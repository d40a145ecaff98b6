"""The control and the faults come out as not correct.

At the fixture cells' size on the CPU, under the fixture limits: the
control (the reference with fp8 products in the program's place, one
precision below the configuration's bf16) fails a number of every cell
on seeds 1-3; and a run with the timed path broken underneath (a step
that leaves its state unchanged, half of the batch left out, a served
token altered where it is produced; a state left unchanged by the
window's steps only) reports ``correct`` false.  A cell
has no exchange between chips, so that fault has no case here."""
from __future__ import annotations

import pytest

from conftest import FIXTURE_CELLS, cell_name, run_cell

CELLS = [cell_name(c, t) for c, t in FIXTURE_CELLS]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_a_number(root, name, seed):
    out = run_cell(root, name, seed=seed)
    assert out.result["correct"]
    control = out.session.control_numbers(out.outputs, out.ref)
    assert any(control[k] > lim for k, _, lim in out.checks), control


FAULTS = [(cell_name("tiny-dense", "tiny_train"), "frozen"),
          (cell_name("tiny-dense", "tiny_train"), "frozen_late"),
          (cell_name("tiny-dense", "tiny_train"), "half_batch"),
          (cell_name("tiny-hybrid", "tiny_train"), "frozen"),
          (cell_name("tiny-hybrid", "tiny_train"), "half_batch"),
          (cell_name("tiny-dense", "tiny_decode"), "altered_token"),
          (cell_name("tiny-hybrid", "tiny_prefill"), "altered_token"),
          (cell_name("tiny-ssm", "tiny_train"), "frozen"),
          (cell_name("tiny-ssm", "tiny_train"), "half_batch"),
          (cell_name("tiny-ssm", "tiny_prefill"), "altered_token")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_under_the_timed_path_makes_correct_false(root, name, fault):
    result = run_cell(root, name, seed=7, faults=(fault,)).result
    assert result["correct"] is False, result["checks"]


def test_a_fault_in_the_window_only_fails_the_window_s_numbers(root):
    """A state that only the window's steps leave unchanged passes the
    set-up's steps and fails the window's last."""
    checks = run_cell(root, cell_name("tiny-dense", "tiny_train"), seed=7,
                      faults=("frozen_late",)).checks
    failed = {k for k, v, lim in checks if not v <= lim}
    assert failed and all(k.startswith("last_") for k in failed), checks
