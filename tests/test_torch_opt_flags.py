"""The port's ``REPRO_OPT`` switches and ``remat="dots"`` against the JAX
package's, on the CPU.

``REPRO_OPT`` is read at import in both packages, so each switch runs in
a subprocess of its own (as ``tests/test_opt_flags.py`` runs the
reference's), all of them at once: ``tests/test_opt_flags.py``'s tiny
fp32 dense model and a reduced MoE through both packages' ``loss_fn``,
and both packages' train cells (where ``params16`` lives) on both.
Limits: 1e-5 relative on the loss and 1e-3 relative on the sum of
|gradient| (``tests/test_opt_flags.py:47-55``'s rule; the train cell's
grad norm in place of the sum).  In fp32 the switches change the order
of the arithmetic only, so the port with a switch is also held to the
port without it.  In fp32 ``attn_probs16`` and ``params16`` cast nothing,
so their bf16 branches run too: the same models in bf16 compute, and
both packages' flash backward on the same bf16 inputs.
``remat="dots"`` runs in process.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_to_port
from repro_torch.models import api, layers

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
SWITCHES = ["norm_vjp", "attn_probs16", "params16", "moe_a2a"]
LOSS_RTOL, GSUM_RTOL = 1e-5, 1e-3
# remat="dots" against "none", "full" and the reference's "dots": fp32,
# the same arithmetic recomputed (the port's three are bit for bit equal;
# the reference sums in other orders)
DOTS_RTOL = 1e-5
# bf16 compute over fp32 masters, where attn_probs16 and params16 cast:
# each package rounds to bf16 in its own order, so the port is held to the
# reference with the same switch at the two packages' bf16 distance, the
# loss 1e-3 and the gradient sum (the cell's grad norm) 1e-2 relative
# (the updated parameters' sum keeps LOSS_RTOL)
LOSS16_RTOL, GSUM16_RTOL = 1e-3, 1e-2
BF16 = ["attn_probs16", "params16"]
# the flash backward's attn_probs16 branch alone, on the same bf16 inputs:
# dq, dk and dv within 1e-4 of the reference's in relative Frobenius norm;
# the switch-off branch of either package lies ~2e-3 away, as does a
# product rounded to bf16 before its fp32 sum
BWD16_RTOL = 1e-4
TIMEOUT = 300

SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
import torch
torch.set_num_threads(1)
from repro.configs.base import ModelConfig, ShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_train_cell as ref_cell
from repro.models import api as rapi
from repro.models import layers as rlayers
from repro.optim import adamw as radamw
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.configs.base import ShapeConfig as PortShape
from repro_torch.convert import params_to_port
from repro_torch.launch import steps
from repro_torch.models import api, layers
from repro_torch.optim import adamw

job = json.loads(sys.argv[1])
out = {"enabled": {n: [rlayers.opt_enabled(n), layers.opt_enabled(n)]
                   for n in job["switches"]}}
toks = np.random.default_rng(1).integers(0, 211, (2, 32)).astype(np.int32)
for name, fields in job["models"].items():
    rcfg, cfg = ModelConfig(**fields), PortConfig(**fields)
    p = jax.tree.map(np.asarray, rapi.init_params(rcfg, jax.random.PRNGKey(0)))
    loss, grads = jax.value_and_grad(
        lambda pp: rapi.loss_fn(rcfg, pp, jnp.asarray(toks),
                                jnp.asarray(toks)))(p)
    ref = [float(loss), sum(float(jnp.abs(g).sum())
                            for g in jax.tree.leaves(grads))]
    model = params_to_port(cfg, p, "cpu", trainable=True)
    t = torch.from_numpy(toks)
    val = api.loss_fn(cfg, model, t, t)
    g = torch.autograd.grad(val, list(model.parameters()))
    out[name] = {"ref": ref, "port": [float(val.detach()),
                                      sum(float(x.abs().sum()) for x in g)]}
    # the train cell: one step, metrics and the updated parameters' sum
    shape = dict(name="t", kind="train", seq_len=32, global_batch=2)
    opt = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
    w = np.asarray([2.0, 0.0], np.float32)
    rc = ref_cell(rcfg, ShapeConfig(**shape), make_host_mesh(),
                  radamw.AdamWConfig(**opt))
    rp, _, rm = rc.fn(p, radamw.init(radamw.AdamWConfig(**opt), p),
                      jnp.asarray(toks), jnp.asarray(toks), jnp.asarray(w))
    cell = steps.build_train_cell(cfg, PortShape(**shape),
                                  adamw.AdamWConfig(**opt), device="cpu")
    model = params_to_port(cfg, p, "cpu", trainable=True)
    model, _, m = cell.fn(model, adamw.init(cell.opt_cfg, model), t, t,
                          torch.from_numpy(w))
    assert all(x.dtype == torch.float32 for x in model.parameters())
    out[f"cell_{name}"] = {
        "ref": [float(rm["loss"]), float(rm["grad_norm"]),
                sum(float(jnp.abs(x).sum()) for x in jax.tree.leaves(rp))],
        "port": [float(m["loss"]), float(m["grad_norm"]),
                 sum(float(x.detach().abs().sum())
                     for x in model.parameters())]}
if job["bwd"]:
    # both packages' flash backward on the same bf16 q, k, v, out, lse and
    # dout (the reference's forward), MHA: (dq, dk, dv) as fp32 arrays
    rng = np.random.default_rng(3)
    qkvd = [jnp.asarray(rng.standard_normal((2, 64, 4, 16)), jnp.bfloat16)
            for _ in range(4)]
    _, res = rlayers._flash_train_fwd(*qkvd[:3], True, 0, 16)
    ref = rlayers._flash_train_bwd(True, 0, 16, res, qkvd[3])
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    port = layers._flash_train_bwd(*(t(a).bfloat16() for a in res[:4]),
                                   t(res[4]), t(qkvd[3]).bfloat16(), True, 16)
    np.savez(job["bwd"], **{f"ref_{n}": np.asarray(a, np.float32)
                            for n, a in zip("qkv", ref)},
             **{f"port_{n}": b.float().numpy() for n, b in zip("qkv", port)})
print(json.dumps(out))
"""

# tests/test_opt_flags.py's tiny model, and a reduced MoE (qwen3-moe's
# family at the tiny widths: 4 experts, top 2, capacity factor 1.25, so
# tokens drop as they do at full size)
DENSE = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=211,
                    flash_block_kv=16, remat="none",
                    compute_dtype="float32", param_dtype="float32")
MOE = dataclasses.replace(DENSE, name="m", family="moe", num_experts=4,
                          experts_per_token=2, qk_norm=True)
DENSE16 = dataclasses.replace(DENSE, compute_dtype="bfloat16")
MOE16 = dataclasses.replace(MOE, compute_dtype="bfloat16")


def _env(opts: str):
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", REPRO_OPT=opts)


def _job(setting: str, tmp: Path) -> str:
    """A setting's models (the bf16 ones under a switch that casts) and
    where its flash backward goes (with and without attn_probs16)."""
    models = {"dense": DENSE, "moe": MOE}
    if setting in BF16:
        models.update(dense16=DENSE16, moe16=MOE16)
    bwd = str(tmp / f"bwd_{setting or 'none'}.npz") \
        if setting in ("", "attn_probs16") else None
    return json.dumps({"switches": SWITCHES, "bwd": bwd, "models": {
        n: dataclasses.asdict(c) for n, c in models.items()}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One subprocess a setting (none, then each switch), all at once."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("opt")
    settings = [""] + SWITCHES
    procs = {s: subprocess.Popen([sys.executable, "-c", SCRIPT, _job(s, tmp)],
                                 env=_env(s), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for s in settings}
    out, errors = {"bwd": tmp}, []
    try:
        for s, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errors.append(f"{s or 'none'}: {stderr[-3000:]}")
            else:
                out[s] = json.loads(stdout.strip().splitlines()[-1])
    except subprocess.TimeoutExpired:
        errors.append(f"a setting ran past {TIMEOUT} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)
    return out


def _close(a, b):
    np.testing.assert_allclose(a[0], b[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(a[1], b[1], rtol=GSUM_RTOL)


@pytest.mark.parametrize("switch", [""] + SWITCHES)
def test_switch_matches_reference_with_the_same_switch(runs, switch):
    run = runs[switch]
    for name in ("dense", "moe", "cell_dense", "cell_moe"):
        _close(run[name]["port"], run[name]["ref"])
    for name in ("cell_dense", "cell_moe"):
        np.testing.assert_allclose(run[name]["port"][2], run[name]["ref"][2],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("switch", BF16)
def test_bf16_switch_matches_reference_with_the_same_switch(runs, switch):
    """bf16 compute over fp32 masters, where the switch casts: the port
    with the switch against the reference with it, within the two
    packages' bf16 distance (LOSS16_RTOL, GSUM16_RTOL)."""
    run = runs[switch]
    for name in ("dense16", "moe16", "cell_dense16", "cell_moe16"):
        port, ref = run[name]["port"], run[name]["ref"]
        np.testing.assert_allclose(port[0], ref[0], rtol=LOSS16_RTOL)
        np.testing.assert_allclose(port[1], ref[1], rtol=GSUM16_RTOL)
    for name in ("cell_dense16", "cell_moe16"):
        np.testing.assert_allclose(run[name]["port"][2], run[name]["ref"][2],
                                   rtol=LOSS_RTOL)


def test_attn_probs16_flash_backward_matches_reference_in_bf16(runs):
    """``_flash_train_bwd`` (``FlashTrain``'s backward on the card) under
    ``attn_probs16`` against the reference's under it, on the same bf16
    q, k, v, out, lse and dout: dq, dk and dv within BWD16_RTOL.  The
    limit tells the branches apart: both packages' switch-off backward
    lies more than ten times as far from the reference's branch."""
    on = np.load(runs["bwd"] / "bwd_attn_probs16.npz")
    off = np.load(runs["bwd"] / "bwd_none.npz")
    for n in "qkv":
        want = on[f"ref_{n}"]

        def dist(x):
            return np.linalg.norm(x - want) / np.linalg.norm(want)
        assert dist(on[f"port_{n}"]) <= BWD16_RTOL, n
        assert dist(off[f"port_{n}"]) > 10 * BWD16_RTOL, n
        assert dist(off[f"ref_{n}"]) > 10 * BWD16_RTOL, n


@pytest.mark.parametrize("switch", SWITCHES)
def test_switch_keeps_the_ports_numerics(runs, switch):
    for name in ("dense", "moe", "cell_dense", "cell_moe"):
        _close(runs[switch][name]["port"], runs[""][name]["port"])


@pytest.mark.parametrize("switch", [""] + SWITCHES)
def test_switches_are_read_at_import_in_both_packages(runs, switch):
    assert runs[switch]["enabled"] == {n: [n == switch] * 2
                                       for n in SWITCHES}


def test_norm_vjp_backward_keeps_the_input_dtype():
    """``RMSNormVJP`` in bf16: its gradients are bf16 and within bf16
    rounding of autograd's through the fp32 norm (1e-2 of max)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=gen).bfloat16().requires_grad_(True)
    w = (1 + 0.1 * torch.randn(64, generator=gen)).requires_grad_(True)
    g = torch.randn(3, 5, 64, generator=gen).bfloat16()
    dx, dw = torch.autograd.grad(layers.RMSNormVJP.apply(x, w, 1e-6), (x, w),
                                 g)
    x32 = x.detach().float().requires_grad_(True)
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6) * w
    rx, rw = torch.autograd.grad(y, (x32, w), g.float())
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for a, b in ((dx, rx), (dw, rw)):
        scale = float(b.abs().max())
        assert float((a.float() - b).abs().max()) <= 1e-2 * scale


# --------------------------------------------------------------------------
# remat="dots"
# --------------------------------------------------------------------------

class _Allocations(TorchDispatchMode):
    """Every storage an operation makes, with its size, weakly held."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                old = self.made.get(st._cdata)
                if old is None or old[0].expired():
                    self.made[st._cdata] = (StorageWeakRef(st), st.nbytes())
        return out


def _held_bytes(fn):
    """(fn(), bytes the call's operations made that are still alive after
    it): what the forward keeps for the backward.  Autograd's
    ``saved_tensors_hooks`` cannot count it under a checkpoint, whose own
    hooks take the saved tensors and whose selective cache holds the
    saved outputs outside them."""
    mode = _Allocations()
    with mode:
        out = fn()
    gc.collect()
    return out, sum(n for ref, n in mode.made.values() if not ref.expired())


DOTS_ARCHS = ["qwen3-0.6b", "dbrx-132b", "mamba2-1.3b", "zamba2-1.2b"]


def _dots_cfg(arch: str) -> ModelConfig:
    cfg = get_config(arch)
    kw = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=211,
              flash_block_kv=16, compute_dtype="float32",
              param_dtype="float32")
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=2,
                  head_dim=16 if cfg.head_dim else None)
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.attn_every:
        kw.update(num_layers=5, attn_every=2, attn_window=16)
    if cfg.family == "ssm":
        kw.update(num_heads=0, num_kv_heads=0, d_ff=0)
    return cfg.scaled(**kw)


@pytest.mark.parametrize("arch", DOTS_ARCHS)
def test_remat_dots_matches_none_full_and_the_reference(arch):
    """``transformer`` and ``ssm_lm`` under ``"dots"``: the loss and every
    gradient equal ``"none"``'s and ``"full"``'s and the reference's
    ``"dots"`` within DOTS_RTOL (of each leaf's max), and the forward
    keeps more bytes for the backward than ``"full"`` (the projections'
    outputs) and fewer than ``"none"``."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs.base import ModelConfig as RefConfig
    from repro.models import api as rapi
    cfg = _dots_cfg(arch)
    rcfg = RefConfig(**dataclasses.asdict(cfg.scaled(remat="dots")))
    params = jax.tree.map(np.asarray, rapi.init_params(
        rcfg, jax.random.PRNGKey(2)))
    model = params_to_port(cfg, params, "cpu", trainable=True)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 211, (2, 32)).astype(np.int32)
    labs = rng.integers(0, 211, (2, 32)).astype(np.int32)
    t, lab = torch.from_numpy(toks), torch.from_numpy(labs)
    ref_val, ref_g = jax.jit(jax.value_and_grad(
        lambda p: rapi.loss_fn(rcfg, p, jnp.asarray(toks),
                               jnp.asarray(labs))))(params)
    ref_flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_g)[0]:
        ref_flat[".".join(k.key for k in path)] = np.array(leaf)
    held, grads = {}, {}
    for remat in ("none", "full", "dots"):
        loss, held[remat] = _held_bytes(
            lambda: api.loss_fn(cfg.scaled(remat=remat), model, t, lab))
        grads[remat] = dict(zip(
            [n for n, _ in model.named_parameters()],
            torch.autograd.grad(loss, list(model.parameters()))))
        np.testing.assert_allclose(float(loss.detach()), float(ref_val),
                                   rtol=DOTS_RTOL)
    assert held["full"] < held["dots"] < held["none"], held
    for name, g in grads["dots"].items():
        for other in (grads["none"][name], grads["full"][name],
                      torch.from_numpy(ref_flat[name])):
            scale = float(other.abs().max()) + 1e-30
            assert float((g - other).abs().max()) <= DOTS_RTOL * scale, name


def test_remat_rejects_an_unknown_mode():
    cfg = _dots_cfg("qwen3-0.6b").scaled(remat="most")
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            trainable=True)
    with pytest.raises(ValueError, match="remat must be"):
        api.loss_fn(cfg, model, torch.zeros((1, 8), dtype=torch.long),
                    torch.zeros((1, 8), dtype=torch.long))
