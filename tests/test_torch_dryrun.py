"""The dry run's twin (``repro_torch.launch.dryrun``, ``launch.hlo_analysis``)
against the JAX package's, on the CPU.

A process holds one process group, so whatever starts one (the ``"fake"``
backend's production meshes, four gloo ranks) runs in a subprocess:
the port's rank inputs on both production meshes beside the reference's
per-device shard bytes (its own subprocess with 512 host devices, as
its dry run runs), the gloo ranks of a (2, 2) mesh beside the twin's
trace of each rank on meta, and the command line.  The reference's
compiled FLOPs come from its decode cells at
``tests/test_dryrun_smoke.py``'s reduced sizes, compiled in this process
as that test compiles them.  Cases that need the card are marked ``gpu``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.kernels.coded_matmul import ops as cm_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun, steps
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import api

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TIMEOUT = 300
META = torch.device("meta")
CELLS = [(a, s) for a in ARCH_IDS if a != "paper-matvec"
         for s in applicable_shapes(get_config(a))]
#: one cell of each (family x kind), both meshes
FAMILY_CELLS = [("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
                ("qwen3-0.6b", "decode_32k"),
                ("qwen3-moe-235b-a22b", "train_4k"),
                ("dbrx-132b", "prefill_32k"), ("mamba2-1.3b", "long_500k"),
                ("zamba2-1.2b", "train_4k"), ("hubert-xlarge", "prefill_32k"),
                ("internvl2-76b", "train_4k")]
MESH_NAMES = ("single", "multi")
#: the reference's ``run_cell`` record beyond ``Roofline.to_dict()``
#: (src/repro/launch/dryrun.py:62-70)
RUN_CELL_KEYS = ("compile_s", "generated_code_bytes", "argument_bytes",
                 "output_bytes", "temp_bytes", "ok")
#: the twin's FLOPs against the reference's compiled HLO's
FLOPS_RTOL = 0.02
#: the reference's int32 step (train) and position (decode) are 0-d device
#: arrays; the port holds both on the host (ROADMAP Queue 3)
HOST_SCALAR_BYTES = 4


def _env(**extra):
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", **extra)


def _wait(procs, timeout: int = TIMEOUT):
    """Each process's standard output; kills all and fails with their
    errors on a failure or past ``timeout``."""
    outs, errors = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode:
                errors.append(err[-3000:])
    except subprocess.TimeoutExpired:
        errors.append(f"a process ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)
    return outs


def _start(script: str, *args, **env):
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# model FLOPs: plain arithmetic, every cell
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    from repro.configs.base import SHAPES as RSHAPES
    from repro.configs.base import get_config as ref_get_config
    from repro.launch import hlo_analysis as RH
    from repro.models import api as rapi
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    pshapes, rshapes = api.param_shapes(cfg), rapi.param_shapes(rcfg)
    total = H.count_params(pshapes)
    assert total == RH.count_params(rshapes)
    assert H.active_params(cfg, total) == RH.active_params(rcfg, total)
    assert H.model_flops_for(cfg, SHAPES[shape], pshapes) == \
        RH.model_flops_for(rcfg, RSHAPES[shape], rshapes)


# --------------------------------------------------------------------------
# a rank's arguments on the production meshes
# --------------------------------------------------------------------------

REF_SHARDS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
import numpy as np
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_cell
cells = json.loads(sys.argv[1])
out = {}
for name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape in cells:
        cell = build_cell(arch, shape, mesh)
        total = scalars = 0
        pairs = jax.tree.leaves(jax.tree.map(
            lambda s, sh: (s, sh), cell.args, cell.in_shardings),
            is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
            and hasattr(x[0], "dtype"))
        for sds, sh in pairs:
            b = int(np.prod(sh.shard_shape(sds.shape))) * sds.dtype.itemsize
            total += b
            scalars += b if sds.ndim == 0 else 0
        out[f"{arch}/{shape}/{name}"] = [total, scalars]
print(json.dumps(out))
"""

PORT_ARGS = r"""
import sys, json
from repro_torch.launch import dryrun, steps
from repro_torch.launch.hlo_analysis import OpRecorder
cells = json.loads(sys.argv[1])
out = {}
for name, multi in (("single", False), ("multi", True)):
    mesh = dryrun.production_mesh(multi)
    for arch, shape in cells:
        cell = steps.build_cell(arch, shape, mesh=mesh)
        out[f"{arch}/{shape}/{name}"] = OpRecorder().track(
            dryrun.rank_inputs(cell))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def shard_bytes():
    """(the port's rank-0 argument bytes, the reference's per-device
    shard bytes and their 0-d share) by "arch/shape/mesh"."""
    cells = json.dumps(FAMILY_CELLS)
    procs = [_start(PORT_ARGS, cells), _start(REF_SHARDS, cells)]
    port, ref = (_last_json(o) for o in _wait(procs))
    return port, ref


@pytest.mark.parametrize("mesh", MESH_NAMES)
@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_argument_bytes_are_the_reference_shards(shard_bytes, arch, shape,
                                                 mesh):
    port, ref = shard_bytes
    key = f"{arch}/{shape}/{mesh}"
    total, scalars = ref[key]
    kind = SHAPES[shape].kind
    assert scalars == (0 if kind == "prefill" else HOST_SCALAR_BYTES), key
    assert port[key] == total - scalars, (key, port[key], total, scalars)


# --------------------------------------------------------------------------
# FLOPs against the reference's compiled program (decode, one device)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-9b", "zamba2-1.2b"])
def test_decode_flops_match_compiled_reference(arch):
    from repro.configs.base import ShapeConfig as RShape
    from repro.launch import hlo_analysis as RH
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_decode_cell as ref_decode_cell
    from tests.test_models_smoke import reduced
    rcfg = reduced(arch)
    mesh = make_host_mesh()
    with mesh:
        compiled = ref_decode_cell(rcfg, RShape("decode_32k", "decode", 64, 4),
                                   mesh).lower().compile()
    ref = RH.hlo_cost(compiled.as_text())["flops"]
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    cell = steps.build_decode_cell(cfg, ShapeConfig("decode_32k", "decode",
                                                    64, 4), device=META)
    trace = dryrun.trace_step(cell, dryrun.rank_inputs(cell, 64))
    flops = H.op_cost(trace)["flops"]
    assert ref > 0 and abs(flops - ref) <= FLOPS_RTOL * ref, (flops, ref)


# --------------------------------------------------------------------------
# four gloo ranks on (2, 2): each rank's collectives are its twin's
# --------------------------------------------------------------------------

TINY = {
    "qwen3": ("qwen3-0.6b", dict(num_layers=2, d_model=64, d_ff=128,
                                 vocab_size=211, flash_block_kv=32,
                                 compute_dtype="float32",
                                 param_dtype="float32", num_heads=16,
                                 head_dim=16, num_kv_heads=8, remat="full")),
    "mamba2": ("mamba2-1.3b", dict(num_layers=2, d_model=64, ssm_expand=2,
                                   ssm_state=16, ssm_chunk=16,
                                   ssm_head_dim=16, flash_block_kv=8,
                                   vocab_size=211, compute_dtype="float32",
                                   param_dtype="float32", remat="none")),
}
GLOO_B, GLOO_S = 4, 32

GLOO_RANK = r"""
import datetime, json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, job = int(sys.argv[1]), json.loads(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(job["store"], 4),
                        rank=rank, world_size=4,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.hlo_analysis import OpRecorder
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh(data=2, device="cpu")
shape = ShapeConfig("t", "train", job["S"], job["B"])
out = {}
for name, (arch, over) in job["tiny"].items():
    cell = steps.build_train_cell(get_config(arch).scaled(**over), shape,
                                  mesh=mesh)
    inputs = cell.materialize(0)
    rec = OpRecorder()
    rec.track(inputs)
    with rec:
        cell.fn(*inputs)
    out[name] = rec.trace.collectives()
dist.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""

GLOO_TWIN = r"""
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_host_mesh
job = json.loads(sys.argv[1])
shape = ShapeConfig("t", "train", job["S"], job["B"])
out = []
for rank in range(4):
    dryrun.fake_group(4, rank)
    mesh = make_host_mesh(data=2, device="meta", backend="fake")
    rec = {}
    for name, (arch, over) in job["tiny"].items():
        cell = steps.build_train_cell(get_config(arch).scaled(**over), shape,
                                      mesh=mesh)
        rec[name] = dryrun.trace_step(cell, dryrun.rank_inputs(cell)
                                      ).collectives()
    out.append(rec)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_dryrun")
    job = dict(tiny=TINY, B=GLOO_B, S=GLOO_S, store=str(tmp / "store"))
    procs = [_start(GLOO_RANK, r, json.dumps(job)) for r in range(4)]
    procs.append(_start(GLOO_TWIN, json.dumps(job)))
    outs = _wait(procs)
    return [_last_json(o) for o in outs[:4]], _last_json(outs[4])


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("name", sorted(TINY))
def test_gloo_rank_collectives_are_the_twins(gloo_runs, name, rank):
    real, twin = gloo_runs
    got, want = real[rank][name], twin[rank][name]
    assert got and got == want, (name, rank, got[:4], want[:4])
    # the model's collectives: FSDP gathers over data, their
    # reduce-scatter, the reduces over model and the flat all-reduce (2
    # ranks); the norm for clipping over the whole mesh (4)
    assert {op for op, _, _ in got} == {"all-gather", "reduce-scatter",
                                        "all-reduce"}
    assert {n for _, n, _ in got} == {2, 4}


# --------------------------------------------------------------------------
# the kernels' meta branches
# --------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _tensor_bytes(event) -> int:
    """The bytes of the tensors a kernel event names."""
    return sum(math.prod(s) * getattr(torch, d).itemsize
               for s, d in zip(event["shapes"], event["dtypes"]))


def _recorded(fn):
    """(fn's result, the kernel events recorded while it ran)."""
    rec = H.OpRecorder()
    with rec:
        out = fn()
    return out, rec.trace.of_kind("kernel")


FLASH_CASES = {
    "causal": ((2, 64, 64, 4, 2, 64), torch.bfloat16, True, 0),
    "full fp32": ((2, 48, 48, 4, 4, 32), torch.float32, False, 0),
    "window": ((1, 128, 128, 4, 4, 64), torch.bfloat16, True, 32),
    "gqa 16 offset rows": ((2, 16, 80, 16, 1, 128), torch.bfloat16, True, 0),
    "d80 bidirectional": ((2, 64, 64, 4, 4, 80), torch.bfloat16, False, 0),
}


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_meta_branch_is_the_kernels(case, lse):
    (b, sq, sk, h, kv, d), dtype, causal, window = FLASH_CASES[case]
    q, k, v = _meta(b, sq, h, d, dtype=dtype), _meta(b, sk, kv, d,
                                                     dtype=dtype), \
        _meta(b, sk, kv, d, dtype=dtype)
    before = fa_ops.flash_attention.launches
    fn = fa_ops.flash_attention_lse if lse else fa_ops.flash_attention
    out, events = _recorded(lambda: fn(q, k, v, causal, window))
    o, l = out if lse else (out, None)
    assert o.device == META and o.shape == q.shape and o.dtype == dtype
    if lse:
        assert l.shape == (b, h, sq) and l.dtype == torch.float32
    assert fa_ops.flash_attention.launches == before       # nothing launched
    ops, nbytes = fa_ops.cost(q, k, causal, window, lse)
    assert [(e["op"], e["flops"], e["bytes"]) for e in events] == \
        [("flash_attention", ops, nbytes)]
    # cost's bytes: the operands read once, the outputs written once
    assert nbytes == _tensor_bytes(events[0])


@pytest.mark.parametrize("shapes,dtype,causal,window,error", [
    (((2, 8, 4, 96), (2, 8, 4, 96)), torch.bfloat16, True, 0, ValueError),
    (((2, 8, 3, 64), (2, 8, 2, 64)), torch.bfloat16, True, 0, ValueError),
    (((2, 16, 4, 64), (2, 8, 4, 64)), torch.bfloat16, True, 0, ValueError),
    (((2, 8, 4, 80), (2, 8, 4, 80)), torch.bfloat16, True, 16, ValueError),
    (((2, 8, 4, 64), (2, 8, 4, 64)), torch.float16, True, 0, TypeError),
])
def test_flash_meta_branch_raises_as_the_card(shapes, dtype, causal, window,
                                              error):
    qs, ks = shapes
    q, k = _meta(*qs, dtype=dtype), _meta(*ks, dtype=dtype)
    with pytest.raises(error):
        fa_ops.flash_attention(q, k, k.clone(), causal, window)


def test_flash_meta_branch_refuses_unaligned_bf16_as_the_card():
    q = _meta(2 * 8 * 4 * 64 + 1)[1:].view(2, 8, 4, 64)
    k = _meta(2, 8, 4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention(q, k, k.clone())


SSD_CASES = {
    "mamba2 bf16": ((2, 512, 8, 64, 128), torch.bfloat16, 256),
    "zamba2 bf16 N 64": ((1, 256, 4, 64, 64), torch.bfloat16, 256),
    "fp32 simt": ((2, 64, 3, 16, 8), torch.float32, 16),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_meta_branch_is_the_kernels(case):
    (b, s, h, p, n), dtype, chunk = SSD_CASES[case]
    x, dt, A = _meta(b, s, h, p, dtype=dtype), \
        _meta(b, s, h, dtype=torch.float32), _meta(h, dtype=torch.float32)
    Bm, Cm = _meta(b, s, n, dtype=dtype), _meta(b, s, n, dtype=dtype)
    before = ssd_ops.ssd_scan.launches
    rec = H.OpRecorder()
    with rec:
        y = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert y.device == META and y.shape == x.shape and y.dtype == dtype
    assert ssd_ops.ssd_scan.launches == before
    ops, nbytes = ssd_ops.cost(x, dt, A, Bm, chunk)
    events = rec.trace.of_kind("kernel")
    assert [(e["op"], e["flops"], e["bytes"]) for e in events] == \
        [("ssd_scan", ops, nbytes)]
    assert nbytes == _tensor_bytes(events[0])
    # y and the bf16 schedule's workspace were live at once
    work = ssd_kernel.workspace_layout(b, s, h, p, n, chunk) \
        if dtype == torch.bfloat16 else 0
    assert rec.trace.peak_bytes == x.nbytes + work


@pytest.mark.parametrize("shape,dtype,chunk,error", [
    ((2, 64, 3, 16, 12), torch.bfloat16, 16, RuntimeError),    # N % 8
    ((1, 64, 2, 64, 256), torch.bfloat16, 16, RuntimeError),   # P*N > 8192
    ((1, 64, 2, 64, 256), torch.float32, 16, RuntimeError),    # state > block
    ((1, 64, 2, 48, 16), torch.bfloat16, 16, ValueError),      # head dim
    ((1, 60, 2, 16, 16), torch.bfloat16, 16, ValueError),      # S % chunk
])
def test_ssd_meta_branch_raises_as_the_card(shape, dtype, chunk, error):
    b, s, h, p, n = shape
    x, dt, A = _meta(b, s, h, p, dtype=dtype), \
        _meta(b, s, h, dtype=torch.float32), _meta(h, dtype=torch.float32)
    Bm = _meta(b, s, n, dtype=dtype)
    with pytest.raises(error):
        ssd_ops.ssd_scan(x, dt, A, Bm, Bm.clone(), chunk=chunk)


def test_ssd_workspace_layout_counts_its_three_parts():
    # B 2, S 4096, H 64, P 64, N 128, chunk 256: 16 chunks
    g = 2 * 16 * 256 * 256 * 4
    l2 = 2 * 16 * 64 * 256 * 8
    st = 2 * 16 * 64 * 64 * 128 * 4
    assert ssd_kernel.workspace_layout(2, 4096, 64, 64, 128, 256) == \
        g + l2 + st
    # a ragged chunk rounds up to 16 rows, each part to 256 bytes
    assert ssd_kernel.workspace_layout(1, 10, 3, 16, 8, 10) == \
        1024 + 512 + 1536
    with pytest.raises(ValueError):
        ssd_kernel.workspace_layout(1, 10, 3, 16, 8, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel's own layout is "
                    "compiled CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ssd_workspace_layout_is_the_kernels(cuda):
    for shape in [(2, 4096, 64, 64, 128, 256), (2, 8192, 64, 64, 64, 256),
                  (1, 200, 3, 16, 40, 40)]:
        assert ssd_kernel.workspace_layout(*shape) == \
            ssd_kernel.workspace_bytes(*shape)


# --------------------------------------------------------------------------
# the recorder and the cost model
# --------------------------------------------------------------------------

def test_recorder_counts_flops_bytes_and_the_peak():
    x = torch.ones(64, 32)
    w = torch.ones(32, 16)
    rec = H.OpRecorder()
    assert rec.track((x, w)) == (64 * 32 + 32 * 16) * 4
    with rec:
        y = x @ w                   # 2 * 64 * 32 * 16 FLOPs
        z = (y + 1).t()             # a new buffer, then a view
        del y
        out = z.sum()
    rec.finish(out)
    t = rec.trace
    mm, add, view, total = t.events[0], t.events[1], t.events[2], t.events[3]
    assert mm["flops"] == 2 * 64 * 32 * 16
    assert mm["bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert add["flops"] == 0 and add["bytes"] == 2 * 64 * 16 * 4
    assert view["op"] == "t" and view["bytes"] == 0
    assert total["bytes"] == 64 * 16 * 4 + 4
    # x, w, y and y + 1 live at once; y was freed before the sum
    assert t.peak_bytes == t.argument_bytes + 2 * 64 * 16 * 4
    assert t.output_bytes == 4


def test_recorder_flops_are_flop_counter_modes():
    from torch.utils.flop_counter import FlopCounterMode
    torch.manual_seed(0)
    lin = torch.nn.Linear(48, 24)
    x = torch.randn(8, 48, requires_grad=True)

    def step():
        y = torch.nn.functional.gelu(lin(x))
        (torch.einsum("bi,bj->ij", y, y).sum()).backward()
    counter = FlopCounterMode(display=False)
    with counter:
        step()
    rec = H.OpRecorder()
    with rec:
        step()
    assert H.op_cost(rec.trace)["flops"] == counter.get_total_flops() > 0


def _event(op, nbytes, ranks):
    return {"kind": "collective", "op": op, "bytes": nbytes, "dtype":
            "float32", "shapes": [], "group_size": len(ranks),
            "ranks": list(ranks)}


def test_collectives_are_charged_by_the_links_their_group_spans():
    assert H.link_bw(range(8)) == H.NVLINK_BW
    assert H.link_bw(range(8, 16)) == H.NVLINK_BW
    assert H.link_bw(range(0, 256, 16)) == H.NET_BW       # a data group
    assert H.link_bw(range(16)) == H.NET_BW               # a model group
    trace = H.Trace(events=[
        _event("all-reduce", 900e6, range(8)),
        _event("all-gather", 100e6, range(16)),
        _event("reduce-scatter", 1600e6, range(0, 32, 2)),
        {"kind": "aten", "op": "mm", "flops": 989e9, "bytes": 0,
         "dtype": "bfloat16"},
        {"kind": "kernel", "op": "flash_attention", "flops": 67e9,
         "bytes": 3.35e9, "dtype": "float32"}])
    cost = H.op_cost(trace)
    assert cost["t_collective"] == pytest.approx(
        900e6 / 450e9 + 100e6 / 50e9 + 1600e6 / 50e9)
    assert cost["t_compute"] == pytest.approx(2e-3)      # 1 ms + 1 ms
    assert cost["coll_bytes"] == 2600e6
    # operand and result: all-reduce 2x, all-gather 1 + 16x, the
    # reduce-scatter 1 + 1/16, and the kernel's bytes
    assert cost["bytes"] == pytest.approx(
        1800e6 + 1700e6 + 1700e6 + 3.35e9)
    assert cost["bytes_raw"] == cost["bytes"]
    assert cost["coll_counts"] == {"all-reduce": 1, "all-gather": 1,
                                   "reduce-scatter": 1, "all-to-all": 0,
                                   "collective-permute": 0}
    assert H.collective_bytes(trace)["_counts"] == cost["coll_counts"]


def test_constants_are_the_h100s():
    assert (H.PEAK_FLOPS, H.FP32_PEAK_FLOPS, H.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    assert (H.NVLINK_BW, H.NET_BW) == (450e9, 50e9)
    assert H.HBM_BYTES == 81_559 * 2 ** 20
    from repro.launch import hlo_analysis as RH
    assert H.PEAK_FLOPS != RH.PEAK_FLOPS and H.HBM_BW != RH.HBM_BW
    roof = H.analyze("a", "s", "single", 256, H.Trace(events=[
        {"kind": "aten", "op": "mm", "flops": 989e12, "bytes": 3.35e12,
         "dtype": "bfloat16"}]), 989e12 * 256)
    assert roof.t_compute == roof.t_memory == pytest.approx(1.0)
    assert roof.roofline_fraction == pytest.approx(1.0)


# --------------------------------------------------------------------------
# one count for the kernels' bounds (PERF.md section 6's table)
# --------------------------------------------------------------------------

def _bound(ops, nbytes, dtype):
    t_bytes = nbytes / H.HBM_BW * 1e3
    t_ops = ops / H.peak_flops(dtype) * 1e3
    return (f"{t_bytes:.4f}", "bytes") if t_bytes >= t_ops else \
        (f"{t_ops:.4f}", "operations")


def _coded(k, N):
    G = _meta(12, k, dtype=torch.float64)
    A = _meta(k, 12288 // k, 8192, dtype=torch.float32)
    return cm_ops.cost(G, A, _meta(8192, N, dtype=torch.float32)), \
        torch.float32


def _flash(b, s, h, kv, d, causal=True, window=0, lse=False):
    q, k = _meta(b, s, h, d), _meta(b, s, kv, d)
    return fa_ops.cost(q, k, causal, window, lse), torch.bfloat16


def _ssd(b, s, h, p, n, chunk=256):
    x, dt, A = _meta(b, s, h, p), _meta(b, s, h, dtype=torch.float32), \
        _meta(h, dtype=torch.float32)
    return ssd_ops.cost(x, dt, A, _meta(b, s, n), chunk), torch.bfloat16


#: row -> (cost, PERF.md's bound_ms and bound_by)
PERF_ROWS = {
    "coded n12 k1 N1": (lambda: _coded(1, 1), ("0.1204", "bytes")),
    "coded n12 k6 N1": (lambda: _coded(6, 1), ("0.1202", "bytes")),
    "coded n12 k1 N128": (lambda: _coded(1, 128), ("0.3852", "operations")),
    "coded n12 k6 N128": (lambda: _coded(6, 128), ("0.3852", "operations")),
    "flash qwen3 prefill": (lambda: _flash(2, 4096, 16, 8, 128),
                            ("0.1390", "operations")),
    "flash qwen3-moe prefill": (lambda: _flash(2, 4096, 64, 4, 128),
                                ("0.5560", "operations")),
    "flash hubert prefill": (lambda: _flash(2, 4096, 16, 16, 80, False),
                             ("0.1737", "operations")),
    "flash qwen3 training": (lambda: _flash(16, 256, 16, 8, 128, lse=True),
                             ("0.0151", "bytes")),
    "flash qwen3 training rank": (lambda: _flash(8, 256, 8, 4, 128,
                                                 lse=True),
                                  ("0.0038", "bytes")),
    "flash qwen3-moe training": (lambda: _flash(16, 256, 64, 4, 128,
                                                lse=True),
                                 ("0.0429", "bytes")),
    "flash dbrx training": (lambda: _flash(16, 256, 48, 8, 128, lse=True),
                            ("0.0353", "bytes")),
    "flash hubert training": (lambda: _flash(16, 256, 16, 16, 80, False,
                                             lse=True),
                              ("0.0126", "bytes")),
    "flash internvl2 training": (lambda: _flash(16, 256, 64, 8, 128,
                                                lse=True),
                                 ("0.0454", "bytes")),
    "flash zamba2 windowed prefill": (lambda: _flash(2, 8192, 32, 32, 64,
                                                     window=4096),
                                      ("0.4169", "operations")),
    "flash zamba2 windowed training": (lambda: _flash(16, 256, 32, 32, 64,
                                                      window=4096, lse=True),
                                       ("0.0202", "bytes")),
    "flash zamba2 windowed training rank": (
        lambda: _flash(8, 256, 16, 16, 64, window=4096, lse=True),
        ("0.0050", "bytes")),
    "ssd mamba2 prefill": (lambda: _ssd(2, 4096, 64, 64, 128),
                           ("0.0419", "bytes")),
    "ssd zamba2 prefill": (lambda: _ssd(2, 8192, 64, 64, 64),
                           ("0.0826", "bytes")),
    "ssd mamba2 training": (lambda: _ssd(16, 256, 64, 64, 128),
                            ("0.0210", "bytes")),
    "ssd mamba2 training rank": (lambda: _ssd(8, 256, 32, 64, 128),
                                 ("0.0054", "bytes")),
}


@pytest.mark.parametrize("row", sorted(PERF_ROWS))
def test_kernel_cost_gives_perf_tables_bounds(row):
    make, want = PERF_ROWS[row]
    (ops, nbytes), dtype = make()
    assert _bound(ops, nbytes, dtype) == want


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def _ref_record_keys():
    from repro.launch import hlo_analysis as RH
    names = [f.name for f in dataclasses.fields(RH.Roofline)]
    roof = RH.Roofline(**{n: 1 for n in names})
    return set(roof.to_dict()) | set(RUN_CELL_KEYS)


def _run_cli(tmp_path, *args, timeout=TIMEOUT):
    out = tmp_path / "out.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--json",
         str(out)], env=_env(), capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout, [json.loads(line) for line in
                         out.read_text().splitlines()]


def test_cli_traces_one_cell(tmp_path):
    stdout, records = _run_cli(tmp_path, "--arch", "qwen3-0.6b", "--shape",
                               "decode_32k", "--mesh", "single")
    assert "all 1 cells traced OK" in stdout
    (rec,) = records
    assert rec["ok"] and rec["fits"] and rec["rank"] == 0
    assert _ref_record_keys() | {"rank", "fits"} <= set(rec)
    assert rec["chips"] == 256 and rec["generated_code_bytes"] is None
    assert rec["peak_bytes_per_device"] == rec["argument_bytes"] + \
        rec["temp_bytes"]
    # rank 0's decode moves its whole cache block at least once
    assert rec["bytes_per_device"] > rec["argument_bytes"]


@pytest.mark.slow
def test_cli_sweeps_every_cell_on_both_meshes(tmp_path):
    stdout, records = _run_cli(tmp_path, "--arch", "all", "--mesh", "both",
                               timeout=1200)
    assert "all 62 cells traced OK" in stdout
    assert len(records) == 62 and all(r["ok"] for r in records)
    keys = _ref_record_keys() | {"rank", "fits"}
    assert all(keys <= set(r) for r in records)
    assert sorted((r["arch"], r["shape"], r["mesh"]) for r in records) == \
        sorted((a, s, m) for a, s in CELLS for m in MESH_NAMES)
