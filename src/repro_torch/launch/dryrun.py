"""Multi-pod dry run: trace every (arch x shape x mesh) cell for one rank
(the port's twin of the JAX package's ``launch/dryrun.py``).

The proof, without hardware, that the distribution config is coherent:
one rank's train, prefill or decode step must run on the single-pod
(16 data x 16 model = 256 ranks) AND the multi-pod (2 x 16 x 16 = 512
ranks) production meshes.  Where the reference lowers and compiles the
step for 512 placeholder devices and reads the HLO, this module runs the
rank's step on the ``meta`` device (shapes and dtypes, no storage) under
``hlo_analysis.OpRecorder``, in one process on a process group of the
``"fake"`` backend (``torch.distributed``'s, whose collectives move
nothing) with the mesh's world size and the rank asked for.  The op trace
stands where the reference reads HLO: it gives the rank's bytes, FLOPs,
collective bytes and roofline terms at the H100 constants of
``hlo_analysis`` (predictions, not measurements).  SPMD makes the ranks
alike; ``--rank`` traces one that is not (the last pod's, say).

The rank's inputs: its blocks of the parameters (``api.build`` on meta)
and of the fp32 AdamW moments, its ``Cell.rows`` of the batch inputs, its
block of the cache, and the decode position as the host integer
``seq_len - 1``, the full cache that the reference's compiled program
reads every step.  The kernels' wrappers give their outputs on meta and
report their ``cost()``; their plain versions never run.

Record keys: the reference's (``Roofline.to_dict()``, ``compile_s``,
``generated_code_bytes``, ``argument_bytes``, ``output_bytes``,
``temp_bytes``, ``ok``), with ``compile_s`` the trace's seconds,
``argument_bytes`` the bytes of the rank's inputs, ``output_bytes`` those
of the step's outputs, ``temp_bytes`` the peak of live bytes less the
arguments and ``generated_code_bytes`` None (no compiled program); plus
``rank`` and ``fits`` (the peak within the card's ``HBM_BYTES``).

Importing this module starts nothing: ``run_cell`` starts (or reuses) the
fake process group it needs, one a process.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --mesh both --json out.jsonl

Environment: ``REPRO_REMAT`` overrides the configs' remat, as the
reference's; ``REPRO_SAVE_HLO=dir`` writes each cell's op trace to
``dir/<arch>_<shape>_<mesh>_<REPRO_OPT or base>.ops.jsonl``, one line an
operation (its shapes, dtypes, FLOPs and bytes).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Optional, Tuple

import torch

_META = torch.device("meta")


def fake_group(world: int, rank: int = 0) -> None:
    """A process group of the ``"fake"`` backend of ``world`` ranks, this
    process being ``rank``; the running one is reused when it is that,
    else destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend(), dist.get_world_size(), dist.get_rank()) == \
                ("fake", world, rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def production_mesh(multi_pod: bool, rank: int = 0):
    """The production mesh on meta for ``rank``, over a fake group."""
    from .mesh import MULTI_POD, SINGLE_POD, make_production_mesh
    fake_group(math.prod(MULTI_POD if multi_pod else SINGLE_POD), rank)
    return make_production_mesh(multi_pod=multi_pod, device=_META,
                                backend="fake")


def _rows(spec: torch.Tensor, rows: Optional[slice]) -> torch.Tensor:
    shape = tuple(spec.shape)
    if rows is not None:
        shape = (rows.stop - rows.start,) + shape[1:]
    return torch.empty(shape, dtype=spec.dtype, device=_META)


def rank_inputs(cell, seq_len: Optional[int] = None) -> Tuple:
    """The rank's inputs of ``cell`` as meta tensors (the module doc's);
    ``seq_len``: a decode cell's (default: its shape's)."""
    from ..models import api
    from ..optim import adamw
    from .steps import _zeros
    params = api.build(cell.cfg, device=_META, trainable=cell.kind == "train",
                       mesh=cell.mesh)
    if cell.kind == "train":
        _, _, tok, lab, w = cell.args
        return (params, adamw.init(cell.opt_cfg, params),
                *(_rows(x, cell.rows) for x in (tok, lab, w)))
    if cell.kind == "prefill":
        return params, _rows(cell.args[1], cell.rows)
    _, cache, tok, _ = cell.args
    specs = api.cache_specs(cell.cfg) if cell.mesh is not None else None
    if seq_len is None:
        from ..configs.base import SHAPES
        seq_len = SHAPES[cell.shape].seq_len
    return (params, _zeros(cache, _META, specs, cell.mesh),
            _rows(tok, cell.rows), seq_len - 1)


def trace_step(cell, inputs) -> "hlo_analysis.Trace":  # noqa: F821
    """``cell.fn(*inputs)`` under an ``OpRecorder``; the inputs' storages
    are the arguments."""
    from .hlo_analysis import OpRecorder
    rec = OpRecorder()
    rec.track(inputs)
    t0 = time.time()
    with rec:
        out = cell.fn(*inputs)
    rec.trace.seconds = time.time() - t0
    rec.finish(out)
    return rec.trace


def run_cell(arch: str, shape_name: str, multi_pod: bool, rank: int = 0,
             verbose: bool = True) -> dict:
    from ..configs.base import SHAPES, get_config
    from ..models import api
    from . import hlo_analysis as H
    from .steps import build_cell

    mesh = production_mesh(multi_pod, rank)
    chips = mesh.size
    mesh_name = "multi" if multi_pod else "single"
    cfg = get_config(arch)
    shape = SHAPES[shape_name]

    overrides = {}
    if os.environ.get("REPRO_REMAT"):
        overrides["remat"] = os.environ["REPRO_REMAT"]
    cell = build_cell(arch, shape_name, overrides or None, mesh=mesh)
    trace = trace_step(cell, rank_inputs(cell, shape.seq_len))

    hlo_dir = os.environ.get("REPRO_SAVE_HLO")
    if hlo_dir:
        os.makedirs(hlo_dir, exist_ok=True)
        tag = os.environ.get("REPRO_OPT", "base") or "base"
        trace.write_jsonl(os.path.join(
            hlo_dir, f"{arch}_{shape_name}_{mesh_name}_"
                     f"{tag.replace(',', '+')}.ops.jsonl"))

    mflops = H.model_flops_for(cfg, shape, api.param_shapes(cfg))
    roof = H.analyze(arch, shape_name, mesh_name, chips, trace, mflops)

    out = roof.to_dict()
    out.update(
        compile_s=round(trace.seconds, 1),
        generated_code_bytes=None,
        argument_bytes=trace.argument_bytes,
        output_bytes=trace.output_bytes,
        temp_bytes=trace.peak_bytes - trace.argument_bytes,
        ok=True,
        rank=rank,
        fits=trace.peak_bytes <= H.HBM_BYTES,
    )
    if verbose:
        gb = 1024 ** 3
        print(f"[{arch} x {shape_name} x {mesh_name}] ok "
              f"trace={out['compile_s']}s "
              f"args/dev={out['argument_bytes']/gb:.2f}GiB "
              f"temp/dev={out['temp_bytes']/gb:.2f}GiB "
              f"flops/dev={roof.flops_per_device:.3e} "
              f"coll/dev={roof.coll_bytes_per_device:.3e}B "
              f"T=(c{roof.t_compute*1e3:.1f} m{roof.t_memory*1e3:.1f} "
              f"x{roof.t_collective*1e3:.1f})ms "
              f"bottleneck={roof.bottleneck} "
              f"roofline_frac={roof.roofline_fraction:.3f} "
              f"fits={out['fits']} (predicted at the {H.DEVICE} "
              f"datasheet constants, {H.POWER_W} W; rank {rank})", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--json", default=None, help="append JSONL results here")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank to trace (SPMD makes most alike)")
    args = ap.parse_args(argv)

    from ..configs.base import ARCH_IDS, applicable_shapes, get_config

    archs = [a for a in ARCH_IDS if a != "paper-matvec"] \
        if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    results = []
    # mesh-major: one fake process group a mesh
    for mp in meshes:
        for arch in archs:
            cfg = get_config(arch)
            shapes = applicable_shapes(cfg) if args.shape == "all" \
                else [args.shape]
            for shape in shapes:
                try:
                    results.append(run_cell(arch, shape, mp, args.rank))
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": "multi" if mp else "single",
                                    "rank": args.rank, "ok": False,
                                    "error": repr(e)})
    if args.json:
        with open(args.json, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_)
        sys.exit(1)
    print(f"\nall {len(results)} cells traced OK")


if __name__ == "__main__":
    main()
