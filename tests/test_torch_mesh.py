"""The port's meshes (``launch.mesh``), sharding trees and the train cell
on a mesh, against the JAX package's, on the CPU.

The reference side runs in a subprocess whose JAX sees 16 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=16``, as
``tests/test_dryrun_smoke.py`` isolates its dry-run): ``batch_spec`` /
``batch_axes`` over a table of mesh shapes and batch sizes, ``constrain``'s
resolution (its ``with_sharding_constraint`` is caught), and one train
step of four reduced cells (qwen3, dbrx, mamba2, zamba2) jitted on a
(data 4, model 1) mesh of 4 of the devices.  The port's train cell runs
the same step on four gloo ranks, one process each (a ``FileStore``
under the test's directory, one thread a rank), from the same numpy
parameters, tokens, labels and decode weights; results come back as
``.npz`` files.  The sharding trees are compared in process.  Each
tolerance is stated where it is used.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import params_to_port
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps
from repro_torch.models import api, layers
from repro_torch.optim import adamw
from repro_torch.sharding import local_block

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CPU = "cpu"
#: the four reduced families of the step (tests/test_torch_steps.py's
#: ``reduced``)
FAMILIES = ["qwen3-0.6b", "dbrx-132b", "mamba2-1.3b", "zamba2-1.2b"]
#: the SSM and hybrid families
SSM_FAMILIES = ["mamba2-1.3b", "zamba2-1.2b"]
SHAPE = ShapeConfig("train_small", "train", 16, 4)     # S 16, B 4
#: the MoE at its default capacity factor, where tokens drop, its rows
#: whole groups of moe.GROUP_SIZE a rank (256 tokens a rank over four
#: ranks), which it groups alone
MOE_SHAPE = ShapeConfig("train_moe", "train", 256, 4)  # S 256, B 4


def shape_of(arch: str) -> ShapeConfig:
    return MOE_SHAPE if get_config(arch).num_experts else SHAPE
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
RANKS = 4
# fp32 on both sides, sums in other orders: the loss 1e-5 relative, the
# updated parameters and moments rtol 1e-5 + atol 1e-6, except where the
# reference's gradient, clipped to the global norm as AdamW clips it, lies
# within 1e-6 of zero (and is not 0): AdamW's first step moves an element
# by lr * g / (|g| + eps), so there a rounding of g moves the parameter
# by up to ~lr (tests/test_torch_steps.py's NEAR_ZERO rule, on the
# gradient AdamW reads; such elements must stay under 1 % of all, as
# there)
LOSS_RTOL, RTOL, ATOL, NEAR_ZERO = 1e-5, 1e-5, 1e-6, 1e-6
TIMEOUT = 240
# (mesh shape, axis names) x batch sizes of the spec tables
MESHES = [((4, 4), ("data", "model")), ((16, 1), ("data", "model")),
          ((1, 16), ("data", "model")), ((2, 2, 4), ("pod", "data", "model")),
          ((2, 8, 1), ("pod", "data", "model"))]
BATCHES = [1, 2, 3, 4, 6, 8, 12, 16, 32]
ELEMS = [("batch", None, "model"), ("batch", "model"), (None, "batch"),
         ("model", None, "data"), (None, None, "batch", "model")]
SHAPES = [(8, 16, 32), (6, 4, 5), (3, 7, 4), (16, 12, 8, 2)]

REDUCE = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=211,
              flash_block_kv=32, remat="none", compute_dtype="float32",
              param_dtype="float32")


def reduced(arch: str) -> ModelConfig:
    cfg = get_config(arch)
    kw = dict(REDUCE)
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)))
        kw.update(head_dim=16 if cfg.head_dim else None)
    if cfg.num_experts:
        kw.update(num_experts=4,
                  experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.attn_every:
        kw.update(num_layers=5, attn_every=2, attn_window=16)
    if cfg.family in ("ssm",):
        kw.update(num_heads=0, num_kv_heads=0, d_ff=0)
    return cfg.scaled(**kw)


REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding
from repro.configs.base import ModelConfig, ShapeConfig
from repro.launch import mesh as rmesh
from repro.launch.steps import build_train_cell
from repro.models import api, layers
from repro.optim import adamw
from repro.runtime.coded_step import weighted_loss_fn

job = json.load(open(sys.argv[1]))
out = sys.argv[2]
assert len(jax.devices()) == 16
auto = lambda n: (AxisType.Auto,) * n

# batch specs and constrain's resolution
specs = {"batch": [], "constrain": []}
caught = []
jax.lax.with_sharding_constraint = lambda x, s: caught.append(s.spec) or x
for shape, names in job["meshes"]:
    m = jax.make_mesh(tuple(shape), tuple(names), axis_types=auto(len(shape)))
    for b in job["batches"]:
        specs["batch"].append([list(rmesh.batch_axes(m)),
                               list(rmesh.batch_spec(m, b))])
    with layers.activation_mesh(m):
        for elems in job["elems"]:
            for s in job["shapes"]:
                layers.constrain(jnp.zeros(s), *elems)
                specs["constrain"].append(list(caught.pop()))
json.dump(specs, open(f"{out}/specs.json", "w"))

# one train step of each cell on (data 4, model 1)
mesh = jax.make_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=auto(2))
opt_cfg = adamw.AdamWConfig(**job["opt"])
for cell_job in job["cells"]:
    cfg = ModelConfig(**cell_job["cfg"])
    shape = ShapeConfig(**cell_job["shape"])
    given = np.load(f"{out}/inputs_{cell_job['arch']}.npz")
    params = {}
    for key in given.files:
        if key.startswith("init/"):
            *path, leaf = key[5:].split(".")
            node = params
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = given[key]
    tok, lab, w = (given[k] for k in ("tokens", "labels", "weights"))
    grads = jax.jit(jax.grad(weighted_loss_fn(cfg)))(params, tok, lab, w)
    cell = build_train_cell(cfg, shape, mesh, opt_cfg)
    with layers.activation_mesh(mesh):
        args = jax.device_put((params, adamw.init(opt_cfg, params),
                               tok, lab, w), cell.in_shardings)
        p, o, m = cell.jitted()(*args)
    flat = {"tokens": tok, "labels": lab, "weights": w,
            "loss": np.asarray(m["loss"]),
            "grad_norm": np.asarray(m["grad_norm"])}
    for tag, tree in (("init", params), ("grad", grads), ("param", p),
                      ("mu", o.mu), ("nu", o.nu)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = ".".join(k.key for k in path)
            flat[f"{tag}/{name}"] = np.asarray(leaf, np.float32)
    np.savez(f"{out}/ref_{cell_job['arch']}.npz", **flat)
print("ok")
"""

RANK_SCRIPT = r"""
import datetime, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist

rank, world = int(sys.argv[1]), int(sys.argv[2])
job = json.load(open(sys.argv[3]))
out = job["out"]
dist.init_process_group("gloo", store=dist.FileStore(job["store"], world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch import checkpoint
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import params_to_port
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import adamw

case = job["case"]
if case == "train":
    mesh = pmesh.make_host_mesh(data=world, device="cpu")
    assert mesh.shape == (world, 1), mesh.shape
    opt_cfg = adamw.AdamWConfig(**job["opt"])
    for arch, cell_job in job["cells"].items():
        cfg = ModelConfig(**cell_job["cfg"])
        shape = ShapeConfig(**cell_job["shape"])
        ref = np.load(f"{out}/inputs_{arch}.npz")
        init = {k[5:]: ref[k] for k in ref.files if k.startswith("init/")}
        model = params_to_port(cfg, init, "cpu", trainable=True, mesh=mesh)
        cell = steps.build_train_cell(cfg, shape, opt_cfg, mesh=mesh)
        inputs = cell.shard(*(torch.from_numpy(ref[k]) for k in
                              ("tokens", "labels", "weights")))
        model, opt, m = cell.fn(model, adamw.init(opt_cfg, model), *inputs)
        flat = {"loss": m["loss"].numpy(), "grad_norm": m["grad_norm"].numpy(),
                "rows": np.asarray([cell.rows.start, cell.rows.stop])}
        for n, p in model.named_parameters():
            flat[f"param/{n}"] = p.detach().numpy()
            flat[f"mu/{n}"] = opt.mu[n].numpy()
            flat[f"nu/{n}"] = opt.nu[n].numpy()
        np.savez(f"{out}/port_{arch}_{rank}.npz", **flat)
elif case == "model2":
    mesh = pmesh.make_host_mesh(data=2, device="cpu")
    assert mesh.shape == (2, 2), mesh.shape
    said = {}
    for arch, cfg in job["cfgs"].items():
        cell = steps.build_train_cell(ModelConfig(**cfg),
                                      ShapeConfig(**job["shape"]), mesh=mesh)
        params = cell.materialize(0)[0]
        said[arch] = {"coord": list(mesh.coordinate()),
                      "shapes": {n: list(p.shape)
                                 for n, p in params.named_parameters()}}
    json.dump({"said": said}, open(f"{out}/model2_{rank}.json", "w"))
elif case == "serve":
    from repro_torch._device import generator
    mesh = pmesh.make_host_mesh(data=world, device="cpu")
    flat = {}
    from repro_torch import parallel
    for arch, cfg in job["cells"].items():
        cfg = ModelConfig(**cfg)
        model = api.init_params(cfg, generator(0, "cpu"), mesh=mesh)
        for n, p in model.named_parameters():
            flat[f"{arch}/param/{n}"] = p.detach().numpy()
        parallel.calls.clear()
        x = torch.from_numpy(np.load(job["tokens"]))
        pre = steps.build_prefill_cell(cfg, ShapeConfig(**job["prefill"]),
                                       mesh=mesh)
        flat[f"{arch}/prefill"] = pre.fn(model, *pre.shard(x)).numpy()
        dec = steps.build_decode_cell(cfg, ShapeConfig(**job["decode"]),
                                      mesh=mesh)
        cache = dec.materialize(0)[1]
        for t in range(3):
            lg, cache = dec.fn(model, cache, *dec.shard(x[:, t:t + 1]),
                               torch.tensor(t, dtype=torch.int32))
            flat[f"{arch}/decode{t}"] = lg.numpy()
        rows = dec.rows or slice(0, x.shape[0])
        flat[f"{arch}/rows"] = np.asarray([pre.rows.start, pre.rows.stop,
                                           rows.start, rows.stop])
        flat[f"{arch}/gathers"] = np.asarray(
            parallel.calls[("all_gather", "gloo")])
    np.savez(f"{out}/serve_{rank}.npz", **flat)
elif case == "restore":
    mesh = pmesh.make_host_mesh(data=world, device="cpu")
    cfg = ModelConfig(**job["cfg"])
    like = api.param_shapes(cfg)
    tree, manifest = checkpoint.restore_sharded(
        job["ckpt"], 3, like, pmesh.named(mesh, api.partition_specs(cfg)))
    flat = {n: t.numpy() for n, t in adamw.named(tree).items()}
    assert all(t.device == mesh.device for t in adamw.named(tree).values())
    whole, _ = checkpoint.restore_sharded(
        job["ckpt"], 3, adamw.named(like),
        pmesh.named(mesh, {n: pmesh.P() for n in adamw.named(like)}))
    flat.update({f"whole/{n}": t.numpy() for n, t in whole.items()})
    np.savez(f"{out}/restore_{rank}.npz", **flat)
dist.barrier()
dist.destroy_process_group()
print("ok")
"""


def _run(cmd, env, timeout):
    """Run one process; fail with its error output on a non-zero exit or
    a timeout (the process is killed)."""
    try:
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"timed out after {timeout} s: {e.stderr}")
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def _env(**extra):
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", **extra)


def _ranks(tmp_path: Path, world: int, job: dict, timeout: int = TIMEOUT):
    """Start ``world`` gloo ranks on ``job``; wait for all, kill all on
    expiry or on the first failure."""
    job = dict(job, store=str(tmp_path / f"store_{job['case']}"),
               out=str(tmp_path))
    path = tmp_path / f"job_{job['case']}.json"
    path.write_text(json.dumps(job))
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r),
                               str(world), str(path)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(err[-3000:])
    except subprocess.TimeoutExpired:
        errors.append(f"a rank ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs of each cell (the reference's parameters, numpy tokens,
    labels and decode weights), then the reference's 16-device subprocess
    and the port's four ranks side by side, once for the module."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import ModelConfig as RefConfig
    from repro.models import api as rapi
    tmp = tmp_path_factory.mktemp("mesh")
    cells = {a: {"cfg": dataclasses.asdict(reduced(a)),
                 "shape": dataclasses.asdict(shape_of(a))} for a in FAMILIES}
    for i, arch in enumerate(FAMILIES):
        b, s = shape_of(arch).global_batch, shape_of(arch).seq_len
        params = rapi.init_params(RefConfig(**cells[arch]["cfg"]),
                                  jax.random.PRNGKey(7 + i))
        rng = np.random.default_rng(7 + i)
        np.savez(tmp / f"inputs_{arch}.npz",
                 tokens=rng.integers(0, 211, (b, s)).astype(np.int32),
                 labels=rng.integers(0, 211, (b, s)).astype(np.int32),
                 weights=np.tile(np.asarray([2.0, 0.0], np.float32), b // 2),
                 **{f"init/{n}": np.asarray(t)
                    for n, t in _by_name(params).items()})
    job = {"meshes": MESHES, "batches": BATCHES, "elems": ELEMS,
           "shapes": SHAPES, "opt": OPT,
           "cells": [dict(cells[a], arch=a) for a in FAMILIES]}
    (tmp / "ref.json").write_text(json.dumps(job))
    # the reference's four sharded steps compile in about half the time
    # at backend optimisation level 0
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=16 "
                        "--xla_backend_optimization_level=0")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            str(tmp / "ref.json"), str(tmp)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        _ranks(tmp, RANKS, {"case": "train", "cells": cells, "opt": OPT})
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    return tmp


# --------------------------------------------------------------------------
# Specs: batch_spec, constrain's resolution, the trees
# --------------------------------------------------------------------------

def _abstract(shape, names):
    return pmesh.Mesh(tuple(names), tuple(shape))


def _plain(spec):
    """A spec as JSON would carry it: a list, tuples of names as lists."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_batch_specs_match_reference(runs):
    ref = json.loads((runs / "specs.json").read_text())["batch"]
    ours = []
    for shape, names in MESHES:
        m = _abstract(shape, names)
        for b in BATCHES:
            spec = pmesh.batch_spec(m, b)
            assert isinstance(spec, pmesh.P)
            ours.append([list(pmesh.batch_axes(m)), _plain(spec)])
    assert ours == ref


def test_constrain_resolution_matches_reference(runs):
    """``layers.resolve_spec`` gives the spec the reference's ``constrain``
    hands ``with_sharding_constraint``, on dimensions that divide the
    axes and that do not; ``constrain`` itself is the identity."""
    ref = json.loads((runs / "specs.json").read_text())["constrain"]
    ours = []
    for shape, names in MESHES:
        m = _abstract(shape, names)
        for elems in ELEMS:
            for s in SHAPES:
                ours.append(_plain(layers.resolve_spec(m, s, *elems)))
                x = torch.zeros(s)
                with layers.activation_mesh(m):
                    assert layers.constrain(x, *elems) is x
    assert ours == ref


def _ref_specs(tree):
    """The reference's spec tree with each PartitionSpec as a tuple."""
    from jax.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _ref_specs(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)._make(_ref_specs(v) for v in tree)
    return tuple(_ref_specs(v) for v in tree)


def _ours(tree):
    if isinstance(tree, pmesh.P):
        assert type(tree) is pmesh.P
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _ours(v) for k, v in tree.items()}
    return tuple(_ours(v) for v in tree)


def _by_name(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_name(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_and_cache_specs_match_reference(arch):
    """``api.partition_specs`` / ``cache_specs`` (through ``transformer``,
    ``ssm_lm`` and ``mamba2.layer_specs`` / ``block_state_specs``) equal
    the reference's leaf for leaf, with the reference's axis names and
    others, and the parameter tree is congruent with ``param_shapes``."""
    pytest.importorskip("jax")
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as rapi
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for axes in ((), ("fs", "tp")):
        assert _ours(api.partition_specs(cfg, *axes)) == \
            _ref_specs(rapi.partition_specs(rcfg, *axes))
        assert _ours(api.cache_specs(cfg, *axes)) == \
            _ref_specs(rapi.cache_specs(rcfg, *axes))
    specs = _by_name(api.partition_specs(cfg))
    shapes = _by_name(api.param_shapes(cfg))
    assert sorted(specs) == sorted(shapes)
    for name, spec in specs.items():
        assert len(spec) == shapes[name].dim(), name
    cache = api.cache_shapes(cfg, 2, 8)
    cspecs = api.cache_specs(cfg)
    if isinstance(cache, dict):
        cache, cspecs = _by_name(cache), _by_name(cspecs)
        assert sorted(cache) == sorted(cspecs)
        pairs = [(cache[k], cspecs[k]) for k in cache]
    else:
        pairs = list(zip(cache, cspecs))
    assert all(len(s) == t.dim() for t, s in pairs)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-235b-a22b",
                                  "mamba2-1.3b", "zamba2-1.2b"])
def test_state_specs_match_reference(arch):
    pytest.importorskip("jax")
    from repro.configs.base import get_config as ref_get_config
    from repro.models import api as rapi
    from repro.optim import adamw as radamw
    ref = radamw.state_specs(rapi.partition_specs(ref_get_config(arch)))
    ours = adamw.state_specs(api.partition_specs(get_config(arch)))
    assert tuple(ours.step) == tuple(ref.step) == ()
    for mine, theirs in ((ours.mu, ref.mu), (ours.nu, ref.nu)):
        assert {n: tuple(s) for n, s in mine.items()} == \
            _by_name(_ref_specs(theirs))
    meta = adamw.state_shapes(adamw.AdamWConfig(),
                              api.param_shapes(get_config(arch)))
    assert sorted(ours.mu) == sorted(meta.mu)


def test_named_pairs_each_spec_with_the_mesh():
    m = _abstract((4, 1), ("data", "model"))
    tree = pmesh.named(m, api.cache_specs(get_config("zamba2-1.2b")))
    assert tree["attn_k"] == pmesh.NamedSharding(
        m, pmesh.P(None, None, None, "model", None))
    assert isinstance(tree["ssm"]["h"], pmesh.NamedSharding)
    pair = pmesh.named(m, api.cache_specs(get_config("qwen3-0.6b")))
    assert isinstance(pair, tuple) and pair[0].spec == \
        pmesh.P(None, "data", None, None, "model")
    state = pmesh.named(m, adamw.state_specs(
        api.partition_specs(get_config("qwen3-0.6b"))))
    assert type(state) is adamw.OptState and state.step.spec == pmesh.P()
    assert state.mu["layers.wq"].spec == pmesh.P(None, "data", "model", None)


# --------------------------------------------------------------------------
# The train cell on four gloo ranks against the reference's on 4 devices
# --------------------------------------------------------------------------

def _leafwise(ours: dict, ref, tag: str, skip: dict):
    """Every ``tag/`` leaf within RTOL + ATOL of the reference's, outside
    its near-zero-gradient elements ``skip``."""
    for key in getattr(ref, "files", ref):
        if not key.startswith(f"{tag}/"):
            continue
        ok = ~skip[key[len(tag) + 1:]]
        np.testing.assert_allclose(ours[key][ok], ref[key][ok], rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def _one_device_step(arch: str, ref) -> dict:
    """The port's one-device train cell (no mesh) from the same state."""
    cfg = reduced(arch)
    init = {k[5:]: ref[k] for k in ref.files if k.startswith("init/")}
    model = params_to_port(cfg, init, CPU, trainable=True)
    opt_cfg = adamw.AdamWConfig(**OPT)
    cell = steps.build_train_cell(cfg, shape_of(arch), opt_cfg, device=CPU)
    assert cell.rows is None and cell.mesh is None
    model, opt, m = cell.fn(model, adamw.init(opt_cfg, model),
                            *(torch.from_numpy(ref[k]) for k in
                              ("tokens", "labels", "weights")))
    flat = {"loss": m["loss"].numpy()}
    for n, p in model.named_parameters():
        flat[f"param/{n}"] = p.detach().numpy()
        flat[f"mu/{n}"], flat[f"nu/{n}"] = opt.mu[n].numpy(), opt.nu[n].numpy()
    return flat


def _blocks_of(arch: str, flat: dict, rank: int) -> dict:
    """Rank ``rank``'s blocks of the whole leaves ``flat`` on (data 4,
    model 1), by ``partition_specs`` (FSDP over data; ``api.placement``)."""
    specs = api.placement(reduced(arch))
    out = {}
    for key, value in flat.items():
        tag, _, name = key.partition("/")
        if tag in ("param", "mu", "nu", "grad"):
            out[key] = value[_rank_block(specs[name], value.shape, rank)]
        else:
            out[key] = value
    return out


def _rank_block(spec, shape, rank: int, ranks: int = RANKS):
    """The slices of ``rank``'s block on (data ``ranks``, model 1)."""
    class At:
        axis_names, sizes, size = ("data", "model"), {"data": ranks,
                                                      "model": 1}, ranks

        def coordinate(self):
            return (rank, 0)
    return local_block(At(), spec, shape)


@pytest.mark.parametrize("arch", FAMILIES)
def test_four_gloo_ranks_match_reference_mesh_step(runs, arch):
    """One train step on four gloo ranks (a row each) against the
    reference's cell jitted on (data 4, model 1): the loss within
    LOSS_RTOL, and each rank's parameters and moments within RTOL + ATOL
    of the reference's and of the port's one-device cell's.  Every family
    holds the reference's blocks (FSDP: the gathers reduce-scatter the
    gradients; the leaves replicated over data, one flat all-reduce,
    bit-equal on every rank).  The MoE
    (dbrx) runs at its default capacity factor, where tokens drop, with a
    rank's row one whole token group (MOE_SHAPE)."""
    ref = np.load(runs / f"ref_{arch}.npz")
    ranks = [dict(np.load(runs / f"port_{arch}_{r}.npz"))
             for r in range(RANKS)]
    assert [tuple(r["rows"]) for r in ranks] == [(i, i + 1)
                                                 for i in range(RANKS)]
    clip = min(1.0, adamw.AdamWConfig(**OPT).clip_norm
               / float(ref["grad_norm"]))
    skip = {k[5:]: (np.abs(ref[k]) * clip <= NEAR_ZERO) & (ref[k] != 0)
            for k in ref.files if k.startswith("grad/")}
    skipped = sum(int(m.sum()) for m in skip.values())
    assert skipped < 0.01 * sum(m.size for m in skip.values()), skipped
    one = _one_device_step(arch, ref)
    specs = api.placement(reduced(arch))
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], ref["grad_norm"],
                                   rtol=LOSS_RTOL)
        mine = _blocks_of(arch, dict(ref), i)
        mine_one = _blocks_of(arch, one, i)
        mine_skip = {n: m[_rank_block(api.placement(reduced(arch))[n],
                                      m.shape, i)] for n, m in skip.items()}
        for key in r:
            if key.split("/")[0] in ("param", "mu", "nu"):
                assert r[key].shape == mine[key].shape, key
                spec = specs[key.split("/", 1)[1]]
                if not any("data" in pmesh.axes_of(e) for e in spec):
                    assert np.array_equal(r[key], ranks[0][key]), key
        for tag in ("param", "mu", "nu"):
            _leafwise(r, mine, tag, mine_skip)
            for key in one:
                if key.startswith(f"{tag}/"):
                    ok = ~mine_skip[key[len(tag) + 1:]]
                    np.testing.assert_allclose(r[key][ok],
                                               mine_one[key][ok],
                                               rtol=RTOL, atol=ATOL)
    for tag in ("param", "mu", "nu"):
        _leafwise(one, ref, tag, skip)
    np.testing.assert_allclose(one["loss"], ranks[0]["loss"], rtol=LOSS_RTOL)


# --------------------------------------------------------------------------
# One gloo run per case
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    """Four gloo ranks on make_host_mesh(data=2), which is (2, 2): what
    building the train cell of each family said."""
    tmp = tmp_path_factory.mktemp("model2")
    archs = ["qwen3-0.6b"] + SSM_FAMILIES
    _ranks(tmp, 4, {"case": "model2",
                    "cfgs": {a: dataclasses.asdict(reduced(a))
                             for a in archs},
                    "shape": dataclasses.asdict(SHAPE)})
    return [json.loads((tmp / f"model2_{r}.json").read_text())["said"]
            for r in range(4)]


@pytest.mark.parametrize("arch", SSM_FAMILIES)
def test_train_cell_on_a_model_axis_raises(model2, arch):
    """On (2, 2) an ssm or hybrid config's train cell builds, as a
    transformer family's, and the parameters it draws are each rank's
    blocks of the trees (``partition_specs``: inner channels, heads and
    vocab over model, FSDP over data); it raises no more."""
    for said in model2:
        view = pmesh.Mesh(("data", "model"), (2, 2))
        for a in ("qwen3-0.6b", arch):
            cfg = reduced(a)
            shapes = {n: tuple(t.shape)
                      for n, t in adamw.named(api.param_shapes(cfg)).items()}
            want = {n: list(_at(view, said[a]["coord"], spec,
                                shapes[n]))
                    for n, spec in api.placement(cfg).items()}
            assert said[a]["shapes"] == want, a


def test_prefill_and_decode_cells_on_two_ranks_need_no_collective(tmp_path):
    """Two gloo ranks on (data 2, model 1), each holding its blocks
    (``Cell.materialize``'s draw: both families' leaves FSDP-sharded,
    which their cells gather over data): the blocks are the one-device
    parameters'; the prefill cell and three decode steps give each rank
    its batch_spec rows of the one-device cell's logits, where
    ``cache_specs`` shards the batch (qwen3's KV cache) and where it does
    not (zamba2's state, replicated as in the reference: the step
    gathers the tokens and runs every row); within 1e-5 of each step's
    max |logit| (fp32, products over fewer rows)."""
    from repro_torch._device import generator
    archs = ["qwen3-0.6b", "zamba2-1.2b"]
    prefill = ShapeConfig("p", "prefill", 16, 4)
    decode = ShapeConfig("d", "decode", 8, 4)
    x = np.random.default_rng(9).integers(0, 211, (4, 16)).astype(np.int32)
    np.save(tmp_path / "tokens.npy", x)
    _ranks(tmp_path, 2, {"case": "serve",
                         "cells": {a: dataclasses.asdict(reduced(a))
                                   for a in archs},
                         "prefill": dataclasses.asdict(prefill),
                         "decode": dataclasses.asdict(decode),
                         "tokens": str(tmp_path / "tokens.npy")})
    t = torch.from_numpy(x)
    for arch in archs:
        cfg = reduced(arch)
        model = api.init_params(cfg, generator(0, CPU))
        want = {"prefill": steps.build_prefill_cell(cfg, prefill, CPU).fn(
            model, t).numpy()}
        dec = steps.build_decode_cell(cfg, decode, CPU)
        cache = dec.materialize(0)[1]
        for i in range(3):
            lg, cache = dec.fn(model, cache, t[:, i:i + 1],
                               torch.tensor(i, dtype=torch.int32))
            want[f"decode{i}"] = lg.numpy()
        specs = api.placement(cfg)
        for r in range(2):
            got = np.load(tmp_path / f"serve_{r}.npz")
            for n, p in model.named_parameters():
                block = _rank_block(specs[n], p.shape, r, ranks=2)
                assert np.array_equal(got[f"{arch}/param/{n}"],
                                      p.detach().numpy()[block]), n
            assert int(got[f"{arch}/gathers"]) > 0
            p0, p1, d0, d1 = got[f"{arch}/rows"]
            assert (p0, p1) == (d0, d1) == (2 * r, 2 * r + 2)
            for key, ref in want.items():
                rows = slice(p0, p1) if key == "prefill" else slice(d0, d1)
                scale = float(np.abs(ref).max())
                np.testing.assert_allclose(got[f"{arch}/{key}"], ref[rows],
                                           rtol=0, atol=1e-5 * scale)


def test_restore_sharded_gives_each_rank_the_checkpoint(tmp_path):
    """zamba2's checkpoint restored on two gloo ranks: by the reference's
    ``partition_specs`` each rank gets its block of every leaf (GSPMD's
    placement, here over data), by replicated specs every leaf whole; bit
    for bit the saved values."""
    from repro_torch import checkpoint
    from repro_torch._device import generator
    cfg = reduced("zamba2-1.2b")
    model = api.init_params(cfg, generator(5, CPU))
    checkpoint.save(str(tmp_path / "ckpt"), 3, model)
    _ranks(tmp_path, 2, {"case": "restore", "cfg": dataclasses.asdict(cfg),
                         "ckpt": str(tmp_path / "ckpt")})
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    specs = adamw.named(api.partition_specs(cfg))
    for r in range(2):
        got = dict(np.load(tmp_path / f"restore_{r}.npz"))
        assert sorted(got) == sorted(want) + sorted(f"whole/{n}"
                                                     for n in want)
        for n in want:
            block = want[n][_rank_block(specs[n], want[n].shape, r, 2)]
            assert got[n].dtype == want[n].dtype
            assert np.array_equal(got[n], block), n
            assert np.array_equal(got[f"whole/{n}"], want[n]), n


# --------------------------------------------------------------------------
# In process: meshes of names and sizes, the rows, the production mesh
# --------------------------------------------------------------------------

def test_local_rows_are_gspmd_blocks_first_axis_major():
    m = pmesh.Mesh(("pod", "data", "model"), (2, 4, 1))
    assert pmesh.local_rows(m, ("pod", "data"), 16) == slice(0, 2)
    assert pmesh.local_rows(m, None, 16) == slice(0, 16)
    with pytest.raises(ValueError, match="do not split"):
        pmesh.local_rows(m, ("pod", "data"), 12)
    assert pmesh.axes_of(("pod", "data")) == ("pod", "data")
    assert pmesh.axes_of("data") == ("data",) and pmesh.axes_of(None) == ()


def test_production_mesh_needs_its_rank_count():
    """Without a process group the world is one rank: both production
    meshes raise, naming their size."""
    assert pmesh.SINGLE_POD == (16, 16) and pmesh.MULTI_POD == (2, 16, 16)
    with pytest.raises(ValueError, match="256 ranks"):
        pmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        pmesh.make_production_mesh(multi_pod=True)


def _at(view, coord, spec, shape):
    """The shape of the block at ``coord`` of a mesh of names and sizes."""
    class At:
        axis_names, sizes, size = view.axis_names, view.sizes, view.size

        def coordinate(self):
            return tuple(coord)
    return pmesh.shard_shape(At(), spec, shape)


@pytest.mark.parametrize("arch", SSM_FAMILIES)
def test_cells_on_a_model_axis_raise_before_placing_anything(arch):
    """The three ``build_*_cell`` functions and ``api.init_cache`` of an
    ssm or hybrid config build on a mesh of names and sizes with model 2 (they raise no more;
    the modules, which name process groups, are placed on real ranks in
    ``test_train_cell_on_a_model_axis_raises``): the cells' rows are the
    ``batch_spec`` rows at the mesh's coordinate (0, 0), the cache the
    block shapes of ``cache_specs`` there (the SSM state over its heads
    and inner channels, the hybrid's ring over its KV heads)."""
    m = pmesh.Mesh(("data", "model"), (2, 2))
    cfg = reduced(arch)
    for build in (steps.build_train_cell, steps.build_prefill_cell,
                  steps.build_decode_cell):
        assert build(cfg, SHAPE, mesh=m).rows == slice(0, 2)
    cache = api.init_cache(cfg, 2, 8, device=CPU, mesh=m)
    whole = api.cache_shapes(cfg, 2, 8)
    cspecs = api.cache_specs(cfg)
    for k in ("attn_k",) if "attn_k" in cache else ():
        assert tuple(cache[k].shape) == pmesh.shard_shape(
            m, cspecs[k], whole[k].shape)
    for k, t in cache["ssm"].items():
        assert tuple(t.shape) == pmesh.shard_shape(
            m, cspecs["ssm"][k], whole["ssm"][k].shape)


def test_moe_cells_raise_where_a_rank_holds_part_of_a_token_group():
    """The reduced dbrx on (data 2, model 1): every ``build_*_cell``
    function builds where a rank's tokens are not whole groups of
    ``moe.GROUP_SIZE`` (train and prefill at S 16: 32 tokens a rank;
    decode: 2; the MoE then forms the reference's global groups from both
    ranks' tokens), as where they are (MOE_SHAPE: 512) and where the batch
    does not split (B 3: every rank holds it all); none raises now."""
    m = pmesh.Mesh(("data", "model"), (2, 1))
    cfg = reduced("dbrx-132b")
    for build, shape in ((steps.build_train_cell, SHAPE),
                         (steps.build_prefill_cell,
                          ShapeConfig("p", "prefill", 16, 4)),
                         (steps.build_decode_cell,
                          ShapeConfig("d", "decode", 16, 4))):
        assert build(cfg, shape, mesh=m).rows == slice(0, 2)
    assert steps.build_train_cell(cfg, MOE_SHAPE, mesh=m).rows == slice(0, 2)
    whole = steps.build_train_cell(cfg, ShapeConfig("t", "train", 16, 3),
                                   mesh=m)
    assert whole.rows == slice(0, 3)
    assert steps.build_train_cell(reduced("qwen3-0.6b"), SHAPE,
                                  mesh=m).rows == slice(0, 2)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

CARD_SCRIPT = r"""
import json, sys
import torch
from repro_torch._device import generator
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.optim import adamw
import torch.distributed as dist

torch.backends.cuda.matmul.allow_tf32 = False
job = json.loads(sys.argv[1])
cfg = ModelConfig(**job["cfg"])
shape = ShapeConfig(**job["shape"])
mesh = make_host_mesh()
assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
one = api.init_params(cfg, generator(3, "cuda"), trainable=True)
meshed = api.init_params(cfg, generator(3, "cuda"), trainable=True, mesh=mesh)
opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2)
o1, o2 = adamw.init(opt_cfg, one), adamw.init(opt_cfg, meshed)
plain = steps.build_train_cell(cfg, shape, opt_cfg, "cuda")
cell = steps.build_train_cell(cfg, shape, opt_cfg, mesh=mesh)
x, lab, w = plain.materialize(4)[2:]
equal = []
for _ in range(2):
    one, o1, m1 = plain.fn(one, o1, x, lab, w)
    flash_attention.launches = 0
    meshed, o2, m2 = cell.fn(meshed, o2, *cell.shard(x, lab, w))
    equal.append(float(m1["loss"]) == float(m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(one.parameters(),
                                          meshed.parameters())))
dist.destroy_process_group()
print(json.dumps({"equal": equal, "launches": flash_attention.launches}))
"""


@pytest.mark.gpu
def test_one_nccl_rank_is_the_one_device_cell_on_the_card():
    """On the card: ``make_host_mesh()`` starts a one-rank NCCL group; two
    train-cell steps on it (its flat all-reduce included) leave the loss
    and every parameter bit for bit the one-device cell's, and the step
    launches the flash kernel twice a layer (remat "full")."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL and the CUDA kernels have "
                    "no CPU mode")
    cfg = reduced("qwen3-0.6b").scaled(remat="full")
    job = json.dumps({"cfg": dataclasses.asdict(cfg),
                      "shape": dataclasses.asdict(SHAPE)})
    out = _run([sys.executable, "-c", CARD_SCRIPT, job], _env(), TIMEOUT)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["equal"] == [True, True]
    assert res["launches"] == 2 * cfg.num_layers
