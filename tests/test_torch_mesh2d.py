"""The transformer families' train, prefill and decode cells on two-axis
meshes (FSDP over ``data``; heads, FFN, experts and vocab over ``model``),
against the JAX package's cells jitted on the same meshes, on the CPU.

The reference side is one subprocess whose JAX sees 16 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=16``, as
``tests/test_torch_mesh.py``): every case's cells jitted on a (data 2,
model 2) and a (data 1, model 4) mesh, and the train cell of one case on
a (pod 2, data 1, model 2) mesh; for each output its global value and
its ``sharding.shard_shape``, and the one-device gradient of each train
case.  The port runs the same cells on four gloo ranks a mesh (one
process a rank, a ``FileStore`` under the test's directory) from the same
numpy parameters and inputs, each rank holding its blocks; results come
back as ``.npz`` files, one a rank.  Each rank's shapes must be the
reference's shard shapes and its values the matching block, within the
tolerances stated where they are used.  The reduced configs have 16
query heads, so that ``partition_specs`` puts the heads over ``model``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as pmesh
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.sharding import local_block

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RANKS = 4
TIMEOUT = 300
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
REDUCE = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=211,
              flash_block_kv=32, compute_dtype="float32",
              param_dtype="float32", num_heads=16, head_dim=16)
#: name -> (arch, overrides, cells).  qwen3: GQA 16/8 with qk_norm (KV
#: heads replicated over model, the cache's head dim sharded); deepseek:
#: 16/16 (KV heads over model); kv2: 16/2, so at model 4 two ranks share
#: each KV head; dbrx-ep: 16 experts over model; dbrx-tp: 4 experts, their
#: FFN columns over model; hubert: the encoder on embeddings; internvl2:
#: decode of embeddings.  The remat modes vary over the cases.
CASES = {
    "qwen3": ("qwen3-0.6b", dict(num_kv_heads=8, remat="full"),
              ("train", "prefill", "decode")),
    "deepseek": ("deepseek-7b", dict(num_kv_heads=16, remat="dots"),
                 ("train", "prefill", "decode")),
    "kv2": ("yi-9b", dict(num_kv_heads=2, remat="none"),
            ("train", "prefill", "decode")),
    "dbrx-ep": ("dbrx-132b", dict(num_kv_heads=8, num_experts=16,
                                  experts_per_token=2, remat="none"),
                ("train", "prefill", "decode")),
    "dbrx-tp": ("dbrx-132b", dict(num_kv_heads=8, num_experts=4,
                                  experts_per_token=2, remat="full"),
                ("train", "prefill")),
    "hubert": ("hubert-xlarge", dict(num_kv_heads=16, remat="none"),
               ("train", "prefill")),
    "internvl2": ("internvl2-76b", dict(num_kv_heads=8, remat="none"),
                  ("decode",)),
}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "pod": ((2, 1, 2), ("pod", "data", "model"))}
#: the pod mesh runs qwen3's train cell only
POD_CASE = "qwen3"
B, S, DECODE_LEN, DECODE_STEPS = 4, 16, 8, 4
#: an MoE's data rank holds whole token groups of 256 here (models.moe's
#: local groups): two rows of 128 a data rank at data 2
#: (tests/test_torch_mesh2d_ssm.py holds the part groups)
MOE_S = 128
# fp32 on both sides, sums in other orders (and over ranks).  The loss and
# grad norm 1e-5 relative; the updated parameters and moments rtol 1e-5 +
# atol 1e-6 outside the elements whose clipped reference gradient lies
# within 1e-6 of zero (tests/test_torch_mesh.py's NEAR_ZERO rule: AdamW's
# first step moves an element by lr * g / (|g| + eps), so there a rounding
# of g moves the parameter by up to ~lr: those are held to 2 lr instead,
# and must stay under 2 % of all: the 16-expert MoE's experts see few of
# its 512 tokens, and 1.8 % of its gradient lies there); every gradient
# block within 1e-5 of its leaf's max |g|; the
# logits within 1e-4 of max |logits| (tests/test_torch_steps.py's
# MODEL_TOL: the cache rounds keys and values to bf16); the bf16 cache
# within one bf16 step, 2^-7 relative
LOSS_RTOL, RTOL, ATOL, NEAR_ZERO = 1e-5, 1e-5, 1e-6, 1e-6
GRAD_TOL, MODEL_TOL, CACHE_RTOL = 1e-5, 1e-4, 2.0 ** -7


def reduced(name: str) -> ModelConfig:
    arch, over, _ = CASES[name]
    return get_config(arch).scaled(**dict(REDUCE, **over))


def seq_of(name: str) -> int:
    return MOE_S if reduced(name).num_experts else S


def meshes_of(name: str):
    """The meshes of a case's cells: an MoE's decode only at data 1 here
    (at data 2 a decode step's B tokens are part groups a data rank:
    tests/test_torch_mesh2d_ssm.py)."""
    out = ["2x2", "1x4"] + (["pod"] if name == POD_CASE else [])
    return out


def cells_on(name: str, mesh: str):
    cells = CASES[name][2]
    if mesh == "pod":
        return ("train",)
    if mesh == "2x2" and reduced(name).num_experts:
        return tuple(c for c in cells if c != "decode")
    return cells


REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import ModelConfig, ShapeConfig
from repro.launch.steps import (build_decode_cell, build_prefill_cell,
                                build_train_cell)
from repro.models import api, layers
from repro.optim import adamw
from repro.runtime.coded_step import weighted_loss_fn

job = json.load(open(sys.argv[1]))
out = sys.argv[2]
assert len(jax.devices()) == 16
opt_cfg = adamw.AdamWConfig(**job["opt"])


def put(flat, key, x):
    flat[key] = np.asarray(x, np.float32)
    flat["shape/" + key] = np.asarray(x.sharding.shard_shape(x.shape))


def leaves(flat, tag, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        put(flat, tag + "/" + ".".join(k.key for k in path), leaf)


for case in job["cases"]:
    cfg = ModelConfig(**case["cfg"])
    given = np.load(f"{out}/inputs_{case['name']}.npz")
    params = {}
    for key in given.files:
        if key.startswith("init/"):
            *path, leaf = key[5:].split(".")
            node = params
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = given[key]
    tok, lab, w = (given[k] for k in ("tokens", "labels", "weights"))
    if "grads" in case:
        grads = jax.jit(jax.grad(weighted_loss_fn(cfg)))(params, tok, lab, w)
        np.savez(f"{out}/grad_{case['name']}.npz", **{
            ".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]})
    for mesh_name, (shape, names), cells in case["meshes"]:
        n = int(np.prod(shape))
        mesh = jax.make_mesh(tuple(shape), tuple(names),
                             devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * len(shape))
        flat = {}
        with layers.activation_mesh(mesh):
            if "train" in cells:
                cell = build_train_cell(cfg, ShapeConfig(**case["train"]),
                                        mesh, opt_cfg)
                args = jax.device_put((params, adamw.init(opt_cfg, params),
                                       tok, lab, w), cell.in_shardings)
                p, o, m = cell.jitted()(*args)
                leaves(flat, "param", p)
                leaves(flat, "mu", o.mu)
                leaves(flat, "nu", o.nu)
                flat["loss"] = np.asarray(m["loss"])
                flat["grad_norm"] = np.asarray(m["grad_norm"])
            if "prefill" in cells:
                cell = build_prefill_cell(cfg, ShapeConfig(**case["train"]),
                                          mesh)
                args = jax.device_put((params, tok), cell.in_shardings)
                put(flat, "prefill", cell.jitted()(*args))
            if "decode" in cells:
                cell = build_decode_cell(cfg, ShapeConfig(**case["decode"]),
                                         mesh)
                x = given["decode_tokens"]
                b, s = x.shape[0], case["decode"]["seq_len"]
                p, cache = jax.device_put(
                    (params, api.init_cache(cfg, b, s)),
                    cell.in_shardings[:2])
                step = cell.jitted()
                for t in range(x.shape[1]):
                    tt, pos = jax.device_put(
                        (x[:, t:t + 1], jnp.int32(t)), cell.in_shardings[2:])
                    lg, cache = step(p, cache, tt, pos)
                    put(flat, f"decode{t}", lg)
                put(flat, "cache_k", cache[0])
                put(flat, "cache_v", cache[1])
        np.savez(f"{out}/ref_{case['name']}_{mesh_name}.npz", **flat)
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
                        timeout=datetime.timedelta(seconds=120))
from repro_torch import checkpoint, parallel
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import params_to_port
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import adamw

shape, names = job["mesh"]
mesh = pmesh._mesh(torch.device("cpu"), tuple(shape), tuple(names))
flat = {"coord": np.asarray(mesh.coordinate())}
if job["case"] == "cells":
    opt_cfg = adamw.AdamWConfig(**job["opt"])
    for case in job["cases"]:
        cfg, name = ModelConfig(**case["cfg"]), case["name"]
        given = np.load(f"{out}/inputs_{name}.npz")
        init = {k[5:]: given[k] for k in given.files if k.startswith("init/")}
        tok, lab, w = (torch.from_numpy(given[k])
                       for k in ("tokens", "labels", "weights"))
        if "train" in case["cells"]:
            model = params_to_port(cfg, init, trainable=True, mesh=mesh)
            cell = steps.build_train_cell(cfg, ShapeConfig(**case["train"]),
                                          opt_cfg, mesh=mesh)
            inputs = cell.shard(tok, lab, w)
            _, grads = cell.grad_step(model, *inputs)
            model, opt, m = cell.fn(model, adamw.init(opt_cfg, model),
                                    *inputs)
            flat[f"{name}/loss"] = m["loss"].numpy()
            flat[f"{name}/grad_norm"] = m["grad_norm"].numpy()
            for n, p in model.named_parameters():
                flat[f"{name}/grad/{n}"] = grads[n].numpy()
                flat[f"{name}/param/{n}"] = p.detach().numpy()
                flat[f"{name}/mu/{n}"] = opt.mu[n].numpy()
                flat[f"{name}/nu/{n}"] = opt.nu[n].numpy()
        model = params_to_port(cfg, init, mesh=mesh)
        if "prefill" in case["cells"]:
            pre = steps.build_prefill_cell(cfg, ShapeConfig(**case["train"]),
                                           mesh=mesh)
            flat[f"{name}/prefill"] = pre.fn(model, *pre.shard(tok)).numpy()
        if "decode" in case["cells"]:
            dec = steps.build_decode_cell(cfg, ShapeConfig(**case["decode"]),
                                          mesh=mesh)
            cache = dec.materialize(0)[1]
            x = torch.from_numpy(given["decode_tokens"])
            for t in range(x.shape[1]):
                lg, cache = dec.fn(model, cache, *dec.shard(x[:, t:t + 1]),
                                   torch.tensor(t, dtype=torch.int32))
                flat[f"{name}/decode{t}"] = lg.numpy()
            flat[f"{name}/cache_k"] = cache[0].float().numpy()
            flat[f"{name}/cache_v"] = cache[1].float().numpy()
    flat["calls"] = np.asarray(json.dumps(
        {f"{op}/{be}": n for (op, be), n in parallel.calls.items()}))
elif job["case"] == "save":
    from repro_torch._device import generator
    cfg = ModelConfig(**job["cfg"])
    model = api.init_params(cfg, generator(5, "cpu"), trainable=True,
                            mesh=mesh)
    state = adamw.init(adamw.AdamWConfig(), model)
    for n, p in model.named_parameters():
        state.mu[n].copy_(2 * p.detach())
        state.nu[n].copy_(p.detach().abs())
    specs = api.partition_specs(cfg)
    shard = {"params": pmesh.named(mesh, adamw.named(specs)),
             "opt": pmesh.named(mesh, adamw.state_specs(specs))}
    checkpoint.save(job["ckpt"], 3, {"params": model, "opt": state},
                    shardings=shard)
elif job["case"] == "restore":
    cfg = ModelConfig(**job["cfg"])
    specs = api.partition_specs(cfg)
    like = {"params": api.param_shapes(cfg),
            "opt": adamw.state_shapes(adamw.AdamWConfig(),
                                      api.param_shapes(cfg))}
    shard = {"params": pmesh.named(mesh, specs),
             "opt": pmesh.named(mesh, adamw.state_specs(specs))}
    tree, _ = checkpoint.restore_sharded(job["ckpt"], 3, like, shard)
    assert tree["opt"].step == 0
    for n, t in adamw.named(tree["params"]).items():
        flat[f"params/{n}"] = t.numpy()
    for n, t in tree["opt"].mu.items():
        flat[f"mu/{n}"] = t.numpy()
np.savez(f"{out}/{job['tag']}_{rank}.npz", **flat)
dist.barrier()
dist.destroy_process_group()
print("ok")
"""


def _env(**extra):
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", **extra)


def _start_ranks(tmp: Path, job: dict):
    """Start RANKS gloo ranks on ``job``; returns the processes."""
    job = dict(job, store=str(tmp / f"store_{job['tag']}"), out=str(tmp))
    path = tmp / f"job_{job['tag']}.json"
    path.write_text(json.dumps(job))
    return [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r),
                              str(RANKS), str(path)], env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(RANKS)]


def _wait(procs, timeout: int = TIMEOUT) -> None:
    """Wait for every process; kill all on expiry or on the first failure
    and fail with their error output."""
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
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


def _by_name(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_name(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _case_job(name: str) -> dict:
    s = seq_of(name)
    return {"name": name, "cfg": dataclasses.asdict(reduced(name)),
            "train": dataclasses.asdict(ShapeConfig("t", "train", s, B)),
            "decode": dataclasses.asdict(
                ShapeConfig("d", "decode", DECODE_LEN, B))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's inputs (the reference's parameters from a seed, numpy
    inputs), then the reference's 16-device subprocess and the port's
    ranks on each mesh side by side, once for the module."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import ModelConfig as RefConfig
    from repro.models import api as rapi
    tmp = tmp_path_factory.mktemp("mesh2d")
    ref_cases = []
    for i, name in enumerate(CASES):
        cfg = reduced(name)
        s = seq_of(name)
        params = rapi.init_params(RefConfig(**dataclasses.asdict(cfg)),
                                  jax.random.PRNGKey(11 + i))
        rng = np.random.default_rng(11 + i)
        if cfg.embedding_inputs:
            tokens = rng.standard_normal((B, s, cfg.d_model), np.float32)
            dec = rng.standard_normal((B, DECODE_STEPS, cfg.d_model),
                                      np.float32)
        else:
            tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
            dec = rng.integers(0, cfg.vocab_size,
                               (B, DECODE_STEPS)).astype(np.int32)
        np.savez(tmp / f"inputs_{name}.npz", tokens=tokens,
                 labels=rng.integers(0, cfg.vocab_size, (B, s)).astype(
                     np.int32),
                 weights=np.asarray([2.0, 0.0, 1.5, 0.5], np.float32),
                 decode_tokens=dec,
                 **{f"init/{n}": np.asarray(t)
                    for n, t in _by_name(params).items()})
        job = _case_job(name)
        if "train" in CASES[name][2]:
            job["grads"] = True
        job["meshes"] = [(m, MESHES[m], cells_on(name, m))
                         for m in meshes_of(name)]
        ref_cases.append(job)
    (tmp / "ref.json").write_text(json.dumps({"opt": OPT,
                                              "cases": ref_cases}))
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=16 "
                         "--xla_backend_optimization_level=0")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            str(tmp / "ref.json"), str(tmp)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        for mesh in MESHES:
            cases = [dict(_case_job(n), cells=cells_on(n, mesh))
                     for n in CASES if mesh in meshes_of(n)]
            _wait(_start_ranks(tmp, {"case": "cells", "tag": mesh,
                                     "mesh": MESHES[mesh], "opt": OPT,
                                     "cases": cases}))
        _wait([ref])
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    return tmp


class RankView:
    """A mesh of names and sizes at rank ``r``'s coordinate, to cut the
    reference's global values into that rank's blocks."""

    def __init__(self, shape, names, coord):
        self.axis_names, self.shape = tuple(names), tuple(shape)
        self.sizes = dict(zip(names, shape))
        self.size = int(np.prod(shape))
        self._coord = tuple(int(c) for c in coord)

    def coordinate(self):
        return self._coord


def _ranks(runs, mesh: str):
    shape, names = MESHES[mesh]
    out = []
    for r in range(RANKS):
        got = dict(np.load(runs / f"{mesh}_{r}.npz"))
        assert tuple(got["coord"]) == tuple(np.unravel_index(r, shape))
        out.append((RankView(shape, names, got["coord"]), got))
    return out


def _cut(view, spec, glob):
    return glob[local_block(view, spec, glob.shape)]


def _spec_of(cfg, tag: str, mesh: str):
    """The output spec the reference's cells place ``tag`` by."""
    rows = pmesh.batch_spec(pmesh.Mesh(*reversed(MESHES[mesh])), B)[0]
    if tag == "prefill" or tag.startswith("decode"):
        return pmesh.P(rows if tag == "prefill" else
                       api.cache_specs(cfg)[0][1], None, "model")
    if tag.startswith("cache"):
        return api.cache_specs(cfg)[0]
    return adamw.named(api.partition_specs(cfg))[tag.split("/", 1)[1]]


def _check(view, got, ref, cfg, mesh, key, name, **tol):
    """The rank's ``name/key`` has the reference's shard shape and, within
    ``tol``, the values of the reference's block."""
    glob = ref[key]
    want = _cut(view, _spec_of(cfg, key, mesh), glob)
    assert want.shape == tuple(ref[f"shape/{key}"]), key
    ours = got[f"{name}/{key}"]
    assert ours.shape == want.shape, (key, ours.shape, want.shape)
    np.testing.assert_allclose(ours, want, err_msg=f"{name} {mesh} {key}",
                               **tol)
    return want


def _train_checks(runs, name: str, mesh: str) -> None:
    cfg = reduced(name)
    ref = np.load(runs / f"ref_{name}_{mesh}.npz")
    grad = np.load(runs / f"grad_{name}.npz")
    clip = min(1.0, adamw.AdamWConfig(**OPT).clip_norm
               / float(ref["grad_norm"]))
    specs = adamw.named(api.partition_specs(cfg))
    skipped = total = 0
    for view, got in _ranks(runs, mesh):
        np.testing.assert_allclose(got[f"{name}/loss"], ref["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[f"{name}/grad_norm"],
                                   ref["grad_norm"], rtol=LOSS_RTOL)
        for n in specs:
            g = _cut(view, specs[n], grad[n])
            ours = got[f"{name}/grad/{n}"]
            assert ours.shape == g.shape, n
            scale = float(np.abs(grad[n]).max()) or 1.0
            np.testing.assert_allclose(ours, g, rtol=0,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"{name} {mesh} grad {n}")
            near = (np.abs(g) * clip <= NEAR_ZERO) & (g != 0)
            skipped, total = skipped + int(near.sum()), total + near.size
            for tag in ("param", "mu", "nu"):
                key = f"{tag}/{n}"
                want = _cut(view, specs[n], ref[key])
                assert want.shape == tuple(ref[f"shape/{key}"]), key
                ours = got[f"{name}/{key}"]
                assert ours.shape == want.shape, key
                np.testing.assert_allclose(ours[~near], want[~near],
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} {mesh} {key}")
                np.testing.assert_allclose(ours[near], want[near], rtol=0,
                                           atol=2 * OPT["lr"] + ATOL,
                                           err_msg=f"{name} {mesh} {key}")
    assert skipped < 0.02 * total, (skipped, total)


def _serve_checks(runs, name: str, mesh: str) -> None:
    cfg = reduced(name)
    ref = np.load(runs / f"ref_{name}_{mesh}.npz")
    cells = cells_on(name, mesh)
    keys = (["prefill"] if "prefill" in cells else []) + \
        ([f"decode{t}" for t in range(DECODE_STEPS)]
         if "decode" in cells else [])
    for view, got in _ranks(runs, mesh):
        for key in keys:
            scale = float(np.abs(ref[key]).max())
            _check(view, got, ref, cfg, mesh, key, name, rtol=0,
                   atol=MODEL_TOL * scale)
        if "decode" in cells:
            for key in ("cache_k", "cache_v"):
                _check(view, got, ref, cfg, mesh, key, name,
                       rtol=CACHE_RTOL, atol=0)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("name", [n for n in CASES
                                  if "train" in CASES[n][2]])
def test_train_cell_blocks_match_reference(runs, name, mesh):
    """One train step on four gloo ranks: each rank's parameter, moment
    and gradient blocks have the reference's shard shapes; the parameters
    and moments are the reference mesh cell's blocks, the gradients the
    one-device gradient's (``Cell.grad_step``: every leaf, q_norm, k_norm,
    wk / wv at KV 8 and KV 2 and the router included); the loss and the
    grad norm are the reference's."""
    _train_checks(runs, name, mesh)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("name", [n for n in CASES
                                  if set(CASES[n][2]) - {"train"}])
def test_prefill_and_decode_blocks_match_reference(runs, name, mesh):
    """The prefill logits and four decode steps' logits (the rank's batch
    rows and vocab columns, ``P(batch, None, "model")``) and the decode
    cache's blocks (``cache_specs``: KV heads or head dim over model)
    against the reference's cells on the same mesh."""
    _serve_checks(runs, name, mesh)


def test_pod_mesh_train_cell_matches_reference(runs):
    """qwen3's train cell on (pod 2, data 1, model 2): the batch over pod,
    the data-sharded leaves' gradients all-reduced over pod."""
    _train_checks(runs, POD_CASE, "pod")


def test_ranks_used_the_native_collectives(runs):
    """Every collective of the cells ran on gloo through
    ``torch.distributed``'s own all-gather, reduce-scatter and all-reduce:
    all three on (2, 2); at data 1 no FSDP gather, so no reduce-scatter,
    and the decode's gathers over ``model``."""
    want = {"2x2": {"all_gather/gloo", "reduce_scatter/gloo",
                    "all_reduce/gloo"},
            "1x4": {"all_gather/gloo", "all_reduce/gloo"}}
    for mesh, ops in want.items():
        calls = json.loads(str(np.load(runs / f"{mesh}_0.npz")["calls"]))
        assert set(calls) == ops and min(calls.values()) > 0, calls


def test_checkpoint_saved_on_2x2_restores_on_1x4(tmp_path):
    """A sharded state saved on (data 2, model 2) writes the one-device
    checkpoint's files byte for byte, and restores onto (data 1, model 4)
    with each rank holding its blocks."""
    from repro_torch import checkpoint
    from repro_torch._device import generator
    cfg = reduced("qwen3")
    job = {"cfg": dataclasses.asdict(cfg), "ckpt": str(tmp_path / "mesh")}
    _wait(_start_ranks(tmp_path, dict(job, case="save", tag="save",
                                      mesh=MESHES["2x2"])))
    model = api.init_params(cfg, generator(5, "cpu"), trainable=True)
    state = adamw.init(adamw.AdamWConfig(), model)
    for n, p in model.named_parameters():
        state.mu[n].copy_(2 * p.detach())
        state.nu[n].copy_(p.detach().abs())
    checkpoint.save(str(tmp_path / "one"), 3, {"params": model,
                                              "opt": state})
    one, mesh = tmp_path / "one" / "step_000000003", \
        tmp_path / "mesh" / "step_000000003"
    files = sorted(os.listdir(one))
    assert files == sorted(os.listdir(mesh)) and len(files) > 2
    for f in files:
        assert (one / f).read_bytes() == (mesh / f).read_bytes(), f
    _wait(_start_ranks(tmp_path, dict(job, case="restore", tag="restore",
                                      mesh=MESHES["1x4"])))
    specs = adamw.named(api.partition_specs(cfg))
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    shape, names = MESHES["1x4"]
    for r in range(RANKS):
        got = dict(np.load(tmp_path / f"restore_{r}.npz"))
        view = RankView(shape, names, got["coord"])
        for n in want:
            block = _cut(view, specs[n], want[n])
            assert np.array_equal(got[f"params/{n}"], block), n
            assert np.array_equal(got[f"mu/{n}"], 2 * block), n


def test_kv_heads_read_by_a_ranks_query_heads():
    """``transformer._kv_read``: a slice where the kernel's pairing (query
    head j with KV head j // (Hl / KVl)) holds, one KV head per query
    head where it cannot (H 48 over KV 8 at model 6: rank 0's heads 0-7
    read KV heads 0 x 6 and 1 x 2)."""
    from repro_torch.models.transformer import _kv_read
    assert _kv_read(0, 8, 2) == slice(0, 4)      # qwen3 at model 2
    assert _kv_read(4, 8, 8) == slice(0, 1)      # KV 2 at model 4
    assert _kv_read(8, 16, 6) == slice(1, 3)     # 4 heads each
    assert _kv_read(0, 8, 6) == [0] * 6 + [1] * 2
