"""Fault-tolerant checkpointing: atomic, async, restore onto any device (a
port of the JAX package's ``checkpoint/store.py``, with its on-disk
layout, so a checkpoint that either package writes restores in the other).

Layout (one directory per step):
    <root>/step_000123/
        manifest.json      {step, num_leaves, treedef, shapes, dtypes, extra}
        leaf_00000.npy ... one .npy per leaf

Leaves are taken in ``jax.tree.flatten``'s order: a dictionary's keys
sorted, a named tuple's fields (``OptState``: step, mu, nu) and a tuple's
or list's items in order.  A model module counts as the dictionary of its
named parameters (``layers.wq``, ... sorted, which is the order of the
reference's nested pytree).  A Python int is saved as an int32 scalar and
a float as a float32 one, as the reference's arrays are.  The manifest's
``treedef`` is a description for people; neither package reads it back.

Write protocol: everything lands in ``<root>/.tmp_step_X`` first (leaves
and manifest each fsync'd), the directory is atomically renamed on
completion, and the rename itself is made durable by fsyncing the root
directory — a crash at ANY instant leaves either the complete previous
state or the complete new one, never a torn step that ``latest_step``
would serve.  Recovery is verified, not assumed: ``latest_step`` only
returns steps whose manifest parses and whose every leaf passes a
header+size check (``is_intact``).  ``save_async`` copies the leaves to
host memory at once and writes them on a worker thread.

Restore: ``restore`` returns numpy leaves, or with ``device=`` tensors on
that device, in the structure of the tree given; ``restore_sharded`` gives
each rank its block of every leaf by its sharding's spec, on the mesh's
device, so a job may come back on a mesh of another shape than it left
on.  ``save`` of a sharded state (``shardings=``, every rank calls it)
gathers each leaf whole and rank 0 writes it: the files are those of the
one-device state, byte for byte.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve

_EXEC = ThreadPoolExecutor(max_workers=2, thread_name_prefix="ckpt")
_LOCK = threading.Lock()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any], str]:
    """(leaves in jax.tree.flatten's order, a function that rebuilds the
    tree's structure from new leaves, a description of the structure)."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        desc = "{" + ", ".join(f"{k!r}: {p[2]}" for k, p in zip(keys, parts)) + "}"
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(x) for x in tree]
        inner = ", ".join(p[2] for p in parts)
        desc = (f"{type(tree).__name__}({inner})" if _is_namedtuple(tree)
                else f"[{inner}]" if isinstance(tree, list) else f"({inner})")
    elif tree is None:
        return [], lambda leaves: None, "None"
    else:
        return [tree], lambda leaves: leaves[0], "*"
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new: List[Any]):
        out, i = [], 0
        for (_, build, _), n in zip(parts, sizes):
            out.append(build(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)

    return leaves, rebuild, desc


def _host(leaf, copy: bool) -> np.ndarray:
    """A leaf as a numpy array (a copy when ``copy``, so that later
    in-place updates of the leaf do not reach it)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype here; the "
                            "port's checkpoints hold fp32 master weights and "
                            "moments")
        return leaf.detach().to("cpu", copy=copy).numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.array(leaf, copy=copy)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def _fsync_path(path: str) -> None:
    """Flush a file's (or directory's) data to stable storage.  The
    directory fsync is what makes a just-renamed entry durable — without
    it a power cut can roll the rename back even though the data files
    themselves were synced."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(root: str, step: int, host: List[np.ndarray], desc: str,
           extra: Optional[dict]) -> str:
    final = _step_dir(root, step)
    tmp = os.path.join(root, f".tmp_step_{step:09d}")
    with _LOCK:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)       # debris of a crashed earlier attempt
        os.makedirs(tmp)
        for i, a in enumerate(host):
            path = os.path.join(tmp, f"leaf_{i:05d}.npy")
            np.save(path, a)
            _fsync_path(path)
        manifest = {
            "step": step,
            "num_leaves": len(host),
            "treedef": desc,
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
            "extra": extra or {},
        }
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)             # leaf + manifest directory entries
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_path(root)            # the rename itself
    return final


def _shardings(shardings: Any, n: int) -> list:
    """One ``NamedSharding`` per leaf: ``shardings`` is one for every leaf
    or a tree of them congruent with the leaves'."""
    from ..sharding import NamedSharding
    shards = [shardings] * n if isinstance(shardings, NamedSharding) \
        else _flatten(shardings)[0]
    if len(shards) != n:
        raise ValueError(f"{len(shards)} shardings for {n} leaves")
    return shards


def save(root: str, step: int, tree: Any, extra: Optional[dict] = None,
         shardings: Any = None) -> Optional[str]:
    """Blocking crash-safe save of ``tree`` (tensors on any device, numpy
    arrays, numbers; see the module doc for the order).

    Leaves and manifest are written to a temp directory and fsync'd,
    the temp directory is atomically renamed into place, and the root
    directory entry is fsync'd: there is no crash instant at which a
    reader (or ``latest_step`` after restart) can observe a partially
    written step under the final name.

    ``shardings`` (as ``restore_sharded``'s): the tensors are this rank's
    blocks; every rank of the mesh calls ``save``, each leaf is gathered
    whole (``parallel.gather_leaf``) and rank 0 writes the one-device
    files; the others return None once it has.
    """
    leaves, _, desc = _flatten(tree)
    if shardings is None:
        return _write(root, step, [_host(x, copy=False) for x in leaves],
                      desc, extra)
    import torch.distributed as dist
    from ..parallel import gather_leaf
    host = []
    for x, sh in zip(leaves, _shardings(shardings, len(leaves))):
        if isinstance(x, torch.Tensor):
            x = gather_leaf(x.detach(), sh.mesh, sh.spec)
        host.append(_host(x, copy=True) if dist.get_rank() == 0 else None)
    path = _write(root, step, host, desc, extra) \
        if dist.get_rank() == 0 else None
    dist.barrier()
    return path


def save_async(root: str, step: int, tree: Any,
               extra: Optional[dict] = None) -> Future:
    """Copy every leaf to host memory NOW (the device-to-host sync point),
    write on a background thread."""
    leaves, _, desc = _flatten(tree)
    host = [_host(x, copy=True) for x in leaves]
    return _EXEC.submit(_write, root, step, host, desc, extra)


def is_intact(root: str, step: int) -> bool:
    """Whether a step's checkpoint is complete and readable: the
    manifest parses and every leaf file's npy header agrees with it and
    covers its data region on disk (``np.load(mmap_mode="r")`` rejects a
    file shorter than its header promises, catching a tail truncated by
    a crash or a copy cut short — the torn-checkpoint case).  Header
    checks only: no leaf data is actually read."""
    d = _step_dir(root, step)
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        for i in range(int(manifest["num_leaves"])):
            a = np.load(os.path.join(d, f"leaf_{i:05d}.npy"), mmap_mode="r")
            if list(a.shape) != list(manifest["shapes"][i]) or \
                    str(a.dtype) != manifest["dtypes"][i]:
                return False
    except (OSError, ValueError, KeyError, IndexError, TypeError):
        return False
    return True


def latest_step(root: str) -> Optional[int]:
    """The newest step with an INTACT checkpoint.  A torn step (crash
    mid-write on a filesystem that reordered the temp-dir writes, or
    corruption after the fact) is skipped, falling back to the newest
    step that still verifies — recovery never serves a checkpoint that
    ``restore`` would choke on."""
    if not os.path.isdir(root):
        return None
    steps = sorted((int(name.split("_")[1])
                    for name in os.listdir(root)
                    if name.startswith("step_")), reverse=True)
    for s in steps:
        if is_intact(root, s):
            return s
    return None


def restore(root: str, step: int, tree_like: Any,
            device=None) -> Tuple[Any, dict]:
    """Load step's arrays into the structure of ``tree_like``.

    ``tree_like`` supplies the structure (values ignored; a module becomes
    the dictionary of its named parameters).  Returns (tree, manifest
    dict): numpy leaves, or with ``device`` tensors on it, the same bits;
    a leaf that is a Python int in ``tree_like`` comes back as an int.
    """
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, rebuild, _ = _flatten(tree_like)
    if len(leaves) != manifest["num_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, "
            f"tree expects {len(leaves)}"
        )
    loaded = [np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
              for i in range(len(leaves))]
    for i, (a, ref) in enumerate(zip(loaded, leaves)):
        if hasattr(ref, "shape") and tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {a.shape} != expected {ref.shape}")
    dev = None if device is None else resolve(device)
    out = []
    for a, ref in zip(loaded, leaves):
        if isinstance(ref, int) and not isinstance(ref, bool):
            out.append(int(a))
        elif dev is not None:
            out.append(torch.from_numpy(a).to(dev))
        else:
            out.append(a)
    return rebuild(out), manifest


def restore_sharded(root: str, step: int, tree_like: Any, shardings: Any):
    """``restore`` of this rank's blocks onto its device.  ``shardings``:
    one ``sharding.NamedSharding`` for every leaf, or a tree of them
    congruent with ``tree_like`` (``launch.mesh.named(mesh, specs)``);
    each tensor leaf comes back as its block by the spec (GSPMD's,
    ``sharding.local_block``), on a mesh of any shape.  Returns (tree,
    manifest)."""
    from ..sharding import local_block
    host, manifest = restore(root, step, tree_like)
    leaves, rebuild, _ = _flatten(host)
    shards = _shardings(shardings, len(leaves))
    if len({sh.mesh.device for sh in shards}) != 1:
        raise ValueError("the shardings name more than one device")
    dev = shards[0].mesh.device
    out = []
    for a, sh in zip(leaves, shards):
        if isinstance(a, np.ndarray):
            block = np.array(a[local_block(sh.mesh, sh.spec, a.shape)])
            out.append(torch.from_numpy(block).to(dev))
        else:
            out.append(a)
    return rebuild(out), manifest
