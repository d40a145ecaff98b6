"""Carry objects of the JAX package (``repro``) across to this package.

``to_port(obj, device)`` takes plain field data and returns this package's
objects and tensors.  It recognises records by duck typing and never
imports ``repro``:

  * a dataclass instance is matched by its class name (``ShiftedExp``,
    ``Pareto``, ``BiModal``, ``Scenario``, ``Policy``, ``RetryPolicy``,
    ``Plan``, ``FailureModel``, ``PoissonArrivals``,
    ``DeterministicArrivals``, ``MMPPArrivals`` and the placements
    ``AllWorkers``, ``ReplicationGroups``, ``RoundRobin``,
    ``RandomGroups``, ``SpeedAware``);
  * a ``dataclasses.asdict`` dictionary is matched by its set of keys.
    Poisson and deterministic arrivals share their one field, so their
    dictionaries are ambiguous and raise: pass the object instead.  The
    placements' dictionaries are not recognised (several share their
    keys): pass the object;
  * an enum whose value names a ``Scaling`` becomes that ``Scaling``;
  * anything with ``__array__`` (numpy arrays, the reference's device
    arrays) becomes a tensor on ``device``; bfloat16 arrays stay bfloat16;
  * lists, tuples and other dictionaries are converted element-wise;
    numbers, strings and None pass through.

``params_to_port(cfg, params, device, trainable, mesh)`` takes the
reference's model parameters (``models.api.init_params``'s pytree, as
numpy arrays or the reference's arrays) and returns this package's model
module holding them; ``trainable`` makes every parameter require a
gradient; on a ``launch.mesh`` mesh the module holds this rank's block
of each (``models.api.placement``).  ``opt_state_to_port(opt_state,
device, cfg, mesh)`` takes the reference's AdamW state
(``optim.adamw.OptState``: step, mu, nu) and returns the port's: the
step as an int and the moments by parameter name (on a mesh, the rank's
blocks, which needs ``cfg``).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ._device import DEFAULT_DEVICE, resolve
from .assign.strategies import (AllWorkers, RandomGroups, ReplicationGroups,
                                RoundRobin, SpeedAware)
from .core.distributions import BiModal, Pareto, Scaling, ShiftedExp
from .core.planner import Plan
from .core.policy import Policy, RetryPolicy
from .core.scenario import (DeterministicArrivals, FailureModel,
                            MMPPArrivals, PoissonArrivals, Scenario)
from .models.api import build, placement
from .optim.adamw import OptState
from .sharding import local_block

__all__ = ["opt_state_to_port", "params_to_port", "to_port"]

_RECORDS = (ShiftedExp, Pareto, BiModal, Scenario, Policy, RetryPolicy, Plan,
            FailureModel, PoissonArrivals, DeterministicArrivals,
            MMPPArrivals)
_PLACEMENTS = (AllWorkers, ReplicationGroups, RoundRobin, RandomGroups,
               SpeedAware)
_BY_NAME = {cls.__name__: cls for cls in _RECORDS + _PLACEMENTS}
_BY_KEYS = {frozenset(f.name for f in dataclasses.fields(cls)): cls
            for cls in _RECORDS
            if cls not in (PoissonArrivals, DeterministicArrivals)}
_AMBIGUOUS_KEYS = frozenset({"rate"})


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    dev = resolve(device)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def _record(cls, fields: dict, device):
    return cls(**{name: to_port(v, device) for name, v in fields.items()})


def to_port(obj, device=DEFAULT_DEVICE):
    """``obj`` as this package's object or tensor (see module doc)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, enum.Enum):
        return Scaling(obj.value)
    if isinstance(obj, torch.Tensor):
        return obj.to(resolve(device))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _BY_NAME.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"no counterpart for {type(obj).__name__}")
        return _record(cls, {f.name: getattr(obj, f.name)
                             for f in dataclasses.fields(obj)}, device)
    if isinstance(obj, dict):
        keys = frozenset(obj)
        if keys == _AMBIGUOUS_KEYS:
            raise ValueError("an arrivals record with only 'rate' may be "
                             "Poisson or deterministic: pass the object")
        cls = _BY_KEYS.get(keys)
        if cls is not None:
            return _record(cls, obj, device)
        return {to_port(k, device): to_port(v, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v, device) for v in obj)
    if hasattr(obj, "__array__"):
        return _tensor(np.asarray(obj), device)
    raise TypeError(f"cannot carry {type(obj).__name__} across")


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = value
    return out


def _blocks(cfg, leaves: dict, device, mesh) -> dict:
    """Each array of ``leaves`` (by dotted name) as a tensor on ``device``:
    on a mesh this rank's block by ``api.placement``."""
    if mesh is None:
        return to_port(leaves, device)
    specs = placement(cfg)
    return {n: _tensor(np.asarray(a)[local_block(mesh, specs[n],
                                                 np.shape(a))], device)
            for n, a in leaves.items()}


def params_to_port(cfg, params: dict, device=DEFAULT_DEVICE,
                   trainable: bool = False, mesh=None):
    """The model module of ``cfg``'s family holding the reference's
    parameter pytree ``params`` (``{"layers": {...}, "embed": ...}``); on
    ``mesh`` this rank's block of each leaf, on the mesh's device.

    Every name of the pytree must be a parameter of the module and every
    parameter a name of the pytree, with the same shape (the block's);
    anything else raises.  Values keep their dtype.  ``trainable``: the
    parameters require gradients (the training path).
    """
    device = mesh.device if mesh is not None else resolve(device)
    model = build(cfg, device, trainable, mesh)
    theirs = _flatten(params)
    ours = dict(model.named_parameters())
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter names differ: missing from "
                         f"the pytree {missing}, not in the model {extra}")
    tensors = _blocks(cfg, theirs, device, mesh)
    for name, p in ours.items():
        t = tensors[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{cfg.name}: {name} has shape "
                             f"{tuple(t.shape)}, the model wants "
                             f"{tuple(p.shape)}")
        p.data = t
    return model


def opt_state_to_port(opt_state, device=DEFAULT_DEVICE, cfg=None,
                      mesh=None) -> OptState:
    """The reference's ``OptState(step, mu, nu)`` as the port's: ``step``
    an int, ``mu`` and ``nu`` dictionaries by the port's parameter names
    (``layers.wq``, ``embed``, ...) of tensors on ``device``; on ``mesh``
    (with ``cfg``) this rank's blocks, on the mesh's device."""
    if mesh is not None:
        if cfg is None:
            raise ValueError("a mesh needs the config whose specs place the "
                             "moments")
        device = mesh.device
    return OptState(step=int(np.asarray(opt_state.step)),
                    mu=_blocks(cfg, _flatten(opt_state.mu), device, mesh),
                    nu=_blocks(cfg, _flatten(opt_state.nu), device, mesh))
