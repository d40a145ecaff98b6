"""Parameter containers shared by the model modules.

The reference keeps each model's parameters as a pytree of arrays; the port
keeps them as ``torch.nn.Parameter``s under the same names and shapes, with
the layers' parameters stacked along a leading ``num_layers`` axis.  A
serving module's parameters require no gradient; a trainable module's
(``requires_grad=True``, the training path) do.  Given a mesh and a
parameter's partition spec, a parameter holds this rank's block of the
reference's leaf (``sharding.shard_shape``): the spec's leading ``None``
covers a stacked leaf's layer axis.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..sharding import shard_shape

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype named by a config field (``"bfloat16"``, ...)."""
    return _DTYPES[name]


def parameter(shape, dtype: torch.dtype, device,
              requires_grad: bool = False, spec=None,
              mesh=None) -> torch.nn.Parameter:
    """An uninitialised parameter, this rank's block of a leaf of ``shape``
    placed by ``spec`` on ``mesh`` (the whole leaf without a mesh); it
    requires a gradient only when asked."""
    shape = shard_shape(mesh, spec, shape) if mesh is not None else shape
    return torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                          device=device),
                              requires_grad=requires_grad)


class StackedParams(torch.nn.Module):
    """One parameter per name, each stacked along a leading layer axis
    (with ``specs`` and ``mesh``, this rank's block of each)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], dtype: torch.dtype,
                 device, requires_grad: bool = False,
                 specs: Optional[dict] = None, mesh=None):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(
                name, parameter(shape, dtype, device, requires_grad,
                                specs[name] if specs else None, mesh))

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s parameters (views, no copy)."""
        return {name: p[i] for name, p in self.named_parameters()}

    def unbind(self) -> List[Dict[str, torch.Tensor]]:
        """Every layer's parameters (views, no copy).  Under autograd one
        ``unbind`` per name stacks the layers' gradients once in the
        backward, where a view per layer would add a zero-padded
        full-stack gradient per layer."""
        per_name = {name: p.unbind(0) for name, p in self.named_parameters()}
        layers = len(next(iter(per_name.values()))) if per_name else 0
        return [{name: views[i] for name, views in per_name.items()}
                for i in range(layers)]
