"""Parameter containers shared by the model modules.

The reference keeps each model's parameters as a pytree of arrays; the port
keeps them as ``torch.nn.Parameter``s under the same names and shapes, with
the layers' parameters stacked along a leading ``num_layers`` axis.
Serving computes no gradients, so no parameter requires one.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype named by a config field (``"bfloat16"``, ...)."""
    return _DTYPES[name]


def no_grad_parameter(shape, dtype: torch.dtype, device) -> torch.nn.Parameter:
    """An uninitialised parameter that requires no gradient."""
    return torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                          device=device), requires_grad=False)


class StackedParams(torch.nn.Module):
    """One parameter per name, each stacked along a leading layer axis."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], dtype: torch.dtype,
                 device):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name,
                                    no_grad_parameter(shape, dtype, device))

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s parameters (views, no copy)."""
        return {name: p[i] for name, p in self.named_parameters()}
