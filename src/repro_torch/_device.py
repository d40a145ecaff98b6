"""Device resolution shared by every entry point of the package.

Entry points default to ``device="cuda"``.  A request for the card on a
machine without one raises here instead of running on the host: the only
way onto the CPU is to ask for it.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a card that
    this machine does not have."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the host")
    return dev


def generator(seed: int, device=DEFAULT_DEVICE) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=resolve(device)).manual_seed(int(seed))


def target(generator: torch.Generator, device=None) -> torch.device:
    """Where a draw from ``generator`` lands: ``device`` if given, else the
    generator's own device."""
    return generator.device if device is None else resolve(device)
