"""Crash-safe checkpoints in the JAX package's layout (a port of its
``checkpoint``)."""
from .store import (is_intact, latest_step, restore, save,  # noqa: F401
                    save_async)

__all__ = ["is_intact", "latest_step", "restore", "save", "save_async"]
