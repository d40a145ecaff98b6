"""Crash-safe checkpoints in the JAX package's layout (a port of its
``checkpoint``)."""
from .store import (is_intact, latest_step, restore,  # noqa: F401
                    restore_sharded, save, save_async)

__all__ = ["is_intact", "latest_step", "restore", "restore_sharded", "save",
           "save_async"]
