"""The optimizer of the training path (a port of the JAX package's
``optim``)."""
from .adamw import (AdamWConfig, OptState, accumulate_grads,  # noqa: F401
                    apply_updates, clip_by_global_norm, global_norm, init,
                    schedule)

__all__ = ["AdamWConfig", "OptState", "accumulate_grads", "apply_updates",
           "clip_by_global_norm", "global_norm", "init", "schedule"]
