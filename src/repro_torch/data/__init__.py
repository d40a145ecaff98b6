"""The training path's data (a port of the JAX package's ``data``)."""
from .pipeline import (DataConfig, batch_iterator, coded_batch,  # noqa: F401
                       decode_example_weights, expand_worker_weights,
                       synthetic_batch)

__all__ = ["DataConfig", "batch_iterator", "coded_batch",
           "decode_example_weights", "expand_worker_weights",
           "synthetic_batch"]
