"""PyTorch/CUDA port of the diversity/parallelism planner and its coded
execution.

Mirrors the module layout of the JAX package ``repro``: ``core`` (service
times, order statistics, planner, coding, Monte-Carlo simulator),
``runtime.straggler``, ``api`` (the ``Planner`` front door), ``configs``
and ``kernels`` (hand-written CUDA for NVIDIA Hopper, each beside its
plain PyTorch version).  ``convert.to_port`` carries the JAX package's
objects across as plain field data.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
