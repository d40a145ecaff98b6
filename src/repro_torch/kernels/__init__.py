"""Hand-written CUDA kernels for NVIDIA Hopper, each beside its plain
PyTorch version.  Sources live under ``<kernel>/csrc/`` and are compiled
by ``_build`` at first use; importing this package builds nothing."""
