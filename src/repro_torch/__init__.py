"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The layout mirrors ``repro``: each module here has a counterpart of the same
name there, which stays the numerical reference. This package imports
``torch`` and ``numpy`` only. Hand-written CUDA kernels live in ``csrc/`` and
are built at first use (see ``kernels._build``).
"""
