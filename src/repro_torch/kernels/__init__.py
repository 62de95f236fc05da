"""Hand-written Hopper kernels of the port.

Each kernel is a subpackage mirroring ``repro.kernels``: ``kernel.py``
(the wrapper: checks, launch on the current stream, launch counter),
``ops.py`` (the executor backend built on it) and ``ref.py`` (the plain
PyTorch version, used for CPU tensors and as the oracle on the card).
The CUDA sources live in ``repro_torch/csrc`` and are built by
:mod:`repro_torch.kernels._build` with ``nvcc`` at first use, into
``build/repro_torch/`` at the repository root, and bound with ``ctypes``.
Importing this package builds nothing.
"""
