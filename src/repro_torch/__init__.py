"""FlashR on PyTorch and CUDA: the port of the ``repro`` package to one
NVIDIA H100.  ``from repro_torch.core import fm`` is the R-like surface;
the hand-written Hopper kernels live in ``repro_torch.kernels``.  The package
imports torch and numpy only — never jax, never ``repro``."""
