"""Hand-written Hopper (sm_90a) kernels of the port, CUDA C++ in ``csrc/``
built with nvcc into plain-C libraries and bound with ctypes (``build``).

Each wrapper — ``gram.gram`` / ``gram.xty``, ``weighted_gram.wgram``,
``fused_apply_agg.fused_apply_agg``, ``kmeans_assign.kmeans_assign``, the
three in ``spmm``, ``flash_attention.flash_attention`` (the LM stack's
entry is ``ops.attention``) — launches its kernel for CUDA tensors
(counting its launches) and uses its plain PyTorch version in ``ref`` for
CPU tensors.  Nothing here imports triton or builds anything at import
time.
"""
from . import common, ref

__all__ = ["common", "ref"]
