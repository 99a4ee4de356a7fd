"""Blockwise online-softmax (flash) attention on Hopper
(csrc/flash_attention.cu).

``flash_attention`` replaces repro/kernels/flash_attention.py:flash_attention
(Pallas, ``_kernel``) and computes its function: O = softmax(scale·QKᵀ +
mask) V with the mask by absolute ids (q_id >= k_id when causal, top-left),
the finite -1e30 and l clamped at 1e-30, f32 inside, the output in q's type.
The serving path calls it once per prefill layer (``ops.attention``).

Bound on an H100 at that path's B 4, 24 heads, S = T = 4096, D 128, bf16,
causal: 2·B·nh·S²·D = 4.12e11 operations against 268 MB of bytes, so
operations bound it — 0.42 ms at the 989 TFLOP/s bf16 tensor rate, 6.15 ms
at the 67 TFLOP/s f32 rate.  The design: one block per (head, 64-row q
tile) walks the kv tiles with (m, l, acc) in registers; Q, then each K and V
tile, staged through shared memory (masked while staging, never padded by
a copy); QKᵀ of bf16 inputs on the tensor cores (``mma.sync``, exact
products, f32 sums), P·V in f32 FMA as the Pallas kernel has it (so the f32
rate bounds this design at 3.1 ms), f32 inputs all in FMA; kv tiles above
the causal diagonal skipped; GQA by reading K/V head h // g, never
repeating KV; 64-bit offsets.

Layout: q (B, nh, S, D) with k, v (B, nkv, T, D), nh a multiple of nkv, or
the Pallas kernel's (BH, S, D) with k, v (BH, T, D); all contiguous.
"""
from __future__ import annotations

import torch

from . import build, ref
from .common import route

#: Head dims the kernel is built for (tests 16, reduced configs 32, qwen2
#: 64, llama / granite 128).
HEAD_DIMS = (16, 32, 64, 128)
#: Query rows a block owns.
BQ = 64
#: Launches of the CUDA kernel (the plain CPU path does not count).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> tuple[int, int, int, int, int]:
    """(batch·heads, heads, group, S, T) of valid operands; raises else."""
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.shape != k.shape:
        raise ValueError(
            "flash_attention: q (BH, S, D) with k, v (BH, T, D), or q "
            "(B, nh, S, D) with k, v (B, nkv, T, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    d = q.shape[-1]
    if k.shape[-1] != d or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} (k: {k.shape[-1]}); "
                         f"the kernel takes {HEAD_DIMS}")
    if q.ndim == 3:
        bh, S = q.shape[:2]
        nh, nkv, T = 1, 1, k.shape[1]
        if k.shape[0] != bh:
            raise ValueError(f"flash_attention: {bh} q heads, {k.shape[0]} kv")
    else:
        B, nh, S = q.shape[:3]
        nkv, T = k.shape[1], k.shape[2]
        if k.shape[0] != B or nkv == 0 or nh % nkv:
            raise ValueError(
                f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)}: "
                "batch must match and nh be a multiple of nkv")
        bh = B * nh
    if T == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    return bh, nh, nh // nkv, S, T


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """Attention of q over k, v (layouts in the module note); the output has
    q's shape and dtype."""
    global launches
    bh, nh, group, S, T = _check(q, k, v)
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    if route(q, k, v) == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if -(-S // BQ) > 65535:
        raise ValueError(f"flash_attention: S = {S} exceeds the grid "
                         f"({65535 * BQ} rows)")
    out = torch.empty_like(q)
    if S == 0 or bh == 0:
        return out
    lib = build.load("flash_attention")
    err = lib.fm_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), bh, nh, group, S, T, d, scale,
                                 int(causal), _DTYPES[q.dtype],
                                 build.stream_handle(q))
    build.check(err, "flash_attention")
    launches += 1
    return out
