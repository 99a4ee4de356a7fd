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
at the 67 TFLOP/s f32 rate.  Two bodies, picked here from the dtype and
head dim alone (``body_for``), both counted in ``launches``:

* ``"wgmma"`` — bf16 at head dims 64 and 128, the serving path: one block
  per (head, 128-row q tile), a producer warp feeding 128-key K/V tiles by
  TMA into an mbarrier ring, two consumer warpgroups running QKᵀ on
  ``wgmma`` with the softmax on the accumulators in registers, and P·V as
  two ``wgmma`` products, P split into bf16 hi + lo terms so that P keeps
  the f32 precision the Pallas kernel gives it (one bf16 rounding of P
  would miss one bf16 ulp of the float64 output;
  tests/test_torch_kernels.py shows it).  That split costs 1.5× the tensor
  work: 0.63 ms is this design's bound.
* ``"fma"`` — f32 inputs, and bf16 at every other head dim (16 and 32 in
  the tests and reduced configs, 80, 96, 112 and 256 in the hybrid and VLM
  families): one block per (head, 64-row q tile), all f32 FMA (6.15 ms
  bound at the serving shape), bf16 values widened as they are staged.

Both: masks by absolute id (after the scale, so any scale), GQA by reading
K/V head h // g (never repeating KV), kv tiles above the causal diagonal
skipped, heaviest q tiles first, 64-bit offsets.

On meta tensors under an account (``launch.hlo_analysis``) the wrapper
returns an empty output and reports ``tile_work``'s FLOPs and bytes; it
counts no launch.

Layout: q (B, nh, S, D) with k, v (B, nkv, T, D), nh a multiple of nkv, or
the Pallas kernel's (BH, S, D) with k, v (BH, T, D); all contiguous.  Both
bodies read 16 bytes at a time and TMA takes no other base, so an operand
that starts off a 16-byte boundary (a view at an odd element offset) is
copied into a fresh buffer first.  The plain CPU path takes any head dim,
as the Pallas kernel does; the card takes ``HEAD_DIMS``.
"""
from __future__ import annotations

import torch

from . import build, common, ref
from .common import LAUNCH_LOCK, aligned, route

#: Head dims the kernel is built for (tests 16, reduced configs 32, qwen2
#: 64, zamba2 112, llama / granite 128, paligemma 256; 80 and 96 for the
#: other multiples of 16 the FMA body's column split takes).
HEAD_DIMS = (16, 32, 64, 80, 96, 112, 128, 256)
#: Query rows a block of the FMA body owns (the wgmma body's 128-row blocks
#: need fewer): ceil(S / BQ) must fit the grid.
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
    if k.shape[-1] != d:
        raise ValueError(f"flash_attention: q head dim {d}, k {k.shape[-1]}")
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


def body_for(dtype: torch.dtype, d: int) -> str:
    """The kernel body that serves q/k/v of this dtype and head dim."""
    return "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "fma"


def tile_work(bh: int, S: int, T: int, d: int, dtype: torch.dtype,
              causal: bool) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one launch, from the tiles it visits: one
    block per (q head, q tile) of ``body_for``'s geometry (wgmma: 128-row
    q tiles over 128-key kv tiles; FMA: 64 × 64), each reading its q tile
    once, the kv tiles up to its last query's when causal (all T keys
    otherwise) and writing its output once.  A visited (query, key) pair
    costs QKᵀ's 2·d and P·V's 2·d operations, P·V twice on the wgmma body
    (P as bf16 hi + lo terms).  What is past S or T in a tile is not
    counted."""
    wg = body_for(dtype, d) == "wgmma"
    bq = bk = 128 if wg else BQ
    per_pair = (6 if wg else 4) * d
    es = torch.finfo(dtype).bits // 8
    pairs = keys_read = 0
    for q0 in range(0, S, bq):
        rows = min(bq, S - q0)
        end = min(q0 + rows, T) if causal else T
        keys = min(-(-end // bk) * bk, T)
        pairs += rows * keys
        keys_read += keys
    flops = float(bh) * pairs * per_pair
    nbytes = float(bh) * (2 * S * d + 2 * keys_read * d) * es
    return flops, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """Attention of q over k, v (layouts in the module note); the output has
    q's shape and dtype."""
    global launches
    bh, nh, group, S, T = _check(q, k, v)
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    where = route(q, k, v, meta=True)
    if where == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d}; the kernel takes "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if -(-S // BQ) > 65535:
        raise ValueError(f"flash_attention: S = {S} exceeds the grid "
                         f"({65535 * BQ} rows)")
    if where == "meta":
        flops, nbytes = tile_work(bh, S, T, d, q.dtype, causal)
        common.METER.kernel("flash_attention", flops, nbytes,
                            "bfloat16" if body_for(q.dtype, d) == "wgmma"
                            else "float32")
        return torch.empty_like(q)
    q, k, v = (aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if S == 0 or bh == 0:
        return out
    lib = build.load("flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, nh,
            group, S, T, d, scale, int(causal))
    if body_for(q.dtype, d) == "wgmma":
        err = lib.fm_flash_attention_wgmma(*args, build.stream_handle(q))
    else:
        err = lib.fm_flash_attention(*args, _DTYPES[q.dtype],
                                     build.stream_handle(q))
    build.check(err, "flash_attention")
    with LAUNCH_LOCK:
        launches += 1
    return out
