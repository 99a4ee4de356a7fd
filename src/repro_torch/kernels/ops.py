"""The LM stack's kernel entry: the port's twin of repro/kernels/ops.py's
``attention``.

``attention(impl="auto")`` is the flash kernel's wrapper, which launches
the kernel for CUDA tensors and takes its plain version for CPU tensors;
``impl="ref"`` asks for that plain version (``ref.flash_attention_ref``)
explicitly, on either device — the tests and ``chip_smoke.py`` compare the
two.  The reference's ``impl="ref"`` is ``ref.attention_ref``, whose causal
mask is bottom-right: it is the same function whenever S == T, which is all
a prefill asks (the two differ when causal and S != T; ROADMAP §C).
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention

__all__ = ["attention", "flash_attention", "ref"]

IMPLS = ("auto", "ref")


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              impl: str = "auto"):
    """Attention over (BH, S, D), or (B, nh, S, D) with k, v (B, nkv, T, D)."""
    if impl == "auto":
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"attention: impl {impl!r}, expected one of {IMPLS}")
