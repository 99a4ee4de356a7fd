"""Element-type lattice and promotion rules (PyTorch port of repro.core.dtypes).

The lattice, the promotion rule and the lazy-cast naming are the reference's.
The canon is the reference's with JAX's x64 mode OFF, always: int64 degrades
to int32 and float64 to float32.  PyTorch defaults to int64 for integer
tensors, indices and reductions, so every value that leaves a torch op with a
64-bit type is canonicalized explicitly (``canon`` here, ``to_canon`` on
tensors).
"""
from __future__ import annotations

import numpy as np
import torch

# The promotion lattice, weakest to strongest (R's logical < integer < double,
# extended with the narrower machine types).
_LATTICE = (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
            torch.bfloat16, torch.float32, torch.float64)

_RANK = {dt: i for i, dt in enumerate(_LATTICE)}

SUPPORTED = frozenset(_LATTICE)

_NAMES = {torch.bool: "bool", torch.int8: "int8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64",
          torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.float64: "float64", torch.float16: "float16",
          torch.uint8: "uint8"}
_BY_NAME = {v: k for k, v in _NAMES.items()}


def _as_torch(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:
        name = np.dtype(dtype).name
    if name == "bool_":
        name = "bool"
    if name in _BY_NAME:
        return _BY_NAME[name]
    try:
        nd = np.dtype(name)
    except TypeError:  # e.g. numpy's 'void16', raw two-byte elements
        raise TypeError(f"unsupported element type: {dtype!r}") from None
    if nd.kind == "f":
        return torch.float32 if nd.itemsize <= 4 else torch.float64
    if nd.kind in ("i", "u"):
        return torch.int32 if nd.itemsize <= 4 else torch.int64
    if nd.kind == "b":
        return torch.bool
    raise TypeError(f"unsupported element type: {dtype!r}")


def kind(dtype) -> str:
    """numpy-style kind letter: 'b', 'i', 'f', or 'V' for bfloat16 — the
    kind numpy gives ml_dtypes' bfloat16, which the reference reads: there
    bf16 is not ``is_floating`` (a float-valued op on it promotes to
    float32, and no kernel matcher claims a bf16 operand)."""
    dt = _as_torch(dtype)
    if dt == torch.bool:
        return "b"
    if dt == torch.bfloat16:
        return "V"
    return "f" if dt.is_floating_point else "i"


def itemsize(dtype) -> int:
    return _as_torch(dtype).itemsize


def name(dtype) -> str:
    return _NAMES[_as_torch(dtype)]


def canon(dtype) -> torch.dtype:
    """Canonicalize a dtype (torch, numpy or name) to a lattice member with
    64-bit members degraded to their 32-bit counterparts."""
    dt = _as_torch(dtype)
    if dt == torch.int64:
        return torch.int32
    if dt == torch.float64:
        return torch.float32
    if dt in _RANK:
        return dt
    if dt.is_floating_point:
        return torch.float32
    return torch.int32


def to_canon(t: torch.Tensor) -> torch.Tensor:
    """A tensor in its canonical dtype (torch's int64 results → int32)."""
    dt = canon(t.dtype)
    return t if t.dtype == dt else t.to(dt)


def rank(dtype) -> int:
    return _RANK[canon(dtype)]


def promote(a, b) -> torch.dtype:
    """Binary promotion: the stronger of the two lattice members."""
    ca, cb = canon(a), canon(b)
    return ca if _RANK[ca] >= _RANK[cb] else cb


def is_floating(dtype) -> bool:
    return kind(canon(dtype)) == "f"


def to_floating(dtype) -> torch.dtype:
    """The dtype arithmetic means (e.g. division) promotes to."""
    dt = canon(dtype)
    return dt if kind(dt) == "f" else torch.float32


def nbytes(dtype) -> int:
    return canon(dtype).itemsize


def np_equiv(dtype) -> np.dtype:
    """numpy equivalent for host-side staging buffers (bf16 stages as f32)."""
    dt = canon(dtype)
    if dt == torch.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(name(dt))
