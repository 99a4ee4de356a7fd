"""The yardstick's constants: published peaks of one NVIDIA H100 SXM and the
roofline bound of counted work.

Frozen here so that a later change to the program cannot move the
yardstick.  ``bound`` is the arithmetic of the port's smoke script
(``bound(nbytes, ops)``), returning seconds instead of milliseconds.
"""
from __future__ import annotations

#: HBM3 bandwidth, bytes/s (H100 SXM data sheet).
HBM_BYTES_S = 3.35e12
#: float32 outside the tensor cores, FLOP/s (H100 SXM data sheet).
F32_FLOP_S = 67e12


def bound(nbytes: float, flops: float, flop_s: float = F32_FLOP_S) -> float:
    """The least time, in seconds, in which the card could read ``nbytes``
    from HBM and perform ``flops`` float32 operations: the larger of the
    two terms."""
    return max(nbytes / HBM_BYTES_S, flops / flop_s)
