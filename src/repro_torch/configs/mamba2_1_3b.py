"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.
48L d_model=2048 d_state=128 vocab=50280 [arXiv:2405.21060; unverified].
expand=2 -> d_inner=4096, headdim=64 -> 64 ssm heads, conv width 4."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    grad_accum=2,
)
