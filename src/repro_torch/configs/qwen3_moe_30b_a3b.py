"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4, head_dim=128)
expert d_ff=768, 128 experts top-8, vocab=151936 [hf:Qwen/Qwen3-30B-A3B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    n_experts=128, top_k=8, moe_d_ff=768, rope_theta=1000000.0,
    grad_accum=2,
)
