"""arctic-480b [moe]: dense-MoE hybrid. 35L d_model=7168 56H (GQA kv=8)
d_ff=4864, MoE 128 experts top-2 + dense residual path, vocab=32000
[hf:Snowflake/snowflake-arctic-base].  The dense FFN runs in parallel with
the routed experts and the outputs sum (Arctic's residual design)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    # 480B optimizer state cannot fit a single pod in f32: pure-bf16
    # training (bf16 masters/moments/grad-accum) is the deployment mode.
    param_dtype="bfloat16", grad_accum=8, serve_weights_resident=False,
)
