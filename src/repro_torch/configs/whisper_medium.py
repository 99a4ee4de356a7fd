"""whisper-medium [audio]: encoder-decoder; conv frontend is a STUB
(`input_specs()` provides precomputed frame embeddings, 1500 frames).
24 enc + 24 dec layers, d_model=1024 16H (MHA) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified].  LayerNorm + GELU (no GLU), learned
positions; decoder has causal self-attn + cross-attn to the encoder."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=51865,
    act="gelu", norm="layernorm", enc_len=1500,
)
