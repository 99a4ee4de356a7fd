"""paligemma-3b [vlm]: SigLIP patch-embedding stub + Gemma-2B decoder.

18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 vocab=257216
[arXiv:2407.07726; hf].  Image patches enter as 256 precomputed embeddings
(`input_specs()` stub per the assignment); text follows, causal LM loss on
the text span.  Gemma-style: GeGLU, tied embeddings, rms-norm.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    act="geglu", tie_embeddings=True, n_patches=256,
)
