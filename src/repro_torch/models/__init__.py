"""The port's LM stack, dense, MoE, VLM, SSM and hybrid families: layers,
the MoE layer, the Mamba-2 mixer, the decoder-only transformer's, the SSM
LM's and the hybrid's entry points and the zoo facade (``zoo.build``)."""
from . import base, hybrid, layers, moe, ssm, ssm_lm, transformer, zoo

__all__ = ["base", "hybrid", "layers", "moe", "ssm", "ssm_lm", "transformer",
           "zoo"]
