"""The port's LM stack, dense, MoE and VLM families: layers, the MoE
layer, the decoder-only transformer's entry points and the zoo facade
(``zoo.build``)."""
from . import base, layers, moe, transformer, zoo

__all__ = ["base", "layers", "moe", "transformer", "zoo"]
