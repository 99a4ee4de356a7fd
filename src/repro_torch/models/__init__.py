"""The port's LM stack, dense family: layers, the decoder-only transformer's
serving entry points and the zoo facade (``zoo.build``)."""
from . import base, layers, transformer, zoo

__all__ = ["base", "layers", "transformer", "zoo"]
