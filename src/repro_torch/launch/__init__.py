"""Entry points of the port's LM stack: the serving steps (``steps``)."""
