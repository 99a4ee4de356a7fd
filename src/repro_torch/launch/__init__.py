"""Entry points of the port: the LM stack's serving steps (``steps``) and
the FlashR serving load generator (``serve``)."""
