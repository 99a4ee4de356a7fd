"""The benchmark of the PyTorch/CUDA port of FlashR (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``calibrate.py`` reads
the numbers that decide ``correct`` for the program and for its control over
many seeds.  Nothing here imports JAX or the JAX package.
"""
