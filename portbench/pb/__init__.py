"""The benchmark of ``repro_torch``, the PyTorch/CUDA port of GoodServe.

One run serves one cell (a model configuration under a traffic mix) through
the port's served path on one card and prints one JSON line; see
``portbench/run.py``.  Nothing here imports JAX or the JAX package
``repro``; the only package of the program it imports is ``repro_torch``.
"""
