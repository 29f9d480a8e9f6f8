"""PyTorch/CUDA port of the GoodServe serving engine.

The JAX package ``repro`` is the reference; module names here mirror it.
This package imports neither ``jax`` nor anything of ``repro``.  Its entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""
