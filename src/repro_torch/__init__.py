"""PyTorch and CUDA port of the RegC reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``dsm/``, ``kernels/``) and imports torch and numpy,
never jax and nothing of ``repro``.  Entry points run on the CUDA card
unless ``device="cpu"`` is asked for.
"""
