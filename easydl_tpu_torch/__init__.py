"""easydl_tpu_torch — the PyTorch/CUDA port of easydl_tpu, for NVIDIA Hopper.

The JAX package ``easydl_tpu`` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copy of what it needs. Its layout
mirrors the JAX package's (``ops/``, ``models/``, ``core/``, ``utils/``).
"""
