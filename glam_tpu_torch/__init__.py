"""PyTorch/CUDA port of ``glam_tpu`` for NVIDIA Hopper (H100).

The JAX package stays beside it as the reference; this package imports
nothing of it, nor JAX.  It trains (``run``) and serves (``serve``)
the single-graph and pair models with the whole layer library, runs the
AutoML search with blending and PASP (``glam``, ``automl/``), and
carries the attention in hand-written CUDA kernels (``csrc/``, built by
``ops/kernels/build.py``).
"""
