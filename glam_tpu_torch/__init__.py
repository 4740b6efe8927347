"""PyTorch/CUDA port of ``glam_tpu`` for NVIDIA Hopper (H100).

The JAX package stays beside it as the reference; this package imports
nothing of it, nor JAX.  It trains (``run``, ``--dtype bfloat16``
included) and serves (``serve``, from its own ``.pt`` checkpoints or the
JAX package's ``.ckpt`` ones, read by ``convert.load_jax_checkpoint``
through ``utils/msgpack.py``) the single-graph and pair models with the
whole layer library, runs the AutoML search with blending and PASP
(``glam``, ``automl/``), builds the PASP set (``data/perturb_builder``,
``chem/fingerprints``), draws atom-level attention (``viz/``), and
carries the attention in hand-written CUDA kernels (``csrc/``, built by
``ops/kernels/build.py``), beside the C++ SMILES featurizer
(``csrc/glam_native.cpp``, bound by ``chem/native.py``).
"""
