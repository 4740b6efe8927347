"""PyTorch/CUDA port of ``glam_tpu`` for NVIDIA Hopper (H100).

The JAX package stays beside it as the reference; this package imports
nothing of it, nor JAX.  Ported so far: the serving path of the flagship
single-graph model (featurizer, padded batches, TripletMessage +
GlobalPool5 ``Architecture``, ``serve.Predictor``) with the fused
triplet-attention forward as a CUDA kernel (``csrc/triplet_fused.cu``).
"""
