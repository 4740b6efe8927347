"""The port's CUDA kernels: kernel A and B (``triplet_fused``), kernel C
both ways (``segment_softmax_spmm``), their ``build`` and shared
``common`` launch code."""
from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """{kernel: launches in this process}: each wrapper counts where it
    launches its CUDA kernel, never on the CPU."""
    from .segment_softmax_spmm import (segment_softmax_spmm,
                                       segment_softmax_spmm_bwd)
    from .triplet_fused import triplet_attention, triplet_attention_bwd
    return {"triplet_fused_fwd": triplet_attention.launches,
            "triplet_fused_bwd": triplet_attention_bwd.launches,
            "segment_softmax_spmm_fwd": segment_softmax_spmm.launches,
            "segment_softmax_spmm_bwd": segment_softmax_spmm_bwd.launches}
