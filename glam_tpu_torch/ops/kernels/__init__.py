"""The port's CUDA kernels: kernel A and B (``triplet_fused``), kernel C
both ways (``segment_softmax_spmm``), the fixed-order CSR sum
(``segment_sum_csr``), their ``build`` and shared ``common`` launch
code."""
from __future__ import annotations

from typing import Dict


def _counted():
    from .segment_softmax_spmm import (segment_softmax_spmm,
                                       segment_softmax_spmm_bwd)
    from .segment_sum_csr import segment_sum_csr
    from .triplet_fused import triplet_attention, triplet_attention_bwd
    return {"triplet_fused_fwd": triplet_attention,
            "triplet_fused_bwd": triplet_attention_bwd,
            "segment_softmax_spmm_fwd": segment_softmax_spmm,
            "segment_softmax_spmm_bwd": segment_softmax_spmm_bwd,
            "segment_sum_csr": segment_sum_csr}


def launch_counts() -> Dict[str, int]:
    """{kernel: launches in this process}: each wrapper counts where it
    launches its CUDA kernel, never on the CPU; a CUDA graph's replay adds
    the launches it holds (:func:`add_launches`)."""
    return {name: fn.launches for name, fn in _counted().items()}


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` ({kernel: launches}) to the wrappers'
    counts: a CUDA graph's replays add the launches recorded while it was
    captured (``train/step_graph.py``), and its capture takes them back,
    since a capture runs nothing."""
    for name, fn in _counted().items():
        fn.launches += times * counts.get(name, 0)
