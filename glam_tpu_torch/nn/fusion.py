"""Cross-graph fusion pooling for the pair models (DDI / DTI), the port
of the JAX package's ``nn/fusion.py``.

For every sample pair g the all-pairs node dot-product matrix
``S_g = X_mol_g @ X_pro_g^T`` is reduced to scalar statistics: both node
sets are scattered to dense per-graph tensors [G, M, C], one batched
product gives [G, Mm, Mp], and masked reductions give the statistics.
The product is a plain ``torch.bmm``, as the JAX package computes it
outside any Pallas kernel.  Parity notes:

  * the max is ``torch.amax``, which splits the gradient of tied maxima
    evenly, as JAX's reduce-max does (``torch.max(dim)`` sends it all to
    one index);
  * std is the *unbiased* one (n-1 divisor), median the lower middle
    element ``sorted[(n-1)//2]``, the tie order of a stable sort;
  * an empty graph gives zeros, taken with ``torch.where`` after the
    masked reductions so that no ``0 * inf`` reaches the backward.
"""
from __future__ import annotations

import torch

from ..ops.segment import scatter_nodes_to_dense


def _pair_scores(xm, xp, m_graph, m_pos, m_count, p_graph, p_pos, p_count,
                 num_graphs, max_m, max_p):
    dm = scatter_nodes_to_dense(xm, m_graph, m_pos, num_graphs, max_m)
    dp = scatter_nodes_to_dense(xp, p_graph, p_pos, num_graphs, max_p)
    s = torch.bmm(dm, dp.transpose(1, 2))                   # [G, Mm, Mp]
    mvalid = (torch.arange(max_m, device=xm.device)[None, :]
              < m_count[:, None])
    pvalid = (torch.arange(max_p, device=xm.device)[None, :]
              < p_count[:, None])
    valid = mvalid[:, :, None] & pvalid[:, None, :]         # [G, Mm, Mp]
    return s, valid


def dot_and_global_pool(xm, xp, m_graph, m_pos, m_count, p_graph, p_pos,
                        p_count, num_graphs: int, max_m: int, max_p: int,
                        stats5: bool) -> torch.Tensor:
    """Per-pair dot-product statistics.

    stats5=False -> [max, mean] (dot_and_global_pool2, the pair models')
    stats5=True  -> [max, mean, median, min, std] (dot_and_global_pool5)
    Empty graphs yield zeros.
    """
    s, valid = _pair_scores(xm, xp, m_graph, m_pos, m_count, p_graph, p_pos,
                            p_count, num_graphs, max_m, max_p)
    G = num_graphs
    flat = s.reshape(G, -1)
    vflat = valid.reshape(G, -1)
    cnt = vflat.sum(dim=1).to(flat.dtype)                   # [G]
    safe_cnt = cnt.clamp(min=1.0)
    zero = flat.new_zeros(())
    empty = cnt < 0.5
    mx = torch.where(empty, zero, torch.amax(
        flat.masked_fill(~vflat, -torch.inf), dim=1))
    mean = torch.where(vflat, flat, zero).sum(dim=1) / safe_cnt
    mean = torch.where(empty, zero, mean)
    if not stats5:
        return torch.stack([mx, mean], dim=-1)
    pos = flat.masked_fill(~vflat, torch.inf)
    mn = torch.where(empty, zero, torch.amin(pos, dim=1))
    # unbiased std over the valid entries
    d = torch.where(vflat, flat - mean[:, None], zero)
    var = (d * d).sum(dim=1) / (cnt - 1.0).clamp(min=1.0)
    std = torch.where(empty, zero, torch.sqrt(var))
    # lower median sorted[(n-1)//2]; the +inf padding sorts last
    srt = torch.sort(pos, dim=1, stable=True).values
    med_idx = ((cnt - 1.0) / 2.0).to(torch.int64).clamp(0, flat.shape[1] - 1)
    med = torch.gather(srt, 1, med_idx[:, None])[:, 0]
    med = torch.where(empty, zero, med)
    return torch.stack([mx, mean, med, mn, std], dim=-1)
