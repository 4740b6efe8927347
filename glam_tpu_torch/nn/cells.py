"""Functional GRU cell with torch semantics: gate order (r, z, n), both
bias vectors.  Weights are in torch layout ([3H, in], [3H, H])."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gru_cell(x: torch.Tensor, h: torch.Tensor, w_ih: torch.Tensor,
             w_hh: torch.Tensor, b_ih: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    gi = F.linear(x, w_ih, b_ih)
    gh = F.linear(h, w_hh, b_hh)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h
