"""Functional recurrent cells with torch semantics.

  gru_cell   torch GRU (sequence length 1): gate order (r, z, n), both
             bias vectors; weights in torch layout ([3H, in], [3H, H]).
  lstm_cell  torch LSTM cell: gate order (i, f, g, o), both bias
             vectors; weights in the JAX package's input-major layout
             ([in, 4H], [H, 4H]), as ``Set2Set`` keeps them.
"""
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


def lstm_cell(inp: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
              b_hh: torch.Tensor):
    """-> (h', c')."""
    z = inp @ w_ih + b_ih + h @ w_hh + b_hh
    i, f, g, o = z.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c2 = f * c + i * torch.tanh(g)
    return o * torch.tanh(c2), c2
