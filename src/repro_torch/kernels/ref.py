"""Plain-torch oracle for the LUT layer (``repro.kernels.ref``'s counterpart)."""

from __future__ import annotations

import torch


def lut_lookup_ref(codes: torch.Tensor, indices: torch.Tensor,
                   table: torch.Tensor, bw_in: int) -> torch.Tensor:
    """LogicNets LUT-layer inference.

    codes:   (batch, in_features) int32 input activation codes
    indices: (out_features, fan_in) int32 fan-in feature ids per neuron
    table:   (out_features, 2^(fan_in*bw_in)) int32 output codes
    returns: (batch, out_features) int32
    """
    gathered = codes[:, indices.long()]                     # (B, O, FI)
    shifts = bw_in * torch.arange(indices.shape[1], dtype=torch.int32,
                                  device=codes.device)
    entry = (gathered << shifts).sum(-1, dtype=torch.int32)  # (B, O)
    rows = torch.arange(table.shape[0], device=codes.device)
    return table[rows[None, :], entry.long()]
