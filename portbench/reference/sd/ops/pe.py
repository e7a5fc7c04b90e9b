"""Sinusoidal positional encoding (counterpart of
`scenedreamer_tpu/ops/pe.py`; reference `voxlib/positional_encoding.py:45-54`):
[sin(x*pi*2^0), cos(x*pi*2^0), ..., sin(x*pi*2^(deg-1)), cos(...), (x)]
concatenated along the last dim."""
import math

import torch


def positional_encoding(x, degrees, incl_orig=False):
    """x: [..., C] -> [..., degrees*2*C (+C if incl_orig)]."""
    if degrees == 0:
        return x if incl_orig else None
    feats = []
    for i in range(degrees):
        scaled = x * (math.pi * (2.0 ** i))
        feats.append(torch.sin(scaled))
        feats.append(torch.cos(scaled))
    if incl_orig:
        feats.append(x)
    return torch.cat(feats, dim=-1)


def pe_out_dim(in_dim, degrees, incl_orig):
    return in_dim * degrees * 2 + (in_dim if incl_orig else 0)
