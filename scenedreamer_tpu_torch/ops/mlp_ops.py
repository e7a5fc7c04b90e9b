"""The RenderMLP's hidden layer as a `torch.library` op, namespace `sd`.

    sd::render_mlp_gemm      K6       csrc/mlp_gemm.cu

    leaky_relu_0.2(x @ w^T + shift (+ m @ wm^T))

x [B, R, K]; w [N, K] shared by the batch (the first layer's
`fc_1.weight`, `shift` its bias [N]) or [B, N, K] (a `ModLinear`'s
weight * alpha_b, `shift` its beta_b [B, N]); the first layer's label
term m [B, R, Km] against wm [N, Km] (`fc_m_a.weight`) -> [B, R, N].

As `ops/hash_ops.py`'s ops, three implementations: for CUDA tensors
`kernels.render_mlp_gemm`, one launch with the shift, the label term and
the LeakyReLU in the GEMM's epilogue (counted under 'render_mlp_gemm');
for CPU tensors the plain composition `render_mlp_gemm_plain`, which
`models/layers.py:RenderMLP` also runs where autograd records or the
layers compute in bfloat16;
and a fake one giving the output's shape and dtype, so `torch.export`
traces through it and a saved tile program names it. The op has no
gradient: `RenderMLP` calls it only where autograd records nothing.
"""
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from scenedreamer_tpu_torch import kernels


def _leaky_relu(y):
    return F.leaky_relu(y, 0.2)


def render_mlp_gemm_plain(x, w, shift, m=None, wm=None, act=_leaky_relu):
    """The layer in plain ops: `F.linear` with the bias (shared w) or
    `bmm` plus the broadcast shift, the label product added after, then
    the activation (`act`: the float32 LeakyReLU; the RenderMLP passes
    `models/layers.py:leaky_relu`, whose slope follows the dtype)."""
    if w.dim() == 2:
        y = F.linear(x, w, shift)
    else:
        y = torch.bmm(x, w.transpose(1, 2)) + shift[:, None]
    if m is not None:
        y = y + F.linear(m, wm)
    return act(y)


@torch.library.custom_op('sd::render_mlp_gemm', mutates_args=(),
                         device_types='cpu')
def render_mlp_gemm(x: Tensor, w: Tensor, shift: Tensor,
                    m: Optional[Tensor] = None,
                    wm: Optional[Tensor] = None) -> Tensor:
    """K6: one RenderMLP hidden layer, see the module docstring."""
    return render_mlp_gemm_plain(x, w, shift, m, wm)


@render_mlp_gemm.register_kernel('cuda')
def _(x, w, shift, m=None, wm=None):
    return kernels.render_mlp_gemm(
        x.contiguous(), w.contiguous(), shift.contiguous(),
        None if m is None else m.contiguous(),
        None if wm is None else wm.contiguous())


@render_mlp_gemm.register_fake
def _(x, w, shift, m=None, wm=None):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[-2]),
                       dtype=torch.float32)
