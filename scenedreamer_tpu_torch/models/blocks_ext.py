"""Layer-library extension, in PyTorch: the remaining imaginaire block
variants.

Counterpart of `scenedreamer_tpu/models/blocks_ext.py`, with its
semantics, in the layout and naming of `models/blocks.py` (NCW / NCHW /
NCDHW, flax's parameter and submodule names, explicit `in_channels`):
  * `ScaledLeakyReLU` + `get_nonlinearity` (`layers/nonlinearity.py:
    12-67`); 'softmax,<dim>' takes the reference's NCHW dim as it is
    ('softmax' alone: the channel dim 1);
  * the norm zoo `LayerNorm2d`, `ScaleNorm`, `PixelNorm`,
    `PixelLayerNorm`, `SplitMeanStd` (`activation_norm.py:425-570`), with
    torch's unbiased statistics where the JAX package takes them;
  * `Conv1dBlock` / `Conv3dBlock`, `Res1dBlock` / `Res3dBlock`,
    `ResLinearBlock`, `UpRes2dBlock`, `DeepRes2dBlock`;
  * `ModulatedConv2d` (+Block, +Res2dBlock): the style scales the input
    channels, one ordinary conv, then the demodulation factor per
    (sample, output channel); stride 0.5 is JAX's
    `conv_transpose(transpose_kernel=True)` with explicit padding;
  * `MultiOutConv2dBlock` / `MultiOutRes2dBlock`, `PartialConv3d` and the
    partial blocks, `partial_sequential`, `HyperRes2dBlock`,
    `HyperSpatiallyAdaptiveNorm`, `Embedding2d`, `EmbeddingBlock`,
    `Embedding2dBlock`.
Resizes are `jax.image.resize`'s (`ops/resize.py`), never
`F.interpolate`. Noise is an input or drawn from an explicit generator.
"""
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedreamer_tpu_torch.models.blocks import (
    ApplyNoise, BlurDownsample, BlurUpsample, Conv2dBlock, HyperConv2dBlock,
    _Conv, _ConvBlock, _Dense, _FlaxNorm, _FrozenBatchNorm2d, _PartialConv,
    PartialConv2d, _channel, bias_act, draw_noise, hyper_conv2d, make_norm)
from scenedreamer_tpu_torch.models.layers import leaky_relu
from scenedreamer_tpu_torch.ops.resize import resize_bilinear, resize_nearest


def _nhwc(fn, x, size):
    """An NHWC resize of `ops/resize.py` applied to an NCHW tensor."""
    return fn(x.permute(0, 2, 3, 1), size).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# nonlinearity factory (`layers/nonlinearity.py:12-67`)
# ---------------------------------------------------------------------------

def scaled_leaky_relu(x, negative_slope=0.2, scale=math.sqrt(2.0)):
    """`ScaledLeakyReLU` (`nonlinearity.py:12-22`)."""
    return leaky_relu(x, grad_one_at_zero=True, slope=negative_slope) * scale


class ScaledLeakyReLU(nn.Module):
    def __init__(self, negative_slope=0.2, scale=math.sqrt(2.0)):
        super().__init__()
        self.negative_slope, self.scale = negative_slope, scale

    def forward(self, x):
        return scaled_leaky_relu(x, self.negative_slope, self.scale)


def get_nonlinearity(nonlinearity_type, channel_last=False):
    """A callable activation or None (`nonlinearity.py:31-67`
    get_nonlinearity_layer; 'fused_*' is `bias_act` with its gain).
    'softmax,<d>' names an NCHW dim, 'softmax' alone the channel dim 1.
    `channel_last`, for blocks whose features are the last axis, maps it
    as JAX's `get_nonlinearity` does: the channel dim 1 (and 'softmax'
    alone) -> -1, a spatial dim d > 1 -> d - 1, the batch dim 0 -> 0."""
    t = nonlinearity_type or 'none'
    if t.startswith('fused_'):
        return functools.partial(bias_act, act=t[6:])
    if t == 'relu':
        return F.relu
    if t == 'leakyrelu':
        return functools.partial(leaky_relu, grad_one_at_zero=True)
    if t == 'scaled_leakyrelu':
        return scaled_leaky_relu
    if t == 'tanh':
        return torch.tanh
    if t == 'sigmoid':
        return torch.sigmoid
    if t.startswith('softmax'):
        dim = int(t.split(',')[1]) if ',' in t else 1
        if channel_last:
            dim = {0: 0, 1: -1}.get(dim, dim - 1)
        return functools.partial(torch.softmax, dim=dim)
    if t in ('none', ''):
        return None
    raise ValueError(f'unknown nonlinearity {t}')


# ---------------------------------------------------------------------------
# norm zoo (`activation_norm.py:425-570`)
# ---------------------------------------------------------------------------

class LayerNorm2d(nn.Module):
    """Per-sample layer norm with per-channel affine `gamma` / `beta`
    (`activation_norm.py:425-472`): (x - mean) / (std + eps), std
    unbiased, over every non-batch axis or (`channel_only`) the channel
    axis."""

    def __init__(self, features, eps=1e-5, channel_only=False, affine=True):
        super().__init__()
        self.eps, self.channel_only = eps, channel_only
        if affine:
            self.gamma = nn.Parameter(torch.ones(features))
            self.beta = nn.Parameter(torch.zeros(features))
        else:
            self.gamma = self.beta = None

    def forward(self, x):
        dims = 1 if self.channel_only else tuple(range(1, x.dim()))
        mean = x.mean(dims, keepdim=True)
        std = x.std(dims, keepdim=True, correction=1)
        y = (x - mean) / (std + self.eps)
        if self.gamma is not None:
            y = y * _channel(self.gamma, x.dim()) \
                + _channel(self.beta, x.dim())
        return y


class ScaleNorm(nn.Module):
    """RMS scale norm (`activation_norm.py:525-553`) over `dim` (1, the
    channel axis, = the reference's dim 1 and JAX's channel-last -1):
    x * scale * rsqrt(mean(x^2) + eps), `scale` learned or 1."""

    def __init__(self, dim=1, learned_scale=True, eps=1e-5):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.scale = nn.Parameter(torch.ones(())) if learned_scale else None

    def forward(self, x):
        y = x if self.scale is None else x * self.scale
        return y * torch.rsqrt((x * x).mean(self.dim, keepdim=True)
                               + self.eps)


class PixelNorm(ScaleNorm):
    """StyleGAN pixel norm (`activation_norm.py:503-505`): the channel
    ScaleNorm with no learned scale."""

    def __init__(self, dim=1, learned_scale=False, eps=1e-5):
        super().__init__(dim, learned_scale, eps)


class PixelLayerNorm(nn.Module):
    """Per-pixel LayerNorm over the channel axis
    (`activation_norm.py:555-563`): flax's `LayerNorm` as `norm`."""

    def __init__(self, num_channels, use_affine=True):
        super().__init__()
        self.norm = _FlaxNorm(num_channels, affine=use_affine)

    def forward(self, x):
        return self.norm(x)


class SplitMeanStd(nn.Module):
    """Pass-through norm that also emits per-channel (mean, std) maps
    (`activation_norm.py:508-522`), std = sqrt(unbiased var + eps):
    returns (x, cat(mean, std) [N, 2C, 1, ...])."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        dims = tuple(range(2, x.dim()))
        mean = x.mean(dims, keepdim=True)
        var = x.var(dims, keepdim=True, correction=1)
        return x, torch.cat([mean, torch.sqrt(var + self.eps)], dim=1)


# ---------------------------------------------------------------------------
# Conv1d / Conv3d blocks + 1d/3d residual blocks
# (`conv.py` Conv1dBlock/Conv3dBlock, `residual.py:367,532`)
# ---------------------------------------------------------------------------

class _ConvNdBlock(_ConvBlock):
    """Order-string conv block at rank `spatial_rank` (the N-d
    `Conv2dBlock`), its 'A' from `get_nonlinearity`."""

    def __init__(self, in_channels, out_channels, spatial_rank=2,
                 kernel_size=3, stride=1, use_bias=True,
                 weight_norm_type='none', activation_norm_type='none',
                 nonlinearity='leakyrelu', order='CNA', dtype=torch.float32):
        super().__init__(in_channels, out_channels, spatial_rank,
                         kernel_size, stride, use_bias, weight_norm_type,
                         activation_norm_type,
                         get_nonlinearity(nonlinearity), order, dtype=dtype)


class Conv1dBlock(_ConvNdBlock):
    """NCW order-string conv block (`conv.py` Conv1dBlock)."""

    def __init__(self, in_channels, out_channels, **kw):
        super().__init__(in_channels, out_channels, spatial_rank=1, **kw)


class Conv3dBlock(_ConvNdBlock):
    """NCDHW order-string conv block (`conv.py` Conv3dBlock)."""

    def __init__(self, in_channels, out_channels, **kw):
        super().__init__(in_channels, out_channels, spatial_rank=3, **kw)


class _ResNdBlock(nn.Module):
    """N-d residual block with learned shortcut (`residual.py`
    _BaseResBlock): output_scale * (two `_ConvNdBlock`s + the shortcut,
    a bias-free 1x1 `conv_block_s` when the width changes)."""

    def __init__(self, in_channels, out_channels, spatial_rank=2,
                 kernel_size=3, weight_norm_type='none',
                 activation_norm_type='none', nonlinearity='leakyrelu',
                 order='CNACNA', output_scale=1.0, dtype=torch.float32):
        super().__init__()
        half = len(order) // 2
        block = functools.partial(
            _ConvNdBlock, spatial_rank=spatial_rank, kernel_size=kernel_size,
            weight_norm_type=weight_norm_type,
            activation_norm_type=activation_norm_type,
            nonlinearity=nonlinearity, dtype=dtype)
        self.conv_block_0 = block(in_channels, out_channels,
                                  order=order[:half])
        self.conv_block_1 = block(out_channels, out_channels,
                                  order=order[half:])
        self.conv_block_s = _ConvNdBlock(
            in_channels, out_channels, spatial_rank, kernel_size=1,
            use_bias=False, weight_norm_type=weight_norm_type,
            nonlinearity='none', order='C', dtype=dtype) \
            if in_channels != out_channels else None
        self.output_scale = output_scale

    def forward(self, x, update_stats=False):
        h = self.conv_block_1(self.conv_block_0(x, update_stats),
                              update_stats)
        if self.conv_block_s is not None:
            x = self.conv_block_s(x, update_stats)
        return self.output_scale * (h + x)


class Res1dBlock(_ResNdBlock):
    """`residual.py:367` Res1dBlock, NCW."""

    def __init__(self, in_channels, out_channels, **kw):
        super().__init__(in_channels, out_channels, spatial_rank=1, **kw)


class Res3dBlock(_ResNdBlock):
    """`residual.py:532` Res3dBlock, NCDHW."""

    def __init__(self, in_channels, out_channels, **kw):
        super().__init__(in_channels, out_channels, spatial_rank=3, **kw)


class ResLinearBlock(nn.Module):
    """Residual fully-connected block (`residual.py:296`): `fc0`, `fc1`
    each followed by the nonlinearity, plus a bias-free `fc_s` shortcut
    when the width changes."""

    def __init__(self, in_features, out_features, nonlinearity='leakyrelu',
                 output_scale=1.0):
        super().__init__()
        self.act = get_nonlinearity(nonlinearity, channel_last=True)
        self.fc0 = _Dense(in_features, out_features)
        self.fc1 = _Dense(out_features, out_features)
        self.fc_s = _Dense(in_features, out_features, bias=False) \
            if in_features != out_features else None
        self.output_scale = output_scale

    def forward(self, x):
        h = x
        for fc in (self.fc0, self.fc1):
            h = fc(h)
            if self.act is not None:
                h = self.act(h)
        if self.fc_s is not None:
            x = self.fc_s(x)
        return self.output_scale * (h + x)


# ---------------------------------------------------------------------------
# UpRes2dBlock (`residual.py:882-1010`)
# ---------------------------------------------------------------------------

def _nearest_up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class UpRes2dBlock(nn.Module):
    """Residual block with 2x upsampling in the middle of the residual
    branch and before the shortcut (`residual.py:882-1010`): with a first
    half 'NAC' the norm and activation run at input resolution
    (`conv_block_0_na`), then upsample, then conv (`conv_block_0_c`).
    `blur` swaps nearest-neighbour for `BlurUpsample` (`blur_up`)."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 weight_norm_type='none', activation_norm_type='none',
                 nonlinearity='leakyrelu', order='CNACNA', blur=False,
                 output_scale=1.0, dtype=torch.float32):
        super().__init__()
        self.blur_up = BlurUpsample() if blur else None
        half = len(order) // 2
        block = functools.partial(
            _ConvNdBlock, kernel_size=kernel_size,
            weight_norm_type=weight_norm_type,
            activation_norm_type=activation_norm_type,
            nonlinearity=nonlinearity, dtype=dtype)
        self.conv_block_s = _ConvNdBlock(
            in_channels, out_channels, kernel_size=1, use_bias=False,
            weight_norm_type=weight_norm_type, nonlinearity='none',
            order='C', dtype=dtype) if in_channels != out_channels else None
        first = order[:half].upper()
        if first == 'NAC':
            self.conv_block_0_na = block(in_channels, out_channels,
                                         order='NA')
            self.conv_block_0_c = block(in_channels, out_channels, order='C')
        else:
            self.conv_block_0 = block(in_channels, out_channels, order=first)
        self.conv_block_1 = block(out_channels, out_channels,
                                  order=order[half:])
        self.output_scale = output_scale

    def up(self, x):
        return _nearest_up2(x) if self.blur_up is None else self.blur_up(x)

    def forward(self, x, update_stats=False):
        xs = self.up(x)
        if self.conv_block_s is not None:
            xs = self.conv_block_s(xs, update_stats)
        if hasattr(self, 'conv_block_0_na'):
            h = self.up(self.conv_block_0_na(x, update_stats))
            h = self.conv_block_0_c(h, update_stats)
        else:
            h = self.up(self.conv_block_0(x, update_stats))
        h = self.conv_block_1(h, update_stats)
        return self.output_scale * (xs + h)


# ---------------------------------------------------------------------------
# DeepRes2dBlock (`residual_deep.py:13-265`)
# ---------------------------------------------------------------------------

class DeepRes2dBlock(nn.Module):
    """Bottleneck residual block: 1x1-in -> kxk -> kxk (strided, blurred
    at stride 2) -> 1x1-out at hidden = in / hidden_channel_ratio
    (`residual_deep.py:13-265`). The shortcut is blur-downsampled
    (`blur_down`) or 2x2 average-pooled at stride 2, then a 1x1
    `conv_block_s` with `learn_shortcut`; else, when in < out, that conv
    makes the missing channels, concatenated; when in > out, the first
    `out` channels are kept. It carries no nonlinearity unless
    `skip_nonlinearity`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 weight_norm_type='none', activation_norm_type='none',
                 nonlinearity='leakyrelu', skip_nonlinearity=False,
                 order='CNACNA', blur=True, learn_shortcut=False,
                 hidden_channel_ratio=4, output_scale=1.0,
                 dtype=torch.float32):
        super().__init__()
        hidden = max(1, in_channels // hidden_channel_ratio)
        order = 'NACNAC' if order == 'pre_act' else order
        half = len(order) // 2
        block = functools.partial(
            Conv2dBlock, weight_norm_type=weight_norm_type,
            activation_norm_type=activation_norm_type,
            nonlinearity=nonlinearity, dtype=dtype)
        self.conv_block_1x1_in = block(in_channels, hidden, 1,
                                       order=order[:half])
        self.conv_block_0 = block(hidden, hidden, kernel_size,
                                  order=order[:half])
        self.conv_block_1 = block(hidden, hidden, kernel_size, stride=stride,
                                  blur=blur, order=order[half:])
        self.conv_block_1x1_out = block(hidden, out_channels, 1,
                                        order=order[:half])
        self.stride, self.out_channels = stride, out_channels
        self.blur_down = BlurDownsample() if stride > 1 and blur else None
        skip = functools.partial(
            block, kernel_size=1, order=order[:half],
            nonlinearity=nonlinearity if skip_nonlinearity else 'none')
        if learn_shortcut:
            self.conv_block_s = skip(in_channels, out_channels)
        elif in_channels < out_channels:
            self.conv_block_s = skip(in_channels, out_channels - in_channels)
        else:
            self.conv_block_s = None
        self.concat = not learn_shortcut and in_channels < out_channels
        self.output_scale = output_scale

    def forward(self, x, update_stats=False):
        h = self.conv_block_1x1_in(x, update_stats)
        h = self.conv_block_0(h, update_stats)
        h = self.conv_block_1(h, update_stats)
        h = self.conv_block_1x1_out(h, update_stats)
        xs = x
        if self.stride > 1:
            xs = F.avg_pool2d(xs, 2) if self.blur_down is None \
                else self.blur_down(xs)
        if self.concat:
            xs = torch.cat([xs, self.conv_block_s(xs, update_stats)], dim=1)
        elif self.conv_block_s is not None:
            xs = self.conv_block_s(xs, update_stats)
        else:
            xs = xs[:, :self.out_channels]
        return self.output_scale * (xs + h)


# ---------------------------------------------------------------------------
# ModulatedConv2d (`conv.py:278-378`; conv analog of
# `weight_norm.py:17-69` WeightDemodulation)
# ---------------------------------------------------------------------------

class ModulatedConv2d(nn.Module):
    """StyleGAN2 modulated conv: `style` is the already projected
    per-sample input-channel scale [N, I]. conv(x * s, W) == conv(x, W *
    s), then the demodulation rsqrt(sum_{i,hw} (W s)^2 + eps) per (sample,
    output channel) and the bias. Stride 1, 2, or 0.5: the transposed
    conv at stride 2 with JAX's explicit padding (k - 1) // 2 on the
    dilated input (torch's padding k - 1 - that). Weight [O, I, k, k].
    As in JAX, `dtype` is taken and unused: the conv runs in the input's
    dtype."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 use_bias=True, demodulate=True, eps=1e-8,
                 dtype=torch.float32):
        super().__init__()
        self.k, self.stride, self.demodulate, self.eps = \
            kernel_size, stride, demodulate, eps
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) \
            if use_bias else None

    def forward(self, x, style):
        w = self.weight
        xm = x * style[:, :, None, None]
        pad = (self.k - 1) // 2
        if self.stride == 0.5:
            y = F.conv_transpose2d(xm, w.transpose(0, 1), stride=2,
                                   padding=self.k - 1 - pad)
        else:
            y = F.conv2d(xm, w, stride=int(self.stride), padding=pad)
        if self.demodulate:
            wsq = (style * style) @ (w * w).sum((2, 3)).t()       # [N, O]
            y = y * torch.rsqrt(wsq + self.eps)[:, :, None, None]
        if self.bias is not None:
            y = y + _channel(self.bias, y.dim())
        return y


class ModulatedConv2dBlock(nn.Module):
    """Order-string block around `ModulatedConv2d` (`conv.py`
    ModulatedConv2dBlock): 'C' projects the style z [N, style_dim] to the
    input channels (`modulation`, bias initialised to 1), runs the
    modulated `conv`, then `noise` with `apply_noise`."""

    def __init__(self, in_channels, out_channels, style_dim, kernel_size=3,
                 stride=1, demodulate=True, activation_norm_type='none',
                 nonlinearity='leakyrelu', apply_noise=False, order='CNA',
                 dtype=torch.float32):
        super().__init__()
        self.order, self.act = order.upper(), get_nonlinearity(nonlinearity)
        if 'C' in self.order:
            self.modulation = _Dense(style_dim, in_channels, bias_init=1.0)
            self.conv = ModulatedConv2d(in_channels, out_channels,
                                        kernel_size, stride=stride,
                                        demodulate=demodulate, dtype=dtype)
            if apply_noise:
                self.noise = ApplyNoise()
        if 'N' in self.order:
            i = self.order.index('N')
            norm = make_norm(activation_norm_type, out_channels
                             if 'C' in self.order[:i] else in_channels)
            if norm is not None:
                self.norm = norm

    def forward(self, x, z, noise=None, generator=None):
        for op in self.order:
            if op == 'C':
                x = self.conv(x, self.modulation(z))
                if hasattr(self, 'noise'):
                    x = self.noise(x, noise, generator)
            elif op == 'N' and hasattr(self, 'norm'):
                x = self.norm(x)
            elif op == 'A' and self.act is not None:
                x = self.act(x)
        return x


class ModulatedRes2dBlock(nn.Module):
    """Residual pair of modulated conv blocks (`residual.py:276-330`)
    with a plain 1x1 `conv_block_s` when the width changes. Both blocks
    add the same noise, as JAX's pass one key to both: `noise` [N, 1, H,
    W], or one draw from `generator`."""

    def __init__(self, in_channels, out_channels, style_dim, kernel_size=3,
                 demodulate=True, nonlinearity='leakyrelu', apply_noise=True,
                 order='CNACNA', output_scale=1.0, dtype=torch.float32):
        super().__init__()
        half = len(order) // 2
        block = functools.partial(
            ModulatedConv2dBlock, style_dim=style_dim,
            kernel_size=kernel_size, demodulate=demodulate,
            nonlinearity=nonlinearity, apply_noise=apply_noise, dtype=dtype)
        self.conv_block_0 = block(in_channels, out_channels,
                                  order=order[:half])
        self.conv_block_1 = block(out_channels, out_channels,
                                  order=order[half:])
        self.conv_block_s = Conv2dBlock(
            in_channels, out_channels, kernel_size=1, nonlinearity='none',
            order='C', dtype=dtype) if in_channels != out_channels else None
        self.apply_noise, self.output_scale = apply_noise, output_scale

    def forward(self, x, z, noise=None, generator=None):
        if self.apply_noise and noise is None:
            noise = draw_noise(x, generator)
        h = self.conv_block_0(x, z, noise)
        h = self.conv_block_1(h, z, noise)
        if self.conv_block_s is not None:
            x = self.conv_block_s(x)
        return self.output_scale * (h + x)


# ---------------------------------------------------------------------------
# MultiOut blocks (`conv.py` _MultiOutBaseConvBlock,
# `residual.py:1284-1331`)
# ---------------------------------------------------------------------------

class MultiOutConv2dBlock(nn.Module):
    """Conv block whose norm step may emit an auxiliary output: with
    'split_mean_std' the per-channel (mean, std) map of `SplitMeanStd`,
    else None. Returns (x, aux)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 activation_norm_type='none', nonlinearity='leakyrelu',
                 order='CNA', dtype=torch.float32):
        super().__init__()
        self.order, self.act = order.upper(), get_nonlinearity(nonlinearity)
        if 'C' in self.order:
            self.conv = _Conv(in_channels, out_channels, kernel_size,
                              stride=stride, dtype=dtype)
        self.norm = None
        if 'N' in self.order:
            i = self.order.index('N')
            self.norm = SplitMeanStd() \
                if activation_norm_type == 'split_mean_std' else make_norm(
                    activation_norm_type, out_channels
                    if 'C' in self.order[:i] else in_channels)

    def forward(self, x, update_stats=False):
        aux = None
        for op in self.order:
            if op == 'C':
                x = self.conv(x)
            elif op == 'N' and self.norm is not None:
                if isinstance(self.norm, SplitMeanStd):
                    x, aux = self.norm(x)
                else:
                    x = self.norm(x)
            elif op == 'A' and self.act is not None:
                x = self.act(x)
        return x, aux


class MultiOutRes2dBlock(nn.Module):
    """Residual block returning (out, aux0, aux1)
    (`residual.py:1284-1331`)."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 activation_norm_type='none', nonlinearity='leakyrelu',
                 order='CNACNA', output_scale=1.0, dtype=torch.float32):
        super().__init__()
        half = len(order) // 2
        block = functools.partial(
            MultiOutConv2dBlock, kernel_size=kernel_size,
            activation_norm_type=activation_norm_type,
            nonlinearity=nonlinearity, dtype=dtype)
        self.conv_block_0 = block(in_channels, out_channels,
                                  order=order[:half])
        self.conv_block_1 = block(out_channels, out_channels,
                                  order=order[half:])
        self.conv_block_s = MultiOutConv2dBlock(
            in_channels, out_channels, kernel_size=1, nonlinearity='none',
            order='C', dtype=dtype) if in_channels != out_channels else None
        self.output_scale = output_scale

    def forward(self, x, update_stats=False):
        h, aux0 = self.conv_block_0(x)
        h, aux1 = self.conv_block_1(h)
        if self.conv_block_s is not None:
            x, _ = self.conv_block_s(x)
        return self.output_scale * (h + x), aux0, aux1


# ---------------------------------------------------------------------------
# Partial convolutions, rank 3 + block/residual/sequential forms
# (`conv.py:910-1105,1307-1366`, `misc.py:33-48`)
# ---------------------------------------------------------------------------

class PartialConv3d(_PartialConv):
    """Partial 3D convolution (`conv.py:1307-1366`), NCDHW; the mask
    contract of `blocks.PartialConv2d`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 use_bias=True, multi_channel=False, return_mask=True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         use_bias, multi_channel, return_mask, rank=3)


class _PartialConvNdBlock(nn.Module):
    """Order-string block over a partial conv (`conv`); the mask threads
    through and is returned (`conv.py:910-1028`)."""

    def __init__(self, in_channels, out_channels, spatial_rank=2,
                 kernel_size=3, stride=1, multi_channel=False,
                 activation_norm_type='none', nonlinearity='leakyrelu',
                 order='CNA'):
        super().__init__()
        self.order, self.act = order.upper(), get_nonlinearity(nonlinearity)
        cls = PartialConv2d if spatial_rank == 2 else PartialConv3d
        if 'C' in self.order:
            self.conv = cls(in_channels, out_channels, kernel_size,
                            stride=stride, multi_channel=multi_channel)
        if 'N' in self.order:
            i = self.order.index('N')
            norm = make_norm(activation_norm_type, out_channels
                             if 'C' in self.order[:i] else in_channels)
            if norm is not None:
                self.norm = norm

    def forward(self, x, mask_in=None):
        mask = mask_in
        for op in self.order:
            if op == 'C':
                x, mask = self.conv(x, mask)
            elif op == 'N' and hasattr(self, 'norm'):
                x = self.norm(x)
            elif op == 'A' and self.act is not None:
                x = self.act(x)
        return x, mask


class PartialConv2dBlock(_PartialConvNdBlock):
    def __init__(self, in_channels, out_channels, **kw):
        super().__init__(in_channels, out_channels, spatial_rank=2, **kw)


class PartialConv3dBlock(_PartialConvNdBlock):
    def __init__(self, in_channels, out_channels, **kw):
        super().__init__(in_channels, out_channels, spatial_rank=3, **kw)


class _PartialResNdBlock(nn.Module):
    """Residual partial-conv block (`residual.py` PartialRes2dBlock /
    PartialRes3dBlock); returns the residual branch's mask."""

    def __init__(self, in_channels, out_channels, spatial_rank=2,
                 kernel_size=3, multi_channel=False,
                 nonlinearity='leakyrelu', order='CNACNA'):
        super().__init__()
        half = len(order) // 2
        block = functools.partial(
            _PartialConvNdBlock, spatial_rank=spatial_rank,
            kernel_size=kernel_size, multi_channel=multi_channel,
            nonlinearity=nonlinearity)
        self.conv_block_0 = block(in_channels, out_channels,
                                  order=order[:half])
        self.conv_block_1 = block(out_channels, out_channels,
                                  order=order[half:])
        self.conv_block_s = _PartialConvNdBlock(
            in_channels, out_channels, spatial_rank, kernel_size=1,
            nonlinearity='none', order='C') \
            if in_channels != out_channels else None

    def forward(self, x, mask_in=None):
        h, mask = self.conv_block_0(x, mask_in)
        h, mask = self.conv_block_1(h, mask)
        if self.conv_block_s is not None:
            x, _ = self.conv_block_s(x, mask_in)
        return h + x, mask


class PartialRes2dBlock(_PartialResNdBlock):
    def __init__(self, in_channels, out_channels, **kw):
        super().__init__(in_channels, out_channels, spatial_rank=2, **kw)


class PartialRes3dBlock(_PartialResNdBlock):
    def __init__(self, in_channels, out_channels, **kw):
        super().__init__(in_channels, out_channels, spatial_rank=3, **kw)


def partial_sequential(modules, x, mask):
    """Chain partial-conv modules, threading (x, mask) (`misc.py:33-48`
    PartialSequential; the mask stays an explicit operand)."""
    for m in modules:
        x, mask = m(x, mask)
    return x, mask


# ---------------------------------------------------------------------------
# Hyper residual block + hyper SPADE norm
# (`residual.py:613-667`, `activation_norm.py:334-424`)
# ---------------------------------------------------------------------------

class HyperRes2dBlock(nn.Module):
    """Residual pair of blocks (`residual.py:613-667`) whose slots
    (block 0, block 1, the shortcut, built when the width changes) take
    hypernetwork weights where `hyper` says so (a `HyperConv2dBlock`
    that owns only its norm), else are plain `Conv2dBlock`s. JAX picks
    the kind per call from which weights are None; here it is fixed at
    construction, and `forward` refuses weights that disagree with it."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 activation_norm_type='none', nonlinearity='leakyrelu',
                 order='CNACNA', output_scale=1.0,
                 hyper=(True, True, True)):
        super().__init__()
        half = len(order) // 2
        self.hyper, self.output_scale = tuple(hyper), output_scale

        def make(i, cin, block_order):
            cls = HyperConv2dBlock if self.hyper[i] else Conv2dBlock
            return cls(cin, out_channels, kernel_size,
                       activation_norm_type=activation_norm_type,
                       nonlinearity=nonlinearity, order=block_order)

        self.conv_block_0 = make(0, in_channels, order[:half])
        self.conv_block_1 = make(1, out_channels, order[half:])
        self.conv_block_s = make(2, in_channels, 'C') \
            if in_channels != out_channels else None

    def forward(self, x, conv_weights=(None,) * 3):
        def run(block, i, h):
            w = conv_weights[i] if i < len(conv_weights) else None
            if (w is not None) != self.hyper[i]:
                raise ValueError(f'slot {i} was built with hyper='
                                 f'{self.hyper[i]}')
            return block(h, conv_weights=w) if self.hyper[i] else block(h)

        h = run(self.conv_block_1, 1, run(self.conv_block_0, 0, x))
        if self.conv_block_s is not None:
            x = run(self.conv_block_s, 2, x)
        return self.output_scale * (h + x)


class HyperSpatiallyAdaptiveNorm(nn.Module):
    """SPADE whose first conditional head may take hypernetwork conv
    weights (`activation_norm.py:334-424`): the frozen batch norm `norm`
    without affine, then per condition i the gamma / beta of the nearest
    resized label, from `norm_weights` ((OIHW weight [N, 2F, C, k, k],
    bias) per sample) when `is_hyper` and i == 0, else from `mlp_{i}_0`
    (relu, with `num_filters`) and `mlp_{i}_1`. `cond_inputs` entries
    may be None (skipped) or (cond, mask) pairs: the mask, bilinearly
    resized, zeroes gamma and beta where it is 1."""

    def __init__(self, num_features, cond_dims, num_filters=0,
                 kernel_size=3, is_hyper=True):
        super().__init__()
        self.cond_dims, self.is_hyper = tuple(cond_dims), is_hyper
        self.pad = (kernel_size - 1) // 2
        self.norm = _FrozenBatchNorm2d(num_features, affine=False)
        for i, c in enumerate(self.cond_dims):
            if is_hyper and i == 0:
                continue
            if num_filters > 0:
                self.add_module(f'mlp_{i}_0', Conv2dBlock(
                    c, num_filters, kernel_size, nonlinearity='relu'))
            self.add_module(f'mlp_{i}_1', Conv2dBlock(
                num_filters if num_filters > 0 else c, 2 * num_features,
                kernel_size, nonlinearity='none'))

    def forward(self, x, cond_inputs, norm_weights=None):
        out = self.norm(x)
        size = tuple(x.shape[2:])
        for i in range(len(self.cond_dims)):
            ci = cond_inputs[i] if i < len(cond_inputs) else None
            if ci is None:
                continue
            if isinstance(ci, (tuple, list)):
                cond, mask = ci
                mask = _nhwc(resize_bilinear, mask, size)
            else:
                cond, mask = ci, None
            label = _nhwc(resize_nearest, cond, size)
            if self.is_hyper and i == 0:
                w, b = norm_weights if norm_weights is not None \
                    else (None, None)
                affine = hyper_conv2d(label, w, b, padding=self.pad)
            else:
                h = label
                if hasattr(self, f'mlp_{i}_0'):
                    h = getattr(self, f'mlp_{i}_0')(h)
                affine = getattr(self, f'mlp_{i}_1')(h)
            gamma, beta = affine.chunk(2, dim=1)
            if mask is not None:
                gamma = gamma * (1.0 - mask)
                beta = beta * (1.0 - mask)
            out = out * (1.0 + gamma) + beta
        return out


# ---------------------------------------------------------------------------
# Embeddings (`conv.py:440-486,1370-1380`)
# ---------------------------------------------------------------------------

class Embedding2d(nn.Module):
    """Per-pixel label embedding: int map [N, H, W] or [N, 1, H, W] ->
    [N, features, H, W] (`conv.py:1370-1380`), the table `embed`."""

    def __init__(self, num_classes, features):
        super().__init__()
        self.embed = nn.Embedding(num_classes, features)
        nn.init.normal_(self.embed.weight, std=1.0 / math.sqrt(features))

    def forward(self, x):
        if x.dim() == 4:
            x = x[:, 0]
        return self.embed(x.long()).permute(0, 3, 1, 2)


class EmbeddingBlock(nn.Module):
    """Order-string block whose 'C' is an embedding lookup (`embed`) over
    int ids of any shape -> [..., features] (`conv.py:440-462`)."""

    def __init__(self, num_classes, features, nonlinearity='none',
                 order='CNA'):
        super().__init__()
        self.order = order.upper()
        self.act = get_nonlinearity(nonlinearity, channel_last=True)
        self.embed = nn.Embedding(num_classes, features)
        nn.init.normal_(self.embed.weight, std=1.0 / math.sqrt(features))

    def forward(self, x):
        for op in self.order:
            if op == 'C':
                x = self.embed(x.long())
            elif op == 'A' and self.act is not None:
                x = self.act(x)
        return x


class Embedding2dBlock(nn.Module):
    """`EmbeddingBlock` over 2-D label maps (`conv.py:464-486`): 'C' is
    `Embedding2d` (`embed2d`)."""

    def __init__(self, num_classes, features, nonlinearity='none',
                 order='CNA'):
        super().__init__()
        self.order, self.act = order.upper(), get_nonlinearity(nonlinearity)
        self.embed2d = Embedding2d(num_classes, features)

    def forward(self, x):
        for op in self.order:
            if op == 'C':
                x = self.embed2d(x)
            elif op == 'A' and self.act is not None:
                x = self.act(x)
        return x
