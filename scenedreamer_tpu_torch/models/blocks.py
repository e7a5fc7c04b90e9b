"""Composable layer library, in PyTorch: order-string Conv / Linear / Res
blocks, up/fir/down resampling, bias + activation.

Counterpart of `scenedreamer_tpu/models/blocks.py` (reference
`imaginaire/layers/{conv,residual,activation_norm,weight_norm,misc,
non_local,vit}.py` and `third_party/{upfirdn2d,bias_act}`), with the JAX
package's semantics:
  * `bias_act` with the `_ACTS` gain table; the blocks apply it with gain
    1 unless the nonlinearity's name starts with `fused_`;
  * `upfirdn2d` (zero-stuff, flipped FIR scaled by gain * up^2, crop on
    negative padding, stride after the full-resolution filter) as a
    depthwise conv; `Blur`, `BlurUpsample`, `BlurDownsample`;
  * `make_norm`: flax's `GroupNorm` / `LayerNorm` (epsilon 1e-6, variance
    as E[x^2] - E[x]^2, statistics in float32) and the frozen batch norm;
  * weight norms 'spectral' (flax's `SpectralNorm`: one power step from
    the stored `u` on every call, `u` and sigma written back only with
    `update_stats`) and 'weight' (`w = v * g / ||v||` per output channel).

Layout: NCHW / NCW / NCDHW, the reference's (the JAX package is channel
last). Parameter and submodule names are the flax names (`conv.weight` for
flax's `conv/kernel`, `norm` for flax's auto-named `GroupNorm_0`, ...), so
`utils/convert.py:blocks_state_dict_from_flax` maps flax variables onto
these modules. `in_channels` are explicit (flax infers them). `dtype` is
the compute dtype of the convs and linears (flax's `dtype`): parameters
stay float32 and each conv casts its input, weight and bias; the norms
compute their statistics in float32. Noise is an input or drawn from an
explicit `torch.Generator`.
"""
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedreamer_tpu_torch.models.discriminator import spectral_normalize
from scenedreamer_tpu_torch.models.layers import leaky_relu
from scenedreamer_tpu_torch.models.spade import xavier_gain_


def _channel(t, ndim, dim=1):
    """A [C] tensor shaped to broadcast over axis `dim` of an ndim tensor."""
    shape = [1] * ndim
    shape[dim] = -1
    return t.reshape(shape)


def _promote(t, p):
    """t cast to the promotion of its dtype with p's, as JAX promotes a
    bf16 activation times a float32 scalar parameter (torch keeps the
    dimensioned operand's dtype)."""
    return t.to(torch.promote_types(t.dtype, p.dtype))


def _lrelu(x):
    return leaky_relu(x, grad_one_at_zero=True)


# ---------------------------------------------------------------------------
# bias_act (`third_party/bias_act/bias_act.py:12-39`)
# ---------------------------------------------------------------------------

_ACTS = {
    'linear': (lambda x: x, 1.0),
    'relu': (F.relu, math.sqrt(2.0)),
    'lrelu': (_lrelu, math.sqrt(2.0)),
    'leakyrelu': (_lrelu, 1.0),
    'tanh': (torch.tanh, 1.0),
    'sigmoid': (torch.sigmoid, 1.0),
    'elu': (F.elu, 1.0),
    'selu': (F.selu, 1.0),
    'softplus': (F.softplus, 1.0),
    'swish': (F.silu, math.sqrt(2.0)),
}


def bias_act(x, b=None, act='linear', gain=None, clamp=None, dim=1):
    """Bias (over axis `dim`, the channel axis) + activation + gain +
    clamp (`bias_act.py:59-86` reference implementation)."""
    fn, def_gain = _ACTS[act]
    if b is not None:
        x = x + _channel(b, x.dim(), dim)
    x = fn(x)
    g = def_gain if gain is None else gain
    if g != 1.0:
        x = x * g
    if clamp is not None and clamp >= 0:
        x = torch.clamp(x, -clamp, clamp)
    return x


def _block_activation(nonlinearity):
    """The 'A' step of `Conv2dBlock` and its kin: `bias_act` with gain 1
    (torch's `get_nonlinearity_layer`), or with `_ACTS`' gain under a
    `fused_` name; None for 'none'."""
    if nonlinearity in (None, 'none', ''):
        return None
    fused = nonlinearity.startswith('fused_')
    act = nonlinearity[6:] if fused else nonlinearity
    if act not in _ACTS:
        raise ValueError(f'unknown nonlinearity {nonlinearity}')
    return functools.partial(bias_act, act=act, gain=None if fused else 1.0)


# ---------------------------------------------------------------------------
# upfirdn2d (`third_party/upfirdn2d/upfirdn2d.py`)
# ---------------------------------------------------------------------------

def setup_filter(f=None, normalize=True, gain=1.0, separable=None):
    """1D/2D FIR kernel -> normalized 2D filter (default [1,3,3,1])."""
    if f is None:
        f = [1.0, 3.0, 3.0, 1.0]
    f = np.asarray(f, np.float32)
    if f.ndim == 1:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    return f * gain


def upfirdn2d(x, f, up=1, down=1, padding=0, gain=1.0):
    """Upsample (zero-stuff) -> FIR filter -> downsample of an NCHW
    tensor; padding int or (left, right, top, bottom), negative crops."""
    b, c, h, w = x.shape
    if isinstance(padding, int):
        padding = (padding,) * 4
    px0, px1, py0, py1 = padding
    if up > 1:
        x = F.pad(x.reshape(b, c, h, 1, w, 1),
                  (0, up - 1, 0, 0, 0, up - 1)).reshape(b, c, h * up, w * up)
    x = F.pad(x, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    if min(px0, px1, py0, py1) < 0:
        x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
              max(-px0, 0):x.shape[3] - max(-px1, 0)]
    f = f if torch.is_tensor(f) else torch.from_numpy(
        np.asarray(f, np.float32))
    kern = (f.flip(0, 1) * (gain * up ** 2)).to(x.device, x.dtype)
    y = F.conv2d(x, kern[None, None].expand(c, 1, *kern.shape), groups=c)
    if down > 1:
        y = y[:, :, ::down, ::down]
    return y


class _Fir(nn.Module):
    """A FIR filter held as a non-persistent buffer (flax keeps no
    variable for it)."""

    def __init__(self, kernel=None):
        super().__init__()
        self.register_buffer('f', torch.from_numpy(setup_filter(kernel)),
                             persistent=False)


class Blur(_Fir):
    """FIR blur, shape-preserving (`upfirdn2d.py` Blur module)."""

    def forward(self, x):
        p = self.f.shape[0] - 1
        return upfirdn2d(x, self.f,
                         padding=(p // 2, p - p // 2, p // 2, p - p // 2))


class BlurUpsample(_Fir):
    def forward(self, x):
        p = self.f.shape[0] - 2
        return upfirdn2d(x, self.f, up=2, gain=1.0,
                         padding=((p + 1) // 2 + 1, p // 2,
                                  (p + 1) // 2 + 1, p // 2))


class BlurDownsample(_Fir):
    def forward(self, x):
        p = self.f.shape[0] - 2
        return upfirdn2d(x, self.f, down=2,
                         padding=((p + 1) // 2, p // 2, (p + 1) // 2, p // 2))


# ---------------------------------------------------------------------------
# activation norms (`layers/activation_norm.py` get_activation_norm_layer)
# ---------------------------------------------------------------------------

def _flax_dims(ndim, axes):
    """The dims of an (N, C, *S) tensor that are the channel-last axes
    `axes` of the JAX layout (N, *S, C)."""
    perm = [0, *range(2, ndim), 1]
    return tuple(sorted(perm[a] for a in axes))


class _FlaxNorm(nn.Module):
    """flax's `GroupNorm` / `LayerNorm` over an (N, C, *S) tensor:
    epsilon 1e-6, statistics in float32 with the variance as E[x^2] -
    E[x]^2 (floored at 0), then (x - mean) * (rsqrt(var + eps) * scale)
    + bias, scale and bias per channel. `groups` > 0 normalises each
    group of channels over them and every spatial axis (GroupNorm; 0:
    one group per channel, whatever the width); `groups` None normalises
    over the JAX layout's `axes` (LayerNorm)."""

    def __init__(self, num_channels, groups=None, axes=(-1,), affine=True,
                 eps=1e-6):
        super().__init__()
        self.groups, self.axes, self.eps = groups, axes, eps
        if affine:
            self.scale = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))
        else:
            self.scale = self.bias = None

    def forward(self, x):
        xf = x.float()
        if self.groups is None:
            dims = _flax_dims(x.dim(), self.axes)
            mean = xf.mean(dims, keepdim=True)
            mean2 = (xf * xf).mean(dims, keepdim=True)
        else:
            n, c = x.shape[:2]
            g = self.groups or c
            xg = xf.reshape(n, g, -1)
            shape = (n, c) + (1,) * (x.dim() - 2)
            mean = xg.mean(-1).repeat_interleave(c // g, 1).reshape(shape)
            mean2 = (xg * xg).mean(-1).repeat_interleave(c // g, 1) \
                .reshape(shape)
        mul = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0)
                          + self.eps)
        if self.scale is None:
            return ((xf - mean) * mul).to(x.dtype)
        mul = mul * _channel(self.scale, x.dim())
        return (xf - mean) * mul + _channel(self.bias, x.dim())


class _FrozenBatchNorm2d(nn.Module):
    """Batch norm by stored statistics (buffers `mean`, `var`, flax's
    `batch_stats`) and, with `affine`, a learned `scale` and `bias`."""

    def __init__(self, features, affine=True, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))
        if affine:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.scale = self.bias = None

    def forward(self, x):
        n = x.dim()
        y = (x - _channel(self.mean, n)) \
            * torch.rsqrt(_channel(self.var, n) + self.eps)
        if self.scale is not None:
            y = y * _channel(self.scale, n) + _channel(self.bias, n)
        return y


def make_norm(norm_type, features):
    """Norm factory; None for 'none'."""
    if norm_type in (None, 'none', ''):
        return None
    if norm_type in ('batch', 'sync_batch'):
        return _FrozenBatchNorm2d(features)
    if norm_type == 'instance':
        return _FlaxNorm(features, groups=0, affine=False)
    if norm_type == 'layer':
        return _FlaxNorm(features)
    if norm_type == 'layer_2d':
        return _FlaxNorm(features, axes=(-3, -2, -1))
    if norm_type == 'group':
        return _FlaxNorm(features, groups=min(32, features))
    raise ValueError(f'unknown activation norm {norm_type}')


# ---------------------------------------------------------------------------
# convs, linears and weight norms (`layers/weight_norm.py`)
# ---------------------------------------------------------------------------

class _Conv(nn.Module):
    """flax's `nn.Conv` (explicit symmetric padding) at rank 1, 2 or 3,
    or with `transposed` its `nn.ConvTranspose(strides=2,
    padding='VALID')` (torch's `conv_transpose2d(stride=2)`; the weight
    is [I, O, k, k], flax's kernel flipped); with `spectral`, flax's
    `SpectralNorm` around it (buffers `weight_u` [1, O] and
    `weight_sigma`). Computes in `dtype`. `init` is 'xavier' (the JAX
    package's `xavier_gain`) or 'lecun' (flax's default)."""

    def __init__(self, in_channels, out_channels, kernel_size, rank=2,
                 stride=1, bias=True, spectral=False, transposed=False,
                 dtype=torch.float32, init='xavier'):
        super().__init__()
        k = (kernel_size,) * rank
        io = (in_channels, out_channels) if transposed \
            else (out_channels, in_channels)
        self.weight = nn.Parameter(torch.empty(io + k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.rank, self.stride, self.pad = rank, stride, (kernel_size - 1) // 2
        self.spectral, self.transposed = spectral, transposed
        self.compute_dtype, self.init = dtype, init
        if spectral:
            self.register_buffer('weight_u', torch.empty(1, out_channels))
            self.register_buffer('weight_sigma', torch.ones(()))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.init == 'xavier':
                xavier_gain_(self.weight, generator=generator)
            else:
                # lecun_normal: truncated at 2 std, std corrected for it
                std = 1.0 / math.sqrt(self.weight[0].numel()) \
                    / .87962566103423978
                nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()
            if self.spectral:
                self.weight_u.normal_(generator=generator)
                self.weight_sigma.fill_(1.0)

    def forward(self, x, update_stats=False):
        w = self.weight
        if self.spectral:
            wm = (w.transpose(0, 1) if self.transposed else w)
            w = spectral_normalize(self, w, wm.reshape(wm.shape[0], -1),
                                   update_stats)
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.transposed:
            return F.conv_transpose2d(x.to(dt), w.to(dt), b, stride=2)
        conv = (F.conv1d, F.conv2d, F.conv3d)[self.rank - 1]
        return conv(x.to(dt), w.to(dt), b, stride=self.stride,
                    padding=self.pad)


class _Dense(nn.Linear):
    """flax's `nn.Dense` (weight [O, I], the JAX package's `xavier_gain`
    init, zero bias), computing in `dtype`."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32, bias_init=0.0):
        self.compute_dtype, self.bias_init = dtype, bias_init
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self, generator=None):
        xavier_gain_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.constant_(self.bias, self.bias_init)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


def weight_norm_conv(x, v, g, bias, stride=1, dtype=torch.float32):
    """Classic weight normalization (`weight_norm.py:246`
    get_weight_norm_layer 'weight'): w = v * g * rsqrt(sum v^2 + 1e-12)
    per output channel, v [O, I, *k] of rank 1-3, g [O] (initialized to
    ||v||, so the conv equals the plain conv at init); symmetric padding
    (k - 1) // 2, computed in `dtype`."""
    rank = v.dim() - 2
    dims = tuple(range(1, v.dim()))
    w = v * _channel(g * torch.rsqrt((v * v).sum(dims) + 1e-12), v.dim(), 0)
    conv = (F.conv1d, F.conv2d, F.conv3d)[rank - 1]
    y = conv(x.to(dtype), w.to(dtype), stride=stride,
             padding=(v.shape[-1] - 1) // 2)
    if bias is not None:
        y = y + _channel(bias.to(dtype), y.dim())
    return y


# ---------------------------------------------------------------------------
# order-string blocks (`layers/conv.py:16-140`, `residual.py`)
# ---------------------------------------------------------------------------

class _ConvBlock(nn.Module):
    """An order-string conv block: C (conv), N (norm), A (activation) in
    the order given, at spatial rank `rank`. The conv is weight-normed by
    `weight_norm_type` ('none' | 'spectral' | 'weight'), blurred first
    when `blur` and `stride` == 2; a norm before the first C normalises
    `in_channels`, after it `out_channels`; `activation` is the 'A'
    callable. Norms are named `norm`, `norm_1`, ... in order."""

    def __init__(self, in_channels, out_channels, rank=2, kernel_size=3,
                 stride=1, use_bias=True, weight_norm_type='none',
                 activation_norm_type='none', activation=None, order='CNA',
                 blur=False, dtype=torch.float32):
        super().__init__()
        self.order, self.stride, self.dtype = order.upper(), stride, dtype
        self.act, self.wn = activation, weight_norm_type
        if 'C' in self.order:
            if weight_norm_type == 'weight':
                k = (kernel_size,) * rank
                self.wn_v = nn.Parameter(torch.empty(
                    (out_channels, in_channels) + k))
                self.wn_g = nn.Parameter(torch.empty(out_channels))
                self.wn_bias = nn.Parameter(torch.zeros(out_channels)) \
                    if use_bias else None
                with torch.no_grad():
                    xavier_gain_(self.wn_v)
                    self.wn_g.copy_(self.wn_v.flatten(1).norm(dim=1))
            elif weight_norm_type in ('none', '', None, 'spectral'):
                self.conv = _Conv(in_channels, out_channels, kernel_size,
                                  rank, stride, use_bias,
                                  spectral=weight_norm_type == 'spectral',
                                  dtype=dtype)
            else:
                raise ValueError(f'unknown weight norm {weight_norm_type}')
            if blur and stride == 2:
                self.blur = Blur()
        self.norms = []
        for i, op in enumerate(self.order):
            if op not in 'CNA':
                raise ValueError(f'bad order char {op}')
            if op == 'N':
                norm = make_norm(activation_norm_type,
                                 out_channels if 'C' in self.order[:i]
                                 else in_channels)
                name = 'norm' if not self.norms else f'norm_{len(self.norms)}'
                if norm is not None:
                    self.add_module(name, norm)
                self.norms.append(name if norm is not None else None)

    def conv_step(self, h, update_stats):
        if hasattr(self, 'blur'):
            h = self.blur(h)
        if self.wn == 'weight':
            return weight_norm_conv(h, self.wn_v, self.wn_g, self.wn_bias,
                                    self.stride, self.dtype)
        return self.conv(h, update_stats)

    def forward(self, x, update_stats=False):
        norms = iter(self.norms)
        for op in self.order:
            if op == 'C':
                x = self.conv_step(x, update_stats)
            elif op == 'N':
                name = next(norms)
                if name is not None:
                    x = getattr(self, name)(x)
            elif self.act is not None:
                x = self.act(x)
        return x


class Conv2dBlock(_ConvBlock):
    """Order-string composable conv block (`layers/conv.py:16-140`):
    order a permutation of C, N, A ('CNA', 'NAC', 'ANC', 'CAN', ...);
    weight norm 'none' | 'spectral' | 'weight'; `blur` puts a FIR blur
    before a stride-2 conv; the activation is `bias_act` without gain
    unless its name starts with `fused_`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 use_bias=True, weight_norm_type='none',
                 activation_norm_type='none', nonlinearity='leakyrelu',
                 order='CNA', blur=False, dtype=torch.float32):
        super().__init__(in_channels, out_channels, 2, kernel_size, stride,
                         use_bias, weight_norm_type, activation_norm_type,
                         _block_activation(nonlinearity), order, blur, dtype)


class LinearBlock(nn.Module):
    """Order-string linear block (`layers/conv.py` LinearBlock): 'C' the
    linear `fc`, 'A' the activation (as `Conv2dBlock`'s); 'N' does
    nothing, as in JAX."""

    def __init__(self, in_features, out_features, use_bias=True,
                 nonlinearity='none', order='CNA', dtype=torch.float32):
        super().__init__()
        self.fc = _Dense(in_features, out_features, use_bias, dtype)
        self.order, self.act = order.upper(), _block_activation(nonlinearity)

    def forward(self, x):
        for op in self.order:
            if op == 'C':
                x = self.fc(x)
            elif op == 'A' and self.act is not None:
                x = self.act(x)
        return x


class Res2dBlock(nn.Module):
    """Residual conv block with learned shortcut (`layers/residual.py`
    Res2dBlock): two `Conv2dBlock`s over the order's halves, plus a 1x1
    bias-free `conv_block_s` when the width changes."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 weight_norm_type='none', activation_norm_type='none',
                 nonlinearity='leakyrelu', order='CNACNA',
                 dtype=torch.float32):
        super().__init__()
        half = len(order) // 2
        block = functools.partial(
            Conv2dBlock, kernel_size=kernel_size,
            weight_norm_type=weight_norm_type,
            activation_norm_type=activation_norm_type,
            nonlinearity=nonlinearity, dtype=dtype)
        self.conv_block_0 = block(in_channels, out_channels,
                                  order=order[:half])
        self.conv_block_1 = block(out_channels, out_channels,
                                  order=order[half:])
        self.conv_block_s = Conv2dBlock(
            in_channels, out_channels, kernel_size=1, use_bias=False,
            weight_norm_type=weight_norm_type, nonlinearity='none',
            order='C', dtype=dtype) if in_channels != out_channels else None

    def forward(self, x, update_stats=False):
        h = self.conv_block_0(x, update_stats)
        h = self.conv_block_1(h, update_stats)
        if self.conv_block_s is not None:
            x = self.conv_block_s(x, update_stats)
        return h + x


class ApplyNoise(nn.Module):
    """Learned-scale additive noise (`layers/misc.py` ApplyNoise,
    StyleGAN-style): x + scale * noise, noise [N, 1, *S] given or drawn
    from `generator`."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(()))

    def forward(self, x, noise=None, generator=None):
        if noise is None:
            noise = draw_noise(x, generator)
        return _promote(x, self.scale) + self.scale * noise.to(x.dtype)


def draw_noise(x, generator):
    """Standard normal noise [N, 1, *S] for an (N, C, *S) tensor, from an
    explicit generator (JAX draws it from a key; None is refused rather
    than taken from the global RNG)."""
    if generator is None:
        raise ValueError('noise needs a tensor or a torch.Generator')
    return torch.randn((x.shape[0], 1) + tuple(x.shape[2:]),
                       generator=generator, device=x.device, dtype=x.dtype)


def equalized_lr_init(lr_mul=1.0):
    """Equalized learning rate (`layers/weight_norm.py:76-185` ScaledLR):
    an in-place init that stores the weight at N(0, 1/lr_mul); it is
    rescaled at use by he_std * lr_mul."""
    def init(weight, generator=None):
        with torch.no_grad():
            return weight.normal_(0.0, 1.0 / lr_mul, generator=generator)
    return init


class EqualizedDense(nn.Module):
    """Dense with runtime He rescale (equalized LR): weight [O, I]."""

    def __init__(self, in_features, out_features, lr_mul=1.0, use_bias=True):
        super().__init__()
        self.lr_mul = lr_mul
        self.weight = nn.Parameter(equalized_lr_init(lr_mul)(
            torch.empty(out_features, in_features)))
        self.bias = nn.Parameter(torch.zeros(out_features)) \
            if use_bias else None

    def forward(self, x):
        he = math.sqrt(2.0 / x.shape[-1]) * self.lr_mul
        y = F.linear(x, self.weight * he)
        if self.bias is not None:
            y = y + self.bias * self.lr_mul
        return y


class NonLocal2dBlock(nn.Module):
    """Self-attention over spatial positions (`layers/non_local.py`,
    embedded-gaussian non-local block): 1x1 convs `theta`, `phi`, `g` to
    C // reduction channels, softmax(theta phi^T / sqrt(inner)) g, then
    x + gamma * `out`(y)."""

    def __init__(self, in_channels, reduction=8):
        super().__init__()
        inner = max(1, in_channels // reduction)
        conv = functools.partial(_Conv, kernel_size=1, init='lecun')
        self.theta = conv(in_channels, inner)
        self.phi = conv(in_channels, inner)
        self.g = conv(in_channels, inner)
        self.out = conv(inner, in_channels)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        b, _, h, w = x.shape

        def rows(conv):
            return conv(x).flatten(2).transpose(1, 2)       # [b, hw, inner]

        theta, phi, g = rows(self.theta), rows(self.phi), rows(self.g)
        attn = torch.softmax(theta @ phi.transpose(1, 2)
                             / math.sqrt(theta.shape[-1]), dim=-1)
        y = (attn @ g).transpose(1, 2).reshape(b, -1, h, w)
        return x + self.gamma * self.out(y)


class Res2dBlockDown(nn.Module):
    """Residual block with stride-2 (blur-)downsample
    (`layers/residual.py` DownRes2dBlock): `c0` and the strided `c1`
    (order 'AC'), the shortcut `cs` a bias-free strided 1x1."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 weight_norm_type='none', nonlinearity='leakyrelu',
                 blur=True, dtype=torch.float32):
        super().__init__()
        block = functools.partial(Conv2dBlock,
                                  weight_norm_type=weight_norm_type,
                                  dtype=dtype)
        self.c0 = block(in_channels, out_channels, kernel_size,
                        nonlinearity=nonlinearity, order='AC')
        self.c1 = block(out_channels, out_channels, kernel_size, stride=2,
                        nonlinearity=nonlinearity, order='AC', blur=blur)
        self.cs = block(in_channels, out_channels, 1, stride=2,
                        use_bias=False, nonlinearity='none', order='C',
                        blur=blur)

    def forward(self, x, update_stats=False):
        h = self.c1(self.c0(x, update_stats), update_stats)
        return h + self.cs(x, update_stats)


# ---------------------------------------------------------------------------
# partial convolution (`layers/conv.py:1222-1305,1307-1366`)
# ---------------------------------------------------------------------------

class _PartialConv(nn.Module):
    """Partial convolution (Liu et al. ECCV 2018) at rank 2 or 3: the
    conv (`conv`) of x * mask renormalised by slide / (window sum +
    1e-6) where the window saw a valid input, the bias taken out and put
    back, the output zeroed elsewhere. The mask is [N, 1, *S] (or
    [N, C, *S] with `multi_channel`, whose window sums over channels);
    without one the input is convolved as it is and the window counts
    the padding out. Returns (out, update mask) with `return_mask`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 use_bias=True, multi_channel=False, return_mask=True,
                 rank=2):
        super().__init__()
        self.conv = _Conv(in_channels, out_channels, kernel_size, rank,
                          stride, use_bias)
        self.k, self.stride, self.rank = kernel_size, stride, rank
        self.multi_channel, self.return_mask = multi_channel, return_mask

    def forward(self, x, mask_in=None):
        k, cin = self.k, x.shape[1]
        if mask_in is None:
            mask = x.new_ones((x.shape[0], cin if self.multi_channel else 1)
                              + tuple(x.shape[2:]))
        else:
            mask = mask_in
        conv = (None, None, F.conv2d, F.conv3d)[self.rank]
        m = mask.shape[1]
        win = conv(mask, mask.new_ones((m, 1) + (k,) * self.rank),
                   stride=self.stride, padding=(k - 1) // 2, groups=m)
        if self.multi_channel:
            win = win.sum(1, keepdim=True)
            slide = float(cin * k ** self.rank)
        else:
            slide = float(k ** self.rank)
        update_mask = torch.clamp(win, 0.0, 1.0)
        mask_ratio = slide / (win + 1e-6) * update_mask
        raw = self.conv(x * mask if mask_in is not None else x)
        if self.conv.bias is not None:
            b = _channel(self.conv.bias, raw.dim())
            out = ((raw - b) * mask_ratio + b) * update_mask
        else:
            out = raw * mask_ratio
        return (out, update_mask) if self.return_mask else out


class PartialConv2d(_PartialConv):
    """Partial 2D convolution (`layers/conv.py:1222-1305`), NCHW."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 use_bias=True, multi_channel=False, return_mask=True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         use_bias, multi_channel, return_mask, rank=2)


# ---------------------------------------------------------------------------
# hyper convolution (`layers/conv.py:694-888`)
# ---------------------------------------------------------------------------

def hyper_conv2d(x, conv_weight, conv_bias=None, stride=1, padding=1,
                 dilation=1):
    """Per-sample-weight convolution (`layers/conv.py:806-888`
    HyperConv2d), one grouped conv over the batch: x [N, I, H, W],
    conv_weight [N, O, I, kh, kw] per-sample OIHW kernels, conv_bias
    [N, O] or None -> [N, O, H', W']; x as it is when conv_weight is
    None."""
    if conv_weight is None:
        return x
    n, o = conv_weight.shape[:2]
    y = F.conv2d(x.reshape(1, -1, *x.shape[2:]),
                 conv_weight.reshape(n * o, *conv_weight.shape[2:]),
                 stride=stride, padding=padding, dilation=dilation, groups=n)
    y = y.reshape(n, o, *y.shape[2:])
    if conv_bias is not None:
        y = y + conv_bias[:, :, None, None]
    return y


class HyperConv2dBlock(nn.Module):
    """Order-string block around `hyper_conv2d` (`layers/conv.py:694-804`):
    the conv weights arrive as call inputs `(weight, bias)` (or a weight
    alone); the block owns only its norm. A norm before the C normalises
    `in_channels`, after it `out_channels` (with no weight the conv
    passes x through, so a norm with parameters then needs equal widths,
    as JAX's would)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 activation_norm_type='none', nonlinearity='leakyrelu',
                 order='CNA'):
        super().__init__()
        self.order, self.stride = order.upper(), stride
        self.pad, self.act = (kernel_size - 1) // 2, \
            _block_activation(nonlinearity)
        if 'N' in self.order:
            i = self.order.index('N')
            norm = make_norm(activation_norm_type, out_channels
                             if 'C' in self.order[:i] else in_channels)
            if norm is not None:
                self.norm = norm

    def forward(self, x, conv_weights=(None, None)):
        w, b = (conv_weights if isinstance(conv_weights, (tuple, list))
                else (conv_weights, None))
        for op in self.order:
            if op == 'C':
                x = hyper_conv2d(x, w, b, stride=self.stride,
                                 padding=self.pad)
            elif op == 'N' and hasattr(self, 'norm'):
                x = self.norm(x)
            elif op == 'A' and self.act is not None:
                x = self.act(x)
        return x


# ---------------------------------------------------------------------------
# ViT2dBlock (`layers/vit.py:14-170`) and ConstantInput (`misc.py:51-76`)
# ---------------------------------------------------------------------------

class ViT2dBlock(nn.Module):
    """StyleGAN-flavoured order-string block with blur and noise slots,
    fractional stride, a learnable output scale and a post-conv
    max-clamp (`layers/vit.py:14-170`). 'B' (blur) and 'G' (noise) are
    spliced around C: stride 2 -> blur, then conv; stride 0.5 -> the
    transposed conv (stride 2, no padding: out 2 * in - 2 + k), then
    blur; `apply_noise` -> noise right after the conv. Weight norm
    'spectral' or none."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 use_bias=True, weight_norm_type='none',
                 activation_norm_type='none', nonlinearity='leakyrelu',
                 apply_noise=False, blur=False, order='CNA', clamp=None,
                 output_scale=None, dtype=torch.float32):
        super().__init__()
        order = order.upper()
        if apply_noise:
            order = order.replace('C', 'CG')
        if blur and stride == 2:
            order = order.replace('C', 'BC')
        elif blur and stride == 0.5:
            order = order.replace('C', 'CB')
        self.order, self.clamp = order, clamp
        self.act = _block_activation(nonlinearity)
        self.conv = _Conv(in_channels, out_channels, kernel_size,
                          stride=1 if stride == 0.5 else int(stride),
                          bias=use_bias,
                          spectral=weight_norm_type == 'spectral',
                          transposed=stride == 0.5, dtype=dtype)
        self.output_scale = None if output_scale is None else \
            nn.Parameter(torch.tensor(float(output_scale)))
        if 'B' in order:
            self.blur = Blur()
        if 'G' in order:
            self.noise = ApplyNoise()
        for i, op in enumerate(order):
            if op not in 'CNABG':
                raise ValueError(f'bad order char {op}')
            if op == 'N':
                norm = make_norm(activation_norm_type, out_channels
                                 if 'C' in order[:i] else in_channels)
                if norm is not None:
                    self.norm = norm

    def forward(self, x, update_stats=False, noise=None, generator=None):
        for op in self.order:
            if op == 'C':
                x = self.conv(x, update_stats)
                if self.clamp is not None:
                    x = torch.clamp(x, max=self.clamp)
                if self.output_scale is not None:
                    x = _promote(x, self.output_scale) * self.output_scale
            elif op == 'B':
                x = self.blur(x)
            elif op == 'G':
                x = self.noise(x, noise, generator)
            elif op == 'N' and hasattr(self, 'norm'):
                x = self.norm(x)
            elif op == 'A' and self.act is not None:
                x = self.act(x)
        return x


class ConstantInput(nn.Module):
    """Learned constant input map `const` [1, C, size, size]
    (`layers/misc.py:51-76`; StyleGAN2 head), broadcast to the batch."""

    def __init__(self, features, size=4):
        super().__init__()
        self.const = nn.Parameter(torch.randn(1, features, size, size))

    def forward(self, batch_size):
        return self.const.expand(batch_size, -1, -1, -1)
