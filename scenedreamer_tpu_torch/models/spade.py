"""SPADE / GauGAN generator: the frozen pseudo-ground-truth oracle,
forward only.

Counterpart of `scenedreamer_tpu/models/spade.py` in its frozen mode
(`bn_mode='frozen'`; reference `imaginaire/generators/spade.py:228-508`
SPADEGenerator, `imaginaire/layers/activation_norm.py:20-263`
AdaptiveNorm / SpatiallyAdaptiveNorm, wired per
`configs/landscape1m.yaml`):

  label one-hot [B, H, W, 184] -> nearest-downsampled 16x16 head ->
  SPADE residual blocks (order NACNAC, batch norm with stored statistics
  + per-label conv MLP producing gamma/beta) interleaved with
  conditional-batch-norm conv blocks driven by the 2*style_dims style
  projection, nearest 2x upsampling ladder to 256/512/1024, multi-scale
  output taps summed before tanh(output_multiplier * .).

During SceneDreamer training this runs frozen in eval mode
(`trainers/gancraft.py:30-65`). Module and parameter names are the
reference's state-dict names with spectral norm folded
(`spade_generator.head_1.conv_block_0.layers.norm.mlps.0.0.layers.conv.weight`,
`...layers.norm.norm.running_mean`, `fc_0.layers.conv.weight`, ...), so
the JAX package's `convert_spade` maps a state dict of this module onto
its own variables. Without a checkpoint the seeded random oracle still
exercises the whole pseudo-GT path.

NCHW inside; the wrapper keeps the JAX package's NHWC at its boundary.
The style encoder and the trainable batch-norm modes belong to SPADE
training and are not ported.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _nearest(x, size):
    """Nearest resize of an NCHW tensor with `F.interpolate(mode=
    'nearest')` semantics, src index = floor(dst * in/out) (not cell
    centres), written as an explicit index map so that it equals the JAX
    package's `_nearest` on every size."""
    h, w = x.shape[-2:]
    iy = torch.floor(torch.arange(size[0], dtype=torch.float64)
                     * (h / size[0])).long().to(x.device)
    ix = torch.floor(torch.arange(size[1], dtype=torch.float64)
                     * (w / size[1])).long().to(x.device)
    return x[:, :, iy][:, :, :, ix]


def leaky_relu(x):
    return F.leaky_relu(x, 0.2)


class FrozenBatchNorm(nn.Module):
    """Batch norm with stored running statistics and affine weight/bias,
    all buffers (`sync_batch` with affine=True per
    `generators/spade.py:90-93`, frozen-eval semantics); identity
    statistics by default."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.register_buffer('weight', torch.ones(features))
        self.register_buffer('bias', torch.zeros(features))

    def forward(self, x):
        def c(v):
            return v[None, :, None, None]
        return (x - c(self.running_mean)) \
            * torch.rsqrt(c(self.running_var) + self.eps) \
            * c(self.weight) + c(self.bias)


class _Layers(nn.Module):
    """A reference `Conv2dBlock` / `LinearBlock` shell: its layers live
    under `.layers` by name (`layers.conv`, `layers.norm`)."""

    def __init__(self, **layers):
        super().__init__()
        self.layers = nn.ModuleDict(layers)


def _conv(cin, cout, k, bias=True):
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)


def xavier_gain_(weight, gain=0.02, generator=None):
    """xavier_normal(gain) in place: std = gain * sqrt(2 / (fan_in +
    fan_out)), fans counted over the kernel window."""
    window = weight[0, 0].numel() if weight.dim() > 2 else 1
    fan = (weight.shape[0] + weight.shape[1]) * window
    with torch.no_grad():
        weight.normal_(0.0, gain * math.sqrt(2.0 / fan), generator=generator)


class SpadeNorm(nn.Module):
    """SpatiallyAdaptiveNorm (`activation_norm.py:133-263`),
    separate_projection=True, one condition input."""

    def __init__(self, features, num_labels, num_filters=128, kernel_size=5):
        super().__init__()
        self.norm = FrozenBatchNorm(features)
        k = kernel_size
        self.mlps = nn.ModuleList([nn.ModuleList(
            [_Layers(conv=_conv(num_labels, num_filters, k))])])
        self.gammas = nn.ModuleList(
            [_Layers(conv=_conv(num_filters, features, k))])
        self.betas = nn.ModuleList(
            [_Layers(conv=_conv(num_filters, features, k))])

    def forward(self, x, seg):
        normed = self.norm(x)
        label = _nearest(seg, x.shape[-2:])
        hidden = F.relu(self.mlps[0][0].layers['conv'](label))
        gamma = self.gammas[0].layers['conv'](hidden)
        beta = self.betas[0].layers['conv'](hidden)
        return normed * (1.0 + gamma) + beta


class AdaptiveNorm(nn.Module):
    """Conditional batch norm from the style vector
    (`activation_norm.py:20-131`), separate projections."""

    def __init__(self, features, cond_dims):
        super().__init__()
        self.norm = FrozenBatchNorm(features)
        self.fc_gamma = _Layers(conv=nn.Linear(cond_dims, features))
        self.fc_beta = _Layers(conv=nn.Linear(cond_dims, features))

    def forward(self, x, z):
        gamma = self.fc_gamma.layers['conv'](z)[:, :, None, None]
        beta = self.fc_beta.layers['conv'](z)[:, :, None, None]
        return self.norm(x) * (1.0 + gamma) + beta


class SpadeRes2dBlock(nn.Module):
    """Res2dBlock order NACNAC with SPADE norms and learned shortcut
    (`generators/spade.py:272-282`, `layers/residual.py`)."""

    def __init__(self, cin, cout, num_labels, kernel_size=3,
                 spade_filters=128, spade_kernel=5):
        super().__init__()

        def block(ci, co, k, bias=True):
            return _Layers(conv=_conv(ci, co, k, bias),
                           norm=SpadeNorm(ci, num_labels, spade_filters,
                                          spade_kernel))
        self.conv_block_0 = block(cin, cout, kernel_size)
        self.conv_block_1 = block(cout, cout, kernel_size)
        self.learned_shortcut = cin != cout
        if self.learned_shortcut:
            self.conv_block_s = block(cin, cout, 1, bias=False)

    def forward(self, x, seg):
        b0, b1 = self.conv_block_0.layers, self.conv_block_1.layers
        h = b0['conv'](leaky_relu(b0['norm'](x, seg)))
        h = b1['conv'](leaky_relu(b1['norm'](h, seg)))
        if self.learned_shortcut:
            bs = self.conv_block_s.layers
            x = bs['conv'](bs['norm'](x, seg))
        return h + x


class CBNConvBlock(nn.Module):
    """Conv2dBlock order NAC with adaptive norm
    (`generators/spade.py:306-316`)."""

    def __init__(self, cin, cout, cond_dims, kernel_size=3):
        super().__init__()
        self.layers = nn.ModuleDict({
            'conv': _conv(cin, cout, kernel_size),
            'norm': AdaptiveNorm(cin, cond_dims)})

    def forward(self, x, z):
        return self.layers['conv'](leaky_relu(self.layers['norm'](x, z)))


class SPADEGenerator(nn.Module):
    """Core SPADE ladder (`generators/spade.py:228-508`); NCHW."""

    def __init__(self, num_labels=184, out_size=512, image_channels=3,
                 num_filters=128, kernel_size=3, style_dims=256,
                 output_multiplier=0.5, spade_filters=128, spade_kernel=5):
        super().__init__()
        if out_size not in (256, 512, 1024):
            raise ValueError(f'SPADE out_size {out_size} not in '
                             '(256, 512, 1024)')
        self.out_size = out_size
        self.base = {256: 16, 512: 32, 1024: 64}[out_size]
        self.output_multiplier = output_multiplier
        nf, k, zd = num_filters, kernel_size, 2 * style_dims

        def res(cin, cout):
            return SpadeRes2dBlock(cin, cout, num_labels, k, spade_filters,
                                   spade_kernel)

        def img(cin):
            return _Layers(conv=_conv(cin, image_channels, 5))
        self.fc_0 = _Layers(conv=nn.Linear(style_dims, zd))
        self.fc_1 = _Layers(conv=nn.Linear(zd, zd))
        self.head_0 = _Layers(conv=_conv(num_labels, 8 * nf, k))
        self.cbn_head_0 = CBNConvBlock(8 * nf, 16 * nf, zd, k)
        self.head_1 = res(16 * nf, 16 * nf)
        self.head_2 = res(16 * nf, 16 * nf)
        self.up_0a = res(16 * nf, 8 * nf)
        self.cbn_up_0a = CBNConvBlock(8 * nf, 8 * nf, zd, k)
        self.up_0b = res(8 * nf, 8 * nf)
        self.up_1a = res(8 * nf, 4 * nf)
        self.cbn_up_1a = CBNConvBlock(4 * nf, 4 * nf, zd, k)
        self.up_1b = res(4 * nf, 4 * nf)
        self.up_2a = res(4 * nf, 4 * nf)
        self.cbn_up_2a = CBNConvBlock(4 * nf, 4 * nf, zd, k)
        self.up_2b = res(4 * nf, 2 * nf)
        self.conv_img256 = img(2 * nf)
        if out_size >= 512:
            self.up_3a = res(2 * nf, nf)
            self.up_3b = res(nf, nf)
            self.conv_img512 = img(nf)
        if out_size == 1024:
            self.up_4a = res(nf, nf // 2)
            self.up_4b = res(nf // 2, nf // 2)
            self.conv_img1024 = img(nf // 2)

    @staticmethod
    def _up(x, factor=2):
        return _nearest(x, (factor * x.shape[-2], factor * x.shape[-1]))

    def forward(self, seg, z):
        """seg: [B, num_labels, H, W] one-hot; z: [B, style_dims]."""
        z = F.relu(self.fc_0.layers['conv'](z))
        z = F.relu(self.fc_1.layers['conv'](z))
        sy = math.floor(seg.shape[-2] / self.base)
        sx = math.floor(seg.shape[-1] / self.base)
        x = leaky_relu(self.head_0.layers['conv'](_nearest(seg, (sy, sx))))
        x = self.cbn_head_0(x, z)
        x = self.head_1(x, seg)
        x = self._up(self.head_2(x, seg))
        x = self.up_0a(x, seg)
        x = self.cbn_up_0a(x, z)
        x = self._up(self.up_0b(x, seg))
        x = self.up_1a(x, seg)
        x = self.cbn_up_1a(x, z)
        x = self._up(self.up_1b(x, seg))
        x = self.up_2a(x, seg)
        x = self.cbn_up_2a(x, z)
        x = self._up(self.up_2b(x, seg))
        x256 = self.conv_img256.layers['conv'](leaky_relu(x))
        if self.out_size == 256:
            return torch.tanh(self.output_multiplier * x256)
        x = self.up_3a(x, seg)
        x = self._up(self.up_3b(x, seg))
        x512 = self.conv_img512.layers['conv'](leaky_relu(x))
        if self.out_size == 512:
            x256 = _nearest(x256, x512.shape[-2:])
            return torch.tanh(self.output_multiplier * (x256 + x512))
        x256 = self._up(x256, 4)
        x512 = self._up(x512)
        x = self.up_4a(x, seg)
        x = self._up(self.up_4b(x, seg))
        x1024 = self.conv_img1024.layers['conv'](leaky_relu(x))
        return torch.tanh(self.output_multiplier * (x256 + x512 + x1024))


class SPADEWrapper(nn.Module):
    """Top-level generator (`generators/spade.py:30-162`) with a random
    or given style. `seed` makes the xavier(0.02) init reproducible."""

    def __init__(self, num_labels=184, out_size=512, style_dims=256,
                 num_filters=128, output_multiplier=0.5, spade_filters=128,
                 spade_kernel=5, seed=0):
        super().__init__()
        self.style_dims = style_dims
        self.spade_generator = SPADEGenerator(
            num_labels=num_labels, out_size=out_size, style_dims=style_dims,
            num_filters=num_filters, output_multiplier=output_multiplier,
            spade_filters=spade_filters, spade_kernel=spade_kernel)
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                xavier_gain_(m.weight, generator=gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, data, random_style=True, generator=None):
        """data: {'label': [B, H, W, C] one-hot, optional 'z': [B,
        style_dims]}. Without 'z' the style is drawn from `generator` (a
        `torch.Generator` on the label's device). Returns
        {'fake_images': [B, H', W', 3] in [-1, 1]}."""
        label = data['label']
        if 'z' in data:
            z = data['z']
        elif random_style or 'images' not in data:
            z = torch.randn((label.shape[0], self.style_dims),
                            generator=generator, device=label.device)
        else:
            raise NotImplementedError(
                'the SPADE style encoder is not ported; pass z or '
                'random_style=True')
        dtype = self.spade_generator.head_0.layers['conv'].weight.dtype
        fake = self.spade_generator(
            label.permute(0, 3, 1, 2).to(dtype), z.to(dtype))
        return {'fake_images': fake.permute(0, 2, 3, 1), 'mu': None,
                'logvar': None}
