"""SPADE / GauGAN generator: the pseudo-ground-truth oracle, frozen for
SceneDreamer training or trainable for its own training.

Counterpart of `scenedreamer_tpu/models/spade.py` (reference
`imaginaire/generators/spade.py:228-571` SPADEGenerator + StyleEncoder,
`imaginaire/layers/activation_norm.py:20-263` AdaptiveNorm /
SpatiallyAdaptiveNorm, wired per `configs/landscape1m.yaml`):

  label one-hot [B, H, W, 184] -> nearest-downsampled 16x16 head ->
  SPADE residual blocks (order NACNAC, batch norm + per-label conv MLP
  producing gamma/beta) interleaved with conditional-batch-norm conv
  blocks driven by the 2*style_dims style projection, nearest 2x
  upsampling ladder to 256/512/1024, multi-scale output taps summed
  before tanh(output_multiplier * .).

The batch norm comes in JAX's `bn_mode`s:
  * 'frozen' (`FrozenBatchNorm`): stored statistics and affine weight /
    bias, all buffers: the oracle during SceneDreamer training
    (`trainers/gancraft.py:30-65`);
  * 'train' / 'eval' (`BatchNorm`): flax's `nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)` with a trainable weight and bias; in the module's
    training mode it normalises by the batch statistics and hands the new
    running statistics back through `SPADEWrapper`'s output instead of
    writing its buffers (the caller adopts them, `adopt_batch_stats`),
    in eval mode by the running statistics. 'train' and 'eval' build the
    same module and differ only in its starting mode. With a process
    group (`set_sync_group`) the batch statistics are the mean over the
    group's ranks, forward and backward: the reference's sync batch norm.
`SPADEStyleEncoder` is the VAE style encoder (`generators/spade.py:511-571`),
built when `SPADEWrapper(style_encoder=True)`.

Module and parameter names are the reference's state-dict names with
spectral norm folded
(`spade_generator.head_1.conv_block_0.layers.norm.mlps.0.0.layers.conv.weight`,
`...layers.norm.norm.running_mean`, `fc_0.layers.conv.weight`,
`style_encoder.layer1.layers.conv.weight`, ...), so the JAX package's
`convert_spade` maps a state dict of this module onto its own variables.
Without a checkpoint the seeded random oracle still exercises the whole
pseudo-GT path.

NCHW inside; the wrapper keeps the JAX package's NHWC at its boundary.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedreamer_tpu_torch.ops.resize import resize_bilinear
from scenedreamer_tpu_torch.parallel.mesh import all_mean

BN_MODES = ('frozen', 'train', 'eval')


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


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over NCHW: weight
    (flax `scale`) and bias are parameters, the running mean and variance
    buffers. In training mode the statistics are the batch's, in float32:
    mean = E[x], var = max(E[x^2] - E[x]^2, 0) (flax's fast variance),
    both means taken over `group`'s ranks when it is set; the new running
    statistics, 0.9 * old + 0.1 * batch with the biased variance (torch's
    `BatchNorm2d` keeps the unbiased one), go to `new_stats` and the
    buffers stay as they are. In eval mode the running statistics
    normalise."""

    def __init__(self, features, eps=1e-5, momentum=0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.group = None
        self.new_stats = None

    def forward(self, x):
        def c(v):
            return v[None, :, None, None]
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            stats = torch.stack([xf.mean(dim=(0, 2, 3)),
                                 (xf * xf).mean(dim=(0, 2, 3))])
            if self.group is not None:
                stats = all_mean(stats, self.group)
            mean = stats[0]
            var = torch.clamp(stats[1] - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.new_stats = (m * self.running_mean + (1.0 - m) * mean,
                                  m * self.running_var + (1.0 - m) * var)
        return (x - c(mean)) * c(torch.rsqrt(var + self.eps) * self.weight) \
            + c(self.bias)


def make_bn(features, bn_mode):
    """The batch norm of `bn_mode` (JAX `make_bn`): 'frozen' ->
    `FrozenBatchNorm`, 'train' / 'eval' -> `BatchNorm`."""
    if bn_mode not in BN_MODES:
        raise ValueError(f'bn_mode {bn_mode!r} not in {BN_MODES}')
    return FrozenBatchNorm(features) if bn_mode == 'frozen' \
        else BatchNorm(features)


def set_sync_group(model, group):
    """Mean every `BatchNorm`'s batch statistics of `model` over the ranks
    of `group` (None: this process's batch alone)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def adopt_batch_stats(model, stats):
    """Copy the running statistics `stats` ({buffer name: tensor}, as a
    training-mode `SPADEWrapper` returns them) into `model`'s buffers."""
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, value in stats.items():
            buffers[name].copy_(value)


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

    def __init__(self, features, num_labels, num_filters=128, kernel_size=5,
                 bn_mode='frozen'):
        super().__init__()
        self.norm = make_bn(features, bn_mode)
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

    def __init__(self, features, cond_dims, bn_mode='frozen'):
        super().__init__()
        self.norm = make_bn(features, bn_mode)
        self.fc_gamma = _Layers(conv=nn.Linear(cond_dims, features))
        self.fc_beta = _Layers(conv=nn.Linear(cond_dims, features))

    def forward(self, x, z):
        gamma = self.fc_gamma.layers['conv'](z)[:, :, None, None]
        beta = self.fc_beta.layers['conv'](z)[:, :, None, None]
        return self.norm(x) * (1.0 + gamma) + beta


class DualAdaptiveNorm(nn.Module):
    """Normalize, then modulate by a list of conditions
    (`activation_norm.py:266-331` DualAdaptiveNorm; no shipped reference
    config builds it): the norm of `models/blocks.make_norm(norm_type)`
    (`norm`), then per condition i, unless it is None, `gamma_{i}` /
    `beta_{i}`: 1x1 convs of a spatial condition [N, C_i, h, w], resized
    to x's size as `jax.image.resize(..., 'bilinear')` does when the
    sizes differ, or linears of a vector condition [N, C_i]; out * (1 +
    gamma) + beta, or out + beta with `bias_only`."""

    def __init__(self, num_features, cond_dims, is_spatial=(False,),
                 bias_only=False, norm_type='instance'):
        super().__init__()
        from scenedreamer_tpu_torch.models.blocks import make_norm
        assert len(cond_dims) == len(is_spatial)
        self.is_spatial, self.bias_only = tuple(is_spatial), bias_only
        self.norm = make_norm(norm_type, num_features)
        for i, (c, spatial) in enumerate(zip(cond_dims, is_spatial)):
            for name in (f'gamma_{i}', f'beta_{i}'):
                layer = nn.Conv2d(c, num_features, 1) if spatial \
                    else nn.Linear(c, num_features)
                xavier_gain_(layer.weight)
                nn.init.zeros_(layer.bias)
                self.add_module(name, layer)

    def forward(self, x, *cond_inputs):
        assert len(cond_inputs) == len(self.is_spatial)
        out = x if self.norm is None else self.norm(x)
        for i, (cond, spatial) in enumerate(zip(cond_inputs,
                                                self.is_spatial)):
            if cond is None:
                continue
            gamma = getattr(self, f'gamma_{i}')(cond)
            beta = getattr(self, f'beta_{i}')(cond)
            if spatial:
                if gamma.shape[2:] != x.shape[2:]:
                    gamma, beta = (resize_bilinear(
                        t.permute(0, 2, 3, 1), x.shape[2:]).permute(
                            0, 3, 1, 2) for t in (gamma, beta))
            else:
                gamma, beta = gamma[:, :, None, None], beta[:, :, None, None]
            out = out + beta if self.bias_only \
                else out * (1.0 + gamma) + beta
        return out


class SpadeRes2dBlock(nn.Module):
    """Res2dBlock order NACNAC with SPADE norms and learned shortcut
    (`generators/spade.py:272-282`, `layers/residual.py`)."""

    def __init__(self, cin, cout, num_labels, kernel_size=3,
                 spade_filters=128, spade_kernel=5, bn_mode='frozen'):
        super().__init__()

        def block(ci, co, k, bias=True):
            return _Layers(conv=_conv(ci, co, k, bias),
                           norm=SpadeNorm(ci, num_labels, spade_filters,
                                          spade_kernel, bn_mode))
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

    def __init__(self, cin, cout, cond_dims, kernel_size=3,
                 bn_mode='frozen'):
        super().__init__()
        self.layers = nn.ModuleDict({
            'conv': _conv(cin, cout, kernel_size),
            'norm': AdaptiveNorm(cin, cond_dims, bn_mode)})

    def forward(self, x, z):
        return self.layers['conv'](leaky_relu(self.layers['norm'](x, z)))


class SPADEGenerator(nn.Module):
    """Core SPADE ladder (`generators/spade.py:228-508`); NCHW."""

    def __init__(self, num_labels=184, out_size=512, image_channels=3,
                 num_filters=128, kernel_size=3, style_dims=256,
                 output_multiplier=0.5, spade_filters=128, spade_kernel=5,
                 bn_mode='frozen'):
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
                                   spade_kernel, bn_mode)

        def cbn(cin, cout):
            return CBNConvBlock(cin, cout, zd, k, bn_mode)

        def img(cin):
            return _Layers(conv=_conv(cin, image_channels, 5))
        self.fc_0 = _Layers(conv=nn.Linear(style_dims, zd))
        self.fc_1 = _Layers(conv=nn.Linear(zd, zd))
        self.head_0 = _Layers(conv=_conv(num_labels, 8 * nf, k))
        self.cbn_head_0 = cbn(8 * nf, 16 * nf)
        self.head_1 = res(16 * nf, 16 * nf)
        self.head_2 = res(16 * nf, 16 * nf)
        self.up_0a = res(16 * nf, 8 * nf)
        self.cbn_up_0a = cbn(8 * nf, 8 * nf)
        self.up_0b = res(8 * nf, 8 * nf)
        self.up_1a = res(8 * nf, 4 * nf)
        self.cbn_up_1a = cbn(4 * nf, 4 * nf)
        self.up_1b = res(4 * nf, 4 * nf)
        self.up_2a = res(4 * nf, 4 * nf)
        self.cbn_up_2a = cbn(4 * nf, 4 * nf)
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


class SPADEStyleEncoder(nn.Module):
    """VAE style encoder (`generators/spade.py:511-571`): the image,
    resized to 256x256 as `jax.image.resize(..., 'bilinear')` does
    (antialiased when shrinking), through six stride-2 3x3 convs with
    leaky ReLU to a [8 nf, 4, 4] map, flattened NCHW (the reference's
    order; the JAX package flattens NHWC), then `fc_mu` and `fc_var`."""

    def __init__(self, style_dims=256, num_filters=64):
        super().__init__()
        nf = num_filters
        chans = [3, nf, 2 * nf, 4 * nf, 8 * nf, 8 * nf, 8 * nf]
        for i in range(6):
            setattr(self, f'layer{i + 1}', _Layers(conv=nn.Conv2d(
                chans[i], chans[i + 1], 3, stride=2, padding=1)))
        self.fc_mu = _Layers(conv=nn.Linear(8 * nf * 16, style_dims))
        self.fc_var = _Layers(conv=nn.Linear(8 * nf * 16, style_dims))

    def forward(self, images, eps=None, generator=None):
        """images [B, H, W, 3]; eps [B, style_dims] (else drawn from
        `generator`). Returns (mu, logvar, mu + eps * exp(logvar / 2))."""
        if images.shape[1] != 256 or images.shape[2] != 256:
            images = resize_bilinear(images, (256, 256))
        x = images.permute(0, 3, 1, 2)
        for i in range(6):
            x = leaky_relu(getattr(self, f'layer{i + 1}').layers['conv'](x))
        x = x.reshape(x.shape[0], -1)
        mu = self.fc_mu.layers['conv'](x)
        logvar = self.fc_var.layers['conv'](x)
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator,
                              device=std.device, dtype=std.dtype)
        return mu, logvar, mu + eps.to(std.dtype) * std


class SPADEWrapper(nn.Module):
    """Top-level generator (`generators/spade.py:30-162`) with a random,
    given or (with `style_encoder`) encoded style, batch norms of
    `bn_mode`. `seed` makes the xavier(0.02) init reproducible."""

    def __init__(self, num_labels=184, out_size=512, style_dims=256,
                 num_filters=128, output_multiplier=0.5, spade_filters=128,
                 spade_kernel=5, style_enc_filters=64, bn_mode='frozen',
                 style_encoder=False, seed=0):
        super().__init__()
        self.style_dims = style_dims
        self.spade_generator = SPADEGenerator(
            num_labels=num_labels, out_size=out_size, style_dims=style_dims,
            num_filters=num_filters, output_multiplier=output_multiplier,
            spade_filters=spade_filters, spade_kernel=spade_kernel,
            bn_mode=bn_mode)
        self.style_encoder = SPADEStyleEncoder(style_dims, style_enc_filters) \
            if style_encoder else None
        self.train(bn_mode != 'eval')
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                xavier_gain_(m.weight, generator=gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, data, random_style=True, generator=None,
                style_eps=None):
        """data: {'label': [B, H, W, C] one-hot, optional 'images' [B, H,
        W, 3], optional 'z': [B, style_dims]}. The style is 'z', else a
        draw from `generator` (a `torch.Generator` on the label's device)
        with `random_style` or without images, else the style encoder's
        of the images (eps `style_eps`, else drawn from `generator`).
        Returns {'fake_images': [B, H', W', 3] in [-1, 1], 'mu', 'logvar'
        (None unless encoded), 'batch_stats'}: in training mode with
        trainable batch norms the new running statistics {buffer name:
        tensor}, else {}."""
        label = data['label']
        dtype = self.spade_generator.head_0.layers['conv'].weight.dtype
        mu = logvar = None
        if 'z' in data:
            z = data['z']
        elif random_style or 'images' not in data:
            z = torch.randn((label.shape[0], self.style_dims),
                            generator=generator, device=label.device)
        elif self.style_encoder is None:
            raise ValueError('an encoded style needs SPADEWrapper('
                             'style_encoder=True); pass z or '
                             'random_style=True')
        else:
            mu, logvar, z = self.style_encoder(
                data['images'].to(dtype), eps=style_eps, generator=generator)
        fake = self.spade_generator(
            label.permute(0, 3, 1, 2).to(dtype), z.to(dtype))
        stats = {}
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm) and m.new_stats is not None:
                stats[f'{name}.running_mean'], stats[f'{name}.running_var'] \
                    = m.new_stats
                m.new_stats = None
        return {'fake_images': fake.permute(0, 2, 3, 1), 'mu': mu,
                'logvar': logvar, 'batch_stats': stats}
