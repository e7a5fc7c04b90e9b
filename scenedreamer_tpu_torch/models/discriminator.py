"""FPSE-style N+1-label patch discriminator, in PyTorch.

Counterpart of `scenedreamer_tpu/models/discriminator.py` (reference
`imaginaire/discriminators/gancraft.py:16-278`): a 5-level stride-2
encoder, an FPN top-down pathway with 1x1 lateral connections and
bilinear upsampling, a stride-1 head and a 1x1 output conv giving
`num_labels + 1` logits per patch (the +1 channel is "fake").
Segmentation maps are resampled to the prediction grid with the
area+argmax `smooth_interp`, or (`smooth_resample=False`) with the
nearest resize of `jax.image.resize(..., 'nearest')`. Every conv but the
output one is spectrally normalised.

`dtype` is the compute dtype of the convs (JAX's `dtype`, bf16 under
AMP): the parameters, the power iteration and sigma stay float32 (flax's
`SpectralNorm` runs in its float32 parameters' dtype and hands the conv a
float32 kernel, which the conv casts), the conv casts its input, weight
and bias, the features stay in `dtype`, and the output logits are cast
to float32 so the N+1 GAN loss stays float32.

Spectral norm follows flax's `nn.SpectralNorm` as the JAX package uses
it: the power-iteration vector `u` [1, O] is an explicit buffer
(`weight_u`, with `weight_sigma` beside it), one power step runs on
every call, and only a call with `update_stats=True` writes the new `u`
and sigma back (the D update; the G update reads them). The weight is
divided by sigma = v W u^T with u, v held constant, so the gradient
flows through sigma as in flax. Tensors are NHWC at every public call.
"""
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedreamer_tpu_torch.models.layers import leaky_relu
from scenedreamer_tpu_torch.ops.resize import resize_bilinear, resize_nearest

SN_EPS = 1e-12


def _l2_normalize(x):
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def spectral_normalize(mod, w, wm, update_stats=False):
    """flax's `SpectralNorm` of the weight `w`, whose matrix view is wm
    [O, K]: one power-iteration step from the buffer `mod.weight_u` [1, O]
    (held constant, so the gradient flows through sigma = v W u^T only),
    then w / sigma; `update_stats` writes the new u and sigma to
    `mod.weight_u` and `mod.weight_sigma`."""
    with torch.no_grad():
        v = _l2_normalize(mod.weight_u @ wm)            # [1, K]
        u = _l2_normalize(v @ wm.t())                   # [1, O]
    sigma = (v @ wm.t() @ u.t())[0, 0]
    if update_stats:
        # new tensors, not in-place writes: autograd may hold the old
        mod.weight_u = u
        mod.weight_sigma = sigma.detach()
    return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SNConv(nn.Module):
    """Conv2d (zero bias, xavier_normal(gain 0.02) weight), optionally
    spectrally normalised, then leaky ReLU(0.2) unless `act=False`
    (reference Conv2dBlock, order 'CNA', no activation norm); computes
    in `dtype`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 act=True, use_sn=True, dtype=torch.float32):
        super().__init__()
        self.stride, self.pad = stride, (kernel_size - 1) // 2
        self.act, self.use_sn = act, use_sn
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        if use_sn:
            self.register_buffer('weight_u', torch.empty(1, out_channels))
            self.register_buffer('weight_sigma', torch.ones(()))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        o, i, kh, kw = self.weight.shape
        std = 0.02 * math.sqrt(2.0 / (i * kh * kw + o * kh * kw))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            nn.init.zeros_(self.bias)
            if self.use_sn:
                self.weight_u.normal_(generator=generator)
                self.weight_sigma.fill_(1.0)

    def normalized_weight(self, update_stats=False):
        """W / sigma after one power-iteration step from `weight_u`."""
        w = self.weight
        return spectral_normalize(self, w, w.reshape(w.shape[0], -1),
                                  update_stats)

    def forward(self, x, update_stats=False):
        """x [B, C, H, W] (NCHW inside the discriminator)."""
        w = self.normalized_weight(update_stats) if self.use_sn \
            else self.weight
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), w.to(dt), self.bias.to(dt),
                     stride=self.stride, padding=self.pad)
        return leaky_relu(y, grad_one_at_zero=True) if self.act else y


def smooth_interp(segmap, size):
    """Area-resample a one-hot segmentation map [B, H, W, C], then
    re-binarise by argmax (`discriminators/gancraft.py:216-228`): a block
    mean when the size divides, else the bilinear resize."""
    b, h, w, c = segmap.shape
    th, tw = size
    if h % th == 0 and w % tw == 0:
        x = segmap.reshape(b, th, h // th, tw, w // tw, c).mean(dim=(2, 4))
    else:
        x = resize_bilinear(segmap, (th, tw))
    return F.one_hot(x.argmax(dim=-1), c).to(segmap.dtype)


class FPSEDiscriminator(nn.Module):
    """Feature-pyramid patch discriminator (`gancraft.py:133-278`)."""

    def __init__(self, num_labels=12, num_filters=128, kernel_size=3,
                 smooth_resample=True, dtype=torch.float32):
        super().__init__()
        nf = num_filters
        self.smooth_resample = smooth_resample
        down = functools.partial(SNConv, kernel_size=kernel_size, stride=2,
                                 dtype=dtype)
        lat = functools.partial(SNConv, kernel_size=1, stride=1, dtype=dtype)
        self.enc1 = down(3, nf)
        self.enc2 = down(nf, 2 * nf)
        self.enc3 = down(2 * nf, 4 * nf)
        self.enc4 = down(4 * nf, 8 * nf)
        self.enc5 = down(8 * nf, 8 * nf)
        self.lat5 = lat(8 * nf, 4 * nf)
        self.lat4 = lat(8 * nf, 4 * nf)
        self.lat3 = lat(4 * nf, 4 * nf)
        self.lat2 = lat(2 * nf, 4 * nf)
        self.final2 = SNConv(4 * nf, 2 * nf, kernel_size, stride=1,
                             dtype=dtype)
        self.output = SNConv(2 * nf, num_labels + 1, 1, act=False,
                             use_sn=False, dtype=dtype)

    def forward(self, images, segmaps, update_stats=False):
        """images [B, H, W, 3]; segmaps [B, H, W, num_labels] one-hot.
        Returns ([{'pred': [B,h,w,L+1], 'label': [B,h,w,L]}], features
        (NHWC))."""
        us = update_stats
        feat11 = self.enc1(images.permute(0, 3, 1, 2), us)
        feat12 = self.enc2(feat11, us)
        feat13 = self.enc3(feat12, us)
        feat14 = self.enc4(feat13, us)
        feat15 = self.enc5(feat14, us)

        def up_to(x, ref):
            nhwc = resize_bilinear(x.permute(0, 2, 3, 1), ref.shape[2:])
            return nhwc.permute(0, 3, 1, 2)

        feat25 = self.lat5(feat15, us)
        feat24 = up_to(feat25, feat14) + self.lat4(feat14, us)
        feat23 = up_to(feat24, feat13) + self.lat3(feat13, us)
        feat22 = up_to(feat23, feat12) + self.lat2(feat12, us)
        feat32 = self.final2(feat22, us)
        pred2 = self.output(feat32).permute(0, 2, 3, 1).float()
        if self.smooth_resample:
            label_map = smooth_interp(segmaps, pred2.shape[1:3])
        else:
            label_map = resize_nearest(segmaps, pred2.shape[1:3])
        features = [f.permute(0, 2, 3, 1) for f in (
            feat11, feat12, feat13, feat14, feat15, feat25, feat24, feat23,
            feat22)]
        return [{'pred': pred2, 'label': label_map}], features


class GANcraftDiscriminator(nn.Module):
    """Routes the fake / real / pseudo-real branches through one FPSE
    (`discriminators/gancraft.py:73-130`) with `use_label` on (the
    segmentation masks condition D), in compute dtype `dtype`. All
    inputs NHWC."""

    def __init__(self, num_labels=12, num_filters=128, kernel_size=3,
                 seed=0, smooth_resample=True, dtype=torch.float32):
        super().__init__()
        self.fpse = FPSEDiscriminator(num_labels, num_filters, kernel_size,
                                      smooth_resample, dtype)
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, SNConv):
                mod.reset_parameters(gen)

    def forward(self, data, net_g_output, incl_real=False,
                incl_pseudo_real=False, update_stats=False):
        out = {}
        fake = net_g_output['fake_images']
        out['fake_outputs'], out['fake_features'] = self.fpse(
            fake, data['fake_masks'], update_stats)
        if incl_real:
            out['real_outputs'], out['real_features'] = self.fpse(
                data['images'], data['real_masks'], update_stats)
        if incl_pseudo_real:
            out['pseudo_real_outputs'], out['pseudo_real_features'] = \
                self.fpse(data['pseudo_real_img'], data['fake_masks'],
                          update_stats)
        return out
