"""Standard GAN losses, the multi-scale patch discriminator and the SPADE
training losses, in PyTorch: the second model family (GauGAN training,
`configs/landscape1m.yaml`).

Counterpart of `scenedreamer_tpu/train/gan_losses.py`:
  * hinge / least_square / non_saturated (softplus) / wasserstein GAN
    losses with the generator side's optional top-k selection
    (`imaginaire/losses/gan.py:31-175`);
  * `weighted_mse_loss` (`losses/weighted_mse.py`) and `info_nce_loss`
    (`losses/info_nce.py`);
  * the multi-scale patch discriminator (2 scales, kernel 4, 128
    filters capped at 512, 5 layers, spectral norm;
    `landscape1m.yaml:77-85`), built on `models/discriminator.SNConv`;
    the pyramid shrinks the images with `jax.image.resize(..., 'linear')`
    (antialiased) and the labels with its nearest resize
    (`ops/resize.py`);
  * `spade_gen_loss` / `spade_dis_loss`: gan 1.0 hinge + perceptual 10 +
    feature matching 10 + KL 0.05 (`landscape1m.yaml:28-33`).
Tensors are NHWC at every public call. `train/losses.py:gan_loss` is
GANcraft's N+1 loss and a different function.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedreamer_tpu_torch.models.discriminator import SNConv
from scenedreamer_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from scenedreamer_tpu_torch.train.losses import (feature_matching_loss,
                                                 gaussian_kl_loss)

GAN_MODES = ('hinge', 'least_square', 'non_saturated', 'softplus',
             'wasserstein')


def _bce_logits(x, target):
    return torch.mean(torch.clamp(x, min=0) - x * target
                      + torch.log1p(torch.exp(-x.abs())))


def gan_loss(dis_output, t_real, gan_mode='hinge', dis_update=True,
             topk_frac=1.0, separate_topk=False):
    """dis_output: a logits tensor, or a list of per-scale logits (the
    mean of their losses). On the generator side (`dis_update=False`,
    real target) `topk_frac` < 1 keeps the ceil(frac * n) largest logits,
    over the whole tensor or, with `separate_topk`, per sample."""
    if isinstance(dis_output, (list, tuple)):
        return torch.stack([gan_loss(o, t_real, gan_mode, dis_update,
                                     topk_frac, separate_topk)
                            for o in dis_output]).mean()
    if gan_mode not in GAN_MODES:
        raise ValueError(f'unknown gan_mode {gan_mode}')
    x = dis_output
    if not dis_update:
        assert t_real, 'generator loss must target real'
        if topk_frac < 1.0:
            flat = x.reshape(x.shape[0], -1) if separate_topk \
                else x.reshape(-1)
            k = max(1, math.ceil(topk_frac * flat.shape[-1]))
            x = torch.topk(flat, k, dim=-1).values
    target = 1.0 if t_real else 0.0
    if gan_mode in ('non_saturated', 'softplus'):
        return _bce_logits(x, target)
    if gan_mode == 'least_square':
        return 0.5 * torch.mean((x - target) ** 2)
    if gan_mode == 'hinge':
        if dis_update:
            return -torch.mean(torch.clamp(x - 1.0 if t_real else -x - 1.0,
                                           max=0.0))
        return -torch.mean(x)
    return -torch.mean(x) if t_real else torch.mean(x)


def weighted_mse_loss(x, y, weights):
    """Per-element weighted MSE (`losses/weighted_mse.py`)."""
    return torch.mean(weights * (x - y) ** 2)


def info_nce_loss(feat_a, feat_b, temperature=0.07):
    """InfoNCE of feature batches [B, C], the a -> b direction
    (`losses/info_nce.py`)."""
    a = feat_a / torch.linalg.norm(feat_a, dim=-1, keepdim=True)
    b = feat_b / torch.linalg.norm(feat_b, dim=-1, keepdim=True)
    logits = (a @ b.t()) / temperature
    return torch.mean(-torch.diagonal(F.log_softmax(logits, dim=-1)))


class PatchDiscriminator(nn.Module):
    """pix2pixHD-style patch D: `num_layers` spectrally normalised convs
    with leaky ReLU (stride 2 but the last), then a plain conv to one
    logit per patch. Returns (logits [B, h, w, 1], per-layer features
    NHWC)."""

    def __init__(self, in_channels, num_filters=128, max_num_filters=512,
                 num_layers=5, kernel_size=4):
        super().__init__()
        self.num_layers = num_layers
        cin, nf = in_channels, num_filters
        for i in range(num_layers):
            cout = min(nf, max_num_filters)
            setattr(self, f'layer{i}', SNConv(
                cin, cout, kernel_size,
                stride=2 if i < num_layers - 1 else 1))
            cin, nf = cout, nf * 2
        self.output = SNConv(cin, 1, kernel_size, act=False, use_sn=False)

    def forward(self, images, label, update_stats=False):
        x = torch.cat([images, label], dim=-1).permute(0, 3, 1, 2)
        feats = []
        for i in range(self.num_layers):
            x = getattr(self, f'layer{i}')(x, update_stats)
            feats.append(x.permute(0, 2, 3, 1))
        return self.output(x).permute(0, 2, 3, 1), feats


class MultiScaleDiscriminator(nn.Module):
    """`num_discriminators` patch Ds (`dis0`, `dis1`, ...) over a pyramid
    that halves the images (bilinear, antialiased) and the labels
    (nearest) between scales. `seed` makes the init reproducible.
    Returns ([logits per scale], [features per scale])."""

    def __init__(self, num_labels, image_channels=3, num_discriminators=2,
                 num_filters=128, max_num_filters=512, num_layers=5,
                 kernel_size=4, seed=0):
        super().__init__()
        self.num_discriminators = num_discriminators
        for d in range(num_discriminators):
            setattr(self, f'dis{d}', PatchDiscriminator(
                image_channels + num_labels, num_filters, max_num_filters,
                num_layers, kernel_size))
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, SNConv):
                m.reset_parameters(gen)

    def forward(self, images, label, update_stats=False):
        outputs, features = [], []
        x, lbl = images, label
        for d in range(self.num_discriminators):
            logits, feats = getattr(self, f'dis{d}')(x, lbl, update_stats)
            outputs.append(logits)
            features.append(feats)
            if d + 1 < self.num_discriminators:
                size = (x.shape[1] // 2, x.shape[2] // 2)
                x = resize_bilinear(x, size)
                lbl = resize_nearest(lbl, size)
        return outputs, features


SPADE_LOSS_WEIGHTS = {'gan': 1.0, 'perceptual': 10.0,
                      'feature_matching': 10.0, 'kl': 0.05}


def spade_gen_loss(dis_apply, g_out, batch, perceptual=None,
                   weights=SPADE_LOSS_WEIGHTS, gan_mode='hinge',
                   batch_shards=1):
    """The generator's SPADE loss; dis_apply(images, label) -> (outputs,
    features). The KL term sums over the batch: when `batch` is one of
    `batch_shards` equal shares of the batch whose losses are then
    averaged (data parallelism), its sum is scaled by `batch_shards`, so
    that the average is the whole batch's sum, as JAX's globally sharded
    step computes it. Returns (total, metrics)."""
    fake, label = g_out['fake_images'], batch['label']
    out_f, feat_f = dis_apply(fake, label)
    out_r, feat_r = dis_apply(batch['images'], label)
    m = {}
    g = gan_loss(out_f, True, gan_mode, dis_update=False)
    m['gen/gan'] = g
    total = weights['gan'] * g
    if 'feature_matching' in weights:
        fm = torch.stack([feature_matching_loss(ff, fr)
                          for ff, fr in zip(feat_f, feat_r)]).mean()
        m['gen/feature_matching'] = fm
        total = total + weights['feature_matching'] * fm
    if 'perceptual' in weights and perceptual is not None:
        p = perceptual(fake, batch['images'])
        m['gen/perceptual'] = p
        total = total + weights['perceptual'] * p
    if 'kl' in weights and g_out.get('mu') is not None:
        kl = gaussian_kl_loss(g_out['mu'], g_out['logvar']) * batch_shards
        m['gen/kl'] = kl
        total = total + weights['kl'] * kl
    m['gen/total'] = total
    return total, m


def spade_dis_loss(dis_apply, fake_images, batch,
                   weights=SPADE_LOSS_WEIGHTS, gan_mode='hinge',
                   dis_apply_real=None):
    """The discriminator's SPADE loss on the detached fake.
    `dis_apply_real` replaces the real images' forward: the trainer's
    advances the spectral-norm power iteration there, inside the loss,
    with no extra D forward. Returns (total, metrics)."""
    label = batch['label']
    out_f, _ = dis_apply(fake_images.detach(), label)
    out_r, _ = (dis_apply_real or dis_apply)(batch['images'], label)
    fake_l = gan_loss(out_f, False, gan_mode, dis_update=True)
    real_l = gan_loss(out_r, True, gan_mode, dis_update=True)
    total = weights['gan'] * (fake_l + real_l)
    return total, {'dis/fake': fake_l, 'dis/real': real_l,
                   'dis/total': total}
