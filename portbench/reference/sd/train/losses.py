"""Losses of SceneDreamer's GAN training, in PyTorch.

Counterpart of `scenedreamer_tpu/train/losses.py`:
  * N+1-label semantic GAN loss (`imaginaire/model_utils/gancraft/loss.py:10-96`)
  * feature matching (`imaginaire/losses/feature_matching.py:8-38`)
  * Gaussian KL (`imaginaire/losses/kl.py:9-23`)
  * VGG19 perceptual loss, relu_{3,4,5}_1 weighted 0.125 / 0.25 / 1.0,
    L1 (`imaginaire/losses/perceptual.py:16-150`,
    `configs/scenedreamer_train.yaml:13-16`)
  * L2 / L1 reconstruction against the pseudo ground truth.
Tensors are NHWC (channel axis -1). Under AMP the feature distances
are reduced in float32 from bf16 features, as JAX does.
"""
import torch

from portbench.reference.sd.models.vgg import (VGG19Features,
                                               imagenet_normalize)

# configs/scenedreamer_train.yaml:17-22
DEFAULT_LOSS_WEIGHTS = {
    'l2': 10.0,
    'gan': 0.5,
    'pseudo_gan': 0.5,
    'perceptual': 10.0,
    'kl': 0.05,
}

PERCEPTUAL_LAYERS = ('relu_3_1', 'relu_4_1', 'relu_5_1')
PERCEPTUAL_WEIGHTS = (0.125, 0.25, 1.0)


def _nplus1_loss(pred, label, t_real, dis_update):
    """Masked log-softmax GAN loss of one scale (`gancraft/loss.py:52-96`):
    pred [B,H,W,L+1], label [B,H,W,L]; label 0 is ignored (its label and
    logit are zeroed before the softmax)."""
    label = torch.cat([torch.zeros_like(label[..., :1]), label[..., 1:]],
                      dim=-1)
    pred = torch.cat([torch.zeros_like(pred[..., :1]), pred[..., 1:]], dim=-1)
    logp = torch.log_softmax(pred, dim=-1)
    if dis_update and not t_real:
        loss = -logp[..., -1:]                       # the fake channel
    else:
        loss = (-label * logp[..., :-1]).sum(dim=-1, keepdim=True)
    return loss.mean()


def gan_loss(outputs, t_real, dis_update=True):
    """Mean over scales of a list of {'pred', 'label'}
    (`gancraft/loss.py:24-50`)."""
    total = 0.0
    for o in outputs:
        total = total + _nplus1_loss(o['pred'], o['label'], t_real,
                                     dis_update)
    return total / len(outputs)


def feature_matching_loss(fake_features, real_features):
    """Mean L1 over the discriminator's feature lists (float32 whatever
    their dtype); real detached."""
    total, n = 0.0, 0
    for f, r in zip(fake_features, real_features):
        total = total + (f.float() - r.detach().float()).abs().mean()
        n += 1
    return total / max(n, 1)


def gaussian_kl_loss(mu, logvar):
    """-0.5 * sum(1 + logvar - mu^2 - e^logvar), summed over the batch
    too (`losses/kl.py:9-23`)."""
    return -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar))


def l2_loss(x, y):
    return ((x - y) ** 2).mean()


def l1_loss(x, y):
    return (x - y).abs().mean()


class PerceptualLoss(torch.nn.Module):
    """Multi-layer L1 distance of frozen VGG19 features. `vgg` defaults to
    a randomly initialised `VGG19Features` (seed `seed`, compute dtype
    `dtype`); its weights never train."""

    def __init__(self, vgg=None, layers=PERCEPTUAL_LAYERS,
                 weights=PERCEPTUAL_WEIGHTS, seed=0, dtype=torch.float32):
        super().__init__()
        self.layers, self.weights = tuple(layers), tuple(weights)
        self.vgg = vgg if vgg is not None else VGG19Features(
            self.layers, seed=seed, dtype=dtype)
        self.vgg.requires_grad_(False)

    def forward(self, inp, target):
        fi = self.vgg(imagenet_normalize(inp))
        with torch.no_grad():
            ft = self.vgg(imagenet_normalize(target))
        loss = 0.0
        for layer, w in zip(self.layers, self.weights):
            loss = loss + w * (fi[layer].float()
                               - ft[layer].float()).abs().mean()
        return loss
