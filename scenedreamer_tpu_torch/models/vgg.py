"""VGG19 feature extractor for the perceptual loss, in PyTorch.

Counterpart of `scenedreamer_tpu/models/vgg.py` (reference
`imaginaire/losses/perceptual.py:16-150`): 3x3 'same' convs with ReLU,
2x2 max pools before each stage, taps at the `relu_x_y` activations,
ImageNet normalisation of [-1, 1] inputs. The convs are `conv0` ..
`conv15` as in the JAX package (`utils/convert.vgg_state_dict_from_flax`
carries its weights). torchvision's pretrained weights are not in the
repository, so by default the weights are a random init from a seed, as
the JAX package does without them. NHWC at the public call. `dtype`
is the convs' compute dtype (bf16 under AMP, as JAX's `VGG19Features
.dtype`): the weights stay float32 and each conv casts its input, weight
and bias.
"""
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# (tap name after the ReLU, out channels, pool before) per conv
VGG19_CFG = [
    ('relu_1_1', 64, False), ('relu_1_2', 64, False),
    ('relu_2_1', 128, True), ('relu_2_2', 128, False),
    ('relu_3_1', 256, True), ('relu_3_2', 256, False),
    ('relu_3_3', 256, False), ('relu_3_4', 256, False),
    ('relu_4_1', 512, True), ('relu_4_2', 512, False),
    ('relu_4_3', 512, False), ('relu_4_4', 512, False),
    ('relu_5_1', 512, True), ('relu_5_2', 512, False),
    ('relu_5_3', 512, False), ('relu_5_4', 512, False),
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(x):
    """[-1, 1] RGB (NHWC) -> ImageNet-normalised."""
    x = (x + 1.0) * 0.5
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


class VGG19Features(nn.Module):
    """x [B, H, W, 3] -> {tap name: NHWC activation} for `layers`; only
    the convs up to the last tap are built."""

    def __init__(self, layers=('relu_3_1', 'relu_4_1', 'relu_5_1'), seed=0,
                 dtype=torch.float32):
        super().__init__()
        self.layers = tuple(layers)
        self.compute_dtype = dtype
        self.last = max(i for i, (n, _, _) in enumerate(VGG19_CFG)
                        if n in self.layers)
        cin = 3
        for i, (_, ch, _) in enumerate(VGG19_CFG[:self.last + 1]):
            setattr(self, f'conv{i}', nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def reset_parameters(self, generator=None):
        """lecun_normal (flax's default conv init) and zero biases."""
        for i in range(self.last + 1):
            conv = getattr(self, f'conv{i}')
            std = math.sqrt(1.0 / conv.weight[0].numel()) / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                nn.init.zeros_(conv.bias)

    def forward(self, x):
        dt = self.compute_dtype
        y = x.permute(0, 3, 1, 2).to(dt)
        taps = {}
        for i, (name, _, pool) in enumerate(VGG19_CFG[:self.last + 1]):
            if pool:
                y = F.max_pool2d(y, 2, 2)
            conv = getattr(self, f'conv{i}')
            y = F.relu(conv._conv_forward(y, conv.weight.to(dt),
                                          conv.bias.to(dt)))
            if name in self.layers:
                taps[name] = y.permute(0, 2, 3, 1)
        return taps


def convert_torch_vgg19(state_dict):
    """torchvision `vgg19().features` state dict -> this module's state
    dict (`conv{i}.weight` / `.bias`, the torchvision OIHW layout kept).

    Counterpart of JAX `models/vgg.py:convert_torch_vgg19`: the keys are
    `features.{idx}.weight/bias` in torchvision's layer order (a ReLU
    after each conv, a max pool before each stage), numpy arrays (an
    `.npz`) or tensors (a `.pt`); the convs stop at the first one
    missing. Load with `strict=False` when the module builds fewer."""
    sd, idx = {}, 0
    for i, (_, _, pool) in enumerate(VGG19_CFG):
        idx += 1 if pool else 0          # the max pool's slot
        w = state_dict.get(f'features.{idx}.weight')
        if w is None:
            break
        for name, v in (('weight', w),
                        ('bias', state_dict[f'features.{idx}.bias'])):
            v = v.detach().cpu() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.asarray(v))
            sd[f'conv{i}.{name}'] = v.to(torch.float32).contiguous()
        idx += 2                         # conv, ReLU
    return sd
