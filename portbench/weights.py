"""Weights and buffers made from the seed on the device.

Every parameter and buffer of the given modules is filled from two draws
of one `torch.Generator` on the device (one normal, one uniform, each a
single call over all tensors), cut into the tensors in the order of
their names, so a module tree with the same names gets the same values
whatever order it registers them in. The program's modules and the
reference's copies are filled alike from one seed. The scheme: a hash
table uniform in [-1e-4, 1e-4] (the generator's init); a weight normal
with std 1 / sqrt(fan in), twice that for a modulated linear's weight;
modulation weights normal with std 1 / sqrt(style size); the
modulation's alpha bias 1; other biases 0; spectral-norm vectors
standard normal and their sigma 1. The generator's own init (kaiming x
0.5, `reference/sd/models/layers.py`) halves the signal at each layer: a
fly-through frame of it is ~0 everywhere (RenderCNN output std 0.003 at
full width), so no fault in the field or the RenderCNN would show in it;
with these gains the frame's values spread (std ~0.12) without
saturating the tanh. A tensor of any other kind is refused, so a new
kind of tensor in the program gets a rule here before a run uses it.
"""
import math

import numpy as np
import torch

def stream_seed(seed, *stream):
    """A 63-bit seed for `torch.Generator.manual_seed` from the run's
    seed and a stream label (strings and integers)."""
    words = [int(seed) & (2 ** 64 - 1), int(seed) >> 64]
    for s in stream:
        words += list(s.encode()) if isinstance(s, str) else [int(s)]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) >> 1


def _rule(name, tensor, names):
    """(kind, scale) of one tensor: kind 'normal', 'uniform' or 'const'."""
    leaf = name.rsplit('.', 1)[-1]
    stem = name[:-len(leaf)]
    if leaf == 'embeddings':
        return 'uniform', 1e-4
    if leaf in ('weight_alpha', 'weight_beta'):
        return 'normal', 1.0 / math.sqrt(tensor.shape[-1])
    if leaf == 'weight_u':
        return 'normal', 1.0
    if leaf in ('bias_alpha', 'weight_sigma'):
        return 'const', 1.0
    if leaf in ('bias', 'bias_beta'):
        return 'const', 0.0
    if leaf == 'weight' and tensor.dim() >= 2:
        gain = 2.0 if stem + 'weight_alpha' in names else 1.0
        return 'normal', gain / math.sqrt(tensor[0].numel())
    raise ValueError(f'no weight rule for {name} {tuple(tensor.shape)}')


def fill_(modules, seed, device):
    """Fill every parameter and buffer of `modules` ({prefix: module}) on
    `device` from `seed`, in place (the modules must already live on
    `device`), named '<prefix>.<name>'. Returns the number of values
    filled."""
    tensors = {}
    for prefix, mod in modules.items():
        for name, t in list(mod.named_parameters()) + list(
                mod.named_buffers()):
            tensors[f'{prefix}.{name}'] = t
    return fill_tensors_(tensors, seed, device)


def fill_tensors_(tensors, seed, device):
    """Fill the tensors of `tensors` ({name: tensor on `device`}) from
    `seed`, in place, by the rules of their names."""
    names = set(tensors)
    plan = []
    for name in sorted(tensors):
        t = tensors[name]
        kind, scale = _rule(name, t, names)
        plan.append((name, t, kind, scale))
    sizes = {k: sum(t.numel() for _, t, kk, _ in plan if kk == k)
             for k in ('normal', 'uniform')}
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, 'weights'))
    draws = {'normal': torch.randn(sizes['normal'], generator=gen,
                                   device=device),
             'uniform': torch.rand(sizes['uniform'], generator=gen,
                                   device=device)}
    offs = {'normal': 0, 'uniform': 0}
    with torch.no_grad():
        for name, t, kind, scale in plan:
            if kind == 'const':
                t.fill_(scale)
                continue
            n = t.numel()
            piece = draws[kind][offs[kind]:offs[kind] + n].view(t.shape)
            offs[kind] += n
            if kind == 'uniform':
                piece = (piece * 2.0 - 1.0)
            t.copy_(piece * scale)
    return sum(t.numel() for _, t, _, _ in plan)
