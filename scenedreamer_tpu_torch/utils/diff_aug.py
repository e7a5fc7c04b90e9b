"""Differentiable GAN augmentation (DiffAugment), in PyTorch.

Counterpart of `scenedreamer_tpu/utils/diff_aug.py` (reference
`imaginaire/utils/diff_aug.py:14-142`): the color / translation / cutout
policies applied to the discriminator's image inputs. NHWC, differentiable
in the image.

Each op takes its random values as tensors (`draw` makes them from a
`torch.Generator`), so the same op can be fed another implementation's
draws:
  * color: brightness, saturation and contrast factors u [B] in [0, 1):
    x + u_b - 0.5, then (x - mean_c) * 2 u_s + mean_c, then
    (x - mean_hwc) * (u_c + 0.5) + mean_hwc;
  * translation (ratio 0.125): integer shifts ty [B] in [-sh, sh] and
    tx [B] in [-sw, sw], sh = int(H * 0.125 + 0.5); a gather with zero
    fill where the source lies outside the image;
  * cutout (ratio 0.5): centres cy [B] in [0, H + (1 - ch % 2)) and cx
    [B] likewise, ch = int(H * 0.5 + 0.5); pixels with |y - cy| < ch // 2
    and |x - cx| < cw // 2 are zeroed.
"""
import torch

POLICIES = ('color', 'translation', 'cutout')


def parse_policy(policy):
    """The op names of a comma-joined `policy`; raises on an unknown one."""
    ops = [p.strip() for p in policy.split(',')] if policy else []
    for p in ops:
        if p not in POLICIES:
            raise ValueError(f'unknown DiffAugment policy {p!r} (known: '
                             f'{POLICIES})')
    return ops


def _spans(h, w, ratio):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def color(x, brightness, saturation, contrast):
    """x [B, H, W, C]; each factor [B] uniform in [0, 1)."""
    b = x.shape[0]
    x = x + brightness.reshape(b, 1, 1, 1) - 0.5
    mean = x.mean(dim=-1, keepdim=True)
    x = (x - mean) * (saturation.reshape(b, 1, 1, 1) * 2.0) + mean
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (contrast.reshape(b, 1, 1, 1) + 0.5) + mean


def translation(x, ty, tx):
    """x [B, H, W, C] shifted by ty, tx [B] (int) pixels, zero-filled."""
    b, h, w, c = x.shape
    ys = torch.arange(h, device=x.device)[None, :] - ty[:, None]     # [B, H]
    xs = torch.arange(w, device=x.device)[None, :] - tx[:, None]     # [B, W]
    inside = (((ys >= 0) & (ys < h))[:, :, None]
              & ((xs >= 0) & (xs < w))[:, None, :])[..., None]
    g = torch.gather(x, 1, ys.clamp(0, h - 1)[:, :, None, None]
                     .expand(b, h, w, c))
    g = torch.gather(g, 2, xs.clamp(0, w - 1)[:, None, :, None]
                     .expand(b, h, w, c))
    return torch.where(inside, g, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def cutout(x, cy, cx, ratio=0.5):
    """x [B, H, W, C] with the box centred at cy, cx [B] (int) zeroed."""
    b, h, w, _ = x.shape
    ch, cw = _spans(h, w, ratio)
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    inside = ((ys - cy.reshape(b, 1, 1)).abs() < ch // 2) \
        & ((xs - cx.reshape(b, 1, 1)).abs() < cw // 2)
    return x * (~inside)[..., None].to(x.dtype)


def draw(policy, shape, generator=None, device=None):
    """The random values of `policy` for an image batch of `shape`
    [B, H, W, C]: one tuple of tensors per policy entry, in its order."""
    b, h, w, _ = shape
    out = []
    for p in parse_policy(policy):
        if p == 'color':
            out.append(tuple(torch.rand((b,), generator=generator,
                                        device=device) for _ in range(3)))
        elif p == 'translation':
            sh, sw = _spans(h, w, 0.125)
            out.append((torch.randint(-sh, sh + 1, (b,), generator=generator,
                                      device=device),
                        torch.randint(-sw, sw + 1, (b,), generator=generator,
                                      device=device)))
        else:
            ch, cw = _spans(h, w, 0.5)
            out.append((torch.randint(0, h + (1 - ch % 2), (b,),
                                      generator=generator, device=device),
                        torch.randint(0, w + (1 - cw % 2), (b,),
                                      generator=generator, device=device)))
    return out


_OPS = {'color': color, 'translation': translation, 'cutout': cutout}


def apply_diff_aug(x, policy, draws):
    """x [B, H, W, C] through each op of `policy` (comma-joined subset of
    'color', 'translation', 'cutout'; '' is the identity) with its
    entry of `draws` (as `draw` returns them)."""
    for p, values in zip(parse_policy(policy), draws, strict=True):
        x = _OPS[p](x, *values)
    return x
