"""Misc tensor and config helpers.

Counterpart of `scenedreamer_tpu/utils/misc.py` (reference
`imaginaire/utils/misc.py` and `imaginaire/utils/path.py`): the
structural helpers. The reference's device moves and dtype casts
(`to_cuda`, `to_half`, ...) are one torch call each and are not wrapped.
The JAX package's `enable_compilation_cache` (XLA's persistent cache)
has no counterpart: the port's kernels build once into
`scenedreamer_tpu_torch/_build/` and load from there after.
"""
import glob
import os

import numpy as np
import torch


def split_labels(labels, label_lengths):
    """Split a channel-concatenated label tensor back into named parts
    (`misc.py:14-37`), channel-last as in the JAX package (the reference
    splits its NCHW channel axis)."""
    start = 0
    outputs = {}
    for data_type, length in label_lengths.items():
        outputs[data_type] = labels[..., start:start + length]
        start += length
    return outputs


def slice_tensor(data, start, end):
    """Slice [start:end) through tensors and arrays in nested dicts,
    lists and tuples (`misc.py:146-162`); other leaves pass through."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        return data[start:end]
    if isinstance(data, dict):
        return {k: slice_tensor(v, start, end) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(slice_tensor(d, start, end) for d in data)
    return data


def get_and_setattr(cfg, name, default):
    """Get attribute, setting the default if absent (`misc.py:163-177`)."""
    if not hasattr(cfg, name):
        setattr(cfg, name, default)
    return getattr(cfg, name)


def get_nested_attr(cfg, attr_name, default):
    """Dotted-path attribute lookup with default (`misc.py:180-198`)."""
    atr = cfg
    for name in attr_name.split('.'):
        if not hasattr(atr, name):
            return default
        atr = getattr(atr, name)
    return atr


def random_shift(x, generator=None, offset=0.05, uniforms=None):
    """Translate each image of x [B, H, W, C] by up to `offset` of its
    half-extent, bilinear with reflection padding (`misc.py:216-239`;
    the reference's `affine_grid` + `grid_sample`). The shift is
    2 * offset * u - offset for u [B, 2] (dy, dx) uniform in [0, 1),
    drawn from `generator` unless given as `uniforms`."""
    b, h, w, c = x.shape
    if uniforms is None:
        uniforms = torch.rand((b, 2), generator=generator, device=x.device)
    shift = 2.0 * offset * uniforms.to(x.dtype) - offset
    ys = (torch.arange(h, device=x.device, dtype=x.dtype) + 0.5) / h * 2 - 1
    xs = (torch.arange(w, device=x.device, dtype=x.dtype) + 0.5) / w * 2 - 1

    def fold(v):
        # reflection padding on the normalised coords: identity on
        # [-1, 1], mirrored outside
        return 1.0 - (torch.remainder(v + 1.0, 4.0) - 2.0).abs()

    fy = (fold(ys[None] + shift[:, :1]) + 1.0) * 0.5 * h - 0.5    # [B, H]
    fx = (fold(xs[None] + shift[:, 1:]) + 1.0) * 0.5 * w - 0.5    # [B, W]
    y0 = torch.floor(fy).long().clamp(0, h - 1)
    x0 = torch.floor(fx).long().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy = (fy - y0).clamp(0.0, 1.0)[:, :, None, None]
    wx = (fx - x0).clamp(0.0, 1.0)[:, None, :, None]
    bi = torch.arange(b, device=x.device)[:, None, None]

    def tap(yi, xi):
        return x[bi, yi[:, :, None], xi[:, None, :]]

    return (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x1) * (1 - wy) * wx
            + tap(y1, x0) * wy * (1 - wx) + tap(y1, x1) * wy * wx)


def get_immediate_subdirectories(input_dir):
    """Sorted immediate subdirectory names (`path.py:11-20`)."""
    return sorted(d for d in os.listdir(input_dir)
                  if os.path.isdir(os.path.join(input_dir, d)))


def get_recursive_subdirectories(input_dir, ext):
    """Sorted directories under input_dir holding files with the
    extension (`path.py:23-35`)."""
    return sorted({os.path.dirname(p) for p in glob.glob(
        os.path.join(input_dir, '**', f'*.{ext}'), recursive=True)})
