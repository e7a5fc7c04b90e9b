"""Visualization helpers: colorized segmentation maps, [-1, 1] images
to uint8, image grids (the trainer's snapshots) and the depth colormap
(the renderer's `save_depth` frames).

Counterpart of `scenedreamer_tpu/utils/visualization.py` (reference
`imaginaire/utils/visualization/common.py`, `trainers/gancraft.py:253-286`,
`mc_utils.py:296-300`).
Host side, numpy; arrays are HWC; tensors are moved to the host first.
"""
import colorsys

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _label_palette(n):
    """Deterministic, visually-spread palette."""
    cols = []
    for i in range(n):
        h = (i * 0.618033988749895) % 1.0
        s = 0.55 + 0.45 * ((i * 7) % 3) / 2.0
        v = 0.75 + 0.25 * ((i * 5) % 2)
        cols.append([int(c * 255) for c in colorsys.hsv_to_rgb(h, s, v)])
    return np.array(cols, np.uint8)


def tensor2label(label, n_labels=None, palette=None):
    """One-hot [H, W, C] or index [H, W] label map -> uint8 RGB."""
    label = _host(label)
    if label.ndim == 3:
        n_labels = n_labels or label.shape[-1]
        idx = np.argmax(label, axis=-1)
    else:
        idx = label.astype(np.int64)
        n_labels = n_labels or int(idx.max()) + 1
    pal = palette if palette is not None else _label_palette(n_labels)
    return pal[np.clip(idx, 0, len(pal) - 1)]


def tensor2im(img):
    """[-1, 1] float image -> uint8 (reference tensor2im)."""
    return np.clip((_host(img) * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)


def colormap(x, cmap='viridis'):
    """NaN-safe normalized colormap (reference `mc_utils.py:296-300`) for
    depth frames: float RGB in [0, 1]. matplotlib's map where matplotlib
    is installed, else a blue-to-yellow ramp (the JAX package's two
    branches)."""
    x = np.asarray(_host(x), np.float64)
    x = x - np.nanmin(x)
    denom = np.nanmax(x)
    x = x / denom if denom > 0 else x
    x = np.nan_to_num(x)
    try:
        import matplotlib.pyplot as plt
        return plt.get_cmap(cmap)(x)[..., :3]
    except ImportError:
        return np.stack([x, x ** 2, 1.0 - x], axis=-1)


def image_grid(images, cols=None):
    """List of same-shape uint8 HWC images -> one grid image
    (the trainer's snapshot strip, `trainers/gancraft.py:271`)."""
    n = len(images)
    cols = cols or n
    rows = -(-n // cols)
    h, w, c = images[0].shape
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i, im in enumerate(images):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = im
    return grid
