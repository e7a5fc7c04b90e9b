"""Visualization helpers: colorized segmentation maps, [-1, 1] images
to uint8, image grids (the trainer's snapshots), the depth colormap
(the renderer's `save_depth` frames), PIL images, the optical-flow
colour wheel and keypoint dots.

Counterpart of `scenedreamer_tpu/utils/visualization.py` (reference
`imaginaire/utils/visualization/common.py`, `trainers/gancraft.py:253-286`,
`mc_utils.py:296-300`).
Host side, numpy; arrays are HWC; tensors are moved to the host first.
Where the JAX package calls OpenCV (`tensor2flow`: `cartToPolar`,
`normalize`, `cvtColor` HSV -> RGB; `plot_keypoints`: `circle`), the port
computes the same in numpy, OpenCV's arithmetic included; only
`tensor2pilimage` needs Pillow (it returns a PIL image), and
`save_tensor_image` writes PNG without it.
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


def tensor2pilimage(image, width=None, height=None,
                    minus1to1_normalized=False):
    """[H, W, 3] float image in [0, 1] (or [-1, 1]) -> PIL image,
    optionally bicubic-resized to (width, height) (reference
    `visualization/common.py:43-71`, NHWC here). Needs Pillow."""
    from PIL import Image
    image = _host(image)
    if image.ndim != 3:
        raise ValueError('Image tensor dimension does not equal 3.')
    if image.shape[-1] != 3:
        raise ValueError('Image has more than 3 channels.')
    if minus1to1_normalized:
        image = (image + 1.0) * 0.5
    out = Image.fromarray(np.clip(image * 255.0, 0, 255).astype(np.uint8))
    if width is not None and height is not None:
        out = out.resize((width, height), Image.BICUBIC)
    return out


def save_tensor_image(filename, image, minus1to1_normalized=False):
    """Write an [H, W, 3] float image in [0, 1] (or [-1, 1]) to disk,
    creating parent dirs (reference `visualization/common.py:14-40`): a
    `.png` by `utils/png.py` (no image library), any other format by
    Pillow, from the uint8 image `tensor2pilimage` makes."""
    import os
    from scenedreamer_tpu_torch.utils.png import write_png
    dirname = os.path.dirname(filename)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    if filename.lower().endswith('.png'):
        image = _host(image)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f'an [H, W, 3] image, got {image.shape}')
        if minus1to1_normalized:
            image = (image + 1.0) * 0.5
        write_png(filename, np.clip(image * 255.0, 0, 255).astype(np.uint8))
        return
    tensor2pilimage(image, minus1to1_normalized=minus1to1_normalized
                    ).save(filename)


# OpenCV's fastAtan2 polynomial, in degrees (`mathfuncs_core`)
_ATAN2_P = [np.float32(c * (180 / np.pi)) for c in (
    0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
    -0.04432655554792128)]


def _fast_atan2_deg(y, x):
    """`cv::fastAtan2` in float32: the angle of (x, y) in [0, 360)."""
    p1, p3, p5, p7 = _ATAN2_P
    ax, ay = np.abs(x), np.abs(y)
    eps = np.float32(np.finfo(np.float64).eps)
    c = np.where(ax >= ay, ay / (ax + eps), ax / (ay + eps)).astype(
        np.float32)
    c2 = c * c
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = np.where(ax >= ay, a, np.float32(90) - a)
    a = np.where(x < 0, np.float32(180) - a, a)
    return np.where(y < 0, np.float32(360) - a, a).astype(np.float32)


def _hsv2rgb_u8(hsv):
    """`cv2.cvtColor(hsv, COLOR_HSV2RGB)` of uint8 HSV (H in [0, 180)):
    OpenCV's float conversion, sector table and rounding."""
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255)
    h = np.where(h >= 6, h - 6, h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector
    sector = np.where((sector < 0) | (sector >= 6), 0, sector)
    tab = np.stack([v, v * (1 - s), v * (1 - s * h), v * (1 - s * (1 - h))],
                   axis=-1)
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                      [0, 1, 3], [2, 1, 0]])[sector]       # b, g, r
    bgr = np.take_along_axis(tab, order, axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    out = np.clip(np.rint(bgr[..., ::-1] * np.float32(255)), 0, 255)
    return out.astype(np.uint8)


def tensor2flow(flow, imtype=np.uint8):
    """Optical flow [..., H, W, 2] -> RGB colour-wheel image(s): hue =
    the flow's angle, value = its min-max-normalized magnitude
    (reference `visualization/common.py:158-190`; NHWC here). Batches and
    lists give lists, as in the reference."""
    if flow is None:
        return None
    if isinstance(flow, (list, tuple)):
        outs = [tensor2flow(f, imtype) for f in flow if f is not None]
        return outs or None
    flow = np.asarray(_host(flow), np.float32)
    if flow.ndim >= 4:
        return [tensor2flow(flow[b], imtype) for b in range(flow.shape[0])]
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx * fx + fy * fy)
    ang = _fast_atan2_deg(fy, fx) * np.float32(np.pi / 180)
    hsv = np.zeros((flow.shape[0], flow.shape[1], 3), dtype=imtype)
    hsv[:, :, 1] = 255
    hsv[..., 0] = ang * 180 / np.pi / 2
    lo, hi = float(mag.min()), float(mag.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    hsv[..., 2] = (mag * scale + (0.0 - lo * scale)).astype(np.float32)
    return _hsv2rgb_u8(hsv)


def plot_keypoints(image, keypoints, color=(0, 255, 0), radius=5):
    """Draw filled circles at [N, 2] (x, y) keypoints on a copy of an HWC
    uint8 image (reference `visualization/common.py:192-217`): each
    circle the horizontal spans of OpenCV's midpoint `Circle` (what
    `cv2.circle(..., thickness=-1)` draws), clipped to the image."""
    image = np.array(_host(image), copy=True)
    assert image.ndim == 3 and image.shape[-1] in (1, 3)
    keypoints = np.asarray(_host(keypoints))
    assert keypoints.ndim == 2 and keypoints.shape[1] == 2
    hgt, wid = image.shape[:2]
    col = np.asarray(color[:image.shape[-1]], image.dtype)

    def span(y, x0, x1):
        if 0 <= y < hgt and x1 >= 0 and x0 < wid:
            image[y, max(x0, 0):min(x1, wid - 1) + 1] = col

    for cx, cy in np.round(keypoints).astype(np.int64):
        err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
        while dx >= dy:
            span(cy - dy, cx - dx, cx + dx)
            span(cy + dy, cx - dx, cx + dx)
            span(cy - dx, cx - dy, cx + dy)
            span(cy + dx, cx - dy, cx + dy)
            dy += 1
            err += plus
            plus += 2
            if err > 0:
                err -= minus
                dx -= 1
                minus -= 2
    return image
