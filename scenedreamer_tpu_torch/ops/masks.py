"""Segmentation-mask utilities.

Counterpart of `scenedreamer_tpu/ops/masks.py` (reference
`imaginaire/model_utils/gancraft/mc_utils.py:277-292`):
  * `segmask_smooth`: window-sum a one-hot mask, divide by the count of
    in-image cells and re-binarize by argmax;
  * `rand_crop`: principal-point jitter emulating a random crop of a
    larger virtual sensor (host side, numpy generator).

NHWC layout at the call boundary.
"""
import torch
import torch.nn.functional as F


def segmask_smooth(seg_mask, kernel_size=11):
    """seg_mask: [B, H, W, C] one-hot -> smoothed one-hot.

    Sums of 0/1 values are exact in float32, so the window means, their
    ties and the argmax (first index on ties) equal the JAX op's bit for
    bit. The window is 'SAME'-padded: for an even size the extra cell
    lies on the high side."""
    k = int(kernel_size)
    lo, hi = (k - 1) // 2, k // 2
    x = seg_mask.permute(0, 3, 1, 2)
    ones = torch.ones_like(x[:, :1])
    summed = F.avg_pool2d(F.pad(x, (lo, hi, lo, hi)), k, stride=1,
                          divisor_override=1)
    count = F.avg_pool2d(F.pad(ones, (lo, hi, lo, hi)), k, stride=1,
                         divisor_override=1)
    idx = (summed / count).argmax(dim=1)
    return F.one_hot(idx, seg_mask.shape[-1]).to(seg_mask.dtype)


def rand_crop(rng, cam_c, cam_res, target_res):
    """New principal point equivalent to rendering at cam_res then
    cropping target_res (host side, numpy generator)."""
    d0 = rng.integers(0, cam_res[0] - target_res[0] + 1)
    d1 = rng.integers(0, cam_res[1] - target_res[1] + 1)
    return (cam_c[0] - d0, cam_c[1] - d1)
