"""Flow-model ops: channel norm, cost-volume correlation, flow warping.

Counterpart of `scenedreamer_tpu/ops/flow.py` (the reference's CUDA
extensions `imaginaire/third_party/{channelnorm,correlation,resample2d}`,
kept for the full imaginaire layer surface; no SceneDreamer model uses
them). The JAX package writes them as plain jnp, so the port writes torch
ops (autograd gives the backward passes the reference hand-writes):

  * `channel_norm`: per-pixel L_p norm over channels
    (`channelnorm/channelnorm.py:9-29`, norm_deg=2 default);
  * `correlation`: the FlowNet cost volume
    (`correlation/src/correlation_cuda_kernel.cu:96-147`): zero-pad both
    inputs by pad_size, sample the first on a stride1 grid, dot it with
    the second displaced by (tj, ti) * stride2 within
    max_displacement / stride2 steps, averaged over channels *
    kernel_size^2 (the grid starts at kernel radius + max_displacement,
    as JAX's does: the CUDA kernel's start reads out of bounds for
    kernel_size > 1);
  * `resample2d`: bilinear (or nearest) warping of the input by a 2-channel
    flow (dx, dy), source coordinates border-clamped
    (`resample2d/src/resample2d_kernel.cu:15-76`).

NHWC at the public call, as in the JAX package.
"""
import numpy as np
import torch


def channel_norm(x, norm_deg=2):
    """[..., C] -> [..., 1] L_p norm over the channel axis."""
    if norm_deg == 2:
        return torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return (x.abs() ** norm_deg).sum(dim=-1, keepdim=True) ** (1.0 / norm_deg)


def correlation(x1, x2, pad_size=4, kernel_size=1, max_displacement=4,
                stride1=1, stride2=1):
    """Cost volume between two feature maps x1, x2 [N, H, W, C] ->
    [N, outH, outW, disp^2], disp = 2 * (max_displacement // stride2) + 1,
    channel (tj + rad) * disp + (ti + rad) as the CUDA kernel orders them
    (`correlation_cuda_kernel.cu:139-141`)."""
    n, h, w, c = x1.shape
    p = pad_size
    krad = (kernel_size - 1) // 2
    rad = max_displacement // stride2
    border = krad + max_displacement
    ph, pw = h + 2 * p, w + 2 * p
    out_h = -(-(ph - 2 * border) // stride1)
    out_w = -(-(pw - 2 * border) // stride1)
    nelems = kernel_size * kernel_size * c

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, p, p, p, p))
    x1p, x2p = pad(x1), pad(x2)
    ys = border + stride1 * np.arange(out_h)
    xs = border + stride1 * np.arange(out_w)

    def window(x, oy, ox):
        return x[:, ys[0] + oy:ys[0] + oy + stride1 * (out_h - 1) + 1:stride1,
                 xs[0] + ox:xs[0] + ox + stride1 * (out_w - 1) + 1:stride1]

    outs = []
    for tj in range(-rad, rad + 1):
        for ti in range(-rad, rad + 1):
            dy, dx = tj * stride2, ti * stride2
            acc = 0.0
            for j in range(-krad, krad + 1):
                for i in range(-krad, krad + 1):
                    acc = acc + (window(x1p, j, i)
                                 * window(x2p, dy + j, dx + i)).sum(dim=-1)
            outs.append(acc / nelems)
    return torch.stack(outs, dim=-1)


def resample2d(x, flow, kernel_size=1, bilinear=True):
    """Warp x [N, H, W, C] by a per-pixel flow [N, H, W, 2] of (dx, dy)
    pixel offsets (the reference reads channel 0 as dx, 1 as dy,
    `resample2d_kernel.cu:42-43`). Source coordinates are clamped to the
    border as the CUDA kernel clamps them (it keeps the bilinear weights
    of a sample outside the image, as here). `kernel_size` is the
    reference's argument; like JAX's, this reads one tap."""
    n, h, w, c = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing='ij')
    xf = gx[None] + flow[..., 0]
    yf = gy[None] + flow[..., 1]
    flat = x.reshape(n, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(n, h * w, 1).expand(n, h * w, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    if not bilinear:
        xn = torch.floor(xf + 0.5).long().clamp(0, w - 1)
        yn = torch.floor(yf + 0.5).long().clamp(0, h - 1)
        return gather(yn, xn)
    x0f, y0f = torch.floor(xf), torch.floor(yf)
    alpha = (xf - x0f)[..., None]
    beta = (yf - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    xl, xr = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    yt, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    return ((1 - alpha) * (1 - beta) * gather(yt, xl)
            + alpha * (1 - beta) * gather(yt, xr)
            + (1 - alpha) * beta * gather(yb, xl)
            + alpha * beta * gather(yb, xr))
