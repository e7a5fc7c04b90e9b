"""Image resizes as `jax.image.resize(x, shape, method)` computes them.

Bilinear (antialiased when shrinking):

Per spatial axis a weight matrix [in, out] of the triangle kernel at
the half-pixel-centred sample positions, widened by the shrink factor
when shrinking, each column normalised to sum 1 and zeroed where the
sample lies outside the input (`jax._src.image.scale.compute_weight_mat`);
the image is contracted with one matrix per resized axis, in the image's
dtype (JAX casts the matrices to it). Upsampling by
an integer factor then equals `F.interpolate(..., 'bilinear',
align_corners=False)`, but the port uses this one form everywhere so
the discriminator's FPN upsampling, `smooth_interp` and the style
encoder's input resize all round as the JAX package does.

Nearest: the cell-centred source index floor((dst + 0.5) * in / out) in
float32 (`jax._src.image.scale._resize_nearest`); torch's `nearest`
takes floor(dst * in / out) instead.
"""
import torch


def _weights(n_in, n_out, device):
    scale = n_out / n_in
    inv = torch.tensor(1.0 / scale, dtype=torch.float32)
    kscale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kscale
    w = torch.clamp(1.0 - x, min=0.0)                     # [in, out]
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_bilinear(x, size):
    """x [B, H, W, C] -> [B, h, w, C] (size = (h, w))."""
    h, w = size
    if x.shape[1] != h:
        x = torch.einsum('bhwc,hy->bywc', x, _weights(x.shape[1], h,
                                                       x.device).to(x.dtype))
    if x.shape[2] != w:
        x = torch.einsum('bhwc,wx->bhxc', x, _weights(x.shape[2], w,
                                                       x.device).to(x.dtype))
    return x


def resize_nearest(x, size):
    """x [B, H, W, C] -> [B, h, w, C] (size = (h, w)), nearest."""
    def index(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) \
            * n_in / n_out
        return torch.floor(pos).long().clamp(max=n_in - 1).to(x.device)
    return x[:, index(x.shape[1], size[0])][:, :, index(x.shape[2], size[1])]
