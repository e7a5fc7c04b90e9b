"""Sparse trilinear interpolation of per-corner features at world coords.

Counterpart of `scenedreamer_tpu/ops/sp_trilinear.py` (reference
`voxlib.sp_trilinear_worldcoord`,
`imaginaire/model_utils/gancraft/voxlib/sp_trilinear_worldcoord_kernel.cu:80-180`),
the legacy GANcraft voxel-feature lookup (`gancraft_base.py:442`):

  * a corner-index LUT `[Y+1, X+1, Z+1]` int32 maps each voxel corner to
    a row of the feature table; trilinear weights from the fractional
    world coordinate;
  * NaN coordinates (the reference's sentinels) and, when given, points
    outside `valid_mask` give zeros;
  * `ign_zero=True` shifts ids by -1 so LUT entry 0 means "hole", whose
    weight is dropped from the blend;
  * the gradient reaches the feature table only, never the coordinates
    (the reference's backward scatters to the features alone).

The JAX package writes this as plain jnp (a gather and a lerp; XLA's
segment sum for the table gradient), so the port writes torch ops, no
kernel. It never forms the [N, 8, C] corner values (3.4 GB at a training
batch's 1.6M points and C = 64): `_SpTrilinear` sums the 8 corners'
rows one at a time, and its backward adds w_k * g into the table
gradient with `index_add_` per corner (on CUDA its atomics sum in no
fixed order; XLA's segment sum is deterministic).
"""
import numpy as np
import torch

# corner k's (y, x, z) offsets are the bits of k, y the highest
_OFFSETS = [((k >> 2) & 1, (k >> 1) & 1, k & 1) for k in range(8)]


class _SpTrilinear(torch.autograd.Function):
    """sum_k w[:, k] * feats[ids[:, k]] with the table gradient only."""

    @staticmethod
    def forward(ctx, feats, ids, w):
        out = torch.zeros((ids.shape[0], feats.shape[1]), dtype=feats.dtype,
                          device=feats.device)
        for k in range(ids.shape[1]):
            out.addcmul_(feats[ids[:, k]], w[:, k:k + 1])
        ctx.save_for_backward(ids, w)
        ctx.rows = feats.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        ids, w = ctx.saved_tensors
        grad = torch.zeros((ctx.rows, g.shape[1]), dtype=g.dtype,
                           device=g.device)
        for k in range(ids.shape[1]):
            grad.index_add_(0, ids[:, k], g * w[:, k:k + 1])
        return grad, None, None


def corner_weights(corner_lut, worldcoord, rows, ign_zero=False,
                   valid_mask=None):
    """The blend of `sp_trilinear_worldcoord`: (ids [N, 8] int64 rows of
    a `rows`-row table, weights [N, 8] float32) for the N = prod(prefix)
    points of worldcoord [..., 3]; zero weights where the point is
    invalid or, with `ign_zero`, where the corner is a hole."""
    wc = worldcoord.detach().reshape(-1, 3).to(torch.float32)
    invalid = torch.isnan(wc).any(dim=-1)
    if valid_mask is not None:
        invalid = invalid | ~valid_mask.reshape(-1).to(torch.bool)
    wc = torch.nan_to_num(wc)
    base = torch.floor(wc)
    frac = wc - base
    dims = corner_lut.shape
    # clamp before the integer cast: a huge (or +-inf -> +-3.4e38)
    # coordinate has frac 0 and lands on the LUT's edge either way
    hi = torch.tensor(dims, dtype=torch.float32, device=wc.device)
    base = torch.maximum(torch.minimum(base, hi), torch.full_like(base, -1))
    base = base.to(torch.int64)
    lut = corner_lut.reshape(-1)
    ids, ws = [], []
    for oy, ox, oz in _OFFSETS:
        cy = (base[:, 0] + oy).clamp(0, dims[0] - 1)
        cx = (base[:, 1] + ox).clamp(0, dims[1] - 1)
        cz = (base[:, 2] + oz).clamp(0, dims[2] - 1)
        ids.append(lut[(cy * dims[1] + cx) * dims[2] + cz].to(torch.int64))
        wy, wx, wz = ((f if o else 1.0 - f) for f, o in
                      zip(frac.unbind(-1), (oy, ox, oz)))
        ws.append(wy * wx * wz)
    ids, w = torch.stack(ids, dim=-1), torch.stack(ws, dim=-1)
    if ign_zero:
        w = torch.where(ids == 0, torch.zeros_like(w), w)
        ids = ids - 1
    w = torch.where(invalid[:, None], torch.zeros_like(w), w)
    return ids.clamp(0, rows - 1), w


def sp_trilinear_worldcoord(feats, corner_lut, worldcoord, ign_zero=False,
                            valid_mask=None):
    """Interpolate per-corner features at world coordinates.

    Args:
        feats: [R, C] per-corner feature rows.
        corner_lut: [Y+1, X+1, Z+1] integer corner-id LUT on feats' device.
        worldcoord: [..., 3] float coords (voxel units). NaNs -> zeros.
        ign_zero: id 0 = hole; indices are shifted by -1 and holes are
            dropped from the blend (cu:163-169).
        valid_mask: optional [...] bool; False -> zeros.

    Returns:
        [..., C] interpolated features (differentiable in `feats` only).
    """
    prefix = worldcoord.shape[:-1]
    ids, w = corner_weights(corner_lut, worldcoord, feats.shape[0],
                            ign_zero, valid_mask)
    out = _SpTrilinear.apply(feats, ids, w.to(feats.dtype))
    return out.reshape(*prefix, feats.shape[-1])


def build_corner_lut(voxel):
    """Corner-id LUT for a dense voxel grid: corners adjacent to at
    least one solid voxel get consecutive ids starting at 1 (0 = hole),
    the `mc_utils.gen_corner_voxel` contract the reference feeds to
    sp_trilinear (`mc_utils.py:13-30`). Host numpy, the JAX package's
    copy; returns ([Y+1, X+1, Z+1] int32 LUT, num_corners)."""
    occ = np.asarray(voxel) != 0
    cor = np.zeros(tuple(s + 1 for s in occ.shape), bool)
    for dy in (0, 1):
        for dx in (0, 1):
            for dz in (0, 1):
                cor[dy:dy + occ.shape[0], dx:dx + occ.shape[1],
                    dz:dz + occ.shape[2]] |= occ
    lut = np.zeros(cor.shape, np.int32)
    n = int(cor.sum())
    lut[cor] = np.arange(1, n + 1, dtype=np.int32)
    return lut, n
