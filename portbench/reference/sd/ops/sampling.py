"""Stratified depth sampling inside ray-voxel intersection intervals.

Counterpart of `scenedreamer_tpu/ops/sampling.py` (reference
`mc_utils.py:82-151` sample_depth_batched), flat-ray `[R, M]` layout,
explicit hit masks instead of NaN sentinels. Returns
`nsamples - 1 (+ M + 1 with box boundaries)` sample midpoints per ray.
"""
import torch

from portbench.reference.sd.ops.compositing import cumsum_exclusive


def _linspace01(num, like):
    """linspace(0, 1, num) rounded as jnp.linspace rounds it (i / (num-1)
    in the working dtype; torch.linspace rounds some entries differently)."""
    div = num - 1
    i = torch.arange(div, dtype=like.dtype, device=like.device)
    return torch.cat([i / div, torch.ones(1, dtype=like.dtype,
                                          device=like.device)])


def sample_depth(depth, mask, nsamples, deterministic=False,
                 use_box_boundaries=True, sample_depth_clip=4.0,
                 generator=None, uniforms=None):
    """Sample point depths along rays.

    Args:
        depth: [R, M, 2] entry/exit ray-t of each intersected voxel.
        mask: [R, M] bool validity of each intersection.
        nsamples: number of raw stratified samples.
        deterministic: equal spacing instead of stratified draws.
        use_box_boundaries: include interval boundaries as samples.
        sample_depth_clip: stop sampling after this much in-solid distance.
        generator: `torch.Generator` for the draws.
        uniforms: optional dict of U[0,1) draws in place of the
            generator's, for holding the op against another
            implementation: 'samples' [R, nsamples] (stratified mode)
            and 'boundary' [R, M] (box-boundary filler).

    Returns:
        rand_depth [R, S] ray-t of each sample midpoint, new_dists [R, S]
        distance between consecutive samples, new_idx [R, S] int64 index
        of the interval that holds each midpoint.
    """
    uniforms = uniforms or {}

    def draw(name, shape):
        u = uniforms.get(name)
        if u is None:
            return torch.rand(shape, generator=generator,
                              device=depth.device, dtype=depth.dtype)
        return torch.as_tensor(u, dtype=depth.dtype, device=depth.device)

    maskf = mask.to(depth.dtype)
    entry = depth[..., 0] * maskf          # [R, M]
    exitd = depth[..., 1] * maskf
    dists = torch.clamp(exitd - entry, min=0.0) * maskf

    accu_depth = torch.cumsum(dists, dim=-1)             # [R, M]
    total_depth = torch.clamp(accu_depth[..., -1:], max=sample_depth_clip)

    r = depth.shape[0]
    pieces = []
    if deterministic:
        rand = _linspace01(nsamples + 2, depth)[1:-1].expand(r, nsamples)
    else:
        rand = draw('samples', (r, nsamples)) / nsamples
        rand = rand + _linspace01(nsamples + 1, depth)[:-1]
    pieces.append(rand * total_depth)
    if use_box_boundaries:
        bad = (accu_depth > sample_depth_clip) | (dists == 0)
        filler = draw('boundary', accu_depth.shape) * total_depth
        pieces.append(torch.where(bad, filler, accu_depth))
        pieces.append(torch.zeros((r, 1), dtype=depth.dtype,
                                  device=depth.device))

    samples = torch.sort(torch.cat(pieces, dim=-1), dim=-1).values

    midpoints = 0.5 * (samples[..., 1:] + samples[..., :-1])   # [R, S]
    new_dists = samples[..., 1:] - samples[..., :-1]

    # which interval holds each midpoint (in accumulated in-solid
    # distance)?
    idx = (midpoints[..., None, :] > accu_depth[..., :, None]).sum(dim=-2)
    idx = torch.clamp(idx, max=depth.shape[1] - 1)

    # in-solid distance -> ray t: t = entry[i] + (m - accu_excl[i])
    heads = entry - cumsum_exclusive(dists, dim=-1)             # [R, M]
    rand_depth = torch.gather(heads, -1, idx) + midpoints
    return rand_depth, new_dists, idx
