"""Camera rays and ray-voxel intersection (DDA).

Counterpart of `scenedreamer_tpu/ops/ray_voxel.py` (reference
`voxlib/ray_voxel_intersection.cu`). Grid layout `[Y, X, Z]`, id 0 =
empty, image rows top-down, the camera basis of
`ray_voxel_intersection.cu:274-287`, flat-ray outputs with explicit hit
masks.

`ray_voxel_intersection` launches kernel K1 (`csrc/dda.cu`, one thread
per ray, with the JAX op's exact empty-space skip over 8^3 bricks,
`kernels.occupancy_bits`) for CUDA tensors and runs `dda_plain`, a lockstep
PyTorch loop with the same arithmetic and no skip, for CPU tensors. The
rays of several camera origins go through one call.
"""
import torch

from scenedreamer_tpu_torch import kernels
from scenedreamer_tpu_torch.ops.rounding import cross3, fma, norm3


def _normalize(v):
    return v / norm3(v)


def camera_rays(cam_dir, cam_up, cam_f, cam_c, img_dims, device='cpu'):
    """Per-pixel unit ray directions [H, W, 3] (float32 on `device`).

    fwd = normalize(dir); side = normalize(fwd x up); up2 = side x fwd;
    ndc = (c0 - row, col - c1); ray = up2*ndc0 + side*ndc1 + fwd*f
    (`ray_voxel_intersection.cu:70-78,280-284`). Cross products and
    norms round as the JAX op's compiled `jnp.cross` / `jnp.linalg.norm`
    do (`ops/rounding.py`), so both packages trace the same rays.
    """
    h, w = img_dims
    cam_dir = torch.as_tensor(cam_dir, dtype=torch.float32, device=device)
    cam_up = torch.as_tensor(cam_up, dtype=torch.float32, device=device)
    fwd = _normalize(cam_dir)
    side = _normalize(cross3(fwd, cam_up))
    up2 = _normalize(cross3(side, fwd))
    rows = torch.arange(h, dtype=torch.float32, device=device)
    cols = torch.arange(w, dtype=torch.float32, device=device)
    ndc0 = (cam_c[0] - rows)[:, None]            # [H, 1]
    ndc1 = (cols - cam_c[1])[None, :]            # [1, W]
    raydir = (up2 * ndc0[..., None] + side * ndc1[..., None]
              + fwd * cam_f)
    return raydir / norm3(raydir, keepdim=True)


def build_occupancy_bits(voxel):
    """K1's occupancy argument for a grid on the card
    (`kernels.occupancy_bits`: one bit per 8^3 brick, as the JAX
    package's `build_occupancy`). Build it once per world and pass it to
    every `ray_voxel_intersection` over that world; None for a grid on
    the CPU, whose plain DDA needs none."""
    if not voxel.is_cuda:
        return None
    return kernels.occupancy_bits(voxel)


def ray_voxel_intersection(voxel, cam_ori, raydirs, max_samples,
                           max_steps=None, occupancy=None, image_width=None):
    """Traverse the grid; record the first `max_samples` solid intervals.

    Args:
        voxel: [Y, X, Z] integer grid tensor, 0 = empty (int8, the
            SceneDreamer worlds' type, on CUDA; any integer type on CPU).
        cam_ori: [3] ray origin shared by all rays, or [G, 3]: the rays
            of G cameras, R / G each, ray r from origin r // (R / G).
        raydirs: [R, 3] float32 unit ray directions, on the grid's device.
        max_samples: M, intervals recorded per ray.
        max_steps: bound on single axis steps; default Y+X+Z+2, which no
            ray from the grid's AABB entry reaches.
        occupancy: the grid's `build_occupancy_bits`, or None to build
            them here (callers that trace one world many times build them
            once and pass them). Unused on the CPU.
        image_width: None, or the width of the row-major images (one per
            origin) the rays form; K1 then walks them in 8x4 pixel tiles.
            The outputs do not depend on it.

    Returns:
        voxel_id [R, M] int32 (0 where no hit), depth [R, M, 2] float32
        entry/exit t (0 where no hit), hit_mask [R, M] bool.
    """
    if max_steps is None:
        max_steps = int(sum(voxel.shape)) + 2
    if raydirs.is_cuda:
        return kernels.dda(voxel, cam_ori, raydirs, max_samples, max_steps,
                           occupancy=occupancy, image_width=image_width)
    return dda_plain(voxel, cam_ori, raydirs, max_samples, max_steps)


def dda_plain(voxel, cam_ori, raydirs, max_samples, max_steps=None,
              with_steps=False):
    """Plain PyTorch version of K1: all rays step in lockstep, one axis
    step per iteration, with the kernel's (and the JAX op's) float
    operations in the same order and rounding; `cam_ori` [3] or [G, 3] as
    `ray_voxel_intersection` takes it. It reads every voxel it steps
    through (the kernel's empty-space skip changes no result). With
    `with_steps`, also returns the per-ray count of axis steps taken (the
    kernel's `out_steps`)."""
    dims = tuple(int(d) for d in voxel.shape)
    if max_steps is None:
        max_steps = sum(dims) + 2
    dev = raydirs.device
    m = int(max_samples)
    dirs = raydirs.to(torch.float32)
    r = dirs.shape[0]
    ori = torch.as_tensor(cam_ori).to(device=dev, dtype=torch.float32) \
        .reshape(-1, 3)
    if r % ori.shape[0]:
        raise ValueError(f'{r} rays do not split among {ori.shape[0]} '
                         f'origins')
    # per-ray origins [R, 3] (one origin broadcasts as [1, 3])
    if ori.shape[0] > 1:
        ori = ori.repeat_interleave(r // ori.shape[0], dim=0)
    dims_f = torch.tensor(dims, dtype=torch.float32, device=dev)
    dims_i = torch.tensor(dims, dtype=torch.int64, device=dev)

    # AABB entry (`_aabb_enter_t`)
    tiny = dirs.abs() < 1e-12
    small = torch.where(dirs < 0, torch.full_like(dirs, -1e-12),
                        torch.full_like(dirs, 1e-12))
    safe = torch.where(tiny, small, dirs)
    t_a = (0.0 - ori) / safe
    t_b = (dims_f - ori) / safe
    t_near = torch.minimum(t_a, t_b).amax(dim=-1)
    t_far = torch.maximum(t_a, t_b).amin(dim=-1)
    inside = (ori >= 0.0) & (ori <= dims_f)
    parallel_miss = (tiny & ~inside).any(dim=-1)
    active = (t_far > torch.clamp(t_near, min=0.0)) & ~parallel_miss
    t0 = torch.clamp(t_near - 1e-4, min=0.0)
    # one rounding, as the JAX op's compiled init (and the kernel) does
    pos = torch.floor(fma(t0[:, None], dirs, ori)).to(torch.int64)

    # crossing t of the next plane per axis: a pure function of the voxel
    inv_dir = 1.0 / torch.where(tiny, torch.full_like(dirs, 1e-12), dirs)
    inf = torch.full_like(dirs, float('inf'))

    def crossing_t(p):
        pf = p.to(torch.float32)
        target = torch.where(dirs > 0, pf + 1.0, pf)
        return torch.where(tiny, inf, (target - ori) * inv_dir)

    axis_t = crossing_t(pos)
    step = torch.where(dirs > 0, 1, -1).to(torch.int64)
    pos_dir = dirs > 0
    voxel_flat = voxel.reshape(-1)
    strides = torch.tensor([dims[1] * dims[2], dims[2], 1],
                           dtype=torch.int64, device=dev)
    slot_iota = torch.arange(m, device=dev)[None, :]
    out_id = torch.zeros((r, m), dtype=torch.int32, device=dev)
    out_t = torch.zeros((r, m, 2), dtype=torch.float32, device=dev)
    cnt = torch.zeros((r,), dtype=torch.int64, device=dev)
    steps = torch.zeros((r,), dtype=torch.int32, device=dev)

    for it in range(max_steps):
        if it % 16 == 0 and not bool(active.any()):
            break
        t0_, t1_, t2_ = axis_t.unbind(-1)
        sel0 = (t0_ <= t1_) & (t0_ <= t2_)
        sel1 = ~sel0 & (t1_ <= t2_)
        sel = torch.stack([sel0, sel1, ~sel0 & ~sel1], dim=-1)
        tnow = axis_t.amin(dim=-1)
        new_pos = pos + torch.where(sel, step, 0)
        oob_dir = torch.where(pos_dir, new_pos >= dims_i, new_pos < 0)
        quit_ = (sel & oob_dir).any(dim=-1)
        axis_t = torch.where(sel, crossing_t(new_pos), axis_t)
        t_exit = axis_t.amin(dim=-1)
        inb = ((new_pos >= 0) & (new_pos < dims_i)).all(dim=-1)
        flat = ((new_pos * strides).sum(dim=-1)).clamp(
            0, voxel_flat.shape[0] - 1)
        blk = torch.where(inb, voxel_flat[flat].to(torch.int32), 0)
        hit = active & ~quit_ & inb & (blk != 0)
        steps += active.to(torch.int32)
        slot = hit[:, None] & (slot_iota == cnt[:, None])
        out_id = torch.where(slot, blk[:, None], out_id)
        out_t = torch.where(slot[..., None],
                            torch.stack([tnow, t_exit], dim=-1)[:, None, :],
                            out_t)
        cnt = cnt + hit.to(torch.int64)
        active = active & ~quit_ & (cnt < m)
        pos = new_pos
    hit_mask = slot_iota < cnt[:, None]
    if with_steps:
        return out_id, out_t, hit_mask, steps
    return out_id, out_t, hit_mask


def ray_voxel_intersection_perspective(voxel, cam_ori, cam_dir, cam_up,
                                       cam_f, cam_c, img_dims, max_samples,
                                       max_steps=None, occupancy=None):
    """Reference-layout wrapper (`voxlib.ray_voxel_intersection_perspective`,
    JAX `ops/ray_voxel.py:564-586`): `camera_rays` on the grid's device,
    then `ray_voxel_intersection` (K1 on CUDA, 8x4 pixel tiles).

    Returns:
        voxel_id: [H, W, M, 1] int32
        depth: [2, H, W, M, 1] float32 (0 where miss; see hit_mask)
        raydirs: [H, W, 1, 3] float32
        hit_mask: [H, W, M] bool (the JAX package's addition; the
            reference marks misses with NaN)
    """
    h, w = img_dims
    raydirs = camera_rays(cam_dir, cam_up, cam_f, cam_c, img_dims,
                          device=voxel.device)
    vid, dep, hit = ray_voxel_intersection(
        voxel, torch.as_tensor(cam_ori, dtype=torch.float32,
                               device=voxel.device),
        raydirs.reshape(-1, 3), max_samples, max_steps,
        occupancy=occupancy, image_width=w)
    voxel_id = vid.reshape(h, w, max_samples, 1)
    depth = dep.reshape(h, w, max_samples, 2).permute(3, 0, 1, 2)[..., None]
    return voxel_id, depth, raydirs.reshape(h, w, 1, 3), \
        hit.reshape(h, w, max_samples)
