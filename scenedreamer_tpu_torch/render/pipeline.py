"""Trajectory rendering: scene -> camera path -> frames.

Counterpart of the split-refine path of `scenedreamer_tpu/render/pipeline.py`
(reference `imaginaire/generators/scenedreamer.py:479-632`
inference_givenstyle). Per frame:
  1. camera rays and the full-frame DDA (kernel K1 on CUDA, with the
     world's brick occupancy built once per renderer);
  2. one frame-global sky average (`pipeline.py:165-169`);
  3. the hash table baked once for the world's scene code (K2 (a); a
     spec that is not foldable has no bake and encodes unfolded, K4);
  4. the pointwise field (depth samples -> hash encode (K2 (b) or K4) ->
     RenderMLP -> compositing) over chunks of image rows, sized to keep
     activations a few GB; the field is pointwise, so the values do not
     depend on the chunking. One fetch per frame brings the count of
     rays with any hit in each chunk (`pipeline.py:431-448`): a chunk
     with none skips the field (`render_pixels(sky_only=True)`, the
     `sky_fast` path), any other runs it on only its first K rays after
     a hits-first sort (`render_pixels(compact_k=K)`, switched by
     SCENEDREAMER_FIELD_COMPACT, default '1'), both exact;
  5. one full-frame RenderCNN, then the pad crop;
  6. expected depth sum(w t) / sum(w), inf for sky (`pipeline.py:211-216`).

Not in this slice: CNN row strips above 1.4 MPx, the padded-tile and
mesh paths, tiles-per-dispatch batching, `export_tile`, style
interpolation, depth colormaps and the mp4 writer.
"""
import os

import numpy as np
import torch

from scenedreamer_tpu_torch.device import resolve_device
from scenedreamer_tpu_torch.ops.ray_voxel import (build_occupancy_bits,
                                                  camera_rays,
                                                  ray_voxel_intersection)
from scenedreamer_tpu_torch.scene.camera import EvalCameraController
from scenedreamer_tpu_torch.utils.png import write_png

# biome color LUT for the semantic-map visualization
# (`scenedreamer.py:534-546`)
BIOME_COLORS = np.array(
    [[255, 255, 178], [184, 200, 98], [188, 161, 53], [190, 255, 242],
     [106, 144, 38], [33, 77, 41], [86, 179, 106], [34, 61, 53],
     [35, 114, 94], [0, 0, 255], [0, 255, 0]], np.uint8)

# rays per field chunk: at 40 samples and 256 hidden channels one MLP
# activation is 32768 * 41 * 256 * 4 B = 1.4 GB
CHUNK_RAYS = 32768
# a compacted chunk's K is its count of rays with a hit rounded up to a
# multiple of this. PyTorch compiles nothing per shape, so any K would
# do; whole warps of rays keep the field's rows (K x samples) a multiple
# of 32 for the GEMMs and bound the distinct activation sizes the
# caching allocator sees, for at most 31 extra rays a chunk (0.1% of a
# 32,670-ray serving chunk)
COMPACT_GRANULE = 32


def to_uint8(img):
    """[-1, 1] float -> uint8 RGB."""
    return np.clip((np.asarray(img) * 0.5 + 0.5) * 255, 0,
                   255).astype(np.uint8)


class TiledRenderer:
    """Renders frames of one world with fixed inference settings.

    `model` is a `SceneDreamerGenerator` (moved to `device`); `device`
    defaults to CUDA and raises without it unless 'cpu' is passed.
    `sky_fast`: chunks where no ray hits skip the field. The environment's
    SCENEDREAMER_FIELD_COMPACT ('1' unless set) compacts the others to
    their rays with a hit. `last_stats` holds the last frame's rays,
    rays with a hit, chunks by path and the field's rays and points.
    """

    def __init__(self, model, world, num_samples=40,
                 num_blocks_early_stop=6, sample_depth=3.0, pad=30,
                 resolution_hw=(540, 960), chunk_rays=CHUNK_RAYS,
                 device=None, sky_fast=True):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.world = world
        self.num_samples = num_samples
        self.m = num_blocks_early_stop
        self.sample_depth = sample_depth
        self.pad = pad
        self.res = tuple(resolution_hw)
        self.cam_res = (self.res[0] + pad, self.res[1] + pad)
        self.chunk_rays = chunk_rays
        self.sky_fast = sky_fast
        self.field_compact = os.environ.get(
            'SCENEDREAMER_FIELD_COMPACT', '1') == '1'
        self.last_stats = None
        self.voxel = torch.from_numpy(world.voxel).to(self.device)
        self.occupancy = build_occupancy_bits(self.voxel)
        with torch.no_grad():
            hf = torch.from_numpy(
                world.height_field.transpose(0, 2, 3, 1)).to(self.device)
            sf = torch.from_numpy(
                world.semantic_field.transpose(0, 2, 3, 1)).to(self.device)
            self.global_enc = self.model.world_code(hf, sf)

    @torch.no_grad()
    def style_z(self, style):
        """Raw style [1, style_dims] -> intermediate style."""
        return self.model.style_forward(torch.tensor(
            np.asarray(style), dtype=torch.float32, device=self.device))

    @torch.no_grad()
    def frame(self, cam_pose, z, return_aux=False):
        """Render one frame. cam_pose = (ori, dir, up, f_ratio) in the
        world's local frame (EvalCameraController convention). Returns
        the [H, W, 3] float image in [-1, 1] (numpy) and, with
        `return_aux`, {'depth', 'first_voxel_id'}."""
        ori, cdir, up, f_ratio = cam_pose
        h, w = self.cam_res
        model, dev = self.model, self.device
        # the view must not depend on the padding (`scenedreamer.py:579`)
        cam_f = f_ratio * (self.res[1] - 1)
        cam_c = ((h - 1) / 2.0, (w - 1) / 2.0)
        raydirs = camera_rays(cdir, up, cam_f, cam_c, (h, w), device=dev)
        cam_ori = torch.as_tensor(ori, dtype=torch.float32, device=dev)
        vid, dep, hit = ray_voxel_intersection(
            self.voxel, cam_ori, raydirs.reshape(-1, 3), self.m,
            occupancy=self.occupancy, image_width=w)
        vid = vid.reshape(1, h, w, self.m)
        dep = dep.reshape(1, h, w, self.m, 2)
        hit = hit.reshape(1, h, w, self.m)
        raydirs = raydirs.reshape(1, h, w, 3)
        cam_ori = cam_ori[None]

        sky_avg = model.sky_color(raydirs, z).mean(dim=(1, 2), keepdim=True)
        baked = model.bake_hash(self.global_enc)

        rows = max(1, self.chunk_rays // w)
        starts = range(0, h, rows)
        # rays with any hit, per chunk: one fetch per frame
        per_row = hit[0].any(dim=-1).sum(dim=-1)                # [H]
        padded = per_row.new_zeros(len(starts) * rows)
        padded[:h] = per_row
        counts = padded.reshape(len(starts), rows).sum(dim=1).tolist()
        stats = dict(rays=h * w, hit_rays=sum(counts), chunks_sky_only=0,
                     chunks_compacted=0, chunks_full=0, field_rays=0,
                     field_points=0)
        feats, depths = [], []
        for y0, count in zip(starts, counts):
            sl = slice(y0, min(h, y0 + rows))
            n_rays = (sl.stop - y0) * w
            sky_only = self.sky_fast and count == 0
            compact_k = None
            if self.field_compact and not sky_only:
                k = -(-count // COMPACT_GRANULE) * COMPACT_GRANULE
                compact_k = k if k < n_rays else None
            out = model.render_pixels(
                vid[:, sl], dep[:, sl], hit[:, sl], raydirs[:, sl], cam_ori,
                z, self.global_enc, self.world.dims,
                num_samples=self.num_samples,
                sample_depth_clip=self.sample_depth, deterministic=True,
                sky_avg=sky_avg, baked=baked, sky_only=sky_only,
                compact_k=compact_k)
            wts = out['weights'][..., 0]                    # [1,r,W,S]
            t = out['rand_depth'][..., 0]
            tw = wts.sum(dim=-1)
            depths.append(torch.where(
                tw > 1e-6, (wts * t).sum(dim=-1) / torch.clamp(tw, min=1e-6),
                torch.full_like(tw, float('inf'))))
            feats.append(out['net_out'])
            path = 'sky_only' if sky_only else \
                'compacted' if compact_k else 'full'
            stats[f'chunks_{path}'] += 1
            field_rays = 0 if sky_only else (compact_k or n_rays)
            stats['field_rays'] += field_rays
            stats['field_points'] += field_rays * t.shape[-1]
        self.last_stats = stats
        img, _ = model.refine(torch.cat(feats, dim=1), z)
        p0 = self.pad // 2
        crop = (slice(p0, p0 + self.res[0]), slice(p0, p0 + self.res[1]))
        img = img[0][crop].cpu().numpy()
        if not return_aux:
            return img
        return img, {'depth': torch.cat(depths, dim=1)[0][crop].cpu().numpy(),
                     'first_voxel_id': vid[0][crop][..., 0].cpu().numpy()}


def render_trajectory(model, world, style, output_dir, camera_mode=0,
                      cam_maxstep=10, cam_ang=72, num_samples=40,
                      num_blocks_early_stop=6, sample_depth=3.0, pad=30,
                      resolution_hw=(540, 960), device=None):
    """Full inference: camera trajectory -> rgb_render/*.png
    (`scenedreamer.py:479-632`). Returns the rendered frames as
    [H, W, 3] float images in [-1, 1]."""
    renderer = TiledRenderer(model, world, num_samples=num_samples,
                             num_blocks_early_stop=num_blocks_early_stop,
                             sample_depth=sample_depth, pad=pad,
                             resolution_hw=resolution_hw, device=device)
    output_dir = os.path.join(output_dir, 'rgb_render')
    os.makedirs(output_dir, exist_ok=True)

    # side outputs (`scenedreamer.py:563-565`)
    sem = np.argmax(world.semantic_field[0], axis=0)
    write_png(os.path.join(output_dir, 'semantic_map.png'),
              BIOME_COLORS[sem])
    hm = world.height_field[0, 0]
    write_png(os.path.join(output_dir, 'height_map.png'),
              np.repeat((np.clip(hm, 0, 1) * 255).astype(np.uint8)
                        [..., None], 3, -1))
    style = np.asarray(style, np.float32).reshape(1, -1)
    np.save(os.path.join(output_dir, 'style.npy'), style)
    z = renderer.style_z(style)
    ctl = EvalCameraController(
        world, maxstep=cam_maxstep, pattern=camera_mode, cam_ang=cam_ang,
        smooth_decay_multiplier=150.0 / cam_maxstep)
    frames = []
    for i, pose in enumerate(ctl):
        img = renderer.frame(pose, z)
        write_png(os.path.join(output_dir, f'{i:05d}.png'), to_uint8(img))
        frames.append(img)
    return frames
