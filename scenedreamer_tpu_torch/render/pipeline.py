"""Trajectory rendering: scene -> camera path -> frames -> video.

Counterpart of `scenedreamer_tpu/render/pipeline.py` (reference
`imaginaire/generators/scenedreamer.py:479-632` inference_givenstyle).
Per frame:
  1. camera rays and the full-frame DDA (kernel K1 on CUDA, with the
     world's brick occupancy built once per renderer);
  2. one frame-global sky average (`pipeline.py:165-169`);
  3. the hash table baked once for the world's scene code (K2 (a), or
     K5 (a) on the paired spec; a spec that is not foldable has no bake
     and encodes unfolded, K4), shared by every field call of the frame;
  4. the field and the RenderCNN by one of JAX's three routes:
     * split refine (the default; SCENEDREAMER_SPLIT_REFINE, '1' unless
       set): the pointwise field (depth samples -> hash encode (K2 (b),
       K5 (b) or K4) -> RenderMLP -> compositing) over chunks of image
       rows, sized to keep activations a few GB. One fetch per frame
       brings the count of rays with any hit in each chunk
       (`pipeline.py:431-448`): a chunk with none skips the field
       (`render_pixels(sky_only=True)`, the `sky_fast` path), any other
       runs it on only its first K rays after a hits-first sort
       (`render_pixels(compact_k=K)`, switched by
       SCENEDREAMER_FIELD_COMPACT, default '1'), both exact. Then one
       RenderCNN over the stitched feature map, or, above
       SCENEDREAMER_REFINE_FULL_PX rays (1,400,000), over full-width
       windows of SCENEDREAMER_REFINE_STRIP rows (256) plus an 8-row halo
       each side (the CNN sees 4 rows each way), clamped into the frame,
       of which only the kept rows are written (`pipeline.py:506-541`);
     * padded tiles (`split_refine=False`, the reference's loop,
       `pipeline.py:678-775`): tiles of tile_size + pad on the grid
       range(0, res, tile_size), each clamped into the frame; field and
       CNN on stacked batches of `tiles_per_batch` tiles (a short last
       group repeats its last tile), each tile cropped by pad // 2 and
       stitched. With one tile per batch, one fetch per frame of the
       per-tile any-hit flags sends pure-sky tiles to `sky_only`;
     * full frame (`tile_size=None`, or, without split refine, a padded
       tile that does not fit the frame): one padded call
       (`pipeline.py:651-672`; JAX also takes it for split refine when
       the tile covers the frame, a choice of compiled programs: here
       split refine runs whenever it is on and `tile_size` is set, the
       two routes' images equal to conv rounding);
  5. the pad crop; expected depth sum(w t) / sum(w), inf for sky
     (`pipeline.py:182-192`).

`frame_async` queues a frame's device work and returns its materializer;
on CUDA the frame's copies to pinned host memory are queued with it and
the materializer waits on their event only. `render_trajectory` queues
frame i + 1 before it writes frame i's PNG, mp4 frame and depth outputs
(the depth-1 pipeline of `pipeline.py:863-878`); the host blocks on the
next frame's hit counts first, so what overlaps is frame i's writes with
frame i + 1's field.

Not here: `export_tile` (a `torch.export` artifact needs the forward
kernels registered as `torch.library` ops) and the mesh path
(`--mesh_tiles`, multi-GPU). JAX's `field_tiles_per_batch` and
`ray_voxel_intersection(chunk='auto')` have no counterpart: they cut
dispatches over a remote TPU link and programs that would run for
minutes; the split path here runs image-row chunks and K1 runs a frame
in one launch.
"""
import os
import time

import numpy as np
import torch

from scenedreamer_tpu_torch.device import resolve_device
from scenedreamer_tpu_torch.ops.ray_voxel import (build_occupancy_bits,
                                                  camera_rays,
                                                  ray_voxel_intersection)
from scenedreamer_tpu_torch.scene.camera import EvalCameraController
from scenedreamer_tpu_torch.scene.labels import get_label_translator
from scenedreamer_tpu_torch.utils.png import write_png
from scenedreamer_tpu_torch.utils.visualization import colormap

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
# rows of halo above and below a RenderCNN strip (>= its 4-row reach)
STRIP_HALO = 8


def to_uint8(img):
    """[-1, 1] float -> uint8 RGB."""
    return np.clip((np.asarray(img) * 0.5 + 0.5) * 255, 0,
                   255).astype(np.uint8)


def grid_coords(extent, s):
    """Starts of non-overlapping s-long pieces covering [0, extent); the
    last is shifted back into range."""
    cs = list(range(0, extent - s + 1, s))
    if not cs or cs[-1] + s < extent:
        cs.append(extent - s)
    return cs


def expected_depth(out):
    """sum(w t) / sum(w) per ray of a `render_pixels` result, inf where
    the weights vanish (sky)."""
    wts = out['weights'][..., 0]
    t = out['rand_depth'][..., 0]
    tw = wts.sum(dim=-1)
    return torch.where(tw > 1e-6,
                       (wts * t).sum(dim=-1) / torch.clamp(tw, min=1e-6),
                       torch.full_like(tw, float('inf')))


class VideoWriter:
    """mp4 (`mp4v`) through OpenCV; RGB frames are written in BGR order.
    Raises when OpenCV cannot open the file, so a missing codec fails the
    run instead of leaving an empty .mp4."""

    def __init__(self, path, fps=10):
        self.path = path
        self.fps = fps
        self._w = None

    def append(self, img_uint8):
        import cv2
        if self._w is None:
            h, w = img_uint8.shape[:2]
            self._w = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*'mp4v'), self.fps,
                (w, h))
            if not self._w.isOpened():
                raise RuntimeError(f'cv2.VideoWriter cannot open '
                                   f'{self.path} with the mp4v codec')
        self._w.write(np.ascontiguousarray(img_uint8[..., ::-1]))

    def close(self):
        if self._w is not None:
            self._w.release()


class TiledRenderer:
    """Renders frames of one world with fixed inference settings.

    `model` is a `SceneDreamerGenerator` (moved to `device`); `device`
    defaults to CUDA and raises without it unless 'cpu' is passed.
    `split_refine` None reads SCENEDREAMER_SPLIT_REFINE; `tile_size` and
    `tiles_per_batch` shape the padded-tile route (see the module
    docstring). `sky_fast`: field chunks, or single padded tiles, where
    no ray hits skip the field. The environment variables are read here,
    in the constructor. `last_stats` holds the last frame's rays, rays
    with a hit and, per route, its chunks or tiles by path and the
    field's rays and points.
    """

    def __init__(self, model, world, num_samples=40,
                 num_blocks_early_stop=6, sample_depth=3.0, pad=30,
                 tile_size=128, resolution_hw=(540, 960),
                 chunk_rays=CHUNK_RAYS, device=None, sky_fast=True,
                 tiles_per_batch=1, split_refine=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.world = world
        self.num_samples = num_samples
        self.m = num_blocks_early_stop
        self.sample_depth = sample_depth
        self.pad = pad
        self.tile = tile_size
        self.tiles_per_batch = max(1, tiles_per_batch)
        self.res = tuple(resolution_hw)
        self.cam_res = (self.res[0] + pad, self.res[1] + pad)
        self.chunk_rays = chunk_rays
        self.sky_fast = sky_fast
        if split_refine is None:
            split_refine = os.environ.get(
                'SCENEDREAMER_SPLIT_REFINE', '1') == '1'
        self.split_refine = split_refine
        self.field_compact = os.environ.get(
            'SCENEDREAMER_FIELD_COMPACT', '1') == '1'
        h = self.cam_res[0]
        self.strip_rows = max(8, min(
            int(os.environ.get('SCENEDREAMER_REFINE_STRIP', '256')),
            h - 2 * STRIP_HALO))
        self.refine_full = (
            self.cam_res[0] * self.cam_res[1]
            <= int(os.environ.get('SCENEDREAMER_REFINE_FULL_PX', '1400000'))
            or self.strip_rows + 2 * STRIP_HALO > h)
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

    def frame(self, cam_pose, z, generator=None, return_aux=False):
        """Render one frame. cam_pose = (ori, dir, up, f_ratio) in the
        world's local frame (EvalCameraController convention). Returns
        the [H, W, 3] float image in [-1, 1] (numpy) and, with
        `return_aux`, {'depth', 'first_voxel_id'}."""
        return self.frame_async(cam_pose, z, generator, return_aux)()

    @torch.no_grad()
    def frame_async(self, cam_pose, z, generator=None, return_aux=False):
        """Queue all of one frame's device work; returns a zero-argument
        materializer giving `frame`'s result. `generator` is the
        `torch.Generator` of the frame's stratified draws (none are drawn
        here: the renderer samples deterministically)."""
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
        f = dict(vid=vid.reshape(1, h, w, self.m),
                 dep=dep.reshape(1, h, w, self.m, 2),
                 hit=hit.reshape(1, h, w, self.m),
                 raydirs=raydirs.reshape(1, h, w, 3), cam_ori=cam_ori[None],
                 z=z, generator=generator)
        f['sky_avg'] = model.sky_color(f['raydirs'], z).mean(
            dim=(1, 2), keepdim=True)
        f['baked'] = model.bake_hash(self.global_enc)

        tile_in = self.tile + self.pad if self.tile else None
        if tile_in is not None and self.split_refine:
            img, depth = self._frame_split(f)
        elif tile_in is None or tile_in > h or tile_in > w:
            img, depth = self._frame_full(f)
        else:
            img, depth = self._frame_tiles(f, tile_in)
        vid0 = self._crop(f['vid'][0])[..., 0] if return_aux else None
        fetch = self._to_host(img, depth if return_aux else None, vid0)

        def materialize():
            img_h, depth_h, vid_h = fetch()
            if not return_aux:
                return img_h
            return img_h, {'depth': depth_h, 'first_voxel_id': vid_h}
        return materialize

    def _to_host(self, *tensors):
        """Queue the copies of `tensors` (None passes through) to the
        host; returns the function that waits for them and gives numpy
        arrays. On CUDA they go to pinned memory without blocking, and an
        event recorded after them is all the host waits on."""
        if self.device.type != 'cuda':
            arrays = [None if t is None else t.contiguous().numpy()
                      for t in tensors]
            return lambda: arrays
        bufs = []
        for t in tensors:
            if t is None:
                bufs.append(None)
                continue
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            bufs.append(buf)
        done = torch.cuda.Event()
        done.record()

        def fetch():
            done.synchronize()
            return [None if b is None else b.numpy() for b in bufs]
        return fetch

    def _render(self, f, sl=slice(None), sky_only=False, compact_k=None,
                coords=None, tile_in=None):
        """`render_pixels` on the frame's rows `sl` or, with `coords`, on
        the stacked [len(coords), tile_in, tile_in] tiles at those
        starts (the per-frame operands broadcast to the batch)."""
        if coords is None:
            def take(a):
                return a[:, sl]
            b = 1
        else:
            def take(a):
                return torch.cat([a[:, y0:y0 + tile_in, x0:x0 + tile_in]
                                  for y0, x0 in coords])
            b = len(coords)

        def bcast(a):
            return a.expand((b,) + a.shape[1:])
        baked = None if f['baked'] is None else f['baked'] * b
        return self.model.render_pixels(
            take(f['vid']), take(f['dep']), take(f['hit']),
            take(f['raydirs']), bcast(f['cam_ori']), bcast(f['z']),
            bcast(self.global_enc), self.world.dims,
            num_samples=self.num_samples,
            sample_depth_clip=self.sample_depth, deterministic=True,
            sky_avg=bcast(f['sky_avg']), baked=baked, sky_only=sky_only,
            generator=f['generator'], compact_k=compact_k)

    def _crop(self, x):
        p0 = self.pad // 2
        return x[p0:p0 + self.res[0], p0:p0 + self.res[1]]

    def _frame_full(self, f):
        """One padded full-frame call."""
        out = self._render(f)
        img, _ = self.model.refine(out['net_out'], f['z'])
        h, w = self.cam_res
        self.last_stats = dict(rays=h * w, field_rays=h * w,
                               field_points=out['rand_depth'][..., 0].numel())
        return self._crop(img[0]), self._crop(expected_depth(out)[0])

    def _frame_split(self, f):
        """Split-refine frame: the field over row chunks, then the
        RenderCNN over the stitched feature map."""
        h, w = self.cam_res
        rows = max(1, self.chunk_rays // w)
        starts = range(0, h, rows)
        # rays with any hit, per chunk: one fetch per frame
        per_row = f['hit'][0].any(dim=-1).sum(dim=-1)          # [H]
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
            out = self._render(f, sl, sky_only=sky_only,
                               compact_k=compact_k)
            depths.append(expected_depth(out))
            feats.append(out['net_out'])
            path = 'sky_only' if sky_only else \
                'compacted' if compact_k else 'full'
            stats[f'chunks_{path}'] += 1
            field_rays = 0 if sky_only else (compact_k or n_rays)
            stats['field_rays'] += field_rays
            stats['field_points'] += field_rays * out['rand_depth'].shape[-2]
        self.last_stats = stats
        img = self._refine(torch.cat(feats, dim=1), f['z'])
        return self._crop(img), self._crop(torch.cat(depths, dim=1)[0])

    def _refine(self, feats, z):
        """RenderCNN over the stitched [1, H, W, C] feature map -> the
        [H, W, 3] image: whole, or in halo'd full-width row strips."""
        if self.refine_full:
            return self.model.refine(feats, z)[0][0]
        h, st = feats.shape[1], self.strip_rows
        win = st + 2 * STRIP_HALO
        img = torch.empty((h, feats.shape[2], 3), dtype=torch.float32,
                          device=feats.device)
        for y0 in grid_coords(h, st):
            w0 = min(max(y0 - STRIP_HALO, 0), h - win)
            strip, _ = self.model.refine(feats[:, w0:w0 + win], z)
            img[y0:y0 + st] = strip[0, y0 - w0:y0 - w0 + st]
        return img

    def _frame_tiles(self, f, tile_in):
        """Padded-tile frame: field and CNN per stacked batch of tiles,
        cropped and stitched."""
        h, w = self.cam_res
        t, tb, p0 = self.tile, self.tiles_per_batch, self.pad // 2
        coords = [(min(y0, h - tile_in), min(x0, w - tile_in))
                  for y0 in range(0, self.res[0], t)
                  for x0 in range(0, self.res[1], t)]
        flags = None
        if self.sky_fast and tb == 1:
            # any hit per tile: one fetch per frame routes pure-sky tiles
            hit_any = f['hit'][0].any(dim=-1)
            flags = torch.stack([hit_any[y0:y0 + tile_in,
                                         x0:x0 + tile_in].any()
                                 for y0, x0 in coords]).tolist()
        img = torch.empty(self.res + (3,), dtype=torch.float32,
                          device=self.device)
        depth = torch.empty(self.res, dtype=torch.float32,
                            device=self.device)
        stats = dict(rays=h * w, tiles=len(coords), tiles_sky_only=0,
                     batches=0, field_rays=0, field_points=0)
        for s in range(0, len(coords), tb):
            group = coords[s:s + tb]
            full = group + [group[-1]] * (tb - len(group))
            sky_only = flags is not None and not flags[s]
            out = self._render(f, sky_only=sky_only, coords=full,
                               tile_in=tile_in)
            tiles, _ = self.model.refine(
                out['net_out'], f['z'].expand((tb,) + f['z'].shape[1:]))
            dexp = expected_depth(out)
            for i, (y0, x0) in enumerate(group):
                img[y0:y0 + t, x0:x0 + t] = tiles[i, p0:p0 + t, p0:p0 + t]
                depth[y0:y0 + t, x0:x0 + t] = dexp[i, p0:p0 + t, p0:p0 + t]
            stats['batches'] += 1
            stats['tiles_sky_only'] += int(sky_only)
            if not sky_only:
                stats['field_rays'] += tb * tile_in * tile_in
                stats['field_points'] += out['rand_depth'][..., 0].numel()
        self.last_stats = stats
        return img, depth


def render_trajectory(model, world, style, output_dir, camera_mode=0,
                      cam_maxstep=10, cam_ang=72, num_samples=40,
                      num_blocks_early_stop=6, sample_depth=3.0, pad=30,
                      tile_size=128, resolution_hw=(540, 960), fps=10,
                      seed=1, write_frames=True, save_depth=False, mesh=None,
                      tiles_per_batch=1, split_refine=None, device=None,
                      timings=None):
    """Full inference: camera trajectory -> rgb_render/*.png and
    rgb_render.mp4 (`scenedreamer.py:479-632`). A style [F, style_dims]
    with F > 1 renders frame i with row min(i, F - 1). `save_depth` also
    writes <i>_depth.png (the depth colormap) and <i>_voxel.png (the
    first voxel's Minecraft color). Frame i gets a `torch.Generator`
    seeded seed + i. `timings`, a list, receives per frame the seconds
    spent queueing it, waiting for its copy and writing its outputs.
    Returns the frames as [H, W, 3] uint8."""
    if mesh is not None:
        raise NotImplementedError(
            'tiles over several devices (--mesh_tiles) are not ported: '
            'ROADMAP.md Queue 1 item 3, multi-GPU')
    renderer = TiledRenderer(model, world, num_samples=num_samples,
                             num_blocks_early_stop=num_blocks_early_stop,
                             sample_depth=sample_depth, pad=pad,
                             tile_size=tile_size,
                             resolution_hw=resolution_hw, device=device,
                             tiles_per_batch=tiles_per_batch,
                             split_refine=split_refine)
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
    style = np.asarray(style, np.float32)
    style = style.reshape(1, -1) if style.ndim == 1 else style
    np.save(os.path.join(output_dir, 'style.npy'), style)
    # style interpolation: frame i renders with its own row
    zs = [renderer.style_z(style[i:i + 1]) for i in range(style.shape[0])]
    ctl = EvalCameraController(
        world, maxstep=cam_maxstep, pattern=camera_mode, cam_ang=cam_ang,
        smooth_decay_multiplier=150.0 / cam_maxstep)

    video = VideoWriter(output_dir + '.mp4', fps=fps)
    frames = []

    def emit(i, materialize, queue_s):
        t0 = time.perf_counter()
        result = materialize()
        t1 = time.perf_counter()
        img, aux = result if save_depth else (result, None)
        rgb = to_uint8(img)
        if write_frames:
            write_png(os.path.join(output_dir, f'{i:05d}.png'), rgb)
        if save_depth:
            # depth colormap and first-hit voxel shading
            # (`scenedreamer.py:636-851`)
            d = aux['depth'].copy()
            d[~np.isfinite(d)] = np.nan
            write_png(os.path.join(output_dir, f'{i:05d}_depth.png'),
                      (colormap(d) * 255).astype(np.uint8))
            write_png(os.path.join(output_dir, f'{i:05d}_voxel.png'),
                      get_label_translator().mc_color(aux['first_voxel_id']))
        video.append(rgb)
        frames.append(rgb)
        if timings is not None:
            timings.append(dict(queue_s=queue_s, wait_s=t1 - t0,
                                write_s=time.perf_counter() - t1))

    # depth-1 pipeline: frame i + 1 is queued before frame i is written
    prev = None
    for i, pose in enumerate(ctl):
        gen = torch.Generator(device=renderer.device).manual_seed(seed + i)
        t0 = time.perf_counter()
        mat = renderer.frame_async(pose, zs[min(i, len(zs) - 1)], gen,
                                   return_aux=save_depth)
        queued = (i, mat, time.perf_counter() - t0)
        if prev is not None:
            emit(*prev)
        prev = queued
    if prev is not None:
        emit(*prev)
    video.close()
    return frames
