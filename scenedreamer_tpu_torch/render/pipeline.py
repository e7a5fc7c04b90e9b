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

Mesh mode (`mesh`, a list of devices: JAX's mesh over `jax.devices()`,
`pipeline.py:80-126, 304-364, 683-710`; the CLI's `--mesh_tiles`) runs
the padded-tile route over several devices from one process: each device
holds a replica of the generator, and the frame's tiles are dealt to the
devices in contiguous blocks, the tiles with a hit first, then, with
`sky_fast`, the pure-sky ones on the sky-only route; each device runs
its block through the padded-tile program, `tiles_per_batch` tiles a
call, and the tiles come back to the first device, which holds the
frame. The DDA, the sky average and the bake run once per frame on the
first device. Split refine is off in mesh mode, as in JAX.

The serving artifact (`export_tile`, `load_exported`,
`pipeline.py:543-615`): JAX's padded-tile program, `TileProgram` (the
hash table baked from the scene code inside, `render_pixels` with
deterministic sampling, the RenderCNN, the expected depth, the pad // 2
crop), exported with `torch.export` at the renderer's fixed shapes and
saved with its weights. A serving process loads it and calls it with no
model code: it imports only the registration of the hash ops and of
the RenderMLP's hidden layer (`ops/hash_ops.py`, `ops/mlp_ops.py`,
through this module), whose kernels the program names and launches on
CUDA. `render_tile` runs the same program live.

JAX's `field_tiles_per_batch` and `ray_voxel_intersection(chunk='auto')`
have no counterpart: they cut dispatches over a remote TPU link and
programs that would run for minutes; the split path here runs image-row
chunks and K1 runs a frame in one launch.
"""
import copy
import io
import os
import time

import numpy as np
import torch

from scenedreamer_tpu_torch.device import resolve_device
# the sd:: ops a loaded tile program names
from scenedreamer_tpu_torch.ops import hash_ops, mlp_ops  # noqa: F401
from scenedreamer_tpu_torch.ops.ray_voxel import (build_occupancy_bits,
                                                  camera_rays,
                                                  ray_voxel_intersection)
from scenedreamer_tpu_torch.scene.camera import EvalCameraController
from scenedreamer_tpu_torch.scene.labels import get_label_translator
from scenedreamer_tpu_torch.utils.png import write_png
from scenedreamer_tpu_torch.utils.profiling import (begin_unit, span,
                                                   upload)
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
# the generator's modules that the tile program runs; its weights are
# theirs (not the world or style encoder's, nor the style MLP's)
TILE_MODULES = ('hash_encoder', 'render_net', 'sky_net', 'denoiser')


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


class TileProgram(torch.nn.Module):
    """JAX's `tile_fn` (`pipeline.py:171-193`) for one batch of padded
    tiles: `render_pixels(deterministic=True, sky_avg=...)` with the
    hash table baked from `global_enc` inside (K2 (a) or K5 (a); none
    for a spec that is not foldable, which encodes unfolded, K4), the
    RenderCNN, the expected depth and the pad // 2 crop. Holds the
    generator with only TILE_MODULES (sharing their parameters), so an
    export carries only the weights the tile runs.

    forward(voxel_id [b, t, t, M] int32, depth [b, t, t, M, 2], hit
    [b, t, t, M] bool, raydirs [b, t, t, 3], cam_ori [b, 3], z [b, S],
    global_enc [b, 2], sky_avg [b, 1, 1, 1, C]) -> (img [b, t', t', 3],
    depth [b, t', t']), t' = t - 2 (pad // 2)."""

    def __init__(self, model, voxel_dims, num_samples, sample_depth, pad):
        super().__init__()
        gen = copy.copy(model)
        gen._modules = {k: v for k, v in model._modules.items()
                        if k in TILE_MODULES}
        self.gen = gen
        self.voxel_dims = tuple(int(d) for d in voxel_dims)
        self.num_samples, self.sample_depth = num_samples, sample_depth
        self.pad = pad

    def forward(self, voxel_id, depth, hit, raydirs, cam_ori, z, global_enc,
                sky_avg):
        out = self.gen.render_pixels(
            voxel_id, depth, hit, raydirs, cam_ori, z, global_enc,
            self.voxel_dims, num_samples=self.num_samples,
            sample_depth_clip=self.sample_depth, deterministic=True,
            sky_avg=sky_avg)
        img, _ = self.gen.refine(out['net_out'], z)
        p0 = self.pad // 2
        h, w = img.shape[1:3]
        return (img[:, p0:h - p0, p0:w - p0],
                expected_depth(out)[:, p0:h - p0, p0:w - p0])


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
    docstring). `mesh`, a list of devices, deals the padded tiles over
    them (mesh mode: split refine off; the frame is held on the first,
    which `device`, when given, must be). `sky_fast`: field chunks, or
    padded tiles, where no ray hits skip the field. The environment variables are read here,
    in the constructor. `last_stats` holds the last frame's rays, rays
    with a hit and, per route, its chunks or tiles by path and the
    field's rays and points.
    """

    def __init__(self, model, world, num_samples=40,
                 num_blocks_early_stop=6, sample_depth=3.0, pad=30,
                 tile_size=128, resolution_hw=(540, 960),
                 chunk_rays=CHUNK_RAYS, device=None, sky_fast=True,
                 tiles_per_batch=1, split_refine=None, mesh=None):
        self.mesh = None if mesh is None else [resolve_device(d)
                                               for d in mesh]
        if self.mesh:
            if device is not None and resolve_device(device) != \
                    self.mesh[0]:
                raise ValueError(f'device {device} is not the mesh\'s '
                                 f'first device {self.mesh[0]}')
            device = self.mesh[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # one generator replica per further device of the mesh
        self.replicas = {self.device: self.model}
        for dev in self.mesh or ():
            if dev not in self.replicas:
                self.replicas[dev] = copy.deepcopy(self.model).to(dev)
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
        self.split_refine = split_refine and not self.mesh
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
        self.tile_program = TileProgram(self.model, world.dims, num_samples,
                                        sample_depth, pad)
        self.last_export = None

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
    def rays(self, cam_pose):
        """One padded frame's camera rays and their DDA (K1 on CUDA), as
        a dict of vid [1, h, w, M] int32, dep [1, h, w, M, 2], hit
        [1, h, w, M] bool, raydirs [1, h, w, 3] and cam_ori [1, 3]."""
        ori, cdir, up, f_ratio = cam_pose
        h, w = self.cam_res
        # the view must not depend on the padding (`scenedreamer.py:579`)
        cam_f = f_ratio * (self.res[1] - 1)
        cam_c = ((h - 1) / 2.0, (w - 1) / 2.0)
        raydirs = camera_rays(cdir, up, cam_f, cam_c, (h, w),
                              device=self.device)
        cam_ori = upload(ori, self.device, torch.float32, 'camera')
        vid, dep, hit = ray_voxel_intersection(
            self.voxel, cam_ori, raydirs.reshape(-1, 3), self.m,
            occupancy=self.occupancy, image_width=w)
        return dict(vid=vid.reshape(1, h, w, self.m),
                    dep=dep.reshape(1, h, w, self.m, 2),
                    hit=hit.reshape(1, h, w, self.m),
                    raydirs=raydirs.reshape(1, h, w, 3),
                    cam_ori=cam_ori[None])

    @torch.no_grad()
    def sky_avg(self, raydirs, z):
        """The frame-global sky average [B, 1, 1, 1, C] of rays
        raydirs [B, H, W, 3] (`pipeline.py:165-169`), in the model's
        dtype: the tile program's `sky_avg`."""
        return self.model.sky_color(raydirs, z).mean(dim=(1, 2),
                                                     keepdim=True)

    @torch.no_grad()
    def render_tile(self, voxel_id, depth, hit, raydirs, cam_ori, z,
                    global_enc, sky_avg):
        """The padded-tile program (`TileProgram`, JAX's `tile_fn`) run
        live on the renderer's device -> (img, depth)."""
        return self.tile_program(voxel_id, depth, hit, raydirs, cam_ori, z,
                                 global_enc, sky_avg)

    def export_tile(self, z, path=None, batch=None):
        """Serialize the padded-tile program with `torch.export` at this
        renderer's fixed shapes, on its device, with the weights it runs.
        `z` is an example intermediate style (`style_z`'s output), which
        fixes the style's shape and dtype; `batch` the tiles per call,
        else `tiles_per_batch` when the renderer is tiled (tile + pad
        below the padded frame's longer side), else 1 for the full frame.
        The program takes JAX's inputs in JAX's order (`TileProgram`;
        `global_enc` in the world code's dtype, `sky_avg` in the model's)
        and bakes the hash table from `global_enc` inside. Returns the
        bytes of `torch.export.save`, also written to `path` when given;
        `last_export` holds the export and save seconds and the size.
        JAX's `params` and `key` arguments have no counterpart: the
        weights ride in the artifact and deterministic sampling draws
        nothing. JAX's `platforms` has none either: the program is for
        this renderer's device (its kernels on CUDA)."""
        t = self.tile + self.pad if self.tile else None
        tiled = t is not None and t < max(self.cam_res)
        h, w = (t, t) if tiled else self.cam_res
        b = batch or (self.tiles_per_batch if tiled else 1)
        dev, m = self.device, self.m

        def rows(x):
            return x[:1].expand((b,) + x.shape[1:]).contiguous()
        raydirs = torch.zeros((b, h, w, 3), device=dev)
        args = (torch.zeros((b, h, w, m), dtype=torch.int32, device=dev),
                torch.zeros((b, h, w, m, 2), device=dev),
                torch.zeros((b, h, w, m), dtype=torch.bool, device=dev),
                raydirs, torch.zeros((b, 3), device=dev), rows(z),
                rows(self.global_enc),
                rows(self.sky_avg(raydirs[:1], z[:1])))
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(self.tile_program, args,
                                          strict=False)
        t1 = time.perf_counter()
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blob = buf.getvalue()
        self.last_export = dict(export_s=t1 - t0,
                                save_s=time.perf_counter() - t1,
                                bytes=len(blob))
        if path:
            with open(path, 'wb') as f:
                f.write(blob)
        return blob

    @staticmethod
    def load_exported(blob_or_path):
        """An `export_tile` artifact (bytes or a path) -> the tile program
        as a callable of its inputs giving (img, depth), its weights on
        the device it was exported for. Needs the `sd::` ops, which
        importing this module registers, and no model code."""
        blob = blob_or_path
        if isinstance(blob, (str, os.PathLike)):
            with open(blob, 'rb') as f:
                blob = f.read()
        module = torch.export.load(io.BytesIO(blob)).module()
        for p in module.parameters():
            p.requires_grad_(False)
        return module

    @torch.no_grad()
    def frame_async(self, cam_pose, z, generator=None, return_aux=False):
        """Queue all of one frame's device work; returns a zero-argument
        materializer giving `frame`'s result. `generator` is the
        `torch.Generator` of the frame's stratified draws (none are drawn
        here: the renderer samples deterministically). One frame unit of
        the recorder (`utils/profiling.py`): spans `render.rays`,
        `render.sky_avg`, `render.bake`, then the route's (split refine:
        `render.hit_counts`, a read, `render.field_chunk` tagged with
        its path, `render.refine`), `render.to_host`; the materializer's
        wait is `render.fetch`, a read of the same frame."""
        with begin_unit('frame', 'render.frame') as frame:
            h, w = self.cam_res
            model = self.model
            with span('render.rays'):
                f = dict(self.rays(cam_pose), z=z, generator=generator,
                         model=model, global_enc=self.global_enc)
            with span('render.sky_avg'):
                f['sky_avg'] = self.sky_avg(f['raydirs'], z)
            with span('render.bake'):
                f['baked'] = model.bake_hash(self.global_enc)

            tile_in = self.tile + self.pad if self.tile else None
            if tile_in is not None and self.split_refine:
                img, depth = self._frame_split(f)
            elif tile_in is None or tile_in > h or tile_in > w:
                img, depth = self._frame_full(f)
            else:
                img, depth = self._frame_tiles(f, tile_in)
            with span('render.to_host'):
                vid0 = self._crop(f['vid'][0])[..., 0] if return_aux \
                    else None
                bufs, done = self._to_host(
                    img, depth if return_aux else None, vid0)
        unit = frame.unit

        def materialize():
            with span('render.fetch', kind='read', reads=bufs, unit=unit):
                if done is not None:
                    done.synchronize()
            img_h, depth_h, vid_h = [None if b is None else b.numpy()
                                     for b in bufs]
            if not return_aux:
                return img_h
            return img_h, {'depth': depth_h, 'first_voxel_id': vid_h}
        return materialize

    def _to_host(self, *tensors):
        """Queue the copies of `tensors` (None passes through) to host
        tensors; returns them and the event to wait on before reading
        them (None on the CPU, where they are the tensors themselves). On
        CUDA they go to pinned memory without blocking, and an event
        recorded after them is all the host waits on."""
        if self.device.type != 'cuda':
            return [None if t is None else t.contiguous()
                    for t in tensors], None
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
        return bufs, done

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
        return f['model'].render_pixels(
            take(f['vid']), take(f['dep']), take(f['hit']),
            take(f['raydirs']), bcast(f['cam_ori']), bcast(f['z']),
            bcast(f['global_enc']), self.world.dims,
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
        hits = padded.reshape(len(starts), rows).sum(dim=1)
        with span('render.hit_counts', kind='read', reads=hits):
            counts = hits.tolist()
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
            path = 'sky_only' if sky_only else \
                'compacted' if compact_k else 'full'
            with span('render.field_chunk', tag=path):
                out = self._render(f, sl, sky_only=sky_only,
                                   compact_k=compact_k)
                depths.append(expected_depth(out))
            feats.append(out['net_out'])
            stats[f'chunks_{path}'] += 1
            field_rays = 0 if sky_only else (compact_k or n_rays)
            stats['field_rays'] += field_rays
            stats['field_points'] += field_rays * out['rand_depth'].shape[-2]
        self.last_stats = stats
        with span('render.refine'):
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
        cropped and stitched; in mesh mode the batches of each device's
        block run on that device's replica."""
        h, w = self.cam_res
        t, tb, p0 = self.tile, self.tiles_per_batch, self.pad // 2
        coords = [(min(y0, h - tile_in), min(x0, w - tile_in))
                  for y0 in range(0, self.res[0], t)
                  for x0 in range(0, self.res[1], t)]
        flags = None
        if self.sky_fast and (tb == 1 or self.mesh):
            # any hit per tile: one fetch per frame routes pure-sky tiles
            hit_any = f['hit'][0].any(dim=-1)
            flags = torch.stack([hit_any[y0:y0 + tile_in,
                                         x0:x0 + tile_in].any()
                                 for y0, x0 in coords])
            with span('render.hit_counts', kind='read', reads=flags):
                flags = flags.tolist()
        if self.mesh:
            jobs = self._mesh_jobs(coords, flags)
        else:
            jobs = [(self.device, coords[s:s + tb],
                     flags is not None and not flags[s])
                    for s in range(0, len(coords), tb)]
        img = torch.empty(self.res + (3,), dtype=torch.float32,
                          device=self.device)
        depth = torch.empty(self.res, dtype=torch.float32,
                            device=self.device)
        stats = dict(rays=h * w, tiles=len(coords), tiles_sky_only=0,
                     batches=0, field_rays=0, field_points=0)
        frames = {self.device: f}
        pieces = []
        for dev, group, sky_only in jobs:
            if dev not in frames:
                frames[dev] = self._frame_on(f, dev)
            fd = frames[dev]
            full = group + [group[-1]] * (tb - len(group))
            out = self._render(fd, sky_only=sky_only, coords=full,
                               tile_in=tile_in)
            tiles, _ = fd['model'].refine(
                out['net_out'], fd['z'].expand((tb,) + fd['z'].shape[1:]))
            pieces.append((group, tiles, expected_depth(out)))
            stats['batches'] += 1
            stats['tiles_sky_only'] += len(group) if sky_only else 0
            if not sky_only:
                stats['field_rays'] += tb * tile_in * tile_in
                stats['field_points'] += out['rand_depth'][..., 0].numel()
        # every device's work is queued before the first copy back
        for group, tiles, dexp in pieces:
            tiles, dexp = tiles.to(self.device), dexp.to(self.device)
            for i, (y0, x0) in enumerate(group):
                img[y0:y0 + t, x0:x0 + t] = tiles[i, p0:p0 + t, p0:p0 + t]
                depth[y0:y0 + t, x0:x0 + t] = dexp[i, p0:p0 + t, p0:p0 + t]
        self.last_stats = stats
        return img, depth

    def _mesh_jobs(self, coords, flags):
        """(device, tiles, sky_only) per call of mesh mode: the tiles
        with a hit, then (with the flags) the pure-sky ones, each group
        dealt to the mesh's devices in contiguous blocks (JAX shards each
        group over the mesh), each block cut into calls of
        `tiles_per_batch`."""
        groups = [(coords, False)]
        if flags is not None:
            groups = [(g, sky) for g, sky in (
                ([c for c, fl in zip(coords, flags) if fl], False),
                ([c for c, fl in zip(coords, flags) if not fl], True)) if g]
        n, tb = len(self.mesh), self.tiles_per_batch
        jobs = []
        for group, sky in groups:
            per = -(-len(group) // n)
            for i, dev in enumerate(self.mesh):
                block = group[i * per:(i + 1) * per]
                jobs += [(dev, block[s:s + tb], sky)
                         for s in range(0, len(block), tb)]
        return jobs

    def _frame_on(self, f, dev):
        """The frame's operands `f` on device `dev`, with its replica."""
        def move(x):
            if torch.is_tensor(x):
                return x.to(dev)
            if isinstance(x, list):
                return [move(v) for v in x]
            if isinstance(x, tuple):               # FoldedTable
                return type(x)._make(move(v) for v in x)
            return x
        out = {k: move(v) for k, v in f.items()
               if k not in ('model', 'generator')}
        gen = f['generator']
        out['generator'] = None if gen is None else torch.Generator(
            device=dev).manual_seed(gen.initial_seed())
        out['model'] = self.replicas[dev]
        return out


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
    `mesh`, a list of devices: mesh mode (`TiledRenderer`). Returns the
    frames as [H, W, 3] uint8."""
    renderer = TiledRenderer(model, world, num_samples=num_samples,
                             num_blocks_early_stop=num_blocks_early_stop,
                             sample_depth=sample_depth, pad=pad,
                             tile_size=tile_size,
                             resolution_hw=resolution_hw, device=device,
                             tiles_per_batch=tiles_per_batch,
                             split_refine=split_refine, mesh=mesh)
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
