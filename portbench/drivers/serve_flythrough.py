"""Serving: back-to-back fly-through trajectories through the program's
`TiledRenderer.frame_async` in `render_trajectory`'s depth-1 pipeline.

Set-up: the world (from the benchmark's cache), the generator built on
the meta device and filled on the card from the seed, the renderer (the
world's brick occupancy and scene code), the styles, and a warm-up of
the traffic's `warmup_frames` (first kernel build and compile included).
Window: trajectory after trajectory of the traffic's poses, each with a
new style (`style_z` at the trajectory's start); frame i + 1 is queued
before frame i is fetched and turned into uint8, as `render_trajectory`
does, with no PNG or mp4 write. A frame's latency runs from its
`frame_async` call to its uint8 image on the host. The window closes at
the last frame fetched after `--seconds`; the rate is every frame over
that time. With `--trace 1`, frames `trace_from` ... + `trace_frames`
are profiled, the pipeline drained at both ends of that part.

Check: after the window, with the program freed, the plain reference
renders a sample of the window's frames drawn from the seed (always the
one with most rays with a hit) from the inputs alone; compared are the
frame (`frame_gap`: the larger of the float image's widest gap and the
expected depth's widest gap relative to the reference's depth, inf where
one is sky and the other not), the first voxel ids and the program's
count of rays with a hit (both exact). The depth alone does not tell the
control from the program on every seed (its TF32 gap read 0 on one seed
of three), the image does; the two are one served frame.
"""
import gc
import time

import numpy as np
import torch

from portbench import inputs, weights, yardstick
from portbench.reference import serve as ref


class Ctx:
    """What the serving metrics read: the window's frames (`hits` of each
    in order, latencies), the trace, and the frames and host seconds of
    the window outside the traced part (`untraced_hits`,
    `untraced_s`)."""

    def __init__(self, cfg, trace, hits, rays, lat, traced_hits,
                 untraced_hits, untraced_s):
        self.cfg, self.trace = cfg, trace
        self.hits, self.rays, self.lat = hits, rays, lat
        self.traced_hits = traced_hits
        self.untraced_hits, self.untraced_s = untraced_hits, untraced_s

    def untraced_flops(self):
        return sum(yardstick.serve_frame_flops(self.cfg, h, self.rays)[1]
                   for h in self.untraced_hits)

    def traced_flops(self, part):
        i = 0 if part == 'mlp' else 1
        return sum(yardstick.serve_frame_flops(self.cfg, h, self.rays)[i]
                   for h in self.traced_hits)

    def traced_points(self):
        return sum(self.traced_hits) * self.cfg['num_samples']


def main(run):
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                        to_uint8)
    from scenedreamer_tpu_torch.scene.voxel_world import VoxelWorld

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr, dev, seed = run.config, run.traffic, run.device, run.seed
    arrays = inputs.world_arrays(cfg, cache_dir=run.world_cache)
    run.log('world loaded')
    poses = inputs.flythrough(inputs.reference_world(arrays), tr)
    styles = inputs.styles(seed, tr['styles'], cfg['style_dims'],
                           dev).cpu().numpy()
    with torch.device('meta'):
        model = SceneDreamerGenerator(GeneratorConfig(
            **ref.generator_config(cfg)))
    model = model.to_empty(device=dev)
    weights.fill_({'gen': model}, seed, dev)
    renderer = TiledRenderer(
        model, VoxelWorld(**arrays), num_samples=cfg['num_samples'],
        num_blocks_early_stop=cfg['num_blocks_early_stop'],
        sample_depth=cfg['sample_depth'], pad=tr['pad'],
        tile_size=tr['tile_size'], resolution_hw=tuple(tr['resolution_hw']),
        device=dev, split_refine=True)
    h, w = renderer.cam_res
    frame_seed = seed % (2 ** 62)
    style = {}       # the trajectory's intermediate style

    def issue(n):
        """Queue frame n of the window: (n, materializer, start, hits)."""
        k, i = divmod(n, len(poses))
        if i == 0:
            style['z'] = renderer.style_z(styles[k % len(styles)][None])
        gen = torch.Generator(device=dev).manual_seed(frame_seed + i)
        run.mark('frame_async')
        t0 = time.perf_counter()
        mat = renderer.frame_async(poses[i], style['z'], gen,
                                   return_aux=True)
        return n, mat, t0, renderer.last_stats['hit_rays']

    frames = {}

    def emit(job, keep=True):
        n, mat, t0, hits = job
        run.mark('fetch_uint8')
        img, aux = mat()
        to_uint8(img)
        t1 = time.perf_counter()
        if keep:
            frames[n] = dict(latency=t1 - t0, hits=hits, img=np.array(img),
                             depth=np.array(aux['depth']),
                             vid=np.array(aux['first_voxel_id']))

    run.log('world, poses, weights and renderer ready')
    for n in tr['warmup_frames']:
        emit(issue(n), keep=False)
    run.setup_done()

    trace = None
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    prev, n = None, 0
    t_from, t_to = tr['trace_from'], tr['trace_from'] + tr['trace_frames']
    while True:
        if run.trace and n == t_from:
            trace = run.open_trace()
        elif trace is not None and n == t_to:
            emit(prev)
            prev = None
            run.close_trace()
            trace = None
        # a traced part started runs to its end
        if trace is None and time.perf_counter() >= deadline:
            break
        job = issue(n)
        if prev is not None:
            emit(prev)
        prev, n = job, n + 1
    if prev is not None:
        emit(prev)
    window_s = time.perf_counter() - t_start
    peak = run.memory_peak()
    run.log(f'window closed: {len(frames)} frames in {window_s:.3f} s')

    order = sorted(frames)
    lat = [frames[i]['latency'] for i in order]
    hits = [frames[i]['hits'] for i in order]
    traced = set(range(t_from, t_to)) if run.last_trace else set()
    e2e = {'frames_per_s': len(order) / window_s,
           'frame_ms_p90': float(np.percentile(lat, 90)) * 1e3,
           'peak_gb': peak / 1e9}
    ctx = Ctx(cfg, run.reduce_trace(), hits, h * w, lat,
              [frames[i]['hits'] for i in order if i in traced],
              [frames[i]['hits'] for i in order if i not in traced],
              window_s - run.traced_s)

    del renderer, model, style
    gc.collect()
    torch.cuda.empty_cache() if dev.type == 'cuda' else None
    checks = check(run, arrays, poses, styles, frames)
    run.log('check done')
    return dict(e2e=e2e, ctx=ctx, checks=checks, attempted=len(order),
                failed=0, memory_peak_bytes=peak)


def sample_frames(seed, frames, k):
    """k frames of the window drawn from the seed: the one with most rays
    with a hit, and k - 1 others."""
    order = sorted(frames)
    top = max(order, key=lambda i: frames[i]['hits'])
    rest = [i for i in order if i != top]
    rng = np.random.default_rng(weights.stream_seed(seed, 'check'))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [top] + sorted(rest[i] for i in pick)


def check(run, arrays, poses, styles, frames, reference_tf32=False):
    """The reference's readings of the sampled frames against the
    program's: [(name, value, limit)]."""
    lim, dev = run.limits, run.device
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = reference_tf32
    torch.backends.cudnn.allow_tf32 = reference_tf32
    try:
        gen = ref.build_generator(run.config, run.seed, dev)
        rr = ref.ReferenceRenderer(gen, arrays, run.config, run.traffic, dev)
        worst = dict(frame_gap=0.0, vid_mismatch=0, hit_mismatch=0)
        for n in sample_frames(run.seed, frames, run.traffic['check_frames']):
            k, i = divmod(n, len(poses))
            out = rr.frame(poses[i], rr.style_z(styles[k % len(styles)][None]))
            got = frames[n]
            worst['frame_gap'] = max(
                worst['frame_gap'],
                float(np.abs(got['img'] - out['img']).max()),
                depth_gap(got['depth'], out['depth']))
            worst['vid_mismatch'] += int((got['vid'] != out['first_voxel_id'])
                                         .sum())
            worst['hit_mismatch'] += abs(got['hits'] - out['hit_rays'])
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    return [(name, worst[name], lim[name]) for name in
            ('frame_gap', 'vid_mismatch', 'hit_mismatch')]


def depth_gap(got, want):
    """The largest gap of two expected-depth maps relative to the
    reference's depth (at least 1 voxel); inf where one is sky (inf) and
    the other is not."""
    fin_g, fin_w = np.isfinite(got), np.isfinite(want)
    if (fin_g != fin_w).any():
        return float('inf')
    if not fin_w.any():
        return 0.0
    g, w = got[fin_w], want[fin_w]
    return float((np.abs(g - w) / np.maximum(np.abs(w), 1.0)).max())
