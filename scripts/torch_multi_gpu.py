#!/usr/bin/env python3
"""The port on every visible GPU of one host (2 or more; with one, only
part 3 runs).

    python scripts/torch_multi_gpu.py [--iters 8] [--trace DIR]

  1. '[multi-gpu train]': `cli.train` through `torch.distributed.run`
     (NCCL, one rank per GPU) on configs/scenedreamer_train.yaml (xor,
     the flagship width, batch 1 per data group, float32), on the terrain
     cache of a scene-1024 world and 16 synthetic pairs made as
     `chip_smoke.py` phase 9 makes them: at 1 rank, at N ranks (data N)
     and at N ranks with `--mesh-rays 2` (data N / 2 x rays 2), `--iters`
     iterations each: s/iteration (median of iterations 2 on), images
     per second (data groups / s), every meter finite, each rank's kernel
     launches; the CLI itself raises unless every rank ends with the
     same parameters;
  2. '[multi-gpu mesh]': one 540x960x40 frame of `chip_smoke.py`'s
     first pose through the padded-tile route (tile 128: 40 tiles) over
     `mesh=[cuda:0 .. cuda:N-1]` against `mesh=[cuda:0]`, at 1 tile per
     call and at 40 / N (each GPU's block in one call): the images
     equal, s/frame of each (a warm-up frame first);
  3. with `--trace DIR`, '[multi-gpu trace]': one more frame on every
     GPU at 1 tile a call under `torch.profiler`: each GPU's busy time
     (its kernels and copies summed) and idle share against the frame's
     wall time, and the host's time in each CUDA runtime call; the
     trace goes to DIR/mesh_frame_trace.json.gz.

Prints each card's name and power limit (nvidia-smi)."""
import argparse
import collections
import gzip
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs        # noqa: E402


def train(root, configs, n, iters):
    out = {}
    for name, nproc, extra in (('1 rank', 1, []), (f'{n} ranks', n, []),
                               (f'{n} ranks, rays 2', n,
                                ['--mesh-rays', '2'])):
        logs = os.path.join(root, 'logs_multi_gpu')
        argv = ['--config', configs['xor'], '--data-root',
                os.path.join(root, 'data'), '--terrain-cache',
                os.path.join(root, 'cache'), '--logdir', logs, '--seed',
                str(cs.SEED), '--max-iter', str(iters)] + extra
        text, counts, _, series, secs = cs.torchrun_cli(argv, nproc=nproc)
        assert [s for s, _ in series['gen/total']] == \
            list(range(1, iters + 1)), name
        for meter, points in series.items():
            assert all(math.isfinite(v) for _, v in points), meter
        spi = statistics.median(1.0 / v for st, v in
                                series['perf/iters_per_s'] if st >= 2)
        data = nproc // (2 if extra else 1)
        cs.log(f'[multi-gpu train] {name} (data {data}): {spi:.3f} '
               f's/iteration, {data / spi:.2f} images/s (medians of '
               f'iterations 2-{iters}; run {secs:.1f} s with process start '
               f'and set-up); each rank\'s launches '
               f'{[{k: v for k, v in c.items() if v} for c in counts]}')
        shutil.rmtree(logs)
        out[name] = spi
    return out


def mesh_frame(torch, kernels, world, n, trace_dir=None):
    import numpy as np
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
    dev = torch.device('cuda', 0)
    cfg = GeneratorConfig(num_samples=cs.SAMPLES, num_blocks_early_stop=cs.M)
    model = SceneDreamerGenerator(cfg, seed=cs.SEED).to(dev).eval()
    style = torch.randn((1, cfg.style_dims),
                        generator=torch.Generator().manual_seed(cs.SEED))
    ctl, _, _ = cs.frame_rays(torch, world, dev)
    imgs = {}
    for tb in (1, -(-cs.TILES // n)) if n > 1 else ():
        for devs in ([dev], [torch.device('cuda', i) for i in range(n)]):
            r = TiledRenderer(model, world, mesh=devs,
                              num_samples=cs.SAMPLES,
                              num_blocks_early_stop=cs.M, pad=cs.PAD,
                              resolution_hw=cs.RES, tile_size=cs.TILE,
                              tiles_per_batch=tb)
            secs, img, counts, peak = cs._warm_timed(
                torch, kernels, r, ctl[0], r.style_z(style.numpy()))
            imgs[len(devs), tb] = img
            st = r.last_stats
            cs.log(f'[multi-gpu mesh] {len(devs)} GPU(s), {tb} tile(s) a '
                   f'call: {secs:.3f} s/frame, {st["tiles"]} tiles '
                   f'({st["tiles_sky_only"]} sky only) in {st["batches"]} '
                   f'calls, peak on GPU 0 {peak:.1f} GB, launches '
                   f'{ {k: v for k, v in counts.items() if v} }')
            del r
            torch.cuda.empty_cache()
    for key, img in imgs.items():
        err = float(np.abs(img - imgs[1, 1]).max())
        cs.log(f'[multi-gpu mesh] {key[0]} GPU(s), {key[1]} tile(s) a call, '
               f'against 1 GPU at 1: image max abs diff {err}')
        assert err <= 1e-3, 'the mesh frame differs'
        if key[1] == 1:
            assert err == 0.0, 'the frame depends on the number of GPUs'
    if trace_dir:
        r = TiledRenderer(model, world, mesh=[torch.device('cuda', i)
                                              for i in range(n)],
                          num_samples=cs.SAMPLES, num_blocks_early_stop=cs.M,
                          pad=cs.PAD, resolution_hw=cs.RES,
                          tile_size=cs.TILE, tiles_per_batch=1)
        trace_frame(torch, r, ctl[0], r.style_z(style.numpy()), n,
                    trace_dir)


def trace_frame(torch, r, pose, z, n, trace_dir):
    """A warm-up frame, a timed frame, then one frame under
    `torch.profiler` (CPU and CUDA): each GPU's busy seconds and idle
    share of the profiled frame's wall time, the host's calls and
    seconds in each CUDA runtime function (top 8)."""
    def sync():
        for i in range(n):
            torch.cuda.synchronize(i)
    r.frame(pose, z)
    sync()
    t0 = time.perf_counter()
    r.frame(pose, z)
    sync()
    plain = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r.frame(pose, z)
        sync()
        wall = time.perf_counter() - t0
    busy, events = [0.0] * n, [0] * n
    host, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        secs = e.time_range.elapsed_us() / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.device_index] += secs
            events[e.device_index] += 1
        elif e.name.startswith('cu'):
            host[e.name] += secs
            calls[e.name] += 1
    assert sum(events), 'the trace holds no device time'
    cs.log(f'[multi-gpu trace] {n} GPU(s), 1 tile a call: {wall:.3f} '
           f's/frame under the profiler, {plain:.3f} without')
    for i in range(n):
        cs.log(f'[multi-gpu trace] GPU {i}: busy {busy[i]:.3f} s in '
               f'{events[i]} kernels and copies, idle share '
               f'{1 - busy[i] / wall:.3f}')
    for name, secs in host.most_common(8):
        cs.log(f'[multi-gpu trace] host {name}: {calls[name]} calls, '
               f'{secs:.3f} s')
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, 'mesh_frame_trace.json')
    prof.export_chrome_trace(path)
    with open(path, 'rb') as f, gzip.open(path + '.gz', 'wb') as g:
        shutil.copyfileobj(f, g)
    os.remove(path)
    cs.log(f'[multi-gpu trace] written to {path}.gz')


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--iters', type=int, default=8)
    p.add_argument('--trace', metavar='DIR',
                   help='trace one 1-tile-a-call frame on every GPU')
    a = p.parse_args()
    import torch
    n = torch.cuda.device_count()
    if n < 2 and not (n == 1 and a.trace):
        print(f'torch_multi_gpu: {n} CUDA GPU(s); needs 2 or more, or '
              f'one with --trace', file=sys.stderr)
        return 1
    from scenedreamer_tpu_torch import kernels
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world
    cs.float32_exact(torch)
    t0 = time.time()
    kernels.build()
    maps = generate_terrain(size=cs.SCENE, seed=cs.SEED)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=cs.SEED)
    root = None
    if n > 1:
        root, configs = cs.loop_data(world)
        train(root, configs, n, a.iters)
    mesh_frame(torch, kernels, world, n, a.trace)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        cs.log(line)
    cs.log(f'[multi-gpu] {n} GPUs in {time.time() - t0:.1f} s')
    if root:
        shutil.rmtree(root)
    return 0


if __name__ == '__main__':
    sys.exit(main())
