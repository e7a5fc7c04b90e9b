"""Time and profile the PyTorch port's frame render on the GPU.

    python scripts/torch_profile_frame.py [--scene_size 2048] [--frames 3]
        [--amp]

Builds the CLI's default world (seed 8888) and the flagship generator
from seeded random weights, renders the first frames of camera pattern 4
at the inference defaults (540x960, 40 samples, M=6, pad 30), and
prints: seconds per frame (host clock around synchronised frames, after
one warm-up frame), the device time by kernel name over one profiled
frame (torch.profiler), the device busy share of that frame, and peak
device memory. Float32 throughout (TF32 off), or with `--amp` the
layers in bf16 (the inference CLI's `--amp`). Needs CUDA.
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--scene_size', type=int, default=2048)
    p.add_argument('--seed', type=int, default=8888)
    p.add_argument('--frames', type=int, default=3)
    p.add_argument('--top', type=int, default=25)
    p.add_argument('--amp', action='store_true',
                   help='bf16 layer compute with float32 parameters')
    a = p.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from scenedreamer_tpu_torch import kernels
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    if not torch.cuda.is_available():
        raise SystemExit('needs CUDA')
    print(f'device {torch.cuda.get_device_name(0)}', flush=True)
    t0 = time.time()
    maps = generate_terrain(size=a.scene_size, seed=a.seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=a.seed)
    print(f'world {world.dims} in {time.time() - t0:.1f} s', flush=True)
    cfg = GeneratorConfig(num_samples=40, num_blocks_early_stop=6,
                          dtype=torch.bfloat16 if a.amp else torch.float32)
    model = SceneDreamerGenerator(cfg, seed=a.seed)
    renderer = TiledRenderer(model, world, num_samples=40,
                             num_blocks_early_stop=6, pad=30,
                             resolution_hw=(540, 960))
    z = renderer.style_z(torch.randn(
        (1, cfg.style_dims), generator=torch.Generator().manual_seed(a.seed)))
    poses = list(EvalCameraController(world, maxstep=max(a.frames, 2),
                                      pattern=4, cam_ang=72,
                                      smooth_decay_multiplier=150.0
                                      / max(a.frames, 2)))
    renderer.frame(poses[0], z)                         # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for pose in poses[:a.frames]:
        torch.cuda.synchronize()
        t0 = time.time()
        renderer.frame(pose, z)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    print(f'frames {a.frames}: {statistics.mean(times):.3f} s/frame '
          f'{[round(t, 3) for t in times]}; launches '
          f'{kernels.launch_counts()}; peak '
          f'{torch.cuda.max_memory_allocated() / 1e9:.1f} GB', flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        renderer.frame(poses[0], z)
        torch.cuda.synchronize()
        wall = time.time() - t0

    def dev_us(evt):
        for attr in ('self_device_time_total', 'self_cuda_time_total'):
            if hasattr(evt, attr):
                return getattr(evt, attr)
        return 0.0

    # device-side events only (kernels and copies); the operator-level
    # rows would count the same device time a second time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e6
    print(f'profiled frame: wall {wall:.3f} s (profiler on), device busy '
          f'{busy:.3f} s = {busy / wall:.3f} of wall, idle share '
          f'{1 - busy / wall:.3f}')
    for e in events[:a.top]:
        print(f'  {dev_us(e) / 1e3:10.2f} ms  {e.count:6d}x  {e.key[:90]}')


if __name__ == '__main__':
    main()
