"""The per-level split of the three hash-table scatters on the GPU.

    python scripts/torch_scatter_levels.py [--scene_size 1024] [--seed 8888]
                                           [--only K3|K4|K5] [--direct_only]
                                           [--pkg_root DIR]

Builds a world (seed 8888) and one training batch of the flagship
training width (crop 256 + pad 6, 24 samples: 1,647,456 field points),
then runs `chip_smoke.py`'s `k3_levels` (K3a at the flagship spec, and
K5c at the flagship spec with `hash_variant='paired'`) and `k4_levels`
(K4b at `hash_log2_size=21`, on the 5-D points with the batch's scene
code from the log2-21 generator's world encoder): per level, the direct
and the coarse path's times in ray order and shuffled, the coarse path's
rows flushed and inserts overflowed, the distinct rows each level
touches and the path the wrapper takes; the whole launch before (every
level direct) and after; and the one-cell and shuffled correctness
cases. The same output as phases 6, 8 and 10 of `chip_smoke.py`, without
the rest of it. `--direct_only` times the direct path alone (the
scatters as they were before the coarse path). `--pkg_root` imports the
port from another checkout (an unpacked older commit, say, whose
wrappers take the same arguments), with this checkout's helpers. Float32; needs CUDA.
"""
import argparse
import importlib.util
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--scene_size', type=int, default=1024)
    p.add_argument('--seed', type=int, default=8888)
    p.add_argument('--only', choices=['K3', 'K4', 'K5'], default=None)
    p.add_argument('--direct_only', action='store_true')
    p.add_argument('--pkg_root', default=REPO,
                   help='directory that holds the scenedreamer_tpu_torch '
                        'package to time (default: this checkout)')
    a = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.pkg_root))
    # this checkout's helpers, whichever package they drive
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    from scenedreamer_tpu_torch import kernels
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.ops import hashgrid as hg
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    if not torch.cuda.is_available():
        raise SystemExit('needs CUDA')
    dev = torch.device('cuda')
    print(f'device {torch.cuda.get_device_name(0)}; package '
          f'{os.path.dirname(kernels.__file__)}', flush=True)
    t0 = time.time()
    kernels.build()
    print(f'build {time.time() - t0:.1f} s', flush=True)
    for name, text in kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[build] {name}: {line.strip()}', flush=True)
    maps = generate_terrain(size=a.scene_size, seed=a.seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=a.seed)
    voxel = torch.from_numpy(world.voxel).to(dev)
    cfg = GeneratorConfig()
    hw = 256 + cfg.pad
    batch = make_batch(world, batch_size=1, height=hw, width=hw,
                       max_samples=cfg.num_blocks_early_stop, pad=cfg.pad,
                       seed=a.seed, device=dev, voxel=voxel)
    xyz = cs.sample_points(batch, cfg, world.dims)
    print(f'world {world.dims}, {xyz.shape[0]} training points, '
          f'{time.time() - t0:.1f} s', flush=True)
    if a.only in (None, 'K3'):
        cs.k3_levels(torch, kernels, hg, cfg.hash_spec, xyz, dev,
                     not a.direct_only)
        torch.cuda.empty_cache()
    if a.only in (None, 'K5'):
        cs.k3_levels(torch, kernels, hg,
                     GeneratorConfig(hash_variant='paired').hash_spec, xyz,
                     dev, not a.direct_only)
        torch.cuda.empty_cache()
    if a.only in (None, 'K4'):
        ucfg = GeneratorConfig(hash_log2_size=cs.LOG2_UNFOLDED)
        umodel = SceneDreamerGenerator(ucfg, seed=a.seed).to(dev).eval()
        with torch.no_grad():
            code = umodel.world_code(batch['height_field'],
                                     batch['semantic_field'])[0]
        del umodel
        pts = torch.cat([xyz, code.expand(xyz.shape[0], 2)],
                        dim=-1).contiguous()
        cs.k4_levels(torch, kernels, hg, ucfg.hash_spec, pts, dev,
                     not a.direct_only)


if __name__ == '__main__':
    main()
