"""The per-level split of the two hash-table scatters on the GPU.

    python scripts/torch_scatter_levels.py [--scene_size 1024] [--seed 8888]
                                           [--only K3|K4] [--direct_only]

Builds a world (seed 8888) and one training batch of the flagship
training width (crop 256 + pad 6, 24 samples: 1,647,456 field points),
then runs `chip_smoke.py`'s `k3_levels` (K3a at the flagship spec) and
`k4_levels` (K4b at `hash_log2_size=21`, on the 5-D points with the
batch's scene code from the log2-21 generator's world encoder): per
level, the direct and the coarse path's times in ray order and shuffled,
the coarse path's rows flushed and inserts overflowed, the distinct rows
each level touches and the path the wrapper takes; the whole launch
before (every level direct) and after; and the one-cell and shuffled
correctness cases. The same output as phases 6 and 10 of
`chip_smoke.py`, without the rest of it. `--direct_only` times the
direct path alone (the scatters as they were before the coarse path).
Float32; needs CUDA.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (LOG2_UNFOLDED, k3_levels, k4_levels,  # noqa: E402
                        sample_points)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--scene_size', type=int, default=1024)
    p.add_argument('--seed', type=int, default=8888)
    p.add_argument('--only', choices=['K3', 'K4'], default=None)
    p.add_argument('--direct_only', action='store_true')
    a = p.parse_args(argv)

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
    print(f'device {torch.cuda.get_device_name(0)}', flush=True)
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
    xyz = sample_points(batch, cfg, world.dims)
    print(f'world {world.dims}, {xyz.shape[0]} training points, '
          f'{time.time() - t0:.1f} s', flush=True)
    if a.only in (None, 'K3'):
        k3_levels(torch, kernels, hg, cfg.hash_spec, xyz, dev,
                  not a.direct_only)
        torch.cuda.empty_cache()
    if a.only in (None, 'K4'):
        ucfg = GeneratorConfig(hash_log2_size=LOG2_UNFOLDED)
        umodel = SceneDreamerGenerator(ucfg, seed=a.seed).to(dev).eval()
        with torch.no_grad():
            code = umodel.world_code(batch['height_field'],
                                     batch['semantic_field'])[0]
        del umodel
        pts = torch.cat([xyz, code.expand(xyz.shape[0], 2)],
                        dim=-1).contiguous()
        k4_levels(torch, kernels, hg, ucfg.hash_spec, pts, dev,
                  not a.direct_only)


if __name__ == '__main__':
    main()
