"""Inference CLI: seed -> terrain -> voxel world -> rendered fly-through.

Counterpart of `scenedreamer_tpu/cli/inference.py` (reference
`inference.py:35-83`) on the port: generates the BEV maps for `--seed`,
builds the voxel world with a 16-deep fill (`pcg_gen.py:124-128`),
builds the generator from random init (seeded) or from a port state
dict saved with `torch.save`, samples a style vector, and renders the
camera trajectory to PNG frames through the split-refine renderer. Runs
on CUDA; `--device cpu` runs the plain PyTorch path.

Usage:
    python -m scenedreamer_tpu_torch.cli.inference --output_dir out \
        --seed 8888 --camera_mode 4
"""
import argparse
import os


def main(argv=None):
    """Run the CLI; returns the rendered frames ([H, W, 3] float)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--output_dir', required=True)
    p.add_argument('--checkpoint', default='',
                   help='port state dict (torch.save of '
                        'SceneDreamerGenerator.state_dict())')
    p.add_argument('--seed', type=int, default=8888)
    p.add_argument('--scene_size', type=int, default=2048)
    p.add_argument('--camera_mode', type=int, default=4)
    p.add_argument('--cam_maxstep', type=int, default=40)
    p.add_argument('--cam_ang', type=int, default=72)
    p.add_argument('--resolution', type=int, nargs=2, default=[540, 960])
    p.add_argument('--num_samples', type=int, default=40)
    p.add_argument('--num_blocks_early_stop', type=int, default=6)
    p.add_argument('--sample_depth', type=float, default=3.0)
    p.add_argument('--pad', type=int, default=30)
    p.add_argument('--style', default='',
                   help='style.npy from a previous render (reuse the '
                        'scene appearance instead of sampling from '
                        '--seed)')
    p.add_argument('--device', default=None,
                   help="torch device (default 'cuda'; 'cpu' runs the "
                        'plain PyTorch path)')
    a = p.parse_args(argv)

    import numpy as np
    import torch
    from scenedreamer_tpu_torch.device import resolve_device
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import render_trajectory
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    device = resolve_device(a.device)
    print(f'[inference] generating terrain (size={a.scene_size}, '
          f'seed={a.seed})')
    maps = generate_terrain(size=a.scene_size, seed=a.seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=a.seed)
    print(f'[inference] voxel world {world.dims}')

    cfg = GeneratorConfig(num_samples=a.num_samples,
                          num_blocks_early_stop=a.num_blocks_early_stop,
                          sample_depth=a.sample_depth)
    model = SceneDreamerGenerator(cfg, seed=a.seed)
    if a.checkpoint:
        print(f'[inference] loading {a.checkpoint}')
        model.load_state_dict(torch.load(a.checkpoint, map_location='cpu'))
    else:
        print('[inference] no checkpoint given - using random init')

    if a.style:
        style = np.load(a.style).reshape(-1, cfg.style_dims)[:1]
    else:
        style = torch.randn((1, cfg.style_dims),
                            generator=torch.Generator().manual_seed(a.seed))
    os.makedirs(a.output_dir, exist_ok=True)
    frames = render_trajectory(
        model, world, style, a.output_dir, camera_mode=a.camera_mode,
        cam_maxstep=a.cam_maxstep, cam_ang=a.cam_ang,
        num_samples=a.num_samples,
        num_blocks_early_stop=a.num_blocks_early_stop,
        sample_depth=a.sample_depth, pad=a.pad,
        resolution_hw=tuple(a.resolution), device=device)
    print(f'[inference] wrote {a.output_dir}/rgb_render')
    return frames


if __name__ == '__main__':
    main()
