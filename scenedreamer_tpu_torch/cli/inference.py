"""Inference CLI: seed -> terrain -> voxel world -> rendered fly-through.

Counterpart of `scenedreamer_tpu/cli/inference.py` (reference
`inference.py:35-83`) on the port, with its flags and defaults:
generates the BEV maps for `--seed`, builds the voxel world with a
16-deep fill (`pcg_gen.py:124-128`), builds the generator (random init
from `--seed`, or `--checkpoint`: see `load_generator`), samples a style
vector (or reads `--style`; `--style2` interpolates to a second one
over the trajectory) and renders the camera trajectory to PNG frames
and an mp4, through the split-refine renderer or, with
`--no_split_refine`, the padded-tile one. `--amp` computes the layers in
bf16. Runs on CUDA; `--device cpu` (or `--platform cpu`) runs the plain
PyTorch path. `--mesh_tiles` deals each frame's padded tiles over every
visible GPU (one process, a generator replica per GPU; on the CPU, the
one CPU device).

Usage:
    python -m scenedreamer_tpu_torch.cli.inference --output_dir out \
        --seed 8888 --camera_mode 4 [--checkpoint logs/<run>/checkpoints]
"""
import argparse
import os


def load_generator(checkpoint, cfg, device, seed=0):
    """The generator for `cfg` on `device`, its weights decided by what
    `checkpoint` holds (not by its suffix: the port's own checkpoints are
    `.pt` too):
      * '' -> random init from `seed`;
      * a directory -> its `latest_checkpoint.txt` target;
      * a trainer checkpoint ('generator' and 'g_ema') -> the generator
        state with the EMA weights laid over it, as JAX prefers g_ema;
      * {'net_G': ...} or a bare reference-named state dict ->
        `utils.convert.load_reference_generator_state_dict`.
    The weights load with strict=True."""
    import torch
    from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
    from scenedreamer_tpu_torch.train.trainer import latest_checkpoint
    from scenedreamer_tpu_torch.utils.convert import \
        load_reference_generator_state_dict
    model = SceneDreamerGenerator(cfg, seed=seed)
    if not checkpoint:
        print('[inference] no checkpoint given - using random init')
        return model.to(device)
    path = checkpoint
    if os.path.isdir(path):
        path = latest_checkpoint(checkpoint)
        if path is None:
            raise FileNotFoundError(f'no latest_checkpoint.txt target in '
                                    f'{checkpoint}')
    print(f'[inference] loading {path}')
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    if 'generator' in ckpt and 'g_ema' in ckpt:
        sd = dict(ckpt['generator'])
        sd.update(ckpt['g_ema'] or {})
    else:
        sd = load_reference_generator_state_dict(ckpt)
    model.load_state_dict(sd, strict=True)
    return model.to(device)


def main(argv=None):
    """Run the CLI; returns the rendered frames ([H, W, 3] uint8)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--output_dir', required=True)
    p.add_argument('--checkpoint', default='',
                   help='trainer checkpoint (file or directory) or a '
                        'reference generator state dict (see '
                        'load_generator)')
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
    p.add_argument('--tile_size', type=int, default=128)
    p.add_argument('--fps', type=int, default=10)
    p.add_argument('--style', default='',
                   help='style.npy from a previous render (reuse the '
                        'scene appearance instead of sampling from '
                        '--seed)')
    p.add_argument('--style2', default='',
                   help='second style: interpolate appearance from '
                        '--style/--seed to this across the trajectory '
                        "(a style.npy path, or 'seed:<int>')")
    p.add_argument('--no_split_refine', action='store_true',
                   help='render padded tiles (field and CNN per tile, the '
                        'reference loop) instead of the split-refine '
                        'path')
    p.add_argument('--tiles_per_batch', type=int, default=1,
                   help='padded tiles per field call')
    p.add_argument('--mesh_tiles', action='store_true',
                   help="deal each frame's padded tiles over every visible "
                        'GPU (multi-GPU inference)')
    p.add_argument('--save_depth', action='store_true',
                   help='also write depth and voxel-id frames '
                        '(reference inference_givenstyle_depth)')
    p.add_argument('--platform', default=None,
                   help="'cpu', or 'gpu' / 'cuda' (the default); "
                        '--device wins when both are given')
    p.add_argument('--amp', action='store_true',
                   help='bf16 layer compute with float32 parameters')
    p.add_argument('--device', default=None,
                   help="torch device (default 'cuda'; 'cpu' runs the "
                        'plain PyTorch path)')
    a = p.parse_args(argv)

    import time
    import numpy as np
    import torch
    from scenedreamer_tpu_torch.device import (device_from_flags,
                                               resolve_device)
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    from scenedreamer_tpu_torch.render.pipeline import render_trajectory
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    device = resolve_device(device_from_flags(a.device, a.platform))
    print(f'[inference] generating terrain (size={a.scene_size}, '
          f'seed={a.seed})')
    maps = generate_terrain(size=a.scene_size, seed=a.seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=a.seed)
    print(f'[inference] voxel world {world.dims}')

    cfg = GeneratorConfig(num_samples=a.num_samples,
                          num_blocks_early_stop=a.num_blocks_early_stop,
                          sample_depth=a.sample_depth,
                          dtype=torch.bfloat16 if a.amp else torch.float32)
    model = load_generator(a.checkpoint, cfg, device, seed=a.seed)

    def one_style(spec, seed):
        if spec.startswith('seed:'):
            seed, spec = int(spec[5:]), ''
        if spec:
            # a saved scene appearance; an interpolated run's
            # [F, style_dims] passes through
            return np.load(spec).reshape(-1, cfg.style_dims)
        return torch.randn((1, cfg.style_dims), generator=torch.Generator()
                           .manual_seed(seed)).numpy()

    style = one_style(a.style, a.seed)
    if a.style2:
        s2 = one_style(a.style2, a.seed + 1)
        t = np.linspace(0.0, 1.0, max(a.cam_maxstep, 2))[:, None]
        style = ((1.0 - t) * style[:1] + t * s2[:1]).astype(np.float32)
    os.makedirs(a.output_dir, exist_ok=True)
    mesh = None
    if a.mesh_tiles:
        mesh = [device] if device.type != 'cuda' else [
            torch.device('cuda', i) for i in range(torch.cuda.device_count())]
        print(f'[inference] mesh tiles over {[str(d) for d in mesh]}')
    timings = []
    t0 = time.perf_counter()
    frames = render_trajectory(
        model, world, style, a.output_dir, camera_mode=a.camera_mode,
        cam_maxstep=a.cam_maxstep, cam_ang=a.cam_ang,
        num_samples=a.num_samples,
        num_blocks_early_stop=a.num_blocks_early_stop,
        sample_depth=a.sample_depth, pad=a.pad, tile_size=a.tile_size,
        resolution_hw=tuple(a.resolution), fps=a.fps, seed=a.seed,
        save_depth=a.save_depth, tiles_per_batch=a.tiles_per_batch,
        split_refine=False if a.no_split_refine else None,
        device=None if mesh else device, mesh=mesh, timings=timings)
    wall = time.perf_counter() - t0
    n = max(1, len(frames))
    loop = sum(t['queue_s'] + t['wait_s'] + t['write_s'] for t in timings)
    print(f'[inference] trajectory: {len(frames)} frames in {wall:.3f} s, '
          f'{wall / n:.3f} s/frame wall; the frame loop {loop / n:.3f} '
          f's/frame after {wall - loop:.3f} s of set-up; host writes '
          f'{sum(t["write_s"] for t in timings) / n:.3f} s/frame, waits '
          f'{sum(t["wait_s"] for t in timings) / n:.3f} s/frame')
    print(f'[inference] wrote {a.output_dir}/rgb_render(.mp4)')
    return frames


if __name__ == '__main__':
    main()
