"""The ray-voxel DDA (K1) at the shapes the port launches it, on the GPU.

    python scripts/torch_dda_shapes.py [--scene_size 1024] [--seed 8888]
                                       [--pkg_root DIR]

Builds a world (seed 8888), the first frame of `chip_smoke.py`'s camera
(570x990 rays) and the training sampler's first camera proposals (262x262
rays each), then runs `chip_smoke.py`'s `k1_shapes`: K1's time at the
frame, at the frame's rays sorted by their step count, at one proposal,
at the proposals launched one by one and in one launch, and at the
frame's 32 longest rays, each with the world's brick bits (the empty-
space skip) and with every bit set (no skip); the per-warp issued /
needed axis steps in launch order and in 8x4 tiles; the voxel loads the
skip leaves; the bits' build time and what a sampled world's first round
costs with and without the skip. The same `[K1 shapes]` lines as phases
2 and 5 of `chip_smoke.py`, without the rest of it. `--pkg_root` imports
the port from another checkout (a copy of the package with a changed
kernel, say, whose `kernels.dda` takes the same arguments), with this
checkout's helpers, so two versions of K1 can be timed the same way on
one card. Float32; needs CUDA.
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
    for kernel, report in cs.ptxas_report(kernels.BUILD_LOGS.get('dda', '')):
        print(f'[build] dda: {kernel}: {report}', flush=True)
    maps = generate_terrain(size=a.scene_size, seed=a.seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=a.seed)
    voxel = torch.from_numpy(world.voxel).to(dev)
    _, rays, ori_t = cs.frame_rays(torch, world, dev)
    print(f'world {world.dims}, {rays.shape[0]} frame rays, '
          f'{time.time() - t0:.1f} s', flush=True)
    cs.k1_shapes(torch, kernels, world, voxel, rays, ori_t,
                 (cs.RES[0] + cs.PAD, cs.RES[1] + cs.PAD), dev)


if __name__ == '__main__':
    main()
