"""The benchmark's inputs, made from the configuration and the seed by
the benchmark's own copies of the scene code (`reference/sd/scene`), so
the program and the reference are handed the same inputs and a change
to the program cannot change them.

  * the world: terrain and voxel world of the configuration's
    `world_seed` (plus the rank, one world per data-parallel rank) at
    its `scene_size`, built on the host once per checkout and kept in
    `portbench/_cache/worlds/` (host numpy: ~35 s at scene 1024 on a
    sandbox CPU, then a ~0.3 s load);
  * the fly-through: `EvalCameraController`'s poses of the traffic's
    camera pattern over that world;
  * the training pool's cameras: proposals from the traffic's
    `camera_seed` (the same batches for every seed, as the fly-through
    is the same path for every seed: the work of a window does not
    change with the seed), taken in an order drawn from the seed;
  * styles and synthetic training images and labels: drawn on the
    device from the seed.
"""
import os

import numpy as np
import torch

from portbench.weights import stream_seed

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_cache')
WORLD_ARRAYS = ('voxel', 'heightmap', 'height_field', 'semantic_field')


def world_arrays(cfg, rank=0, cache_dir=None):
    """{voxel, heightmap, height_field, semantic_field, y_offset} of the
    configuration's world for `rank`, from the cache or built and cached
    (written to a temporary name and renamed, so concurrent runs never
    read a half-written world)."""
    seed = int(cfg['world_seed']) + rank
    key = (f"world-s{cfg['scene_size']}-seed{seed}-v{cfg['voronoi_cells']}"
           f"-r{cfg['relax_iters']}-f{cfg['fill_depth']}")
    root = os.path.join(cache_dir or os.path.join(CACHE, 'worlds'), key)
    done = os.path.join(root, 'done')
    if not os.path.exists(done):
        from portbench.reference.sd.scene.terrain import generate_terrain
        from portbench.reference.sd.scene.voxel_world import \
            build_voxel_world
        maps = generate_terrain(size=cfg['scene_size'], seed=seed,
                                n_voronoi=cfg['voronoi_cells'],
                                relax_iters=cfg['relax_iters'])
        w = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=cfg['fill_depth'],
                              seed=seed)
        os.makedirs(root, exist_ok=True)
        for name in WORLD_ARRAYS:
            tmp = os.path.join(root, f'{name}.{os.getpid()}.npy')
            np.save(tmp, getattr(w, name))
            os.replace(tmp, os.path.join(root, f'{name}.npy'))
        tmp = f'{done}.{os.getpid()}'
        with open(tmp, 'w') as f:
            f.write(f'{w.y_offset}\n')
        os.replace(tmp, done)
    out = {n: np.load(os.path.join(root, f'{n}.npy')) for n in WORLD_ARRAYS}
    with open(done) as f:
        out['y_offset'] = int(f.read())
    return out


def reference_world(arrays):
    """The arrays as the reference copy's `VoxelWorld`."""
    from portbench.reference.sd.scene.voxel_world import VoxelWorld
    return VoxelWorld(**arrays)


def flythrough(world, traffic):
    """The traffic's fly-through poses (ori, dir, up, f) over `world` (a
    reference `VoxelWorld`)."""
    from portbench.reference.sd.scene.camera import EvalCameraController
    n = traffic['cam_maxstep']
    return list(EvalCameraController(
        world, maxstep=n, pattern=traffic['camera_mode'],
        cam_ang=traffic['cam_ang'], smooth_decay_multiplier=150.0 / n))


def styles(seed, n, dims, device):
    """n raw styles [n, dims] on `device`, drawn from the seed."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, 'styles'))
    return torch.randn((n, dims), generator=gen, device=device)


def training_images(seed, rank, n, crop, num_coco, device):
    """n synthetic (images, label, pseudo_real_img) triples for one rank:
    images and pseudo-real images uniform in [-1, 1], [1, crop, crop, 3];
    labels one-hot [1, crop, crop, num_coco] of a map of 16x16 blocks,
    each block a coco label drawn uniformly. Two draws on the device."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, 'images', rank))
    img = torch.rand((n, 2, 1, crop, crop, 3), generator=gen,
                     device=device) * 2.0 - 1.0
    blocks = torch.randint(0, num_coco - 1, (n, 1, crop // 16, crop // 16),
                           generator=gen, device=device)
    lab = blocks.repeat_interleave(16, dim=2).repeat_interleave(16, dim=3)
    onehot = torch.nn.functional.one_hot(lab, num_coco).to(torch.float32)
    return [{'images': img[i, 0], 'pseudo_real_img': img[i, 1],
             'label': onehot[i]} for i in range(n)]


def camera_rng(camera_seed, rank):
    """The host generator of a rank's camera proposals: the traffic's
    `camera_seed`, the same for every run seed, so every seed trains on
    the same batches (in its own order, `pool_order`)."""
    return np.random.default_rng(stream_seed(camera_seed, 'cameras', rank))


def pool_order(seed, rank, n):
    """The run seed's order of a rank's n pooled batches."""
    rng = np.random.default_rng(stream_seed(seed, 'pool order', rank))
    return [int(i) for i in rng.permutation(n)]
