"""PCG voxel-cache builder CLI.

Counterpart of `scenedreamer_tpu/cli/pcg_cache.py` (reference
`scripts/pcg_cache.py:15-127`), with its flags and defaults: for every
terrain scene, a seeded random `--crop` crop of the BEV maps
(`pcg_cache.py:58-62`), the sparse voxel world (an 8-deep column fill
and the trees, `pcg_cache.py:66-98`) and the training cache in the
reference's format: `voxel_sparse.npy` (4xN int16 COO), `height_map.npy`,
`semantic_map.npy`, `hmap_mc.npy` (`pcg_cache.py:120-127`), which
`scene/voxel_world.py:load_world_cache` and the reference's PCGCache
read. Both namings of `cli/terrain_gen.py` are accepted; the grayscale
PNGs are read by `data/paired_dataset.py:decode_image` (OpenCV, Pillow
or the port's own PNG reader).

Usage:
    python -m scenedreamer_tpu_torch.cli.pcg_cache \
        --terrain-dir data/terrain_dataset --outdir data/terrain_cache \
        --crop 1024
"""
import argparse
import os

HEIGHT_NAMES = ('heightmap.npy', 'biome_rivers_height.npy')


def cache_one(terrain_dir, outdir, crop, seed, fill_depth=8):
    import numpy as np
    from scenedreamer_tpu_torch.data.paired_dataset import decode_image
    from scenedreamer_tpu_torch.scene.voxel_world import (build_voxel_world,
                                                          save_world_cache)

    def first(*names):
        for n in names:
            path = os.path.join(terrain_dir, n)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f'{names} in {terrain_dir}')

    def gray(*names):
        with open(first(*names), 'rb') as f:
            return decode_image(f.read(), gray=True)

    # the inference naming, or the reference's training naming
    # (`scripts/single_terrain_gen.py:455-467` writes biome_rivers_*;
    # `scripts/pcg_cache.py:52-56` reads them)
    height = np.load(first(*HEIGHT_NAMES))
    semantic = gray('semanticmap.png', 'biome_rivers_labels.png')
    tree = gray('treemap.png', 'biome_trees_dist.png')
    size = height.shape[0]
    rng = np.random.default_rng(seed)
    if crop and crop < size:
        y0 = rng.integers(0, size - crop)
        x0 = rng.integers(0, size - crop)
        height = height[y0:y0 + crop, x0:x0 + crop]
        semantic = semantic[y0:y0 + crop, x0:x0 + crop]
        tree = tree[y0:y0 + crop, x0:x0 + crop]
    world = build_voxel_world(height, semantic, tree, fill_depth=fill_depth,
                              seed=seed, crop=False)
    save_world_cache(world, outdir)
    return outdir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--terrain-dir', required=True,
                   help='one scene dir, or a dir of scene dirs')
    p.add_argument('--outdir', required=True)
    p.add_argument('--crop', type=int, default=1024)
    p.add_argument('--fill-depth', type=int, default=8)
    p.add_argument('--seed', type=int, default=0)
    a = p.parse_args(argv)

    def has_height(d):
        return any(os.path.exists(os.path.join(d, n)) for n in HEIGHT_NAMES)

    if has_height(a.terrain_dir):
        scenes = [a.terrain_dir]
    else:
        scenes = sorted(os.path.join(a.terrain_dir, d)
                        for d in os.listdir(a.terrain_dir)
                        if has_height(os.path.join(a.terrain_dir, d)))
    for i, scene in enumerate(scenes):
        out = os.path.join(a.outdir,
                           os.path.basename(os.path.normpath(scene)))
        cache_one(scene, out, a.crop, a.seed + i, a.fill_depth)
        print(f'[{i + 1}/{len(scenes)}] {out}')


if __name__ == '__main__':
    main()
