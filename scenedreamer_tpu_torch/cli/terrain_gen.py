"""Terrain generation CLI.

Counterpart of `scenedreamer_tpu/cli/terrain_gen.py` (reference
`terrain_generator.py` + `scripts/single_terrain_gen.py` +
`scripts/batch_terrain_gen.py`), with its flags and defaults: one seed ->
the BEV maps in the reference's file contract (`heightmap.npy`,
`semanticmap.png`, `treemap.png`, `colormap.png`, read by
`pcg_gen.py:84-90`) and in its training naming (`biome_rivers_height
.npy/.png`, `biome_rivers_labels.png`, `biome_trees_dist.png`, read by
`scripts/pcg_cache.py`); `--num-scenes` fans out over a pool of spawned
processes into `{seed:06d}` directories. Host numpy: the maps equal the JAX
package's for the same seed. PNGs are written by `utils/png.py` (no
image library).

Usage:
    python -m scenedreamer_tpu_torch.cli.terrain_gen --size 2048 \
        --seed 3407 --outdir data/terrain
    python -m scenedreamer_tpu_torch.cli.terrain_gen --num-scenes 1024 \
        --outdir data/terrain_dataset
"""
import argparse
import os


def generate_one(seed, size, outdir):
    import numpy as np
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.utils.png import write_png
    maps = generate_terrain(size=size, seed=seed)
    os.makedirs(outdir, exist_ok=True)

    def png(name, img):
        write_png(os.path.join(outdir, name), img.astype(np.uint8))

    np.save(os.path.join(outdir, 'heightmap.npy'), maps.height_map)
    png('semanticmap.png', maps.semantic_map)
    png('treemap.png', maps.tree_map)
    png('colormap.png', maps.color_map)
    # the training naming (`scripts/single_terrain_gen.py:455-467`,
    # `save_height_map` `:17-21`), which the reference's
    # `scripts/pcg_cache.py` reads
    h = maps.height_map
    np.save(os.path.join(outdir, 'biome_rivers_height.npy'),
            h.astype(np.float64))
    png('biome_rivers_height.png',
        (h - h.min()) / max(h.max() - h.min(), 1e-9) * 255)
    png('biome_rivers_labels.png', maps.semantic_map)
    png('biome_trees_dist.png', maps.tree_map)
    return outdir


def _worker(args):
    seed, size, outdir = args
    return generate_one(seed, size, outdir)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--size', type=int, default=2048)
    p.add_argument('--seed', type=int, default=3407)
    p.add_argument('--outdir', required=True)
    p.add_argument('--num-scenes', type=int, default=1,
                   help='>1: generate a dataset of scenes (batch mode)')
    p.add_argument('--start-seed', type=int, default=None)
    p.add_argument('--workers', type=int, default=16)
    a = p.parse_args(argv)

    if a.num_scenes <= 1:
        out = generate_one(a.seed, a.size, a.outdir)
        print(f'wrote {out}')
        return

    start = a.seed if a.start_seed is None else a.start_seed
    jobs = [(start + i, a.size, os.path.join(a.outdir, f'{start + i:06d}'))
            for i in range(a.num_scenes)]
    # spawned workers: a forked child of a process whose thread pools
    # (torch's, a caller's) hold locks can deadlock
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(min(a.workers, a.num_scenes)) as pool:
        for i, out in enumerate(pool.imap_unordered(_worker, jobs)):
            print(f'[{i + 1}/{a.num_scenes}] {out}')


if __name__ == '__main__':
    main()
