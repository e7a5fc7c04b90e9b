"""The per-level split of the forward hash gathers on the GPU, and the
shapes of the bake's dw reductions.

    python scripts/torch_encode_levels.py [--scene_size 1024] [--seed 8888]
                                          [--only K2|K4a|K5|K3c]
                                          [--pkg_root DIR]

Builds a world (seed 8888), the first frame of `chip_smoke.py`'s camera
and its middle serving chunk (33 image rows x 990 rays x 41 samples:
1,306,800 field points), and one training batch of the flagship training
width (crop 256 + pad 6, 24 samples: 1,647,456 field points). Then runs
`chip_smoke.py`'s `k2_levels` (K2b at the flagship spec on the serving
chunk, table uniform in [-1, 1] baked with the flagship generator's scene
code) and `k4a_levels` (K4a at `hash_log2_size=21`, on the training
points and on the serving chunk, each with the scene code of the log2-21
generator's world encoder): per level, the distinct rows and the rows
issued, the time in ray order, shuffled and with every point equal, and
the issued sectors per ms; then the whole launch. `K5`: `paired_levels`
(K5b the same way at the flagship spec with `hash_variant='paired'`, on
the training points and on the serving chunk, the table baked with the
paired generator's scene code of each), then `dw_shapes` of K5d's dw
(the whole launch, each level alone, one corner, every shift 0) on a
table uniform in [-1, 1] and a seeded normal G, at phase 8's scene code;
`K3c`: `dw_shapes` of K3c's dw on the same tables under the xor masks.
The same lines as phases 5, 6, 8 and 10 of `chip_smoke.py` (`[K2
levels]`, `[K3c dw]`, `[K5d dw]`, `[K5b levels]`, `[K4a levels]`),
without the rest of it. `--pkg_root` imports the port from another
checkout (an unpacked older commit, say), so two versions of the kernels
can be timed the same way in one session. Float32; needs CUDA.
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
    p.add_argument('--only', choices=['K2', 'K4a', 'K5', 'K3c'],
                   default=None)
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
        for kernel, report in cs.ptxas_report(text):
            print(f'[build] {name}: {kernel}: {report}', flush=True)
    maps = generate_terrain(size=a.scene_size, seed=a.seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=a.seed)
    voxel = torch.from_numpy(world.voxel).to(dev)
    _, rays, ori_t = cs.frame_rays(torch, world, dev)
    _, depth, hit = kernels.dda(voxel, ori_t, rays, cs.M,
                                sum(world.dims) + 2)
    chunk, _ = cs.chunk_points(torch, rays, ori_t, depth, hit, world.dims)
    fields = (torch.from_numpy(world.height_field.transpose(0, 2, 3, 1))
              .to(dev),
              torch.from_numpy(world.semantic_field.transpose(0, 2, 3, 1))
              .to(dev))
    print(f'world {world.dims}, serving chunk {chunk.shape[0]} points, '
          f'{time.time() - t0:.1f} s', flush=True)
    if a.only in (None, 'K2'):
        cfg = GeneratorConfig(num_samples=cs.SAMPLES,
                              num_blocks_early_stop=cs.M)
        spec = cfg.hash_spec
        with torch.no_grad():
            scene = SceneDreamerGenerator(cfg, seed=a.seed).to(dev) \
                .world_code(*fields)[0]
        gen = torch.Generator(device=dev).manual_seed(0)
        table3 = (torch.rand((spec.table_size, spec.level_dim), generator=gen,
                             device=dev) * 2 - 1).reshape(spec.num_levels,
                                                          -1, spec.level_dim)
        masks, weights, oob = hg.scene_fold_weights(spec, scene)
        baked = kernels.hash_bake(table3, masks.to(torch.int32).contiguous(),
                                  weights.contiguous())
        cs.k2_levels(torch, kernels, hg, baked, chunk,
                     hg._scales(spec, dev), hg._offset(spec), oob, dev)
        del table3, baked
        torch.cuda.empty_cache()
    # the training batch of `chip_smoke.py` phase 6
    tcfg = GeneratorConfig()
    hw = cs.TRAIN_CROP + tcfg.pad
    batch = make_batch(world, batch_size=1, height=hw, width=hw,
                       max_samples=tcfg.num_blocks_early_stop, pad=tcfg.pad,
                       seed=a.seed, device=dev, voxel=voxel)
    if a.only in (None, 'K5'):
        cs.paired_levels(torch, kernels, hg,
                         GeneratorConfig(hash_variant='paired'), batch,
                         fields, world.dims, chunk, dev)
        torch.cuda.empty_cache()
    if a.only in (None, 'K5', 'K3c'):
        gen = torch.Generator(device=dev).manual_seed(a.seed)
        spec = tcfg.hash_spec
        table3 = (torch.rand((spec.table_size, spec.level_dim), generator=gen,
                             device=dev) * 2 - 1).reshape(spec.num_levels,
                                                          -1, spec.level_dim)
        grad = torch.randn(table3.shape, generator=gen, device=dev)
        scene = torch.tensor([0.31, -0.47], device=dev)
        for only, tag, variant, launch in (
                ('K5', 'K5d', 'paired', kernels.hash_shift_bake_dw),
                ('K3c', 'K3c', 'xor', kernels.hash_bake_dw)):
            if a.only in (None, only):
                masks = hg.scene_fold_weights(
                    GeneratorConfig(hash_variant=variant).hash_spec,
                    scene)[0]
                cs.dw_shapes(torch, tag, launch, table3, grad,
                             masks.to(torch.int32).contiguous())
        del table3, grad
        torch.cuda.empty_cache()
    if a.only in (None, 'K4a'):
        ucfg = GeneratorConfig(hash_log2_size=cs.LOG2_UNFOLDED)
        umodel = SceneDreamerGenerator(ucfg, seed=a.seed).to(dev).eval()
        with torch.no_grad():
            tcode = umodel.world_code(batch['height_field'],
                                      batch['semantic_field'])[0]
            scode = umodel.world_code(*fields)[0]
        del umodel
        xyz = cs.sample_points(batch, GeneratorConfig(), world.dims)
        for case, x, code in (('train', xyz, tcode), ('chunk', chunk, scode)):
            pts = torch.cat([x, code.expand(x.shape[0], 2)],
                            dim=-1).contiguous()
            cs.k4a_levels(torch, kernels, hg, ucfg.hash_spec, pts, dev, case)
            del pts
            torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
