"""Training-campaign tools: the assets a campaign trains on, the image
sets that score its checkpoints, and an end-to-end smoke render.

Counterparts of the JAX package's `scripts/make_training_assets.py`,
`make_pseudo_gt_set.py`, `render_fake_set.py`, `campaign_eval.py` and
`smoke_render.py`, one function each with the script's flags and
defaults; the thin entry points are `scripts/torch_<name>.py`. Every
function runs on CUDA unless `--device cpu` (or `--platform cpu`) asks
for the plain PyTorch path.

  * `make_training_assets`: a synthetic paired dataset (`images/` +
    `seg_maps/`, the folder contract of `data/paired_dataset.py`) of
    smooth random fields over the coco labels the reference's LHQ
    seg maps use, and a terrain cache (`cli.terrain_gen` then
    `cli.pcg_cache`). Host work; numpy only (no OpenCV), so the images
    are PNG where JAX writes JPEG: the port reads no JPEG without OpenCV
    or Pillow.
  * `make_pseudo_gt_set`: the SPADE oracle's images on the training
    camera distribution (`cli.train`'s oracle loader and batch builder:
    kernel K1 in the sampler's rounds), the real set of an evaluation.
  * `render_fake_set`: a checkpoint's generator crops on the same
    distribution (K1, then K2a + K2b, K5a + K5b or K4a by the yaml's
    hash spec), the fake set.
  * `campaign_eval`: for every checkpoint of a `cli.train` run, a fake
    set (seed 123) and `cli.evaluate`'s FID / KID with the `vgg19` and
    `pixel` extractors, in this process; `fid_table.json` and a markdown
    table.
  * `smoke_render`: terrain -> voxel world -> seeded generator ->
    `render_trajectory`.

Images are quantised as the JAX scripts quantise them,
clip((x * 0.5 + 0.5) * 255) to uint8 (`render/pipeline.py:to_uint8`),
and written by `utils/png.py`.
The oracle's and the generator's styles are drawn from one
`torch.Generator` seeded with `--seed`, so the images are the port's own;
the worlds and cameras are the JAX scripts' draws for the same seed (one
numpy generator in the same order).

Usage:
    python scripts/torch_make_training_assets.py --outdir assets
    python scripts/torch_make_pseudo_gt_set.py --spade-checkpoint oracle.pt \\
        --terrain-cache assets/terrain_cache --outdir pgt
    python scripts/torch_campaign_eval.py --run-dir logs/<run> \\
        --real-dir pgt --terrain-cache assets/terrain_cache --outdir eval
"""
import argparse
import json
import os
import time

import numpy as np

from scenedreamer_tpu_torch.device import device_from_flags, resolve_device

# landscape-ish coco classes of the synthetic seg maps (sky 156, sea 154,
# tree 168, grass 123, mountain 134, dirt 110, river 147, snow 158)
CLASSES = np.array([156, 154, 168, 123, 134, 110, 147, 158])


def _device_flags(p):
    p.add_argument('--platform', default=None,
                   help="'cpu', or 'gpu' / 'cuda' (the default); --device "
                        'wins when both are given')
    p.add_argument('--device', default=None,
                   help="torch device (default 'cuda'; 'cpu' runs the "
                        'plain PyTorch path)')


def _device(a):
    return resolve_device(device_from_flags(a.device, a.platform))


def smooth_field(rng, h, w, octaves=4):
    """Multi-octave smooth random field in [0, 1] (cheap fBm): standard
    normal grids of 4, 8, 16, 32 cells, each bicubic-upsampled
    (`data/image_ops.py:resize_cubic`, OpenCV's INTER_CUBIC) and summed
    with halving weights, then normalised."""
    from scenedreamer_tpu_torch.data.image_ops import resize_cubic
    acc = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        side = max(2, 2 ** (o + 2))
        g = rng.standard_normal((side, side)).astype(np.float32)
        acc += amp * resize_cubic(g, (h, w))
        amp *= 0.5
    acc -= acc.min()
    m = acc.max()
    return acc / m if m > 0 else acc


def make_dataset(root, num_images, size, seed):
    """`num_images` pairs of `images/<i>.png` (RGB) and `seg_maps/<i>.png`
    (coco label ids): a horizon of sky over bands picked by a smooth
    elevation, the image loosely coloured by the bands plus noise."""
    from scenedreamer_tpu_torch.utils.png import write_png
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'images'), exist_ok=True)
    os.makedirs(os.path.join(root, 'seg_maps'), exist_ok=True)
    for i in range(num_images):
        elev = smooth_field(rng, size, size)
        hue = smooth_field(rng, size, size)
        # horizon: top rows are sky; below, elevation picks the class
        horizon = 0.3 + 0.2 * smooth_field(rng, 1, size)[0]
        yy = np.linspace(0, 1, size)[:, None] * np.ones((1, size))
        sky = yy < horizon
        band = np.clip((elev * 6).astype(np.int32), 0,
                       len(CLASSES) - 2) + 1
        seg = np.where(sky, 0, band)
        base = np.stack([
            0.3 + 0.5 * hue, 0.4 + 0.4 * elev,
            0.5 + 0.3 * smooth_field(rng, size, size)], -1)
        sky_col = np.array([0.55, 0.7, 0.95], np.float32)
        img = np.where(sky[..., None], sky_col[None, None], base)
        img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1)
        write_png(os.path.join(root, 'images', f'{i:05d}.png'),
                  (img * 255).astype(np.uint8))
        write_png(os.path.join(root, 'seg_maps', f'{i:05d}.png'),
                  CLASSES[seg].astype(np.uint8))
    print(f'[assets] dataset: {num_images} pairs at {root}')


def make_training_assets(argv=None):
    """A synthetic paired dataset and a PCG terrain cache under --outdir;
    returns (data root, cache dir)."""
    p = argparse.ArgumentParser(description=make_training_assets.__doc__)
    p.add_argument('--outdir', required=True)
    p.add_argument('--num-images', type=int, default=64)
    p.add_argument('--image-size', type=int, default=320)
    p.add_argument('--terrain-size', type=int, default=512)
    p.add_argument('--num-scenes', type=int, default=4)
    p.add_argument('--crop', type=int, default=256)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="checked as every entry point's (default 'cuda'); "
                        'the assets are host work')
    a = p.parse_args(argv)
    resolve_device(a.device)
    from scenedreamer_tpu_torch.cli import pcg_cache, terrain_gen

    data_root = os.path.join(a.outdir, 'dataset')
    make_dataset(data_root, a.num_images, a.image_size, a.seed)
    terrain_dir = os.path.join(a.outdir, 'terrain')
    cache_dir = os.path.join(a.outdir, 'terrain_cache')
    terrain_gen.main(['--size', str(a.terrain_size),
                      '--num-scenes', str(a.num_scenes),
                      '--seed', str(a.seed), '--outdir', terrain_dir])
    pcg_cache.main(['--terrain-dir', terrain_dir, '--outdir', cache_dir,
                    '--crop', str(a.crop)])
    print(f'[assets] done: data-root={data_root} '
          f'terrain-cache={cache_dir}')
    return data_root, cache_dir


def make_pseudo_gt_set(argv=None):
    """The SPADE oracle's pseudo ground truth on the training camera
    distribution (`cli.train`'s oracle loader and batch builder, the
    contract training itself uses), written as <outdir>/<i>.png; returns
    the paths."""
    p = argparse.ArgumentParser(description=make_pseudo_gt_set.__doc__)
    p.add_argument('--spade-checkpoint', required=True)
    p.add_argument('--terrain-cache', required=True)
    p.add_argument('--outdir', required=True)
    p.add_argument('--num-images', type=int, default=128)
    p.add_argument('--crop', type=int, default=256)
    p.add_argument('--spade-size', type=int, default=256)
    p.add_argument('--spade-res', type=int, default=256)
    p.add_argument('--spade-filters', type=int, default=32)
    p.add_argument('--seed', type=int, default=0)
    _device_flags(p)
    a = p.parse_args(argv)
    device = _device(a)
    import torch
    from scenedreamer_tpu_torch.cli import train as T
    from scenedreamer_tpu_torch.render.pipeline import to_uint8
    from scenedreamer_tpu_torch.scene.voxel_world import WorldCache
    from scenedreamer_tpu_torch.utils.config import Config
    from scenedreamer_tpu_torch.utils.png import write_png

    args = argparse.Namespace(
        spade_checkpoint=a.spade_checkpoint, spade_size=a.spade_size,
        spade_res=a.spade_res, spade_filters=a.spade_filters,
        spade_oracle_f32=False)
    cfg = Config(None)
    cfg.setdefault('gen', {})['crop_size'] = [a.crop, a.crop]
    spade_apply = T._load_spade_oracle(args, device)
    _, _, builder = T._build_sampler_and_pgt(cfg, args, spade_apply, device)
    cache = WorldCache(a.terrain_cache)
    rng = np.random.default_rng(a.seed)
    style = torch.Generator(device).manual_seed(a.seed)
    os.makedirs(a.outdir, exist_ok=True)
    paths = []
    t0 = time.perf_counter()
    for n in range(a.num_images):
        world = cache.sample_world(rng=T._RandomAdapter(rng))
        batch = builder({}, world, rng, style)
        paths.append(os.path.join(a.outdir, f'{n:05d}.png'))
        write_png(paths[-1], to_uint8(batch['pseudo_real_img'][0].cpu()))
        if (n + 1) % 16 == 0:
            print(f'[pgt] {n + 1}/{a.num_images}')
    print(f'[pgt] wrote {len(paths)} pseudo-GT images to {a.outdir} in '
          f'{time.perf_counter() - t0:.2f} s')
    return paths


def render_fake_set(argv=None):
    """A checkpoint's generator crops on the training camera / world
    distribution (rejection-sampled cameras over the cached worlds),
    written as <outdir>/<i>.png; returns the paths. The generator is the
    yaml's (`cli.train.generator_config`), its weights a trainer
    checkpoint or a reference `.pt` (`cli.inference.load_generator`)."""
    p = argparse.ArgumentParser(description=render_fake_set.__doc__)
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--terrain-cache', required=True)
    p.add_argument('--outdir', required=True)
    p.add_argument('--num-images', type=int, default=64)
    p.add_argument('--crop', type=int, default=256)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--config', default=None,
                   help='train yaml for the generator hyperparameters '
                        '(defaults = flagship GeneratorConfig)')
    _device_flags(p)
    a = p.parse_args(argv)
    device = _device(a)
    import torch
    from scenedreamer_tpu_torch.cli import train as T
    from scenedreamer_tpu_torch.cli.inference import load_generator
    from scenedreamer_tpu_torch.render.pipeline import to_uint8
    from scenedreamer_tpu_torch.scene.voxel_world import WorldCache
    from scenedreamer_tpu_torch.train.sampling import (CameraBatchSampler,
                                                       CameraSamplerConfig)
    from scenedreamer_tpu_torch.utils.config import Config
    from scenedreamer_tpu_torch.utils.png import write_png

    cfg = Config(a.config)
    gcfg = T.generator_config(cfg)
    cache = WorldCache(a.terrain_cache)
    rng = np.random.default_rng(a.seed)
    # the first world pins the voxel dims (JAX traces them into its
    # program); every world drawn after must match them
    dims = tuple(int(d) for d in
                 cache.sample_world(rng=T._RandomAdapter(rng)).dims)
    model = load_generator(a.checkpoint, gcfg, device, seed=a.seed).eval()
    sampler = CameraBatchSampler(CameraSamplerConfig(
        cam_res=tuple(cfg.get('gen', {}).get('cam_res', (360, 640))),
        crop_size=(a.crop, a.crop), pad=gcfg.pad,
        num_blocks_early_stop=gcfg.num_blocks_early_stop), device=device)
    style = torch.Generator(device).manual_seed(a.seed)
    os.makedirs(a.outdir, exist_ok=True)
    paths = []
    t0 = time.perf_counter()
    for n in range(a.num_images):
        world = cache.sample_world(rng=T._RandomAdapter(rng))
        if tuple(int(d) for d in world.dims) != dims:
            # the WorldCache slab invariant: fail loudly on a cache of
            # mixed dims rather than render with another world's
            raise ValueError(f'world dims {world.dims} != the first '
                             f"world's {dims}: the cache mixes sizes")
        batch = dict(sampler.sample(world, 1, rng))
        for k in ('height_field', 'semantic_field'):
            batch[k] = torch.from_numpy(np.ascontiguousarray(
                getattr(world, k).transpose(0, 2, 3, 1))).to(device)
        with torch.no_grad():
            img = model(batch, dims, random_style=True,
                        generator=style)['fake_images'][0]
        paths.append(os.path.join(a.outdir, f'{n:05d}.png'))
        write_png(paths[-1], to_uint8(img.float().cpu()))
        if (n + 1) % 16 == 0:
            print(f'[fake] {n + 1}/{a.num_images}')
    print(f'[fake] wrote {len(paths)} fake images to {a.outdir} in '
          f'{time.perf_counter() - t0:.2f} s')
    return paths


def campaign_eval(argv=None):
    """For every checkpoint of a `cli.train` run
    (<run-dir>/checkpoints/step_<8 digits>.pt): a fake set (seed 123,
    kept and reused when complete) and FID / KID against --real-dir with
    the vgg19 and pixel extractors (`cli.evaluate`), in this process.
    Writes <outdir>/fid_table.json, prints a markdown table and returns
    the rows."""
    p = argparse.ArgumentParser(description=campaign_eval.__doc__)
    p.add_argument('--run-dir', required=True)
    p.add_argument('--real-dir', required=True)
    p.add_argument('--terrain-cache', required=True)
    p.add_argument('--outdir', required=True)
    p.add_argument('--num-images', type=int, default=64)
    p.add_argument('--crop', type=int, default=256)
    p.add_argument('--config', default=None)
    p.add_argument('--image-size', type=int, default=256)
    _device_flags(p)
    a = p.parse_args(argv)
    device = str(_device(a))
    from scenedreamer_tpu_torch.cli import evaluate

    ckpt_dir = os.path.join(a.run_dir, 'checkpoints')
    steps = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith('step_') and f.endswith('.pt'))
    if not steps:
        raise SystemExit(f'no checkpoints under {ckpt_dir}')
    os.makedirs(a.outdir, exist_ok=True)
    cfg = ['--config', a.config] if a.config else []
    rows = []
    for s in steps:
        step = int(s[len('step_'):-len('.pt')])
        fake_dir = os.path.join(a.outdir, f'fake_{step:06d}')
        if not os.path.exists(os.path.join(
                fake_dir, f'{a.num_images - 1:05d}.png')):
            render_fake_set(['--checkpoint', os.path.join(ckpt_dir, s),
                             '--terrain-cache', a.terrain_cache,
                             '--outdir', fake_dir,
                             '--num-images', str(a.num_images),
                             '--crop', str(a.crop), '--seed', '123',
                             '--device', device] + cfg)
        row = {'step': step}
        for ex in ('vgg19', 'pixel'):
            r = evaluate.main([
                '--real-dir', a.real_dir, '--fake-dir', fake_dir,
                '--image-size', str(a.image_size), '--extractor', ex,
                '--output', os.path.join(a.outdir,
                                         f'eval_{step:06d}_{ex}.json'),
                '--device', device])
            row[f'fid_{ex}'] = r['fid']
            row[f'kid_{ex}'] = r['kid']
        rows.append(row)
        print(f'[campaign_eval] step {step}: {row}')
    table = os.path.join(a.outdir, 'fid_table.json')
    with open(table, 'w') as f:
        json.dump(rows, f, indent=1)
    print(f'[campaign_eval] wrote {table}')
    print('| step | FID (vgg-rel) | KID (vgg-rel) | FID (pixel) | '
          'KID (pixel) |')
    print('|---|---|---|---|---|')
    for r in rows:
        print(f'| {r["step"]} | {r["fid_vgg19"]:.4f} | '
              f'{r["kid_vgg19"]:.6f} | {r["fid_pixel"]:.4f} | '
              f'{r["kid_pixel"]:.6f} |')
    return rows


def smoke_render(argv=None):
    """One PCG scene -> a short trajectory with a seeded, untrained
    generator (terrain -> voxel world -> K1 -> hash field -> sky ->
    compositing -> RenderCNN -> PNG / mp4) at the JAX script's defaults:
    scene 1024, 270x480, 8 samples, 10 frames. Returns the uint8
    frames."""
    p = argparse.ArgumentParser(description=smoke_render.__doc__)
    p.add_argument('--outdir', default='smoke_out')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--scene-size', type=int, default=1024)
    p.add_argument('--resolution', type=int, nargs=2, default=[270, 480])
    p.add_argument('--num-samples', type=int, default=8)
    p.add_argument('--frames', type=int, default=10)
    p.add_argument('--camera-mode', type=int, default=0)
    p.add_argument('--tile-size', type=int, default=128)
    _device_flags(p)
    a = p.parse_args(argv)
    device = _device(a)
    import torch
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import render_trajectory
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    t0 = time.time()
    maps = generate_terrain(size=a.scene_size, seed=a.seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=a.seed)
    print(f'[smoke] world {world.dims} in {time.time() - t0:.1f}s')
    cfg = GeneratorConfig(num_samples=a.num_samples)
    model = SceneDreamerGenerator(cfg, seed=a.seed).to(device).eval()
    style = torch.randn((1, cfg.style_dims),
                        generator=torch.Generator().manual_seed(a.seed))
    t0 = time.time()
    frames = render_trajectory(
        model, world, style.numpy(), a.outdir, camera_mode=a.camera_mode,
        cam_maxstep=a.frames, num_samples=a.num_samples,
        num_blocks_early_stop=6, pad=6, tile_size=a.tile_size,
        resolution_hw=tuple(a.resolution), fps=10, seed=a.seed,
        device=device)
    dt = time.time() - t0
    rays = a.resolution[0] * a.resolution[1] * len(frames)
    print(f'[smoke] {len(frames)} frames in {dt:.1f}s '
          f'({rays / dt / 1e3:.1f}k rays/s) -> {a.outdir}/rgb_render')
    return frames
