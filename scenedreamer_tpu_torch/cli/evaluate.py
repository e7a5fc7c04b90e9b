"""Evaluation CLI: FID and KID between a real image set and rendered
frames.

Counterpart of `scenedreamer_tpu/cli/evaluate.py`, with its flags and
defaults: real images and either pre-rendered frames (`--fake-dir`) or
frames rendered here from a checkpoint (`--checkpoint`; 'random' = a
random init from the first seed, for smoke runs) -> features -> FID and
KID (`utils/fid.py`) as one JSON line `{fid, kid, kid_std, num_real,
num_fake, extractor}`, also written to `--output` when given.

The extractor is VGG19's `relu_5_1`, global-average-pooled
(`models/vgg.py`, random-init or torchvision weights through
`--vgg-checkpoint`), or `pixel`: 16x16 area-resized RGB patches, which
need no weights. Scores are comparable within one extractor; they are
not Inception-FID (its weights are not in the repository).

Rendering: one scene per `--seeds` entry (terrain, a 16-deep voxel
world), `--cam_maxstep` frames of `EvalCameraController` through
`TiledRenderer` (kernels K1, K2a, K2b on the card), each frame clipped
to [-1, 1] and area-resized to `--image-size`. Each seed's style is drawn
from a `torch.Generator` seeded with it, as the port's other CLIs draw
theirs, so the fake set differs from the JAX CLI's for the same seed.
`--save-frames DIR` also writes the rendered frames as PNG, a
`--fake-dir` for a later run. Images are decoded by
`data/paired_dataset.py:decode_image` and resized by
`data/image_ops.py:resize_area` (OpenCV's INTER_AREA in numpy), so no
image library is needed.

The JAX CLI turns on XLA's persistent compilation cache; the port has no
counterpart to it: its kernels build once into
`scenedreamer_tpu_torch/_build/` and are loaded from there after.

Runs on CUDA; `--device cpu` (or `--platform cpu`) runs the plain
PyTorch path.

Usage:
    python -m scenedreamer_tpu_torch.cli.evaluate --real-dir data/lhq/images \
        --fake-dir out/rgb_render
    python -m scenedreamer_tpu_torch.cli.evaluate --real-dir data/lhq/images \
        --checkpoint logs/run/checkpoints --seeds 1 2 3 --cam_maxstep 8
"""
import argparse
import glob
import json
import os
import time

IMG_EXTS = ('*.png', '*.jpg', '*.jpeg', '*.webp')


def list_images(root, limit=0):
    """Image files in root, sorted. If root has an `images/` subdir (the
    paired-dataset layout), only that subdir is used, so `seg_maps/`
    never joins the feature set."""
    img_sub = os.path.join(root, 'images')
    scan = img_sub if os.path.isdir(img_sub) else root
    paths = []
    for ext in IMG_EXTS:
        paths += glob.glob(os.path.join(scan, ext))
    paths = sorted(set(paths))
    return paths[:limit] if limit else paths


def load_images(paths, size):
    """-> float32 [N, size, size, 3] RGB in [-1, 1]; files that do not
    decode are skipped, as the JAX CLI skips them."""
    import numpy as np
    from scenedreamer_tpu_torch.data.image_ops import resize_area
    from scenedreamer_tpu_torch.data.paired_dataset import decode_image
    out = []
    for p in paths:
        with open(p, 'rb') as f:
            buf = f.read()
        try:
            img = decode_image(buf)
        except (ValueError, OSError):
            continue
        img = resize_area(img, (size, size))
        out.append(img.astype(np.float32) / 127.5 - 1.0)
    if not out:
        raise SystemExit('no readable images found')
    return np.stack(out)


def make_pixel_feature_fn(grid=16):
    """VGG-independent extractor: each image area-resized to a grid x
    grid RGB patch and flattened (float64). FID / KID over these measure
    the colour and low-frequency structure of the two sets, with no
    dependence on VGG weights."""
    import numpy as np
    from scenedreamer_tpu_torch.data.image_ops import resize_area

    def run(images):
        out = [resize_area(im, (grid, grid)).reshape(-1) for im in images]
        return np.stack(out).astype(np.float64)

    return run


def make_feature_fn(image_size, vgg_checkpoint='', tap='relu_5_1',
                    batch=16, device=None):
    """-> callable [N, H, W, 3] in [-1, 1] (numpy) -> [N, D] features:
    VGG19's `tap`, global-average-pooled, `batch` images per forward.
    `vgg_checkpoint`: a torchvision `vgg19().features` state dict (`.pt`
    or `.npz`), converted by `convert_torch_vgg19`; without it the VGG is
    a random init from seed 0. `image_size` is the JAX CLI's argument
    (its traced input shape); the port takes any size."""
    import numpy as np
    import torch
    from scenedreamer_tpu_torch.device import resolve_device
    from scenedreamer_tpu_torch.models.vgg import (VGG19Features,
                                                   convert_torch_vgg19,
                                                   imagenet_normalize)
    del image_size
    device = resolve_device(device)
    model = VGG19Features(layers=(tap,))
    if vgg_checkpoint:
        if vgg_checkpoint.endswith('.npz'):
            sd = dict(np.load(vgg_checkpoint))
        else:
            sd = torch.load(vgg_checkpoint, map_location='cpu')
        own = model.state_dict()
        model.load_state_dict({k: v for k, v in
                               convert_torch_vgg19(sd).items() if k in own})
    else:
        print('[evaluate] no --vgg-checkpoint: random-init VGG features '
              '(relative scores only)')
    model = model.to(device).eval()

    @torch.no_grad()
    def run(images):
        outs = []
        for s in range(0, len(images), batch):
            x = torch.as_tensor(np.asarray(images[s:s + batch],
                                           np.float32), device=device)
            taps = model(imagenet_normalize(x))
            outs.append(taps[tap].mean(dim=(1, 2)).float().cpu().numpy())
        return np.concatenate(outs)

    return run


def render_frames(a, device=None, timings=None):
    """Render `cam_maxstep` frames per seed from `a.checkpoint` ->
    float32 [N, h, w, 3] in [-1, 1] (in memory). `timings`, a list,
    receives each frame's seconds (host clock; a frame is fetched to the
    host, so it has finished)."""
    import numpy as np
    import torch
    from scenedreamer_tpu_torch.cli.inference import load_generator
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
    from scenedreamer_tpu_torch.scene import camera as camctl
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    cfg = GeneratorConfig(num_samples=a.num_samples)
    frames, model = [], None
    for seed in a.seeds:
        maps = generate_terrain(size=a.scene_size, seed=seed)
        world = build_voxel_world(maps.height_map, maps.semantic_map,
                                  maps.tree_map, fill_depth=16, seed=seed)
        if model is None:    # the weights do not depend on the seed
            ckpt = '' if a.checkpoint == 'random' else a.checkpoint
            model = load_generator(ckpt, cfg, device, seed=seed)
        style = torch.randn((1, cfg.style_dims),
                            generator=torch.Generator().manual_seed(seed))
        r = TiledRenderer(model, world, num_samples=a.num_samples,
                          pad=a.pad, tile_size=a.tile_size,
                          resolution_hw=tuple(a.resolution), device=device)
        z = r.style_z(style.numpy())
        ctl = camctl.EvalCameraController(
            world, pattern=a.camera_mode, maxstep=a.cam_maxstep,
            cam_ang=a.cam_ang)
        for pose in ctl:
            t0 = time.perf_counter()
            frames.append(np.clip(r.frame(pose, z), -1.0, 1.0))
            if timings is not None:
                timings.append(time.perf_counter() - t0)
    return np.stack(frames)


def main(argv=None, timings=None):
    """Run the CLI; returns the result dict it prints. `timings`, a
    list, receives each rendered frame's seconds."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--real-dir', required=True,
                   help='folder of real images (flat or images/ subdir)')
    p.add_argument('--fake-dir', default='',
                   help='folder of rendered frames to score')
    p.add_argument('--checkpoint', default='',
                   help="render frames from this checkpoint instead "
                        "('random' = fresh init, for smoke runs)")
    p.add_argument('--seeds', type=int, nargs='+', default=[8888])
    p.add_argument('--scene_size', type=int, default=1024)
    p.add_argument('--camera_mode', type=int, default=4)
    p.add_argument('--cam_maxstep', type=int, default=8)
    p.add_argument('--cam_ang', type=int, default=72)
    p.add_argument('--resolution', type=int, nargs=2, default=[270, 480])
    p.add_argument('--num_samples', type=int, default=24)
    p.add_argument('--pad', type=int, default=30)
    p.add_argument('--tile_size', type=int, default=128)
    p.add_argument('--image-size', type=int, default=256,
                   help='resize everything to this before features')
    p.add_argument('--max-images', type=int, default=0,
                   help='cap on real/fake set sizes (0 = all)')
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--vgg-checkpoint', default='',
                   help='torchvision vgg19 .pt/.npz for real features')
    p.add_argument('--extractor', default='vgg19',
                   choices=['vgg19', 'pixel'],
                   help="'pixel' = 16x16 RGB patch statistics, "
                        'VGG-independent')
    p.add_argument('--kid-subset-size', type=int, default=1000)
    p.add_argument('--output', default='',
                   help='also write the JSON result here')
    p.add_argument('--save-frames', default='',
                   help='also write the rendered frames here as PNG')
    p.add_argument('--platform', default=None,
                   help="'cpu', or 'gpu' / 'cuda' (the default); "
                        '--device wins when both are given')
    p.add_argument('--device', default=None,
                   help="torch device (default 'cuda'; 'cpu' runs the "
                        'plain PyTorch path)')
    a = p.parse_args(argv)
    if bool(a.fake_dir) == bool(a.checkpoint):
        raise SystemExit('give exactly one of --fake-dir / --checkpoint')

    import numpy as np
    from scenedreamer_tpu_torch.data.image_ops import resize_area
    from scenedreamer_tpu_torch.device import (device_from_flags,
                                               resolve_device)
    from scenedreamer_tpu_torch.render.pipeline import to_uint8
    from scenedreamer_tpu_torch.utils.fid import compute_fid, compute_kid
    from scenedreamer_tpu_torch.utils.png import write_png

    device = resolve_device(device_from_flags(a.device, a.platform))
    real = load_images(list_images(a.real_dir, a.max_images), a.image_size)
    if a.fake_dir:
        fake = load_images(list_images(a.fake_dir, a.max_images),
                           a.image_size)
    else:
        rendered = render_frames(a, device, timings)
        if a.save_frames:
            os.makedirs(a.save_frames, exist_ok=True)
            for i, f in enumerate(rendered):
                write_png(os.path.join(a.save_frames, f'{i:04d}.png'),
                          to_uint8(f))
        fake = np.stack([resize_area(f, (a.image_size, a.image_size))
                         for f in rendered])
        if a.max_images:
            fake = fake[:a.max_images]
    print(f'[evaluate] real={len(real)} fake={len(fake)} '
          f'@ {a.image_size}px')

    if a.extractor == 'pixel':
        feats = make_pixel_feature_fn()
        ex_name = 'pixel16'
    else:
        feats = make_feature_fn(a.image_size, a.vgg_checkpoint,
                                batch=a.batch, device=device)
        ex_name = 'vgg19' if a.vgg_checkpoint else 'vgg19-random-init'
    fr, ff = feats(real), feats(fake)
    fid = compute_fid(fr, ff)
    kid_mean, kid_std = compute_kid(fr, ff, subset_size=a.kid_subset_size)
    result = {'fid': round(fid, 4), 'kid': round(kid_mean, 6),
              'kid_std': round(kid_std, 6), 'num_real': len(real),
              'num_fake': len(ff), 'extractor': ex_name}
    line = json.dumps(result)
    print(line)
    if a.output:
        with open(a.output, 'w') as f:
            f.write(line + '\n')
    return result


if __name__ == '__main__':
    main()
