"""The port's evaluation against the JAX package's: `utils/fid.py`, the
INTER_AREA resize of `data/image_ops.py`, `cli/evaluate.py`'s loaders
and extractors, and the CLI itself.

* FID and KID of seeded features equal to JAX's (relative 1e-12: the
  same float64 numpy).
* `resize_area` against `cv2.resize(INTER_AREA)` (skipped without
  OpenCV): uint8 within one level, float32 within 1e-5, on an integer
  shrink, a non-integer shrink, an enlargement and the evaluation's own
  three calls (the reals to 256, 16x16 pixel patches, 270x480 frames to
  256).
* `load_images` within 1/127.5 of JAX's (one uint8 level); the pixel
  extractor within 1e-5 of JAX's on the same images.
* VGG features (`relu_5_1`, 32 px images) within 1e-4: JAX's random VGG
  as a torchvision-keyed `.npz` through `convert_torch_vgg19` in both
  packages (the port's weights equal to `vgg_state_dict_from_flax`'s of
  the same flax params), against JAX's own random-init extractor too.
* The CLI on `--fake-dir`: the JSON line against JAX's CLI on the same
  folders, for both extractors (the VGG from that `.npz`): counts equal,
  fid / kid / kid_std within 1e-3 relative + 1e-6.
  JAX's `make_feature_fn` wraps `convert_torch_vgg19`'s {'params': ...}
  in a second {'params': ...}, which flax refuses, so its
  `--vgg-checkpoint` cannot run as shipped; the tests that use it take
  the converter's inner dict (`jax_vgg_checkpoint_fixed`). The port's
  CLI loads the file as it is.
* The CLI's `--checkpoint random` route on the CPU at small sizes:
  `num_fake` = seeds x cam_maxstep, its saved frames equal to
  `TiledRenderer.frame`'s for the same seeded generator and style.
"""
import json

import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from scenedreamer_tpu.cli import evaluate as jev
from scenedreamer_tpu.utils import fid as jfid
from scenedreamer_tpu_torch.cli import evaluate as tev
from scenedreamer_tpu_torch.data.image_ops import resize_area
from scenedreamer_tpu_torch.utils import fid as tfid
from scenedreamer_tpu_torch.utils.png import write_png

cap_torch_threads()

TAP = 'relu_5_1'


def test_fid_and_kid_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 8))
    b = rng.standard_normal((30, 8)) * 1.3 + 0.2
    assert tfid.compute_fid(a, b) == pytest.approx(jfid.compute_fid(a, b),
                                                   rel=1e-12)
    for size in (1000, 12):
        got = tfid.compute_kid(a, b, subset_size=size)
        want = jfid.compute_kid(a, b, subset_size=size)
        assert got == pytest.approx(want, rel=1e-12)
    mu, sigma = tfid.activation_statistics(a[:, :1])
    assert sigma.shape == (1, 1)
    with pytest.raises(ValueError):
        tfid.compute_kid(a[:1], b)


@pytest.mark.parametrize('src,dst', [
    ((64, 96), (32, 48)),        # integer shrink (2x2 blocks)
    ((48, 60), (16, 20)),        # integer shrink (3x3 blocks)
    ((100, 150), (37, 53)),      # non-integer shrink
    ((30, 50), (77, 41)),        # enlarge one axis, shrink the other
    ((40, 60), (96, 128)),       # enlargement
    ((300, 420), (256, 256)),    # the reals to --image-size
    ((256, 256), (16, 16)),      # the pixel extractor's patch
    ((270, 480), (256, 256)),    # a rendered frame to --image-size
])
def test_resize_area_matches_opencv(src, dst):
    cv2 = pytest.importorskip('cv2')
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    f32 = rng.uniform(-1, 1, src + (3,)).astype(np.float32)
    size = (dst[1], dst[0])
    got = resize_area(u8, dst)
    want = cv2.resize(u8, size, interpolation=cv2.INTER_AREA)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    got = resize_area(f32, dst)
    want = cv2.resize(f32, size, interpolation=cv2.INTER_AREA)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(resize_area(u8[..., 0], dst).shape, dst)


def _write_set(root, n, hw, seed):
    """n RGB PNGs of a smooth random field plus noise."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]] / max(hw)
    for i in range(n):
        c = rng.uniform(0, 255, (3, 3))
        img = (c[0] * yy[..., None] / 3 + c[1] * xx[..., None] / 3
               + c[2] / 3 + rng.uniform(0, 40, hw + (3,)))
        write_png(str(root / f'{i:03d}.png'),
                  np.clip(img, 0, 255).astype(np.uint8))
    return str(root)


@pytest.fixture(scope='module')
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp('eval')
    real = _write_set(root / 'real' / 'images', 12, (40, 52), 0)
    (root / 'real' / 'seg_maps').mkdir()
    write_png(str(root / 'real' / 'seg_maps' / 'x.png'),
              np.zeros((4, 4), np.uint8))
    fake = _write_set(root / 'fake', 9, (36, 36), 1)
    return root, str(root / 'real'), fake, real


def test_list_and_load_images_match_jax(folders):
    pytest.importorskip('cv2')
    _, real_root, fake, real_images = folders
    paths = tev.list_images(real_root)
    assert paths == jev.list_images(real_root) and len(paths) == 12
    assert all(p.startswith(real_images) for p in paths)
    assert tev.list_images(real_root, 5) == paths[:5]
    for size in (32, 64):
        got = tev.load_images(paths, size)
        want = jev.load_images(paths, size)
        assert got.shape == want.shape == (12, size, size, 3)
        np.testing.assert_allclose(got, want, atol=1 / 127.5 + 1e-6, rtol=0)
    images = jev.load_images(paths, 32)
    got = tev.make_pixel_feature_fn()(images)
    want = jev.make_pixel_feature_fn()(images)
    assert got.dtype == np.float64 and got.shape == (12, 768)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope='module')
def jax_vgg(tmp_path_factory):
    """JAX's random VGG (the init its evaluate CLI makes at 32 px), and
    the same weights as a torchvision-keyed .npz."""
    import jax
    import jax.numpy as jnp
    from scenedreamer_tpu.models.vgg import _VGG19_CFG, VGG19Features
    params = VGG19Features(layers=(TAP,)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tv, idx = {}, 0
    for i, (_, _, pool) in enumerate(_VGG19_CFG):
        idx += 1 if pool else 0
        leaf = params['params'].get(f'conv{i}')
        if leaf is not None:
            tv[f'features.{idx}.weight'] = leaf['kernel'].transpose(3, 2, 0, 1)
            tv[f'features.{idx}.bias'] = leaf['bias']
        idx += 2
    path = str(tmp_path_factory.mktemp('vgg') / 'vgg19.npz')
    np.savez(path, **tv)
    return params, path


@pytest.fixture
def jax_vgg_checkpoint_fixed(monkeypatch):
    """JAX's converter as its evaluate CLI needs it: the inner dict."""
    from scenedreamer_tpu.models import vgg as jvgg
    convert = jvgg.convert_torch_vgg19
    monkeypatch.setattr(jvgg, 'convert_torch_vgg19',
                        lambda sd: convert(sd)['params'])


def test_vgg_features_match_jax(jax_vgg, jax_vgg_checkpoint_fixed):
    from scenedreamer_tpu_torch.models.vgg import (VGG19Features,
                                                   convert_torch_vgg19)
    from scenedreamer_tpu_torch.utils.convert import vgg_state_dict_from_flax
    params, npz = jax_vgg
    # the flax converter and the torchvision one give the same weights
    model = VGG19Features(layers=(TAP,))
    model.load_state_dict(vgg_state_dict_from_flax(params))
    tv = convert_torch_vgg19(dict(np.load(npz)))
    for k, v in model.state_dict().items():
        assert torch.equal(tv[k], v), k
    images = np.random.default_rng(2).uniform(-1, 1, (5, 32, 32, 3)).astype(
        np.float32)
    want = jev.make_feature_fn(32, batch=2)(images)
    got = tev.make_feature_fn(32, npz, batch=3, device='cpu')(images)
    assert got.shape == want.shape == (5, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, jev.make_feature_fn(32, npz)(images),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize('extractor', ['pixel', 'vgg19'])
def test_cli_fake_dir_matches_jax_cli(folders, jax_vgg, extractor,
                                      jax_vgg_checkpoint_fixed, monkeypatch):
    pytest.importorskip('cv2')
    monkeypatch.setenv('SCENEDREAMER_NO_CACHE', '1')
    root, real, fake, _ = folders
    argv = ['--real-dir', real, '--fake-dir', fake, '--image-size', '32',
            '--extractor', extractor, '--kid-subset-size', '6',
            '--platform', 'cpu']
    if extractor == 'vgg19':
        argv += ['--vgg-checkpoint', jax_vgg[1]]
    out = {}
    for name, mod in (('jax', jev), ('port', tev)):
        path = str(root / f'{name}_{extractor}.json')
        mod.main(argv + ['--output', path])
        with open(path) as f:
            out[name] = json.loads(f.read())
    want, got = out['jax'], out['port']
    assert got['extractor'] == want['extractor'] == (
        'pixel16' if extractor == 'pixel' else 'vgg19')
    assert (got['num_real'], got['num_fake']) == (12, 9)
    assert (want['num_real'], want['num_fake']) == (12, 9)
    for k in ('fid', 'kid', 'kid_std'):
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-6, \
            (k, got[k], want[k])
    assert want['fid'] > 0


def test_cli_checkpoint_route_renders_tiled_frames(folders, tmp_path):
    from scenedreamer_tpu_torch.data.paired_dataset import decode_image
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                        to_uint8)
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world
    _, real, _, _ = folders
    flags = dict(scene_size=64, resolution=(10, 14), num_samples=2, pad=2,
                 tile_size=8, cam_maxstep=2)
    argv = ['--real-dir', real, '--checkpoint', 'random', '--seeds', '3',
            '--image-size', '16', '--extractor', 'pixel', '--device', 'cpu',
            '--save-frames', str(tmp_path / 'frames')]
    for k, v in flags.items():
        argv += [f'--{k}'] + [str(x) for x in np.atleast_1d(v)]
    timings = []
    result = tev.main(argv, timings=timings)
    assert result['num_fake'] == 2 and len(timings) == 2
    assert np.isfinite([result['fid'], result['kid']]).all()
    maps = generate_terrain(size=64, seed=3)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=3)
    model = SceneDreamerGenerator(GeneratorConfig(num_samples=2), seed=3)
    r = TiledRenderer(model, world, num_samples=2, pad=2, tile_size=8,
                      resolution_hw=(10, 14), device='cpu')
    z = r.style_z(torch.randn((1, 128), generator=torch.Generator()
                              .manual_seed(3)).numpy())
    poses = EvalCameraController(world, pattern=4, maxstep=2, cam_ang=72)
    for i, pose in enumerate(poses):
        want = to_uint8(np.clip(r.frame(pose, z), -1, 1))
        got = decode_image((tmp_path / 'frames' / f'{i:04d}.png')
                           .read_bytes())
        np.testing.assert_array_equal(got, want)


def test_cli_defaults_to_cuda(folders):
    """Without a GPU the CLI refuses the default device before any work,
    on either route, unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the default device is usable')
    _, real, fake, _ = folders
    for argv in (['--fake-dir', fake], ['--checkpoint', 'random'],
                 ['--fake-dir', fake, '--platform', 'gpu']):
        with pytest.raises(RuntimeError, match='CUDA'):
            tev.main(['--real-dir', real] + argv)
    with pytest.raises(SystemExit):
        tev.main(['--real-dir', real])
