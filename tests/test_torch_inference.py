"""The rest of the port's serving path against the JAX package, on the
CPU, with the flax-initialised TINY weights of `test_golden.py`: the
padded-tile route (`split_refine=False`) against the golden `*_tile`
frames, tiles per batch, the RenderCNN row strips, bf16 compute, the
trajectory's style interpolation, depth and voxel frames and mp4, the
reference state-dict loader, the inference CLI's new flags and the
demo's BEV maps.

Tolerances: images atol 1e-3 as the golden tests (a uint8 LSB is
~7.8e-3; JAX's own golden split and tile frames differ by up to 1.6e-4);
regrouping tiles or cutting the CNN into strips changes only GEMM and
conv blocking, atol 1e-5 as JAX's own strip test; bf16 is held to JAX's
bf16-to-float32 distance, measured here on the same frame."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.models.generator import \
    SceneDreamerGenerator as JGen
from scenedreamer_tpu.render.pipeline import TiledRenderer as JRenderer
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                    render_trajectory,
                                                    to_uint8)
from scenedreamer_tpu_torch.utils.convert import \
    generator_state_dict_from_flax
from scenedreamer_tpu_torch.utils.png import read_png
from _torch_parity import cap_torch_threads, port_config
from test_golden import FIXTURE, IMG_ATOL, KW, TINY, _poses

cap_torch_threads()

PKW = {k: v for k, v in KW.items() if k != 'fov'}
BF16 = dataclasses.replace(TINY, dtype=jnp.bfloat16)


@pytest.fixture(scope='module')
def setup():
    """The golden tests' world, flax model and params (their init, jitted:
    a quarter of the eager init's time, leaves within 6e-8 of it; without
    the style encoder, which serving does not run: the port keeps its
    own init there), the same weights in the port, and the golden
    style."""
    from scenedreamer_tpu.data.synthetic import make_batch, make_world
    from scenedreamer_tpu.scene.labels import get_label_translator
    # built outside the trace: the translator is cached, and one made
    # while tracing would keep the trace's arrays
    get_label_translator()
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    jmodel = JGen(cfg=TINY)
    batch = make_batch(world, batch_size=1, height=20, width=20,
                       max_samples=4, pad=TINY.pad, seed=0,
                       include_gan_data=False)
    params = jax.jit(lambda key, b: jmodel.init(
        {'params': key}, b, world.dims, key, random_style=True))(
        jax.random.PRNGKey(0), batch)
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = SceneDreamerGenerator(port_config(TINY))
    missing, unexpected = tmodel.load_state_dict(
        generator_state_dict_from_flax(params), strict=False)
    assert not unexpected
    assert missing and all(k.startswith('style_encoder.') for k in missing)
    tmodel.eval()
    style = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                         (1, TINY.style_dims)))
    return world, jmodel, params, tmodel, style


def _bf16_port(params):
    model = SceneDreamerGenerator(dataclasses.replace(
        port_config(TINY), dtype=torch.bfloat16))
    model.load_state_dict(generator_state_dict_from_flax(params),
                          strict=False)
    return model.eval()


@pytest.mark.parametrize('pose', ['tour', 'sky'])
def test_padded_tile_frame_matches_golden(setup, pose):
    world, _, _, tmodel, style = setup
    r = TiledRenderer(tmodel, world, tile_size=16, split_refine=False,
                      device='cpu', **PKW)
    img = r.frame(_poses(world)[pose], r.style_z(style))
    np.testing.assert_allclose(img, np.load(FIXTURE)[f'{pose}_tile'],
                               atol=IMG_ATOL, rtol=0)
    st = r.last_stats
    assert st['tiles'] == 6 and st['batches'] == 6
    # the sky pose has pure-sky tiles, which skip the field
    assert (st['tiles_sky_only'] > 0) == (pose == 'sky')


@pytest.mark.parametrize('tiles_per_batch', [3, 4])
def test_tiles_per_batch_matches_one(setup, tiles_per_batch):
    """Stacked batches of tiles (4: the short last group repeats its last
    tile) equal one tile per call."""
    world, _, _, tmodel, style = setup
    pose = _poses(world)['sky']
    imgs = []
    for tb in (1, tiles_per_batch):
        r = TiledRenderer(tmodel, world, tile_size=16, split_refine=False,
                          tiles_per_batch=tb, device='cpu', **PKW)
        imgs.append(r.frame(pose, r.style_z(style), return_aux=True))
    assert r.last_stats['batches'] == -(-6 // tiles_per_batch)
    np.testing.assert_allclose(imgs[1][0], imgs[0][0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(imgs[1][1]['depth'], imgs[0][1]['depth'])


def test_strips_match_whole_cnn(setup, monkeypatch):
    """The RenderCNN in halo'd row strips (the giant-frame mode, forced
    on here) against the whole-frame CNN, as JAX's
    `test_split_refine_strips_match_full`."""
    world, _, _, tmodel, style = setup
    monkeypatch.setenv('SCENEDREAMER_REFINE_FULL_PX', '0')
    monkeypatch.setenv('SCENEDREAMER_REFINE_STRIP', '10')
    r_strips = TiledRenderer(tmodel, world, device='cpu', **PKW)
    assert not r_strips.refine_full and r_strips.strip_rows == 10
    monkeypatch.undo()
    r_full = TiledRenderer(tmodel, world, device='cpu', **PKW)
    assert r_full.refine_full
    pose = _poses(world)['tour']
    z = r_full.style_z(style)
    np.testing.assert_allclose(r_strips.frame(pose, z), r_full.frame(pose, z),
                               atol=1e-5, rtol=0)


# TINY with every bf16 layer at the flagship width (style 128 -> 256,
# RenderMLP 256, feature 64; the RenderCNN is 256 wide in both); the hash
# grid, float32 in both dtypes, stays small
WIDE = dataclasses.replace(TINY, style_dims=128, interm_style_dims=256,
                           final_feat_dim=64, mlp_hidden=256)


@pytest.mark.parametrize('width', ['tiny', 'wide'])
def test_bf16_frame_within_jax_bf16_distance(setup, width):
    """The port's bf16 frame is no further from JAX's bf16 frame (same
    weights) than JAX's bf16 frame is from its float32 one: at TINY on
    the golden weights, and at the flagship layer widths on the port's
    seeded init, converted to flax by JAX's own converter. The card's
    bf16 limit (`chip_smoke.BF16_JAX_MAX`, `BF16_JAX_MEAN`) comes from the
    full flagship width (`tests/test_torch_bf16_limit.py`)."""
    from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
    world, _, params, _, style = setup
    pose = _poses(world)['tour']
    if width == 'tiny':
        cfg, j32 = TINY, np.load(FIXTURE)['tour_split']
    else:
        cfg = WIDE
        params = convert_scenedreamer_generator(
            SceneDreamerGenerator(port_config(WIDE), seed=3).state_dict())
        params = jax.tree_util.tree_map(np.asarray, params)
        style = np.random.default_rng(5).standard_normal(
            (1, WIDE.style_dims)).astype(np.float32)
        jr = JRenderer(JGen(cfg=WIDE), params, world, tile_size=16, **KW)
        j32 = np.asarray(jr.frame(pose, jr.style_z(style)))
    jr = JRenderer(JGen(cfg=dataclasses.replace(cfg, dtype=jnp.bfloat16)),
                   params, world, tile_size=16, **KW)
    j16 = np.asarray(jr.frame(pose, jr.style_z(style)))
    model = SceneDreamerGenerator(dataclasses.replace(
        port_config(cfg), dtype=torch.bfloat16))
    model.load_state_dict(generator_state_dict_from_flax(params),
                          strict=False)
    r = TiledRenderer(model.eval(), world, device='cpu', **PKW)
    z = r.style_z(style)
    assert z.dtype == torch.bfloat16
    t16 = r.frame(pose, z)
    assert t16.dtype == np.float32 and np.isfinite(t16).all()
    limit = float(np.abs(j16 - j32).max())
    err = float(np.abs(t16 - j16).max())
    print(f'[bf16 {width}] JAX bf16 vs float32 max {limit:.4g} mean '
          f'{np.abs(j16 - j32).mean():.4g} (frame max {np.abs(j32).max():.4g})'
          f'; port bf16 vs JAX bf16 max {err:.4g}')
    assert 0 < limit < 0.5, limit
    assert err <= limit, (err, limit)


@pytest.mark.parametrize('split_refine', [True, False])
def test_bf16_sky_skip_bit_exact(setup, split_refine):
    """Under bf16 the sky-only zeros come in the compute dtype, so pure-sky
    chunks or tiles that skip the field give the full path's frame bit
    for bit (JAX `tests/test_render.py:193`)."""
    world, _, params, _, style = setup
    model = _bf16_port(params)
    pose = _poses(world)['sky']
    out = []
    for sky_fast in (True, False):
        r = TiledRenderer(model, world, tile_size=16, chunk_rays=200,
                          split_refine=split_refine, sky_fast=sky_fast,
                          device='cpu', **PKW)
        out.append((r.frame(pose, r.style_z(style)), r.last_stats))
    (fast, st), (slow, _) = out
    skipped = st['chunks_sky_only'] if split_refine else st['tiles_sky_only']
    assert skipped > 0
    np.testing.assert_array_equal(fast, slow)


@pytest.fixture(scope='module')
def trajectory(setup, tmp_path_factory):
    """Two frames with a [2, style_dims] style and `save_depth`."""
    world, _, _, tmodel, _ = setup
    out = tmp_path_factory.mktemp('traj')
    styles = np.random.default_rng(3).standard_normal(
        (2, TINY.style_dims)).astype(np.float32)
    timings = []
    frames = render_trajectory(tmodel, world, styles, str(out),
                               camera_mode=4, cam_maxstep=2, save_depth=True,
                               device='cpu', timings=timings, **PKW)
    return frames, styles, out, timings


def _trajectory_poses(world):
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    return list(EvalCameraController(world, maxstep=2, pattern=4, cam_ang=72,
                                     smooth_decay_multiplier=75.0))


def test_style_interpolation_frame_by_frame(setup, trajectory):
    world, _, _, tmodel, _ = setup
    frames, styles, out, timings = trajectory
    assert len(frames) == 2 and len(timings) == 2
    assert np.load(out / 'rgb_render' / 'style.npy').shape == styles.shape
    r = TiledRenderer(tmodel, world, device='cpu', **PKW)
    for i, pose in enumerate(_trajectory_poses(world)):
        img = r.frame(pose, r.style_z(styles[i:i + 1]))
        np.testing.assert_array_equal(to_uint8(img), frames[i])
    assert not np.array_equal(frames[0], to_uint8(
        r.frame(_trajectory_poses(world)[0], r.style_z(styles[1:]))))


def test_save_depth_files_match_jax(setup, trajectory):
    """`<i>_depth.png` and `<i>_voxel.png` hold JAX's `colormap` of the
    frame's depth (non-finite set to NaN) and JAX's `mc_color` of its
    first voxel ids."""
    from scenedreamer_tpu.scene.labels import get_label_translator
    from scenedreamer_tpu.utils.visualization import colormap
    world, _, _, tmodel, _ = setup
    _, styles, out, _ = trajectory
    r = TiledRenderer(tmodel, world, device='cpu', **PKW)
    for i, pose in enumerate(_trajectory_poses(world)):
        _, aux = r.frame(pose, r.style_z(styles[i:i + 1]), return_aux=True)
        d = aux['depth'].copy()
        d[~np.isfinite(d)] = np.nan
        want = (colormap(d) * 255).astype(np.uint8)
        with open(out / 'rgb_render' / f'{i:05d}_depth.png', 'rb') as f:
            np.testing.assert_array_equal(read_png(f.read()), want)
        want = get_label_translator().mc_color(aux['first_voxel_id'])
        with open(out / 'rgb_render' / f'{i:05d}_voxel.png', 'rb') as f:
            np.testing.assert_array_equal(read_png(f.read()), want)


def test_mp4_reads_back(trajectory):
    import cv2
    frames, _, out, _ = trajectory
    cap = cv2.VideoCapture(str(out / 'rgb_render.mp4'))
    n = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        assert img.shape == frames[0].shape
        n += 1
    cap.release()
    assert n == len(frames)


def _reference_dict(tmodel):
    """The port's state dict as a reference checkpoint would hold it: a
    `module.` prefix, denoiser.conv2a spectral-normed (stored u and v
    with u . (W v) = 1), the style encoder's name variants."""
    sd = {}
    for k, v in tmodel.state_dict().items():
        v = v.numpy().copy()
        if k == 'denoiser.conv2a.weight':
            rng = np.random.default_rng(0)
            vv = rng.standard_normal(v[0].size)
            vv /= np.linalg.norm(vv)
            wv = v.reshape(v.shape[0], -1).astype(np.float64) @ vv
            sd['module.denoiser.conv2a.weight_orig'] = v
            sd['module.denoiser.conv2a.weight_u'] = wv / (wv @ wv)
            sd['module.denoiser.conv2a.weight_v'] = vv
            continue
        k = k.replace('style_encoder.layer1.', 'style_encoder.layer1.'
                      'layers.conv.')
        k = k.replace('style_encoder.fc_mu.', 'style_encoder.fc_mu.fc.')
        k = k.replace('style_encoder.fc_var.', 'style_encoder.fc_var.'
                      'layers.linear.')
        sd['module.' + k] = v
    return sd


def test_reference_state_dict_matches_jax_converter(setup):
    """`load_reference_generator_state_dict` and JAX's
    `convert_scenedreamer_generator` read the same reference dict; the
    port's frame equals JAX's frame on JAX's converted params."""
    from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
    from scenedreamer_tpu_torch.utils.convert import \
        load_reference_generator_state_dict
    world, jmodel, params, tmodel, style = setup
    ref = _reference_dict(tmodel)
    sd = load_reference_generator_state_dict({'net_G': ref})
    loaded = SceneDreamerGenerator(port_config(TINY))
    loaded.load_state_dict(sd, strict=True)
    for k, v in tmodel.state_dict().items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    jparams = convert_scenedreamer_generator(ref)
    pose = _poses(world)['tour']
    jr = JRenderer(jmodel, jparams, world, tile_size=16, **KW)
    jimg = np.asarray(jr.frame(pose, jr.style_z(style)))
    r = TiledRenderer(loaded.eval(), world, device='cpu', **PKW)
    np.testing.assert_allclose(r.frame(pose, r.style_z(style)), jimg,
                               atol=IMG_ATOL, rtol=0)
    # a generator that takes the ray direction (`render_net.fc_viewdir`,
    # `mod_5`) loads into a config with one; its frames are held against
    # JAX in `tests/test_torch_generator_options.py`
    vcfg = port_config(dataclasses.replace(TINY, pe_incl_orig_raydir=True))
    vsd = SceneDreamerGenerator(vcfg, seed=2).state_dict()
    got = load_reference_generator_state_dict(
        {'module.' + k: v.numpy() for k, v in vsd.items()})
    SceneDreamerGenerator(vcfg).load_state_dict(got, strict=True)
    assert torch.equal(got['render_net.fc_viewdir.weight'],
                       vsd['render_net.fc_viewdir.weight'])


def test_trainer_checkpoint_directory_loads_g_ema(tmp_path):
    """A trainer checkpoint directory: `latest_checkpoint.txt`'s target,
    the generator state with g_ema laid over it."""
    from scenedreamer_tpu_torch.cli.inference import load_generator
    from scenedreamer_tpu_torch.train.trainer import save_checkpoint
    cfg = port_config(TINY)
    gen = SceneDreamerGenerator(cfg, seed=1)
    ema = {n: p.detach() + 0.25 for n, p in gen.named_parameters()
           if n.startswith('render_net.')}

    class Trainer:
        step = 7

        def state_dict(self):
            return {'step': 7, 'generator': gen.state_dict(), 'g_ema': ema}
    save_checkpoint(str(tmp_path), Trainer())
    got = load_generator(str(tmp_path), cfg, torch.device('cpu')).state_dict()
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(got[k], ema.get(k, v), rtol=0, atol=0)


def test_inference_cli_padded_tiles_depth_style2(tmp_path):
    from scenedreamer_tpu_torch.cli import inference
    frames = inference.main([
        '--output_dir', str(tmp_path), '--device', 'cpu',
        '--scene_size', '64', '--resolution', '24', '32',
        '--num_samples', '6', '--pad', '6', '--cam_maxstep', '2',
        '--tile_size', '16', '--no_split_refine', '--save_depth',
        '--style2', 'seed:3'])
    assert len(frames) == 2 and frames[0].shape == (24, 32, 3)
    out = tmp_path / 'rgb_render'
    names = sorted(p.name for p in out.iterdir())
    assert names == ['00000.png', '00000_depth.png', '00000_voxel.png',
                     '00001.png', '00001_depth.png', '00001_voxel.png',
                     'height_map.png', 'semantic_map.png', 'style.npy']
    style = np.load(out / 'style.npy')
    assert style.shape == (2, 128)
    assert not np.array_equal(style[0], style[1])
    assert (tmp_path / 'rgb_render.mp4').stat().st_size > 0


def test_demo_get_bev_matches_jax():
    from scenedreamer_tpu.cli.demo import get_bev as jget_bev
    from scenedreamer_tpu_torch.cli.demo import get_bev
    h, s, world = get_bev(5, scene_size=64)
    jh, js, jworld = jget_bev(5, scene_size=64)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(world.voxel, jworld.voxel)
