"""The port's split-refine frame against the JAX package's `TiledRenderer`
(split-refine) and against the committed golden frames, for both poses
of `test_golden.py`, with the same flax-initialised TINY weights.

Tolerances are the golden tests' own: image atol 1e-3 (a uint8 LSB is
~7.8e-3), depth rtol 1e-5 / atol 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from scenedreamer_tpu.render.pipeline import TiledRenderer as JRenderer
from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                    render_trajectory,
                                                    to_uint8)
from _torch_parity import cap_torch_threads, tiny_models
from test_golden import FIXTURE, IMG_ATOL, KW, TINY, _poses

cap_torch_threads()

POSES = ('tour', 'sky')


@pytest.fixture(scope='module')
def frames():
    world, jmodel, params, tmodel, _ = tiny_models()
    style = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                         (1, TINY.style_dims)))
    jr = JRenderer(jmodel, params, world, tile_size=16, **KW)
    assert jr.split_refine
    jz = jr.style_z(style)
    kw = {k: v for k, v in KW.items() if k != 'fov'}
    # a small chunk size: several field chunks per frame
    tr = TiledRenderer(tmodel, world, chunk_rays=300, device='cpu', **kw)
    tz = tr.style_z(style)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5,
                               rtol=0)
    out = {}
    for name, pose in _poses(world).items():
        out[name] = (jr.frame(pose, jz, return_aux=True),
                     tr.frame(pose, tz, return_aux=True))
    return out, (world, tmodel, style)


@pytest.mark.parametrize('pose', POSES)
def test_frame_matches_jax_renderer(frames, pose):
    (jimg, jaux), (timg, taux) = frames[0][pose]
    assert timg.shape == jimg.shape and np.isfinite(timg).all()
    np.testing.assert_allclose(timg, jimg, atol=IMG_ATOL, rtol=0)
    np.testing.assert_allclose(taux['depth'], jaux['depth'], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(taux['first_voxel_id'],
                                  jaux['first_voxel_id'])


@pytest.mark.parametrize('pose', POSES)
def test_frame_matches_golden(frames, pose):
    golden = np.load(FIXTURE)
    _, (timg, taux) = frames[0][pose]
    np.testing.assert_allclose(timg, golden[f'{pose}_split'],
                               atol=IMG_ATOL, rtol=0)
    np.testing.assert_allclose(np.nan_to_num(taux['depth'], posinf=1e9),
                               golden[f'{pose}_split_depth'], rtol=1e-5,
                               atol=1e-4)


def test_render_trajectory_writes_frames(frames, tmp_path):
    """`render_trajectory` returns the uint8 frames it wrote, as JAX's
    does; the float image of the same pose comes from
    `TiledRenderer.frame` and converts to the same bytes."""
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    world, tmodel, style = frames[1]
    kw = {k: v for k, v in KW.items() if k != 'fov'}
    out = render_trajectory(tmodel, world, style, str(tmp_path),
                            camera_mode=4, cam_maxstep=2, device='cpu', **kw)
    assert len(out) == 2
    for img in out:
        assert img.shape == KW['resolution_hw'] + (3,)
        assert img.dtype == np.uint8
    tr = TiledRenderer(tmodel, world, device='cpu', **kw)
    pose = EvalCameraController(world, maxstep=2, pattern=4, cam_ang=72,
                                smooth_decay_multiplier=75.0)[0]
    img = tr.frame(pose, tr.style_z(style))
    assert np.isfinite(img).all() and np.abs(img).max() <= 1.0
    np.testing.assert_array_equal(to_uint8(img), out[0])
    files = sorted(p.name for p in (tmp_path / 'rgb_render').iterdir())
    assert files == ['00000.png', '00001.png', 'height_map.png',
                     'semantic_map.png', 'style.npy']
    assert (tmp_path / 'rgb_render.mp4').stat().st_size > 0
    png = (tmp_path / 'rgb_render' / '00000.png').read_bytes()
    assert png[:8] == b'\x89PNG\r\n\x1a\n'


def test_inference_cli_on_cpu(tmp_path):
    """The CLI's whole chain (terrain, world, flagship-width generator,
    renderer, PNGs) at a tiny scene and resolution on the CPU."""
    from scenedreamer_tpu_torch.cli import inference
    frames = inference.main([
        '--output_dir', str(tmp_path), '--device', 'cpu',
        '--scene_size', '64', '--resolution', '24', '32',
        '--num_samples', '6', '--pad', '6', '--cam_maxstep', '2'])
    assert len(frames) == 2
    for img in frames:
        assert img.shape == (24, 32, 3) and img.dtype == np.uint8
    assert (tmp_path / 'rgb_render' / '00001.png').exists()


def test_paired_variant_frame_matches_jax_renderer():
    """The serving renderer on `hash_variant='paired'` (bake and encode
    through the paired plain versions on the CPU), hash table redrawn in
    [-1, 1] so the rows matter; image atol 1e-3 as above."""
    cfg = dataclasses.replace(TINY, hash_variant='paired')
    world, jmodel, params, tmodel, _ = tiny_models(cfg=cfg)
    table = np.random.default_rng(9).uniform(
        -1, 1, params['params']['hash_table'].shape).astype(np.float32)
    params = {'params': {**params['params'], 'hash_table': table}}
    with torch.no_grad():
        tmodel.hash_encoder.embeddings.copy_(torch.from_numpy(table))
    style = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                         (1, TINY.style_dims)))
    jr = JRenderer(jmodel, params, world, tile_size=16, **KW)
    kw = {k: v for k, v in KW.items() if k != 'fov'}
    tr = TiledRenderer(tmodel, world, chunk_rays=300, device='cpu', **kw)
    pose = _poses(world)['tour']
    jimg = jr.frame(pose, jr.style_z(style))
    timg = tr.frame(pose, tr.style_z(style))
    assert np.isfinite(timg).all() and np.abs(timg).max() <= 1.0
    np.testing.assert_allclose(timg, jimg, atol=IMG_ATOL, rtol=0)
