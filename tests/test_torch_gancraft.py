"""The legacy GANcraft path of the port against the JAX package:
`ops/sp_trilinear.py`, `ops/ray_voxel.py:ray_voxel_intersection_perspective`
and `models/gancraft.py:GANcraftGenerator`, on the same numpy inputs.

* `sp_trilinear_worldcoord`: forward within 1e-6 and the table gradient
  within 1e-5 of each element's absolute sum of terms + 1e-7 (float32
  sums in another order), with NaN points, points outside the grid,
  `ign_zero` and `valid_mask`; no gradient to the coordinates.
* The perspective wrapper: voxel ids and hits equal, rays and depths
  within 1e-6 (JAX's un-jitted `camera_rays` rounds its cross products
  and norms otherwise than the compiled op the port matches).
* `GANcraftGenerator` at `tests/test_gancraft_mode.py`'s TINY config
  (blk_feat_dim 48, PE on the first 8 channels) with deterministic
  depths: the port's seeded weights (blk_feats uniform in [-1, 1]) carried
  to flax by the JAX package's reference converter plus `blk_feats`, and
  back by `generator_state_dict_from_flax`; JAX's style draw fed in as
  `style_eps`. Frames within 1e-4 of JAX's jitted forward, with and
  without `compact_k`; the `blk_feats` gradient of mean(img^2) within
  1e-5 of its largest element (jitted `jax.grad`); the hash table gets
  no gradient; rays that hit nothing render finite frames.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import cap_torch_threads, port_config
from scenedreamer_tpu.data.synthetic import make_batch, make_world
from scenedreamer_tpu.models.gancraft import GANcraftGenerator as JGANcraft
from scenedreamer_tpu.ops import ray_voxel as jrv
from scenedreamer_tpu.ops import sp_trilinear as jsp
from scenedreamer_tpu.scene.labels import get_label_translator
from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
from scenedreamer_tpu_torch.models.gancraft import GANcraftGenerator
from scenedreamer_tpu_torch.ops import ray_voxel as trv
from scenedreamer_tpu_torch.ops import sp_trilinear as tsp
from scenedreamer_tpu_torch.utils.convert import \
    generator_state_dict_from_flax
from test_gancraft_mode import TINY

cap_torch_threads()

CFG = dataclasses.replace(TINY, coarse_deterministic_sampling=True)
MODEL_KW = dict(blk_feat_dim=48, pe_no_pe_feat_dim=40)


@pytest.fixture(scope='module')
def world():
    return make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)


def test_build_corner_lut_matches_jax(world):
    jl, jn = jsp.build_corner_lut(world.voxel)
    tl, tn = tsp.build_corner_lut(world.voxel)
    assert tn == jn > 0 and tl.dtype == np.int32
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize('ign_zero,masked', [(True, True), (False, False),
                                             (True, False)])
def test_sp_trilinear_matches_jax(world, ign_zero, masked):
    lut, n = jsp.build_corner_lut(world.voxel)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((n + 1, 6)).astype(np.float32)
    dims = np.array(world.voxel.shape, np.float32)
    wc = (rng.uniform(-0.1, 1.1, (7, 50, 3)) * dims).astype(np.float32)
    wc[0, :5] = np.nan                      # the reference's sentinels
    wc[1, :3, 1] = np.nan
    wc[2, :4] = [[1e6, 3, 3], [-1e6, 5, 5], [3.5, 2.25, -7], [0, 0, 0]]
    valid = rng.random((7, 50)) > 0.2 if masked else None
    g = rng.standard_normal((7, 50, 6)).astype(np.float32)

    def jfn(f):
        return jsp.sp_trilinear_worldcoord(
            f, jnp.asarray(lut), jnp.asarray(wc), ign_zero=ign_zero,
            valid_mask=None if valid is None else jnp.asarray(valid))
    jout, pull = jax.vjp(jfn, jnp.asarray(feats))
    (jgrad,) = pull(jnp.asarray(g))
    tf = torch.tensor(feats, requires_grad=True)
    twc = torch.tensor(wc, requires_grad=True)
    tout = tsp.sp_trilinear_worldcoord(
        tf, torch.from_numpy(lut), twc, ign_zero=ign_zero,
        valid_mask=None if valid is None else torch.from_numpy(valid))
    tout.backward(torch.from_numpy(g))
    assert twc.grad is None, 'the coordinates got a gradient'
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-6, rtol=0)
    assert np.all(tout.detach().numpy()[0, :5] == 0)
    # each element's sum of |w_k g| over the points that read it
    ids, w = tsp.corner_weights(torch.from_numpy(lut), torch.from_numpy(wc),
                                n + 1, ign_zero,
                                None if valid is None else
                                torch.from_numpy(valid))
    absg = torch.from_numpy(np.abs(g).reshape(-1, 6))
    scale = torch.zeros((n + 1, 6), dtype=torch.float64)
    for k in range(8):
        scale.index_add_(0, ids[:, k],
                         (w[:, k:k + 1].abs() * absg).double())
    err = np.abs(tf.grad.numpy() - np.asarray(jgrad))
    assert np.all(err <= 1e-5 * scale.numpy() + 1e-7), err.max()
    assert np.abs(np.asarray(jgrad)).sum() > 0


def test_perspective_wrapper_matches_jax(world):
    from scenedreamer_tpu.scene.camera import EvalCameraController
    ori, cdir, up, f = EvalCameraController(world, maxstep=4, pattern=0)[1]
    h, w = 12, 20
    cam_f, cam_c = f * (w - 1), ((h - 1) / 2.0, (w - 1) / 2.0)
    want = jrv.ray_voxel_intersection_perspective(
        jnp.asarray(world.voxel), jnp.asarray(ori), jnp.asarray(cdir),
        jnp.asarray(up), cam_f, cam_c, (h, w), 5)
    got = trv.ray_voxel_intersection_perspective(
        torch.from_numpy(world.voxel), ori, cdir, up, cam_f, cam_c, (h, w),
        5)
    names = ('voxel_id', 'depth', 'raydirs', 'hit_mask')
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        if name in ('voxel_id', 'hit_mask'):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0,
                                       err_msg=name)
    assert got[3][..., 0].float().mean() > 0.2


@pytest.fixture(scope='module')
def gancraft(world):
    lut, n = jsp.build_corner_lut(world.voxel)
    batch = make_batch(world, batch_size=1, height=18, width=18,
                       max_samples=4, pad=CFG.pad, include_gan_data=False)
    batch = {k: np.array(v) for k, v in batch.items()}
    batch['height_field'] = np.ascontiguousarray(
        world.height_field.transpose(0, 2, 3, 1))
    batch['semantic_field'] = np.ascontiguousarray(
        world.semantic_field.transpose(0, 2, 3, 1))
    tm = GANcraftGenerator(port_config(CFG), num_corners=n, **MODEL_KW)
    with torch.no_grad():
        tm.blk_feats.uniform_(-1, 1, generator=torch.Generator()
                              .manual_seed(5))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = convert_scenedreamer_generator(sd)
    params['params']['blk_feats'] = jnp.asarray(sd['blk_feats'])
    jm = JGANcraft(cfg=CFG, num_corners=n, **MODEL_KW)
    get_label_translator()     # JAX's cached tables, built outside a trace
    key = jax.random.PRNGKey(0)
    eps = np.array(jax.random.normal(jax.random.split(key)[0],
                                     (1, CFG.style_dims)))
    return dict(lut=lut, n=n, batch=batch, tm=tm, jm=jm, params=params,
                key=key, eps=eps, dims=world.dims)


def _port_forward(s, batch, compact_k=None):
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    return s['tm'](data, s['dims'], random_style=True,
                   style_eps=torch.from_numpy(s['eps']),
                   field_extra={'corner_lut': torch.from_numpy(s['lut'])},
                   compact_k=compact_k)['fake_images']


def test_converter_carries_blk_feats(gancraft):
    s = gancraft
    sd = generator_state_dict_from_flax(s['params'])
    back = GANcraftGenerator(port_config(CFG), num_corners=s['n'],
                             seed=3, **MODEL_KW)
    back.load_state_dict(sd, strict=True)
    for k, v in s['tm'].state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    assert back.render_net.fc_1.weight.shape[1] == back.field_in_dim == 104
    assert GANcraftGenerator.field_in_dim.fget(
        type('D', (), dict(blk_feat_dim=64, pe_no_pe_feat_dim=40,
                           pe_lvl_feat=4, pe_incl_orig_feat=False))) == 232


def test_gancraft_frames_and_grads_match_jax(gancraft):
    s = gancraft
    batch, jm, params, dims = s['batch'], s['jm'], s['params'], s['dims']
    extra = {'corner_lut': jnp.asarray(s['lut'])}
    hits = int(batch['hit_mask'][..., 0].sum())
    assert 0 < hits < batch['hit_mask'][..., 0].size
    k = -(-hits // 8) * 8

    def jloss(bf, ck):
        p = {'params': {**params['params'], 'blk_feats': bf}}
        img = jm.apply(p, batch, dims, s['key'], random_style=True,
                       field_extra=extra, compact_k=ck)['fake_images']
        return jnp.mean(img ** 2), img

    grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                      static_argnums=1)
    bf = params['params']['blk_feats']
    (_, jimg), jgrad = grad_fn(bf, None)
    jimg, jgrad = np.asarray(jimg), np.asarray(jgrad)
    assert np.abs(jgrad).max() > 0
    for ck in (None, k):
        s['tm'].zero_grad(set_to_none=True)
        img = _port_forward(s, batch, ck)
        (img ** 2).mean().backward()
        np.testing.assert_allclose(img.detach().numpy(), jimg, atol=1e-4,
                                   rtol=0, err_msg=f'compact_k={ck}')
        g = s['tm'].blk_feats.grad.numpy()
        np.testing.assert_allclose(g, jgrad, rtol=0,
                                   atol=1e-5 * np.abs(jgrad).max(),
                                   err_msg=f'compact_k={ck}')
        assert s['tm'].hash_encoder.embeddings.grad is None
    (_, jimg_k), _ = grad_fn(bf, k)
    np.testing.assert_allclose(np.asarray(jimg_k), jimg, atol=1e-5, rtol=0)


def test_gancraft_all_sky_rays_finite(gancraft):
    s = gancraft
    batch = dict(s['batch'])
    batch['hit_mask'] = np.zeros_like(batch['hit_mask'])
    batch['voxel_id'] = np.zeros_like(batch['voxel_id'])
    with torch.no_grad():
        img = _port_forward(s, batch)
    assert img.shape == (1, 16, 16, 3) and torch.isfinite(img).all()
    with pytest.raises(ValueError, match='corner_lut'):
        s['tm'].field_features(torch.zeros(1, 2, 3), s['dims'], None, None,
                               None)
