"""Every `GeneratorConfig` option the shipped configs leave at its default,
in the port against the JAX package, on the CPU (TINY config of
`test_golden.py`, the 20x20 batch with a sky block of
`test_torch_compact.py`).

One parametrised test per option: the port generator (seeded, its hash
table uniform in [-1, 1]) is carried to flax by the JAX package's own
reference converter (`convert_scenedreamer_generator`: the port's names
are the reference's, the ray-direction layers `fc_viewdir` / `mod_5`
included), and `render_pixels` runs un-jitted in both, with and without
`compact_k`: net_out, weights, total weights and sigma within 1e-5
(float32 matmuls summed in another order; un-jitted JAX rounds the
world coordinate's a*b+c twice where the port rounds once, well inside
that). Each option's compacted pass is also held to the port's own full
pass at 1e-6, except `raw_noise_std`, whose noise JAX draws on the
compacted rays only (the two paths then differ by design; each is held
to JAX's same path with JAX's draws fed to `sigma_noise`). The last test
carries the view-direction weights through both converters and back."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from scenedreamer_tpu.models.generator import SceneDreamerGenerator as JGen
from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.utils.convert import (
    generator_state_dict_from_flax, load_reference_generator_state_dict)
from _torch_parity import cap_torch_threads, port_config
from test_golden import TINY
from test_torch_compact import _k, _sky_block, _t

cap_torch_threads()

ATOL, SELF_ATOL = 1e-5, 1e-6
OPTIONS = {
    'pe_lvl_raydir': dict(pe_lvl_raydir=2, pe_incl_orig_raydir=True),
    'pe_incl_orig_raydir': dict(pe_incl_orig_raydir=True),
    'clip_feat_map_tanh': dict(clip_feat_map='tanh'),
    'clip_feat_map_off': dict(clip_feat_map=False),
    'raw_noise_std': dict(raw_noise_std=0.5),
    'keep_sky_out_off': dict(keep_sky_out=False),
    'keep_sky_out_avgpool_off': dict(keep_sky_out_avgpool=False),
    'sky_global_avgpool_off': dict(sky_global_avgpool=False),
    'use_seg_off': dict(use_seg=False),
}


@pytest.fixture(scope='module')
def setup():
    """The world, batch (with the sky block) and render_pixels operands
    of `test_torch_compact.py`'s fixture, without its flax init."""
    from scenedreamer_tpu.data.synthetic import make_batch, make_world
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    batch = make_batch(world, batch_size=1, height=20, width=20,
                       max_samples=4, pad=TINY.pad, seed=0,
                       include_gan_data=False)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    batch['hit_mask'] = _sky_block(batch['hit_mask'])
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, TINY.interm_style_dims)).astype(np.float32)
    genc = np.array([[0.31, -0.47]], np.float32)
    args = [batch[k] for k in ('voxel_id', 'depth', 'hit_mask', 'raydirs',
                               'cam_ori')] + [z, genc]
    return world, batch, args


def _models(cfg, seed=3):
    tm = SceneDreamerGenerator(port_config(cfg), seed=seed)
    with torch.no_grad():
        tm.hash_encoder.embeddings.uniform_(
            -1, 1, generator=torch.Generator().manual_seed(seed))
    tm.eval()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    return tm, JGen(cfg=cfg), convert_scenedreamer_generator(sd)


@pytest.mark.parametrize('option', sorted(OPTIONS))
def test_option_matches_jax_render_pixels(setup, option):
    world, batch, args = setup
    cfg = dataclasses.replace(TINY, **OPTIONS[option])
    tm, jm, params = _models(cfg)
    key = jax.random.PRNGKey(5)
    if cfg.raw_noise_std > 0:
        _, k_noise = jax.random.split(key)
        tm.sigma_noise = lambda shape, dtype, device, generator=None: \
            torch.from_numpy(np.array(jax.random.normal(k_noise, shape)))
    k = _k(batch['hit_mask'])
    targs = [_t(a) for a in args]
    got = {}
    for ck in (None, k):
        j = jm.apply(params, key, *args, world.dims, deterministic=True,
                     compact_k=ck, method=jm.render_pixels)
        with torch.no_grad():
            t = tm.render_pixels(*targs, world.dims, deterministic=True,
                                 compact_k=ck)
        for name in ('net_out', 'weights', 'total_weights', 'sigma'):
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f'{name}, compact_k={ck}')
        got[ck] = t
    if cfg.raw_noise_std == 0:
        for name in ('net_out', 'weights', 'total_weights'):
            torch.testing.assert_close(got[k][name], got[None][name],
                                       rtol=0, atol=SELF_ATOL, msg=name)
    else:
        assert not torch.equal(got[k]['net_out'], got[None]['net_out'])


def test_viewdir_weights_through_both_converters():
    """A generator with the ray-direction input and without `use_seg`:
    its reference state dict (`module.` prefix) loads strictly through
    `load_reference_generator_state_dict`, JAX's converter reads the same
    dict into `fc_5` / `fc_viewdir` / `mod_5`, and
    `generator_state_dict_from_flax` gives the port's weights back."""
    cfg = dataclasses.replace(TINY, pe_lvl_raydir=2, use_seg=False)
    tm, _, params = _models(cfg, seed=6)
    sd = tm.state_dict()
    names = {k for k in sd if k.startswith('render_net.')}
    assert {'render_net.fc_viewdir.weight', 'render_net.fc_5.weight',
            'render_net.mod_5.weight_alpha',
            'render_net.mod_5.bias_beta'} <= names
    assert not any(k.startswith('render_net.fc_m_a') for k in names)
    assert 'render_net.fc_5.bias' not in names
    ref = {'module.' + k: v.numpy() for k, v in sd.items()}
    loaded = load_reference_generator_state_dict({'net_G': ref})
    back = generator_state_dict_from_flax(params)
    fresh = SceneDreamerGenerator(port_config(cfg), seed=0)
    for got in (loaded, back):
        fresh.load_state_dict(got, strict=True)
        for k, v in sd.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-7, err_msg=k)
    rn = params['params']['render_net']
    np.testing.assert_array_equal(np.asarray(rn['fc_viewdir']['weight']),
                                  sd['render_net.fc_viewdir.weight'])
    np.testing.assert_array_equal(np.asarray(rn['mod_5']['weight_alpha']),
                                  sd['render_net.mod_5.weight_alpha'])
