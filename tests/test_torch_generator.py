"""The port's generator against the JAX package's, with weights from a
flax init carried across by the port's converter, on the TINY config of
`test_golden.py`. Inputs are the same numpy arrays; sampling is
deterministic. Tolerance atol 1e-5: float32 matmuls and convolutions
sum in another order in the two frameworks. The `hash_variant` tests run
both variants with the hash table redrawn uniform in [-1, 1] (the init's
1e-4 would hide a wrong row), as `tests/test_generator.py` does for the
paired variant on the JAX side."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.ops.hashgrid import (encode_folded, foldable,
                                                 general_levels)
from scenedreamer_tpu_torch.utils.convert import \
    generator_state_dict_from_flax
from _torch_parity import cap_torch_threads, port_config, tiny_models
from test_golden import TINY

cap_torch_threads()

ATOL = 1e-5


@pytest.fixture(scope='module')
def setup():
    return tiny_models()


def _t(x):
    return torch.from_numpy(np.array(x))


def test_world_code(setup):
    world, jm, params, tm, batch = setup
    j = jm.apply(params, batch['height_field'], batch['semantic_field'],
                 method=jm.world_code)
    with torch.no_grad():
        t = tm.world_code(_t(batch['height_field']),
                          _t(batch['semantic_field']))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_style_and_sky(setup):
    world, jm, params, tm, batch = setup
    style = np.random.default_rng(1).standard_normal(
        (1, TINY.style_dims)).astype(np.float32)
    jz = jm.apply(params, style, method=jm.style_forward)
    with torch.no_grad():
        tz = tm.style_forward(_t(style))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL,
                               rtol=0)
    js = jm.apply(params, batch['raydirs'], jz, method=jm.sky_color)
    with torch.no_grad():
        ts = tm.sky_color(_t(batch['raydirs']), _t(jz))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL,
                               rtol=0)


def test_render_pixels_and_refine(setup):
    world, jm, params, tm, batch = setup
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, TINY.interm_style_dims)).astype(np.float32)
    genc = np.asarray(jm.apply(params, batch['height_field'],
                               batch['semantic_field'],
                               method=jm.world_code))
    args = [batch[k] for k in ('voxel_id', 'depth', 'hit_mask', 'raydirs',
                               'cam_ori')] + [z, genc]
    j = jm.apply(params, jax.random.PRNGKey(3), *args, world.dims,
                 deterministic=True, method=jm.render_pixels)
    with torch.no_grad():
        t = tm.render_pixels(*[_t(a) for a in args], world.dims,
                             deterministic=True)
    assert batch['hit_mask'][..., 0].any()
    for k in ('net_out', 'weights', 'rand_depth', 'total_weights'):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    img_j, raw_j = jm.apply(params, j['net_out'], z, method=jm.refine)
    with torch.no_grad():
        img_t, raw_t = tm.refine(_t(j['net_out']), _t(z))
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=ATOL,
                               rtol=0)


def test_sky_only_matches_full_on_sky_rays(setup):
    """`sky_only=True` skips the field and is exact where no ray hits."""
    world, jm, params, tm, batch = setup
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.standard_normal(
        (1, TINY.interm_style_dims)).astype(np.float32))
    hit = np.zeros_like(batch['hit_mask'])
    args = [_t(batch['voxel_id']), _t(batch['depth']), _t(hit),
            _t(batch['raydirs']), _t(batch['cam_ori']), z,
            torch.zeros(1, 2)]
    with torch.no_grad():
        full = tm.render_pixels(*args, world.dims, deterministic=True)
        sky = tm.render_pixels(*args, world.dims, deterministic=True,
                               sky_only=True)
    torch.testing.assert_close(sky['net_out'], full['net_out'], rtol=0,
                               atol=0)


@pytest.fixture(scope='module', params=['xor', 'paired'])
def variant_setup(request):
    cfg = dataclasses.replace(TINY, hash_variant=request.param,
                              coarse_deterministic_sampling=True)
    world, jm, params, tm, batch = tiny_models(cfg=cfg)
    table = np.random.default_rng(9).uniform(
        -1, 1, params['params']['hash_table'].shape).astype(np.float32)
    params = {'params': {**params['params'], 'hash_table': table}}
    with torch.no_grad():
        tm.hash_encoder.embeddings.copy_(torch.from_numpy(table))
    assert tm.cfg.hash_spec.hash_variant == request.param
    return request.param, world, jm, params, tm, batch


def test_render_pixels_hash_variant(variant_setup):
    variant, world, jm, params, tm, batch = variant_setup
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, TINY.interm_style_dims)).astype(np.float32)
    genc = np.asarray(jm.apply(params, batch['height_field'],
                               batch['semantic_field'],
                               method=jm.world_code))
    args = [batch[k] for k in ('voxel_id', 'depth', 'hit_mask', 'raydirs',
                               'cam_ori')] + [z, genc]
    j = jm.apply(params, jax.random.PRNGKey(3), *args, world.dims,
                 deterministic=True, method=jm.render_pixels)
    with torch.no_grad():
        t = tm.render_pixels(*[_t(a) for a in args], world.dims,
                             deterministic=True)
    for k in ('net_out', 'weights', 'total_weights'):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_forward_hash_variant(variant_setup):
    """The training forward with a random style (the JAX draw handed to
    the port as `style_eps`) and deterministic depths."""
    variant, world, jm, params, tm, batch = variant_setup
    key = jax.random.PRNGKey(5)
    j = jm.apply(params, batch, world.dims, key, random_style=True)
    k_style, _ = jax.random.split(key)
    eps = np.array(jax.random.normal(k_style, (1, TINY.style_dims)))
    with torch.no_grad():
        t = tm({k: _t(v) for k, v in batch.items()}, world.dims,
               random_style=True, style_eps=_t(eps))
    assert t['fake_images'].shape == (1, 18, 18, 3)
    np.testing.assert_allclose(t['fake_images'].numpy(),
                               np.asarray(j['fake_images']), atol=ATOL,
                               rtol=0)


def test_hash_variants_render_differently():
    """With the same weights and table the two variants read different
    rows, so a port that ignored `hash_variant` would fail here."""
    outs = []
    pts = torch.rand((50, 3), generator=torch.Generator().manual_seed(1))
    for variant in ('xor', 'paired'):
        cfg = dataclasses.replace(TINY, hash_variant=variant)
        tm = SceneDreamerGenerator(port_config(cfg), seed=1)
        with torch.no_grad():
            tm.hash_encoder.embeddings.uniform_(
                -1, 1, generator=torch.Generator().manual_seed(0))
            folded = tm.bake_hash(torch.tensor([[0.2, -0.4]]))
            outs.append(encode_folded(tm.cfg.hash_spec, folded[0],
                                      pts * 2 - 1))
    assert (outs[0] - outs[1]).abs().max() > 0.1


# A generator whose hash spec is not foldable: level 0's 3^5 cells fit
# under the 2^10 cap and are indexed densely (248 rows, not a power of
# two), levels 1-3 are hashed at 1024 rows. The field then runs the
# general encode (K4's plain twins) on the 5-D points.
NONFOLD = dataclasses.replace(
    TINY, hash_base_resolution=2, hash_log2_size=10, hash_num_levels=4,
    hash_level_dim=4, hash_desired_resolution=16,
    coarse_deterministic_sampling=True)


@pytest.fixture(scope='module')
def nonfold_setup(setup):
    """The JAX generator's render pass and the gradients of a scalar loss
    (world code -> render_pixels -> sum(net_out * c)) for every
    parameter, jitted (the compiled cell position is one rounding, as
    the port's) with float32 table-gradient payloads. The weights are
    the TINY models' (only the table's row count differs), with the
    hash table drawn uniform in [-1, 1]."""
    from scenedreamer_tpu.models.generator import SceneDreamerGenerator \
        as JGen
    from scenedreamer_tpu.ops import hashgrid as jhg
    import jax.numpy as jnp
    world, _, params, _, batch = setup
    jm = JGen(cfg=NONFOLD)
    tm = SceneDreamerGenerator(port_config(NONFOLD))
    table = np.random.default_rng(9).uniform(
        -1, 1, tuple(tm.hash_encoder.embeddings.shape)).astype(np.float32)
    params = {'params': {**params['params'], 'hash_table': table}}
    tm.load_state_dict(generator_state_dict_from_flax(params))
    tm.eval()
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, TINY.interm_style_dims)).astype(np.float32)
    args = [batch[k] for k in ('voxel_id', 'depth', 'hit_mask', 'raydirs',
                               'cam_ori')] + [z]
    hw = batch['voxel_id'].shape[1:3]
    c = rng.standard_normal((1,) + hw + (TINY.final_feat_dim,)) \
        .astype(np.float32)

    def loss(p):
        genc = jm.apply(p, batch['height_field'], batch['semantic_field'],
                        method=jm.world_code)
        out = jm.apply(p, jax.random.PRNGKey(3), *args, genc, world.dims,
                       deterministic=True, method=jm.render_pixels)
        return jnp.sum(out['net_out'] * c), out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhg, 'SORT_PAYLOAD_DTYPE', jnp.float32)
        (_, jout), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
    jout = {k: np.asarray(jout[k]) for k in ('net_out', 'weights',
                                             'total_weights')}
    jgrad = generator_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrad))
    return world, tm, batch, args, c, jout, jgrad


def test_nonfoldable_spec_has_no_bake(nonfold_setup):
    world, tm, batch, *_ = nonfold_setup
    spec = tm.cfg.hash_spec
    assert not foldable(spec)
    assert [lv.size for lv in general_levels(spec)] == [248, 1024, 1024,
                                                        1024]
    assert tm.bake_hash(torch.zeros(1, 2)) is None


def test_nonfoldable_render_pixels_and_grads(nonfold_setup):
    """`render_pixels` through the general encode at 1e-5; the gradients
    of the hash table and the world encoder against `jax.grad`. The
    table gradient is held per row to 1e-4 of the largest row magnitude
    plus 1e-6 (the MLP's float32 matmul sums in another order feed every
    row's cotangent); the world encoder's reaches it only through the
    scene code's gradient, a sum over all points of the encode's
    dx[:, 3:5] with both signs, and is held to 1e-3 of each tensor's
    largest magnitude."""
    world, tm, batch, args, c, jout, jgrad = nonfold_setup
    tm.zero_grad()
    genc = tm.world_code(_t(batch['height_field']),
                         _t(batch['semantic_field']))
    out = tm.render_pixels(*[_t(a) for a in args], genc, world.dims,
                           deterministic=True)
    assert batch['hit_mask'][..., 0].any()
    for k in ('net_out', 'weights', 'total_weights'):
        np.testing.assert_allclose(out[k].detach().numpy(), jout[k],
                                   atol=ATOL, rtol=0, err_msg=k)
    (out['net_out'] * _t(c)).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()
             if n.startswith(('hash_encoder.', 'world_encoder.'))}
    assert len(grads) > 2
    for name, got in grads.items():
        want = jgrad[name].numpy()
        assert got is not None and np.abs(want).max() > 0, name
        scale = np.abs(want).max()
        rtol = 1e-4 if name.startswith('hash_encoder.') else 1e-3
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=rtol * scale + 1e-6, err_msg=name)
