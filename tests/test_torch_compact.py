"""Exact sky-ray compaction in the port (`render_pixels(compact_k=K)`,
the serving renderer's per-chunk sky skip and compaction, and the
trainer's `compact_k`), on the TINY config of `test_golden.py`.

The port's compacted `render_pixels` is held against the JAX package's,
jitted, at atol 1e-5 (float32 matmuls sum in another order in the two
frameworks), and against its own uncompacted pass at 1e-6 with the
dropped rays' weights exactly 0: rays that hit nothing have zero sample
distances and are masked, so the field there never reaches a result.
Frames and depth with and without compaction (and the sky skip) are
held equal, a training step with `compact_k` to the step without it at
1e-5 relative in every loss and 1e-5 in every parameter."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from scenedreamer_tpu_torch.data.synthetic import make_batch, make_world
from scenedreamer_tpu_torch.models.discriminator import GANcraftDiscriminator
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
from scenedreamer_tpu_torch.train.losses import PerceptualLoss
from scenedreamer_tpu_torch.train.trainer import GANTrainer
from _torch_parity import cap_torch_threads, port_config
from test_golden import KW, TINY

cap_torch_threads()

ATOL = 1e-5
SKY_ROWS = 8        # image rows forced to hit nothing


def _t(x):
    return torch.from_numpy(np.array(x))


def _sky_block(hit_mask):
    """hit_mask with its first SKY_ROWS image rows cleared, as
    `tests/test_generator.py:test_compact_k_exactness` forces a sky
    block, so compaction has rays to drop."""
    hm = np.array(hit_mask)
    hm[:, :SKY_ROWS] = False
    return hm


def _k(hit_mask, extra=4):
    """A K that keeps every ray whose first slot hits, and `extra` more."""
    hits = hit_mask[..., 0].reshape(hit_mask.shape[0], -1).sum(1).max()
    return int(hits) + extra


@pytest.fixture(scope='module')
def setup():
    """The world and batch of `_torch_parity.tiny_models` with a sky
    block, the flax parameters of the TINY generator's render pass alone
    (`init(method=render_pixels)`: the hash table, drawn again uniform
    in [-1, 1], the RenderMLP and the sky MLP; a whole-generator init
    costs ~30 s) and a port generator with those weights."""
    from scenedreamer_tpu.data.synthetic import make_batch as j_make_batch
    from scenedreamer_tpu.data.synthetic import make_world as j_make_world
    from scenedreamer_tpu.models.generator import \
        SceneDreamerGenerator as JGen
    from scenedreamer_tpu_torch.utils.convert import \
        generator_state_dict_from_flax
    world = j_make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    batch = j_make_batch(world, batch_size=1, height=20, width=20,
                         max_samples=4, pad=TINY.pad, seed=0,
                         include_gan_data=False)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    batch['hit_mask'] = _sky_block(batch['hit_mask'])
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, TINY.interm_style_dims)).astype(np.float32)
    genc = np.array([[0.31, -0.47]], np.float32)
    args = [batch[k] for k in ('voxel_id', 'depth', 'hit_mask', 'raydirs',
                               'cam_ori')] + [z, genc]
    jm = JGen(cfg=TINY)
    key = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        {'params': key}, key, *args, world.dims, deterministic=True,
        method=jm.render_pixels))
    params['params']['hash_table'] = rng.uniform(
        -1, 1, params['params']['hash_table'].shape).astype(np.float32)
    tm = SceneDreamerGenerator(port_config(TINY), seed=1)
    sd = generator_state_dict_from_flax(params)
    assert set(sd) <= set(tm.state_dict())
    tm.load_state_dict(sd, strict=False)
    tm.eval()
    return world, jm, params, tm, batch, args


def test_render_pixels_compact_matches_jax(setup):
    world, jm, params, tm, batch, args = setup
    hm = batch['hit_mask']
    k = _k(hm)
    assert k < hm.shape[1] * hm.shape[2], 'the batch must have sky to drop'

    @jax.jit
    def jfwd(p, *a):
        return jm.apply(p, jax.random.PRNGKey(3), *a, world.dims,
                        deterministic=True, compact_k=k,
                        method=jm.render_pixels)

    j = jfwd(params, *args)
    with torch.no_grad():
        t = tm.render_pixels(*[_t(a) for a in args], world.dims,
                             deterministic=True, compact_k=k)
    for name in ('net_out', 'weights', 'total_weights', 'sigma'):
        np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                   atol=ATOL, rtol=0, err_msg=name)


# the three hash paths the field takes on a [B, K, S, 3] batch: the
# folded xor (K2), the folded paired (K5) and the unfolded (K4) encode
VARIANTS = {
    'xor': TINY,
    'paired': dataclasses.replace(TINY, hash_variant='paired'),
    'unfolded': dataclasses.replace(
        TINY, hash_base_resolution=2, hash_log2_size=10, hash_num_levels=4,
        hash_level_dim=4, hash_desired_resolution=16),
}


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_compact_matches_uncompacted(setup, variant):
    """Per hash path, a compacted pass against the full one: weights and
    net_out to 1e-6, the dropped rays' weights, totals and terrain 0."""
    world, _, _, _, batch, args = setup
    tm = SceneDreamerGenerator(port_config(VARIANTS[variant]), seed=3)
    with torch.no_grad():
        tm.hash_encoder.embeddings.uniform_(
            -1, 1, generator=torch.Generator().manual_seed(0))
    hm = batch['hit_mask']
    k = _k(hm)
    targs = [_t(a) for a in args]
    with torch.no_grad():
        full = tm.render_pixels(*targs, world.dims, deterministic=True)
        comp = tm.render_pixels(*targs, world.dims, deterministic=True,
                                compact_k=k)
    for name in ('net_out', 'weights', 'total_weights', 'rand_depth'):
        torch.testing.assert_close(comp[name], full[name], rtol=0,
                                   atol=1e-6, msg=name)
    miss = torch.from_numpy(~hm[..., 0])
    assert miss.any() and (~miss).any()
    assert (full['weights'][miss] == 0).all()
    assert (comp['weights'][miss] == 0).all()
    assert (comp['total_weights'][miss] == 0).all()
    # rays past the first K after the hits-first sort were never
    # evaluated: their sigma is the zero fill
    n_dropped = int(hm[..., 0].size) - k
    assert int((comp['sigma'] == 0).all(dim=-2).sum()) >= n_dropped


@pytest.mark.parametrize('compact_k', [None, 'all', 'more'])
def test_compact_k_off_runs_the_full_path(setup, compact_k):
    """None and any K >= H*W leave the field on every ray: the output
    equals the plain pass, sigma on sky rays included (the compacted
    pass zero-fills it)."""
    world, _, _, tm, batch, args = setup
    r_all = batch['hit_mask'].shape[1] * batch['hit_mask'].shape[2]
    k = {None: None, 'all': r_all, 'more': r_all + 5}[compact_k]
    targs = [_t(a) for a in args]
    with torch.no_grad():
        full = tm.render_pixels(*targs, world.dims, deterministic=True)
        got = tm.render_pixels(*targs, world.dims, deterministic=True,
                               compact_k=k)
    for name in ('net_out', 'weights', 'sigma', 'total_weights'):
        assert torch.equal(got[name], full[name]), name
    assert (full['sigma'] != 0).any(dim=-2)[
        torch.from_numpy(~batch['hit_mask'][..., 0])].any()


def _poses(world):
    """The tour pose and the low camera pitched up of `test_golden.py`,
    and a camera over the middle of the world looking down: between
    them, chunks of pure sky, chunks partly sky and chunks that all
    hit."""
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    f = 0.5 / np.tan(np.deg2rad(20.0))
    up = np.array([1.0, 0.0, 0.0], np.float32)
    y, x, z = world.dims
    return {'tour': EvalCameraController(world, maxstep=4, pattern=0)[0],
            'sky': (np.array([y * 0.5, 10.0, 10.0], np.float32),
                    np.array([0.9, 0.3, 0.3], np.float32), up, f),
            'ground': (np.array([y * 0.6, x / 2, z / 2], np.float32),
                       np.array([-0.9, 0.3, 0.3], np.float32), up, f)}


# the chunk paths each pose must take, 3 image rows of 54 rays a chunk
PATHS = {'tour': ('compacted',), 'sky': ('sky_only', 'compacted'),
         'ground': ('compacted', 'full')}


@pytest.mark.parametrize('pose', sorted(PATHS))
def test_renderer_compaction_and_sky_skip_are_exact(setup, monkeypatch,
                                                    pose):
    """`TiledRenderer` with SCENEDREAMER_FIELD_COMPACT 0 and 1 (the
    default), and with the sky skip off: the frame and depth equal."""
    world, _, _, tm, _, _ = setup
    kw = {k: v for k, v in KW.items() if k != 'fov'}
    style = np.random.default_rng(9).standard_normal(
        (1, TINY.style_dims)).astype(np.float32)
    out = {}
    for name, env, sky_fast in (('off', '0', False), ('skip', '0', True),
                                ('on', '1', True)):
        monkeypatch.setenv('SCENEDREAMER_FIELD_COMPACT', env)
        r = TiledRenderer(tm, world, chunk_rays=200, device='cpu',
                          sky_fast=sky_fast, **kw)
        assert r.field_compact == (env == '1')
        out[name] = r.frame(_poses(world)[pose], r.style_z(style),
                            return_aux=True) + (r.last_stats,)
    monkeypatch.delenv('SCENEDREAMER_FIELD_COMPACT')
    assert TiledRenderer(tm, world, device='cpu', **kw).field_compact
    img_off, aux_off, st_off = out['off']
    for name in ('skip', 'on'):
        img, aux, _ = out[name]
        np.testing.assert_array_equal(img, img_off, err_msg=name)
        np.testing.assert_array_equal(
            np.nan_to_num(aux['depth'], posinf=1e9),
            np.nan_to_num(aux_off['depth'], posinf=1e9), err_msg=name)
    st = out['on'][2]
    assert all(st[f'chunks_{p}'] for p in PATHS[pose]), st
    assert st_off['chunks_full'] == sum(
        st[f'chunks_{p}'] for p in ('sky_only', 'compacted', 'full'))
    assert st['rays'] == st_off['rays'] == st_off['field_rays']
    assert st['hit_rays'] <= st['field_rays'] < st['rays']
    assert st['field_points'] == st['field_rays'] * KW['num_samples']
    assert np.isinf(aux_off['depth']).any()


def _trainer(cfg, dims, seed):
    return GANTrainer(
        SceneDreamerGenerator(port_config(cfg), seed=seed),
        GANcraftDiscriminator(12, 8, seed=seed), dims,
        perceptual=PerceptualLoss(layers=('relu_2_1',), weights=(1.0,),
                                  seed=seed), iters_per_epoch=10)


def test_train_step_shared_with_compact_k():
    """One `train_step_shared(compact_k=K)` against the same step
    without it, twin trainers from one seed and one draw seed (the
    stochastic depths are drawn on every ray either way): losses and
    gradient norms to 1e-5 relative, parameters to 1e-5, except where
    a gradient is below 1e-5 (Adam with beta1 = 0 moves such a parameter
    by up to its learning rate whichever way the rounding tips it, as in
    `tests/test_torch_train.py`)."""
    cfg = dataclasses.replace(TINY, pad=2)
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    batch = make_batch(world, batch_size=2, height=34, width=34,
                       max_samples=4, pad=cfg.pad, seed=3)
    batch['hit_mask'] = _t(_sky_block(batch['hit_mask'].numpy()))
    k = _k(batch['hit_mask'].numpy())
    assert k < 34 * 34
    runs = []
    for ck in (None, k):
        tr = _trainer(cfg, world.dims, seed=4)
        m = tr.train_step_shared(batch, torch.Generator().manual_seed(5),
                                 compact_k=ck)
        runs.append((tr, m))
    (ta, ma), (tb, mb) = runs
    assert set(ma) == set(mb)
    for name in ma:
        np.testing.assert_allclose(mb[name], ma[name], rtol=1e-5, atol=0,
                                   err_msg=name)
    lr_of = {id(p): g['lr'] for o in (ta.g_opt, ta.d_opt)
             for g in o.opt.param_groups for p in g['params']}
    for mod_a, mod_b in ((ta.gen, tb.gen), (ta.dis, tb.dis)):
        for (name, pa), pb in zip(mod_a.named_parameters(),
                                  mod_b.parameters()):
            flat = pa.grad.abs() < 1e-5
            err = (pa - pb).abs()
            bad = err > torch.where(flat, 2 * lr_of[id(pa)] + 1e-5, 1e-5)
            assert not bad.any(), (name, float(err.max()))
    assert (tb.gen.hash_encoder.embeddings.grad != 0).any()
