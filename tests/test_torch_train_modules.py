"""The port's training-side modules against the JAX package's, on the CPU,
on the same numpy inputs and converted weights: the random training
camera poses, the synthetic batch, the style encoder, the discriminator
(outputs, features, spectral-norm vectors), `smooth_interp`, the VGG19
taps, the losses and the learning-rate schedules.

Tolerances: module outputs 1e-5 (float32 convolutions summed in another
order by XLA and oneDNN, through up to 16 layers); spectral-norm vectors
1e-6 (one power-iteration step: two matrix-vector products and
normalisations of unit vectors); losses 1e-6 relative (a few float32
reductions), the perceptual loss 1e-5 (it runs VGG convolutions); camera poses and the batch's integer and copied arrays are
exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.data import synthetic as jsyn
from scenedreamer_tpu.models import discriminator as jdis
from scenedreamer_tpu.models import layers as jlayers
from scenedreamer_tpu.models import vgg as jvgg
from scenedreamer_tpu.scene import camera as jcam
from scenedreamer_tpu.train import losses as JL
from scenedreamer_tpu.train import optim as jopt
from scenedreamer_tpu_torch.data import synthetic as tsyn
from scenedreamer_tpu_torch.models import discriminator as tdis
from scenedreamer_tpu_torch.models.layers import StyleEncoder
from scenedreamer_tpu_torch.models.vgg import VGG19Features
from scenedreamer_tpu_torch.scene import camera as tcam
from scenedreamer_tpu_torch.train import losses as TL
from scenedreamer_tpu_torch.train import optim as topt
from scenedreamer_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax,
    vgg_state_dict_from_flax)
from _torch_parity import cap_torch_threads

cap_torch_threads()

ATOL = 1e-5


@pytest.fixture(scope='module')
def worlds():
    kw = dict(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    return jsyn.make_world(**kw), tsyn.make_world(**kw)


@pytest.mark.parametrize('name', ['birdseye', 'firstperson', 'thirdperson',
                                  'thirdperson2', 'thirdperson3', 'tour',
                                  'insideout'])
def test_rand_camera_poses_equal(worlds, name):
    _, world = worlds
    jf = getattr(jcam, f'rand_camera_pose_{name}')
    tf = getattr(tcam, f'rand_camera_pose_{name}')
    kw = {'border': 8} if name not in ('tour', 'insideout') else {}
    for seed in range(4):
        want = jf(world, np.random.default_rng(seed), **kw)
        got = tf(world, np.random.default_rng(seed), **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_make_batch_matches_jax(worlds):
    jworld, tworld = worlds
    want = jsyn.make_batch(jworld, batch_size=2, height=34, width=34,
                           max_samples=4, pad=2, seed=5)
    got = tsyn.make_batch(tworld, batch_size=2, height=34, width=34,
                          max_samples=4, pad=2, seed=5)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k in ('depth', 'raydirs'):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got['hit_mask'].any() and got['fake_masks'].sum() > 0


@pytest.mark.parametrize('size', [256, 48])
def test_style_encoder_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jmod = jlayers.StyleEncoder(style_dims=16, num_filters=8)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       rng=jax.random.PRNGKey(1))
    k = jax.random.PRNGKey(2)
    want = [np.asarray(a) for a in jmod.apply(params, jnp.asarray(x),
                                              rng=k)]
    eps = np.array(jax.random.normal(k, (2, 16)))
    sd = generator_state_dict_from_flax({'style_encoder': params['params']})
    tmod = StyleEncoder(style_dims=16, num_filters=8)
    tmod.load_state_dict({n.split('.', 1)[1]: v for n, v in sd.items()})
    got = tmod(torch.from_numpy(x), eps=torch.from_numpy(eps))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=ATOL, rtol=0)


def test_style_encoder_clamps_logvar():
    enc = StyleEncoder(style_dims=4, num_filters=2)
    with torch.no_grad():
        enc.fc_var.bias.fill_(50.0)
    _, logvar, _ = enc(torch.zeros(1, 256, 256, 3), eps=torch.zeros(1, 4))
    assert float(logvar.detach().max()) == 4.0


def _d_inputs(crop, seed=0):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, 12, (2, crop, crop))
    masks = np.eye(12, dtype=np.float32)[lbl]
    data = {'fake_masks': masks, 'real_masks': masks[::-1].copy(),
            'images': rng.uniform(-1, 1, (2, crop, crop, 3)),
            'pseudo_real_img': rng.uniform(-1, 1, (2, crop, crop, 3))}
    data = {k: v.astype(np.float32) for k, v in data.items()}
    fake = rng.uniform(-1, 1, (2, crop, crop, 3)).astype(np.float32)
    return data, fake


@pytest.mark.parametrize('crop', [32, 30])
def test_discriminator_matches_jax(crop):
    """Outputs and features of all three branches, then one call with
    update_stats=True: the same outputs and the same new u and sigma.
    Crop 32 gives an 8x8 prediction grid that divides the masks (the
    flagship 256 -> 64 path); 30 takes the resize branch."""
    data, fake = _d_inputs(crop)
    jd = jdis.GANcraftDiscriminator(num_labels=12, num_filters=8)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jfake = {'fake_images': jnp.asarray(fake)}
    variables = jd.init(jax.random.PRNGKey(0), jdata, jfake)
    td = tdis.GANcraftDiscriminator(num_labels=12, num_filters=8)
    td.load_state_dict(discriminator_state_dict_from_flax(
        variables['params'], variables['spectral_stats']))
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    tfake = {'fake_images': torch.from_numpy(fake)}
    want, stats = jd.apply(variables, jdata, jfake, incl_real=True,
                           incl_pseudo_real=True, update_stats=True,
                           mutable=['spectral_stats'])
    with torch.no_grad():
        got = td(tdata, tfake, incl_real=True, incl_pseudo_real=True,
                 update_stats=True)
    for branch in ('fake', 'real', 'pseudo_real'):
        (go,), (wo,) = got[f'{branch}_outputs'], want[f'{branch}_outputs']
        np.testing.assert_allclose(go['pred'].numpy(), np.asarray(wo['pred']),
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(go['label'].numpy(),
                                      np.asarray(wo['label']))
        for gf, wf in zip(got[f'{branch}_features'],
                          want[f'{branch}_features']):
            np.testing.assert_allclose(gf.numpy(), np.asarray(wf),
                                       atol=ATOL, rtol=0)
    new = discriminator_state_dict_from_flax(variables['params'], stats)
    sd = td.state_dict()
    for name in new:
        if name.endswith(('weight_u', 'weight_sigma')):
            np.testing.assert_allclose(sd[name].numpy(), new[name].numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)
            assert not torch.equal(
                sd[name], discriminator_state_dict_from_flax(
                    variables['params'], variables['spectral_stats'])[name])


@pytest.mark.parametrize('size', [(4, 4), (5, 3)])
def test_smooth_interp_matches_jax(size):
    rng = np.random.default_rng(1)
    seg = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (2, 16, 12))]
    want = np.asarray(jdis.smooth_interp(jnp.asarray(seg), size))
    got = tdis.smooth_interp(torch.from_numpy(seg), size).numpy()
    np.testing.assert_array_equal(got, want)


def test_vgg_taps_match_jax():
    layers = ('relu_1_2', 'relu_2_1', 'relu_3_1')
    x = np.random.default_rng(2).uniform(-1, 1, (2, 40, 40, 3)) \
        .astype(np.float32)
    jm = jvgg.VGG19Features(layers=layers)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(params, jvgg.imagenet_normalize(jnp.asarray(x)))
    tm = VGG19Features(layers)
    tm.load_state_dict(vgg_state_dict_from_flax(params))
    from scenedreamer_tpu_torch.models.vgg import imagenet_normalize
    with torch.no_grad():
        got = tm(imagenet_normalize(torch.from_numpy(x)))
    assert set(got) == set(layers)
    for name in layers:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=ATOL, rtol=0, err_msg=name)


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(float(torch.as_tensor(got).detach()),
                               float(want), rtol=rtol, atol=0)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((2, 6, 6, 13)).astype(np.float32)
    label = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (2, 6, 6))]
    out_j = [{'pred': jnp.asarray(pred), 'label': jnp.asarray(label)}]
    out_t = [{'pred': torch.from_numpy(pred),
              'label': torch.from_numpy(label)}]
    for t_real in (True, False):
        for dis_update in (True, False):
            _close(TL.gan_loss(out_t, t_real, dis_update),
                   JL.gan_loss(out_j, t_real, dis_update))
    feats = [rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
             for _ in range(4)]
    _close(TL.feature_matching_loss([torch.from_numpy(f) for f in feats[:2]],
                                    [torch.from_numpy(f) for f in feats[2:]]),
           JL.feature_matching_loss([jnp.asarray(f) for f in feats[:2]],
                                    [jnp.asarray(f) for f in feats[2:]]))
    mu, logvar = (rng.standard_normal((2, 8)).astype(np.float32)
                  for _ in range(2))
    _close(TL.gaussian_kl_loss(torch.from_numpy(mu),
                               torch.from_numpy(logvar)),
           JL.gaussian_kl_loss(jnp.asarray(mu), jnp.asarray(logvar)))
    x, y = (rng.uniform(-1, 1, (2, 24, 24, 3)).astype(np.float32)
            for _ in range(2))
    for name in ('l1_loss', 'l2_loss'):
        _close(getattr(TL, name)(torch.from_numpy(x), torch.from_numpy(y)),
               getattr(JL, name)(jnp.asarray(x), jnp.asarray(y)))
    jp = JL.PerceptualLoss(layers=('relu_1_2', 'relu_2_1'),
                           weights=(0.5, 1.0))
    vgg = VGG19Features(('relu_1_2', 'relu_2_1'))
    vgg.load_state_dict(vgg_state_dict_from_flax(jp.params))
    tp = TL.PerceptualLoss(vgg, layers=('relu_1_2', 'relu_2_1'),
                           weights=(0.5, 1.0))
    _close(tp(torch.from_numpy(x), torch.from_numpy(y)),
           jp(jnp.asarray(x), jnp.asarray(y)), rtol=ATOL)
    assert TL.DEFAULT_LOSS_WEIGHTS == JL.DEFAULT_LOSS_WEIGHTS
    assert (TL.PERCEPTUAL_LAYERS, TL.PERCEPTUAL_WEIGHTS) == \
        (JL.PERCEPTUAL_LAYERS, JL.PERCEPTUAL_WEIGHTS)


@pytest.mark.parametrize('policy', [
    None, {'type': 'constant'},
    {'type': 'step', 'step_size': 10, 'gamma': 0.1, 'iteration_mode': True},
    {'type': 'step', 'step_size': 2, 'gamma': 0.5, 'iteration_mode': False},
    {'type': 'linear', 'decay_start': 5, 'decay_end': 40,
     'decay_target': 0.1, 'iteration_mode': True}])
def test_schedules_equal(policy):
    js = jopt.make_schedule(policy, iters_per_epoch=7)
    ts = topt.make_schedule(policy, iters_per_epoch=7)
    for step in range(0, 60, 3):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_optimizer_groups_and_hyperparameters():
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    gen = SceneDreamerGenerator(GeneratorConfig(
        hash_num_levels=4, hash_level_dim=4, hash_log2_size=10,
        hash_desired_resolution=128, mlp_hidden=16,
        style_enc_num_filters=4))
    opt = topt.make_generator_optimizer(gen)
    lrs = {}
    for group, base in zip(opt.opt.param_groups, opt.base_lrs):
        assert group['betas'] == (jopt.ADAM_B1, jopt.ADAM_B2)
        assert group['eps'] == jopt.ADAM_EPS
        for p in group['params']:
            lrs[id(p)] = base
    for name, p in gen.named_parameters():
        top = name.split('.')[0]
        jtop = 'hash_table' if top == 'hash_encoder' else top
        assert lrs[id(p)] == jopt.GEN_PARAM_GROUP_LR[jtop], name
    assert topt.DIS_LR == jopt.DIS_LR


@pytest.mark.parametrize('clip,skip', [(0.0, 0.0), (0.5, 0.0), (0.0, 1e3),
                                       (0.5, 1.0)])
def test_clip_and_validate_matches_jax(clip, skip):
    """Global norm, clipping and the skip decision of the port's
    `clip_and_validate` against the JAX trainer's `_clip_and_validate`."""
    from scenedreamer_tpu.train.trainer import TrainerConfig as JConfig
    from scenedreamer_tpu.train.trainer import _clip_and_validate
    from scenedreamer_tpu_torch.train.trainer import (TrainerConfig,
                                                      clip_and_validate)
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    extra = torch.zeros(3, requires_grad=True)        # no gradient: zeros
    ok, gnorm = clip_and_validate(
        params + [extra], TrainerConfig(grad_clip_norm=clip,
                                        skip_grad_norm=skip))
    jg, jok, jnorm = _clip_and_validate(
        {str(i): jnp.asarray(g) for i, g in enumerate(grads)},
        JConfig(grad_clip_norm=clip, skip_grad_norm=skip))
    assert ok == bool(jok)
    np.testing.assert_allclose(gnorm, float(jnorm), rtol=1e-6)
    assert torch.equal(extra.grad, torch.zeros(3))
    if ok:
        for i, p in enumerate(params):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[str(i)]),
                                       rtol=1e-6, atol=0)
