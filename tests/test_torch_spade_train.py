"""SPADE oracle training in the port against the JAX package on the CPU:
the trainable batch norm, the style encoder, `make_optimizer`, one
`SpadeTrainer.train_step` and `generate`, the trained -> frozen fold, and
`cli.train_spade` with resume and its fold into `cli.train
--spade-checkpoint`.

Same numpy inputs and weights on both sides: the flax variables of a tiny
SPADE (num_filters 2, style 8, 8 labels, crop 32, batch 2) and of the
multi-scale D (2 scales x 3 layers, 2 filters) are redrawn with numpy at
unit scale (the xavier(0.02) init gives images of 1e-4, which would hide
a wrong layer) and carried to the port by `spade_state_dict_from_flax` /
`multiscale_discriminator_state_dict_from_flax`. JAX's style draws come
from its own `jax.random.normal` calls, recorded and fed to the port as
eps. One jitted JAX step is compiled for the module.

Tolerances: forward images, statistics and encoder outputs 1e-5
(float32 convs summed in another order); the step's losses 1e-5
relative and gradient norms 1e-4 relative; parameters within 2 lr + 1e-6
(Adam with beta1 = 0 moves each element by about +-lr, so float noise in
a near-zero gradient can flip its sign) and within 1e-5 for all but 1%
of elements; running statistics 1e-5, the EMA (1 - beta) times the
parameters' bound; optimizers against
optax 1e-6 (1e-4 of a step at lr 1e-2: torch's Adam divides in another
order than optax's); the fold 1e-6 (as JAX's own
`test_spade_trainer.py:63`); the oracle of `cli.train` against the
trainer's eval `generate` 1e-5.
"""
import argparse
import contextlib
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from scenedreamer_tpu.models import spade as jspade
from scenedreamer_tpu.train import gan_losses as JG
from scenedreamer_tpu.train import losses as JL
from scenedreamer_tpu.train import optim as joptim
from scenedreamer_tpu.train.spade_trainer import SpadeTrainer as JTrainer
from scenedreamer_tpu.train.spade_trainer import SpadeTrainState
from scenedreamer_tpu.train.trainer import TrainerConfig as JConfig
from scenedreamer_tpu.utils.convert import convert_spade
from scenedreamer_tpu_torch.cli import train as cli_train
from scenedreamer_tpu_torch.cli import train_spade as cli_spade
from scenedreamer_tpu_torch.data.synthetic import make_paired_folder
from scenedreamer_tpu_torch.models import spade as tspade
from scenedreamer_tpu_torch.models.vgg import VGG19Features
from scenedreamer_tpu_torch.train import gan_losses as TG
from scenedreamer_tpu_torch.train import losses as TL
from scenedreamer_tpu_torch.train import optim as toptim
from scenedreamer_tpu_torch.train.spade_trainer import SpadeTrainer
from scenedreamer_tpu_torch.train.trainer import TrainerConfig
from scenedreamer_tpu_torch.utils.convert import (
    multiscale_discriminator_state_dict_from_flax, spade_frozen_from_trained,
    spade_state_dict_from_flax)
from _torch_parity import cap_torch_threads
from test_torch_multiprocess import REPO, free_port, spawn_ranks, wait_ranks
from test_torch_train_amp import _flax_vgg

cap_torch_threads()

GEN_KW = dict(num_labels=8, out_size=256, num_filters=2, style_dims=8,
              spade_filters=2, style_enc_filters=2)
DIS_KW = dict(num_discriminators=2, num_filters=2, num_layers=3)
CROP, B = 32, 2
WEIGHTS = {'gan': 1.0, 'perceptual': 10.0, 'feature_matching': 10.0,
           'kl': 0.05}
VGG_LAYERS = ('relu_1_1',)
EMA_BETA = 0.9
TOL, LOSS_RTOL, NORM_RTOL, LR = 1e-5, 1e-5, 1e-4, 1e-4


def _redraw(module, rng):
    """Every parameter and buffer of a port module redrawn with numpy:
    weights N(0, 1/fan_in), batch-norm weight U(0.5, 1.5) and running
    var U(0.5, 2), power-iteration vectors N(0, 1), sigma 1, the rest
    0.1 N(0, 1)."""
    sd = module.state_dict()
    for k, v in sd.items():
        shape = tuple(v.shape)
        if k.endswith('norm.weight'):
            new = rng.uniform(0.5, 1.5, shape)
        elif k.endswith('running_var'):
            new = rng.uniform(0.5, 2.0, shape)
        elif k.endswith('weight_u'):
            new = rng.standard_normal(shape)
        elif k.endswith('weight_sigma'):
            new = np.ones(shape)
        elif k.endswith('weight'):
            new = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            new = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(np.asarray(new, np.float32))
    module.load_state_dict(sd)
    return module


def _flax_spade(sd):
    """A port SPADE state dict -> flax variables of JAX's trainable
    layout: JAX's `convert_spade` gives the frozen one, whose batch-norm
    scale / offset move to `params` as flax `nn.BatchNorm`'s scale /
    bias."""
    frozen = jax.tree_util.tree_map(np.asarray, convert_spade(
        {k: v.numpy() for k, v in sd.items()}))
    params, stats = frozen['params'], frozen['batch_stats']

    def walk(p, st):
        for k, sub in st.items():
            if set(sub) == {'mean', 'var', 'scale', 'offset'}:
                p.setdefault(k, {}).update(scale=sub['scale'],
                                           bias=sub['offset'])
                st[k] = {'mean': sub['mean'], 'var': sub['var']}
            else:
                walk(p.setdefault(k, {}), sub)
    walk(params['spade_generator'], stats['spade_generator'])
    return {'params': params, 'batch_stats': stats}


def _flax_multiscale(sd):
    """A port multi-scale D state dict -> flax (params, spectral stats)."""
    params, stats = {}, {}
    for key, v in sd.items():
        d, name, leaf = key.split('.')
        v = v.numpy()
        if leaf in ('weight', 'bias'):
            params.setdefault(d, {}).setdefault(name, {'Conv_0': {}})[
                'Conv_0']['kernel' if leaf == 'weight' else 'bias'] = \
                v.transpose(2, 3, 1, 0) if leaf == 'weight' else v
        else:
            stats.setdefault(d, {}).setdefault(
                name, {'SpectralNorm_0': {}})['SpectralNorm_0'][
                'Conv_0/kernel/' + ('u' if leaf == 'weight_u'
                                    else 'sigma')] = v
    return params, stats


@contextlib.contextmanager
def recorded_normals():
    """Records every `jax.random.normal` draw made eagerly inside the
    block (the style encoder's eps, JAX's `make_rng('style')` key)."""
    orig, drawn = jax.random.normal, []

    def rec(key, shape=(), dtype=jnp.float32, *args, **kw):
        out = orig(key, shape, dtype, *args, **kw)
        if not isinstance(out, jax.core.Tracer):
            drawn.append(np.asarray(out))
        return out
    jax.random.normal = rec
    try:
        yield drawn
    finally:
        jax.random.normal = orig


def _jax_eps(model, variables, images, key):
    """The eps JAX's style encoder draws with `rngs={'style': key}`."""
    with recorded_normals() as drawn:
        model.apply(variables, jnp.asarray(images),
                    method=lambda m, x: m.style_encoder(x),
                    rngs={'style': key})
    return torch.from_numpy(np.array(drawn[-1]))


def _batch(seed, num_labels=8, crop=CROP, b=B):
    rng = np.random.default_rng(seed)
    label = np.eye(num_labels, dtype=np.float32)[
        rng.integers(0, num_labels, (b, crop, crop))]
    images = rng.uniform(-1, 1, (b, crop, crop, 3)).astype(np.float32)
    return {'label': label, 'images': images}


def _port_gen(variables):
    gen = tspade.SPADEWrapper(**GEN_KW, bn_mode='train', style_encoder=True)
    gen.load_state_dict(spade_state_dict_from_flax(variables))
    return gen


def _port_dis(params, stats):
    dis = TG.MultiScaleDiscriminator(GEN_KW['num_labels'], **DIS_KW)
    dis.load_state_dict(multiscale_discriminator_state_dict_from_flax(
        params, stats))
    return dis


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope='module')
def setup():
    """The redrawn variables, a batch, JAX's jitted step from them and
    its eval `generate`; every array numpy."""
    rng = np.random.default_rng(0)
    batch = _batch(1)
    gtrain = jspade.SPADEWrapper(**GEN_KW, bn_mode='train')
    port_gen = _redraw(tspade.SPADEWrapper(**GEN_KW, bn_mode='train',
                                           style_encoder=True), rng)
    port_dis = _redraw(TG.MultiScaleDiscriminator(GEN_KW['num_labels'],
                                                  **DIS_KW), rng)
    g_vars = _flax_spade(port_gen.state_dict())
    d_params, d_stats = _flax_multiscale(port_dis.state_dict())
    d_vars = {'params': d_params, 'spectral_stats': d_stats}
    jdis = JG.MultiScaleDiscriminator(**DIS_KW)
    vgg = VGG19Features(VGG_LAYERS, seed=3)
    jt = JTrainer(GEN_KW, jdis, cfg=JConfig(ema_beta=EMA_BETA),
                  perceptual=JL.PerceptualLoss(
                      params=_flax_vgg(vgg.state_dict()), layers=VGG_LAYERS,
                      weights=(1.0,)),
                  loss_weights=WEIGHTS, ema_start=0)
    g_params = g_vars['params']
    state = SpadeTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_params,
        g_stats=g_vars['batch_stats'], g_opt=jt.g_tx.init(g_params),
        d_params=d_vars['params'], d_stats=d_vars['spectral_stats'],
        d_opt=jt.d_tx.init(d_vars['params']),
        g_ema=jax.tree_util.tree_map(jnp.copy, g_params))
    key = jax.random.PRNGKey(5)
    kd, kg = jax.random.split(key)
    eps = (_jax_eps(gtrain, g_vars, batch['images'], kd),
           _jax_eps(gtrain, g_vars, batch['images'], kg))
    new, metrics = jt.train_step(state, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, key)
    gkey = jax.random.PRNGKey(9)
    ema_vars = {'params': new.g_ema, 'batch_stats': new.g_stats}
    gen_eps = _jax_eps(jt.gen_eval, ema_vars, batch['images'], gkey)
    # JAX's `generate`, jitted (its eager form costs ~10 s on the CPU)
    generated = jax.jit(lambda v, b, k: jt.gen_eval.apply(
        v, b, random_style=False, rngs={'style': k}))(ema_vars, batch, gkey)
    np_tree = jax.tree_util.tree_map(np.asarray, {
        'g_params': new.g_params, 'g_stats': new.g_stats,
        'd_params': new.d_params, 'd_stats': new.d_stats,
        'g_ema': new.g_ema})
    return dict(batch=batch, g_vars=g_vars, d_vars=d_vars, vgg=vgg,
                port_gen=port_gen.state_dict(),
                port_dis=port_dis.state_dict(),
                eps=eps, new=np_tree,
                metrics={k: float(v) for k, v in metrics.items()},
                gen_eps=gen_eps,
                generated=np.asarray(generated['fake_images']),
                gtrain=gtrain)


def _port_trainer(setup):
    perceptual = TL.PerceptualLoss(setup['vgg'], layers=VGG_LAYERS,
                                   weights=(1.0,))
    return SpadeTrainer(
        _port_gen(setup['g_vars']),
        _port_dis(setup['d_vars']['params'],
                  setup['d_vars']['spectral_stats']),
        cfg=TrainerConfig(ema_beta=EMA_BETA), perceptual=perceptual,
        loss_weights=WEIGHTS, ema_start=0)


@pytest.fixture(scope='module')
def stepped(setup):
    tr = _port_trainer(setup)
    metrics = tr.train_step(_t(setup['batch']), style_eps=setup['eps'])
    return tr, metrics


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_forward_and_running_stats_match_jax(setup, mode):
    """The generator with a given style in training mode (batch
    statistics, biased variance, new running statistics returned, the
    buffers untouched) and in eval mode (running statistics)."""
    batch = dict(setup['batch'])
    batch['z'] = np.random.default_rng(2).standard_normal(
        (B, GEN_KW['style_dims'])).astype(np.float32)
    jmodel = jspade.SPADEWrapper(**GEN_KW, bn_mode=mode)
    # jitted: an eager flax apply costs ~10 s of op compiles on the CPU
    if mode == 'train':
        out, mut = jax.jit(lambda v, b: jmodel.apply(
            v, b, mutable=['batch_stats']))(setup['g_vars'], batch)
        want_stats = spade_state_dict_from_flax(
            {'params': setup['g_vars']['params'], **mut})
    else:
        out = jax.jit(jmodel.apply)(setup['g_vars'], batch)
    gen = _port_gen(setup['g_vars']).train(mode == 'train')
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    with torch.no_grad():
        got = gen(_t(batch))
    np.testing.assert_allclose(got['fake_images'].numpy(),
                               np.asarray(out['fake_images']),
                               atol=TOL, rtol=0)
    for k, v in gen.state_dict().items():
        assert torch.equal(v, before[k]), k
    if mode == 'train':
        assert len(got['batch_stats']) == 2 * sum(
            isinstance(m, tspade.BatchNorm) for m in gen.modules())
        for k, v in got['batch_stats'].items():
            np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(),
                                       atol=TOL, rtol=0, err_msg=k)
    else:
        assert got['batch_stats'] == {}


@pytest.mark.parametrize('crop', [64, 512])
def test_style_encoder_matches_jax(setup, crop):
    """mu, logvar and z of the style encoder; a 512 crop is shrunk to 256
    by the antialiased bilinear resize first."""
    images = np.random.default_rng(crop).uniform(
        -1, 1, (1, crop, crop, 3)).astype(np.float32)
    key = jax.random.PRNGKey(crop)
    enc = jspade.SPADEStyleEncoder(style_dims=8, num_filters=2)
    with recorded_normals() as drawn:
        mu, logvar, z = enc.apply(
            {'params': setup['g_vars']['params']['style_encoder']}, images,
            rngs={'style': key})
    port = _port_gen(setup['g_vars']).style_encoder
    with torch.no_grad():
        got = port(torch.from_numpy(images),
                   eps=torch.from_numpy(np.array(drawn[-1])))
    for g, w in zip(got, (mu, logvar, z)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize('part', ['generator', 'discriminator'])
def test_converters_round_trip(setup, part):
    """The port's converters invert the flax layouts exactly: JAX's
    trainable SPADE variables (with the style encoder, flatten order
    included) and the multi-scale D's params and spectral stats."""
    if part == 'generator':
        got = spade_state_dict_from_flax(setup['g_vars'])
        want = setup['port_gen']
    else:
        got = multiscale_discriminator_state_dict_from_flax(
            setup['d_vars']['params'], setup['d_vars']['spectral_stats'])
        want = setup['port_dis']
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize('opt_type', toptim.OPTIMIZERS)
def test_make_optimizer_matches_optax(opt_type):
    """Three updates of each optimizer type on the same gradients, with a
    step schedule that halves the rate after two updates."""
    rng = np.random.default_rng(7)
    shapes = {'a': (3, 4), 'b': (5,), 'c': (2, 2, 3)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    policy = {'type': 'step', 'step_size': 2, 'gamma': 0.5,
              'iteration_mode': True}
    tx = joptim.make_optimizer(opt_type, 1e-2, policy)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, params)
        params = optax.apply_updates(params, upd)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    opt = toptim.make_optimizer(tparams.values(), opt_type, 1e-2, policy)
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # the state round-trips
    again = toptim.make_optimizer(tparams.values(), opt_type, 1e-2, policy)
    again.load_state_dict(opt.state_dict())
    assert again.count == opt.count == 3


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _close_params(got, want, lr=LR):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * lr + 1e-6
    return (diff > TOL).sum(), diff.size


def test_train_step_matches_jax(setup, stepped):
    """Losses, gradient norms, G and D parameters, the spectral-norm
    vectors, G's running statistics and the EMA after one step."""
    tr, metrics = stepped
    want = setup['metrics']
    assert set(metrics) == set(want)
    for k, v in want.items():
        rtol = NORM_RTOL if k.endswith('grad_norm') else LOSS_RTOL
        np.testing.assert_allclose(metrics[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=k)
    new = setup['new']
    want_g = spade_state_dict_from_flax({'params': new['g_params'],
                                         'batch_stats': new['g_stats']})
    want_d = multiscale_discriminator_state_dict_from_flax(
        new['d_params'], new['d_stats'])
    want_ema = spade_state_dict_from_flax({'params': new['g_ema'],
                                           'batch_stats': new['g_stats']})
    far = total = 0
    for sd, want_sd, lr in ((tr.gen.state_dict(), want_g, LR),
                            (tr.dis.state_dict(), want_d, 4e-4)):
        assert set(sd) == set(want_sd)
        for k, v in sd.items():
            w = want_sd[k].numpy()
            if 'running' in k or 'weight_u' in k or 'weight_sigma' in k:
                np.testing.assert_allclose(v.numpy(), w, atol=TOL, rtol=0,
                                           err_msg=k)
            else:
                n, size = _close_params(v.numpy(), w, lr)
                far, total = far + n, total + size
    assert far <= 0.01 * total
    # the EMA is (1 - beta) of the new parameters from the same old ones
    for k, v in tr.g_ema.items():
        np.testing.assert_allclose(v.numpy(), want_ema[k].numpy(),
                                   atol=(1 - EMA_BETA) * 2 * LR + 1e-6,
                                   rtol=0, err_msg=k)


def test_sync_batch_norm_two_ranks_match_jax(setup, tmp_path):
    """Two gloo ranks (`tests/_torch_spade_worker.py`), each on one item
    of the batch with its row of JAX's style draws, the batch norms synced
    over the data group, against JAX's single-device step on the whole
    batch: metrics and G's running statistics within JAX's own sync-BN
    tolerance (rtol 2e-4, atol 1e-5, `tests/test_parallel.py:141`),
    parameters as in `test_train_step_matches_jax`, and both ranks with
    the same state."""
    torch.save({'gen_kw': GEN_KW, 'dis_kw': DIS_KW,
                'g_sd': setup['port_gen'], 'd_sd': setup['port_dis'],
                'vgg_sd': setup['vgg'].state_dict(),
                'vgg_layers': VGG_LAYERS, 'ema_beta': EMA_BETA,
                'weights': WEIGHTS, 'batch': _t(setup['batch']),
                'eps': setup['eps']}, tmp_path / 'inputs.pt')
    wait_ranks(spawn_ranks(
        os.path.join(REPO, 'tests', '_torch_spade_worker.py'),
        [free_port(), str(tmp_path)]), timeout=240)
    ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
             for r in range(2)]
    for k, v in setup['metrics'].items():
        np.testing.assert_allclose(ranks[0]['metrics'][k], v, rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    new = setup['new']
    want = spade_state_dict_from_flax({'params': new['g_params'],
                                       'batch_stats': new['g_stats']})
    far = total = 0
    for k, v in ranks[0]['gen'].items():
        assert torch.equal(v, ranks[1]['gen'][k]), k
        if 'running' in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=2e-4, atol=1e-5, err_msg=k)
        else:
            n, size = _close_params(v.numpy(), want[k].numpy())
            far, total = far + n, total + size
    assert far <= 0.01 * total
    for k, v in ranks[0]['dis'].items():
        assert torch.equal(v, ranks[1]['dis'][k]), k


def test_generate_matches_jax(setup, stepped):
    """Eval mode on the EMA parameters with the encoded style."""
    tr, _ = stepped
    out = tr.generate(_t(setup['batch']), style_eps=setup['gen_eps'])
    np.testing.assert_allclose(out['fake_images'].numpy(),
                               setup['generated'], atol=TOL, rtol=0)
    assert tr.gen.training


def test_frozen_from_trained_exact(setup, stepped):
    """The fold of a trained state into the frozen oracle reproduces the
    eval forward (EMA parameters, running statistics) to 1e-6."""
    tr, _ = stepped
    frozen = tspade.SPADEWrapper(**GEN_KW).eval()
    frozen.load_state_dict(spade_frozen_from_trained(tr.state_dict()))
    z = torch.randn((B, GEN_KW['style_dims']),
                    generator=torch.Generator().manual_seed(3))
    data = {'label': torch.from_numpy(setup['batch']['label']), 'z': z}
    with torch.no_grad():
        got = frozen(data)['fake_images']
    want = tr.generate(data)['fake_images']
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # without an EMA the trained parameters themselves
    no_ema = spade_frozen_from_trained({**tr.state_dict(), 'g_ema': None})
    k = 'spade_generator.fc_0.layers.conv.weight'
    assert torch.equal(no_ema[k], tr.gen.state_dict()[k])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

YAML = """logging_iter: 1
image_save_iter: 2
snapshot_save_iter: 100
trainer:
    model_average_config: {enabled: True, beta: 0.9, start_iteration: 1}
    gan_mode: hinge
    perceptual_loss: {layers: [relu_1_1], weights: [1.0]}
    loss_weight: {gan: 1.0, perceptual: 10.0, feature_matching: 10.0,
                  kl: 0.05}
gen_opt: {type: adam, lr: 0.0001}
dis_opt: {type: rmsprop, lr: 0.0004}
gen: {num_labels: 184, style_dims: 8, num_filters: 2,
      activation_norm_params: {num_filters: 2}, style_enc: {num_filters: 2}}
dis: {num_filters: 2, max_num_filters: 8, num_discriminators: 2,
      num_layers: 3}
data:
    num_workers: 0
    one_hot_num_classes: 183
    train:
        batch_size: 2
        augmentations: {resize_smallest_side: 40, rotate: 5,
                        random_scale_limit: 0.2, horizontal_flip: True,
                        random_crop_h_w: [32, 32]}
"""


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """Three iterations straight, and two then a resume to three."""
    root = tmp_path_factory.mktemp('spade_cli')
    make_paired_folder(str(root / 'data'), 4, 48, 0)
    (root / 'tiny.yaml').write_text(YAML)

    def run(logs, *extra):
        return cli_spade.main(['--config', str(root / 'tiny.yaml'),
                               '--data-root', str(root / 'data'),
                               '--logdir', str(root / logs),
                               '--device', 'cpu', *extra])
    straight = run('straight', '--max-iter', '3')
    first = run('resumed', '--max-iter', '2')
    time.sleep(1.1)                 # run directories are named per second
    resumed = run('resumed', '--max-iter', '3', '--resume')
    return root, straight, first, resumed


def test_cli_trains_and_resumes_exactly(cli_runs):
    """The config's augmentations (rotate included), rmsprop for D, a
    snapshot at iteration 2; the run resumed at 2 ends where the straight
    run ends."""
    root, straight, first, resumed = cli_runs
    assert first.step == 2 and straight.step == resumed.step == 3
    a, b = straight.state_dict(), resumed.state_dict()
    for part in ('generator', 'discriminator', 'g_ema'):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert a['d_opt']['count'] == b['d_opt']['count'] == 3
    snaps = list((root / 'straight').glob('*/images/train_snapshot_*.png'))
    assert len(snaps) == 1


def test_fold_into_train_cli_oracle(cli_runs):
    """`cli.train --spade-checkpoint <train_spade run>`: the oracle is the
    folded EMA generator, equal to the trainer's eval `generate` with the
    same random style."""
    root, straight, _, _ = cli_runs
    run_dir = next((root / 'straight').iterdir())
    args = argparse.Namespace(spade_checkpoint=str(run_dir), spade_size=256,
                              spade_res=32, spade_filters=128,
                              spade_oracle_f32=True)
    oracle = cli_train._load_spade_oracle(args, torch.device('cpu'))
    masks = torch.from_numpy(_batch(4, num_labels=185)['label'])
    got = oracle(masks, torch.Generator().manual_seed(6))
    want = straight.generate({'label': masks[..., :-1]},
                             generator=torch.Generator().manual_seed(6))
    np.testing.assert_allclose(got.numpy(), want['fake_images'].numpy(),
                               atol=1e-5, rtol=0)
    # a checkpoint file and the checkpoints directory load the same
    ckpt = os.path.join(run_dir, 'checkpoints')
    for path in (ckpt, os.path.join(ckpt, 'step_00000003.pt')):
        args.spade_checkpoint = path
        again = cli_train._load_spade_oracle(args, torch.device('cpu'))
        assert torch.equal(again(masks, torch.Generator().manual_seed(6)),
                           got)
