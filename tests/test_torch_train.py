"""The port's training step against the JAX package's, on the CPU.

One `train_step_shared` and one `train_step` of the JAX `GANTrainer`
and of the port's, from the same weights (flax init, carried over by the
port's converters) on the same batch. The TINY generator of
`tests/test_train.py` with deterministic depth sampling; the style
encoder's reparameterisation draws are JAX's own (`generator.py:473,
480-483`), handed to the port. The JAX table-gradient payloads are
patched to float32 (`SORT_PAYLOAD_DTYPE`, `_SPLAT_DTYPE`).

Tolerances: losses 1e-5 relative and gradient norms 1e-4 relative
(float32 sums in another order: XLA's fused convolutions and matmuls vs
oneDNN, sorted segments vs `index_add_`). The KL term also gets 1e-6
absolute: it sums B*S = 32 terms 1 + logvar - mu^2 - e^logvar whose O(1)
parts cancel to ~1e-5 each near logvar = mu = 0, so every term keeps
float32 rounding of its O(1) parts (32 * 6e-8 ~ 2e-6 at worst).

Updated parameters: 1e-6 absolute wherever the port's gradient has
|g| >= 1e-5. With beta1 = 0 the first Adam update is lr * g / (|g| +
1e-7), about +-lr; a gradient difference dg moves it by at most
lr * dg * 1e-7 / |g|^2, which at |g| >= 1e-5 is below 1e-7 for any
dg < 1e-5. Where |g| is near Adam's eps the update is the sign of
float32 noise: a D element there can move by up to 2 lr_D = 8e-4 on
one side only, and the G gradient through that D then differs by
~1e-6 on some elements. Those elements are held to the update's range,
2 lr, and to be fewer than 1% of all (measured: 0.3% in the two-forward
step, under 0.1% in the shared one)."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.data.synthetic import make_batch as j_make_batch
from scenedreamer_tpu.data.synthetic import make_world
from scenedreamer_tpu.models.discriminator import \
    GANcraftDiscriminator as JDis
from scenedreamer_tpu.models.generator import SceneDreamerGenerator as JGen
from scenedreamer_tpu.ops import hashgrid as jhg
from scenedreamer_tpu.train import losses as JL
from scenedreamer_tpu.train.trainer import GANTrainer as JTrainer
from scenedreamer_tpu.train.trainer import TrainerConfig as JConfig
from scenedreamer_tpu_torch.models.discriminator import GANcraftDiscriminator
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.models.vgg import VGG19Features
from scenedreamer_tpu_torch.train import losses as L
from scenedreamer_tpu_torch.train.trainer import (GANTrainer, TrainerConfig,
                                                  latest_checkpoint,
                                                  load_checkpoint,
                                                  save_checkpoint)
from scenedreamer_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax,
    vgg_state_dict_from_flax)
from _torch_parity import cap_torch_threads, port_config
from test_train import TINY as TRAIN_TINY

cap_torch_threads()

TINY = dataclasses.replace(TRAIN_TINY, coarse_deterministic_sampling=True)
NUM_LBL, NF = 12, 8
LOSS_RTOL, NORM_RTOL, KL_ATOL = 1e-5, 1e-4, 1e-6
PARAM_ATOL, GRAD_MIN = 1e-6, 1e-5


def _style_eps(key, b):
    """The reparameterisation eps the JAX generator draws from `key`."""
    k_style, _ = jax.random.split(key)
    return np.array(jax.random.normal(k_style, (b, TINY.style_dims)))


@pytest.fixture(scope='module')
def setup():
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    batch = j_make_batch(world, batch_size=2, height=34, width=34,
                         max_samples=4, pad=TINY.pad, seed=3)
    perc = JL.PerceptualLoss(layers=('relu_2_1',), weights=(1.0,))
    jt = JTrainer(JGen(cfg=TINY), JDis(num_labels=NUM_LBL, num_filters=NF),
                  world.dims, cfg=JConfig(), perceptual=perc,
                  iters_per_epoch=10)
    key = jax.random.PRNGKey(0)
    state0 = jt.init_state(key, batch)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(state0))
    k = jax.random.PRNGKey(3)
    kd, kg = jax.random.split(k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhg, 'SORT_PAYLOAD_DTYPE', jnp.float32)
        mp.setattr(jhg, '_SPLAT_DTYPE', jnp.float32)
        copy1 = jax.tree_util.tree_map(jnp.array, host)
        s_shared, m_shared = jt.train_step_shared(copy1, batch, k)
        copy2 = jax.tree_util.tree_map(jnp.array, host)
        s_two, m_two = jt.train_step(copy2, batch, k)
    get = jax.device_get
    return dict(
        world=world, perc_params=perc.params,
        batch={n: torch.from_numpy(np.array(v)) for n, v in batch.items()},
        init=host,
        shared=(get(s_shared), {n: float(v) for n, v in m_shared.items()}),
        two=(get(s_two), {n: float(v) for n, v in m_two.items()}),
        eps_shared=_style_eps(k, 2),
        eps_two=(_style_eps(kd, 2), _style_eps(kg, 2)))


def _port_trainer(setup, cfg=None):
    init = setup['init']
    gen = SceneDreamerGenerator(port_config(TINY))
    gen.load_state_dict(generator_state_dict_from_flax(init.g_params))
    dis = GANcraftDiscriminator(num_labels=NUM_LBL, num_filters=NF)
    dis.load_state_dict(discriminator_state_dict_from_flax(init.d_params,
                                                           init.d_stats))
    vgg = VGG19Features(('relu_2_1',))
    vgg.load_state_dict(vgg_state_dict_from_flax(setup['perc_params']))
    perc = L.PerceptualLoss(vgg, layers=('relu_2_1',), weights=(1.0,))
    return GANTrainer(gen, dis, setup['world'].dims, cfg=cfg,
                      perceptual=perc, iters_per_epoch=10)


def _assert_state(tr, jstate):
    lr_of = {id(p): g['lr'] for o in (tr.g_opt, tr.d_opt)
             for g in o.opt.param_groups for p in g['params']}
    params = {**dict(tr.gen.named_parameters()),
              **dict(tr.dis.named_parameters())}
    pairs = ((tr.gen.state_dict(),
              generator_state_dict_from_flax(jstate.g_params)),
             (tr.dis.state_dict(),
              discriminator_state_dict_from_flax(jstate.d_params,
                                                 jstate.d_stats)))
    n_loose = n_all = 0
    for got, want in pairs:
        assert set(got) == set(want)
        for name, w in want.items():
            err = (got[name] - w).abs()
            p = params.get(name)
            if p is None:                      # spectral-norm buffers
                assert float(err.max()) <= PARAM_ATOL, name
                continue
            flat = p.grad.abs() < GRAD_MIN
            bad = err > torch.where(flat, 2 * lr_of[id(p)] + PARAM_ATOL,
                                    PARAM_ATOL)
            assert not bad.any(), (name, int(bad.sum()), float(err.max()))
            n_loose += int((flat & (err > PARAM_ATOL)).sum())
            n_all += err.numel()
    assert n_loose < 1e-2 * n_all, (n_loose, n_all)


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        rtol = NORM_RTOL if name.endswith('grad_norm') else LOSS_RTOL
        atol = KL_ATOL if name == 'gen/kl' else 0.0
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol,
                                   err_msg=name)


def test_shared_step_matches_jax(setup):
    tr = _port_trainer(setup)
    g0 = {n: p.detach().clone() for n, p in tr.gen.named_parameters()}
    m = tr.train_step_shared(setup['batch'],
                             style_eps=torch.from_numpy(setup['eps_shared']))
    jstate, jm = setup['shared']
    _assert_metrics(m, jm)
    _assert_state(tr, jstate)
    assert tr.step == int(jstate.step) == 1
    for name in ('hash_encoder.embeddings', 'world_encoder.fc2.weight',
                 'style_encoder.fc_var.weight'):
        assert (dict(tr.gen.named_parameters())[name] != g0[name]).any()


def test_two_forward_step_matches_jax(setup):
    tr = _port_trainer(setup)
    m = tr.train_step(setup['batch'],
                      style_eps=tuple(torch.from_numpy(e)
                                      for e in setup['eps_two']))
    jstate, jm = setup['two']
    _assert_metrics(m, jm)
    _assert_state(tr, jstate)


def test_shared_step_equals_two_forward_with_same_draws(setup):
    """The port's single-render step is the D update then the G update
    on the same render."""
    eps = torch.from_numpy(setup['eps_shared'])
    a, b = _port_trainer(setup), _port_trainer(setup)
    ma = a.train_step_shared(setup['batch'], style_eps=eps)
    mb = {**b.dis_step(setup['batch'], style_eps=eps),
          **b.gen_step(setup['batch'], style_eps=eps)}
    _assert_metrics(ma, mb)
    for (n, x), y in zip(a.gen.state_dict().items(),
                         b.gen.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-7, msg=n)
    for (n, x), y in zip(a.dis.state_dict().items(),
                         b.dis.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-7, msg=n)


@pytest.mark.parametrize('step', ['train_step_shared', 'train_step'])
def test_steps_record_their_spans(setup, step):
    """With the recorder on, a step is one step unit: `train.render`,
    `train.dis_update` (backward, clip read, Adam, metrics read),
    `train.gen_loss`, `train.gen_update` (the same and the EMA); the
    two-forward step renders again before the G loss. Each update reads
    its gradient norm once (2 `clip_read` spans) and each metric tensor
    once; no mesh, no exchange."""
    from scenedreamer_tpu_torch.utils import profiling
    tr = _port_trainer(setup, TrainerConfig(ema_beta=0.5))
    eps = torch.from_numpy(setup['eps_shared'])
    profiling.enable()
    try:
        profiling.take()
        m = getattr(tr, step)(setup['batch'], style_eps=eps if step ==
                              'train_step_shared' else (eps, eps))
        got = profiling.take()
    finally:
        profiling.disable()
    spans = sorted(got['spans'], key=lambda s: s.start_ns)
    (root,) = [s for s in spans if s.name == 'train.step']
    assert got['units'] == {root.unit: 'step'}

    def children(parent):
        return [s.name for s in spans if s.parent == parent.id]
    render = ['train.render'] * (2 if step == 'train_step' else 1)
    assert children(root) == render[:1] + ['train.dis_update'] \
        + render[1:] + ['train.gen_loss', 'train.gen_update']
    (dis,) = [s for s in spans if s.name == 'train.dis_update']
    (gen,) = [s for s in spans if s.name == 'train.gen_update']
    assert children(dis) == ['backward', 'clip_read', 'adam', 'metrics_read']
    assert children(gen) == ['backward', 'clip_read', 'adam', 'ema',
                             'metrics_read']
    reads = [s for s in spans if s.kind == 'read']
    assert [s.name for s in reads].count('clip_read') == 2
    assert {s.name for s in reads} == {'clip_read', 'metrics_read'}
    # the two gradient norms are read by the clip, every other metric by
    # its update's metrics read
    assert got['counters'] == {'host_reads': len(m)}
    assert all(s.unit == root.unit for s in spans)


def _snapshot(tr):
    return (copy.deepcopy(tr.gen.state_dict()),
            copy.deepcopy(tr.dis.state_dict()),
            tr.g_opt.count, tr.d_opt.count, len(tr.g_opt.opt.state),
            len(tr.d_opt.opt.state))


@pytest.mark.parametrize('case', ['nonfinite_batch', 'skip_grad_norm'])
def test_skipped_update_keeps_params_and_optimizer(setup, case):
    batch = dict(setup['batch'])
    cfg = TrainerConfig()
    if case == 'nonfinite_batch':
        img = batch['pseudo_real_img'].clone()
        img[0, 0, 0, 0] = float('nan')
        batch['pseudo_real_img'] = img
    else:
        cfg = TrainerConfig(skip_grad_norm=1e-9)
    tr = _port_trainer(setup, cfg)
    g_sd, _, *counts = _snapshot(tr)
    m = tr.train_step_shared(batch,
                             style_eps=torch.from_numpy(setup['eps_shared']))
    if case == 'nonfinite_batch':
        assert not np.isfinite(m['gen/grad_norm'])
        assert not np.isfinite(m['dis/grad_norm'])
    else:
        assert m['gen/grad_norm'] > 1e-9 and m['dis/grad_norm'] > 1e-9
    g_after, _, *counts_after = _snapshot(tr)
    assert counts_after == counts == [0, 0, 0, 0]
    for n, v in g_sd.items():
        assert torch.equal(v, g_after[n]), n
    assert tr.step == 1


def test_checkpoint_round_trip(setup, tmp_path):
    eps = torch.from_numpy(setup['eps_shared'])
    tr = _port_trainer(setup, TrainerConfig(ema_beta=0.9))
    tr.train_step_shared(setup['batch'], style_eps=eps)
    assert latest_checkpoint(tmp_path) is None
    path = save_checkpoint(tmp_path, tr)
    assert latest_checkpoint(tmp_path) == path
    fresh = GANTrainer(SceneDreamerGenerator(port_config(TINY), seed=5),
                       GANcraftDiscriminator(NUM_LBL, NF, seed=5),
                       setup['world'].dims,
                       cfg=TrainerConfig(ema_beta=0.9),
                       perceptual=tr.perceptual, iters_per_epoch=10)
    assert load_checkpoint(tmp_path, fresh) == path
    assert fresh.step == 1 and fresh.g_opt.count == 1
    for a, b in ((tr.gen, fresh.gen), (tr.dis, fresh.dis)):
        for (n, x), y in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(x, y), n
    for n, v in tr.g_ema.items():
        assert torch.equal(v, fresh.g_ema[n])
    # the restored trainer takes the same next step
    m1 = tr.train_step_shared(setup['batch'], style_eps=eps)
    m2 = fresh.train_step_shared(setup['batch'], style_eps=eps)
    assert m1 == m2


def test_feature_matching_term(setup):
    """With `use_feature_matching`, the G loss adds the weighted L1
    distance of D's fake and pseudo-real features (the loss itself is
    held against JAX in `test_torch_train_modules.py`)."""
    weights = dict(L.DEFAULT_LOSS_WEIGHTS, feature_matching=10.0)
    tr = _port_trainer(setup, TrainerConfig(loss_weights=weights,
                                            use_feature_matching=True))
    m = tr.train_step_shared(setup['batch'],
                             style_eps=torch.from_numpy(setup['eps_shared']))
    assert m['gen/feature_matching'] > 0
    total = sum(weights[k] * m[f'gen/{n}'] for k, n in (
        ('gan', 'gan'), ('pseudo_gan', 'pgan'), ('kl', 'kl'),
        ('perceptual', 'perceptual'), ('l2', 'l2'),
        ('feature_matching', 'feature_matching')))
    np.testing.assert_allclose(m['gen/total'], total, rtol=1e-6)


def test_aug_policy_is_refused(setup):
    """DiffAugment runs (held against JAX in
    `tests/test_torch_train_amp.py`); a policy name it does not know is
    refused when the trainer is built."""
    with pytest.raises(ValueError, match='unknown DiffAugment'):
        _port_trainer(setup, TrainerConfig(aug_policy='color,flip'))
    tr = _port_trainer(setup, TrainerConfig(aug_policy='color,cutout'))
    m = tr.train_step_shared(setup['batch'],
                             torch.Generator().manual_seed(0),
                             style_eps=torch.from_numpy(setup['eps_shared']))
    jm = setup['shared'][1]
    assert all(np.isfinite(v) for v in m.values())
    assert m['dis/total'] != jm['dis/total']      # D saw augmented images
    assert m['gen/l2'] == pytest.approx(jm['gen/l2'], rel=LOSS_RTOL)
