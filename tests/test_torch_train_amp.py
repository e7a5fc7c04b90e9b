"""bf16 AMP training, DiffAugment in the trainer, the discriminator with
the nearest label resize and `train_step_fused` in the port, against the
JAX package on the CPU.

The step: one `train_step_shared` of the TINY generator of
`tests/test_train.py` (deterministic depth sampling), the discriminator
with `smooth_resample=False` and the VGG loss, `aug_policy=
'color,translation,cutout'`, from the same weights (the port's seeded
init, carried to flax by the JAX package's reference converter and by
hand for D and VGG) on the same batch, with JAX's style eps and JAX's
DiffAugment draws (`fold_in(key, 101)` for the D update, 102 for the G
update, each split 3 ways: images, pseudo-real, fake) fed to the port.
JAX's table-gradient payloads are patched to float32. JAX runs the step
in bf16 (`dtype=bfloat16` in G, D and VGG, each compiled once) and in
float32.

* float32: the port's step equals JAX's within `test_torch_train.py`'s
  tolerances (losses 1e-5 relative, norms 1e-4, parameters 1e-6 where
  the gradient is not flat).
* bf16: held to JAX's own bf16-to-float32 distance on the same step, as
  `test_torch_inference.py` holds the bf16 frame. A distance is a triple:
  the largest relative difference over the losses (|a - b| / max(|b|,
  1e-2)), the same over the two gradient norms, and the mean absolute
  difference of the updated parameters. Measured on the CPU, D at the
  flagship 128 filters:
    JAX bf16 to JAX float32   2.08e-3, 2.54e-2, 5.86e-6 (JAX's own);
    port bf16 to JAX bf16     5.74e-4, 1.43e-2, 4.47e-6 (0.28, 0.56,
                              0.76 of JAX's own);
    port bf16 to float32      1.50e-3, 1.14e-2, 5.74e-6 (0.72, 0.45,
                              0.98 of JAX's own).
  Held: the port's bf16 step within JAX's own distance of JAX's bf16
  step, and the port's own bf16-to-float32 distance within 1.25x JAX's,
  on all three. The two bf16 paths part at the biases' gradient, which
  XLA's transpose of the bf16 bias add sums over the image in bf16 while
  the port's convs sum it in float32 (with an 8-filter D, D's output-conv
  bias gradient was 7.5% from float32 in JAX's bf16 step, 0.23% in the
  port's, and the port's norms sat 1.1x JAX's own distance from JAX's
  bf16 step but 0.12x from float32). `chip_smoke.BF16_STEP_LIMIT_LOSS`
  and `_NORM` are 4x JAX's own loss and norm distances here.
* D (both label resizes; 8 filters) and VGG in bf16, un-jitted: within
  0.5x JAX's own bf16-to-float32 distance (D's logits and deepest
  feature equal to JAX's bf16 ones, JAX's own 2.3e-5 and 4.3e-4; VGG's
  mean 3.5e-6 against 6.7e-4); the spectral-norm state float32 and
  equal to 1e-6.
* `train_step_fused` equals `train_step` bit for bit. (The nearest label
  resize, `ops/resize.py:resize_nearest`, is held equal to JAX's in
  `test_torch_sampling.py`, which shares it.)
"""
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
from scenedreamer_tpu.models.vgg import VGG19Features as JVGG
from scenedreamer_tpu.ops import hashgrid as jhg
from scenedreamer_tpu.scene.labels import get_label_translator
from scenedreamer_tpu.train import losses as JL
from scenedreamer_tpu.train import optim as joptim
from scenedreamer_tpu.train.trainer import GANTrainer as JTrainer
from scenedreamer_tpu.train.trainer import TrainerConfig as JConfig
from scenedreamer_tpu.train.trainer import TrainState
from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
from scenedreamer_tpu_torch.models.discriminator import GANcraftDiscriminator
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.models.vgg import VGG19Features
from scenedreamer_tpu_torch.train import losses as L
from scenedreamer_tpu_torch.train.trainer import GANTrainer, TrainerConfig
from _torch_parity import cap_torch_threads, jax_diff_aug_draws, port_config
from test_torch_train import TINY, _assert_metrics, _assert_state, _style_eps

cap_torch_threads()

POLICY = 'color,translation,cutout'
# D at the flagship width (configs/scenedreamer_train.yaml): D's first
# Adam step (beta1 = 0) moves each weight by about +-lr, so bf16 noise in
# its small gradients flips signs, and the G losses see that through the
# updated D; with 8 filters JAX's own loss distance was 8x smaller than
# at 128, and 4x of it fell short of the card's reading. The module tests
# and the fused step use an 8-filter D (SMALL_NF) for time.
NUM_LBL, NF, SMALL_NF, LAYERS = 12, 128, 8, ('relu_2_1',)
BF16 = torch.bfloat16
FLOOR = 1e-2            # the relative distances' denominator floor
TO_JAX = 1.0            # port-to-JAX-bf16 distance / JAX's own, at most
OWN_ERROR = 1.25        # the port's bf16-to-float32 distance / JAX's


def _flax_dis(sd):
    """The port's discriminator state dict -> flax (params, spectral
    stats), the inverse of `discriminator_state_dict_from_flax`."""
    params, stats = {}, {}
    for key, v in sd.items():
        _, name, leaf = key.split('.')
        v = v.numpy()
        if leaf == 'weight':
            params.setdefault(name, {})['kernel'] = v.transpose(2, 3, 1, 0)
        elif leaf == 'bias':
            params.setdefault(name, {})['bias'] = v
        else:
            sn = stats.setdefault(name, {'SpectralNorm_0': {}})
            sn['SpectralNorm_0'][{'weight_u': 'Conv_0/kernel/u',
                                  'weight_sigma': 'Conv_0/kernel/sigma'}
                                 [leaf]] = v
    return ({'fpse': {n: {'Conv_0': p} for n, p in params.items()}},
            {'fpse': stats})


def _flax_vgg(sd):
    out = {}
    for key, v in sd.items():
        name, leaf = key.split('.')
        out.setdefault(name, {})[
            'kernel' if leaf == 'weight' else leaf] = \
            v.numpy().transpose(2, 3, 1, 0) if leaf == 'weight' else v.numpy()
    return {'params': out}


def _jax_step(world, batch, weights, dtype, key):
    # fresh copies: the step donates its state
    g_params, (d_params, d_stats), v_params = jax.tree_util.tree_map(
        jnp.array, weights)
    jt = JTrainer(
        JGen(cfg=dataclasses.replace(TINY, dtype=dtype)),
        JDis(num_labels=NUM_LBL, num_filters=NF, smooth_resample=False,
             dtype=dtype), world.dims, cfg=JConfig(aug_policy=POLICY),
        perceptual=JL.PerceptualLoss(params=v_params, layers=LAYERS,
                                     weights=(1.0,), dtype=dtype),
        iters_per_epoch=10)
    jt.g_tx = joptim.make_generator_optimizer(g_params, iters_per_epoch=10)
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params,
                       g_opt=jt.g_tx.init(g_params), d_params=d_params,
                       d_stats=d_stats, d_opt=jt.d_tx.init(d_params))
    state, metrics = jt.train_step_shared(state, batch, key)
    return jax.device_get(state), {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope='module')
def setup():
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    batch = j_make_batch(world, batch_size=2, height=34, width=34,
                         max_samples=4, pad=TINY.pad, seed=3)
    get_label_translator()          # built once, outside any trace
    gen = SceneDreamerGenerator(port_config(TINY), seed=1)
    dis = GANcraftDiscriminator(NUM_LBL, NF, seed=1)
    vgg = VGG19Features(LAYERS, seed=1)
    sds = tuple(m.state_dict() for m in (gen, dis, vgg))
    weights = (
        convert_scenedreamer_generator(
            {k: v.numpy() for k, v in sds[0].items()})['params'],
        _flax_dis(sds[1]), _flax_vgg(sds[2]))
    key = jax.random.PRNGKey(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhg, 'SORT_PAYLOAD_DTYPE', jnp.float32)
        mp.setattr(jhg, '_SPLAT_DTYPE', jnp.float32)
        steps = {dt: _jax_step(world, batch, weights, dt, key)
                 for dt in (jnp.bfloat16, jnp.float32)}
    shape = batch['images'].shape
    draws = {(update, name): jax_diff_aug_draws(ks[i], POLICY, shape)
             for update, salt in (('dis', 101), ('gen', 102))
             for ks in [jax.random.split(jax.random.fold_in(key, salt), 3)]
             for i, name in enumerate(('images', 'pseudo_real_img',
                                       'fake_images'))}
    return dict(world=world, sds=sds, draws=draws,
                batch={n: torch.from_numpy(np.array(v))
                       for n, v in batch.items()},
                eps=torch.from_numpy(_style_eps(key, 2)),
                bf16=steps[jnp.bfloat16], f32=steps[jnp.float32])


def _port_step(setup, dtype):
    """The port's trainer at compute dtype `dtype` from the fixture's
    weights, after one `train_step_shared` with JAX's draws."""
    gen = SceneDreamerGenerator(dataclasses.replace(
        port_config(TINY), dtype=dtype))
    dis = GANcraftDiscriminator(NUM_LBL, NF, smooth_resample=False,
                                dtype=dtype)
    vgg = VGG19Features(LAYERS, dtype=dtype)
    for m, sd in zip((gen, dis, vgg), setup['sds']):
        m.load_state_dict(sd)
    tr = GANTrainer(gen, dis, setup['world'].dims,
                    cfg=TrainerConfig(aug_policy=POLICY),
                    perceptual=L.PerceptualLoss(vgg, layers=LAYERS,
                                                weights=(1.0,)),
                    iters_per_epoch=10)
    draws = setup['draws']
    tr._aug_draws = lambda update, name, x, g: draws[(update, name)]
    m = tr.train_step_shared(setup['batch'], style_eps=setup['eps'])
    return tr, m


def _params(tr_or_state):
    """Every G and D parameter, flattened, in one fixed order."""
    from scenedreamer_tpu_torch.utils.convert import (
        discriminator_state_dict_from_flax, generator_state_dict_from_flax)
    if isinstance(tr_or_state, GANTrainer):
        g = dict(tr_or_state.gen.named_parameters())
        d = dict(tr_or_state.dis.named_parameters())
    else:
        g = generator_state_dict_from_flax(tr_or_state.g_params)
        d = discriminator_state_dict_from_flax(tr_or_state.d_params,
                                               tr_or_state.d_stats)
    return torch.cat([v.detach().float().reshape(-1) for _, v in
                      sorted({**{'g.' + k: v for k, v in g.items()},
                              **{'d.' + k: v for k, v in d.items()
                                 if not k.endswith(('_u', '_sigma'))}}
                             .items())])


def _distances(got, want, p_got, p_want):
    """(losses, gradient norms, mean |parameter difference|)."""
    def rel(names):
        return max(abs(got[n] - want[n]) / max(abs(want[n]), FLOOR)
                   for n in names)
    norms = [n for n in want if n.endswith('grad_norm')]
    losses = [n for n in want if n not in norms]
    return rel(losses), rel(norms), float((p_got - p_want).abs().mean())


def test_float32_step_with_diff_aug_matches_jax(setup):
    tr, m = _port_step(setup, torch.float32)
    jstate, jm = setup['f32']
    _assert_metrics(m, jm)
    _assert_state(tr, jstate)


def test_amp_step_within_jax_bf16_distance(setup):
    tr, m = _port_step(setup, BF16)
    for p in list(tr.gen.parameters()) + list(tr.dis.parameters()):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()
    for st in tr.g_opt.opt.state.values():
        assert all(v.dtype == torch.float32 for v in st.values()
                   if torch.is_tensor(v) and v.is_floating_point())
    (sb, mb), (sf, mf) = setup['bf16'], setup['f32']
    assert set(m) == set(mb)
    p_port, p_bf16, p_f32 = _params(tr), _params(sb), _params(sf)
    jax_d = _distances(mb, mf, p_bf16, p_f32)
    to_jax = _distances(m, mb, p_port, p_bf16)
    own = _distances(m, mf, p_port, p_f32)
    print('[amp step] JAX bf16 to float32 (losses, norms, params)', jax_d,
          '; port bf16 to JAX bf16', to_jax, '; port bf16 to float32', own)
    for p, j in zip(to_jax, jax_d):
        assert p <= TO_JAX * j, (to_jax, jax_d)
    for p, j in zip(own, jax_d):
        assert p <= OWN_ERROR * j, (own, jax_d)


def _module_distances(jfn, tfn, x, reduce=np.max):
    """(port bf16 to JAX bf16, JAX bf16 to JAX float32): `reduce` of the
    absolute difference of each output of `jfn(dtype, x)` /
    `tfn(dtype, x)` (dicts of arrays), per output name."""
    jb, jf = jfn(jnp.bfloat16, x), jfn(jnp.float32, x)
    tb = tfn(BF16, x)
    return {n: (float(reduce(np.abs(tb[n].float().numpy()
                                    - np.asarray(jb[n], np.float32)))),
                float(reduce(np.abs(np.asarray(jb[n], np.float32)
                                    - np.asarray(jf[n]))))) for n in jb}


@pytest.mark.parametrize('smooth', [True, False])
def test_discriminator_bf16_matches_jax(setup, smooth):
    """D in bf16 (one update_stats call on the batch's real branch):
    logits float32, labels equal, the spectral-norm state float32 and
    equal to 1e-6, logits and features within 0.5x JAX's own
    bf16-to-float32 distance."""
    b = {k: v.numpy() for k, v in setup['batch'].items()}
    d_sd = GANcraftDiscriminator(NUM_LBL, SMALL_NF, seed=2).state_dict()
    params, stats = _flax_dis(d_sd)

    def jfn(dt, _):
        jd = JDis(num_labels=NUM_LBL, num_filters=SMALL_NF,
                  smooth_resample=smooth,
                  dtype=dt)
        out, mut = jd.apply({'params': params, 'spectral_stats': stats}, b,
                            {'fake_images': b['pseudo_real_img']},
                            incl_real=True, update_stats=True,
                            mutable=['spectral_stats'])
        res = {'pred': out['real_outputs'][0]['pred'],
               'label': out['real_outputs'][0]['label'],
               'feat15': out['real_features'][4],
               'u': mut['spectral_stats']['fpse']['enc3']['SpectralNorm_0'][
                   'Conv_0/kernel/u']}
        assert res['pred'].dtype == jnp.float32
        return res

    def tfn(dt, _):
        td = GANcraftDiscriminator(NUM_LBL, SMALL_NF, smooth_resample=smooth,
                                   dtype=dt)
        td.load_state_dict(d_sd)
        with torch.no_grad():
            out = td(setup['batch'],
                     {'fake_images': setup['batch']['pseudo_real_img']},
                     incl_real=True, update_stats=True)
        assert out['real_outputs'][0]['pred'].dtype == torch.float32
        assert td.fpse.enc3.weight_u.dtype == torch.float32
        return {'pred': out['real_outputs'][0]['pred'],
                'label': out['real_outputs'][0]['label'],
                'feat15': out['real_features'][4],
                'u': td.fpse.enc3.weight_u}

    d = _module_distances(jfn, tfn, None)
    print('[D bf16]', d)
    assert d['label'][0] == 0 and d['u'][0] <= 1e-6
    for name in ('pred', 'feat15'):
        assert d[name][0] <= 0.5 * d[name][1], (name, d[name])


def test_vgg_bf16_matches_jax(setup):
    """VGG19 to relu_2_1 in bf16 against JAX's bf16 module: the mean
    difference within 0.5x JAX's own bf16-to-float32 mean distance (the
    largest difference is one bf16 rounding step of an activation ~1.5,
    0.0078, where the two round a conv sum the other way; JAX's own
    largest is 0.0072)."""
    x = setup['batch']['images'].numpy()
    params = _flax_vgg(setup['sds'][2])

    def jfn(dt, v):
        return JVGG(layers=LAYERS, dtype=dt).apply(params, jnp.asarray(v))

    def tfn(dt, v):
        tv = VGG19Features(LAYERS, dtype=dt)
        tv.load_state_dict(setup['sds'][2])
        with torch.no_grad():
            out = tv(torch.from_numpy(v))
        assert out[LAYERS[0]].dtype == dt
        return out

    d = _module_distances(jfn, tfn, x, reduce=np.mean)
    print('[VGG bf16]', d)
    assert d[LAYERS[0]][0] <= 0.5 * d[LAYERS[0]][1], d


def test_train_step_fused_equals_train_step(setup):
    """`train_step_fused` is `train_step` (the D then the G update, each
    on a generator split from the caller's): from the same state with
    the same generator seed, with DiffAugment on, the same metrics and
    parameters bit for bit; a second seed gives other draws."""
    def run(method, seed):
        gen = SceneDreamerGenerator(dataclasses.replace(
            port_config(TINY), coarse_deterministic_sampling=False))
        dis = GANcraftDiscriminator(NUM_LBL, SMALL_NF, seed=2)
        gen.load_state_dict(setup['sds'][0])
        tr = GANTrainer(gen, dis, setup['world'].dims,
                        cfg=TrainerConfig(aug_policy=POLICY),
                        iters_per_epoch=10)
        m = getattr(tr, method)(setup['batch'],
                                torch.Generator().manual_seed(seed))
        return m, torch.cat([p.detach().reshape(-1) for p in
                             list(gen.parameters()) + list(dis.parameters())])
    m1, p1 = run('train_step', 7)
    m2, p2 = run('train_step_fused', 7)
    m3, _ = run('train_step_fused', 8)
    assert m1 == m2 and torch.equal(p1, p2)
    assert m3['dis/total'] != m1['dis/total']


@pytest.mark.parametrize('spec', ['folded', 'unfolded'])
def test_hash_functions_see_float32_under_amp(setup, monkeypatch, spec):
    """Under AMP the hash autograd Functions (the kernels' callers) take
    float32 inputs and cotangents and return float32 gradients: the
    RenderMLP's first layer casts the encoding, and the bf16 scene code
    is rounded, then carried in float32, before the bake."""
    from scenedreamer_tpu_torch.ops import hashgrid as hg
    seen, calls = [], set()

    def watch(cls):
        fwd, bwd = cls.forward, cls.backward

        def forward(ctx, *args):
            calls.add((cls.__name__, 'forward'))
            seen.extend(a.dtype for a in args
                        if torch.is_tensor(a) and a.is_floating_point())
            return fwd(ctx, *args)

        def backward(ctx, *grads):
            calls.add((cls.__name__, 'backward'))
            out = bwd(ctx, *grads)
            seen.extend(t.dtype for t in grads + tuple(out)
                        if torch.is_tensor(t))
            return out
        monkeypatch.setattr(cls, 'forward', staticmethod(forward))
        monkeypatch.setattr(cls, 'backward', staticmethod(backward))

    names = ('HashBake', 'HashEncode') if spec == 'folded' \
        else ('HashEncodeGeneral',)
    for name in names:
        watch(getattr(hg, name))
    extra = {} if spec == 'folded' else dict(hash_base_resolution=2,
                                             hash_desired_resolution=16)
    gen = SceneDreamerGenerator(dataclasses.replace(
        port_config(TINY), dtype=BF16, **extra))
    tr = GANTrainer(gen, GANcraftDiscriminator(NUM_LBL, SMALL_NF, dtype=BF16),
                    setup['world'].dims, cfg=TrainerConfig(aug_policy=POLICY))
    m = tr.train_step_shared(setup['batch'], torch.Generator().manual_seed(0))
    assert all(np.isfinite(v) for v in m.values())
    assert calls == {(n, d) for n in names
                     for d in ('forward', 'backward')}, calls
    assert set(seen) == {torch.float32}, set(seen)
