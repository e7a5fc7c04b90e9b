"""The port's layer library (`scenedreamer_tpu_torch/models/blocks.py`)
and `models/spade.py:DualAdaptiveNorm` against the JAX package's, on the
same numpy inputs with every parameter drawn from a seeded generator
(`_torch_blocks_parity.parity`: forward within 1e-5 of the largest JAX
value + 1e-6, gradients within 1e-4 + 1e-7), and the coverage of the
three JAX modules' names by the port.

Each case is one option value that changes the maths: every `order`
shape, every norm type (flax's epsilon 1e-6 and fast variance), weight
norm none / spectral (with `update_stats` off and on) / weight, the
`fused_` activations' sqrt(2) gain, stride 1 / 2 / 0.5 (the flax
`ConvTranspose` kernel flipped by the converter), blur on and off, the
partial conv's mask given and absent and `multi_channel`, hyper weights
given and None, `is_spatial` and `bias_only`. One bf16 `Conv2dBlock` is
held to 4x JAX's own bf16-to-float32 distance."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_blocks_parity import (  # noqa: F401 (a fixture)
    GRAD_ABS, GRAD_REL, assert_close, fn_parity, nchw, parity,
    quick_jax_compiles, to_torch)
from _torch_parity import cap_torch_threads
from scenedreamer_tpu.models import blocks as jb
from scenedreamer_tpu.models import blocks_ext as jbx
from scenedreamer_tpu.models import spade as jspade
from scenedreamer_tpu_torch.models import blocks as tb
from scenedreamer_tpu_torch.models import blocks_ext as tbx
from scenedreamer_tpu_torch.models import spade as tspade
from scenedreamer_tpu_torch.utils.convert import blocks_state_dict_from_flax

cap_torch_threads()

N, C, HW = 2, 8, 8
OUT, NARROW = 8, 4     # the output width; a width change for shortcuts


def _x(seed=1, c=C, hw=HW, shape=None):
    shape = shape or (N, hw, hw, c)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# coverage of the JAX modules' names
# ---------------------------------------------------------------------------

# JAX names given no port counterpart, each with its reason (none today:
# `xavier_gain` and the flax initializers are imports there, and each port
# layer's `reset_parameters` draws their distributions)
NOT_PORTED = {}


def _defined(module):
    """Names a module defines itself (dir() minus imports)."""
    return sorted(n for n in dir(module) if not n.startswith('__')
                  and (getattr(getattr(module, n), '__module__', None)
                       == module.__name__ or n == '_ACTS'))


@pytest.mark.parametrize('jmod,tmod,only', [
    (jb, tb, None), (jbx, tbx, None),
    (jspade, tspade, ('DualAdaptiveNorm',))])
def test_every_jax_name_has_a_counterpart(jmod, tmod, only):
    names = _defined(jmod) if only is None else list(only)
    assert names
    missing = [n for n in names if not hasattr(tmod, n)
               and n not in NOT_PORTED]
    assert not missing, f'{jmod.__name__}: no port counterpart of {missing}'


# ---------------------------------------------------------------------------
# bias_act, upfirdn2d, Blur*
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('act', sorted(jb._ACTS))
def test_bias_act(act):
    x, b = _x(), _x(2, shape=(C,))
    fn_parity(lambda x, b: jb.bias_act(x, b, act=act, clamp=1.5),
              lambda x, b: tb.bias_act(x, b, act=act, clamp=1.5), [x, b])
    assert tb._ACTS[act][1] == pytest.approx(float(jb._ACTS[act][1]))


def test_setup_filter():
    for f in (None, [1.0, 2.0, 1.0], np.arange(9.0).reshape(3, 3) + 1):
        np.testing.assert_array_equal(tb.setup_filter(f, gain=2.0),
                                      jb.setup_filter(f, gain=2.0))


@pytest.mark.parametrize('up,down,pad,gain,taps', [
    (2, 1, (2, 1, 2, 1), 1.0, None),
    (1, 2, (1, 1, 1, 1), 2.0, [1.0, 2.0, 1.0]),
    (2, 2, (-1, 2, 0, 1), 1.0, None), (3, 1, (0, -2, 1, 1), 0.5,
                                       np.arange(9.0).reshape(3, 3))])
def test_upfirdn2d(up, down, pad, gain, taps):
    f = jb.setup_filter(taps)
    fn_parity(lambda x: jb.upfirdn2d(x, f, up, down, pad, gain),
              lambda x: tb.upfirdn2d(x, f, up, down, pad, gain), [_x()],
              grad=True)


@pytest.mark.parametrize('name', ['Blur', 'BlurUpsample', 'BlurDownsample'])
@pytest.mark.parametrize('taps', [None, [1.0, 2.0, 1.0]])
def test_blur(name, taps):
    parity(getattr(jb, name)(taps), [_x()], getattr(tb, name)(taps),
           grad=taps is None)


# ---------------------------------------------------------------------------
# norms and weight norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('affine', [True, False])
def test_frozen_batch_norm(affine):
    parity(jb._FrozenBatchNorm2d(C, affine=affine), [_x()],
           tb._FrozenBatchNorm2d(C, affine=affine))


@pytest.mark.parametrize('norm', ['batch', 'sync_batch', 'instance', 'layer',
                                  'layer_2d', 'group'])
def test_make_norm(norm):
    x = _x() * 3.0 + 1.0
    parity(jb.make_norm(norm, C), [x], tb.make_norm(norm, C))
    assert jb.make_norm('none', C) is None and tb.make_norm('none', C) is None


class _Holder:
    """The flax module `weight_norm_conv` reads its parameters from."""

    def __init__(self, values):
        self.values = values

    def param(self, name, *_):
        return self.values[name]


@pytest.mark.parametrize('stride,k', [(1, 3), (2, 1)])
def test_weight_norm_conv(stride, k):
    rng = np.random.default_rng(3)
    x = _x()
    v = rng.standard_normal((k, k, C, OUT)).astype(np.float32)
    g, b = (rng.standard_normal(OUT).astype(np.float32) for _ in range(2))

    def jfn(x, v, g, b):
        return jb.weight_norm_conv(_Holder({'wn_v': v, 'wn_g': g,
                                            'wn_bias': b}),
                                   x, OUT, (k, k), stride, True)

    jout, pull = jax.vjp(jfn, *map(jnp.asarray, (x, v, g, b)))
    cot = rng.standard_normal(jout.shape).astype(np.float32)
    jgrads = pull(jnp.asarray(cot))
    oihw = (lambda a: np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
    tx = [torch.tensor(a, requires_grad=True)
          for a in (nchw(x), oihw(v), g, b)]
    tout = tb.weight_norm_conv(*tx, stride)
    assert_close(tout.detach().numpy(), nchw(jout), 'output')
    (tout * torch.from_numpy(nchw(cot))).sum().backward()
    for t, j, f, what in zip(tx, jgrads, (nchw, oihw, np.asarray,
                                          np.asarray), 'xvgb'):
        assert_close(t.grad.numpy(), f(np.asarray(j)), f'gradient of {what}',
                     GRAD_REL, GRAD_ABS)


# ---------------------------------------------------------------------------
# Conv2dBlock, LinearBlock, Res2dBlock
# ---------------------------------------------------------------------------

def _pair(jcls, tcls, cin, cout, **kw):
    """(flax module, port module) of a block class with the same
    options; the port takes the input width as well."""
    return jcls(cout, **kw), tcls(cin, cout, **kw)


@pytest.mark.parametrize('order', ['CNA', 'NAC', 'ANC', 'CAN'])
def test_conv2d_block_orders(order):
    """A norm before the conv normalises the input width, after it the
    output width (8 -> 4 here)."""
    j, t = _pair(jb.Conv2dBlock, tb.Conv2dBlock, C, NARROW, order=order,
                 activation_norm_type='group')
    parity(j, [_x()], t)


@pytest.mark.parametrize('norm', ['none', 'batch', 'sync_batch', 'instance',
                                  'layer', 'layer_2d', 'group'])
@pytest.mark.parametrize('order', ['CNA', 'NAC'])
def test_conv2d_block_norms(norm, order):
    j, t = _pair(jb.Conv2dBlock, tb.Conv2dBlock, C, NARROW, order=order,
                 activation_norm_type=norm)
    parity(j, [_x()], t)


@pytest.mark.parametrize('wn,update,stride,blur', [
    ('none', False, 1, False), ('spectral', False, 1, False),
    ('spectral', True, 1, False), ('weight', False, 1, False),
    ('none', False, 2, True), ('spectral', True, 2, True),
    ('weight', False, 2, False), ('spectral', False, 2, False)])
def test_conv2d_block_weight_norms(wn, update, stride, blur):
    j, t = _pair(jb.Conv2dBlock, tb.Conv2dBlock, C, OUT, stride=stride,
                 weight_norm_type=wn, blur=blur)
    parity(j, [_x()], t, update_stats=update,
           grad=wn == 'spectral' and stride == 1 and not update)


@pytest.mark.parametrize('nonlinearity,use_bias', [
    ('fused_lrelu', True), ('fused_relu', False), ('fused_swish', True),
    ('lrelu', True), ('relu', False), ('tanh', True), ('none', False),
    ('fused_linear', True)])
def test_conv2d_block_activations(nonlinearity, use_bias):
    j, t = _pair(jb.Conv2dBlock, tb.Conv2dBlock, C, OUT, kernel_size=1,
                 nonlinearity=nonlinearity, use_bias=use_bias)
    parity(j, [_x()], t)


def test_conv2d_block_bf16_within_jax_own_distance():
    """bf16 convs accumulate in another order in XLA and in PyTorch, so
    the port's bf16 block is held to 4x JAX's own bf16-to-float32
    distance from JAX's float32 output, as `test_torch_bf16_limit.py`
    holds the frame."""
    x = _x()
    kw = dict(activation_norm_type='group', order='CNA')
    v = parity(jb.Conv2dBlock(OUT, **kw), [x], tb.Conv2dBlock(C, OUT, **kw))
    j32 = np.asarray(jb.Conv2dBlock(OUT, **kw).apply(v, jnp.asarray(x)))
    j16 = np.asarray(jb.Conv2dBlock(OUT, dtype=jnp.bfloat16, **kw).apply(
        v, jnp.asarray(x)), np.float32)
    t16 = tb.Conv2dBlock(C, OUT, dtype=torch.bfloat16, **kw)
    t16.load_state_dict(blocks_state_dict_from_flax(v))
    port = t16(torch.from_numpy(nchw(x))).float().detach().numpy()
    jax_own = float(np.abs(j16 - j32).max())
    assert jax_own > 0
    assert float(np.abs(port - nchw(j32)).max()) <= 4 * jax_own


@pytest.mark.parametrize('order,nonlinearity,use_bias', [
    ('CA', 'fused_lrelu', True), ('AC', 'relu', True), ('CNA', 'none', False),
    ('CA', 'tanh', True)])
def test_linear_block(order, nonlinearity, use_bias):
    j, t = _pair(jb.LinearBlock, tb.LinearBlock, 5, 7, order=order,
                 nonlinearity=nonlinearity, use_bias=use_bias)
    parity(j, [_x(shape=(N, 5))], t)


@pytest.mark.parametrize('cout,order,norm,wn', [
    (C, 'CNACNA', 'none', 'none'), (NARROW, 'NACNAC', 'instance', 'none'),
    (NARROW, 'CNACNA', 'group', 'spectral'), (C, 'NACNAC', 'batch', 'weight')])
def test_res2d_block(cout, order, norm, wn):
    j, t = _pair(jb.Res2dBlock, tb.Res2dBlock, C, cout, order=order,
                 activation_norm_type=norm, weight_norm_type=wn)
    parity(j, [_x()], t, update_stats=wn == 'spectral')


# ---------------------------------------------------------------------------
# ApplyNoise, EqualizedDense, NonLocal2dBlock, Res2dBlockDown
# ---------------------------------------------------------------------------

def _jax_noise(key, shape):
    """JAX's ApplyNoise draw for an NHWC output of `shape`, channel-first."""
    return torch.from_numpy(nchw(np.array(jax.random.normal(
        key, tuple(shape[:-1]) + (1,)))))


def test_apply_noise():
    x, key = _x(), jax.random.PRNGKey(4)
    parity(jb.ApplyNoise(), [x], tb.ApplyNoise(), jkw=dict(key=key),
           tkw=dict(noise=_jax_noise(key, x.shape)))
    with pytest.raises(ValueError):
        tb.ApplyNoise()(torch.zeros(1, 2, 3, 3))
    drawn = tb.ApplyNoise()(torch.zeros(1, 2, 3, 3),
                            generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (1, 2, 3, 3)


@pytest.mark.parametrize('lr_mul,use_bias', [(1.0, True), (0.5, True),
                                             (0.01, False)])
def test_equalized_dense(lr_mul, use_bias):
    j = jb.EqualizedDense(7, lr_mul=lr_mul, use_bias=use_bias)
    t = tb.EqualizedDense(5, 7, lr_mul=lr_mul, use_bias=use_bias)
    parity(j, [_x(shape=(N, 5))], t)
    w = tb.equalized_lr_init(0.5)(torch.empty(4000),
                                  torch.Generator().manual_seed(0))
    assert abs(float(w.std()) - 2.0) < 0.1


@pytest.mark.parametrize('reduction', [4])
def test_non_local_2d_block(reduction):
    x = _x()
    # phi's bias shifts every logit of a softmax row alike: its gradient
    # is 0 but for rounding
    parity(jb.NonLocal2dBlock(reduction), [x],
           tb.NonLocal2dBlock(C, reduction), grad=True,
           zero_grads=('phi.bias',))


@pytest.mark.parametrize('blur,wn', [(True, 'none'), (False, 'none'),
                                     (True, 'spectral')])
def test_res2d_block_down(blur, wn):
    j, t = _pair(jb.Res2dBlockDown, tb.Res2dBlockDown, C, NARROW, blur=blur,
                 weight_norm_type=wn)
    parity(j, [_x()], t)


# ---------------------------------------------------------------------------
# PartialConv2d, hyper_conv2d, HyperConv2dBlock
# ---------------------------------------------------------------------------

def _mask(shape, seed=5):
    return (np.random.default_rng(seed).random(shape) > 0.4).astype(
        np.float32)


@pytest.mark.parametrize('given,multi_channel,stride,use_bias', [
    (True, False, 1, True), (False, True, 1, True), (True, True, 2, True),
    (False, False, 2, False), (True, False, 1, False),
    (False, False, 1, True)])
def test_partial_conv2d(given, multi_channel, stride, use_bias):
    x = _x()
    mask = _mask((N, HW, HW, C if multi_channel else 1)) if given else None
    j, t = _pair(jb.PartialConv2d, tb.PartialConv2d, C, OUT, stride=stride,
                 use_bias=use_bias, multi_channel=multi_channel)
    parity(j, [x, mask], t, grad=stride == 1 and given != multi_channel)


def test_partial_conv2d_no_mask_out():
    j, t = _pair(jb.PartialConv2d, tb.PartialConv2d, C, OUT,
                 return_mask=False)
    parity(j, [_x(), _mask((N, HW, HW, 1))], t)


def _hyper_weights(cin, cout, k, seed=6, bias=True):
    """Per-sample kernels: JAX's [N, kh, kw, I, O] and the port's OIHW
    [N, O, I, kh, kw], and biases [N, O] (or None)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((N, k, k, cin, cout)).astype(np.float32) * 0.3
    b = rng.standard_normal((N, cout)).astype(np.float32) if bias else None
    return (w, b), (torch.from_numpy(np.ascontiguousarray(
        w.transpose(0, 4, 3, 1, 2))), None if b is None
        else torch.from_numpy(b))


@pytest.mark.parametrize('stride,padding,dilation,bias', [
    (1, 1, 1, True), (2, 1, 1, False), (1, 2, 2, True), (1, 0, 1, True)])
def test_hyper_conv2d(stride, padding, dilation, bias):
    (w, b), (tw, tbias) = _hyper_weights(C, OUT, 3, bias=bias)
    x = _x()
    got = tb.hyper_conv2d(torch.from_numpy(nchw(x)), tw, tbias, stride,
                          padding, dilation)
    want = jb.hyper_conv2d(jnp.asarray(x), jnp.asarray(w),
                           None if b is None else jnp.asarray(b), stride,
                           padding, dilation)
    assert_close(got.numpy(), nchw(want), 'output')
    assert tb.hyper_conv2d(got, None) is got


@pytest.mark.parametrize('given', [True, False])
@pytest.mark.parametrize('order,norm', [('CNA', 'instance'),
                                        ('NAC', 'group'),
                                        ('CAN', 'none')])
def test_hyper_conv2d_block(given, order, norm):
    jw, tw = _hyper_weights(C, C, 3)
    j, t = _pair(jb.HyperConv2dBlock, tb.HyperConv2dBlock, C, C,
                 order=order, activation_norm_type=norm)
    parity(j, [_x()], t, jkw=dict(conv_weights=jw if given
                                  else (None, None)),
           tkw=dict(conv_weights=tw if given else (None, None)))


# ---------------------------------------------------------------------------
# ViT2dBlock, ConstantInput
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('stride,blur,noise,wn,kw', [
    (2, True, True, 'spectral', dict(activation_norm_type='group',
                                     clamp=0.5)),
    (0.5, True, True, 'spectral', dict(order='NAC', output_scale=0.7,
                                       activation_norm_type='layer')),
    (1, False, True, 'none', dict(nonlinearity='fused_lrelu', clamp=1.0,
                                  output_scale=1.3))])
def test_vit2d_block(stride, blur, noise, wn, kw):
    x, key = _x(), jax.random.PRNGKey(7)
    j, t = _pair(jb.ViT2dBlock, tb.ViT2dBlock, C, OUT, stride=stride,
                 blur=blur, apply_noise=noise, weight_norm_type=wn, **kw)
    jkw = dict(noise_key=key) if noise else {}
    tkw = {}
    if noise:
        out = j.apply(j.init(key, jnp.asarray(x), noise_key=key),
                      jnp.asarray(x), noise_key=key)
        tkw = dict(noise=_jax_noise(key, out.shape[:3] + (OUT,)))
        if stride == 0.5 and blur:      # noise before the blur
            tkw = dict(noise=_jax_noise(key, (N, 2 * HW + 1, 2 * HW + 1, OUT)))
    parity(j, [x], t, jkw=jkw, tkw=tkw,
           transposed=('conv',) if stride == 0.5 else ())


def test_constant_input():
    parity(jb.ConstantInput(C, size=4), [3], tb.ConstantInput(C, size=4),
           tin=(3,))


# ---------------------------------------------------------------------------
# DualAdaptiveNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('spatial,bias_only,norm,cond_hw', [
    ((False,), False, 'instance', HW), ((True,), False, 'group', HW),
    ((True, False), False, 'instance', 4), ((True, False), True, 'layer', 4),
    ((False, True), False, 'batch', HW), ((True,), True, 'none', 4)])
def test_dual_adaptive_norm(spatial, bias_only, norm, cond_hw):
    rng = np.random.default_rng(8)
    conds = [rng.standard_normal((N, cond_hw, cond_hw, 3) if s else (N, 5))
             .astype(np.float32) for s in spatial]
    j = jspade.DualAdaptiveNorm(C, spatial, bias_only, norm)
    t = tspade.DualAdaptiveNorm(C, [3 if s else 5 for s in spatial], spatial,
                                bias_only, norm)
    parity(j, [_x(), *conds], t, grad=len(spatial) == 2 and not bias_only)


def test_dual_adaptive_norm_skips_none():
    cond = _x(9, c=3)
    j = jspade.DualAdaptiveNorm(C, (False, True), norm_type='group')
    t = tspade.DualAdaptiveNorm(C, [5, 3], (False, True), norm_type='group')
    v = parity(j, [_x(), np.zeros((N, 5), np.float32), cond], t)
    got = t(*to_torch([_x(), None, cond]))
    want = j.apply(v, jnp.asarray(_x()), None, jnp.asarray(cond))
    assert_close(got.detach().numpy(), nchw(want), 'None entry')
