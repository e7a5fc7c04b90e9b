"""The port's layer-library extension
(`scenedreamer_tpu_torch/models/blocks_ext.py`) against the JAX package's
`models/blocks_ext.py`, on the same numpy inputs with every parameter
drawn from a seeded generator (`_torch_blocks_parity.parity`: forward
within 1e-5 of the largest JAX value + 1e-6, gradients within 1e-4 +
1e-7): the nonlinearities (the reference's NCHW softmax dims), the norm
zoo's unbiased statistics, the 1-D / 3-D blocks, the up / deep /
modulated (stride 1, 2 and the transposed 0.5 at k 3 and 5; one noise
shared by a residual pair) / multi-out / partial (mask given and absent,
`multi_channel`) / hyper blocks, the hyper SPADE norm's resizes, and the
embeddings."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_blocks_parity import (  # noqa: F401 (a fixture)
    fn_parity, nchw, parity, quick_jax_compiles)
from _torch_parity import cap_torch_threads
from scenedreamer_tpu.models import blocks_ext as jbx
from scenedreamer_tpu_torch.models import blocks_ext as tbx

cap_torch_threads()

N, C, HW, OUT = 2, 8, 8, 8
NARROW = 4          # a width change, for the shortcuts


def _x(seed=1, shape=(N, HW, HW, C)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


X1, X3 = (N, HW, C), (N, 4, 6, 6, C)     # NWC and NDHWC inputs


def _pair(name, cin, cout, **kw):
    """(flax module, port module) of a class with the same options; the
    port takes the input width as well."""
    return getattr(jbx, name)(cout, **kw), getattr(tbx, name)(cin, cout, **kw)


def _mask(shape, seed=5):
    return (np.random.default_rng(seed).random(shape) > 0.4).astype(
        np.float32)


# ---------------------------------------------------------------------------
# nonlinearities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('slope,scale', [(0.2, np.sqrt(2.0)), (0.1, 1.5)])
def test_scaled_leaky_relu(slope, scale):
    fn_parity(lambda x: jbx.scaled_leaky_relu(x, slope, scale),
              lambda x: tbx.ScaledLeakyReLU(slope, scale)(x), [_x()],
              grad=True)


@pytest.mark.parametrize('name', ['relu', 'leakyrelu', 'scaled_leakyrelu',
                                  'tanh', 'sigmoid', 'fused_lrelu',
                                  'softmax', 'softmax,1', 'softmax,2',
                                  'softmax,3', 'softmax,0'])
def test_get_nonlinearity(name):
    fn_parity(jbx.get_nonlinearity(name), tbx.get_nonlinearity(name),
              [_x()])


def test_get_nonlinearity_none_and_unknown():
    assert tbx.get_nonlinearity('none') is None
    assert tbx.get_nonlinearity(None) is None
    with pytest.raises(ValueError):
        tbx.get_nonlinearity('nope')


# ---------------------------------------------------------------------------
# norm zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('channel_only,affine', [(False, True), (True, True),
                                                 (False, False)])
def test_layer_norm_2d(channel_only, affine):
    parity(jbx.LayerNorm2d(C, channel_only=channel_only, affine=affine),
           [_x() * 2.0 + 0.5],
           tbx.LayerNorm2d(C, channel_only=channel_only, affine=affine),
           grad=affine and not channel_only)


@pytest.mark.parametrize('learned', [True, False])
def test_scale_norm(learned):
    parity(jbx.ScaleNorm(learned_scale=learned), [_x()],
           tbx.ScaleNorm(learned_scale=learned))


def test_pixel_norm():
    parity(jbx.PixelNorm(), [_x()], tbx.PixelNorm())


@pytest.mark.parametrize('affine', [True, False])
def test_pixel_layer_norm(affine):
    parity(jbx.PixelLayerNorm(affine), [_x() + 1.0],
           tbx.PixelLayerNorm(C, affine))


@pytest.mark.parametrize('shape', [(N, HW, HW, C), X3])
def test_split_mean_std(shape):
    parity(jbx.SplitMeanStd(), [_x(shape=shape) + 0.3], tbx.SplitMeanStd(),
           grad=len(shape) == 4)


# ---------------------------------------------------------------------------
# 1-D / 3-D blocks, ResLinearBlock
# ---------------------------------------------------------------------------

_ND_KW = [
    dict(), dict(order='NAC', activation_norm_type='instance'),
    dict(activation_norm_type='batch', weight_norm_type='weight', stride=2),
    dict(stride=2, activation_norm_type='group', nonlinearity='relu'),
    dict(activation_norm_type='layer_2d', nonlinearity='fused_lrelu'),
    dict(order='CAN', activation_norm_type='layer',
         nonlinearity='scaled_leakyrelu', use_bias=False)]


@pytest.mark.parametrize('name,shape,kw', [
    *[('Conv1dBlock', X1, kw) for kw in _ND_KW],
    *[('Conv3dBlock', X3, _ND_KW[i]) for i in (1, 2)]])
def test_conv_nd_block(name, shape, kw):
    j, t = _pair(name, C, OUT, **kw)
    parity(j, [_x(shape=shape)], t)


@pytest.mark.parametrize('name,shape,update', [
    ('Conv1dBlock', X1, False), ('Conv1dBlock', X1, True),
    ('Conv3dBlock', X3, True)])
def test_conv_nd_block_spectral(name, shape, update):
    j, t = _pair(name, C, OUT, weight_norm_type='spectral')
    parity(j, [_x(shape=shape)], t, update_stats=update)


@pytest.mark.parametrize('name,shape,cout,kw', [
    ('Res1dBlock', X1, OUT, dict(order='NACNAC', output_scale=0.5,
                                 activation_norm_type='instance')),
    ('Res1dBlock', X1, NARROW, dict(weight_norm_type='spectral')),
    ('Res3dBlock', X3, NARROW, dict(order='NACNAC', output_scale=0.5,
                                    activation_norm_type='instance'))])
def test_res_nd_block(name, shape, cout, kw):
    j, t = _pair(name, C, cout, **kw)
    parity(j, [_x(shape=shape)], t)


@pytest.mark.parametrize('cout,nonlinearity', [(7, 'leakyrelu'), (5, 'none'),
                                               (5, 'tanh')])
def test_res_linear_block(cout, nonlinearity):
    j, t = _pair('ResLinearBlock', 5, cout, nonlinearity=nonlinearity,
                 output_scale=0.7)
    parity(j, [_x(shape=(N, 5))], t)


@pytest.mark.parametrize('nonlinearity', ['softmax', 'softmax,2'])
def test_res_linear_block_rank3(nonlinearity):
    """A [N, L, features] input: the softmax axes are JAX's channel-last
    ones (the features, then L)."""
    j, t = _pair('ResLinearBlock', 5, 7, nonlinearity=nonlinearity)
    x = _x(shape=(N, 3, 5))
    parity(j, [x], t, tin=(torch.from_numpy(x),), out_layout=False)


# ---------------------------------------------------------------------------
# UpRes2dBlock, DeepRes2dBlock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('cout,order,blur,norm', [
    (OUT, 'CNACNA', False, 'none'), (OUT, 'NACNAC', True, 'instance'),
    (NARROW, 'NACNAC', False, 'group'), (OUT, 'CNACNA', True, 'batch')])
def test_up_res2d_block(cout, order, blur, norm):
    j, t = _pair('UpRes2dBlock', C, cout, order=order, blur=blur,
                 activation_norm_type=norm, output_scale=0.8)
    parity(j, [_x()], t)


@pytest.mark.parametrize('cin,cout,kw', [
    (8, 8, dict()),                                       # identity shortcut
    (8, 12, dict()),                                      # concat branch
    (8, 4, dict(stride=2)),                               # slice branch
    (8, 12, dict(learn_shortcut=True, stride=2, blur=False,
                 weight_norm_type='spectral', hidden_channel_ratio=2)),
    (8, 12, dict(order='pre_act', activation_norm_type='group',
                 skip_nonlinearity=True, stride=2))])
def test_deep_res2d_block(cin, cout, kw):
    j, t = _pair('DeepRes2dBlock', cin, cout, **kw)
    parity(j, [_x(shape=(N, HW, HW, cin))], t)


# ---------------------------------------------------------------------------
# ModulatedConv2d (+Block, +Res2dBlock)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('stride,k,demod', [
    (1, 3, True), (1, 3, False), (2, 3, True), (0.5, 3, True),
    (0.5, 5, True), (0.5, 5, False)])
def test_modulated_conv2d(stride, k, demod):
    style = _x(2, (N, C)) + 1.0
    j, t = _pair('ModulatedConv2d', C, OUT, kernel_size=k, stride=stride,
                 demodulate=demod)
    parity(j, [_x(), style], t, grad=demod and k == 3 and stride != 2)


def _jax_noise(key, shape):
    return torch.from_numpy(nchw(np.array(jax.random.normal(
        key, tuple(shape[:-1]) + (1,)))))


@pytest.mark.parametrize('stride,noise,kw', [
    (1, False, dict()), (1, True, dict(activation_norm_type='instance')),
    (2, True, dict(order='NAC', activation_norm_type='group')),
    (0.5, False, dict(demodulate=False, nonlinearity='fused_lrelu'))])
def test_modulated_conv2d_block(stride, noise, kw):
    z, key = _x(3, (N, 6)), jax.random.PRNGKey(4)
    j, t = getattr(jbx, 'ModulatedConv2dBlock')(
        OUT, stride=stride, apply_noise=noise, **kw), \
        tbx.ModulatedConv2dBlock(C, OUT, 6, stride=stride,
                                 apply_noise=noise, **kw)
    hw = {1: HW, 2: HW // 2, 0.5: 2 * HW - 1}[stride]
    parity(j, [_x(), z], t, jkw=dict(noise_key=key) if noise else {},
           tkw=dict(noise=_jax_noise(key, (N, hw, hw, OUT))) if noise
           else {})


@pytest.mark.parametrize('cout,noise', [(OUT, True), (NARROW, True),
                                        (OUT, False)])
def test_modulated_res2d_block(cout, noise):
    """One noise key reaches both blocks in JAX: the port shares one
    noise map between them."""
    z, key = _x(3, (N, 6)), jax.random.PRNGKey(4)
    j = jbx.ModulatedRes2dBlock(cout, apply_noise=noise, output_scale=0.9)
    t = tbx.ModulatedRes2dBlock(C, cout, 6, apply_noise=noise,
                                output_scale=0.9)
    parity(j, [_x(), z], t, jkw=dict(noise_key=key),
           tkw=dict(noise=_jax_noise(key, (N, HW, HW, 1))))
    if noise:   # a generator draws one map for both, as one key does
        g = torch.Generator().manual_seed(0)
        x, tz = torch.from_numpy(nchw(_x())), torch.from_numpy(z)
        y = t(x, tz, generator=g)
        ref = t(x, tz, noise=tbx.draw_noise(x, torch.Generator()
                                            .manual_seed(0)))
        assert torch.equal(y, ref)


# ---------------------------------------------------------------------------
# MultiOut blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('norm,order,cout', [
    ('split_mean_std', 'CNA', OUT), ('instance', 'NAC', OUT),
    ('none', 'CNA', NARROW)])
def test_multi_out_blocks(norm, order, cout):
    j, t = _pair('MultiOutConv2dBlock', C, cout, order=order,
                 activation_norm_type=norm)
    parity(j, [_x()], t)
    j, t = _pair('MultiOutRes2dBlock', C, cout, activation_norm_type=norm,
                 output_scale=0.5)
    parity(j, [_x()], t)


# ---------------------------------------------------------------------------
# partial convolutions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('given,multi_channel,stride,use_bias', [
    (True, False, 1, True), (False, True, 1, True), (True, True, 2, False)])
def test_partial_conv3d(given, multi_channel, stride, use_bias):
    mask = _mask(X3[:-1] + (C if multi_channel else 1,)) if given else None
    j, t = _pair('PartialConv3d', C, OUT, stride=stride, use_bias=use_bias,
                 multi_channel=multi_channel)
    parity(j, [_x(shape=X3), mask], t,
           grad=stride == 1 and given != multi_channel)


@pytest.mark.parametrize('name,shape', [('PartialConv2dBlock', None),
                                        ('PartialConv3dBlock', X3)])
@pytest.mark.parametrize('given,multi_channel,kw', [
    (True, False, dict()), (False, True, dict(activation_norm_type='group')),
    (True, True, dict(order='NAC', activation_norm_type='instance'))])
def test_partial_blocks(name, shape, given, multi_channel, kw):
    shape = shape or (N, HW, HW, C)
    mask = _mask(shape[:-1] + (C if multi_channel else 1,)) if given \
        else None
    j, t = _pair(name, C, OUT, multi_channel=multi_channel, **kw)
    parity(j, [_x(shape=shape), mask], t)


@pytest.mark.parametrize('name,shape', [('PartialRes2dBlock', None),
                                        ('PartialRes3dBlock', X3)])
@pytest.mark.parametrize('cout,given', [(OUT, True), (NARROW, False)])
def test_partial_res_blocks(name, shape, cout, given):
    shape = shape or (N, HW, HW, C)
    mask = _mask(shape[:-1] + (1,)) if given else None
    j, t = _pair(name, C, cout)
    parity(j, [_x(shape=shape), mask], t)


def test_partial_sequential():
    x, mask = _x(), _mask((N, HW, HW, 1))
    jmods = [jbx.PartialConv2dBlock(OUT), jbx.PartialRes2dBlock(OUT)]
    tmods = [tbx.PartialConv2dBlock(C, OUT), tbx.PartialRes2dBlock(OUT, OUT)]
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    variables = []
    for jm_, tm in zip(jmods, tmods):
        v = parity(jm_, [np.asarray(jx), np.asarray(jm)], tm)
        variables.append(v)
        jx, jm = jm_.apply(v, jx, jm)
    bound = [m.bind(v) for m, v in zip(jmods, variables)]
    want = jbx.partial_sequential(bound, jnp.asarray(x), jnp.asarray(mask))
    got = tbx.partial_sequential(tmods, torch.from_numpy(nchw(x)),
                                 torch.from_numpy(nchw(mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), nchw(w), rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-6)


# ---------------------------------------------------------------------------
# HyperRes2dBlock, HyperSpatiallyAdaptiveNorm
# ---------------------------------------------------------------------------

def _hyper(cin, cout, k=3, seed=6):
    """Per-sample kernels: JAX's [N, kh, kw, I, O] and the port's OIHW
    [N, O, I, kh, kw], with biases [N, O]."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((N, k, k, cin, cout)).astype(np.float32) * 0.3
    b = rng.standard_normal((N, cout)).astype(np.float32)
    return (w, b), (torch.from_numpy(np.ascontiguousarray(
        w.transpose(0, 4, 3, 1, 2))), torch.from_numpy(b))


@pytest.mark.parametrize('cout,hyper,norm', [
    (OUT, (True, True, False), 'instance'),
    (OUT, (True, True, True), 'none'),
    (NARROW, (False, True, False), 'group'),
    (OUT, (False, False, False), 'instance')])
def test_hyper_res2d_block(cout, hyper, norm):
    ws = [_hyper(C if i != 1 else cout, cout, seed=6 + i) if h else
          (None, None) for i, h in enumerate(hyper)]
    jw = tuple(w[0] if h else None for w, h in zip(ws, hyper))
    tw = tuple(w[1] if h else None for w, h in zip(ws, hyper))
    j = jbx.HyperRes2dBlock(cout, activation_norm_type=norm,
                            output_scale=0.6)
    t = tbx.HyperRes2dBlock(C, cout, activation_norm_type=norm,
                            output_scale=0.6, hyper=hyper)
    parity(j, [_x()], t, jkw=dict(conv_weights=jw),
           tkw=dict(conv_weights=tw))
    with pytest.raises(ValueError):     # weights against the built kind
        t(torch.from_numpy(nchw(_x())), conv_weights=(None,) * 3
          if any(hyper) else (_hyper(C, cout)[1], None, None))


@pytest.mark.parametrize('is_hyper,num_filters,masked,skip', [
    (True, 0, False, False), (True, 5, True, False),
    (False, 5, True, False), (False, 0, False, True)])
def test_hyper_spatially_adaptive_norm(is_hyper, num_filters, masked, skip):
    """Conditions resized to x's 8x8: a 4x4 and a 16x16 label (nearest)
    and a 4x4 mask (bilinear); with `skip` the module built on both
    conditions is called with the second None."""
    rng = np.random.default_rng(9)
    cond = [rng.standard_normal((N, 4, 4, 3)).astype(np.float32),
            rng.standard_normal((N, 16, 16, 2)).astype(np.float32)]
    mask = _mask((N, 4, 4, 1))
    first = (cond[0], mask) if masked else cond[0]
    (w, b), (tw, tbias) = _hyper(3, 2 * C)
    j = jbx.HyperSpatiallyAdaptiveNorm(C, (3, 2), num_filters,
                                       is_hyper=is_hyper)
    t = tbx.HyperSpatiallyAdaptiveNorm(C, (3, 2), num_filters,
                                       is_hyper=is_hyper)
    kw = dict(jkw=dict(norm_weights=(w, b)),
              tkw=dict(norm_weights=(tw, tbias)), grad=masked)
    v = parity(j, [_x(), [first, cond[1]]], t, **kw)
    if skip:
        parity(j, [_x(), [first, None]], t, variables=v, **kw)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(N, HW, HW), (N, HW, HW, 1)])
def test_embedding2d(shape):
    ids = np.random.default_rng(2).integers(0, 5, shape).astype(np.int32)
    tin = torch.from_numpy(ids if ids.ndim == 3 else nchw(ids))
    parity(jbx.Embedding2d(5, 6), [ids], tbx.Embedding2d(5, 6), tin=(tin,))


@pytest.mark.parametrize('nonlinearity,shape', [
    ('none', (N, 7)), ('tanh', (N, 7)), ('softmax', (N * 7,)),
    ('softmax', (N, 7)), ('softmax,1', (N, 7)), ('softmax,2', (N, 7))])
def test_embedding_block(nonlinearity, shape):
    """ids of any shape -> [..., features]; the softmax takes JAX's
    channel-last axis: the features for 'softmax' and 'softmax,1', the
    ids' last axis for 'softmax,2'."""
    ids = np.random.default_rng(2).integers(0, 5, shape).astype(np.int32)
    parity(jbx.EmbeddingBlock(5, 6, nonlinearity), [ids],
           tbx.EmbeddingBlock(5, 6, nonlinearity),
           tin=(torch.from_numpy(ids),), out_layout=False)


@pytest.mark.parametrize('nonlinearity', ['none', 'sigmoid'])
def test_embedding2d_block(nonlinearity):
    ids = np.random.default_rng(2).integers(0, 5, (N, HW, HW, 1)).astype(
        np.int32)
    parity(jbx.Embedding2dBlock(5, 6, nonlinearity), [ids],
           tbx.Embedding2dBlock(5, 6, nonlinearity),
           tin=(torch.from_numpy(nchw(ids)),))
