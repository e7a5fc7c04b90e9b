"""Parity harness of the layer-library tests (`test_torch_blocks.py`,
`test_torch_blocks_ext.py`): a flax module of the JAX package and its
port module run on the same numpy inputs with the same variables.

Every leaf of the flax variables (zero-initialised ones included) is
drawn anew from a seeded numpy generator, the JAX module is applied op by
op, its variables go through the port's converter
(`blocks_state_dict_from_flax`, loaded with `strict=True`) and the
outputs are compared after the channel-last -> channel-first transpose:
forward `max|port - JAX| <= 1e-5 max|JAX| + 1e-6`; with `grad`, the
gradients of sum(out * cot) for a seeded cotangent, against the first
input and every parameter, `<= 1e-4 max|grad| + 1e-7`."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu_torch.utils.convert import blocks_state_dict_from_flax

FWD_REL, FWD_ABS = 1e-5, 1e-6
GRAD_REL, GRAD_ABS = 1e-4, 1e-7


@pytest.fixture(scope='module', autouse=True)
def quick_jax_compiles():
    """The JAX side runs op by op, so its time is XLA compiling ~1000
    one-op programs; `jax_disable_most_optimizations` cuts that by a
    quarter (a single op has nothing to fuse). The flag is restored
    after the module and the compile caches cleared, so no later test
    of the worker reuses a program compiled under it."""
    before = jax.config.values['jax_disable_most_optimizations']
    jax.config.update('jax_disable_most_optimizations', True)
    yield
    jax.config.update('jax_disable_most_optimizations', before)
    jax.clear_caches()


def nchw(a):
    """Channel-last (N, *S, C) -> channel-first (N, C, *S); 2-D as is."""
    a = np.asarray(a)
    return np.ascontiguousarray(np.moveaxis(a, -1, 1)) if a.ndim >= 3 else a


def _np_tree(tree, fn):
    return jax.tree_util.tree_map(
        lambda a: fn(a) if isinstance(a, np.ndarray) else a, tree)


def to_torch(tree):
    """numpy leaves -> channel-first torch tensors."""
    return _np_tree(tree, lambda a: torch.from_numpy(np.array(nchw(a))))


def redraw(variables, rng):
    """Every leaf (an array or its shape) drawn anew: N(0, 0.5^2),
    batch-norm variances U(0.5, 1.5)."""
    def draw(path, a):
        if path[-1].key == 'var':
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.standard_normal(a.shape) * 0.5).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(variables))


def assert_close(got, want, what, rel=FWD_REL, abs_=FWD_ABS):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f'{what}: shape {got.shape} != {want.shape}'
    err = float(np.abs(got - want).max()) if got.size else 0.0
    lim = rel * float(np.abs(want).max() if want.size else 0.0) + abs_
    assert err <= lim, f'{what}: max |port - JAX| {err:.3g} > {lim:.3g}'
    return err


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def parity(jmod, jin, tmod, tin=None, *, jkw=None, tkw=None, transposed=(),
           grad=False, update_stats=False, out_layout=True, variables=None,
           zero_grads=()):
    """Hold `tmod(*tin, **tkw)` against `jmod.apply(v, *jin, **jkw)`.
    `jin` are numpy (channel-last) inputs, nested tuples and None
    allowed; `tin` defaults to them transposed to channel-first. With
    `update_stats` both run their spectral-norm update and the new `u`
    and sigma are compared too. `zero_grads` names parameters whose
    gradient is 0 analytically: both sides' rounding noise there is held
    within 1e-5 of the largest parameter gradient instead. Returns the
    JAX variables."""
    jkw, tkw = dict(jkw or {}), dict(tkw or {})
    rng = np.random.default_rng(0)
    jx = _np_tree(jin, jnp.asarray)
    if variables is None:
        # shapes alone: flax's init would compile each initializer
        arrays = [i for i, a in enumerate(jx) if isinstance(a, jax.Array)]

        def init(*a):
            args = list(jx)
            for i, v in zip(arrays, a):
                args[i] = v
            return jmod.init(jax.random.PRNGKey(0), *args, **jkw)

        variables = redraw(jax.eval_shape(init, *[jx[i] for i in arrays]),
                           rng)
    tmod.load_state_dict(blocks_state_dict_from_flax(variables, transposed))
    tmod.zero_grad(set_to_none=True)
    tin = to_torch(jin) if tin is None else tin
    if update_stats:
        jout, new = jmod.apply(variables, *jx, **jkw, update_stats=True,
                               mutable=['spectral_stats'])
        tkw['update_stats'] = True
    else:
        jout = jmod.apply(variables, *jx, **jkw)
    jouts = _flat(jout)
    if grad:
        x = tin[0].clone().requires_grad_(True)
        tin = (x,) + tuple(tin[1:])
    touts = _flat(tmod(*tin, **tkw))
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        if j is None:
            assert t is None, f'output {i}: JAX gives None'
            continue
        want = nchw(j) if out_layout else np.asarray(j)
        assert_close(t.detach().float().numpy(), want, f'output {i}')
    if update_stats:
        want = blocks_state_dict_from_flax(
            {'spectral_stats': new['spectral_stats']})
        sd = tmod.state_dict()
        for k, v in want.items():
            assert_close(sd[k].numpy(), v.numpy(), k)
    if grad:
        _grad_parity(jmod, variables, jx, jkw, jouts, tmod, x, touts, rng,
                     transposed, out_layout, zero_grads)
    return variables


def _grad_parity(jmod, variables, jx, jkw, jouts, tmod, x, touts, rng,
                 transposed, out_layout, zero_grads):
    cots = [None if j is None or not jnp.issubdtype(j.dtype, jnp.floating)
            else rng.standard_normal(j.shape).astype(np.float32)
            for j in jouts]
    rest = {k: v for k, v in variables.items() if k != 'params'}

    def loss(params, x0):
        out = _flat(jmod.apply({'params': params, **rest}, x0, *jx[1:],
                               **jkw))
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)
                   if c is not None)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables.get('params', {}),
                                            jx[0])
    tloss = sum((t.float() * torch.from_numpy(
        nchw(c) if out_layout else c)).sum()
        for t, c in zip(touts, cots) if c is not None)
    tloss.backward()
    assert_close(x.grad.numpy(), nchw(gx), 'input gradient', GRAD_REL,
                 GRAD_ABS)
    want = blocks_state_dict_from_flax({'params': gp}, transposed)
    params = dict(tmod.named_parameters())
    assert set(want) == set(params), set(want) ^ set(params)
    scale = max((float(w.abs().max()) for w in want.values()), default=0.0)
    for k, w in want.items():
        g = params[k].grad
        got = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        if k in zero_grads:
            noise = max(float(np.abs(got).max()), float(w.abs().max()))
            assert noise <= 1e-5 * scale, f'gradient of {k}: {noise:.3g}'
        else:
            assert_close(got, w.numpy(), f'gradient of {k}', GRAD_REL,
                         GRAD_ABS)


def fn_parity(jfn, tfn, inputs, *, grad=False):
    """A function pair on the same numpy inputs (channel-first for the
    port; every float input differentiated with `grad`)."""
    jx = [jnp.asarray(a) for a in inputs]
    tx = [torch.tensor(nchw(a), requires_grad=grad) for a in inputs]
    jout, tout = jfn(*jx), tfn(*tx)
    assert_close(tout.detach().numpy(), nchw(jout), 'output')
    if not grad:
        return
    cot = np.random.default_rng(0).standard_normal(jout.shape).astype(
        np.float32)
    _, pull = jax.vjp(jfn, *jx)
    (tout * torch.from_numpy(nchw(cot))).sum().backward()
    for i, (t, g) in enumerate(zip(tx, pull(jnp.asarray(cot)))):
        assert_close(t.grad.numpy(), nchw(g), f'gradient of input {i}',
                     GRAD_REL, GRAD_ABS)
