"""The port's `ops/encoders.py` (`trunc_exp`, `freq_encode`,
`get_encoder`) against the JAX package's `ops/encoders.py` on the same
numpy inputs. The grid encoders run the general hash encode (its plain
CPU twin here); the JAX side is jitted, as in
`test_torch_hashgrid_general.py`, and its table-gradient payloads are
patched to float32. Tolerances: features 1e-5; gradients as that file
states them (rows within 1e-4 of their absolute contributions + 1e-6 +
1e-7 of the total, here taken over the whole table)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.ops import encoders as jenc
from scenedreamer_tpu.ops import hashgrid as jhg
from scenedreamer_tpu_torch.ops import encoders as tenc
from _torch_parity import cap_torch_threads

cap_torch_threads()

GRID = dict(input_dim=3, num_levels=4, level_dim=2, log2_hashmap_size=8,
            desired_resolution=64)


@pytest.fixture(autouse=True)
def f32_payloads(monkeypatch):
    monkeypatch.setattr(jhg, 'SORT_PAYLOAD_DTYPE', jnp.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _abs_table_grad(fn, table, x, g):
    """The table gradient of `fn` with |g|: per row, the sum of absolute
    contributions (the corner weights are non-negative)."""
    t = _t(table, True)
    (d,) = torch.autograd.grad(fn(t, _t(x)), t, _t(np.abs(g)))
    return d.numpy()


def _table_close(got, want, abs_grad):
    tol = 1e-4 * abs_grad + 1e-6 + 1e-7 * abs_grad.sum()
    assert (np.abs(got - want) <= tol).all()


def test_trunc_exp_forward_and_clamped_grad():
    x = np.array([-30.0, -15.5, -2.0, 0.0, 1.5, 15.0, 30.0], np.float32)
    g = np.linspace(0.5, 2.0, len(x)).astype(np.float32)
    xt = _t(x, grad=True)
    out = tenc.trunc_exp(xt)
    (dx,) = torch.autograd.grad(out, xt, _t(g))
    want = np.asarray(jenc.trunc_exp(jnp.asarray(x)))
    _, vjp = jax.vjp(jenc.trunc_exp, jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-6)
    assert np.isfinite(dx.numpy()).all()
    np.testing.assert_allclose(dx.numpy()[[0, -1]],
                               g[[0, -1]] * np.exp([-15.0, 15.0]), rtol=1e-6)


@pytest.mark.parametrize('degree', [0, 2, 4])
def test_freq_encode(degree):
    x = np.random.default_rng(degree).uniform(-1, 1, (7, 3)) \
        .astype(np.float32)
    fn, dim, spec = tenc.get_encoder('frequency', input_dim=3, degree=degree)
    jfn, jdim, _ = jenc.get_encoder('frequency', input_dim=3, degree=degree)
    assert spec is None and dim == jdim == 3 + 6 * degree
    got = fn(_t(x)).numpy()
    assert got.shape == (7, dim)
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tenc.freq_encode(_t(x), degree).numpy(), got)


def test_none_encoder_and_unknown():
    fn, dim, spec = tenc.get_encoder('None', input_dim=5)
    x = torch.ones(2, 5)
    assert fn(x) is x and dim == 5 and spec is None
    assert tenc.get_encoder(None, input_dim=4)[1] == 4
    with pytest.raises(NotImplementedError):
        tenc.get_encoder('sphere_harmonics')


@pytest.mark.parametrize('encoding,align', [('hashgrid', False),
                                            ('tiledgrid', False),
                                            ('tiledgrid', True)])
def test_grid_encoders_match_jax(encoding, align):
    fn, dim, spec = tenc.get_encoder(encoding, align_corners=align, **GRID)
    jfn, jdim, jspec = jenc.get_encoder(encoding, align_corners=align,
                                        **GRID)
    assert (dim, spec.table_size, spec.gridtype, spec.align_corners) == (
        jdim, jspec.table_size, jspec.gridtype, jspec.align_corners)
    rng = np.random.default_rng(len(encoding) + align)
    table = rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)
    x = rng.uniform(-1.02, 1.02, (200, 3)).astype(np.float32)
    g = rng.standard_normal((200, dim)).astype(np.float32)
    out, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(table), jnp.asarray(x))
    jt, jx = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    t, p = _t(table, True), _t(x, True)
    got = fn(t, p)
    dt, dx = torch.autograd.grad(got, (t, p), _t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=0)
    _table_close(dt.numpy(), jt, _abs_table_grad(fn, table, x, g))
    assert np.abs(dx.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()


def test_varhashgrid_splits_the_gradient():
    """'varhashgrid' places the external rows ahead of its own table; the
    gradient splits between the two along that seam, as JAX's does."""
    fn, dim, spec = tenc.get_encoder('varhashgrid', **GRID)
    jfn, _, _ = jenc.get_encoder('varhashgrid', **GRID)
    full_fn, _, _ = tenc.get_encoder('hashgrid', **GRID)
    rng = np.random.default_rng(3)
    full = rng.uniform(-1, 1, (spec.table_size, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (150, 3)).astype(np.float32)
    g = rng.standard_normal((150, dim)).astype(np.float32)
    n_ext = 40
    own, ext = _t(full[n_ext:], True), _t(full[:n_ext], True)
    got = fn(own, ext, _t(x))
    d_own, d_ext = torch.autograd.grad(got, (own, ext), _t(g))
    f = _t(full, True)
    whole = full_fn(f, _t(x))
    (d_full,) = torch.autograd.grad(whole, f, _t(g))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  whole.detach().numpy())
    np.testing.assert_array_equal(d_ext.numpy(), d_full.numpy()[:n_ext])
    np.testing.assert_array_equal(d_own.numpy(), d_full.numpy()[n_ext:])
    out, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(full[n_ext:]),
                       jnp.asarray(full[:n_ext]), jnp.asarray(x))
    j_own, j_ext, _ = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=0)
    assert np.abs(d_ext.numpy()).max() > 0
    abs_full = _abs_table_grad(full_fn, full, x, g)
    _table_close(d_ext.numpy(), j_ext, abs_full[:n_ext])
    _table_close(d_own.numpy(), j_own, abs_full[n_ext:])
