"""Gradients of the port's scene-folded hash encode (the plain CPU twins
of kernel K3 behind the `HashBake` / `HashEncode` autograd Functions)
against `jax.vjp` of the JAX package's `hashgrid_encode_folded`, for the
table, the scene code and the points, and the table gradient against the
unfolded 5-D `hashgrid_encode`.

The JAX backward rounds its table-gradient payloads to bfloat16 by
default (`SORT_PAYLOAD_DTYPE`, `_SPLAT_DTYPE`); both globals are patched
to float32 here so the comparison is of the algorithm.

Tolerances. The two sides form and sum the same float32 contributions
in another order: sorted segments and dense-splat matmuls, with the
weight products grouped as (t_x t_y)(t_z g), in JAX; ((t_x t_y) t_z) g
and `index_add_` per corner here. A table slot whose contributions
cancel therefore differs by float32 steps of their absolute sum, not of
its own value, and JAX's segment sums are differences of a running
float32 prefix sum over a whole level, which adds about one float32
step of that prefix to every slot. So a table slot may differ by
rtol 1e-4 of the sum of absolute contributions to it (the port's
gradient with |table| and |g|: the corner weights are non-negative),
plus atol 1e-6 + 1e-7 of the level's total of absolute contributions
(the largest prefix). The scene gradient is held to rtol 1e-4, the
point gradient to 1e-4 of its largest magnitude (its terms carry the
fine levels' scale of up to 2047 and the frac signs)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.ops import hashgrid as jhg
from scenedreamer_tpu_torch import kernels
from scenedreamer_tpu_torch.ops import hashgrid as thg
from _torch_parity import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-4, 1e-6
CASES = [(4, 4, 10, 128), (4, 8, 10, 128), (16, 4, 12, 2048),
         (16, 8, 12, 2048)]


@pytest.fixture(autouse=True)
def f32_payloads(monkeypatch):
    monkeypatch.setattr(jhg, 'SORT_PAYLOAD_DTYPE', jnp.float32)
    monkeypatch.setattr(jhg, '_SPLAT_DTYPE', jnp.float32)


def _specs(levels, channels, log2, res):
    kw = dict(input_dim=5, num_levels=levels, level_dim=channels,
              base_resolution=16, log2_hashmap_size=log2,
              desired_resolution=res)
    return jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)


def _inputs(spec, seed, n=600):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_size, spec.level_dim)) \
        .astype(np.float32)
    xyz = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    scene = rng.uniform(-0.9, 0.9, (2,)).astype(np.float32)
    g = rng.standard_normal((n, spec.output_dim)).astype(np.float32)
    return table, xyz, scene, g


def _jax_grads(jspec, table, xyz, scene, g):
    fn = jax.jit(lambda t, x, s: jhg.hashgrid_encode_folded(jspec, t, x, s))
    _, vjp = jax.vjp(fn, jnp.asarray(table), jnp.asarray(xyz),
                     jnp.asarray(scene))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _close(got, want, tol, name):
    bad = np.abs(got - want) > tol
    assert not bad.any(), (name, int(bad.sum()), got[bad][:5], want[bad][:5])


def _table_tol(spec, abs_grad):
    levels = np.abs(abs_grad).reshape(spec.num_levels, -1)
    prefix = levels.sum(axis=1, keepdims=True)
    return (RTOL * levels + ATOL + 1e-7 * prefix).reshape(abs_grad.shape)


def _port_grads(tspec, table, xyz, scene, g):
    t, x, s = (torch.tensor(a, requires_grad=True)
               for a in (table, xyz, scene))
    out = thg.hashgrid_encode_folded(tspec, t, x, s)
    return [a.numpy() for a in torch.autograd.grad(
        out, (t, x, s), torch.from_numpy(g))]


@pytest.mark.parametrize('levels,channels,log2,res', CASES)
def test_folded_encode_grads_match_jax(levels, channels, log2, res):
    jspec, tspec = _specs(levels, channels, log2, res)
    table, xyz, scene, g = _inputs(tspec, levels * 10 + channels)
    want = _jax_grads(jspec, table, xyz, scene, g)
    got = _port_grads(tspec, table, xyz, scene, g)
    oob = (np.abs(xyz) > 1.0).any(-1)
    assert oob.any() and (~oob).any()
    assert (got[1][oob] == 0).all()               # out of bounds: no grad
    assert np.abs(got[0]).max() > 0.1 and np.abs(got[2]).max() > 0
    abs_table = _port_grads(tspec, table, xyz, scene, np.abs(g))[0]
    _close(got[0], want[0], _table_tol(tspec, abs_table), 'table')
    _close(got[1], want[1], RTOL * np.abs(want[1]).max(), 'xyz')
    _close(got[2], want[2], RTOL * np.abs(want[2]), 'scene')


@pytest.mark.parametrize('levels,channels,log2,res', CASES[:2])
def test_table_grad_matches_unfolded_encode(levels, channels, log2, res):
    jspec, tspec = _specs(levels, channels, log2, res)
    table, xyz, scene, g = _inputs(tspec, 7)
    cat = np.concatenate([xyz, np.broadcast_to(scene, (len(xyz), 2))], -1)
    _, vjp = jax.vjp(lambda t: jhg.hashgrid_encode(jspec, t,
                                                   jnp.asarray(cat)),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _port_grads(tspec, table, xyz, scene, g)[0]
    abs_table = _port_grads(tspec, table, xyz, scene, np.abs(g))[0]
    _close(got, want, _table_tol(tspec, abs_table), 'table')


def test_scene_out_of_bounds_gives_zero_grads():
    _, tspec = _specs(4, 4, 10, 128)
    table, xyz, _, g = _inputs(tspec, 3)
    scene = np.array([1.5, 0.2], np.float32)
    for a in _port_grads(tspec, table, xyz, scene, g):
        assert (a == 0).all()


def test_split_bake_encode_is_differentiable():
    """`fold_scene` then `encode_folded` (the renderer's split) carries the
    same gradients as one `hashgrid_encode_folded` call, and a table that
    needs no gradient saves no baked table for the points."""
    _, tspec = _specs(16, 8, 12, 2048)
    table, xyz, scene, g = _inputs(tspec, 5)
    whole = _port_grads(tspec, table, xyz, scene, g)
    t, s = (torch.tensor(a, requires_grad=True) for a in (table, scene))
    folded = thg.fold_scene(tspec, t, s)
    assert folded.baked.grad_fn is not None
    out = thg.encode_folded(tspec, folded, torch.from_numpy(xyz))
    assert out.grad_fn is not None
    dt, ds = torch.autograd.grad(out, (t, s), torch.from_numpy(g))
    np.testing.assert_array_equal(dt.numpy(), whole[0])
    np.testing.assert_array_equal(ds.numpy(), whole[2])
    with torch.no_grad():
        folded = thg.fold_scene(tspec, t, s)
        assert folded.baked.grad_fn is None


def test_plain_backward_pieces():
    """encode_bwd_plain scatters w_k * g into the corner rows; the bake
    is its own adjoint up to the xor masks; bake_dw_plain is the weight
    gradient of the bake (checked by a finite difference in float64)."""
    _, tspec = _specs(4, 4, 10, 128)
    table, xyz, scene, g = _inputs(tspec, 11, n=50)
    t3 = torch.from_numpy(table).reshape(4, -1, 4)
    masks, weights, _ = thg.scene_fold_weights(tspec, torch.from_numpy(scene))
    grad = torch.from_numpy(
        np.random.default_rng(0).standard_normal(t3.shape).astype(np.float32))
    dw = thg.bake_dw_plain(t3, grad, masks)
    eps = 1e-3
    for a in range(masks.shape[1]):
        bump = torch.zeros_like(weights, dtype=torch.float64)
        bump[:, a] = eps
        up = thg.bake_plain(t3.double(), masks, weights.double() + bump)
        dn = thg.bake_plain(t3.double(), masks, weights.double() - bump)
        fd = ((up - dn) * grad.double()).sum(dim=(1, 2)) / (2 * eps)
        np.testing.assert_allclose(dw[:, a].numpy(), fd.numpy(), rtol=1e-5)
    scales = thg._scales(tspec, 'cpu')
    g_t = torch.from_numpy(g)
    acc, _ = thg.encode_bwd_plain(g_t, torch.from_numpy(xyz), scales,
                                  thg._offset(tspec), 1.0, False,
                                  t3.shape[1])
    baked = torch.zeros_like(t3, requires_grad=True)
    out = thg.encode_plain(baked, torch.from_numpy(xyz), scales,
                           thg._offset(tspec), 1.0, False)
    (want,) = torch.autograd.grad(out, baked, g_t)
    torch.testing.assert_close(acc, want, rtol=1e-5, atol=1e-6)


def test_scatter_coarse_levels_follow_the_scale():
    """The table scatters (K3a, K4b on the card) take their coarse path on
    the levels whose scale is at most `kernels.COARSE_MAX_SCALE`: every
    level of the flagship spec (all 16 were measured faster there), the
    same for the folded encode's scales and for the general encode's
    metadata of the unfolded log2-21 spec; a finer level stays direct;
    DIRECT_ONLY flags no level, an infinite bound every level."""
    kw = dict(input_dim=5, num_levels=16, level_dim=8, base_resolution=16,
              desired_resolution=2048)
    spec = thg.HashGridSpec.create(log2_hashmap_size=19, **kw)
    scales = thg._scales(spec, 'cpu')
    flags = kernels.coarse_levels(scales)
    assert flags == [True] * 16
    assert [float(s) <= kernels.COARSE_MAX_SCALE
            for s in scales.tolist()] == flags
    unfolded = thg.HashGridSpec.create(log2_hashmap_size=21, **kw)
    assert kernels.coarse_levels(thg.general_meta(unfolded)[1]) == flags
    finer = thg.HashGridSpec.create(**{**kw, 'desired_resolution': 4096})
    assert kernels.coarse_levels(thg._scales(finer, 'cpu'))[-3:] == [
        True, False, False]
    assert not any(kernels.coarse_levels(scales, kernels.DIRECT_ONLY))
    assert all(kernels.coarse_levels(scales, float('inf')))
