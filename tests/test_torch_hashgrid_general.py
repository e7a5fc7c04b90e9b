"""The port's general (unfolded) hash-grid encode (the plain CPU twins of
kernel K4 behind `HashEncodeGeneral`) against the JAX package's
`hashgrid_encode`, forward and, through `jax.vjp`, the table and point
gradients.

The JAX side runs jitted, as the generator and the trainer run it: XLA
then rounds the cell position x * scale + offset once (a fused
multiply-add), and so does the port; op by op, unjitted, JAX rounds it
twice, which moves the fine levels' features by up to a float32 step
of the position. The JAX backward rounds its table-gradient payloads to
bfloat16 by default (`SORT_PAYLOAD_DTYPE`); it is patched to float32
here so the comparison is of the algorithm.

Tolerances: the forward 1e-5 (float32 sums of 2^D corner terms in
another order). The table and point gradients as
`test_torch_hashgrid_grad.py` states them: a table row may differ by
1e-4 of the sum of absolute contributions to it plus 1e-6 and 1e-7 of
its level's total of absolute contributions (JAX sums sorted segments
as differences of a running float32 prefix over the level); the point
gradient by 1e-4 of its largest magnitude.

The cases cover input dimensions 1, 2, 3, 5 and 7; gridtype 'hash' and
'tiled'; aligned and unaligned corners; both hash variants; levels that
are tiled (non-power-of-two sizes: `% size`), hashed, and tiled past a
stride cut-off; the all-hashed uniform spec (JAX's scan path); points
exactly on the bounds and out of bounds."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.ops import hashgrid as jhg
from scenedreamer_tpu_torch.models.generator import GeneratorConfig
from scenedreamer_tpu_torch.ops import hashgrid as thg
from scenedreamer_tpu_torch.ops.encoders import get_encoder
from _torch_parity import cap_torch_threads

cap_torch_threads()

ATOL_FWD = 1e-5
RTOL, ATOL = 1e-4, 1e-6
N = 256

CASES = {
    # the tiny non-foldable generator spec: level 0 tiled at 3^5 -> 248
    # rows, levels 1-3 hashed at 2^10
    'd5_xor': dict(input_dim=5, num_levels=4, level_dim=4,
                   base_resolution=2, log2_hashmap_size=10,
                   desired_resolution=16),
    'd5_paired': dict(input_dim=5, num_levels=4, level_dim=4,
                      base_resolution=2, log2_hashmap_size=10,
                      desired_resolution=16, hash_variant='paired'),
    'd2_paired_c8': dict(input_dim=2, num_levels=5, level_dim=8,
                         base_resolution=8, log2_hashmap_size=9,
                         desired_resolution=2048, hash_variant='paired'),
    # tiled past the cut-off: the stride loop stops before dimension 2
    'd3_tiledgrid': dict(input_dim=3, num_levels=6, level_dim=2,
                         base_resolution=4, log2_hashmap_size=8,
                         desired_resolution=256, gridtype='tiled'),
    'd3_tiledgrid_aligned': dict(input_dim=3, num_levels=6, level_dim=2,
                                 base_resolution=4, log2_hashmap_size=8,
                                 desired_resolution=256, gridtype='tiled',
                                 align_corners=True),
    'd3_hash_aligned': dict(input_dim=3, num_levels=4, level_dim=4,
                            base_resolution=3, log2_hashmap_size=9,
                            desired_resolution=512, align_corners=True),
    # every level hashed at one size: JAX takes `_encode_flat_scan`
    'd3_uniform': dict(input_dim=3, num_levels=4, level_dim=2,
                       base_resolution=16, log2_hashmap_size=8,
                       desired_resolution=128),
    'd7_c1': dict(input_dim=7, num_levels=3, level_dim=1,
                  base_resolution=2, log2_hashmap_size=12,
                  desired_resolution=8),
    'd1': dict(input_dim=1, num_levels=3, level_dim=4, base_resolution=4,
               log2_hashmap_size=4, desired_resolution=64),
}


@pytest.fixture(autouse=True)
def f32_payloads(monkeypatch):
    monkeypatch.setattr(jhg, 'SORT_PAYLOAD_DTYPE', jnp.float32)


def _specs(kw):
    return jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)


def _inputs(spec, seed, n=N):
    """Table uniform in [-1, 1] (a wrong row shows), points in
    [-1.05, 1.05]^D with some coordinates exactly on -1 and 1."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_size, spec.level_dim)) \
        .astype(np.float32)
    x = rng.uniform(-1.05, 1.05, (n, spec.input_dim)).astype(np.float32)
    x[:8] = rng.uniform(-0.9, 0.9, (8, spec.input_dim))
    x[0, :] = -1.0
    x[1, :] = 1.0
    for i in range(2, 8):
        x[i, i % spec.input_dim] = -1.0 if i % 2 else 1.0
    g = rng.standard_normal((n, spec.output_dim)).astype(np.float32)
    return table, x, g


def _jax(jspec, table, x, g):
    def both(t, p, c):
        out, vjp = jax.vjp(lambda t_, p_: jhg.hashgrid_encode(jspec, t_, p_),
                           t, p)
        return (out,) + vjp(c)
    return [np.asarray(a) for a in jax.jit(both)(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(g))]


def _port(tspec, table, x, g, chunk=None):
    t, p = (torch.tensor(a, requires_grad=True) for a in (table, x))
    out = thg.hashgrid_encode(tspec, t, p, chunk=chunk)
    dt, dp = torch.autograd.grad(out, (t, p), torch.from_numpy(g))
    return out.detach().numpy(), dt.numpy(), dp.numpy()


def _close(got, want, tol, name):
    bad = np.abs(got - want) > tol
    assert not bad.any(), (name, int(bad.sum()), got[bad][:5], want[bad][:5])


def _table_tol(spec, abs_grad):
    tol = np.empty_like(abs_grad)
    for lv in thg.general_levels(spec):
        rows = slice(lv.offset, lv.offset + lv.size)
        total = abs_grad[rows].sum()
        tol[rows] = RTOL * abs_grad[rows] + ATOL + 1e-7 * total
    return tol


@pytest.mark.parametrize('case', list(CASES))
def test_general_encode_matches_jax(case):
    jspec, tspec = _specs(CASES[case])
    assert tspec.table_size == jspec.table_size
    assert jhg.foldable(jspec) == thg.foldable(tspec)
    table, x, g = _inputs(tspec, sum(map(ord, case)))
    want = _jax(jspec, table, x, g)
    got = _port(tspec, table, x, g)
    oob = (np.abs(x) > 1.0).any(-1)
    assert oob.any() and (~oob).any() and not oob[:8].any()
    assert (got[0][oob] == 0).all() and (got[2][oob] == 0).all()
    assert np.abs(got[0][~oob]).max() > 0.1
    np.testing.assert_allclose(got[0], want[0], atol=ATOL_FWD, rtol=0)
    abs_table = _port(tspec, table, x, np.abs(g))[1]
    _close(got[1], want[1], _table_tol(tspec, abs_table), 'table')
    _close(got[2], want[2], RTOL * np.abs(want[2]).max(), 'points')
    # chunked encodes give the same features and point gradients as one
    # call; the table gradient sums the chunks' scatters in another order
    chunked = _port(tspec, table, x, g, chunk=100)
    np.testing.assert_array_equal(chunked[0], got[0])
    np.testing.assert_array_equal(chunked[2], got[2])
    _close(chunked[1], got[1], 1e-6 * abs_table + 1e-7, 'chunked table')


def test_levels_tiled_hashed_and_cut_off():
    """The per-level index modes of `_level_encode` (JAX
    hashgrid.py:495-511): the flagship spec at 2^21 rows keeps level 0
    tiled (17^5 cells, 1,419,864 rows after the multiple-of-8 round-up,
    not a power of two) and hashes the rest; a tiled grid past its cap
    drops the dimensions after the cut-off."""
    spec = thg.HashGridSpec.create(input_dim=5, num_levels=16, level_dim=8,
                                   base_resolution=16, log2_hashmap_size=21,
                                   desired_resolution=2048)
    levels = thg.general_levels(spec)
    assert not thg.foldable(spec)
    assert spec.table_size == 32_877_144
    assert levels[0].size == 1_419_864 and not levels[0].hashed
    assert levels[0].strides == (1, 17, 17 ** 2, 17 ** 3, 17 ** 4)
    assert all(lv.hashed and lv.size == 2 ** 21 for lv in levels[1:])
    tiled = thg.HashGridSpec.create(input_dim=3, num_levels=2, level_dim=2,
                                    base_resolution=20, log2_hashmap_size=8,
                                    per_level_scale=2.0, gridtype='tiled')
    assert [lv.strides for lv in thg.general_levels(tiled)] == [
        (1, 21, 0), (1, 41, 0)]
    assert not any(lv.hashed for lv in thg.general_levels(tiled))


def test_tiled_index_wraps_like_uint32():
    """corner * stride is a wrapping uint32 product in JAX; the plain
    version's int64 arithmetic is masked to the same value before the
    `% size`."""
    level = thg.GeneralLevel(0, 1000, 70000.0, False, (1, 70001))
    x01 = torch.tensor([[0.3, 0.999], [0.0, 0.95]], dtype=torch.float32)
    rows, _, _ = thg._general_corners(x01, level, 0.5, 'xor')
    pos = (x01.numpy().astype(np.float64) * 70000.0 + 0.5).astype(np.float32)
    u = np.floor(pos).astype(np.uint32)
    for k, got in enumerate(rows):
        c = [u[:, d] + np.uint32((k >> d) & 1) for d in range(2)]
        h = c[0] * np.uint32(1) + c[1] * np.uint32(70001)   # wraps
        assert (c[1].astype(np.uint64) * 70001 >= 2 ** 32).all()
        np.testing.assert_array_equal(got.numpy(), h % np.uint32(1000))


def _kernel_mod(h, magic, size):
    """K4's `fast_mod` (`csrc/hashgrid_general.cu`) in numpy: the high 64
    bits of ((magic * h) mod 2^64) * size, formed from 32-bit halves."""
    low = h * np.uint64(magic)                      # wraps mod 2^64
    lo, hi = low & np.uint64(0xffffffff), low >> np.uint64(32)
    s = np.uint64(size)
    return (hi * s + ((lo * s) >> np.uint64(32))) >> np.uint64(32)


MOD_SPECS = {
    'flagship_19': lambda: GeneratorConfig().hash_spec,
    'flagship_21': lambda: GeneratorConfig(hash_log2_size=21).hash_spec,
    'flagship_22': lambda: GeneratorConfig(hash_log2_size=22).hash_spec,
    'hashgrid': lambda: get_encoder('hashgrid')[2],
    'tiledgrid_aligned': lambda: get_encoder('tiledgrid', level_dim=2,
                                             align_corners=True)[2],
}


@pytest.mark.parametrize('name', list(MOD_SPECS))
def test_mod_magic_matches_remainder(name):
    """The per-level multiplier `general_meta` hands K4 for its division-
    free `% size` gives h % size for every level size of the generator's
    specs and `get_encoder`'s: checked on the first and the last 2^20
    uint32 values, 2^20 random ones and the last 4,097 multiples of the
    size below 2^32, +-1; power-of-two sizes carry 0 (the kernel masks
    them)."""
    spec = MOD_SPECS[name]()
    meta, _ = thg.general_meta(spec)
    sizes = [lv.size for lv in thg.general_levels(spec)]
    assert meta[:, 10].tolist() == [thg.mod_magic(s) for s in sizes]
    rng = np.random.default_rng(7)
    top = np.uint64(2 ** 32)
    base = np.concatenate([np.arange(1 << 20, dtype=np.uint64),
                           top - np.uint64(1)
                           - np.arange(1 << 20, dtype=np.uint64),
                           rng.integers(0, 2 ** 32, 1 << 20,
                                        dtype=np.uint64)])
    assert any(s & (s - 1) for s in sizes) or name == 'flagship_19'
    for size in sorted(set(sizes)):
        magic = thg.mod_magic(size)
        if size & (size - 1) == 0:
            assert magic == 0
            continue
        assert 0 < magic < 2 ** 63 and magic == -(-2 ** 64 // size)
        k = np.arange(max(1, 2 ** 32 // size - 4096), 2 ** 32 // size + 1,
                      dtype=np.uint64) * np.uint64(size)
        near = np.concatenate([k - np.uint64(1), k, k + np.uint64(1)])
        h = np.concatenate([base, near[near < top]])
        np.testing.assert_array_equal(_kernel_mod(h, magic, size),
                                      h % np.uint64(size))


def test_foldable_spec_encodes_as_the_folded_path():
    """For a foldable spec the general encode of the concatenated 5-D
    points equals the scene-folded encode (the port's two paths)."""
    spec = thg.HashGridSpec.create(input_dim=5, num_levels=4, level_dim=4,
                                   log2_hashmap_size=10,
                                   desired_resolution=128)
    assert thg.foldable(spec)
    table, x, _ = _inputs(spec, 3)
    t = torch.from_numpy(table)
    xyz = torch.from_numpy(x[:, :3])
    scene = torch.tensor([0.25, -0.4])
    cat = torch.cat([xyz, scene.expand(len(xyz), 2)], dim=-1)
    torch.testing.assert_close(
        thg.hashgrid_encode(spec, t, cat),
        thg.hashgrid_encode_folded(spec, t, xyz, scene), rtol=0, atol=1e-6)


def test_gradient_paths_and_saved_table():
    """A table that needs a gradient while the points do not keeps no
    table for the backward and gives the same table gradient; points
    alone give the same point gradient with no table gradient."""
    _, tspec = _specs(CASES['d5_xor'])
    table, x, g = _inputs(tspec, 4, n=64)
    _, dt_both, dx_both = _port(tspec, table, x, g)
    t = torch.tensor(table, requires_grad=True)
    out = thg.HashEncodeGeneral.apply(t, torch.from_numpy(x), tspec, 1.0)
    assert out.grad_fn.saved_tensors[1] is None
    (dt,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    np.testing.assert_array_equal(dt.numpy(), dt_both)
    p = torch.tensor(x, requires_grad=True)
    out = thg.hashgrid_encode(tspec, torch.from_numpy(table), p)
    (dx,) = torch.autograd.grad(out, p, torch.from_numpy(g))
    np.testing.assert_array_equal(dx.numpy(), dx_both)
    grad, dx_plain = thg.encode_general_bwd_plain(
        tspec, torch.from_numpy(g), torch.from_numpy(x), 1.0, None,
        torch.from_numpy(table), table_grad=False)
    assert grad is None
    np.testing.assert_array_equal(dx_plain.numpy(), dx_both)


def test_bad_inputs_raise():
    _, tspec = _specs(CASES['d3_uniform'])
    table = torch.zeros((tspec.table_size, tspec.level_dim))
    with pytest.raises(ValueError):
        thg.hashgrid_encode(tspec, table[:-1], torch.zeros(4, 3))
    with pytest.raises(ValueError):
        thg.hashgrid_encode(tspec, table, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        thg.general_levels(thg.HashGridSpec(gridtype='dense'))
