"""The port's scene-folded hash encode under `hash_variant='paired'` (the
plain CPU twins of kernel K5) against the JAX package: forward against
`hashgrid_encode_folded` and the unfolded 5-D `hashgrid_encode`, and the
gradients for the table, the scene code and the points against `jax.vjp`.

Forward: atol 1e-5 (float32 sums in another order), tables uniform in
[-1, 1] so a wrong row is visible. Gradients: the JAX backward rounds its
table-gradient payloads to bfloat16 by default (`SORT_PAYLOAD_DTYPE` on
the fine levels' pair payloads, `_SPLAT_DTYPE` on the coarse levels'
dense splat); both are patched to float32. A table slot may then differ
by rtol 1e-4 of the sum of absolute contributions to it, plus atol 1e-6
+ 1e-7 of the level's total of absolute contributions (JAX's segment
sums are differences of a running float32 prefix sum over a level); the
scene gradient is held to rtol 1e-4 plus 1e-6 of its largest component
(JAX sums each fold-weight gradient in float32 over a whole level, the
port in float64, and a component whose terms cancel carries that sum's
rounding), the point gradient to 1e-4 of its largest magnitude, as for
the xor variant.

A table of 2^6 or 2^10 rows makes pairs whose base is the last row
common: their second row is row 0."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.ops import hashgrid as jhg
from scenedreamer_tpu_torch.ops import hashgrid as thg
from _torch_parity import cap_torch_threads

cap_torch_threads()

ATOL_FWD = 1e-5
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
              desired_resolution=res, hash_variant='paired')
    return jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)


def _inputs(spec, seed, n=600):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_size, spec.level_dim)) \
        .astype(np.float32)
    xyz = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    scene = rng.uniform(-0.9, 0.9, (2,)).astype(np.float32)
    g = rng.standard_normal((n, spec.output_dim)).astype(np.float32)
    return table, xyz, scene, g


def _port(tspec, table, xyz, scene):
    return thg.hashgrid_encode_folded(tspec, torch.from_numpy(table),
                                      torch.from_numpy(xyz),
                                      torch.from_numpy(scene)).numpy()


def _port_grads(tspec, table, xyz, scene, g):
    t, x, s = (torch.tensor(a, requires_grad=True)
               for a in (table, xyz, scene))
    out = thg.hashgrid_encode_folded(tspec, t, x, s)
    return [a.numpy() for a in torch.autograd.grad(
        out, (t, x, s), torch.from_numpy(g))]


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


def _wrapping_points(tspec, xyz):
    """How many (point, level, corner) pairs start at the last row."""
    slots = tspec.table_size // tspec.num_levels
    x01 = (torch.from_numpy(xyz) + 1.0) / 2.0
    x01 = x01[((x01 >= 0) & (x01 <= 1)).all(-1)]
    count = 0
    for lv, scale in enumerate(thg._scales(tspec, 'cpu')):
        rows, _, _ = thg._corners(x01, scale, 0.5, slots, 'paired')
        for k in range(0, 8, 2):
            wrap = rows[k] == slots - 1
            assert (rows[k + 1][wrap] == 0).all()
            assert (rows[k + 1][~wrap] == rows[k][~wrap] + 1).all()
            count += int(wrap.sum())
    return count


@pytest.mark.parametrize('levels,channels,log2,res', CASES)
def test_paired_folded_encode_matches_jax(levels, channels, log2, res):
    jspec, tspec = _specs(levels, channels, log2, res)
    assert thg.foldable(tspec) and jhg.foldable(jspec)
    table, xyz, scene, _ = _inputs(tspec, levels * 10 + channels, n=400)
    got = _port(tspec, table, xyz, scene)
    folded = np.asarray(jhg.hashgrid_encode_folded(
        jspec, jnp.asarray(table), jnp.asarray(xyz), jnp.asarray(scene)))
    cat = np.concatenate([xyz, np.broadcast_to(scene, (len(xyz), 2))], -1)
    unfolded = np.asarray(jhg.hashgrid_encode(jspec, jnp.asarray(table),
                                              jnp.asarray(cat)))
    oob = (np.abs(xyz) > 1.0).any(-1)
    assert oob.any() and (~oob).any()
    assert (got[oob] == 0).all()
    assert np.abs(got[~oob]).max() > 0.1
    np.testing.assert_allclose(got, folded, atol=ATOL_FWD, rtol=0)
    np.testing.assert_allclose(got, unfolded, atol=ATOL_FWD, rtol=0)


def test_paired_differs_from_xor():
    """The two variants address different rows (else the tests above
    would hold for a port that ignored the variant)."""
    _, tspec = _specs(4, 4, 10, 128)
    xspec = thg.HashGridSpec.create(
        input_dim=5, num_levels=4, level_dim=4, log2_hashmap_size=10,
        desired_resolution=128)
    table, xyz, scene, _ = _inputs(tspec, 2, n=100)
    assert np.abs(_port(tspec, table, xyz, scene)
                  - _port(xspec, table, xyz, scene)).max() > 0.1


@pytest.mark.parametrize('log2', [6, 10])
def test_pair_wraps_at_last_row(log2):
    """Pairs based at row S-1 take row 0 as their second row, forward and
    backward (JAX: the cyclically extended table and the roll)."""
    jspec, tspec = _specs(4, 4, log2, 128)
    table, xyz, scene, g = _inputs(tspec, 21, n=2000)
    assert _wrapping_points(tspec, xyz) >= 4
    got = _port(tspec, table, xyz, scene)
    want = np.asarray(jhg.hashgrid_encode_folded(
        jspec, jnp.asarray(table), jnp.asarray(xyz), jnp.asarray(scene)))
    np.testing.assert_allclose(got, want, atol=ATOL_FWD, rtol=0)
    gw = _jax_grads(jspec, table, xyz, scene, g)
    gg = _port_grads(tspec, table, xyz, scene, g)
    abs_table = _port_grads(tspec, table, xyz, scene, np.abs(g))[0]
    _close(gg[0], gw[0], _table_tol(tspec, abs_table), 'table')
    _close(gg[1], gw[1], RTOL * np.abs(gw[1]).max(), 'xyz')


@pytest.mark.parametrize('levels,channels,log2,res', CASES)
def test_paired_folded_encode_grads_match_jax(levels, channels, log2, res):
    jspec, tspec = _specs(levels, channels, log2, res)
    table, xyz, scene, g = _inputs(tspec, levels * 10 + channels)
    want = _jax_grads(jspec, table, xyz, scene, g)
    got = _port_grads(tspec, table, xyz, scene, g)
    oob = (np.abs(xyz) > 1.0).any(-1)
    assert (got[1][oob] == 0).all()
    assert np.abs(got[0]).max() > 0.1 and np.abs(got[2]).max() > 0
    abs_table = _port_grads(tspec, table, xyz, scene, np.abs(g))[0]
    _close(got[0], want[0], _table_tol(tspec, abs_table), 'table')
    _close(got[1], want[1], RTOL * np.abs(want[1]).max(), 'xyz')
    _close(got[2], want[2], RTOL * np.abs(want[2])
           + ATOL * np.abs(want[2]).max(), 'scene')


@pytest.mark.parametrize('levels,channels,log2,res', CASES[:2])
def test_paired_table_grad_matches_unfolded_encode(levels, channels, log2,
                                                   res):
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


def test_paired_scene_out_of_bounds_gives_zeros():
    jspec, tspec = _specs(4, 4, 10, 128)
    table, xyz, _, g = _inputs(tspec, 3)
    scene = np.array([1.5, 0.2], np.float32)
    ref = np.asarray(jhg.hashgrid_encode_folded(
        jspec, jnp.asarray(table), jnp.asarray(xyz), jnp.asarray(scene)))
    assert (_port(tspec, table, xyz, scene) == 0).all() and (ref == 0).all()
    for a in _port_grads(tspec, table, xyz, scene, g):
        assert (a == 0).all()


def test_fold_masks_wrap_like_uint32():
    """The paired fold masks equal JAX's uint32 ADD-combine (which wraps
    mod 2^32 before the mask) at every level of the flagship spec."""
    jspec, tspec = _specs(16, 8, 19, 2048)
    size = tspec.table_size // tspec.num_levels
    for scene in ([0.31, -0.47], [0.999, 0.999], [-1.0, 1.0]):
        masks, weights, oob = thg.scene_fold_weights(
            tspec, torch.tensor(scene))
        assert not oob and masks.min() >= 0 and masks.max() < size
        s01 = (np.asarray(scene, np.float32) + 1) / 2
        for lv in range(16):
            scale = np.float32(tspec.level_resolution(lv)[1])
            cell = np.floor(np.float64(s01) * np.float64(scale) + 0.5) \
                .astype(np.uint32)
            for a in range(4):
                c = cell + np.array([a & 1, a >> 1], np.uint32)
                with np.errstate(over='ignore'):
                    h = (c[0] * jhg._PRIMES[3] + c[1] * jhg._PRIMES[4]) \
                        & np.uint32(size - 1)
                assert int(masks[lv, a]) == int(h)


def test_paired_plain_backward_pieces():
    """Each plain backward piece against autograd through the plain
    forward: `paired_encode_bwd_plain` (table rows and points),
    `shift_bake_plain` with the inverse shifts (dT) and
    `shift_bake_dw_plain` (dw)."""
    _, tspec = _specs(4, 4, 10, 128)
    table, xyz, scene, g = _inputs(tspec, 11, n=80)
    xyz = np.clip(xyz, -0.99, 0.99)
    t3 = torch.from_numpy(table).reshape(4, -1, 4)
    slots = t3.shape[1]
    shifts, weights, _ = thg.scene_fold_weights(tspec,
                                                torch.from_numpy(scene))
    scales, off = thg._scales(tspec, 'cpu'), thg._offset(tspec)
    g_t, x_t = torch.from_numpy(g), torch.from_numpy(xyz)

    # bake: dT and dw through autograd of the gather-based plain bake
    tt = t3.clone().requires_grad_(True)
    ww = weights.clone().requires_grad_(True)
    baked = thg.shift_bake_plain(tt, shifts, ww)
    gb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        t3.shape).astype(np.float32))
    want_dt, want_dw = torch.autograd.grad(baked, (tt, ww), gb)
    inv = (slots - shifts) & (slots - 1)
    torch.testing.assert_close(thg.shift_bake_plain(gb, inv, weights),
                               want_dt, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(thg.shift_bake_dw_plain(t3, gb, shifts),
                               want_dw, rtol=1e-4, atol=1e-5)

    # encode: the scatter is the adjoint of the gather
    bb = baked.detach().clone().requires_grad_(True)
    out = thg.paired_encode_plain(bb, x_t, scales, off, 1.0, False)
    (want_g,) = torch.autograd.grad(out, bb, g_t)
    got_g, got_dx = thg.paired_encode_bwd_plain(
        g_t, x_t, scales, off, 1.0, False, slots, baked.detach())
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)
    # points: central difference of the float64 forward inside the cell
    eps = 1e-6
    x64 = x_t.double()
    b64, s64 = baked.detach().double(), scales.double()
    for d in range(3):
        bump = torch.zeros_like(x64)
        bump[:, d] = eps
        up = _encode64(b64, x64 + bump, s64, off, slots)
        dn = _encode64(b64, x64 - bump, s64, off, slots)
        fd = ((up - dn) * g_t.double()).sum(-1) / (2 * eps)
        err = (got_dx[:, d].double() - fd).abs()
        # a point within eps of a cell face has no two-sided derivative
        assert np.quantile(err.numpy(), 0.9) <= 1e-3 * fd.abs().max()


def _encode64(baked, xyz, scales, offset, slots):
    """The paired encode in float64 (no fused rounding needed)."""
    x01 = (xyz + 1.0) / 2.0
    outs = []
    for lv in range(baked.shape[0]):
        pos = x01 * scales[lv] + offset
        cell = torch.floor(pos)
        frac = pos - cell
        u = cell.to(torch.int64)
        acc = 0
        for k in range(8):
            bits = [(k >> d) & 1 for d in range(3)]
            idx = sum((u[:, d] + bits[d]) * thg.PRIMES[d] for d in range(3))
            w = 1.0
            for d in range(3):
                w = w * (frac[:, d] if bits[d] else 1.0 - frac[:, d])
            acc = acc + w[:, None] * baked[lv][idx & (slots - 1)]
        outs.append(acc)
    return torch.cat(outs, -1)


def test_paired_scatter_split_checks_its_arguments():
    """K5c's split wrapper checks its arguments before it builds or
    launches anything: a stats tensor off the card, and points off the
    card, are refused on the CPU too."""
    from scenedreamer_tpu_torch import kernels
    g, xyz = torch.zeros((4, 8)), torch.zeros((4, 3))
    scales = torch.ones(2)
    with pytest.raises(ValueError, match='stats must be a CUDA tensor'):
        kernels.hash_encode_paired_bwd_split(
            g, xyz, scales, 0.5, 1.0, False, 16, None, 2048.0,
            torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match='g must be a CUDA tensor'):
        kernels.hash_encode_paired_bwd_split(g, xyz, scales, 0.5, 1.0, False,
                                             16)


def test_paired_encode_and_dw_check_their_arguments(monkeypatch):
    """K5b's and K5d's wrappers refuse what their kernels do not take
    before they build or launch anything, on the CPU too: C not in
    {4, 8}, S not a power of two, S * C above 2^32 (the kernels' 32-bit
    row offsets), more than 8 corners and mismatched shapes; tensors of
    the right shapes off the card are refused next."""
    from scenedreamer_tpu_torch import kernels

    def no_build():
        raise AssertionError('a wrapper built the kernels')
    monkeypatch.setattr(kernels, 'build', no_build)
    xyz, scales = torch.zeros((4, 3)), torch.ones(2)
    for baked, x, s, match in (
            (torch.zeros((2, 16, 6)), xyz, scales, 'C in'),
            (torch.zeros((2, 12, 8)), xyz, scales, 'power-of-two S'),
            (torch.zeros((2, 16, 8)), torch.zeros((4, 2)), scales, r'\[N, 3\]'),
            (torch.zeros((2, 16, 8)), xyz, torch.ones(3), r'\[L\] scales'),
            (torch.zeros((16, 8)), xyz, scales, r'\[L, S, C\]'),
            (torch.zeros((1, 1, 8)).expand(1, 1 << 30, 8), xyz, scales[:1],
             r'2\^32'),
            (torch.zeros((2, 16, 8)), xyz, scales, 'CUDA tensor')):
        with pytest.raises(ValueError, match=match):
            kernels.hash_encode_paired(baked, x, s, 0.5, 1.0, False)
    table = torch.zeros((2, 16, 8))
    shifts = torch.zeros((2, 4), dtype=torch.int32)
    for t, g, m, match in (
            (torch.zeros((2, 16, 6)), torch.zeros((2, 16, 6)), shifts,
             'C in'),
            (torch.zeros((2, 12, 8)), torch.zeros((2, 12, 8)), shifts,
             'power-of-two S'),
            (table, table, torch.zeros((2, 9), dtype=torch.int32),
             'A<=8'),
            (table, torch.zeros((2, 8, 8)), shifts, 'equal'),
            (table, table, torch.zeros((3, 4), dtype=torch.int32), 'equal'),
            (table, table, torch.zeros(4, dtype=torch.int32), r'\[L, A\]'),
            (table, table, shifts, 'CUDA tensor')):
        with pytest.raises(ValueError, match=match):
            kernels.hash_shift_bake_dw(t, g, m)


def test_kernel_builds_hash_the_headers_they_include():
    """Every header a kernel source includes is hashed into that source's
    library name (`kernels.HEADERS`), so a changed `scatter_accum.cuh`
    rebuilds K3, K4 and K5 rather than loading a stale library."""
    import os
    import re
    import shutil
    import tempfile
    from scenedreamer_tpu_torch import kernels
    from scenedreamer_tpu_torch.utils.build import library_path
    for src in kernels.SOURCES.values():
        with open(os.path.join(kernels.CSRC, src)) as f:
            for inc in re.findall(r'#include "([^"]+)"', f.read()):
                assert inc in kernels.HEADERS, (src, inc)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ('hashgrid_paired.cu',) + kernels.HEADERS:
            shutil.copy(os.path.join(kernels.CSRC, name), tmp)
        deps = tuple(os.path.join(tmp, h) for h in kernels.HEADERS)
        src = os.path.join(tmp, 'hashgrid_paired.cu')
        before = library_path(src, ['nvcc'], 'hashgrid_paired', deps)
        with open(deps[0], 'a') as f:
            f.write('// changed\n')
        assert library_path(src, ['nvcc'], 'hashgrid_paired', deps) != before


def _dw_grid(table3, grad, masks, variant):
    """`csrc/bake_dw.cuh` emulated in float64 on the CPU: the persistent
    grid's spans (block b takes float4s [b P / B, (b+1) P / B) of each
    level, B = DW_BLOCKS, thread t of the block every 256th float4 from
    the span's start t, a warp's 32 threads summed into its own partial)
    and the two windows on float4 indices (xor: i ^ off; shift: i + off,
    less P once), off = (m & (S-1)) * C/4; then the partials summed.
    Checks on the way that the spans tile each level once and that each
    window reads row src(j, m) of T, 4 channels q at a time."""
    from scenedreamer_tpu_torch import kernels
    lv, s, c = table3.shape
    c4 = c // 4
    per = s * c4
    blocks, warps = kernels.DW_BLOCKS, kernels.DW_WARPS
    lo = torch.tensor([per * b // blocks for b in range(blocks + 1)])
    assert lo[0] == 0 and lo[-1] == per and (lo[1:] >= lo[:-1]).all()
    i = torch.arange(per)
    blk = torch.searchsorted(lo[:-1], i, right=True) - 1
    assert ((lo[blk] <= i) & (i < lo[blk + 1])).all()
    warp = blk * warps + (i - lo[blk]) % 256 // 32
    t4 = table3.double().reshape(lv, per, 4)
    g4 = grad.double().reshape(lv, per, 4)
    dw = torch.zeros(masks.shape, dtype=torch.float64)
    for l in range(lv):
        for a in range(masks.shape[1]):
            m = int(masks[l, a]) & (s - 1)
            off = m * c4
            if variant == 'xor':
                src = i ^ off
                row = (i // c4) ^ m
            else:
                src = i + off
                src = torch.where(src >= per, src - per, src)
                row = (i // c4 + m) % s
            assert torch.equal(src, row * c4 + i % c4)
            partial = torch.zeros(blocks * warps, dtype=torch.float64)
            partial.index_add_(0, warp, (t4[l, src] * g4[l]).sum(-1))
            dw[l, a] = partial.sum()
    return dw.float()


@pytest.mark.parametrize('variant', ['xor', 'paired'])
@pytest.mark.parametrize('levels,slots,channels,corners', [
    (3, 16, 4, 4), (3, 16, 8, 4), (2, 1 << 12, 4, 8), (2, 1 << 11, 8, 3)])
def test_dw_grid_windows_match_plain(variant, levels, slots, channels,
                                     corners):
    """The dw reductions' shared skeleton, K3c's xor window and K5d's
    shift window, emulated in float64 (`_dw_grid`), against
    `bake_dw_plain` (rtol 1e-6: float64 sums in another order, rounded
    to float32): C = 4 and 8, 1 to 8 corners, a 16-row level (fewer
    float4s than blocks, so most blocks take none), masks 0, S - 1 and
    one past S (the kernel reduces it & (S-1), as the plain version
    does)."""
    gen = torch.Generator().manual_seed(11)
    table3 = torch.rand((levels, slots, channels), generator=gen) * 2 - 1
    grad = torch.randn((levels, slots, channels), generator=gen)
    masks = torch.randint(0, slots, (levels, corners), generator=gen)
    masks[0, 0] = 0
    masks[-1, -1] = slots - 1
    masks[0, -1] = slots + 3
    got = _dw_grid(table3, grad, masks, variant)
    want = thg.bake_dw_plain(table3, grad, masks, variant)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
