"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test skips, with its reason, where CUDA is absent; on a GPU
machine run `python -m pytest tests/test_torch_cuda.py`.

K1 must equal its plain version exactly (ids, masks, t values and step
counts), also with the empty-space skip, in 8x4 tiles and with several
origins in one launch; K2 is expected exact as well (same float32 operations in the
same order) and is held to 1e-6. K3 (the hash backward) is held to its
plain version with the tolerances stated in its test (its scatter adds
atomically, in a run-dependent order). K5 (the paired variant's four
kernels) is held as K2 and K3 are, and so is K4 (the general encode,
forward and backward). The three table scatters' coarse path (K3a, K4b
and K5c through `csrc/scatter_accum.cuh`) is forced onto every level and
held to the same tolerances where a block's shared-memory table
overflows, where every point lies in one cell, and in ray order or
shuffled. The forward kernels' `sd::` ops (`ops/hash_ops.py`) launch
them, each once, with the same result as the wrappers. K6 (the
RenderMLP's hidden layer, `sd::render_mlp_gemm`) is held to its plain
composition within 1e-5 of the largest output (accumulation order
only), launches six times per served field chunk and never in a
training step."""
import math

import numpy as np
import pytest
import torch

from scenedreamer_tpu_torch import kernels
from scenedreamer_tpu_torch.ops import hashgrid as hg
from scenedreamer_tpu_torch.ops.ray_voxel import (build_occupancy_bits,
                                                  dda_plain)
from _torch_parity import cap_torch_threads

cap_torch_threads()

BLOCK_POINTS = 2048     # points per coarse block (scatter_accum.cuh)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (the kernels have no CPU mode)')
    return torch.device('cuda')


def test_dda_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    dims = (40, 96, 80)
    vox = np.zeros(dims, np.int64)
    vox[:5] = 9
    solid = rng.integers(0, np.asarray(dims) - 1, (300, 3))
    vox[solid[:, 0], solid[:, 1], solid[:, 2]] = 60
    voxel = torch.tensor(vox, dtype=torch.int8, device=cuda)
    dirs = rng.standard_normal((20000, 3)).astype(np.float32)
    dirs[:100, 1:] = 0.0                                # axis-parallel
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = torch.tensor(dirs, device=cuda)
    for ori in ([20.5, 40.2, 30.7], [60.0, -8.0, 33.3]):
        ori = torch.tensor(ori, device=cuda)
        got = kernels.dda(voxel, ori, dirs, 6, sum(dims) + 2,
                          with_steps=True)
        want = dda_plain(voxel, ori, dirs, 6, with_steps=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert got[2].any()


def _dda_grid(rng, dims, dev):
    """A grid whose dims are not multiples of the 8-voxel brick: a solid
    floor, solid blobs of a few bricks, scattered solid voxels and wide
    empty space."""
    vox = np.zeros(dims, np.int64)
    vox[:3] = 7
    for c in rng.integers(0, np.asarray(dims) - 12, (6, 3)):
        vox[c[0]:c[0] + 11, c[1]:c[1] + 9, c[2]:c[2] + 13] = 21
    solid = rng.integers(0, np.asarray(dims), (150, 3))
    vox[solid[:, 0], solid[:, 1], solid[:, 2]] = 60
    return torch.tensor(vox, dtype=torch.int8, device=dev)


def test_dda_kernel_skip_tiles_origins_match_plain(cuda):
    """K1 with the empty-space skip, in 8x4 tiles of 23x29-ray images (not
    whole tiles) and with 4 origins in one launch (two inside the grid,
    two outside) equals the plain version with the same per-ray origins,
    in flat order and in tiles, whether the caller passes the grid's
    bits, passes none (the wrapper builds them) or passes every bit set
    (a walk that loads every voxel it steps through); the card's bits
    equal the CPU's, and the grid's bits leave fewer voxel loads than all
    bits set, which load at every in-grid step."""
    rng = np.random.default_rng(3)
    dims = (45, 83, 70)
    voxel = _dda_grid(rng, dims, cuda)
    occ = build_occupancy_bits(voxel)
    assert occ.dtype == torch.int32
    assert torch.equal(occ.cpu(), kernels.occupancy_bits(voxel.cpu()))
    h, w = 23, 29
    dirs = rng.standard_normal((4, h * w, 3)).astype(np.float32)
    dirs[:, :40, 1:] = 0.0                              # axis-parallel
    dirs[:, 40:80, 0] = 0.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = torch.tensor(dirs.reshape(-1, 3), device=cuda)
    oris = torch.tensor([[20.5, 40.2, 30.7], [60.0, -8.0, 33.3],
                         [3.5, 77.9, 66.1], [-4.0, 100.0, -9.5]],
                        device=cuda)
    want = dda_plain(voxel, oris, dirs, 6, with_steps=True)
    assert want[2].any() and not want[2].all()
    loads = {}
    for bits, o in (('grid', occ), ('built', None),
                    ('all set', torch.full_like(occ, -1))):
        for width in (None, w):
            stats = torch.zeros(2, dtype=torch.int64, device=cuda)
            got = kernels.dda(voxel, oris, dirs, 6, sum(dims) + 2,
                              with_steps=True, occupancy=o,
                              image_width=width, stats=stats)
            for g, x in zip(got, want):
                assert torch.equal(g, x), (bits, width)
            loads[bits] = stats.tolist()
    steps = int(want[3].sum())
    assert loads['grid'] == loads['built']
    assert 0 < loads['all set'][0] <= steps
    assert 0 < loads['grid'][0] < loads['all set'][0]
    assert 0 < loads['grid'][1] < loads['all set'][0]


def test_dda_kernel_rejects_bad_input(cuda):
    voxel = torch.zeros((4, 4, 4), dtype=torch.int32, device=cuda)
    dirs = torch.ones((3, 3), device=cuda)
    with pytest.raises(ValueError):
        kernels.dda(voxel, torch.zeros(3), dirs, 2, 14)
    voxel = voxel.to(torch.int8)
    with pytest.raises(ValueError):        # 3 rays among 2 origins
        kernels.dda(voxel, torch.zeros((2, 3), device=cuda), dirs, 2, 14)
    with pytest.raises(ValueError):        # 3 rays are no rows of 2
        kernels.dda(voxel, torch.zeros(3, device=cuda), dirs, 2, 14,
                    image_width=2)
    with pytest.raises(ValueError):        # bits of another grid
        kernels.dda(voxel, torch.zeros(3, device=cuda), dirs, 2, 14,
                    occupancy=torch.zeros(2, dtype=torch.int32,
                                          device=cuda))


@pytest.mark.parametrize('levels,channels', [(4, 4), (16, 8)])
def test_hash_kernels_match_plain(cuda, levels, channels):
    spec = hg.HashGridSpec.create(input_dim=5, num_levels=levels,
                                  level_dim=channels, log2_hashmap_size=14,
                                  desired_resolution=2048)
    gen = torch.Generator(device=cuda).manual_seed(0)
    table = torch.rand((spec.table_size, channels), generator=gen,
                       device=cuda) * 2 - 1
    xyz = torch.rand((50000, 3), generator=gen, device=cuda) * 2.2 - 1.1
    scene = torch.tensor([0.3, -0.6], device=cuda)
    masks, weights, oob = hg.scene_fold_weights(spec, scene)
    table3 = table.reshape(levels, -1, channels)
    baked = kernels.hash_bake(table3, masks.to(torch.int32), weights)
    torch.testing.assert_close(baked, hg.bake_plain(table3, masks, weights),
                               rtol=0, atol=1e-6)
    scales = hg._scales(spec, cuda)
    got = kernels.hash_encode(baked, xyz, scales, hg._offset(spec), 1.0, oob)
    want = hg.encode_plain(baked, xyz, scales, hg._offset(spec), 1.0, oob)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    folded = hg.hashgrid_encode_folded(spec, table, xyz, scene)
    torch.testing.assert_close(folded, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('levels,channels', [(4, 4), (16, 8)])
def test_hash_backward_kernels_match_plain(cuda, levels, channels):
    """K3 against its plain version. G and dT: atomics add in a
    run-dependent order, so each slot may differ by 1e-5 of the sum of
    absolute contributions to it (the plain path on |g|) + 1e-7; dw:
    float64 sums on both sides, rtol 1e-5; dxyz: 1e-4 of its largest
    magnitude (float32 atomics over levels)."""
    spec = hg.HashGridSpec.create(input_dim=5, num_levels=levels,
                                  level_dim=channels, log2_hashmap_size=14,
                                  desired_resolution=2048)
    gen = torch.Generator(device=cuda).manual_seed(1)
    table = torch.rand((spec.table_size, channels), generator=gen,
                       device=cuda) * 2 - 1
    xyz = torch.rand((50000, 3), generator=gen, device=cuda) * 2.2 - 1.1
    g = torch.randn((50000, levels * channels), generator=gen, device=cuda)
    scene = torch.tensor([0.3, -0.6], device=cuda)
    masks, weights, oob = hg.scene_fold_weights(spec, scene)
    masks32 = masks.to(torch.int32)
    table3 = table.reshape(levels, -1, channels)
    scales, off = hg._scales(spec, cuda), hg._offset(spec)
    baked = hg.bake_plain(table3, masks, weights)
    slots = table3.shape[1]
    k_grad, k_dxyz = kernels.hash_encode_bwd(g, xyz, scales, off, 1.0, oob,
                                             slots, baked)
    p_grad, p_dxyz = hg.encode_bwd_plain(g, xyz, scales, off, 1.0, oob,
                                         slots, baked)
    abs_grad, _ = hg.encode_bwd_plain(g.abs(), xyz, scales, off, 1.0, oob,
                                      slots)
    assert ((k_grad - p_grad).abs() <= 1e-5 * abs_grad + 1e-7).all()
    k_dt = kernels.hash_bake(k_grad, masks32, weights, 'hash_bake_bwd')
    p_dt = hg.bake_plain(p_grad, masks, weights)
    abs_dt = hg.bake_plain(abs_grad, masks, weights)
    assert ((k_dt - p_dt).abs() <= 1e-5 * abs_dt + 1e-7).all()
    k_dw = kernels.hash_bake_dw(table3, k_grad, masks32)
    p_dw = hg.bake_dw_plain(table3, k_grad, masks)
    torch.testing.assert_close(k_dw, p_dw, rtol=1e-5, atol=0)
    assert (k_dxyz - p_dxyz).abs().max() <= 1e-4 * p_dxyz.abs().max()
    # the autograd path launches the same kernels
    t = table.clone().requires_grad_(True)
    s = scene.clone().requires_grad_(True)
    before = kernels.launch_counts()
    out = hg.hashgrid_encode_folded(spec, t, xyz, s)
    dt, ds = torch.autograd.grad(out, (t, s), g)
    after = kernels.launch_counts()
    for name in ('hash_bake', 'hash_encode', 'hash_encode_bwd',
                 'hash_bake_bwd', 'hash_bake_dw'):
        assert after[name] == before[name] + 1, name
    assert ((dt.reshape(table3.shape) - p_dt).abs()
            <= 1e-5 * abs_dt + 1e-7).all()
    assert torch.isfinite(ds).all() and (ds != 0).any()


@pytest.mark.parametrize('levels,channels,log2', [
    (4, 4, 14), (16, 8, 14), (4, 8, 8), (1, 4, 8), (1, 8, 14), (16, 4, 8)])
def test_paired_hash_kernels_match_plain(cuda, levels, channels, log2):
    """K5 (a)-(d) against the plain versions, tolerances as K2 / K3: bake
    1e-6; the encode K5b equal (error 0: the same float32 operations in
    the same order), zeros at points outside the bounds, which lie among
    in-bounds points of the same warp, and everywhere under an
    out-of-bounds scene code; G and dT per slot 1e-5 of the sum of
    absolute contributions + 1e-7 (atomics), dw rtol 1e-5 (float64 sums),
    dxyz 1e-4 of its largest magnitude. The point count is no multiple of
    a block; the 2^8-row tables make pairs that wrap at the last row
    common."""
    # one level: the finest level of the others
    res = dict(desired_resolution=2048) if levels > 1 \
        else dict(base_resolution=2048)
    spec = hg.HashGridSpec.create(input_dim=5, num_levels=levels,
                                  level_dim=channels,
                                  log2_hashmap_size=log2,
                                  hash_variant='paired', **res)
    gen = torch.Generator(device=cuda).manual_seed(2)
    n = 50003
    table = torch.rand((spec.table_size, channels), generator=gen,
                       device=cuda) * 2 - 1
    xyz = torch.rand((n, 3), generator=gen, device=cuda) * 2.2 - 1.1
    xyz[:4] = torch.tensor([-1.0, 1.0, 0.0, 1.0], device=cuda)[:, None]
    xyz[4], xyz[5] = 0.25, 1.5
    g = torch.randn((n, levels * channels), generator=gen, device=cuda)
    scene = torch.tensor([0.3, -0.6], device=cuda)
    shifts, weights, oob = hg.scene_fold_weights(spec, scene)
    shifts32 = shifts.to(torch.int32)
    table3 = table.reshape(levels, -1, channels)
    slots = table3.shape[1]
    scales, off = hg._scales(spec, cuda), hg._offset(spec)
    baked = kernels.hash_shift_bake(table3, shifts32, weights)
    torch.testing.assert_close(
        baked, hg.shift_bake_plain(table3, shifts, weights), rtol=0,
        atol=1e-6)
    got = kernels.hash_encode_paired(baked, xyz, scales, off, 1.0, oob)
    want = hg.paired_encode_plain(baked, xyz, scales, off, 1.0, oob)
    assert torch.equal(got, want)
    assert want.abs().max() > 0.1
    outside = (xyz.abs() > 1.0).any(-1)
    assert outside[5] and not outside[:5].any() and (got[outside] == 0).all()
    assert (kernels.hash_encode_paired(baked, xyz, scales, off, 1.0, True)
            == 0).all()
    if log2 == 8:       # pairs whose base is the last row wrap to row 0
        x01 = ((xyz + 1.0) / 2.0)[~outside]
        assert any(int((hg._corners(x01, scales[lv], off, slots,
                                    'paired')[0][0] == slots - 1).sum())
                   for lv in range(levels))

    k_grad, k_dxyz = kernels.hash_encode_paired_bwd(
        g, xyz, scales, off, 1.0, oob, slots, baked)
    p_grad, p_dxyz = hg.paired_encode_bwd_plain(g, xyz, scales, off, 1.0,
                                                oob, slots, baked)
    abs_grad, _ = hg.paired_encode_bwd_plain(g.abs(), xyz, scales, off, 1.0,
                                             oob, slots)
    assert ((k_grad - p_grad).abs() <= 1e-5 * abs_grad + 1e-7).all()
    inv32 = ((slots - shifts) & (slots - 1)).to(torch.int32)
    k_dt = kernels.hash_shift_bake(k_grad, inv32, weights,
                                   'hash_shift_bake_bwd')
    p_dt = hg.shift_bake_plain(p_grad, inv32.long(), weights)
    abs_dt = hg.shift_bake_plain(abs_grad, inv32.long(), weights)
    assert ((k_dt - p_dt).abs() <= 1e-5 * abs_dt + 1e-7).all()
    k_dw = kernels.hash_shift_bake_dw(table3, k_grad, shifts32)
    p_dw = hg.shift_bake_dw_plain(table3, k_grad, shifts)
    torch.testing.assert_close(k_dw, p_dw, rtol=1e-5, atol=0)
    assert (k_dxyz - p_dxyz).abs().max() <= 1e-4 * p_dxyz.abs().max()
    # the autograd path launches the paired kernels and no xor kernel
    t = table.clone().requires_grad_(True)
    s = scene.clone().requires_grad_(True)
    before = kernels.launch_counts()
    out = hg.hashgrid_encode_folded(spec, t, xyz, s)
    dt, ds = torch.autograd.grad(out, (t, s), g)
    after = kernels.launch_counts()
    for name in ('hash_shift_bake', 'hash_encode_paired',
                 'hash_encode_paired_bwd', 'hash_shift_bake_bwd',
                 'hash_shift_bake_dw'):
        assert after[name] == before[name] + 1, name
    for name in ('hash_bake', 'hash_encode', 'hash_encode_bwd',
                 'hash_bake_bwd', 'hash_bake_dw'):
        assert after[name] == before[name], name
    assert ((dt.reshape(table3.shape) - p_dt).abs()
            <= 1e-5 * abs_dt + 1e-7).all()
    assert torch.isfinite(ds).all() and (ds != 0).any()


@pytest.mark.parametrize('levels,slots,channels,corners', [
    (16, 1 << 14, 8, 4), (3, 16, 4, 1), (2, 1 << 10, 8, 8), (5, 1 << 12, 4, 3),
    (4, 1 << 9, 8, 2)])
def test_shift_bake_dw_matches_plain_and_repeats(cuda, levels, slots,
                                                 channels, corners):
    """K5 (d)'s dw against its plain version, rtol 1e-5 (float64 sums on
    both sides, in another order), and bitwise equal across two launches
    (a fixed reduction order). 1 to 8 corners, shifts of 0 and S - 1, a
    level smaller than one block's span (16 rows) and the test's widest
    shape, 16 x 2^14 x 8."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    table3 = torch.rand((levels, slots, channels), generator=gen,
                        device=cuda) * 2 - 1
    grad = torch.randn((levels, slots, channels), generator=gen, device=cuda)
    shifts = torch.randint(0, slots, (levels, corners), generator=gen,
                           device=cuda, dtype=torch.int32)
    shifts[::2, 0] = 0
    shifts[1::2, -1] = slots - 1
    got = kernels.hash_shift_bake_dw(table3, grad, shifts)
    want = hg.shift_bake_dw_plain(table3, grad, shifts.long())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert torch.equal(kernels.hash_shift_bake_dw(table3, grad, shifts), got)


@pytest.mark.parametrize('levels,slots,channels,corners', [
    (16, 1 << 14, 8, 4), (3, 16, 4, 1), (2, 1 << 10, 8, 8), (5, 1 << 12, 4, 3),
    (4, 1 << 9, 8, 2)])
def test_hash_bake_dw_matches_plain_and_repeats(cuda, levels, slots,
                                                channels, corners):
    """K3 (c)'s dw on the shared skeleton (`csrc/bake_dw.cuh`, the xor
    window) against its plain version, rtol 1e-5, and bitwise equal
    across two launches; the cases of K5 (d)'s test above, with xor
    masks 0 and S - 1."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    table3 = torch.rand((levels, slots, channels), generator=gen,
                        device=cuda) * 2 - 1
    grad = torch.randn((levels, slots, channels), generator=gen, device=cuda)
    masks = torch.randint(0, slots, (levels, corners), generator=gen,
                          device=cuda, dtype=torch.int32)
    masks[::2, 0] = 0
    masks[1::2, -1] = slots - 1
    got = kernels.hash_bake_dw(table3, grad, masks)
    want = hg.bake_dw_plain(table3, grad, masks.long())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert torch.equal(kernels.hash_bake_dw(table3, grad, masks), got)


@pytest.mark.parametrize('kw', [
    # level 0 tiled at 5^5 -> 3128 rows (not a power of two), the rest
    # hashed at 2^12; C = 8, float4 rows
    dict(input_dim=5, num_levels=8, level_dim=8, base_resolution=4,
         log2_hashmap_size=12, desired_resolution=512),
    # tiled past the stride cut-off, aligned corners, C = 2 (float2)
    dict(input_dim=3, num_levels=6, level_dim=2, base_resolution=4,
         log2_hashmap_size=8, desired_resolution=256, gridtype='tiled',
         align_corners=True),
    # the paired (add) hash, C = 4
    dict(input_dim=2, num_levels=5, level_dim=4, base_resolution=8,
         log2_hashmap_size=9, desired_resolution=2048, hash_variant='paired'),
    # seven dimensions, C = 1 (scalar rows)
    dict(input_dim=7, num_levels=3, level_dim=1, base_resolution=2,
         log2_hashmap_size=12, desired_resolution=8),
    # each shape the forward dispatches to, with every level kind it takes
    # the generator's shape: level 0 tiled at 9^5 -> 59056 rows (not a
    # power of two; its index cannot reach the size), the rest hashed
    dict(input_dim=5, num_levels=6, level_dim=8, base_resolution=8,
         log2_hashmap_size=16, desired_resolution=256),
    dict(input_dim=5, num_levels=4, level_dim=8, base_resolution=8,
         log2_hashmap_size=14, desired_resolution=64, hash_variant='paired'),
    # aligned corners: level 0's tiled index (7^5 -> 16808 rows) wraps
    dict(input_dim=5, num_levels=3, level_dim=8, base_resolution=7,
         log2_hashmap_size=16, desired_resolution=64, align_corners=True),
    # get_encoder's shapes at C = 2: tiled (1336 rows; wrapping; past the
    # cut-off) with aligned corners, and tiled (4920 rows) then hashed
    dict(input_dim=3, num_levels=6, level_dim=2, base_resolution=4,
         log2_hashmap_size=12, desired_resolution=512, gridtype='tiled',
         align_corners=True),
    dict(input_dim=3, num_levels=6, level_dim=2, base_resolution=16,
         log2_hashmap_size=14, desired_resolution=1024),
    # the generic kernel: D = 1, D = 7, and D = 3 at C = 8
    dict(input_dim=1, num_levels=5, level_dim=4, base_resolution=16,
         log2_hashmap_size=6, desired_resolution=4096),
    dict(input_dim=7, num_levels=2, level_dim=2, base_resolution=2,
         log2_hashmap_size=10, desired_resolution=4),
    dict(input_dim=3, num_levels=4, level_dim=8, base_resolution=7,
         log2_hashmap_size=12, desired_resolution=128, align_corners=True),
], ids=['d5_c8', 'd3_tiled_c2', 'd2_paired_c4', 'd7_c1',
        'fixed_d5_c8', 'fixed_d5_c8_paired', 'fixed_d5_c8_aligned',
        'fixed_d3_c2_tiled_aligned', 'fixed_d3_c2_hash', 'generic_d1_c4',
        'generic_d7_c2', 'generic_d3_c8_aligned'])
def test_general_hash_kernels_match_plain(cuda, kw):
    """K4 (a)/(b) against the plain versions on every shape the forward
    dispatches to (the compile-time D = 5 / C = 8 and D = 3 / C = 2
    kernels and the generic one): the forward 1e-6 (same float32
    operations in the same order), zeros at points outside the bounds; G
    per row 1e-5 of the sum of absolute contributions + 1e-7 (atomics add
    in a run-dependent order), dx 1e-4 of its largest magnitude (float32
    atomics over the levels); the autograd path launches each kernel
    once. The point count is no multiple of a block."""
    spec = hg.HashGridSpec.create(**kw)
    levels = hg.general_levels(spec)
    if spec.input_dim == 5 and spec.hash_variant == 'xor':
        assert levels[0].size & (levels[0].size - 1) and not levels[0].hashed
        assert levels[1].hashed
    gen = torch.Generator(device=cuda).manual_seed(4)
    n = 20003 if spec.input_dim == 7 else 50003
    table = torch.rand((spec.table_size, spec.level_dim), generator=gen,
                       device=cuda) * 2 - 1
    x = torch.rand((n, spec.input_dim), generator=gen, device=cuda) \
        * 2.2 - 1.1
    x[:4] = torch.tensor([-1.0, 1.0, 0.0, 1.0], device=cuda)[:, None]
    x[-1] = 1.5
    g = torch.randn((n, spec.output_dim), generator=gen, device=cuda)
    meta, scales = hg.general_meta(spec)
    off, xor = hg._offset(spec), spec.hash_variant == 'xor'
    got = kernels.hash_encode_general(table, x, meta, scales, off, 1.0, xor)
    want = hg.encode_general_plain(spec, table, x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert want.abs().max() > 0.1
    oob = (x.abs() > 1.0).any(-1)
    assert oob.any() and (got[oob] == 0).all()
    rows = spec.table_size
    k_grad, k_dx = kernels.hash_encode_general_bwd(
        g, x, meta, scales, off, 1.0, xor, rows, table)
    p_grad, p_dx = hg.encode_general_bwd_plain(spec, g, x, 1.0, rows, table)
    abs_grad, _ = hg.encode_general_bwd_plain(spec, g.abs(), x, 1.0, rows)
    assert ((k_grad - p_grad).abs() <= 1e-5 * abs_grad + 1e-7).all()
    assert (k_dx - p_dx).abs().max() <= 1e-4 * p_dx.abs().max()
    t = table.clone().requires_grad_(True)
    p = x.clone().requires_grad_(True)
    before = kernels.launch_counts()
    out = hg.hashgrid_encode(spec, t, p)
    dt, dx = torch.autograd.grad(out, (t, p), g)
    after = kernels.launch_counts()
    for name in ('hash_encode_general', 'hash_encode_general_bwd'):
        assert after[name] == before[name] + 1, name
    assert ((dt - p_grad).abs() <= 1e-5 * abs_grad + 1e-7).all()
    assert (dx - p_dx).abs().max() <= 1e-4 * p_dx.abs().max()


@pytest.mark.parametrize('channels', [4, 8])
@pytest.mark.parametrize('scene_oob', [False, True])
def test_folded_encode_edges_match_plain(cuda, channels, scene_oob):
    """K2 (b) on a point count that is no multiple of a block, points on
    and outside the bounds, and an out-of-bounds scene code (every
    feature zero), against the plain version, 1e-6."""
    spec = hg.HashGridSpec.create(input_dim=5, num_levels=5,
                                  level_dim=channels, log2_hashmap_size=12,
                                  desired_resolution=512)
    gen = torch.Generator(device=cuda).manual_seed(9)
    baked = torch.rand((spec.num_levels, 2 ** 12, channels), generator=gen,
                       device=cuda) * 2 - 1
    xyz = torch.rand((4099, 3), generator=gen, device=cuda) * 2.2 - 1.1
    xyz[:4] = torch.tensor([-1.0, 1.0, 0.0, 1.0], device=cuda)[:, None]
    scales, off = hg._scales(spec, cuda), hg._offset(spec)
    got = kernels.hash_encode(baked, xyz, scales, off, 1.0, scene_oob)
    want = hg.encode_plain(baked, xyz, scales, off, 1.0, scene_oob)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    oob = (xyz.abs() > 1.0).any(-1)
    assert (got[oob] == 0).all() and oob.any()
    assert (got == 0).all() if scene_oob else got.abs().max() > 0.1


@pytest.mark.parametrize('variant', ['xor', 'paired'])
@pytest.mark.parametrize('scene_oob', [False, True])
def test_hash_ops_launch_the_kernels(cuda, variant, scene_oob):
    """The `sd::` ops on CUDA tensors: the bake and the encode (the
    out-of-bounds flag a 0-d bool tensor on the card) equal the kernel
    wrappers with the flag on the host, bit for bit, and each op adds
    one launch to its kernel's count; K4 (a)'s op equals its wrapper."""
    from scenedreamer_tpu_torch.ops import hash_ops
    spec = hg.HashGridSpec.create(input_dim=5, num_levels=5, level_dim=8,
                                  log2_hashmap_size=12,
                                  desired_resolution=512,
                                  hash_variant=variant)
    gen = torch.Generator(device=cuda).manual_seed(3)
    table3 = torch.rand((spec.num_levels, 2 ** 12, 8), generator=gen,
                        device=cuda) * 2 - 1
    masks, weights, _ = hg.scene_fold_weights(
        spec, torch.tensor([0.3, -0.6], device=cuda))
    xyz = torch.rand((4099, 3), generator=gen, device=cuda) * 2.2 - 1.1
    scales, off = hg._scales(spec, cuda), hg._offset(spec)
    oob = torch.tensor(scene_oob, device=cuda)
    paired = variant == 'paired'
    bake_op = hash_ops.hash_shift_bake if paired else hash_ops.hash_bake
    enc_op = hash_ops.hash_encode_paired if paired else hash_ops.hash_encode
    bake = kernels.hash_shift_bake if paired else kernels.hash_bake
    enc = kernels.hash_encode_paired if paired else kernels.hash_encode
    kernels.reset_launch_counts()
    baked = bake_op(table3, masks, weights)
    got = enc_op(baked, xyz, scales, off, 1.0, oob)
    counts = kernels.launch_counts()
    assert counts[bake.__name__] == 1 and counts[enc.__name__] == 1, counts
    assert sum(counts.values()) == 2, counts
    assert torch.equal(baked, bake(table3, masks.to(torch.int32), weights))
    assert torch.equal(got, enc(baked, xyz, scales, off, 1.0, scene_oob))
    assert (got == 0).all() if scene_oob else got.abs().max() > 0.1
    # the encode's backward takes the flag tensor too, without a host read
    b = baked.clone().requires_grad_(True)
    p = xyz.clone().requires_grad_(True)
    out = hg.HashEncode.apply(b, p, scales, off, 1.0, oob, variant)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    d_b, d_p = torch.autograd.grad(out, (b, p), g)
    bwd = kernels.hash_encode_paired_bwd if paired \
        else kernels.hash_encode_bwd
    w_b, w_p = bwd(g, xyz, scales, off, 1.0, scene_oob, 2 ** 12, baked)
    assert torch.equal(d_b, w_b) if scene_oob else \
        ((d_b - w_b).abs().max() <= 1e-4 * w_b.abs().max())
    assert torch.equal(d_p, w_p) if scene_oob else \
        ((d_p - w_p).abs().max() <= 1e-4 * w_p.abs().max())
    assert (d_b == 0).all() == scene_oob
    gspec = hg.HashGridSpec.create(input_dim=5, num_levels=4, level_dim=8,
                                   log2_hashmap_size=14,
                                   base_resolution=4, hash_variant=variant)
    table = torch.rand((gspec.table_size, 8), generator=gen,
                       device=cuda) * 2 - 1
    x = torch.rand((4099, 5), generator=gen, device=cuda) * 2.2 - 1.1
    args = (*hg.general_meta(gspec), hg._offset(gspec), 1.0, not paired)
    assert torch.equal(hash_ops.hash_encode_general(table, x, *args),
                       kernels.hash_encode_general(table, x, *args))


def _scatter_points(case, n, dims, scales, gen, dev):
    """Points [n, dims] for the coarse-path tests: 'overflow' uniform in
    [-1.1, 1.1] (a block's points touch more rows than its table holds), 'one_cell' inside one cell of every level, 'rays' 25 samples
    along each of n / 25 random rays, ray after ray, as training orders
    its points."""
    if case == 'overflow':
        return torch.rand((n, dims), generator=gen, device=dev) * 2.2 - 1.1
    if case == 'one_cell':
        width = 1e-3 / float(max(scales))
        while True:
            lo = torch.rand((dims,), generator=gen, device=dev) * 0.8 + 0.1
            cells = [torch.floor(v * float(s) + 0.5)
                     for v in (lo - width, lo + 2 * width) for s in scales]
            half = len(cells) // 2
            if all(torch.equal(a, b)
                   for a, b in zip(cells[:half], cells[half:])):
                break
        x01 = lo + torch.rand((n, dims), generator=gen, device=dev) * width
        return (x01 * 2 - 1).contiguous()
    rays = n // 25
    ori = torch.rand((rays, 1, dims), generator=gen, device=dev) * 2 - 1
    d = torch.randn((rays, 1, dims), generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.sort(torch.rand((rays, 25, 1), generator=gen, device=dev)
                   * 0.2, dim=1).values
    return (ori + t * d).reshape(-1, dims).contiguous()


@pytest.mark.parametrize('channels', [4, 8])
@pytest.mark.parametrize('case', ['overflow', 'one_cell', 'rays'])
def test_hash_backward_coarse_path_matches_plain(cuda, case, channels):
    """K3a with every level on the coarse path (warp sums, a shared-memory
    table per block, one flush per row and block), and with every level
    on the direct path, against the plain version: G per slot 1e-5 of the
    sum of absolute contributions + 1e-7, dxyz 1e-4 of its largest
    magnitude, as the direct test. 'overflow' must send inserts past the
    tables to the global atomics; 'one_cell' must flush each level's
    corner rows (8, fewer where two hash alike) once per block and
    overflow none."""
    spec = hg.HashGridSpec.create(input_dim=5, num_levels=4,
                                  level_dim=channels, log2_hashmap_size=14,
                                  desired_resolution=256)
    gen = torch.Generator(device=cuda).manual_seed(5)
    scales, off = hg._scales(spec, cuda), hg._offset(spec)
    n, slots = 50000, spec.table_size // 4
    xyz = _scatter_points(case, n, 3, scales.tolist(), gen, cuda)
    g = torch.randn((n, spec.output_dim), generator=gen, device=cuda)
    baked = torch.rand((4, slots, channels), generator=gen,
                       device=cuda) * 2 - 1
    p_grad, p_dxyz = hg.encode_bwd_plain(g, xyz, scales, off, 1.0, False,
                                         slots, baked)
    abs_grad, _ = hg.encode_bwd_plain(g.abs(), xyz, scales, off, 1.0, False,
                                      slots)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    for cms in (math.inf, kernels.DIRECT_ONLY):
        k_grad, k_dxyz = kernels.hash_encode_bwd_split(
            g, xyz, scales, off, 1.0, False, slots, baked, cms,
            stats if cms == math.inf else None)
        assert ((k_grad - p_grad).abs() <= 1e-5 * abs_grad + 1e-7).all()
        assert (k_dxyz - p_dxyz).abs().max() <= 1e-4 * p_dxyz.abs().max()
    flushed, overflowed = stats.tolist()
    blocks = -(-n // BLOCK_POINTS)
    if case == 'overflow':
        assert overflowed > 0
    elif case == 'one_cell':
        x01 = (xyz + 1) / 2
        rows = sum(torch.unique(torch.cat(hg._corners(
            x01, scales[lv], off, slots)[0])).numel() for lv in range(4))
        assert (flushed, overflowed) == (blocks * rows, 0)
    else:
        assert 0 < flushed < n * 8 * 4


def _exact_folded_grad(g, xyz, scales, off, slots, variant):
    """The folded table scatter [L, slots, C] summed in float64 from the
    plain version's rows and float32 weights."""
    lv, c = scales.shape[0], g.shape[1] // scales.shape[0]
    x01 = (xyz + 1.0) / 2.0
    ok = ((x01 >= 0) & (x01 <= 1)).all(-1)
    x01, g = x01[ok], g[ok].double()
    out = torch.zeros((lv, slots, c), dtype=torch.float64, device=g.device)
    for level in range(lv):
        idx, ws, _ = hg._corners(x01, scales[level], off, slots, variant)
        for i, wt in zip(idx, ws):
            out[level].index_add_(0, i, wt.double()[:, None]
                                  * g[:, level * c:(level + 1) * c])
    return out


@pytest.mark.parametrize('channels', [4, 8])
@pytest.mark.parametrize('case', ['overflow', 'one_cell', 'shuffled'])
def test_paired_backward_coarse_path_matches_exact(cuda, case, channels):
    """K5c with every level on the coarse path, and with every level on
    the direct path, against the float64 sum of the same terms: G per row
    1e-5 of the sum of absolute contributions + 1e-7 (float32 atomics in a
    run-dependent order), dxyz 1e-4 of its largest magnitude; 'shuffled'
    is the rays case in a random order. 'overflow' must send inserts past
    the tables to the global atomics; 'one_cell' must flush each level's
    rows (8: 4 pairs of adjacent rows, fewer where two coincide) once per
    block and overflow none. The 2^10-row levels make pairs that wrap at
    the last row common."""
    spec = hg.HashGridSpec.create(input_dim=5, num_levels=4,
                                  level_dim=channels, log2_hashmap_size=10,
                                  desired_resolution=256,
                                  hash_variant='paired')
    gen = torch.Generator(device=cuda).manual_seed(9)
    scales, off = hg._scales(spec, cuda), hg._offset(spec)
    n, slots = 50000, spec.table_size // 4
    xyz = _scatter_points('rays' if case == 'shuffled' else case, n, 3,
                          scales.tolist(), gen, cuda)
    if case == 'shuffled':
        xyz = xyz[torch.randperm(n, generator=gen, device=cuda)].contiguous()
    g = torch.randn((n, spec.output_dim), generator=gen, device=cuda)
    baked = torch.rand((4, slots, channels), generator=gen,
                       device=cuda) * 2 - 1
    want = _exact_folded_grad(g, xyz, scales, off, slots, 'paired')
    _, p_dxyz = hg.paired_encode_bwd_plain(g, xyz, scales, off, 1.0, False,
                                           slots, baked)
    abs_grad, _ = hg.paired_encode_bwd_plain(g.abs(), xyz, scales, off, 1.0,
                                             False, slots)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    for cms in (math.inf, kernels.DIRECT_ONLY):
        k_grad, k_dxyz = kernels.hash_encode_paired_bwd_split(
            g, xyz, scales, off, 1.0, False, slots, baked, cms,
            stats if cms == math.inf else None)
        assert ((k_grad.double() - want).abs()
                <= 1e-5 * abs_grad + 1e-7).all(), cms
        assert (k_dxyz - p_dxyz).abs().max() <= 1e-4 * p_dxyz.abs().max()
    flushed, overflowed = stats.tolist()
    if case == 'overflow':
        assert overflowed > 0
    elif case == 'one_cell':
        x01 = (xyz + 1) / 2
        rows = sum(torch.unique(torch.cat(hg._corners(
            x01, scales[lv], off, slots, 'paired')[0])).numel()
            for lv in range(4))
        assert (flushed, overflowed) == (-(-n // BLOCK_POINTS) * rows, 0)
    else:
        assert 0 < flushed < n * 8 * 4
    # the default split sends every level of this spec down the coarse path
    assert all(kernels.coarse_levels(scales.tolist()))


@pytest.mark.parametrize('channels', [2, 4, 8])
@pytest.mark.parametrize('case', ['overflow', 'one_cell'])
def test_general_backward_coarse_path_matches_plain(cuda, case, channels):
    """K4b with every level on the coarse path, and with every level on
    the direct path, against the plain version, tolerances as
    `test_general_hash_kernels_match_plain`: D=5 points whose last two
    coordinates (the generator's scene code) are one constant, a tiled
    level 0 and hashed levels above."""
    spec = hg.HashGridSpec.create(input_dim=5, num_levels=3,
                                  level_dim=channels, base_resolution=4,
                                  log2_hashmap_size=12,
                                  desired_resolution=64)
    gen = torch.Generator(device=cuda).manual_seed(6)
    meta, scales = hg.general_meta(spec)
    off, rows, n = hg._offset(spec), spec.table_size, 50000
    x = torch.cat([_scatter_points(case, n, 3, scales.tolist(), gen, cuda),
                   torch.tensor([[0.37, -0.52]], device=cuda).expand(n, 2)],
                  dim=-1).contiguous()
    table = torch.rand((rows, channels), generator=gen, device=cuda) * 2 - 1
    g = torch.randn((n, spec.output_dim), generator=gen, device=cuda)
    p_grad, p_dx = hg.encode_general_bwd_plain(spec, g, x, 1.0, rows, table)
    abs_grad, _ = hg.encode_general_bwd_plain(spec, g.abs(), x, 1.0, rows)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    for cms in (math.inf, kernels.DIRECT_ONLY):
        k_grad, k_dx = kernels.hash_encode_general_bwd_split(
            g, x, meta, scales, off, 1.0, True, rows, table, True, cms,
            stats if cms == math.inf else None)
        assert ((k_grad - p_grad).abs() <= 1e-5 * abs_grad + 1e-7).all()
        assert (k_dx - p_dx).abs().max() <= 1e-4 * p_dx.abs().max()
    flushed, overflowed = stats.tolist()
    if case == 'overflow':
        assert overflowed > 0
    else:       # each level's corner rows once per block
        x01 = (x + 1) / 2
        rows = sum(torch.unique(torch.cat(hg._general_corners(
            x01, lv, off, 'xor')[0])).numel()
            for lv in hg.general_levels(spec))
        assert (flushed, overflowed) == (-(-n // BLOCK_POINTS) * rows, 0)


def test_general_hash_kernel_rejects_bad_input(cuda):
    spec = hg.HashGridSpec.create(input_dim=3, num_levels=2, level_dim=3,
                                  log2_hashmap_size=8)
    meta, scales = hg.general_meta(spec)
    table = torch.zeros((spec.table_size, 3), device=cuda)
    with pytest.raises(ValueError):        # C = 3 has no kernel
        kernels.hash_encode_general(table, torch.zeros((4, 3), device=cuda),
                                    meta, scales, 0.5, 1.0, True)
    with pytest.raises(ValueError):        # a level outside the table
        kernels.hash_encode_general(torch.zeros((10, 2), device=cuda),
                                    torch.zeros((4, 3), device=cuda), meta,
                                    scales, 0.5, 1.0, True)


def test_padded_tile_frame_matches_cpu(cuda):
    """A padded-tile frame (`split_refine=False`; the DDA, bake and
    encode kernels, 3 tiles per batch with a short last group) on the card
    against the same frame on the CPU through the plain versions: image
    within 1e-3 as the golden frames, depth within 1e-3 where finite as
    `chip_smoke.py` phase 4 holds it (float32 GEMM order moves depths of
    ~50 by up to ~7e-4)."""
    from scenedreamer_tpu_torch.data.synthetic import make_world
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    cfg = GeneratorConfig(style_dims=16, interm_style_dims=32,
                          final_feat_dim=8, num_blocks_early_stop=4,
                          num_samples=6, hash_num_levels=4, hash_level_dim=4,
                          hash_log2_size=10, hash_desired_resolution=128,
                          mlp_hidden=32, style_enc_num_filters=8)
    pose = EvalCameraController(world, maxstep=4, pattern=0)[0]
    style = np.random.default_rng(5).standard_normal((1, 16)).astype(
        np.float32)
    out = {}
    for dev in ('cpu', cuda):
        model = SceneDreamerGenerator(cfg, seed=3)
        r = TiledRenderer(model, world, num_samples=6, num_blocks_early_stop=4,
                          pad=6, tile_size=16, resolution_hw=(32, 48),
                          split_refine=False, tiles_per_batch=4, device=dev)
        out[str(dev)] = r.frame(pose, r.style_z(style), return_aux=True)
    (img_c, aux_c), (img_g, aux_g) = out['cpu'], out['cuda']
    np.testing.assert_allclose(img_g, img_c, atol=1e-3, rtol=0)
    fin = np.isfinite(aux_c['depth'])
    assert (np.isfinite(aux_g['depth']) == fin).all()
    np.testing.assert_allclose(aux_g['depth'][fin], aux_c['depth'][fin],
                               atol=1e-3, rtol=0)
    np.testing.assert_array_equal(aux_g['first_voxel_id'],
                                  aux_c['first_voxel_id'])


def _syncs_outside_reads(fn):
    """Run `fn` under `torch.cuda.set_sync_debug_mode('warn')`, the
    recorder on: (the innermost span of each synchronising call, the
    innermost span and the stack of each made outside a read or upload
    span)."""
    import traceback
    import warnings
    from scenedreamer_tpu_torch.utils import profiling
    seen, outside = [], []

    def hook(message, *args, **kwargs):
        if 'called a synchronizing CUDA operation' in str(message):
            cur = profiling.current()
            seen.append(cur)
            if cur is None or cur.kind not in ('read', 'upload'):
                outside.append(f'{None if cur is None else cur.name}: '
                               f'{message}\n'
                               + ''.join(traceback.format_stack(limit=14)))
    profiling.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('always')
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode('warn')
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        profiling.disable()
        profiling.take()
    return seen, outside


def test_every_sync_of_a_frame_and_a_step_is_in_a_read_span(cuda):
    """One split-refine `frame_async` and its fetch, and one
    `train_step_shared`, of tiny models on the card: every call that
    synchronises the device is made inside a span of the recorder that
    waits on purpose: a read (the hit counts, the fetch, the clip and
    metrics reads) or an upload from pageable memory; and there are
    some."""
    from scenedreamer_tpu_torch.data.synthetic import make_batch, make_world
    from scenedreamer_tpu_torch.models.discriminator import \
        GANcraftDiscriminator
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    from scenedreamer_tpu_torch.train.losses import PerceptualLoss
    from scenedreamer_tpu_torch.train.trainer import GANTrainer
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    cfg = GeneratorConfig(style_dims=16, interm_style_dims=32,
                          final_feat_dim=8, pad=2, num_blocks_early_stop=4,
                          num_samples=6, hash_num_levels=4, hash_level_dim=4,
                          hash_log2_size=10, hash_desired_resolution=128,
                          mlp_hidden=32, style_enc_num_filters=8)
    model = SceneDreamerGenerator(cfg, seed=3).to(cuda)
    r = TiledRenderer(model, world, num_samples=6, num_blocks_early_stop=4,
                      pad=6, tile_size=16, resolution_hw=(32, 48),
                      chunk_rays=300, split_refine=True, device=cuda)
    poses = EvalCameraController(world, maxstep=4, pattern=0)
    z = r.style_z(np.random.default_rng(5).standard_normal((1, 16)))
    gens = [torch.Generator(device=cuda).manual_seed(i) for i in range(3)]
    r.frame_async(poses[0], z, gens[0], return_aux=True)()   # warm-up
    prev = r.frame_async(poses[1], z, gens[1], return_aux=True)

    def frame():
        nxt = r.frame_async(poses[2], z, gens[2], return_aux=True)
        prev()
        nxt()
    seen, outside = _syncs_outside_reads(frame)
    assert seen
    if outside:
        pytest.fail('\n\n'.join(outside))

    trainer = GANTrainer(model.train(), GANcraftDiscriminator(12, 8).to(cuda),
                         world.dims, perceptual=PerceptualLoss(
                             layers=('relu_2_1',), weights=(1.0,)).to(cuda))
    batch = make_batch(world, 2, 34, 34, 4, 2, device=cuda)
    draws = torch.Generator(device=cuda).manual_seed(7)
    trainer.train_step_shared(batch, draws)                  # warm-up
    seen, outside = _syncs_outside_reads(
        lambda: trainer.train_step_shared(batch, draws))
    assert seen
    if outside:
        pytest.fail('\n\n'.join(outside))


SERVING_CHUNK_POINTS = 1306800   # points of a served frame's field chunk


def _mlp_layer(rows, k, n, b, label, shared, gen, dev):
    """Inputs of one RenderMLP hidden layer: activations x [b, rows, k]
    (LeakyReLU outputs, so a fifth of them small and negative), a weight
    at the generator's init scale, shared by the batch (the first layer)
    or one per batch item (a ModLinear's), its shift and, with `label`
    columns, one-hot labels and their weight."""
    x = torch.randn((b, rows, k), generator=gen, device=dev)
    x = torch.where(x > 0, x, 0.2 * x)
    wshape = (n, k) if shared else (b, n, k)
    w = torch.randn(wshape, generator=gen, device=dev) * (1.4 / math.sqrt(k))
    shift = torch.randn(wshape[:-1], generator=gen, device=dev) * 0.3
    if not label:
        return x, w, shift
    ids = torch.randint(0, label, (b, rows), generator=gen, device=dev)
    m = torch.nn.functional.one_hot(ids, label).float()
    m[:, ::7] = 0                                 # rows with no label
    wm = torch.randn((n, label), generator=gen, device=dev) * 0.5
    return x, w, shift, m, wm


@pytest.mark.parametrize('rows,k,n,b,label,shared', [
    (SERVING_CHUNK_POINTS, 128, 256, 1, 12, True),     # fc_1 + fc_m_a
    (SERVING_CHUNK_POINTS, 256, 256, 1, 0, False),     # fc_2 .. fc_6
    (1000, 37, 301, 2, 0, False),                      # ragged edges
    (1000, 37, 301, 2, 5, True),
    (77, 256, 45, 2, 12, False),
])
def test_render_mlp_gemm_matches_plain(cuda, rows, k, n, b, label, shared):
    """K6 against its plain composition (cuBLAS GEMM, adds, LeakyReLU) at
    the serving chunk's shape and at ragged edges (rows not a multiple of
    the 128-row tile, odd K and N, N past one 256-wide tile, B = 2, with
    and without the label term): within 1e-5 of the largest |y|. Both sum
    256 float32 products in different orders (accumulation order only):
    each sum's rounding reaches ~1e-6 of its terms' sum, ~1e-6 of the
    largest output at this init. The label term of a one-hot row is one
    exact weight on both sides."""
    from scenedreamer_tpu_torch.ops import mlp_ops
    gen = torch.Generator(device=cuda).manual_seed(rows + k + n + label)
    args = _mlp_layer(rows, k, n, b, label, shared, gen, cuda)
    kernels.reset_launch_counts()
    got = kernels.render_mlp_gemm(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()['render_mlp_gemm'] == 1
    want = mlp_ops.render_mlp_gemm_plain(*args)
    assert got.shape == want.shape == (b, rows, n)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    assert (got < 0).any() and (got > 1).any()
    # the op launches the same kernel
    assert torch.equal(mlp_ops.render_mlp_gemm(*args), got)
    assert kernels.launch_counts()['render_mlp_gemm'] == 2


def test_render_mlp_gemm_rejects_bad_input(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, w, shift, m, wm = _mlp_layer(300, 40, 64, 2, 12, True, gen, cuda)
    for bad, what in (
            ((x.double(), w, shift), 'must be torch.float32'),
            ((x.cpu(), w, shift), 'must be a CUDA tensor'),
            ((x, w.cpu(), shift), 'must be a CUDA tensor'),
            ((x.transpose(1, 2).contiguous().transpose(1, 2), w, shift),
             'must be contiguous'),
            ((x, w.t().contiguous().t(), shift), 'must be contiguous'),
            ((x, w, shift, m[:, :, :6].contiguous(), wm), 'm must be \\['),
            ((x, w, shift, m), 'come together'),
            ((x, w[:, :39].contiguous(), shift), 'w must be \\['),
            ((x, w, shift[:-1]), 'shift must be \\[')):
        with pytest.raises(ValueError, match=what):
            kernels.render_mlp_gemm(*bad)


def test_render_mlp_gemm_launches_per_field_chunk(cuda):
    """A served split-refine frame launches K6 six times for each field
    chunk that is not pure sky (`last_stats`), and a `train_step_shared`,
    which renders under autograd, not at all."""
    from scenedreamer_tpu_torch.data.synthetic import make_batch, make_world
    from scenedreamer_tpu_torch.models.discriminator import \
        GANcraftDiscriminator
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    from scenedreamer_tpu_torch.train.losses import PerceptualLoss
    from scenedreamer_tpu_torch.train.trainer import GANTrainer
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    cfg = GeneratorConfig(style_dims=16, interm_style_dims=32,
                          final_feat_dim=8, pad=2, num_blocks_early_stop=4,
                          num_samples=6, hash_num_levels=4, hash_level_dim=4,
                          hash_log2_size=10, hash_desired_resolution=128,
                          mlp_hidden=32, style_enc_num_filters=8)
    model = SceneDreamerGenerator(cfg, seed=3).to(cuda)
    r = TiledRenderer(model, world, num_samples=6, num_blocks_early_stop=4,
                      pad=6, tile_size=16, resolution_hw=(32, 48),
                      chunk_rays=300, split_refine=True, device=cuda)
    pose = EvalCameraController(world, maxstep=4, pattern=0)[0]
    z = r.style_z(np.random.default_rng(5).standard_normal((1, 16)))
    kernels.reset_launch_counts()
    r.frame(pose, z)
    st = r.last_stats
    chunks = st['chunks_compacted'] + st['chunks_full']
    assert chunks > 0, st
    assert kernels.launch_counts()['render_mlp_gemm'] == 6 * chunks, st

    trainer = GANTrainer(model.train(), GANcraftDiscriminator(12, 8).to(cuda),
                         world.dims, perceptual=PerceptualLoss(
                             layers=('relu_2_1',), weights=(1.0,)).to(cuda))
    batch = make_batch(world, 2, 34, 34, 4, 2, device=cuda)
    kernels.reset_launch_counts()
    trainer.train_step_shared(batch, torch.Generator(device=cuda)
                              .manual_seed(7))
    counts = kernels.launch_counts()
    assert counts['render_mlp_gemm'] == 0 and counts['hash_encode'], counts
