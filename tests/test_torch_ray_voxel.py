"""The plain PyTorch DDA (the CPU twin of kernel K1) against the JAX op
and the scalar numpy oracle, on the same numpy rays.

Voxel ids and hit masks must be equal; entry/exit t must agree with the
JAX op to rtol 1e-6 (both run the same float32 operations in the same
order) and with the float64 oracle to the 2e-4 the JAX op's own oracle
test allows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scenedreamer_tpu.data.synthetic import make_world
from scenedreamer_tpu.ops import ray_voxel as jrv
from scenedreamer_tpu.scene.camera import EvalCameraController
from scenedreamer_tpu_torch import kernels
from scenedreamer_tpu_torch.ops import ray_voxel as trv
from test_ray_voxel import dda_oracle
from _torch_parity import cap_torch_threads

cap_torch_threads()


def _both(voxel, ori, dirs, m):
    j = jrv.ray_voxel_intersection(jnp.asarray(voxel), jnp.asarray(ori),
                                   jnp.asarray(dirs), m)
    t = trv.ray_voxel_intersection(torch.tensor(voxel), torch.tensor(ori),
                                   torch.tensor(dirs), m)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_match(j, t):
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_allclose(t[1], j[1], rtol=1e-6, atol=0)
    assert t[0].dtype == np.int32 and t[2].dtype == bool


def _assert_oracle(voxel, ori, dirs, m, t):
    vid, dep, hit = t
    for ri in range(dirs.shape[0]):
        expected = dda_oracle(voxel, ori.astype(np.float64),
                              dirs[ri].astype(np.float64), m)
        assert int(hit[ri].sum()) == len(expected), ri
        for k, (blk, t0, t1) in enumerate(expected):
            assert vid[ri, k] == blk
            np.testing.assert_allclose(dep[ri, k], [t0, t1], rtol=2e-4,
                                       atol=2e-4)


def _unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_random_grid_camera_inside():
    rng = np.random.default_rng(0)
    voxel = ((rng.random((12, 16, 14)) < 0.15)
             * rng.integers(1, 600, (12, 16, 14))).astype(np.int32)
    ori = np.array([6.3, 8.1, 7.7], np.float32)
    dirs = _unit(rng, 256)
    j, t = _both(voxel, ori, dirs, 4)
    _assert_match(j, t)
    _assert_oracle(voxel, ori, dirs, 4, t)


def test_camera_outside_grid():
    rng = np.random.default_rng(7)
    dims = (48, 64, 56)
    voxel = np.zeros(dims, np.int8)
    voxel[:4] = 3
    solid = rng.integers(0, np.asarray(dims) - 1, (40, 3))
    voxel[solid[:, 0], solid[:, 1], solid[:, 2]] = 5
    ori = np.array([30.0, -10.0, 20.0], np.float32)
    th = rng.uniform(0, np.pi, 600)
    ph = rng.uniform(0, 2 * np.pi, 600)
    dirs = np.stack([np.cos(th), np.sin(th) * np.cos(ph),
                     np.sin(th) * np.sin(ph)], -1).astype(np.float32)
    j, t = _both(voxel, ori, dirs, 6)
    assert t[2].any() and not t[2].all()
    _assert_match(j, t)


def test_axis_parallel_rays():
    voxel = np.zeros((8, 10, 9), np.int32)
    voxel[2, :, :] = 5
    voxel[:, 7, :] = 4
    voxel[:, :, 1] = 6
    axes = np.eye(3, dtype=np.float32)
    diag = np.array([[0.6, 0.8, 0.0], [0.0, -0.6, 0.8], [-0.8, 0.0, 0.6]],
                    np.float32)
    dirs = np.concatenate([axes, -axes, diag, -diag])
    for ori in (np.array([4.5, 3.5, 4.5], np.float32),
                np.array([20.0, 4.2, 4.7], np.float32)):
        j, t = _both(voxel, ori, dirs, 3)
        _assert_match(j, t)
        if (ori >= 0).all() and (ori < voxel.shape).all():
            _assert_oracle(voxel, ori, dirs, 3, t)
    assert t[0][3, 0] == 5 and t[2][0].sum() == 0   # down hits, up misses


def test_int8_world_frame():
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    ori, cdir, up, f = EvalCameraController(world, maxstep=4, pattern=0)[0]
    h, w = 24, 32
    cam_f, cam_c = f * (w - 1), ((h - 1) / 2.0, (w - 1) / 2.0)
    jd = np.asarray(jrv.camera_rays(jnp.asarray(cdir), jnp.asarray(up),
                                    cam_f, cam_c, (h, w)))
    td = trv.camera_rays(cdir, up, cam_f, cam_c, (h, w)).numpy()
    np.testing.assert_allclose(td, jd, atol=1e-6, rtol=0)
    dirs = jd.reshape(-1, 3)
    assert world.voxel.dtype == np.int8
    j, t = _both(world.voxel, np.asarray(ori, np.float32), dirs, 6)
    assert t[2][:, 0].mean() > 0.2
    _assert_match(j, t)


@pytest.mark.parametrize('shape', [(5, 7), (8, 8)])
def test_camera_rays_match(shape):
    args = ([0.3, 1.0, -0.2], [1.0, 0.0, 0.1], 10.0,
            ((shape[0] - 1) / 2, (shape[1] - 1) / 2), shape)
    j = np.asarray(jrv.camera_rays(jnp.asarray(args[0]),
                                   jnp.asarray(args[1]), *args[2:]))
    t = trv.camera_rays(*args).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)


def test_step_counts_bound():
    """The per-ray step count (what kernel K1 reports for its bound)
    stays below the Y+X+Z+2 step cap on every ray."""
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    rng = np.random.default_rng(1)
    ori = torch.tensor([60.0, -5.0, 30.0])
    dirs = torch.from_numpy(_unit(rng, 400))
    vox = torch.from_numpy(world.voxel)
    *_, steps = trv.dda_plain(vox, ori, dirs, 6, with_steps=True)
    assert int(steps.max()) < sum(world.voxel.shape) + 2


def _grid_not_whole_bricks(seed=4):
    """A [29, 45, 38] int8 grid (no dim a multiple of 8): a floor, a few
    solid blocks, scattered voxels and wide empty space."""
    rng = np.random.default_rng(seed)
    vox = np.zeros((29, 45, 38), np.int8)
    vox[:2] = 3
    for c in rng.integers(0, (20, 36, 29), (4, 3)):
        vox[c[0]:c[0] + 9, c[1]:c[1] + 7, c[2]:c[2] + 10] = 11
    solid = rng.integers(0, vox.shape, (60, 3))
    vox[solid[:, 0], solid[:, 1], solid[:, 2]] = 40
    return vox


def test_occupancy_matches_jax_build_occupancy():
    """K1's packed brick bits (`kernels.occupancy_bits`, plain PyTorch,
    here on the CPU) hold JAX's `build_occupancy` flags bit for bit: on an
    int8 grid whose dims are not whole bricks, and on an int32 grid whose
    dims are (each brick row along Z then one int64 word)."""
    whole = np.zeros((24, 40, 32), np.int32)
    whole[:3] = 5
    whole[17, 9, 30] = 2
    whole[8:12, 33:40, 0:9] = 7
    for vox in (_grid_not_whole_bricks(), whole):
        want = np.asarray(jrv.build_occupancy(jnp.asarray(vox)))
        assert want.any() and not want.all()
        words = kernels.occupancy_bits(torch.from_numpy(vox))
        assert words.dtype == torch.int32
        assert words.numel() == kernels.occupancy_words(vox.shape)
        bits = (words.long()[:, None] >> torch.arange(32)) & 1
        np.testing.assert_array_equal(
            bits.reshape(-1)[:want.size].numpy().astype(bool),
            want.reshape(-1))
        assert not bits.reshape(-1)[want.size:].any()
    assert trv.build_occupancy_bits(torch.from_numpy(whole)) is None  # CPU


def test_grouped_origins_match_separate_calls_and_jax():
    """`dda_plain` (and `ray_voxel_intersection` on the CPU) with K=3
    origins of R/K rays each equals K one-origin calls and JAX's
    `ray_voxel_intersection` per origin: rays from inside and outside the
    grid, axis-parallel ones among them."""
    vox = _grid_not_whole_bricks()
    rng = np.random.default_rng(9)
    oris = np.array([[14.3, 20.6, 17.2], [35.0, -6.0, 12.5],
                     [-3.0, 50.2, 41.0]], np.float32)
    dirs = _unit(rng, 3 * 96).reshape(3, 96, 3)
    dirs[:, :6] = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    tv = torch.from_numpy(vox)
    grouped = trv.ray_voxel_intersection(tv, torch.from_numpy(oris),
                                         torch.from_numpy(dirs.reshape(-1, 3)),
                                         5)
    *_, steps = trv.dda_plain(tv, torch.from_numpy(oris),
                              torch.from_numpy(dirs.reshape(-1, 3)), 5,
                              with_steps=True)
    assert grouped[2].any() and not grouped[2].all()
    for k in range(3):
        sl = slice(96 * k, 96 * (k + 1))
        one = trv.dda_plain(tv, torch.from_numpy(oris[k]),
                            torch.from_numpy(dirs[k]), 5, with_steps=True)
        for a, b in zip([x[sl] for x in grouped] + [steps[sl]], one):
            assert torch.equal(a, b)
        j = jrv.ray_voxel_intersection(jnp.asarray(vox), jnp.asarray(oris[k]),
                                       jnp.asarray(dirs[k]), 5)
        _assert_match([np.asarray(x) for x in j],
                      [x[sl].numpy() for x in grouped])
        np.testing.assert_array_equal(grouped[1][sl].numpy(),
                                      np.asarray(j[1]))
