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
