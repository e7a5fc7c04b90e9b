"""The port's terrain, voxel world and evaluation camera poses equal the
JAX package's for the same seed (both are host numpy; the port keeps
its own copies)."""
import numpy as np
import pytest

from scenedreamer_tpu.scene import camera as jcam
from scenedreamer_tpu.scene import terrain as jterrain
from scenedreamer_tpu.scene import voxel_world as jvw
from scenedreamer_tpu_torch.scene import camera as tcam
from scenedreamer_tpu_torch.scene import terrain as tterrain
from scenedreamer_tpu_torch.scene import voxel_world as tvw
from _torch_parity import cap_torch_threads

cap_torch_threads()

TERRAIN_KW = dict(size=64, seed=7, n_voronoi=20, relax_iters=2)
WORLD_KW = dict(fill_depth=8, seed=7, boundary_detect=4)


def _world(terrain, vw):
    maps = terrain.generate_terrain(**TERRAIN_KW)
    return maps, vw.build_voxel_world(maps.height_map, maps.semantic_map,
                                      maps.tree_map, **WORLD_KW)


@pytest.fixture(scope='module')
def worlds():
    return _world(jterrain, jvw), _world(tterrain, tvw)


def test_terrain_maps_equal(worlds):
    (jm, _), (tm, _) = worlds
    for name in ('height_map', 'semantic_map', 'tree_map', 'color_map'):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)


def test_voxel_world_equal(worlds):
    (_, jw), (_, tw) = worlds
    assert tw.voxel.dtype == np.int8
    assert tw.y_offset == jw.y_offset
    for name in ('voxel', 'heightmap', 'height_field', 'semantic_field'):
        np.testing.assert_array_equal(getattr(tw, name), getattr(jw, name),
                                      err_msg=name)


@pytest.mark.parametrize('pattern', range(10))
def test_eval_camera_poses_equal(worlds, pattern):
    (_, jw), (_, tw) = worlds
    jp = jcam.EvalCameraController(jw, maxstep=4, pattern=pattern)
    tp = tcam.EvalCameraController(tw, maxstep=4, pattern=pattern)
    assert len(tp) == len(jp) == 4
    for a, b in zip(tp, jp):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_local2world_and_is_sea_equal(worlds):
    """`local2world` undoes `world2local`, and `is_sea` gives JAX's
    answer on points inside the map (sea and land columns), on its edges
    and outside it (sea)."""
    (_, jw), (_, tw) = worlds
    pts = np.array([[3.0, 5.5, 7.25], [-2.0, 0.0, 63.0], [40.0, 31.0, 2.0]],
                   np.float32)
    np.testing.assert_array_equal(tw.local2world(pts), jw.local2world(pts))
    np.testing.assert_array_equal(tw.local2world(tw.world2local(pts)), pts)
    s = tw.heightmap.shape[0]
    sea = np.array([[jw.is_sea((0, x, z)) for z in range(s)]
                    for x in range(s)])
    (sx, sz), (lx, lz) = np.argwhere(sea)[0], np.argwhere(~sea)[0]
    locs = [(0, sx, sz), (5, lx, lz), (0, 0, 0), (0, s - 1, s - 1),
            (0, 0, s - 1), (0, s - 1, 0), (3, s - 1, 17), (0, 17.9, 0.5),
            (0, -1, 5), (0, 5, -1), (0, s, 5), (0, 5, s), (0, -3, s + 2)]
    got = [tw.is_sea(loc) for loc in locs]
    assert got == [jw.is_sea(loc) for loc in locs]
    assert got[0] and not got[1] and all(got[-5:])
