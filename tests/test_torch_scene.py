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
