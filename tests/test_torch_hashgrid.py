"""The plain PyTorch scene-folded hash encode (the CPU twin of kernel K2)
against the JAX package's `hashgrid_encode_folded`, and against its
unfolded `hashgrid_encode` of the concatenated 5-D input.

Tables are uniform in [-1, 1] so a wrong row is visible; atol 1e-5 as
`test_folded_scene_encode_matches_standard` (float32 sums in another
order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scenedreamer_tpu.ops import hashgrid as jhg
from scenedreamer_tpu_torch.ops import hashgrid as thg
from _torch_parity import cap_torch_threads

cap_torch_threads()

ATOL = 1e-5
CASES = [(4, 4, 10, 128), (4, 8, 10, 128), (16, 4, 12, 2048),
         (16, 8, 12, 2048)]


def _specs(levels, channels, log2, res):
    kw = dict(input_dim=5, num_levels=levels, level_dim=channels,
              base_resolution=16, log2_hashmap_size=log2,
              desired_resolution=res)
    return jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)


def _inputs(spec, seed):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.table_size, spec.level_dim)) \
        .astype(np.float32)
    xyz = rng.uniform(-1.1, 1.1, (400, 3)).astype(np.float32)
    scene = rng.uniform(-0.9, 0.9, (2,)).astype(np.float32)
    return table, xyz, scene


@pytest.mark.parametrize('levels,channels,log2,res', CASES)
def test_folded_encode_matches_jax(levels, channels, log2, res):
    jspec, tspec = _specs(levels, channels, log2, res)
    assert thg.foldable(tspec) and jhg.foldable(jspec)
    assert tspec.table_size == jspec.table_size
    table, xyz, scene = _inputs(tspec, levels * 10 + channels)
    got = thg.hashgrid_encode_folded(tspec, torch.from_numpy(table),
                                     torch.from_numpy(xyz),
                                     torch.from_numpy(scene)).numpy()
    folded = np.asarray(jhg.hashgrid_encode_folded(
        jspec, jnp.asarray(table), jnp.asarray(xyz), jnp.asarray(scene)))
    cat = np.concatenate([xyz, np.broadcast_to(scene, (len(xyz), 2))], -1)
    unfolded = np.asarray(jhg.hashgrid_encode(jspec, jnp.asarray(table),
                                              jnp.asarray(cat)))
    assert got.shape == (len(xyz), levels * channels)
    oob = (np.abs(xyz) > 1.0).any(-1)
    assert oob.any() and (~oob).any()
    assert (got[oob] == 0).all()
    assert np.abs(got[~oob]).max() > 0.1
    np.testing.assert_allclose(got, folded, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, unfolded, atol=ATOL, rtol=0)


def test_scene_out_of_bounds_gives_zeros():
    jspec, tspec = _specs(4, 4, 10, 128)
    table, xyz, _ = _inputs(tspec, 3)
    scene = np.array([1.5, 0.2], np.float32)
    got = thg.hashgrid_encode_folded(tspec, torch.from_numpy(table),
                                     torch.from_numpy(xyz),
                                     torch.from_numpy(scene)).numpy()
    ref = np.asarray(jhg.hashgrid_encode_folded(
        jspec, jnp.asarray(table), jnp.asarray(xyz), jnp.asarray(scene)))
    assert (got == 0).all() and (ref == 0).all()


def test_bake_and_encode_split_matches_one_call():
    """A renderer bakes once per frame and encodes many chunks against
    the baked table; chunked encodes equal one encode of all points."""
    _, tspec = _specs(16, 8, 12, 2048)
    table, xyz, scene = _inputs(tspec, 5)
    t, x, s = (torch.from_numpy(a) for a in (table, xyz, scene))
    folded = thg.fold_scene(tspec, t, s)
    parts = [thg.encode_folded(tspec, folded, x[i:i + 128])
             for i in range(0, len(x), 128)]
    whole = thg.hashgrid_encode_folded(tspec, t, x, s)
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


def test_spec_geometry_matches_jax():
    for case in CASES + [(16, 8, 19, 2048)]:
        jspec, tspec = _specs(*case)
        np.testing.assert_array_equal(tspec.offsets(), jspec.offsets())
        for lv in range(tspec.num_levels):
            assert tspec.level_resolution(lv) == jspec.level_resolution(lv)
