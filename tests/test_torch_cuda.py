"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test skips, with its reason, where CUDA is absent; on a GPU
machine run `python -m pytest tests/test_torch_cuda.py`.

K1 must equal its plain version exactly (ids, masks, t values and step
counts); K2 is expected exact as well (same float32 operations in the
same order) and is held to 1e-6."""
import numpy as np
import pytest
import torch

from scenedreamer_tpu_torch import kernels
from scenedreamer_tpu_torch.ops import hashgrid as hg
from scenedreamer_tpu_torch.ops.ray_voxel import dda_plain


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


def test_dda_kernel_rejects_bad_input(cuda):
    voxel = torch.zeros((4, 4, 4), dtype=torch.int32, device=cuda)
    dirs = torch.ones((3, 3), device=cuda)
    with pytest.raises(ValueError):
        kernels.dda(voxel, torch.zeros(3), dirs, 2, 14)


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
