"""The port's mesh helpers, multi-GPU serving and multi-process training
CLI on the CPU (`scenedreamer_tpu_torch/parallel/mesh.py`,
`render/pipeline.py` mesh mode, `cli/train.py` under torchrun).

  * placement and batch cuts against the JAX package's own mesh on the
    8-device CPU mesh of `tests/conftest.py`: rank r at (r // rays,
    r % rays) as JAX lays devices out, and `shard_batch`'s piece of each
    key equal to the shard JAX puts on that device, the replicated axes
    (a batch or row count that does not divide) included;
  * mesh-mode frames over a list of CPU devices against JAX's mesh mode
    (the golden `*_mesh` frames of `test_golden.py`, rendered by JAX over
    the 8-device mesh), atol 1e-3 as the golden tests, and against the
    port's padded-tile route, which must be equal: every tile runs the
    same program;
  * the inference CLI's `--mesh_tiles`;
  * `cli.train` through `torch.distributed.run` on gloo ranks
    (`--platform cpu`), 2 ranks at data 2 and 4 at data 2 x rays 2: one
    run directory, written by rank 0, and the same parameters on every
    rank at the end (the CLI checks that itself and raises otherwise).
    The 3 pairs do not divide the data axis (the loader's stride gives
    data group 0 two and group 1 one), and a checkpoint every epoch puts
    a collective at each epoch end: the groups must keep in step."""
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from jax.sharding import NamedSharding

from scenedreamer_tpu.parallel import mesh as jpm
from scenedreamer_tpu_torch.data.synthetic import make_paired_folder
from scenedreamer_tpu_torch.parallel import mesh as pm
from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                    render_trajectory)
from scenedreamer_tpu_torch.scene import terrain, voxel_world
from _torch_parity import cap_torch_threads
from test_golden import FIXTURE, IMG_ATOL, KW, _poses
from test_torch_inference import setup  # noqa: F401  (module fixture)
from test_torch_multiprocess import free_port, run_session
from test_torch_train_cli import YAML

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKW = {k: v for k, v in KW.items() if k != 'fov'}
MESHES = [(8, 1), (4, 2), (2, 4)]


def test_all_mean_counts_the_flat_buffer(tmp_path):
    """On a one-process gloo group, `all_mean_` leaves its tensors as they
    were (the mean of one rank) and, with the recorder on, opens
    `mesh.all_mean` and counts one call of the flat float32 buffer's
    bytes, whatever the tensors' dtypes."""
    import torch.distributed as dist
    from scenedreamer_tpu_torch.utils import profiling
    dist.init_process_group('gloo', init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    tensors = [torch.arange(6.0).reshape(2, 3), torch.ones(5).half(),
               torch.tensor(2.5)]
    want = [t.clone() for t in tensors]
    try:
        pm.all_mean_(tensors)           # off: nothing recorded
        profiling.enable()
        profiling.take()
        pm.all_mean_(tensors)
        got = profiling.take()
    finally:
        profiling.disable()
        dist.destroy_process_group()
    for t, w in zip(tensors, want):
        torch.testing.assert_close(t, w, rtol=0, atol=0)
    assert got['counters'] == {'allreduce_bytes': (6 + 5 + 1) * 4,
                               'allreduce_calls': 1}
    assert [s.name for s in got['spans']] == ['mesh.all_mean']


@pytest.mark.parametrize('data, rays', MESHES)
def test_ranks_sit_where_jax_puts_devices(data, rays):
    ids = np.vectorize(lambda d: d.id)(jpm.make_mesh(rays=rays).devices)
    data_groups, rays_groups = pm.mesh_groups(data, rays)
    assert ids.shape == (data, rays)
    assert rays_groups == ids.tolist()
    assert data_groups == ids.T.tolist()
    for r in range(data * rays):
        mesh = pm.Mesh(data, rays, r // rays, r % rays)
        assert ids[mesh.data_index, mesh.rays_index] == r
        assert mesh.group_root == ids[mesh.data_index, 0]


def _host_batch(b, h):
    rng = np.random.default_rng(0)
    return {'voxel_id': rng.integers(0, 9, (b, h, 6, 4)).astype(np.int32),
            'raydirs': rng.normal(size=(b, h, 6, 3)).astype(np.float32),
            'images': rng.normal(size=(b, h - 2, 4, 3)).astype(np.float32),
            'cam_ori': rng.normal(size=(b, 3)).astype(np.float32),
            'height_field': rng.normal(size=(b, 8, 8, 1)).astype(
                np.float32)}


@pytest.mark.parametrize('data, rays', MESHES)
@pytest.mark.parametrize('b, h', [(8, 12), (2, 12), (8, 9)])
def test_shard_batch_matches_jax(data, rays, b, h):
    """(8, 12) divides every axis; a batch of 2 does not divide data
    4 / 8 and 9 (7) rows do not divide rays 2 / 4: replicated there."""
    jmesh = jpm.make_mesh(rays=rays)
    batch = _host_batch(b, h)
    sharded = jpm.shard_batch(jmesh, batch)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for key, arr in batch.items():
        assert pm.batch_spec(key, arr.shape, pm.Mesh(data, rays)) == \
            tuple(jpm.batch_spec(key, arr.shape, jmesh))
        assert isinstance(sharded[key].sharding, NamedSharding)
        shards = {s.device.id: np.asarray(s.data)
                  for s in sharded[key].addressable_shards}
        for r in range(data * rays):
            mesh = pm.Mesh(data, rays, r // rays, r % rays)
            got = pm.shard_batch(mesh, {key: torch.from_numpy(arr)})[key]
            np.testing.assert_array_equal(
                got.numpy(), shards[ids[r // rays, r % rays]], err_msg=key)


def test_mesh_divisibility_raises_as_jax():
    with pytest.raises(ValueError, match='not divisible by rays=3'):
        jpm.make_mesh(rays=3)
    with pytest.raises(ValueError, match='not divisible by rays=3'):
        pm.make_mesh(rays=3)
    assert pm.make_mesh() == pm.Mesh(1, 1)
    assert pm.Mesh(1, 2, 0, 1).row_band(34).rows == slice(17, 34)
    assert pm.Mesh(1, 2, 0, 1).row_band(35) is None      # replicated


@pytest.mark.parametrize('pose', ['tour', 'sky'])
def test_mesh_frame_matches_jax_mesh_and_padded_tiles(setup, pose):
    world, _, _, tmodel, style = setup
    mesh = [torch.device('cpu')] * 3
    r_mesh = TiledRenderer(tmodel, world, tile_size=16, mesh=mesh, **PKW)
    r_tile = TiledRenderer(tmodel, world, tile_size=16, split_refine=False,
                           device='cpu', **PKW)
    assert not r_mesh.split_refine
    z = r_mesh.style_z(style)
    p = _poses(world)[pose]
    img, aux = r_mesh.frame(p, z, return_aux=True)
    st = r_mesh.last_stats
    assert st['tiles'] == 6 and (st['tiles_sky_only'] > 0) == (pose == 'sky')
    np.testing.assert_allclose(img, np.load(FIXTURE)[f'{pose}_mesh'],
                               atol=IMG_ATOL, rtol=0)
    want, want_aux = r_tile.frame(p, z, return_aux=True)
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(aux['depth'], want_aux['depth'])


def test_mesh_trajectory_equals_padded_tiles(setup, tmp_path):
    world, _, _, tmodel, style = setup
    kw = dict(cam_maxstep=2, tile_size=16, tiles_per_batch=2, **PKW)
    got = render_trajectory(tmodel, world, style, str(tmp_path / 'mesh'),
                            mesh=['cpu', 'cpu'], **kw)
    want = render_trajectory(tmodel, world, style, str(tmp_path / 'tiles'),
                             split_refine=False, device='cpu', **kw)
    assert len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match='first device'):
        TiledRenderer(tmodel, world, mesh=['cpu'], device='meta')


def test_inference_cli_mesh_tiles(tmp_path, capsys):
    """`--mesh_tiles` deals the padded tiles over the one CPU device (on
    CUDA: every visible GPU); mesh mode itself is held against the padded
    tiles above."""
    from scenedreamer_tpu_torch.cli import inference
    frames = inference.main([
        '--device', 'cpu', '--scene_size', '64', '--resolution', '24', '32',
        '--num_samples', '6', '--pad', '6', '--cam_maxstep', '2',
        '--tile_size', '16', '--output_dir', str(tmp_path), '--mesh_tiles'])
    assert "mesh tiles over ['cpu']" in capsys.readouterr().out
    assert len(frames) == 2 and frames[0].shape == (24, 32, 3)
    assert (tmp_path / 'rgb_render.mp4').stat().st_size > 0


@pytest.fixture(scope='module')
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp('dist_cli')
    make_paired_folder(str(root / 'data'), n=3, size=40, seed=0)
    maps = terrain.generate_terrain(size=64, seed=3, n_voronoi=20,
                                    relax_iters=2)
    world = voxel_world.build_voxel_world(
        maps.height_map, maps.semantic_map, maps.tree_map, fill_depth=8,
        seed=3, boundary_detect=4, crop=False)
    voxel_world.save_world_cache(world, str(root / 'cache' / '000000'))
    with open(root / 'xor.yaml', 'w') as f:
        f.write(YAML.format(variant='xor', extra='')
                + 'snapshot_save_epoch: 1\n')
    return root


@pytest.mark.parametrize('ranks, rays', [(2, 1), (4, 2)])
def test_cli_trains_on_gloo_ranks(cli_data, ranks, rays):
    """2 ranks: data 2; 4 ranks: data 2 x rays 2, each rays group's
    first rank building and broadcasting its batch."""
    root = cli_data
    logs = root / f'logs_{ranks}x{rays}'
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
           str(ranks), '--master_port', free_port(), '-m',
           'scenedreamer_tpu_torch.cli.train', '--config',
           str(root / 'xor.yaml'), '--data-root', str(root / 'data'),
           '--terrain-cache', str(root / 'cache'), '--logdir', str(logs),
           '--platform', 'cpu', '--spade-size', '256', '--spade-res', '48',
           '--spade-filters', '4', '--seed', '1', '--max-iter', '2',
           '--mesh-rays', str(rays)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    res = run_session(cmd, 300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    for r in range(ranks):
        assert (f"rank {r} of {ranks} (gloo), mesh {{'data': "
                f"{ranks // rays}, 'rays': {rays}}}, data index {r // rays}, "
                f'rays index {r % rays}') in res.stdout
    (run,) = glob.glob(str(logs / '*'))
    # one step an epoch on every data group: saved at the end of epoch 0
    # and at the end of the run
    assert sorted(os.listdir(os.path.join(run, 'checkpoints'))) == [
        'latest_checkpoint.txt', 'step_00000001.pt', 'step_00000002.pt']
    sd = torch.load(os.path.join(run, 'checkpoints', 'step_00000002.pt'),
                    weights_only=True)
    assert sd['step'] == 2
    with open(os.path.join(run, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert sorted({r['step'] for r in recs if 'gen/total' in r}) == [1, 2]
    assert res.stdout.count('[train] done at iteration 2') == ranks
