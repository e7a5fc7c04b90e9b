"""The port's scene CLIs and host IO against the JAX package's:
`cli/terrain_gen.py`, `scene/terrain.py:save_terrain`,
`cli/pcg_cache.py`, `data/lmdb_utils.py` + `cli/build_db.py` (and
`PairedImageDataset(dataset_type='lmdb')`), `utils/io.py` and
`scene/camera.py:TourCameraController`.

Terrain arrays are equal, PNGs decode to equal pixels (the port writes
them with its own encoder, JAX with OpenCV), the voxel caches' four
files are equal whichever package wrote the terrain and whichever naming
it is read by, each package reads the other's databases byte for byte,
and the chain terrain -> cache -> database -> lmdb dataset runs in a
process where `cv2` and `lmdb` cannot be imported."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from scenedreamer_tpu.cli import pcg_cache as jpcg
from scenedreamer_tpu.cli import terrain_gen as jtg
from scenedreamer_tpu.data import lmdb_utils as jlmdb
from scenedreamer_tpu_torch.cli import build_db as tbuild
from scenedreamer_tpu_torch.cli import pcg_cache as tpcg
from scenedreamer_tpu_torch.cli import terrain_gen as ttg
from scenedreamer_tpu_torch.data import lmdb_utils as tlmdb
from scenedreamer_tpu_torch.data.paired_dataset import (DataLoader,
                                                        PairedImageDataset,
                                                        decode_image)
from scenedreamer_tpu_torch.data.synthetic import make_paired_folder

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SEED = 128, 11
TERRAIN_FILES = ('heightmap.npy', 'semanticmap.png', 'treemap.png',
                 'colormap.png', 'biome_rivers_height.npy',
                 'biome_rivers_height.png', 'biome_rivers_labels.png',
                 'biome_trees_dist.png')
NAMINGS = {'inference': ('heightmap.npy', 'semanticmap.png', 'treemap.png'),
           'training': ('biome_rivers_height.npy', 'biome_rivers_labels.png',
                        'biome_trees_dist.png')}
CACHE_FILES = ('voxel_sparse.npy', 'height_map.npy', 'semantic_map.npy',
               'hmap_mc.npy')


def _assert_same_file(a, b):
    if a.endswith('.npy'):
        x, y = np.load(a), np.load(b)
        assert x.dtype == y.dtype, (a, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=a)
    else:
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            np.testing.assert_array_equal(decode_image(fa.read()),
                                          decode_image(fb.read()),
                                          err_msg=a)


@pytest.fixture(scope='module')
def terrains(tmp_path_factory):
    root = tmp_path_factory.mktemp('terrain')
    jtg.generate_one(SEED, SIZE, str(root / 'jax'))
    ttg.generate_one(SEED, SIZE, str(root / 'port'))
    return root


def test_terrain_gen_matches_jax(terrains):
    for name in TERRAIN_FILES:
        _assert_same_file(str(terrains / 'port' / name),
                          str(terrains / 'jax' / name))


def test_save_terrain_matches_jax(tmp_path):
    from scenedreamer_tpu.scene.terrain import save_terrain as jsave
    from scenedreamer_tpu_torch.scene.terrain import (generate_terrain,
                                                      save_terrain)
    maps = generate_terrain(size=64, seed=3)
    save_terrain(maps, str(tmp_path / 'port'))
    jsave(maps, str(tmp_path / 'jax'))
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert sorted(os.listdir(tmp_path / 'port')) == names
    for name in names:
        _assert_same_file(str(tmp_path / 'port' / name),
                          str(tmp_path / 'jax' / name))


@pytest.mark.parametrize('naming', sorted(NAMINGS))
def test_pcg_cache_matches_jax_both_ways(terrains, tmp_path, naming):
    """The port's cache of JAX's terrain and JAX's cache of the port's,
    each read by one naming only, with the seeded random crop."""
    for pkg in ('jax', 'port'):
        os.makedirs(tmp_path / pkg)
        for name in NAMINGS[naming]:
            shutil.copy(terrains / pkg / name, tmp_path / pkg / name)
    tpcg.cache_one(str(tmp_path / 'jax'), str(tmp_path / 'c_port'), 96, 5)
    jpcg.cache_one(str(tmp_path / 'port'), str(tmp_path / 'c_jax'), 96, 5)
    for name in CACHE_FILES:
        _assert_same_file(str(tmp_path / 'c_port' / name),
                          str(tmp_path / 'c_jax' / name))
    assert np.load(tmp_path / 'c_port' / 'height_map.npy').shape[-1] == 96


def test_scene_cli_mains_fan_out(tmp_path):
    from scenedreamer_tpu_torch.scene.voxel_world import load_world_cache
    ttg.main(['--size', '64', '--outdir', str(tmp_path / 'data'),
              '--num-scenes', '2', '--start-seed', '4', '--workers', '2'])
    assert sorted(os.listdir(tmp_path / 'data')) == ['000004', '000005']
    tpcg.main(['--terrain-dir', str(tmp_path / 'data'), '--outdir',
               str(tmp_path / 'cache'), '--crop', '48'])
    for scene in ('000004', '000005'):
        world = load_world_cache(str(tmp_path / 'cache' / scene))
        assert world.voxel.shape[1:] == (48, 48) and world.voxel.any()


@pytest.fixture(scope='module')
def paired(tmp_path_factory):
    root = tmp_path_factory.mktemp('paired')
    folder = make_paired_folder(str(root / 'folder'), n=4, size=40, seed=2)
    tbuild.main(['--data_root', folder, '--output_root',
                 str(root / 'db_port')])
    jlmdb.build_paired_lmdbs(folder, str(root / 'db_jax'))
    return root, folder


def test_build_db_readable_by_both_packages(paired):
    root, folder = paired
    for t in ('images', 'seg_maps'):
        keys = sorted(os.listdir(os.path.join(folder, t)))
        readers = [mod.LMDBReader(str(root / db / t))
                   for mod in (tlmdb, jlmdb) for db in ('db_port', 'db_jax')]
        for r in readers:
            assert r.keys == keys
        for k in keys:
            with open(os.path.join(folder, t, k), 'rb') as f:
                raw = f.read()
            assert all(r.get(k) == raw for r in readers)
        with pytest.raises(KeyError):
            readers[0].get('missing.png')


def test_lmdb_dataset_matches_folder_dataset(paired):
    root, folder = paired
    ref = PairedImageDataset(folder, seed=1)
    for db in ('db_port', 'db_jax'):
        ds = PairedImageDataset(str(root / db), dataset_type='lmdb', seed=1)
        assert len(ds) == len(ref) == 4
        for i in range(len(ds)):
            a, b = ds.__getitem__(i, epoch=1), ref.__getitem__(i, epoch=1)
            for key in ('images', 'label'):
                np.testing.assert_array_equal(a[key], b[key])
    # the loader's worker threads read the database (one sqlite
    # connection per thread)
    ds = PairedImageDataset(str(root / 'db_port'), dataset_type='lmdb',
                            seed=1)
    batch = next(iter(DataLoader(ds, 4, shuffle=False, num_workers=2)))
    for i in range(4):
        np.testing.assert_array_equal(batch['images'][i],
                                      ref.__getitem__(i, epoch=0)['images'])


def test_scene_chain_needs_no_opencv_or_lmdb(tmp_path):
    """terrain_gen -> pcg_cache -> build_db -> an lmdb-backed loader
    batch, in a process where `cv2` and `lmdb` do not import."""
    code = f'''
import sys
sys.modules['cv2'] = None
sys.modules['lmdb'] = None
from scenedreamer_tpu_torch.cli import build_db, pcg_cache, terrain_gen
from scenedreamer_tpu_torch.data.paired_dataset import (DataLoader,
                                                        PairedImageDataset)
from scenedreamer_tpu_torch.data.synthetic import make_paired_folder
from scenedreamer_tpu_torch.scene.voxel_world import load_world_cache
root = {str(tmp_path)!r}
terrain_gen.main(['--size', '64', '--seed', '2', '--outdir', root + '/t'])
pcg_cache.main(['--terrain-dir', root + '/t', '--outdir', root + '/c',
                '--crop', '0'])
world = load_world_cache(root + '/c/t')
make_paired_folder(root + '/p', n=3, size=32)
build_db.main(['--data_root', root + '/p', '--output_root', root + '/db'])
ds = PairedImageDataset(root + '/db', dataset_type='lmdb')
batch = next(iter(DataLoader(ds, 2)))
assert batch['images'].shape[0] == 2, batch['images'].shape
assert 'cv2' not in [m for m, v in sys.modules.items() if v is not None]
print('ok', world.voxel.shape)
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines()[-1].startswith('ok')


def test_io_matches_jax(tmp_path):
    from scenedreamer_tpu.utils import io as jio
    from scenedreamer_tpu_torch.utils import io as tio
    img = np.random.default_rng(4).uniform(-1, 1, (2, 9, 11, 3)).astype(
        np.float32)
    jio.save_tensor_image(str(tmp_path / 'j' / 'a.png'), img)
    tio.save_tensor_image(str(tmp_path / 't' / 'a.png'),
                          torch.from_numpy(img))
    u8 = (img[1] * 100 + 120).astype(np.uint8)
    jio.save_image(str(tmp_path / 'j' / 'b.png'), u8)
    tio.save_image(str(tmp_path / 't' / 'b.png'), u8)
    for name in ('a.png', 'b.png'):
        _assert_same_file(str(tmp_path / 't' / name),
                          str(tmp_path / 'j' / name))
    ckpt = tmp_path / 'ckpts' / 'model.pt'
    ckpt.parent.mkdir()
    ckpt.write_bytes(b'x')
    for mod in (jio, tio):
        assert mod.get_checkpoint(str(ckpt)) == str(ckpt)
        assert mod.get_checkpoint('https://host/model.pt',
                                  str(ckpt.parent)) == str(ckpt)
        with pytest.raises(FileNotFoundError):
            mod.get_checkpoint('https://host/other.pt', str(ckpt.parent))
        with pytest.raises(FileNotFoundError):
            mod.get_checkpoint(str(tmp_path / 'none.pt'))


def test_tour_camera_matches_jax():
    from scenedreamer_tpu.data.synthetic import make_world
    from scenedreamer_tpu.scene.camera import \
        TourCameraController as JTour
    from scenedreamer_tpu_torch.scene.camera import TourCameraController
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    want, got = JTour(world, maxstep=12), TourCameraController(world, 12)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
