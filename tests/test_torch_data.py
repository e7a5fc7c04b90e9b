"""The port's host-side data layer against the JAX package's on the same
files: paired dataset and loader, world cache, config, meters, PNG
codec.

Labels are held equal (nearest resize as an explicit index map). Images
agree within one uint8 level per resize (2/255 on the [-1, 1] scale): the
port resizes with torch's bilinear kernel and rounds to nearest, OpenCV
in 11-bit fixed point; the flagship augmentation chains two resizes
(smallest side, then random scale), so its images are held to two levels
(4/255) and a single resize to one."""
import json
import os

import numpy as np
import pytest
import yaml

from scenedreamer_tpu.data import paired_dataset as jds
from scenedreamer_tpu.scene import voxel_world as jvw
from scenedreamer_tpu.utils import meters as jmeters
from scenedreamer_tpu.utils.config import Config as JConfig
from scenedreamer_tpu_torch.data import paired_dataset as tds
from scenedreamer_tpu_torch.data.synthetic import (make_paired_folder,
                                                   make_world)
from scenedreamer_tpu_torch.scene import terrain
from scenedreamer_tpu_torch.scene import voxel_world as tvw
from scenedreamer_tpu_torch.utils import meters as tmeters
from scenedreamer_tpu_torch.utils.config import Config as TConfig
from scenedreamer_tpu_torch.utils.png import read_png, write_png
from _torch_parity import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = 2.0 / 255.0
AUG = dict(resize_smallest_side=64, random_scale_limit=0.2,
           horizontal_flip=True, random_crop_h_w=(48, 48))


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    return make_paired_folder(str(tmp_path_factory.mktemp('paired')), n=7,
                              size=90, seed=1)


def test_paired_folder_contract(folder):
    assert sorted(os.listdir(folder)) == ['images', 'seg_maps']
    assert len(os.listdir(os.path.join(folder, 'images'))) == 7
    with open(os.path.join(folder, 'seg_maps', '00000.png'), 'rb') as f:
        seg = read_png(f.read())
    assert seg.shape == (90, 90) and seg.dtype == np.uint8
    assert ((seg < 183) | (seg == 255)).all()


@pytest.mark.parametrize('epoch', [0, 1])
def test_dataset_items_match_jax(folder, epoch):
    jd = jds.PairedImageDataset(folder, augment=jds.AugmentConfig(**AUG),
                                seed=3)
    td = tds.PairedImageDataset(folder, augment=tds.AugmentConfig(**AUG),
                                seed=3)
    assert len(td) == len(jd) == 7
    flipped = 0
    for i in range(len(td)):
        want = jd.__getitem__(i, epoch=epoch)
        got = td.__getitem__(i, epoch=epoch)
        assert set(got) == set(want)
        assert got['images'].shape == (48, 48, 3)
        assert got['label'].shape == (48, 48, 184)
        np.testing.assert_array_equal(got['label'], want['label'])
        np.testing.assert_array_equal(got['seg_maps'], want['seg_maps'])
        np.testing.assert_allclose(got['images'], want['images'],
                                   atol=2 * LEVEL + 1e-6, rtol=0)
        flipped += int(not np.array_equal(
            got['label'], td.__getitem__(i, epoch=epoch + 7)['label']))
    assert flipped > 0                  # the epoch enters the item rng


@pytest.mark.parametrize('ops', [
    {'resize_smallest_side': 64},
    {'resize_h_w': (40, 56)},
    {'resize_smallest_side': 120, 'center_crop_h_w': (100, 100)},
    {'random_scale_limit': 0.3, 'random_crop_h_w': (60, 60)},
])
def test_single_resize_within_one_level(folder, ops):
    jd = jds.PairedImageDataset(folder, augment=dict(ops), seed=0)
    td = tds.PairedImageDataset(folder, augment=dict(ops), seed=0)
    for i in range(3):
        want, got = jd[i], td[i]
        np.testing.assert_array_equal(got['label'], want['label'])
        np.testing.assert_allclose(got['images'], want['images'],
                                   atol=LEVEL + 1e-6, rtol=0)


def test_unported_augmentation_and_lmdb_raise(folder, tmp_path):
    """Every augmentation of the JAX package is ported (held against it
    in `test_torch_augment.py`); an unknown one raises ValueError as
    there, and so does an unknown dataset type. The lmdb backend is
    ported: a folder that holds no database raises, one built by
    `data/lmdb_utils.py` reads the folder dataset's items
    (`test_torch_scene_cli.py` holds it against the JAX package)."""
    from scenedreamer_tpu_torch.data.lmdb_utils import build_paired_lmdbs
    tds.Augmentor({'rotate': 10})
    tds.Augmentor({'random_scale_limit': {'scale_limit_lb': 0.2,
                                          'scale_limit_ub': 0.3}})
    with pytest.raises(ValueError, match='Unknown augmentation'):
        tds.Augmentor({'swirl': 1})
    with pytest.raises((ImportError, FileNotFoundError)):
        tds.PairedImageDataset(str(tmp_path), dataset_type='lmdb')
    build_paired_lmdbs(folder, str(tmp_path / 'db'))
    db = tds.PairedImageDataset(str(tmp_path / 'db'), dataset_type='lmdb')
    ref = tds.PairedImageDataset(folder)
    assert len(db) == len(ref)
    for key in ('images', 'label'):
        np.testing.assert_array_equal(db[1][key], ref[1][key])
    with pytest.raises(ValueError):
        tds.PairedImageDataset(folder, dataset_type='zip')


def test_make_one_hot_and_concat_labels_match_jax():
    seg = np.random.default_rng(0).integers(-2, 260, (9, 11))
    for dont_care in (True, False):
        np.testing.assert_array_equal(
            tds.make_one_hot(seg, 183, dont_care),
            jds.make_one_hot(seg, 183, dont_care))
    data = {'seg_maps': tds.make_one_hot(seg)}
    assert tds.concat_labels(dict(data))['label'].shape == (9, 11, 184)


@pytest.mark.parametrize('pidx,pcount,drop_last', [(0, 1, True), (1, 2, True),
                                                   (0, 2, False)])
def test_loader_order_and_sharding_match_jax(folder, pidx, pcount,
                                             drop_last):
    aug = dict(AUG)
    jd = jds.PairedImageDataset(folder, augment=jds.AugmentConfig(**aug))
    td = tds.PairedImageDataset(folder, augment=tds.AugmentConfig(**aug))
    kw = dict(batch_size=2, seed=5, process_index=pidx,
              process_count=pcount, drop_last=drop_last)
    jl, tl = jds.DataLoader(jd, **kw), tds.DataLoader(td, **kw)
    assert len(tl) == len(jl)
    for epoch in (0, 3):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a['label'], b['label'])
        for a, b in zip(tl._batch_indices(), jl._batch_indices()):
            np.testing.assert_array_equal(a, b)


def test_loader_workers_equal_synchronous(folder):
    td = tds.PairedImageDataset(folder, augment=tds.AugmentConfig(**AUG))
    sync = list(tds.DataLoader(td, 2, seed=1))
    threaded = list(tds.DataLoader(td, 2, seed=1, num_workers=3,
                                   prefetch_batches=2))
    assert len(sync) == len(threaded) == 3
    for a, b in zip(sync, threaded):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    it = iter(tds.DataLoader(td, 2, seed=1, num_workers=2))
    next(it)
    it.close()                          # abandoning mid-epoch must not hang


def _uncropped_world(seed):
    maps = terrain.generate_terrain(size=64, seed=seed, n_voronoi=20,
                                    relax_iters=2)
    return tvw.build_voxel_world(maps.height_map, maps.semantic_map,
                                 maps.tree_map, fill_depth=8, seed=seed,
                                 boundary_detect=4, crop=False)


def test_world_cache_round_trip_and_jax_loader(tmp_path):
    cache = str(tmp_path / 'cache')
    worlds = [_uncropped_world(s) for s in (3, 4)]
    for i, w in enumerate(worlds):
        tvw.save_world_cache(w, os.path.join(cache, f'{i:06d}'))
    assert sorted(os.listdir(os.path.join(cache, '000000'))) == [
        'height_map.npy', 'hmap_mc.npy', 'semantic_map.npy',
        'voxel_sparse.npy']
    with pytest.raises(ValueError, match='uncropped'):
        tvw.save_world_cache(make_world(size=32, seed=1, n_voronoi=8,
                                        boundary_detect=2),
                             str(tmp_path / 'bad'))
    tc, jc = tvw.WorldCache(cache), jvw.WorldCache(cache)
    assert tc.paths == jc.paths and tc.slab_height == jc.slab_height
    for i, path in enumerate(tc.paths):
        got = tvw.load_world_cache(path, crop_height=tc.slab_height)
        want = jvw.load_world_cache(path, crop_height=jc.slab_height)
        for f in ('voxel', 'heightmap', 'height_field', 'semantic_field'):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert got.y_offset == want.y_offset
        assert got.voxel.shape[0] == tc.slab_height
        # the round trip: the world's own [ground, sky) rows come back
        own = tvw.load_world_cache(path)
        full = worlds[i].voxel
        np.testing.assert_array_equal(
            own.voxel, full[own.y_offset:own.y_offset + own.voxel.shape[0]])
        np.testing.assert_array_equal(own.heightmap, worlds[i].heightmap)

    class First:
        def choice(self, seq):
            return seq[0]
    np.testing.assert_array_equal(tc.sample_world(First()).voxel,
                                  jc.sample_world(First()).voxel)
    with pytest.raises(ValueError, match='crop_height'):
        tvw.load_world_cache(tc.paths[0], crop_height=2)
    os.makedirs(tmp_path / 'empty')
    with pytest.raises(FileNotFoundError):
        tvw.WorldCache(str(tmp_path / 'empty'))


@pytest.mark.parametrize('name', ['scenedreamer_train.yaml',
                                  'scenedreamer_train_small.yaml',
                                  'scenedreamer_inference.yaml',
                                  'landscape1m.yaml', None])
def test_config_matches_jax(name):
    path = os.path.join(REPO, 'configs', name) if name else None
    got, want = TConfig(path), JConfig(path)
    assert got.to_dict() == want.to_dict()
    assert got.name == want.name
    assert got.trainer.model_average_config.enabled == \
        want.trainer.model_average_config.enabled
    over = {'gen': {'hash_variant': 'paired'}, 'logging_iter': 1}
    assert TConfig(path, over).to_dict() == JConfig(path, over).to_dict()
    assert TConfig(path, over).gen.hash_variant == 'paired'


def _records(logdir):
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
        return [{k: v for k, v in json.loads(line).items() if k != 't'}
                for line in f]


def test_metrics_writer_writes_the_same_records(tmp_path):
    writers = [jmeters.MetricsWriter(str(tmp_path / 'j'),
                                     use_tensorboard=False),
               tmeters.MetricsWriter(str(tmp_path / 't'),
                                     use_tensorboard=False)]
    for w in writers:
        for step in (1, 2):
            for name, vals in (('gen/total', [1.0, 2.5, float('nan')]),
                               ('dis/total', [0.25 * step]),
                               ('empty', [float('inf')])):
                for v in vals:
                    w.meter(name).write(v)
            w.meter('gen/total').write(None)
            w.flush_meters(step)
            w.scalar('perf/iters_per_s', 2.0 * step, step)
        w.close()
    got, want = _records(tmp_path / 't'), _records(tmp_path / 'j')
    assert got == want
    assert got[0] == {'step': 1, 'dis/total': 0.25}
    assert {'step': 1, 'gen/total': 1.75} in got
    assert not any('empty' in r for r in got)
    m = tmeters.Meter('x', None)
    assert m.local_mean() is None
    assert tmeters._cross_process_mean(['a'], {'a': 1.0}) == {'a': 1.0}


def test_metrics_writer_image_sink_and_logging_dir(tmp_path):
    logdir = tmeters.make_logging_dir(str(tmp_path), 'cfg')
    assert os.path.isdir(logdir) and logdir.endswith('_cfg')
    w = tmeters.MetricsWriter(logdir, use_tensorboard=False)
    img = np.random.default_rng(0).integers(0, 255, (6, 8, 3)) \
        .astype(np.uint8)
    w.image('train/snapshot', img, 4)
    w.close()
    with open(os.path.join(logdir, 'images',
                           'train_snapshot_00000004.png'), 'rb') as f:
        np.testing.assert_array_equal(read_png(f.read()), img)


@pytest.mark.parametrize('shape', [(7, 9, 3), (12, 5)])
def test_png_codec_round_trip_and_filters(tmp_path, shape):
    """Own writer -> own reader, own writer -> OpenCV, and OpenCV's
    filtered rows (Sub / Up / Average / Paeth) -> own reader."""
    cv2 = pytest.importorskip('cv2')
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, shape).astype(np.uint8)
    img[2:5] = np.cumsum(np.ones_like(img[2:5]), axis=1)    # smooth rows
    path = str(tmp_path / 'a.png')
    write_png(path, img)
    with open(path, 'rb') as f:
        buf = f.read()
    np.testing.assert_array_equal(read_png(buf), img)
    flag = cv2.IMREAD_COLOR if img.ndim == 3 else cv2.IMREAD_GRAYSCALE
    dec = cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
    np.testing.assert_array_equal(dec[..., ::-1] if img.ndim == 3 else dec,
                                  img)
    ok, enc = cv2.imencode('.png', img[..., ::-1] if img.ndim == 3 else img)
    np.testing.assert_array_equal(read_png(enc.tobytes()), img)
    np.testing.assert_array_equal(
        tds.decode_image(enc.tobytes(), gray=img.ndim == 2), img)
    with pytest.raises(ValueError):
        read_png(b'not a png')
    with pytest.raises(ValueError):
        write_png(path, np.zeros((2, 2, 4), np.uint8))


def test_yaml_round_trip_of_the_flagship_config(tmp_path):
    """A config rewritten with PyYAML (as the on-card smoke run writes
    its paired-variant copy) loads to the same values."""
    src = os.path.join(REPO, 'configs', 'scenedreamer_train.yaml')
    with open(src) as f:
        cfg = yaml.safe_load(f)
    cfg['gen']['hash_variant'] = 'paired'
    out = str(tmp_path / 'paired.yaml')
    with open(out, 'w') as f:
        yaml.safe_dump(cfg, f)
    got = TConfig(out).to_dict()
    want = TConfig(src, {'gen': {'hash_variant': 'paired'}}).to_dict()
    got.pop('source_filename'), want.pop('source_filename')
    got.pop('name'), want.pop('name')
    assert got == want
