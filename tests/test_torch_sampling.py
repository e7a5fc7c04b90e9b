"""The port's training-batch assembly (`ops/masks.py`, `scene/labels.py`,
`train/sampling.py`) against the JAX package on the same worlds, the same
numpy generators and the same SPADE weights and style vector.

Index work is held bit-equal: `segmask_smooth` (window sums of 0/1 are
exact, so ties and the first-index argmax agree), `rand_crop`, the label
translations, the accepted cameras' voxel ids and hit masks, `fake_masks`,
`translate_masks`. Floats: interval t values 2e-6 relative (a few
float32 steps: in the sampler's vmapped JAX program one t in 12,544
lies 1.02e-6 from the port's, where `test_torch_ray_voxel.py` holds the
single-camera program to 1e-6), ray directions 1e-6, the accept metrics
1e-5 (float32 reductions in another order; the tests assert that no proposal's
metric lies within 1e-3 of a threshold, so both packages accept the same
camera), the pseudo-GT image 1e-4 (SPADE's convolutions and the resize
back, summed in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.data.synthetic import make_world as jmake_world
from scenedreamer_tpu.models.spade import SPADEWrapper as JSpade
from scenedreamer_tpu.ops import masks as jmasks
from scenedreamer_tpu.scene.labels import \
    get_label_translator as jtranslator
from scenedreamer_tpu.train import sampling as jsamp
from scenedreamer_tpu_torch.data.synthetic import make_world
from scenedreamer_tpu_torch.models.spade import SPADEWrapper as TSpade
from scenedreamer_tpu_torch.ops import masks as tmasks
from scenedreamer_tpu_torch.scene.labels import get_label_translator
from scenedreamer_tpu_torch.train import sampling as tsamp
from scenedreamer_tpu_torch.utils.convert import spade_state_dict_from_flax
from _torch_parity import cap_torch_threads

cap_torch_threads()

CFG = dict(cam_res=(40, 64), crop_size=(24, 24), pad=4,
           num_blocks_early_stop=4, max_rejections=8,
           camera_min_entropy=0.75, camera_rej_avg_depth=38.0,
           label_smooth_dia=5)
WORLD = dict(size=64, seed=7, n_voronoi=20, boundary_detect=4)


@pytest.fixture(scope='module')
def worlds():
    return jmake_world(**WORLD), make_world(**WORLD)


@pytest.fixture(scope='module')
def spade():
    """A tiny 256-variant oracle with the same unit-scale weights in both
    packages, and a fixed style vector."""
    kw = dict(num_labels=184, out_size=256, num_filters=4, spade_filters=8,
              style_dims=16)
    jmodel = JSpade(**kw)
    rng = np.random.default_rng(5)
    seg0 = np.zeros((1, 64, 64, 184), np.float32)
    init = jmodel.init({'params': jax.random.PRNGKey(0),
                        'style': jax.random.PRNGKey(1)}, {'label': seg0},
                       random_style=True)

    def weight(path, leaf):
        if path[-1].key == 'kernel':
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return np.asarray(leaf)
    variables = jax.tree_util.tree_map_with_path(weight, dict(init))
    variables['params'] = {
        'spade_generator': variables['params']['spade_generator']}
    tmodel = TSpade(**kw)
    tmodel.load_state_dict(spade_state_dict_from_flax(variables))
    tmodel.eval()
    z = rng.standard_normal((1, 16)).astype(np.float32)

    def japply(masks, key):
        return jmodel.apply(variables, {'label': masks[..., :-1],
                                        'z': jnp.asarray(z)})['fake_images']

    def tapply(masks, generator):
        with torch.no_grad():
            return tmodel({'label': masks[..., :-1],
                           'z': torch.from_numpy(z)})['fake_images']
    return japply, tapply


def _onehot(rng, shape, n):
    return np.eye(n, dtype=np.float32)[rng.integers(0, n, shape)]


@pytest.mark.parametrize('shape,channels,k', [((2, 16, 16), 5, 5),
                                              ((1, 30, 26), 12, 11),
                                              ((1, 13, 9), 185, 11),
                                              ((1, 12, 12), 4, 4)])
def test_segmask_smooth_bit_equal(shape, channels, k):
    # few labels in large blobs: window means tie often
    rng = np.random.default_rng(channels)
    idx = rng.integers(0, min(channels, 3), shape)
    idx = np.repeat(np.repeat(idx[:, ::3, ::3], 3, 1), 3, 2)[
        :, :shape[1], :shape[2]]
    m = np.eye(channels, dtype=np.float32)[idx]
    want = np.asarray(jmasks.segmask_smooth(jnp.asarray(m), k))
    got = tmasks.segmask_smooth(torch.from_numpy(m), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 1).all()


def test_rand_crop_equal():
    for seed in range(5):
        a = jmasks.rand_crop(np.random.default_rng(seed), (19.5, 31.5),
                             (40, 64), (28, 28))
        b = tmasks.rand_crop(np.random.default_rng(seed), (19.5, 31.5),
                             (40, 64), (28, 28))
        assert a == b


def test_label_translations_bit_equal():
    jt, tt = jtranslator(), get_label_translator()
    rng = np.random.default_rng(0)
    mc = rng.integers(0, 680, (3, 50))
    coco = rng.integers(-3, 200, (3, 50))
    np.testing.assert_array_equal(
        tt.mc2coco(torch.from_numpy(mc)).numpy(), jt.mc2coco(jnp.asarray(mc)))
    for ign in (False, True):
        np.testing.assert_array_equal(
            tt.mc2reduced(torch.from_numpy(mc), ign).numpy(),
            jt.mc2reduced(jnp.asarray(mc), ign))
    np.testing.assert_array_equal(
        tt.coco2reduced(torch.from_numpy(coco)).numpy(),
        jt.coco2reduced(jnp.asarray(coco)))
    for name in ('sky', 'water', 'clouds', 'fog', 'sea', 'river'):
        assert tt.gglbl2ggid(name) == jt.gglbl2ggid(name)
    assert tt.get_num_reduced_lbls() == jt.get_num_reduced_lbls() == 12
    np.testing.assert_array_equal(tt.mc_color(mc), jt.mc_color(mc))


def _rays_close(got, want):
    np.testing.assert_array_equal(got['voxel_id'].numpy(),
                                  np.asarray(want['voxel_id']))
    np.testing.assert_array_equal(got['hit_mask'].numpy(),
                                  np.asarray(want['hit_mask']))
    np.testing.assert_allclose(got['depth'].numpy(),
                               np.asarray(want['depth']), rtol=2e-6, atol=0)
    np.testing.assert_allclose(got['raydirs'].numpy(),
                               np.asarray(want['raydirs']), atol=1e-6)
    np.testing.assert_array_equal(got['cam_ori'].numpy(),
                                  np.asarray(want['cam_ori']))


@pytest.fixture(scope='module')
def sampled(worlds):
    """Three cameras from each package's sampler with the same numpy
    generator; the port's accept metrics are recorded on the way."""
    jw, tw = worlds
    jsampler = jsamp.CameraBatchSampler(jsamp.CameraSamplerConfig(**CFG))
    tsampler = tsamp.CameraBatchSampler(tsamp.CameraSamplerConfig(**CFG))
    seen = []
    real = tsamp.accept_metrics
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsamp, 'accept_metrics',
                   lambda *a: seen.append(real(*a)) or seen[-1])
        got = tsampler.sample(tw, 3, np.random.default_rng(11))
    want = jsampler.sample(jw, 3, np.random.default_rng(11))
    return jsampler, tsampler, got, want, seen


def test_sampler_accepts_the_same_cameras(sampled):
    jsampler, tsampler, got, want, seen = sampled
    cfg = tsampler.cfg
    metrics = np.array([[float(a), float(e)] for a, e in seen])
    assert len(metrics) == tsampler.stats['proposals']
    # no proposal on a threshold: the accept decision cannot flip
    assert (np.abs(metrics[:, 0] - cfg.camera_rej_avg_depth) > 1e-3).all()
    assert (np.abs(metrics[:, 1] - cfg.camera_min_entropy) > 1e-3).all()
    ok = (metrics[:, 0] >= cfg.camera_rej_avg_depth) \
        & (metrics[:, 1] >= cfg.camera_min_entropy)
    assert ok.any() and not ok.all()          # both branches were taken
    assert tsampler.stats == jsampler.stats
    assert tsampler.fallback_rate == jsampler.fallback_rate
    assert got['voxel_id'].shape == (3, 28, 28, 4)
    _rays_close(got, want)


def test_sampler_traces_each_round_in_one_call(sampled, worlds):
    """The sampler traces a round's K proposals in one
    `ray_voxel_intersection` call (one K1 launch on the card) with K
    origins and the crop's image width: as many calls as rounds, the same
    cameras and tensors as the fixture's run with the same seed, and each
    accepted camera's intersections equal to a call of its own."""
    _, tsampler, got, _, _ = sampled
    k = tsampler.cfg.proposals_per_dispatch
    calls = []
    real = tsamp.ray_voxel_intersection

    def counted(voxel, cam_ori, raydirs, m, **kw):
        calls.append((tuple(cam_ori.shape), raydirs.shape[0],
                      kw.get('image_width')))
        return real(voxel, cam_ori, raydirs, m, **kw)
    sampler = tsamp.CameraBatchSampler(tsamp.CameraSamplerConfig(**CFG))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsamp, 'ray_voxel_intersection', counted)
        again = sampler.sample(worlds[1], 3, np.random.default_rng(11))
    h, w = sampler.crop_res
    assert len(calls) * k == sampler.stats['proposals'] \
        == tsampler.stats['proposals']
    assert set(calls) == {((k, 3), k * h * w, w)}
    for name, t in got.items():
        assert torch.equal(again[name], t), name
    # each accepted camera traced alone, as the sampler traced it before
    voxel = torch.from_numpy(worlds[1].voxel)
    for i in range(3):
        one = real(voxel, got['cam_ori'][i], got['raydirs'][i].reshape(-1, 3),
                   CFG['num_blocks_early_stop'])
        for name, t in zip(('voxel_id', 'depth', 'hit_mask'), one):
            assert torch.equal(got[name][i].reshape(t.shape), t), name


def test_accept_metrics_match_jax(sampled, worlds):
    """The metrics of the accepted cameras, recomputed from the JAX
    sampler's tensors with the JAX formulas."""
    _, _, got, want, _ = sampled
    for i in range(3):
        ad, en = tsamp.accept_metrics(got['voxel_id'][i].reshape(-1, 4),
                                      got['depth'][i].reshape(-1, 4, 2),
                                      got['hit_mask'][i].reshape(-1, 4))
        dep = np.asarray(want['depth'][i]).reshape(-1, 4, 2)
        hit = np.asarray(want['hit_mask'][i]).reshape(-1, 4)
        vid = np.asarray(want['voxel_id'][i]).reshape(-1, 4)
        want_ad = dep[hit[:, 0], 0, 0].astype(np.float64).mean()
        cnt = np.bincount(vid[:, 0], minlength=680) / vid.shape[0]
        want_en = -(cnt * np.log(cnt + 1e-10)).sum()
        np.testing.assert_allclose(float(ad), want_ad, rtol=1e-5)
        np.testing.assert_allclose(float(en), want_en, rtol=1e-5, atol=1e-6)


def test_fallback_admits_the_best_rejected_proposal(worlds):
    """Thresholds no camera passes: both packages count a fallback and
    admit the same best-rejected proposal."""
    jw, tw = worlds
    kw = dict(CFG, camera_min_entropy=50.0, max_rejections=4)
    js = jsamp.CameraBatchSampler(jsamp.CameraSamplerConfig(**kw))
    ts = tsamp.CameraBatchSampler(tsamp.CameraSamplerConfig(**kw))
    want = js.sample(jw, 1, np.random.default_rng(4))
    got = ts.sample(tw, 1, np.random.default_rng(4))
    assert ts.stats == js.stats == {'proposals': 4, 'accepted': 0,
                                    'fallbacks': 1}
    assert ts.fallback_rate == 1.0
    _rays_close(got, want)


@pytest.mark.parametrize('crop,pad,spade_res', [(24, 4, 64), (12, 4, 48)])
def test_pseudo_gt_matches_jax(sampled, spade, crop, pad, spade_res):
    """crop 24 at 64: the linear resize back; crop 12 at 48: the exact
    area mean of whole blocks (the flagship's 256 -> 512 shape)."""
    _, _, got, want, _ = sampled
    japply, tapply = spade
    h = crop + pad
    vid_j = want['voxel_id'][:1, :h, :h]
    vid_t = got['voxel_id'][:1, :h, :h]
    for seed in (0, 3):                 # two sets of relabeling dice
        jp = jsamp.PseudoGTGenerator(japply, pad=pad, spade_res=spade_res,
                                     label_smooth_dia=5)
        tp = tsamp.PseudoGTGenerator(tapply, pad=pad, spade_res=spade_res,
                                     label_smooth_dia=5)
        jimg, jmask = jp(vid_j, np.random.default_rng(seed),
                         jax.random.PRNGKey(0))
        timg, tmask = tp(vid_t, np.random.default_rng(seed), None)
        assert tmask.shape == (1, crop, crop, 185)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        assert np.abs(np.asarray(jimg)).max() > 0.05
        np.testing.assert_allclose(timg.numpy(), np.asarray(jimg),
                                   atol=1e-4, rtol=0)


def test_nearest_centred_resize_matches_jax_image_resize():
    """`ops/resize.py:resize_nearest` (the pseudo-GT mask resize and the
    discriminator's label map with `smooth_resample=False`) picks JAX's
    source rows and columns: growing, shrinking by a divisor (the label
    map) and not, one axis kept."""
    x = np.random.default_rng(0).standard_normal((1, 24, 20, 3)) \
        .astype(np.float32)
    for size in ((64, 64), (48, 40), (7, 9), (6, 5), (24, 7)):
        want = np.asarray(jax.image.resize(
            jnp.asarray(x), (1,) + size + (3,), 'nearest'))
        got = tsamp.resize_nearest(torch.from_numpy(x), size)
        np.testing.assert_array_equal(got.numpy(), want)


def test_translate_masks_bit_equal(sampled):
    _, _, got, want, _ = sampled
    real = _onehot(np.random.default_rng(0), (3, 28, 28), 184)
    jf, jr = jsamp.translate_masks(jtranslator(), want['voxel_id'],
                                   jnp.asarray(real), pad=4,
                                   label_smooth_dia=5)
    tf, tr = tsamp.translate_masks(get_label_translator(), got['voxel_id'],
                                   torch.from_numpy(real), pad=4,
                                   label_smooth_dia=5)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tf.shape == (3, 24, 24, 12) and tr.shape == (3, 28, 28, 12)
    tf2, tr2 = tsamp.translate_masks(get_label_translator(),
                                     got['voxel_id'], None, pad=4)
    assert tr2 is None and tf2.shape == (3, 24, 24, 12)


@pytest.mark.parametrize('multi_world', [False, True])
def test_training_batch_builder_matches_jax(worlds, spade, multi_world):
    """One whole batch: cameras, BEV fields, pseudo-GT, fake and real
    masks, on one world and on one world per sample."""
    jw, tw = worlds
    japply, tapply = spade
    cfg = dict(CFG)
    jb = jsamp.TrainingBatchBuilder(
        jsamp.CameraBatchSampler(jsamp.CameraSamplerConfig(**cfg)),
        jsamp.PseudoGTGenerator(japply, pad=4, spade_res=64,
                                label_smooth_dia=5))
    tb = tsamp.TrainingBatchBuilder(
        tsamp.CameraBatchSampler(tsamp.CameraSamplerConfig(**cfg)),
        tsamp.PseudoGTGenerator(tapply, pad=4, spade_res=64,
                                label_smooth_dia=5))
    b = 2 if multi_world else 1
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (b, 28, 28, 3)).astype(np.float32)
    label = _onehot(rng, (b, 28, 28), 184)
    jworld, tworld = ([jw] * b, [tw] * b) if multi_world else (jw, tw)
    want = jb({'images': jnp.asarray(images), 'label': jnp.asarray(label)},
              jworld, np.random.default_rng(2), jax.random.PRNGKey(0))
    got = tb({'images': torch.from_numpy(images),
              'label': torch.from_numpy(label)}, tworld,
             np.random.default_rng(2), None)
    assert set(got) == set(want)
    _rays_close(got, want)
    for k in ('images', 'label', 'height_field', 'semantic_field',
              'fake_masks', 'real_masks'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got['pseudo_real_img'].shape == (b, 24, 24, 3)
    np.testing.assert_allclose(got['pseudo_real_img'].numpy(),
                               np.asarray(want['pseudo_real_img']),
                               atol=1e-4, rtol=0)
    if multi_world:
        with pytest.raises(ValueError, match='worlds for batch'):
            tb({'images': torch.from_numpy(images[:1])}, [tw, tw],
               np.random.default_rng(2), None)
