"""The port's dataset augmentations (`data/paired_dataset.Augmentor`,
`data/image_ops.py`, numpy only) against the JAX package's `Augmentor`,
which calls OpenCV, on the same uint8 image, label map and numpy
generator seed. Each op runs alone over several seeds, so that an op of
probability p both runs and is skipped; the generators must stand at the
same place afterwards (the same draws in the same order, those of a
skipped op included).

Tolerances, from the port against cv2 5.0 on these inputs and on
256 x 200 noise (where the measured worst was 1 level on 4e-5 of the
values for `rotate`, 1 level on 3e-5 for `motion_blur`, 0 for the rest):
  * rotate: the image within 1 level on at most 1e-3 of its values (the
    bilinear float32 sums round otherwise), the labels equal on all but
    1e-3 of the pixels;
  * motion_blur: within 1 level on at most 1e-3 of the values (the
    warped kernel and the float32 correlation sum in another order);
  * compression: within 1 level, mean difference at most 0.01 (libjpeg's
    integer stages are reproduced; measured equal);
  * blur, contrast, gamma, random_rotate_90: equal;
  * random_resize_h_w_aspect and the dict random_scale_limit: within one
    level, labels equal (the port's bilinear resize, as
    `test_torch_data.py` holds it)."""
import numpy as np
import pytest

from scenedreamer_tpu.data import paired_dataset as jds
from scenedreamer_tpu_torch.data import image_ops
from scenedreamer_tpu_torch.data import paired_dataset as tds
from scenedreamer_tpu_torch.data.synthetic import make_paired_folder
from _torch_parity import cap_torch_threads

cap_torch_threads()

SEEDS = range(6)


def _inputs(h=48, w=64):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([120 + 90 * np.sin(xx / (5 + c) + c) * np.cos(yy / 7 - c)
                    for c in range(3)], -1) + rng.normal(0, 12, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    seg = np.zeros((h, w), np.uint8)
    for _ in range(5):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        seg[y0:y0 + rng.integers(5, h // 2),
            x0:x0 + rng.integers(5, w // 2)] = rng.integers(0, 183)
    return img, seg


OPS = {
    'rotate': ({'rotate': 15}, 1, 1e-3, 1e-3),
    'rotate_0': ({'rotate': 0}, 0, 0, 0),
    'random_rotate_90': ({'random_rotate_90': True}, 0, 0, 0),
    'contrast': ({'contrast': {'p': 0.5, 'brightness_limit': 0.2,
                               'contrast_limit': 0.3}}, 0, 0, 0),
    'blur': ({'blur': {'p': 0.5, 'blur_limit': 7}}, 0, 0, 0),
    'gamma': ({'gamma': {'p': 0.5, 'gamma_limit_lb': 80,
                         'gamma_limit_ub': 120}}, 0, 0, 0),
    'motion_blur': ({'motion_blur': {'p': 0.5, 'blur_limit': 9}}, 1, 1e-3,
                    0),
    'compression': ({'compression': {'p': 0.5, 'quality_lower': 20,
                                     'quality_upper': 100}}, 1, 1.0, 0),
    'random_resize_h_w_aspect': ({'random_resize_h_w_aspect': {
        'h': 40, 'w': 56, 'aspect_min': 0.75, 'aspect_max': 1.33}}, 1, 1.0,
        0),
    'random_scale_limit_dict': ({'random_scale_limit': {
        'scale_limit_lb': 0.2, 'scale_limit_ub': 0.3, 'p': 0.5}}, 1, 1.0, 0),
}


@pytest.mark.parametrize('name', list(OPS))
def test_augment_op_matches_jax(name):
    ops, max_level, share, seg_share = OPS[name]
    img, seg = _inputs()
    jaug, taug = jds.Augmentor(dict(ops)), tds.Augmentor(dict(ops))
    for seed in SEEDS:
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        want_img, want_seg = jaug(img.copy(), seg.copy(), jr)
        got_img, got_seg = taug(img.copy(), seg.copy(), tr)
        assert jr.random() == tr.random(), (name, seed)
        assert got_img.shape == want_img.shape
        assert got_img.dtype == want_img.dtype == np.uint8
        diff = np.abs(got_img.astype(int) - want_img.astype(int))
        assert diff.max() <= max_level, (name, seed, diff.max())
        assert (diff > 0).mean() <= share, (name, seed, (diff > 0).mean())
        if name == 'compression':
            assert diff.mean() <= 0.01
        assert got_seg.shape == want_seg.shape
        assert (got_seg != want_seg).mean() <= seg_share, (name, seed)


@pytest.mark.parametrize('quality', [5, 50, 90])
def test_jpeg_round_trip_matches_cv2(quality):
    """The JPEG round trip against `cv2.imencode` / `imdecode` at odd
    sizes (partial blocks and MCUs on both axes)."""
    import cv2
    img, _ = _inputs(37, 45)
    ok, buf = cv2.imencode('.jpg', img, [int(cv2.IMWRITE_JPEG_QUALITY),
                                         quality])
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    got = image_ops.jpeg_round_trip(img, quality)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and diff.mean() <= 0.01


def test_landscape_pipeline_matches_jax(tmp_path):
    """The dataset with `configs/landscape1m.yaml`'s training pipeline
    (rotate 0, the scalar scale limit, flip, crop) at a small size: labels
    equal, images within 2 levels (one per bilinear resize of the
    chain)."""
    root = make_paired_folder(str(tmp_path / 'data'), 3, 40, 0)
    ops = {'resize_smallest_side': 36, 'rotate': 0,
           'random_scale_limit': 0.2, 'horizontal_flip': True,
           'random_crop_h_w': (32, 32)}
    jd = jds.PairedImageDataset(root, augment=dict(ops), seed=1)
    td = tds.PairedImageDataset(root, augment=dict(ops), seed=1)
    for i in range(3):
        want, got = jd[i], td[i]
        np.testing.assert_array_equal(got['label'], want['label'])
        np.testing.assert_allclose(got['images'], want['images'],
                                   atol=2 / 127.5 + 1e-6, rtol=0)
