"""The port's flow ops, misc helpers, visualization and tracing against
the JAX package on the same numpy inputs.

`ops/flow.py` and `utils/misc.py:random_shift` (forward, and gradients
through a seeded cotangent: `jax.vjp` against autograd) within 1e-5
(float32 sums in another order); the structural helpers exactly;
`tensor2flow` within one uint8 level (OpenCV's fastAtan2 polynomial and
its min-max scale reproduced in numpy, rounded in another order),
`plot_keypoints` and the PNG of `save_tensor_image` exactly,
`tensor2pilimage` exactly (both Pillow); `trace` / `annotate` write a
Chrome trace naming the span."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import cap_torch_threads
from scenedreamer_tpu.ops import flow as jflow
from scenedreamer_tpu.utils import misc as jmisc
from scenedreamer_tpu.utils import visualization as jvis
from scenedreamer_tpu_torch.ops import flow as tflow
from scenedreamer_tpu_torch.utils import misc as tmisc
from scenedreamer_tpu_torch.utils import visualization as tvis

cap_torch_threads()

ATOL = 1e-5


def _vjp_pair(jfn, tfn, inputs, seed=1):
    """(JAX outputs and input cotangents, the port's) for fn(*inputs)
    and a seeded normal cotangent; an input autograd leaves without a
    gradient (nearest resampling's flow) counts as zeros, as JAX's."""
    jout, pull = jax.vjp(jfn, *[jnp.asarray(x) for x in inputs])
    g = np.random.default_rng(seed).standard_normal(jout.shape).astype(
        np.float32)
    jgrads = pull(jnp.asarray(g))
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    tout = tfn(*tin)
    tout.backward(torch.from_numpy(g))
    return ((np.asarray(jout), [np.asarray(a) for a in jgrads]),
            (tout.detach().numpy(),
             [np.zeros_like(x) if t.grad is None else t.grad.numpy()
              for x, t in zip(inputs, tin)]))


def _assert_pair(pair, atol=ATOL):
    (jo, jg), (to, tg) = pair
    np.testing.assert_allclose(to, jo, atol=atol, rtol=0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize('deg', [2, 3])
def test_channel_norm_matches_jax(deg):
    x = np.random.default_rng(0).standard_normal((2, 5, 6, 4)).astype(
        np.float32)
    _assert_pair(_vjp_pair(lambda a: jflow.channel_norm(a, deg),
                           lambda a: tflow.channel_norm(a, deg), [x]))


@pytest.mark.parametrize('kw', [
    dict(),
    dict(pad_size=2, kernel_size=3, max_displacement=2, stride1=2,
         stride2=2)])
def test_correlation_matches_jax(kw):
    rng = np.random.default_rng(1)
    x1, x2 = (rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
              for _ in range(2))
    pair = _vjp_pair(lambda a, b: jflow.correlation(a, b, **kw),
                     lambda a, b: tflow.correlation(a, b, **kw), [x1, x2])
    assert pair[1][0].shape == pair[0][0].shape
    _assert_pair(pair)


@pytest.mark.parametrize('bilinear', [True, False])
def test_resample2d_matches_jax(bilinear):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 7, 9, 2)) * 4).astype(np.float32)
    pair = _vjp_pair(lambda a, f: jflow.resample2d(a, f, bilinear=bilinear),
                     lambda a, f: tflow.resample2d(a, f, bilinear=bilinear),
                     [x, flow])
    _assert_pair(pair)


def test_random_shift_matches_jax():
    """JAX's draw of the shift, fed to the port as `uniforms`."""
    x = np.random.default_rng(3).standard_normal((3, 8, 10, 2)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    u = np.array(jax.random.uniform(key, (3, 2)))
    pair = _vjp_pair(lambda a: jmisc.random_shift(a, key, offset=0.2),
                     lambda a: tmisc.random_shift(
                         a, offset=0.2, uniforms=torch.from_numpy(u)), [x])
    _assert_pair(pair)
    out = tmisc.random_shift(torch.from_numpy(x),
                             torch.Generator().manual_seed(0))
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_structural_helpers_match_jax(tmp_path):
    labels = np.arange(2 * 3 * 7, dtype=np.float32).reshape(2, 3, 7)
    lengths = {'a': 2, 'b': 4, 'c': 1}
    want = jmisc.split_labels(jnp.asarray(labels), lengths)
    got = tmisc.split_labels(torch.from_numpy(labels), lengths)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jt = jmisc.slice_tensor({'x': jnp.asarray(labels),
                             'y': [jnp.asarray(labels[0]), 'keep'],
                             'z': (labels, 3)}, 1, 2)
    tt = tmisc.slice_tensor({'x': torch.from_numpy(labels),
                             'y': [torch.from_numpy(labels[0]), 'keep'],
                             'z': (labels, 3)}, 1, 2)
    np.testing.assert_array_equal(tt['x'].numpy(), np.asarray(jt['x']))
    np.testing.assert_array_equal(tt['y'][0].numpy(),
                                  np.asarray(jt['y'][0]))
    assert tt['y'][1] == jt['y'][1] == 'keep'
    assert isinstance(tt['z'], tuple) and tt['z'][1] == jt['z'][1] == 3
    np.testing.assert_array_equal(tt['z'][0], jt['z'][0])

    class Cfg:
        pass
    for mod in (jmisc, tmisc):
        cfg = Cfg()
        cfg.inner = Cfg()
        cfg.inner.value = 5
        assert mod.get_and_setattr(cfg, 'new', 7) == 7 and cfg.new == 7
        assert mod.get_and_setattr(cfg, 'new', 9) == 7
        assert mod.get_nested_attr(cfg, 'inner.value', 0) == 5
        assert mod.get_nested_attr(cfg, 'inner.missing', 'd') == 'd'
    for d in ('b', 'a/x', 'a/y/z', 'c'):
        os.makedirs(tmp_path / d)
    for f in ('a/x/1.png', 'a/y/z/2.png', 'c/3.jpg'):
        (tmp_path / f).write_bytes(b'')
    assert tmisc.get_immediate_subdirectories(str(tmp_path)) == \
        jmisc.get_immediate_subdirectories(str(tmp_path)) == ['a', 'b', 'c']
    assert tmisc.get_recursive_subdirectories(str(tmp_path), 'png') == \
        jmisc.get_recursive_subdirectories(str(tmp_path), 'png')


def test_tensor2flow_matches_jax_within_a_level():
    rng = np.random.default_rng(5)
    flow = (rng.standard_normal((2, 12, 14, 2)) * 3).astype(np.float32)
    flow[0, 0, 0] = 0.0
    flow[0, 1, :4] = [[1, 0], [0, 1], [-1, 0], [0, -1]]
    want, got = jvis.tensor2flow(flow), tvis.tensor2flow(torch.from_numpy(
        flow))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape
        assert np.abs(a.astype(int) - b).max() <= 1
    assert tvis.tensor2flow(None) is None
    assert len(tvis.tensor2flow([flow[0], None, flow[1]])) == 2


def test_plot_keypoints_matches_jax():
    img = np.random.default_rng(6).integers(0, 255, (20, 24, 3)).astype(
        np.uint8)
    kps = np.array([[3.2, 4.7], [22.6, 1.0], [12, 18], [-2, 10], [40, 40]])
    for radius in (1, 3, 5, 7):
        want = jvis.plot_keypoints(img, kps, color=(10, 200, 30),
                                   radius=radius)
        got = tvis.plot_keypoints(img, kps, color=(10, 200, 30),
                                  radius=radius)
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)


def test_pil_image_and_save_match_jax(tmp_path):
    from scenedreamer_tpu_torch.data.paired_dataset import decode_image
    img = np.random.default_rng(7).uniform(-1.2, 1.2, (10, 12, 3)).astype(
        np.float32)
    for norm in (True, False):
        want = jvis.tensor2pilimage(img, 6, 5, minus1to1_normalized=norm)
        got = tvis.tensor2pilimage(torch.from_numpy(img), 6, 5,
                                   minus1to1_normalized=norm)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        jvis.save_tensor_image(str(tmp_path / 'j' / 'a.png'), img, norm)
        tvis.save_tensor_image(str(tmp_path / 't' / 'a.png'), img, norm)
        tvis.save_tensor_image(str(tmp_path / 't' / 'a.jpg'), img, norm)
        np.testing.assert_array_equal(
            decode_image((tmp_path / 't' / 'a.png').read_bytes()),
            decode_image((tmp_path / 'j' / 'a.png').read_bytes()))
        assert (tmp_path / 't' / 'a.jpg').stat().st_size > 0
    with pytest.raises(ValueError):
        tvis.tensor2pilimage(img[..., :2])


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    from scenedreamer_tpu_torch.utils.profiling import annotate, trace
    with trace(str(tmp_path / 'tr')):
        with annotate('my_span'):
            torch.ones(8).sum()
    with open(tmp_path / 'tr' / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'my_span' for e in events)
