"""The training-campaign path of the port against the JAX package, on the
CPU at a tiny size: the reference SPADE oracle checkpoint in
`cli/train.py`, and `cli/campaign.py` (training assets, pseudo-GT set,
fake set, campaign evaluation) against the JAX scripts of the same names.

The oracle: reference-layout files (`net_G`, `module.` prefixes,
spectral-norm `weight_orig` / `weight_u` [/ `weight_v`] triplets, the
style encoder, batch norms with `num_batches_tracked` and without affine
weight / bias, optimizer and scheduler state beside) made from seeded
unit-scale weights. The port's loaded state dict, mapped through JAX's
`convert_spade`, equals what JAX's loader converts from the file, leaf
for leaf; one oracle image agrees within 1e-4 (as `test_torch_spade.py`).

The bicubic resize equals OpenCV's own C++ path bit for bit (IPP off) and
OpenCV's default IPP path within 32 float32 steps of the image's largest
value (IPP computes its weights otherwise); the synthetic dataset equals
JAX's arrays before its writes, computed with IPP off.

The sets: for one seed, the port draws the same worlds, cameras (first-
hit voxel ids) and pseudo-GT labels as the JAX scripts (their oracle and
generator stubbed: only the draws are compared); each written image is the
quantised render of its batch, and a trainer checkpoint and a reference
`.pt` of the same weights give the live model's images. The campaign
table's pixel FID / KID are within 1e-3 of JAX's `cli.evaluate` on the
same folders, as `test_torch_evaluate.py` holds them."""
import argparse
import ast
import hashlib
import importlib.util
import json
import math
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from scenedreamer_tpu.cli import evaluate as jevaluate
from scenedreamer_tpu.cli import train as jtrain
from scenedreamer_tpu.scene import voxel_world as jvw
from scenedreamer_tpu.train import sampling as jsamp
from scenedreamer_tpu.utils import convert as jconvert
from scenedreamer_tpu_torch.cli import campaign
from scenedreamer_tpu_torch.cli import train as T
from scenedreamer_tpu_torch.data.image_ops import resize_cubic
from scenedreamer_tpu_torch.models import generator as tgen
from scenedreamer_tpu_torch.models.discriminator import GANcraftDiscriminator
from scenedreamer_tpu_torch.models.spade import SPADEWrapper as TSpade
from scenedreamer_tpu_torch.render.pipeline import to_uint8
from scenedreamer_tpu_torch.scene import voxel_world as tvw
from scenedreamer_tpu_torch.train import sampling as tsamp
from scenedreamer_tpu_torch.train.trainer import GANTrainer, save_checkpoint
from scenedreamer_tpu_torch.utils.config import Config
from scenedreamer_tpu_torch.utils.convert import spade_frozen_from_trained
from scenedreamer_tpu_torch.utils.png import read_png
from _torch_parity import TORCH_THREADS, cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_labels=184, out_size=256, num_filters=4, spade_filters=8,
          style_dims=16)
# reference-layout oracle files: (under net_G with `module.`, weight_v
# stored, style encoder, num_batches_tracked and no affine batch norm)
VARIANTS = {
    'bare': (False, True, False, False),
    'net_G': (True, True, False, False),
    'no_v': (True, False, False, False),
    'style_encoder': (True, True, True, False),
    'num_batches_tracked': (True, True, False, True),
}
YAML = """
gen:
  pad: 2
  cam_res: [32, 40]
  num_samples: 4
  num_blocks_early_stop: 2
  style_dims: 8
  interm_style_dims: 16
  final_feat_dim: 8
  hash_num_levels: 4
  hash_level_dim: 4
  hash_log2_size: 10
  hash_desired_resolution: 128
  mlp_hidden: 16
  style_enc:
    num_filters: 4
"""
CAMPAIGN = ['vgg19', 'pixel']
CROP, IMAGES = 16, 3


@pytest.fixture(scope='module', autouse=True)
def _cap_blas_threads():
    """numpy's BLAS / LAPACK threads capped as torch's are: the FID's
    eigendecompositions (512- and 768-wide) slow down by an order of
    magnitude when six test workers each spin a thread per core."""
    with threadpool_limits(TORCH_THREADS):
        yield


def _jax_script(name):
    """A JAX package script (`scripts/<name>.py`) as a module."""
    spec = importlib.util.spec_from_file_location(
        f'_jax_script_{name}', os.path.join(REPO, 'scripts', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _oracle_state(seed, style_encoder):
    """A frozen port oracle's state dict with unit-scale weights and
    non-trivial statistics (the xavier(0.02) init gives images of 1e-4,
    which would hide a wrong layer)."""
    rng = np.random.default_rng(seed)
    model = TSpade(**KW, style_encoder=style_encoder, style_enc_filters=4)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if v.ndim >= 2:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith('running_var'):
            a = rng.uniform(0.5, 2.0, shape)
        elif k.endswith('norm.weight'):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def _reference_layout(sd, seed, with_v, tracked):
    """`sd` as the reference stores a spectral-normed net: every weight
    of rank >= 2 as `weight_orig` with a unit `weight_u` (and `weight_v`,
    one power half-iteration from u); with `tracked`, each batch norm
    with `num_batches_tracked` and without affine weight / bias."""
    rng = np.random.default_rng(seed)
    norms = {k[:-len('.running_mean')] for k in sd
             if k.endswith('.running_mean')}
    out = {}
    for k, v in sd.items():
        base = k.rsplit('.', 1)[0]
        if v.ndim >= 2:
            mat = v.numpy().reshape(v.shape[0], -1).astype(np.float64)
            u = rng.standard_normal(mat.shape[0])
            u /= np.linalg.norm(u)
            out[k + '_orig'] = v
            out[k + '_u'] = torch.from_numpy(u.astype(np.float32))
            if with_v:
                vv = mat.T @ u
                out[k + '_v'] = torch.from_numpy(
                    (vv / np.linalg.norm(vv)).astype(np.float32))
        elif tracked and base in norms and k.endswith(('.weight', '.bias')):
            continue
        else:
            out[k] = v
        if tracked and k.endswith('.running_mean'):
            out[base + '.num_batches_tracked'] = torch.tensor(7)
    return out


@pytest.fixture(scope='module')
def oracle_files(tmp_path_factory):
    root = tmp_path_factory.mktemp('oracle')
    files = {}
    for i, (name, (net_g, with_v, enc, tracked)) in \
            enumerate(VARIANTS.items()):
        sd = _reference_layout(_oracle_state(i, enc), i, with_v, tracked)
        if net_g:
            # a released checkpoint: D, optimizer and scheduler beside
            sd = {'net_G': {f'module.{k}': v for k, v in sd.items()},
                  'net_D': {'module.dis.weight': torch.ones(2, 2)},
                  'opt_G': {'state': {}, 'param_groups': [{'lr': 1e-4}]},
                  'sch_G': argparse.Namespace(last_epoch=3),
                  'current_iteration': 100}
        files[name] = str(root / f'{name}.pt')
        torch.save(sd, files[name])
    return files


def _args(path, f32=True, res=48):
    return argparse.Namespace(spade_checkpoint=path, spade_size=256,
                              spade_res=res, spade_filters=4,
                              spade_oracle_f32=f32)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _folded_names(raw):
    """The names a reference state dict's keys have once prefixes are
    stripped and spectral norm folded."""
    out = set()
    for k in raw:
        k = k.replace('module.', '', 1)
        if k.endswith(('.weight_u', '.weight_v')):
            continue
        out.add(k[:-len('_orig')] if k.endswith('.weight_orig') else k)
    return out


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_reference_oracle_loads_as_jax_converts_it(oracle_files, variant):
    """JAX's loader (`load_torch_checkpoint` + `convert_spade`, its
    `cli/train.py:_load_spade_oracle` route for a `.pt`) and the port's
    `build_spade_oracle` on the same file (which the CLI's
    `_load_spade_oracle` loads and runs): the port's state dict mapped
    back through `convert_spade` equals JAX's variables leaf for leaf.
    Dropped: each `num_batches_tracked`; `net_D`, the optimizer and the
    scheduler never reach the state dict."""
    path = oracle_files[variant]
    masks = torch.nn.functional.one_hot(torch.randint(
        0, 184, (1, 48, 48), generator=torch.Generator().manual_seed(0)),
        185).float()
    img = T._load_spade_oracle(_args(path), 'cpu')(masks, None)
    assert img.shape == (1, 48, 48, 3) and torch.isfinite(img).all()
    ckpt = jconvert.load_torch_checkpoint(path)
    raw = ckpt.get('net_G', ckpt)
    want = jconvert.convert_spade(raw, num_filters=4)
    port = T.build_spade_oracle(_args(path))
    sd = port.state_dict()
    got = jconvert.convert_spade(sd, num_filters=4)
    w, g = _leaves(want), _leaves(got)
    assert w.keys() == g.keys()
    for k, leaf in w.items():
        np.testing.assert_array_equal(g[k], leaf, err_msg=k)
    assert ('style_encoder' in want['params']) == (variant == 'style_encoder')
    assert (port.style_encoder is not None) == (variant == 'style_encoder')
    names = _folded_names(raw)
    dropped = names - set(sd)
    assert dropped == {k for k in names if k.endswith('.num_batches_tracked')}
    assert bool(dropped) == (variant == 'num_batches_tracked')
    if variant == 'num_batches_tracked':
        # JAX reads a missing affine weight / bias as ones / zeros
        added = set(sd) - names
        assert added and all(k.endswith(('.norm.weight', '.norm.bias'))
                             for k in added)
    else:
        assert set(sd) <= names
    if 'net_G' in ckpt:
        assert set(ckpt) - {'net_G'} == {'net_D', 'opt_G', 'sch_G',
                                         'current_iteration'}
        assert not any(k.startswith('dis') for k in sd)


def test_reference_oracle_image_matches_jax(oracle_files, monkeypatch):
    """One oracle image: JAX's `_load_spade_oracle` (float32) with its
    random style, the port's oracle from the same file with that style."""
    path = oracle_files['style_encoder']
    drawn = []
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, 'normal',
                        lambda *a, **k: drawn.append(normal(*a, **k))
                        or drawn[-1])
    japply = jtrain._load_spade_oracle(_args(path))

    def apply(masks, key):          # jitted: one compile, not one per op
        return japply(masks, key), [
            d for d in drawn if d.shape == (1, KW['style_dims'])][-1]
    masks = np.eye(185, dtype=np.float32)[
        np.random.default_rng(3).integers(0, 184, (1, 48, 48))]
    want, z = jax.jit(apply)(jnp.asarray(masks), jax.random.PRNGKey(0))
    want = np.asarray(want)
    assert z.shape == (1, KW['style_dims'])
    with torch.no_grad():
        got = T.build_spade_oracle(_args(path))(
            {'label': torch.from_numpy(masks[..., :-1]),
             'z': torch.from_numpy(np.array(z))})['fake_images'].numpy()
    assert got.shape == want.shape == (1, 48, 48, 3)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the CLI's bf16 oracle on the same file
    img = T._load_spade_oracle(_args(path, f32=False), 'cpu')(
        torch.from_numpy(masks), torch.Generator().manual_seed(0))
    assert img.shape == (1, 48, 48, 3) and torch.isfinite(img).all()


def test_trainer_checkpoints_and_frozen_dicts_still_load(tmp_path):
    frozen = TSpade(**KW, seed=3).state_dict()
    torch.save(frozen, str(tmp_path / 'frozen.pt'))
    got = T.build_spade_oracle(_args(str(tmp_path / 'frozen.pt')))
    assert got.style_encoder is None
    assert got.state_dict().keys() == frozen.keys()
    for k, v in frozen.items():
        assert torch.equal(got.state_dict()[k], v), k
    trained = TSpade(**KW, bn_mode='train', style_encoder=True,
                     style_enc_filters=4, seed=4)
    ckpt = {'generator': trained.state_dict(), 'g_ema': None, 'step': 2}
    torch.save(ckpt, str(tmp_path / 'trained.pt'))
    got = T.build_spade_oracle(_args(str(tmp_path / 'trained.pt')))
    want = spade_frozen_from_trained(ckpt)
    assert got.style_encoder is None
    assert got.state_dict().keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got.state_dict()[k], v), k


@pytest.mark.parametrize('ipp', [False, True], ids=['opencv', 'ipp'])
def test_resize_cubic_matches_opencv(ipp):
    rng = np.random.default_rng(0)
    eps = np.finfo(np.float32).eps
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        for side in (2, 3, 4, 8, 16, 32):
            for h, w in ((320, 320), (1, 320), (33, 17), (1, 41), (3, 3),
                         (20, 6), (42, 42), (1, 1)):
                g = rng.standard_normal((side, side)).astype(np.float32)
                want = cv2.resize(g, (w, h), interpolation=cv2.INTER_CUBIC)
                got = resize_cubic(g, (h, w))
                assert got.dtype == np.float32 and got.shape == want.shape
                if ipp:
                    np.testing.assert_allclose(
                        got, want, rtol=0, atol=32 * eps * np.abs(want).max())
                else:
                    np.testing.assert_array_equal(got, want)
    finally:
        cv2.ipp.setUseIPP(before)


def test_dataset_matches_jax(tmp_path, monkeypatch):
    """`make_dataset`'s seg maps and images equal the arrays JAX hands to
    `cv2.imwrite` (its images BGR, before the JPEG encoder); the port's
    runs where neither OpenCV nor Pillow imports."""
    jmod = _jax_script('make_training_assets')
    written = {}
    jroot = str(tmp_path / 'jax')

    def imwrite(path, img):
        written[os.path.relpath(path, jroot)] = np.array(img)
        return True
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        with monkeypatch.context() as mp:
            mp.setattr(cv2, 'imwrite', imwrite)
            jmod.make_dataset(jroot, 3, 42, 5)
    finally:
        cv2.ipp.setUseIPP(before)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, 'cv2', None)
        mp.setitem(sys.modules, 'PIL', None)
        campaign.make_dataset(str(tmp_path / 'port'), 3, 42, 5)
    for i in range(3):
        with open(tmp_path / 'port' / 'seg_maps' / f'{i:05d}.png', 'rb') as f:
            seg = read_png(f.read())
        with open(tmp_path / 'port' / 'images' / f'{i:05d}.png', 'rb') as f:
            img = read_png(f.read())
        np.testing.assert_array_equal(seg, written[f'seg_maps/{i:05d}.png'])
        np.testing.assert_array_equal(img[..., ::-1],
                                      written[f'images/{i:05d}.jpg'])
        assert len(np.unique(seg)) > 1


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """`make_training_assets` at a tiny size: 2 pairs, two 64x64 scenes."""
    root = tmp_path_factory.mktemp('assets')
    data, cache = campaign.make_training_assets([
        '--outdir', str(root), '--num-images', '2', '--image-size', '32',
        '--terrain-size', '64', '--num-scenes', '2', '--crop', '64',
        '--seed', '3', '--device', 'cpu'])
    return root, data, cache


def test_training_assets_are_read_by_the_port(assets):
    from scenedreamer_tpu_torch.data.paired_dataset import PairedImageDataset
    _, data, cache = assets
    ds = PairedImageDataset(data)
    assert len(ds) == 2
    assert sorted(os.listdir(cache)) == ['000003', '000004']
    world = tvw.WorldCache(cache).sample_world(
        rng=T._RandomAdapter(np.random.default_rng(0)))
    assert world.dims[1:] == (64, 64)


def _record_worlds(mp, module, out):
    real = module.WorldCache.sample_world

    def sample_world(self, rng=None):
        world = real(self, rng=rng)
        out.append(hashlib.sha1(np.ascontiguousarray(
            world.voxel).tobytes()).hexdigest())
        return world
    mp.setattr(module.WorldCache, 'sample_world', sample_world)


@pytest.fixture(scope='module')
def pgt_sets(assets, oracle_files, tmp_path_factory):
    """The JAX script and the port's `make_pseudo_gt_set` on one seed,
    each with its worlds and its pseudo-GT calls (first-hit voxel ids,
    185-label masks, image) recorded."""
    root = tmp_path_factory.mktemp('pgt')
    flags = ['--spade-checkpoint', oracle_files['net_G'], '--terrain-cache',
             assets[2], '--num-images', str(IMAGES), '--crop', str(CROP),
             '--spade-size', '256', '--spade-res', '32', '--spade-filters',
             '4', '--seed', '2']
    rec = {}
    for name, samp, vw in (('jax', jsamp, jvw), ('port', tsamp, tvw)):
        calls, worlds = [], []
        real = samp.PseudoGTGenerator.__call__

        def call(self, voxel_id, rng, *a, real=real, calls=calls, **k):
            img, masks = real(self, voxel_id, rng, *a, **k)
            calls.append((np.asarray(voxel_id[..., 0]), np.asarray(masks),
                          np.asarray(img)))
            return img, masks
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv('SCENEDREAMER_NO_CACHE', '1')
            mp.setattr(samp.PseudoGTGenerator, '__call__', call)
            _record_worlds(mp, vw, worlds)
            out = str(root / name)
            if name == 'jax':
                # JAX's oracle stubbed: its images are not compared, and
                # its loader is held above
                mp.setattr(jtrain, '_load_spade_oracle', lambda args: (
                    lambda masks, key: jnp.zeros(masks.shape[:3] + (3,))))
                _jax_script('make_pseudo_gt_set').main(
                    flags + ['--outdir', out])
            else:
                paths = campaign.make_pseudo_gt_set(
                    flags + ['--outdir', out, '--device', 'cpu'])
                assert paths == [os.path.join(out, f'{i:05d}.png')
                                 for i in range(IMAGES)]
        rec[name] = (calls, worlds, out)
    return rec


def test_pseudo_gt_set_draws_jax_worlds_cameras_and_labels(pgt_sets):
    jcalls, jworlds, _ = pgt_sets['jax']
    tcalls, tworlds, out = pgt_sets['port']
    assert len(jworlds) == len(tworlds) == IMAGES
    assert tworlds == jworlds and len(set(jworlds)) > 1
    for i, ((jv, jm, _), (tv, tm, timg)) in enumerate(zip(jcalls, tcalls)):
        np.testing.assert_array_equal(tv, jv, err_msg=f'voxel ids {i}')
        np.testing.assert_array_equal(tm, jm, err_msg=f'labels {i}')
        assert tm.shape == (1, CROP, CROP, 185)
        with open(os.path.join(out, f'{i:05d}.png'), 'rb') as f:
            np.testing.assert_array_equal(read_png(f.read()),
                                          to_uint8(timg[0]))


@pytest.fixture(scope='module')
def generator_files(tmp_path_factory):
    """A tiny yaml; a run directory with two checkpoints written by
    `save_checkpoint` (steps 1 and 2, different weights); the step-2
    generator as a reference `.pt` (`net_G`, `module.` prefixes)."""
    root = tmp_path_factory.mktemp('gen')
    yaml_path = str(root / 'tiny.yaml')
    with open(yaml_path, 'w') as f:
        f.write(YAML)
    gcfg = T.generator_config(Config(yaml_path))
    gen = tgen.SceneDreamerGenerator(gcfg, seed=5)
    trainer = GANTrainer(gen, GANcraftDiscriminator(12, 8), None)
    ckpts = root / 'run' / 'checkpoints'
    save_checkpoint(str(ckpts), trainer, step=1)
    noise = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(torch.randn(p.shape, generator=noise), alpha=0.1)
    save_checkpoint(str(ckpts), trainer, step=2)
    ref = str(root / 'net_G.pt')
    torch.save({'net_G': {f'module.{k}': v
                          for k, v in gen.state_dict().items()}}, ref)
    return dict(yaml=yaml_path, run=str(root / 'run'), ckpt=str(
        ckpts / 'step_00000002.pt'), ref=ref, gcfg=gcfg,
        state={k: v.clone() for k, v in gen.state_dict().items()})


class _StubGenerator:
    """The JAX generator in `render_fake_set.py`, stubbed: the draws of
    worlds and cameras are compared, not the render."""

    def __init__(self, cfg):
        self.cfg = cfg

    def apply(self, params, batch, dims, key, random_style=True):
        b, h, w = batch['voxel_id'].shape[:3]
        p = self.cfg.pad // 2
        return {'fake_images': jnp.zeros((b, h - 2 * p, w - 2 * p, 3))}


def _fake_flags(cache, gen_files, *extra):
    return ['--terrain-cache', cache, '--num-images', str(IMAGES), '--crop',
            str(CROP), '--seed', '1', '--config', gen_files['yaml'], *extra]


def test_fake_set_draws_jax_worlds_and_cameras(assets, generator_files,
                                               tmp_path):
    """The JAX script (generator stubbed) and the port on one seed: the
    same worlds and accepted cameras."""
    from scenedreamer_tpu.cli import inference as jinf
    from scenedreamer_tpu.models import generator as jgen
    cache = assets[2]
    rec = {}
    for name, samp, vw in (('jax', jsamp, jvw), ('port', tsamp, tvw)):
        cams, worlds = [], []
        real = samp.CameraBatchSampler.sample

        def sample(self, world, b, rng, *a, real=real, cams=cams, **k):
            rays = real(self, world, b, rng, *a, **k)
            cams.append(np.asarray(rays['voxel_id'][..., 0]))
            return rays
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv('SCENEDREAMER_NO_CACHE', '1')
            mp.setattr(samp.CameraBatchSampler, 'sample', sample)
            _record_worlds(mp, vw, worlds)
            out = str(tmp_path / name)
            if name == 'jax':
                mp.setattr(jgen, 'SceneDreamerGenerator', _StubGenerator)
                mp.setattr(jinf, 'load_generator_params',
                           lambda *a, **k: None)
                _jax_script('render_fake_set').main(_fake_flags(
                    cache, generator_files, '--checkpoint', 'x', '--outdir',
                    out))
            else:
                campaign.render_fake_set(_fake_flags(
                    cache, generator_files, '--checkpoint',
                    generator_files['ckpt'], '--outdir', out, '--device',
                    'cpu'))
        rec[name] = (cams, worlds)
    (jcams, jworlds), (tcams, tworlds) = rec['jax'], rec['port']
    assert tworlds == jworlds and len(jworlds) == IMAGES + 1
    assert len(tcams) == len(jcams) == IMAGES
    for i, (t, j) in enumerate(zip(tcams, jcams)):
        assert t.shape == (1, CROP + 2, CROP + 2)
        np.testing.assert_array_equal(t, j, err_msg=f'camera {i}')


@pytest.mark.parametrize('source', ['ckpt', 'ref'])
def test_fake_set_is_the_live_models_render(assets, generator_files,
                                            tmp_path, source):
    """A trainer checkpoint and a reference `.pt` of the same weights:
    each written image is the quantised render of its batch by the live
    model (the step-2 weights) with the same style generator state."""
    calls = []
    real = tgen.SceneDreamerGenerator.forward

    def forward(self, data, dims, *a, generator=None, **k):
        calls.append(({n: t.clone() for n, t in data.items()}, dims,
                      generator.get_state()))
        return real(self, data, dims, *a, generator=generator, **k)
    out = str(tmp_path / 'fake')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgen.SceneDreamerGenerator, 'forward', forward)
        paths = campaign.render_fake_set(_fake_flags(
            assets[2], generator_files, '--checkpoint',
            generator_files[source], '--outdir', out, '--device', 'cpu'))
    live = tgen.SceneDreamerGenerator(generator_files['gcfg'])
    live.load_state_dict(generator_files['state'])
    live.eval()
    assert len(paths) == len(calls) == IMAGES
    for path, (data, dims, state) in zip(paths, calls):
        with torch.no_grad():
            img = live(data, dims, random_style=True,
                       generator=torch.Generator().set_state(state))
        with open(path, 'rb') as f:
            got = read_png(f.read())
        assert got.shape == (CROP, CROP, 3)
        np.testing.assert_array_equal(
            got, to_uint8(img['fake_images'][0]))


def test_fake_set_refuses_a_cache_of_mixed_dims(assets, generator_files,
                                                tmp_path):
    from scenedreamer_tpu_torch.scene import terrain
    cache = tmp_path / 'mixed'
    cache.mkdir()
    os.symlink(os.path.join(assets[2], '000003'), cache / '000003')
    maps = terrain.generate_terrain(size=48, seed=4, n_voronoi=20,
                                    relax_iters=2)
    tvw.save_world_cache(tvw.build_voxel_world(
        maps.height_map, maps.semantic_map, maps.tree_map, fill_depth=8,
        seed=4, crop=False), str(cache / '000004'))
    with pytest.raises(ValueError, match='mixes sizes'):
        campaign.render_fake_set(_fake_flags(
            str(cache), generator_files, '--checkpoint',
            generator_files['ckpt'], '--outdir', str(tmp_path / 'fake'),
            '--device', 'cpu'))


def test_campaign_eval_table_matches_jax_evaluate(assets, generator_files,
                                                  pgt_sets, tmp_path,
                                                  monkeypatch):
    """Two checkpoints -> a two-row `fid_table.json`; its pixel FID / KID
    against JAX's `cli.evaluate` on the same folders; a second run reuses
    the fake sets on disk."""
    monkeypatch.setenv('SCENEDREAMER_NO_CACHE', '1')
    real = pgt_sets['port'][2]
    out = str(tmp_path / 'eval')
    argv = ['--run-dir', generator_files['run'], '--real-dir', real,
            '--terrain-cache', assets[2], '--outdir', out, '--num-images',
            str(IMAGES), '--crop', str(CROP), '--config',
            generator_files['yaml'], '--image-size', '32', '--device', 'cpu']
    rows = campaign.campaign_eval(argv)
    with open(os.path.join(out, 'fid_table.json')) as f:
        assert json.load(f) == rows
    assert [r['step'] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {'step'} | {f'{m}_{ex}' for m in ('fid', 'kid')
                                     for ex in CAMPAIGN}
        assert all(math.isfinite(v) for v in r.values())
        fake = os.path.join(out, f'fake_{r["step"]:06d}')
        path = str(tmp_path / f'jax_{r["step"]}.json')
        jevaluate.main(['--real-dir', real, '--fake-dir', fake,
                        '--image-size', '32', '--extractor', 'pixel',
                        '--output', path])
        with open(path) as f:
            want = json.load(f)
        for k in ('fid', 'kid'):
            assert abs(r[f'{k}_pixel'] - want[k]) \
                <= 1e-3 * abs(want[k]) + 1e-6, (k, r, want)
    assert rows[0]['fid_pixel'] != rows[1]['fid_pixel']
    with monkeypatch.context() as mp:
        mp.setattr(campaign, 'render_fake_set', None)
        assert campaign.campaign_eval(argv) == rows


@pytest.mark.parametrize('name', ['make_training_assets',
                                  'make_pseudo_gt_set', 'render_fake_set',
                                  'campaign_eval', 'smoke_render'])
def test_tools_default_to_cuda(name, tmp_path):
    """Every entry point refuses to run without a GPU unless the CPU is
    asked for, before any work; and its module and script import none of
    jax, OpenCV, Pillow or the JAX package."""
    argv = {'make_training_assets': ['--outdir', str(tmp_path)],
            'make_pseudo_gt_set': ['--spade-checkpoint', 'x',
                                   '--terrain-cache', 'x', '--outdir', 'x'],
            'render_fake_set': ['--checkpoint', 'x', '--terrain-cache', 'x',
                                '--outdir', 'x'],
            'campaign_eval': ['--run-dir', 'x', '--real-dir', 'x',
                              '--terrain-cache', 'x', '--outdir', 'x'],
            'smoke_render': []}[name]
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        getattr(campaign, name)(argv)
    assert not os.listdir(tmp_path)
    for path in (campaign.__file__,
                 os.path.join(REPO, 'scripts', f'torch_{name}.py')):
        with open(path) as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        top = {m.split('.')[0] for m in mods}
        assert not top & {'jax', 'flax', 'cv2', 'PIL', 'scenedreamer_tpu'}
