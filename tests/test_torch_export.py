"""The port's serving artifact: `TiledRenderer.export_tile` (`torch.export`
of the padded-tile program, the forward hash kernels and the RenderMLP's
hidden layers as `sd::` ops) and `load_exported`.

Held against JAX's `export_tile` -> `load_exported` round trip on the
inputs of `tests/test_render.py::test_export_tile_round_trip` (tile 16,
pad 6, numpy rng 0) with the converted TINY weights: image within the
golden tests' IMG_ATOL (1e-3), depth within 1e-3 where finite and inf
on the same rays. The loaded program is held against the live tile
(`render_tile`) at JAX's own round-trip tolerances (image 1e-5, depth
1e-4) for the xor, paired and an unfoldable spec (K2, K5, K4 on the
card; their plain versions here), at batch 1 and 2."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from scenedreamer_tpu.render.pipeline import TiledRenderer as JRenderer
from scenedreamer_tpu_torch import kernels
from scenedreamer_tpu_torch.data.synthetic import make_world
from scenedreamer_tpu_torch.models import generator as tgen
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.ops import hashgrid
from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
from scenedreamer_tpu_torch.scene import labels
from scenedreamer_tpu_torch.scene.camera import EvalCameraController
from _torch_parity import cap_torch_threads, port_config, tiny_models
from test_golden import IMG_ATOL, KW, TINY

cap_torch_threads()

TILE = 16
PORT_KW = {k: v for k, v in KW.items() if k != 'fov'}
# the ops each spec's program names: its hash ops (the unfoldable spec,
# level 0 dense at 9^5 cells under 2^16 rows, has no bake) and the
# RenderMLP's hidden layers
SPECS = {
    'xor': (TINY, {'hash_bake', 'hash_encode', 'render_mlp_gemm'}),
    'paired': (dataclasses.replace(TINY, hash_variant='paired'),
               {'hash_shift_bake', 'hash_encode_paired', 'render_mlp_gemm'}),
    'unfolded': (dataclasses.replace(TINY, hash_base_resolution=8,
                                     hash_log2_size=16),
                 {'hash_encode_general', 'render_mlp_gemm'}),
}
ALL_OPS = {'hash_bake', 'hash_shift_bake', 'hash_encode',
           'hash_encode_paired', 'hash_encode_general', 'render_mlp_gemm'}


def tile_inputs(r, z, b=1, seed=0):
    """`test_render.py`'s tile inputs for renderer `r` (numpy rng),
    stacked to batch `b`, with the style rows `z` [b, S], the scene code
    and, for b = 2, a second, halved one, and the tile's sky average."""
    t = r.tile + r.pad
    rng = np.random.default_rng(seed)
    vid = rng.integers(0, 3, (b, t, t, r.m)).astype(np.int32)
    dep = (np.sort(rng.random((b, t, t, r.m, 2)), axis=-1) * 10
           + 1.0).astype(np.float32)
    hit = rng.random((b, t, t, r.m)) < 0.7
    rd = rng.normal(size=(b, t, t, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ori = np.array([[32.0, 40.0, 32.0], [30.0, 45.0, 20.0]][:b], np.float32)
    genc = torch.cat([r.global_enc, r.global_enc * 0.5])[:b]
    rd = torch.from_numpy(rd)
    return (torch.from_numpy(vid), torch.from_numpy(dep),
            torch.from_numpy(hit), rd, torch.from_numpy(ori), z, genc,
            r.sky_avg(rd, z))


def assert_tile_close(got, want, img_atol, depth_atol):
    (img, dep), (img_w, dep_w) = [[np.asarray(x) for x in pair]
                                  for pair in (got, want)]
    assert img.shape == img_w.shape and dep.shape == dep_w.shape
    np.testing.assert_allclose(img, img_w, atol=img_atol, rtol=0)
    fin = np.isfinite(dep_w)
    # sky rays are inf in both: compare where finite, the mask exactly
    np.testing.assert_array_equal(np.isfinite(dep), fin)
    np.testing.assert_allclose(dep[fin], dep_w[fin], atol=depth_atol, rtol=0)


def graph_ops(program):
    return {n.target.name().split('::')[1].split('.')[0]
            for n in program.graph.nodes
            if n.op == 'call_function' and str(n.target).startswith('sd.')}


def clear_caches():
    for fn in (tgen._delim, hashgrid._scales, hashgrid.general_meta,
               labels.get_label_translator):
        fn.cache_clear()


def spec_run(name):
    """One spec's renderer (seeded weights, the hash table redrawn in
    [-1, 1] so its rows matter) and a frame; then, with every cache of
    device tensors cleared, the export at batch 1 and 2 (the first calls
    to reach the caches), the same frame again and the loaded
    programs."""
    cfg, ops = SPECS[name]
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    model = SceneDreamerGenerator(port_config(cfg), seed=3)
    table = model.hash_encoder.embeddings
    with torch.no_grad():
        table.copy_(torch.from_numpy(np.random.default_rng(9).uniform(
            -1, 1, table.shape).astype(np.float32)))
    r = TiledRenderer(model, world, tile_size=TILE, device='cpu', **PORT_KW)
    styles = np.random.default_rng(5).standard_normal((2, cfg.style_dims))
    z = r.style_z(styles)
    pose = EvalCameraController(world, maxstep=4, pattern=0)[0]
    before = r.frame(pose, z[:1])
    clear_caches()
    blobs = {b: r.export_tile(z[:1], batch=b) for b in (1, 2)}
    after = r.frame(pose, z[:1])
    return dict(r=r, z=z, ops=ops, blob=blobs[1], frames=(before, after),
                loaded={b: TiledRenderer.load_exported(blob)
                        for b, blob in blobs.items()})


@pytest.fixture(scope='module')
def runs():
    return {name: spec_run(name) for name in SPECS}


def test_matches_jax_export_round_trip(tmp_path):
    """The port's loaded program and JAX's, each exported by its own
    renderer from the same weights, on the same tile."""
    world, jmodel, params, tmodel, _ = tiny_models(serving=True)
    style = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                         (1, TINY.style_dims)))
    jr = JRenderer(jmodel, params, world, tile_size=TILE, **KW)
    jz = jr.style_z(style)
    jfn = JRenderer.load_exported(jr.export_tile(jz))
    tr = TiledRenderer(tmodel, world, tile_size=TILE, device='cpu',
                       **PORT_KW)
    path = os.path.join(tmp_path, 'tile.pt2')
    blob = tr.export_tile(tr.style_z(style), path=path)
    assert os.path.getsize(path) == len(blob) > 0
    tfn = TiledRenderer.load_exported(path)
    vid, dep, hit, rd, ori, tz, genc, sky = tile_inputs(tr, tr.style_z(style))
    jsky = jr._sky_avg_fn(jr.params, rd.numpy(), jz)
    want = jfn(jr.params, vid.numpy(), dep.numpy(), hit.numpy(), rd.numpy(),
               ori.numpy(), jz, jr.global_enc, jsky, jax.random.PRNGKey(7))
    got = tfn(vid, dep, hit, rd, ori, tz, genc, sky)
    assert got[0].shape == (1, TILE, TILE, 3)
    assert 0 < np.isfinite(want[1]).mean() < 1     # ground and sky rays
    assert_tile_close(got, want, IMG_ATOL, 1e-3)


@pytest.mark.parametrize('spec', SPECS)
def test_graph_names_spec_ops(runs, spec):
    run = runs[spec]
    for program in run['loaded'].values():
        assert graph_ops(program) == run['ops']
        assert not graph_ops(program) & (ALL_OPS - run['ops'])


@pytest.mark.parametrize('spec', SPECS)
@pytest.mark.parametrize('b', [1, 2])
def test_loaded_matches_live(runs, spec, b):
    r, z = runs[spec]['r'], runs[spec]['z']
    args = tile_inputs(r, z[:b], b)
    kernels.reset_launch_counts()
    got = runs[spec]['loaded'][b](*args)
    want = r.render_tile(*args)
    assert not any(kernels.launch_counts().values())
    assert got[0].shape == (b, TILE, TILE, 3)
    assert 0 < torch.isfinite(want[1]).float().mean() < 1
    assert_tile_close(got, want, 1e-5, 1e-4)


@pytest.mark.parametrize('spec', SPECS)
def test_frame_after_export_equals_frame_before(runs, spec):
    """The export was the first call to reach the caches of device
    tensors: the live frame after it equals the one before, bit for
    bit."""
    before, after = runs[spec]['frames']
    np.testing.assert_array_equal(after, before)


@pytest.mark.parametrize('spec', SPECS)
def test_scene_code_out_of_bounds(runs, spec):
    """A scene code outside [-1, 1]: the folded specs zero every hash
    feature through the flag tensor, the unfolded one each point; the
    loaded program still equals the live tile."""
    r, z = runs[spec]['r'], runs[spec]['z']
    args = list(tile_inputs(r, z[:1]))
    args[6] = torch.tensor([[1.5, -0.25]])
    assert_tile_close(runs[spec]['loaded'][1](*args), r.render_tile(*args),
                      1e-5, 1e-4)


def test_fresh_process_loads_without_model_code(runs, tmp_path):
    """A new interpreter loads each spec's artifact and calls it,
    importing neither `scenedreamer_tpu_torch.models` nor JAX."""
    for name, run in runs.items():
        with open(os.path.join(tmp_path, f'{name}.pt2'), 'wb') as f:
            f.write(run['blob'])
        np.savez(os.path.join(tmp_path, f'{name}_in.npz'),
                 *[a.numpy() for a in tile_inputs(run['r'], run['z'][:1])])
    code = (
        'import sys, numpy as np, torch\n'
        'torch.set_num_threads(2)\n'
        'from scenedreamer_tpu_torch.render.pipeline import TiledRenderer\n'
        'd = sys.argv[1]\n'
        'for name in sys.argv[2:]:\n'
        '    fn = TiledRenderer.load_exported(f"{d}/{name}.pt2")\n'
        '    a = np.load(f"{d}/{name}_in.npz")\n'
        '    img, dep = fn(*[torch.from_numpy(a[f"arr_{i}"])\n'
        '                    for i in range(8)])\n'
        '    np.savez(f"{d}/{name}_out.npz", img=img.numpy(),\n'
        '             dep=dep.numpy())\n'
        'assert "scenedreamer_tpu_torch.models" not in sys.modules\n'
        'assert "jax" not in sys.modules\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, '-c', code, str(tmp_path), *runs],
                   env=env, check=True, timeout=300, cwd=root)
    for name, run in runs.items():
        out = np.load(os.path.join(tmp_path, f'{name}_out.npz'))
        want = run['r'].render_tile(*tile_inputs(run['r'], run['z'][:1]))
        assert_tile_close((out['img'], out['dep']), want, 1e-5, 1e-4)
