"""The PyTorch port stands alone: it imports without JAX, never names the
JAX package, and its entry points refuse to run on a missing GPU unless
the caller asks for the CPU."""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch
from _torch_parity import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'scenedreamer_tpu_torch')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'scenedreamer_tpu'}


def _port_files():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    files += glob.glob(os.path.join(REPO, 'scripts', 'torch_*.py'))
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "import scenedreamer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'scenedreamer_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'scenedreamer_tpu' or "
        "k.startswith('scenedreamer_tpu.') for k in sys.modules)\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 30


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or '']
        else:
            continue
        for mod in mods:
            assert mod.split('.')[0] not in FORBIDDEN, (path, mod)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the default device is usable')
    from scenedreamer_tpu_torch.cli import demo, inference
    from scenedreamer_tpu_torch.device import resolve_device
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                        render_trajectory)
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world
    assert resolve_device('cpu').type == 'cpu'
    maps = generate_terrain(size=32, seed=3, n_voronoi=8, relax_iters=1)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=4,
                              boundary_detect=2)
    model = SceneDreamerGenerator(GeneratorConfig(
        hash_num_levels=4, hash_level_dim=4, hash_log2_size=10,
        hash_desired_resolution=128, mlp_hidden=16))
    with pytest.raises(RuntimeError, match='CUDA'):
        TiledRenderer(model, world)
    with pytest.raises(RuntimeError, match='CUDA'):
        render_trajectory(model, world, torch.zeros(1, 128), str(tmp_path))
    with pytest.raises(RuntimeError, match='CUDA'):
        inference.main(['--output_dir', str(tmp_path)])
    with pytest.raises(RuntimeError, match='CUDA'):
        TiledRenderer(model, world, split_refine=False)
    with pytest.raises(RuntimeError, match='CUDA'):
        demo.main(['--output_dir', str(tmp_path)])


@pytest.mark.parametrize('flags,raises', [
    (['--platform', 'gpu'], RuntimeError),
    (['--platform', 'cuda'], RuntimeError),
    (['--platform', 'cuda', '--amp', '--no_split_refine', '--save_depth',
      '--style2', 'seed:1', '--tiles_per_batch', '2', '--tile_size', '64',
      '--fps', '5'], RuntimeError),
    (['--platform', 'tpu'], ValueError),
    (['--mesh_tiles'], RuntimeError)])
def test_inference_flags_follow_the_device_rule(tmp_path, flags, raises):
    """The inference CLI's flags go through the device rule before any
    work: `--platform gpu` / `cuda` means CUDA (absent here), another
    platform is refused, and `--mesh_tiles` (every visible GPU) needs
    CUDA like the default device."""
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the default device is usable')
    from scenedreamer_tpu_torch.cli import inference
    with pytest.raises(raises):
        inference.main(['--output_dir', str(tmp_path)] + flags)


@pytest.mark.parametrize('module', ['cli.demo', 'cli.inference',
                                    'render.pipeline',
                                    'utils.visualization', 'utils.convert'])
def test_serving_modules_are_in_the_walk(module):
    """Each module of the serving slice exists in the package, so the
    walks above cover it."""
    assert os.path.join(PKG, *module.split('.')) + '.py' in _port_files()


@pytest.mark.parametrize('module', [
    'cli.train', 'models.spade', 'train.sampling', 'data.paired_dataset',
    'utils.config', 'utils.meters', 'utils.visualization', 'utils.profiling',
    'utils.png', 'ops.masks'])
def test_training_loop_modules_are_in_the_walk(module):
    """Each module of the training-loop slice exists in the package, so
    the walks above cover it."""
    path = os.path.join(PKG, *module.split('.')) + '.py'
    assert path in _port_files()


@pytest.mark.parametrize('module', ['ops.encoders', 'ops.hashgrid'])
def test_general_encode_modules_are_in_the_walk(module):
    """The general hash encode's modules are walked above (so they import
    without JAX), and its CUDA source is one the build compiles."""
    from scenedreamer_tpu_torch import kernels
    assert os.path.join(PKG, *module.split('.')) + '.py' in _port_files()
    assert kernels.SOURCES['hashgrid_general'] == 'hashgrid_general.cu'
    assert os.path.exists(os.path.join(kernels.CSRC, 'hashgrid_general.cu'))


def test_training_cli_defaults_to_cuda(tmp_path):
    """`cli.train.main` resolves its device before it touches the data:
    without a GPU it raises unless `--device cpu` is given."""
    if torch.cuda.is_available():
        pytest.skip('CUDA present: the default device is usable')
    from scenedreamer_tpu_torch.cli import train
    argv = ['--data-root', str(tmp_path), '--terrain-cache', str(tmp_path)]
    with pytest.raises(RuntimeError, match='CUDA'):
        train.main(argv)
    with pytest.raises(FileNotFoundError):      # past the device check
        train.main(argv + ['--device', 'cpu'])
