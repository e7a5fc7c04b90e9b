"""CPU tests of the benchmark harness (`portbench/`): cells, files and
metrics found by name; the result line's schema; the yardstick's counts
against the port's published kernel table; the check for JAX; the weights
from the seed. Runs of the tiny fixture cells go through the program's
plain CPU paths."""
import ast
import json
import os

import pytest

import pb_support as S

from portbench import harness, weights, yardstick


def test_every_cell_resolves_by_name():
    bench = harness.Bench()
    spec = bench.spec
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    for w in spec['workloads']:
        entry, conf, config, traffic, limits = bench.cell(w['name'])
        assert os.path.exists(os.path.join(S.ROOT, conf['file']))
        assert hasattr(bench.driver(traffic), 'main')
        assert limits
        for m in bench.metrics_for(w['name'], 'per_layer'):
            assert callable(bench.reader(m['name']))
        names = {m['name'] for m in bench.metrics_for(w['name'],
                                                      'end_to_end')}
        assert 'setup_s' in names and len(names) >= 2
        assert bench.metrics_for(w['name'], 'per_layer')


def test_every_per_layer_metric_moves_what_its_cells_report():
    bench = harness.Bench()
    for m in bench.spec['per_layer']:
        for w in m['workloads']:
            e2e = {x['name'] for x in bench.metrics_for(w, 'end_to_end')}
            assert m['moves'] in e2e, (m['name'], w)


@pytest.mark.parametrize('workload,trace', [('tiny.serve', 0),
                                            ('tiny.serve', 1),
                                            ('tiny.step', 0),
                                            ('tiny.step', 1)])
def test_result_line_schema(tmp_path, workload, trace):
    code, line, err = S.run_tiny(str(tmp_path), workload, trace=trace)
    assert code == 0, err
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                              'device']
    assert list(line)[-1] == 'checks'
    assert ('breakdown' in line) == bool(trace)
    assert line['correct'] is True, line['checks']
    assert line['attempted'] > 0 and line['failed'] == 0
    bench = S.tiny_bench(str(tmp_path))
    kind = 'per_layer' if trace else 'end_to_end'
    want = {m['name']: m['unit'] for m in bench.metrics_for(workload, kind)}
    for name, m in line['metrics'].items():
        assert m['unit'] == want[name]
    if not trace:
        assert set(line['metrics']) == set(want)
    else:
        assert {'busy_s', 'window_s'} <= set(line['device'])
        assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
    assert {'platform', 'kind', 'count',
            'memory_peak_bytes'} <= set(line['device'])
    for name, c in line['checks'].items():
        assert set(c) == {'value', 'limit'}
        assert f'check {name}:' in err


def test_fixture_cell_and_metric_are_files_alone(tmp_path):
    """The test-only cell `tiny.extra` (a new mix, its limits and a new
    per-layer metric, each a new file, named in `fixtures/extra.json`)
    runs and reports its metric with no edit of a file that is there."""
    code, line, err = S.run_tiny(str(tmp_path), 'tiny.extra', trace=1)
    assert code == 0, err
    assert line['correct'] is True
    assert line['metrics']['frames_seen.extra']['value'] >= 1
    assert 'frames_seen.extra' not in json.dumps(harness.Bench().spec)


def test_k3a_bound_of_the_kernel_table():
    """PERF.md's K3a bound: 1,647,456 points x (128 + 3) x 4 B plus the
    268 MB table at 3.35 TB/s is 0.338 ms."""
    cfg = _config('scenedreamer_train')
    points = 262 * 262 * cfg['num_samples']
    assert points == 1647456
    ms = yardstick.k3a_bytes(points, cfg) / yardstick.HBM_BYTES_PER_S * 1e3
    assert round(ms, 3) == 0.338
    assert yardstick.table_bytes(cfg) == 268435456


def test_flop_and_byte_counts_from_shapes():
    cfg = _config('scenedreamer_infer')
    assert yardstick.render_mlp_flops_per_point(cfg) == 2 * (
        128 * 256 + 12 * 256 + 5 * 256 * 256 + 256 + 256 * 64)
    assert yardstick.sky_mlp_flops_per_ray(cfg) == 2 * (
        33 * 256 + 4 * 256 * 256 + 256 * 64)
    assert yardstick.render_cnn_flops_per_px(cfg) == 2 * (
        64 * 256 + 4 * 9 * 256 * 256 + 2 * 256 * 256 + 256 * 3)
    assert yardstick.k2b_bytes(1306800, cfg) == 1306800 * 131 * 4
    mlp, total = yardstick.serve_frame_flops(cfg, 1000, 2000)
    assert mlp == 1000 * 40 * yardstick.render_mlp_flops_per_point(cfg) \
        + 2000 * yardstick.sky_mlp_flops_per_ray(cfg)
    assert total == mlp + 2000 * yardstick.render_cnn_flops_per_px(cfg)


def test_side_flops_count_convolutions_by_shape():
    """The discriminator's first conv alone is 3 -> 128 channels, 3x3,
    stride 2 at 256x256: its share is counted, and the whole is the sum
    the flop counter gives."""
    side = yardstick.train_step_side_flops(_config('scenedreamer_train'))
    assert side['dis'] > 2 * 128 * 128 * 128 * 27
    assert side['vgg'] > side['style_enc'] > 0 and side['world_enc'] > 0


def test_banned_modules_compare_whole_top_level_names():
    assert harness.banned_modules(
        ['jax.numpy', 'scenedreamer_tpu.ops.hashgrid', 'flax',
         'scenedreamer_tpu_torch.kernels', 'jaxtyping', 'jaxlib.xla']) == \
        ['flax', 'jax', 'jaxlib', 'scenedreamer_tpu']
    assert harness.banned_modules(['scenedreamer_tpu_torch',
                                   'portbench.run']) == []


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(S.PB):
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            mods = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods |= {a.name for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods.add(node.module)
            assert not harness.banned_modules(mods), (path, mods)


def test_reference_imports_nothing_of_the_program():
    for dirpath, _, files in os.walk(os.path.join(S.PB, 'reference')):
        for name in files:
            if name.endswith('.py'):
                with open(os.path.join(dirpath, name)) as f:
                    assert 'scenedreamer_tpu_torch' not in f.read(), name


def test_weights_follow_names_not_order():
    import torch
    a = {'gen.b.weight': torch.empty(4, 3), 'gen.a.bias': torch.empty(4),
         'gen.hash_encoder.embeddings': torch.empty(5, 2)}
    b = {k: torch.empty_like(a[k]) for k in reversed(list(a))}
    weights.fill_tensors_(a, 2 ** 33 + 1, torch.device('cpu'))
    weights.fill_tensors_(b, 2 ** 33 + 1, torch.device('cpu'))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a['gen.a.bias'].abs().sum() == 0
    assert a['gen.hash_encoder.embeddings'].abs().max() <= 1e-4
    with pytest.raises(ValueError):
        weights.fill_tensors_({'gen.x.running_mean': torch.empty(3)}, 1,
                              torch.device('cpu'))


def test_large_seeds_make_distinct_streams():
    s = [weights.stream_seed(2 ** 31 + k, 'styles') for k in range(3)]
    assert len(set(s)) == 3 and all(0 <= x < 2 ** 63 for x in s)
    assert weights.stream_seed(5, 'a') == weights.stream_seed(5, 'a')


def _config(name):
    with open(os.path.join(S.PB, 'configs', f'{name}.json')) as f:
        return json.load(f)


def _run_py(cwd, *extra):
    import subprocess
    import sys
    return subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'sd_serve.flyover',
         '--seed', str(2 ** 31 + 5), '--seconds', '1', '--trace', '0',
         *extra], cwd=cwd, capture_output=True, text=True, timeout=600)


def test_refuses_without_the_chips_or_the_program(tmp_path):
    """No result and a non-zero exit without CUDA devices (this sandbox)
    and in a directory holding only BENCHMARK.json and `portbench/`."""
    import shutil
    import torch
    if torch.cuda.is_available():
        pytest.skip('the card is here: the look for a chip passes')
    got = _run_py(S.ROOT)
    assert got.returncode != 0 and not got.stdout.strip(), got.stderr
    shutil.copy(os.path.join(S.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(S.PB, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))
    got = _run_py(str(tmp_path))
    assert got.returncode != 0 and not got.stdout.strip(), got.stderr
