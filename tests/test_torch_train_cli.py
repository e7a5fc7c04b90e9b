"""The port's training CLI (`scenedreamer_tpu_torch.cli.train`) on the
CPU at a tiny size, on both hash variants: metrics, checkpoints, resume,
prefetch, termination. Dataset, terrain cache and yaml are made with the
port alone. Not compared step by step with the JAX CLI (the step itself
is held by `test_torch_train.py`, the batch by `test_torch_sampling.py`).

Prefetch on and off must give the same metrics: one ordered worker and
generators seeded on the main thread leave the order of all draws
unchanged; held to 5e-3 relative: the batch build's CPU kernels split
their work differently on the worker thread and on the main thread, the
bf16 oracle turns that into rounding differences of the pseudo ground
truth (seen: 1.5e-4 relative on `gen/l2`), and four training steps
carry it into the gradient norms. Another order of world draws moves
`gen/l2` and `gen/grad_norm` by 3% to 38% (the totals, which the GAN
terms dominate at this size, move less and decide nothing here)."""
import glob
import json
import math
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from scenedreamer_tpu_torch.cli import train as cli
from scenedreamer_tpu_torch.data.synthetic import make_paired_folder
from scenedreamer_tpu_torch.scene import terrain, voxel_world
from _torch_parity import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = """
logging_iter: 1
snapshot_save_iter: 3
image_save_iter: 2
gen:
  crop_size: [24, 24]
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
  hash_variant: {variant}
  mlp_hidden: 16
  camera_min_entropy: 0.2
  camera_rej_avg_depth: 2.0
  label_smooth_dia: 5
  style_enc:
    num_filters: 4
dis:
  num_filters: 8
trainer:
  loss_weight:
    l2: 10.0
    gan: 0.5
    pseudo_gan: 0.5
    kl: 0.05
{extra}
data:
  num_workers: 2
"""


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_cli')
    make_paired_folder(str(root / 'data'), n=8, size=40, seed=0)
    for i, seed in enumerate((3, 4)):
        maps = terrain.generate_terrain(size=64, seed=seed, n_voronoi=20,
                                        relax_iters=2)
        world = voxel_world.build_voxel_world(
            maps.height_map, maps.semantic_map, maps.tree_map, fill_depth=8,
            seed=seed, boundary_detect=4, crop=False)
        voxel_world.save_world_cache(world, str(root / 'cache' / f'{i:06d}'))
    configs = {}
    for variant in ('xor', 'paired'):
        configs[variant] = str(root / f'{variant}.yaml')
        with open(configs[variant], 'w') as f:
            f.write(YAML.format(variant=variant, extra=''))
    configs['reset'] = str(root / 'reset.yaml')
    with open(configs['reset'], 'w') as f:
        f.write(YAML.format(variant='paired',
                            extra='  reset_opt_g_on_resume: true\n'
                                  '  reset_opt_d_on_resume: true'))
    configs['amp'] = str(root / 'amp.yaml')
    with open(configs['amp'], 'w') as f:
        f.write(YAML.format(
            variant='xor', extra='  amp_config:\n    enabled: true\n'
                                 '  aug_policy: color,translation,cutout')
            .replace('dis:\n', 'dis:\n  smooth_resample: false\n'))
    return root, configs


def _argv(root, config, logs, *extra):
    return ['--config', config, '--data-root', str(root / 'data'),
            '--terrain-cache', str(root / 'cache'), '--logdir',
            str(root / logs), '--device', 'cpu', '--spade-size', '256',
            '--spade-res', '48', '--spade-filters', '4', '--seed', '1',
            *extra]


def _series(logdir):
    out = {}
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k not in ('t', 'step'):
                    out.setdefault(k, []).append((rec['step'], v))
    return out


def _newest(root, logs):
    return max(glob.glob(str(root / logs / '*')), key=os.path.getmtime)


@pytest.fixture(scope='module')
def first_runs(setup):
    """Four iterations on each variant (prefetch on)."""
    root, configs = setup
    out = {}
    for variant in ('xor', 'paired'):
        cli.main(_argv(root, configs[variant], f'logs_{variant}',
                       '--max-iter', '4'))
        out[variant] = _newest(root, f'logs_{variant}')
    return out


@pytest.mark.parametrize('variant', ['xor', 'paired'])
def test_four_iterations_write_metrics_and_checkpoints(first_runs, variant):
    logdir = first_runs[variant]
    series = _series(logdir)
    for name in ('gen/total', 'dis/total', 'gen/l2', 'gen/kl',
                 'gen/grad_norm', 'dis/grad_norm', 'perf/iters_per_s',
                 'sampler/fallback_rate'):
        assert [s for s, _ in series[name]] == [1, 2, 3, 4], name
    for name, points in series.items():
        assert all(math.isfinite(v) for _, v in points), name
    ckpts = os.path.join(logdir, 'checkpoints')
    assert sorted(os.listdir(ckpts)) == [
        'latest_checkpoint.txt', 'step_00000003.pt', 'step_00000004.pt']
    with open(os.path.join(ckpts, 'latest_checkpoint.txt')) as f:
        assert f.read().strip() == 'step_00000004.pt'
    sd = torch.load(os.path.join(ckpts, 'step_00000004.pt'),
                    weights_only=True)
    assert sd['step'] == 4
    assert sorted(os.listdir(os.path.join(logdir, 'images'))) == [
        'train_snapshot_00000002.png', 'train_snapshot_00000004.png']


def test_variants_train_different_tables(first_runs):
    """The yaml's `gen.hash_variant` reaches the hash encode: after the
    same four batches the two variants' tables differ."""
    tables = [torch.load(os.path.join(first_runs[v], 'checkpoints',
                                      'step_00000004.pt'), weights_only=True)
              ['generator']['hash_encoder.embeddings']
              for v in ('xor', 'paired')]
    assert tables[0].shape == tables[1].shape
    assert not torch.equal(tables[0], tables[1])


@pytest.mark.parametrize('config', ['paired', 'reset'])
def test_resume_continues_from_the_checkpoint(setup, first_runs, capsys,
                                              config):
    root, configs = setup
    capsys.readouterr()
    cli.main(_argv(root, configs[config], 'logs_paired', '--max-iter', '6',
                   '--resume'))
    out = capsys.readouterr().out
    assert 'resumed at iteration 4' in out
    assert ('reset opt_G state' in out) == (config == 'reset')
    assert ('reset opt_D state' in out) == (config == 'reset')
    logdir = _newest(root, 'logs_paired')
    assert logdir != first_runs['paired']
    series = _series(logdir)
    assert [s for s, _ in series['gen/total']] == [5, 6]
    with open(os.path.join(logdir, 'checkpoints',
                           'latest_checkpoint.txt')) as f:
        assert f.read().strip() == 'step_00000006.pt'
    # the later run's checkpoint is older than nothing: remove it so the
    # next resume starts from iteration 4 again
    os.remove(os.path.join(logdir, 'checkpoints', 'latest_checkpoint.txt'))


@pytest.mark.parametrize('flag', ['--no-prefetch', '--speed-benchmark'])
def test_prefetch_does_not_change_the_batches(setup, first_runs, flag):
    root, configs = setup
    cli.main(_argv(root, configs['paired'], 'logs_serial', '--max-iter', '4',
                   flag))
    got = _series(_newest(root, 'logs_serial'))
    want = _series(first_runs['paired'])
    for name in ('gen/total', 'dis/total', 'gen/l2', 'gen/grad_norm',
                 'sampler/fallback_rate'):
        assert [s for s, _ in got[name]] == [s for s, _ in want[name]]
        for (_, a), (_, b) in zip(got[name], want[name]):
            assert a == pytest.approx(b, rel=5e-3), name
    if flag == '--speed-benchmark':
        for phase in ('batch_build', 'train_step', 'world_sample'):
            assert all(v > 0 for _, v in got[f'speed/{phase}_ms'])
        assert [s for s, _ in got['speed/world_sample_ms']] == [2, 3, 4]


def test_two_forward_step_runs(setup):
    root, configs = setup
    cli.main(_argv(root, configs['xor'], 'logs_two', '--max-iter', '2',
                   '--two-forward', '--world-switch-every', '100'))
    series = _series(_newest(root, 'logs_two'))
    assert [s for s, _ in series['gen/total']] == [1, 2]


def test_amp_diff_aug_and_profile(setup, capsys):
    """`amp_config.enabled: true` with DiffAugment, the nearest label
    resize and `--profile`: bf16 models, float32 checkpointed parameters
    and optimizer state, finite meters, and a Chrome trace of the
    iterations from the third on, closed when the run ends inside the
    window (3 iterations run)."""
    root, configs = setup
    capsys.readouterr()
    cli.main(_argv(root, configs['amp'], 'logs_amp', '--max-iter', '3',
                   '--profile'))
    out = capsys.readouterr().out
    logdir = _newest(root, 'logs_amp')
    series = _series(logdir)
    assert [s for s, _ in series['gen/total']] == [1, 2, 3]
    assert all(math.isfinite(v) for pts in series.values() for _, v in pts)
    sd = torch.load(os.path.join(logdir, 'checkpoints', 'step_00000003.pt'),
                    weights_only=True)
    for part in ('generator', 'discriminator'):
        assert {v.dtype for v in sd[part].values()
                if v.is_floating_point()} == {torch.float32}
    assert all(v.dtype == torch.float32 for st in sd['g_opt']['adam'][
        'state'].values() for v in st.values() if torch.is_tensor(v)
        and v.is_floating_point())
    (trace,) = glob.glob(os.path.join(logdir, 'trace', '*.json'))
    assert f'trace written to {trace}' in out
    with open(trace) as f:
        events = json.load(f)['traceEvents']
    assert any('train_step' in str(e.get('name', '')) or
               'conv' in str(e.get('name', '')) for e in events)


def test_lmdb_raises(setup):
    """`--dataset-type lmdb` on a data root that holds no database
    raises; on the databases `cli.build_db` makes of the data folder, one
    iteration gives the folder run's meters (the same items, read by the
    loader's threads)."""
    from scenedreamer_tpu_torch.cli import build_db
    root, configs = setup
    with pytest.raises((ImportError, FileNotFoundError)):
        cli.main(_argv(root, configs['xor'], 'logs_lmdb', '--max-iter', '1',
                       '--dataset-type', 'lmdb'))
    build_db.main(['--data_root', str(root / 'data'), '--output_root',
                   str(root / 'data_lmdb')])
    argv = _argv(root, configs['xor'], 'logs_lmdb', '--max-iter', '1',
                 '--dataset-type', 'lmdb')
    argv[argv.index('--data-root') + 1] = str(root / 'data_lmdb')
    cli.main(argv)
    cli.main(_argv(root, configs['xor'], 'logs_lmdb_folder', '--max-iter',
                   '1'))
    got, want = (
        {k: v for k, v in _series(_newest(root, logs)).items()
         if not k.startswith('perf/')}        # timings
        for logs in ('logs_lmdb', 'logs_lmdb_folder'))
    assert 'gen/l2' in got and got == want


def test_spade_checkpoint_sets_the_oracle_widths(setup, tmp_path, capsys):
    """A state dict saved with `torch.save` is loaded and its widths win
    over the flags."""
    from scenedreamer_tpu_torch.models.spade import SPADEWrapper
    root, configs = setup
    path = str(tmp_path / 'spade.pt')
    torch.save(SPADEWrapper(out_size=256, num_filters=2, spade_filters=6,
                            style_dims=8, seed=3).state_dict(), path)
    capsys.readouterr()
    cli.main(_argv(root, configs['xor'], 'logs_oracle', '--max-iter', '1',
                   '--spade-checkpoint', path, '--spade-oracle-f32'))
    assert 'loaded SPADE oracle weights' in capsys.readouterr().out
    series = _series(_newest(root, 'logs_oracle'))
    assert math.isfinite(series['gen/l2'][0][1])


def test_sigterm_leaves_a_checkpoint(setup):
    root, configs = setup
    logs = root / 'logs_term'
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'scenedreamer_tpu_torch.cli.train']
        + _argv(root, configs['paired'], 'logs_term', '--max-iter', '100000'),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            found = glob.glob(str(logs / '*' / 'metrics.jsonl'))
            if found and os.path.getsize(found[0]) > 0:
                break
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.2)
        else:
            pytest.fail('the training process wrote no metrics in 60 s')
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert 'termination requested' in out
    ckpts = glob.glob(str(logs / '*' / 'checkpoints'))[0]
    with open(os.path.join(ckpts, 'latest_checkpoint.txt')) as f:
        name = f.read().strip()
    sd = torch.load(os.path.join(ckpts, name), weights_only=True)
    assert sd['step'] >= 1 and name == f'step_{sd["step"]:08d}.pt'
