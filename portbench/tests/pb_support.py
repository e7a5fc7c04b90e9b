"""Helpers of the harness's CPU tests: a tiny benchmark built from the
real `BENCHMARK.json` with the fixture cells of `fixtures/` (tiny
configurations and mixes, test-only limits, metric and cell), and runs
of its cells on the CPU, in this process or in one process per rank
(gloo), with a fault planted in the program where asked."""
import contextlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, 'fixtures')
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

# the tiny training mixes' `first_steps`: the set-up's steps
LATE_AFTER = 2
TINY = {'tiny.serve': ('tiny_infer', 'tiny_flyover', ['sd_serve.flyover']),
        'tiny.step': ('tiny_train', 'tiny_step', ['sd_train.step']),
        'tiny.dp': ('tiny_train', 'tiny_dp', ['sd_train.dp4'])}


def tiny_bench(tmp):
    """A BENCHMARK.json in `tmp` whose cells are the tiny fixture cells,
    each taking the metrics of the real cell it stands for, plus the
    fixture's own entries (`fixtures/extra.json`: a test-only cell and
    per-layer metric, added as new files alone). Returns a `Bench` that
    looks in `tmp`, the fixtures and `portbench/` by name."""
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    with open(os.path.join(FIX, 'extra.json')) as f:
        extra = json.load(f)
    spec['configs'] = [
        {'name': n, 'source': 'test', 'reduced': [], 'why': 'test',
         'file': f'portbench/tests/fixtures/configs/{n}.json'}
        for n in ('tiny_infer', 'tiny_train')]
    spec['workloads'] = [
        {'name': w, 'config': c, 'traffic': t, 'chips': 1, 'why': 'test'}
        for w, (c, t, _) in TINY.items()] + extra['workloads']
    for m in spec['end_to_end'] + spec['per_layer']:
        if 'workloads' in m:
            m['workloads'] = [w for w, (_, _, real) in TINY.items()
                              if set(real) & set(m['workloads'])]
    spec['per_layer'] += extra['per_layer']
    path = os.path.join(tmp, 'BENCHMARK.json')
    with open(path, 'w') as f:
        json.dump(spec, f)
    return harness.Bench(path, root=ROOT, dirs=(FIX, PB))


def _args(workload, seed, seconds, trace):
    from portbench import run as R
    return R.parse(['--workload', workload, '--seed', str(seed),
                    '--seconds', str(seconds), '--trace', str(trace)])


def run_tiny(tmp, workload, seed=2 ** 31 + 7, seconds=2.0, trace=0,
             fault=None, world_cache=None):
    """One run of a tiny cell on the CPU in this process, with `fault`
    planted; returns (exit code, result line or None, standard error)."""
    from portbench import run as R
    bench = tiny_bench(tmp)
    out, err = io.StringIO(), io.StringIO()
    with plant(fault), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        code = R.run_one(_args(workload, seed, seconds, trace), bench,
                         device='cpu', world_cache=world_cache
                         or os.path.join(tmp, 'worlds'))
    lines = out.getvalue().strip().splitlines()
    return code, json.loads(lines[-1]) if lines else None, err.getvalue()


def _rank(rank, world, device, tmp, workload, seed, seconds, fault):
    from portbench import run as R
    bench = harness.Bench(os.path.join(tmp, 'BENCHMARK.json'), root=ROOT,
                          dirs=(FIX, PB))
    out = io.StringIO()
    with plant(fault, rank, world), contextlib.redirect_stdout(out):
        code = R.run_one(_args(workload, seed, seconds, 0), bench, rank,
                         world, device=device,
                         world_cache=os.path.join(tmp, 'worlds'))
    if rank == 0:
        with open(os.path.join(tmp, 'rank0.out'), 'w') as f:
            f.write(out.getvalue())
    return code


def run_tiny_ranks(tmp, workload, world=2, seed=2 ** 31 + 7, seconds=2.0,
                   fault=None):
    """One run of a tiny cell on `world` CPU processes (gloo); returns
    (exit codes, rank 0's result line or None)."""
    from portbench.ranks import spawn
    tiny_bench(tmp)
    codes = spawn(_rank, world, (tmp, workload, seed, seconds, fault),
                  device='cpu', timeout=900)
    path = os.path.join(tmp, 'rank0.out')
    lines = open(path).read().strip().splitlines() \
        if os.path.exists(path) else []
    line = json.loads(lines[-1]) if lines and lines[-1].startswith('{') \
        else None
    return codes, line


@contextlib.contextmanager
def plant(fault, rank=0, world=1):
    """Break the program underneath the harness for the block:
      'answer': every served frame's image off by 0.01 where the frame
          is produced (its materializer);
      'frozen': the training step leaves the parameters and the optimizer
          state unchanged (Adam's step does nothing);
      'no_exchange': the ranks' gradients are not all-reduced;
      'half_batch': the mean over the ranks takes only the first half of
          the ranks' gradients (the others count zero);
      'late_update': from the first step after the set-up's on, each step
          moves every generator parameter by a further 1e-3 (a path that
          only the window and after it run);
      'banned': the last rank's process holds a module named `jax`."""
    if fault is None:
        yield
        return
    from scenedreamer_tpu_torch.render import pipeline
    from scenedreamer_tpu_torch.train import optim, trainer
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == 'answer':
        orig = pipeline.TiledRenderer.frame_async

        def frame_async(self, *a, **k):
            mat = orig(self, *a, **k)

            def off():
                out = mat()
                if isinstance(out, tuple):
                    return (out[0] + 0.01,) + tuple(out[1:])
                return out + 0.01
            return off
        patch(pipeline.TiledRenderer, 'frame_async', frame_async)
    elif fault == 'frozen':
        patch(optim.ScheduledAdam, 'step', lambda self: None)
    elif fault == 'no_exchange':
        patch(trainer, 'all_mean_', lambda tensors: None)
    elif fault == 'half_batch':
        import torch
        import torch.distributed as dist
        orig = trainer.all_mean_

        def half(tensors):
            tensors = list(tensors)
            if rank >= world // 2:
                with torch.no_grad():
                    for t in tensors:
                        t.zero_()
            orig(tensors)
            with torch.no_grad():
                for t in tensors:
                    t.mul_(dist.get_world_size() / (world // 2))
        patch(trainer, 'all_mean_', half)
    elif fault == 'late_update':
        import torch
        orig = trainer.GANTrainer.train_step_shared
        calls = [0]

        def late(self, *a, **k):
            out = orig(self, *a, **k)
            calls[0] += 1
            if calls[0] > LATE_AFTER:
                with torch.no_grad():
                    for p in self.gen.parameters():
                        p.add_(1e-3)
            return out
        patch(trainer.GANTrainer, 'train_step_shared', late)
    elif fault == 'banned':
        import types
        if rank == world - 1:
            sys.modules['jax'] = types.ModuleType('jax')
            saved.append((None, 'jax', None))
    else:
        raise ValueError(f'unknown fault {fault!r}')
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            if obj is None:
                sys.modules.pop(name, None)
            else:
                setattr(obj, name, value)
