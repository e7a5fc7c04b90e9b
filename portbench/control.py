"""The control of a cell's correctness check: the plain reference put in
the program's place and computed one precision step down, TF32 for the
configurations' float32 with TF32 off, read by the cell's own check; or,
with `--fault`, the float32 reference with a fault planted in it.

    python portbench/control.py --workload <name> --seeds <n> [<n> ...]
                                [--fault no_exchange|half_batch]

Serving: per seed, the TF32 reference renders the frames the check would
sample (among the first trajectory's) at the traffic's shapes, and the
float32 reference holds them to the cell's limits. Training: per seed,
the TF32 reference's pool and first steps against the float32
reference's, and the step after them from the TF32 reference's own
state against the float32 reference's step from that state (as the
program's step after its window is checked). Prints one line per seed with each number and its limit;
`correct` has to read false. A cell on several chips runs one process
per chip, as `run.py` does; its faults are those of the exchange between
the ranks: 'no_exchange' (the gradients are not all-reduced) and
'half_batch' (the mean takes the first half of the ranks' gradients
only). The benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import harness, inputs  # noqa: E402
from portbench.run import Run  # noqa: E402


def serve_control(run):
    import torch
    from portbench.drivers import serve_flythrough as drv
    from portbench.reference import serve as ref
    cfg, tr, dev = run.config, run.traffic, run.device
    arrays = inputs.world_arrays(cfg, cache_dir=run.world_cache)
    poses = inputs.flythrough(inputs.reference_world(arrays), tr)
    styles = inputs.styles(run.seed, tr['styles'], cfg['style_dims'],
                           dev).cpu().numpy()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    gen = ref.build_generator(cfg, run.seed, dev)
    rr = ref.ReferenceRenderer(gen, arrays, cfg, tr, dev)
    # frames of the first trajectory, drawn as the check draws them
    pick = drv.sample_frames(run.seed, {n: {'hits': n}
                                        for n in range(len(poses))},
                             tr['check_frames'])
    frames = {}
    for n in pick:
        z = rr.style_z(styles[0][None])
        out = rr.frame(poses[n], z)
        frames[n] = dict(img=out['img'], depth=out['depth'],
                         vid=out['first_voxel_id'], hits=out['hit_rays'])
    del gen, rr
    torch.cuda.empty_cache() if dev.type == 'cuda' else None
    return drv.check(run, arrays, poses, styles, frames)


def train_control(run, fault=None):
    from portbench.drivers import train_steps as drv
    arrays = inputs.world_arrays(run.config, rank=run.rank,
                                 cache_dir=run.world_cache)
    with reference_fault(fault, run.rank, run.world_size):
        got = drv.reference_readings(run, arrays,
                                     reference_tf32=fault is None)
    return drv.check(run, arrays, got, got['pool'])


@contextlib.contextmanager
def reference_fault(fault, rank, world):
    """Plant a fault of the exchange in the reference's trainer."""
    if fault is None:
        yield
        return
    import torch
    import torch.distributed as dist
    from portbench.reference.sd.train import trainer
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
    trainer.all_mean_ = {'no_exchange': lambda tensors: None,
                         'half_batch': half}[fault]
    try:
        yield
    finally:
        trainer.all_mean_ = orig


def _readings(rank, world, device, workload, seeds, fault):
    bench = harness.Bench()
    for seed in seeds:
        args = argparse.Namespace(workload=workload, seed=seed, seconds=0,
                                  trace=0)
        run = Run(bench, args, device, rank, world)
        if run.traffic['driver'] == 'serve_flythrough':
            checks = serve_control(run)
        else:
            checks = train_control(run, fault)
        if rank:
            continue
        print(json.dumps({'workload': workload, 'seed': seed,
                          'control': fault or 'reference in TF32',
                          'correct': all(harness.passes(v, lim)
                                         for _, v, lim in checks),
                          'checks': {n: {'value': v, 'limit': lim}
                                     for n, v, lim in checks}}),
              flush=True)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--fault', choices=('no_exchange', 'half_batch'))
    a = p.parse_args(argv)
    chips = int(harness.Bench().cell(a.workload)[0]['chips'])
    if chips == 1:
        return _readings(0, 1, 'cuda', a.workload, a.seeds, a.fault)
    from portbench.ranks import spawn
    return max(spawn(_readings, chips, (a.workload, a.seeds, a.fault)))


if __name__ == '__main__':
    sys.exit(main())
