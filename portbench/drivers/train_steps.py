"""Training: a closed loop of the program's
`GANTrainer.train_step_shared` over a pool of batches, cycled; on
several chips one process per chip under `GANTrainer(mesh=make_mesh(
data=world))`, each rank with its own world and pool.

Set-up: the rank's world (from the benchmark's cache); the generator,
discriminator and VGG19 loss built on the meta device and filled on the
card from the seed; the pool of `pool_batches` batches made by the
program's `TrainingBatchBuilder` over its `CameraBatchSampler` (K1, a
round of proposals per launch) from the rank's camera generator and
synthetic images, labels and pseudo ground truth drawn from the seed;
then the trainer's first `first_steps` steps on the pool's first
batches, through the window's own call, which build and warm everything
the window runs.
Window: `train_step_shared` on pool batch i mod `pool_batches`, step
after step until `--seconds`; on several chips all ranks stop together
(a one-number reduction on the host's gloo group after each step). Each
step ends in the host's read of its metrics.
After the window: the trainer's whole state (G, D, both Adams, the EMA,
the draws) is copied to the host, and the same trainer object takes one
more step through the window's call on the next pool batch.
Readings of a stretch of steps: each step's losses, the gradient of
every leaf in its first step (Adam's first moment after it: beta1 is
0), and every leaf's change over the stretch (after the window, entry by
entry).
Check: with the program freed, the reference copy of the trainer
(`reference/sd`) rebuilds the pool from the same seed (the same camera
proposals and accept decisions, the plain DDA) and runs the same first
steps on it from the same weights and draws (on several chips, its own
all_reduce of the gradients over the ranks); then it loads the state the
program held after the window and takes the same step from it. Compared
(`compare`): the pool's rays and masks (exact); in both stretches each
step's D and G losses and the worst leaf's first gradient; the worst
leaf's change in the step after the window, the median leaf's over the
first steps.
"""
import gc
import statistics
import sys
import time
from types import SimpleNamespace

import torch

from portbench import inputs, weights, yardstick
from portbench.reference import serve as ref_serve

LOSSES = ('dis/total', 'gen/total')
POOL_KEYS = ('voxel_id', 'depth', 'hit_mask', 'raydirs', 'cam_ori',
             'fake_masks', 'real_masks')


class Ctx:
    """What the training metrics read."""

    def __init__(self, cfg, trace, step_s, untraced_s, hits, rays, flops,
                 traced_steps, world_size, allreduce_s):
        self.cfg, self.trace = cfg, trace
        self.step_s, self.untraced_s = step_s, untraced_s
        self.hits, self.rays = hits, rays
        # all ranks' operations in the window's untraced steps
        self.flops = flops
        self.traced_steps = traced_steps
        self.world_size = world_size
        self.allreduce_s = allreduce_s


def build_models(mods, cfg, seed, dev):
    """The generator, discriminator and perceptual loss of the
    configuration from `mods` (the program's or the reference's module
    namespace), built on the meta device and filled from the seed on
    `dev`."""
    with torch.device('meta'):
        gen = mods.SceneDreamerGenerator(mods.GeneratorConfig(
            **ref_serve.generator_config(cfg)))
        dis = mods.GANcraftDiscriminator(
            num_labels=cfg['num_reduced_labels'],
            num_filters=cfg['dis_num_filters'],
            smooth_resample=cfg['dis_smooth_resample'])
        perc = mods.PerceptualLoss(layers=tuple(cfg['perceptual_layers']),
                                   weights=tuple(cfg['perceptual_weights']))
    gen, dis, perc = (m.to_empty(device=dev) for m in (gen, dis, perc))
    weights.fill_(named_modules(gen, dis, perc), seed, dev)
    return gen, dis, perc


def named_modules(gen, dis, perc):
    return {'gen': gen, 'dis': dis, 'vgg': perc.vgg}


def make_trainer(mods, gen, dis, perc, dims, cfg, mesh):
    return mods.GANTrainer(
        gen, dis, dims, cfg=mods.TrainerConfig(
            loss_weights=dict(cfg['loss_weights'])),
        perceptual=perc, mesh=mesh)


def make_pool(mods, world, cfg, tr, seed, rank, dev):
    sampler = mods.CameraBatchSampler(mods.CameraSamplerConfig(
        crop_size=(cfg['crop_size'], cfg['crop_size']), pad=cfg['pad'],
        num_blocks_early_stop=cfg['num_blocks_early_stop'],
        proposals_per_dispatch=tr['proposals_per_dispatch'],
        num_reduced_labels=cfg['num_reduced_labels']), device=dev)
    builder = mods.TrainingBatchBuilder(sampler)
    rng = inputs.camera_rng(tr['camera_seed'], rank)
    n = tr['pool_batches']
    data = inputs.training_images(seed, rank, n, cfg['crop_size'],
                                  cfg['num_coco_labels'], dev)
    pool = [builder(d, world, rng) for d in data]
    return [pool[i] for i in inputs.pool_order(seed, rank, n)]


def leaves_of(trainer):
    """The generator's and discriminator's parameters, named
    'gen.<name>' and 'dis.<name>'."""
    leaves = {f'gen.{k}': p for k, p in trainer.gen.named_parameters()}
    leaves.update({f'dis.{k}': p for k, p in trainer.dis.named_parameters()})
    return leaves


def drive(trainer, batches, draws, start, keep=None, floors=False):
    """Drive `trainer` through one step on each of `batches`: each step's
    losses, each leaf's gradient of the first step as Adam holds it (its
    first moment; beta1 is 0) and the norm of each leaf's change over
    the steps against `start()` ({leaf: tensor before them}). With
    `keep` (a device), also each leaf's change entry by entry, moved
    there; with `floors`, each leaf's smallest gradient magnitude over
    the steps, entry by entry."""
    leaves = leaves_of(trainer)
    losses, grad, floor = [], {}, {}
    for i, batch in enumerate(batches):
        m = trainer.train_step_shared(batch, draws)
        losses.append([m[k] for k in LOSSES])
        state = {**trainer.g_opt.opt.state, **trainer.d_opt.opt.state}
        for k, p in leaves.items():
            g = state[p]['exp_avg'] if p in state else None
            if i == 0:
                grad[k] = None if g is None else float(_norm(g))
            if floors and g is not None:
                floor[k] = g.abs() if i == 0 else torch.minimum(floor[k],
                                                                g.abs())
    before = start()
    change, delta = {}, {}
    for k, p in leaves.items():
        d = p.detach() - before.pop(k)
        change[k] = float(_norm(d))
        if keep is not None:
            delta[k] = d.to(keep)
    return {'losses': losses, 'grad': grad, 'change': change,
            'delta': delta, 'floor': floor}


def snapshot(trainer, draws, batch):
    """The trainer's whole state and the draws' on the host, and the
    pool batch of the step that follows."""
    return {'trainer': _to(trainer.state_dict(), torch.device('cpu')),
            'draws': draws.get_state(), 'batch': batch}


def restore(trainer, draws, snap, dev):
    """Load a snapshot into `trainer` and `draws` (from a copy on the host:
    the modules copy it in, Adam moves its moments to the parameters'
    device and keeps its step counts on the host, as it holds them)."""
    trainer.load_state_dict(_to(snap['trainer'], torch.device('cpu')))
    if trainer.g_ema is not None:
        trainer.g_ema = _to(trainer.g_ema, dev)
    draws.set_state(snap['draws'])


def snapshot_leaves(snap, dev):
    """{leaf: tensor} of a snapshot's parameters on `dev`."""
    sd = snap['trainer']
    return {f'{side}.{k}': v.to(dev, copy=True)
            for side, mod in (('gen', 'generator'), ('dis', 'discriminator'))
            for k, v in sd[mod].items()}


def _to(obj, dev):
    """A copy of a nest of dicts, lists and tensors with every tensor on
    `dev`."""
    if torch.is_tensor(obj):
        return obj.detach().to(dev, copy=True)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, dev) for v in obj)
    return obj


def post_window(trainer, pool, draws, i, keep):
    """The snapshot before step `i` (pool batch i mod len(pool)) and the
    readings of that one step."""
    snap = snapshot(trainer, draws, i % len(pool))
    dev = next(trainer.gen.parameters()).device
    got = drive(trainer, [pool[snap['batch']]], draws,
                lambda: snapshot_leaves(snap, dev), keep)
    return snap, got


def _norm(t):
    return torch.linalg.vector_norm(t.float())


def initial_tensors(gen, dis, perc, seed, dev):
    """{leaf name: initial value} of the generator's and discriminator's
    parameters, made again from the seed."""
    named = {}
    for prefix, mod in named_modules(gen, dis, perc).items():
        for k, t in list(mod.named_parameters()) + list(mod.named_buffers()):
            named[f'{prefix}.{k}'] = torch.empty_like(t)
    weights.fill_tensors_(named, seed, dev)
    return {k: v for k, v in named.items() if not k.startswith('vgg.')}


def program_modules():
    """The program's classes that the cell drives."""
    from scenedreamer_tpu_torch.models.discriminator import \
        GANcraftDiscriminator
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.train.losses import PerceptualLoss
    from scenedreamer_tpu_torch.train.sampling import (
        CameraBatchSampler, CameraSamplerConfig, TrainingBatchBuilder)
    from scenedreamer_tpu_torch.train.trainer import GANTrainer, TrainerConfig
    return SimpleNamespace(**locals())


def _all(op, value, world_size):
    """`value` reduced over the ranks by 'sum' or 'max', on the host."""
    if world_size == 1:
        return value
    from portbench.ranks import host_reduce
    return host_reduce(op, value)


def main(run):
    from scenedreamer_tpu_torch.scene.voxel_world import VoxelWorld
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr, dev, seed = run.config, run.traffic, run.device, run.seed
    rank, ws = run.rank, run.world_size
    arrays = inputs.world_arrays(cfg, rank=rank, cache_dir=run.world_cache)
    world = VoxelWorld(**arrays)
    run.log('world loaded')
    mesh = None
    if ws > 1:
        from scenedreamer_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(data=ws)
    mods = program_modules()
    gen, dis, perc = build_models(mods, cfg, seed, dev)
    trainer = make_trainer(mods, gen, dis, perc, world.dims, cfg, mesh)
    run.log('models built')
    pool = make_pool(mods, world, cfg, tr, seed, rank, dev)
    run.log('pool built')
    draws = torch.Generator(device=dev).manual_seed(
        weights.stream_seed(seed, 'draws', rank))
    n0 = tr['first_steps']
    got = {'first': drive(trainer, pool[:n0], draws,
                          lambda: initial_tensors(gen, dis, perc, seed, dev))}
    run.setup_done()

    npool = tr['pool_batches']
    t_from, t_to = n0 + tr['trace_from'], n0 + tr['trace_from'] \
        + tr['trace_steps']
    step_s, trace, i = [], None, n0
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    while True:
        if run.trace and i == t_from:
            trace = run.open_trace()
        elif trace is not None and i == t_to:
            run.close_trace()
            trace = None
        go = trace is not None or time.perf_counter() < deadline
        if _all('max', 0.0 if go else 1.0, ws):     # a rank is done
            break
        run.mark('train_step')
        ts = time.perf_counter()
        trainer.train_step_shared(pool[i % npool], draws)
        step_s.append(time.perf_counter() - ts)
        i += 1
    window_s = time.perf_counter() - t_start
    peak = _all('max', run.memory_peak(), ws)
    run.log(f'window closed: {len(step_s)} steps in {window_s:.3f} s, '
            f'step ms median {statistics.median(step_s) * 1e3:.1f} max '
            f'{max(step_s) * 1e3:.1f}')

    rays = cfg['crop_size'] + cfg['pad']
    rays *= rays
    hits = [int(b['hit_mask'][..., 0].sum()) for b in pool]
    side = yardstick.train_step_side_flops(cfg)
    t = run.reduce_trace()
    traced = range(t_from, t_to) if t else range(0)
    flops = sum(yardstick.train_step_flops(cfg, hits[j % npool], rays, side)
                for j in range(n0, i) if j not in traced)
    flops = _all('sum', flops, ws)
    nsteps = len(step_s)
    busy = _all('sum', t.busy_s if t else 0.0, ws) / ws
    traced_window = _all('sum', t.window_s if t else 0.0, ws) / ws
    nccl = t.kernel_s('nccl') if t else None
    ctx = Ctx(cfg, t, step_s, window_s - run.traced_s, hits, rays, flops,
              len(traced), ws, nccl)
    e2e = {'train_images_per_s': nsteps * ws * cfg['batch_per_rank']
           / window_s, 'peak_gb': peak / 1e9}

    got['snap'], got['post'] = post_window(trainer, pool, draws, i,
                                           torch.device('cpu'))
    program_pool = [{k: b[k].cpu() for k in POOL_KEYS} for b in pool]
    del trainer, gen, dis, perc, pool, mesh
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    checks = check(run, arrays, got, program_pool)
    run.log('check done')
    return dict(e2e=e2e, ctx=ctx, checks=checks, attempted=nsteps,
                failed=0, memory_peak_bytes=int(peak), busy_s=busy,
                window_s=traced_window)


class _RefMesh:
    """The reference trainer's data-parallel flag: its updates mean their
    gradients over every rank (the reference copy's all_reduce)."""
    data_group = True

    @staticmethod
    def row_band(height):
        return None


def reference_readings(run, arrays, reference_tf32=False, follow=None):
    """The reference copy's pool and first steps from the seed alone;
    then, with `follow` (a snapshot of the program after its window), the
    step that follows it from that state, with each leaf's smallest
    gradient per entry. Without `follow` the reference stands in for the
    program (the control): it takes its own snapshot after its first
    steps and the step after it."""
    from portbench.reference.train import reference_modules
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = reference_tf32
    torch.backends.cudnn.allow_tf32 = reference_tf32
    try:
        cfg, tr, dev, seed = run.config, run.traffic, run.device, run.seed
        mods = reference_modules()
        world = inputs.reference_world(arrays)
        gen, dis, perc = build_models(mods, cfg, seed, dev)
        trainer = make_trainer(mods, gen, dis, perc, world.dims, cfg,
                               _RefMesh() if run.world_size > 1 else None)
        pool = make_pool(mods, world, cfg, tr, seed, run.rank, dev)
        draws = torch.Generator(device=dev).manual_seed(
            weights.stream_seed(seed, 'draws', run.rank))
        n0 = tr['first_steps']
        out = {'first': drive(trainer, pool[:n0], draws,
                              lambda: initial_tensors(gen, dis, perc, seed,
                                                      dev))}
        if follow is not None:
            restore(trainer, draws, follow, dev)
            out['post'] = drive(trainer, [pool[follow['batch']]], draws,
                                lambda: snapshot_leaves(follow, dev),
                                keep=dev, floors=True)
        else:
            out['snap'], out['post'] = post_window(
                trainer, pool, draws, n0, torch.device('cpu'))
        out['pool'] = [{k: b[k].cpu() for k in POOL_KEYS} for b in pool]
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def compare(got, want, program_pool, entry_floor, log=None):
    """(loss_gap, grad_gap, change_gap, change_gap_first, pool_mismatch).
    A leaf's gap is the gap of the program's and the reference's norms
    over the larger of the reference's norm of that leaf and the median
    leaf's. loss_gap: the worst step's relative gap of the D and G
    losses, over the first steps and the step after the window; grad_gap:
    the worst leaf's first gradient, over every leaf (one that only one
    side moves reads inf), in both stretches. The changes are taken over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's. change_gap: the worst leaf's change in the step after
    the window, over the entries whose reference gradient is at or above
    `entry_floor`: below it Adam divides their rounding by a number of
    its own eps's size. change_gap_first: the median leaf's change over
    the first steps, whose first update is Adam's sign of each gradient,
    so a leaf's change there swings with the rounding of its smallest
    gradients (`PERF.md` section 2)."""
    log = log or (lambda text: print(f'[portbench] {text}',
                                     file=sys.stderr))
    first, post = got['first'], got['post']
    wfirst, wpost = want['first'], want['post']
    loss_gap = max(_loss_gap(first, wfirst), _loss_gap(post, wpost))
    grad_gap = max(_grad_gap(first, wfirst, 'first', log),
                   _grad_gap(post, wpost, 'post', log))
    keep = _kept(wfirst, log)
    med = statistics.median(wfirst['change'][k] for k in keep)
    whole = {k: _gap(first['change'][k], wfirst['change'][k], med)
             for k in keep}
    worst = max(whole, key=whole.get)
    change_first = statistics.median(whole.values())
    log(f'first: change, median leaf {change_first!r}; worst leaf {worst} '
        f'{whole[worst]!r}')
    keep = _kept(wpost)
    norms = {}
    for k in keep:
        mask = wpost['floor'][k] >= entry_floor
        d = post['delta'][k].to(mask.device)
        norms[k] = (float(_norm(d[mask])),
                    float(_norm(wpost['delta'][k][mask])), int(mask.sum()),
                    mask.numel())
    med = statistics.median(r for _, r, _, _ in norms.values())
    masked = {k: _gap(a, r, med) for k, (a, r, _, _) in norms.items()}
    worst = max(masked, key=masked.get)
    med = statistics.median(wpost['change'][k] for k in keep)
    whole = {k: _gap(post['change'][k], wpost['change'][k], med)
             for k in keep}
    every = max(whole, key=whole.get)
    log(f'post: change, worst leaf {worst} {masked[worst]!r} (program '
        f'{norms[worst][0]!r}, reference {norms[worst][1]!r}, entries '
        f'{norms[worst][2]} of {norms[worst][3]}); over every entry, worst '
        f'leaf {every} {whole[every]!r}')
    mismatch = 0
    for a, b in zip(program_pool, want['pool']):
        for k in POOL_KEYS:
            if a[k].shape != b[k].shape:
                mismatch += b[k].numel()
            else:
                mismatch += int((a[k] != b[k]).sum())
    mismatch += abs(len(program_pool) - len(want['pool']))
    return loss_gap, grad_gap, masked[worst], change_first, mismatch


def _loss_gap(got, want):
    return max(abs(a - b) / max(abs(b), 1e-6)
               for ga, wa in zip(got['losses'], want['losses'])
               for a, b in zip(ga, wa))


def _grad_gap(got, want, label, log):
    ref = want['grad']
    med = statistics.median(v for v in ref.values() if v is not None)
    gaps = {k: (0.0 if got['grad'].get(k) is None else float('inf'))
            if v is None else _gap(got['grad'].get(k), v, med)
            for k, v in ref.items()}
    worst = max(gaps, key=gaps.get)
    log(f'{label}: worst grad leaf {worst} {gaps[worst]!r} (program '
        f'{got["grad"].get(worst)!r}, reference {ref[worst]!r})')
    return gaps[worst]


def _kept(want, log=None):
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's; `log` names the others with theirs."""
    ref = {k: v for k, v in want['grad'].items() if v is not None}
    med = statistics.median(ref.values())
    keep = [k for k, v in ref.items() if v >= 1e-3 * med]
    if log is not None:
        out = sorted((v, k) for k, v in ref.items() if v < 1e-3 * med)
        log(f'left out of the change ({len(out)} of {len(want["grad"])}, '
            f'median leaf gradient {med!r}): '
            + ', '.join(f'{k} {v:.3g}' for v, k in out))
    return keep


def _gap(a, b, med):
    if a is None or a != a:
        return float('inf')
    if a == b:
        return 0.0
    den = max(b, med)
    return abs(a - b) / den if den > 0 else float('inf')


def entry_floor(cfg):
    """100 times the configuration's Adam eps: an entry's gradient at
    that size moves it by Adam's whole step, within 1%, whatever
    rounding does to it."""
    return 100 * min(cfg[k]['eps'] for k in ('gen_opt', 'dis_opt'))


def check(run, arrays, got, program_pool, reference_tf32=False):
    want = reference_readings(run, arrays, reference_tf32,
                              follow=got['snap'])
    vals = compare(got, want, program_pool, entry_floor(run.config),
                   run.log)
    vals = [_all('max', v, run.world_size) for v in vals]
    names = ('loss_gap', 'grad_gap', 'change_gap', 'change_gap_first',
             'pool_mismatch')
    return [(n, v, run.limits[n]) for n, v in zip(names, vals)]
