"""One rank of the port's 2-process gloo CPU tests
(`tests/test_torch_multiprocess.py`).

    python tests/_torch_dist_worker.py <rank> <world> <port> <dir>

Reads `<dir>/inputs.pt` (weights as port state dicts, a batch of 2, the
style draws), rendezvouses over env:// on localhost:<port> through
`parallel.mesh.init_distributed`, and runs, in order:
  * 'dp_shared' / 'dp_two': one `train_step_shared` / `train_step` on a
    data=2 mesh, each rank on its item of the batch with its own style
    draws (JAX's per-group draws, given in the inputs);
  * 'dp_paired': the same `train_step_shared` with the paired hash
    variant (the port's own seeded weights), and on rank 0 the batch-2
    step of one process with the same draws and half the KL weight;
  * 'rays_<case>': one `train_step_shared` on a data=1 x rays=2 mesh
    with stochastic sampling (each rank renders 17 of the 34 rows), and
    on rank 0 the step of one process from the same weights and seed;
  * 'meters', 'global_batch', 'broadcast_batch': the cross-process
    meter mean, its raise on diverging name sets, the global batch
    check and the rays group's batch broadcast.
Writes `<dir>/rank<rank>.pt`. Imports no JAX."""
import os
import sys

rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=port,
                  RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK='0')

import dataclasses               # noqa: E402
import json                      # noqa: E402

import torch                     # noqa: E402
import torch.distributed as dist  # noqa: E402

from scenedreamer_tpu_torch.models.discriminator import \
    GANcraftDiscriminator    # noqa: E402
from scenedreamer_tpu_torch.models.generator import (  # noqa: E402
    GeneratorConfig, SceneDreamerGenerator)
from scenedreamer_tpu_torch.models.vgg import VGG19Features  # noqa: E402
from scenedreamer_tpu_torch.parallel import mesh as pm  # noqa: E402
from scenedreamer_tpu_torch.train import losses as L  # noqa: E402
from scenedreamer_tpu_torch.train.trainer import (  # noqa: E402
    GANTrainer, TrainerConfig)
from scenedreamer_tpu_torch.utils.meters import MetricsWriter  # noqa: E402
from _torch_parity import cap_torch_threads  # noqa: E402

cap_torch_threads()
inp = torch.load(os.path.join(out_dir, 'inputs.pt'), weights_only=False)
assert pm.init_distributed('cpu') == (rank, world)
assert dist.get_backend() == 'gloo'


def trainer(cfg, g_sd=None, d_sd=None, mesh=None, seed=0, kl_scale=1.0):
    gen = SceneDreamerGenerator(cfg, seed=seed)
    dis = GANcraftDiscriminator(num_labels=inp['num_labels'],
                                num_filters=inp['nf'], seed=seed)
    if g_sd is not None:
        gen.load_state_dict(g_sd)
        dis.load_state_dict(d_sd)
    vgg = VGG19Features(('relu_2_1',))
    vgg.load_state_dict(inp['vgg_sd'])
    perc = L.PerceptualLoss(vgg, layers=('relu_2_1',), weights=(1.0,))
    weights = dict(L.DEFAULT_LOSS_WEIGHTS)
    weights['kl'] *= kl_scale
    return GANTrainer(gen, dis, inp['dims'], perceptual=perc,
                      cfg=TrainerConfig(loss_weights=weights),
                      iters_per_epoch=10, mesh=mesh)


def state(tr, metrics):
    """Metrics, state dicts, gradients and each parameter's learning rate
    after a step."""
    named = list(tr.gen.named_parameters(prefix='gen')) \
        + list(tr.dis.named_parameters(prefix='dis'))
    lr = {id(p): g['lr'] for o in (tr.g_opt, tr.d_opt)
          for g in o.opt.param_groups for p in g['params']}
    return dict(metrics=metrics, gen=tr.gen.state_dict(),
                dis=tr.dis.state_dict(),
                grads={n: p.grad.clone() for n, p in named},
                lrs={n: lr[id(p)] for n, p in named})


out = {}
cfg = GeneratorConfig(**inp['gen_cfg'])
batch = inp['batch']

# data parallel, held against JAX's data=2 mesh step ----------------------
dp = pm.make_mesh()
assert (dp.data, dp.rays, dp.data_index) == (2, 1, rank)
mine = pm.shard_batch(dp, batch)
eps = inp['eps_shared'][rank:rank + 1]
tr = trainer(cfg, inp['g_sd'], inp['d_sd'], dp)
out['dp_shared'] = state(tr, tr.train_step_shared(mine, style_eps=eps))
tr = trainer(cfg, inp['g_sd'], inp['d_sd'], dp)
out['dp_two'] = state(tr, tr.train_step(mine, style_eps=tuple(
    e[rank:rank + 1] for e in inp['eps_two'])))

# the paired variant, held against one process's batch-2 step -------------
pcfg = dataclasses.replace(cfg, hash_variant='paired')
tr = trainer(pcfg, mesh=dp, seed=3)
out['dp_paired'] = state(tr, tr.train_step_shared(mine, style_eps=eps))
if rank == 0:
    # the KL term sums over the batch: the ranks mean their sums (as
    # JAX's pmean and DDP), one process sums both items, so its KL
    # weight is halved to take the same update
    tr = trainer(pcfg, seed=3, kl_scale=0.5)
    out['one_paired'] = state(tr, tr.train_step_shared(
        batch, style_eps=inp['eps_shared']))

# rays: data 1 x rays 2 against rays 1 --------------------------------------
rays = pm.make_mesh(rays=2)
assert (rays.data, rays.rays, rays.rays_index) == (1, 2, rank)
item = {k: v[:1] for k, v in batch.items()}
for case, extra in inp['rays_cases'].items():
    rcfg = dataclasses.replace(cfg, coarse_deterministic_sampling=False,
                               **extra)
    runs = [('rays_' + case, rays)] + ([('one_' + case, None)]
                                       if rank == 0 else [])
    for name, mesh in runs:
        tr = trainer(rcfg, mesh=mesh, seed=5)
        m = tr.train_step_shared(item, torch.Generator().manual_seed(11))
        out[name] = state(tr, m)
try:
    trainer(cfg, mesh=rays, seed=5).train_step_shared(item, compact_k=64)
except ValueError as e:
    out['rays_compact_k'] = str(e)

# meters: the global mean, and a raise on diverging name sets -------------
logdir = os.path.join(out_dir, 'meters')
w = MetricsWriter(logdir if rank == 0 else None, use_tensorboard=False)
w.meter('a').write(rank + 1.0)
if rank == 0:
    w.meter('b').write(5.0)       # no value on rank 1: NaN there
w.meter('b')
w.flush_meters(1)
w.meter('c' if rank == 1 else 'a').write(1.0)
try:
    w.flush_meters(2)
except RuntimeError as e:
    out['meters_raise'] = str(e)
w.close()
if rank == 0:
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
        out['meters'] = [json.loads(line) for line in f]

# the global batch check and the rays group's batch broadcast -------------
out['global_batch'] = list(pm.global_batch_from_local(dp, mine))
try:
    pm.global_batch_from_local(dp, {'images': batch['images'][:rank + 1]})
except ValueError as e:
    out['global_batch_raise'] = str(e)
got = pm.broadcast_batch(rays, item if rank == 0 else None,
                         torch.device('cpu'))
out['broadcast_equal'] = all(torch.equal(got[k], item[k]) for k in item)

torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
dist.destroy_process_group()
