"""One rank of the port's 2-process gloo SPADE training test
(`tests/test_torch_spade_train.py::test_sync_batch_norm_two_ranks_match_jax`).

    python tests/_torch_spade_worker.py <rank> <world> <port> <dir>

Reads `<dir>/inputs.pt` (the generator's and the discriminator's state
dicts, the VGG weights, a batch of 2 and JAX's style draws of the whole
batch), rendezvouses over env:// on localhost:<port>, and runs one
`SpadeTrainer.train_step` on a data=2 mesh with the batch norms synced
over it, each rank on its item of the batch and its row of the draws.
Writes `<dir>/rank<rank>.pt`. Imports no JAX."""
import os
import sys

rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=port,
                  RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK='0')

import torch                     # noqa: E402
import torch.distributed as dist  # noqa: E402

from scenedreamer_tpu_torch.models.spade import SPADEWrapper  # noqa: E402
from scenedreamer_tpu_torch.models.vgg import VGG19Features  # noqa: E402
from scenedreamer_tpu_torch.parallel import mesh as pm  # noqa: E402
from scenedreamer_tpu_torch.train import gan_losses as G  # noqa: E402
from scenedreamer_tpu_torch.train import losses as L  # noqa: E402
from scenedreamer_tpu_torch.train.spade_trainer import \
    SpadeTrainer  # noqa: E402
from scenedreamer_tpu_torch.train.trainer import TrainerConfig  # noqa: E402
from _torch_parity import cap_torch_threads  # noqa: E402

cap_torch_threads()
inp = torch.load(os.path.join(out_dir, 'inputs.pt'), weights_only=False)
assert pm.init_distributed('cpu') == (rank, world)
mesh = pm.make_mesh()
assert (mesh.data, mesh.data_index) == (world, rank)

gen = SPADEWrapper(**inp['gen_kw'], bn_mode='train', style_encoder=True)
gen.load_state_dict(inp['g_sd'])
dis = G.MultiScaleDiscriminator(inp['gen_kw']['num_labels'], **inp['dis_kw'])
dis.load_state_dict(inp['d_sd'])
vgg = VGG19Features(inp['vgg_layers'])
vgg.load_state_dict(inp['vgg_sd'])
tr = SpadeTrainer(gen, dis, cfg=TrainerConfig(ema_beta=inp['ema_beta']),
                  perceptual=L.PerceptualLoss(vgg, layers=inp['vgg_layers'],
                                              weights=(1.0,)),
                  loss_weights=inp['weights'], ema_start=0, mesh=mesh)
n = inp['batch']['label'].shape[0] // world
mine = {k: v[rank * n:(rank + 1) * n] for k, v in inp['batch'].items()}
metrics = tr.train_step(mine, style_eps=tuple(
    e[rank * n:(rank + 1) * n] for e in inp['eps']))
torch.save({'metrics': metrics, 'gen': gen.state_dict(),
            'dis': dis.state_dict()},
           os.path.join(out_dir, f'rank{rank}.pt'))
dist.destroy_process_group()
