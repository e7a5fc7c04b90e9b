"""SPADE / GauGAN oracle training CLI (`configs/landscape1m.yaml`), in
PyTorch.

Counterpart of `scenedreamer_tpu/cli/train_spade.py` (reference `train.py
--config configs/landscape1m.yaml`): paired image + segmentation data
with the config's augmentations (or `--image-size`), hinge GAN against
the multi-scale patch discriminator, VGG19 perceptual (random-init;
`--no-perceptual` drops it) + feature matching + the VAE's KL, the EMA
of G, image snapshots (real | label | fake | fake EMA), checkpoints with
resume and a checkpoint on SIGTERM / SIGINT. The same yaml keys and
flags as the JAX CLI, plus `--device` (default 'cuda'; raises without a
GPU unless 'cpu' is asked for; `--platform cpu|gpu` says the same).

The trained checkpoint is the frozen pseudo-GT oracle of SceneDreamer
training: `cli/train.py --spade-checkpoint <run dir or checkpoint>`
folds it (`utils/convert.spade_frozen_from_trained`).

Several processes (torchrun; NCCL on CUDA, gloo on the CPU) train
data-parallel: `--batch-size` is the whole batch, each rank loads its
1/N share of it, the batch norms mean their statistics over the ranks
and the trainer means gradients and metrics (`train/spade_trainer.py`).
A batch that the ranks do not divide runs whole on every rank (what one
device computes). Rank 0 writes metrics, snapshots and checkpoints. The
draws of iteration i (the style eps) come from a generator seeded by
(`--seed`, i) and each epoch's order from (`--seed`, epoch), so a resumed
run continues exactly as the uninterrupted one would.

Usage:
    python -m scenedreamer_tpu_torch.cli.train_spade \\
        --config configs/landscape1m.yaml --data-root data/lhq \\
        --logdir logs
    python -m torch.distributed.run --nproc_per_node 8 \\
        -m scenedreamer_tpu_torch.cli.train_spade ...
"""
import argparse
import itertools
import os
import signal
import threading
import time

import torch
import torch.distributed as dist

from scenedreamer_tpu_torch.cli.train import (_any_rank, _barrier,
                                              _find_resume_dir)
from scenedreamer_tpu_torch.data.paired_dataset import (AugmentConfig,
                                                        DataLoader,
                                                        PairedImageDataset)
from scenedreamer_tpu_torch.device import device_from_flags, resolve_device
from scenedreamer_tpu_torch.models.spade import SPADEWrapper
from scenedreamer_tpu_torch.parallel import mesh as pm
from scenedreamer_tpu_torch.train import gan_losses as G
from scenedreamer_tpu_torch.train import optim
from scenedreamer_tpu_torch.train.losses import PerceptualLoss
from scenedreamer_tpu_torch.train.spade_trainer import SpadeTrainer
from scenedreamer_tpu_torch.train.trainer import (TrainerConfig,
                                                  load_checkpoint,
                                                  save_checkpoint)
from scenedreamer_tpu_torch.utils.config import Config
from scenedreamer_tpu_torch.utils.meters import (MetricsWriter,
                                                 make_logging_dir)
from scenedreamer_tpu_torch.utils.visualization import (image_grid,
                                                        tensor2im,
                                                        tensor2label)


def _parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--config', default='configs/landscape1m.yaml')
    p.add_argument('--data-root', required=True,
                   help='images/ + seg_maps/ folder')
    p.add_argument('--dataset-type', default='folder',
                   choices=['folder', 'lmdb'])
    p.add_argument('--logdir', default='logs')
    p.add_argument('--batch-size', type=int, default=None,
                   help='default: data.train.batch_size from config')
    p.add_argument('--image-size', type=int, default=None,
                   help='training crop override (default: the '
                        "config's data.train.augmentations pipeline)")
    p.add_argument('--out-size', type=int, default=None,
                   choices=[256, 512, 1024],
                   help='generator output-tap ladder '
                        '(gen.out_image_small_side_size)')
    p.add_argument('--max-epoch', type=int, default=None)
    p.add_argument('--max-iter', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--no-perceptual', action='store_true',
                   help='drop the VGG19 term (CPU smoke runs)')
    p.add_argument('--num-filters', type=int, default=None,
                   help='override gen.num_filters (tiny CPU runs)')
    p.add_argument('--dis-filters', type=int, default=None)
    p.add_argument('--style-dims', type=int, default=None)
    p.add_argument('--spade-filters', type=int, default=None)
    p.add_argument('--style-enc-filters', type=int, default=None)
    p.add_argument('--platform', default=None,
                   help="'cpu', or 'gpu' / 'cuda' (the default); --device "
                        'wins when both are given')
    p.add_argument('--device', default=None,
                   help="torch device (default 'cuda'; 'cpu' runs on the "
                        'CPU)')
    return p


def augment_and_crop(cfg, image_size=None):
    """(augmentations, crop) of `--image-size`, else of the config's
    `data.train.augmentations` (reference `landscape1m.yaml:111-133`),
    else a 256 crop."""
    aug_ops = cfg.get('data', {}).get('train', {}).get('augmentations')
    if image_size:
        crop = (image_size, image_size)
        return AugmentConfig(resize_smallest_side=image_size,
                             random_crop_h_w=crop), crop
    if aug_ops:
        augment = {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                   for k, v in aug_ops.items()}
        rs = augment.get('resize_smallest_side')
        crop = tuple(augment.get('random_crop_h_w')
                     or augment.get('center_crop_h_w')
                     or augment.get('resize_h_w')
                     or ((rs, rs) if rs else (256, 256)))
        return augment, crop
    return AugmentConfig(resize_smallest_side=256,
                         random_crop_h_w=(256, 256)), (256, 256)


def build_trainer(cfg, a, device, iters_per_epoch, image_size, mesh=None):
    """The SPADE generator, the multi-scale D, the perceptual loss, the
    optimizers and the `SpadeTrainer` from the config and the flags, on
    `device` (JAX `cli/train_spade.py:111-190`)."""
    tcfg, gen_c, dis_c = (cfg.get(k, {}) for k in ('trainer', 'gen', 'dis'))
    # reference ladder = min(crop) (`spade.py:43`), snapped down to the
    # nearest implemented tap ladder
    default_out = [s for s in (256, 512, 1024)
                   if s <= max(image_size, 256)][-1]
    num_labels = int(gen_c.get('num_labels', 184))
    gen = SPADEWrapper(
        num_labels=num_labels,
        out_size=a.out_size or int(gen_c.get('out_image_small_side_size',
                                             default_out)),
        style_dims=a.style_dims or int(gen_c.get('style_dims', 256)),
        num_filters=a.num_filters or int(gen_c.get('num_filters', 128)),
        output_multiplier=float(gen_c.get('output_multiplier', 0.5)),
        spade_filters=a.spade_filters or int(
            gen_c.get('activation_norm_params', {}).get('num_filters', 128)),
        style_enc_filters=a.style_enc_filters or int(
            gen_c.get('style_enc', {}).get('num_filters', 64)),
        bn_mode='train', style_encoder=True, seed=a.seed).to(device)
    dis = G.MultiScaleDiscriminator(
        num_labels,
        num_discriminators=int(dis_c.get('num_discriminators', 2)),
        num_filters=a.dis_filters or int(dis_c.get('num_filters', 128)),
        max_num_filters=int(dis_c.get('max_num_filters', 512)),
        num_layers=int(dis_c.get('num_layers', 5)),
        kernel_size=int(dis_c.get('kernel_size', 4)),
        seed=a.seed + 1).to(device)

    perceptual = None
    pcfg = tcfg.get('perceptual_loss', {})
    if not a.no_perceptual and pcfg:
        perceptual = PerceptualLoss(
            layers=tuple(pcfg.get('layers', ('relu_1_1', 'relu_2_1',
                                             'relu_3_1', 'relu_4_1',
                                             'relu_5_1'))),
            weights=tuple(pcfg.get('weights', (0.03125, 0.0625, 0.125, 0.25,
                                               1.0))),
            seed=a.seed).to(device)
    mac = tcfg.get('model_average_config', {})
    ema_beta = float(mac.get('beta', 0.9999)) \
        if mac.get('enabled', False) else 0.0
    weights = dict(tcfg.get('loss_weight', G.SPADE_LOSS_WEIGHTS))
    if perceptual is None:
        weights.pop('perceptual', None)

    def _opt(section, module, default_lr):
        o = cfg.get(section, {})
        return optim.make_optimizer(
            module.parameters(), o.get('type', 'adam'),
            float(o.get('lr', default_lr)),
            dict(o['lr_policy']) if o.get('lr_policy') else None,
            iters_per_epoch=iters_per_epoch)

    return SpadeTrainer(
        gen, dis, cfg=TrainerConfig(ema_beta=ema_beta),
        perceptual=perceptual, g_opt=_opt('gen_opt', gen, 1e-4),
        d_opt=_opt('dis_opt', dis, 4e-4),
        gan_mode=tcfg.get('gan_mode', 'hinge'), loss_weights=weights,
        ema_start=int(mac.get('start_iteration', 1000)), mesh=mesh)


def step_generator(seed, it, device):
    """The torch generator of iteration `it`'s draws: a function of
    (seed, it) alone, so a resumed run draws what the uninterrupted one
    did."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + it) % (2 ** 63))


def main(argv=None):
    a = _parser().parse_args(argv)
    device = resolve_device(device_from_flags(a.device, a.platform))
    started = not dist.is_initialized()
    pm.init_distributed(device)
    started = started and dist.is_initialized()
    if device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())
    cfg = Config(a.config)
    stop_requested = {'flag': False}
    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _on_term(signum, frame):
            stop_requested['flag'] = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _on_term)
    try:
        return _run(a, cfg, device, stop_requested)
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        if started:
            dist.destroy_process_group()


def _run(a, cfg, device, stop_requested):
    max_epoch = a.max_epoch or int(cfg.get('max_epoch', 400))
    logging_iter = int(cfg.get('logging_iter', 100))
    snapshot_save_iter = int(cfg.get('snapshot_save_iter', 30000))
    image_save_iter = int(cfg.get('image_save_iter', 5000))
    data_c = cfg.get('data', {})
    augment, crop = augment_and_crop(cfg, a.image_size)
    batch_size = a.batch_size or int(data_c.get('train', {})
                                     .get('batch_size', 4))
    rank, world = pm.rank(), pm.world_size()
    # data parallel where the ranks divide the batch; else every rank
    # runs the whole batch, as one device would
    mesh = pm.make_mesh()
    if world > 1 and batch_size % world:
        print(f'[train_spade] batch {batch_size} not divisible by {world} '
              'ranks - each rank runs the whole batch')
        mesh = None
    shards = mesh.data if mesh is not None else 1
    dataset = PairedImageDataset(
        a.data_root, dataset_type=a.dataset_type, augment=augment,
        num_seg_classes=int(data_c.get('one_hot_num_classes', 183)))
    loader = DataLoader(
        dataset, batch_size=batch_size // shards, seed=a.seed,
        process_index=mesh.data_index if mesh is not None else 0,
        process_count=shards, num_workers=int(data_c.get('num_workers', 4)))
    iters_per_epoch = max(1, len(loader))
    trainer = build_trainer(cfg, a, device, iters_per_epoch, int(min(crop)),
                            mesh)
    if mesh is not None and mesh.data_group is not None:
        print(f'[train_spade] rank {rank} of {world} '
              f'({dist.get_backend()}), batch sharded {shards} ways, '
              'sync batch norm')

    logdir = [make_logging_dir(a.logdir, cfg.get('name', 'landscape1m'))
              if rank == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(logdir, src=0, device=pm.comm_device())
    logdir = logdir[0]
    writer = MetricsWriter(logdir if rank == 0 else None)
    ckpt_dir = os.path.join(logdir, 'checkpoints')
    print(f'[train_spade] logging to {logdir} ({len(dataset)} items, '
          f'{iters_per_epoch} it/epoch)')

    it = 0
    if a.resume:
        resume_dir = [_find_resume_dir(a.logdir, ckpt_dir)]
        if dist.is_initialized():
            dist.broadcast_object_list(resume_dir, src=0,
                                       device=pm.comm_device())
        resume_dir = resume_dir[0]
        if resume_dir and load_checkpoint(resume_dir, trainer) is not None:
            it = trainer.step
            print(f'[train_spade] resumed at iteration {it} '
                  f'from {resume_dir}')
    pm.replicate(trainer.gen)
    pm.replicate(trainer.dis)

    def _save():
        if rank == 0:
            save_checkpoint(ckpt_dir, trainer)
        _barrier()

    pending = []

    def _flush():
        for m in pending:
            for k, v in m.items():
                writer.meter(k).write(v)
        pending.clear()
        writer.flush_meters(it)

    t0 = time.time()
    done = False
    try:
        for epoch in range(it // iters_per_epoch, max_epoch):
            loader.set_epoch(epoch, it % iters_per_epoch)
            for data in itertools.islice(iter(loader),
                                         iters_per_epoch
                                         - it % iters_per_epoch):
                if _any_rank(stop_requested['flag']):
                    print('[train_spade] termination requested - '
                          'checkpointing')
                    done = True
                    break
                batch = {k: torch.from_numpy(data[k]).to(device)
                         for k in ('images', 'label')}
                metrics = trainer.train_step(
                    batch, step_generator(a.seed, it, device))
                it += 1
                pending.append(metrics)
                if it % logging_iter == 0:
                    _flush()
                    print(f'[train_spade] it {it} epoch {epoch} '
                          f"G {metrics['gen/total']:.4f} "
                          f"D {metrics['dis/total']:.4f} "
                          f'({logging_iter / (time.time() - t0):.3f} it/s)')
                    t0 = time.time()
                if it % image_save_iter == 0:
                    if rank == 0:
                        _save_snapshot(writer, trainer, batch,
                                       a.seed, it, device)
                    _barrier()
                if it % snapshot_save_iter == 0:
                    _save()
                if a.max_iter and it >= a.max_iter:
                    done = True
                    break
            if done:
                break
        if pending:
            _flush()
        _save()
        print(f'[train_spade] done at iteration {it}; '
              f'checkpoints in {ckpt_dir}')
    finally:
        writer.close()
    return trainer


def _save_snapshot(writer, trainer, batch, seed, it, device):
    """Visualization strip real | label | fake | fake (EMA) of the first
    sample (`trainers/base.py:530-551`); both fakes from the same style
    draw."""
    imgs = [tensor2im(batch['images'][0]), tensor2label(batch['label'][0])]
    out = trainer.generate(batch, step_generator(seed, it, device),
                           use_ema=False)
    imgs.append(tensor2im(out['fake_images'][0]))
    if trainer.g_ema is not None:
        ema = trainer.generate(batch, step_generator(seed, it, device),
                               use_ema=True)
        imgs.append(tensor2im(ema['fake_images'][0]))
    h = min(im.shape[0] for im in imgs)
    w = min(im.shape[1] for im in imgs)
    writer.image('train/snapshot', image_grid([im[:h, :w] for im in imgs]),
                 it)


if __name__ == '__main__':
    main()
