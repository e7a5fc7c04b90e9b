"""Training CLI: the SceneDreamer GAN training loop, in PyTorch.

Counterpart of `scenedreamer_tpu/cli/train.py` (reference `train.py:50-164`):
config loading, seeding, dataloader / model / trainer construction, the
epoch / iteration loop with the D and G updates, metric logging, image
snapshots, checkpoint cadence, resume from `latest_checkpoint.txt`, and a
checkpoint on SIGTERM / SIGINT.

The per-iteration flow mirrors `trainers/gancraft.py:139-156`: sample a
cached world, rejection-sample cameras (kernel K1), make the SPADE
pseudo ground truth and the masks, outside autograd; then run the
training step (kernels K2/K3, or K5 with `gen.hash_variant: paired`).
The same yaml keys and flags as the JAX package's CLI, plus `--device`
(default 'cuda'; raises without a GPU unless 'cpu' is asked for;
`--platform cpu|gpu` says the same).

Several processes (torchrun's env:// rendezvous; NCCL on CUDA, gloo on
the CPU) train data-parallel over a ('data', `--mesh-rays`) mesh of the
ranks (`parallel/mesh.py`): each data group loads its own share of the
dataset and seeds its host and device draws with `--seed` + its data
index; the first rank of each rays group builds the group's batch and
broadcasts it; the trainer means gradients and metrics over the ranks;
rank 0 writes the metrics, the image snapshots and the checkpoints, and
every rank resumes from the same checkpoint.

`trainer.amp_config.enabled: true` trains with bf16 compute in the
generator, the discriminator and the VGG loss, float32
parameters, optimizer state and losses, and no loss scaling (JAX
`cli/train.py:48-56`); `trainer.aug_policy` turns on DiffAugment;
`--profile` writes a `torch.profiler` Chrome trace of iterations 2-4
(CPU and CUDA activity, with the recorder's spans: `utils/profiling.py`)
under `<logdir>/trace`; `--speed-benchmark` logs each span's mean host
time as `speed/<span>_ms` (no device barrier: a span holds what the host
spent in it, waits on the device included) and each counter per step as
`speed/<counter>` (the values read from the device, `host_reads`, and with
a mesh the bytes and calls of the gradient exchange).

Usage:
    python -m scenedreamer_tpu_torch.cli.train \\
        --config configs/scenedreamer_train.yaml \\
        --data-root data/lhq --terrain-cache data/terrain_cache \\
        --logdir logs
    python -m torch.distributed.run --nproc_per_node 8 \\
        -m scenedreamer_tpu_torch.cli.train ... [--mesh-rays 2]
"""
import argparse
import glob
import itertools
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack

import numpy as np
import torch
import torch.distributed as dist

from scenedreamer_tpu_torch.data.paired_dataset import (AugmentConfig,
                                                        DataLoader,
                                                        PairedImageDataset)
from scenedreamer_tpu_torch.device import device_from_flags, resolve_device
from scenedreamer_tpu_torch.models.discriminator import GANcraftDiscriminator
from scenedreamer_tpu_torch.models.generator import (GeneratorConfig,
                                                     SceneDreamerGenerator)
from scenedreamer_tpu_torch.models.spade import SPADEWrapper
from scenedreamer_tpu_torch.parallel import mesh as pm
from scenedreamer_tpu_torch.scene.voxel_world import WorldCache
from scenedreamer_tpu_torch.train import losses as L
from scenedreamer_tpu_torch.train import optim
from scenedreamer_tpu_torch.train.sampling import (CameraBatchSampler,
                                                   CameraSamplerConfig,
                                                   PseudoGTGenerator,
                                                   TrainingBatchBuilder)
from scenedreamer_tpu_torch.train.trainer import (GANTrainer, TrainerConfig,
                                                  latest_checkpoint,
                                                  load_checkpoint,
                                                  save_checkpoint,
                                                  split_generator)
from scenedreamer_tpu_torch.utils.convert import (
    load_reference_spade_state_dict, spade_frozen_from_trained)
from scenedreamer_tpu_torch.utils.config import Config
from scenedreamer_tpu_torch.utils.meters import (MetricsWriter,
                                                 make_logging_dir)
from scenedreamer_tpu_torch.utils import profiling
from scenedreamer_tpu_torch.utils.visualization import (image_grid,
                                                        tensor2im,
                                                        tensor2label)


def generator_config(cfg):
    """The `GeneratorConfig` of a config's `gen` block (and the bf16
    compute dtype of `trainer.amp_config.enabled`): the generator that
    `cli.train` trains and `cli/campaign.py` renders fake sets with."""
    gen_cfg = cfg.get('gen', {})
    # `trainer.amp_config.enabled` (reference
    # `configs/scenedreamer_train.yaml:11-12`, GradScaler machinery in
    # `trainers/base.py:77-78`): bf16 module compute with float32
    # parameters and losses, as the JAX package: no loss scaling (bf16
    # has float32's exponent range), and the trainer's skip of a
    # non-finite gradient stands in for the scaler's retry
    amp = bool(cfg.get('trainer', {}).get('amp_config', {})
               .get('enabled', False))
    return GeneratorConfig(
        dtype=torch.bfloat16 if amp else torch.float32,
        style_dims=int(gen_cfg.get('style_dims', 128)),
        interm_style_dims=int(gen_cfg.get('interm_style_dims', 256)),
        final_feat_dim=int(gen_cfg.get('final_feat_dim', 64)),
        pad=int(gen_cfg.get('pad', 6)),
        num_blocks_early_stop=int(gen_cfg.get('num_blocks_early_stop', 6)),
        num_samples=int(gen_cfg.get('num_samples', 24)),
        sample_depth=float(gen_cfg.get('sample_depth', 3.0)),
        raw_noise_std=float(gen_cfg.get('raw_noise_std', 0.0)),
        dists_scale=float(gen_cfg.get('dists_scale', 0.25)),
        # extensions over the reference yaml: the hash-grid / MLP sizes
        # (hard-coded at scenedreamer.py:51 upstream)
        hash_num_levels=int(gen_cfg.get('hash_num_levels', 16)),
        hash_level_dim=int(gen_cfg.get('hash_level_dim', 8)),
        hash_log2_size=int(gen_cfg.get('hash_log2_size', 19)),
        hash_desired_resolution=int(gen_cfg.get('hash_desired_resolution',
                                                2048)),
        hash_variant=str(gen_cfg.get('hash_variant', 'xor')),
        mlp_hidden=int(gen_cfg.get('mlp_hidden', 256)),
        style_enc_num_filters=int(
            gen_cfg.get('style_enc', {}).get('num_filters', 64)),
    )


def build_everything(cfg, args, device, mesh):
    """Models, loader, world cache, batch builder and trainer from the
    config and the parsed flags, on `device`; the loader reads the
    share of `mesh`'s data group, and the trainer steps over the mesh."""
    gen_cfg = cfg.get('gen', {})
    crop = tuple(gen_cfg.get('crop_size', (256, 256)))
    gcfg = generator_config(cfg)
    model_dtype = gcfg.dtype
    generator = SceneDreamerGenerator(gcfg, seed=args.seed).to(device)

    dis_cfg = cfg.get('dis', {})
    discriminator = GANcraftDiscriminator(
        num_labels=int(dis_cfg.get('num_labels', 12)),
        num_filters=int(dis_cfg.get('num_filters', 128)),
        smooth_resample=bool(dis_cfg.get('smooth_resample', True)),
        dtype=model_dtype, seed=args.seed).to(device)

    dataset = PairedImageDataset(
        args.data_root, dataset_type=args.dataset_type,
        augment=AugmentConfig(random_crop_h_w=crop))
    loader = DataLoader(dataset, batch_size=args.batch_size,
                        seed=args.seed, process_index=mesh.data_index,
                        process_count=mesh.data,
                        num_workers=int(cfg.get('data', {})
                                        .get('num_workers', 4)))

    world_cache = WorldCache(args.terrain_cache)

    spade_apply = _load_spade_oracle(args, device)
    sampler, pseudo_gt, builder = _build_sampler_and_pgt(
        cfg, args, spade_apply, device,
        num_blocks_early_stop=gcfg.num_blocks_early_stop)

    # losses / trainer
    lw = dict(cfg.get('trainer', {}).get('loss_weight',
                                         L.DEFAULT_LOSS_WEIGHTS))
    if not lw:
        # Config injects an empty loss_weight default; an empty dict
        # would train with a constant-zero objective
        lw = dict(L.DEFAULT_LOSS_WEIGHTS)
    perc_cfg = cfg.get('trainer', {}).get('perceptual_loss', None)
    perceptual = None
    if 'perceptual' in lw:
        kwargs = {}
        if perc_cfg:
            kwargs = dict(layers=tuple(perc_cfg['layers']),
                          weights=tuple(perc_cfg['weights']))
        perceptual = L.PerceptualLoss(seed=args.seed, dtype=model_dtype,
                                      **kwargs).to(device)
    ema_cfg = cfg.get('trainer', {}).get('model_average_config', {})
    ema_beta = 0.0
    if ema_cfg.get('enabled', False):
        if 'g_smooth_img' in ema_cfg:
            # half-life parameterization (`utils/trainer.py:158-167`):
            # beta = 0.5 ** (global_batch / g_smooth_img)
            ema_beta = 0.5 ** (args.batch_size * mesh.data
                               / float(ema_cfg['g_smooth_img']))
        else:
            ema_beta = float(ema_cfg.get('beta', 0.9999))
    # grad clip/skip (reference `gen_opt.clip_grad_norm` +
    # `gen_opt.skip_grad`, `trainers/base.py:701-721`): trainer.* keys
    # take precedence, gen_opt.* accepted for reference-yaml compatibility
    tcfg = cfg.get('trainer', {})
    gocfg = cfg.get('gen_opt', {})
    clip = float(tcfg.get('grad_clip_norm',
                          gocfg.get('clip_grad_norm', 0.0) or 0.0)
                 if not gocfg.get('skip_grad', False) else 0.0)
    skip_norm = float(tcfg.get(
        'skip_grad_norm',
        (gocfg.get('clip_grad_norm', 0.0) or 0.0)
        if gocfg.get('skip_grad', False) else 0.0))
    do = cfg.get('dis_opt', {})
    iters_per_epoch = max(len(loader), 1)
    d_opt = optim.make_discriminator_optimizer(
        discriminator, lr=float(do.get('lr', optim.DIS_LR)),
        lr_policy=dict(do['lr_policy']) if do.get('lr_policy') else None,
        iters_per_epoch=iters_per_epoch)
    trainer = GANTrainer(
        generator, discriminator, voxel_dims=None,  # set per world
        cfg=TrainerConfig(
            loss_weights=lw,
            grad_clip_norm=clip,
            skip_grad_norm=skip_norm,
            aug_policy=str(tcfg.get('aug_policy', '') or ''),
            ema_beta=ema_beta),
        perceptual=perceptual, d_opt=d_opt,
        iters_per_epoch=iters_per_epoch, mesh=mesh)
    if float(do.get('lr', optim.DIS_LR)) != optim.DIS_LR:
        print(f"[train] dis lr override: {do.get('lr')}")
    if clip or skip_norm:
        print(f'[train] grad guard: clip_norm={clip} '
              f'skip_norm={skip_norm}')
    return (generator, discriminator, loader, world_cache, builder,
            trainer, gcfg)


def build_spade_oracle(args):
    """The frozen SPADE pseudo-GT oracle (`models/spade.SPADEWrapper`,
    184 labels: the pseudo-GT one-hot is 185-ch but the oracle consumes
    label[..., :-1] exactly like the reference, `trainers/gancraft.py:53`)
    on the CPU in float32, eval mode, without gradients.
    `--spade-checkpoint` is a file or a `cli.train_spade` run (its run
    directory or its checkpoints directory: the latest checkpoint), read
    by what it holds, not by its suffix (as `cli/inference.py:
    load_generator` reads a generator):
      * a `cli.train_spade` checkpoint ('generator' and 'step') -> folded
        into the frozen layout, the EMA parameters when kept (JAX
        `cli/train.py:189-227`);
      * the reference's checkpoint (`{'net_G': ...}`, spectral-norm
        `weight_orig` triplets, `module.` prefixes; JAX `:186-194`) or
        the port's frozen state dict saved with `torch.save` ->
        `utils.convert.load_reference_spade_state_dict`.
    A reference file holds optimizer and scheduler objects, so it is
    opened with `weights_only=False`. The widths (and the style encoder,
    when the file carries one) come from the checkpoint; without one, a
    seeded random init at the flags' widths. `args` needs
    spade_checkpoint / spade_size / spade_filters."""
    sd = None
    nf, sf, zd = args.spade_filters, 128, 256
    if args.spade_checkpoint:
        path = args.spade_checkpoint
        if os.path.isdir(path):
            # a train_spade run dir (its pointer under checkpoints/) or
            # the checkpoints dir itself
            path = (latest_checkpoint(path)
                    or latest_checkpoint(os.path.join(path, 'checkpoints')))
            if path is None:
                raise SystemExit(f'--spade-checkpoint {args.spade_checkpoint}'
                                 ': no checkpoint found there')
        ckpt = torch.load(path, map_location='cpu', weights_only=False)
        if 'generator' in ckpt and 'step' in ckpt:
            # a cli.train_spade checkpoint: freeze the trained oracle
            sd = spade_frozen_from_trained(ckpt)
        else:
            sd = load_reference_spade_state_dict(ckpt)
        head = sd['spade_generator.head_0.layers.conv.weight']
        if head.shape[1] != 184:
            raise SystemExit(
                f'--spade-checkpoint has a {head.shape[1]}-label oracle; '
                'the pseudo-GT path (like the reference, '
                'trainers/gancraft.py:53) feeds a 184-label SPADE with '
                'label[..., :-1]. Re-export the checkpoint at 184 labels.')
        # architecture widths come from the checkpoint when one is
        # loaded; the flags only describe the default reference shape
        nf = head.shape[0] // 8
        sf = sd['spade_generator.head_1.conv_block_0.layers.norm.mlps.0.0'
                '.layers.conv.weight'].shape[0]
        zd = sd['spade_generator.fc_0.layers.conv.weight'].shape[1]
    enc = None if sd is None else sd.get(
        'style_encoder.layer1.layers.conv.weight')
    # with weights to load, built on the meta device and given the loaded
    # tensors: the random init of the landscape1m width (414M values)
    # would cost seconds of host time for nothing
    with torch.device('meta' if sd is not None else 'cpu'):
        spade = SPADEWrapper(num_labels=184, out_size=args.spade_size,
                             num_filters=nf, spade_filters=sf, style_dims=zd,
                             style_encoder=enc is not None,
                             style_enc_filters=64 if enc is None
                             else enc.shape[0], seed=0)
    if sd is not None:
        spade.load_state_dict(sd, assign=True)
        print('[train] loaded SPADE oracle weights')
    else:
        print('[train] WARNING: SPADE oracle randomly initialized '
              '(provide --spade-checkpoint for real pseudo-GT)')
    return spade.eval().requires_grad_(False)


def _load_spade_oracle(args, device):
    """The frozen oracle of `build_spade_oracle` on `device` as an apply
    function: (label one-hot [B, R, R, 185], torch generator) -> image
    [B, R, R, 3]. `args` needs spade_checkpoint / spade_size /
    spade_res / spade_filters / spade_oracle_f32."""
    spade = build_spade_oracle(args).to(device)
    if not args.spade_oracle_f32:
        # the reference evals its frozen oracle half-precision
        # unconditionally (`trainers/gancraft.py:41` calls `.half()`
        # whether or not AMP is on); bf16 as in the JAX package. The
        # wrapper casts the labels to the weights' type and
        # `PseudoGTGenerator` casts the image back to float32.
        spade = spade.to(torch.bfloat16)

    def spade_apply(masks, generator):
        with torch.no_grad():
            return spade({'label': masks[..., :-1]}, random_style=True,
                         generator=generator)['fake_images']
    return spade_apply


def _build_sampler_and_pgt(cfg, args, spade_apply, device,
                           num_blocks_early_stop=6):
    """Camera sampler + pseudo-GT + batch builder from a config dict."""
    gen_cfg = cfg.get('gen', {})
    crop = tuple(gen_cfg.get('crop_size', (256, 256)))
    pad = int(gen_cfg.get('pad', 6))
    sampler = CameraBatchSampler(CameraSamplerConfig(
        cam_res=tuple(gen_cfg.get('cam_res', (360, 640))),
        crop_size=crop, pad=pad,
        num_blocks_early_stop=num_blocks_early_stop,
        camera_sampler_type=gen_cfg.get('camera_sampler_type',
                                        'traditional'),
        camera_rej_avg_depth=float(gen_cfg.get('camera_rej_avg_depth',
                                               2.0)),
        camera_min_entropy=float(gen_cfg.get('camera_min_entropy', 0.75)),
        label_smooth_dia=int(gen_cfg.get('label_smooth_dia', 11))),
        device=device)
    pseudo_gt = PseudoGTGenerator(
        spade_apply, pad=pad, spade_res=args.spade_res,
        use_label_smooth_pgt=bool(gen_cfg.get('use_label_smooth_pgt',
                                              True)),
        label_smooth_dia=int(gen_cfg.get('label_smooth_dia', 11)))
    builder = TrainingBatchBuilder(sampler, pseudo_gt)
    return sampler, pseudo_gt, builder


def _parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--config', default=None)
    p.add_argument('--data-root', required=True)
    p.add_argument('--dataset-type', default='folder',
                   choices=['folder', 'lmdb'])
    p.add_argument('--terrain-cache', required=True)
    p.add_argument('--spade-checkpoint', default='')
    p.add_argument('--spade-size', type=int, default=512,
                   choices=[256, 512, 1024],
                   help='SPADE architecture variant (512 = reference)')
    p.add_argument('--spade-res', type=int, default=512,
                   help='resolution the oracle is evaluated at '
                        '(512 = reference)')
    p.add_argument('--spade-filters', type=int, default=128)
    p.add_argument('--world-switch-every', type=int, default=1,
                   help='resample the PCG world every N iterations '
                        '(1 = the reference per-iteration semantics, '
                        'scenedreamer.py:88)')
    p.add_argument('--spade-oracle-f32', action='store_true',
                   help='keep the frozen SPADE oracle in float32 (the '
                        'reference runs it half-precision always, '
                        'trainers/gancraft.py:41, so bf16 is the default)')
    p.add_argument('--logdir', default='logs')
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--max-epoch', type=int, default=None)
    p.add_argument('--max-iter', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--two-forward', dest='shared_fwd',
                   action='store_false', default=True,
                   help='render the generator twice per iteration '
                        '(separate D/G forwards, the reference shape); '
                        'default is the single-forward step '
                        '(train_step_shared). Env override: '
                        'SCENEDREAMER_SHARED_FWD=0')
    p.add_argument('--profile', action='store_true',
                   help='write a torch.profiler Chrome trace (CPU and CUDA '
                        'activity, and the spans) of iterations 2-4 of this '
                        'process to '
                        '<logdir>/trace (reference train.py:129-151; after '
                        'the first iterations, which build the kernels '
                        'and warm the allocator)')
    p.add_argument('--speed-benchmark', action='store_true',
                   help='log the mean host ms of each span '
                        '(world_sample, batch_build, train_step and the '
                        "step's own, utils/profiling.py) as speed/<span>_ms "
                        'and each counter per step as speed/<counter> '
                        '(trainers/base.py:876-940 speed_benchmark, '
                        'without its device barrier); disables the '
                        'prefetch so phases stay attributable')
    p.add_argument('--no-prefetch', dest='prefetch', action='store_false',
                   help='disable building batch i+1 on a worker thread '
                        'while the device trains on batch i (a single '
                        'ordered worker keeps every rng/world call in '
                        'the serial order, so the batches are the same)')
    p.add_argument('--mesh-rays', type=int, default=1,
                   help='size of the rays (image-row) axis of the mesh of '
                        'ranks; data axis = ranks // rays')
    p.add_argument('--platform', default=None,
                   help="'cpu', or 'gpu' / 'cuda' (the default); --device "
                        'wins when both are given')
    p.add_argument('--device', default=None,
                   help="torch device (default 'cuda'; 'cpu' runs the "
                        'plain PyTorch path)')
    return p


def main(argv=None):
    a = _parser().parse_args(argv)
    device = resolve_device(device_from_flags(a.device, a.platform))
    started = not dist.is_initialized()
    pm.init_distributed(device)
    started = started and dist.is_initialized()
    if device.type == 'cuda':
        # this rank's GPU by its index: a bare 'cuda' would mean GPU 0 on
        # the prefetch worker's thread, whose current device is its own
        device = torch.device('cuda', torch.cuda.current_device())
    cfg = Config(a.config)

    # AutoResume parity (`train.py:152-158`): on SIGTERM/SIGINT save a
    # checkpoint before exiting so the run resumes with --resume.
    # Handlers can only be set from the main thread; the caller's are
    # restored on the way out.
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
    logging_iter = int(cfg.get('logging_iter', 10))
    snapshot_save_iter = int(cfg.get('snapshot_save_iter', 10000))
    snapshot_save_epoch = int(cfg.get('snapshot_save_epoch', 5))
    image_save_iter = int(cfg.get('image_save_iter', 5000))
    # the ('data', 'rays') mesh of the ranks (JAX `cli/train.py:386-395`):
    # with process groups whenever torch.distributed is up, world 1 too
    mesh = pm.make_mesh(rays=a.mesh_rays)
    rank = pm.rank()
    if dist.is_initialized():
        print(f'[train] rank {rank} of {pm.world_size()} '
              f'({dist.get_backend()}), mesh {mesh.shape}, data index '
              f'{mesh.data_index}, rays index {mesh.rays_index}')
    (gen, dis, loader, world_cache, builder, trainer, gcfg) = \
        build_everything(cfg, a, device, mesh)

    # rank 0 names the run directory; rank 0 alone writes into it
    logdir = [make_logging_dir(a.logdir, cfg.get('name', 'scenedreamer'))
              if rank == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(logdir, src=0,
                                   device=pm.comm_device())
    logdir = logdir[0]
    writer = MetricsWriter(logdir if rank == 0 else None)
    ckpt_dir = os.path.join(logdir, 'checkpoints')
    print(f'[train] logging to {logdir}')

    def _save():
        # rank 0 writes; the others wait until it is on disk
        if rank == 0:
            path = save_checkpoint(ckpt_dir, trainer)
        else:
            path = os.path.join(ckpt_dir, f'step_{trainer.step:08d}.pt')
        _barrier()
        return path

    # host dice (worlds, cameras, relabeling) from one numpy generator;
    # device draws (oracle style, render) from per-step torch generators
    # seeded off one master generator; both seeded by the data index
    # (JAX `cli/train.py:422-423` seeds by process), so the ranks of a
    # rays group draw alike
    rng = np.random.default_rng(a.seed + mesh.data_index)
    master = torch.Generator().manual_seed(a.seed + mesh.data_index)
    # the first rank of each rays group builds its batches
    builds = mesh.rays_index == 0

    # one world per batch element (reference: one per DDP rank).
    # WorldCache crops every world to the cache-wide height slab, so
    # voxel dims are the same across swaps.
    world = [world_cache.sample_world(rng=_RandomAdapter(rng))
             for _ in range(a.batch_size)]
    trainer.voxel_dims = tuple(int(d) for d in world[0].voxel.shape)

    if a.speed_benchmark:
        profiling.enable()
    profile_window = (2, 4) if a.profile and rank == 0 else None
    trace_dir = os.path.join(logdir, 'trace')
    trace = {'open': None}

    def _stop_trace():
        if trace['open'] is None:
            return
        trace['open'].close()
        trace['open'] = None
        path = os.path.join(trace_dir, 'trace.json')
        print(f'[train] trace written to {path}')

    it = 0
    steps_run = 0   # iterations run by THIS process (`it` jumps on resume)
    shared = a.shared_fwd and bool(int(os.environ.get(
        'SCENEDREAMER_SHARED_FWD', '1')))
    step_fn = trainer.train_step_shared if shared else trainer.train_step
    print(f"[train] iteration step: "
          f"{'single-forward (shared graph)' if shared else 'two-forward'}")
    if a.resume:
        # every rank resumes from the checkpoint rank 0 finds
        resume_dir = [_find_resume_dir(a.logdir, ckpt_dir)]
        if dist.is_initialized():
            dist.broadcast_object_list(resume_dir, src=0,
                                       device=pm.comm_device())
        resume_dir = resume_dir[0]
        restored = load_checkpoint(resume_dir, trainer) \
            if resume_dir else None
        if restored is not None:
            it = int(trainer.step)
            print(f'[train] resumed at iteration {it} from {resume_dir}')
            # reset_opt_{g,d}_on_resume (`trainers/gancraft.py:300-305`):
            # fresh optimizer state, restored weights
            tc = cfg.get('trainer', {})
            ipe = max(len(loader), 1)
            if tc.get('reset_opt_g_on_resume', False):
                trainer.g_opt = optim.make_generator_optimizer(
                    gen, iters_per_epoch=ipe)
                print('[train] reset opt_G state')
            if tc.get('reset_opt_d_on_resume', False):
                do = cfg.get('dis_opt', {})
                trainer.d_opt = optim.make_discriminator_optimizer(
                    dis, lr=float(do.get('lr', optim.DIS_LR)),
                    lr_policy=dict(do['lr_policy'])
                    if do.get('lr_policy') else None, iters_per_epoch=ipe)
                print('[train] reset opt_D state')
    # the same parameters on every rank (JAX `cli/train.py:531-532`)
    pm.replicate(gen)
    pm.replicate(dis)
    pending_metrics = []

    def _flush_pending():
        for m in pending_metrics:
            for k, v in m.items():
                writer.meter(k).write(float(v))
        pending_metrics.clear()

    # batch prefetch: ONE ordered worker builds batch i+1 (world
    # resample + camera rejection + pseudo-GT) while the device runs
    # train_step(i). Sequencing is identical to the serial loop: the
    # worker executes jobs one at a time in submission order, so every
    # rng/world_cache call happens in the same order, and the torch
    # generators are seeded on the main thread. The device work of the
    # batch build rides the same stream as the train step.
    use_prefetch = a.prefetch and not a.speed_benchmark
    executor = ThreadPoolExecutor(max_workers=1) if use_prefetch else None

    def _build(data_np, it_now, g_batch):
        nonlocal world
        if not builds:
            return None
        if it_now > 0 and it_now % max(1, a.world_switch_every) == 0:
            with profiling.span('world_sample'):
                world = [world_cache.sample_world(rng=_RandomAdapter(rng))
                         for _ in range(a.batch_size)]
        data = {k: torch.from_numpy(v).to(device)
                for k, v in data_np.items() if k in ('images', 'label')}
        with profiling.span('batch_build'):
            return builder(data, world, rng, g_batch)

    def _next_generators():
        # exactly ONE pair of seeds per iteration, always in serial
        # order: prefetching only moves WHEN a pair is drawn
        return split_generator(master, device)

    def _finish(message):
        _flush_pending()
        path = _save()
        pm.check_replicated(gen, dis)
        print(message.format(it=it, ckpt_dir=ckpt_dir, path=path))

    try:
        t0 = time.time()
        for epoch in range(max_epoch):
            loader.set_epoch(epoch)
            # every data group takes len(loader) steps an epoch: the
            # loader's stride gives the first len(dataset) % data groups
            # an item more, and a group that ran on would meet another
            # group's epoch-end collectives with its step's all_reduce
            diter = itertools.islice(iter(loader), len(loader))
            nxt = next(diter, None)
            fut = None            # (future, g_step) for the prefetched batch
            while nxt is not None:
                data_np, nxt = nxt, next(diter, None)
                if profile_window and steps_run == profile_window[0] \
                        and trace['open'] is None:
                    trace['open'] = ExitStack()
                    trace['open'].enter_context(profiling.trace(trace_dir))
                if fut is not None:
                    pending, g_step = fut
                    batch = pending.result()
                    fut = None
                else:
                    g_batch, g_step = _next_generators()
                    batch = _build(data_np, it, g_batch)
                # the sampler's counts as this batch left them, before the
                # worker starts on the next: what the serial loop logs
                sampled = (builder.sampler.fallback_rate,
                           builder.sampler.stats['proposals'])
                if executor is not None and nxt is not None:
                    gb2, gs2 = _next_generators()
                    fut = (executor.submit(_build, nxt, it + 1, gb2), gs2)
                # on the main thread, so the collectives keep one order
                batch = pm.broadcast_batch(mesh, batch, device)
                if steps_run == 0:
                    pm.global_batch_from_local(mesh, batch)
                with profiling.span('train_step'):
                    metrics = step_fn(batch, g_step)
                if trace['open'] is not None \
                        and steps_run == profile_window[1]:
                    _stop_trace()
                it += 1
                steps_run += 1
                pending_metrics.append(metrics)
                if it % logging_iter == 0:
                    _flush_pending()
                    dt = time.time() - t0
                    writer.flush_meters(it)
                    writer.scalar('perf/iters_per_s', logging_iter / dt, it)
                    # cameras admitted past max_rejections must be visible
                    # (the reference retries forever; here bounded + counted)
                    writer.scalar('sampler/fallback_rate', sampled[0], it)
                    writer.scalar('sampler/proposals', sampled[1], it)
                    print(f'epoch {epoch} iter {it} '
                          f'({logging_iter / dt:.2f} it/s) '
                          f"G {float(metrics['gen/total']):.3f} "
                          f"D {float(metrics['dis/total']):.3f}")
                    if a.speed_benchmark:
                        speed = speed_scalars(profiling.take())
                        print('[speed_benchmark]\n' + '\n'.join(
                            f'{k}: {v:.2f}' for k, v in speed.items()))
                        for name, v in speed.items():
                            writer.scalar(f'speed/{name}', v, it)
                    t0 = time.time()
                if it % snapshot_save_iter == 0:
                    _save()
                if it % image_save_iter == 0:
                    if rank == 0:
                        _save_snapshot_images(writer, trainer, batch, g_step,
                                              it)
                    _barrier()
                if _any_rank(stop_requested['flag']):
                    _finish('[train] termination requested - checkpointed '
                            '{path}')
                    return
                if a.max_iter and it >= a.max_iter:
                    break
            if a.max_iter and it >= a.max_iter:
                break
            if (epoch + 1) % snapshot_save_epoch == 0:
                _save()
        _finish('[train] done at iteration {it}; checkpoints in {ckpt_dir}')
    finally:
        _stop_trace()       # a run shorter than the window
        if a.speed_benchmark:
            profiling.disable()
            profiling.take()
        writer.close()
        if executor is not None:
            executor.shutdown(wait=False, cancel_futures=True)


def speed_scalars(took):
    """`--speed-benchmark`'s scalars from what the recorder took
    (`profiling.take()`): each span's mean host ms as `<span>_ms`, and
    each counter per step as `<counter>` (`host_reads`; with a mesh
    `allreduce_bytes` and `allreduce_calls`)."""
    total = {}
    for s in took['spans']:
        n, ms = total.get(s.name, (0, 0.0))
        total[s.name] = (n + 1, ms + s.ms)
    out = {f'{k}_ms': ms / n for k, (n, ms) in sorted(total.items())}
    steps = sum(k == 'step' for k in took['units'].values())
    if steps:
        out.update((k, v / steps) for k, v in sorted(
            took['counters'].items()))
    return out


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def _any_rank(flag):
    """`flag` of any rank, so that every rank stops at the same
    iteration (a SIGTERM may reach one rank only)."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], device=pm.comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _find_resume_dir(logdir_root, own_ckpt_dir):
    """Newest prior run with a checkpoint (each run gets a fresh
    date-uid dir, so resume searches sibling runs; one
    `latest_checkpoint.txt` pointer per run, `trainers/base.py:262-270`)."""
    candidates = sorted(
        glob.glob(os.path.join(logdir_root, '*', 'checkpoints',
                               'latest_checkpoint.txt')),
        key=os.path.getmtime, reverse=True)
    for c in candidates:
        d = os.path.dirname(c)
        if os.path.abspath(d) != os.path.abspath(own_ckpt_dir):
            return d
    return None


def _save_snapshot_images(writer, trainer, batch, generator, it):
    """Periodic visualization strip: real | label | fake | pseudo-GT
    (`trainers/gancraft.py:253-286`)."""
    with torch.no_grad():
        out = trainer.gen(batch, trainer.voxel_dims, random_style=True,
                          generator=generator)
    imgs = []
    if 'images' in batch:
        imgs.append(tensor2im(batch['images'][0]))
    if 'label' in batch:
        imgs.append(tensor2label(batch['label'][0]))
    imgs.append(tensor2im(out['fake_images'][0]))
    if 'pseudo_real_img' in batch:
        imgs.append(tensor2im(batch['pseudo_real_img'][0]))
    h = min(im.shape[0] for im in imgs)
    w = min(im.shape[1] for im in imgs)
    imgs = [im[:h, :w] for im in imgs]
    writer.image('train/snapshot', image_grid(imgs), it)


class _RandomAdapter:
    """numpy Generator -> `random.choice`-style interface used by
    WorldCache."""

    def __init__(self, rng):
        self.rng = rng

    def choice(self, seq):
        return seq[int(self.rng.integers(0, len(seq)))]


if __name__ == '__main__':
    main()
