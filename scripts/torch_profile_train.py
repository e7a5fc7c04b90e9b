"""Time and profile the PyTorch port's GAN training step on the GPU.

    python scripts/torch_profile_train.py [--scene_size 1024] [--steps 3]
                                          [--hash_variant xor|paired]
                                          [--hash_log2_size 21]
                                          [--direct_only] [--amp]

Builds a world (seed 8888) and the flagship training models of
configs/scenedreamer_train.yaml from seeded random weights (generator
`GeneratorConfig()` with the chosen `hash_variant`: 'xor' runs kernels
K2/K3, 'paired' K5; with `--hash_log2_size 21` the spec is not foldable
and the step runs K4; D with 128 filters, VGG19 perceptual loss), takes
batch-1 crops of 256 + pad 6 from `data/synthetic.make_batch`, and
prints: seconds per `train_step_shared` (host clock around synchronised
steps, after two warm-up steps), the device time by kernel name over
one profiled step (torch.profiler), the device busy share of that step,
and peak device memory. With `--scatter_order`, last the variant's hash
scatter (K3a or K5c) alone on one crop's sample points in ray order (as
training feeds it) and in a random order, to show how much of its time
is atomic contention between neighbouring samples. `--direct_only` puts
every level of the table scatters K3a, K4b and K5c on the direct path
(one global atomic per corner: the scatters before their coarse path),
for a before / after pair in one run of the card. The models and the sample
points come from `chip_smoke.py` (`make_trainer`, `sample_points`).
Float32 throughout (TF32 off); `--amp` computes the generator, D and
the VGG loss in bf16 with float32 parameters and losses (the training
CLI's `trainer.amp_config.enabled: true`). Needs CUDA.
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import make_trainer, sample_points  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--scene_size', type=int, default=1024)
    p.add_argument('--seed', type=int, default=8888)
    p.add_argument('--steps', type=int, default=3)
    p.add_argument('--top', type=int, default=30)
    p.add_argument('--hash_variant', default='xor',
                   choices=['xor', 'paired'],
                   help='hash variant of the profiled step')
    p.add_argument('--hash_log2_size', type=int, default=19)
    p.add_argument('--scatter_order', action='store_true',
                   help='also time the hash scatter in ray order and '
                        'shuffled')
    p.add_argument('--amp', action='store_true',
                   help='bf16 compute (AMP), float32 parameters')
    p.add_argument('--direct_only', action='store_true',
                   help='every level of the table scatters on the direct '
                        'path')
    a = p.parse_args(argv)
    if a.scatter_order and a.hash_log2_size != 19:
        p.error('--scatter_order times the folded scatters (log2 size 19)')

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from scenedreamer_tpu_torch import kernels
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    if not torch.cuda.is_available():
        raise SystemExit('needs CUDA')
    dev = torch.device('cuda')
    print(f'device {torch.cuda.get_device_name(0)}', flush=True)
    if a.direct_only:
        kernels.COARSE_MAX_SCALE = kernels.DIRECT_ONLY
    print(f'table scatters: levels of scale <= {kernels.COARSE_MAX_SCALE} '
          f'on the coarse path', flush=True)
    t0 = time.time()
    maps = generate_terrain(size=a.scene_size, seed=a.seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=a.seed)
    voxel = torch.from_numpy(world.voxel).to(dev)
    print(f'world {world.dims} in {time.time() - t0:.1f} s', flush=True)
    cfg = GeneratorConfig(hash_variant=a.hash_variant,
                          hash_log2_size=a.hash_log2_size,
                          dtype=torch.bfloat16 if a.amp else torch.float32)
    print(f'hash variant {cfg.hash_variant}, log2 size {a.hash_log2_size}, '
          f'compute {cfg.dtype}', flush=True)
    trainer = make_trainer(cfg, world.dims, dev, seed=a.seed)
    draws = torch.Generator(device=dev).manual_seed(a.seed)
    hw = 256 + cfg.pad
    batches = [make_batch(world, batch_size=1, height=hw, width=hw,
                          max_samples=cfg.num_blocks_early_stop,
                          pad=cfg.pad, seed=a.seed + i, device=dev,
                          voxel=voxel) for i in range(a.steps + 3)]
    for batch in batches[:2]:                           # warm-up
        trainer.train_step_shared(batch, draws)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for batch in batches[2:2 + a.steps]:
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.train_step_shared(batch, draws)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    spi = statistics.mean(times)
    print(f'steps {a.steps}: {spi:.3f} s/iteration '
          f'{[round(t, 3) for t in times]}, {hw * hw / spi:.0f} rays/s '
          f'forward + backward; launches {kernels.launch_counts()}; peak '
          f'{torch.cuda.max_memory_allocated() / 1e9:.1f} GB', flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.train_step_shared(batches[-1], draws)
        torch.cuda.synchronize()
        wall = time.time() - t0

    def dev_us(evt):
        for attr in ('self_device_time_total', 'self_cuda_time_total'):
            if hasattr(evt, attr):
                return getattr(evt, attr)
        return 0.0

    # device-side events only (kernels and copies); the operator-level
    # rows would count the same device time a second time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e6
    print(f'profiled step: wall {wall:.3f} s (profiler on), device busy '
          f'{busy:.3f} s = {busy / wall:.3f} of wall, idle share '
          f'{1 - busy / wall:.3f}')
    for e in events[:a.top]:
        print(f'  {dev_us(e) / 1e3:10.2f} ms  {e.count:6d}x  {e.key[:90]}')
    if a.scatter_order:
        scatter_order(torch, kernels, cfg, batches[-1], world.dims, a.seed)


def scatter_order(torch, kernels, cfg, batch, dims, seed):
    """The variant's scatter (K3a or K5c) on the crop's sample points,
    in ray order and shuffled."""
    from scenedreamer_tpu_torch.ops import hashgrid as hg
    spec, dev = cfg.hash_spec, batch['depth'].device
    xyz = sample_points(batch, cfg, dims)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((xyz.shape[0], spec.output_dim), generator=gen,
                    device=dev)
    perm = torch.randperm(xyz.shape[0], generator=gen, device=dev)
    scales, slots = hg._scales(spec, dev), spec.table_size // spec.num_levels
    paired = spec.hash_variant == 'paired'
    scatter = kernels.hash_encode_paired_bwd if paired \
        else kernels.hash_encode_bwd
    label = 'K5c paired scatter' if paired else 'K3a scatter'
    for name, x in (('ray order', xyz), ('shuffled', xyz[perm].contiguous())):
        fn = lambda: scatter(g, x, scales, hg._offset(spec), 1.0, False,
                             slots)
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        print(f'{label}, {xyz.shape[0]} points in {name}: '
              f'{start.elapsed_time(end) / 3:.2f} ms')


if __name__ == '__main__':
    main()
