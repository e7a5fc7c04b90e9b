#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`scenedreamer_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels build for sm_90a) and nvcc.
Exits non-zero, printing no result, without a GPU or outside a checkout
of the repository. Phases, each fatal on failure:

  1. build the CUDA kernels from `scenedreamer_tpu_torch/csrc/` (nvcc,
     one process per source, in parallel) and print the build time and
     the ptxas report;
  2. K1 (DDA) against its plain PyTorch version on a 570x990 frame of a
     scene-1024 world (seed 8888, camera pattern 4): voxel ids and hit
     masks equal, entry/exit t max-abs difference printed;
  3. K2 (hash bake + encode) against the plain versions on one field
     chunk of that frame's sample points, flagship hash spec (16 levels
     x 2^19 x 8), table uniform in [-1, 1]: max abs error <= 1e-5
     (float32 sums; the bake is expected exact);
  4. the main path: `render_trajectory` renders 2 frames at the
     flagship width and the inference defaults (540x960, 40 samples,
     M=6, pad 30; MLP 256, CNN 256, feature 64) with random seeded
     weights; every frame must be finite and in [-1, 1], and every
     kernel's launch count must rise during the render;
  5. timing (CUDA events, median of 5, L2 flushed before each run) of
     each kernel and its plain version at the main path's shapes, with
     the bound the card could reach;
  6. K3 (the hash backward: scatter, dT bake, dw reduction) against its
     plain version at the flagship spec on the sample points of one
     training batch (crop 256 + pad 6, 262x262 rays, 24 samples), table
     uniform in [-1, 1], seeded normal cotangent; the scattered
     gradient G, dT, dw and dxyz held to the tolerances printed with
     their reasons;
  7. the training path: `GANTrainer` at the flagship training width of
     configs/scenedreamer_train.yaml (`GeneratorConfig()`: hash 16 x
     2^19 x 8, MLP 256, style 128/256, feature 64, 24 samples, M=6,
     pad 6, stochastic sampling; D 128 filters, 12 labels; VGG19
     perceptual loss on a random VGG; the yaml's loss weights and
     optimizers) with random seeded weights, on batches from the port's
     `make_batch` (batch 1, scene-1024 world, seed 8888): one warm-up
     and 3 timed `train_step_shared`, then one `train_step`. Losses and
     gradient norms must be finite, the hash table, the world encoder
     and a D conv must move, and every kernel's launch count must rise;
     s/iteration, rays/s (forward + backward) and peak memory printed.

Then one `kernels` JSON line covering K1-K3, the card's name and power
limit (nvidia-smi), and last the line {"ok": true, "device": {...}}.
Float32 everywhere: TF32 is switched off for matmuls and convolutions.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SCENE, SEED = 1024, 8888
RES, PAD, SAMPLES, M = (540, 960), 30, 40, 6
TRAIN_CROP, TRAIN_STEPS = 256, 3


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps=5):
    """Median device time of `fn` over `reps` runs (CUDA events), with a
    warm-up run and a 256 MB write before each run to flush the L2."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device='cuda')
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def sample_points(batch, cfg, dims):
    """The field points [N, 3] in [-1, 1] of a training batch's rays at
    deterministic sample depths: K3's input at training shapes."""
    import torch
    from scenedreamer_tpu_torch.ops.rounding import fma
    from scenedreamer_tpu_torch.ops.sampling import sample_depth
    m = batch['voxel_id'].shape[-1]
    rdepth, _, _ = sample_depth(batch['depth'].reshape(-1, m, 2),
                                batch['hit_mask'].reshape(-1, m),
                                cfg.num_samples + 1, deterministic=True,
                                use_box_boundaries=False,
                                sample_depth_clip=cfg.sample_depth)
    wc = fma(batch['raydirs'].reshape(-1, 1, 3), rdepth[..., None],
             batch['cam_ori'][0])
    dims_t = torch.tensor(dims, dtype=torch.float32, device=wc.device)
    return (wc / dims_t * 2.0 - 1.0).reshape(-1, 3).contiguous()


def make_trainer(cfg, dims, dev, seed=SEED):
    """The flagship training models of configs/scenedreamer_train.yaml
    from seeded random weights: generator `cfg`, D with 128 filters and
    `cfg`'s labels, VGG19 perceptual loss; the yaml's loss weights and
    optimizers (the `GANTrainer` defaults)."""
    from scenedreamer_tpu_torch.models.discriminator import \
        GANcraftDiscriminator
    from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
    from scenedreamer_tpu_torch.train.losses import PerceptualLoss
    from scenedreamer_tpu_torch.train.trainer import GANTrainer
    return GANTrainer(
        SceneDreamerGenerator(cfg, seed=seed).to(dev),
        GANcraftDiscriminator(num_labels=cfg.num_reduced_labels,
                              num_filters=128, seed=seed).to(dev),
        dims, perceptual=PerceptualLoss(seed=seed).to(dev))


def k3_check(torch, kernels, hg, cfg, batch, dims, dev):
    """Phase 6: K3 (a)-(c) against the plain versions on the sample points
    of one training batch; returns errors, timings and bounds."""
    spec = cfg.hash_spec
    xyz = sample_points(batch, cfg, dims)
    n = xyz.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table3 = (torch.rand((spec.table_size, spec.level_dim), generator=gen,
                         device=dev) * 2 - 1).reshape(spec.num_levels, -1,
                                                      spec.level_dim)
    g = torch.randn((n, spec.output_dim), generator=gen, device=dev)
    scene = torch.tensor([0.31, -0.47], device=dev)
    masks, weights, oob = hg.scene_fold_weights(spec, scene)
    masks32 = masks.to(torch.int32).contiguous()
    scales, off = hg._scales(spec, dev), hg._offset(spec)
    slots = table3.shape[1]
    baked = kernels.hash_bake(table3, masks32, weights)
    k_grad, k_dxyz = kernels.hash_encode_bwd(g, xyz, scales, off, 1.0, oob,
                                             slots, baked)
    p_grad, p_dxyz = hg.encode_bwd_plain(g, xyz, scales, off, 1.0, oob,
                                         slots, baked)
    abs_grad, _ = hg.encode_bwd_plain(g.abs(), xyz, scales, off, 1.0, oob,
                                      slots)
    k_dt = kernels.hash_bake(k_grad, masks32, weights, 'hash_bake_bwd')
    p_dt = hg.bake_plain(p_grad, masks, weights)
    abs_dt = hg.bake_plain(abs_grad, masks, weights)
    k_dw = kernels.hash_bake_dw(table3, k_grad, masks32)
    p_dw = hg.bake_dw_plain(table3, k_grad, masks)
    torch.cuda.synchronize()
    g_excess = float(((k_grad - p_grad).abs() - 1e-5 * abs_grad
                      - 1e-7).max())
    dt_excess = float(((k_dt - p_dt).abs() - 1e-5 * abs_dt - 1e-7).max())
    dt_err = float((k_dt - p_dt).abs().max())
    g_err = float((k_grad - p_grad).abs().max())
    dw_rel = float(((k_dw - p_dw).abs() / p_dw.abs()).max())
    dx_rel = float((k_dxyz - p_dxyz).abs().max() / p_dxyz.abs().max())
    inb = int((((xyz + 1.0) / 2.0 >= 0) & ((xyz + 1.0) / 2.0 <= 1))
              .all(-1).sum())
    log(f'[K3] {n} points ({inb} in bounds), spec {spec.num_levels} x '
        f'{slots} x {spec.level_dim}')
    log(f'[K3] G (scatter) max abs err {g_err:.3g}, dT max abs err '
        f'{dt_err:.3g}; tolerance for each, per slot: 1e-5 x (sum of |w g| '
        f'into the slot, plain path) + 1e-7, because float32 atomics add in '
        f'a run-dependent order: worst margin G {g_excess:.3g}, dT '
        f'{dt_excess:.3g} (<= 0 passes)')
    log(f'[K3] dw max rel err {dw_rel:.3g}; tolerance 1e-5 (float64 sums '
        f'on both sides, the kernel in a fixed block order)')
    log(f'[K3] dxyz max err / max|dxyz| {dx_rel:.3g}; tolerance 1e-4 '
        f'(float32 atomics over the 16 levels)')
    assert g_excess <= 0, 'K3 G differs from plain'
    assert dt_excess <= 0, 'K3 dT differs from plain'
    assert dw_rel <= 1e-5, 'K3 dw differs from plain'
    assert dx_rel <= 1e-4, 'K3 dxyz differs from plain'

    t_enc = median_ms(lambda: kernels.hash_encode_bwd(
        g, xyz, scales, off, 1.0, oob, slots))
    t_enc_plain = median_ms(lambda: hg.encode_bwd_plain(
        g, xyz, scales, off, 1.0, oob, slots))
    t_dt = median_ms(lambda: kernels.hash_bake(k_grad, masks32, weights,
                                               'hash_bake_bwd'))
    t_dt_plain = median_ms(lambda: hg.bake_plain(k_grad, masks, weights))
    t_dw = median_ms(lambda: kernels.hash_bake_dw(table3, k_grad, masks32))
    t_dw_plain = median_ms(lambda: hg.bake_dw_plain(table3, k_grad, masks))
    tbytes = table3.numel() * 4
    # scatter: g rows of in-bounds points and xyz read once, G written once
    enc_bound = bound_ms(inb * spec.output_dim * 4 + n * 12 + tbytes,
                         inb * spec.num_levels * 8 * spec.level_dim * 2)
    dt_bound = bound_ms(2 * tbytes, table3.numel() * masks.shape[1] * 2)
    dw_bound = bound_ms(2 * tbytes, table3.numel() * masks.shape[1] * 2)
    log(f'[K3] (a) scatter {t_enc:.3f} ms (plain {t_enc_plain:.2f} ms, bound '
        f'{enc_bound[0]:.3f} ms); (b) dT bake {t_dt:.3f} ms (plain '
        f'{t_dt_plain:.2f}); (c) dw {t_dw:.3f} ms (plain {t_dw_plain:.2f}, '
        f'bound {dw_bound[0]:.3f} ms)')
    return dict(points=n, in_bounds=inb,
                hash_encode_bwd=(g_err, t_enc, t_enc_plain,
                                 *enc_bound),
                hash_bake_bwd=(dt_err, t_dt, t_dt_plain, *dt_bound),
                hash_bake_dw=(dw_rel, t_dw, t_dw_plain, *dw_bound))


def train_path(torch, kernels, cfg, world, voxel, dev):
    """Phase 7: the training step at the flagship training width."""
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    trainer = make_trainer(cfg, world.dims, dev)
    gen_model, dis = trainer.gen, trainer.dis
    draws = torch.Generator(device=dev).manual_seed(SEED)
    hw = TRAIN_CROP + cfg.pad
    watched = {'hash_encoder.embeddings': gen_model.hash_encoder.embeddings,
               'world_encoder.fc2.weight': gen_model.world_encoder.fc2.weight,
               'fpse.enc1.weight': dis.fpse.enc1.weight}
    before = {k: v.detach().clone() for k, v in watched.items()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    metrics, step_s = [], []
    for i in range(1 + TRAIN_STEPS + 1):
        batch = make_batch(world, batch_size=1, height=hw, width=hw,
                           max_samples=cfg.num_blocks_early_stop,
                           pad=cfg.pad, seed=SEED + i, device=dev,
                           voxel=voxel)
        torch.cuda.synchronize()
        t0 = time.time()
        if i <= TRAIN_STEPS:
            metrics.append(trainer.train_step_shared(batch, draws))
        else:
            metrics.append(trainer.train_step(batch, draws))
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = len(step_s)
    for i, m in enumerate(metrics):
        log(f'[train] step {i} ({"shared" if i <= TRAIN_STEPS else "two-forward"})'
            f' {step_s[i]:.3f} s: ' + ', '.join(f'{k} {v:.4g}'
                                                 for k, v in m.items()))
        for k, v in m.items():
            assert math.isfinite(v), f'non-finite {k} at step {i}'
    moved = {k: float((v.detach() - before[k]).abs().max())
             for k, v in watched.items()}
    log(f'[train] parameter change (max abs): {moved}')
    for k, v in moved.items():
        assert v > 0, f'{k} did not move'
    spi = statistics.mean(step_s[1:1 + TRAIN_STEPS])
    log(f'[train] {spi:.3f} s/iteration (train_step_shared, mean of '
        f'{TRAIN_STEPS} after one warm-up; {step_s}), {hw * hw / spi:.0f} '
        f'rays/s forward + backward at {hw}x{hw} rays, {cfg.num_samples} '
        f'samples; train_step {step_s[-1]:.3f} s; peak memory '
        f'{peak_gb:.1f} GB; launches {counts} over {steps} steps')
    for name in ('dda', 'hash_bake', 'hash_encode', 'hash_encode_bwd',
                 'hash_bake_bwd', 'hash_bake_dw'):
        assert counts[name] > 0, f'kernel {name} never launched in training'
    return dict(counts=counts, steps=steps, s_per_iter=spi,
                peak_gb=peak_gb, rays=hw * hw)


def kernel_rows(serving, k3, train):
    """The `kernels` JSON rows: K1, K2a, K2b on the serving path and
    K3a-c on the training path, with launches per frame and per step,
    each read from the kernel's own counter. `launches` is the count of
    the path the kernel was ported for: serving for K1/K2, training for
    K3 (K3b is K2a's kernel on G, counted as 'hash_bake_bwd')."""
    counts, tcounts = serving['counts'], train['counts']

    def row(name, source, replaces, err, ms, plain, bound, by, path,
            **extra):
        return dict(name=name, route='cuda', source=source,
                    replaces=replaces, launches=path[name], max_abs_err=err,
                    ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                    library_ms=None,
                    launches_per_frame=counts[name] / serving['n_frames'],
                    launches_per_step=tcounts[name] / train['steps'],
                    **extra)

    ms, errs, extra = serving['ms'], serving['errs'], serving['extra']
    fwd = 'scenedreamer_tpu_torch/csrc/hashgrid_fwd.cu'
    bwd = 'scenedreamer_tpu_torch/csrc/hashgrid_bwd.cu'
    return [
        row('dda', 'scenedreamer_tpu_torch/csrc/dda.cu',
            'scenedreamer_tpu/ops/ray_voxel.py:456', errs['dda'],
            *ms['dda'], counts, **extra['dda']),
        row('hash_bake', fwd, 'scenedreamer_tpu/ops/hashgrid.py:626',
            errs['hash_bake'], *ms['hash_bake'], counts),
        row('hash_encode', fwd, 'scenedreamer_tpu/ops/hashgrid.py:848',
            errs['hash_encode'], *ms['hash_encode'], counts,
            **extra['hash_encode']),
        row('hash_encode_bwd', bwd, 'scenedreamer_tpu/ops/hashgrid.py:361',
            *k3['hash_encode_bwd'], tcounts, points=k3['points']),
        row('hash_bake_bwd', fwd, 'scenedreamer_tpu/ops/hashgrid.py:642',
            *k3['hash_bake_bwd'], tcounts),
        row('hash_bake_dw', bwd, 'scenedreamer_tpu/ops/hashgrid.py:642',
            *k3['hash_bake_dw'], tcounts),
    ]


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    from scenedreamer_tpu_torch import kernels
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.ops import hashgrid as hg
    from scenedreamer_tpu_torch.ops.ray_voxel import camera_rays, dda_plain
    from scenedreamer_tpu_torch.ops.rounding import fma
    from scenedreamer_tpu_torch.ops.sampling import sample_depth
    from scenedreamer_tpu_torch.render.pipeline import (CHUNK_RAYS,
                                                        TiledRenderer,
                                                        render_trajectory)
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    dev = torch.device('cuda')
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')
    log(f'tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
        f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} '
        f'float32_matmul_precision={torch.get_float32_matmul_precision()}')

    # 1. build -------------------------------------------------------------
    t0 = time.time()
    kernels.build()
    log(f'[build] {time.time() - t0:.1f} s')
    for name, text in kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'[build] {name}: {line.strip()}')

    # 2. K1 vs plain -------------------------------------------------------
    t0 = time.time()
    maps = generate_terrain(size=SCENE, seed=SEED)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=SEED)
    log(f'[world] scene {SCENE} seed {SEED}: grid {world.dims} '
        f'in {time.time() - t0:.1f} s')
    voxel = torch.from_numpy(world.voxel).to(dev)
    h, w = RES[0] + PAD, RES[1] + PAD
    ctl = EvalCameraController(world, maxstep=2, pattern=4, cam_ang=72,
                               smooth_decay_multiplier=150.0 / 2)
    ori, cdir, up, f_ratio = ctl[0]
    rays = camera_rays(cdir, up, f_ratio * (RES[1] - 1),
                       ((h - 1) / 2.0, (w - 1) / 2.0), (h, w),
                       device=dev).reshape(-1, 3)
    ori_t = torch.as_tensor(ori, dtype=torch.float32, device=dev)
    k_vid, k_dep, k_hit, k_steps = kernels.dda(
        voxel, ori_t, rays, M, sum(world.dims) + 2, with_steps=True)
    p_vid, p_dep, p_hit, p_steps = dda_plain(voxel, ori_t, rays, M,
                                             with_steps=True)
    torch.cuda.synchronize()
    assert torch.equal(k_vid, p_vid), 'K1 voxel ids differ from plain'
    assert torch.equal(k_hit, p_hit), 'K1 hit masks differ from plain'
    assert torch.equal(k_steps, p_steps), 'K1 step counts differ'
    dda_err = float((k_dep - p_dep).abs().max())
    log(f'[K1] {rays.shape[0]} rays: ids/hits equal, depth max abs diff '
        f'{dda_err:.3g}, rays with a hit '
        f'{float(k_hit[:, 0].float().mean()):.3f}, steps mean '
        f'{float(k_steps.float().mean()):.1f} max {int(k_steps.max())}')
    assert dda_err == 0.0, 'K1 depth differs from plain'

    # 3. K2 vs plain -------------------------------------------------------
    cfg = GeneratorConfig(num_samples=SAMPLES, num_blocks_early_stop=M)
    spec = cfg.hash_spec
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((spec.table_size, spec.level_dim), generator=gen,
                       device=dev) * 2 - 1
    model = SceneDreamerGenerator(cfg, seed=SEED).to(dev).eval()
    with torch.no_grad():
        scene = model.world_code(
            torch.from_numpy(world.height_field.transpose(0, 2, 3, 1)).to(dev),
            torch.from_numpy(world.semantic_field.transpose(0, 2, 3, 1))
            .to(dev))[0]
    rows = CHUNK_RAYS // w
    r0 = h // 2
    sl = slice(r0 * w, (r0 + rows) * w)
    rdepth, _, _ = sample_depth(k_dep[sl], k_hit[sl], SAMPLES + 1,
                                deterministic=True, use_box_boundaries=False,
                                sample_depth_clip=3.0)
    wc = fma(rays[sl, None, :], rdepth[..., None], ori_t)
    dims = torch.tensor(world.dims, dtype=torch.float32, device=dev)
    xyz = (wc / dims * 2.0 - 1.0).reshape(-1, 3).contiguous()
    masks, weights, scene_oob = hg.scene_fold_weights(spec, scene)
    table3 = table.reshape(spec.num_levels, -1, spec.level_dim)
    masks32 = masks.to(torch.int32).contiguous()
    k_baked = kernels.hash_bake(table3, masks32, weights.contiguous())
    p_baked = hg.bake_plain(table3, masks, weights)
    scales = hg._scales(spec, dev)
    offset = hg._offset(spec)
    k_enc = kernels.hash_encode(k_baked, xyz, scales, offset, 1.0, scene_oob)
    p_enc = hg.encode_plain(p_baked, xyz, scales, offset, 1.0, scene_oob)
    torch.cuda.synchronize()
    bake_err = float((k_baked - p_baked).abs().max())
    enc_err = float((k_enc - p_enc).abs().max())
    n_pts = xyz.shape[0]
    log(f'[K2] bake {tuple(table3.shape)} max abs err {bake_err:.3g}; '
        f'encode {n_pts} points ({rows} rows x {w} rays x {SAMPLES + 1}) '
        f'-> {tuple(k_enc.shape)} max abs err {enc_err:.3g}, '
        f'out mean |x| {float(k_enc.abs().mean()):.3f}')
    assert bake_err <= 1e-5 and enc_err <= 1e-5, 'K2 differs from plain'

    # 4. main path ---------------------------------------------------------
    style = torch.randn((1, cfg.style_dims),
                        generator=torch.Generator().manual_seed(SEED))
    out_dir = os.path.join(REPO, 'smoke_out')
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    frames = render_trajectory(model, world, style, out_dir, camera_mode=4,
                               cam_maxstep=2, cam_ang=72,
                               num_samples=SAMPLES,
                               num_blocks_early_stop=M, pad=PAD,
                               resolution_hw=RES, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f'[main] render_trajectory: {len(frames)} frames in {wall:.2f} s '
        f'(first frame includes warm-up), peak memory {peak_gb:.1f} GB, '
        f'launches {counts}')
    assert len(frames) == 2
    for img in frames:
        assert img.shape == RES + (3,), img.shape
        assert np.isfinite(img).all(), 'non-finite frame'
        assert np.abs(img).max() <= 1.0, 'frame outside [-1, 1]'
    for name in ('dda', 'hash_bake', 'hash_encode'):
        assert counts[name] > 0, f'kernel {name} never launched on the main path'
    for name in ('hash_encode_bwd', 'hash_bake_bwd', 'hash_bake_dw'):
        assert counts[name] == 0, f'the serving path launched {name}'

    renderer = TiledRenderer(model, world, num_samples=SAMPLES,
                             num_blocks_early_stop=M, pad=PAD,
                             resolution_hw=RES, device=dev)
    z = renderer.style_z(style.numpy())
    frame_s = []
    for pose in ctl:
        torch.cuda.synchronize()
        t0 = time.time()
        renderer.frame(pose, z)
        torch.cuda.synchronize()
        frame_s.append(time.time() - t0)
    spf = statistics.mean(frame_s)
    log(f'[main] steady state: {spf:.3f} s/frame ({frame_s}), '
        f'{h * w / spf:.0f} rays/s at {h}x{w} rays, {RES[0]}x{RES[1]} '
        f'output, {SAMPLES} samples')

    # 5. kernel timings ----------------------------------------------------
    n_frames = len(frames)
    r_rays = rays.shape[0]
    max_steps = sum(world.dims) + 2
    dda_ms = median_ms(lambda: kernels.dda(voxel, ori_t, rays, M,
                                           max_steps))
    dda_plain_ms = median_ms(lambda: dda_plain(voxel, ori_t, rays, M))
    steps_total = int(k_steps.sum())
    hits_total = int(k_hit.sum())
    # dirs in, ids/t/hit out, and the voxel byte of every recorded hit
    dda_bound, dda_by = bound_ms(r_rays * 12 + r_rays * M * 13 + hits_total,
                                 steps_total * 8)
    bake_ms = median_ms(lambda: kernels.hash_bake(table3, masks32,
                                                  weights.contiguous()))
    bake_plain_ms = median_ms(lambda: hg.bake_plain(table3, masks, weights))
    tbytes = table3.numel() * 4
    bake_bound, bake_by = bound_ms(2 * tbytes, table3.numel() * 4 * 2)
    enc_ms = median_ms(lambda: kernels.hash_encode(
        k_baked, xyz, scales, offset, 1.0, scene_oob))
    enc_plain_ms = median_ms(lambda: hg.encode_plain(
        p_baked, xyz, scales, offset, 1.0, scene_oob))
    # distinct baked rows this chunk reads, per level (each read once)
    rows_read = 0
    x01 = (xyz + 1.0) / 2.0
    inb = ((x01 >= 0) & (x01 <= 1)).all(-1)
    for lv in range(spec.num_levels):
        pos = fma(x01[inb], scales[lv], offset)
        u = torch.floor(pos).to(torch.int64)
        idx = []
        for k in range(8):
            hsh = torch.zeros_like(u[:, 0])
            for d in range(3):
                hsh = hsh ^ ((u[:, d] + ((k >> d) & 1)) * hg.PRIMES[d])
            idx.append(hsh & (table3.shape[1] - 1))
        rows_read += int(torch.unique(torch.cat(idx)).numel())
    row_bytes = spec.level_dim * 4
    out_bytes = n_pts * spec.output_dim * 4
    enc_bound, enc_by = bound_ms(
        n_pts * 12 + rows_read * row_bytes + out_bytes,
        n_pts * spec.num_levels * 8 * (2 * spec.level_dim + 3))
    # the gather traffic as issued: 8 random 32-byte rows per point and
    # level, plus the output
    gather_ms = (out_bytes + int(inb.sum()) * spec.num_levels * 8 * 32) \
        / HBM_BYTES_PER_S * 1e3
    log(f'[K1] {dda_ms:.3f} ms (plain {dda_plain_ms:.1f} ms), {steps_total} '
        f'axis steps, {hits_total} hits')
    log(f'[K2] bake {bake_ms:.3f} ms (plain {bake_plain_ms:.2f} ms); encode '
        f'{enc_ms:.3f} ms (plain {enc_plain_ms:.1f} ms), {rows_read} distinct '
        f'rows, gather-traffic bound {gather_ms:.3f} ms')

    serving = dict(counts=counts, n_frames=n_frames, errs=dict(
        dda=dda_err, hash_bake=bake_err, hash_encode=enc_err), ms=dict(
        dda=(dda_ms, dda_plain_ms, dda_bound, dda_by),
        hash_bake=(bake_ms, bake_plain_ms, bake_bound, bake_by),
        hash_encode=(enc_ms, enc_plain_ms, enc_bound, enc_by)),
        extra=dict(dda=dict(rays=r_rays, axis_steps=steps_total),
                   hash_encode=dict(points=n_pts, gather_bound_ms=gather_ms)))
    del table, k_baked, p_baked, k_enc, p_enc, table3, renderer, model
    torch.cuda.empty_cache()

    # 6. K3 vs plain -------------------------------------------------------
    tcfg = GeneratorConfig()
    hw = TRAIN_CROP + tcfg.pad
    batch = make_batch(world, batch_size=1, height=hw, width=hw,
                       max_samples=tcfg.num_blocks_early_stop, pad=tcfg.pad,
                       seed=SEED, device=dev, voxel=voxel)
    k3 = k3_check(torch, kernels, hg, tcfg, batch, world.dims, dev)
    torch.cuda.empty_cache()

    # 7. the training path -------------------------------------------------
    train = train_path(torch, kernels, tcfg, world, voxel, dev)

    table_rows = kernel_rows(serving, k3, train)
    log(json.dumps({'kernels': table_rows}))

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
