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
     scene-1024 world (seed 8888, camera pattern 4), as the main path
     launches it (the empty-space skip over the world's brick occupancy,
     8x4 pixel tiles) and in flat order, and on the
     training sampler's 4 proposals (262x262 rays each) in one launch
     with 4 origins: voxel ids, hit masks and step counts equal, entry /
     exit t difference 0; then '[K1 shapes]': the per-warp issued /
     needed axis steps in launch order and in 8x4 tiles;
  3. K2 (hash bake + encode) against the plain versions on one field
     chunk of that frame's sample points, flagship hash spec (16 levels
     x 2^19 x 8), table uniform in [-1, 1]: max abs error <= 1e-5
     (float32 sums; the bake is expected exact);
  4. the main path: `render_trajectory` renders 2 frames at the
     flagship width and the inference defaults (540x960, 40 samples,
     M=6, pad 30; MLP 256, CNN 256, feature 64; the sky skip and exact
     sky-ray compaction on) with random seeded weights; every kernel's
     launch count must rise during the render; then 2 timed frames of
     the same path through `TiledRenderer.frame`, each finite, in
     [-1, 1] and giving the trajectory's uint8 frame, each with
     its rays, rays with a hit, field chunks by path (sky only /
     compacted / full) and field points, and one timed frame with the
     sky skip and compaction off, held against the compacted frame:
     image within 1e-3, depth within 1e-3 where finite and inf on the
     same rays;
  5. timing (CUDA events, median of 5, L2 flushed before each run) of
     each kernel and its plain version at the main path's shapes, with
     the bound the card could reach; and K2b split by level on phase
     3's chunk ('[K2 levels]': each level alone in ray order, shuffled
     and with every point equal, its distinct rows and issued sectors
     per ms; the whole launch in each order); K1 at its shapes ('[K1
     shapes]': the frame, the frame's rays sorted by step count, one
     sampler proposal, 4 proposals launched one by one and in one launch,
     each with the world's brick bits and with every bit set; the voxel
     loads the skip leaves; the bits' build time, and what a sampled
     world's first round costs with and without the skip);
  6. K3 (the hash backward: scatter, dT bake, dw reduction) against its
     plain version at the flagship spec on the sample points of one
     training batch (crop 256 + pad 6, 262x262 rays, 24 samples), table
     uniform in [-1, 1], seeded normal cotangent; the scattered
     gradient G (against its float64 sum), dT, dw and dxyz held to the
     tolerances printed with their reasons; then the scatter K3a split
     by level ('[K3 levels]': each level's time on the coarse and the
     direct path, in ray order and shuffled, with its distinct rows and
     the coarse path's rows flushed and inserts overflowed; the whole
     launch before, every level direct, and after), and K3a held in two
     adversarial cases, 2^20 points in one cell and the batch's points
     shuffled; dw bitwise equal across two launches, and timed whole,
     level by level, with one corner and with every mask 0 ('[K3c dw]');
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
     s/iteration, rays/s (forward + backward) and peak memory printed;
     then one `train_step_shared` with `compact_k` against the same step
     without it on twin trainers from one seed ('[train compact]': the
     batch's top quarter of rows forced to sky; losses within 1e-5
     relative, gradient norms 1e-4, parameters 1e-5);
  8. K5 (the paired hash variant: shift bake, paired encode, paired
     scatter, dT shift bake, dw reduction) against its plain versions at
     the flagship spec with `hash_variant='paired'` on the sample points
     of phase 6's training batch, tolerances as phases 3 and 6 (G and
     dT against the float64 sum of the same terms) but the paired encode
     K5b equal to its plain version (error 0), then the timings and
     bounds of K5 (a)-(d), K5d's dw as K3c's in phase 6 ('[K5d dw]'),
     the scatter K5c split by level and held in the adversarial cases as
     K3a in phase 6 ('[K5 levels]'), and K5b split by level as K2b in
     phase 5, on the training points and on phase 3's serving chunk,
     the table baked with the paired flagship generator's scene code of
     each ('[K5b levels] train', '[K5b levels] chunk');
  9. the training loop: writes a terrain cache of the scene-1024 world
     and 16 synthetic 320x320 PNG pairs under `smoke_out/`, and runs
     `scenedreamer_tpu_torch.cli.train.main` on
     configs/scenedreamer_train.yaml with `gen.hash_variant: paired`
     (crop 256, 24 samples, hash 16 x 2^19 x 8, MLP 256, D 128, SPADE
     512 with 128 filters in bf16 from seeded random weights, batch 1)
     for 6 iterations, again with `--resume` to 8, then 3 iterations
     with the unmodified (xor) yaml, then 3 with `--speed-benchmark`.
     Every meter must be finite, the checkpoints and
     `latest_checkpoint.txt` must exist, the second run must resume at
     iteration 6, the hash table must move, the paired run must launch
     K1 and all of K5 and none of K2/K3, the xor run the reverse; the
     `--speed-benchmark` run must launch K1 once per sampler round of 4
     proposals.

 10. K4 (the general, unfolded encode: forward, table scatter and point
     gradient) against its plain versions: the flagship hash spec at
     `hash_log2_size=21` (not foldable: level 0 tiled at 17^5 cells,
     levels 1-15 hashed at 2^21; table 32,877,144 x 8) on the 5-D points
     of phase 6's training batch (its 1,647,456 field points with the
     batch's scene code from the log2-21 generator's world encoder), table
     uniform in [-1, 1], seeded normal cotangent; then a D=3
     `get_encoder('tiledgrid', level_dim=2, align_corners=True)` spec on
     1,048,576 points (tiled levels past their stride cut-off, C=2,
     aligned corners); tolerances as phases 3 and 6; then the timings
     and bounds of K4 (a)/(b) at the flagship shapes, and K4b split by
     level and held in the adversarial cases as K3a in phase 6; K4a
     split by level as K2b in phase 5 ('[K4a levels] train'), then held
     against its plain version, timed and split on phase 3's serving
     chunk with the serving world's scene code ('[K4 chunk]',
     '[K4a levels] chunk');
 11. the paths through K4: the flagship generator at `hash_log2_size=21`
     with seeded weights renders 1 frame through `render_trajectory`
     (540x960, 40 samples, pad 30; the timed frame finite and in
     [-1, 1], K4 (a) launched
     once per field chunk that is not pure sky, no K4 (b) and no
     K2/K3/K5 launch) and one more timed frame; 1 warm-up and 2 timed
     `train_step_shared` at that width (K4 (a) and (b) once each per
     step); then
     `scenedreamer_tpu_torch.cli.train.main` on
     configs/scenedreamer_train.yaml with `gen.hash_log2_size: 21` (xor;
     phase 9's terrain cache and PNG pairs; batch 1) for 4 iterations
     with `--speed-benchmark`, a snapshot image at 2 and 4 and a
     checkpoint at 3 and 4: every meter finite, the hash table and the
     world encoder moved between the checkpoints, K1 and K4 (a)/(b)
     launched and no K2/K3/K5 counter rose.

 12. the rest of serving, at the flagship width on phase 4's world, style
     and seeded weights ('[serve ...]' lines): one 540x960x40 frame of
     phase 4's first pose through the padded-tile route (tile 128, pad
     30: 40 tiles of 158x158) at 1 and 4 tiles per batch, each within
     1e-3 of phase 4's split-refine frame, with K1 and K2a launched once
     and K2b once per tile that runs the field; one 1080x1920 frame
     (1110x1950 rays, above the 1.4 MPx threshold) with CNN strips and
     with the whole CNN, within 1e-3 of each other; the 540x960 frame
     in bf16, finite, in [-1, 1] and within its limit of the float32
     frame (`BF16_REL_LIMIT`, from the CPU test); each with s/frame and
     peak GB; `cli.inference.main` (scene 1024, 3 frames, `--save_depth
     --style2 seed:9`, phase 9's xor checkpoint directory): 3 RGB, depth
     and voxel PNGs, style.npy [3, 128], an mp4 read back as 3 frames of
     540x960, its frames within one uint8 step of the same frames through
     `frame`, the trajectory's wall time per frame beside the frames'
     `frame` time and the host's write time; then `--no_split_refine`
     for 2 frames; and `cli.demo.main` headless for 2 frames (the BEV
     PNGs and the mp4).

 13. the rest of training ('[train ...]' lines), at the flagship training
     width on phase 6's batch: '[train amp]', 1 warm-up then 3 timed
     AMP (bf16 G, D and VGG) and 3 float32 `train_step_shared` in turns
     from the same seeded weights and draws, the warm-up's losses and
     gradient norms each within `BF16_STEP_LIMIT_*` of float32's (4x
     JAX's own bf16 distance, tests/test_torch_train_amp.py), K2/K3
     launches per step equal, every AMP gradient float32 and finite, then
     one paired AMP step (K5 launched); '[train aug]', a step with
     DiffAugment ('color,translation,cutout') and the nearest label
     resize, then `train_step_fused` against `train_step` on twin
     trainers (phase 7's tolerances); '[train options]', for two
     generator configurations that set every option the shipped configs
     leave at its default, one step (K2/K3 launched as the default step)
     and one 540x960 frame with compaction on, within 1e-3 of the frame
     with it off (not with `raw_noise_std`); '[train cli amp]',
     `cli.train.main` with AMP, DiffAugment, the paired spec and
     `--profile` on phase 9's cache and pairs for 24 iterations (a
     checkpoint at 12; the Chrome trace must name K5's kernels), a resume
     from 12 to 16, the same 24 in float32, the median and spread of
     s/iteration over iterations 5-24 of each.

Then the total time, one `kernels` JSON line covering K1-K5 (K4a also
at the serving chunk, under `at_serving_chunk`; K5b's whole launch there
under `serving_chunk_ms`; every row with its launches per padded-tile
frame at 1 and 4 tiles per batch and per AMP step), the card's name and
power limit (nvidia-smi), and last the line {"ok": true, "device": {...}}.
Float32 everywhere but phase 12's bf16 frame and phase 13's AMP: TF32
is switched off for matmuls and convolutions.
"""
import json
import math
import os
import shutil
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
PAIRED = ('hash_shift_bake', 'hash_encode_paired', 'hash_encode_paired_bwd',
          'hash_shift_bake_bwd', 'hash_shift_bake_dw')
XOR = ('hash_bake', 'hash_encode', 'hash_encode_bwd', 'hash_bake_bwd',
       'hash_bake_dw')
GENERAL = ('hash_encode_general', 'hash_encode_general_bwd')
LOG2_UNFOLDED = 21      # the smallest flagship table that is not foldable
ONE_CELL_POINTS = 1 << 20   # points of the scatters' one-cell case


def log(*a):
    print(*a, flush=True)


def ptxas_report(text):
    """(kernel, report) per entry function of an `nvcc -Xptxas=-v` log:
    the kernel as its name and template arguments (`encode_kernel<8>`),
    the report its registers, stack frame and spills."""
    import re
    out, name, frame = [], None, ''
    for line in text.splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            k = re.search(r'(?<=\d)([a-z][a-z_]*kernel)', m.group(1))
            args = re.findall(r'Li(\d+)E', m.group(1))
            name = (k.group(1) if k else m.group(1)) \
                + (f'<{",".join(args)}>' if args else '')
        elif 'stack frame' in line:
            frame = line.strip()
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out.append((name, f'{m.group(1)} registers, {frame}'))
            name = None
    return out


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


def timed_frame(torch, renderer, pose, z):
    """One synchronised `renderer.frame` on the host clock: (seconds,
    image, aux)."""
    torch.cuda.synchronize()
    t0 = time.time()
    img, aux = renderer.frame(pose, z, return_aux=True)
    torch.cuda.synchronize()
    return time.time() - t0, img, aux


def log_frame_stats(tag, stats, secs):
    """Phase 4's line per frame: rays, rays with a hit, the field chunks
    by path (sky only / compacted / full) and the field's rays and
    points."""
    log(f'[main] frame, compaction {tag}: {secs:.3f} s, {stats["rays"]} '
        f'rays, {stats["hit_rays"]} with a hit; chunks '
        f'sky only {stats["chunks_sky_only"]}, compacted '
        f'{stats["chunks_compacted"]}, full {stats["chunks_full"]}; field '
        f'rays {stats["field_rays"]} '
        f'({stats["field_rays"] / stats["rays"]:.3f}), field points '
        f'{stats["field_points"]}')


def frame_rays(torch, world, dev):
    """The first frame of camera pattern 4 at the inference defaults
    (570x990 rays with the CNN pad): the camera controller, the rays
    [H*W, 3] and the camera origin [3] (phases 2-5)."""
    from scenedreamer_tpu_torch.ops.ray_voxel import camera_rays
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    h, w = RES[0] + PAD, RES[1] + PAD
    ctl = EvalCameraController(world, maxstep=2, pattern=4, cam_ang=72,
                               smooth_decay_multiplier=150.0 / 2)
    ori, cdir, up, f_ratio = ctl[0]
    rays = camera_rays(cdir, up, f_ratio * (RES[1] - 1),
                       ((h - 1) / 2.0, (w - 1) / 2.0), (h, w),
                       device=dev).reshape(-1, 3)
    ori_t = torch.as_tensor(ori, dtype=torch.float32, device=dev)
    return ctl, rays, ori_t


PROPOSALS = 4   # camera proposals per sampler round (CameraSamplerConfig)


def proposal_rays(torch, world, dev, k=PROPOSALS, seed=SEED):
    """k camera proposals of the training sampler (its default config:
    262x262 rays each) on `world`, drawn as `CameraBatchSampler` draws
    them: rays [k, h*w, 3], origins [k, 3] and (h, w)."""
    import numpy as np
    from scenedreamer_tpu_torch.ops.ray_voxel import camera_rays
    from scenedreamer_tpu_torch.train.sampling import (CameraBatchSampler,
                                                       CameraSamplerConfig)
    sampler = CameraBatchSampler(CameraSamplerConfig(), device=dev)
    rng = np.random.default_rng(seed)
    rays, oris = [], []
    for _ in range(k):
        ori, cdir, up, cam_f, cam_c = sampler._propose(world, rng)
        rays.append(camera_rays(
            np.asarray(cdir, np.float32), np.asarray(up, np.float32),
            float(np.float32(cam_f)),
            tuple(float(np.float32(v)) for v in cam_c), sampler.crop_res,
            device=dev).reshape(-1, 3))
        oris.append(torch.tensor(np.asarray(ori, np.float32), device=dev))
    return torch.stack(rays), torch.stack(oris), sampler.crop_res


def step_ratios(torch, steps, h, w):
    """Issued over needed axis steps of K1's warps on rays [G*h*w] (G
    row-major images of h x w) whose per-ray step counts are `steps`: the
    sum over warps of 32 x the warp's largest count, over the sum of the
    counts, with a warp taking 32 consecutive rays (launch order) and with
    a warp taking an 8x4 pixel tile."""
    s = steps.reshape(-1, h, w).float()
    total = float(s.sum())
    flat = s.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 32)])
    launch = float(flat.reshape(-1, 32).amax(1).sum()) * 32 / total
    t = torch.nn.functional.pad(s, (0, -w % 8, 0, -h % 4))
    t = t.reshape(s.shape[0], t.shape[1] // 4, 4, t.shape[2] // 8, 8)
    tiled = float(t.permute(0, 1, 3, 2, 4).reshape(-1, 32).amax(1).sum()) \
        * 32 / total
    return launch, tiled


def k1_bound(steps, hits, rays):
    """K1's bound for rays whose axis steps and recorded hits are given:
    directions in, ids / t / hit flags out, the voxel byte of every hit,
    and 8 float32 operations per axis step."""
    return bound_ms(rays * 12 + rays * M * 13 + hits, steps * 8)


def k1_shapes(torch, kernels, world, voxel, rays, ori_t, size, dev):
    """Phase 5, '[K1 shapes]': K1's time (median of 5, L2 flushed) at (a)
    the frame's rays (`size` = (h, w)), (b) the same rays sorted by their
    step count, (c) one training-sampler proposal (262x262 rays), (d)
    PROPOSALS such proposals back to back, one launch each, (e) the
    PROPOSALS proposals in one launch, as the sampler launches a round,
    and (f) the frame's 32 longest rays. Rays that form images go in 8x4
    tiles, the others in flat order. Each shape is timed with the world's
    brick bits ('skip', the main path) and with every bit set ('no skip':
    every step loads its voxel). Prints the per-warp step ratios
    (`step_ratios`), the voxel loads the skip leaves, the time to build
    the world's bits, and what a sampled world's K1 costs with and without
    the skip for its first round (the build included). Returns {shape:
    {variant: ms}}, the proposals' bounds and that build time."""
    max_steps = sum(world.dims) + 2
    prays, poris, (ph, pw) = proposal_rays(torch, world, dev)
    k = prays.shape[0]
    occ = kernels.occupancy_bits(voxel)
    bits = dict(skip=occ, no_skip=torch.full_like(occ, -1))

    def launch(x, o, width, variant, **kw):
        return kernels.dda(voxel, o, x, M, max_steps, occupancy=bits[variant],
                           image_width=width, **kw)

    _, _, f_hit, f_steps = launch(rays, ori_t, None, 'skip', with_steps=True)
    order = torch.argsort(f_steps)
    p_out = [launch(prays[i].contiguous(), poris[i], pw, 'skip',
                    with_steps=True) for i in range(k)]
    p_steps = torch.stack([o[3] for o in p_out])
    h, w = size
    for name, st, hh, ww in (('frame', f_steps, h, w),
                             (f'{k} proposals', p_steps, ph, pw)):
        lr, tr = step_ratios(torch, st, hh, ww)
        log(f'[K1 shapes] {name}: {st.numel()} rays, axis steps mean '
            f'{float(st.float().mean()):.1f} max {int(st.max())} sum '
            f'{int(st.sum())}; per-warp issued / needed steps: launch order '
            f'{lr:.3f}, 8x4 tiles {tr:.3f}')
    # each shape: its launches as (rays, origins, image width or None)
    all_rays = (prays.reshape(-1, 3).contiguous(), poris, pw)
    shapes = {
        '(a) frame': [(rays, ori_t, w)],
        '(b) frame sorted by steps': [(rays[order].contiguous(), ori_t,
                                       None)],
        '(c) one proposal': [(prays[0].contiguous(), poris[0], pw)],
        # the critical path: the frame's 32 rays with the most steps
        '(f) the 32 longest frame rays, one warp': [
            (rays[order[-32:]].contiguous(), ori_t, None)],
        f'(d) {k} proposals, {k} launches': [
            (prays[i].contiguous(), poris[i], pw) for i in range(k)],
        f'(e) {k} proposals, one launch': [all_rays],
    }
    out = {}
    for name, calls in shapes.items():
        out[name] = {v: median_ms(lambda: [launch(*c, v) for c in calls])
                     for v in bits}
        log(f'[K1 shapes] {name}: ' + ', '.join(
            f'{v.replace("_", " ")} {t:.3f} ms'
            for v, t in out[name].items()))
    bound_one = k1_bound(int(p_steps[0].sum()), int(p_out[0][2].sum()),
                         ph * pw)
    bound_all = k1_bound(int(p_steps.sum()),
                         sum(int(o[2].sum()) for o in p_out), k * ph * pw)
    log(f'[K1 shapes] bound: one proposal {bound_one[0]:.4f} ms, {k} '
        f'proposals {bound_all[0]:.4f} ms (by {bound_all[1]})')
    build_ms = median_ms(lambda: kernels.occupancy_bits(voxel))
    log(f'[K1 shapes] the brick occupancy of the {tuple(voxel.shape)} '
        f'grid ({occ.numel() * 4} bytes), built once per world: '
        f'{build_ms:.3f} ms')
    rnd = out[f'(e) {k} proposals, one launch']
    saved = rnd['no_skip'] - rnd['skip']
    log(f'[K1 shapes] a sampled world, first round of {k} proposals: build + '
        f'round with the skip {build_ms + rnd["skip"]:.3f} ms, without '
        f'{rnd["no_skip"]:.3f} ms; the skip repays its build from '
        + (f'{build_ms / saved:.2f} rounds per world' if saved > 0
           else 'no number of rounds'))
    for name, c, st in (('frame', (rays, ori_t, w), f_steps),
                        (f'{k} proposals', all_rays, p_steps)):
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        launch(*c, 'skip', stats=stats)
        loads, lookups = stats.tolist()
        log(f'[K1 shapes] {name} with the skip: {loads} voxel loads '
            f'(steps in occupied bricks) of {int(st.sum())} axis steps '
            f'({loads / int(st.sum()):.3f}), {lookups} occupancy bits read')
    return dict(shapes=out, proposal_bound=bound_one,
                proposals_bound=bound_all, proposals=k,
                occupancy_build_ms=build_ms)


def chunk_points(torch, rays, ori_t, depth, hit, dims):
    """One serving field chunk (phase 3): the CHUNK_RAYS // W image rows
    from the middle of the frame, SAMPLES + 1 deterministic depths per ray
    from the DDA's `depth` / `hit` -> (points [N, 3] in [-1, 1], rows)."""
    from scenedreamer_tpu_torch.ops.rounding import fma
    from scenedreamer_tpu_torch.ops.sampling import sample_depth
    from scenedreamer_tpu_torch.render.pipeline import CHUNK_RAYS
    h, w = RES[0] + PAD, RES[1] + PAD
    rows = CHUNK_RAYS // w
    sl = slice(h // 2 * w, (h // 2 + rows) * w)
    rdepth, _, _ = sample_depth(depth[sl], hit[sl], SAMPLES + 1,
                                deterministic=True, use_box_boundaries=False,
                                sample_depth_clip=3.0)
    wc = fma(rays[sl, None, :], rdepth[..., None], ori_t)
    dims_t = torch.tensor(dims, dtype=torch.float32, device=rays.device)
    return (wc / dims_t * 2.0 - 1.0).reshape(-1, 3).contiguous(), rows


def make_trainer(cfg, dims, dev, seed=SEED, aug_policy='',
                 smooth_resample=True):
    """The flagship training models of configs/scenedreamer_train.yaml
    from seeded random weights: generator `cfg`, D with 128 filters and
    `cfg`'s labels, VGG19 perceptual loss, D and VGG in `cfg.dtype` (bf16:
    AMP); the yaml's loss weights and optimizers (the `GANTrainer`
    defaults), DiffAugment `aug_policy`."""
    from scenedreamer_tpu_torch.models.discriminator import \
        GANcraftDiscriminator
    from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
    from scenedreamer_tpu_torch.train.losses import PerceptualLoss
    from scenedreamer_tpu_torch.train.trainer import GANTrainer, TrainerConfig
    return GANTrainer(
        SceneDreamerGenerator(cfg, seed=seed).to(dev),
        GANcraftDiscriminator(num_labels=cfg.num_reduced_labels,
                              num_filters=128, seed=seed,
                              smooth_resample=smooth_resample,
                              dtype=cfg.dtype).to(dev),
        dims, cfg=TrainerConfig(aug_policy=aug_policy),
        perceptual=PerceptualLoss(seed=seed, dtype=cfg.dtype).to(dev))


def _exact_scatter(torch, g, c, rows, corners):
    """A table gradient [rows, C] summed in float64 from the plain
    versions' corner rows and float32 weights: `corners` yields (level,
    rows of each corner in the whole table, weights of each corner) for
    the points whose cotangent rows are g [N, L*C]. The reference for the
    table scatters K3a and K4b: a float32 sum of a row's terms in any
    order may be off by more than 1e-5 of their absolute sum where a row
    takes a few hundred thousand of them (phases 6 and 10 have one: the
    samples of the rays that hit nothing all lie at the camera, since
    `sample_depth` gives them depth 0), and the plain versions' float32
    `index_add_` is such a sum."""
    out = torch.zeros((rows, c), dtype=torch.float64, device=g.device)
    for lv, idx, ws in corners:
        gl = g[:, lv * c:(lv + 1) * c].double()
        for i, w in zip(idx, ws):
            out.index_add_(0, i, w.double()[:, None] * gl)
    return out


def exact_folded_grad(torch, hg, g, xyz, scales, offset, slots,
                      variant='xor'):
    """K3a's (K5c's under variant 'paired') table gradient [L, slots, C]
    in float64 (`_exact_scatter`)."""
    lvs, c = scales.shape[0], g.shape[1] // scales.shape[0]
    x01 = (xyz + 1.0) / 2.0
    ok = ((x01 >= 0) & (x01 <= 1)).all(-1)
    x01, g = x01[ok], g[ok]

    def corners():
        for lv in range(lvs):
            idx, ws, _ = hg._corners(x01, scales[lv], offset, slots,
                                     variant)
            yield lv, [i + lv * slots for i in idx], ws
    return _exact_scatter(torch, g, c, lvs * slots, corners()) \
        .reshape(lvs, slots, c)


def exact_general_grad(torch, hg, spec, g, x):
    """K4b's table gradient [rows, C] in float64 (`_exact_scatter`)."""
    x01 = (x + 1.0) / 2.0
    ok = ((x01 >= 0) & (x01 <= 1)).all(-1)
    x01, g = x01[ok], g[ok]
    off = hg._offset(spec)

    def corners():
        for lv, level in enumerate(hg.general_levels(spec)):
            idx, ws, _ = hg._general_corners(x01, level, off,
                                             spec.hash_variant)
            yield lv, [i + level.offset for i in idx], ws
    return _exact_scatter(torch, g, spec.level_dim, spec.table_size,
                          corners())


def backward_check(torch, kernels, hg, cfg, batch, dims, dev, tag):
    """Phases 6 and 8: the hash kernels of `cfg.hash_variant` against the
    plain versions on the sample points of one training batch; returns
    errors, timings and bounds by kernel name. For 'xor' that is K3
    (a)-(c) (K2 is held by phase 3); for 'paired' K5 (a)-(d), forward
    included."""
    spec = cfg.hash_spec
    variant = spec.hash_variant
    paired = variant == 'paired'
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
    # the adjoint fold: xor is its own inverse, a shift is undone by S - m
    inv = ((slots - masks) & (slots - 1)) if paired else masks
    inv32 = inv.to(torch.int32).contiguous()
    if paired:
        names = dict(zip(('bake', 'enc', 'bwd', 'dt', 'dw'), PAIRED))
        k_bake = kernels.hash_shift_bake
        k_enc = kernels.hash_encode_paired
        k_bwd = kernels.hash_encode_paired_bwd
        k_dw = kernels.hash_shift_bake_dw
    else:
        names = dict(zip(('bake', 'enc', 'bwd', 'dt', 'dw'), XOR))
        k_bake, k_enc = kernels.hash_bake, kernels.hash_encode
        k_bwd, k_dw = kernels.hash_encode_bwd, kernels.hash_bake_dw
    out = dict(points=n)
    baked = k_bake(table3, masks32, weights)
    if paired:
        p_baked = hg.bake_plain(table3, masks, weights, variant)
        k_feat = k_enc(baked, xyz, scales, off, 1.0, oob)
        p_feat = hg.encode_plain(p_baked, xyz, scales, off, 1.0, oob, variant)
        bake_err = float((baked - p_baked).abs().max())
        enc_err = float((k_feat - p_feat).abs().max())
        log(f'[{tag}] shift bake max abs err {bake_err:.3g} (tolerance '
            f'1e-5); paired encode max abs err {enc_err:.3g} (tolerance 0: '
            f'the same float32 operations in the same order), out mean |x| '
            f'{float(k_feat.abs().mean()):.3f}')
        assert bake_err <= 1e-5 and enc_err == 0, \
            f'{tag} forward differs from plain'
        del p_baked, k_feat, p_feat
    k_grad, k_dxyz = k_bwd(g, xyz, scales, off, 1.0, oob, slots, baked)
    p_grad, p_dxyz = hg.encode_bwd_plain(g, xyz, scales, off, 1.0, oob,
                                         slots, baked, variant)
    if not oob:     # K3a, K5c: against the exact sum
        p_grad = exact_folded_grad(torch, hg, g, xyz, scales, off, slots,
                                   variant)
    abs_grad, _ = hg.encode_bwd_plain(g.abs(), xyz, scales, off, 1.0, oob,
                                      slots, None, variant)
    k_dt = k_bake(k_grad, inv32, weights, names['dt'])
    p_dt = hg.bake_plain(p_grad, inv, weights, variant)
    abs_dt = hg.bake_plain(abs_grad, inv, weights, variant)
    k_dwv = k_dw(table3, k_grad, masks32)
    p_dwv = hg.bake_dw_plain(table3, k_grad, masks, variant)
    torch.cuda.synchronize()
    g_excess = float(((k_grad - p_grad).abs() - 1e-5 * abs_grad
                      - 1e-7).max())
    dt_excess = float(((k_dt - p_dt).abs() - 1e-5 * abs_dt - 1e-7).max())
    dt_err = float((k_dt - p_dt).abs().max())
    g_err = float((k_grad - p_grad).abs().max())
    dw_rel = float(((k_dwv - p_dwv).abs() / p_dwv.abs()).max())
    dx_rel = float((k_dxyz - p_dxyz).abs().max() / p_dxyz.abs().max())
    inb = int((((xyz + 1.0) / 2.0 >= 0) & ((xyz + 1.0) / 2.0 <= 1))
              .all(-1).sum())
    log(f'[{tag}] {n} points ({inb} in bounds), spec {spec.num_levels} x '
        f'{slots} x {spec.level_dim}, variant {variant}')
    log(f'[{tag}] G (scatter) max abs err {g_err:.3g}, dT max abs err '
        f'{dt_err:.3g} (against the float64 sum of the same terms); '
        f'tolerance for each, per slot: 1e-5 x (sum of |w g| into the slot, '
        f'plain path) + 1e-7, because float32 atomics add in a '
        f'run-dependent order: worst margin G {g_excess:.3g}, dT '
        f'{dt_excess:.3g} (<= 0 passes)')
    dw_again = torch.equal(k_dw(table3, k_grad, masks32), k_dwv)
    log(f'[{tag}] dw max rel err {dw_rel:.3g}; tolerance 1e-5 (float64 sums '
        f'on both sides, the kernel in a fixed block order); bitwise equal '
        f'across two launches: {dw_again}')
    log(f'[{tag}] dxyz max err / max|dxyz| {dx_rel:.3g}; tolerance 1e-4 '
        f'(float32 atomics over the 16 levels)')
    assert g_excess <= 0, f'{tag} G differs from plain'
    assert dt_excess <= 0, f'{tag} dT differs from plain'
    assert dw_rel <= 1e-5, f'{tag} dw differs from plain'
    assert dw_again, f'{tag} dw differs between two launches'
    assert dx_rel <= 1e-4, f'{tag} dxyz differs from plain'
    del p_grad, p_dxyz, abs_grad, p_dt, abs_dt, k_dt, k_dxyz

    tbytes = table3.numel() * 4
    fold_flops = table3.numel() * masks.shape[1] * 2
    fold_bound = bound_ms(2 * tbytes, fold_flops)
    if paired:
        t_bake = median_ms(lambda: k_bake(table3, masks32, weights))
        t_bake_plain = median_ms(lambda: hg.bake_plain(table3, masks,
                                                       weights, variant))
        t_fwd = median_ms(lambda: k_enc(baked, xyz, scales, off, 1.0, oob))
        t_fwd_plain = median_ms(lambda: hg.encode_plain(
            baked, xyz, scales, off, 1.0, oob, variant))
        # encode: points in, the distinct baked rows this batch reads
        # (each once) and the features out
        x01 = (xyz + 1.0) / 2.0
        ok = ((x01 >= 0) & (x01 <= 1)).all(-1)
        rows_read = 0
        for lv in range(spec.num_levels):
            rows, _, _ = hg._corners(x01[ok], scales[lv], off, slots,
                                     variant)
            rows_read += int(torch.unique(torch.cat(rows)).numel())
        fwd_bound = bound_ms(
            n * 12 + rows_read * spec.level_dim * 4
            + n * spec.output_dim * 4,
            inb * spec.num_levels * 8 * (2 * spec.level_dim + 3))
        log(f'[{tag}] (a) shift bake {t_bake:.3f} ms (plain '
            f'{t_bake_plain:.2f}, bound {fold_bound[0]:.3f}); (b) paired '
            f'encode {t_fwd:.3f} ms (plain {t_fwd_plain:.1f}, bound '
            f'{fwd_bound[0]:.3f}, {rows_read} distinct rows)')
        out[names['bake']] = (bake_err, t_bake, t_bake_plain, *fold_bound)
        out[names['enc']] = (enc_err, t_fwd, t_fwd_plain, *fwd_bound)
    t_enc = median_ms(lambda: k_bwd(g, xyz, scales, off, 1.0, oob, slots))
    t_enc_plain = median_ms(lambda: hg.encode_bwd_plain(
        g, xyz, scales, off, 1.0, oob, slots, None, variant))
    t_dt = median_ms(lambda: k_bake(k_grad, inv32, weights, names['dt']))
    t_dt_plain = median_ms(lambda: hg.bake_plain(k_grad, inv, weights,
                                                 variant))
    t_dw = median_ms(lambda: k_dw(table3, k_grad, masks32))
    t_dw_plain = median_ms(lambda: hg.bake_dw_plain(table3, k_grad, masks,
                                                    variant))
    # scatter: g rows of in-bounds points and xyz read once, G written once
    enc_bound = bound_ms(inb * spec.output_dim * 4 + n * 12 + tbytes,
                         inb * spec.num_levels * 8 * spec.level_dim * 2)
    log(f'[{tag}] scatter {t_enc:.3f} ms (plain {t_enc_plain:.2f} ms, bound '
        f'{enc_bound[0]:.3f} ms); dT bake {t_dt:.3f} ms (plain '
        f'{t_dt_plain:.2f}, bound {fold_bound[0]:.3f}); dw {t_dw:.3f} ms '
        f'(plain {t_dw_plain:.2f}, bound {fold_bound[0]:.3f} ms)')
    out.update(in_bounds=inb)
    out[names['bwd']] = (g_err, t_enc, t_enc_plain, *enc_bound)
    out[names['dt']] = (dt_err, t_dt, t_dt_plain, *fold_bound)
    out[names['dw']] = (dw_rel, t_dw, t_dw_plain, *fold_bound)
    out['dw_shapes'] = dw_shapes(torch, 'K5d' if paired else 'K3c', k_dw,
                                 table3, k_grad, masks32)
    return out


def _timed_split(torch, kernels, launch, level, order, dev, coarse):
    """Median ms of one scatter launch on the direct path, on the coarse
    path, and the coarse path's (rows flushed, inserts overflowed); the
    direct path alone without `coarse`."""
    direct = median_ms(lambda: launch(order, level, kernels.DIRECT_ONLY))
    if not coarse:
        return direct, math.nan, (-1, -1)
    coarse = median_ms(lambda: launch(order, level, math.inf))
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    launch(order, level, math.inf, stats)
    return direct, coarse, tuple(stats.tolist())


def scatter_split(torch, kernels, tag, scales, launch, distinct, dev,
                  coarse=True):
    """The per-level split of a table scatter (K3a, K4b) on the training
    points, in ray order (as training feeds them) and shuffled:
    `launch(order, level, coarse_max_scale, stats=None)` runs the scatter
    of the points in `order` on one level (None: every level), the
    one-level launch being the kernel on that level's columns of g with
    that level's scale (and metadata); `distinct(level)` counts the table
    rows the level's corners touch. Prints, per level, the direct and the
    coarse path's ms, the coarse path's rows flushed and inserts
    overflowed, and which path the wrapper takes (`kernels.coarse_levels`),
    then the whole launch before (every level direct: the scatter as it
    was before the coarse path) and after. Without `coarse`, the direct
    path alone. Returns the numbers."""
    flags = kernels.coarse_levels(scales)
    out = dict(levels=[], total={})
    log(f'[{tag} levels] level, scale, distinct rows, path taken; per order '
        f'(ray, shuffled): direct ms, coarse ms, coarse rows flushed, '
        f'coarse inserts overflowed')
    for lv, scale in enumerate(scales):
        row = dict(level=lv, scale=float(scale), coarse=flags[lv],
                   rows=distinct(lv))
        for order in ('ray', 'shuffled'):
            row[order] = _timed_split(torch, kernels, launch, lv, order, dev,
                                      coarse)
        log(f'[{tag} levels] {lv:2d} {float(scale):8.2f} {row["rows"]:9d} '
            f'{"coarse" if flags[lv] else "direct"}: ' + '; '.join(
                f'{order} {d:8.3f} {c:8.3f} {fl:9d} {ov:9d}'
                for order in ('ray', 'shuffled')
                for d, c, (fl, ov) in [row[order]]))
        out['levels'].append(row)
    for order in ('ray', 'shuffled'):
        before = median_ms(lambda: launch(order, None, kernels.DIRECT_ONLY))
        after = median_ms(lambda: launch(order, None,
                                         kernels.COARSE_MAX_SCALE)) \
            if coarse else math.nan
        out['total'][order] = (before, after)
        log(f'[{tag} levels] all {len(scales)} levels, {order}: before '
            f'(every level direct) {before:.3f} ms, after (levels of scale '
            f'<= {kernels.COARSE_MAX_SCALE} coarse) {after:.3f} ms')
    return out


def check_split(tag, split):
    """No level the wrapper sends down the coarse path is slower there
    than on the direct path, in ray order (10% for timing noise)."""
    for row in split['levels']:
        d, c, _ = row['ray']
        assert not row['coarse'] or c <= 1.1 * d, (
            f'{tag}: level {row["level"]} is slower on the coarse path '
            f'({c:.3f} ms) than on the direct one ({d:.3f} ms)')


GATHER_ORDERS = ('ray', 'shuffled', 'one point')


def gather_split(torch, tag, case, scales, launch, rows, pts, row_bytes,
                 dev):
    """The per-level split of a forward gather (K2b, K4a) on points `pts`
    [N, D]: in the order the main path feeds them ('ray'), shuffled, and
    all equal to the first in-bounds point ('one point': a warp's lanes
    read the same rows, so the launch costs its instructions and little
    memory traffic). `launch(x, level)` encodes points x on one level
    (None: every level); `rows(level)` gives the table rows that level's
    corners read, one per in-bounds point and corner. Prints, per level,
    the distinct rows, the rows issued, the ms in each order (median of
    5, L2 flushed) and the issued 32-byte sectors per ms in ray order;
    then the whole launch in each order. Returns the numbers."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x01 = (pts + 1.0) / 2.0
    first = int(((x01 >= 0) & (x01 <= 1)).all(-1).int().argmax())
    xs = {'ray': pts,
          'shuffled': pts[torch.randperm(pts.shape[0], generator=gen,
                                         device=dev)].contiguous(),
          'one point': pts[first:first + 1].expand_as(pts).contiguous()}
    sectors = -(-row_bytes // 32)
    out = dict(levels=[], total={})
    log(f'[{tag} levels] {case}: {pts.shape[0]} points; level, scale, '
        f'distinct rows, rows issued; ms {", ".join(GATHER_ORDERS)}; issued '
        f'sectors per ms (ray)')
    for lv, scale in enumerate(scales):
        r = rows(lv)
        row = dict(level=lv, scale=float(scale), issued=int(r.numel()),
                   distinct=int(torch.unique(r).numel()))
        del r
        row['ms'] = {o: median_ms(lambda: launch(xs[o], lv))
                     for o in GATHER_ORDERS}
        rate = row['issued'] * sectors / row['ms']['ray']
        log(f'[{tag} levels] {case} {lv:2d} {float(scale):8.2f} '
            f'{row["distinct"]:9d} {row["issued"]:10d} '
            + ' '.join(f'{row["ms"][o]:7.3f}' for o in GATHER_ORDERS)
            + f' {rate / 1e6:8.1f}M')
        out['levels'].append(row)
    out['total'] = {o: median_ms(lambda: launch(xs[o], None))
                    for o in GATHER_ORDERS}
    log(f'[{tag} levels] {case} all {len(scales)} levels: '
        + ', '.join(f'{o} {t:.3f} ms' for o, t in out['total'].items())
        + f'; sum of the levels (ray) '
        f'{sum(r["ms"]["ray"] for r in out["levels"]):.3f} ms')
    return out


def k2_levels(torch, kernels, hg, baked, xyz, scales, offset, scene_oob,
              dev):
    """Phase 5, K2b: `gather_split` on phase 3's serving chunk; a
    one-level launch is the kernel on that level's baked table and
    scale."""
    slots = baked.shape[1]
    x01 = (xyz + 1.0) / 2.0
    x01 = x01[((x01 >= 0) & (x01 <= 1)).all(-1)]

    def launch(x, lv):
        if lv is None:
            return kernels.hash_encode(baked, x, scales, offset, 1.0,
                                       scene_oob)
        return kernels.hash_encode(baked[lv:lv + 1], x, scales[lv:lv + 1],
                                   offset, 1.0, scene_oob)

    def rows(lv):
        return torch.cat(hg._corners(x01, scales[lv], offset, slots)[0])

    return gather_split(torch, 'K2', 'chunk', scales.tolist(), launch, rows,
                        xyz, baked.shape[2] * 4, dev)


def k4a_levels(torch, kernels, hg, spec, pts, dev, case):
    """Phase 10, K4a: `gather_split` on 5-D points `pts` (scene code
    included) at `spec`, table uniform in [-1, 1]; a one-level launch is
    the kernel on that level's metadata and scale."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    table = torch.rand((spec.table_size, spec.level_dim), generator=gen,
                       device=dev) * 2 - 1
    meta, scales = hg.general_meta(spec)
    off, xor = hg._offset(spec), spec.hash_variant == 'xor'
    levels = hg.general_levels(spec)
    one = [(meta[lv:lv + 1].contiguous(), scales[lv:lv + 1].contiguous())
           for lv in range(spec.num_levels)]
    x01 = (pts + 1.0) / 2.0
    x01 = x01[((x01 >= 0) & (x01 <= 1)).all(-1)]

    def launch(x, lv):
        m, s = (meta, scales) if lv is None else one[lv]
        return kernels.hash_encode_general(table, x, m, s, off, 1.0, xor)

    def rows(lv):
        return torch.cat(hg._general_corners(x01, levels[lv], off,
                                             spec.hash_variant)[0])

    return gather_split(torch, 'K4a', case, scales.tolist(), launch, rows,
                        pts, spec.level_dim * 4, dev)


def k5b_levels(torch, kernels, hg, spec, table3, code, pts, dev, case):
    """Phase 8, K5b: `gather_split` on points `pts` [N, 3] at the paired
    `spec`, the table `table3` [L, S, C] baked by K5a for the scene code
    `code` [2]; a one-level launch is the kernel on that level's baked
    table and scale."""
    shifts, weights, oob = hg.scene_fold_weights(spec, code)
    baked = kernels.hash_shift_bake(table3,
                                    shifts.to(torch.int32).contiguous(),
                                    weights.contiguous())
    scales, off = hg._scales(spec, dev), hg._offset(spec)
    slots = baked.shape[1]
    x01 = (pts + 1.0) / 2.0
    x01 = x01[((x01 >= 0) & (x01 <= 1)).all(-1)]

    def launch(x, lv):
        if lv is None:
            return kernels.hash_encode_paired(baked, x, scales, off, 1.0, oob)
        return kernels.hash_encode_paired(baked[lv:lv + 1], x,
                                          scales[lv:lv + 1], off, 1.0, oob)

    def rows(lv):
        return torch.cat(hg._corners(x01, scales[lv], off, slots,
                                     'paired')[0])

    return gather_split(torch, 'K5b', case, scales.tolist(), launch, rows,
                        pts, baked.shape[2] * 4, dev)


def paired_levels(torch, kernels, hg, cfg, batch, fields, dims, chunk, dev):
    """Phase 8, '[K5b levels]': K5b split by level (`k5b_levels`) on the
    training batch's points ('train') and on phase 3's serving chunk
    ('chunk'), a seeded table uniform in [-1, 1] baked with the scene
    code that the generator of `cfg` (seeded weights) gives the batch's
    fields and the serving world's `fields`. Returns {case: split}."""
    from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
    spec = cfg.hash_spec
    model = SceneDreamerGenerator(cfg, seed=SEED).to(dev)
    with torch.no_grad():
        codes = dict(train=model.world_code(batch['height_field'],
                                            batch['semantic_field'])[0],
                     chunk=model.world_code(*fields)[0])
    del model
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    table3 = (torch.rand((spec.table_size, spec.level_dim), generator=gen,
                         device=dev) * 2 - 1).reshape(spec.num_levels, -1,
                                                      spec.level_dim)
    pts = dict(train=sample_points(batch, cfg, dims), chunk=chunk)
    return {case: k5b_levels(torch, kernels, hg, spec, table3, codes[case],
                             pts[case], dev, case)
            for case in ('train', 'chunk')}


def dw_shapes(torch, tag, launch, table3, grad, masks):
    """'[K3c dw]' / '[K5d dw]' (phases 6 and 8): the weight half of a
    bake's backward, `launch(table3, grad, masks)` on [L, S, C] tables
    and int32 [L, A] xor masks or shifts. Median ms (L2 flushed) of the
    whole launch; of each level alone, summed over the levels; of one
    corner (mask 0) against the A; and with every mask 0, so the A
    windows read the same rows. A whole launch costs its device-memory
    traffic if it is near the sum of the levels and the all-zero masks
    save little; the misses of several levels' windows in L2 if it is
    well above the sum, or the zero masks save much. Bound: T and G read
    once. Returns the numbers."""
    lv, a = masks.shape
    one = [(table3[i:i + 1], grad[i:i + 1], masks[i:i + 1].contiguous())
           for i in range(lv)]
    corner0 = torch.zeros((lv, 1), dtype=torch.int32, device=masks.device)
    zeros = torch.zeros_like(masks)
    out = dict(whole=median_ms(lambda: launch(table3, grad, masks)),
               levels=[median_ms(lambda: launch(*args)) for args in one],
               one_corner=median_ms(lambda: launch(table3, grad, corner0)),
               masks_zero=median_ms(lambda: launch(table3, grad, zeros)))
    out['bound'] = bound_ms(2 * table3.numel() * 4,
                            2 * a * table3.numel())[0]
    lvs = out['levels']
    log(f'[{tag} dw] {tuple(table3.shape)}, {a} corners: whole '
        f'{out["whole"]:.3f} ms; levels alone {min(lvs):.3f}-{max(lvs):.3f} '
        f'ms, sum of the {lv} {sum(lvs):.3f}; one corner (mask 0) '
        f'{out["one_corner"]:.3f}; every mask 0 {out["masks_zero"]:.3f}; '
        f'bound {out["bound"]:.3f} ms (T and G once)')
    return out


def one_cell(torch, n, dims, scales, offset, seed, dev):
    """n points [n, dims] in [-1, 1] that share one cell at every level
    of `scales`: a box 1e-3 of the finest cell wide around a seeded
    centre whose box crosses no level's cell boundary."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    width = 1e-3 / float(max(scales))
    while True:
        lo = torch.rand((dims,), generator=gen, device=dev) * 0.8 + 0.1
        # a margin of one box width on each side for the kernels' rounding
        cells = [torch.floor(v * float(s) + offset)
                 for v in (lo - width, lo + 2 * width) for s in scales]
        half = len(cells) // 2
        if all(torch.equal(a, b) for a, b in zip(cells[:half], cells[half:])):
            break
    x01 = lo + torch.rand((n, dims), generator=gen, device=dev) * width
    return (x01 * 2.0 - 1.0).contiguous()


def _held(tag, case, k_grad, p_grad, abs_grad, k_d, p_d, stats):
    """G per row within 1e-5 of its absolute sum + 1e-7 and the point
    gradient within 1e-4 of its largest magnitude, as phases 6 and 10."""
    excess = float(((k_grad - p_grad).abs() - 1e-5 * abs_grad - 1e-7).max())
    d_rel = float((k_d - p_d).abs().max() / p_d.abs().max())
    flushed, overflowed = stats.tolist()
    log(f'[{tag} {case}] G against the float64 sum: worst margin '
        f'{excess:.3g} (<= 0 passes: 1e-5 x the sum of |w g| into the row + '
        f'1e-7), point gradient max err / max {d_rel:.3g} (tolerance 1e-4); '
        f'coarse path: {flushed} rows flushed, {overflowed} inserts '
        f'overflowed to global atomics')
    assert excess <= 0, f'{tag} {case}: G differs from plain'
    assert d_rel <= 1e-4, f'{tag} {case}: point gradient differs from plain'
    return dict(g_margin=excess, d_rel=d_rel, flushed=flushed,
                overflowed=overflowed)


def report_sums(torch, tag, exact, abs_grad, sums, where):
    """Why the scatters' G is held against its float64 sum: the worst
    margin against the tolerance (1e-5 x the row's absolute sum + 1e-7;
    <= 0 passes) of float32 sums of the same terms, {name: G}, and where
    the first one's worst row lies (`where(row)`: its level and adds)."""
    parts = []
    for i, (name, got) in enumerate(sums.items()):
        margin = ((got.double() - exact).abs() - 1e-5 * abs_grad - 1e-7) \
            .reshape(exact.shape[0] * exact.shape[1] if exact.dim() == 3
                     else exact.shape[0], -1).max(dim=1).values
        worst = int(margin.argmax())
        parts.append(f'{name} {float(margin[worst]):.3g}'
                     + (f' (row {worst}: {where(worst)})' if i == 0 else ''))
    log(f'[{tag} reference] against the float64 sum of the same terms, worst '
        f'margin (<= 0 passes): ' + '; '.join(parts))


def k3_levels(torch, kernels, hg, spec, xyz, dev, coarse=True):
    """Phase 6, K3a: the per-level split (`scatter_split`) and the two
    adversarial cases, every point in one cell (the most sharing: 2^20
    points) and the training points shuffled (which sends the coarse
    levels' tables into overflow), held to the float64 sum of the same
    terms with the wrapper's split and a seeded table as the baked one.
    Without `coarse`, the direct path's split alone. Under a paired
    `spec` the same for K5c (phase 8, '[K5 levels]')."""
    paired = spec.hash_variant == 'paired'
    tag = 'K5' if paired else 'K3'
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, c, lvs = xyz.shape[0], spec.level_dim, spec.num_levels
    slots = spec.table_size // lvs
    scales, off = hg._scales(spec, dev), hg._offset(spec)
    variant = spec.hash_variant
    g = torch.randn((n, spec.output_dim), generator=gen, device=dev)
    perm = torch.randperm(n, generator=gen, device=dev)
    pts = dict(ray=xyz, shuffled=xyz[perm].contiguous())
    gs = dict(ray=g, shuffled=g[perm].contiguous())
    cols = {o: [v[:, lv * c:(lv + 1) * c].contiguous() for lv in range(lvs)]
            for o, v in gs.items()}
    split = kernels.hash_encode_paired_bwd_split if paired \
        else kernels.hash_encode_bwd_split

    def launch(order, lv, cms, stats=None):
        if lv is None:
            return split(gs[order], pts[order], scales, off, 1.0, False,
                         slots, None, cms, stats)
        return split(cols[order][lv], pts[order], scales[lv:lv + 1], off,
                     1.0, False, slots, None, cms, stats)

    x01 = (xyz + 1.0) / 2.0
    x01 = x01[((x01 >= 0) & (x01 <= 1)).all(-1)]
    _, repeats = torch.unique(xyz, dim=0, return_counts=True)
    log(f'[{tag} levels] {n} points, {x01.shape[0]} in bounds; the most '
        f'repeated point occurs {int(repeats.max())} times (the samples of '
        f'rays that hit nothing, all at the camera)')

    def distinct(lv):
        rows, _, _ = hg._corners(x01, scales[lv], off, slots, variant)
        return int(torch.unique(torch.cat(rows)).numel())

    out = scatter_split(torch, kernels, tag, scales.tolist(), launch,
                        distinct, dev, coarse)
    del cols
    if not coarse:
        return out

    def where(row):
        lv, slot = divmod(row, slots)
        idx, _, _ = hg._corners(x01, scales[lv], off, slots, variant)
        return f'level {lv}, {sum(int((i == slot).sum()) for i in idx)} adds'
    report_sums(torch, tag, exact_folded_grad(torch, hg, g, xyz, scales, off,
                                              slots, variant),
                hg.encode_bwd_plain(g.abs(), xyz, scales, off, 1.0, False,
                                    slots, None, variant)[0],
                {'float32 plain twin': hg.encode_bwd_plain(
                    g, xyz, scales, off, 1.0, False, slots, None,
                    variant)[0],
                 'direct path': launch('ray', None, kernels.DIRECT_ONLY)[0],
                 'coarse path': launch('ray', None, None)[0]}, where)
    baked = torch.rand((lvs, slots, c), generator=gen, device=dev) * 2 - 1
    cell = one_cell(torch, ONE_CELL_POINTS, 3, scales.tolist(), off, SEED,
                    dev)
    g1 = torch.randn((cell.shape[0], spec.output_dim), generator=gen,
                     device=dev)
    for case, x, gg in (('one cell', cell, g1),
                        ('shuffled', pts['shuffled'], gs['shuffled'])):
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        k_grad, k_d = split(gg, x, scales, off, 1.0, False, slots, baked,
                            stats=stats)
        _, p_d = hg.encode_bwd_plain(gg, x, scales, off, 1.0, False, slots,
                                     baked, variant)
        p_grad = exact_folded_grad(torch, hg, gg, x, scales, off, slots,
                                   variant)
        abs_grad, _ = hg.encode_bwd_plain(gg.abs(), x, scales, off, 1.0,
                                          False, slots, None, variant)
        out[case] = _held(tag, case, k_grad, p_grad, abs_grad, k_d,
                          p_d, stats)
        del k_grad, p_grad, abs_grad, k_d, p_d
    check_split(tag, out)
    return out


def k4_levels(torch, kernels, hg, spec, pts, dev, coarse=True):
    """Phase 10, K4b: as `k3_levels` on the 5-D training points (scene
    code included), the table given so the point gradient is computed;
    the one-cell case keeps the batch's scene code."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, d = pts.shape
    c, lvs, rows = spec.level_dim, spec.num_levels, spec.table_size
    meta, scales = hg.general_meta(spec)
    off, xor = hg._offset(spec), spec.hash_variant == 'xor'
    levels = hg.general_levels(spec)
    table = torch.rand((rows, c), generator=gen, device=dev) * 2 - 1
    g = torch.randn((n, spec.output_dim), generator=gen, device=dev)
    perm = torch.randperm(n, generator=gen, device=dev)
    xs = dict(ray=pts, shuffled=pts[perm].contiguous())
    gs = dict(ray=g, shuffled=g[perm].contiguous())
    cols = {o: [v[:, lv * c:(lv + 1) * c].contiguous() for lv in range(lvs)]
            for o, v in gs.items()}
    one = [(meta[lv:lv + 1].contiguous(), scales[lv:lv + 1].contiguous())
           for lv in range(lvs)]

    def launch(order, lv, cms, stats=None):
        if lv is None:
            return kernels.hash_encode_general_bwd_split(
                gs[order], xs[order], meta, scales, off, 1.0, xor, rows,
                table, True, cms, stats)
        return kernels.hash_encode_general_bwd_split(
            cols[order][lv], xs[order], *one[lv], off, 1.0, xor, rows, table,
            True, cms, stats)

    x01 = (pts + 1.0) / 2.0
    x01 = x01[((x01 >= 0) & (x01 <= 1)).all(-1)]

    def distinct(lv):
        idx, _, _ = hg._general_corners(x01, levels[lv], off,
                                        spec.hash_variant)
        return int(torch.unique(torch.cat(idx)).numel())

    out = scatter_split(torch, kernels, 'K4', scales.tolist(), launch,
                        distinct, dev, coarse)
    del cols
    if not coarse:
        return out
    offsets = [lv.offset for lv in levels]

    def where(row):
        lv = max(i for i, o in enumerate(offsets) if o <= row)
        idx, _, _ = hg._general_corners(x01, levels[lv], off,
                                        spec.hash_variant)
        return (f'level {lv}, '
                f'{sum(int((i + offsets[lv] == row).sum()) for i in idx)} adds')
    report_sums(torch, 'K4', exact_general_grad(torch, hg, spec, g, pts),
                hg.encode_general_bwd_plain(spec, g.abs(), pts, 1.0, rows)[0],
                {'float32 plain twin': hg.encode_general_bwd_plain(
                    spec, g, pts, 1.0, rows)[0],
                 'direct path': launch('ray', None, kernels.DIRECT_ONLY)[0],
                 'coarse path': launch('ray', None, None)[0]}, where)
    cell = one_cell(torch, ONE_CELL_POINTS, 3, scales.tolist(), off, SEED,
                    dev)
    cell = torch.cat([cell, pts[:1, 3:].expand(cell.shape[0], d - 3)],
                     dim=-1).contiguous()
    g1 = torch.randn((cell.shape[0], spec.output_dim), generator=gen,
                     device=dev)
    for case, x, gg in (('one cell', cell, g1),
                        ('shuffled', xs['shuffled'], gs['shuffled'])):
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        k_grad, k_d = kernels.hash_encode_general_bwd_split(
            gg, x, meta, scales, off, 1.0, xor, rows, table, stats=stats)
        _, p_d = hg.encode_general_bwd_plain(spec, gg, x, 1.0, rows, table,
                                             False)
        p_grad = exact_general_grad(torch, hg, spec, gg, x)
        abs_grad, _ = hg.encode_general_bwd_plain(spec, gg.abs(), x, 1.0,
                                                  rows)
        out[case] = _held('K4', case, k_grad, p_grad, abs_grad, k_d,
                          p_d, stats)
        del k_grad, p_grad, abs_grad, k_d, p_d
    check_split('K4', out)
    return out


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
    for name in PAIRED:
        assert counts[name] == 0, f'the xor training step launched {name}'
    return dict(counts=counts, steps=steps, s_per_iter=spi,
                peak_gb=peak_gb, rays=hw * hw)


def twin_margins(torch, ta, ma, tb, mb):
    """Two trainers from one state after the same step: the largest
    relative difference of their losses and of their gradient norms, and
    of their parameters the worst margin against 1e-5 (or 2 lr + 1e-5
    where |grad| < 1e-5: Adam with beta1 = 0 moves those by up to their
    learning rate whichever way the rounding tips it), how many such, of
    how many, and the largest difference."""
    return state_margins(torch, ta, ma, {'gen': tb.gen.state_dict(),
                                         'dis': tb.dis.state_dict()}, mb)


def state_margins(torch, ta, ma, sd, mb):
    """`twin_margins` of trainer `ta` (its metrics `ma`, its gradients
    deciding where Adam may tip) against the generator and discriminator
    state dicts `sd` ({'gen': ..., 'dis': ...}) and metrics `mb` of
    another run of the same step."""
    rel = {n: abs(mb[n] - ma[n]) / max(abs(ma[n]), 1e-30) for n in ma}
    loss_rel = max(v for n, v in rel.items() if not n.endswith('grad_norm'))
    norm_rel = max(v for n, v in rel.items() if n.endswith('grad_norm'))
    lr_of = {id(p): g['lr'] for o in (ta.g_opt, ta.d_opt)
             for g in o.opt.param_groups for p in g['params']}
    worst, loose, total, max_err = -math.inf, 0, 0, 0.0
    with torch.no_grad():
        for part, mod_a in (('gen', ta.gen), ('dis', ta.dis)):
            for name, pa in mod_a.named_parameters():
                err = (pa - sd[part][name].to(pa.device)).abs()
                flat = pa.grad.abs() < 1e-5
                limit = torch.where(flat, 2 * lr_of[id(pa)] + 1e-5, 1e-5)
                worst = max(worst, float((err - limit).max()))
                loose += int((flat & (err > 1e-5)).sum())
                total += err.numel()
                max_err = max(max_err, float(err.max()))
    return loss_rel, norm_rel, worst, loose, total, max_err


def train_compact(torch, cfg, world, voxel, dev):
    """Phase 7, compaction: twin trainers from one seed take one
    `train_step_shared` on one batch with the same draws, one with
    `compact_k`, one without. The batch's top quarter of image rows is
    forced to hit nothing (as the CPU tests force a sky block), and K is
    the rays whose first slot hits, rounded up as the renderer rounds.
    Losses within 1e-5 relative, gradient norms 1e-4, parameters within
    1e-5 except where a gradient is below 1e-5 (Adam with beta1 = 0 moves
    those by up to their learning rate whichever way the rounding tips
    it)."""
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    from scenedreamer_tpu_torch.render.pipeline import COMPACT_GRANULE
    hw = TRAIN_CROP + cfg.pad
    batch = make_batch(world, batch_size=1, height=hw, width=hw,
                       max_samples=cfg.num_blocks_early_stop, pad=cfg.pad,
                       seed=SEED, device=dev, voxel=voxel)
    natural = float(batch['hit_mask'][..., 0].float().mean())
    batch['hit_mask'] = batch['hit_mask'].clone()
    batch['hit_mask'][:, :hw // 4] = False
    n_hit = int(batch['hit_mask'][..., 0].sum())
    k = -(-n_hit // COMPACT_GRANULE) * COMPACT_GRANULE
    assert k < hw * hw, 'no ray to drop'
    runs = []
    for ck in (None, k):
        trainer = make_trainer(cfg, world.dims, dev)
        draws = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.time()
        m = trainer.train_step_shared(batch, draws, compact_k=ck)
        torch.cuda.synchronize()
        runs.append((trainer, m, time.time() - t0))
    (ta, ma, sa), (tb, mb, sb) = runs
    loss_rel, norm_rel, worst, loose, total, max_err = twin_margins(
        torch, ta, ma, tb, mb)
    log(f'[train compact] {hw}x{hw} rays, {natural:.3f} hit before the top '
        f'{hw // 4} rows were cleared, {n_hit} after; compact_k {k}: one '
        f'train_step_shared {sb:.3f} s against {sa:.3f} s without; losses '
        f'max rel diff {loss_rel:.3g} (tolerance 1e-5), gradient norms '
        f'{norm_rel:.3g} (1e-4); parameters max abs diff {max_err:.3g}, '
        f'worst margin {worst:.3g} (<= 0 passes: 1e-5, or 2 lr + 1e-5 '
        f'where |grad| < 1e-5, {loose} of {total} such)')
    assert loss_rel <= 1e-5, 'the compacted step\'s losses differ'
    assert norm_rel <= 1e-4, 'the compacted step\'s gradient norms differ'
    assert worst <= 0, 'the compacted step\'s update differs'


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self):
        return ''.join(self.parts)


def _run_cli(torch, kernels, argv):
    """One `cli.train.main(argv)`: (its printed output, launch counts,
    the run's log directory, its metrics.jsonl records by name, seconds,
    peak GB)."""
    import contextlib
    import gc
    import glob
    from scenedreamer_tpu_torch.cli import train as cli
    logs = argv[argv.index('--logdir') + 1]
    before = set(glob.glob(os.path.join(logs, '*')))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    tee = _Tee(sys.stdout)
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    (logdir,) = set(glob.glob(os.path.join(logs, '*'))) - before
    return tee.text(), counts, logdir, _read_series(logdir), seconds, peak_gb


def _read_series(logdir):
    """A run's metrics.jsonl as {name: [(step, value), ...]}."""
    series = {}
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k not in ('t', 'step'):
                    series.setdefault(k, []).append((rec['step'], v))
    return series


def _check_counts(counts, ran, idle, what):
    log(f'[loop] {what}: launches {counts}')
    for name in ('dda',) + ran:
        assert counts[name] > 0, f'{what}: kernel {name} never launched'
    for name in idle:
        assert counts[name] == 0, f'{what}: launched {name}'


def loop_data(world):
    """Phase 9's inputs under smoke_out/loop: a terrain cache of `world`,
    16 synthetic 320x320 PNG pairs and configs/scenedreamer_train.yaml
    logging every iteration (checkpoints at 3, snapshots at 4), as
    `train_xor.yaml` and, with `gen.hash_variant: paired`,
    `train_paired.yaml`. Returns (root, {variant: yaml path})."""
    import dataclasses
    import numpy as np
    import yaml
    from scenedreamer_tpu_torch.data.synthetic import make_paired_folder
    from scenedreamer_tpu_torch.scene.voxel_world import (SAMPLE_HEIGHT,
                                                          save_world_cache)
    root = os.path.join(REPO, 'smoke_out', 'loop')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # the cache holds uncropped worlds; rows outside [ground, sky) are
    # dropped again on load, so zeros there give the same world back
    full = np.zeros((SAMPLE_HEIGHT,) + world.voxel.shape[1:], np.int8)
    full[world.y_offset:world.y_offset + world.voxel.shape[0]] = world.voxel
    save_world_cache(dataclasses.replace(world, voxel=full, y_offset=0),
                     os.path.join(root, 'cache', '000000'))
    make_paired_folder(os.path.join(root, 'data'), n=16, size=320, seed=SEED)
    with open(os.path.join(REPO, 'configs', 'scenedreamer_train.yaml')) as f:
        base = yaml.safe_load(f)
    base.update(logging_iter=1, snapshot_save_iter=3, image_save_iter=4)
    configs = {}
    for variant in ('paired', 'xor'):
        cfg = json.loads(json.dumps(base))
        if variant == 'paired':
            cfg['gen']['hash_variant'] = 'paired'
        configs[variant] = os.path.join(root, f'train_{variant}.yaml')
        with open(configs[variant], 'w') as f:
            yaml.safe_dump(cfg, f)
    return root, configs


def loop_path(torch, kernels, world, dev):
    """Phase 9: the training CLI at the flagship training width, on the
    paired variant (6 iterations, then a resume to 8), on the xor
    variant (3) and with `--speed-benchmark` (3)."""
    t0 = time.time()
    root, configs = loop_data(world)
    log(f'[loop] terrain cache + 16 PNG pairs + yamls in '
        f'{time.time() - t0:.1f} s under {root}')

    def argv(variant, logs, *extra):
        return ['--config', configs[variant], '--data-root',
                os.path.join(root, 'data'), '--terrain-cache',
                os.path.join(root, 'cache'), '--logdir',
                os.path.join(root, logs), '--seed', str(SEED)] + list(extra)

    def finite(series, what):
        assert series, f'{what}: no metrics written'
        for name, points in series.items():
            for step, v in points:
                assert math.isfinite(v), f'{what}: {name} = {v} at {step}'

    # paired: 6 iterations -------------------------------------------------
    text, counts, logdir, series, secs, peak = _run_cli(
        torch, kernels, argv('paired', 'logs_paired', '--max-iter', '6'))
    _check_counts(counts, PAIRED, XOR, 'paired, 6 iterations')
    finite(series, 'paired')
    assert [s for s, _ in series['gen/total']] == [1, 2, 3, 4, 5, 6]
    ckpts = os.path.join(logdir, 'checkpoints')
    with open(os.path.join(ckpts, 'latest_checkpoint.txt')) as f:
        assert f.read().strip() == 'step_00000006.pt'
    tables = [torch.load(os.path.join(ckpts, f'step_{i:08d}.pt'),
                         map_location='cpu', weights_only=True)
              ['generator']['hash_encoder.embeddings'] for i in (3, 6)]
    moved = float((tables[1] - tables[0]).abs().max())
    log(f'[loop] hash table change between iterations 3 and 6 (max abs): '
        f'{moved:.3g}')
    assert moved > 0, 'the hash table did not move'
    del tables
    assert os.path.exists(os.path.join(logdir, 'images',
                                       'train_snapshot_00000004.png'))
    ips = [v for _, v in series['perf/iters_per_s']]
    paired_spi = statistics.median(1.0 / v for v in ips[1:])
    fallback = series['sampler/fallback_rate'][-1][1]
    log(f'[loop] paired: {paired_spi:.3f} s/iteration (median of iterations '
        f'2-6, batch build prefetched; all {[round(1 / v, 3) for v in ips]}), '
        f'run {secs:.1f} s with set-up and checkpoints, peak memory '
        f'{peak:.1f} GB, sampler/fallback_rate {fallback}')
    loop = dict(counts=counts, iterations=6, s_per_iter=paired_spi,
                peak_gb=peak, fallback_rate=fallback)

    # paired: resume to 8 --------------------------------------------------
    text, counts, logdir2, series, secs, _ = _run_cli(
        torch, kernels, argv('paired', 'logs_paired', '--max-iter', '8',
                             '--resume'))
    assert 'resumed at iteration 6' in text, 'the run did not resume at 6'
    _check_counts(counts, PAIRED, XOR, 'paired, resumed to 8')
    finite(series, 'paired resumed')
    assert [s for s, _ in series['gen/total']] == [7, 8]
    with open(os.path.join(logdir2, 'checkpoints',
                           'latest_checkpoint.txt')) as f:
        assert f.read().strip() == 'step_00000008.pt'

    # xor: 3 iterations ----------------------------------------------------
    text, counts, xlogdir, series, secs, xpeak = _run_cli(
        torch, kernels, argv('xor', 'logs_xor', '--max-iter', '3'))
    _check_counts(counts, XOR, PAIRED, 'xor, 3 iterations')
    finite(series, 'xor')
    ips = [v for _, v in series['perf/iters_per_s']]
    xor_spi = statistics.median(1.0 / v for v in ips[1:])
    log(f'[loop] xor: {xor_spi:.3f} s/iteration (median of iterations 2-3; '
        f'all {[round(1 / v, 3) for v in ips]}), peak memory {xpeak:.1f} GB')
    loop.update(xor_counts=counts, xor_iterations=3, xor_s_per_iter=xor_spi,
                xor_series=series)

    # paired with --speed-benchmark: 3 iterations ---------------------------
    text, counts, _, series, secs, _ = _run_cli(
        torch, kernels, argv('paired', 'logs_speed', '--max-iter', '3',
                             '--speed-benchmark'))
    finite(series, 'speed benchmark')
    # no prefetch here, so the last logged proposal count is the run's
    proposals = int(series['sampler/proposals'][-1][1])
    log(f'[loop] --speed-benchmark: K1 launched {counts["dda"]} times for '
        f'{proposals} camera proposals in 3 iterations (one launch per '
        f'round of {PROPOSALS})')
    assert counts['dda'] * PROPOSALS == proposals, \
        'the sampler did not launch K1 once per round'
    loop.update(speed_dda_launches=counts['dda'], speed_proposals=proposals)
    phases = {}
    for name in ('world_sample', 'batch_build', 'train_step'):
        vals = [v for step, v in series[f'speed/{name}_ms'] if step > 1]
        phases[name] = statistics.mean(vals)
    total = sum(phases.values())
    log('[loop] --speed-benchmark, no prefetch, mean of iterations 2-3 '
        '(ms): ' + ', '.join(f'{k} {v:.1f}' for k, v in phases.items())
        + f'; host-side batch share (world_sample + batch_build) '
        f'{(total - phases["train_step"]) / total:.3f} of {total:.1f} ms')
    loop.update(phases_ms=phases)
    for logs in ('logs_paired', 'logs_speed'):
        shutil.rmtree(os.path.join(root, logs))     # ~4 GB of checkpoints
    # phase 12's inference CLI loads the xor run's checkpoint directory
    # (the CLI's generator is the xor spec, as JAX's): keep its latest
    ckpts = os.path.join(xlogdir, 'checkpoints')
    with open(os.path.join(ckpts, 'latest_checkpoint.txt')) as f:
        latest = f.read().strip()
    for name in os.listdir(ckpts):
        if name.endswith('.pt') and name != latest:
            os.remove(os.path.join(ckpts, name))
    loop.update(xor_checkpoints=ckpts, xor_yaml=configs['xor'])
    return loop


def _general_rows(torch, hg, spec, x):
    """Distinct table rows the in-bounds points of x read, summed over the
    levels (each read once), and the in-bounds count."""
    x01 = (x + 1.0) / 2.0
    inb = ((x01 >= 0) & (x01 <= 1)).all(-1)
    rows = sum(int(torch.unique(torch.cat(hg._general_corners(
        x01[inb], lv, hg._offset(spec), spec.hash_variant)[0])).numel())
        for lv in hg.general_levels(spec))
    return rows, int(inb.sum())


def general_forward(torch, kernels, hg, spec, table, x, tag, timing):
    """Phase 10: K4 (a) against its plain version on points x [N, D];
    with `timing`, its and the plain version's times and the bound.
    Returns (error, ms, plain ms, bound ms, bound by) (the error alone
    without `timing`)."""
    meta, scales = hg.general_meta(spec)
    off, xor = hg._offset(spec), spec.hash_variant == 'xor'
    k_out = kernels.hash_encode_general(table, x, meta, scales, off, 1.0, xor)
    p_out = hg.encode_general_plain(spec, table, x)
    torch.cuda.synchronize()
    err = float((k_out - p_out).abs().max())
    n, d = x.shape
    log(f'[{tag}] forward {n} points -> {tuple(k_out.shape)} max abs err '
        f'{err:.3g} (tolerance 1e-5: the same float32 operations in the '
        f'same order), out mean |x| {float(k_out.abs().mean()):.3f}')
    assert err <= 1e-5, f'{tag} forward differs from plain'
    del k_out, p_out
    if not timing:
        return (err,)
    t = median_ms(lambda: kernels.hash_encode_general(
        table, x, meta, scales, off, 1.0, xor))
    t_plain = median_ms(lambda: hg.encode_general_plain(spec, table, x),
                        reps=3)
    rows_read, n_inb = _general_rows(torch, hg, spec, x)
    c, lvs = spec.level_dim, spec.num_levels
    bound = bound_ms(n * d * 4 + rows_read * c * 4 + n * lvs * c * 4,
                     n_inb * lvs * 2 ** d * (2 * c + d))
    log(f'[{tag}] (a) encode {t:.3f} ms (plain {t_plain:.1f}, bound '
        f'{bound[0]:.3f} by {bound[1]}, {rows_read} distinct rows)')
    return err, t, t_plain, *bound


def general_check(torch, kernels, hg, spec, x, dev, tag, timing=False):
    """Phase 10: K4 (a)/(b) against the plain versions on points x
    [N, D]; with `timing`, the kernels' and plain versions' times and
    bounds. Returns {kernel name: (error, ms, plain ms, bound ms, bound
    by)} (errors only without `timing`) and the point counts."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.rand((spec.table_size, spec.level_dim), generator=gen,
                       device=dev) * 2 - 1
    n, d = x.shape
    g = torch.randn((n, spec.output_dim), generator=gen, device=dev)
    meta, scales = hg.general_meta(spec)
    off, xor, rows = hg._offset(spec), spec.hash_variant == 'xor', \
        spec.table_size
    levels = hg.general_levels(spec)
    log(f'[{tag}] spec D={d} x {spec.num_levels} levels x {spec.level_dim} '
        f'(gridtype {spec.gridtype}, align_corners {spec.align_corners}, '
        f'{spec.hash_variant}), table {spec.table_size} rows; level sizes '
        f'{[lv.size for lv in levels]}, hashed '
        f'{[int(lv.hashed) for lv in levels]}')
    fwd = general_forward(torch, kernels, hg, spec, table, x, tag, timing)
    k_grad, k_dx = kernels.hash_encode_general_bwd(g, x, meta, scales, off,
                                                   1.0, xor, rows, table)
    _, p_dx = hg.encode_general_bwd_plain(spec, g, x, 1.0, rows, table,
                                          False)
    p_grad = exact_general_grad(torch, hg, spec, g, x)
    abs_grad, _ = hg.encode_general_bwd_plain(spec, g.abs(), x, 1.0, rows)
    torch.cuda.synchronize()
    g_err = float((k_grad - p_grad).abs().max())
    g_excess = float(((k_grad - p_grad).abs() - 1e-5 * abs_grad
                      - 1e-7).max())
    dx_rel = float((k_dx - p_dx).abs().max() / p_dx.abs().max())
    x01 = (x + 1.0) / 2.0
    n_inb = int(((x01 >= 0) & (x01 <= 1)).all(-1).sum())
    log(f'[{tag}] G (scatter) max abs err {g_err:.3g} against the float64 '
        f'sum; tolerance per row: 1e-5 x (sum of |w g| into the row, plain '
        f'path) + 1e-7, because float32 atomics add in a run-dependent '
        f'order: worst margin {g_excess:.3g} (<= 0 passes); dx max err / '
        f'max|dx| {dx_rel:.3g}, tolerance 1e-4 (float32 atomics over the '
        f'levels); {n_inb} points in bounds')
    assert g_excess <= 0, f'{tag} G differs from plain'
    assert dx_rel <= 1e-4, f'{tag} dx differs from plain'
    del p_grad, p_dx, abs_grad, k_grad, k_dx
    out = dict(points=n, in_bounds=n_inb, hash_encode_general=fwd)
    if not timing:
        out.update(hash_encode_general_bwd=(g_err,))
        return out
    t_bwd = median_ms(lambda: kernels.hash_encode_general_bwd(
        g, x, meta, scales, off, 1.0, xor, rows, table))
    t_bwd_plain = median_ms(lambda: hg.encode_general_bwd_plain(
        spec, g, x, 1.0, rows, table), reps=3)
    c, lvs, k = spec.level_dim, spec.num_levels, 2 ** d
    rows_read, _ = _general_rows(torch, hg, spec, x)
    # g rows of in-bounds points, x, the rows read for dx, G and dx
    # written once
    bwd_bound = bound_ms(n_inb * lvs * c * 4 + n * d * 4 + rows_read * c * 4
                         + rows * c * 4 + n * d * 4,
                         n_inb * lvs * k * (4 * c + d * d))
    log(f'[{tag}] (b) scatter + dx {t_bwd:.3f} ms (plain '
        f'{t_bwd_plain:.1f}, bound {bwd_bound[0]:.3f} by {bwd_bound[1]})')
    out.update(rows_read=rows_read,
               hash_encode_general_bwd=(g_err, t_bwd, t_bwd_plain,
                                        *bwd_bound))
    return out


def general_render(torch, kernels, model, world, style, dev):
    """Phase 11, serving: one frame of the log2-21 generator through
    `render_trajectory`, then one more timed frame."""
    import numpy as np
    from scenedreamer_tpu_torch.render.pipeline import (CHUNK_RAYS,
                                                        TiledRenderer,
                                                        render_trajectory)
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    out_dir = os.path.join(REPO, 'smoke_out', 'unfolded')
    h, w = RES[0] + PAD, RES[1] + PAD
    chunks = math.ceil(h / max(1, CHUNK_RAYS // w))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    frames = render_trajectory(model, world, style, out_dir, camera_mode=4,
                               cam_maxstep=1, cam_ang=72,
                               num_samples=SAMPLES, num_blocks_early_stop=M,
                               pad=PAD, resolution_hw=RES, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f'[unfolded] render_trajectory: {len(frames)} frame in {wall:.2f} s '
        f'(with warm-up), peak memory {peak_gb:.1f} GB, launches {counts}')
    assert len(frames) == 1
    assert frames[0].shape == RES + (3,) and frames[0].dtype == np.uint8, \
        (frames[0].shape, frames[0].dtype)
    assert counts['dda'] > 0, 'K1 never launched'
    for name in ('hash_encode_general_bwd',) + XOR + PAIRED:
        assert counts[name] == 0, f'the unfolded serving path launched {name}'
    renderer = TiledRenderer(model, world, num_samples=SAMPLES,
                             num_blocks_early_stop=M, pad=PAD,
                             resolution_hw=RES, device=dev)
    z = renderer.style_z(style.numpy())
    # the pose of the frame above
    pose = EvalCameraController(world, maxstep=1, pattern=4, cam_ang=72,
                                smooth_decay_multiplier=150.0)[0]
    spf, img, _ = timed_frame(torch, renderer, pose, z)
    assert np.isfinite(img).all(), 'non-finite frame'
    assert np.abs(img).max() <= 1.0, 'frame outside [-1, 1]'
    log_frame_stats('on, unfolded', renderer.last_stats, spf)
    field_chunks = chunks - renderer.last_stats['chunks_sky_only']
    assert counts['hash_encode_general'] == field_chunks, \
        f'K4 (a) launched {counts["hash_encode_general"]} times, not once ' \
        f'per chunk that runs the field ({field_chunks} of {chunks})'
    log(f'[unfolded] steady state: {spf:.3f} s/frame at {h}x{w} rays, '
        f'{SAMPLES} samples ({chunks} chunks, {field_chunks} through the '
        f'field)')
    return dict(counts=counts, n_frames=1, chunks=chunks, s_per_frame=spf,
                peak_gb=peak_gb)


def general_train(torch, kernels, cfg, world, voxel, dev):
    """Phase 11, the step: 1 warm-up and 2 timed `train_step_shared` of
    the log2-21 generator at the flagship training width."""
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    trainer = make_trainer(cfg, world.dims, dev)
    gm = trainer.gen
    draws = torch.Generator(device=dev).manual_seed(SEED)
    hw = TRAIN_CROP + cfg.pad
    watched = {'hash_encoder.embeddings': gm.hash_encoder.embeddings,
               'world_encoder.fc2.weight': gm.world_encoder.fc2.weight}
    before = {k: v.detach().clone() for k, v in watched.items()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    step_s = []
    for i in range(3):
        batch = make_batch(world, batch_size=1, height=hw, width=hw,
                           max_samples=cfg.num_blocks_early_stop,
                           pad=cfg.pad, seed=SEED + i, device=dev,
                           voxel=voxel)
        torch.cuda.synchronize()
        t0 = time.time()
        m = trainer.train_step_shared(batch, draws)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        for k, v in m.items():
            assert math.isfinite(v), f'non-finite {k} at step {i}'
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = {k: float((v.detach() - before[k]).abs().max())
             for k, v in watched.items()}
    spi = statistics.mean(step_s[1:])
    log(f'[unfolded] train_step_shared {spi:.3f} s/iteration (mean of 2 after '
        f'a warm-up; {step_s}), peak memory {peak_gb:.1f} GB, parameter '
        f'change {moved}, launches {counts} over 3 steps; last metrics '
        + ', '.join(f'{k} {v:.4g}' for k, v in m.items()))
    for k, v in moved.items():
        assert v > 0, f'{k} did not move'
    assert counts['dda'] > 0, 'K1 never launched'
    for name in GENERAL:
        assert counts[name] == 3, f'{name} launched {counts[name]} times'
    for name in XOR + PAIRED:
        assert counts[name] == 0, f'the unfolded step launched {name}'
    return dict(counts=counts, steps=3, s_per_iter=spi, peak_gb=peak_gb)


def general_loop(torch, kernels):
    """Phase 11, the loop: `cli.train.main` with `gen.hash_log2_size: 21`
    on phase 9's cache and pairs, 4 iterations with `--speed-benchmark`."""
    import yaml
    root = os.path.join(REPO, 'smoke_out', 'loop')
    with open(os.path.join(REPO, 'configs', 'scenedreamer_train.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg.update(logging_iter=1, snapshot_save_iter=3, image_save_iter=2)
    cfg['gen']['hash_log2_size'] = LOG2_UNFOLDED
    path = os.path.join(root, 'train_unfolded.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    argv = ['--config', path, '--data-root', os.path.join(root, 'data'),
            '--terrain-cache', os.path.join(root, 'cache'), '--logdir',
            os.path.join(root, 'logs_unfolded'), '--seed', str(SEED),
            '--max-iter', '4', '--speed-benchmark']
    text, counts, logdir, series, secs, peak = _run_cli(torch, kernels, argv)
    _check_counts(counts, GENERAL, XOR + PAIRED, 'unfolded, 4 iterations')
    assert series, 'unfolded: no metrics written'
    for name, points in series.items():
        for step, v in points:
            assert math.isfinite(v), f'unfolded: {name} = {v} at {step}'
    assert [s for s, _ in series['gen/total']] == [1, 2, 3, 4]
    ckpts = os.path.join(logdir, 'checkpoints')
    with open(os.path.join(ckpts, 'latest_checkpoint.txt')) as f:
        assert f.read().strip() == 'step_00000004.pt'
    states = [torch.load(os.path.join(ckpts, f'step_{i:08d}.pt'),
                         map_location='cpu', weights_only=True)['generator']
              for i in (3, 4)]
    moved = {}
    for prefix in ('hash_encoder.', 'world_encoder.'):
        moved[prefix] = max(float((states[1][k] - states[0][k]).abs().max())
                            for k in states[0] if k.startswith(prefix))
    del states
    log(f'[unfolded] parameter change between iterations 3 and 4 (max abs): '
        f'{moved}')
    for k, v in moved.items():
        assert v > 0, f'{k} did not move in the loop'
    for it in (2, 4):
        assert os.path.exists(os.path.join(
            logdir, 'images', f'train_snapshot_{it:08d}.png'))
    ips = [v for _, v in series['perf/iters_per_s']]
    spi = statistics.median(1.0 / v for v in ips[1:])
    phases = {}
    for name in ('world_sample', 'batch_build', 'train_step'):
        vals = [v for step, v in series[f'speed/{name}_ms'] if step > 1]
        phases[name] = statistics.mean(vals)
    total = sum(phases.values())
    share = phases['train_step'] / total
    log(f'[unfolded] loop: {spi:.3f} s/iteration (median of iterations 2-4, '
        f'--speed-benchmark: no prefetch; all {[round(1 / v, 3) for v in ips]}'
        f'), run {secs:.1f} s with set-up, checkpoints and snapshots; phases, '
        f'mean of iterations 2-4 (ms): '
        + ', '.join(f'{k} {v:.1f}' for k, v in phases.items())
        + f'; the step\'s share {share:.3f} of {total:.1f} ms; peak memory '
        f'{peak:.1f} GB')
    shutil.rmtree(os.path.join(root, 'logs_unfolded'))
    return dict(counts=counts, iterations=4, s_per_iter=spi, phases_ms=phases,
                step_share=share, peak_gb=peak)


# bf16 limits of phase 12, on the largest and the mean difference from the
# float32 frame: multiples of JAX's own bf16-to-float32 distance at the
# full flagship width, which tests/test_torch_bf16_limit.py measures on
# the CPU (40x64 frames, two poses: max 1.84e-4, mean 3.40e-5; the port's
# own distance there max 1.84e-4, mean 3.41e-5). The card's frame has
# 200x the pixels of those frames, so its largest difference lies
# further out. Both limits stay under the frames' 1e-3.
BF16_JAX_MAX, BF16_JAX_MEAN = 1.84e-4, 3.40e-5
BF16_LIMIT_MAX, BF16_LIMIT_MEAN = 4 * BF16_JAX_MAX, 2 * BF16_JAX_MEAN
TILE = 128                  # the inference CLI's --tile_size
TILES = 40                  # 540x960 on the 128 grid: 5 x 8
STRIP_RES = (1080, 1920)    # 1110x1950 rays with the pad: 2.16 MPx


def _warm_timed(torch, kernels, renderer, pose, z):
    """A warm-up frame, then one timed frame with the launch counts set
    to 0 just before it and read just after: (seconds, image, launch
    counts, peak GB)."""
    renderer.frame(pose, z)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    secs, img, _ = timed_frame(torch, renderer, pose, z)
    counts = kernels.launch_counts()
    return secs, img, counts, torch.cuda.max_memory_allocated() / 1e9


def _run_inference(torch, module, argv):
    """`module.main(argv)` with its printed output kept: (its return
    value, the output)."""
    import contextlib
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        ret = module.main(argv)
    torch.cuda.synchronize()
    return ret, tee.text()


def _mp4_frames(path):
    import cv2
    cap = cv2.VideoCapture(path)
    shapes = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        shapes.append(img.shape)
    cap.release()
    return shapes


def serve_rest(torch, kernels, world, style, pose, split_img, ckpts, dev):
    """Phase 12, the rest of serving, at the flagship width on phase 4's
    world, style and seeded weights: the padded-tile frame at 1 and 4
    tiles per batch, the 1080p frame with and without CNN strips, the
    bf16 frame, the inference CLI (phase 9's xor checkpoint directory,
    depth, style interpolation, mp4; then padded tiles) and the headless
    demo. Returns the padded-tile frames' launch counts by tiles per
    batch."""
    import dataclasses
    import re
    import numpy as np
    from scenedreamer_tpu_torch.cli import demo, inference
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                        to_uint8)
    from scenedreamer_tpu_torch.scene.camera import EvalCameraController
    cfg = GeneratorConfig(num_samples=SAMPLES, num_blocks_early_stop=M)
    model = SceneDreamerGenerator(cfg, seed=SEED).to(dev).eval()
    kw = dict(num_samples=SAMPLES, num_blocks_early_stop=M, pad=PAD,
              device=dev)
    z_np = style.numpy()
    idle = XOR[2:] + PAIRED + GENERAL
    t_phase = time.time()

    # padded tiles -----------------------------------------------------
    tiles = {}
    for tb in (1, 4):
        r = TiledRenderer(model, world, resolution_hw=RES, tile_size=TILE,
                          split_refine=False, tiles_per_batch=tb, **kw)
        secs, img, counts, peak = _warm_timed(torch, kernels, r, pose,
                                              r.style_z(z_np))
        st = r.last_stats
        err = float(np.abs(img - split_img).max())
        field_tiles = (st['batches'] - st['tiles_sky_only']) * tb
        log(f'[serve tile] tiles_per_batch {tb}: {secs:.3f} s/frame, peak '
            f'{peak:.1f} GB, {st["tiles"]} tiles of {TILE + PAD}x'
            f'{TILE + PAD} ({st["tiles_sky_only"]} sky only, {field_tiles} '
            f'through the field with the repeats of a short last group), '
            f'field rays {st["field_rays"]}, launches per frame {counts}; '
            f'image max abs diff from phase 4\'s split-refine frame {err:.3g}'
            f' (tolerance 1e-3)')
        assert st['tiles'] == TILES, st
        assert np.isfinite(img).all() and np.abs(img).max() <= 1.0
        assert err <= 1e-3, 'the padded-tile frame differs from the split one'
        assert counts['dda'] == 1, 'K1 not launched once per frame'
        assert counts['hash_bake'] == 1, \
            'K2a not launched once per frame (once per tile or batch item?)'
        assert counts['hash_encode'] == field_tiles, \
            'K2b not launched once per tile that runs the field'
        for name in idle:
            assert counts[name] == 0, f'the padded-tile frame launched {name}'
        tiles[tb] = counts
        if tb == 1:
            tile_img = img
        del r
        torch.cuda.empty_cache()

    # 1080p: CNN strips and the whole CNN -----------------------------------
    strips = TiledRenderer(model, world, resolution_hw=STRIP_RES, **kw)
    os.environ['SCENEDREAMER_REFINE_FULL_PX'] = str(10 ** 9)
    try:
        whole = TiledRenderer(model, world, resolution_hw=STRIP_RES, **kw)
    finally:
        del os.environ['SCENEDREAMER_REFINE_FULL_PX']
    assert not strips.refine_full and whole.refine_full
    z = strips.style_z(z_np)
    whole.frame(pose, z)                      # warm-up at this shape
    got = {}
    for name, r in (('strips', strips), ('whole', whole)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs, img, _ = timed_frame(torch, r, pose, z)
        got[name] = (secs, img, torch.cuda.max_memory_allocated() / 1e9)
    err = float(np.abs(got['strips'][1] - got['whole'][1]).max())
    h, w = strips.cam_res
    log(f'[serve strips] {STRIP_RES[0]}x{STRIP_RES[1]} ({h}x{w} rays, '
        f'{h * w / 1e6:.2f} MPx): strips of {strips.strip_rows} rows '
        f'{got["strips"][0]:.3f} s/frame, peak {got["strips"][2]:.1f} GB; '
        f'whole CNN {got["whole"][0]:.3f} s/frame, peak '
        f'{got["whole"][2]:.1f} GB; image max abs diff {err:.3g} (tolerance '
        f'1e-3)')
    for _, img, _ in got.values():
        assert np.isfinite(img).all() and np.abs(img).max() <= 1.0
    assert err <= 1e-3, 'the CNN strips differ from the whole CNN'
    del strips, whole, got
    torch.cuda.empty_cache()

    # bf16 -----------------------------------------------------------------
    bmodel = SceneDreamerGenerator(dataclasses.replace(
        cfg, dtype=torch.bfloat16), seed=SEED).to(dev).eval()
    r = TiledRenderer(bmodel, world, resolution_hw=RES, **kw)
    secs, img, counts, peak = _warm_timed(torch, kernels, r, pose,
                                          r.style_z(z_np))
    diff = np.abs(img - split_img)
    log(f'[serve bf16] {RES[0]}x{RES[1]}: {secs:.3f} s/frame, peak '
        f'{peak:.1f} GB; difference from phase 4\'s float32 frame max '
        f'{diff.max():.4g} (limit {BF16_LIMIT_MAX:.4g}), mean '
        f'{diff.mean():.4g} (limit {BF16_LIMIT_MEAN:.4g}); the limits are 4x '
        f'and 2x JAX\'s own bf16-to-float32 distance on the CPU (max '
        f'{BF16_JAX_MAX}, mean {BF16_JAX_MEAN}, '
        f'tests/test_torch_bf16_limit.py); the float32 frame\'s largest '
        f'magnitude {np.abs(split_img).max():.4g}; launches {counts}')
    assert np.isfinite(img).all() and np.abs(img).max() <= 1.0
    assert diff.max() <= BF16_LIMIT_MAX and diff.mean() <= BF16_LIMIT_MEAN, \
        'the bf16 frame is outside its limit'
    del r, bmodel
    torch.cuda.empty_cache()

    # the inference CLI ------------------------------------------------------
    out_dir = os.path.join(REPO, 'smoke_out', 'serve_cli')
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ['--output_dir', out_dir, '--scene_size', str(SCENE), '--seed',
            str(SEED), '--checkpoint', ckpts]
    frames, text = _run_inference(torch, inference, argv + [
        '--cam_maxstep', '3', '--save_depth', '--style2', 'seed:9'])
    line = re.search(r'trajectory: (\d+) frames in ([\d.]+) s, ([\d.]+) '
                     r's/frame wall; the frame loop ([\d.]+) s/frame after '
                     r'([\d.]+) s of set-up; host writes ([\d.]+) s/frame, '
                     r'waits ([\d.]+) s/frame', text)
    assert line, 'the CLI printed no trajectory line'
    wall, loop_s, setup, writes, waits = (float(line.group(i))
                                          for i in (3, 4, 5, 6, 7))
    rgb = os.path.join(out_dir, 'rgb_render')
    for i in range(3):
        for suffix in ('', '_depth', '_voxel'):
            assert os.path.exists(os.path.join(rgb, f'{i:05d}{suffix}.png'))
    assert np.load(os.path.join(rgb, 'style.npy')).shape == (3, 128)
    shapes = _mp4_frames(rgb + '.mp4')
    assert shapes == [RES + (3,)] * 3, shapes
    # the same frames through `frame`, one by one, on the same weights
    loaded = inference.load_generator(ckpts, cfg, dev, seed=SEED)
    with open(os.path.join(ckpts, 'latest_checkpoint.txt')) as f:
        table = torch.load(os.path.join(ckpts, f.read().strip()),
                           map_location='cpu', weights_only=True)[
            'generator']['hash_encoder.embeddings']
    assert torch.equal(loaded.hash_encoder.embeddings.cpu(), table), \
        'the CLI did not load the checkpoint'
    r = TiledRenderer(loaded, world, resolution_hw=RES, **kw)
    styles = np.load(os.path.join(rgb, 'style.npy'))
    poses = EvalCameraController(world, maxstep=3, pattern=4, cam_ang=72,
                                 smooth_decay_multiplier=150.0 / 3)
    frame_s = []
    for i, p in enumerate(poses):
        secs, img, _ = timed_frame(torch, r, p, r.style_z(styles[i:i + 1]))
        frame_s.append(secs)
        assert np.abs(to_uint8(img).astype(int) - frames[i]).max() <= 1, \
            'the CLI frame differs from the same frame through `frame`'
    del r, loaded
    torch.cuda.empty_cache()
    log(f'[serve cli] 3 frames at {RES[0]}x{RES[1]} from {ckpts} (save_depth,'
        f' style2 seed:9): {wall:.3f} s/frame wall, the depth-1 frame loop '
        f'{loop_s:.3f} s/frame after {setup:.3f} s of renderer set-up; the '
        f'same frames through `frame` {statistics.mean(frame_s):.3f} s/frame '
        f'({[round(s, 3) for s in frame_s]}); host writes {writes:.3f} '
        f's/frame (PNG, depth, voxel, mp4), waits {waits:.3f} s/frame; mp4 '
        f'read back as {len(shapes)} frames of {shapes[0][:2]}')
    shutil.rmtree(out_dir + '_tiles', ignore_errors=True)
    frames, text = _run_inference(torch, inference, [
        '--output_dir', out_dir + '_tiles', '--scene_size', str(SCENE),
        '--seed', str(SEED), '--checkpoint', ckpts, '--no_split_refine',
        '--cam_maxstep', '2'])
    line = re.search(r'([\d.]+) s/frame wall', text)
    assert len(frames) == 2 and _mp4_frames(
        os.path.join(out_dir + '_tiles', 'rgb_render.mp4')) == [
        RES + (3,)] * 2
    log(f'[serve cli] --no_split_refine, 2 frames: {float(line.group(1)):.3f}'
        f' s/frame wall (set-up and the first frame included)')

    # the headless demo -----------------------------------------------------
    demo_dir = os.path.join(REPO, 'smoke_out', 'serve_demo')
    shutil.rmtree(demo_dir, ignore_errors=True)
    t0 = time.time()
    path, _ = _run_inference(torch, demo, [
        '--output_dir', demo_dir, '--seed', str(SEED), '--cam_maxstep', '2'])
    for name in ('bev_height.png', 'bev_semantic.png'):
        assert os.path.exists(os.path.join(demo_dir, name)), name
    shapes = _mp4_frames(path)
    assert shapes == [RES + (3,)] * 2, shapes
    log(f'[serve demo] headless, 2 frames: BEV PNGs and {path} '
        f'({len(shapes)} frames) in {time.time() - t0:.1f} s with terrain')
    log(f'[serve] phase 12 in {time.time() - t_phase:.1f} s')
    shutil.rmtree(os.path.dirname(os.path.dirname(ckpts)))
    return dict(counts=tiles, img=tile_img)


# bf16 step limits of phase 13: 4x JAX's own bf16-to-float32 distance of
# one `train_step_shared`, which tests/test_torch_train_amp.py measures
# on the CPU (TINY generator, D at the flagship 128 filters, DiffAugment
# on, the same weights and draws): the largest relative difference
# |a - b| / max(|b|, 1e-2) over the losses 2.08e-3, over the two
# gradient norms 2.54e-2 (the port's own there 1.50e-3 and 1.14e-2). The
# G losses pass through the D that the step's first Adam update (about
# +-lr per weight) just moved, so bf16 noise in D's small gradients
# reaches them; it grows with D's width (8x from 8 to 128 filters).
BF16_STEP_JAX_LOSS, BF16_STEP_JAX_NORM = 2.08e-3, 2.54e-2
BF16_STEP_LIMIT_LOSS = 4 * BF16_STEP_JAX_LOSS
BF16_STEP_LIMIT_NORM = 4 * BF16_STEP_JAX_NORM
STEP_FLOOR = 1e-2
AUG = 'color,translation,cutout'
STEP_KERNELS = ('hash_bake', 'hash_encode', 'hash_encode_bwd',
                'hash_bake_bwd', 'hash_bake_dw')
# two generator configurations that between them set every option the
# shipped configs leave at its default off it
OPTION_CONFIGS = {
    'viewdir': dict(pe_lvl_raydir=4, pe_incl_orig_raydir=True,
                    clip_feat_map='tanh', sky_global_avgpool=False,
                    use_seg=False),
    'noise': dict(raw_noise_std=1.0, clip_feat_map=False,
                  keep_sky_out=False, keep_sky_out_avgpool=False),
}
LOOP_ITERS, LOOP_CKPT, LOOP_RESUME = 24, 12, 16


def _step(torch, kernels, trainer, batch, seed, dev,
          method='train_step_shared'):
    """One synchronised training step with the launch counts set to 0
    just before it: (metrics, seconds, launch counts, peak GB)."""
    draws = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    m = getattr(trainer, method)(batch, draws)
    torch.cuda.synchronize()
    secs = time.time() - t0
    for k, v in m.items():
        assert math.isfinite(v), f'non-finite {k} ({method})'
    return (m, secs, kernels.launch_counts(),
            torch.cuda.max_memory_allocated() / 1e9)


def train_amp(torch, kernels, world, batch, dev):
    """Phase 13, '[train amp]': AMP and float32 `train_step_shared` on
    phase 6's batch from the same seeded weights and draws; the first
    step of each (a warm-up) compared loss by loss, then 3 timed steps of
    each in turn, then one AMP step on the paired spec."""
    import dataclasses
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    tcfg = GeneratorConfig()
    trainers = {name: make_trainer(dataclasses.replace(tcfg, dtype=dt),
                                   world.dims, dev)
                for name, dt in (('amp', torch.bfloat16),
                                 ('float32', torch.float32))}
    first = {name: _step(torch, kernels, tr, batch, SEED, dev)
             for name, tr in trainers.items()}
    (ma, sa, _, _), (mf, sf, _, _) = first['amp'], first['float32']
    readings = []
    for n in sorted(mf):
        rel = abs(ma[n] - mf[n]) / max(abs(mf[n]), STEP_FLOOR)
        limit = BF16_STEP_LIMIT_NORM if n.endswith('grad_norm') \
            else BF16_STEP_LIMIT_LOSS
        readings.append((n, ma[n], mf[n], rel, limit))
    log(f'[train amp] first step (a warm-up; the same weights, batch and '
        f'draws): AMP {sa:.3f} s, float32 {sf:.3f} s; each metric, AMP / '
        f'float32, |a - b| / max(|b|, {STEP_FLOOR}) against its limit '
        f'(BF16_STEP_LIMIT_LOSS {BF16_STEP_LIMIT_LOSS:.4g}, _NORM '
        f'{BF16_STEP_LIMIT_NORM:.4g}: 4x JAX\'s own on the CPU): '
        + '; '.join(f'{n} {a:.6g} / {b:.6g}: {r:.3g} (limit {lim:.3g})'
                    for n, a, b, r, lim in readings))
    steps = {name: [] for name in trainers}
    for i in range(TRAIN_STEPS):
        for name, tr in trainers.items():
            steps[name].append(_step(torch, kernels, tr, batch,
                                     SEED + 1 + i, dev))
        ca, cf = steps['amp'][-1][2], steps['float32'][-1][2]
        for k in STEP_KERNELS:
            assert ca[k] == cf[k] > 0, \
                f'AMP step {i} launched {k} {ca[k]} times, float32 {cf[k]}'
        for k in PAIRED + GENERAL:
            assert ca[k] == 0, f'the xor AMP step launched {k}'
    out = {}
    for name, runs in steps.items():
        secs = [r[1] for r in runs]
        out[name] = dict(s_per_iter=statistics.mean(secs),
                         peak_gb=max(r[3] for r in runs), counts=runs[-1][2])
        log(f'[train amp] {name}: {out[name]["s_per_iter"]:.3f} s/iteration '
            f'(mean of {TRAIN_STEPS} after the warm-up; '
            f'{[round(t, 3) for t in secs]}), peak {out[name]["peak_gb"]:.1f}'
            f' GB, launches per step {runs[-1][2]}')
    amp = trainers['amp']
    for mod in (amp.gen, amp.dis):
        for n, p in mod.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
            assert bool(torch.isfinite(p.grad).all()), f'non-finite grad {n}'
    log(f'[train amp] AMP parameters and gradients: float32 and finite '
        f'({sum(1 for m in (amp.gen, amp.dis) for _ in m.parameters())} '
        f'tensors); float32 / AMP s/iteration '
        f'{out["float32"]["s_per_iter"] / out["amp"]["s_per_iter"]:.2f}x')
    for n, a, b, r, lim in readings:
        assert r <= lim, f'AMP {n} {a} is {r:.3g} from float32 {b} ' \
            f'(limit {lim:.3g})'
    del trainers, amp
    torch.cuda.empty_cache()
    ptr = make_trainer(dataclasses.replace(tcfg, hash_variant='paired',
                                           dtype=torch.bfloat16),
                       world.dims, dev)
    m, secs, counts, peak = _step(torch, kernels, ptr, batch, SEED, dev)
    log(f'[train amp] paired spec, one AMP step: {secs:.3f} s (first step '
        f'of its trainer), peak {peak:.1f} GB, launches {counts}')
    for k in PAIRED:
        assert counts[k] > 0, f'the paired AMP step never launched {k}'
    for k in XOR + GENERAL:
        assert counts[k] == 0, f'the paired AMP step launched {k}'
    out['paired_counts'] = counts
    del ptr
    torch.cuda.empty_cache()
    return out


def train_aug(torch, kernels, world, batch, f32_spi, dev):
    """Phase 13, '[train aug]': a step with DiffAugment and the nearest
    label resize, then `train_step_fused` against `train_step` on twin
    trainers from one seed and one draw seed."""
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    tcfg = GeneratorConfig()
    tr = make_trainer(tcfg, world.dims, dev, aug_policy=AUG,
                      smooth_resample=False)
    warm = _step(torch, kernels, tr, batch, SEED, dev)
    m, secs, counts, peak = _step(torch, kernels, tr, batch, SEED + 1, dev)
    log(f'[train aug] aug_policy {AUG}, smooth_resample false: '
        f'train_step_shared {secs:.3f} s (after a warm-up step of '
        f'{warm[1]:.3f} s) against [train amp]\'s float32 step '
        f'{f32_spi:.3f} s: DiffAugment and the nearest resize cost '
        f'{secs - f32_spi:+.3f} s; peak {peak:.1f} GB; ' + ', '.join(
            f'{k} {v:.4g}' for k, v in m.items()))
    del tr
    torch.cuda.empty_cache()
    runs = []
    for method in ('train_step', 'train_step_fused'):
        t = make_trainer(tcfg, world.dims, dev, aug_policy=AUG,
                         smooth_resample=False)
        runs.append((t,) + _step(torch, kernels, t, batch, SEED, dev,
                                 method))
    (ta, ma, sa, _, _), (tb, mb, sb, _, _) = runs
    loss_rel, norm_rel, worst, loose, total, max_err = twin_margins(
        torch, ta, ma, tb, mb)
    log(f'[train aug] train_step_fused {sb:.3f} s against train_step '
        f'{sa:.3f} s from one state and draw seed: losses max rel diff '
        f'{loss_rel:.3g} (tolerance 1e-5), gradient norms {norm_rel:.3g} '
        f'(1e-4); parameters max abs diff {max_err:.3g}, worst margin '
        f'{worst:.3g} (<= 0 passes; {loose} of {total} within 2 lr where '
        f'|grad| < 1e-5)')
    assert loss_rel <= 1e-5 and norm_rel <= 1e-4 and worst <= 0, \
        'train_step_fused differs from train_step'
    del runs, ta, tb
    torch.cuda.empty_cache()
    return dict(s_per_iter=secs, peak_gb=peak)


def train_options(torch, kernels, world, batch, style, pose, f32_counts,
                  dev):
    """Phase 13, '[train options]': per `OPTION_CONFIGS` entry one
    training step at the flagship training width (finite, K2/K3 launched
    as the default step launches them) and one 540x960 frame with
    compaction and the sky skip on, held within 1e-3 of the same frame
    with both off (not with `raw_noise_std`: JAX draws the noise on the
    compacted rays only)."""
    import dataclasses
    import numpy as np
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
    out = {}
    for name, opts in OPTION_CONFIGS.items():
        tr = make_trainer(dataclasses.replace(GeneratorConfig(), **opts),
                          world.dims, dev)
        m, secs, counts, peak = _step(torch, kernels, tr, batch, SEED, dev)
        del tr
        for k in STEP_KERNELS + PAIRED + GENERAL:
            assert counts[k] == f32_counts[k], \
                f'{name}: the step launched {k} {counts[k]} times, the ' \
                f'default step {f32_counts[k]}'
        model = SceneDreamerGenerator(GeneratorConfig(
            num_samples=SAMPLES, num_blocks_early_stop=M, **opts),
            seed=SEED).to(dev).eval()
        kw = dict(num_samples=SAMPLES, num_blocks_early_stop=M, pad=PAD,
                  resolution_hw=RES, device=dev)
        r_on = TiledRenderer(model, world, **kw)
        z = r_on.style_z(style.numpy())
        r_on.frame(pose, z)                                 # warm-up
        s_on, img_on, _ = timed_frame(torch, r_on, pose, z)
        os.environ['SCENEDREAMER_FIELD_COMPACT'] = '0'
        try:
            r_off = TiledRenderer(model, world, sky_fast=False, **kw)
        finally:
            del os.environ['SCENEDREAMER_FIELD_COMPACT']
        s_off, img_off, _ = timed_frame(torch, r_off, pose, z)
        err = float(np.abs(img_on - img_off).max())
        log(f'[train options] {name} {opts}: one train_step_shared '
            f'{secs:.3f} s (its trainer\'s first), peak {peak:.1f} GB, '
            f'K2/K3 launches as the default step; frame {RES[0]}x{RES[1]} '
            f'compaction on {s_on:.3f} s, off {s_off:.3f} s, image max abs '
            f'diff {err:.3g}'
            + (' (noise drawn on other rays: not held)'
               if opts.get('raw_noise_std') else ' (tolerance 1e-3)'))
        for img in (img_on, img_off):
            assert np.isfinite(img).all() and np.abs(img).max() <= 1.0
        if not opts.get('raw_noise_std'):
            assert err <= 1e-3, f'{name}: the compacted frame differs'
        out[name] = dict(step_s=secs, frame_s=s_on, frame_err=err)
        del model, r_on, r_off
        torch.cuda.empty_cache()
    return out


def _kernel_names(trace_dir):
    """The names of the device kernels in the Chrome trace under
    `trace_dir` (events of category 'kernel')."""
    import glob
    (path,) = glob.glob(os.path.join(trace_dir, '*.json'))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return path, sorted({e['name'] for e in events
                         if e.get('cat') == 'kernel'})


def _loop_spread(series, first=5):
    """s/iteration of each logged iteration from `first` on: (median,
    min, max, count)."""
    per = [1.0 / v for step, v in series['perf/iters_per_s'] if step >= first]
    return statistics.median(per), min(per), max(per), len(per)


def train_cli_amp(torch, kernels):
    """Phase 13, '[train cli amp]': `cli.train.main` with AMP, DiffAugment
    and the paired spec on phase 9's cache and pairs, `--profile`, 24
    iterations with a checkpoint at 12, a resume from 12 to 16, then the
    same 24 iterations in float32."""
    import yaml
    root = os.path.join(REPO, 'smoke_out', 'loop')
    with open(os.path.join(REPO, 'configs', 'scenedreamer_train.yaml')) as f:
        base = yaml.safe_load(f)
    base.update(logging_iter=1, snapshot_save_iter=LOOP_CKPT,
                image_save_iter=10 ** 6)
    base['gen']['hash_variant'] = 'paired'
    base['trainer']['aug_policy'] = AUG
    paths = {}
    for name, enabled in (('amp', True), ('float32', False)):
        cfg = json.loads(json.dumps(base))
        cfg['trainer']['amp_config'] = {'enabled': enabled}
        paths[name] = os.path.join(root, f'train_{name}.yaml')
        with open(paths[name], 'w') as f:
            yaml.safe_dump(cfg, f)

    def argv(name, logs, *extra):
        return ['--config', paths[name], '--data-root',
                os.path.join(root, 'data'), '--terrain-cache',
                os.path.join(root, 'cache'), '--logdir',
                os.path.join(root, logs), '--seed', str(SEED)] + list(extra)

    def finite(series, what):
        assert series, f'{what}: no metrics written'
        for n, points in series.items():
            for step, v in points:
                assert math.isfinite(v), f'{what}: {n} = {v} at {step}'

    out = {}
    text, counts, logdir, series, secs, peak = _run_cli(
        torch, kernels, argv('amp', 'logs_amp', '--max-iter',
                             str(LOOP_ITERS), '--profile'))
    _check_counts(counts, PAIRED, XOR + GENERAL, f'AMP, {LOOP_ITERS} '
                  f'iterations')
    finite(series, 'AMP loop')
    assert [s for s, _ in series['gen/total']] == \
        list(range(1, LOOP_ITERS + 1))
    trace, names = _kernel_names(os.path.join(logdir, 'trace'))
    hashes = [n for n in names if 'paired' in n or 'shift_bake' in n
              or 'folded_bwd' in n or 'dw_' in n]
    log(f'[train cli amp] --profile: {trace} holds {len(names)} distinct '
        f'kernels; the hash kernels among them: {hashes}')
    for want in ('encode_paired_kernel', 'shift_bake_kernel'):
        assert any(want in n for n in hashes), \
            f'the trace does not name {want}'
    out['amp'] = _loop_spread(series) + (secs, peak)
    ckpts = os.path.join(logdir, 'checkpoints')
    with open(os.path.join(ckpts, 'latest_checkpoint.txt'), 'w') as f:
        f.write(f'step_{LOOP_CKPT:08d}.pt\n')       # as if killed after 12
    text, counts, logdir2, series, _, _ = _run_cli(
        torch, kernels, argv('amp', 'logs_amp', '--max-iter',
                             str(LOOP_RESUME), '--resume'))
    assert f'resumed at iteration {LOOP_CKPT}' in text, \
        f'the run did not resume at {LOOP_CKPT}'
    finite(series, 'AMP resumed')
    assert [s for s, _ in series['gen/total']] == \
        list(range(LOOP_CKPT + 1, LOOP_RESUME + 1))
    state = torch.load(os.path.join(logdir2, 'checkpoints',
                                    f'step_{LOOP_RESUME:08d}.pt'),
                       map_location='cpu', weights_only=True)
    dtypes = {str(v.dtype) for part in ('generator', 'discriminator')
              for v in state[part].values() if v.is_floating_point()}
    assert dtypes == {'torch.float32'}, dtypes
    del state
    med, lo, hi, n = _loop_spread(series, LOOP_CKPT + 2)
    log(f'[train cli amp] resumed at {LOOP_CKPT}, ran to {LOOP_RESUME} '
        f'(meters at {[s for s, _ in series["gen/total"]]}); checkpointed '
        f'parameters {sorted(dtypes)}; without --profile, iterations '
        f'{LOOP_CKPT + 2}-{LOOP_RESUME}: {med:.3f} s/iteration median '
        f'({n}; {lo:.3f}-{hi:.3f})')
    out['amp_resumed'] = (med, lo, hi, n)
    text, counts, _, series, secs, peak = _run_cli(
        torch, kernels, argv('float32', 'logs_f32', '--max-iter',
                             str(LOOP_ITERS)))
    _check_counts(counts, PAIRED, XOR + GENERAL, f'float32, {LOOP_ITERS} '
                  f'iterations')
    finite(series, 'float32 loop')
    out['float32'] = _loop_spread(series) + (secs, peak)
    out['float32_series'], out['float32_yaml'] = series, paths['float32']
    for name in ('amp', 'float32'):
        med, lo, hi, n, secs, peak = out[name]
        log(f'[train cli amp] {name}: {med:.3f} s/iteration, median of '
            f'iterations 5-{LOOP_ITERS} ({n}; spread {lo:.3f}-{hi:.3f}; '
            f'prefetch on, aug {AUG}, paired), run {secs:.1f} s with '
            f'set-up and checkpoints, peak {peak:.1f} GB')
    for logs in ('logs_amp', 'logs_f32'):
        shutil.rmtree(os.path.join(root, logs))
    return out


def rest_of_training(torch, kernels, world, style, pose, dev):
    """Phase 13, the rest of training: `[train amp]`, `[train aug]`,
    `[train options]`, `[train cli amp]`."""
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    t_phase = time.time()
    tcfg = GeneratorConfig()
    hw = TRAIN_CROP + tcfg.pad
    voxel = torch.from_numpy(world.voxel).to(dev)
    batch = make_batch(world, batch_size=1, height=hw, width=hw,
                       max_samples=tcfg.num_blocks_early_stop, pad=tcfg.pad,
                       seed=SEED, device=dev, voxel=voxel)
    amp = train_amp(torch, kernels, world, batch, dev)
    aug = train_aug(torch, kernels, world, batch,
                    amp['float32']['s_per_iter'], dev)
    options = train_options(torch, kernels, world, batch, style, pose,
                            amp['float32']['counts'], dev)
    del batch, voxel
    torch.cuda.empty_cache()
    loop = train_cli_amp(torch, kernels)
    log(f'[train] phase 13 in {time.time() - t_phase:.1f} s')
    return dict(amp=amp, aug=aug, options=options, loop=loop)


# phase 14: multi-GPU -------------------------------------------------------
MULTI_XOR_ITERS, MULTI_PAIRED_ITERS = 8, 4
# the torchrun CLI (NCCL, world 1) against the same CLI in one process on
# the same yaml and seed: only the float atomics of the table scatters
# (K3a, K5c) make two such runs differ, and Adam (beta1 = 0) turns that
# noise in near-zero gradients into +-lr steps, which the later
# iterations' meters carry. Held to CLI_TOL, relative with denominators
# floored at 1e-2; the distance of two one-process runs (phase 9's xor
# run and this phase's, iterations 1-3) is printed beside it
CLI_TOL = 1e-3


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run_session(cmd, timeout, **kw):
    """`subprocess.run(cmd, capture_output=True, text=True)` in a session
    of its own: at the timeout the whole session is killed, torchrun's
    ranks with it (killing torchrun alone leaves them hung in a
    collective)."""
    import signal
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True, **kw)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def torchrun_cli(argv, nproc=1, timeout=900):
    """`cli.train.main(argv)` through `torch.distributed.run
    --nproc_per_node <nproc>` (env:// rendezvous, NCCL; at 1, world size
    1) in children of this script (`--worker cli`): (their output, each
    rank's launch counts, the run's log directory, its metrics,
    seconds)."""
    import glob
    logs = argv[argv.index('--logdir') + 1]
    before = set(glob.glob(os.path.join(logs, '*')))
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
           str(nproc), '--master_port', str(_free_port()),
           os.path.abspath(__file__), '--worker', 'cli'] + argv
    t0 = time.time()
    res = run_session(cmd, timeout, cwd=REPO,
                      env=dict(os.environ, PYTHONPATH=REPO))
    seconds = time.time() - t0
    assert res.returncode == 0, \
        f'torchrun failed ({res.returncode}):\n{res.stdout[-4000:]}\n' \
        f'{res.stderr[-4000:]}'
    counts = [json.loads(ln[len('[worker] launches '):])
              for ln in res.stdout.splitlines()
              if ln.startswith('[worker] launches ')]
    assert len(counts) == nproc, counts
    (logdir,) = set(glob.glob(os.path.join(logs, '*'))) - before
    return res.stdout, counts, logdir, _read_series(logdir), seconds


def _meter_distance(got, want, steps):
    """The largest relative difference over the meters both runs wrote at
    `steps` (not the timings, nor the sampler's running counts, which
    the prefetch's timing moves), denominators floored at 1e-2:
    (distance, meter, step)."""
    worst = (0.0, None, None)
    for name, points in want.items():
        if name.startswith(('perf/', 'speed/', 'sampler/')) \
                or name not in got:
            continue
        a, b = dict(got[name]), dict(points)
        for st in steps:
            if st in a and st in b:
                d = abs(a[st] - b[st]) / max(abs(b[st]), 1e-2)
                worst = max(worst, (d, name, st), key=lambda t: t[0])
    return worst


def multi_cli(torch, kernels, loop, rest):
    """Phase 14 (a): the training CLI through torchrun at world size 1 over
    NCCL: 8 iterations on phase 9's xor yaml against the same in one
    process (meters, launches, s/iteration), and 4 on phase 13's float32
    paired yaml against phase 13's run of it."""
    root = os.path.join(REPO, 'smoke_out', 'loop')

    def argv(yaml_path, logs, iters):
        return ['--config', yaml_path, '--data-root',
                os.path.join(root, 'data'), '--terrain-cache',
                os.path.join(root, 'cache'), '--logdir',
                os.path.join(root, logs), '--seed', str(SEED), '--max-iter',
                str(iters)]
    _, plain_counts, _, plain, plain_secs, _ = _run_cli(
        torch, kernels, argv(loop['xor_yaml'], 'logs_multi_plain',
                             MULTI_XOR_ITERS))
    text, (counts,), _, dist, dist_secs = torchrun_cli(
        argv(loop['xor_yaml'], 'logs_multi_nccl', MULTI_XOR_ITERS))
    assert 'rank 0 of 1 (nccl)' in text, 'the CLI did not run over NCCL'
    steps = list(range(1, MULTI_XOR_ITERS + 1))
    for series in (plain, dist):
        assert [s for s, _ in series['gen/total']] == steps
    spi = {name: statistics.median(1.0 / v for st, v in series[
        'perf/iters_per_s'] if st >= 2) for name, series in
        (('plain', plain), ('nccl', dist))}
    d, name, st = _meter_distance(dist, plain, steps)
    floor = _meter_distance(plain, loop['xor_series'], [1, 2, 3])
    log(f'[multi cli] xor, {MULTI_XOR_ITERS} iterations: torchrun '
        f'--nproc_per_node 1 (NCCL, world 1) {spi["nccl"]:.3f} s/iteration '
        f'against {spi["plain"]:.3f} in one process (medians of iterations '
        f'2-{MULTI_XOR_ITERS}; runs {dist_secs:.1f} / {plain_secs:.1f} s with '
        f'set-up and process start); meters max rel diff {d:.3g} ({name} at '
        f'{st}; tolerance {CLI_TOL}); two one-process runs (phase 9, this '
        f'phase), iterations 1-3: {floor[0]:.3g} ({floor[1]} at {floor[2]})')
    log(f'[multi cli] launches in {MULTI_XOR_ITERS} iterations: torchrun '
        f'{counts}, one process {plain_counts}')
    assert counts == plain_counts, \
        'the NCCL run launched other kernels than the one-process run'
    assert d <= CLI_TOL, 'the NCCL CLI run differs from the one-process run'
    out = dict(s_per_iter=spi, xor_rel=d, floor_rel=floor[0])
    text, (counts,), _, paired, secs = torchrun_cli(
        argv(rest['loop']['float32_yaml'], 'logs_multi_paired',
             MULTI_PAIRED_ITERS))
    steps = list(range(1, MULTI_PAIRED_ITERS + 1))
    assert [s for s, _ in paired['gen/total']] == steps
    d, name, st = _meter_distance(paired, rest['loop']['float32_series'],
                                  steps)
    log(f'[multi cli] paired float32 (phase 13\'s yaml: DiffAugment), '
        f'{MULTI_PAIRED_ITERS} iterations through torchrun in {secs:.1f} s: '
        f'meters against phase 13\'s float32 run max rel diff {d:.3g} '
        f'({name} at {st}; tolerance {CLI_TOL})')
    _check_counts(counts, PAIRED, XOR + GENERAL, 'NCCL paired')
    assert d <= CLI_TOL, 'the NCCL paired run differs from phase 13\'s'
    out.update(paired_rel=d)
    for logs in ('logs_multi_plain', 'logs_multi_nccl', 'logs_multi_paired'):
        shutil.rmtree(os.path.join(root, logs))
    return out


def _spawn_step_ranks(kind, work, timeout=900):
    """Two ranks of `--worker step <kind> <work>` sharing this card over
    gloo (NCCL refuses two ranks on one device); returns their results
    (`<work>/rank<r>.pt`)."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--worker', 'step', kind,
         work], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR=
                            'localhost', MASTER_PORT=port, RANK=str(r),
                            WORLD_SIZE='2', LOCAL_RANK='0'))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f'{kind} rank failed:\n{text[-4000:]}'
    import torch
    return [torch.load(os.path.join(work, f'rank{r}.pt'), weights_only=False)
            for r in range(2)]


def _hold_ranks(torch, tag, ref, m_ref, ranks, plain_counts, kl_half=False):
    """Two ranks' step (rank 0's parameters; both ranks' metrics and
    launches) against the one-process trainer `ref` after its step
    (metrics `m_ref`), with phase 7's twin tolerances: losses 1e-5
    relative, gradient norms 1e-4, parameters 1e-5 or 2 lr + 1e-5 where
    |grad| < 1e-5. With `kl_half` the ranks' `gen/kl` (a mean of their
    per-item sums) is held to half the batch-2 process's sum."""
    r0, r1 = ranks
    assert r0['metrics'] == r1['metrics'], f'{tag}: the ranks\' metrics differ'
    got = dict(r0['metrics'])
    want = dict(m_ref)
    if kl_half:
        kl_got, kl_want = got.pop('gen/kl'), want.pop('gen/kl') / 2
        kl_rel = abs(kl_got - kl_want) / abs(kl_want)
        log(f'[multi {tag}] gen/kl {kl_got:.6g}, half the one process\'s '
            f'{kl_want:.6g} (rel diff {kl_rel:.3g}, tolerance 1e-5 + 1e-6 '
            f'abs)')
        assert abs(kl_got - kl_want) <= 1e-5 * abs(kl_want) + 1e-6
    loss_rel, norm_rel, worst, loose, total, max_err = state_margins(
        torch, ref, want, r0['state'], got)
    log(f'[multi {tag}] against one process: losses max rel diff '
        f'{loss_rel:.3g} (tolerance 1e-5), gradient norms {norm_rel:.3g} '
        f'(1e-4); parameters max abs diff {max_err:.3g}, worst margin '
        f'{worst:.3g} (<= 0 passes; {loose} of {total} within 2 lr); '
        f'launches per step rank 0 {r0["counts"]}, rank 1 {r1["counts"]}')
    assert loss_rel <= 1e-5, f'{tag}: the losses differ'
    assert norm_rel <= 1e-4, f'{tag}: the gradient norms differ'
    assert worst <= 0, f'{tag}: the update differs'
    for r in ranks:
        assert r['counts'] == plain_counts, \
            f'{tag}: launches per step differ from the plain step\'s'


def multi_steps(torch, kernels, world, plain_counts, dev):
    """Phase 14 (b) and (c): two ranks sharing the card over gloo take one
    `train_step_shared` at the flagship training width, float32: (b) data
    2 (batch 1 each, deterministic sampling) against one process's batch-2
    step with the same draws; (c) data 1 x rays 2 (each rank renders 131
    of the 262 rows) against the rays=1 step, stochastic sampling from
    one seed."""
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    work = os.path.join(REPO, 'smoke_out', 'multi')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    voxel = torch.from_numpy(world.voxel).to(dev)
    out = {}
    for kind, b in (('dp', 2), ('rays', 1)):
        cfg = GeneratorConfig(coarse_deterministic_sampling=kind == 'dp')
        hw = TRAIN_CROP + cfg.pad
        batch = {k: v.cpu() for k, v in make_batch(
            world, batch_size=b, height=hw, width=hw,
            max_samples=cfg.num_blocks_early_stop, pad=cfg.pad, seed=SEED,
            device=dev, voxel=voxel).items()}
        eps = torch.randn((b, cfg.style_dims),
                          generator=torch.Generator().manual_seed(SEED))
        kdir = os.path.join(work, kind)
        os.makedirs(kdir)
        torch.save(dict(batch=batch, eps=eps, dims=tuple(world.dims)),
                   os.path.join(kdir, 'inputs.pt'))
        torch.cuda.empty_cache()
        t0 = time.time()
        ranks = _spawn_step_ranks(kind, kdir)
        wall = time.time() - t0
        # the one-process reference, after the ranks have left the card
        ref = make_trainer(cfg, world.dims, dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
        if kind == 'dp':
            # the KL term sums over the batch: the ranks mean their sums
            # (JAX's pmean, DDP), so one process takes half the weight
            ref.cfg.loss_weights = dict(ref.cfg.loss_weights)
            ref.cfg.loss_weights['kl'] /= 2
            m_ref = ref.train_step_shared(batch, style_eps=eps.to(dev))
        else:
            m_ref = ref.train_step_shared(
                batch, torch.Generator(device=dev).manual_seed(SEED))
        r0 = ranks[0]
        log(f'[multi {kind}] two ranks sharing one card over gloo (not a '
            f'scaling number): mesh {r0["mesh"]}, first step '
            f'{r0["step_s"]:.3f} / {ranks[1]["step_s"]:.3f} s (warm-up '
            f'included), second {r0["step2_s"]:.3f} / '
            f'{ranks[1]["step2_s"]:.3f} s, all-reducing '
            f'{r0["reduce_bytes"] / 1e6:.1f} MB a rank a step (one '
            f'all_reduce of that size alone {r0["reduce_s"]:.3f} / '
            f'{ranks[1]["reduce_s"]:.3f} s), peak {r0["peak_gb"]:.1f} / '
            f'{ranks[1]["peak_gb"]:.1f} GB; {wall:.1f} s with process start '
            f'and set-up')
        _hold_ranks(torch, kind, ref, m_ref, ranks, plain_counts,
                    kl_half=kind == 'dp')
        out[kind] = dict(counts=r0['counts'],
                         step_s=[r['step_s'] for r in ranks],
                         step2_s=[r['step2_s'] for r in ranks],
                         reduce_bytes=r0['reduce_bytes'],
                         reduce_s=[r['reduce_s'] for r in ranks],
                         peak_gb=[r['peak_gb'] for r in ranks])
        del ref, batch, ranks
        torch.cuda.empty_cache()
    del voxel
    shutil.rmtree(work)
    return out


def multi_render(torch, kernels, world, style, pose, tile_img, dev):
    """Phase 14 (d): mesh mode over [cuda:0] (the card's one device):
    `TiledRenderer(mesh=...)` on phase 4's pose against phase 12's
    padded-tile frame (tolerance 1e-3; expected equal), then
    `render_trajectory(mesh=...)` for 2 frames, its first within one uint8
    step of it."""
    import numpy as np
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                        render_trajectory,
                                                        to_uint8)
    cfg = GeneratorConfig(num_samples=SAMPLES, num_blocks_early_stop=M)
    model = SceneDreamerGenerator(cfg, seed=SEED).to(dev).eval()
    kw = dict(num_samples=SAMPLES, num_blocks_early_stop=M, pad=PAD,
              resolution_hw=RES, tile_size=TILE)
    r = TiledRenderer(model, world, mesh=[dev], **kw)
    assert not r.split_refine
    secs, img, counts, peak = _warm_timed(torch, kernels, r, pose,
                                          r.style_z(style.numpy()))
    st = r.last_stats
    err = float(np.abs(img - tile_img).max())
    field_tiles = st['tiles'] - st['tiles_sky_only']
    log(f'[multi mesh] TiledRenderer(mesh=[{dev}]): {secs:.3f} s/frame, peak '
        f'{peak:.1f} GB, {st["tiles"]} tiles ({st["tiles_sky_only"]} sky '
        f'only), launches {counts}; image max abs diff from phase 12\'s '
        f'padded-tile frame {err:.3g} (tolerance 1e-3)')
    assert err <= 1e-3, 'the mesh frame differs from the padded-tile frame'
    assert counts['dda'] == 1 and counts['hash_bake'] == 1
    assert counts['hash_encode'] == field_tiles
    out_dir = os.path.join(REPO, 'smoke_out', 'multi_render')
    frames = render_trajectory(model, world, style, out_dir, camera_mode=4,
                               cam_maxstep=2, cam_ang=72, mesh=[dev], **kw)
    step = int(np.abs(frames[0].astype(int)
                      - to_uint8(tile_img).astype(int)).max())
    log(f'[multi mesh] render_trajectory(mesh=[{dev}]): {len(frames)} '
        f'frames; frame 0 against phase 12\'s frame: max uint8 step {step}')
    assert len(frames) == 2 and step <= 1
    shutil.rmtree(out_dir)
    return dict(s_per_frame=secs, err=err)


def multi_gpu(torch, kernels, world, style, pose, tile_img, loop, rest, dev):
    """Phase 14, multi-GPU: (a) the CLI over NCCL at world size 1, (b)
    data-parallel and (c) row-parallel ranks over gloo on the one card,
    (d) mesh-mode serving over [cuda:0]."""
    t_phase = time.time()
    cli = multi_cli(torch, kernels, loop, rest)
    steps = multi_steps(torch, kernels, world,
                        rest['amp']['float32']['counts'], dev)
    render = multi_render(torch, kernels, world, style, pose, tile_img, dev)
    log(f'[multi] phase 14 in {time.time() - t_phase:.1f} s')
    return dict(cli=cli, steps=steps, render=render,
                dp_counts=steps['dp']['counts'],
                rays_counts=steps['rays']['counts'])


def worker(args):
    """A child of phase 14: `cli <argv>` runs `cli.train.main(argv)` (under
    torchrun) and prints its launch counts; `step dp|rays <dir>` is one
    rank of two (env:// rendezvous over gloo on this card) taking one
    `train_step_shared` and writing `<dir>/rank<r>.pt`."""
    import torch
    sys.path.insert(0, REPO)
    from scenedreamer_tpu_torch import kernels
    float32_exact(torch)
    if args[0] == 'cli':
        from scenedreamer_tpu_torch.cli import train as cli
        kernels.reset_launch_counts()
        cli.main(args[1:])
        torch.cuda.synchronize()
        log('[worker] launches ' + json.dumps(kernels.launch_counts()))
        return 0
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    from scenedreamer_tpu_torch.parallel import mesh as pm
    kind, work = args[1], args[2]
    rank, world = pm.init_distributed('cuda', backend='gloo')
    dev = torch.device('cuda')
    inp = torch.load(os.path.join(work, 'inputs.pt'), weights_only=False)
    mesh = pm.make_mesh(rays=2 if kind == 'rays' else 1)
    cfg = GeneratorConfig(coarse_deterministic_sampling=kind == 'dp')
    trainer = make_trainer(cfg, inp['dims'], dev)
    trainer.mesh = mesh
    pm.replicate(trainer.gen)
    pm.replicate(trainer.dis)
    batch = {k: v.to(dev) for k, v in inp['batch'].items()}
    if kind == 'dp':
        batch = pm.shard_batch(mesh, batch)
        kw = dict(style_eps=inp['eps'][rank:rank + 1].to(dev))
    else:
        kw = dict(generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    metrics = trainer.train_step_shared(batch, **kw)
    torch.cuda.synchronize()
    step_s = time.time() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pm.check_replicated(trainer.gen, trainer.dis)
    state = {'gen': {k: v.cpu() for k, v in trainer.gen.state_dict().items()},
             'dis': {k: v.cpu() for k, v in trainer.dis.state_dict().items()}}
    # a second step, past the first one's warm-up (allocator, cuDNN and
    # cuBLAS set-up), for the steady time only
    t0 = time.time()
    trainer.train_step_shared(batch, **kw)
    torch.cuda.synchronize()
    step2_s = time.time() - t0
    # float32 gradients and metrics of both updates, the D update's
    # spectral-norm buffers too; then the same all_reduce alone
    n = (sum(p.numel() for o in (trainer.g_opt, trainer.d_opt)
             for p in o.params) + len(metrics)
         + sum(b.numel() for b in trainer.dis.buffers()))
    flat = torch.zeros(n, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    torch.distributed.all_reduce(flat)
    torch.cuda.synchronize()
    out = dict(metrics=metrics, counts=counts, step_s=step_s,
               step2_s=step2_s, peak_gb=peak_gb, reduce_bytes=4 * n,
               reduce_s=time.time() - t0, mesh=mesh.shape)
    if rank == 0:
        out['state'] = state
    torch.save(out, os.path.join(work, f'rank{rank}.pt'))
    torch.distributed.destroy_process_group()
    return 0


def split_extra(split):
    """The `kernels` row fields of a scatter's per-level split: the whole
    launch with every level direct (before the coarse path) in ray order,
    and the number of levels on the coarse path."""
    return dict(ms_before=split['total']['ray'][0],
                coarse_levels=sum(r['coarse'] for r in split['levels']))


def kernel_rows(serving, k3, k3_split, train, k5, k5_split, k5b, loop):
    """The `kernels` JSON rows: K1, K2a, K2b on the serving path, K3a-c
    on the training path and K5a-d on the training loop's paired run,
    each read from the kernel's own counter; K5b also at phase 3's
    serving chunk (`k5b`, phase 8's split: the whole launch in ray order,
    under `serving_chunk_ms`). `launches` is the count of
    the path the kernel was ported for: serving for K1/K2, the training
    step for K3 (K3b is K2a's kernel on G, counted as 'hash_bake_bwd'),
    the paired loop run for K5 (K5d's table half is K5a's kernel on G
    with the inverse shifts, counted as 'hash_shift_bake_bwd')."""
    counts, tcounts = serving['counts'], train['counts']
    lcounts, xcounts = loop['counts'], loop['xor_counts']

    def row(name, source, replaces, err, ms, plain, bound, by, path,
            **extra):
        per_loop = xcounts[name] / loop['xor_iterations'] if name in XOR \
            else lcounts[name] / loop['iterations']
        return dict(name=name, route='cuda', source=source,
                    replaces=replaces, launches=path[name], max_abs_err=err,
                    ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                    library_ms=None,
                    launches_per_frame=counts[name] / serving['n_frames'],
                    launches_per_step=tcounts[name] / train['steps'],
                    launches_per_loop_iteration=per_loop, **extra)

    ms, errs, extra = serving['ms'], serving['errs'], serving['extra']
    fwd = 'scenedreamer_tpu_torch/csrc/hashgrid_fwd.cu'
    bwd = 'scenedreamer_tpu_torch/csrc/hashgrid_bwd.cu'
    paired = 'scenedreamer_tpu_torch/csrc/hashgrid_paired.cu'
    jax_hg = 'scenedreamer_tpu/ops/hashgrid.py'
    return [
        row('dda', 'scenedreamer_tpu_torch/csrc/dda.cu',
            'scenedreamer_tpu/ops/ray_voxel.py:456', errs['dda'],
            *ms['dda'], counts, **extra['dda']),
        row('hash_bake', fwd, f'{jax_hg}:626',
            errs['hash_bake'], *ms['hash_bake'], counts),
        row('hash_encode', fwd, f'{jax_hg}:848',
            errs['hash_encode'], *ms['hash_encode'], counts,
            **extra['hash_encode']),
        row('hash_encode_bwd', bwd, f'{jax_hg}:361',
            *k3['hash_encode_bwd'], tcounts, points=k3['points'],
            **split_extra(k3_split)),
        row('hash_bake_bwd', fwd, f'{jax_hg}:642',
            *k3['hash_bake_bwd'], tcounts),
        row('hash_bake_dw', bwd, f'{jax_hg}:642',
            *k3['hash_bake_dw'], tcounts),
        row('hash_shift_bake', paired, f'{jax_hg}:664',
            *k5['hash_shift_bake'], lcounts),
        row('hash_encode_paired', paired, f'{jax_hg}:458',
            *k5['hash_encode_paired'], lcounts, points=k5['points'],
            serving_chunk_ms=k5b['chunk']['total']['ray']),
        row('hash_encode_paired_bwd', paired, f'{jax_hg}:427',
            *k5['hash_encode_paired_bwd'], lcounts, points=k5['points'],
            **split_extra(k5_split)),
        row('hash_shift_bake_bwd', paired, f'{jax_hg}:642',
            *k5['hash_shift_bake_bwd'], lcounts),
        row('hash_shift_bake_dw', paired, f'{jax_hg}:642',
            *k5['hash_shift_bake_dw'], lcounts),
    ]


def general_rows(k4, k4_split, k4c, render, step, loop):
    """The `kernels` JSON rows of K4 (a) and (b): `launches` from the
    path each was ported for (the unfolded serving frame for (a), the
    unfolded training loop for (b)), per-frame / per-step / per-loop-
    iteration counts from phase 11; (a) at the training points and, under
    `at_serving_chunk`, at phase 3's serving chunk (`k4c`: points and the
    forward's error, ms, plain ms, bound ms, bound by)."""
    src = 'scenedreamer_tpu_torch/csrc/hashgrid_general.cu'
    jax_hg = 'scenedreamer_tpu/ops/hashgrid.py'
    out = []
    for name, replaces, path in (
            ('hash_encode_general', f'{jax_hg}:982', render),
            ('hash_encode_general_bwd', f'{jax_hg}:361', loop)):
        err, ms, plain, bound, by = k4[name]
        out.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=path['counts'][name], max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None,
            launches_per_frame=render['counts'][name] / render['n_frames'],
            launches_per_step=step['counts'][name] / step['steps'],
            launches_per_loop_iteration=(loop['counts'][name]
                                         / loop['iterations']),
            points=k4['points'],
            **(split_extra(k4_split) if name.endswith('_bwd') else
               dict(at_serving_chunk=dict(zip(
                   ('points', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                    'bound_by'), k4c))))))
    return out


def float32_exact(torch):
    """TF32 off for matmuls and convolutions, as the JAX package's
    float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    if sys.argv[1:2] == ['--worker']:
        return worker(sys.argv[2:])
    sys.path.insert(0, REPO)
    import numpy as np
    from scenedreamer_tpu_torch import kernels
    from scenedreamer_tpu_torch.data.synthetic import make_batch
    from scenedreamer_tpu_torch.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from scenedreamer_tpu_torch.ops import hashgrid as hg
    from scenedreamer_tpu_torch.ops.ray_voxel import (build_occupancy_bits,
                                                      dda_plain)
    from scenedreamer_tpu_torch.render.pipeline import (TiledRenderer,
                                                        render_trajectory,
                                                        to_uint8)
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world

    t_start = time.time()
    float32_exact(torch)
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
        for kernel, report in ptxas_report(text):
            log(f'[build] {name}: {kernel}: {report}')

    # 2. K1 vs plain -------------------------------------------------------
    t0 = time.time()
    maps = generate_terrain(size=SCENE, seed=SEED)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=SEED)
    log(f'[world] scene {SCENE} seed {SEED}: grid {world.dims} '
        f'in {time.time() - t0:.1f} s')
    voxel = torch.from_numpy(world.voxel).to(dev)
    h, w = RES[0] + PAD, RES[1] + PAD
    ctl, rays, ori_t = frame_rays(torch, world, dev)
    occ = build_occupancy_bits(voxel)
    p_vid, p_dep, p_hit, p_steps = dda_plain(voxel, ori_t, rays, M,
                                             with_steps=True)
    # the main path's form (8x4 tiles), then flat order, each with the
    # world's brick bits and held equal to the plain version
    for how, width in (('skip, 8x4 tiles', w), ('skip, flat order', None)):
        k_vid, k_dep, k_hit, k_steps = kernels.dda(
            voxel, ori_t, rays, M, sum(world.dims) + 2, with_steps=True,
            occupancy=occ, image_width=width)
        torch.cuda.synchronize()
        assert torch.equal(k_vid, p_vid), f'K1 ({how}) ids differ from plain'
        assert torch.equal(k_hit, p_hit), f'K1 ({how}) hits differ from plain'
        assert torch.equal(k_steps, p_steps), f'K1 ({how}) step counts differ'
        dda_err = float((k_dep - p_dep).abs().max())
        log(f'[K1] {rays.shape[0]} rays ({how}): ids/hits/steps equal, depth '
            f'max abs diff {dda_err:.3g}, rays with a hit '
            f'{float(k_hit[:, 0].float().mean()):.3f}, steps mean '
            f'{float(k_steps.float().mean()):.1f} max {int(k_steps.max())}')
        assert dda_err == 0.0, f'K1 ({how}) depth differs from plain'
    # the training sampler's round: its proposals' rays in one launch
    prays, poris, (ph, pw) = proposal_rays(torch, world, dev)
    prays = prays.reshape(-1, 3).contiguous()
    got = kernels.dda(voxel, poris, prays, M, sum(world.dims) + 2,
                      with_steps=True, occupancy=occ, image_width=pw)
    want = dda_plain(voxel, poris, prays, M, with_steps=True)
    for name, a, b in zip(('ids', 'depth', 'hits', 'steps'), got, want):
        assert torch.equal(a, b), f'K1 ({PROPOSALS} origins) {name} differ'
    log(f'[K1] {PROPOSALS} sampler proposals of {ph}x{pw} rays in one launch '
        f'({PROPOSALS} origins, skip, 8x4 tiles): ids/depth/hits/steps equal '
        f'to the plain version, rays with a hit '
        f'{float(got[2][:, 0].float().mean()):.3f}, steps mean '
        f'{float(got[3].float().mean()):.1f} max {int(got[3].max())}')
    for name, st, hh, ww in (('frame', k_steps, h, w),
                             (f'{PROPOSALS} proposals', got[3], ph, pw)):
        lr, tr = step_ratios(torch, st, hh, ww)
        log(f'[K1 shapes] {name}: per-warp issued / needed axis steps, launch '
            f'order {lr:.3f}, 8x4 tiles {tr:.3f}')
    del prays, poris, got, want, p_vid, p_dep, p_hit, p_steps

    # 3. K2 vs plain -------------------------------------------------------
    cfg = GeneratorConfig(num_samples=SAMPLES, num_blocks_early_stop=M)
    spec = cfg.hash_spec
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((spec.table_size, spec.level_dim), generator=gen,
                       device=dev) * 2 - 1
    model = SceneDreamerGenerator(cfg, seed=SEED).to(dev).eval()
    fields = (torch.from_numpy(world.height_field.transpose(0, 2, 3, 1))
              .to(dev),
              torch.from_numpy(world.semantic_field.transpose(0, 2, 3, 1))
              .to(dev))
    with torch.no_grad():
        scene = model.world_code(*fields)[0]
    xyz, rows = chunk_points(torch, rays, ori_t, k_dep, k_hit, world.dims)
    chunk = xyz
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
    for img in frames:      # the uint8 frames written, as JAX returns
        assert img.shape == RES + (3,) and img.dtype == np.uint8, \
            (img.shape, img.dtype)
    for name in ('dda', 'hash_bake', 'hash_encode'):
        assert counts[name] > 0, f'kernel {name} never launched on the main path'
    for name in ('hash_encode_bwd', 'hash_bake_bwd', 'hash_bake_dw'):
        assert counts[name] == 0, f'the serving path launched {name}'

    renderer = TiledRenderer(model, world, num_samples=SAMPLES,
                             num_blocks_early_stop=M, pad=PAD,
                             resolution_hw=RES, device=dev)
    z = renderer.style_z(style.numpy())
    # steady state, the sky skip and compaction on (the defaults), then
    # one frame with both off: every chunk through the field
    frame_s, shots = [], []
    for i, pose in enumerate(ctl):
        secs, img, aux = timed_frame(torch, renderer, pose, z)
        assert np.isfinite(img).all(), 'non-finite frame'
        assert np.abs(img).max() <= 1.0, 'frame outside [-1, 1]'
        assert np.abs(to_uint8(img).astype(int) - frames[i]).max() <= 1, \
            'the float frame does not give the trajectory\'s uint8 frame'
        frame_s.append(secs)
        shots.append((img, aux, dict(renderer.last_stats)))
        log_frame_stats('on', renderer.last_stats, secs)
    spf = statistics.mean(frame_s)
    os.environ['SCENEDREAMER_FIELD_COMPACT'] = '0'
    try:
        full = TiledRenderer(model, world, num_samples=SAMPLES,
                             num_blocks_early_stop=M, pad=PAD,
                             resolution_hw=RES, device=dev, sky_fast=False)
    finally:
        del os.environ['SCENEDREAMER_FIELD_COMPACT']
    off_s, img_off, aux_off = timed_frame(torch, full, ctl[0], z)
    log_frame_stats('off', full.last_stats, off_s)
    stats_off = dict(full.last_stats)
    del full
    img_on, aux_on, stats_on = shots[0]
    frame_err = float(np.abs(img_on - img_off).max())
    d_on, d_off = aux_on['depth'], aux_off['depth']
    fin = np.isfinite(d_off)
    same_sky = bool((np.isfinite(d_on) == fin).all())
    depth_err = float(np.abs(d_on[fin] - d_off[fin]).max()) if fin.any() \
        else 0.0
    log(f'[main] compaction on against off, frame 0: image max abs diff '
        f'{frame_err:.3g} (tolerance 1e-3, the frames\' limit: the field\'s '
        f'GEMMs run on fewer rows and may round otherwise), depth max abs '
        f'diff where finite {depth_err:.3g} (tolerance 1e-3), inf on the '
        f'same rays: {same_sky}')
    assert frame_err <= 1e-3, 'the compacted frame differs from the full one'
    assert same_sky, 'compaction changed which rays see only sky'
    assert depth_err <= 1e-3, 'the compacted depth differs from the full one'
    assert stats_on['field_rays'] < stats_off['field_rays'], \
        'compaction evaluated every ray'
    log(f'[main] steady state: {spf:.3f} s/frame ({frame_s}), '
        f'{h * w / spf:.0f} rays/s at {h}x{w} rays, {RES[0]}x{RES[1]} '
        f'output, {SAMPLES} samples; compaction and sky skip off '
        f'{off_s:.3f} s/frame')

    # 5. kernel timings ----------------------------------------------------
    n_frames = len(frames)
    r_rays = rays.shape[0]
    max_steps = sum(world.dims) + 2
    # K1 as the main path launches it: the skip and 8x4 tiles
    dda_ms = median_ms(lambda: kernels.dda(voxel, ori_t, rays, M, max_steps,
                                           occupancy=occ, image_width=w))
    dda_plain_ms = median_ms(lambda: dda_plain(voxel, ori_t, rays, M))
    steps_total = int(k_steps.sum())
    hits_total = int(k_hit.sum())
    dda_bound, dda_by = k1_bound(steps_total, hits_total, r_rays)
    k1 = k1_shapes(torch, kernels, world, voxel, rays, ori_t, (h, w), dev)
    k1_loop = dict(
        one_proposal_ms=k1['shapes']['(c) one proposal']['skip'],
        one_proposal_bound_ms=k1['proposal_bound'][0],
        proposals=k1['proposals'],
        proposals_one_launch_ms=k1['shapes'][
            f'(e) {k1["proposals"]} proposals, one launch']['skip'],
        proposals_one_launch_bound_ms=k1['proposals_bound'][0],
        proposals_one_launch_no_skip_ms=k1['shapes'][
            f'(e) {k1["proposals"]} proposals, one launch']['no_skip'],
        frame_no_skip_ms=k1['shapes']['(a) frame']['no_skip'],
        occupancy_build_ms=k1['occupancy_build_ms'])
    bake_ms = median_ms(lambda: kernels.hash_bake(table3, masks32,
                                                  weights.contiguous()))
    bake_plain_ms = median_ms(lambda: hg.bake_plain(table3, masks, weights))
    tbytes = table3.numel() * 4
    bake_bound, bake_by = bound_ms(2 * tbytes, table3.numel() * 4 * 2)
    enc_ms = median_ms(lambda: kernels.hash_encode(
        k_baked, xyz, scales, offset, 1.0, scene_oob))
    enc_plain_ms = median_ms(lambda: hg.encode_plain(
        p_baked, xyz, scales, offset, 1.0, scene_oob))
    k2_split = k2_levels(torch, kernels, hg, k_baked, xyz, scales, offset,
                         scene_oob, dev)
    # distinct baked rows this chunk reads, per level (each read once)
    rows_read = sum(r['distinct'] for r in k2_split['levels'])
    row_bytes = spec.level_dim * 4
    out_bytes = n_pts * spec.output_dim * 4
    enc_bound, enc_by = bound_ms(
        n_pts * 12 + rows_read * row_bytes + out_bytes,
        n_pts * spec.num_levels * 8 * (2 * spec.level_dim + 3))
    # the gather traffic as issued: 8 random 32-byte rows per point and
    # level, plus the output
    gather_ms = (out_bytes
                 + sum(r['issued'] for r in k2_split['levels']) * 32) \
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
        extra=dict(dda=dict(rays=r_rays, axis_steps=steps_total, **k1_loop),
                   hash_encode=dict(points=n_pts, gather_bound_ms=gather_ms)))
    del table, k_baked, p_baked, k_enc, p_enc, table3, renderer, model
    torch.cuda.empty_cache()

    # 6. K3 vs plain -------------------------------------------------------
    tcfg = GeneratorConfig()
    hw = TRAIN_CROP + tcfg.pad
    batch = make_batch(world, batch_size=1, height=hw, width=hw,
                       max_samples=tcfg.num_blocks_early_stop, pad=tcfg.pad,
                       seed=SEED, device=dev, voxel=voxel)
    k3 = backward_check(torch, kernels, hg, tcfg, batch, world.dims, dev,
                        'K3')
    torch.cuda.empty_cache()
    k3_split = k3_levels(torch, kernels, hg, tcfg.hash_spec,
                         sample_points(batch, tcfg, world.dims), dev)
    torch.cuda.empty_cache()

    # 7. the training path -------------------------------------------------
    train = train_path(torch, kernels, tcfg, world, voxel, dev)
    torch.cuda.empty_cache()
    train_compact(torch, tcfg, world, voxel, dev)
    torch.cuda.empty_cache()

    # 8. K5 vs plain -------------------------------------------------------
    pcfg = GeneratorConfig(hash_variant='paired')
    k5 = backward_check(torch, kernels, hg, pcfg, batch, world.dims, dev,
                        'K5')
    torch.cuda.empty_cache()
    k5_split = k3_levels(torch, kernels, hg, pcfg.hash_spec,
                         sample_points(batch, pcfg, world.dims), dev)
    torch.cuda.empty_cache()
    k5b = paired_levels(torch, kernels, hg, pcfg, batch, fields, world.dims,
                        chunk, dev)
    torch.cuda.empty_cache()

    # 9. the training loop -------------------------------------------------
    loop = loop_path(torch, kernels, world, dev)

    # 10. K4 vs plain ------------------------------------------------------
    from scenedreamer_tpu_torch.ops.encoders import get_encoder
    ucfg = GeneratorConfig(num_samples=SAMPLES, num_blocks_early_stop=M,
                           hash_log2_size=LOG2_UNFOLDED)
    uspec = ucfg.hash_spec
    assert not hg.foldable(uspec), 'the log2-21 spec must not be foldable'
    umodel = SceneDreamerGenerator(ucfg, seed=SEED).to(dev).eval()
    with torch.no_grad():
        code = umodel.world_code(batch['height_field'],
                                 batch['semantic_field'])[0]
    xyz = sample_points(batch, tcfg, world.dims)
    pts = torch.cat([xyz, code.expand(xyz.shape[0], 2)], dim=-1).contiguous()
    log(f'[K4] scene code of the training batch {code.tolist()}')
    k4 = general_check(torch, kernels, hg, uspec, pts, dev, 'K4',
                       timing=True)
    torch.cuda.empty_cache()
    k4_split = k4_levels(torch, kernels, hg, uspec, pts, dev)
    torch.cuda.empty_cache()
    k4a_levels(torch, kernels, hg, uspec, pts, dev, 'train')
    del xyz, pts
    # K4a on phase 3's serving chunk with the serving world's scene code
    with torch.no_grad():
        scode = umodel.world_code(*fields)[0]
    cpts = torch.cat([chunk, scode.expand(chunk.shape[0], 2)],
                     dim=-1).contiguous()
    k4c = general_forward(torch, kernels, hg, uspec, torch.rand(
        (uspec.table_size, uspec.level_dim), generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev) * 2 - 1, cpts,
        'K4 chunk', timing=True)
    k4a_levels(torch, kernels, hg, uspec, cpts, dev, 'chunk')
    chunk_n = chunk.shape[0]
    del cpts, chunk
    torch.cuda.empty_cache()
    _, _, tspec = get_encoder('tiledgrid', input_dim=3, level_dim=2,
                              align_corners=True)
    tpts = torch.rand((1 << 20, 3), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 2.1 - 1.05
    k4t = general_check(torch, kernels, hg, tspec, tpts, dev, 'K4 tiled')
    fn, _, _ = get_encoder('tiledgrid', input_dim=3, level_dim=2,
                           align_corners=True)
    ttab = torch.rand((tspec.table_size, 2), device=dev) * 2 - 1
    direct = kernels.hash_encode_general(ttab, tpts,
                                         *hg.general_meta(tspec),
                                         hg._offset(tspec), 1.0, True)
    assert torch.equal(fn(ttab, tpts), direct), \
        'get_encoder does not run the kernel'
    del tpts, ttab, direct
    torch.cuda.empty_cache()

    # 11. the paths through K4 ---------------------------------------------
    urender = general_render(torch, kernels, umodel, world, style, dev)
    del umodel
    torch.cuda.empty_cache()
    ustep = general_train(torch, kernels,
                          GeneratorConfig(hash_log2_size=LOG2_UNFOLDED),
                          world, voxel, dev)
    del batch, voxel
    torch.cuda.empty_cache()
    uloop = general_loop(torch, kernels)

    # 12. the rest of serving ------------------------------------------------
    padded = serve_rest(torch, kernels, world, style, ctl[0], img_on,
                        loop['xor_checkpoints'], dev)

    # 13. the rest of training -----------------------------------------------
    rest = rest_of_training(torch, kernels, world, style, ctl[0], dev)

    # 14. multi-GPU ------------------------------------------------------------
    multi = multi_gpu(torch, kernels, world, style, ctl[0], padded['img'],
                      loop, rest, dev)

    table_rows = kernel_rows(serving, k3, k3_split, train, k5, k5_split,
                             k5b, loop) \
        + general_rows(k4, k4_split, (int(chunk_n), *k4c), urender, ustep,
                       uloop)
    amp_counts = {**rest['amp']['amp']['counts'],
                  **{k: v for k, v in rest['amp']['paired_counts'].items()
                     if k in PAIRED}}
    for row in table_rows:
        row['launches_per_padded_tile_frame'] = {
            f'tiles_per_batch_{tb}': counts[row['name']]
            for tb, counts in padded['counts'].items()}
        row['launches_per_amp_step'] = amp_counts[row['name']]
        row['launches_per_dp_step'] = multi['dp_counts'][row['name']]
        row['launches_per_rays_step'] = multi['rays_counts'][row['name']]
    log(json.dumps({'kernels': table_rows}))

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f'[smoke] phases 1-14 in {time.time() - t_start:.1f} s')
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
