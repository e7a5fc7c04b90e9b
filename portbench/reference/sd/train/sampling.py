"""Training-batch assembly: rejection-sampled cameras + pseudo ground
truth + mask translation.

Counterpart of `scenedreamer_tpu/train/sampling.py` (reference
`imaginaire/generators/scenedreamer.py:80-283` _get_batch / get_pseudo_gt
/ sample_camera, invoked outside autograd from
`trainers/gancraft.py:139-156`):

  * 'traditional' camera sampler: 50% tour poses / 50% third-person
    poses with randomized focal length, principal-point jitter
    emulating a random crop of a 360x640 virtual sensor
  * rejection on mean hit depth < 2.0 and first-hit label entropy
    < 0.75
  * pseudo-GT: first-hit mc labels -> coco(183+1), stochastic
    sky->clouds/fog and water->sea/river relabeling, one-hot 185ch,
    SPADE oracle at 512x512, NaN/Inf scrub, area-resize back, clamp
  * reduced(12)-label one-hot masks for D, label smoothing (11x11
    window mean + argmax) on both fake and real masks

Camera proposals and the accept/reject loop run on the host with a numpy
generator, in the JAX package's order of draws, so one seed gives both
packages the same cameras. The ray-voxel intersection (kernel K1 on
CUDA: the K proposals of a round in one launch, as the JAX package vmaps
them into one dispatch), the accept metrics, SPADE, the label
translation and the smoothing run on the models' device, without
gradients. Tensors are NHWC.
"""
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.sd.ops.masks import rand_crop, segmask_smooth
from portbench.reference.sd.ops.ray_voxel import (build_occupancy_bits,
                                                  camera_rays,
                                                  ray_voxel_intersection)
from portbench.reference.sd.ops.resize import resize_bilinear, resize_nearest
from portbench.reference.sd.scene import camera as camctl
from portbench.reference.sd.scene.labels import (NUM_MC_LABELS,
                                                 get_label_translator)


@dataclasses.dataclass
class CameraSamplerConfig:
    """configs/scenedreamer_train.yaml:118-149."""
    cam_res: tuple = (360, 640)
    crop_size: tuple = (256, 256)
    pad: int = 6
    num_blocks_early_stop: int = 6
    camera_sampler_type: str = 'traditional'
    camera_rej_avg_depth: float = 2.0
    camera_min_entropy: float = 0.75
    max_rejections: int = 100
    # proposals intersected per round, in one K1 launch: their accept
    # metrics come back in one [2, K] device->host fetch (accept
    # semantics unchanged: the first passing proposal in proposal order
    # wins)
    proposals_per_dispatch: int = 4
    num_reduced_labels: int = 12
    use_label_smooth: bool = True
    use_label_smooth_real: bool = True
    use_label_smooth_pgt: bool = True
    label_smooth_dia: int = 11


def accept_metrics(voxel_id, depth, hit_mask):
    """Mean first-hit depth over the rays that hit, and the entropy of
    the first-hit label histogram (680 bins), as 0-d tensors."""
    d0 = depth[..., 0, 0]
    valid = hit_mask[..., 0]
    nvalid = valid.sum()
    avg_depth = torch.where(
        nvalid > 0,
        torch.where(valid, d0, torch.zeros_like(d0)).sum()
        / nvalid.clamp(min=1), torch.zeros((), device=d0.device))
    first = voxel_id[..., 0].reshape(-1).long()
    cnt = torch.bincount(first, minlength=NUM_MC_LABELS).to(torch.float32) \
        / first.numel()
    entropy = -(cnt * torch.log(cnt + 1e-10)).sum()
    return avg_depth, entropy


class CameraBatchSampler:
    """Host-side rejection sampler producing ray batches for one world."""

    def __init__(self, cfg: CameraSamplerConfig = CameraSamplerConfig(),
                 device='cpu'):
        self.cfg = cfg
        self.device = torch.device(device)
        self.trans = get_label_translator()
        c = cfg
        self.crop_res = (c.crop_size[0] + c.pad, c.crop_size[1] + c.pad)
        # accept/fallback accounting: the reference retries forever
        # (`scenedreamer.py:95-145` while True); retries are bounded here,
        # so cameras admitted past max_rejections must be observable: the
        # training CLI writes fallback_rate through MetricsWriter
        self.stats = {'proposals': 0, 'accepted': 0, 'fallbacks': 0}

    @property
    def fallback_rate(self):
        """Fraction of admitted cameras that exhausted max_rejections."""
        n = self.stats['accepted'] + self.stats['fallbacks']
        return self.stats['fallbacks'] / n if n else 0.0

    def _propose(self, world, rng):
        """One camera proposal (`scenedreamer.py:95-120`)."""
        c = self.cfg
        h, w = c.cam_res
        cam_c = ((h - 1) / 2.0, (w - 1) / 2.0)
        if c.camera_sampler_type == 'traditional' and rng.random() > 0.5:
            ori, cdir, up, f = camctl.rand_camera_pose_tour(world, rng)
            cam_f = f * (w - 1)
        else:
            ori, cdir, up = camctl.rand_camera_pose_thirdperson2(
                world, rng)[:3]
            cam_f = 0.5 / np.tan(np.deg2rad(73 / 2)
                                 * (rng.random() * 0.5 + 0.5)) * (w - 1)
        cam_c = rand_crop(rng, cam_c, c.cam_res, self.crop_res)
        return ori, cdir, up, cam_f, cam_c

    def _intersect(self, voxel, props, occupancy):
        """Rays, intersections and accept metrics of a round's proposals,
        all traced in one `ray_voxel_intersection` call over the grid
        `voxel` and its `build_occupancy_bits`; each proposal's
        numbers are rounded to float32 first, as the JAX package hands
        them to its device program. Returns [((vid, dep, hit, rd, ori),
        (avg_depth, entropy))] in proposal order."""
        h, w = self.crop_res
        oris = np.stack([np.asarray(p[0], np.float32) for p in props])
        rds = torch.stack([
            camera_rays(np.asarray(cdir, np.float32),
                        np.asarray(up, np.float32), float(np.float32(cam_f)),
                        tuple(float(np.float32(v)) for v in cam_c),
                        self.crop_res, device=self.device)
            for _, cdir, up, cam_f, cam_c in props])
        vid, dep, hit = ray_voxel_intersection(
            voxel, torch.from_numpy(oris).to(self.device), rds.reshape(-1, 3),
            self.cfg.num_blocks_early_stop, occupancy=occupancy,
            image_width=w)
        m = vid.shape[-1]
        vid = vid.reshape(len(props), h * w, m)
        dep = dep.reshape(len(props), h * w, m, 2)
        hit = hit.reshape(len(props), h * w, m)
        return [((vid[i], dep[i], hit[i], rds[i], oris[i]),
                 accept_metrics(vid[i], dep[i], hit[i]))
                for i in range(len(props))]

    @torch.no_grad()
    def sample(self, world, batch_size, rng, voxel_dev=None):
        """Rejection-sample batch_size cameras against one world
        (`voxel_dev`: its grid already on the device), building the
        grid's brick occupancy once for all of them.

        Returns dict: voxel_id [B,h,w,M], depth [B,h,w,M,2], hit_mask,
        raydirs [B,h,w,3], cam_ori [B,3] (NHWC tensors on the device).
        """
        c = self.cfg
        h, w = self.crop_res
        k = max(1, c.proposals_per_dispatch)
        voxel = torch.from_numpy(world.voxel).to(self.device) \
            if voxel_dev is None else voxel_dev
        occupancy = build_occupancy_bits(voxel)
        out = {kk: [] for kk in ('voxel_id', 'depth', 'hit_mask',
                                 'raydirs', 'cam_ori')}
        for _ in range(batch_size):
            accepted = None
            best = None              # (score, tensors) across all rounds
            rounds = max(1, -(-c.max_rejections // k))
            for _round in range(rounds):
                props = [self._propose(world, rng) for _ in range(k)]
                results = self._intersect(voxel, props, occupancy)
                self.stats['proposals'] += k
                # reject: too close (`scenedreamer.py:129-133`) or low
                # entropy (`:136-143`); ONE [2, K] device->host fetch
                ad, en = torch.stack(
                    [torch.stack(m) for _, m in results], dim=1) \
                    .cpu().numpy()
                ok = np.ones(k, bool)
                if c.camera_rej_avg_depth > 0:
                    ok &= ad >= c.camera_rej_avg_depth
                if c.camera_min_entropy > 0:
                    ok &= en >= c.camera_min_entropy
                if ok.any():
                    accepted = results[int(np.argmax(ok))][0]
                    self.stats['accepted'] += 1
                    break
                # remember the best rejected proposal: passing depth
                # outranks entropy (too-close views are the worse
                # failure mode), then higher entropy wins
                depth_ok = (ad >= c.camera_rej_avg_depth
                            if c.camera_rej_avg_depth > 0
                            else np.ones(k, bool))
                for i in range(k):
                    score = (bool(depth_ok[i]), float(en[i]))
                    if best is None or score > best[0]:
                        best = (score, results[i][0])
            if accepted is None:
                # max_rejections exhausted: admit the BEST proposal seen
                # and count it (the reference would spin forever here)
                accepted = best[1]
                self.stats['fallbacks'] += 1
            vid_i, dep_i, hit_i, rd_i, ori_i = accepted
            out['voxel_id'].append(vid_i.reshape(h, w, -1))
            out['depth'].append(dep_i.reshape(h, w, -1, 2))
            out['hit_mask'].append(hit_i.reshape(h, w, -1))
            out['raydirs'].append(rd_i)
            out['cam_ori'].append(torch.from_numpy(ori_i).to(self.device))
        return {kk: torch.stack(v) for kk, v in out.items()}


class PseudoGTGenerator:
    """Wraps the SPADE oracle into the reference pseudo-GT contract
    (`scenedreamer.py:158-213`)."""

    def __init__(self, spade_apply: Callable, pad=6, resize_512=True,
                 use_label_smooth_pgt=True, label_smooth_dia=11,
                 num_coco_labels=185, spade_res=512):
        """spade_apply: (label_onehot [B,R,R,C], generator) -> image
        [B,R,R,3] in [-1,1], R = spade_res (512 in the reference)."""
        self.spade_apply = spade_apply
        self.pad = pad
        self.resize_512 = resize_512
        self.spade_res = spade_res
        self.use_label_smooth_pgt = use_label_smooth_pgt
        self.label_smooth_dia = label_smooth_dia
        self.num_coco = num_coco_labels
        self.trans = get_label_translator()

    def _device_part(self, voxel_id_first, sky_sub, water_sub, generator):
        """mc first-hit labels -> pseudo-real image + fake_masks."""
        trans = self.trans
        coco = trans.mc2coco(voxel_id_first) - 1
        coco = torch.where(coco < 0, torch.full_like(coco, 183), coco)
        # stochastic relabeling, chosen on host, applied on device
        if sky_sub >= 0:
            coco = torch.where(coco == trans.gglbl2ggid('sky'),
                               torch.full_like(coco, sky_sub), coco)
        if water_sub >= 0:
            coco = torch.where(coco == trans.gglbl2ggid('water'),
                               torch.full_like(coco, water_sub), coco)
        fake_masks = F.one_hot(coco, self.num_coco).to(torch.float32)
        if self.use_label_smooth_pgt:
            fake_masks = segmask_smooth(fake_masks, self.label_smooth_dia)
        if self.pad > 0:
            p0 = self.pad // 2
            fake_masks = fake_masks[:, p0:-p0, p0:-p0]
        masks_in = fake_masks
        r = self.spade_res
        if self.resize_512:
            masks_in = resize_nearest(fake_masks, (r, r))
        # f32 regardless of oracle precision (the reference's fp16
        # oracle output is consumed in f32 too, `scenedreamer.py:204`)
        img = self.spade_apply(masks_in, generator).to(torch.float32)
        img = torch.nan_to_num(img, nan=0.0, posinf=0.0, neginf=0.0)
        if self.resize_512:
            b, hh, ww, _ = fake_masks.shape
            # area-downsample back to the crop resolution
            fh, fw = r // hh, r // ww
            if fh * hh == r and fw * ww == r:
                img = img.reshape(b, hh, fh, ww, fw, 3).mean(dim=(2, 4))
            else:
                img = resize_bilinear(img, (hh, ww))
        return img.clamp(-1.0, 1.0), fake_masks

    @torch.no_grad()
    def __call__(self, voxel_id, rng, generator=None, deterministic=False):
        """voxel_id: [B, h, w, M] first-hit ids in slot 0; `rng` the host
        numpy generator (relabeling dice), `generator` the torch
        generator of the oracle's style draw."""
        sky_sub = water_sub = -1
        if not deterministic:
            dice = rng.random()
            if 0.5 < dice < 0.9:
                sky_sub = self.trans.gglbl2ggid('clouds')
            elif dice >= 0.9:
                sky_sub = self.trans.gglbl2ggid('fog')
            dice = rng.random()
            if 0.33 < dice < 0.66:
                water_sub = self.trans.gglbl2ggid('sea')
            elif dice >= 0.66:
                water_sub = self.trans.gglbl2ggid('river')
        return self._device_part(voxel_id[..., 0], sky_sub, water_sub,
                                 generator)


@torch.no_grad()
def translate_masks(trans, voxel_id, real_label_onehot, pad=6,
                    num_reduced=12, use_label_smooth=True,
                    use_label_smooth_real=True, label_smooth_dia=11):
    """Reduced-label fake/real masks (`scenedreamer.py:246-281`).

    voxel_id: [B,h,w,M]; real_label_onehot: [B,H,W,184] or None.
    """
    reduced_fake = trans.mc2reduced(voxel_id[..., 0], ign2dirt=True)
    fake = F.one_hot(reduced_fake, num_reduced).to(torch.float32)
    if pad:
        p0 = pad // 2
        fake = fake[:, p0:-p0, p0:-p0]
    if use_label_smooth:
        fake = segmask_smooth(fake, label_smooth_dia)

    real = None
    if real_label_onehot is not None:
        idx = real_label_onehot.argmax(dim=-1).clamp(max=182)
        reduced_real = trans.coco2reduced(idx)
        real = F.one_hot(reduced_real, num_reduced).to(torch.float32)
        if use_label_smooth_real:
            real = segmask_smooth(real, label_smooth_dia)
    return fake, real


class TrainingBatchBuilder:
    """Full `sample_camera` equivalent: cameras + pseudo-GT + masks
    (`scenedreamer.py:216-283`, `trainers/gancraft.py:139-156`)."""

    def __init__(self, sampler: CameraBatchSampler,
                 pseudo_gt: Optional[PseudoGTGenerator] = None,
                 world_cache: Any = None):
        self.sampler = sampler
        self.pseudo_gt = pseudo_gt
        self.world_cache = world_cache
        self.trans = sampler.trans

    def __call__(self, data, world, rng, generator=None):
        """data: {'images': [B,H,W,3], 'label': [B,H,W,184]} tensors on
        the sampler's device (may be an empty dict for pseudo-GT-only
        training). `world` is a single world or a list of per-sample
        worlds (the analog of the reference's one world per DDP rank,
        `scenedreamer.py:88`; all worlds must share voxel dims). `rng` is
        the host numpy generator, `generator` the torch generator of the
        oracle's style. Returns the merged training batch."""
        dev = self.sampler.device
        c = self.sampler.cfg
        worlds = (list(world) if isinstance(world, (list, tuple))
                  else [world])
        batch_size = (data['images'].shape[0] if 'images' in data
                      else max(1, len(worlds)))
        ret = dict(data)
        if len(worlds) == 1:
            w0 = worlds[0]
            rays = self.sampler.sample(w0, batch_size, rng)
            hf = np.repeat(w0.height_field.transpose(0, 2, 3, 1),
                           batch_size, 0)
            sf = np.repeat(w0.semantic_field.transpose(0, 2, 3, 1),
                           batch_size, 0)
        else:
            if len(worlds) != batch_size:
                raise ValueError(
                    f'got {len(worlds)} worlds for batch {batch_size}')
            dims = {tuple(w.voxel.shape) for w in worlds}
            if len(dims) != 1:
                raise ValueError(f'worlds differ in voxel dims: {dims}')
            parts = [self.sampler.sample(w, 1, rng) for w in worlds]
            rays = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            hf = np.concatenate(
                [w.height_field.transpose(0, 2, 3, 1) for w in worlds])
            sf = np.concatenate(
                [w.semantic_field.transpose(0, 2, 3, 1) for w in worlds])
        ret.update(rays)
        ret['height_field'] = torch.from_numpy(
            np.ascontiguousarray(hf)).to(dev)
        ret['semantic_field'] = torch.from_numpy(
            np.ascontiguousarray(sf)).to(dev)
        if self.pseudo_gt is not None:
            pseudo, _ = self.pseudo_gt(rays['voxel_id'], rng, generator)
            ret['pseudo_real_img'] = pseudo
        fake, real = translate_masks(
            self.trans, rays['voxel_id'], data.get('label'), pad=c.pad,
            num_reduced=c.num_reduced_labels,
            use_label_smooth=c.use_label_smooth,
            use_label_smooth_real=c.use_label_smooth_real,
            label_smooth_dia=c.label_smooth_dia)
        ret['fake_masks'] = fake
        if real is not None:
            ret['real_masks'] = real
        return ret
