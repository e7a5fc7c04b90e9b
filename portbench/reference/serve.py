"""The plain reference of a served fly-through frame.

From the benchmark's inputs alone (the world's arrays, the pose, the raw
style and the weights made from the seed), with the frozen plain copy of
the port (`reference/sd`): the camera rays, the plain DDA (`dda_plain`,
no brick skip), the world code, the frame-global sky average, the hash
table baked by `bake_plain`, then per block of image rows the field
(`encode_plain`, RenderMLP, SKYMLP, compositing) on every ray, with no
sky skip and no compaction, and the RenderCNN over the whole padded
feature map. Returns the cropped image, expected depth, first voxel ids
and the count of rays with a hit.
"""
import numpy as np
import torch

from portbench import weights
from portbench.reference.sd.models.generator import (GeneratorConfig,
                                                     SceneDreamerGenerator)
from portbench.reference.sd.ops.ray_voxel import camera_rays, dda_plain


def generator_config(cfg):
    """The `GeneratorConfig` fields of a configuration file (the same
    field names in the program's and the reference's config)."""
    return {k: cfg[k] for k in GENERATOR_KEYS if k in cfg}


GENERATOR_KEYS = (
    'style_dims', 'interm_style_dims', 'final_feat_dim', 'pad',
    'num_blocks_early_stop', 'num_samples', 'sample_depth',
    'coarse_deterministic_sampling', 'sample_use_box_boundaries',
    'raw_noise_std', 'dists_scale', 'clip_feat_map', 'keep_sky_out',
    'keep_sky_out_avgpool', 'sky_global_avgpool', 'pe_lvl_raydir',
    'pe_incl_orig_raydir', 'pe_lvl_raydir_sky', 'pe_incl_orig_raydir_sky',
    'hash_num_levels', 'hash_level_dim', 'hash_base_resolution',
    'hash_log2_size', 'hash_desired_resolution', 'hash_variant',
    'mlp_hidden', 'use_seg', 'style_enc_num_filters',
    'style_enc_kernel_size', 'num_reduced_labels')


def build_generator(cfg, seed, device):
    with torch.device('meta'):
        gen = SceneDreamerGenerator(GeneratorConfig(**generator_config(cfg)))
    gen = gen.to_empty(device=device)
    weights.fill_({'gen': gen}, seed, device)
    return gen.eval()


def expected_depth(out):
    wts = out['weights'][..., 0]
    t = out['rand_depth'][..., 0]
    tw = wts.sum(dim=-1)
    return torch.where(tw > 1e-6,
                       (wts * t).sum(dim=-1) / torch.clamp(tw, min=1e-6),
                       torch.full_like(tw, float('inf')))


class ReferenceRenderer:
    def __init__(self, gen, arrays, cfg, traffic, device, chunk_rays=32768):
        self.gen, self.device = gen, device
        self.voxel = torch.from_numpy(arrays['voxel']).to(device)
        self.dims = tuple(int(d) for d in self.voxel.shape)
        self.res = tuple(traffic['resolution_hw'])
        self.pad = traffic['pad']
        self.m = cfg['num_blocks_early_stop']
        self.num_samples = cfg['num_samples']
        self.sample_depth = cfg['sample_depth']
        self.chunk_rays = chunk_rays
        with torch.no_grad():
            hf = torch.from_numpy(
                arrays['height_field'].transpose(0, 2, 3, 1)).to(device)
            sf = torch.from_numpy(
                arrays['semantic_field'].transpose(0, 2, 3, 1)).to(device)
            self.global_enc = gen.world_code(hf, sf)

    @torch.no_grad()
    def style_z(self, style):
        return self.gen.style_forward(torch.tensor(
            np.asarray(style), dtype=torch.float32, device=self.device))

    @torch.no_grad()
    def frame(self, pose, z):
        gen, dev = self.gen, self.device
        ori, cdir, up, f_ratio = pose
        h, w = self.res[0] + self.pad, self.res[1] + self.pad
        raydirs = camera_rays(cdir, up, f_ratio * (self.res[1] - 1),
                              ((h - 1) / 2.0, (w - 1) / 2.0), (h, w),
                              device=dev)
        cam_ori = torch.as_tensor(ori, dtype=torch.float32, device=dev)
        vid, dep, hit = dda_plain(self.voxel, cam_ori, raydirs.reshape(-1, 3),
                                  self.m, sum(self.dims) + 2)
        vid = vid.reshape(1, h, w, self.m)
        dep = dep.reshape(1, h, w, self.m, 2)
        hit = hit.reshape(1, h, w, self.m)
        raydirs = raydirs.reshape(1, h, w, 3)
        sky_avg = gen.sky_color(raydirs, z).mean(dim=(1, 2), keepdim=True)
        baked = gen.bake_hash(self.global_enc)
        rows = max(1, self.chunk_rays // w)
        feats, depths = [], []
        for y0 in range(0, h, rows):
            sl = slice(y0, min(h, y0 + rows))
            out = gen.render_pixels(
                vid[:, sl], dep[:, sl], hit[:, sl], raydirs[:, sl],
                cam_ori[None], z, self.global_enc, self.dims,
                num_samples=self.num_samples,
                sample_depth_clip=self.sample_depth, deterministic=True,
                sky_avg=sky_avg, baked=baked)
            feats.append(out['net_out'])
            depths.append(expected_depth(out))
        img, _ = gen.refine(torch.cat(feats, dim=1), z)
        p0 = self.pad // 2

        def crop(x):
            return x[p0:p0 + self.res[0], p0:p0 + self.res[1]]
        return {'img': crop(img[0]).cpu().numpy(),
                'depth': crop(torch.cat(depths, dim=1)[0]).cpu().numpy(),
                'first_voxel_id': crop(vid[0])[..., 0].cpu().numpy(),
                'hit_rays': int(hit[0].any(dim=-1).sum())}
