"""SceneDreamer generator: hash-grid neural field + sky + style + render
CNN, for inference and training.

Counterpart of `scenedreamer_tpu/models/generator.py` (reference
`imaginaire/generators/scenedreamer.py` on `gancraft_base.py:296-603`):
world_encoder(BEV fields) -> 2-d scene code; style z -> StyleMLP;
per pixel: depth samples inside the DDA intervals -> scene-folded hash
encode -> style-modulated RenderMLP -> volume compositing blended with
the SKYMLP sky dome -> RenderCNN -> tanh.

Submodule and parameter names are the reference's (`hash_encoder.embeddings`,
`render_net.fc_1`, `world_encoder.conv_blocks.<i>.layers.0`,
`denoiser.conv2a`, ...). Tensors keep the JAX package's layouts (NHWC
images, [B, H, W, M] ray arrays). `forward` is the training forward
(reference `scenedreamer.py:432-476`): scene code, style from the VAE
style encoder (or random), render, refine and crop. Its random draws
(style, reparameterisation, stratified depths) come from a
`torch.Generator`; the style draws can be given (`style_eps`) to hold
the port against another implementation. The hash encode is
differentiable on both devices (`ops/hashgrid.py`: K2 forward, K3
backward on CUDA; K5 for `hash_variant='paired'`; the general encode K4,
forward and backward, when the spec is not foldable, e.g.
`hash_log2_size=21`). `render_pixels(compact_k=K)` (and `forward`) runs
the field on only the first K rays after a stable hits-first sort and
scatters the per-ray results back: exact sky-ray compaction, the JAX
package's `compact_k`. `GeneratorConfig.dtype=torch.bfloat16` computes
the layers in bf16 with float32 parameters (the JAX package's `dtype`,
for serving and AMP training): the hash kernels stay float32 (the
RenderMLP's first layer casts the encoding, and autograd hands the
kernels float32 cotangents), the bf16 scene code is rounded where JAX
rounds it before the bake, sky-only zeros come in the compute dtype,
and `refine` returns float32.

Every field of `GeneratorConfig` is honoured as in JAX: the ray-direction
input (`pe_lvl_raydir`, `pe_incl_orig_raydir`: RenderMLP's `fc_viewdir`
and `mod_5`), `clip_feat_map` (True, 'tanh' or False), `raw_noise_std`
(drawn by `sigma_noise`; on the compacted path only on the kept rays, as
JAX draws it, so with noise the two paths differ), the sky-leak options
(`keep_sky_out`, `keep_sky_out_avgpool`, and `sky_global_avgpool=False`:
a 31x31 average pool, edge-corrected; a caller's `sky_avg`, which the
renderer always passes as the frame's global mean, takes precedence, as
in JAX's renderer) and `use_seg`.
"""
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedreamer_tpu_torch.device import tensor_cache
from scenedreamer_tpu_torch.models.layers import (ConditionalHashGrid,
                                                  RenderCNN, RenderMLP,
                                                  SKYMLP, StyleEncoder,
                                                  StyleMLP)
from scenedreamer_tpu_torch.ops.compositing import volume_rendering_relu
from scenedreamer_tpu_torch.ops.hashgrid import (HashGridSpec, encode_folded,
                                                 fold_scene, foldable,
                                                 hashgrid_encode,
                                                 init_hashgrid_table)
from scenedreamer_tpu_torch.ops.pe import pe_out_dim, positional_encoding
from scenedreamer_tpu_torch.ops.rounding import fma
from scenedreamer_tpu_torch.ops.sampling import sample_depth
from scenedreamer_tpu_torch.scene.labels import mc2reduced


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Generator hyperparameters (the JAX package's fields and defaults,
    = configs/scenedreamer_train.yaml)."""
    style_dims: int = 128
    interm_style_dims: int = 256
    final_feat_dim: int = 64
    pad: int = 6
    # ray casting
    num_blocks_early_stop: int = 6
    num_samples: int = 24
    sample_depth: float = 3.0
    coarse_deterministic_sampling: bool = False
    sample_use_box_boundaries: bool = False
    # blender
    raw_noise_std: float = 0.0
    dists_scale: float = 0.25
    clip_feat_map: object = True
    keep_sky_out: bool = True
    keep_sky_out_avgpool: bool = True
    sky_global_avgpool: bool = True
    # ray-direction PE (train config disables the raydir input entirely)
    pe_lvl_raydir: int = 0
    pe_incl_orig_raydir: bool = False
    pe_lvl_raydir_sky: int = 5
    pe_incl_orig_raydir_sky: bool = True
    # hash grid (reference scenedreamer.py:51)
    hash_num_levels: int = 16
    hash_level_dim: int = 8
    hash_base_resolution: int = 16
    hash_log2_size: int = 19
    hash_desired_resolution: int = 2048
    hash_variant: str = 'xor'
    # mlp
    mlp_hidden: int = 256
    use_seg: bool = True
    # style encoder
    style_enc_num_filters: int = 64
    style_enc_kernel_size: int = 3
    num_reduced_labels: int = 12
    dtype: torch.dtype = torch.float32

    @property
    def hash_spec(self):
        return HashGridSpec.create(
            input_dim=5, num_levels=self.hash_num_levels,
            level_dim=self.hash_level_dim,
            base_resolution=self.hash_base_resolution,
            log2_hashmap_size=self.hash_log2_size,
            desired_resolution=self.hash_desired_resolution,
            hash_variant=self.hash_variant)

    @property
    def viewdir_dim(self):
        return pe_out_dim(3, self.pe_lvl_raydir, self.pe_incl_orig_raydir) \
            if (self.pe_lvl_raydir or self.pe_incl_orig_raydir) else 0

    @property
    def sky_in_dim(self):
        return pe_out_dim(3, self.pe_lvl_raydir_sky,
                          self.pe_incl_orig_raydir_sky)


class HashEncoder(nn.Module):
    """Holds the hash table as `embeddings` (reference gridencoder
    `GridEncoder`, grid.py:133)."""

    def __init__(self, spec):
        super().__init__()
        self.spec = spec
        self.embeddings = nn.Parameter(init_hashgrid_table(spec))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.embeddings.copy_(init_hashgrid_table(self.spec, generator))


_DTYPES = (torch.float32, torch.bfloat16)
SKY_POOL = 31       # the local sky average's window (`sky_global_avgpool=False`)


@tensor_cache()
def _delim(voxel_dims, device):
    """The voxel dims as a float32 tensor on `device`, made once per
    (dims, device) outside a trace: a host-to-device copy per call would
    wait for the device's queue to drain (one per tile in mesh-mode
    serving)."""
    return torch.tensor(voxel_dims, dtype=torch.float32, device=device)


def _local_sky_avg(sky_c):
    """The SKY_POOL x SKY_POOL moving average of sky_c [B, H, W, 1, C]
    over the image, 'SAME' padded and divided by the in-image count
    (JAX's two `reduce_window` sums)."""
    x = sky_c[..., 0, :].permute(0, 3, 1, 2)
    avg = F.avg_pool2d(x, SKY_POOL, stride=1, padding=SKY_POOL // 2,
                       count_include_pad=False)
    return avg.permute(0, 2, 3, 1)[..., None, :]


class SceneDreamerGenerator(nn.Module):
    """The generator. `seed` makes the random init reproducible (the
    style encoder, registered last, draws after every other module, so
    the serving modules' init is that of a generator without it)."""

    def __init__(self, cfg=GeneratorConfig(), seed=0):
        super().__init__()
        if cfg.dtype not in _DTYPES:
            raise NotImplementedError(
                f'GeneratorConfig.dtype={cfg.dtype!r} is not ported (only '
                f'{_DTYPES})')
        self.cfg = c = cfg
        dt = c.dtype
        spec = c.hash_spec
        self.hash_encoder = HashEncoder(spec)
        self.render_net = RenderMLP(
            spec.output_dim, style_dim=c.interm_style_dims,
            mask_dim=c.num_reduced_labels, out_channels_c=c.final_feat_dim,
            hidden_channels=c.mlp_hidden, viewdir_dim=c.viewdir_dim,
            use_seg=c.use_seg, dtype=dt)
        self.world_encoder = ConditionalHashGrid(dtype=dt)
        self.sky_net = SKYMLP(c.sky_in_dim, style_dim=c.interm_style_dims,
                              out_channels_c=c.final_feat_dim, dtype=dt)
        self.style_net = StyleMLP(c.style_dims, out_dim=c.interm_style_dims,
                                  dtype=dt)
        self.denoiser = RenderCNN(c.final_feat_dim, c.interm_style_dims,
                                  hidden_channels=256, out_channels=3,
                                  dtype=dt)
        self.style_encoder = StyleEncoder(
            c.style_dims, num_filters=c.style_enc_num_filters,
            kernel_size=c.style_enc_kernel_size, dtype=dt)
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if mod is not self and hasattr(mod, 'reset_parameters'):
                mod.reset_parameters(gen)

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------

    def world_code(self, height_field, semantic_field):
        """BEV fields (NHWC) -> [B, 2] scene code."""
        return self.world_encoder(height_field, semantic_field)

    def encode_style(self, image, eps=None, generator=None):
        """NHWC image -> (mu, logvar, z)."""
        return self.style_encoder(image, eps=eps, generator=generator)

    def style_forward(self, z):
        return self.style_net(z)

    def sky_color(self, raydirs, z):
        """raydirs [B, H, W, 3], z [B, S] -> [B, H, W, 1, C]."""
        pe = positional_encoding(raydirs[..., None, :],
                                 self.cfg.pe_lvl_raydir_sky,
                                 self.cfg.pe_incl_orig_raydir_sky)
        return self.sky_net(pe, z)

    def bake_hash(self, global_enc):
        """Fold the hash table for each scene code of the batch
        (kernel K2 (a) on CUDA; differentiable in the table and the
        scene code). A renderer bakes once per frame and passes the
        result to `render_pixels(baked=...)`. None when the spec is not
        foldable: the field then encodes unfolded (K4)."""
        spec = self.cfg.hash_spec
        if not foldable(spec, global_enc.shape[-1]):
            return None
        return [fold_scene(spec, self.hash_encoder.embeddings, g)
                for g in global_enc]

    def field_features(self, worldcoord, voxel_dims, global_enc, z,
                       mc_masks_onehot, baked=None, raydirs_in=None):
        """Hash-encode world points with the scene code and run the
        RenderMLP (`scenedreamer.py:285-311`). worldcoord [B, ..., 3];
        raydirs_in [B, ..., 1, C_v] (the ray-direction input, broadcast
        over the samples) when the config has one.
        A foldable spec encodes against the baked table (K2 / K5); any
        other encodes the points concatenated with the broadcast scene
        code, [B, ..., 5], with the general encode (K4), whose point
        gradient carries the scene code's."""
        spec = self.cfg.hash_spec
        normalized = worldcoord / _delim(tuple(float(d) for d in voxel_dims),
                                         worldcoord.device) * 2.0 - 1.0
        b = normalized.shape[0]
        if foldable(spec, global_enc.shape[-1]):
            if baked is None:
                baked = self.bake_hash(global_enc)
            flat = normalized.reshape(b, -1, 3)
            feat = torch.stack([encode_folded(spec, baked[i], flat[i])
                                for i in range(b)])
        else:
            lead = (b,) + (1,) * (normalized.dim() - 2)
            # a bf16 scene code joins the float32 points exactly, as
            # JAX's concatenate promotes it
            genc = global_enc.to(normalized.dtype).reshape(
                lead + (global_enc.shape[-1],)).expand(
                normalized.shape[:-1] + (global_enc.shape[-1],))
            pts = torch.cat([normalized, genc], dim=-1)
            feat = hashgrid_encode(spec, self.hash_encoder.embeddings, pts)
            feat = feat.reshape(b, -1, spec.output_dim)
        return self.field_mlp(feat, normalized.shape[:-1], z,
                              mc_masks_onehot, raydirs_in)

    def field_mlp(self, feat, point_shape, z, mc_masks_onehot,
                  raydirs_in=None):
        """The RenderMLP on field features feat [B, N, C_in] of the
        points of `point_shape` ([B, ...]) -> (sigma, feature) shaped
        `point_shape` + (channels,)."""
        b = point_shape[0]
        m_flat = mc_masks_onehot.reshape(b, -1, mc_masks_onehot.shape[-1])
        rd_flat = None
        if raydirs_in is not None:
            rd_flat = raydirs_in.expand(
                tuple(point_shape) + (raydirs_in.shape[-1],)).reshape(
                b, -1, raydirs_in.shape[-1])
        sigma, feat_c = self.render_net(feat, z, m_flat, rd_flat)
        return (sigma.reshape(tuple(point_shape) + (sigma.shape[-1],)),
                feat_c.reshape(tuple(point_shape) + (feat_c.shape[-1],)))

    def render_pixels(self, voxel_id, depth, hit_mask, raydirs, cam_ori, z,
                      global_enc, voxel_dims, num_samples=None,
                      sample_depth_clip=None, deterministic=None,
                      sky_avg=None, sky_only=False, baked=None,
                      generator=None, compact_k=None, rows=None,
                      field_extra=None):
        """Per-pixel rendering pass (`scenedreamer.py:313-430`).

        `compact_k`: evaluate the hash field and the RenderMLP on only the
        first `compact_k` rays of each batch item after a stable
        hits-first sort, and scatter the per-ray results (weights, sigma,
        total weight, terrain sum) back, zero on the dropped rays. Rays
        that hit nothing have zero sample distances and are masked by
        `sky_only_mask`, so their weights, terrain sums and field
        gradients are exactly zero in the full path too: dropping them is
        exact PROVIDED `compact_k` >= the number of rays whose first
        slot hits. Sampling, the sky MLP and the sky average still run on
        every ray, so a `generator` draws the same depths either way.
        None, or a value >= H*W, runs the field on every ray.

        Args:
            voxel_id [B, H, W, M] int; depth [B, H, W, M, 2];
            hit_mask [B, H, W, M] bool; raydirs [B, H, W, 3];
            cam_ori [B, 3]; z [B, interm_style]; global_enc [B, 2];
            voxel_dims (Y, X, Z); sky_avg optional [B, 1, 1, 1, C]
            frame-global sky average (tiled inference shares one);
            sky_only skips the field (exact for rays with no hit);
            compact_k: see above;
            baked: `bake_hash(global_enc)`, reused across calls (None
            for a spec that is not foldable);
            field_extra: keyword arguments passed on to every
            `field_features` call (the GANcraft generator's
            `corner_lut`, JAX `models/generator.py:348,385`);
            generator: `torch.Generator` of the stratified draws when
            not deterministic.

        Returns dict with net_out [B, H, W, C], weights, rand_depth and
        the sky masks.
        """
        c = self.cfg
        num_samples = num_samples or c.num_samples
        sample_depth_clip = sample_depth_clip if sample_depth_clip \
            is not None else c.sample_depth
        deterministic = c.coarse_deterministic_sampling \
            if deterministic is None else deterministic
        b, h, w, m = voxel_id.shape
        nsamples = (num_samples - c.num_blocks_early_stop
                    if c.sample_use_box_boundaries else num_samples + 1)
        uniforms = None
        raydirs_all = raydirs
        if rows is not None:
            if compact_k is not None:
                raise ValueError('compact_k runs on whole images: render '
                                 'a band of rows without it')
            uniforms = self._band_draws(rows, (b, h, w, m), nsamples,
                                        deterministic, depth, generator)
            voxel_id, depth, hit_mask, raydirs = (
                x[:, rows] for x in (voxel_id, depth, hit_mask, raydirs))
            h = voxel_id.shape[1]

        with torch.no_grad():
            rand_depth, new_dists, new_idx = sample_depth(
                depth.reshape(b * h * w, m, 2),
                hit_mask.reshape(b * h * w, m), nsamples,
                deterministic=deterministic,
                use_box_boundaries=c.sample_use_box_boundaries,
                sample_depth_clip=sample_depth_clip, generator=generator,
                uniforms=uniforms)
            s = rand_depth.shape[-1]
            rand_depth = rand_depth.reshape(b, h, w, s, 1)
            new_dists = new_dists.reshape(b, h, w, s, 1)
            new_idx = new_idx.reshape(b, h, w, s)

            vid_reduced = mc2reduced(voxel_id, ign2dirt=True)  # [B,H,W,M]
            mc_masks = torch.gather(vid_reduced, -1, new_idx)

        # one rounding, as the JAX op's compiled render_pixels does
        worldcoord = fma(raydirs[:, :, :, None, :], rand_depth,
                         cam_ori[:, None, None, None, :])

        # the ray-direction input (the train config has none)
        raydirs_in = None
        if c.pe_lvl_raydir > 0:
            raydirs_in = positional_encoding(raydirs[:, :, :, None, :],
                                             c.pe_lvl_raydir,
                                             c.pe_incl_orig_raydir)
        elif c.pe_incl_orig_raydir:
            raydirs_in = raydirs[:, :, :, None, :]

        # sky masks: last slot empty = ray ends in sky; first slot empty =
        # pure sky ray (reference scenedreamer.py:334-337)
        sky_mask = ~hit_mask[..., -1:]                        # [B,H,W,1]
        sky_only_mask = ~hit_mask[..., :1]

        r_all = h * w
        if not sky_only and compact_k is not None and compact_k < r_all:
            weights, sigma, total_w, terrain_sum = self._compact_field(
                int(compact_k), worldcoord, mc_masks, new_dists,
                hit_mask, voxel_dims, global_enc, z, baked, raydirs_in,
                generator, field_extra)
        else:
            if sky_only:
                # zeros in the compute dtype, so the compositing promotes
                # as on the full path (bit-exact under bf16 too)
                sigma = torch.zeros((b, h, w, s, 1), dtype=c.dtype,
                                    device=raydirs.device)
                feat_c = torch.zeros((b, h, w, s, c.final_feat_dim),
                                     dtype=c.dtype, device=raydirs.device)
            else:
                mc_onehot = F.one_hot(mc_masks, c.num_reduced_labels).to(
                    torch.float32)
                sigma, feat_c = self.field_features(
                    worldcoord, voxel_dims, global_enc, z, mc_onehot,
                    baked=baked, raydirs_in=raydirs_in,
                    **(field_extra or {}))
            if c.raw_noise_std > 0:
                shape = sigma.shape if rows is None else \
                    (b, raydirs_all.shape[1]) + sigma.shape[2:]
                noise = self.sigma_noise(shape, sigma.dtype, sigma.device,
                                         generator)
                sigma = sigma + (noise if rows is None
                                 else noise[:, rows]) * c.raw_noise_std
            weights = volume_rendering_relu(
                sigma, new_dists * c.dists_scale, dim=-2)
            weights = weights * (~sky_only_mask).to(weights.dtype).reshape(
                b, h, w, 1, 1)
            total_w = weights.sum(dim=-2, keepdim=True)       # [B,H,W,1,1]
            terrain_sum = (weights * self._clip_feat(feat_c)).sum(
                dim=-2, keepdim=True)                         # [B,H,W,1,C]

        # [B,H,W,1,C]; a band takes its rows of the whole image's, whose
        # average the sky-leak suppression uses
        sky_all = self.sky_color(raydirs_all, z)
        sky_c = sky_all if rows is None else sky_all[:, rows]
        is_gnd = (worldcoord[..., 0] <= 1.0).any(dim=-1, keepdim=True)
        nosky = (~sky_mask | is_gnd).to(torch.float32)[..., None]

        # sky-leak suppression (reference scenedreamer.py:373-427)
        sky_weight = 1.0 - total_w
        if c.keep_sky_out:
            if c.keep_sky_out_avgpool:
                if sky_avg is None and c.sky_global_avgpool:
                    sky_avg = sky_all.mean(dim=(1, 2), keepdim=True)
                elif sky_avg is None:
                    sky_avg = _local_sky_avg(sky_all)
                    sky_avg = sky_avg if rows is None else sky_avg[:, rows]
                sky_c = sky_c * (1.0 - nosky) + sky_avg * nosky
            else:
                sky_weight = sky_weight * (1.0 - nosky)
        if c.clip_feat_map is True:
            net_out = (terrain_sum + sky_weight * (torch.clamp(
                sky_c, -1, 1) + 1)).squeeze(-2) - 1.0
        elif c.clip_feat_map == 'tanh':
            net_out = (terrain_sum
                       + sky_weight * torch.tanh(sky_c)).squeeze(-2)
        else:
            net_out = (terrain_sum + sky_weight * sky_c).squeeze(-2)

        return {
            'net_out': net_out,            # [B, H, W, C]
            'weights': weights,
            'rand_depth': rand_depth,
            'total_weights': total_w,
            'sigma': sigma,
            'sky_c': sky_c,
            'nosky_mask': nosky,
            'sky_mask': sky_mask,
            'sky_only_mask': sky_only_mask,
        }

    def _band_draws(self, rows, shape, nsamples, deterministic, depth,
                    generator):
        """The uniforms `sample_depth` draws for a whole [B, H, W, M]
        image, in its order ('samples', then 'boundary'), cut to the band
        `rows`: a band then takes the draws of its rows in the whole
        render."""
        b, h, w, m = shape
        names = () if deterministic else (('samples', nsamples),)
        if self.cfg.sample_use_box_boundaries:
            names += (('boundary', m),)
        out = {}
        for name, n in names:
            u = torch.rand((b * h * w, n), generator=generator,
                           device=depth.device, dtype=depth.dtype)
            out[name] = u.reshape(b, h, w, n)[:, rows].reshape(-1, n)
        return out

    def sigma_noise(self, shape, dtype, device, generator=None):
        """Standard normal draws of the density noise (`raw_noise_std`),
        in sigma's dtype as JAX draws them. A test replaces this to feed
        JAX's draws."""
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    def _clip_feat(self, feat):
        """The per-sample feature term of the compositing sum, by
        `clip_feat_map` (reference scenedreamer.py:373-427)."""
        mode = self.cfg.clip_feat_map
        if mode is True:
            return torch.clamp(feat, -1, 1) + 1
        if mode == 'tanh':
            return torch.tanh(feat)
        return feat

    def _compact_field(self, k, worldcoord, mc_masks, new_dists, hit_mask,
                       voxel_dims, global_enc, z, baked, raydirs_in=None,
                       generator=None, field_extra=None):
        """`render_pixels`' field on the first `k` rays of each batch item
        after a stable hits-first sort (the JAX package's compact_k
        branch): the field, the compositing weights, the total weight and
        the terrain sum on those rays, scattered back to [B, H, W, ...]
        with zeros on the others. The density noise is drawn on the kept
        rays only, as JAX draws it. Returns (weights, sigma, total_w,
        terrain_sum)."""
        c = self.cfg
        b, h, w, s = worldcoord.shape[:4]
        r_all = h * w
        miss = ~hit_mask[..., 0].reshape(b, r_all)
        # stable sort: hitting rays first, each group in its own order
        sel = torch.sort(miss.to(torch.uint8), dim=1,
                         stable=True).indices[:, :k]          # [B, K]

        def take(x):                          # [B, R, ...] -> [B, K, ...]
            idx = sel.reshape((b, k) + (1,) * (x.dim() - 2))
            return torch.gather(x, 1, idx.expand((b, k) + x.shape[2:]))

        def put(x):                           # [B, K, ...] -> [B, H, W, ...]
            idx = sel.reshape((b, k) + (1,) * (x.dim() - 2))
            full = x.new_zeros((b, r_all) + x.shape[2:])
            full = full.scatter(1, idx.expand(x.shape), x)
            return full.reshape((b, h, w) + x.shape[2:])

        with torch.no_grad():
            mc_c = F.one_hot(take(mc_masks.reshape(b, r_all, s)),
                             c.num_reduced_labels).to(torch.float32)
            dists_c = take(new_dists.reshape(b, r_all, s, 1))
            keep_c = take(~miss.reshape(b, r_all, 1, 1))
        rd_c = None if raydirs_in is None else take(
            raydirs_in.reshape(b, r_all, 1, raydirs_in.shape[-1]))
        sigma_c, feat_c = self.field_features(
            take(worldcoord.reshape(b, r_all, s, 3)), voxel_dims,
            global_enc, z, mc_c, baked=baked, raydirs_in=rd_c,
            **(field_extra or {}))
        if c.raw_noise_std > 0:
            sigma_c = sigma_c + self.sigma_noise(
                sigma_c.shape, sigma_c.dtype, sigma_c.device,
                generator) * c.raw_noise_std
        w_c = volume_rendering_relu(sigma_c, dists_c * c.dists_scale,
                                    dim=-2)
        w_c = w_c * keep_c.to(w_c.dtype)
        total_c = w_c.sum(dim=-2, keepdim=True)               # [B,K,1,1]
        terrain_c = (w_c * self._clip_feat(feat_c)).sum(
            dim=-2, keepdim=True)                             # [B,K,1,C]
        return put(w_c), put(sigma_c), put(total_c), put(terrain_c)

    def refine(self, net_out, z):
        """RenderCNN + tanh (`gancraft_base.py:588-603`).
        net_out [B, H, W, C] -> (image [B, H, W, 3] in [-1, 1], raw),
        float32 whatever the compute dtype."""
        raw = self.denoiser(net_out, z).float()
        return torch.tanh(raw), raw

    def forward(self, data, voxel_dims, random_style=False, pad=None,
                generator=None, style_eps=None, compact_k=None, band=None,
                field_extra=None):
        """The training forward (`scenedreamer.py:432-476`).

        data (NHWC): voxel_id [B,H,W,M] int; depth [B,H,W,M,2];
        hit_mask [B,H,W,M]; raydirs [B,H,W,3]; cam_ori [B,3];
        height_field [B,S,S,1]; semantic_field [B,S,S,11];
        pseudo_real_img [B,h,w,3] (style-encoded unless random_style).
        generator: `torch.Generator` of the draws (style z or the
        reparameterisation eps first, then the stratified depths);
        style_eps [B, style_dims] replaces the style draws.
        compact_k: `render_pixels`' exact sky-ray compaction.
        band: a `parallel.mesh.RowBand`: render its rows alone
        (`render_pixels(rows=...)`) and put the whole feature map
        together with `band.gather` before the RenderCNN.
        field_extra: `render_pixels`' (JAX `models/generator.py:491`).

        Returns dict with fake_images [B, H-pad, W-pad, 3] in [-1, 1],
        fake_images_raw, mu, logvar (None with a random style) and the
        `render_pixels` dict.
        """
        c = self.cfg
        pad = c.pad if pad is None else pad
        b = data['voxel_id'].shape[0]
        global_enc = self.world_code(data['height_field'],
                                     data['semantic_field'])
        mu = logvar = None
        if random_style or 'pseudo_real_img' not in data:
            z = style_eps if style_eps is not None else torch.randn(
                (b, c.style_dims), generator=generator,
                device=global_enc.device)
        else:
            mu, logvar, z = self.encode_style(data['pseudo_real_img'],
                                              eps=style_eps,
                                              generator=generator)
        z = self.style_forward(z)
        out = self.render_pixels(
            data['voxel_id'], data['depth'], data['hit_mask'],
            data['raydirs'], data['cam_ori'], z, global_enc, voxel_dims,
            generator=generator, compact_k=compact_k,
            rows=None if band is None else band.rows,
            field_extra=field_extra)
        net_out = out['net_out'] if band is None else \
            band.gather(out['net_out'])
        fake, fake_raw = self.refine(net_out, z)
        if pad:
            fake = fake[:, pad // 2:-(pad // 2), pad // 2:-(pad // 2), :]
        return {'fake_images': fake, 'fake_images_raw': fake_raw,
                'mu': mu, 'logvar': logvar, 'render': out}
