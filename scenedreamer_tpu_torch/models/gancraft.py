"""Legacy GANcraft generator: sparse per-corner voxel features instead
of the hash grid.

Counterpart of `scenedreamer_tpu/models/gancraft.py` (reference
`Base3DGenerator`'s own field path, `imaginaire/generators/
gancraft_base.py:296-586`): a learnable `blk_feats [K + 1, C1]` table
indexed through the scene's corner LUT by sparse trilinear interpolation
(`ops/sp_trilinear.py`, `gancraft_base.py:442-444`), a positional
encoding of the first `C1 - pe_no_pe_feat_dim` channels (pe_lvl_feat 4,
pe_no_pe_feat_dim 40 in `configs/scenedreamer_train.yaml:81-85`), then
the SceneDreamer generator's RenderMLP, sky, compositing and RenderCNN.
SceneDreamer replaced this path with the hash grid; it is kept for the
GANcraft-style single-scene mode.

Everything but the field lookup is inherited. The corner LUT is
per-scene data (`build_corner_lut`, moved to the device) passed as
`forward(..., field_extra={'corner_lut': lut})` (or `render_pixels`'):
the coordinates stay in voxel units. The hash table is kept, as JAX's
model keeps it, with the same state-dict keys, and receives no gradient;
`bake_hash` returns None, so a frame or step launches K1 (its rays) and
none of K2-K5. The RenderMLP's first layer takes `field_in_dim` inputs
(flax infers that width; 232 at the defaults).
"""
import torch
import torch.nn as nn

from scenedreamer_tpu_torch.models.generator import (GeneratorConfig,
                                                     SceneDreamerGenerator)
from scenedreamer_tpu_torch.models.layers import RenderMLP
from scenedreamer_tpu_torch.ops.pe import pe_out_dim, positional_encoding
from scenedreamer_tpu_torch.ops.sp_trilinear import sp_trilinear_worldcoord


class GANcraftGenerator(SceneDreamerGenerator):
    """Voxel-corner-feature variant (`gancraft_base.py:429-472`).
    `num_corners`: the scene's corner count (rows of blk_feats less the
    hole row); the defaults are the JAX module's and the train yaml's.
    `seed` makes the random init reproducible (blk_feats normal x 0.01)."""

    def __init__(self, cfg=GeneratorConfig(), num_corners=1,
                 blk_feat_dim=64, pe_lvl_feat=4, pe_incl_orig_feat=False,
                 pe_no_pe_feat_dim=40, seed=0):
        super().__init__(cfg, seed=seed)
        self.num_corners = num_corners
        self.blk_feat_dim = blk_feat_dim
        self.pe_lvl_feat = pe_lvl_feat
        self.pe_incl_orig_feat = pe_incl_orig_feat
        self.pe_no_pe_feat_dim = pe_no_pe_feat_dim
        c = cfg
        self.render_net = RenderMLP(
            self.field_in_dim, style_dim=c.interm_style_dims,
            mask_dim=c.num_reduced_labels, out_channels_c=c.final_feat_dim,
            hidden_channels=c.mlp_hidden, viewdir_dim=c.viewdir_dim,
            use_seg=c.use_seg, dtype=c.dtype)
        self.blk_feats = nn.Parameter(torch.empty(num_corners + 1,
                                                  blk_feat_dim))
        gen = torch.Generator().manual_seed(seed + 1)
        for mod in self.render_net.modules():
            if hasattr(mod, 'reset_parameters'):
                mod.reset_parameters(gen)
        with torch.no_grad():
            self.blk_feats.normal_(generator=gen).mul_(0.01)

    @property
    def field_in_dim(self):
        """The RenderMLP's input width: the encoded channels plus the
        ones passed through."""
        pe_dims = self.blk_feat_dim - self.pe_no_pe_feat_dim
        return pe_out_dim(pe_dims, self.pe_lvl_feat,
                          self.pe_incl_orig_feat) + self.pe_no_pe_feat_dim

    def bake_hash(self, global_enc):
        """No hash table is read in this mode: nothing to bake."""
        return None

    def field_features(self, worldcoord, voxel_dims, global_enc, z,
                       mc_masks_onehot, baked=None, raydirs_in=None,
                       corner_lut=None, valid_mask=None):
        """sp_trilinear + PE + RenderMLP (`gancraft_base.py:429-472`).
        worldcoord [B, ..., 3] in voxel units; `voxel_dims`,
        `global_enc` and `baked` are unused here (the per-scene feature
        table conditions the field)."""
        if corner_lut is None:
            raise ValueError("GANcraft mode needs field_extra="
                             "{'corner_lut': ...}")
        proj = sp_trilinear_worldcoord(self.blk_feats, corner_lut,
                                       worldcoord, ign_zero=True,
                                       valid_mask=valid_mask)
        npe = self.pe_no_pe_feat_dim
        if self.pe_lvl_feat == 0 and self.pe_incl_orig_feat:
            feature_in = proj
        elif npe > 0:
            feature_in = torch.cat([positional_encoding(
                proj[..., :-npe], self.pe_lvl_feat, self.pe_incl_orig_feat),
                proj[..., -npe:]], dim=-1)
        else:
            feature_in = positional_encoding(proj, self.pe_lvl_feat,
                                             self.pe_incl_orig_feat)
        b = worldcoord.shape[0]
        return self.field_mlp(feature_in.reshape(b, -1, feature_in.shape[-1]),
                              worldcoord.shape[:-1], z, mc_masks_onehot,
                              raydirs_in)
