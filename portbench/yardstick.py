"""The yardstick: the card's published peaks and the operations and bytes
of the program's work, counted from shapes and from counts that the
correctness check covers (never from a kernel's own arguments).

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W power
limit: 67 TFLOP/s float32 outside the tensor cores (both configurations
compute in float32 with TF32 off) and 3.35 TB/s of HBM. A card set below
700 W reaches less; every run reports the card's `power.limit` beside
its shares.

Counts, per unit of work (2 operations per multiply-add):
  * RenderMLP per field point: fc_1 (C_hash -> H), fc_m_a (labels -> H),
    five H -> H modulated linears, fc_sigma (H -> 1), fc_out_c
    (H -> feature);
  * SKYMLP per ray: fc1 (sky PE -> H), four H -> H, fc_out_c;
  * RenderCNN per pixel of the padded feature map: conv1 1x1 feature ->
    H, four 3x3 H -> H, conv4a / conv4b 1x1 H -> H, conv4 1x1 H -> 3;
  * K2b (`encode_kernel`) bytes per point: 3 float32 read, L*C float32
    written (the baked table's rows left out: ~3% of the bytes at the
    serving chunk);
  * K3a (`folded_bwd_*_kernel`) bytes per step: per point the L*C
    float32 cotangent row and the 3 float32 coordinates read, plus the
    table's gradient written once.
The step's other convolutions (discriminator, VGG19, style encoder,
world encoder) are counted by `torch.utils.flop_counter` from their
shapes on the meta device, over the benchmark's own copies of the
modules (`reference/sd`).
"""
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def hash_out_dim(cfg):
    return cfg['hash_num_levels'] * cfg['hash_level_dim']


def table_bytes(cfg):
    return (cfg['hash_num_levels'] * 2 ** cfg['hash_log2_size']
            * cfg['hash_level_dim'] * 4)


def sky_in_dim(cfg):
    lvl = cfg['pe_lvl_raydir_sky']
    return 3 * 2 * lvl + (3 if cfg['pe_incl_orig_raydir_sky'] else 0)


def render_mlp_flops_per_point(cfg):
    h = cfg['mlp_hidden']
    macs = (hash_out_dim(cfg) * h + cfg['num_reduced_labels'] * h
            + 5 * h * h + h + h * cfg['final_feat_dim'])
    return 2 * macs


def sky_mlp_flops_per_ray(cfg):
    h = cfg['mlp_hidden']
    return 2 * (sky_in_dim(cfg) * h + 4 * h * h + h * cfg['final_feat_dim'])


def render_cnn_flops_per_px(cfg):
    h = cfg['cnn_hidden']
    return 2 * (cfg['final_feat_dim'] * h + 4 * 9 * h * h + 2 * h * h
                + h * 3)


def k2b_bytes(points, cfg):
    return points * (3 + hash_out_dim(cfg)) * 4


def k3a_bytes(points, cfg):
    return points * (hash_out_dim(cfg) + 3) * 4 + table_bytes(cfg)


def serve_frame_flops(cfg, hit_rays, rays):
    """The model operations a served frame needs: the field on its rays
    with a hit (`num_samples` points each), the sky on every ray, the
    RenderCNN on every pixel of the padded map. Returns (MLP operations,
    all operations)."""
    mlp = (hit_rays * cfg['num_samples'] * render_mlp_flops_per_point(cfg)
           + rays * sky_mlp_flops_per_ray(cfg))
    return mlp, mlp + rays * render_cnn_flops_per_px(cfg)


def conv_flops(module, *inputs):
    """Operations of `module(*inputs)` (meta tensors) by
    `torch.utils.flop_counter`, which counts matmuls and convolutions
    from their shapes."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(*inputs)
    return counter.get_total_flops()


def train_step_side_flops(cfg):
    """Forward operations of the step's convolutional parts at the
    configuration's shapes, counted on the meta device over the
    benchmark's copies of the modules: {'dis': one discriminator pass of
    one image with its labels, 'vgg': one VGG19 pass to relu_5_1,
    'style_enc': one style-encoder pass, 'world_enc': one world-encoder
    pass}."""
    import torch
    from portbench.reference.sd.models.discriminator import \
        GANcraftDiscriminator
    from portbench.reference.sd.models.layers import (ConditionalHashGrid,
                                                      StyleEncoder)
    from portbench.reference.sd.models.vgg import VGG19Features
    crop, s = cfg['crop_size'], cfg['scene_size']
    with torch.device('meta'):
        dis = GANcraftDiscriminator(num_labels=cfg['num_reduced_labels'],
                                    num_filters=cfg['dis_num_filters'])
        vgg = VGG19Features(tuple(cfg['perceptual_layers']))
        enc = StyleEncoder(cfg['style_dims'],
                           num_filters=cfg['style_enc_num_filters'],
                           kernel_size=cfg['style_enc_kernel_size'])
        wenc = ConditionalHashGrid()
        img = torch.empty((1, crop, crop, 3))
        lab = torch.empty((1, crop, crop, cfg['num_reduced_labels']))
        hf = torch.empty((1, s, s, 1))
        sf = torch.empty((1, s, s, 11))
    return {'dis': conv_flops(dis.fpse, img, lab),
            'vgg': conv_flops(vgg, img),
            'style_enc': conv_flops(lambda x: enc(x, eps=torch.zeros(
                (1, cfg['style_dims']), device='meta')), img),
            'world_enc': conv_flops(wenc, hf, sf)}


def train_step_flops(cfg, hit_rays, rays, side):
    """The model operations of one `train_step_shared` on one batch item
    (forward and backward; a backward costs twice its forward where both
    the weights' and the inputs' gradients are needed, once where only
    one is): the generator's field on the rays with a hit, sky and
    RenderCNN, style encoder and world encoder, forward and backward
    (3x); the discriminator on fake, real and pseudo-real in its update
    (3 x 3x) and on the fake in the generator's (forward and the inputs'
    gradient, 2x); VGG19 on fake and target forward and the fake's
    gradient (3x). `side` is `train_step_side_flops(cfg)`."""
    gen = 3 * (hit_rays * cfg['num_samples']
               * render_mlp_flops_per_point(cfg)
               + rays * (sky_mlp_flops_per_ray(cfg)
                         + render_cnn_flops_per_px(cfg))
               + side['style_enc'] + side['world_enc'])
    return gen + 11 * side['dis'] + 3 * side['vgg']
