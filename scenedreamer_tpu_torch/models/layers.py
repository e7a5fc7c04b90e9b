"""Style-modulated linears and the neural-field networks, in PyTorch.

Counterpart of `scenedreamer_tpu/models/layers.py` with the reference's
module and parameter names, so a reference state dict loads as is:
  * ModLinear (`imaginaire/model_utils/layers.py:184-271`) and AffineMod
    (`:128-181`)
  * RenderMLP == LightningMLP (`gancraft_base.py:20-88`)
  * StyleMLP (`gancraft_base.py:91-126`), SKYMLP (`gancraft_base.py:129-169`)
  * ConditionalHashGrid world encoder (`model_utils/layers.py:6-55`)
  * RenderCNN (`gancraft_base.py:172-225`)
  * StyleEncoder (`gancraft_base.py:228-293`), with the JAX package's
    logvar clamp

Tensors are channels-last at every public call (NHWC images, [B, ..., C]
features); the convolutions permute to NCHW inside. `dtype` is the
compute dtype, the JAX package's `GeneratorConfig.dtype`: parameters stay
float32, and each layer casts its input, weight and bias to it (bfloat16
for serving; the modulation coefficients alpha / beta are computed in
float32 and cast, as JAX's `ModLinear` and `AffineMod` do). Each module has
`reset_parameters(generator)` with the JAX package's init scheme:
kaiming(leaky 0.2) x 0.5 for weights, zero biases, randn/sqrt(fan) for
modulation weights (`generators/scenedreamer.py:66-78`).
"""
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from scenedreamer_tpu_torch.ops import mlp_ops
from scenedreamer_tpu_torch.ops.resize import resize_bilinear


class _LeakyReLU(torch.autograd.Function):
    """`F.leaky_relu` whose gradient at exactly 0 is 1, as JAX's
    `where(x >= 0, x, slope * x)` differentiates (torch's own backward
    passes the slope there)."""

    @staticmethod
    def forward(ctx, x, slope):
        y = F.leaky_relu(x, slope)
        ctx.save_for_backward(y)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y < 0, g * ctx.slope, g), None


def leaky_relu(x, grad_one_at_zero=False, slope=0.2):
    """Leaky ReLU as JAX computes it: `slope` (0.2) in x's dtype (JAX
    multiplies a bf16 x by 0.2 rounded to bf16, 0.2001953125, not by the
    float32 0.2). `grad_one_at_zero` also takes JAX's gradient at exactly
    0 (1, where torch's fused backward passes the slope), at the price of
    three elementwise kernels in the backward for one. The discriminator
    needs it: DiffAugment's cutout and zero fill give all-zero input
    windows, which a zero bias (every bias at init) passes on as exact
    zeros layer after layer. The generator's layers keep the fused
    backward: their activations reach ~1.7 GB at the flagship training
    width, where the three kernels cost ~20 ms of device time a step on
    an H100 (`scripts/torch_profile_train.py`), and no exact zeros reach
    them in the tests held against JAX."""
    slope = slope if x.dtype == torch.float32 else \
        float(torch.tensor(slope, dtype=x.dtype))
    if grad_one_at_zero and torch.is_grad_enabled() and x.requires_grad:
        return _LeakyReLU.apply(x, slope)
    return F.leaky_relu(x, slope)


def _kaiming_half_(w, generator, scale=0.5, a=0.2):
    """kaiming_normal_(a=0.2, leaky_relu) followed by *= scale."""
    fan_in = w[0].numel()
    std = math.sqrt(2.0 / (1.0 + a * a)) / math.sqrt(fan_in) * scale
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)


def _mod_weight_(w, generator):
    """randn / sqrt(style_features) (reference layers.py:143,212)."""
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(w.shape[-1]), generator=generator)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Dense(nn.Linear):
    """Linear layer, weight [out, in], with the reference init; computes
    in `dtype`."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self, generator=None):
        _kaiming_half_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv(nn.Conv2d):
    """NCHW conv with the reference init (kaiming x 0.5, zero bias);
    computes in `dtype`."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def reset_parameters(self, generator=None):
        _kaiming_half_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class ModLinear(nn.Module):
    """Style-modulated linear (reference layers.py:184-271, in the mode
    the generator uses: no bias, modulated bias on the output side):
    per-batch weight W * alpha_b over the input axis, one batched matmul
    ([B, N, I] @ [B, I, O]), plus beta_b. alpha(z) = z @ weight_alpha.T
    + bias_alpha, beta(z) = z @ weight_beta.T + bias_beta."""

    def __init__(self, in_features, out_features, style_dim,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.weight_alpha = nn.Parameter(torch.empty(in_features, style_dim))
        self.bias_alpha = nn.Parameter(torch.empty(in_features))
        self.weight_beta = nn.Parameter(torch.empty(out_features, style_dim))
        self.bias_beta = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _kaiming_half_(self.weight, generator, scale=1.0)
        _mod_weight_(self.weight_alpha, generator)
        nn.init.ones_(self.bias_alpha)
        _mod_weight_(self.weight_beta, generator)
        nn.init.zeros_(self.bias_beta)

    def modulation(self, z):
        """(W * alpha_b [B, O, I], beta_b [B, O]) in the compute dtype,
        from the style z [B, S] in float32."""
        dt = self.compute_dtype
        z = z.float()
        alpha = F.linear(z, self.weight_alpha, self.bias_alpha)   # [B, I]
        beta = F.linear(z, self.weight_beta, self.bias_beta)      # [B, O]
        w_mod = (self.weight[None] * alpha[:, None, :]).to(dt)    # [B, O, I]
        return w_mod, beta.to(dt)

    def forward(self, x, z):
        prefix = x.shape[:-1]
        xb = x.reshape(x.shape[0], -1, x.shape[-1]).to(self.compute_dtype)
        w_mod, beta = self.modulation(z)
        y = torch.bmm(xb, w_mod.transpose(1, 2)) + beta[:, None]
        return y.reshape(*prefix, y.shape[-1])


class AffineMod(nn.Module):
    """x * alpha(z) + beta(z) over the channel axis (reference
    layers.py:128-181): alpha(z) = z @ weight_alpha.T + bias_alpha, beta
    likewise, computed in float32 and cast to `dtype`."""

    def __init__(self, in_features, style_dim, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight_alpha = nn.Parameter(torch.empty(in_features, style_dim))
        self.bias_alpha = nn.Parameter(torch.empty(in_features))
        self.weight_beta = nn.Parameter(torch.empty(in_features, style_dim))
        self.bias_beta = nn.Parameter(torch.empty(in_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _mod_weight_(self.weight_alpha, generator)
        nn.init.ones_(self.bias_alpha)
        _mod_weight_(self.weight_beta, generator)
        nn.init.zeros_(self.bias_beta)

    def forward(self, x, z):
        """x [B, ..., I]; z [B, S]."""
        dt = self.compute_dtype
        z = z.float()
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        alpha = F.linear(z, self.weight_alpha, self.bias_alpha)
        beta = F.linear(z, self.weight_beta, self.bias_beta)
        return x * alpha.reshape(shape).to(dt) + beta.reshape(shape).to(dt)


class RenderMLP(nn.Module):
    """Per-sample neural field: hash features (+ segmentation one-hot
    with `use_seg`, + the ray-direction encoding when `viewdir_dim` > 0)
    and style -> (sigma, color feature). Reference `gancraft_base.py:
    20-88`. With a view direction, `fc_5` is a plain linear without
    bias, `fc_viewdir(raydir)` is added to it and `mod_5` (AffineMod)
    modulates the sum; otherwise `fc_5` is a ModLinear.

    Each hidden layer but a view-direction `fc_5` is one call of
    `ops/mlp_ops.py`: the GEMM, the bias or style shift, the first
    layer's label term and the LeakyReLU. Where autograd records nothing
    (grad mode off, or no input and no parameter requiring grad) and the
    layers compute in float32, that is the `sd::render_mlp_gemm` op
    (kernel K6 on CUDA, which writes the activation once; the plain
    composition on the CPU); otherwise the plain composition itself."""

    def __init__(self, in_channels, style_dim, mask_dim, out_channels_c,
                 hidden_channels=256, viewdir_dim=0, use_seg=True,
                 dtype=torch.float32):
        super().__init__()
        hc = hidden_channels
        self.fc_1 = Dense(in_channels, hc, dtype=dtype)
        self.fc_m_a = Dense(mask_dim, hc, bias=False, dtype=dtype) \
            if use_seg else None
        self.fc_2 = ModLinear(hc, hc, style_dim, dtype)
        self.fc_3 = ModLinear(hc, hc, style_dim, dtype)
        self.fc_4 = ModLinear(hc, hc, style_dim, dtype)
        self.fc_sigma = Dense(hc, 1, dtype=dtype)
        if viewdir_dim > 0:
            self.fc_5 = Dense(hc, hc, bias=False, dtype=dtype)
            self.fc_viewdir = Dense(viewdir_dim, hc, bias=False, dtype=dtype)
            self.mod_5 = AffineMod(hc, style_dim, dtype)
        else:
            self.fc_5 = ModLinear(hc, hc, style_dim, dtype)
        self.fc_6 = ModLinear(hc, hc, style_dim, dtype)
        self.fc_out_c = Dense(hc, out_channels_c, dtype=dtype)

    def forward(self, x, z, m, raydir=None):
        """x [B, N, C_in]; z [B, S]; m [B, N, mask_dim] (unused without
        `use_seg`); raydir [B, N, viewdir_dim] when `viewdir_dim` > 0."""
        dt = self.fc_1.compute_dtype
        if dt == torch.float32 and not self._records_grad(x, z, m, raydir):
            layer = mlp_ops.render_mlp_gemm
        else:
            layer = functools.partial(mlp_ops.render_mlp_gemm_plain,
                                      act=leaky_relu)
        label = () if self.fc_m_a is None else (m.to(dt),
                                                self.fc_m_a.weight.to(dt))
        f = layer(x.to(dt), self.fc_1.weight.to(dt), self.fc_1.bias.to(dt),
                  *label)
        f = layer(f, *self.fc_2.modulation(z))
        f = layer(f, *self.fc_3.modulation(z))
        f = layer(f, *self.fc_4.modulation(z))
        sigma = self.fc_sigma(f)
        if isinstance(self.fc_5, ModLinear):
            f = layer(f, *self.fc_5.modulation(z))
        else:
            f = self.fc_5(f) + self.fc_viewdir(raydir)
            f = leaky_relu(self.mod_5(f, z))
        f = layer(f, *self.fc_6.modulation(z))
        return sigma, self.fc_out_c(f)

    def _records_grad(self, *inputs):
        """Whether autograd would record this forward."""
        if not torch.is_grad_enabled():
            return False
        return any(t is not None and t.requires_grad for t in inputs) \
            or any(p.requires_grad for p in self.parameters())


class StyleMLP(nn.Module):
    """Style code -> intermediate style (reference gancraft_base.py:91-126)."""

    def __init__(self, style_dim, out_dim, hidden_channels=256,
                 num_layers=5, dtype=torch.float32):
        super().__init__()
        dims = [style_dim] + [hidden_channels] * num_layers
        self.fc_layers = nn.ModuleList(
            [Dense(dims[i], dims[i + 1], dtype=dtype)
             for i in range(num_layers)])
        self.fc_out = Dense(hidden_channels, out_dim, dtype=dtype)

    def forward(self, z):
        z = z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True),
                            min=1e-12)
        for fc in self.fc_layers:
            z = leaky_relu(fc(z))
        return leaky_relu(self.fc_out(z))


class SKYMLP(nn.Module):
    """Ray-direction embedding -> sky color feature
    (reference gancraft_base.py:129-169)."""

    def __init__(self, in_channels, style_dim, out_channels_c=3,
                 hidden_channels=256, dtype=torch.float32):
        super().__init__()
        hc = hidden_channels
        self.fc_z_a = Dense(style_dim, hc, bias=False, dtype=dtype)
        self.fc1 = Dense(in_channels, hc, dtype=dtype)
        self.fc2 = Dense(hc, hc, dtype=dtype)
        self.fc3 = Dense(hc, hc, dtype=dtype)
        self.fc4 = Dense(hc, hc, dtype=dtype)
        self.fc5 = Dense(hc, hc, dtype=dtype)
        self.fc_out_c = Dense(hc, out_channels_c, dtype=dtype)

    def forward(self, x, z):
        """x [B, ..., C_pe]; z [B, S]."""
        zf = self.fc_z_a(z)
        zf = zf.reshape((zf.shape[0],) + (1,) * (x.dim() - 2)
                        + (zf.shape[-1],))
        y = leaky_relu(self.fc1(x) + zf)
        for fc in (self.fc2, self.fc3, self.fc4, self.fc5):
            y = leaky_relu(fc(y))
        return self.fc_out_c(y)


class SRTConvBlock(nn.Module):
    """conv(s1)-relu-conv(s2)-relu (reference model_utils/layers.py:6-23);
    NCHW inside the world encoder."""

    def __init__(self, in_channels, hdim, odim, dtype=torch.float32):
        super().__init__()
        self.layers = nn.Sequential(
            Conv(in_channels, hdim, 3, stride=1, padding=1, bias=False,
                 dtype=dtype),
            nn.ReLU(),
            Conv(hdim, odim, 3, stride=2, padding=1, bias=False,
                 dtype=dtype),
            nn.ReLU())

    def forward(self, x):
        return self.layers(x)


class ConditionalHashGrid(nn.Module):
    """BEV height + semantic one-hot -> 2-d tanh scene code
    (reference model_utils/layers.py:25-55). Inputs NHWC: height
    [B, S, S, 1], semantic [B, S, S, 11]."""

    def __init__(self, num_conv_blocks=6, dtype=torch.float32):
        super().__init__()
        self.hconv_head = Conv(1, 8, 3, stride=2, padding=1, dtype=dtype)
        self.sconv_head = Conv(11, 8, 3, stride=2, padding=1, dtype=dtype)
        cur = 16
        blocks = []
        for _ in range(1, num_conv_blocks):
            blocks.append(SRTConvBlock(cur, cur, 2 * cur, dtype))
            cur *= 2
        self.conv_blocks = nn.ModuleList(blocks)
        self.fc1 = Dense(cur, 16, dtype=dtype)
        self.fc2 = Dense(16, 2, dtype=dtype)

    def forward(self, height, semantic):
        h = leaky_relu(self.hconv_head(height.permute(0, 3, 1, 2)))
        s = leaky_relu(self.sconv_head(semantic.permute(0, 3, 1, 2)))
        joint = torch.cat([h, s], dim=1)
        for block in self.conv_blocks:
            joint = leaky_relu(block(joint))
        pooled = joint.mean(dim=(2, 3))
        return torch.tanh(self.fc2(leaky_relu(self.fc1(pooled))))


class RenderCNN(nn.Module):
    """Style-modulated 2-D refinement CNN over the composited feature map
    (reference gancraft_base.py:172-225). Input NHWC [B, H, W, C]."""

    def __init__(self, in_channels, style_dim, hidden_channels=256,
                 out_channels=3, dtype=torch.float32):
        super().__init__()
        hc = hidden_channels
        self.fc_z_cond = Dense(style_dim, 4 * hc, dtype=dtype)
        self.conv1 = Conv(in_channels, hc, 1, dtype=dtype)
        self.conv2a = Conv(hc, hc, 3, padding=1, dtype=dtype)
        self.conv2b = Conv(hc, hc, 3, padding=1, bias=False, dtype=dtype)
        self.conv3a = Conv(hc, hc, 3, padding=1, dtype=dtype)
        self.conv3b = Conv(hc, hc, 3, padding=1, bias=False, dtype=dtype)
        self.conv4a = Conv(hc, hc, 1, dtype=dtype)
        self.conv4b = Conv(hc, hc, 1, dtype=dtype)
        self.conv4 = Conv(hc, out_channels, 1, dtype=dtype)

    def forward(self, x, z):
        a0, b0, a1, b1 = self.fc_z_cond(z)[:, :, None, None].chunk(4, dim=1)
        y = leaky_relu(self.conv1(x.permute(0, 3, 1, 2)))
        y = y + self.conv2b(leaky_relu(self.conv2a(y)))
        y = leaky_relu(y * (a0 + 1.0) + b0)
        y = y + self.conv3b(leaky_relu(self.conv3a(y)))
        y = leaky_relu(y * (a1 + 1.0) + b1)
        y = y + self.conv4b(leaky_relu(self.conv4a(y)))
        return self.conv4(leaky_relu(y)).permute(0, 2, 3, 1)


class StyleEncoder(nn.Module):
    """Image -> (mu, logvar, z), the VAE style encoder (reference
    gancraft_base.py:228-293). Input NHWC [B, 256, 256, 3]; other sizes
    are resized to 256 first as `jax.image.resize(..., 'bilinear')`
    does. Six stride-2 3x3 convs (`layer1..6`), then `fc_mu` / `fc_var`
    on the NCHW flatten (the reference's order; the JAX package flattens
    NHWC and its converter permutes the rows). logvar is clamped to
    [-10, logvar_clamp] (the JAX package's guard against an e^logvar
    overflow; 0 disables it). The convs compute in `dtype`, `fc_mu` and
    `fc_var` in float32, as in JAX."""

    def __init__(self, style_dims=128, num_filters=64, kernel_size=3,
                 logvar_clamp=4.0, dtype=torch.float32):
        super().__init__()
        nf = num_filters
        chans = [3, nf, 2 * nf, 4 * nf, 8 * nf, 8 * nf, 8 * nf]
        for i in range(6):
            setattr(self, f'layer{i + 1}',
                    Conv(chans[i], chans[i + 1], kernel_size, stride=2,
                         padding=kernel_size // 2, dtype=dtype))
        self.fc_mu = Dense(8 * nf * 4 * 4, style_dims)
        self.fc_var = Dense(8 * nf * 4 * 4, style_dims)
        self.logvar_clamp = logvar_clamp

    def forward(self, x, eps=None, generator=None):
        """x [B, H, W, 3]; eps [B, style_dims] standard normal draws of
        the reparameterisation (drawn from `generator` when None)."""
        if x.shape[1] != 256 or x.shape[2] != 256:
            x = resize_bilinear(x, (256, 256))
        y = x.permute(0, 3, 1, 2)
        for i in range(6):
            y = leaky_relu(getattr(self, f'layer{i + 1}')(y))
        y = y.reshape(y.shape[0], -1)
        mu = self.fc_mu(y)
        logvar = self.fc_var(y)
        if self.logvar_clamp > 0:
            logvar = torch.clamp(logvar, -10.0, self.logvar_clamp)
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator,
                              device=std.device, dtype=std.dtype)
        return mu, logvar, mu + eps * std
