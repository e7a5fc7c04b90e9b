"""Flax variables of the JAX package's models -> this port's state dicts.

The inverse of `convert_scenedreamer_generator` in
`scenedreamer_tpu/utils/convert.py:116-209`, written against the layout
rules alone (no import of it): the port's modules carry the reference
names, so the mapping is
  * `hash_table` -> `hash_encoder.embeddings`;
  * flax conv kernel [kh, kw, I, O] -> torch weight [O, I, kh, kw];
  * flax `nn.Dense` kernel [in, out] -> torch weight [out, in] (the
    generator's own `Dense` already stores [out, in] and is copied);
  * ModLinear / AffineMod leaves by name (with a view direction the
    RenderMLP's `fc_5`, `fc_viewdir` and `mod_5`; without `use_seg` no
    `fc_m_a`);
  * world encoder `block_<i>.Conv_<j>` -> `conv_blocks.<i-1>.layers.<2j>`;
  * style net `fc_<i>` -> `fc_layers.<i>`;
  * style encoder `fc_mu` / `fc_var` weights: the JAX package flattens
    the last [4, 4, C] feature map NHWC, the port (and the reference)
    NCHW, so their columns are permuted (`convert.py:184-198` there).
`discriminator_state_dict_from_flax` and `vgg_state_dict_from_flax` map
the JAX discriminator (with its spectral-norm power-iteration vectors)
and VGG19 feature extractor onto `models/discriminator.py` and
`models/vgg.py`; `spade_state_dict_from_flax` maps the SPADE generator's
params and batch-norm statistics, frozen or trainable, with its style
encoder, onto `models/spade.py` (the inverse of `convert_spade`,
`convert.py:232-322` there), and
`multiscale_discriminator_state_dict_from_flax` the SPADE trainer's
discriminator onto `train/gan_losses.py`, and `blocks_state_dict_from_flax`
any module of the layer library onto `models/blocks.py` /
`models/blocks_ext.py`. `spade_frozen_from_trained`
folds a trained port SPADE (`train/spade_trainer.py`) into the frozen
oracle's state dict (JAX `convert.py:345-382`).

`load_reference_generator_state_dict` reads the reference's own
generator state dict (`scenedreamer_released.pt`'s `net_G`, or a bare
dict) into the port's names: wrappers stripped and spectral norm folded
as `strip_prefixes` / `fold_spectral_norm` do in the JAX package
(`convert.py:39-80`, copied here), then each name variant that its
`convert_scenedreamer_generator` accepts mapped onto the port's module.
`load_reference_spade_state_dict` does the same for the reference's
SPADE oracle (the landscape1m checkpoint's `net_G`; JAX `convert_spade`
+ `load_torch_checkpoint`, `convert.py:232-343` there).
"""
import re

import numpy as np
import torch

STYLE_ENC_SPATIAL = 4       # the style encoder's last map: 256 / 2^6

# the generator's top-level modules; a reference key outside them is not
# a generator weight and is dropped, as the JAX converter ignores it
GENERATOR_MODULES = ('hash_encoder', 'render_net', 'world_encoder', 'sky_net',
                     'style_net', 'style_encoder', 'denoiser')


def _rename(path):
    if path == ['hash_table']:
        return ['hash_encoder', 'embeddings']
    out = []
    for i, p in enumerate(path):
        top = path[0]
        m = re.fullmatch(r'block_(\d+)', p)
        if top == 'world_encoder' and m:
            out += ['conv_blocks', str(int(m.group(1)) - 1)]
            continue
        m = re.fullmatch(r'Conv_(\d+)', p)
        if top == 'world_encoder' and m:
            out += ['layers', str(2 * int(m.group(1)))]
            continue
        m = re.fullmatch(r'fc_(\d+)', p)
        if top == 'style_net' and m and i == 1:
            out += ['fc_layers', m.group(1)]
            continue
        out.append(p)
    return out


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _leaves(v, path + (k,))
        else:
            yield list(path + (k,)), v


def generator_state_dict_from_flax(params):
    """{'params': {...}} (or the inner dict) of numpy-convertible leaves
    -> {name: torch.Tensor} for `SceneDreamerGenerator.load_state_dict`."""
    tree = params.get('params', params)
    sd = {}
    for path, leaf in _leaves(tree):
        arr = _torch_layout(path, leaf)
        if path[-1] == 'kernel':
            path = path[:-1] + ['weight']
        if path[0] == 'style_encoder' and path[1] in ('fc_mu', 'fc_var') \
                and path[-1] == 'weight':
            hw = STYLE_ENC_SPATIAL
            arr = arr.reshape(arr.shape[0], hw, hw, -1) \
                .transpose(0, 3, 1, 2).reshape(arr.shape[0], -1)
        sd['.'.join(_rename(path))] = _tensor(arr)
    return sd


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def strip_prefixes(sd):
    """Remove DDP/EMA wrappers: 'module.', 'averaged_model.', 'model.'."""
    out = {}
    for k, v in sd.items():
        for pre in ('module.', 'averaged_model.', 'model.'):
            while k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def fold_spectral_norm(sd):
    """Replace `w_orig`/`w_u`/`w_v` triplets with w_orig / sigma, in
    float64: torch's eval-mode value sigma = u . (W v) with the STORED u
    and v (`torch.nn.utils.spectral_norm`, no power iteration); without
    v, one power half-iteration from u recovers it."""
    out = dict(sd)
    for k in list(sd.keys()):
        if k.endswith('weight_orig'):
            base = k[:-len('_orig')]
            w = _np(sd[k]).astype(np.float64)
            u = _np(sd[base + '_u']) if base + '_u' in sd else None
            v = _np(sd[base + '_v']) if base + '_v' in sd else None
            mat = w.reshape(w.shape[0], -1)
            if u is None:
                u = np.random.default_rng(0).normal(size=mat.shape[0])
                u /= np.linalg.norm(u)
            if v is None:
                v = mat.T @ u
                v /= max(np.linalg.norm(v), 1e-12)
            sigma = float(u @ (mat @ v))
            # torch divides by sigma signed and unclamped; a barely-
            # iterated u/v pair can give a tiny or negative estimate
            if abs(sigma) < 1e-12:
                sigma = 1e-12 if sigma >= 0 else -1e-12
            out[base] = (w / sigma).astype(np.float32)
            out.pop(k, None)
            out.pop(base + '_u', None)
            out.pop(base + '_v', None)
    return out


def _reference_name(key):
    """A reference generator key -> the port's name (None: not a
    generator weight). The style encoder's convs may sit under
    `.layers.conv`, its `fc_mu` / `fc_var` under `.fc` or
    `.layers.linear` (`convert.py:175-200` there); every other module
    already has the reference's names."""
    parts = key.split('.')
    if parts[0] not in GENERATOR_MODULES:
        return None
    if parts[0] == 'style_encoder':
        m = re.fullmatch(r'style_encoder\.(layer\d|fc_mu|fc_var)'
                         r'(?:\.layers\.conv|\.layers\.linear|\.fc)?'
                         r'\.(weight|bias)', key)
        if m:
            return f'style_encoder.{m.group(1)}.{m.group(2)}'
    return key


def load_reference_generator_state_dict(sd_or_ckpt):
    """The reference's generator weights, `{'net_G': state_dict}` or the
    bare state dict, -> a state dict that `SceneDreamerGenerator` loads
    with `strict=True`: prefixes stripped, spectral norm folded, name
    variants mapped (`_reference_name`). The style encoder's `fc_mu` /
    `fc_var` weights are not permuted: the port flattens NCHW, as the
    reference does. A generator that takes the ray direction
    (`render_net.fc_viewdir`, `fc_5` without bias, `mod_5`) loads into a
    config with `pe_lvl_raydir` > 0 or `pe_incl_orig_raydir`, as JAX's
    converter maps it (`convert.py:132-136` there)."""
    sd = sd_or_ckpt.get('net_G', sd_or_ckpt)
    sd = fold_spectral_norm(strip_prefixes(sd))
    out = {}
    for k, v in sd.items():
        name = _reference_name(k)
        if name is not None:
            out[name] = torch.from_numpy(
                np.array(_np(v), dtype=np.float32, order='C'))
    return out


def load_reference_spade_state_dict(sd_or_ckpt):
    """The reference's SPADE weights, `{'net_G': state_dict, ...}` (the
    released landscape1m checkpoint, optimizer and scheduler state
    beside it) or the bare state dict, -> a state dict that the frozen
    `models/spade.SPADEWrapper` loads with `strict=True` (with
    `style_encoder=True` when the file carries one): prefixes stripped
    and spectral norm folded (`strip_prefixes`, `fold_spectral_norm`),
    and a batch norm without affine weight / bias given ones / zeros, as
    JAX's `convert_spade` (`_bn_stats`) reads it. The port's names are
    the reference's (the style encoder's `fc_mu` / `fc_var` flatten NCHW
    in both), so no key is renamed and no weight permuted. Dropped, as
    JAX's converter ignores them: keys outside `spade_generator.` and
    `style_encoder.` (other nets, optimizer state) and the batch norms'
    `num_batches_tracked`. The port's own frozen state dict passes
    through unchanged."""
    sd = sd_or_ckpt.get('net_G', sd_or_ckpt)
    sd = fold_spectral_norm(strip_prefixes(sd))
    out = {k: torch.from_numpy(np.ascontiguousarray(_np(v), np.float32))
           for k, v in sd.items()
           if k.split('.')[0] in ('spade_generator', 'style_encoder')
           and not k.endswith('.num_batches_tracked')}
    for k in [k for k in out if k.endswith('.running_mean')]:
        norm = k[:-len('.running_mean')]
        out.setdefault(f'{norm}.weight', torch.ones_like(out[k]))
        out.setdefault(f'{norm}.bias', torch.zeros_like(out[k]))
    return out


def _torch_layout(path, leaf):
    """A flax `kernel` in torch layout (conv HWIO -> OIHW, dense
    [in, out] -> [out, in]); any other leaf as float32."""
    arr = np.array(leaf, dtype=np.float32)
    if path[-1] == 'kernel':
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return arr


def _tensor(arr):
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def _sn_buffers(prefix, sn, conv):
    """flax `SpectralNorm` state of its wrapped module `conv` (leaves
    `<conv>/kernel/u` [1, O] and `<conv>/kernel/sigma` []) -> the port's
    buffers `<prefix>.weight_u` and `<prefix>.weight_sigma`."""
    return {f'{prefix}.weight_{w}': _tensor(
        np.asarray(sn[f'{conv}/kernel/{w}'], np.float32))
        for w in ('u', 'sigma')}


def discriminator_state_dict_from_flax(params, spectral_stats):
    """`GANcraftDiscriminator` variables (params and the `spectral_stats`
    collection, each with or without its top-level key) -> the state dict
    of `models/discriminator.GANcraftDiscriminator`: `fpse.<conv>.weight`
    [O, I, kh, kw] and `.bias`, and per spectral-normed conv the buffers
    `weight_u` [1, O] and `weight_sigma` []."""
    params = params.get('params', params)
    stats = spectral_stats.get('spectral_stats', spectral_stats)
    sd = {}
    for name, sub in params['fpse'].items():
        conv = sub['Conv_0']
        sd[f'fpse.{name}.weight'] = _tensor(
            _torch_layout(['kernel'], conv['kernel']))
        sd[f'fpse.{name}.bias'] = _tensor(np.asarray(conv['bias'],
                                                     np.float32))
        sn = stats.get('fpse', {}).get(name)
        if sn is not None:
            sd.update(_sn_buffers(f'fpse.{name}', sn['SpectralNorm_0'],
                                  'Conv_0'))
    return sd


def vgg_state_dict_from_flax(params):
    """`VGG19Features` params ({'params': {'conv<i>': ...}} or the inner
    dict) -> the state dict of `models/vgg.VGG19Features`."""
    params = params.get('params', params)
    return {f'{name}.{"weight" if leaf == "kernel" else leaf}':
            _tensor(_torch_layout([leaf], v))
            for name, sub in params.items() for leaf, v in sub.items()}


def spade_state_dict_from_flax(variables):
    """`SPADEWrapper` variables {'params': ..., 'batch_stats': ...}
    (numpy-convertible leaves), frozen or trainable, -> the state dict of
    `models/spade.SPADEWrapper` of the same `bn_mode`, whose names are the
    reference's:
      * conv / dense `kernel` -> `<block>.layers.conv.weight` in torch
        layout, `bias` beside it;
      * SpadeNorm `mlp` / `gamma` / `beta` -> `mlps.0.0` / `gammas.0` /
        `betas.0` (`.layers.conv`);
      * res block `conv{0,1,_s}` + `norm{0,1,_s}` -> `conv_block_{0,1,s}
        .layers.{conv,norm}`;
      * batch norm -> `norm.running_mean` / `running_var` / `weight` /
        `bias`: frozen, all four from batch_stats mean / var / scale /
        offset; trainable (flax `nn.BatchNorm`), mean / var from
        batch_stats and scale / bias from params;
      * the style encoder, when present: `style_encoder.layer<i>` and
        `fc_mu` / `fc_var` (`.layers.conv`), whose weights' columns are
        permuted from JAX's NHWC flatten to the port's NCHW."""
    params = variables['params']['spade_generator']
    stats = variables.get('batch_stats', {}).get('spade_generator', {})
    sd = {}

    def put(prefix, leaf_dict):
        for leaf, v in leaf_dict.items():
            name = 'weight' if leaf == 'kernel' else leaf
            sd[f'{prefix}.{name}'] = _tensor(_torch_layout([leaf], v))

    def put_bn(prefix, st, affine):
        st = dict(st)
        if affine is not None:             # trainable: scale / bias params
            st['scale'], st['offset'] = affine['scale'], affine['bias']
        for src, dst in (('mean', 'running_mean'), ('var', 'running_var'),
                         ('scale', 'weight'), ('offset', 'bias')):
            sd[f'{prefix}.{dst}'] = _tensor(np.asarray(st[src], np.float32))

    for name, sub in params.items():
        top = f'spade_generator.{name}'
        if name.startswith('cbn_'):
            put(f'{top}.layers.conv', sub['conv'])
            put(f'{top}.layers.norm.fc_gamma.layers.conv',
                sub['norm']['fc_gamma'])
            put(f'{top}.layers.norm.fc_beta.layers.conv',
                sub['norm']['fc_beta'])
            put_bn(f'{top}.layers.norm.norm', stats[name]['norm']['norm'],
                   sub['norm'].get('norm'))
        elif 'conv0' in sub:
            for conv, norm, block in (('conv0', 'norm0', 'conv_block_0'),
                                      ('conv1', 'norm1', 'conv_block_1'),
                                      ('conv_s', 'norm_s', 'conv_block_s')):
                if conv not in sub:
                    continue
                put(f'{top}.{block}.layers.conv', sub[conv])
                nk = f'{top}.{block}.layers.norm'
                put(f'{nk}.mlps.0.0.layers.conv', sub[norm]['mlp'])
                put(f'{nk}.gammas.0.layers.conv', sub[norm]['gamma'])
                put(f'{nk}.betas.0.layers.conv', sub[norm]['beta'])
                put_bn(f'{nk}.norm', stats[name][norm]['norm'],
                       sub[norm].get('norm'))
        else:                       # fc_0, fc_1, head_0, conv_img*
            put(f'{top}.layers.conv', sub)
    enc = variables['params'].get('style_encoder')
    if enc is not None:
        for name, sub in enc.items():
            put(f'style_encoder.{name}.layers.conv', sub)
        hw = STYLE_ENC_SPATIAL
        for name in ('fc_mu', 'fc_var'):
            key = f'style_encoder.{name}.layers.conv.weight'
            w = sd[key]
            sd[key] = w.reshape(w.shape[0], hw, hw, -1).permute(
                0, 3, 1, 2).reshape(w.shape[0], -1).contiguous()
    return sd


def multiscale_discriminator_state_dict_from_flax(params, spectral_stats):
    """`MultiScaleDiscriminator` variables (params and the
    `spectral_stats` collection, each with or without its top-level key)
    -> the state dict of `train/gan_losses.MultiScaleDiscriminator`:
    `dis<d>.layer<i>.weight` [O, I, kh, kw] and `.bias`, the buffers
    `weight_u` [1, O] and `weight_sigma` [], and `dis<d>.output`."""
    params = params.get('params', params)
    stats = spectral_stats.get('spectral_stats', spectral_stats)
    sd = {}
    for d, layers in params.items():
        for name, sub in layers.items():
            conv = sub['Conv_0']
            sd[f'{d}.{name}.weight'] = _tensor(
                _torch_layout(['kernel'], conv['kernel']))
            sd[f'{d}.{name}.bias'] = _tensor(np.asarray(conv['bias'],
                                                        np.float32))
            sn = stats.get(d, {}).get(name)
            if sn is not None:
                sd.update(_sn_buffers(f'{d}.{name}', sn['SpectralNorm_0'],
                                      'Conv_0'))
    return sd


# flax's auto-named norms of `make_norm`, `norm` / `norm_<i>` in the port
_AUTO_NORM = re.compile(r'(GroupNorm|LayerNorm|_FrozenBatchNorm2d)_(\d+)')


def _blocks_key(path):
    out = []
    for p in path:
        m = _AUTO_NORM.fullmatch(p)
        out.append(p if m is None else
                   'norm' if m.group(2) == '0' else f'norm_{m.group(2)}')
    return '.'.join(out)


def blocks_state_dict_from_flax(variables, transposed=()):
    """Variables of a layer-library module of the JAX package
    (`models/blocks.py`, `models/blocks_ext.py`, `models/spade.py:
    DualAdaptiveNorm`): {'params': ..., 'batch_stats': ...,
    'spectral_stats': ...} of numpy-convertible leaves -> the state dict
    of the matching port module (`scenedreamer_tpu_torch/models/blocks*.py`),
    whose names are flax's with `kernel` / `embedding` -> `weight` and the
    auto-named norms (`GroupNorm_0`, `LayerNorm_0`, `_FrozenBatchNorm2d_0`)
    -> `norm`. Leaves:
      * conv kernels of rank 1-3 (*k, I, O) and `wn_v` -> (O, I, *k); a
        4-D `weight` (ModulatedConv2d, HWIO) likewise; dense kernels
        (I, O) -> (O, I); EqualizedDense's 2-D `weight` [O, I] as it is;
      * the kernels of the flax `nn.ConvTranspose` modules at the paths
        in `transposed` ('/'-joined, e.g. 'conv'): flax does not flip
        the kernel, torch's `conv_transpose2d` does, so (kh, kw, I, O) ->
        [I, O, kh, kw] flipped spatially;
      * `const` (1, s, s, C) -> (1, C, s, s); everything else (norm scale
        and bias, embeddings, scalars, `batch_stats` mean / var) as it is;
      * `spectral_stats` `.../SpectralNorm_<i>/<conv>/kernel/u` and
        `sigma` -> `<conv>.weight_u` / `.weight_sigma`.
    The same mapping carries a gradient tree of the params."""
    sd = {}
    for path, leaf in _leaves(variables.get('params', {})):
        *mod, name = path
        arr = np.asarray(leaf, np.float32)
        if name in ('kernel', 'wn_v') or (name == 'weight' and arr.ndim > 2):
            if '/'.join(mod) in transposed:
                arr = np.flip(np.moveaxis(arr, (-2, -1), (0, 1)),
                              tuple(range(2, arr.ndim)))
            else:
                arr = np.moveaxis(arr, (-1, -2), (0, 1))
        elif name == 'const':
            arr = np.moveaxis(arr, -1, 1)
        name = 'weight' if name in ('kernel', 'embedding') else name
        sd[_blocks_key(mod + [name])] = _tensor(arr)
    for path, leaf in _leaves(variables.get('batch_stats', {})):
        sd[_blocks_key(path)] = _tensor(np.asarray(leaf, np.float32))
    for path, sn in _sn_modules(variables.get('spectral_stats', {})):
        for conv in {k.split('/')[0] for k in sn}:
            sd.update(_sn_buffers(_blocks_key(path + [conv]), sn, conv))
    return sd


def _sn_modules(tree, path=()):
    """(path of the parent module, state dict) of each `SpectralNorm_<i>`
    in a `spectral_stats` tree."""
    for k, v in tree.items():
        if re.fullmatch(r'SpectralNorm_\d+', k):
            yield list(path), v
        else:
            yield from _sn_modules(v, path + (k,))


def spade_frozen_from_trained(state):
    """A trained SPADE -> the state dict of the frozen oracle
    (`SPADEWrapper()`, bn_mode 'frozen', no style encoder), which
    `cli/train.py --spade-checkpoint` loads (JAX
    `spade_frozen_from_trained`, `convert.py:345-382`). `state` is a
    `SpadeTrainer.state_dict()` (or a `train_spade` checkpoint): the
    generator's parameters (the EMA's when kept, as JAX's CLI folds
    `g_ema or g_params`) and running statistics. The trainable
    and the frozen batch norm share their names (`weight`, `bias`,
    `running_mean`, `running_var`), and their eval maths agree (eps
    1e-5), so the fold keeps every entry of the SPADE generator and drops
    the style encoder, which the oracle's random styles do not use."""
    sd = dict(state['generator'])
    if state.get('g_ema') is not None:
        sd.update(state['g_ema'])
    return {k: v.detach().clone() for k, v in sd.items()
            if k.startswith('spade_generator.')}
