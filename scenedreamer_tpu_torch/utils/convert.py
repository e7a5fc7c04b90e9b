"""Flax variables of the JAX package's models -> this port's state dicts.

The inverse of `convert_scenedreamer_generator` in
`scenedreamer_tpu/utils/convert.py:116-209`, written against the layout
rules alone (no import of it): the port's modules carry the reference
names, so the mapping is
  * `hash_table` -> `hash_encoder.embeddings`;
  * flax conv kernel [kh, kw, I, O] -> torch weight [O, I, kh, kw];
  * flax `nn.Dense` kernel [in, out] -> torch weight [out, in] (the
    generator's own `Dense` already stores [out, in] and is copied);
  * ModLinear / AffineMod leaves by name;
  * world encoder `block_<i>.Conv_<j>` -> `conv_blocks.<i-1>.layers.<2j>`;
  * style net `fc_<i>` -> `fc_layers.<i>`;
  * style encoder `fc_mu` / `fc_var` weights: the JAX package flattens
    the last [4, 4, C] feature map NHWC, the port (and the reference)
    NCHW, so their columns are permuted (`convert.py:184-198` there).
`discriminator_state_dict_from_flax` and `vgg_state_dict_from_flax` map
the JAX discriminator (with its spectral-norm power-iteration vectors)
and VGG19 feature extractor onto `models/discriminator.py` and
`models/vgg.py`; `spade_state_dict_from_flax` maps the frozen SPADE
oracle's params and stored batch-norm statistics onto `models/spade.py`
(the inverse of `convert_spade`, `convert.py:232-322` there).
"""
import re

import numpy as np
import torch

STYLE_ENC_SPATIAL = 4       # the style encoder's last map: 256 / 2^6


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


def _torch_layout(path, leaf):
    """A flax `kernel` in torch layout (conv HWIO -> OIHW, dense
    [in, out] -> [out, in]); any other leaf as float32."""
    arr = np.array(leaf, dtype=np.float32)
    if path[-1] == 'kernel':
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return arr


def _tensor(arr):
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


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
            sn = sn['SpectralNorm_0']
            sd[f'fpse.{name}.weight_u'] = _tensor(
                np.asarray(sn['Conv_0/kernel/u'], np.float32))
            sd[f'fpse.{name}.weight_sigma'] = _tensor(
                np.asarray(sn['Conv_0/kernel/sigma'], np.float32))
    return sd


def vgg_state_dict_from_flax(params):
    """`VGG19Features` params ({'params': {'conv<i>': ...}} or the inner
    dict) -> the state dict of `models/vgg.VGG19Features`."""
    params = params.get('params', params)
    return {f'{name}.{"weight" if leaf == "kernel" else leaf}':
            _tensor(_torch_layout([leaf], v))
            for name, sub in params.items() for leaf, v in sub.items()}


def spade_state_dict_from_flax(variables):
    """`SPADEWrapper` variables {'params': ..., 'batch_stats': ...} in the
    frozen layout (numpy-convertible leaves) -> the state dict of
    `models/spade.SPADEWrapper`, whose names are the reference's:
      * conv / dense `kernel` -> `<block>.layers.conv.weight` in torch
        layout, `bias` beside it;
      * SpadeNorm `mlp` / `gamma` / `beta` -> `mlps.0.0` / `gammas.0` /
        `betas.0` (`.layers.conv`);
      * res block `conv{0,1,_s}` + `norm{0,1,_s}` -> `conv_block_{0,1,s}
        .layers.{conv,norm}`;
      * batch_stats mean / var / scale / offset -> `norm.running_mean` /
        `running_var` / `weight` / `bias`.
    The style encoder's leaves, if present, are ignored (not ported)."""
    params = variables['params']['spade_generator']
    stats = variables.get('batch_stats', {}).get('spade_generator', {})
    sd = {}

    def put(prefix, leaf_dict):
        for leaf, v in leaf_dict.items():
            name = 'weight' if leaf == 'kernel' else leaf
            sd[f'{prefix}.{name}'] = _tensor(_torch_layout([leaf], v))

    def put_bn(prefix, st):
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
            put_bn(f'{top}.layers.norm.norm', stats[name]['norm']['norm'])
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
                put_bn(f'{nk}.norm', stats[name][norm]['norm'])
        else:                       # fc_0, fc_1, head_0, conv_img*
            put(f'{top}.layers.conv', sub)
    return sd
