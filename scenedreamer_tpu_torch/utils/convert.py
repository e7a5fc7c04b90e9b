"""Flax params of the JAX package's generator -> this port's state dict.

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
  * style net `fc_<i>` -> `fc_layers.<i>`.
The style encoder's leaves are skipped: it is not part of the inference
path, and the port has no StyleEncoder yet.
"""
import re

import numpy as np
import torch

_SKIP = ('style_encoder',)


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
        if path[0] in _SKIP:
            continue
        arr = np.array(leaf, dtype=np.float32)
        if path[-1] == 'kernel':
            path = path[:-1] + ['weight']
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        sd['.'.join(_rename(path))] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return sd
