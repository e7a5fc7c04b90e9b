"""Encoder factory and `trunc_exp`.

Counterpart of `scenedreamer_tpu/ops/encoders.py` (reference
`encoding.py:5-66` and `activation.py:5-17`): the NeRF frequency
encoder, the `get_encoder` factory ('None', 'frequency', 'hashgrid',
'tiledgrid', 'varhashgrid') and `trunc_exp`, exp with a backward that
clamps its input. The grid encoders run the general hash encode of
`ops/hashgrid.py` (kernel K4 on CUDA tensors).
"""
import functools

import torch

from scenedreamer_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode
from scenedreamer_tpu_torch.ops.pe import pe_out_dim, positional_encoding


class _TruncExp(torch.autograd.Function):
    """exp(x) whose gradient clamps the input to +-15 before the backward
    exp, which keeps sigma gradients finite when the MLP spikes."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)


def freq_encode(x, degree=4):
    """NeRF frequency encoding with the raw input appended (output dim
    D + D * 2 * degree)."""
    return positional_encoding(x, degree, incl_orig=True)


def get_encoder(encoding='hashgrid', input_dim=3, degree=4, num_levels=16,
                level_dim=2, base_resolution=16, log2_hashmap_size=19,
                desired_resolution=2048, align_corners=False):
    """Encoder factory. Returns (encode_fn, output_dim, spec or None).
    Grid encoders take (table, x); 'varhashgrid' takes (own_table,
    external, x), the external rows placed ahead of the encoder's own
    (reference `grid.py:211`); 'frequency' and 'None' take (x)."""
    if encoding in (None, 'None'):
        return (lambda x: x), input_dim, None
    if encoding == 'frequency':
        fn = functools.partial(freq_encode, degree=degree)
        return fn, pe_out_dim(input_dim, degree, True), None
    if encoding in ('hashgrid', 'tiledgrid', 'varhashgrid'):
        spec = HashGridSpec.create(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype='tiled' if encoding == 'tiledgrid' else 'hash',
            align_corners=align_corners)
        if encoding != 'varhashgrid':
            return functools.partial(hashgrid_encode, spec), \
                spec.output_dim, spec

        def var_encode(table, external, x):
            return hashgrid_encode(spec, torch.cat([external, table], dim=0),
                                   x)

        return var_encode, spec.output_dim, spec
    raise NotImplementedError(f'encoder {encoding}')
