"""The forward hash-grid kernels as `torch.library` ops, namespace `sd`.

    sd::hash_bake            K2 (a)   csrc/hashgrid_fwd.cu
    sd::hash_shift_bake      K5 (a)   csrc/hashgrid_paired.cu
    sd::hash_encode          K2 (b)   csrc/hashgrid_fwd.cu
    sd::hash_encode_paired   K5 (b)   csrc/hashgrid_paired.cu
    sd::hash_encode_general  K4 (a)   csrc/hashgrid_general.cu

Each op has three implementations: for CUDA tensors the wrapper of
`kernels.py`, which launches the kernel (or raises) and counts the
launch under its own name; for CPU tensors the plain PyTorch version of
`ops/hashgrid.py`; and a fake one that gives the output's shape and
dtype, so that `torch.export` traces through the op (it cannot trace a
ctypes launch) and a saved program names it. The forwards of the
autograd Functions in `ops/hashgrid.py` call these ops on every device,
so the live path and an exported program are one path. The backward
kernels stay plain wrapper calls: nothing exports a gradient.

Importing this module registers the ops and needs neither nvcc nor a
build (`kernels.py` builds at the first launch). A process that loads a
saved program naming them imports it first: `torch.export.load` refuses
an unknown op. `TiledRenderer.load_exported` does so.

The encode ops take the scene code's out-of-bounds flag as a 0-d bool
tensor and zero every output row with it without reading it on the
host: the plain version masks its output, the CUDA one moves every
point out of bounds before a launch with the flag 0 (a pass over the
[N, 3] points, 24 bytes a point where masking the output would move
8 L C), and the kernel writes zeros for such points.
"""
import torch
from torch import Tensor

from scenedreamer_tpu_torch import kernels

_FWD = dict(mutates_args=(), device_types='cpu')


# the plain versions live in ops/hashgrid.py, which imports this module:
# they are imported at the call

@torch.library.custom_op('sd::hash_bake', **_FWD)
def hash_bake(table3: Tensor, masks: Tensor, weights: Tensor) -> Tensor:
    """K2 (a): table3 [L, S, C], xor masks [L, A] int, weights [L, A] ->
    the baked table [L, S, C]."""
    from scenedreamer_tpu_torch.ops.hashgrid import bake_plain
    return bake_plain(table3, masks, weights)


@torch.library.custom_op('sd::hash_shift_bake', **_FWD)
def hash_shift_bake(table3: Tensor, shifts: Tensor,
                    weights: Tensor) -> Tensor:
    """K5 (a): as `hash_bake` with cyclic shifts [L, A] in [0, S)."""
    from scenedreamer_tpu_torch.ops.hashgrid import shift_bake_plain
    return shift_bake_plain(table3, shifts, weights)


@torch.library.custom_op('sd::hash_encode', **_FWD)
def hash_encode(baked: Tensor, xyz: Tensor, scales: Tensor, offset: float,
                bound: float, scene_oob: Tensor) -> Tensor:
    """K2 (b): points xyz [N, 3] against the baked table [L, S, C], level
    scales [L] -> [N, L*C], zero rows for points out of bounds and, when
    the 0-d bool `scene_oob` is set, for every point."""
    from scenedreamer_tpu_torch.ops.hashgrid import encode_plain
    return encode_plain(baked, xyz, scales, offset, bound, scene_oob)


@torch.library.custom_op('sd::hash_encode_paired', **_FWD)
def hash_encode_paired(baked: Tensor, xyz: Tensor, scales: Tensor,
                       offset: float, bound: float,
                       scene_oob: Tensor) -> Tensor:
    """K5 (b): as `hash_encode` under the paired hash."""
    from scenedreamer_tpu_torch.ops.hashgrid import paired_encode_plain
    return paired_encode_plain(baked, xyz, scales, offset, bound, scene_oob)


@torch.library.custom_op('sd::hash_encode_general', **_FWD)
def hash_encode_general(table: Tensor, x: Tensor, meta: Tensor,
                        scales: Tensor, offset: float, bound: float,
                        xor_hash: bool) -> Tensor:
    """K4 (a): points x [N, D] against the table [rows, C] -> [N, L*C];
    meta [L, 11] int64 and scales [L] float32 on the CPU, as
    `ops/hashgrid.py:general_meta` packs a spec; `xor_hash` False for
    the paired (add) hash."""
    from scenedreamer_tpu_torch.ops.hashgrid import (encode_levels_plain,
                                                     meta_levels)
    return encode_levels_plain(meta_levels(meta, scales, x.shape[1]), table,
                               x, offset, bound,
                               'xor' if xor_hash else 'paired')


@hash_bake.register_kernel('cuda')
def _(table3, masks, weights):
    return kernels.hash_bake(table3.contiguous(),
                             masks.to(torch.int32).contiguous(),
                             weights.contiguous())


@hash_shift_bake.register_kernel('cuda')
def _(table3, shifts, weights):
    return kernels.hash_shift_bake(table3.contiguous(),
                                   shifts.to(torch.int32).contiguous(),
                                   weights.contiguous())


def _launch_encode(launch, baked, xyz, scales, offset, bound, scene_oob):
    # an infinite coordinate is out of bounds: the kernel writes zeros
    xyz = torch.where(scene_oob, float('inf'), xyz)
    return launch(baked.contiguous(), xyz.contiguous(), scales.contiguous(),
                  offset, bound, False)


@hash_encode.register_kernel('cuda')
def _(baked, xyz, scales, offset, bound, scene_oob):
    return _launch_encode(kernels.hash_encode, baked, xyz, scales, offset,
                          bound, scene_oob)


@hash_encode_paired.register_kernel('cuda')
def _(baked, xyz, scales, offset, bound, scene_oob):
    return _launch_encode(kernels.hash_encode_paired, baked, xyz, scales,
                          offset, bound, scene_oob)


@hash_encode_general.register_kernel('cuda')
def _(table, x, meta, scales, offset, bound, xor_hash):
    return kernels.hash_encode_general(table.contiguous(), x.contiguous(),
                                       meta, scales, offset, bound, xor_hash)


@hash_bake.register_fake
def _(table3, masks, weights):
    return torch.empty_like(table3)


@hash_shift_bake.register_fake
def _(table3, shifts, weights):
    return torch.empty_like(table3)


@hash_encode.register_fake
def _(baked, xyz, scales, offset, bound, scene_oob):
    return xyz.new_empty((xyz.shape[0], baked.shape[0] * baked.shape[2]),
                         dtype=torch.float32)


@hash_encode_paired.register_fake
def _(baked, xyz, scales, offset, bound, scene_oob):
    return xyz.new_empty((xyz.shape[0], baked.shape[0] * baked.shape[2]),
                         dtype=torch.float32)


@hash_encode_general.register_fake
def _(table, x, meta, scales, offset, bound, xor_hash):
    return x.new_empty((x.shape[0], meta.shape[0] * table.shape[1]),
                       dtype=torch.float32)
