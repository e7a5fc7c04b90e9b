"""Multiresolution hash-grid encoding, scene-folded, forward and backward.

Counterpart of `scenedreamer_tpu/ops/hashgrid.py` (reference CUDA
`gridencoder/src/gridencoder.cu` + `gridencoder/grid.py`): the same
`HashGridSpec` (per-level resolution, table offsets, the xor `fast_hash`
and the 'paired' ADD-combine hash), `foldable`, `init_hashgrid_table`, and
`hashgrid_encode_folded` with its gradients, which the flagship generator
always takes (D=5, every level hashed at one power-of-two table size).

Every point of a world shares its 2-D scene code, so per level the four
scene-corner rows fold into one baked table,
`B_l[j] = sum_a w_a * T_l[j ^ m_a]`, and each point then needs 8
spatial corners instead of 32 (exact: `% size` is `& (size-1)` and
distributes over xor). The fold is split so a renderer can bake once
per frame and encode many ray chunks against it:

    folded = fold_scene(spec, table, scene)     # bake: kernel K2 (a)
    feats = encode_folded(spec, folded, xyz)    # encode: kernel K2 (b)

Both steps are `torch.autograd.Function`s (`HashBake`, `HashEncode`),
so gradients reach the table, the scene code (through the fold weights,
which `scene_fold_weights` computes in plain differentiable torch) and,
when asked, the points. Their backward is K3: `HashEncode` scatters the
output cotangent into the baked table's rows (K3 (a), and the gradient
through frac for the points), `HashBake` turns that into the table
gradient with the bake itself (K3 (b): xor is its own inverse) and into
the fold-weight gradient (K3 (c)). For CUDA tensors every step launches
the kernels of `csrc/hashgrid_fwd.cu` and `csrc/hashgrid_bwd.cu`; for
CPU tensors it runs the plain PyTorch versions below (index arithmetic,
gathers and `index_add_`, the same float operations). The forwards go
through the `torch.library` ops of `ops/hash_ops.py` (`sd::hash_bake`,
`sd::hash_encode`, and below `sd::hash_shift_bake`,
`sd::hash_encode_paired`, `sd::hash_encode_general`), which pick the
kernel or the plain version by device and let `torch.export` trace the
forward; the backwards call the kernel wrappers directly. The scene
code's out-of-bounds flag stays a 0-d bool tensor on the device, never
read on the host for CUDA tensors: when it is set, the encode and its
backward move every point out of bounds.

`hash_variant='paired'` (K5) combines the per-dimension prime products
with a wrapping uint32 ADD instead of xor. Dimension 0 has prime 1, so
the two x-corners of a cell are the adjacent rows `base` and
`(base + 1) mod S` (cyclic at S-1): a point reads 4 two-row slices per
level, one per (y, z) corner, and the scene fold becomes a blend of
cyclic shifts, `B_l[j] = sum_a w_a * T_l[(j + m_a) mod S]`, whose adjoint
shifts the other way. The same two autograd Functions carry it with
`variant='paired'`; on CUDA they launch the kernels of
`csrc/hashgrid_paired.cu`, on the CPU the plain versions
`shift_bake_plain`, `paired_encode_plain`, `paired_encode_bwd_plain` and
`shift_bake_dw_plain`.

`hashgrid_encode` is the general, unfolded encode (K4) of the JAX
package's `hashgrid_encode`: any input dimension from 1 to 7, per level
a tiled (row-major, stride cut off at the level's size) or hashed index,
levels of any size (`% size`, not a mask, where the size is not a power
of two), gridtype 'tiled', `align_corners`. The generator takes it when
its spec is not foldable (from `hash_log2_size: 21`, level 0's 17^5
cells fit under the cap and are indexed densely), and `ops/encoders.py`
builds its grid encoders on it. Its autograd Function
`HashEncodeGeneral` launches `csrc/hashgrid_general.cu` (K4 (a) forward,
K4 (b) table scatter and point gradient) for CUDA tensors and the plain
versions `encode_general_plain` / `encode_general_bwd_plain` for CPU
tensors.
"""
import collections
import dataclasses
import functools

import numpy as np
import torch

from scenedreamer_tpu_torch import kernels
from scenedreamer_tpu_torch.device import tensor_cache
from scenedreamer_tpu_torch.ops import hash_ops
from scenedreamer_tpu_torch.ops.rounding import fma

# Instant-NGP / reference primes (cu:42); prime 1 keeps dim 0 coherent.
PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
          2165219737)


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    gridtype: str = 'hash'          # 'hash' | 'tiled'
    align_corners: bool = False
    hash_variant: str = 'xor'       # 'xor' (reference) | 'paired'

    @staticmethod
    def create(input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
               log2_hashmap_size=19, desired_resolution=None,
               per_level_scale=2.0, gridtype='hash', align_corners=False,
               hash_variant='xor'):
        if desired_resolution is not None:
            per_level_scale = float(np.exp2(
                np.log2(desired_resolution / base_resolution)
                / (num_levels - 1)))
        return HashGridSpec(input_dim, num_levels, level_dim,
                            base_resolution, log2_hashmap_size,
                            float(per_level_scale), gridtype, align_corners,
                            hash_variant)

    @property
    def max_params(self):
        return 2 ** self.log2_hashmap_size

    @property
    def output_dim(self):
        return self.num_levels * self.level_dim

    def level_resolution(self, level):
        scale = np.exp2(level * np.log2(self.per_level_scale)) \
            * self.base_resolution - 1.0
        return int(np.ceil(scale)) + 1, float(scale)

    def offsets(self):
        """Per-level start offsets into the flat table (reference
        grid.py:113-123)."""
        offs, off = [], 0
        for lv in range(self.num_levels):
            res, _ = self.level_resolution(lv)
            side = res if self.align_corners else res + 1
            n = min(self.max_params, side ** self.input_dim)
            n = int(np.ceil(n / 8) * 8)
            offs.append(off)
            off += n
        offs.append(off)
        return np.array(offs, dtype=np.int64)

    @property
    def table_size(self):
        return int(self.offsets()[-1])


def _all_levels_hashed_uniform(spec):
    """Every level overflows into hash mode at one capped table size."""
    offs = spec.offsets()
    sizes = set(int(offs[i + 1] - offs[i])
                for i in range(spec.num_levels))
    if len(sizes) != 1 or spec.gridtype != 'hash':
        return False
    for lv in range(spec.num_levels):
        res, _ = spec.level_resolution(lv)
        side = res if spec.align_corners else res + 1
        if side ** spec.input_dim <= spec.max_params:
            return False
    return True


def foldable(spec, scene_dim=2):
    """The scene-folded path applies when every level is hashed at the
    same power-of-two size (the flagship D=5 config)."""
    if not _all_levels_hashed_uniform(spec):
        return False
    size = spec.table_size // spec.num_levels
    return size & (size - 1) == 0 and spec.input_dim > scene_dim


def init_hashgrid_table(spec, generator=None, device=None):
    """A [table_size, C] table uniform in [-1e-4, 1e-4] (the JAX
    package's `init_hashgrid_table`, reference grid.py:136)."""
    table = torch.empty((spec.table_size, spec.level_dim),
                        dtype=torch.float32, device=device)
    return table.uniform_(-1e-4, 1e-4, generator=generator)


@tensor_cache()
def _scales(spec, device):
    """The levels' float32 scales on `device`, made once per (spec,
    device) outside a trace: a host-to-device copy per call would wait
    for the device's queue to drain (one per tile in mesh-mode
    serving)."""
    return torch.tensor([spec.level_resolution(lv)[1]
                         for lv in range(spec.num_levels)],
                        dtype=torch.float32, device=device)


def _offset(spec):
    return 0.0 if spec.align_corners else 0.5


VARIANTS = ('xor', 'paired')


def _combine(variant, a, b):
    """One step of the corner hash on int64 values: xor, or the paired
    variant's add (callers reduce with `& (S-1)`, which also takes the
    uint32 wrap since S divides 2^32)."""
    return a + b if variant == 'paired' else a ^ b


def _fold_src(variant, j, m):
    """Source row of the scene fold: j ^ m, or (j + m) for 'paired'
    (callers reduce with `& (S-1)`)."""
    return j + m if variant == 'paired' else j ^ m


# a baked table [L, S, C] and whether the scene code lies out of bounds
# (then every point encodes to zero), a 0-d bool tensor on its device
FoldedTable = collections.namedtuple('FoldedTable', ['baked', 'scene_oob'])


def scene_fold_weights(spec, scene, bound=1.0):
    """Scene code [Ds] -> per-level fold masks [L, 2^Ds] int64 (xor
    masks, or cyclic shifts for the 'paired' variant), blend weights
    [L, 2^Ds] float32 and the out-of-bounds flag, a 0-d bool tensor on
    the scene code's device, never read here (the math of `bake` in
    `hashgrid_encode_folded`). The paired masks are
    (sum_d corner_d * P_{3+d}) mod 2^32 & (S-1); S divides 2^32 and the
    int64 sum of two products of a corner (< 2^12) and a prime (< 2^32)
    cannot overflow, so the final `& (S-1)` is the whole reduction."""
    ds = scene.shape[-1]
    dp = spec.input_dim - ds
    if spec.hash_variant not in VARIANTS:
        raise ValueError(f'unknown hash_variant {spec.hash_variant!r}')
    if not foldable(spec, ds):
        raise ValueError('spec not foldable')
    size = spec.table_size // spec.num_levels
    # in the scene code's dtype (a bf16 code rounds here, as JAX's does),
    # float32 from the cell position on
    s01 = ((scene + bound) / (2.0 * bound)).to(torch.float32)
    scene_oob = ((s01 < 0.0) | (s01 > 1.0)).any()
    spos = fma(s01[None, :], _scales(spec, scene.device)[:, None],
               _offset(spec))                                # [L, Ds]
    sgrid = torch.floor(spos)
    sfrac = spos - sgrid
    bits = torch.tensor([[(a >> d) & 1 for d in range(ds)]
                         for a in range(2 ** ds)], device=scene.device)
    on = bits.to(torch.bool)[None]                           # [1, A, Ds]
    weights = torch.where(on, sfrac[:, None, :],
                          1.0 - sfrac[:, None, :]).prod(dim=-1)  # [L, A]
    corner = sgrid.to(torch.int64)[:, None, :] + bits[None]  # [L, A, Ds]
    masks = torch.zeros(corner.shape[:-1], dtype=torch.int64,
                        device=scene.device)
    for d in range(ds):
        masks = _combine(spec.hash_variant, masks,
                         corner[..., d] * PRIMES[dp + d])
    return masks & (size - 1), weights, scene_oob


def fold_scene(spec, table, scene, bound=1.0):
    """Bake the [table_size, C] table for one scene code [Ds]
    (differentiable in the table and the scene code)."""
    masks, weights, scene_oob = scene_fold_weights(spec, scene, bound)
    table3 = table.reshape(spec.num_levels, -1, spec.level_dim)
    return FoldedTable(HashBake.apply(table3, weights, masks,
                                      spec.hash_variant), scene_oob)


def _bake(table3, masks, weights, variant='xor', backward=False):
    """The fold (the op `sd::hash_bake` or `sd::hash_shift_bake`), or
    (`backward`) its adjoint applied to the baked table's gradient: xor
    is its own inverse, a shift by m is undone by S - m."""
    if not backward:
        op = hash_ops.hash_shift_bake if variant == 'paired' \
            else hash_ops.hash_bake
        return op(table3, masks, weights)
    if variant == 'paired':
        masks = (table3.shape[1] - masks) & (table3.shape[1] - 1)
    if table3.is_cuda:
        masks32 = masks.to(torch.int32).contiguous()
        if variant == 'paired':
            return kernels.hash_shift_bake(
                table3.contiguous(), masks32, weights.contiguous(),
                'hash_shift_bake_bwd')
        return kernels.hash_bake(table3.contiguous(), masks32,
                                 weights.contiguous(), 'hash_bake_bwd')
    return bake_plain(table3, masks, weights, variant)


class HashBake(torch.autograd.Function):
    """baked = bake(table3 [L,S,C], weights [L,A]; masks [L,A]; variant).
    Forward K2 (a) / K5 (a); backward dT = the adjoint bake of dB (K3 (b)
    / K5 (d): the same kernel, counted as 'hash_bake_bwd' /
    'hash_shift_bake_bwd') and dw = bake_dw(T, dB) (K3 (c) / K5 (d))."""

    @staticmethod
    def forward(ctx, table3, weights, masks, variant='xor'):
        ctx.save_for_backward(table3, weights, masks)
        ctx.variant = variant
        return _bake(table3, masks, weights.detach(), variant)

    @staticmethod
    def backward(ctx, grad):
        table3, weights, masks = ctx.saved_tensors
        grad = grad.contiguous()
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            d_table = _bake(grad, masks, weights.detach(), ctx.variant,
                            backward=True)
        if ctx.needs_input_grad[1]:
            if grad.is_cuda:
                dw = kernels.hash_shift_bake_dw if ctx.variant == 'paired' \
                    else kernels.hash_bake_dw
                d_weights = dw(table3.detach().contiguous(), grad,
                               masks.to(torch.int32).contiguous())
            else:
                d_weights = bake_dw_plain(table3.detach(), grad, masks,
                                          ctx.variant)
        return d_table, d_weights, None, None


def bake_plain(table3, masks, weights, variant='xor'):
    """Plain version of K2 (a) and, with variant='paired', K5 (a):
    baked[l, j] = 0 + sum_a w[l,a] * table3[l, src(j, masks[l,a])],
    src = j ^ m or (j + m) mod S, summed in ascending a."""
    lv, s, c = table3.shape
    j = torch.arange(s, device=table3.device)
    out = torch.zeros_like(table3)
    for a in range(masks.shape[1]):
        src = (_fold_src(variant, j[None, :], masks[:, a:a + 1].long())
               & (s - 1)).unsqueeze(-1).expand(lv, s, c)
        out = out + weights[:, a, None, None] * torch.gather(table3, 1, src)
    return out


def shift_bake_plain(table3, shifts, weights):
    """Plain version of K5 (a): baked[l, j] = sum_a w[l,a] *
    table3[l, (j + shifts[l,a]) mod S]."""
    return bake_plain(table3, shifts, weights, 'paired')


def encode_folded(spec, folded, xyz, bound=1.0):
    """Encode points [N, 3] in [-bound, bound] against a baked table;
    returns [N, L*C] (zeros for out-of-bounds points). Differentiable in
    the baked table and the points."""
    if xyz.shape[-1] != 3:
        raise ValueError('the folded encode takes 3-D points')
    return HashEncode.apply(folded.baked, xyz, _scales(spec, xyz.device),
                            _offset(spec), bound, folded.scene_oob,
                            spec.hash_variant)


class HashEncode(torch.autograd.Function):
    """out = encode(baked [L,S,C], xyz [N,3]; variant). Forward K2 (b) /
    K5 (b); backward K3 (a) / K5 (c): the cotangent scattered into the
    baked table's rows and, when the points need it, the gradient through
    frac (the baked table is kept for that case only)."""

    @staticmethod
    def forward(ctx, baked, xyz, scales, offset, bound, scene_oob,
                variant='xor'):
        ctx.geom = (offset, bound, scene_oob, baked.shape[1], variant)
        keep = baked if ctx.needs_input_grad[1] else None
        ctx.save_for_backward(xyz, scales, keep)
        op = hash_ops.hash_encode_paired if variant == 'paired' \
            else hash_ops.hash_encode
        return op(baked.detach(), xyz.detach(), scales, offset, bound,
                  scene_oob)

    @staticmethod
    def backward(ctx, g):
        xyz, scales, baked = ctx.saved_tensors
        offset, bound, scene_oob, slots, variant = ctx.geom
        if baked is not None:
            baked = baked.detach().contiguous()
        if g.is_cuda:
            bwd = kernels.hash_encode_paired_bwd if variant == 'paired' \
                else kernels.hash_encode_bwd
            # as the forward op: every point out of bounds (the kernel
            # skips it) rather than the flag read on the host
            xyz = torch.where(scene_oob, float('inf'), xyz.detach())
            d_baked, d_xyz = bwd(g.contiguous(), xyz.contiguous(), scales,
                                 offset, bound, False, slots, baked)
        else:
            d_baked, d_xyz = encode_bwd_plain(g, xyz.detach(), scales,
                                              offset, bound, scene_oob,
                                              slots, baked, variant)
        return d_baked, d_xyz, None, None, None, None, None


def encode_plain(baked, xyz, scales, offset, bound, scene_oob,
                 variant='xor'):
    """Plain version of K2 (b) and, with variant='paired', K5 (b): per
    level, the cell position x01 * scale + offset rounded once (as the JAX
    op's compiled encode and the kernel round it; a separate rounding
    moves the fractional position by up to one float32 step of the
    position, ~1e-4 at the finest levels), the 8 corner rows and weights
    of `_corners`, and sum_k w_k * baked[idx_k] in ascending k; zero
    rows for points out of bounds and, when `scene_oob` (a 0-d bool
    tensor or a bool) is set, for every point."""
    lv, s, c = baked.shape
    x01 = (xyz.to(torch.float32) + bound) / (2.0 * bound)    # [N, 3]
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1, keepdim=True) | scene_oob
    outs = []
    for level in range(lv):
        rows, ws, _ = _corners(x01, scales[level], offset, s, variant)
        acc = torch.zeros((xyz.shape[0], c), dtype=torch.float32,
                          device=xyz.device)
        for idx, w in zip(rows, ws):
            acc = acc + w[:, None] * baked[level][idx]
        outs.append(acc)
    out = torch.cat(outs, dim=-1)
    return torch.where(oob, torch.zeros_like(out), out)


def paired_encode_plain(baked, xyz, scales, offset, bound, scene_oob):
    """Plain version of K5 (b): per level 4 bases
    base_k = (x + y' * P1 + z' * P2) & (S-1) over the (y, z) corner bits
    (k = y_bit + 2 z_bit), rows base_k and (base_k + 1) mod S with weights
    (t_y t_z) * (1 - f_x, f_x), summed over k then over the row pair."""
    return encode_plain(baked, xyz, scales, offset, bound, scene_oob,
                        'paired')


def _corners(x01, scale, offset, slots, variant='xor'):
    """Per level: the 8 corner rows [N] int64 and weights [N] of each
    point, in ascending k (bit d of k = upper corner in dimension d), and
    the taps t[d] = (1 - frac_d, frac_d), as the forward computes them.
    'xor': row = ((x*1) ^ (y*P1) ^ (z*P2)) & (S-1), weight (t_x t_y) t_z.
    'paired': row = (x*1 + y*P1 + z*P2) & (S-1), so corners 2k and 2k+1
    are the adjacent rows base_k and (base_k + 1) mod S of the (y, z)
    corner k, and the weight is (t_y t_z) t_x as the JAX op forms it."""
    pos = fma(x01, scale, offset)
    cell = torch.floor(pos)
    frac = pos - cell
    u = cell.to(torch.int64)
    h = [[u[:, d] * PRIMES[d], (u[:, d] + 1) * PRIMES[d]] for d in range(3)]
    t = [[1.0 - frac[:, d], frac[:, d]] for d in range(3)]
    rows, ws = [], []
    for k in range(8):
        bx, by, bz = k & 1, (k >> 1) & 1, (k >> 2) & 1
        idx = _combine(variant, _combine(variant, h[0][bx], h[1][by]),
                       h[2][bz])
        if variant == 'paired':
            w = (t[1][by] * t[2][bz]) * t[0][bx]
        else:
            w = (t[0][bx] * t[1][by]) * t[2][bz]
        rows.append(idx & (slots - 1))
        ws.append(w)
    return rows, ws, t


def encode_bwd_plain(g, xyz, scales, offset, bound, scene_oob, slots,
                     baked=None, variant='xor'):
    """Plain version of K3 (a) and, with variant='paired', K5 (c).
    g [N, L*C] -> (grad [L, slots, C]:
    grad[l, idx_k] += w_k * g[n, l] over points and corners (`index_add_`
    per corner in ascending k), dxyz [N, 3] or None). With `baked`, dxyz
    is the gradient through frac: per level
    dfrac_d = sum_k gv_k * sign_{k,d} * prod_{d' != d} t_{k,d'} with
    gv_k = sum_c g_c * baked[idx_k, c], and dxyz = sum_l scale_l *
    dfrac / (2 bound). Out-of-bounds points give zeros, every point when
    `scene_oob` (a 0-d bool tensor, read here, or a bool) is set."""
    lv = scales.shape[0]
    n, c = xyz.shape[0], g.shape[1] // lv
    grad = torch.zeros((lv, slots, c), dtype=torch.float32, device=g.device)
    dx01 = torch.zeros((n, 3), dtype=torch.float32, device=g.device) \
        if baked is not None else None
    if scene_oob or n == 0:
        return grad, dx01
    x01 = (xyz.to(torch.float32) + bound) / (2.0 * bound)
    inb = ((x01 >= 0.0) & (x01 <= 1.0)).all(dim=-1, keepdim=True)
    g = torch.where(inb, g, torch.zeros_like(g))
    for level in range(lv):
        rows, ws, t = _corners(x01, scales[level], offset, slots, variant)
        gl = g[:, level * c:(level + 1) * c]
        gv = []
        for idx, w in zip(rows, ws):
            grad[level].index_add_(0, idx, w[:, None] * gl)
            if baked is not None:
                gv.append((gl * baked[level][idx]).sum(dim=-1))
        if baked is None:
            continue
        for d in range(3):
            s = torch.zeros_like(gv[0])
            for k in range(8):
                excl = torch.ones_like(s)
                for e in range(3):
                    if e != d:
                        excl = excl * t[e][(k >> e) & 1]
                term = gv[k] * excl
                s = s + term if (k >> d) & 1 else s - term
            dx01[:, d] += s * scales[level]
    if dx01 is not None:
        dx01 = dx01 / (2.0 * bound)
    return grad, dx01


def paired_encode_bwd_plain(g, xyz, scales, offset, bound, scene_oob, slots,
                            baked=None):
    """Plain version of K5 (c): G[l, (base_k + j) mod S] += w[n,k,j] *
    g[n, l] and, with `baked`, the gradient through frac for the points."""
    return encode_bwd_plain(g, xyz, scales, offset, bound, scene_oob, slots,
                            baked, 'paired')


def bake_dw_plain(table3, grad, masks, variant='xor'):
    """Plain version of K3 (c) and, with variant='paired', K5 (d):
    dw[l, a] = sum_{j,c} table3[l, src(j, m[l,a]), c] * grad[l, j, c], in
    float64 as the kernel sums, rounded to float32."""
    lv, s, c = table3.shape
    j = torch.arange(s, device=table3.device)
    cols = []
    for a in range(masks.shape[1]):
        src = (_fold_src(variant, j[None, :], masks[:, a:a + 1].long())
               & (s - 1)).unsqueeze(-1).expand(lv, s, c)
        cols.append((torch.gather(table3, 1, src).double()
                     * grad.double()).sum(dim=(1, 2)))
    return torch.stack(cols, dim=-1).float()


def shift_bake_dw_plain(table3, grad, shifts):
    """Plain version of K5 (d), the weight half: dw[l, a] = sum_j
    table3[l, (j + shifts[l,a]) mod S] . grad[l, j]. (The table half,
    dT[k] = sum_a w_a * G[(k - m_a) mod S], is `shift_bake_plain` with
    shifts (S - m_a) mod S.)"""
    return bake_dw_plain(table3, grad, shifts, 'paired')


def hashgrid_encode_folded(spec, table, xyz, scene, bound=1.0):
    """Exact hash-grid encode of points [N, 3] that share trailing scene
    coordinates [Ds]: `fold_scene` then `encode_folded`. Equals the
    unfolded encode of the concatenated [N, 3+Ds] input."""
    return encode_folded(spec, fold_scene(spec, table, scene, bound), xyz,
                         bound)


# ----------------------------------------------------------------------
# the general (unfolded) encode, K4
# ----------------------------------------------------------------------

_U32 = 0xFFFFFFFF

# per level: first row in the flat table, rows, float32 scale, whether
# the corner index is hashed, and the tiled strides per input dimension
# (0 past the cut-off, where the JAX loop stops adding)
GeneralLevel = collections.namedtuple(
    'GeneralLevel', ['offset', 'size', 'scale', 'hashed', 'strides'])


@functools.lru_cache(maxsize=64)
def general_levels(spec):
    """The per-level index metadata of `_level_encode` (JAX
    `hashgrid.py:475-513`): the tiled stride loop stops before the
    dimension at which the stride would exceed the level's size, and a
    level is hashed when that happens (or the full grid overflows) and
    the gridtype is 'hash'."""
    if spec.gridtype not in ('hash', 'tiled'):
        raise ValueError(f'unknown gridtype {spec.gridtype!r}')
    offs = spec.offsets()
    out = []
    for lv in range(spec.num_levels):
        res, scale = spec.level_resolution(lv)
        side = res if spec.align_corners else res + 1
        size = int(offs[lv + 1] - offs[lv])
        strides, stride = [], 1
        for _ in range(spec.input_dim):
            if stride > size:
                break
            strides.append(stride)
            stride *= side
        overflow = stride > size
        strides += [0] * (spec.input_dim - len(strides))
        out.append(GeneralLevel(int(offs[lv]), size,
                                float(np.float32(scale)),
                                spec.gridtype == 'hash' and overflow,
                                tuple(strides)))
    return tuple(out)


def mod_magic(size):
    """The multiplier with which K4 reduces a uint32 corner index modulo a
    level size that is not a power of two without dividing:
    ceil(2^64 / size), so that h % size == (((magic * h) mod 2^64) * size)
    >> 64 for every uint32 h (Lemire, Kaser and Kurz, 2019); 0 for a
    power of two, which K4 reduces with a mask. Fits an int64."""
    return 0 if size & (size - 1) == 0 else (2 ** 64 - 1) // size + 1


@tensor_cache(maxsize=64)
def general_meta(spec):
    """`general_levels` packed for K4: [L, 11] int64 (offset, size,
    hashed, strides padded to 7 dims, `mod_magic(size)`) and [L] float32
    scales, on the CPU (made once per spec outside a trace)."""
    rows = [[lv.offset, lv.size, int(lv.hashed)]
            + list(lv.strides) + [0] * (7 - len(lv.strides))
            + [mod_magic(lv.size)]
            for lv in general_levels(spec)]
    return (torch.tensor(rows, dtype=torch.int64),
            torch.tensor([lv.scale for lv in general_levels(spec)],
                         dtype=torch.float32))


def _general_corners(x01, level, offset, variant):
    """One level of the general encode: the 2^D corner rows [N] int64
    (within the level) and weights [N] float32 of each point in
    ascending k (bit d of k = upper corner in dimension d), and the taps
    t[d] = (1 - frac_d, frac_d). The cell position x01 * scale + offset
    is rounded once (the compiled JAX op fuses it); the index is
    sum_d corner_d * stride_d or, hashed, the xor (paired: add) of
    corner_d * prime_d, wrapped to uint32, then `% size`; the weight is
    the product over d in ascending order, as `jnp.prod` forms it."""
    d = x01.shape[-1]
    pos = fma(x01, level.scale, offset)
    cell = torch.floor(pos)
    frac = pos - cell
    u = cell.to(torch.int64)
    mult = PRIMES if level.hashed else level.strides
    a = [[u[:, e] * mult[e], (u[:, e] + 1) * mult[e]] for e in range(d)]
    t = [[1.0 - frac[:, e], frac[:, e]] for e in range(d)]
    use_xor = level.hashed and variant == 'xor'
    rows, ws = [], []
    for k in range(2 ** d):
        h, w = a[0][k & 1], t[0][k & 1]
        for e in range(1, d):
            bit = (k >> e) & 1
            h = h ^ a[e][bit] if use_xor else h + a[e][bit]
            w = w * t[e][bit]
        rows.append((h & _U32) % level.size)
        ws.append(w)
    return rows, ws, t


def _inside(x, bound):
    """x01 = (x + bound) / (2 bound) and the in-bounds mask [N]."""
    x01 = (x.to(torch.float32) + bound) / (2.0 * bound)
    return x01, ~((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)


def meta_levels(meta, scales, dims):
    """`general_levels` back from `general_meta`'s packing, for points
    of `dims` dimensions (the op `sd::hash_encode_general` takes the
    packing, not the spec)."""
    return tuple(GeneralLevel(int(row[0]), int(row[1]), float(scale),
                              bool(row[2]), tuple(row[3:3 + dims]))
                 for row, scale in zip(meta.tolist(), scales.tolist()))


def encode_general_plain(spec, table, x, bound=1.0):
    """Plain version of K4 (a): x [N, D] -> [N, L*C], per level
    sum_k w_k * table[offset_l + idx_k] in ascending k, zeros for points
    with any coordinate outside [-bound, bound]."""
    return encode_levels_plain(general_levels(spec), table, x,
                               _offset(spec), bound, spec.hash_variant)


def encode_levels_plain(levels, table, x, offset, bound, variant):
    """`encode_general_plain` on the levels' metadata."""
    x01, inb = _inside(x, bound)
    c = table.shape[1]
    outs = []
    for level in levels:
        tl = table[level.offset:level.offset + level.size]
        rows, ws, _ = _general_corners(x01, level, offset, variant)
        acc = torch.zeros((x.shape[0], c), dtype=torch.float32,
                          device=x.device)
        for idx, w in zip(rows, ws):
            acc = acc + w[:, None] * tl[idx]
        outs.append(acc)
    out = torch.cat(outs, dim=-1)
    return torch.where(inb[:, None], out, torch.zeros_like(out))


def encode_general_bwd_plain(spec, g, x, bound=1.0, rows=None, table=None,
                             table_grad=True):
    """Plain version of K4 (b). g [N, L*C] -> (grad [rows, C]:
    grad[offset_l + idx_k] += w_k * g[n, l] over in-bounds points and
    corners (`index_add_` per corner in ascending k), or None without
    `table_grad`; dx [N, D] when `table` is given, else None: per level
    dfrac_d = sum_k gv_k * sign_{k,d} * prod_{e != d} t_{k,e} with
    gv_k = sum_c g_c * table[idx_k, c], and dx = sum_l scale_l * dfrac /
    (2 bound); zeros for out-of-bounds points)."""
    rows = spec.table_size if rows is None else rows
    n, d = x.shape
    c = spec.level_dim
    grad = torch.zeros((rows, c), dtype=torch.float32, device=g.device) \
        if table_grad else None
    dx01 = torch.zeros((n, d), dtype=torch.float32, device=g.device) \
        if table is not None else None
    x01, inb = _inside(x, bound)
    x01, g = x01[inb], g[inb]
    part = torch.zeros((x01.shape[0], d), dtype=torch.float32,
                       device=g.device) if table is not None else None
    for lv, level in enumerate(general_levels(spec)):
        rows_k, ws, t = _general_corners(x01, level, _offset(spec),
                                         spec.hash_variant)
        gl = g[:, lv * c:(lv + 1) * c]
        gv = []
        for idx, w in zip(rows_k, ws):
            if grad is not None:
                grad.index_add_(0, idx + level.offset, w[:, None] * gl)
            if table is not None:
                gv.append((gl * table[level.offset + idx]).sum(dim=-1))
        if table is None:
            continue
        for e in range(d):
            s = torch.zeros_like(gl[:, 0])
            for k in range(2 ** d):
                excl = torch.ones_like(s)
                for f in range(d):
                    if f != e:
                        excl = excl * t[f][(k >> f) & 1]
                term = gv[k] * excl
                s = s + term if (k >> e) & 1 else s - term
            part[:, e] += s * level.scale
    if dx01 is not None:
        dx01[inb] = part
        dx01 = dx01 / (2.0 * bound)
    return grad, dx01


class HashEncodeGeneral(torch.autograd.Function):
    """out = encode(table [rows, C], x [N, D]; spec, bound). Forward
    K4 (a); backward K4 (b): the cotangent scattered into the table's
    rows and, when the points need it, the gradient through frac (the
    table is kept for that case only)."""

    @staticmethod
    def forward(ctx, table, x, spec, bound):
        ctx.geom = (spec, bound, table.shape[0])
        keep = table if ctx.needs_input_grad[1] else None
        ctx.save_for_backward(x, keep)
        return hash_ops.hash_encode_general(
            table.detach(), x.detach(), *general_meta(spec), _offset(spec),
            bound, spec.hash_variant == 'xor')

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        spec, bound, rows = ctx.geom
        if table is not None:
            table = table.detach().contiguous()
        want_table = ctx.needs_input_grad[0]
        if g.is_cuda:
            meta, scales = general_meta(spec)
            d_table, d_x = kernels.hash_encode_general_bwd(
                g.contiguous(), x.detach().contiguous(), meta, scales,
                _offset(spec), bound, spec.hash_variant == 'xor', rows,
                table, want_table)
        else:
            d_table, d_x = encode_general_bwd_plain(
                spec, g, x.detach(), bound, rows, table, want_table)
        return d_table, d_x, None, None


def hashgrid_encode(spec, table, x, bound=1.0, chunk=None):
    """The general hash-grid encode (JAX `hashgrid_encode`): x
    [..., input_dim] in [-bound, bound], table [table_size, level_dim] ->
    [..., num_levels * level_dim], zero for out-of-bounds points.
    Differentiable in the table and the points. `chunk` encodes that
    many points per call (same result; bounds nothing on the card, where
    each kernel thread holds one point and level)."""
    if spec.hash_variant not in VARIANTS:
        raise ValueError(f'unknown hash_variant {spec.hash_variant!r}')
    if not 1 <= spec.input_dim <= len(PRIMES):
        raise ValueError(f'input_dim must be 1..{len(PRIMES)}')
    if tuple(table.shape) != (spec.table_size, spec.level_dim) \
            or x.shape[-1] != spec.input_dim:
        raise ValueError(f'table must be [{spec.table_size}, '
                         f'{spec.level_dim}] and x [..., {spec.input_dim}]')
    prefix = x.shape[:-1]
    flat = x.reshape(-1, spec.input_dim)
    n = flat.shape[0]
    if chunk is None or n <= chunk:
        out = HashEncodeGeneral.apply(table, flat, spec, bound)
    else:
        out = torch.cat([HashEncodeGeneral.apply(table, flat[i:i + chunk],
                                                 spec, bound)
                         for i in range(0, n, chunk)])
    return out.reshape(*prefix, spec.output_dim)
