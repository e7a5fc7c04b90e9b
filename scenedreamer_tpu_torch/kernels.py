"""Build, bind and launch the port's hand-written CUDA kernels.

Sources live in `csrc/`, one shared library per source with a plain C
interface. They are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xptxas=-v -shared -Xcompiler -fPIC

(all sources at once, one nvcc each, in parallel) into the gitignored
`scenedreamer_tpu_torch/_build/`, and bound with ctypes: pointers as
`c_void_p` from `tensor.data_ptr()`, PyTorch's current stream as the
last argument. A kernel never synchronises and allocates nothing; the
wrappers here check device, dtype, shape and contiguity, allocate the
outputs, raise if `cudaGetLastError()` after the launch is not 0, and
count launches per kernel (`launch_counts()`), so a run can show that
its main path went through the kernels. `-fmad=false` stops nvcc from
fusing multiply-adds on its own; the sources fuse (`__fmaf_rn`) only
where the JAX op's compiled code does, so the kernels round as their
plain PyTorch versions do (see the notes in each source and
`ops/rounding.py`).

Importing this module builds nothing. The op modules, and the `sd::`
ops that `ops/hash_ops.py` registers for the forward kernels on the
tile path and `ops/mlp_ops.py` for the RenderMLP's hidden layers, call
these wrappers only for CUDA tensors.
"""
import ctypes
import os
import shutil
import threading

import torch

from scenedreamer_tpu_torch.utils.build import finish_compile, start_compile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
SOURCES = {'dda': 'dda.cu', 'hashgrid_fwd': 'hashgrid_fwd.cu',
           'hashgrid_bwd': 'hashgrid_bwd.cu',
           'hashgrid_paired': 'hashgrid_paired.cu',
           'hashgrid_general': 'hashgrid_general.cu',
           'mlp_gemm': 'mlp_gemm.cu'}
# included by the three table scatters (`scatter_accum.cuh`) and by the
# two dw reductions (`bake_dw.cuh`)
HEADERS = ('scatter_accum.cuh', 'bake_dw.cuh')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xptxas=-v', '-shared', '-Xcompiler',
              '-fPIC']

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()  # the training CLI launches from two threads
_LIBS = {}
BUILD_LOGS = {}     # nvcc output (ptxas registers / spills) per source
_LAUNCHES = {'dda': 0, 'hash_bake': 0, 'hash_encode': 0,
             'hash_encode_bwd': 0, 'hash_bake_bwd': 0, 'hash_bake_dw': 0,
             'hash_shift_bake': 0, 'hash_encode_paired': 0,
             'hash_encode_paired_bwd': 0, 'hash_shift_bake_bwd': 0,
             'hash_shift_bake_dw': 0, 'hash_encode_general': 0,
             'hash_encode_general_bwd': 0, 'render_mlp_gemm': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    'sd_dda_i8': [_P, _I, _I, _I, _P, _LL, _P, _I, _P, _LL, _I, _I, _P, _P,
                  _P, _P, _P, _P],
    'sd_hash_bake': [_P, _P, _P, _P, _I, _LL, _I, _I, _P],
    'sd_hash_encode': [_P, _P, _P, _P, _LL, _I, _LL, _I, _F, _F, _F, _I,
                       _P],
    'sd_hash_encode_bwd': [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _F,
                           _F, _F, _F, _P, _P],
    'sd_hash_bake_dw': [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    'sd_hash_encode_general': [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F,
                               _F, _F, _P],
    'sd_hash_encode_general_bwd': [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                                   _I, _I, _F, _F, _F, _F, _P, _P],
    'sd_render_mlp_gemm': [_P, _P, _LL, _P, _LL, _P, _P, _I, _P, _I, _LL, _I,
                           _I, _I, _P],
}
# the paired variant's entry points (K5) take the arguments of their xor
# counterparts
for _xor, _paired in (('sd_hash_bake', 'sd_hash_shift_bake'),
                      ('sd_hash_encode', 'sd_hash_encode_paired'),
                      ('sd_hash_encode_bwd', 'sd_hash_encode_paired_bwd'),
                      ('sd_hash_bake_dw', 'sd_hash_shift_bake_dw')):
    _SIGNATURES[_paired] = _SIGNATURES[_xor]
# blocks of the dw reductions K3 (c) and K5 (d) (`csrc/bake_dw.cuh`), a
# persistent grid that walks the levels in order, all of it resident at
# once on an H100 (4 blocks of 256 threads on each of its 132 SMs); each
# of a block's 8 warps writes its own partial sums
DW_BLOCKS, DW_WARPS = 528, 8
# The table scatters K3 (a), K4 (b) and K5 (c) take their coarse path
# (`csrc/scatter_accum.cuh`: warp sums, a shared-memory table per block,
# one global add per row and block) on the levels whose scale (the
# level's resolution - 1) is at most this, and the direct path (one
# global atomic per corner) on the others. On the training points, in
# the ray order training feeds them, every level of the flagship spec up
# to its finest (scale 2047) ran faster on the coarse path: 2.8x to 7.0x
# for K4 (b), 8x to 26x for K3 (a), 8x to 25x for K5 (c), and shuffled
# too (`chip_smoke.py` phases 6, 8 and 10, `PERF.md`); finer levels stay
# direct until measured.
COARSE_MAX_SCALE = 2048.0
DIRECT_ONLY = -1.0  # flags no level coarse: the direct path everywhere


def coarse_levels(scales, coarse_max_scale=None):
    """Per-level flags of the table scatters' coarse path: the levels of
    `scales` (host values, e.g. `ops/hashgrid.py:general_meta`'s) whose
    scale is at most `coarse_max_scale` (default COARSE_MAX_SCALE). The
    kernels apply the same rule to the scales they are given."""
    if coarse_max_scale is None:
        coarse_max_scale = COARSE_MAX_SCALE
    return [float(s) <= coarse_max_scale for s in scales]


def launch_counts():
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')
    return path


def build():
    """Compile (one nvcc per source, all started together) and load
    every kernel library; returns {source name: ctypes library}."""
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return dict(_LIBS)
        cmd = [_nvcc()] + NVCC_FLAGS
        deps = tuple(os.path.join(CSRC, h) for h in HEADERS)
        jobs = {name: start_compile(os.path.join(CSRC, src), cmd, name, deps)
                for name, src in SOURCES.items() if name not in _LIBS}
        for name, job in jobs.items():
            path, BUILD_LOGS[name] = finish_compile(*job)
            lib = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            lib.sd_error_string.argtypes = [ctypes.c_int]
            lib.sd_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return dict(_LIBS)


def _launch(source, fn, name, device, *args):
    lib = build()[source]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: '
                           f'{lib.sd_error_string(err).decode()} ({err})')
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


def _require(t, dtype, name, ndim=None):
    if not t.is_cuda:
        raise ValueError(f'{name} must be a CUDA tensor')
    if t.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f'{name} must have {ndim} dims, got {t.dim()}')


def dda(voxel, origins, raydirs, max_samples, max_steps, with_steps=False,
        occupancy=None, image_width=None, stats=None):
    """K1. voxel [Y, X, Z] int8 (0 = empty); origins [3], or [G, 3] with
    ray r belonging to origin r // (R / G) (R a multiple of G), float32 on
    the voxel grid's device (read there by the kernel: nothing comes back
    to the host; a tensor elsewhere is copied there); raydirs [R, 3]
    float32. `occupancy`: the grid's `occupancy_bits`, for the exact
    empty-space skip; None builds them here (a caller that traces one
    world many times builds them once). `image_width`: None for flat ray
    order, else the width of the row-major images (one per origin) whose
    8x4 pixel tiles a warp takes. `stats`: None, or an int64 [2] CUDA
    tensor to which the launch adds its voxel loads and the occupancy
    bits it read. Returns voxel_id [R, M] int32, depth [R, M, 2] float32,
    hit_mask [R, M] bool (and per-ray axis-step counts [R] int32 with
    `with_steps`)."""
    _require(voxel, torch.int8, 'voxel', 3)
    _require(raydirs, torch.float32, 'raydirs', 2)
    if raydirs.shape[1] != 3 or raydirs.device != voxel.device:
        raise ValueError('raydirs must be [R, 3] on the voxel grid device')
    r, m = raydirs.shape[0], int(max_samples)
    dev = voxel.device
    origins = torch.as_tensor(origins).to(dev, torch.float32).reshape(-1, 3) \
        .contiguous()
    g = origins.shape[0]
    if g < 1 or r % g:
        raise ValueError(f'{r} rays do not split among {g} origins')
    per = r // g
    width = 0 if image_width is None else int(image_width)
    if width < 0 or (width and per % width):
        raise ValueError(f'{per} rays per origin are not rows of '
                         f'{image_width}')
    if occupancy is None:
        occupancy = occupancy_bits(voxel)
    _require(occupancy, torch.int32, 'occupancy', 1)
    if occupancy.device != dev or occupancy.numel() != \
            occupancy_words(voxel.shape):
        raise ValueError('occupancy must be the grid\'s brick bits on its '
                         'device')
    if stats is not None:
        _require(stats, torch.int64, 'stats', 1)
    out_id = torch.empty((r, m), dtype=torch.int32, device=dev)
    out_t = torch.empty((r, m, 2), dtype=torch.float32, device=dev)
    hit = torch.empty((r, m), dtype=torch.bool, device=dev)
    steps = torch.empty((r,), dtype=torch.int32, device=dev) \
        if with_steps else None
    if r:
        _launch('dda', 'sd_dda_i8', 'dda', dev, voxel.data_ptr(),
                *voxel.shape, origins.data_ptr(), per, occupancy.data_ptr(),
                width, raydirs.data_ptr(), r, m, int(max_steps),
                out_id.data_ptr(), out_t.data_ptr(), hit.data_ptr(),
                steps.data_ptr() if with_steps else None,
                stats.data_ptr() if stats is not None else None)
    if with_steps:
        return out_id, out_t, hit, steps
    return out_id, out_t, hit


BRICK = 8   # voxels per side of an occupancy brick (K1's empty-space skip)


def occupancy_words(dims):
    """int32 words of the brick bits of a [Y, X, Z] grid."""
    bricks = 1
    for d in dims:
        bricks *= -(-int(d) // BRICK)
    return -(-bricks // 32)


def occupancy_bits(voxel):
    """K1's `occupancy`: one flag per 8^3 brick of the [Y, X, Z] grid
    (0 = empty), set where a voxel of the brick is solid, as the JAX
    package's `build_occupancy` (the grid zero-padded to whole bricks),
    packed into int32 words: brick b = (y8 * ceil(X/8) + x8) * ceil(Z/8)
    + z8 at bit b % 32 of word b // 32 (59,392 bytes at scene 1024).
    Plain PyTorch on the grid's device, no kernel of its own: the 8 bytes
    of a brick row along Z are read as one int64, so the grid is read
    once and only an eighth of it is written."""
    y, x, z = (int(d) for d in voxel.shape)
    by, bx, bz = (-(-d // BRICK) for d in (y, x, z))
    v = voxel if voxel.element_size() == 1 else (voxel != 0).to(torch.int8)
    if z % BRICK or v.storage_offset() % BRICK or not v.is_contiguous():
        whole = v.new_zeros((y, x, bz * BRICK))
        whole[..., :z] = v
        v = whole
    rows = v.view(torch.int64) != 0                     # [Y, X, bz]
    if y % BRICK or x % BRICK:
        whole = rows.new_zeros((by * BRICK, bx * BRICK, bz))
        whole[:y, :x] = rows
        rows = whole
    flags = rows.reshape(by, BRICK, bx, BRICK, bz).amax(dim=(1, 3))
    bits = flags.reshape(-1).to(torch.int64)
    bits = torch.cat([bits, bits.new_zeros(-bits.numel() % 32)])
    shifts = torch.arange(32, dtype=torch.int64, device=voxel.device)
    words = (bits.reshape(-1, 32) << shifts).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words) \
        .to(torch.int32)


def hash_bake(table3, masks, weights, counter='hash_bake'):
    """K2 (a). table3 [L, S, C] float32, masks [L, A] int32, weights
    [L, A] float32 -> baked [L, S, C]. `counter` names the launch count
    it adds to: 'hash_bake' for the forward bake, 'hash_bake_bwd' for the
    same kernel run on the baked table's gradient (K3 (b))."""
    if counter not in ('hash_bake', 'hash_bake_bwd'):
        raise ValueError(f'unknown bake counter {counter!r}')
    return _bake('hashgrid_fwd', 'sd_hash_bake', counter, table3, masks,
                 weights)


def hash_shift_bake(table3, shifts, weights, counter='hash_shift_bake'):
    """K5 (a). As `hash_bake` with cyclic shifts [L, A] int32 in [0, S):
    baked[l, j] = sum_a w[l,a] * table3[l, (j + shifts[l,a]) mod S].
    `counter` is 'hash_shift_bake' for the forward bake and
    'hash_shift_bake_bwd' for the same kernel run on the baked table's
    gradient with the inverse shifts (K5 (d), the table half)."""
    if counter not in ('hash_shift_bake', 'hash_shift_bake_bwd'):
        raise ValueError(f'unknown bake counter {counter!r}')
    return _bake('hashgrid_paired', 'sd_hash_shift_bake', counter, table3,
                 shifts, weights)


def _bake(source, fn, counter, table3, masks, weights):
    _require(table3, torch.float32, 'table', 3)
    _require(masks, torch.int32, 'masks', 2)
    _require(weights, torch.float32, 'weights', 2)
    lv, s, c = table3.shape
    if c % 4 or s & (s - 1) or masks.shape != weights.shape \
            or masks.shape[0] != lv:
        raise ValueError('bake needs C % 4 == 0, a power-of-two S and '
                         '[L, A] masks/weights')
    baked = torch.empty_like(table3)
    _launch(source, fn, counter, table3.device,
            table3.data_ptr(), masks.data_ptr(), weights.data_ptr(),
            baked.data_ptr(), lv, s, c, masks.shape[1])
    return baked


def hash_encode(baked, xyz, scales, offset, bound, scene_oob):
    """K2 (b). baked [L, S, C] float32 (S a power of two, C 4 or 8);
    xyz [N, 3] float32; scales [L] float32 -> [N, L*C] float32."""
    return _encode('hashgrid_fwd', 'sd_hash_encode', 'hash_encode', baked,
                   xyz, scales, offset, bound, scene_oob)


def hash_encode_paired(baked, xyz, scales, offset, bound, scene_oob):
    """K5 (b). As `hash_encode` under the paired hash: 4 two-row slices
    per point and level."""
    return _encode('hashgrid_paired', 'sd_hash_encode_paired',
                   'hash_encode_paired', baked, xyz, scales, offset, bound,
                   scene_oob)


def _encode(source, fn, counter, baked, xyz, scales, offset, bound,
            scene_oob):
    if baked.dim() != 3 or xyz.dim() != 2 or scales.dim() != 1:
        raise ValueError('encode needs a [L, S, C] table, [N, 3] points and '
                         '[L] scales')
    lv, s, c = baked.shape
    if c not in (4, 8) or s & (s - 1) or xyz.shape[1] != 3 \
            or scales.shape[0] != lv:
        raise ValueError('encode needs C in (4, 8), a power-of-two S, '
                         '[N, 3] points and [L] scales')
    if s * c > 1 << 32:
        raise ValueError('encode needs S * C <= 2^32 (32-bit row offsets)')
    _require(baked, torch.float32, 'baked')
    _require(xyz, torch.float32, 'xyz')
    _require(scales, torch.float32, 'scales')
    n = xyz.shape[0]
    out = torch.empty((n, lv * c), dtype=torch.float32, device=xyz.device)
    if n:
        _launch(source, fn, counter, xyz.device, xyz.data_ptr(),
                baked.data_ptr(), scales.data_ptr(), out.data_ptr(), n, lv,
                s, c, float(bound), float(2.0 * bound), float(offset),
                int(bool(scene_oob)))
    return out


def hash_encode_bwd(g, xyz, scales, offset, bound, scene_oob, slots,
                    baked=None):
    """K3 (a). g [N, L*C] float32 cotangent of `hash_encode`; xyz [N, 3];
    scales [L] -> (grad [L, slots, C] float32, the scatter of g into the
    baked table's rows, and dxyz [N, 3] when `baked` [L, slots, C] is
    given, else None). Levels of scale <= COARSE_MAX_SCALE take the
    coarse path."""
    return hash_encode_bwd_split(g, xyz, scales, offset, bound, scene_oob,
                                 slots, baked)


def hash_encode_bwd_split(g, xyz, scales, offset, bound, scene_oob, slots,
                          baked=None, coarse_max_scale=None, stats=None):
    """`hash_encode_bwd` with the levels' split given: levels of scale <=
    `coarse_max_scale` (default COARSE_MAX_SCALE, read at the call, so a
    measurement can set the module's value to DIRECT_ONLY for the whole
    training step) take the coarse path, DIRECT_ONLY puts every level on
    the direct path, `math.inf` every level on the coarse one. `stats`,
    an int64 [2] CUDA tensor, or None: the coarse path adds to it the
    rows it flushed and the inserts that overflowed its tables. For the
    per-level measurements and the tests; the training path runs
    `hash_encode_bwd`."""
    return _encode_bwd('hashgrid_bwd', 'sd_hash_encode_bwd',
                       'hash_encode_bwd', g, xyz, scales, offset, bound,
                       scene_oob, slots, baked,
                       _split(coarse_max_scale, stats))


def hash_encode_paired_bwd(g, xyz, scales, offset, bound, scene_oob, slots,
                           baked=None):
    """K5 (c). As `hash_encode_bwd` under the paired hash: the scatter
    goes into rows base_k and (base_k + 1) mod slots. Levels of scale <=
    COARSE_MAX_SCALE take the coarse path."""
    return hash_encode_paired_bwd_split(g, xyz, scales, offset, bound,
                                        scene_oob, slots, baked)


def hash_encode_paired_bwd_split(g, xyz, scales, offset, bound, scene_oob,
                                 slots, baked=None, coarse_max_scale=None,
                                 stats=None):
    """`hash_encode_paired_bwd` with the levels' split given, as
    `hash_encode_bwd_split`."""
    return _encode_bwd('hashgrid_paired', 'sd_hash_encode_paired_bwd',
                       'hash_encode_paired_bwd', g, xyz, scales, offset,
                       bound, scene_oob, slots, baked,
                       _split(coarse_max_scale, stats))


def _split(coarse_max_scale, stats):
    """The (coarse_max_scale, stats pointer) arguments of a scatter with
    a coarse path; COARSE_MAX_SCALE read at the call when None."""
    if stats is not None:
        _require(stats, torch.int64, 'stats', 1)
    if coarse_max_scale is None:
        coarse_max_scale = COARSE_MAX_SCALE
    return (float(coarse_max_scale),
            stats.data_ptr() if stats is not None else None)


def _encode_bwd(source, fn, counter, g, xyz, scales, offset, bound,
                scene_oob, slots, baked, split):
    _require(g, torch.float32, 'g', 2)
    _require(xyz, torch.float32, 'xyz', 2)
    _require(scales, torch.float32, 'scales', 1)
    lv, n = scales.shape[0], xyz.shape[0]
    c = g.shape[1] // lv
    if c not in (4, 8) or g.shape != (n, lv * c) or xyz.shape[1] != 3 \
            or slots & (slots - 1):
        raise ValueError('encode backward needs C in (4, 8), g [N, L*C], '
                         '[N, 3] points and a power-of-two slot count')
    if baked is not None:
        _require(baked, torch.float32, 'baked', 3)
        if baked.shape != (lv, slots, c):
            raise ValueError('baked must be [L, slots, C]')
    dev = xyz.device
    grad = torch.zeros((lv, slots, c), dtype=torch.float32, device=dev)
    dxyz = torch.zeros((n, 3), dtype=torch.float32, device=dev) \
        if baked is not None else None
    if n and not scene_oob:
        _launch(source, fn, counter, dev, g.data_ptr(), xyz.data_ptr(),
                scales.data_ptr(),
                baked.data_ptr() if baked is not None else None,
                grad.data_ptr(),
                dxyz.data_ptr() if dxyz is not None else None, n, lv,
                int(slots), c, float(bound), float(2.0 * bound),
                float(offset), *split)
    return grad, dxyz


def hash_bake_dw(table3, grad, masks):
    """K3 (c). table3, grad [L, S, C] float32; masks [L, A] int32 ->
    dw [L, A] float32, dw[l, a] = sum_{j,c} table3[l, j ^ m[l,a], c] *
    grad[l, j, c] (float64 sums in a fixed order)."""
    return _bake_dw('hashgrid_bwd', 'sd_hash_bake_dw', 'hash_bake_dw',
                    table3, grad, masks)


def hash_shift_bake_dw(table3, grad, shifts):
    """K5 (d), the weight half. As `hash_bake_dw` with cyclic shifts:
    dw[l, a] = sum_{j,c} table3[l, (j + shifts[l,a]) mod S, c] *
    grad[l, j, c] (float64 sums in a fixed order)."""
    return _bake_dw('hashgrid_paired', 'sd_hash_shift_bake_dw',
                    'hash_shift_bake_dw', table3, grad, shifts)


def _bake_dw(source, fn, counter, table3, grad, masks):
    """A dw reduction on `csrc/bake_dw.cuh`'s grid of DW_BLOCKS blocks,
    each warp writing one partial sum per (level, corner)."""
    if table3.dim() != 3 or masks.dim() != 2:
        raise ValueError('bake dw needs [L, S, C] tables and [L, A] masks')
    lv, s, c = table3.shape
    a = masks.shape[1]
    if grad.shape != table3.shape or masks.shape[0] != lv \
            or c not in (4, 8) or s & (s - 1) or not 1 <= a <= 8:
        raise ValueError('bake dw needs equal [L, S, C] tables, C in (4, 8), '
                         'a power-of-two S and [L, A<=8] masks')
    if s * c > 1 << 32:
        raise ValueError('bake dw needs S * C <= 2^32 (32-bit offsets)')
    _require(table3, torch.float32, 'table')
    _require(grad, torch.float32, 'grad')
    _require(masks, torch.int32, 'masks')
    dev = table3.device
    partial = torch.empty(lv * a * DW_BLOCKS * DW_WARPS,
                          dtype=torch.float64, device=dev)
    dw = torch.empty((lv, a), dtype=torch.float32, device=dev)
    _launch(source, fn, counter, dev,
            table3.data_ptr(), grad.data_ptr(), masks.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), lv, s, c, a, DW_BLOCKS)
    return dw


GENERAL_CHANNELS = (1, 2, 4, 8, 16)
GENERAL_MAX_DIMS, GENERAL_MAX_LEVELS = 7, 32
# offset, size, hashed, strides, the modulo's multiplier
GENERAL_META_COLS = 4 + GENERAL_MAX_DIMS


def _general_args(x, meta, scales, c, rows, tensors):
    """Checks shared by K4 (a) and (b): x [N, D] float32 on the card; meta
    [L, 11] int64 and scales [L] float32 on the CPU whose levels lie
    inside `rows` table rows; C a supported width; `tensors` (name ->
    tensor or None) float32 and aligned for C's vector accesses."""
    _require(x, torch.float32, 'x', 2)
    if meta.is_cuda or meta.dtype != torch.int64 or not meta.is_contiguous() \
            or meta.dim() != 2 or meta.shape[1] != GENERAL_META_COLS:
        raise ValueError(f'meta must be a contiguous CPU int64 [L, '
                         f'{GENERAL_META_COLS}] tensor')
    lv = meta.shape[0]
    if scales.is_cuda or scales.dtype != torch.float32 \
            or not scales.is_contiguous() or tuple(scales.shape) != (lv,):
        raise ValueError('scales must be a contiguous CPU float32 [L] tensor')
    if not 1 <= x.shape[1] <= GENERAL_MAX_DIMS \
            or not 1 <= lv <= GENERAL_MAX_LEVELS or c not in GENERAL_CHANNELS:
        raise ValueError(f'the general encode takes 1..{GENERAL_MAX_DIMS} '
                         f'dims, 1..{GENERAL_MAX_LEVELS} levels and C in '
                         f'{GENERAL_CHANNELS}')
    if int((meta[:, 0] + meta[:, 1]).max()) > rows or int(meta[:, 0].min()) < 0:
        raise ValueError('a level lies outside the table')
    align = 16 if c % 4 == 0 else (8 if c == 2 else 4)
    for name, t in tensors.items():
        if t is None:
            continue
        _require(t, torch.float32, name, 2)
        if t.device != x.device or t.data_ptr() % align:
            raise ValueError(f'{name} must be on the points\' device and '
                             f'{align}-byte aligned')
    return lv


def hash_encode_general(table, x, meta, scales, offset, bound, xor_hash):
    """K4 (a). table [rows, C] float32 (C in 1, 2, 4, 8, 16); x [N, D]
    float32 (1 <= D <= 7); meta [L, 11] int64 and scales [L] float32, on
    the CPU: each level's (offset, size, hashed, tiled strides, modulo
    multiplier) and scale, as `ops/hashgrid.py:general_meta` packs them;
    offset the cell offset (0.5, or 0 with aligned corners); `xor_hash`
    False for the paired (add) hash -> [N, L*C] float32."""
    c = table.shape[1] if table.dim() == 2 else 0
    lv = _general_args(x, meta, scales, c, table.shape[0], {'table': table})
    n, dims = x.shape
    out = torch.empty((n, lv * c), dtype=torch.float32, device=x.device)
    if n:
        _launch('hashgrid_general', 'sd_hash_encode_general',
                'hash_encode_general', x.device, table.data_ptr(),
                x.data_ptr(), meta.data_ptr(), scales.data_ptr(),
                out.data_ptr(), n, dims, lv, c, int(bool(xor_hash)),
                float(bound), float(2.0 * bound), float(offset))
    return out


def hash_encode_general_bwd(g, x, meta, scales, offset, bound, xor_hash,
                            rows, table=None, table_grad=True):
    """K4 (b). g [N, L*C] float32 cotangent of `hash_encode_general`; x,
    meta, scales, offset, bound, xor_hash as there; rows the table's row
    count -> (grad [rows, C] float32, the scatter of g into the corner
    rows, or None without `table_grad`; dx [N, D] float32, the gradient
    through frac, when `table` [rows, C] is given, else None). Levels of
    scale <= COARSE_MAX_SCALE take the coarse path."""
    return hash_encode_general_bwd_split(g, x, meta, scales, offset, bound,
                                         xor_hash, rows, table, table_grad)


def hash_encode_general_bwd_split(g, x, meta, scales, offset, bound,
                                  xor_hash, rows, table=None,
                                  table_grad=True, coarse_max_scale=None,
                                  stats=None):
    """`hash_encode_general_bwd` with the levels' split given, as
    `hash_encode_bwd_split`."""
    lv = meta.shape[0] if meta.dim() == 2 else 1
    c = g.shape[1] // lv if g.dim() == 2 else 0
    _general_args(x, meta, scales, c, rows, {'g': g, 'table': table})
    n, dims = x.shape
    if g.shape != (n, lv * c) or (table is not None
                                  and table.shape != (rows, c)):
        raise ValueError('g must be [N, L*C] and table [rows, C]')
    coarse_max_scale, stats_ptr = _split(coarse_max_scale, stats)
    dev = x.device
    grad = torch.zeros((rows, c), dtype=torch.float32, device=dev) \
        if table_grad else None
    dx = torch.zeros((n, dims), dtype=torch.float32, device=dev) \
        if table is not None else None
    if n and (grad is not None or dx is not None):
        _launch('hashgrid_general', 'sd_hash_encode_general_bwd',
                'hash_encode_general_bwd', dev, g.data_ptr(), x.data_ptr(),
                meta.data_ptr(), scales.data_ptr(),
                table.data_ptr() if table is not None else None,
                grad.data_ptr() if grad is not None else None,
                dx.data_ptr() if dx is not None else None, n, dims, lv, c,
                int(bool(xor_hash)), float(bound), float(2.0 * bound),
                float(offset), coarse_max_scale, stats_ptr)
    return grad, dx


MLP_GEMM_MAX_LABELS = 32   # label columns K6 stages in shared memory


def render_mlp_gemm(x, w, shift, m=None, wm=None):
    """K6, one RenderMLP hidden layer (`csrc/mlp_gemm.cu`): x [B, R, K]
    float32; w [N, K] shared by the batch, or [B, N, K]; shift [N] with a
    shared w, else [B, N]; optionally the label term m [B, R, Km] with wm
    [N, Km] -> leaky_relu_0.2(x @ w^T + shift (+ m @ wm^T)) [B, R, N]
    float32, written once."""
    _require(x, torch.float32, 'x', 3)
    _require(w, torch.float32, 'w')
    _require(shift, torch.float32, 'shift')
    b, rows, k = x.shape
    shared = w.dim() == 2
    if w.dim() not in (2, 3) or w.shape[-1] != k \
            or (not shared and w.shape[0] != b):
        raise ValueError('w must be [N, K] or [B, N, K] for x [B, R, K]')
    n = w.shape[-2]
    if shift.shape != ((n,) if shared else (b, n)):
        raise ValueError('shift must be [N] with a shared w, else [B, N]')
    if (m is None) != (wm is None):
        raise ValueError('m and wm come together')
    km = 0
    if m is not None:
        _require(m, torch.float32, 'm', 3)
        _require(wm, torch.float32, 'wm', 2)
        km = m.shape[2]
        if m.shape[:2] != (b, rows) or wm.shape != (n, km) \
                or not 1 <= km <= MLP_GEMM_MAX_LABELS:
            raise ValueError(f'm must be [B, R, Km] and wm [N, Km], 1 <= Km '
                             f'<= {MLP_GEMM_MAX_LABELS}')
    dev = x.device
    if any(t.device != dev for t in (w, shift, m, wm) if t is not None):
        raise ValueError('render_mlp_gemm\'s tensors must share x\'s device')
    if k < 1 or not 1 <= b <= 65535:
        raise ValueError('render_mlp_gemm needs K >= 1 and 1 <= B <= 65535')
    out = torch.empty((b, rows, n), dtype=torch.float32, device=dev)
    if rows and n:
        # the kernel reads W^T rows with 16-byte copies
        wt = w.transpose(-1, -2).contiguous()
        _launch('mlp_gemm', 'sd_render_mlp_gemm', 'render_mlp_gemm', dev,
                x.data_ptr(), wt.data_ptr(), 0 if shared else n * k,
                shift.data_ptr(), 0 if shared else n,
                m.data_ptr() if m is not None else None,
                wm.data_ptr() if wm is not None else None, km,
                out.data_ptr(), b, rows, k, n, int(n % 4 == 0))
    return out
