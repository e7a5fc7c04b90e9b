// General (unfolded) multiresolution hash-grid encode, forward and
// backward (K4), for Hopper: two simple kernels.
//
// Replaces the JAX package's `scenedreamer_tpu/ops/hashgrid.py`
// `hashgrid_encode` general path: `_encode_flat` / `_encode_flat_scan`,
// `_level_encode` with `_combine_hash`, and `gather_interp` forward and
// backward (`_gather_interp_bwd` with `segment_sum_sorted`, whose
// sentinel sort works around XLA's serial scatter-add on the TPU; here
// the scatter is an atomic add). The generator reaches it whenever its
// hash spec is not foldable (e.g. `hash_log2_size: 21`: level 0 is
// indexed densely at 17^5 rows, the other levels hashed at 2^21), and
// `ops/encoders.py:get_encoder` for 'hashgrid' / 'tiledgrid' /
// 'varhashgrid'. Inputs: x [N, D] in [-bound, bound] (1 <= D <= 7), a flat
// table [rows, C] with per-level offsets, levels of any size.
//
// Per level l and point n:
//   x01 = (x + bound) / (2 bound); pos = fma(x01, scale_l, offset) (one
//   rounding, as the JAX op's compiled code rounds it); cell = floor(pos),
//   frac = pos - cell. For each of the 2^D corners k (bit d = upper
//   corner in dimension d), ascending:
//     w_k = prod_d (bit ? frac_d : 1 - frac_d), ascending d;
//     idx_k = sum_d corner_d * stride_d (wrapping uint32; strides are 0
//             past the level's cut-off, where the JAX loop `break`s), or,
//             for a hashed level, xor (or, 'paired', wrapping add) of
//             corner_d * prime_d; then idx_k mod size_l (a mask when
//             size_l is a power of two; else, in the fixed-shape forward,
//             nothing when a tiled index cannot reach size_l and a
//             multiply-high by a host-computed constant, `fast_mod`,
//             otherwise; `%` in the generic forward and the backward);
//   (a) sd_hash_encode_general: out[n, l*C + c] = sum_k w_k T[off_l +
//       idx_k, c], summed in ascending k; zeros when any coordinate of the
//       point lies outside [0, 1]. D = 5 / C = 8 (the generator) and
//       D = 3 / C = 2 (`get_encoder`'s default width) take
//       `encode_fixed_kernel` (compile-time shape, C / 4 lanes per point
//       at C >= 8, a thread walking the levels), any other shape the
//       generic one (one thread per (point, level)).
//   (b) sd_hash_encode_general_bwd: with g the cotangent of out, G[off_l
//       + idx_k, c] += w_k g[n, l*C + c] (G zero-filled by the caller)
//       and, when T is given, dx[n, d] += (scale_l / 2 bound) sum_k gv_k
//       sign_{k,d} prod_{e != d} t_{k,e}, gv_k = sum_c g_c T[idx_k, c],
//       the gradient through frac. Out-of-bounds points are skipped (the
//       forward wrote zeros there). Two paths for the table gradient,
//       chosen per level by the caller's coarse_max_scale and launched
//       one after the other (`LevelOrder` puts the coarse levels first):
//       - coarse (`encode_general_bwd_coarse_kernel`,
//         `scatter_accum.cuh`): a block walks 2,048 consecutive points of
//         one level; each corner's w * g is summed over the warp's lanes
//         on the same row, added into the block's shared-memory table and
//         flushed with one vector atomic per 4 channels and row;
//       - direct (`encode_general_bwd_kernel`): one thread per (point,
//         level), float4 atomics per corner when C % 4 == 0, float2 when
//         C == 2, scalar otherwise.
//
// The per-level metadata (offset, size, the tiled strides, whether the
// level is hashed, the scale, which path) rides in a __grid_constant__
// kernel parameter: every thread of a block reads the same level, so the
// reads are constant-cache broadcasts and no device buffer is needed.
//
// What bounds it: (a) gathers 2^D rows of C * 4 bytes per (point,
// level) (32 rows at D = 5). Measured level by level on an H100 at the
// `hash_log2_size: 21` spec (`scripts/torch_encode_levels.py`, 1,647,456
// training points): one thread per (point, level) with a runtime corner
// loop took 0.20-0.27 ms per level in ray order and as long with every
// point equal (3.5 ms in all): its instructions and one corner's latency
// at a time bound it, not the gather (~60 instructions per corner, a
// 32-bit division per corner on the tiled level 0). The fixed shape
// unrolls the 32 corners (8 rows in flight), reduces without dividing,
// and walks the levels inside the thread, so each point's 512-byte
// output row leaves L2 as whole lines (the per-(point, level) kernel
// wrote it in 32-byte pieces a level apart); its 16-byte stores are
// vector stores by intrinsic (nvcc had split them into four, which cost
// 0.37 ms). Now 0.10-0.17 ms per level (1.55 ms in all; 1.26 with every
// point equal): ~620 instructions per lane and level, rising with the
// distinct rows at the fine levels (up to 1,957,048 of a 2^21-row level,
// 64 MB, which no longer fits L2). A thread per point with both halves
// of each row (2.2 ms), fused multiply-adds (3% faster, not exact),
// 16 rows in flight, or a 64-register cap (spills) did not win.
// (b) on the direct path issues 2^D * ceil(C / 4) vector atomics per
// (point, level); every point shares its trailing scene coordinates in
// the generator, so a level's atomics land on few rows (level 0 of the
// `hash_log2_size: 21` spec: 1,136 rows for 52.7M corner adds of the
// 1,647,456 points of a training crop), and it takes 4.8-10.7 ms per
// level, 84.4 ms in all, on an H100. The coarse path flushes 70k (level
// 0) to 380k (level 15) rows per level and takes 1.5-1.8 ms per level
// alone, 16.3 ms in all: no longer the atomics but the per-corner work
// (32 warp reductions of C values, the table inserts, the 32 table rows
// read for dx) bounds it, against an operation bound of 0.72 ms. Every
// level is faster there, in ray order and shuffled (31.8 against 84.6
// ms in all).
//
// C ABI (ctypes): each entry point returns cudaGetLastError().
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "scatter_accum.cuh"

namespace {

namespace sa = scatter_accum;

constexpr int kMaxDims = 7;
constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
// offset, size, hashed, strides, the modulo's multiplier
constexpr int kMetaCols = 4 + kMaxDims;
__device__ __constant__ unsigned kPrimes[kMaxDims] = {
    1u, 2654435761u, 805459861u, 3674653429u, 2097192037u, 1434869437u,
    2165219737u};

struct Level {
  long long offset;              // first row of the level in the table
  unsigned long long magic;      // ceil(2^64 / size) for `fast_mod`
  unsigned size;                 // rows of the level
  unsigned mask;                 // size - 1 for a power-of-two size, else 0
  unsigned fixed_mask;           // the fixed forward's: mask, or all ones
                                 // where a tiled index cannot reach size
  int hashed;                    // 1: corner hash; 0: tiled index
  unsigned stride[kMaxDims];     // tiled strides, 0 past the cut-off
  float scale;
  int coarse;                    // 1: the backward's coarse path
};

struct Levels {
  Level lv[kMaxLevels];
};

// The backward's level order: the coarse levels first, then the direct.
struct LevelOrder {
  int idx[kMaxLevels];
};

// h mod size without a division (Lemire, Kaser and Kurz, "Faster
// remainder by direct computation", 2019): with magic = ceil(2^64 / size),
// the high 64 bits of ((magic * h) mod 2^64) * size are h mod size for
// every 32-bit h and size. The host computes magic
// (`ops/hashgrid.py:general_meta`); a runtime `%` costs a 32-bit
// division sequence per corner. The fixed forward's reduction.
__device__ __forceinline__ unsigned fast_mod(unsigned h, const Level& lv) {
  return (unsigned)__umul64hi(lv.magic * h, lv.size);
}

// The generic forward's and the backward's reduction.
__device__ __forceinline__ unsigned reduce_row(unsigned h, const Level& lv) {
  return lv.mask ? (h & lv.mask) : (h % lv.size);
}

// The corner-index terms and interpolation taps of dimension d of a point
// at x01 at level lv.
__device__ __forceinline__ void dim_terms(int d, float x01, const Level& lv,
                                          float offset, unsigned& a0,
                                          unsigned& a1, float& t0,
                                          float& t1) {
  const float pos = __fmaf_rn(x01, lv.scale, offset);
  const float cell = floorf(pos);
  const float frac = __fsub_rn(pos, cell);
  const unsigned u = (unsigned)cell;     // saturating for oob points
  const unsigned m = lv.hashed ? kPrimes[d] : lv.stride[d];
  a0 = u * m;
  a1 = (u + 1u) * m;
  t1 = frac;
  t0 = __fsub_rn(1.f, frac);
}

// The per-dimension terms of the corner index and the interpolation taps
// of point n at level lv; false when the point is out of bounds.
__device__ __forceinline__ bool setup_point(
    const float* __restrict__ x, long long n, int dims, const Level& lv,
    float bound, float two_bound, float offset, unsigned (&a0)[kMaxDims],
    unsigned (&a1)[kMaxDims], float (&t0)[kMaxDims],
    float (&t1)[kMaxDims]) {
  bool oob = false;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d >= dims) break;
    const float x01 = __fdiv_rn(__fadd_rn(x[n * dims + d], bound), two_bound);
    oob |= x01 < 0.f || x01 > 1.f;
    dim_terms(d, x01, lv, offset, a0[d], a1[d], t0[d], t1[d]);
  }
  return !oob;
}

// Row (within the level) and weight of corner k.
__device__ __forceinline__ unsigned corner(int k, int dims, bool use_xor,
                                           const Level& lv,
                                           const unsigned (&a0)[kMaxDims],
                                           const unsigned (&a1)[kMaxDims],
                                           const float (&t0)[kMaxDims],
                                           const float (&t1)[kMaxDims],
                                           float& w) {
  unsigned h = (k & 1) ? a1[0] : a0[0];
  w = (k & 1) ? t1[0] : t0[0];
#pragma unroll
  for (int d = 1; d < kMaxDims; ++d) {
    if (d >= dims) break;
    const bool bit = (k >> d) & 1;
    const unsigned v = bit ? a1[d] : a0[d];
    h = use_xor ? (h ^ v) : (h + v);
    w = __fmul_rn(w, bit ? t1[d] : t0[d]);
  }
  return reduce_row(h, lv);
}

template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 r = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = r.x;
      v[4 * q + 1] = r.y;
      v[4 * q + 2] = r.z;
      v[4 * q + 3] = r.w;
    }
  } else if constexpr (C == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    v[0] = r.x;
    v[1] = r.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

// Vector stores by intrinsic: through a plain assignment nvcc split the
// forward's 16-byte output stores into four 4-byte ones.
template <int C>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      __stwb(reinterpret_cast<float4*>(p) + q,
             make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else if constexpr (C == 2) {
    __stwb(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = v[c];
  }
}

// G[row] += w * g, with sm_90's vector atomics where the row allows.
template <int C>
__device__ __forceinline__ void scatter_row(float* __restrict__ p, float w,
                                            const float (&g)[C]) {
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, g[c]);
  sa::add_row<C>(p, v);
}

// s[d] += gv * d/dfrac_d of w_k: sign_{k,d} times the product of the
// other taps.
__device__ __forceinline__ void accum_dfrac(int k, int dims, float gv,
                                            const float (&t0)[kMaxDims],
                                            const float (&t1)[kMaxDims],
                                            float (&s)[kMaxDims]) {
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d >= dims) break;
    float excl = 1.f;
#pragma unroll
    for (int e = 0; e < kMaxDims; ++e) {
      if (e >= dims) break;
      if (e == d) continue;
      excl = __fmul_rn(excl, ((k >> e) & 1) ? t1[e] : t0[e]);
    }
    const float term = __fmul_rn(gv, excl);
    s[d] = ((k >> d) & 1) ? __fadd_rn(s[d], term) : __fsub_rn(s[d], term);
  }
}

// dx[n, d] += (scale / 2 bound) * s[d].
__device__ __forceinline__ void add_dx(float* __restrict__ dx, long long n,
                                       int dims, float scale, float two_bound,
                                       const float (&s)[kMaxDims]) {
  const float dpos_scale = __fdiv_rn(scale, two_bound);
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d >= dims) break;
    atomicAdd(dx + n * dims + d, __fmul_rn(s[d], dpos_scale));
  }
}

// The forward for any D and C: one thread per (point, level), the
// corners in a runtime loop.
template <int C>
__global__ void __launch_bounds__(kThreads) encode_general_kernel(
    const __grid_constant__ Levels levels, const float* __restrict__ table,
    const float* __restrict__ x, float* __restrict__ out, long long n_pts,
    int dims, int n_levels, int xor_variant, float bound, float two_bound,
    float offset) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const Level& lv = levels.lv[blockIdx.y];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float* o = out + (n * n_levels + blockIdx.y) * C;
  unsigned a0[kMaxDims], a1[kMaxDims];
  float t0[kMaxDims], t1[kMaxDims];
  if (!setup_point(x, n, dims, lv, bound, two_bound, offset, a0, a1, t0,
                   t1)) {
    store_row<C>(o, acc);
    return;
  }
  const bool use_xor = lv.hashed && xor_variant;
  const float* tl = table + lv.offset * C;
  const int corners = 1 << dims;
  for (int k = 0; k < corners; ++k) {
    float w;
    const unsigned row = corner(k, dims, use_xor, lv, a0, a1, t0, t1, w);
    float v[C];
    load_row<C>(tl + (long long)row * C, v);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, v[c]));
  }
  store_row<C>(o, acc);
}

// The forward's shape at compile-time D and C (the generator's D = 5,
// C = 8; `get_encoder`'s D = 3, C = 2): kLanes lanes per point, lane q
// holding channels [q kWidth, (q + 1) kWidth) of every level, so at C = 8
// a lane pair fetches each 32-byte corner row as one sector of one
// warp-wide load; the 2^D corners unrolled, kBatch rows loaded before
// their sums, each at a 32-bit offset from its level's base (every level
// holds fewer than 2^32 floats: `fits_fixed`). A thread walks the levels
// in order: x01 once per point, and each point's output row is written
// by one block within a short span, so its sectors meet in L2 and leave
// as whole lines.
template <int D, int C>
struct Fixed {
  static constexpr int kLanes = C >= 8 ? C / 4 : 1;
  static constexpr int kWidth = C / kLanes;
  static constexpr int kCorners = 1 << D;
  static constexpr int kBatch = kCorners < 8 ? kCorners : 8;
};

// acc = sum_k w_k T[row_k] over the corners in ascending k, for the lane's
// table pointer tl (the level's first row plus the lane's channels).
// kXor: the xor hash (else the wrapping add of the tiled index and the
// paired hash); kPow2: the row is h & fixed_mask (else `fast_mod`).
template <int D, int C, bool kXor, bool kPow2>
__device__ __forceinline__ void gather_fixed(
    const Level& lv, const float* __restrict__ tl, const unsigned (&a0)[D],
    const unsigned (&a1)[D], const float (&t0)[D], const float (&t1)[D],
    float (&acc)[Fixed<D, C>::kWidth]) {
  using F = Fixed<D, C>;
#pragma unroll
  for (int c = 0; c < F::kWidth; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < F::kCorners; k0 += F::kBatch) {
    float w[F::kBatch];
    float v[F::kBatch][F::kWidth];
#pragma unroll
    for (int j = 0; j < F::kBatch; ++j) {
      const int k = k0 + j;
      unsigned h = (k & 1) ? a1[0] : a0[0];
      w[j] = (k & 1) ? t1[0] : t0[0];
#pragma unroll
      for (int d = 1; d < D; ++d) {
        const bool bit = (k >> d) & 1;
        const unsigned m = bit ? a1[d] : a0[d];
        h = kXor ? (h ^ m) : (h + m);
        w[j] = __fmul_rn(w[j], bit ? t1[d] : t0[d]);
      }
      const unsigned row = kPow2 ? (h & lv.fixed_mask) : fast_mod(h, lv);
      load_row<F::kWidth>(tl + row * (unsigned)C, v[j]);
    }
#pragma unroll
    for (int j = 0; j < F::kBatch; ++j)
#pragma unroll
      for (int c = 0; c < F::kWidth; ++c)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(w[j], v[j][c]));
  }
}

template <int D, int C>
__global__ void __launch_bounds__(kThreads) encode_fixed_kernel(
    const __grid_constant__ Levels levels, const float* __restrict__ table,
    const float* __restrict__ x, float* __restrict__ out, long long n_pts,
    int n_levels, int xor_variant, float bound, float two_bound,
    float offset) {
  using F = Fixed<D, C>;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = t / F::kLanes;
  const int q = (int)(t % F::kLanes);
  if (n >= n_pts) return;
  float* o = out + n * n_levels * C + q * F::kWidth;
  float acc[F::kWidth];
  float x01[D];
  bool oob = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(x[n * D + d], bound), two_bound);
    oob |= x01[d] < 0.f || x01[d] > 1.f;
  }
  if (oob) {
#pragma unroll
    for (int c = 0; c < F::kWidth; ++c) acc[c] = 0.f;
    for (int l = 0; l < n_levels; ++l) store_row<F::kWidth>(o + l * C, acc);
    return;
  }
  for (int l = 0; l < n_levels; ++l) {
    const Level& lv = levels.lv[l];
    unsigned a0[D], a1[D];
    float t0[D], t1[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      dim_terms(d, x01[d], lv, offset, a0[d], a1[d], t0[d], t1[d]);
    const float* tl = table + lv.offset * C + q * F::kWidth;
    if (lv.hashed && xor_variant) {
      if (lv.fixed_mask)
        gather_fixed<D, C, true, true>(lv, tl, a0, a1, t0, t1, acc);
      else
        gather_fixed<D, C, true, false>(lv, tl, a0, a1, t0, t1, acc);
    } else {
      if (lv.fixed_mask)
        gather_fixed<D, C, false, true>(lv, tl, a0, a1, t0, t1, acc);
      else
        gather_fixed<D, C, false, false>(lv, tl, a0, a1, t0, t1, acc);
    }
    store_row<F::kWidth>(o + l * C, acc);
  }
}

// The direct path: one thread per (point, level), blockIdx.y the
// level_base + y-th level of `order`.
template <int C>
__global__ void __launch_bounds__(kThreads) encode_general_bwd_kernel(
    const __grid_constant__ Levels levels,
    const __grid_constant__ LevelOrder order, int level_base,
    const float* __restrict__ g, const float* __restrict__ x,
    const float* __restrict__ table, float* __restrict__ grad,
    float* __restrict__ dx, long long n_pts, int dims, int n_levels,
    int xor_variant, float bound, float two_bound, float offset) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const int l = order.idx[level_base + blockIdx.y];
  const Level& lv = levels.lv[l];
  unsigned a0[kMaxDims], a1[kMaxDims];
  float t0[kMaxDims], t1[kMaxDims];
  if (!setup_point(x, n, dims, lv, bound, two_bound, offset, a0, a1, t0,
                   t1))
    return;
  float gc[C];
  load_row<C>(g + (n * n_levels + l) * C, gc);
  const bool use_xor = lv.hashed && xor_variant;
  const long long base = lv.offset * C;
  const bool want_dx = dx != nullptr;
  float s[kMaxDims];
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) s[d] = 0.f;
  const int corners = 1 << dims;
  for (int k = 0; k < corners; ++k) {
    float w;
    const long long row =
        base + (long long)corner(k, dims, use_xor, lv, a0, a1, t0, t1, w) * C;
    if (grad) scatter_row<C>(grad + row, w, gc);
    if (!want_dx) continue;
    float v[C];
    load_row<C>(table + row, v);
    float gv = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) gv = __fadd_rn(gv, __fmul_rn(gc[c], v[c]));
    accum_dfrac(k, dims, gv, t0, t1, s);
  }
  if (want_dx) add_dx(dx, n, dims, lv.scale, two_bound, s);
}

// The coarse path (`scatter_accum.cuh`): block (b, y) walks points
// [b * kBlockPoints, (b + 1) * kBlockPoints) of the y-th level of
// `order` (a coarse one); each corner's w * g is summed over the warp's
// lanes on the same row, added into the block's shared-memory table
// (keyed by the table row) and flushed once per row at the end. The
// gradient through frac is the direct path's, per point.
template <int C>
__global__ void __launch_bounds__(sa::kThreads) encode_general_bwd_coarse_kernel(
    const __grid_constant__ Levels levels,
    const __grid_constant__ LevelOrder order, const float* __restrict__ g,
    const float* __restrict__ x, const float* __restrict__ table,
    float* __restrict__ grad, float* __restrict__ dx, long long n_pts,
    int dims, int n_levels, int xor_variant, float bound, float two_bound,
    float offset, unsigned long long* __restrict__ stats) {
  const int l = order.idx[blockIdx.y];
  const Level& lv = levels.lv[l];
  extern __shared__ __align__(16) unsigned char smem[];
  sa::Table<C> tab(smem);
  tab.clear();
  const long long first = (long long)blockIdx.x * sa::kBlockPoints;
  const long long last =
      first + sa::kBlockPoints < n_pts ? first + sa::kBlockPoints : n_pts;
  const bool use_xor = lv.hashed && xor_variant;
  const bool want_dx = dx != nullptr;
  const int corners = 1 << dims;
  // every lane runs the same iterations: the warp reduction needs them all
  for (long long base = first; base < last; base += blockDim.x) {
    const long long n = base + threadIdx.x;
    unsigned a0[kMaxDims], a1[kMaxDims];
    float t0[kMaxDims], t1[kMaxDims];
    const bool ok = n < last && setup_point(x, n, dims, lv, bound, two_bound,
                                            offset, a0, a1, t0, t1);
    float gc[C];
    if (ok) {
      load_row<C>(g + (n * n_levels + l) * C, gc);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) gc[c] = 0.f;
    }
    float s[kMaxDims];
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) s[d] = 0.f;
    for (int k = 0; k < corners; ++k) {
      unsigned key = sa::kEmpty;
      float w = 0.f;
      if (ok)
        key = (unsigned)(lv.offset
                         + corner(k, dims, use_xor, lv, a0, a1, t0, t1, w));
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gc[c]);
      if (sa::warp_reduce_peers<C>(key, v) && key != sa::kEmpty)
        tab.insert(key, v, grad);
      if (!want_dx || !ok) continue;
      float tv[C];
      load_row<C>(table + (long long)key * C, tv);
      float gv = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) gv = __fadd_rn(gv, __fmul_rn(gc[c], tv[c]));
      accum_dfrac(k, dims, gv, t0, t1, s);
    }
    if (want_dx && ok) add_dx(dx, n, dims, lv.scale, two_bound, s);
  }
  tab.flush(grad, stats);
}

// meta: [levels, kMetaCols] int64 on the host (offset, size, hashed,
// strides[kMaxDims], ceil(2^64 / size) where size is not a power of two);
// scales: [levels] f32 on the host; offset: the cell offset of the launch.
bool fill_levels(const long long* meta, const float* scales, int n_levels,
                 float offset, Levels* out) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  for (int l = 0; l < n_levels; ++l) {
    const long long* m = meta + (long long)l * kMetaCols;
    Level& lv = out->lv[l];
    if (m[1] < 1 || m[1] > 0xffffffffLL) return false;
    lv.offset = m[0];
    lv.size = (unsigned)m[1];
    lv.mask = (lv.size & (lv.size - 1u)) == 0u ? lv.size - 1u : 0u;
    lv.magic = (unsigned long long)m[3 + kMaxDims];
    if ((lv.size & (lv.size - 1u)) != 0u
        && lv.magic != ~0ull / lv.size + 1ull)
      return false;
    lv.hashed = (int)m[2];
    for (int d = 0; d < kMaxDims; ++d) lv.stride[d] = (unsigned)m[3 + d];
    lv.scale = scales[l];
    lv.coarse = 0;
    lv.fixed_mask = lv.mask;
    // A tiled index that cannot reach the level's size needs no reduction:
    // a point in bounds has x01 <= 1, so each corner coordinate is at most
    // floor(fma(1, scale, offset)) + 1 (the flagship log2-21 level 0: at
    // most 1,419,856 of 1,419,864 rows).
    if (!lv.hashed) {
      const unsigned long long top =
          (unsigned long long)std::floor(std::fma(1.f, lv.scale, offset)) + 1;
      unsigned long long last = 0;
      for (int d = 0; d < kMaxDims; ++d) last += top * lv.stride[d];
      if (last < lv.size) lv.fixed_mask = 0xffffffffu;
    }
  }
  return true;
}

// Flags the levels of scale <= coarse_max_scale coarse (only where the
// table's rows fit the coarse path's u32 keys) and orders them first;
// returns their count.
int order_levels(Levels* lv, int n_levels, float coarse_max_scale,
                 LevelOrder* order) {
  int n_coarse = 0;
  for (int l = 0; l < n_levels; ++l) {
    Level& v = lv->lv[l];
    v.coarse = v.scale <= coarse_max_scale
               && v.offset + (long long)v.size <= (long long)sa::kEmpty;
    if (v.coarse) order->idx[n_coarse++] = l;
  }
  int i = n_coarse;
  for (int l = 0; l < n_levels; ++l)
    if (!lv->lv[l].coarse) order->idx[i++] = l;
  return n_coarse;
}

template <template <int> class Launch, typename... Args>
int dispatch_channels(int channels, Args... args) {
  switch (channels) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    case 16: return Launch<16>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D, int C>
int launch_fixed(cudaStream_t s, const Levels* lv, const float* table,
                 const float* x, float* out, long long n_pts, int n_levels,
                 int xor_variant, float bound, float two_bound, float offset) {
  const long long lanes = n_pts * Fixed<D, C>::kLanes;
  const unsigned grid = (unsigned)((lanes + kThreads - 1) / kThreads);
  encode_fixed_kernel<D, C><<<grid, kThreads, 0, s>>>(
      *lv, table, x, out, n_pts, n_levels, xor_variant, bound, two_bound,
      offset);
  return (int)cudaGetLastError();
}

// Every level's rows, times C, fit a 32-bit offset.
bool fits_fixed(const Levels* lv, int n_levels, int channels) {
  for (int l = 0; l < n_levels; ++l)
    if ((unsigned long long)lv->lv[l].size * channels > 0xffffffffull)
      return false;
  return true;
}

// The compile-time shapes where they apply, else the generic kernel.
template <int C>
struct LaunchFwd {
  static int run(cudaStream_t s, const Levels* lv, const float* table,
                 const float* x, float* out, long long n_pts, int dims,
                 int n_levels, int xor_variant, float bound, float two_bound,
                 float offset) {
    const bool fixed = fits_fixed(lv, n_levels, C);
    if constexpr (C == 8) {
      if (dims == 5 && fixed)
        return launch_fixed<5, 8>(s, lv, table, x, out, n_pts, n_levels,
                                  xor_variant, bound, two_bound, offset);
    }
    if constexpr (C == 2) {
      if (dims == 3 && fixed)
        return launch_fixed<3, 2>(s, lv, table, x, out, n_pts, n_levels,
                                  xor_variant, bound, two_bound, offset);
    }
    dim3 grid((unsigned)((n_pts + kThreads - 1) / kThreads),
              (unsigned)n_levels);
    encode_general_kernel<C><<<grid, kThreads, 0, s>>>(
        *lv, table, x, out, n_pts, dims, n_levels, xor_variant, bound,
        two_bound, offset);
    return (int)cudaGetLastError();
  }
};

template <int C>
struct LaunchBwd {
  static int run(cudaStream_t s, const Levels* lv, const LevelOrder* order,
                 int n_coarse, const float* g, const float* x,
                 const float* table, float* grad, float* dx, long long n_pts,
                 int dims, int n_levels, int xor_variant, float bound,
                 float two_bound, float offset, unsigned long long* stats) {
    if (n_coarse) {
      dim3 grid((unsigned)((n_pts + sa::kBlockPoints - 1) / sa::kBlockPoints),
                (unsigned)n_coarse);
      encode_general_bwd_coarse_kernel<C>
          <<<grid, sa::kThreads, sa::smem_bytes(C), s>>>(
              *lv, *order, g, x, table, grad, dx, n_pts, dims, n_levels,
              xor_variant, bound, two_bound, offset, stats);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess || n_coarse == n_levels) return (int)err;
    }
    dim3 grid((unsigned)((n_pts + kThreads - 1) / kThreads),
              (unsigned)(n_levels - n_coarse));
    encode_general_bwd_kernel<C><<<grid, kThreads, 0, s>>>(
        *lv, *order, n_coarse, g, x, table, grad, dx, n_pts, dims, n_levels,
        xor_variant, bound, two_bound, offset);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// table [rows, channels] f32; x [n, dims] f32; meta / scales as
// `fill_levels`; out [n, levels * channels] f32. channels in
// {1, 2, 4, 8, 16}; 1 <= dims <= 7; levels <= 32; xor_variant: 1 for the
// xor hash, 0 for the paired (add) hash.
int sd_hash_encode_general(const float* table, const float* x,
                           const long long* meta, const float* scales,
                           float* out, long long n_pts, int dims, int levels,
                           int channels, int xor_variant, float bound,
                           float two_bound, float offset, void* stream) {
  Levels lv;
  if (dims < 1 || dims > kMaxDims
      || !fill_levels(meta, scales, levels, offset, &lv))
    return (int)cudaErrorInvalidValue;
  return dispatch_channels<LaunchFwd>(
      channels, (cudaStream_t)stream, (const Levels*)&lv, table, x, out,
      n_pts, dims, levels, xor_variant, bound, two_bound, offset);
}

// g [n, levels * channels] f32; x [n, dims] f32; table [rows, channels]
// f32 or null (then dx is not written); grad [rows, channels] f32,
// zero-filled, or null (no table gradient); dx [n, dims] f32, zero-filled,
// or null. With a table gradient, levels whose scale is <=
// coarse_max_scale take the coarse path (`scatter_accum.cuh`), the others
// the direct one; a negative coarse_max_scale launches the direct path
// alone. stats: null, or [2] u64 to which the coarse path adds the rows
// it flushed and the inserts that overflowed its tables.
int sd_hash_encode_general_bwd(const float* g, const float* x,
                               const long long* meta, const float* scales,
                               const float* table, float* grad, float* dx,
                               long long n_pts, int dims, int levels,
                               int channels, int xor_variant, float bound,
                               float two_bound, float offset,
                               float coarse_max_scale,
                               unsigned long long* stats, void* stream) {
  Levels lv;
  LevelOrder order;
  if (dims < 1 || dims > kMaxDims
      || !fill_levels(meta, scales, levels, offset, &lv) || (dx && !table))
    return (int)cudaErrorInvalidValue;
  const int n_coarse =
      order_levels(&lv, levels, grad ? coarse_max_scale : -1.f, &order);
  return dispatch_channels<LaunchBwd>(
      channels, (cudaStream_t)stream, (const Levels*)&lv,
      (const LevelOrder*)&order, n_coarse, g, x, table, grad, dx, n_pts, dims,
      levels, xor_variant, bound, two_bound, offset, stats);
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
