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
//             size_l is a power of two);
//   (a) sd_hash_encode_general: out[n, l*C + c] = sum_k w_k T[off_l +
//       idx_k, c], summed in ascending k; zeros when any coordinate of the
//       point lies outside [0, 1].
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
// level) (32 rows at D = 5), most of them random, so device-memory
// transactions bound it, not bytes; the coarse levels' rows stay in L2.
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
#include <cstdint>
#include <cuda_runtime.h>

#include "scatter_accum.cuh"

namespace {

namespace sa = scatter_accum;

constexpr int kMaxDims = 7;
constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kMetaCols = 3 + kMaxDims;   // offset, size, hashed, strides
__device__ __constant__ unsigned kPrimes[kMaxDims] = {
    1u, 2654435761u, 805459861u, 3674653429u, 2097192037u, 1434869437u,
    2165219737u};

struct Level {
  long long offset;              // first row of the level in the table
  unsigned size;                 // rows of the level
  unsigned mask;                 // size - 1 for a power-of-two size, else 0
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

__device__ __forceinline__ unsigned reduce_row(unsigned h, const Level& lv) {
  return lv.mask ? (h & lv.mask) : (h % lv.size);
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
    const float pos = __fmaf_rn(x01, lv.scale, offset);
    const float cell = floorf(pos);
    const float frac = __fsub_rn(pos, cell);
    const unsigned u = (unsigned)cell;     // saturating for oob points
    const unsigned m = lv.hashed ? kPrimes[d] : lv.stride[d];
    a0[d] = u * m;
    a1[d] = (u + 1u) * m;
    t1[d] = frac;
    t0[d] = __fsub_rn(1.f, frac);
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

template <int C>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
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
// strides[kMaxDims]); scales: [levels] f32 on the host.
bool fill_levels(const long long* meta, const float* scales, int n_levels,
                 Levels* out) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  for (int l = 0; l < n_levels; ++l) {
    const long long* m = meta + (long long)l * kMetaCols;
    Level& lv = out->lv[l];
    if (m[1] < 1 || m[1] > 0xffffffffLL) return false;
    lv.offset = m[0];
    lv.size = (unsigned)m[1];
    lv.mask = (lv.size & (lv.size - 1u)) == 0u ? lv.size - 1u : 0u;
    lv.hashed = (int)m[2];
    for (int d = 0; d < kMaxDims; ++d) lv.stride[d] = (unsigned)m[3 + d];
    lv.scale = scales[l];
    lv.coarse = 0;
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

template <int C>
struct LaunchFwd {
  static int run(dim3 grid, cudaStream_t s, const Levels* lv,
                 const float* table, const float* x, float* out,
                 long long n_pts, int dims, int n_levels, int xor_variant,
                 float bound, float two_bound, float offset) {
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
  if (dims < 1 || dims > kMaxDims || !fill_levels(meta, scales, levels, &lv))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_pts + kThreads - 1) / kThreads), (unsigned)levels);
  return dispatch_channels<LaunchFwd>(
      channels, grid, (cudaStream_t)stream, (const Levels*)&lv, table, x, out,
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
  if (dims < 1 || dims > kMaxDims || !fill_levels(meta, scales, levels, &lv)
      || (dx && !table))
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
