// Scene-folded hash-grid encode, backward (K3), for Hopper: the table
// scatter on two paths, the dw reduction, plus the forward's bake kernel
// reused.
//
// Replaces the backward of the JAX package's
// `scenedreamer_tpu/ops/hashgrid.py:hashgrid_encode_folded`:
// `_gather_interp_bwd` with `segment_sum_sorted` on the fine levels,
// `_splat_bwd` with `_dense_remap_consts` on the levels of side <= 64,
// and `_make_bake.bwd`. The sentinel sort, the bf16 sort payload, the
// dense splat matmuls and the xor butterfly there work around XLA's
// serial scatter-add on the TPU; here the scatter adds atomically, after
// summing on chip what it can. With g the cotangent of the encode output
// [N, L*C]:
//
//  (a) sd_hash_encode_bwd: G_l[idx_k, c] += w_k * g[n, l*C + c] (G
//      zero-filled by the caller) for every in-bounds point n and corner
//      k, the cell, frac, 8 corner hashes and 8 weights recomputed
//      exactly as `hashgrid_fwd.cu` does (same intrinsics, -fmad=false);
//      points out of bounds, and every point when the scene code is out
//      of bounds, are skipped (the forward wrote zeros there). Two paths,
//      chosen per level by the caller's coarse_max_scale:
//      - coarse (`encode_bwd_coarse_kernel`, `scatter_accum.cuh`): a
//        block walks 2,048 consecutive points of one level; each
//        corner's w * g is summed over the warp's lanes on the same
//        slot, added into the block's shared-memory table and flushed
//        with one float4 atomic per 4 channels and slot;
//      - direct (`encode_bwd_kernel`): one thread per (point, level),
//        one float4 `atomicAdd` per 4 channels and corner (sm_90's
//        16-byte vector atomic on global memory; rows are C * 4 bytes).
//      With the baked table B both also add, per level, the gradient
//      through frac to dxyz:
//        dxyz[n,d] += (scale_l / 2 bound) * sum_k gv_k * sign_{k,d}
//                     * prod_{d' != d} t_{k,d'},  gv_k = sum_c g_c B_l[idx_k,c].
//  (b) dT_l[s] = sum_a w_a * G_l[s ^ m_a] is the bake applied to G (xor is
//      its own inverse): the caller launches `sd_hash_bake` on G (its
//      wrapper counts that launch as 'hash_bake_bwd').
//  (c) sd_hash_bake_dw: dw_{l,a} = sum_{j,c} T_l[j ^ m_a, c] * G_l[j, c],
//      the gradient of the scene-fold weights (how the world encoder's
//      scene code trains). Blocks of one level stride over its S*C/4
//      float4s and keep one float64 partial sum per corner; a block
//      reduces them in shared memory into a [L, A, blocks] scratch, and a
//      second kernel sums each (l, a) row in block order. The sum order is
//      fixed, so dw is deterministic; float64 products and sums make it
//      exact to float32 rounding of the result.
//
// What bounds it: (a) moves g's in-bounds rows, xyz and G once (0.338
// ms on an H100 for the 1,647,456 points of a 262x262x24 training crop
// at 16 x 2^19 x 8), but its time is set by the number of global
// atomics, not by bytes: the direct path issues 2 float4 atomics per
// corner, 26.4M per level, and takes 2.6-5.4 ms on every level (level 0,
// 284 rows, is among the slowest; the finest, 489,827 rows, still 3.1
// ms), 46.3 ms in all. The coarse path takes 0.21-0.35 ms per level and
// 3.22 ms in all: in ray order the blocks flush 17k (level 0) to 372k
// (level 15) rows per level in place of 13.2M corner adds, and 0 to 3.0M
// inserts overflow their tables. Every level of that spec is faster on
// the coarse path, also with the points shuffled (8.9 against 35.1 ms),
// so callers send every level there. The coarse path also sums more exactly: the
// camera's 388,200 coincident samples (rays that hit nothing) pile onto
// single rows, which it sums on chip before one global add. (c) streams
// G once and reads T through 4 xor permutations of 32-byte rows that
// stay within one level's 16 MB (L2 resident), so device-memory bytes
// bound it.
//
// C ABI (ctypes): each entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "scatter_accum.cuh"

namespace {

namespace sa = scatter_accum;

constexpr int kMaxCorners = 8;
constexpr int kDwThreads = 256;

// Cell, taps and per-dimension corner hashes of point n at one level, as
// `hashgrid_fwd.cu` computes them; false when the point is out of bounds.
__device__ __forceinline__ bool point_setup(const float* __restrict__ xyz,
                                            long long n, float scale,
                                            float two_bound, float bound,
                                            float offset, unsigned (&h0)[3],
                                            unsigned (&h1)[3],
                                            float (&t0)[3], float (&t1)[3]) {
  float x01[3];
  bool oob = false;
  for (int d = 0; d < 3; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(xyz[3 * n + d], bound), two_bound);
    oob |= x01[d] < 0.f || x01[d] > 1.f;
  }
  if (oob) return false;
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  for (int d = 0; d < 3; ++d) {
    float pos = __fmaf_rn(x01[d], scale, offset);
    float cell = floorf(pos);
    float frac = __fsub_rn(pos, cell);
    unsigned u = (unsigned)cell;
    h0[d] = u * primes[d];
    h1[d] = (u + 1u) * primes[d];
    t1[d] = frac;
    t0[d] = __fsub_rn(1.f, frac);
  }
  return true;
}

// Slot hash (before the mask) and weight of corner k.
__device__ __forceinline__ unsigned corner_hash(int k, const unsigned (&h0)[3],
                                                const unsigned (&h1)[3],
                                                const float (&t0)[3],
                                                const float (&t1)[3],
                                                float& w) {
  unsigned h = (k & 1) ? h1[0] : h0[0];
  w = (k & 1) ? t1[0] : t0[0];
  for (int d = 1; d < 3; ++d) {
    bool bit = (k >> d) & 1;
    h ^= bit ? h1[d] : h0[d];
    w = __fmul_rn(w, bit ? t1[d] : t0[d]);
  }
  return h;
}

template <int C>
__device__ __forceinline__ void load_g(const float* __restrict__ g,
                                       long long n, int levels, int l,
                                       float (&gc)[C]) {
  const float4* grow = reinterpret_cast<const float4*>(
      g + n * (long long)levels * C + (long long)l * C);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    float4 v = grow[q];
    gc[4 * q] = v.x;
    gc[4 * q + 1] = v.y;
    gc[4 * q + 2] = v.z;
    gc[4 * q + 3] = v.w;
  }
}

template <int C>
__device__ __forceinline__ float dot_row(const float (&gc)[C],
                                         const float* __restrict__ row) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s = __fadd_rn(s, __fmul_rn(gc[c], row[c]));
  return s;
}

// dxyz[n, d] += (scale / 2 bound) * sum_k gv_k sign_{k,d} prod_{d' != d}
// t_{k,d'}: d/dfrac_d of w_k is sign_{k,d} times the other two taps.
__device__ __forceinline__ void add_dxyz(float* __restrict__ dxyz, long long n,
                                         const float (&gv)[8],
                                         const float (&t0)[3],
                                         const float (&t1)[3], float scale,
                                         float two_bound) {
  const float dpos_scale = __fdiv_rn(scale, two_bound);
  for (int d = 0; d < 3; ++d) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float excl = 1.f;
      for (int e = 0; e < 3; ++e) {
        if (e == d) continue;
        excl = __fmul_rn(excl, ((k >> e) & 1) ? t1[e] : t0[e]);
      }
      float term = __fmul_rn(gv[k], excl);
      s = ((k >> d) & 1) ? __fadd_rn(s, term) : __fsub_rn(s, term);
    }
    atomicAdd(dxyz + 3 * n + d, __fmul_rn(s, dpos_scale));
  }
}

// The direct path: one thread per (point, level), one global float4
// atomic per 4 channels of each corner. Levels with scale <=
// coarse_max_scale belong to `encode_bwd_coarse_kernel`.
template <int C>
__global__ void encode_bwd_kernel(const float* __restrict__ g,
                                  const float* __restrict__ xyz,
                                  const float* __restrict__ scales,
                                  const float* __restrict__ baked,
                                  float* __restrict__ grad,
                                  float* __restrict__ dxyz, long long n_pts,
                                  int levels, long long slots, float bound,
                                  float two_bound, float offset,
                                  float coarse_max_scale) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const int l = blockIdx.y;
  const float scale = scales[l];
  if (scale <= coarse_max_scale) return;
  unsigned h0[3], h1[3];
  float t0[3], t1[3];
  if (!point_setup(xyz, n, scale, two_bound, bound, offset, h0, h1, t0, t1))
    return;
  float gc[C];
  load_g<C>(g, n, levels, l, gc);
  const unsigned mask = (unsigned)(slots - 1);
  float* gl = grad + (long long)l * slots * C;
  const float* bl = baked ? baked + (long long)l * slots * C : nullptr;
  float gv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float w;
    const unsigned h = corner_hash(k, h0, h1, t0, t1, w);
    const long long row = (long long)(h & mask) * C;
    // sm_90's 16-byte vector atomic: C / 4 per corner instead of C
    float4* g4 = reinterpret_cast<float4*>(gl + row);
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      atomicAdd(g4 + q, make_float4(__fmul_rn(w, gc[4 * q]),
                                    __fmul_rn(w, gc[4 * q + 1]),
                                    __fmul_rn(w, gc[4 * q + 2]),
                                    __fmul_rn(w, gc[4 * q + 3])));
    if (bl) gv[k] = dot_row<C>(gc, bl + row);
  }
  if (dxyz) add_dxyz(dxyz, n, gv, t0, t1, scale, two_bound);
}

// The coarse path (`scatter_accum.cuh`): block (b, l) walks points
// [b * kBlockPoints, (b + 1) * kBlockPoints) of level l when scales[l] <=
// coarse_max_scale (other levels' blocks return at once); each corner's
// w * g is summed over the warp's lanes on the same slot, added into the
// block's shared-memory table and flushed once per slot at the end. The
// gradient through frac is the direct path's, per point.
template <int C>
__global__ void __launch_bounds__(sa::kThreads) encode_bwd_coarse_kernel(
    const float* __restrict__ g, const float* __restrict__ xyz,
    const float* __restrict__ scales, const float* __restrict__ baked,
    float* __restrict__ grad, float* __restrict__ dxyz, long long n_pts,
    int levels, long long slots, float bound, float two_bound, float offset,
    float coarse_max_scale, unsigned long long* __restrict__ stats) {
  const int l = blockIdx.y;
  const float scale = scales[l];
  if (!(scale <= coarse_max_scale)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  sa::Table<C> table(smem);
  table.clear();
  const long long first = (long long)blockIdx.x * sa::kBlockPoints;
  const long long last =
      first + sa::kBlockPoints < n_pts ? first + sa::kBlockPoints : n_pts;
  const unsigned mask = (unsigned)(slots - 1);
  const unsigned level_row = (unsigned)(l * slots);
  // every lane runs the same iterations: the warp reduction needs them all
  for (long long base = first; base < last; base += blockDim.x) {
    const long long n = base + threadIdx.x;
    unsigned h0[3], h1[3];
    float t0[3], t1[3];
    const bool ok = n < last && point_setup(xyz, n, scale, two_bound, bound,
                                            offset, h0, h1, t0, t1);
    float gc[C];
    if (ok) {
      load_g<C>(g, n, levels, l, gc);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) gc[c] = 0.f;
    }
    float gv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      unsigned key = sa::kEmpty;
      float v[C];
      float w = 0.f;
      if (ok) key = level_row + (corner_hash(k, h0, h1, t0, t1, w) & mask);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gc[c]);
      if (sa::warp_reduce_peers<C>(key, v) && key != sa::kEmpty)
        table.insert(key, v, grad);
      if (baked && ok) gv[k] = dot_row<C>(gc, baked + (long long)key * C);
    }
    if (dxyz && ok) add_dxyz(dxyz, n, gv, t0, t1, scale, two_bound);
  }
  table.flush(grad, stats);
}

__global__ void bake_dw_partial_kernel(const float4* __restrict__ table,
                                       const float4* __restrict__ grad,
                                       const int* __restrict__ masks,
                                       double* __restrict__ partial,
                                       long long slots, int c4, int corners,
                                       int blocks) {
  __shared__ double red[kDwThreads];
  const int l = blockIdx.y;
  const long long per_level = slots * c4;
  const float4* tl = table + (long long)l * per_level;
  const float4* gl = grad + (long long)l * per_level;
  long long m[kMaxCorners];
  double acc[kMaxCorners];
#pragma unroll
  for (int a = 0; a < kMaxCorners; ++a) {
    m[a] = a < corners ? (long long)masks[l * corners + a] : 0;
    acc[a] = 0.0;
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < per_level; i += (long long)blocks * blockDim.x) {
    const long long j = i / c4;
    const int q = (int)(i % c4);
    const float4 gv = gl[i];
#pragma unroll
    for (int a = 0; a < kMaxCorners; ++a) {
      if (a >= corners) break;
      const float4 tv = tl[(j ^ m[a]) * c4 + q];
      acc[a] += (double)tv.x * (double)gv.x + (double)tv.y * (double)gv.y
              + (double)tv.z * (double)gv.z + (double)tv.w * (double)gv.w;
    }
  }
  for (int a = 0; a < corners; ++a) {
    red[threadIdx.x] = acc[a];
    __syncthreads();
    for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
      __syncthreads();
    }
    if (threadIdx.x == 0)
      partial[((long long)l * corners + a) * blocks + blockIdx.x] = red[0];
    __syncthreads();
  }
}

__global__ void bake_dw_finish_kernel(const double* __restrict__ partial,
                                      float* __restrict__ dw, int rows,
                                      int blocks) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)i * blocks + b];
  dw[i] = (float)s;
}

template <int C>
int launch_encode_bwd(const float* g, const float* xyz, const float* scales,
                      const float* baked, float* grad, float* dxyz,
                      long long n_pts, int levels, long long slots,
                      float bound, float two_bound, float offset,
                      float coarse_max_scale, unsigned long long* stats,
                      cudaStream_t s) {
  if (coarse_max_scale >= 0.f) {
    if ((long long)levels * slots >= (long long)sa::kEmpty)
      return (int)cudaErrorInvalidValue;    // the tables' keys are u32
    dim3 grid((unsigned)((n_pts + sa::kBlockPoints - 1) / sa::kBlockPoints),
              (unsigned)levels);
    encode_bwd_coarse_kernel<C><<<grid, sa::kThreads, sa::smem_bytes(C), s>>>(
        g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, bound,
        two_bound, offset, coarse_max_scale, stats);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  dim3 grid((unsigned)((n_pts + threads - 1) / threads), (unsigned)levels);
  encode_bwd_kernel<C><<<grid, threads, 0, s>>>(
      g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, bound,
      two_bound, offset, coarse_max_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g [n, levels*channels] f32; xyz [n, 3] f32; scales [levels] f32;
// baked [levels, slots, channels] f32 or null (then dxyz is not written);
// grad [levels, slots, channels] f32, zero-filled; dxyz [n, 3] f32,
// zero-filled, or null. slots a power of two, channels 4 or 8. Levels
// whose scale is <= coarse_max_scale take the coarse path
// (`scatter_accum.cuh`; it needs levels * slots < 2^32 - 1), the others
// the direct one; a negative coarse_max_scale launches the direct path
// alone. stats: null, or [2] u64 to which the coarse path adds the rows
// it flushed and the inserts that overflowed its tables.
int sd_hash_encode_bwd(const float* g, const float* xyz, const float* scales,
                       const float* baked, float* grad, float* dxyz,
                       long long n_pts, int levels, long long slots,
                       int channels, float bound, float two_bound,
                       float offset, float coarse_max_scale,
                       unsigned long long* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 8)
    return launch_encode_bwd<8>(g, xyz, scales, baked, grad, dxyz, n_pts,
                                levels, slots, bound, two_bound, offset,
                                coarse_max_scale, stats, s);
  if (channels == 4)
    return launch_encode_bwd<4>(g, xyz, scales, baked, grad, dxyz, n_pts,
                                levels, slots, bound, two_bound, offset,
                                coarse_max_scale, stats, s);
  return (int)cudaErrorInvalidValue;
}

// table, grad: [levels, slots, channels] f32, channels % 4 == 0;
// masks [levels, corners] i32, corners <= 8; partial: scratch of
// levels*corners*blocks f64; dw [levels, corners] f32.
int sd_hash_bake_dw(const float* table, const float* grad, const int* masks,
                    double* partial, float* dw, int levels, long long slots,
                    int channels, int corners, int blocks, void* stream) {
  if (corners < 1 || corners > kMaxCorners || channels % 4 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)blocks, (unsigned)levels);
  bake_dw_partial_kernel<<<grid, kDwThreads, 0, s>>>(
      reinterpret_cast<const float4*>(table),
      reinterpret_cast<const float4*>(grad), masks, partial, slots,
      channels / 4, corners, blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = levels * corners;
  bake_dw_finish_kernel<<<(rows + 127) / 128, 128, 0, s>>>(partial, dw, rows,
                                                           blocks);
  return (int)cudaGetLastError();
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
