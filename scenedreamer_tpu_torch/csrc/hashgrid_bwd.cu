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
//      - coarse (`sa::folded_bwd_coarse_kernel<XorCorners>`): a
//        block walks 2,048 consecutive points of one level; each
//        corner's w * g is summed over the warp's lanes on the same
//        slot, added into the block's shared-memory table and flushed
//        with one float4 atomic per 4 channels and slot;
//      - direct (`sa::folded_bwd_direct_kernel<XorCorners>`): one
//        thread per (point, level), one float4 `atomicAdd` per 4
//        channels and corner (sm_90's 16-byte vector atomic on global
//        memory; rows are C * 4 bytes).
//      Both are `scatter_accum.cuh`'s, shared with K5c; this file gives
//      the xor hash's corners (`XorCorners`).
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

// K3a's corners under the xor hash (`sa::launch_folded_bwd`'s policy):
// the cell, taps and per-dimension corner hashes of point n at one level,
// as `hashgrid_fwd.cu` computes them, and corner k's slot hash (before
// the mask) and weight.
struct XorCorners {
  unsigned h0[3], h1[3];
  float t0[3], t1[3];

  __device__ __forceinline__ bool setup(const float* __restrict__ xyz,
                                        long long n, float scale,
                                        float bound, float two_bound,
                                        float offset) {
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

  __device__ __forceinline__ unsigned row(int k, float& w) const {
    unsigned h = (k & 1) ? h1[0] : h0[0];
    w = (k & 1) ? t1[0] : t0[0];
    for (int d = 1; d < 3; ++d) {
      bool bit = (k >> d) & 1;
      h ^= bit ? h1[d] : h0[d];
      w = __fmul_rn(w, bit ? t1[d] : t0[d]);
    }
    return h;
  }
};

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
  return sa::launch_folded_bwd<XorCorners>(
      g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, channels,
      bound, two_bound, offset, coarse_max_scale, stats,
      (cudaStream_t)stream);
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
