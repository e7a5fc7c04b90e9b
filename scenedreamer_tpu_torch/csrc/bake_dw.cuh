// The weight half of a scene fold's backward, for Hopper: dw_{l,a} =
// sum_{j,c} T_l[src(j, m_a), c] * G_l[j, c] over a level's S rows of C
// floats, for the A fold corners of each of L levels. One skeleton for
// both fold variants; a source gives only its window, the row of T
// that row j of G meets under corner a:
//   - xor (K3c, `hashgrid_bwd.cu`): src = j ^ m_a;
//   - shift (K5d, `hashgrid_paired.cu`): src = (j + m_a) mod S.
// A window maps float4 index i = j * C/4 + q (q < C/4) of a level to
// the float4 index of T it reads, given off = (m_a & (S-1)) * C/4:
//   - xor: i ^ off. C/4 is 1 or 2, a power of two, and q < C/4, so
//     (j C/4 + q) ^ (m C/4) = (j ^ m) C/4 + q, with no division; the
//     rows j ^ m of an aligned group of rows stay within one aligned
//     group of the same size, permuted, so a warp's loads still meet
//     whole 32-byte sectors;
//   - shift: i + off, less P = S C/4 once if it reaches P.
//
// `dw_partial_kernel<Window>`: a persistent grid of `gridDim.x` blocks
// walks the levels in order; at each level block b takes the contiguous
// float4s [b P / B, (b+1) P / B) of G and, for each corner a, the same
// span of T through a's window. All blocks work on one level at a time,
// so the level's T (16 MB at 2^19 x 8) stays in L2 while its A windows
// pass over it; G streams past it (`__ldcs`, evict first). Device memory
// then moves T and G once each. Each G value becomes a double once; a
// product of two floats is exact in float64, so each is added with one
// float64 fused multiply-add, rounded as a separate product and sum
// would be. The corner loop is unrolled to kMaxCorners, so the A sums
// stay in registers (a loop to `corners` indexes them at run time and
// puts them in local memory). Each warp's sums go to its own
// partial[(l * A + a) * W + w] (W the grid's warps), without a barrier,
// so no warp waits for the others at a level's end. The caller's B = 4
// blocks per SM of an H100 (the launch bounds keep a thread within 64
// registers) are resident at once; no block waits on another, so a grid
// that is not gives the same dw, only later.
//
// `dw_finish_kernel`: one block per (level, corner) sums that row's W
// partials in a fixed order, so dw is the same on every launch.
//
// Offsets are 32-bit: the launcher needs S * C <= 2^32.
#pragma once

#include <cuda_runtime.h>

namespace bake_dw {

constexpr int kMaxCorners = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <class Window>
__global__ void __launch_bounds__(kThreads, 4) dw_partial_kernel(
    const float4* __restrict__ table, const float4* __restrict__ grad,
    const int* __restrict__ masks, double* __restrict__ partial,
    int levels, long long slots, int c4, int corners) {
  const unsigned per_level = (unsigned)(slots * c4);
  const unsigned lo = (unsigned)((unsigned long long)per_level * blockIdx.x
                                 / gridDim.x);
  const unsigned hi = (unsigned)((unsigned long long)per_level
                                 * (blockIdx.x + 1) / gridDim.x);
  const unsigned warps = gridDim.x * kWarps;
  const unsigned warp = blockIdx.x * kWarps + threadIdx.x / 32;
  for (int l = 0; l < levels; ++l) {
    const float4* tl = table + (long long)l * per_level;
    const float4* gl = grad + (long long)l * per_level;
    unsigned off[kMaxCorners];
    double acc[kMaxCorners];
#pragma unroll
    for (int a = 0; a < kMaxCorners; ++a) {
      off[a] = a < corners
                   ? (unsigned)((masks[l * corners + a] & (slots - 1)) * c4)
                   : 0u;
      acc[a] = 0.0;
    }
    for (unsigned i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float4 gv = __ldcs(gl + i);
      const double gx = gv.x, gy = gv.y, gz = gv.z, gw = gv.w;
#pragma unroll
      for (int a = 0; a < kMaxCorners; ++a) {
        if (a >= corners) break;
        const float4 tv = tl[Window::src(i, off[a], per_level)];
        double s = __fma_rn((double)tv.x, gx, acc[a]);
        s = __fma_rn((double)tv.y, gy, s);
        s = __fma_rn((double)tv.z, gz, s);
        acc[a] = __fma_rn((double)tv.w, gw, s);
      }
    }
#pragma unroll
    for (int a = 0; a < kMaxCorners; ++a) {
      if (a >= corners) break;
      double v = acc[a];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, d);
      if (threadIdx.x % 32 == 0)
        partial[((long long)l * corners + a) * warps + warp] = v;
    }
  }
}

// One block per (level, corner) sums its `per_row` partials in a fixed
// order: thread t the partials t, t + 256, ... in turn, then the threads
// pairwise in shared memory, halving the stride.
__global__ void __launch_bounds__(kThreads) dw_finish_kernel(
    const double* __restrict__ partial, float* __restrict__ dw,
    int per_row) {
  __shared__ double red[kThreads];
  const double* p = partial + (long long)blockIdx.x * per_row;
  double s = 0.0;
  for (int i = threadIdx.x; i < per_row; i += kThreads) s += p[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) dw[blockIdx.x] = (float)red[0];
}

// table, grad: [levels, slots, channels] f32, channels 4 or 8, slots a
// power of two, slots * channels <= 2^32; masks [levels, corners] i32
// (reduced & (slots-1) here), corners <= 8; blocks: the grid, all
// resident at once; partial: scratch of levels*corners*blocks*kWarps
// f64 (one per warp); dw [levels, corners] f32. Returns
// cudaGetLastError().
template <class Window>
int launch_dw(const float* table, const float* grad, const int* masks,
              double* partial, float* dw, int levels, long long slots,
              int channels, int corners, int blocks, cudaStream_t stream) {
  if (corners < 1 || corners > kMaxCorners || (channels != 4 && channels != 8)
      || blocks < 1 || levels < 1 || slots < 1 || (slots & (slots - 1))
      || slots * channels > (1ll << 32))
    return (int)cudaErrorInvalidValue;
  dw_partial_kernel<Window><<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(table),
      reinterpret_cast<const float4*>(grad), masks, partial, levels, slots,
      channels / 4, corners);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_finish_kernel<<<levels * corners, kThreads, 0, stream>>>(
      partial, dw, blocks * kWarps);
  return (int)cudaGetLastError();
}

}  // namespace bake_dw
