// Scene-folded hash-grid encode, backward (K3), for Hopper: two simple
// kernels, plus the forward's bake kernel reused.
//
// Replaces the backward of the JAX package's
// `scenedreamer_tpu/ops/hashgrid.py:hashgrid_encode_folded`:
// `_gather_interp_bwd` with `segment_sum_sorted` on the fine levels,
// `_splat_bwd` with `_dense_remap_consts` on the levels of side <= 64,
// and `_make_bake.bwd`. The sentinel sort, the bf16 sort payload, the
// dense splat matmuls and the xor butterfly there work around XLA's
// serial scatter-add on the TPU; here the scatter is an atomic add.
// With g the cotangent of the encode output [N, L*C]:
//
//  (a) sd_hash_encode_bwd: one thread per (point, level). It recomputes
//      the cell, the frac, the 8 corner hashes and the 8 weights exactly
//      as `hashgrid_fwd.cu` does (same intrinsics, -fmad=false), reads
//      g[n, l*C:(l+1)*C] and atomically adds w_k * g_c into
//      G_l[idx_k, c] (G zero-filled by the caller), four channels per
//      atomic (sm_90's float4 `atomicAdd` on global memory; rows are
//      C * 4 bytes, so 16-byte aligned). Points out of bounds,
//      and every point when the scene code is out of bounds, are skipped:
//      the forward wrote zeros there. With the baked table B it also
//      adds, per level, the gradient through frac to dxyz:
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
// What bounds it: (a) is a scatter, 8 * C / 4 vector atomics per point
// and level plus g's N*L*C*4 bytes; the coarse levels (17^3 = 4,913
// distinct slots at level 0) put thousands of atomics on each slot, so
// contention, not bytes, sets its time. Privatised or warp-aggregated
// accumulation is the redesign target. (c) streams G once and reads T
// through 4 xor permutations of 32-byte rows that stay within one
// level's 16 MB (L2 resident), so device-memory bytes bound it.
//
// C ABI (ctypes): each entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCorners = 8;
constexpr int kDwThreads = 256;

template <int C>
__global__ void encode_bwd_kernel(const float* __restrict__ g,
                                  const float* __restrict__ xyz,
                                  const float* __restrict__ scales,
                                  const float* __restrict__ baked,
                                  float* __restrict__ grad,
                                  float* __restrict__ dxyz, long long n_pts,
                                  int levels, long long slots, float bound,
                                  float two_bound, float offset) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const int l = blockIdx.y;
  float x01[3];
  bool oob = false;
  for (int d = 0; d < 3; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(xyz[3 * n + d], bound), two_bound);
    oob |= x01[d] < 0.f || x01[d] > 1.f;
  }
  if (oob) return;
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  const float scale = scales[l];
  unsigned h0[3], h1[3];
  float t0[3], t1[3];
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
  float gc[C];
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
  const unsigned mask = (unsigned)(slots - 1);
  float* gl = grad + (long long)l * slots * C;
  const float* bl = baked ? baked + (long long)l * slots * C : nullptr;
  float gv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    unsigned h = (k & 1) ? h1[0] : h0[0];
    float w = (k & 1) ? t1[0] : t0[0];
    for (int d = 1; d < 3; ++d) {
      bool bit = (k >> d) & 1;
      h ^= bit ? h1[d] : h0[d];
      w = __fmul_rn(w, bit ? t1[d] : t0[d]);
    }
    const long long row = (long long)(h & mask) * C;
    // sm_90's 16-byte vector atomic: C / 4 per corner instead of C
    float4* g4 = reinterpret_cast<float4*>(gl + row);
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      atomicAdd(g4 + q, make_float4(__fmul_rn(w, gc[4 * q]),
                                    __fmul_rn(w, gc[4 * q + 1]),
                                    __fmul_rn(w, gc[4 * q + 2]),
                                    __fmul_rn(w, gc[4 * q + 3])));
    if (bl) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) s = __fadd_rn(s, __fmul_rn(gc[c], bl[row + c]));
      gv[k] = s;
    }
  }
  if (!dxyz) return;
  // d/dfrac_d of w_k = sign_{k,d} * product of the other two taps
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
// zero-filled, or null. slots a power of two, channels 4 or 8.
int sd_hash_encode_bwd(const float* g, const float* xyz, const float* scales,
                       const float* baked, float* grad, float* dxyz,
                       long long n_pts, int levels, long long slots,
                       int channels, float bound, float two_bound,
                       float offset, void* stream) {
  const int threads = 256;
  dim3 grid((unsigned)((n_pts + threads - 1) / threads), (unsigned)levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 8) {
    encode_bwd_kernel<8><<<grid, threads, 0, s>>>(
        g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, bound,
        two_bound, offset);
  } else if (channels == 4) {
    encode_bwd_kernel<4><<<grid, threads, 0, s>>>(
        g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, bound,
        two_bound, offset);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
