// Scene-folded hash-grid encode under the 'paired' hash variant (K5),
// forward and backward, for Hopper: four kernels, the scatter on two
// paths.
//
// Replaces, in the JAX package's `scenedreamer_tpu/ops/hashgrid.py`, the
// paired branch of `hashgrid_encode_folded`: `_shift_bake` (the scene
// fold as a blend of `jnp.roll`s), `_paired_corner_fetch` /
// `paired_gather_interp` / `_paired_vals` (one slice-size-2 gather per
// (y, z) corner from a cyclically extended table), their backward
// `_paired_gather_interp_bwd` (a sentinel sort of [w0 g | w1 g] pair
// payloads keyed by the pair base, folded with a roll), the dense splat
// `_splat_bwd` with the paired remap on the coarse levels, and
// `_make_bake.bwd` with `_inv_shift_take`.
//
// The variant's hash is h = (x*1 + y*P1 + z*P2 + ...) mod 2^32, reduced
// with & (S-1): an ADD where the reference hash has an xor. Dimension 0
// has prime 1, so the two x-corners of a cell are rows `base` and
// (base + 1) & (S-1) of the level's table: adjacent, cyclic at S-1. The
// trailing scene dimensions add a constant m_a per scene corner, so the
// scene fold is B_l[j] = sum_a w_a * T_l[(j + m_a) & (S-1)].
//
//  (a) sd_hash_shift_bake: one thread per (level, row, 4 channels);
//      B_l[j] = 0 + w_0*T_l[(j+m_0)&(S-1)] + w_1*... in ascending a. The
//      adjoint dT_l[k] = sum_a w_a * G_l[(k - m_a) & (S-1)] is the same
//      kernel with shifts (S - m_a) & (S-1); the caller passes those.
//  (b) sd_hash_encode_paired: one thread per (point, level). For each of
//      the 4 (y, z) corners k = y_bit + 2 z_bit, in ascending k, base_k =
//      (x + y'*P1 + z'*P2) & (S-1) in uint32 and the rows base_k, then
//      (base_k+1) & (S-1), are added with weights ((t_y t_z) * (1-f_x))
//      and ((t_y t_z) * f_x): out = sum_k sum_j w_kj * B_l[(base_k+j)
//      mod S], the order the plain PyTorch version sums in. When base_k
//      != S-1 the two rows are 2*C*4 contiguous bytes (64 at C = 8).
//      Out-of-bounds points, or an out-of-bounds scene code, give zeros.
//  (c) sd_hash_encode_paired_bwd: the table scatter G_l[(base_k+j) &
//      (S-1)] += w_kj * g for the 8 rows of every in-bounds point and
//      level, bases and weights recomputed as (b) does. Two paths, chosen
//      per level by the caller's coarse_max_scale, as K3a's
//      (`hashgrid_bwd.cu`):
//      - coarse (`sa::folded_bwd_coarse_kernel<PairedCorners>`):
//        a block walks 2,048 consecutive points of one level; each row's
//        w * g is summed over the warp's lanes on the same row, added into
//        the block's shared-memory table and flushed with one float4
//        atomic per 4 channels and row. The two rows of a pair are two
//        keys that differ by one;
//      - direct (`sa::folded_bwd_direct_kernel<PairedCorners>`): one
//        thread per (point, level), one float4 `atomicAdd` per 4
//        channels and row.
//      Both are `scatter_accum.cuh`'s, shared with K3a; this file gives
//      the paired hash's rows (`PairedCorners`).
//      With B both also add the gradient through frac to dxyz, the 8
//      rows taken as corners (x_bit, y_bit, z_bit).
//  (d) sd_hash_shift_bake_dw: dw_{l,a} = sum_{j,c} T_l[(j+m_a)&(S-1), c]
//      * G_l[j, c]; float64 partial sums per block, reduced in shared
//      memory, then summed per (l, a) in block order by a second kernel:
//      a fixed order, so dw is deterministic.
//
// What bounds them: (a) and (d) stream one table and read another
// through 4 shifted windows of the same level (16 MB at 2^19 x 8 floats,
// L2 resident), so device-memory bytes; (b) is a gather of 4 random
// 64-byte pairs per point and level plus N*L*C*4 output bytes, so
// transaction rate; (c) moves g's rows, xyz and G once (0.338 ms on an
// H100 for the 1,647,456 points of a 262x262x24 training crop at 16 x
// 2^19 x 8), but its direct path issues 2 float4 atomics per row, 26.4M
// per level, and is bound by that count as K3a's direct path is: 2.96-
// 5.26 ms on every level, 47.5 ms in all, on an NVIDIA H100 80GB HBM3 at
// 700 W. The coarse path sums on chip first, so its global atomics drop
// to the rows each block touched plus the inserts that overflow its
// table: in ray order 17k (level 0) to 373k (level 15) flushed rows and
// 0 to 3.0M overflowed inserts, 0.20-0.35 ms per level and 3.16 ms in
// all on the same card; shuffled 9.0 ms against 38.6.
//
// Numerics as in hashgrid_fwd.cu: the cell position is one __fmaf_rn,
// every other product and sum an explicit round-to-nearest intrinsic in
// the order above, and the file builds with -fmad=false.
//
// C ABI (ctypes): each entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "scatter_accum.cuh"

namespace {

namespace sa = scatter_accum;

constexpr int kMaxCorners = 8;
constexpr int kDwThreads = 256;
constexpr unsigned kP1 = 2654435761u;
constexpr unsigned kP2 = 805459861u;

__global__ void shift_bake_kernel(const float4* __restrict__ table,
                                  const int* __restrict__ shifts,
                                  const float* __restrict__ weights,
                                  float4* __restrict__ baked, int levels,
                                  long long slots, int c4, int corners) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)levels * slots * c4;
  if (i >= total) return;
  int q = (int)(i % c4);
  long long j = (i / c4) % slots;
  int l = (int)(i / ((long long)c4 * slots));
  const float4* tl = table + (long long)l * slots * c4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int a = 0; a < corners; ++a) {
    long long src = (j + (long long)shifts[l * corners + a]) & (slots - 1);
    float w = weights[l * corners + a];
    float4 v = tl[src * c4 + q];
    acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
  }
  baked[i] = acc;
}

// The cell of point n at one level: x01 -> the uint32 cell coordinates u
// and the taps t0 = 1 - frac, t1 = frac. Returns false out of bounds.
__device__ __forceinline__ bool paired_cell(const float* __restrict__ xyz,
                                            long long n, float scale,
                                            float bound, float two_bound,
                                            float offset, unsigned (&u)[3],
                                            float (&t0)[3], float (&t1)[3]) {
  float x01[3];
  bool oob = false;
  for (int d = 0; d < 3; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(xyz[3 * n + d], bound), two_bound);
    oob |= x01[d] < 0.f || x01[d] > 1.f;
  }
  if (oob) return false;
  for (int d = 0; d < 3; ++d) {
    float pos = __fmaf_rn(x01[d], scale, offset);
    float cell = floorf(pos);
    float frac = __fsub_rn(pos, cell);
    u[d] = (unsigned)cell;
    t1[d] = frac;
    t0[d] = __fsub_rn(1.f, frac);
  }
  return true;
}

template <int C>
__global__ void encode_paired_kernel(const float* __restrict__ xyz,
                                     const float* __restrict__ baked,
                                     const float* __restrict__ scales,
                                     float* __restrict__ out,
                                     long long n_pts, int levels,
                                     long long slots, float bound,
                                     float two_bound, float offset,
                                     int scene_oob) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const int l = blockIdx.y;
  float4* o = reinterpret_cast<float4*>(out + n * (long long)levels * C
                                        + (long long)l * C);
  unsigned u[3];
  float t0[3], t1[3];
  if (scene_oob != 0 || !paired_cell(xyz, n, scales[l], bound, two_bound,
                                     offset, u, t0, t1)) {
    for (int q = 0; q < C / 4; ++q) o[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const unsigned mask = (unsigned)(slots - 1);
  const float4* tl = reinterpret_cast<const float4*>(
      baked + (long long)l * slots * C);
  float acc[C];
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int by = k & 1, bz = k >> 1;
    const unsigned base = (u[0] + (u[1] + by) * kP1 + (u[2] + bz) * kP2)
                          & mask;
    const float wr = __fmul_rn(by ? t1[1] : t0[1], bz ? t1[2] : t0[2]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float w = __fmul_rn(wr, j ? t1[0] : t0[0]);
      const float4* row = tl + (long long)((base + j) & mask) * (C / 4);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        float4 v = row[q];
        acc[4 * q] = __fadd_rn(acc[4 * q], __fmul_rn(w, v.x));
        acc[4 * q + 1] = __fadd_rn(acc[4 * q + 1], __fmul_rn(w, v.y));
        acc[4 * q + 2] = __fadd_rn(acc[4 * q + 2], __fmul_rn(w, v.z));
        acc[4 * q + 3] = __fadd_rn(acc[4 * q + 3], __fmul_rn(w, v.w));
      }
    }
  }
  for (int q = 0; q < C / 4; ++q)
    o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]);
}

// K5c's rows under the paired hash (`sa::launch_folded_bwd`'s policy):
// corner k = x + 2 y + 4 z is row j = x of the pair (y, z), the row
// base + j before the mask with base = x + y' P1 + z' P2, and weight
// (t_y t_z) t_x, the order the forward (b) multiplies in.
struct PairedCorners {
  unsigned u[3];
  float t0[3], t1[3];

  __device__ __forceinline__ bool setup(const float* __restrict__ xyz,
                                        long long n, float scale,
                                        float bound, float two_bound,
                                        float offset) {
    return paired_cell(xyz, n, scale, bound, two_bound, offset, u, t0, t1);
  }

  __device__ __forceinline__ unsigned row(int k, float& w) const {
    const unsigned j = k & 1, by = (k >> 1) & 1, bz = k >> 2;
    const float wr = __fmul_rn(by ? t1[1] : t0[1], bz ? t1[2] : t0[2]);
    w = __fmul_rn(wr, j ? t1[0] : t0[0]);
    return u[0] + (u[1] + by) * kP1 + (u[2] + bz) * kP2 + j;
  }
};

__global__ void shift_dw_partial_kernel(const float4* __restrict__ table,
                                        const float4* __restrict__ grad,
                                        const int* __restrict__ shifts,
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
    m[a] = a < corners ? (long long)shifts[l * corners + a] : 0;
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
      const float4 tv = tl[((j + m[a]) & (slots - 1)) * c4 + q];
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

__global__ void shift_dw_finish_kernel(const double* __restrict__ partial,
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

// table, baked: [levels, slots, channels] f32; shifts [levels, corners]
// i32 in [0, slots); weights [levels, corners] f32; channels % 4 == 0,
// slots a power of two.
int sd_hash_shift_bake(const float* table, const int* shifts,
                       const float* weights, float* baked, int levels,
                       long long slots, int channels, int corners,
                       void* stream) {
  const int threads = 256;
  long long total = (long long)levels * slots * (channels / 4);
  long long blocks = (total + threads - 1) / threads;
  shift_bake_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), shifts, weights,
      reinterpret_cast<float4*>(baked), levels, slots, channels / 4,
      corners);
  return (int)cudaGetLastError();
}

// xyz [n, 3] f32; baked [levels, slots, channels] f32 (slots a power of
// two, channels 4 or 8); scales [levels] f32; out [n, levels*channels].
int sd_hash_encode_paired(const float* xyz, const float* baked,
                          const float* scales, float* out, long long n_pts,
                          int levels, long long slots, int channels,
                          float bound, float two_bound, float offset,
                          int scene_oob, void* stream) {
  const int threads = 256;
  dim3 grid((unsigned)((n_pts + threads - 1) / threads), (unsigned)levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 8) {
    encode_paired_kernel<8><<<grid, threads, 0, s>>>(
        xyz, baked, scales, out, n_pts, levels, slots, bound, two_bound,
        offset, scene_oob);
  } else if (channels == 4) {
    encode_paired_kernel<4><<<grid, threads, 0, s>>>(
        xyz, baked, scales, out, n_pts, levels, slots, bound, two_bound,
        offset, scene_oob);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g [n, levels*channels] f32; xyz [n, 3] f32; scales [levels] f32;
// baked [levels, slots, channels] f32 or null (then dxyz is not written);
// grad [levels, slots, channels] f32, zero-filled; dxyz [n, 3] f32,
// zero-filled, or null. slots a power of two, channels 4 or 8. Levels
// whose scale is <= coarse_max_scale take the coarse path
// (`scatter_accum.cuh`; it needs levels * slots < 2^32 - 1), the others
// the direct one; a negative coarse_max_scale launches the direct path
// alone. stats: null, or [2] u64 to which the coarse path adds the rows
// it flushed and the inserts that overflowed its tables.
int sd_hash_encode_paired_bwd(const float* g, const float* xyz,
                              const float* scales, const float* baked,
                              float* grad, float* dxyz, long long n_pts,
                              int levels, long long slots, int channels,
                              float bound, float two_bound, float offset,
                              float coarse_max_scale,
                              unsigned long long* stats, void* stream) {
  return sa::launch_folded_bwd<PairedCorners>(
      g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, channels,
      bound, two_bound, offset, coarse_max_scale, stats,
      (cudaStream_t)stream);
}

// table, grad: [levels, slots, channels] f32, channels % 4 == 0;
// shifts [levels, corners] i32, corners <= 8; partial: scratch of
// levels*corners*blocks f64; dw [levels, corners] f32.
int sd_hash_shift_bake_dw(const float* table, const float* grad,
                          const int* shifts, double* partial, float* dw,
                          int levels, long long slots, int channels,
                          int corners, int blocks, void* stream) {
  if (corners < 1 || corners > kMaxCorners || channels % 4 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)blocks, (unsigned)levels);
  shift_dw_partial_kernel<<<grid, kDwThreads, 0, s>>>(
      reinterpret_cast<const float4*>(table),
      reinterpret_cast<const float4*>(grad), shifts, partial, slots,
      channels / 4, corners, blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = levels * corners;
  shift_dw_finish_kernel<<<(rows + 127) / 128, 128, 0, s>>>(partial, dw, rows,
                                                            blocks);
  return (int)cudaGetLastError();
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
