// Scene-folded hash-grid encode under the 'paired' hash variant (K5),
// forward and backward, for Hopper: four simple kernels.
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
//  (c) sd_hash_encode_paired_bwd: one thread per (point, level);
//      recomputes bases and weights as (b) does and atomically adds
//      w_kj * g into G_l[(base_k+j) & (S-1)] with sm_90's float4
//      `atomicAdd` (C/4 per row). With B it also adds the gradient
//      through frac to dxyz, the 8 corners taken as (x_bit, y_bit, z_bit).
//  (d) sd_hash_shift_bake_dw: dw_{l,a} = sum_{j,c} T_l[(j+m_a)&(S-1), c]
//      * G_l[j, c]; float64 partial sums per block, reduced in shared
//      memory, then summed per (l, a) in block order by a second kernel:
//      a fixed order, so dw is deterministic.
//
// What bounds them: (a) and (d) stream one table and read another
// through 4 shifted windows of the same level (16 MB at 2^19 x 8 floats,
// L2 resident), so device-memory bytes; (b) is a gather of 4 random
// 64-byte pairs per point and level plus N*L*C*4 output bytes, so
// transaction rate; (c) is a scatter whose coarse levels put thousands of
// atomics on each row, so contention.
//
// Numerics as in hashgrid_fwd.cu: the cell position is one __fmaf_rn,
// every other product and sum an explicit round-to-nearest intrinsic in
// the order above, and the file builds with -fmad=false.
//
// C ABI (ctypes): each entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
                                            float offset, unsigned u[3],
                                            float t0[3], float t1[3]) {
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

template <int C>
__global__ void encode_paired_bwd_kernel(const float* __restrict__ g,
                                         const float* __restrict__ xyz,
                                         const float* __restrict__ scales,
                                         const float* __restrict__ baked,
                                         float* __restrict__ grad,
                                         float* __restrict__ dxyz,
                                         long long n_pts, int levels,
                                         long long slots, float bound,
                                         float two_bound, float offset) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const int l = blockIdx.y;
  const float scale = scales[l];
  unsigned u[3];
  float t0[3], t1[3];
  if (!paired_cell(xyz, n, scale, bound, two_bound, offset, u, t0, t1))
    return;
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
  float gv[8];      // indexed by the corner bits x + 2 y + 4 z
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int by = k & 1, bz = k >> 1;
    const unsigned base = (u[0] + (u[1] + by) * kP1 + (u[2] + bz) * kP2)
                          & mask;
    const float wr = __fmul_rn(by ? t1[1] : t0[1], bz ? t1[2] : t0[2]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float w = __fmul_rn(wr, j ? t1[0] : t0[0]);
      const long long row = (long long)((base + j) & mask) * C;
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
        for (int c = 0; c < C; ++c)
          s = __fadd_rn(s, __fmul_rn(gc[c], bl[row + c]));
        gv[2 * k + j] = s;
      }
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
// zero-filled, or null. slots a power of two, channels 4 or 8.
int sd_hash_encode_paired_bwd(const float* g, const float* xyz,
                              const float* scales, const float* baked,
                              float* grad, float* dxyz, long long n_pts,
                              int levels, long long slots, int channels,
                              float bound, float two_bound, float offset,
                              void* stream) {
  const int threads = 256;
  dim3 grid((unsigned)((n_pts + threads - 1) / threads), (unsigned)levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 8) {
    encode_paired_bwd_kernel<8><<<grid, threads, 0, s>>>(
        g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, bound,
        two_bound, offset);
  } else if (channels == 4) {
    encode_paired_bwd_kernel<4><<<grid, threads, 0, s>>>(
        g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, bound,
        two_bound, offset);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
