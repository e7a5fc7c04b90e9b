// Scene-folded hash-grid encode, forward, for Hopper: two simple kernels.
//
// Replaces the forward of the JAX package's
// `scenedreamer_tpu/ops/hashgrid.py:hashgrid_encode_folded`: the scene
// fold `bake` (`_xor_bake` via `_xor_take`, a butterfly einsum on the
// TPU's matrix unit), the corner hashing `_corner_idx_w` and the corner
// gather `gather_interp` / `_splat_gather` (the reference CUDA kernel is
// `gridencoder.cu`). Every point of a world shares the same 2-D scene
// code, so per level l the four scene-corner contributions fold into one
// table: B_l[j] = sum_a w_a * T_l[j ^ m_a]. Each point then needs 8
// spatial corner rows of B_l instead of 32 rows of T_l.
//
//  (a) sd_hash_bake: one thread per (level, slot, 4 channels);
//      B_l[j] = 0 + w_0*T_l[j^m_0] + w_1*T_l[j^m_1] + ... in that order.
//      Masks and weights come from the scene code, computed by the
//      caller once per frame.
//  (b) sd_hash_encode: one thread per (point, level). Corner hashes
//      idx = ((x*1) ^ (y*P1) ^ (z*P2)) & (size-1) in u32, weights as
//      products in ascending dimension order, 8 row loads of C floats
//      (float4s), and out[n, l*C:(l+1)*C] = sum_k w_k * B_l[idx_k] in
//      ascending k. Out-of-bounds points (or an out-of-bounds scene code)
//      give zeros. Levels run on blockIdx.y, so the blocks in flight
//      read one level's baked table (16 MB at 2^19 x 8 floats), which
//      stays in the 50 MB L2.
//
// What bounds it: the encode is a gather, random 32-byte rows (8 per
// point and level) plus N*L*C*4 output bytes, so device-memory and L2
// transaction rate, not arithmetic; the bake streams its table once.
// The design keeps each level's working set L2-resident and moves a
// corner row as two 16-byte loads.
//
// Numerics: the cell position x01 * scale + offset is one fused
// multiply-add (__fmaf_rn), rounded once as the JAX op's compiled encode
// and the plain PyTorch version round it: with two roundings the
// fractional position moves by up to a float32 step of the position,
// ~1e-4 at the finest levels. Every other product and sum is an explicit
// round-to-nearest intrinsic, in the order above, and the file builds
// with -fmad=false so nvcc contracts nothing else.
//
// C ABI (ctypes): each entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bake_kernel(const float4* __restrict__ table,
                            const int* __restrict__ masks,
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
    long long src = j ^ (long long)masks[l * corners + a];
    float w = weights[l * corners + a];
    float4 v = tl[src * c4 + q];
    acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
  }
  baked[i] = acc;
}

template <int C>
__global__ void encode_kernel(const float* __restrict__ xyz,
                              const float* __restrict__ baked,
                              const float* __restrict__ scales,
                              float* __restrict__ out, long long n_pts,
                              int levels, long long slots, float bound,
                              float two_bound, float offset, int scene_oob) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const int l = blockIdx.y;
  float4* o = reinterpret_cast<float4*>(out + n * (long long)levels * C
                                        + (long long)l * C);
  float x01[3];
  bool oob = scene_oob != 0;
  for (int d = 0; d < 3; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(xyz[3 * n + d], bound), two_bound);
    oob |= x01[d] < 0.f || x01[d] > 1.f;
  }
  if (oob) {
    for (int q = 0; q < C / 4; ++q) o[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
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
  const unsigned mask = (unsigned)(slots - 1);
  const float4* tl = reinterpret_cast<const float4*>(
      baked + (long long)l * slots * C);
  float acc[C];
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    unsigned h = (k & 1) ? h1[0] : h0[0];
    float w = (k & 1) ? t1[0] : t0[0];
    for (int d = 1; d < 3; ++d) {
      bool bit = (k >> d) & 1;
      h ^= bit ? h1[d] : h0[d];
      w = __fmul_rn(w, bit ? t1[d] : t0[d]);
    }
    const float4* row = tl + (long long)(h & mask) * (C / 4);
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      float4 v = row[q];
      acc[4 * q] = __fadd_rn(acc[4 * q], __fmul_rn(w, v.x));
      acc[4 * q + 1] = __fadd_rn(acc[4 * q + 1], __fmul_rn(w, v.y));
      acc[4 * q + 2] = __fadd_rn(acc[4 * q + 2], __fmul_rn(w, v.z));
      acc[4 * q + 3] = __fadd_rn(acc[4 * q + 3], __fmul_rn(w, v.w));
    }
  }
  for (int q = 0; q < C / 4; ++q)
    o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]);
}

}  // namespace

extern "C" {

// table, baked: [levels, slots, channels] f32; masks [levels, corners]
// i32; weights [levels, corners] f32; channels % 4 == 0.
int sd_hash_bake(const float* table, const int* masks, const float* weights,
                 float* baked, int levels, long long slots, int channels,
                 int corners, void* stream) {
  const int threads = 256;
  long long total = (long long)levels * slots * (channels / 4);
  long long blocks = (total + threads - 1) / threads;
  bake_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), masks, weights,
      reinterpret_cast<float4*>(baked), levels, slots, channels / 4,
      corners);
  return (int)cudaGetLastError();
}

// xyz [n, 3] f32; baked [levels, slots, channels] f32 (slots a power of
// two, channels 4 or 8); scales [levels] f32; out [n, levels*channels].
int sd_hash_encode(const float* xyz, const float* baked, const float* scales,
                   float* out, long long n_pts, int levels, long long slots,
                   int channels, float bound, float two_bound, float offset,
                   int scene_oob, void* stream) {
  const int threads = 256;
  dim3 grid((unsigned)((n_pts + threads - 1) / threads), (unsigned)levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 8) {
    encode_kernel<8><<<grid, threads, 0, s>>>(xyz, baked, scales, out,
                                              n_pts, levels, slots, bound,
                                              two_bound, offset, scene_oob);
  } else if (channels == 4) {
    encode_kernel<4><<<grid, threads, 0, s>>>(xyz, baked, scales, out,
                                              n_pts, levels, slots, bound,
                                              two_bound, offset, scene_oob);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
