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
//  (b) sd_hash_encode: C / 4 lanes per point (a lane pair at C = 8),
//      each lane 4 channels of every level; a thread walks the levels in
//      order. Corner hashes idx = ((x*1) ^ (y*P1) ^ (z*P2)) & (size-1) in
//      u32, weights as products in ascending dimension order, the 8 rows
//      loaded before their sums, and out[n, l*C:(l+1)*C] = sum_k w_k *
//      B_l[idx_k] in ascending k. Out-of-bounds points (or an
//      out-of-bounds scene code) give zeros.
//
// What bounds it, measured level by level on an H100 at the serving
// chunk of 1,306,800 points (`scripts/torch_encode_levels.py`): not the
// gather. One-level launches take 0.030-0.041 ms in ray order, and as
// long with every point equal, so a level costs its instructions; their
// sum is 0.54 ms. One thread per (point, level) with the levels on
// blockIdx.y took 1.21 ms for the whole launch, 1.11 with every point
// equal: each pass over the points wrote 32 bytes of every point's
// 512-byte output row, so the rows reached device memory in 32-byte
// pieces. Walking the levels inside the thread writes a point's row
// within one block's lifetime; its sectors meet in L2 and leave as whole
// lines: 0.38 ms (the 669 MB output alone is 0.20 ms at the HBM rate).
// The lane pair moves a 32-byte row as one sector of one warp-wide load
// (one thread per point with two 16-byte loads per row took 0.77 ms).
// The touched rows of all 16 baked levels of a chunk (616,211, 20 MB)
// fit the 50 MB L2, so point-major order loses nothing to misses there;
// shuffled points take 0.85 ms.
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

// C / 4 lanes per point, lane q holding channels [4q, 4q + 4) of every
// level: at C = 8 a lane pair fetches each 32-byte corner row as one
// sector of one warp-wide load, where one thread per row issued two
// 16-byte loads of the same sector. A thread walks the levels in order,
// so x01 is computed once per point and the block writes each point's
// output row (levels * C floats) within a short span: the row's sectors
// meet in L2 and reach device memory as whole lines, where one block per
// (points, level) wrote 32 bytes of each 512-byte row a level apart. All
// 8 corner rows of a level are loaded before their sums; a row's offset
// from the level's base is 32-bit (slots * C <= 2^32, checked by the
// launcher).
template <int C>
__global__ void __launch_bounds__(256) encode_kernel(
    const float* __restrict__ xyz, const float* __restrict__ baked,
    const float* __restrict__ scales, float* __restrict__ out,
    long long n_pts, int levels, long long slots, float bound,
    float two_bound, float offset, int scene_oob) {
  constexpr int kLanes = C / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = t / kLanes;
  const int q = (int)(t % kLanes);
  if (n >= n_pts) return;
  float4* o = reinterpret_cast<float4*>(out + n * levels * C) + q;
  float x01[3];
  bool oob = scene_oob != 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(xyz[3 * n + d], bound), two_bound);
    oob |= x01[d] < 0.f || x01[d] > 1.f;
  }
  if (oob) {
    for (int l = 0; l < levels; ++l)
      o[l * kLanes] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  const unsigned mask = (unsigned)(slots - 1);
  const float4* tl = reinterpret_cast<const float4*>(baked) + q;
  for (int l = 0; l < levels; ++l, tl += slots * kLanes) {
    const float scale = scales[l];
    unsigned h0[3], h1[3];
    float t0[3], t1[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float pos = __fmaf_rn(x01[d], scale, offset);
      const float cell = floorf(pos);
      const float frac = __fsub_rn(pos, cell);
      const unsigned u = (unsigned)cell;
      h0[d] = u * primes[d];
      h1[d] = (u + 1u) * primes[d];
      t1[d] = frac;
      t0[d] = __fsub_rn(1.f, frac);
    }
    float4 v[8];
    float w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      unsigned h = (k & 1) ? h1[0] : h0[0];
      w[k] = (k & 1) ? t1[0] : t0[0];
#pragma unroll
      for (int d = 1; d < 3; ++d) {
        const bool bit = (k >> d) & 1;
        h ^= bit ? h1[d] : h0[d];
        w[k] = __fmul_rn(w[k], bit ? t1[d] : t0[d]);
      }
      v[k] = tl[(h & mask) * (unsigned)kLanes];
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc.x = __fadd_rn(acc.x, __fmul_rn(w[k], v[k].x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w[k], v[k].y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w[k], v[k].z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w[k], v[k].w));
    }
    o[l * kLanes] = acc;
  }
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
  if ((channels != 4 && channels != 8) || slots * channels > (1ll << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long lanes = n_pts * (channels / 4);
  const unsigned grid = (unsigned)((lanes + threads - 1) / threads);
  if (channels == 8)
    encode_kernel<8><<<grid, threads, 0, s>>>(
        xyz, baked, scales, out, n_pts, levels, slots, bound, two_bound,
        offset, scene_oob);
  else
    encode_kernel<4><<<grid, threads, 0, s>>>(
        xyz, baked, scales, out, n_pts, levels, slots, bound, two_bound,
        offset, scene_oob);
  return (int)cudaGetLastError();
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
