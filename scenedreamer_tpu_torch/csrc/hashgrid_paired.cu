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
//  (b) sd_hash_encode_paired: C / 4 lanes per point (a lane pair at C =
//      8), each lane 4 channels of every level; a thread walks the levels
//      in order. For each of the 4 (y, z) corners k = y_bit + 2 z_bit, in
//      ascending k, base_k = (x + y'*P1 + z'*P2) & (S-1) in uint32 and the
//      rows base_k, then (base_k+1) & (S-1), are added with weights
//      ((t_y t_z) * (1-f_x)) and ((t_y t_z) * f_x): out = sum_k sum_j
//      w_kj * B_l[(base_k+j) mod S], the order the plain PyTorch version
//      sums in, so the two are equal. Out-of-bounds points, or an
//      out-of-bounds scene code, give zeros.
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
//      * G_l[j, c]: `bake_dw.cuh`'s persistent grid, shared with K3c,
//      which walks the levels in order, each block a contiguous span of G
//      and the same span of T through each corner's window, float64 sums
//      per warp, then summed in a fixed order by a second kernel, so dw
//      is deterministic; this file gives the shift window (`ShiftWindow`).
//
// What bounds them, on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6;
// the per-level split of `scripts/torch_encode_levels.py --only K5`). (a) and (d) stream one table and read another through 4 shifted
// windows of the same level (16 MB at 2^19 x 8 floats); their bound is T
// and G (or B) once from device memory, 0.160 ms. (d) took 0.42 ms as a
// grid of 256 blocks per level: several levels were in flight, so a
// window's rows were evicted from L2 before the next window read them
// (0.29 ms with every shift 0), and its float64 sums sat in local
// memory. With the levels walked in order and the sums in registers it
// takes 0.27 ms, 0.21 with one window: what is left are the three
// further windows' reads of T through L2 (a G load kept a step ahead,
// an evict-last policy on T and 6 blocks per SM did not move it).
// (b) reads 4 random 64-byte pairs per point and level, from 1,874,173
// distinct rows (60 MB) at the 1,647,456 points of a 262x262x24 training
// crop, and writes N*L*C*4 bytes (843 MB, 0.25 ms at the device
// memory's rate); its bound, 0.276 ms, counts each distinct row once.
// One thread per (point, level), the levels on blockIdx.y, took 1.54 ms
// though its levels alone summed to 0.65 and a launch with every point
// equal took 1.41: each pass over the points wrote 32 bytes of every
// point's 512-byte output row, as K2b did before its redesign. Walking
// the levels per thread writes a row within one block's lifetime: 0.51
// ms (0.37 at a 1,306,800-point serving chunk), within 4% of the time
// with every point equal, so instructions and the output write bound it,
// not misses on the 60 MB of rows. (c) moves g's rows, xyz and G once
// (0.338 ms for the training crop at 16 x 2^19 x 8), but its direct path
// issues 2 float4 atomics per row, 26.4M per level, and is bound by that
// count as K3a's direct path is: 2.96-5.26 ms on every level, 47.5 ms in
// all. The coarse path sums on chip first, so its global atomics drop to
// the rows each block touched plus the inserts that overflow its table:
// in ray order 17k (level 0) to 373k (level 15) flushed rows and 0 to
// 3.0M overflowed inserts, 0.20-0.35 ms per level and 3.16 ms in all on
// the same card; shuffled 9.0 ms against 38.6.
//
// Numerics as in hashgrid_fwd.cu: the cell position is one __fmaf_rn,
// every other float32 product and sum an explicit round-to-nearest
// intrinsic in the order above, and the file builds with -fmad=false.
// (d)'s float64 fused multiply-adds round as a product and a sum would:
// the product of two floats is exact in float64.
//
// C ABI (ctypes): each entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "bake_dw.cuh"
#include "scatter_accum.cuh"

namespace {

namespace sa = scatter_accum;

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

// The cell of a point at one level from its unit coordinates x01: the
// uint32 cell coordinates u and the taps t0 = 1 - frac, t1 = frac.
__device__ __forceinline__ void cell_taps(const float (&x01)[3], float scale,
                                          float offset, unsigned (&u)[3],
                                          float (&t0)[3], float (&t1)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fmaf_rn(x01[d], scale, offset);
    const float cell = floorf(pos);
    const float frac = __fsub_rn(pos, cell);
    u[d] = (unsigned)cell;
    t1[d] = frac;
    t0[d] = __fsub_rn(1.f, frac);
  }
}

// Point n's unit coordinates x01 = (xyz + bound) / (2 bound); false out
// of bounds.
__device__ __forceinline__ bool unit_coords(const float* __restrict__ xyz,
                                            long long n, float bound,
                                            float two_bound,
                                            float (&x01)[3]) {
  bool oob = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(xyz[3 * n + d], bound), two_bound);
    oob |= x01[d] < 0.f || x01[d] > 1.f;
  }
  return !oob;
}

// C / 4 lanes per point, lane q holding channels [4q, 4q + 4) of every
// level (a lane pair at C = 8, as K2b's `encode_kernel`): a thread walks
// the levels in order, so x01 is computed once per point and the block
// writes each point's output row (levels * C floats) within a short
// span, where one block per (points, level) wrote 32 bytes of each
// 512-byte row a level apart. A level's 4 pairs, 8 rows, are loaded
// before their sums, which run in the plain version's order: k = y_bit
// + 2 z_bit ascending, then the row j of the pair. A row's offset from
// the level's base is 32-bit (slots * C <= 2^32, checked by the
// launcher).
template <int C>
__global__ void __launch_bounds__(256) encode_paired_kernel(
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
  if (!unit_coords(xyz, n, bound, two_bound, x01) || scene_oob != 0) {
    for (int l = 0; l < levels; ++l)
      o[l * kLanes] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const unsigned mask = (unsigned)(slots - 1);
  const float4* tl = reinterpret_cast<const float4*>(baked) + q;
  for (int l = 0; l < levels; ++l, tl += slots * kLanes) {
    unsigned u[3];
    float t0[3], t1[3];
    cell_taps(x01, scales[l], offset, u, t0, t1);
    float4 v[8];
    float w[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int by = k & 1, bz = k >> 1;
      const unsigned base = u[0] + (u[1] + by) * kP1 + (u[2] + bz) * kP2;
      const float wr = __fmul_rn(by ? t1[1] : t0[1], bz ? t1[2] : t0[2]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        w[2 * k + j] = __fmul_rn(wr, j ? t1[0] : t0[0]);
        v[2 * k + j] = tl[((base + j) & mask) * (unsigned)kLanes];
      }
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc.x = __fadd_rn(acc.x, __fmul_rn(w[i], v[i].x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w[i], v[i].y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w[i], v[i].z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w[i], v[i].w));
    }
    o[l * kLanes] = acc;
  }
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
    float x01[3];
    if (!unit_coords(xyz, n, bound, two_bound, x01)) return false;
    cell_taps(x01, scale, offset, u, t0, t1);
    return true;
  }

  __device__ __forceinline__ unsigned row(int k, float& w) const {
    const unsigned j = k & 1, by = (k >> 1) & 1, bz = k >> 2;
    const float wr = __fmul_rn(by ? t1[1] : t0[1], bz ? t1[2] : t0[2]);
    w = __fmul_rn(wr, j ? t1[0] : t0[0]);
    return u[0] + (u[1] + by) * kP1 + (u[2] + bz) * kP2 + j;
  }
};

// K5d's window (`bake_dw::launch_dw`'s policy): float4 i of a level's G
// meets float4 (i + off) mod P of its T, P = S * C/4 the level's float4s
// and off = (m_a & (S-1)) * C/4 < P, so one conditional subtract reduces
// it.
struct ShiftWindow {
  __device__ __forceinline__ static unsigned src(unsigned i, unsigned off,
                                                 unsigned per_level) {
    unsigned src = i + off;
    if (src >= per_level) src -= per_level;
    return src;
  }
};

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
// two, channels 4 or 8, slots * channels <= 2^32); scales [levels] f32;
// out [n, levels*channels].
int sd_hash_encode_paired(const float* xyz, const float* baked,
                          const float* scales, float* out, long long n_pts,
                          int levels, long long slots, int channels,
                          float bound, float two_bound, float offset,
                          int scene_oob, void* stream) {
  const int threads = 256;
  if ((channels != 4 && channels != 8) || slots * channels > (1ll << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long lanes = n_pts * (channels / 4);
  const unsigned grid = (unsigned)((lanes + threads - 1) / threads);
  if (channels == 8)
    encode_paired_kernel<8><<<grid, threads, 0, s>>>(
        xyz, baked, scales, out, n_pts, levels, slots, bound, two_bound,
        offset, scene_oob);
  else
    encode_paired_kernel<4><<<grid, threads, 0, s>>>(
        xyz, baked, scales, out, n_pts, levels, slots, bound, two_bound,
        offset, scene_oob);
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

// table, grad: [levels, slots, channels] f32, channels 4 or 8, slots a
// power of two, slots * channels <= 2^32; shifts [levels, corners] i32,
// corners <= 8; blocks: the grid, all resident at once; partial: scratch
// of levels*corners*blocks*8 f64 (one per warp); dw [levels, corners]
// f32.
int sd_hash_shift_bake_dw(const float* table, const float* grad,
                          const int* shifts, double* partial, float* dw,
                          int levels, long long slots, int channels,
                          int corners, int blocks, void* stream) {
  return bake_dw::launch_dw<ShiftWindow>(table, grad, shifts, partial, dw,
                                         levels, slots, channels, corners,
                                         blocks, (cudaStream_t)stream);
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
