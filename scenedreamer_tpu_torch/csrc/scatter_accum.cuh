// Two-tier accumulation for the hash-grid table scatters (K3a in
// `hashgrid_bwd.cu`, K5c in `hashgrid_paired.cu`, K4b in
// `hashgrid_general.cu`), for Hopper, and the skeleton K3a and K5c share.
//
// A table scatter adds w_k * g_n into row idx_k of a table gradient for
// every (point n, corner k) of a level. One thread per (point, level)
// with a global float4 `atomicAdd` per corner (the direct path) is
// bound by the number of global atomics, not by bytes: on an H100 it
// sustains about 9-11 G float4 atomics/s, so each level of a training
// crop (1,647,456 points, 13.2M corner adds for K3a, 52.7M for K4b)
// costs 2.6-5.4 ms (K3a) or 4.8-10.7 ms (K4b) whatever its resolution.
// The coarse levels add contention on top (level 0 of K3a puts its adds
// on 284 rows and is the slowest), but even the finest level's rows take
// ~27 adds each, most of them from neighbouring samples of one ray.
//
// The coarse path takes the atomics off those rows before they reach
// global memory:
//  tier 0, the warp: lanes whose corner lands on the same row sum their
//    contributions with shuffles (`warp_reduce_peers`: `__match_any_sync`
//    groups, ceil(log2(group size)) rounds); in ray order a warp's 32
//    points are neighbouring samples of one or two rays, so on a coarse
//    level most of its corners fall into one group;
//  tier 1, the block: one block walks `kBlockPoints` consecutive points
//    and each group's leader adds into a block-private open-addressed
//    table in dynamic shared memory (`Table`: `kCap` entries of (row,
//    C floats), keyed by the row of the whole gradient array; a key is
//    claimed with `atomicCAS`, values are added with shared-memory float
//    atomics). An insert that finds no free or matching entry in its
//    `kProbe`-entry window goes straight to the global atomic: the same
//    sum, added earlier;
//  tier 2, the flush: at the end the block adds each occupied entry to
//    global memory once, one vector atomic per 4 channels.
// A level's global atomics so drop from (points x corners) to about
// (blocks x rows each block touched) + overflowed inserts: in ray order
// 17k (level 0) to 372k (level 15) flushed rows for K3a, and 0 to 3.0M
// overflowed inserts. Measured per level on an H100, K3a's coarse path
// takes 0.21-0.35 ms where the direct one takes 2.6-5.4 ms, and K4b's
// 1.5-1.8 ms where the direct one takes 4.8-10.7 ms (there the per-
// corner work of 32 corners, not the atomics, is left). The callers
// choose the path per level from its resolution (a level is coarse when
// its scale is at most a threshold fixed from that per-level timing in
// `chip_smoke.py` phases 6 and 10); every level measured so far is
// faster on the coarse path.
//
// The shape: 256 threads, runs of 2,048 points, 512 entries (18 KB at
// C = 8). It won a sweep over 128-512 threads, 512-2,048 entries and
// runs of 1,024-8,192 points on an H100: the table's size sets how many
// blocks share an SM, and that, not the rate of overflow, sets the time
// (2,048 entries and 4,096 points: K3a 3.97, K4b 20.4 ms).
//
// The summation order differs from the direct path (warp sums, then
// shared sums, then the global adds in any order), so results agree to
// float32 rounding of the sum of absolute contributions, as the direct
// path's own run-to-run order does. Where one row takes hundreds of
// thousands of small adds (samples that coincide), the coarse path is
// the more exact one: it sums them on chip and adds the sum to the
// row's large running total once, where the direct path rounds each of
// them against that total.
#pragma once
#include <cuda_runtime.h>

namespace scatter_accum {

constexpr int kThreads = 256;        // threads of a coarse block
constexpr int kBlockPoints = 2048;   // consecutive points one block walks
constexpr int kLog2Cap = 9;
constexpr int kCap = 1 << kLog2Cap;  // table entries per block
constexpr int kProbe = 8;            // linear-probe window of an insert
constexpr unsigned kEmpty = 0xffffffffu;   // no row; also "no key" lanes
constexpr unsigned kFullWarp = 0xffffffffu;

// Dynamic shared memory of a coarse block for C channels: keys, values
// and two counters (rows flushed, inserts that overflowed).
__host__ __device__ constexpr size_t smem_bytes(int channels) {
  return (size_t)kCap * 4 * (1 + channels) + 16;
}
// the widest rows (C = 16) fit a launch's default 48 KB of dynamic
// shared memory, so no kernel needs the opt-in to more
static_assert(smem_bytes(16) <= 48 * 1024, "a coarse block's table");

// p[0:C] += v with sm_90's vector atomics where the row allows (rows
// of C floats: 16-byte aligned when C % 4 == 0, 8-byte when C == 2).
template <int C>
__device__ __forceinline__ void add_row(float* __restrict__ p,
                                        const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(p) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                            v[4 * q + 3]));
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(p + c, v[c]);
  }
}

// Sums v over the lanes of the warp holding the same key; all 32 lanes
// call it together. Returns true on the lowest lane of each key, which
// then holds its group's sum (Westphal's peer reduction: in round j each
// remaining lane of even rank adds the partial sum of the next remaining
// peer above it, and lanes of odd rank drop out).
template <int C>
__device__ __forceinline__ bool warp_reduce_peers(unsigned key,
                                                  float (&v)[C]) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned peers = __match_any_sync(kFullWarp, key);
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned above = peers & (0xfffffffeu << lane);
  unsigned rank = __popc(below);
  while (__any_sync(kFullWarp, above != 0u)) {
    const int next = (__ffs(above) - 1) & 31;
    float t[C];
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = __shfl_sync(kFullWarp, v[c], next);
    if (!(rank & 1u) && above) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = __fadd_rn(v[c], t[c]);
    }
    above &= ~__ballot_sync(kFullWarp, rank & 1u);
    rank >>= 1;
  }
  return below == 0u;
}

// A block's open-addressed table of (row, C floats) in dynamic shared
// memory `smem` (16-byte aligned, `smem_bytes(C)` long).
template <int C>
struct Table {
  unsigned* keys;     // [kCap], kEmpty where free
  float* vals;        // [kCap * C]
  unsigned* counts;   // [2]: rows flushed, inserts that overflowed

  __device__ explicit Table(unsigned char* smem)
      : keys(reinterpret_cast<unsigned*>(smem)),
        vals(reinterpret_cast<float*>(smem + (size_t)kCap * 4)),
        counts(reinterpret_cast<unsigned*>(smem + (size_t)kCap * 4 * (1 + C))) {}

  __device__ void clear() {
    for (int i = threadIdx.x; i < kCap; i += blockDim.x) keys[i] = kEmpty;
    float4* v4 = reinterpret_cast<float4*>(vals);
    for (int i = threadIdx.x; i < kCap * C / 4; i += blockDim.x)
      v4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (threadIdx.x < 2) counts[threadIdx.x] = 0u;
    __syncthreads();
  }

  // grad[key] += v, through the table when the key finds an entry in
  // its probe window, else with the global atomic.
  __device__ void insert(unsigned key, const float (&v)[C],
                         float* __restrict__ grad) {
    unsigned i = (key * 2654435761u) >> (32 - kLog2Cap);
    volatile unsigned* vkeys = keys;
    for (int p = 0; p < kProbe; ++p, i = (i + 1u) & (kCap - 1)) {
      unsigned k = vkeys[i];
      if (k == kEmpty) {
        k = atomicCAS(keys + i, kEmpty, key);
        if (k == kEmpty) k = key;
      }
      if (k == key) {
        float* e = vals + (size_t)i * C;
#pragma unroll
        for (int c = 0; c < C; ++c) atomicAdd(e + c, v[c]);
        return;
      }
    }
    atomicAdd(counts + 1, 1u);
    add_row<C>(grad + (size_t)key * C, v);
  }

  // After every insert of the block: each occupied entry to global
  // memory once; with `stats` [2] (rows flushed, inserts that
  // overflowed) the block's counts are added there.
  __device__ void flush(float* __restrict__ grad,
                        unsigned long long* __restrict__ stats) {
    __syncthreads();
    unsigned flushed = 0u;
    for (int i = threadIdx.x; i < kCap; i += blockDim.x) {
      const unsigned key = keys[i];
      if (key == kEmpty) continue;
      float v[C];
      const float* e = vals + (size_t)i * C;
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = e[c];
      add_row<C>(grad + (size_t)key * C, v);
      ++flushed;
    }
    if (!stats) return;
    atomicAdd(counts, flushed);
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(stats, (unsigned long long)counts[0]);
      atomicAdd(stats + 1, (unsigned long long)counts[1]);
    }
  }
};

// The scatter of the scene-folded encodes (K3a in `hashgrid_bwd.cu`,
// K5c in `hashgrid_paired.cu`): 3-D points, a gradient table of [levels,
// slots, C] rows (slots a power of two), 8 rows per (point, level). The
// two differ only in the hash that names a corner's row and in the order
// a corner's weight is multiplied out, which a `Corners` policy gives:
//
//   struct Corners {
//     float t0[3], t1[3];   // taps 1 - frac and frac per dimension
//     // the cell of point n at this level; false when out of bounds
//     __device__ bool setup(const float* xyz, long long n, float scale,
//                           float bound, float two_bound, float offset);
//     // corner k (bits x + 2 y + 4 z): its row before the mask, and w
//     __device__ unsigned row(int k, float& w) const;
//   };
//
// With g the cotangent [N, levels * C], G[l, row_k & (S-1)] += w_k * g
// for every in-bounds point and corner k in ascending k, and with the
// baked table B the gradient through frac goes to dxyz (`add_dxyz`). Two
// paths, chosen per level by coarse_max_scale: the coarse one through the
// block tables above, and the direct one, one global vector atomic per
// corner.

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
// t_{k,d'}, gv_k = sum_c g_c B[row_k, c]: d/dfrac_d of w_k is sign_{k,d}
// times the other two taps.
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

// The direct path: one thread per (point, level), one global vector
// atomic per corner. Levels with scale <= coarse_max_scale belong to
// `folded_bwd_coarse_kernel`.
template <class Corners, int C>
__global__ void folded_bwd_direct_kernel(
    const float* __restrict__ g, const float* __restrict__ xyz,
    const float* __restrict__ scales, const float* __restrict__ baked,
    float* __restrict__ grad, float* __restrict__ dxyz, long long n_pts,
    int levels, long long slots, float bound, float two_bound, float offset,
    float coarse_max_scale) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const int l = blockIdx.y;
  const float scale = scales[l];
  if (scale <= coarse_max_scale) return;
  Corners cs;
  if (!cs.setup(xyz, n, scale, bound, two_bound, offset)) return;
  float gc[C];
  load_g<C>(g, n, levels, l, gc);
  const unsigned mask = (unsigned)(slots - 1);
  float* gl = grad + (long long)l * slots * C;
  const float* bl = baked ? baked + (long long)l * slots * C : nullptr;
  float gv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float w;
    const long long row = (long long)(cs.row(k, w) & mask) * C;
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gc[c]);
    add_row<C>(gl + row, v);
    if (bl) gv[k] = dot_row<C>(gc, bl + row);
  }
  if (dxyz) add_dxyz(dxyz, n, gv, cs.t0, cs.t1, scale, two_bound);
}

// The coarse path: block (b, l) walks points [b * kBlockPoints, (b + 1) *
// kBlockPoints) of level l when scales[l] <= coarse_max_scale (other
// levels' blocks return at once); each corner's w * g is summed over the
// warp's lanes on the same row, added into the block's table under the
// key l * S + row and flushed once per key at the end. The gradient
// through frac is the direct path's, per point.
template <class Corners, int C>
__global__ void __launch_bounds__(kThreads) folded_bwd_coarse_kernel(
    const float* __restrict__ g, const float* __restrict__ xyz,
    const float* __restrict__ scales, const float* __restrict__ baked,
    float* __restrict__ grad, float* __restrict__ dxyz, long long n_pts,
    int levels, long long slots, float bound, float two_bound, float offset,
    float coarse_max_scale, unsigned long long* __restrict__ stats) {
  const int l = blockIdx.y;
  const float scale = scales[l];
  if (!(scale <= coarse_max_scale)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  Table<C> table(smem);
  table.clear();
  const long long first = (long long)blockIdx.x * kBlockPoints;
  const long long last =
      first + kBlockPoints < n_pts ? first + kBlockPoints : n_pts;
  const unsigned mask = (unsigned)(slots - 1);
  const unsigned level_row = (unsigned)(l * slots);
  // every lane runs the same iterations: the warp reduction needs them all
  for (long long base = first; base < last; base += blockDim.x) {
    const long long n = base + threadIdx.x;
    Corners cs;
    const bool ok =
        n < last && cs.setup(xyz, n, scale, bound, two_bound, offset);
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
      unsigned key = kEmpty;
      float v[C];
      float w = 0.f;
      if (ok) key = level_row + (cs.row(k, w) & mask);
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gc[c]);
      if (warp_reduce_peers<C>(key, v) && key != kEmpty)
        table.insert(key, v, grad);
      if (baked && ok) gv[k] = dot_row<C>(gc, baked + (long long)key * C);
    }
    if (dxyz && ok) add_dxyz(dxyz, n, gv, cs.t0, cs.t1, scale, two_bound);
  }
  table.flush(grad, stats);
}

// Both paths of one folded scatter (C 4 or 8): the coarse kernel, unless
// coarse_max_scale is negative (every level direct), then the direct one.
template <class Corners, int C>
int launch_folded_bwd(const float* g, const float* xyz, const float* scales,
                      const float* baked, float* grad, float* dxyz,
                      long long n_pts, int levels, long long slots,
                      float bound, float two_bound, float offset,
                      float coarse_max_scale, unsigned long long* stats,
                      cudaStream_t s) {
  if (coarse_max_scale >= 0.f) {
    if ((long long)levels * slots >= (long long)kEmpty)
      return (int)cudaErrorInvalidValue;    // the tables' keys are u32
    dim3 grid((unsigned)((n_pts + kBlockPoints - 1) / kBlockPoints),
              (unsigned)levels);
    folded_bwd_coarse_kernel<Corners, C><<<grid, kThreads, smem_bytes(C), s>>>(
        g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, bound,
        two_bound, offset, coarse_max_scale, stats);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  dim3 grid((unsigned)((n_pts + threads - 1) / threads), (unsigned)levels);
  folded_bwd_direct_kernel<Corners, C><<<grid, threads, 0, s>>>(
      g, xyz, scales, baked, grad, dxyz, n_pts, levels, slots, bound,
      two_bound, offset, coarse_max_scale);
  return (int)cudaGetLastError();
}

// The C ABI entry point's dispatch on the channel count.
template <class Corners>
int launch_folded_bwd(const float* g, const float* xyz, const float* scales,
                      const float* baked, float* grad, float* dxyz,
                      long long n_pts, int levels, long long slots,
                      int channels, float bound, float two_bound,
                      float offset, float coarse_max_scale,
                      unsigned long long* stats, cudaStream_t s) {
  if (channels == 8)
    return launch_folded_bwd<Corners, 8>(g, xyz, scales, baked, grad, dxyz,
                                         n_pts, levels, slots, bound,
                                         two_bound, offset, coarse_max_scale,
                                         stats, s);
  if (channels == 4)
    return launch_folded_bwd<Corners, 4>(g, xyz, scales, baked, grad, dxyz,
                                         n_pts, levels, slots, bound,
                                         two_bound, offset, coarse_max_scale,
                                         stats, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace scatter_accum
