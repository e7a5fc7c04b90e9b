// Scene-folded hash-grid encode, backward (K3), for Hopper: the table
// scatter on two paths and the dw reduction, each on a skeleton shared
// with K5, plus the forward's bake kernel reused.
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
//      scene code trains): `bake_dw.cuh`'s persistent grid, which walks
//      the levels in order with float64 sums per warp and a fixed-order
//      finish, so dw is deterministic; this file gives the xor window
//      (`XorWindow`: float4 i reads T's float4 i ^ (m_a C/4)), K5d the
//      shift one.
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
// stay within one level's 16 MB (L2 resident while the grid walks that
// level), so device-memory bytes bound it: 0.160 ms for T and G once.
// On `bake_dw.cuh` it takes 0.26 ms, 0.20 with one corner, on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md); a grid of 256 blocks per level,
// with several levels in flight, its sums in local memory and a 64-bit
// division per float4, took 0.35.
//
// C ABI (ctypes): each entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "bake_dw.cuh"
#include "scatter_accum.cuh"

namespace {

namespace sa = scatter_accum;

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

// K3c's window (`bake_dw::launch_dw`'s policy): float4 i of a level's G
// meets float4 i ^ off of its T, off = (m_a & (S-1)) * C/4.
struct XorWindow {
  __device__ __forceinline__ static unsigned src(unsigned i, unsigned off,
                                                 unsigned) {
    return i ^ off;
  }
};

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

// table, grad: [levels, slots, channels] f32, channels 4 or 8, slots a
// power of two, slots * channels <= 2^32; masks [levels, corners] i32,
// corners <= 8; blocks: the grid, all resident at once; partial: scratch
// of levels*corners*blocks*8 f64 (one per warp); dw [levels, corners]
// f32.
int sd_hash_bake_dw(const float* table, const float* grad, const int* masks,
                    double* partial, float* dw, int levels, long long slots,
                    int channels, int corners, int blocks, void* stream) {
  return bake_dw::launch_dw<XorWindow>(table, grad, masks, partial, dw,
                                       levels, slots, channels, corners,
                                       blocks, (cudaStream_t)stream);
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
