// Ray-voxel DDA for Hopper (K1): one thread per ray, early exit, an exact
// empty-space skip over 8^3 bricks, several camera origins in one launch,
// and rays optionally taken in 8x4 pixel tiles.
//
// Replaces the JAX package's lockstep traversal
// `scenedreamer_tpu/ops/ray_voxel.py:_dda_run` (with `_dda_init`,
// `_aabb_enter_t`, `_crossing_t_init`, and its empty-space skip over
// `build_occupancy`'s bricks), which itself stands in for the reference
// CUDA kernel `voxlib/ray_voxel_intersection.cu`. Each thread
// fast-forwards its ray to the grid's AABB, then takes Amanatides-Woo
// axis steps through the [Y, X, Z] grid (0 = empty) and records the first
// M solid voxels: id, entry t (the smallest crossing t before the step)
// and exit t (the smallest crossing t after it). A ray stops when the
// stepped axis leaves the grid or when it has M hits. The TPU kernel's
// lockstep loop and wavefront drivers worked around lockstep SIMD; a GPU
// thread simply returns when its ray is done.
//
// What bounds it: latency, not operations. A ray is a serial chain of
// axis steps (pick the axis of the smallest crossing t, step it, compute
// its next crossing t, and inside a solid region wait on a 1-byte load
// at a data-dependent address), and rays differ in length by 100x. On an
// NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py` phase 5, `[K1
// shapes]`) the 564,300 rays of a 570x990 frame at scene 1024 take about
// 1.0 ms against an operation bound of 0.028 ms (237M axis steps x 8
// float32 operations), and one warp of the frame's 32 longest rays
// (~1,590 steps) alone takes 0.33 ms, ~400 cycles a step: the warps that
// walk longest, left alone on their SMs at the end of the launch, set the
// time. The design answers:
//  - registers: the walk keeps each axis in its own registers and picks
//    the stepped axis with selects. Arrays indexed by the stepped axis
//    live in local memory (an 88-byte stack frame), and each step then
//    waits on local loads and stores: the frame took 2.3 ms that way;
//  - the empty-space skip: `occ` holds one bit per 8^3 brick (1 = some
//    voxel of the brick is solid; 59,392 bytes at scene 1024, L1/L2
//    resident). A thread reads a brick's bit once when its ray enters the
//    brick and, while the brick is empty, takes its axis steps with no
//    voxel load (5.6% of the frame's steps still load). The steps are the
//    same arithmetic in the same order (the crossing t is a pure function
//    of the integer voxel), so ids, t and step counts equal the walk
//    without the skip, which is this kernel given every bit set. The
//    bits are built once per world (`kernels.occupancy_bits`);
//  - origins: `origins` [G, 3] on the device, ray r belonging to origin
//    r / rays_per_origin, so the training sampler's K camera proposals are
//    one launch (4 x 68,644 rays fill the card where one proposal leaves
//    it a quarter full) and no host copy of an origin is needed;
//  - order: with `width` > 0 each warp takes an 8x4 pixel tile of an image
//    `width` rays wide (rays_per_origin rays per image), so its rays walk
//    alike (issued / needed axis steps 1.05 against 1.12 for 32
//    consecutive rays of a frame); the rays and outputs stay in row-major
//    order. With 0 a warp takes 32 consecutive rays.
//
// Numerics: voxel ids must equal the JAX op's. The crossing time keeps
// the JAX op order t = (target - ori) * inv_dir with inv_dir = 1 / dir
// hoisted, with explicit round-to-nearest intrinsics, and the file
// builds with -fmad=false so nvcc contracts no multiply-add on its own
// (a one-ULP drift flips the voxel of grazing rays). The start point
// start = ori + t0 * dir is the one fused multiply-add (__fmaf_rn): the
// JAX op's compiled init rounds it once, and on grazing rays that enter
// through a face the two roundings put the start on different sides of
// the face (measured: 0.27% of 2M random rays entering a 200x1024x1024
// grid from outside). The step bound is counted in single axis steps
// and is never below Y+X+Z+2, which no ray from the AABB entry reaches,
// so it never cuts a ray short.
//
// C ABI (ctypes): sd_dda_i8 returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBrickShift = 3;          // 8^3 voxels per occupancy bit
constexpr int kTileW = 8, kTileH = 4;   // a warp's pixels in tiled order

__device__ __forceinline__ float crossing_t(int p, float ori, float d,
                                            float inv, bool tiny) {
  if (tiny) return __int_as_float(0x7f800000);  // +inf
  float target = d > 0.f ? __fadd_rn((float)p, 1.0f) : (float)p;
  return __fmul_rn(__fsub_rn(target, ori), inv);
}

// Ray of thread i (-1: none): i itself in flat order; in tiled order
// (width > 0) lane l of tile t of image g is pixel (row, col) = (ty * 4 +
// l / 8, tx * 8 + l % 8), (ty, tx) = divmod(t, tiles_x), of the image's
// row-major rays.
__device__ __forceinline__ long long ray_of(long long i,
                                            long long rays_per_image,
                                            int width, int tiles_x,
                                            long long tile_threads) {
  if (width <= 0) return i;
  const long long img = i / tile_threads;
  const long long rem = i - img * tile_threads;
  const int tile = (int)(rem >> 5), lane = (int)(rem & 31);
  const int row = (tile / tiles_x) * kTileH + lane / kTileW;
  const int col = (tile % tiles_x) * kTileW + lane % kTileW;
  if (col >= width || (long long)row * width >= rays_per_image) return -1;
  return img * rays_per_image + (long long)row * width + col;
}

// Walks ray r; returns the voxel loads it issued and adds the occupancy
// bits it read to `lookups`.
__device__ __forceinline__ unsigned walk(
    long long r, const int8_t* __restrict__ voxel, int ny, int nx, int nz,
    const float* __restrict__ origins, long long rays_per_origin,
    const unsigned* __restrict__ occ, const float* __restrict__ dirs, int m,
    int max_steps, int* __restrict__ out_id, float* __restrict__ out_t,
    uint8_t* __restrict__ out_hit, int* __restrict__ out_steps,
    unsigned& lookups) {
  const float* o = origins + 3 * (r / rays_per_origin);
  const float ori[3] = {o[0], o[1], o[2]};
  const int dims[3] = {ny, nx, nz};
  const float d[3] = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
  int* oid = out_id + r * m;
  float* ot = out_t + r * m * 2;
  uint8_t* oh = out_hit + r * m;
  for (int k = 0; k < m; ++k) {
    oid[k] = 0;
    ot[2 * k] = 0.f;
    ot[2 * k + 1] = 0.f;
    oh[k] = 0;
  }

  // AABB entry (`_aabb_enter_t`)
  bool tiny[3];
  float t_near = -__int_as_float(0x7f800000);
  float t_far = __int_as_float(0x7f800000);
  bool parallel_miss = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    tiny[a] = fabsf(d[a]) < 1e-12f;
    float safe = tiny[a] ? (d[a] < 0.f ? -1e-12f : 1e-12f) : d[a];
    float ta = __fdiv_rn(__fsub_rn(0.f, ori[a]), safe);
    float tb = __fdiv_rn(__fsub_rn((float)dims[a], ori[a]), safe);
    t_near = fmaxf(t_near, fminf(ta, tb));
    t_far = fminf(t_far, fmaxf(ta, tb));
    bool inside = ori[a] >= 0.f && ori[a] <= (float)dims[a];
    if (tiny[a] && !inside) parallel_miss = true;
  }
  bool possible = (t_far > fmaxf(t_near, 0.f)) && !parallel_miss;
  int steps = 0;
  unsigned loads = 0;
  if (possible) {
    // `_dda_init` / `_crossing_t_init`. The walk keeps each axis in its
    // own registers and picks the stepped axis with selects: an array
    // indexed by the stepped axis would live in local memory, and every
    // step would wait on its loads and stores.
    float t0 = fmaxf(__fsub_rn(t_near, 1e-4f), 0.f);
    const int s0 = d[0] > 0.f ? 1 : -1, s1 = d[1] > 0.f ? 1 : -1,
              s2 = d[2] > 0.f ? 1 : -1;
    int p0, p1, p2;
    float inv0, inv1, inv2, at0, at1, at2;
    {
      int pos[3];
      float inv[3], axis_t[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float start = __fmaf_rn(t0, d[a], ori[a]);
        pos[a] = (int)floorf(start);
        inv[a] = __fdiv_rn(1.0f, tiny[a] ? 1e-12f : d[a]);
        axis_t[a] = crossing_t(pos[a], ori[a], d[a], inv[a], tiny[a]);
      }
      p0 = pos[0]; p1 = pos[1]; p2 = pos[2];
      inv0 = inv[0]; inv1 = inv[1]; inv2 = inv[2];
      at0 = axis_t[0]; at1 = axis_t[1]; at2 = axis_t[2];
    }
    const long long xz = (long long)nx * nz;
    const int bx = (nx + (1 << kBrickShift) - 1) >> kBrickShift;
    const int bz = (nz + (1 << kBrickShift) - 1) >> kBrickShift;
    int brick = -1;             // the brick whose bit `empty` holds
    bool empty = false;
    int cnt = 0;
    // `_dda_run` body, one axis step per iteration
    while (steps < max_steps) {
      ++steps;
      const int a = (at0 <= at1 && at0 <= at2) ? 0 : (at1 <= at2 ? 1 : 2);
      const float tnow = fminf(fminf(at0, at1), at2);
      const float da = a == 0 ? d[0] : (a == 1 ? d[1] : d[2]);
      const int pa = a == 0 ? p0 + s0 : (a == 1 ? p1 + s1 : p2 + s2);
      const int dim = a == 0 ? ny : (a == 1 ? nx : nz);
      if (da > 0.f ? pa >= dim : pa < 0) break;
      const float ta = crossing_t(
          pa, a == 0 ? ori[0] : (a == 1 ? ori[1] : ori[2]), da,
          a == 0 ? inv0 : (a == 1 ? inv1 : inv2),
          a == 0 ? tiny[0] : (a == 1 ? tiny[1] : tiny[2]));
      if (a == 0) { p0 = pa; at0 = ta; }
      else if (a == 1) { p1 = pa; at1 = ta; }
      else { p2 = pa; at2 = ta; }
      const bool inb = (unsigned)p0 < (unsigned)ny
                       && (unsigned)p1 < (unsigned)nx
                       && (unsigned)p2 < (unsigned)nz;
      if (!inb) continue;
      const int b = ((p0 >> kBrickShift) * bx + (p1 >> kBrickShift)) * bz
                    + (p2 >> kBrickShift);
      if (b != brick) {
        brick = b;
        empty = !((__ldg(occ + (b >> 5)) >> (b & 31)) & 1u);
        ++lookups;
      }
      if (empty) continue;
      ++loads;
      int blk = (int)voxel[p0 * xz + (long long)p1 * nz + p2];
      if (blk == 0) continue;
      float t_exit = fminf(fminf(at0, at1), at2);
      oid[cnt] = blk;
      ot[2 * cnt] = tnow;
      ot[2 * cnt + 1] = t_exit;
      oh[cnt] = 1;
      if (++cnt == m) break;
    }
  }
  if (out_steps) out_steps[r] = steps;
  return loads;
}

__global__ void __launch_bounds__(kThreads) dda_kernel(
    const int8_t* __restrict__ voxel, int ny, int nx, int nz,
    const float* __restrict__ origins, long long rays_per_origin,
    const unsigned* __restrict__ occ, int width, int tiles_x,
    long long tile_threads, const float* __restrict__ dirs,
    long long n_rays, int m, int max_steps, int* __restrict__ out_id,
    float* __restrict__ out_t, uint8_t* __restrict__ out_hit,
    int* __restrict__ out_steps, unsigned long long* __restrict__ stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = ray_of(i, rays_per_origin, width, tiles_x,
                             tile_threads);
  unsigned loads = 0, lookups = 0;
  if (r >= 0 && r < n_rays)
    loads = walk(r, voxel, ny, nx, nz, origins, rays_per_origin, occ, dirs,
                 m, max_steps, out_id, out_t, out_hit, out_steps, lookups);
  if (stats) {  // the grid is whole warps: every lane reaches here
    const unsigned wl = __reduce_add_sync(0xffffffffu, loads);
    const unsigned wk = __reduce_add_sync(0xffffffffu, lookups);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats, (unsigned long long)wl);
      atomicAdd(stats + 1, (unsigned long long)wk);
    }
  }
}

}  // namespace

extern "C" {

// voxel [ny, nx, nz] int8; origins [G, 3] f32 on the device, G = n_rays /
// rays_per_origin; occ: the occupancy bits of 8^3 bricks (bit b of word
// b / 32 for brick b = (y8 * ceil(nx / 8) + x8) * ceil(nz / 8) + z8; all
// bits set walks every voxel); width: 0 for flat order, else the image
// width of the tiled order (rays_per_origin a multiple of it); dirs
// [n_rays, 3] f32; out_id [n_rays, m] i32, out_t [n_rays, m, 2] f32,
// out_hit [n_rays, m] u8, out_steps [n_rays] i32 or null; stats: null,
// or [2] u64 to which the launch adds the voxel loads and the occupancy
// bits it read.
int sd_dda_i8(const int8_t* voxel, int ny, int nx, int nz,
              const float* origins, long long rays_per_origin,
              const unsigned* occ, int width, const float* dirs,
              long long n_rays, int m, int max_steps, int* out_id,
              float* out_t, uint8_t* out_hit, int* out_steps,
              unsigned long long* stats, void* stream) {
  if (!occ || rays_per_origin < 1 || n_rays % rays_per_origin || width < 0
      || (width > 0 && rays_per_origin % width))
    return (int)cudaErrorInvalidValue;
  long long threads = n_rays;
  int tiles_x = 0;
  long long tile_threads = 0;
  if (width > 0) {
    const long long height = rays_per_origin / width;
    tiles_x = (width + kTileW - 1) / kTileW;
    tile_threads = (long long)tiles_x * ((height + kTileH - 1) / kTileH) * 32;
    threads = n_rays / rays_per_origin * tile_threads;
  }
  const long long blocks = (threads + kThreads - 1) / kThreads;
  dda_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      voxel, ny, nx, nz, origins, rays_per_origin, occ, width, tiles_x,
      tile_threads, dirs, n_rays, m, max_steps, out_id, out_t, out_hit,
      out_steps, stats);
  return (int)cudaGetLastError();
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
