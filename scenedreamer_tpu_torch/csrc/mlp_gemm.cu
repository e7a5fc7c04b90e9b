// RenderMLP hidden layer, forward, for Hopper: one float32 GEMM with the
// layer's bias or style shift, label term and LeakyReLU in its epilogue.
//
// Replaces no Pallas kernel. Its JAX counterpart is XLA's dot fusion of
// `scenedreamer_tpu/models/layers.py:RenderMLP` (`Dense` / `ModLinear`,
// their adds and `leaky_relu`, lines 144-183), which the TPU compiles
// into one fusion per layer. In PyTorch each hidden layer was a cuBLAS
// GEMM followed by one to three elementwise passes over its 1 KB-a-row
// output (the broadcast add of the shift, the label add of the first
// layer, the LeakyReLU), each reading and writing the whole activation:
// ~440 GB a served frame, a quarter of its device time. Here the GEMM's
// sums stay in registers until the epilogue has finished them, and the
// output is written once.
//
//   out[b, r, :] = leaky_relu_0.2(x[b, r, :] @ W[b]^T + shift[b, :]
//                                 (+ m[b, r, :] @ Wm^T))
//
// x [B, rows, K], W [N, K] per batch item (batch stride 0 when the batch
// shares it: the first layer's `fc_1.weight`), shift [N] per batch item
// (stride 0: `fc_1.bias`; else ModLinear's beta_b), the optional label
// term m [B, rows, km] against Wm [N, km] (`fc_m_a.weight`), out
// [B, rows, N]. The wrapper (`kernels.py:render_mlp_gemm`) hands W over
// transposed, [K, N] (256 KB, one small copy a layer), so its rows
// arrive by 16-byte copies. Any rows, K, N and km <= 32; edges masked.
//
// What bounds it: operations. A row of the flagship layer is 1 KB in and
// 1 KB out against 2 x 256 x 256 = 131 kFLOP, ~64 FLOP per byte, above
// float32's ridge on an H100 (67 TFLOP/s over 3.35 TB/s, ~20). So the
// design is a register-blocked SIMT GEMM (float32 FFMA; the configuration
// is float32 with TF32 off, so no tensor core):
//   * a block of 256 threads owns 128 rows and a 256-wide slice of the
//     output (the whole layer at N = 256), so each x row is read from
//     device memory once per layer; W^T[b] (256 KB) stays in L2;
//   * each thread owns an 8 x 16 micro-tile (rows ty*4 + {0..3} and
//     64 + ty*4 + {0..3}; columns c*64 + tx*4 + {0..3}, c < 4): per step
//     of k, two float4 reads of A and four of W from shared memory feed
//     128 FFMA; a warp is 4 ty x 8 tx, so each float4 read of a warp
//     spans 64 or 128 contiguous bytes, one shared-memory wavefront;
//   * a 4-stage cp.async ring over K in steps of 8 keeps three steps of
//     loads in flight. A arrives k-major ([k][row]), transposed on the
//     way in by 4-byte copies (a warp reads 4 rows x 32 contiguous
//     bytes: whole sectors) into rows padded by 4 floats, so the
//     transposing writes hit 32 distinct banks; W^T by 16-byte copies;
//     out-of-range rows, columns and k are zero-filled (src-size 0);
//   * a persistent grid (the SMs' resident blocks, one per SM at ~235
//     registers): block x takes row tiles x, x + gridDim.x, ... and
//     starts the next tile's labels and first three steps before this
//     tile's epilogue, so the load latency at a tile's start hides
//     behind the previous tile's stores;
//   * the epilogue, in registers: + shift, + the label term (Wm k-major
//     and the tile's m rows staged in shared memory by cp.async; zero
//     entries of m skipped, which is exact: a one-hot row adds one
//     weight), then y > 0 ? y : y * 0.2f as `F.leaky_relu` computes it,
//     then float4 stores (scalar ones when N is not a multiple of 4).
// Measured on an H100 at the serving chunk (1,306,800 rows): tiles of
// 128 x 256 beat 64 x 256 (two blocks an SM), steps of 8 beat 16 and 32,
// 4 stages beat 3, 5 and 6; the persistent grid took the K 256 layer from
// 4.23 to 4.01 ms (cuBLAS's GEMM alone 3.81) and the first layer, whose
// label weights each block used to gather before its first load, from
// 3.06 to 2.52 ms. `chip_smoke.py` phase 20 times both layers.
//
// Numerics: each output is a sequential sum over k of __fmaf_rn products
// (the file builds with -fmad=false, so only these fuse), then
// (sum + shift) + label, rounded at each step as the plain composition
// (`ops/mlp_ops.py:render_mlp_gemm_plain`) rounds its adds. The tests
// allow the two an accumulation order apart (1e-5 of the largest output);
// on an H100 at the serving chunk both layers matched cuBLAS's
// composition bit for bit (its float32 SIMT GEMM also sums each output
// over k in order), and the served frame's `frame_gap` read 0.
//
// C ABI (ctypes): the entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;          // rows of a block
constexpr int BN = 256;          // output columns of a block
constexpr int BK = 8;            // depth of a pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = BM * 2;  // an 8 x 16 micro-tile each
constexpr int MIN_BLOCKS = 256 / THREADS;   // blocks an SM holds at once
constexpr int SA = BM + 4;       // padded k-row of the A tile
constexpr int STAGE_FLOATS = BK * SA + BK * BN;
constexpr int A_COPIES = BM * BK / THREADS;          // 4-byte copies
constexpr int W_COPIES = BK * BN / 4 / THREADS;      // 16-byte copies
constexpr int MAX_LABELS = 32;
constexpr size_t RING_BYTES = sizeof(float) * STAGES * STAGE_FLOATS;

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a 4-byte copy, zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// a 16-byte copy, zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// x [B, rows, K]; wt [K, N] per batch item (W^T, w_bstride floats apart);
// vec_n: N % 4 == 0 (16-byte copies of W^T rows and float4 stores). A
// persistent grid: block x walks the row tiles x, x + gridDim.x, ...
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
render_mlp_gemm_kernel(const float* __restrict__ x,
                       const float* __restrict__ wt, long long w_bstride,
                       const float* __restrict__ shift, long long s_bstride,
                       const float* __restrict__ m,
                       const float* __restrict__ wm, int km,
                       float* __restrict__ out, long long rows, int K, int N,
                       int vec_n) {
  extern __shared__ __align__(16) float smem[];
  float* wm_s = smem + STAGES * STAGE_FLOATS;   // [km][BN], k-major
  float* m_s = wm_s + km * BN;                  // [2][BM][km] by tile parity
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const float* xb = x + (long long)b * rows * K;
  const float* wb = wt + (long long)b * w_bstride;
  const float* mb = m != nullptr ? m + (long long)b * rows * km : nullptr;
  const long long tiles = (rows + BM - 1) / BM;
  const int ktiles = (K + BK - 1) / BK;

  // A: thread (lk, lr) copies k = lk of rows lr + A_STEP i, transposing
  // into the k-major tile (a warp reads whole 32-byte sectors of 4 or 2
  // rows); W^T: the stage's BK x BN / 4 float4 slots in order, tid +
  // THREADS i
  const int lk = tid % BK, lr = tid / BK;
  constexpr int A_STEP = THREADS / BK;
  long long m0 = 0;
  const float* a_src = xb;
  unsigned a_ok = 0;

  auto load = [&](int kt, int stage) {
    float* as = smem + stage * STAGE_FLOATS + lk * SA + lr;
    float* bs = smem + stage * STAGE_FLOATS + BK * SA;
    const bool kok = kt * BK + lk < K;
    const long long koff = (long long)kt * BK;
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const bool ok = kok && (a_ok >> i & 1u);
      cp_async4(as + A_STEP * i, ok ? a_src + i * A_STEP * (long long)K + koff
                                    : xb, ok);
    }
#pragma unroll
    for (int i = 0; i < W_COPIES; ++i) {
      const int slot = tid + THREADS * i;
      const int kk = slot / (BN / 4), c = (slot % (BN / 4)) * 4;
      const int k = kt * BK + kk, col = n0 + c;
      float* dst = bs + kk * BN + c;
      const float* src = wb + (long long)k * N + col;
      if (vec_n) {
        const bool ok = k < K && col < N;
        cp_async16(dst, ok ? src : wb, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k < K && col + e < N;
          cp_async4(dst + e, ok ? src + e : wb, ok);
        }
      }
    }
  };

  // a tile's labels and first STAGES - 1 steps, in flight while the
  // previous tile finishes
  auto start_tile = [&](long long tile, int parity) {
    m0 = tile * BM;
    a_src = xb + (m0 + lr) * K + lk;
    a_ok = 0;
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i)
      if (m0 + lr + A_STEP * i < rows) a_ok |= 1u << i;
    if (mb != nullptr) {
      float* ms = m_s + parity * BM * km;
      const float* src = mb + m0 * km;
      for (int i = tid; i < BM * km; i += THREADS) {
        const bool ok = m0 + i / km < rows;
        cp_async4(ms + i, ok ? src + i : mb, ok);
      }
    }
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) load(s, s);
      cp_async_commit();
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);

  // the label weights, k-major; they land with the first tile's first step
  if (mb != nullptr) {
    for (int i = tid; i < km * BN; i += THREADS) {
      const int k = i / BN, n = i - k * BN;
      const bool ok = n0 + n < N;
      cp_async4(wm_s + i, ok ? wm + (long long)(n0 + n) * km + k : wm, ok);
    }
  }
  float sh[16];
  {
    const float* sb = shift + (long long)b * s_bstride;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + (j >> 2) * 64 + tx * 4 + (j & 3);
      sh[j] = col < N ? sb[col] : 0.f;
    }
  }
  float* ob = out + (long long)b * rows * N;

  long long tile = blockIdx.x;
  if (tile < tiles) start_tile(tile, 0);
  for (int parity = 0; tile < tiles; tile += gridDim.x, parity ^= 1) {
    float acc[8][16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<STAGES - 2>();
      // step kt has landed for every thread, and every thread is done
      // with step kt - 1, whose stage the next load overwrites
      __syncthreads();
      if (kt + STAGES - 1 < ktiles)
        load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
      cp_async_commit();
      const float* as = smem + (kt % STAGES) * STAGE_FLOATS;
      const float* bs = as + BK * SA;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(as + kk * SA + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(
            as + kk * SA + BM / 2 + ty * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[16];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 t = *reinterpret_cast<const float4*>(
              bs + kk * BN + c * 64 + tx * 4);
          bv[4 * c] = t.x;
          bv[4 * c + 1] = t.y;
          bv[4 * c + 2] = t.z;
          bv[4 * c + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            acc[i][j] = __fmaf_rn(a[i], bv[j], acc[i][j]);
      }
    }

    const long long row0 = m0;
    const float* ms = m_s + parity * BM * km;
    __syncthreads();          // every warp is done with the ring
    if (tile + gridDim.x < tiles) start_tile(tile + gridDim.x, parity ^ 1);

    // epilogue: shift, label term, LeakyReLU, one store
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4;
      const long long row = row0 + r;
      float y[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) y[j] = __fadd_rn(acc[i][j], sh[j]);
      if (mb != nullptr) {
        float lab[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) lab[j] = 0.f;
        for (int k = 0; k < km; ++k) {
          const float mv = ms[r * km + k];
          if (mv != 0.f) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float4 t = *reinterpret_cast<const float4*>(
                  wm_s + k * BN + c * 64 + tx * 4);
              lab[4 * c] = __fmaf_rn(mv, t.x, lab[4 * c]);
              lab[4 * c + 1] = __fmaf_rn(mv, t.y, lab[4 * c + 1]);
              lab[4 * c + 2] = __fmaf_rn(mv, t.z, lab[4 * c + 2]);
              lab[4 * c + 3] = __fmaf_rn(mv, t.w, lab[4 * c + 3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) y[j] = __fadd_rn(y[j], lab[j]);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        y[j] = y[j] > 0.f ? y[j] : __fmul_rn(y[j], 0.2f);
      if (row < rows) {
        float* orow = ob + row * N;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = n0 + c * 64 + tx * 4;
          if (vec_n) {
            if (col < N)
              *reinterpret_cast<float4*>(orow + col) = make_float4(
                  y[4 * c], y[4 * c + 1], y[4 * c + 2], y[4 * c + 3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < N) orow[col + e] = y[4 * c + e];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x [batch, rows, k] f32; wt [k, n] f32 (W^T) per batch item, w_bstride
// floats apart (0: shared); shift [n] f32, s_bstride apart; m [batch,
// rows, km] and wm [n, km] f32, or both null; out [batch, rows, n] f32.
// vec_n: n % 4 == 0 and wt 16-byte aligned per batch item. 1 <= batch <=
// 65535, k >= 1, 0 <= km <= 32.
int sd_render_mlp_gemm(const float* x, const float* wt, long long w_bstride,
                       const float* shift, long long s_bstride,
                       const float* m, const float* wm, int km, float* out,
                       int batch, long long rows, int k, int n, int vec_n,
                       cudaStream_t stream) {
  if (batch <= 0 || rows <= 0 || n <= 0) return (int)cudaSuccess;
  if (k <= 0 || km < 0 || km > MAX_LABELS) return (int)cudaErrorInvalidValue;
  // per device, once (every caller sets the same values): the
  // shared-memory allowance past 48 KB and the SM count
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sm_count = dev < 64 ? sms[dev] : 0;
  if (sm_count == 0) {
    err = cudaFuncSetAttribute(
        render_mlp_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(RING_BYTES + sizeof(float) * MAX_LABELS * (BN + 2 * BM)));
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sms[dev] = sm_count;
  }
  const int labels = m != nullptr ? km : 0;
  const size_t smem = RING_BYTES + sizeof(float) * labels * (BN + 2 * BM);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, render_mlp_gemm_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (rows + BM - 1) / BM;
  const long long others = (long long)((n + BN - 1) / BN) * batch;
  long long resident = (long long)sm_count * (per_sm > 0 ? per_sm : 1);
  resident = resident > others ? resident / others : 1;
  const dim3 grid((unsigned)(tiles < resident ? tiles : resident),
                  (unsigned)((n + BN - 1) / BN), (unsigned)batch);
  render_mlp_gemm_kernel<<<grid, THREADS, smem, stream>>>(
      x, wt, w_bstride, shift, s_bstride, m, wm, labels, out, rows, k, n,
      vec_n);
  return (int)cudaGetLastError();
}

const char* sd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
