// Packed-ternary weight matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/ternary_matmul.py:ternary_matmul_pallas.
// y[m, n] = bf16( (sum_k x[m, k] * trit[k, n]) * scale[n] ), f32 accumulate,
// where w (K/4, N) uint8 holds four 2-bit digits per byte along K (digit i
// at bits 2i..2i+1, trit = digit - 1) and scale (1, N) is float32.
//
// Bound: at decode (M = batch, 1..8) the kernel is a GEMV bounded by the
// packed weight's bytes (K*N/4); at prefill (M = batch * chunk) by the
// multiply-adds. The weight stays packed in device memory in both paths:
//  * M <= 8: one block per 32 output columns, its 32 warps splitting K
//    among themselves (each lane reads one packed byte per step, four
//    trits, and the activations by broadcast), partial sums reduced
//    across warps in shared memory — many blocks, no cross-block pass;
//  * M > 8: 32 x 64 output tiles on the tensor cores (WMMA bf16, f32
//    accumulate), 128-deep K steps: each step unpacks the tile's trits
//    into shared memory as bf16 +-1/0, which the tensor cores multiply
//    exactly, while the next step's operands load into registers.
// The per-channel scale is applied in the epilogue of both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ---- GEMV path (M <= GV_MAX_M) --------------------------------------------
constexpr int GV_MAX_M = 8;
constexpr int GV_WARPS = 32;
constexpr int GV_COLS = 32;

__global__ void __launch_bounds__(GV_WARPS * 32)
ternary_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  __shared__ float red[GV_WARPS][GV_MAX_M][GV_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * GV_COLS + lane;
  float acc[GV_MAX_M];
#pragma unroll
  for (int m = 0; m < GV_MAX_M; ++m) acc[m] = 0.f;

  const int Kp = K / 4;
#pragma unroll 4
  for (int kp = warp; kp < Kp; kp += GV_WARPS) {
    const unsigned b = w[(size_t)kp * N + n];
    const float t0 = (float)((int)(b & 3u) - 1);
    const float t1 = (float)((int)((b >> 2) & 3u) - 1);
    const float t2 = (float)((int)((b >> 4) & 3u) - 1);
    const float t3 = (float)((int)((b >> 6) & 3u) - 1);
#pragma unroll
    for (int m = 0; m < GV_MAX_M; ++m) {
      if (m < M) {
        // four bf16 activations x[m, 4kp .. 4kp+3], the same for all lanes
        const uint2 raw =
            *reinterpret_cast<const uint2*>(x + (size_t)m * K + 4 * kp);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h[0]);
        const float2 c = __bfloat1622float2(h[1]);
        acc[m] = fmaf(a.x, t0, acc[m]);
        acc[m] = fmaf(a.y, t1, acc[m]);
        acc[m] = fmaf(c.x, t2, acc[m]);
        acc[m] = fmaf(c.y, t3, acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < GV_MAX_M; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  if (warp < M) {                       // warp m reduces output row m
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < GV_WARPS; ++i) s += red[i][warp][lane];
    y[(size_t)warp * N + n] = __float2bfloat16_rn(s * scale[n]);
  }
}

// ---- tensor-core path (M > GV_MAX_M) ----------------------------------------
constexpr int TM = 32, TN = 64, TK = 128;  // block tile
constexpr int MMA_THREADS = 128;           // 4 warps, 2 x 2, 16 x 32 each
constexpr int XS_LD = TK + 8, WS_LD = TN + 8, CS_LD = TN + 4;
constexpr int X_VECS = TM * TK / 8 / MMA_THREADS;       // uint4 per thread
constexpr int W_WORDS = (TK / 4) * TN / 4 / MMA_THREADS; // uint32 per thread

__global__ void __launch_bounds__(MMA_THREADS)
ternary_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(32) __nv_bfloat16 xs[TM][XS_LD];
  __shared__ __align__(32) __nv_bfloat16 ws[TK][WS_LD];
  __shared__ __align__(32) float cs[TM][CS_LD];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;

  // the next K step's operands wait in registers while the tensor cores
  // work on the current one (a two-stage pipeline through registers)
  uint4 xr[X_VECS];
  uint32_t wr[W_WORDS];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_VECS; ++i) {
      const int idx = tid + MMA_THREADS * i;
      const int row = idx / (TK / 8), c8 = idx % (TK / 8);
      const int m = m0 + row;
      xr[i] = m < M ? *reinterpret_cast<const uint4*>(
                          x + (size_t)m * K + k0 + c8 * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < W_WORDS; ++i) {
      const int idx = tid + MMA_THREADS * i;
      const int pr = idx / (TN / 4), c4 = idx % (TN / 4);
      wr[i] = *reinterpret_cast<const uint32_t*>(
          w + (size_t)(k0 / 4 + pr) * N + n0 + c4 * 4);
    }
  };
  auto store_stage = [&]() {
#pragma unroll
    for (int i = 0; i < X_VECS; ++i) {
      const int idx = tid + MMA_THREADS * i;
      const int row = idx / (TK / 8), c8 = idx % (TK / 8);
      *reinterpret_cast<uint4*>(&xs[row][c8 * 8]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < W_WORDS; ++i) {
      const int idx = tid + MMA_THREADS * i;
      const int pr = idx / (TN / 4), c4 = idx % (TN / 4);
#pragma unroll
      for (int d = 0; d < 4; ++d) {   // trit row 4 * pr + d of 4 columns
        float t[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)   // byte j of the word is column 4 c4 + j
          t[j] = (float)((int)((wr[i] >> (8 * j + 2 * d)) & 3u) - 1);
        const __nv_bfloat162 p01 = __floats2bfloat162_rn(t[0], t[1]);
        const __nv_bfloat162 p23 = __floats2bfloat162_rn(t[2], t[3]);
        uint2 v;
        v.x = *reinterpret_cast<const uint32_t*>(&p01);
        v.y = *reinterpret_cast<const uint32_t*>(&p23);
        *reinterpret_cast<uint2*>(&ws[pr * 4 + d][c4 * 4]) = v;
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);

  load_stage(0);
  for (int k0 = 0; k0 < K; k0 += TK) {
    store_stage();
    __syncthreads();
    if (k0 + TK < K) load_stage(k0 + TK);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, &xs[wm * 16][kk], XS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &ws[kk][wn * 32 + j * 16], WS_LD);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&cs[wm * 16][wn * 32 + j * 16], acc[j], CS_LD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TM * TN; i += MMA_THREADS) {
    const int r = i / TN, c = i % TN;
    const int m = m0 + r;
    if (m < M)
      y[(size_t)m * N + n0 + c] = __float2bfloat16_rn(cs[r][c] * scale[n0 + c]);
  }
}

}  // namespace

// x (M, K) bf16 (16-byte aligned), w (K/4, N) uint8 (4-byte aligned),
// scale (N,) f32, y (M, N) bf16, all contiguous; K % 128 == 0 and
// N % 64 == 0 (checked by the wrapper).
extern "C" int ternary_matmul(const void* x, const void* w, const void* scale,
                              void* y, int M, int K, int N, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (M <= GV_MAX_M) {
    ternary_gemv_kernel<<<N / GV_COLS, GV_WARPS * 32, 0, s>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)scale,
        (__nv_bfloat16*)y, M, K, N);
  } else {
    dim3 grid(N / TN, (M + TM - 1) / TM);
    ternary_mma_kernel<<<grid, MMA_THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)scale,
        (__nv_bfloat16*)y, M, K, N);
  }
  return (int)cudaGetLastError();
}
