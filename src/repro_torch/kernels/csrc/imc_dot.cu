// Bit-serial in-memory-compute (IMC) dot products for Hopper (sm_90a).
//
// Replaces repro/kernels/imc_dot.py: imc_dot_pallas (one resident weight
// plane: 2-bit ternary trits (K/4, N) u8, int4 row pairs (K/2, N) u8 with
// the even row in the high nibble, or int8 (K, N)) and imc_dual_dot_pallas
// (one activation stream over both int4 planes of a (K, N) u8 buffer: hi
// = arithmetic byte >> 4, lo = (int8)(byte << 4) >> 4).
//
//   xs[m]   = max(amax_m, 1e-8) / qmax,  xq[m, k] = clip(rint(x / xs), +-qmax)
//   y[m, n] = bf16( ((float)(sum_k xq[m, k] * W[k, n]) * xs[m]) * scale[n] )
//
// The TPU kernel shift-adds one {-1, 0, +1} bit-plane product per
// magnitude bit in float32; every term is an integer, so the shift-add IS
// the integer product xq @ W. Here it is taken in int32 with __dp4a (four
// int8 products a lane and instruction) and converted once, so the result
// equals the float32 plain version bit for bit wherever that version's
// sums stay under 2^24 (ternary always; int4 / dual for K < 16.5k; int8
// for K <= 1040), and is the exact one past it.
//
// Bound: at decode (M = batch) the packed weight bytes, at prefill (M =
// batch x chunk) the multiply-adds.
//  * M <= 16: a GEMV. A block owns 32 columns and 4 rows (grid.y covers
//    more rows; those blocks re-read the weights from L2); each thread
//    reads 32-bit weight words (4 columns) of its K slice, unpacks four
//    K values per column into an int8x4 word, and the 32 K slices are
//    summed by warp shuffles and shared memory. int32 sums make the
//    order irrelevant.
//  * M > 16: 32 x 64 output tiles, 64-deep K steps; each step stages the
//    int8 activations and the weights unpacked to int8x4 words in shared
//    memory, and each thread accumulates 2 x 4 outputs (x2 for dual).
// The quantize pre-pass gives each row one warp (shuffle-reduced amax,
// 16-byte loads) and needs IEEE division and round-half-even: no
// -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FMT_TERNARY = 0, FMT_INT4 = 1, FMT_INT8 = 2, FMT_DUAL = 3;

// ---- quantize pre-pass ------------------------------------------------------
constexpr int Q_WARPS = 8;

__device__ __forceinline__ uint32_t quant_level(float v, float s, float q) {
  return (uint32_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -q), q) & 0xFFu;
}

// K % 8 == 0 and x 16-byte aligned: eight bf16 activations a lane and
// load, eight int8 levels a lane and store
__global__ void __launch_bounds__(Q_WARPS * 32)
imc_quantize_kernel(const __nv_bfloat16* __restrict__ x,
                    int8_t* __restrict__ xq, float* __restrict__ xs, int M,
                    int K, int qmax) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * Q_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  const int K8 = K / 8;
  float amax = 0.f;
#pragma unroll 4
  for (int k = lane; k < K8; k += 32) {
    const uint4 v = __ldg(xr + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float q = (float)qmax;
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), q);
  uint2* qr = reinterpret_cast<uint2*>(xq + (size_t)row * K);
#pragma unroll 4
  for (int k = lane; k < K8; k += 32) {
    const uint4 v = __ldg(xr + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      w[j / 2] |= (quant_level(f.x, s, q) | (quant_level(f.y, s, q) << 8))
                  << (16 * (j % 2));
    }
    qr[k] = make_uint2(w[0], w[1]);
  }
  if (lane == 0) xs[row] = s;
}

// ---- weight unpack: four K values of one column as an int8x4 word ----------

// per byte: a nibble 0..15 -> its sign-extended int8 value -8..7
__device__ __forceinline__ uint32_t sext4(uint32_t n) {
  return (((n ^ 0x08080808u) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// one byte of four 2-bit digits (digit i at bits 2i..2i+1) -> four int8
// trits digit - 1, digit i in byte i (K order)
__device__ __forceinline__ uint32_t trits4(uint32_t b) {
  const uint32_t d = (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u;
  return ((d | 0x80808080u) - 0x01010101u) ^ 0x80808080u;
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// K group g (K values 4g .. 4g+3) of columns n .. n+3: wk[0][c] is column
// n + c's int8x4 word (the hi plane for dual), wk[1][c] the lo plane's.
template <int FMT>
__device__ __forceinline__ void load_group(const uint8_t* __restrict__ w,
                                           int g, int n, int N,
                                           uint32_t (&wk)[2][4]) {
  if (FMT == FMT_TERNARY) {
    const uint32_t r = ld32(w + (size_t)g * N + n);
#pragma unroll
    for (int c = 0; c < 4; ++c) wk[0][c] = trits4((r >> (8 * c)) & 0xFFu);
  } else if (FMT == FMT_INT4) {
    const uint32_t r0 = ld32(w + (size_t)(2 * g) * N + n);
    const uint32_t r1 = ld32(w + (size_t)(2 * g + 1) * N + n);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // bytes [b0, b0, b1, b1] of column c -> [hi b0, lo b0, hi b1, lo b1]
      const uint32_t b = __byte_perm(r0, r1, c | (c << 4) | ((c + 4) << 8)
                                                 | ((c + 4) << 12));
      wk[0][c] = sext4(((b >> 4) & 0x000F000Fu) | (b & 0x0F000F00u));
    }
  } else {
    const uint32_t r0 = ld32(w + (size_t)(4 * g) * N + n);
    const uint32_t r1 = ld32(w + (size_t)(4 * g + 1) * N + n);
    const uint32_t r2 = ld32(w + (size_t)(4 * g + 2) * N + n);
    const uint32_t r3 = ld32(w + (size_t)(4 * g + 3) * N + n);
    // 4 x 4 byte transpose: rows r0..r3 (bytes = columns) -> columns
    const uint32_t a = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
    const uint32_t b = __byte_perm(r2, r3, 0x5140);
    const uint32_t c2 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
    const uint32_t d = __byte_perm(r2, r3, 0x7362);
    const uint32_t col[4] = {__byte_perm(a, b, 0x5410),
                             __byte_perm(a, b, 0x7632),
                             __byte_perm(c2, d, 0x5410),
                             __byte_perm(c2, d, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (FMT == FMT_INT8) {
        wk[0][c] = col[c];
      } else {
        wk[0][c] = sext4((col[c] >> 4) & 0x0F0F0F0Fu);
        wk[1][c] = sext4(col[c] & 0x0F0F0F0Fu);
      }
    }
  }
}

__device__ __forceinline__ __nv_bfloat16 epilogue(int acc, float sx,
                                                  float sw) {
  return __float2bfloat16_rn(((float)acc * sx) * sw);
}

// ---- GEMV path (M <= GV_MAX_M) ----------------------------------------------
constexpr int GV_MAX_M = 16;
constexpr int GV_ROWS = 4;                 // output rows of one block
constexpr int GV_COLS = 32;                // output columns of one block
constexpr int GV_TC = GV_COLS / 4;         // thread columns (4 columns each)
constexpr int GV_KS = 32;                  // K slices
constexpr int GV_THREADS = GV_TC * GV_KS;  // 256
constexpr int GV_WARPS = GV_THREADS / 32;

template <int FMT, int PLANES>
__global__ void __launch_bounds__(GV_THREADS)
imc_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const uint8_t* __restrict__ w, const float* __restrict__ s0,
                const float* __restrict__ s1, __nv_bfloat16* __restrict__ y0,
                __nv_bfloat16* __restrict__ y1, int M, int K, int N) {
  __shared__ int red[PLANES][GV_WARPS][GV_ROWS][GV_COLS];
  const int tc = threadIdx.x % GV_TC;
  const int ks = threadIdx.x / GV_TC;      // lane / 8 + 4 * warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = blockIdx.x * GV_COLS;
  const int m0 = blockIdx.y * GV_ROWS;
  const int rows = min(GV_ROWS, M - m0);
  int acc[PLANES][GV_ROWS][4];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int m = 0; m < GV_ROWS; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][m][c] = 0;

  // unrolled so that several K groups' weight loads are in flight at once
#pragma unroll 4
  for (int g = ks; g < K / 4; g += GV_KS) {
    uint32_t wk[2][4];
    load_group<FMT>(w, g, nb + 4 * tc, N, wk);
#pragma unroll
    for (int m = 0; m < GV_ROWS; ++m) {
      if (m < rows) {
        // four int8 activations xq[m0 + m, 4g .. 4g+3], one word
        const int xw = __ldg(
            reinterpret_cast<const int*>(xq + (size_t)(m0 + m) * K) + g);
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[p][m][c] = __dp4a((int)wk[p][c], xw, acc[p][m][c]);
      }
    }
  }
  // the 4 K slices of a warp share a thread column: lanes tc, tc+8, ...
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int m = 0; m < GV_ROWS; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int v = acc[p][m][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < GV_TC) red[p][warp][m][4 * tc + c] = v;
      }
  __syncthreads();
  if (threadIdx.x < GV_ROWS * GV_COLS) {
    const int m = threadIdx.x / GV_COLS;
    const int col = threadIdx.x % GV_COLS;
    if (m < rows) {
      const int n = nb + col;
      const float sx = xs[m0 + m];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        int s = 0;
#pragma unroll
        for (int i = 0; i < GV_WARPS; ++i) s += red[p][i][m][col];
        (p ? y1 : y0)[(size_t)(m0 + m) * N + n] =
            epilogue(s, sx, (p ? s1 : s0)[n]);
      }
    }
  }
}

// ---- tiled path (M > GV_MAX_M) ----------------------------------------------
constexpr int TM = 32, TN = 64, TK = 64;   // block tile, K step
constexpr int TG = TK / 4;                 // K groups a step
constexpr int T_THREADS = 256;             // 16 x 16: 2 rows x 4 columns each
static_assert(TG * (TN / 4) == T_THREADS, "one weight group per thread");

template <int FMT, int PLANES>
__global__ void __launch_bounds__(T_THREADS)
imc_tiled_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const uint8_t* __restrict__ w, const float* __restrict__ s0,
                 const float* __restrict__ s1, __nv_bfloat16* __restrict__ y0,
                 __nv_bfloat16* __restrict__ y1, int M, int K, int N) {
  __shared__ int xsm[TM][TG + 1];
  __shared__ __align__(16) uint32_t wsm[PLANES][TG][TN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  int acc[PLANES][2][4];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][r][c] = 0;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = t; i < TM * TG; i += T_THREADS) {
      const int r = i / TG, gg = i % TG;
      const int m = m0 + r;
      xsm[r][gg] = m < M ? __ldg(reinterpret_cast<const int*>(
                               xq + (size_t)m * K + k0) + gg)
                         : 0;
    }
    {
      const int gg = t / (TN / 4), cq = t % (TN / 4);
      uint32_t wk[2][4];
      load_group<FMT>(w, k0 / 4 + gg, n0 + 4 * cq, N, wk);
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
        *reinterpret_cast<uint4*>(&wsm[p][gg][4 * cq]) =
            make_uint4(wk[p][0], wk[p][1], wk[p][2], wk[p][3]);
    }
    __syncthreads();
#pragma unroll
    for (int gg = 0; gg < TG; ++gg) {
      const int xa = xsm[ty][gg];
      const int xb = xsm[ty + 16][gg];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const uint4 v = *reinterpret_cast<const uint4*>(&wsm[p][gg][4 * tx]);
        const int wv[4] = {(int)v.x, (int)v.y, (int)v.z, (int)v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[p][0][c] = __dp4a(wv[c], xa, acc[p][0][c]);
          acc[p][1][c] = __dp4a(wv[c], xb, acc[p][1][c]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m < M) {
      const float sx = xs[m];
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + 4 * tx + c;
          (p ? y1 : y0)[(size_t)m * N + n] =
              epilogue(acc[p][r][c], sx, (p ? s1 : s0)[n]);
        }
    }
  }
}

template <int FMT, int PLANES>
int launch(const void* xq, const void* xs, const void* w, const void* s0,
           const void* s1, void* y0, void* y1, int M, int K, int N,
           cudaStream_t s) {
  const int8_t* q = (const int8_t*)xq;
  const float* sx = (const float*)xs;
  const uint8_t* wb = (const uint8_t*)w;
  if (M <= GV_MAX_M) {
    dim3 grid(N / GV_COLS, (M + GV_ROWS - 1) / GV_ROWS);
    imc_gemv_kernel<FMT, PLANES><<<grid, GV_THREADS, 0, s>>>(
        q, sx, wb, (const float*)s0, (const float*)s1, (__nv_bfloat16*)y0,
        (__nv_bfloat16*)y1, M, K, N);
  } else {
    dim3 grid(N / TN, (M + TM - 1) / TM);
    imc_tiled_kernel<FMT, PLANES><<<grid, T_THREADS, 0, s>>>(
        q, sx, wb, (const float*)s0, (const float*)s1, (__nv_bfloat16*)y0,
        (__nv_bfloat16*)y1, M, K, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (16-byte aligned) -> xq (M, K) int8, xs (M,) f32;
// contiguous; K % 8 == 0 (checked by the wrapper).
extern "C" int imc_quantize(const void* x, void* xq, void* xs, int M, int K,
                            int qmax, void* stream) {
  imc_quantize_kernel<<<(M + Q_WARPS - 1) / Q_WARPS, Q_WARPS * 32, 0,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs, M, K, qmax);
  return (int)cudaGetLastError();
}

// xq (M, K) int8, xs (M,) f32, w packed per fmt (0 ternary (K/4, N) u8,
// 1 int4 rows (K/2, N) u8, 2 int8 (K, N)), 4-byte aligned; scale (N,)
// f32; y (M, N) bf16; all contiguous; K % 64 == 0, N % 64 == 0 (checked
// by the wrapper).
extern "C" int imc_dot(const void* xq, const void* xs, const void* w,
                       const void* scale, void* y, int M, int K, int N,
                       int fmt, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (fmt) {
    case FMT_TERNARY:
      return launch<FMT_TERNARY, 1>(xq, xs, w, scale, scale, y, y, M, K, N, s);
    case FMT_INT4:
      return launch<FMT_INT4, 1>(xq, xs, w, scale, scale, y, y, M, K, N, s);
    case FMT_INT8:
      return launch<FMT_INT8, 1>(xq, xs, w, scale, scale, y, y, M, K, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// buf (K, N) u8 (4-byte aligned), hi/lo scales (N,) f32, y_hi / y_lo
// (M, N) bf16; otherwise as imc_dot.
extern "C" int imc_dual_dot(const void* xq, const void* xs, const void* buf,
                            const void* hi_scale, const void* lo_scale,
                            void* y_hi, void* y_lo, int M, int K, int N,
                            void* stream) {
  return launch<FMT_DUAL, 2>(xq, xs, buf, hi_scale, lo_scale, y_hi, y_lo, M,
                             K, N, (cudaStream_t)stream);
}
