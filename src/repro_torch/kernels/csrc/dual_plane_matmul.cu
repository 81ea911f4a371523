// Dual-plane (8T dual-bit cell) weight matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/dual_plane_matmul.py:dual_plane_matmul_pallas.
// buf (K, N) uint8 holds two int4 matrices: the high nibble (arithmetic
// shift of the signed byte) and the low nibble (shift left, then
// arithmetic shift right). With x (M, K) bf16 and per-column f32 scales:
//   y_hi[m, n] = bf16( f32(sum_k x[m, k] * hi[k, n]) * hi_scale[n] )
//   y_lo[m, n] = bf16( f32(sum_k x[m, k] * lo[k, n]) * lo_scale[n] )
// Each byte is read from device memory once and feeds both sums: that is
// the kernel's reason to exist.
//
// The sums are EXACT: a bf16 x int4 product has at most 12 significant
// bits, so the 2048-term sums of the model's projections fit the 53 bits
// of a float64 accumulator whenever a row's activations span fewer than
// ~30 binades (post-norm activations span ~15). An exact sum does not
// depend on the order it is taken in, so every route below equals the
// plain version (a float64 matmul) bit for bit on the card, and a row's
// result does not depend on M (decode M = 4, verify M = 16, prefill
// M = 128) nor on how K is split. Why exact: f32 sums taken in another
// order than the plain version's (tensor-core tiles) move ~0.3% of the
// bf16 outputs by an ulp; granite's int4 KV cache turns such ulps into
// level flips, and its first prefill chunk's logits then miss the plain
// route's by rel_err 0.094 (measured on an NVIDIA H100, 700 W), past the
// 0.05 the port holds them to.
//
// Bound: at decode (M <= 4) the K*N buffer bytes; above it the float64
// multiply-adds, which the card's float64 tensor cores (DMMA, 67 TFLOP/s
// dense on an H100 SXM) run at twice its float64 CUDA-core rate. Routes:
//  * M <= 4: a GEMV on the CUDA cores. One block per 64 output columns
//    (two per lane, so a warp reads 64 consecutive bytes of a K row) and
//    the M rows of x, staged as float64 in shared memory 256 columns of K
//    at a time; 16 warps split K row by row, their partial sums meet in
//    shared memory. A tensor-core tile would waste 12 of its 16 rows.
//  * 4 < M <= 16 (verify) and M > 16 (prefill): float64 tensor-core tiles
//    of 16 x 64 and 128 x 64 outputs, mma.sync.m16n8k16.f64. Each K slice
//    (128 deep at 16 rows, 64 at 128) of the byte buffer and of x goes
//    into shared memory with cp.async through a 4-stage ring; x is
//    converted there to float64 once per tile; each byte is expanded from
//    shared memory into both planes' B fragments as exact doubles (the
//    level() trick below), and both planes' tiles accumulate from that
//    one read. 8 warps: at 128 rows 4 x 2 warps of 32 x 32 outputs; at 16
//    rows 2 column halves x 4 warps that split each slice's K and meet in
//    shared memory. Where the tiles do not fill the card (N = 512), K is
//    split across CTAs as well; the float64 partial sums, exact, go to
//    scratch and a small kernel adds them, scales and rounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_common.cuh"

namespace {

// an int4 nibble u (0..15, two's complement) as an exact double:
// 2^52 + (u ^ 8) holds the level + 8 in its low word, so one integer xor
// and one double subtraction replace the slow int-to-double conversion
__device__ __forceinline__ double level(unsigned u) {
  return __hiloint2double(0x43300000, (int)(u ^ 8u)) - 4503599627370504.0;
}

__device__ __forceinline__ double plane_hi(unsigned b) {
  return level((b >> 4) & 15u);
}

__device__ __forceinline__ double plane_lo(unsigned b) {
  return level(b & 15u);
}

__device__ __forceinline__ __nv_bfloat162 scaled_pair(double a, double b,
                                                      const float* sc,
                                                      int col) {
  return __halves2bfloat162(__float2bfloat16_rn((float)a * sc[col]),
                            __float2bfloat16_rn((float)b * sc[col + 1]));
}

// ---------------------------------------------------------------------------
// decode: the GEMV
// ---------------------------------------------------------------------------

constexpr int GV_COLS = 64;       // two columns per lane
constexpr int GV_ROWS = 4;        // rows of x the GEMV takes
constexpr int GV_WARPS = 16;      // warps splitting K
constexpr int KC = 256;           // K columns of x staged per round

__global__ void __launch_bounds__(GV_WARPS * 32)
dual_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ buf,
                 const float* __restrict__ hs, const float* __restrict__ ls,
                 __nv_bfloat16* __restrict__ y_hi,
                 __nv_bfloat16* __restrict__ y_lo, int M, int K, int N) {
  constexpr int MT = GV_ROWS, WARPS = GV_WARPS;
  __shared__ double xs[MT][KC];
  __shared__ double red[WARPS][4][32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * GV_COLS;
  const int n = n0 + 2 * lane;
  const int rows = M;
  // acc[m][0..1]: hi plane, columns n and n+1; acc[m][2..3]: lo plane
  double acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();               // the previous round's xs is read
    for (int i = tid; i < rows * (kc / 2); i += WARPS * 32) {
      const int r = i / (kc / 2), c = 2 * (i % (kc / 2));
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              x + (size_t)r * K + k0 + c));
      xs[r][c] = v.x;
      xs[r][c + 1] = v.y;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = warp; k < kc; k += WARPS) {
      const unsigned w = *reinterpret_cast<const uint16_t*>(
          buf + (size_t)(k0 + k) * N + n);
      const double h0 = plane_hi(w & 0xffu), h1 = plane_hi(w >> 8);
      const double l0 = plane_lo(w & 0xffu), l1 = plane_lo(w >> 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < rows) {
          const double xv = xs[m][k];            // a broadcast read
          acc[m][0] = fma(xv, h0, acc[m][0]);
          acc[m][1] = fma(xv, h1, acc[m][1]);
          acc[m][2] = fma(xv, l0, acc[m][2]);
          acc[m][3] = fma(xv, l1, acc[m][3]);
        }
      }
    }
  }
  // one output row at a time: warps' partial sums -> shared memory ->
  // 128 threads each finish one (plane, column)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= rows) break;          // uniform across the block
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][j][lane] = acc[m][j];
    __syncthreads();
    if (tid < 128) {
      const int j = tid / 32, l = tid % 32;
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += red[i][j][l];
      const int col = n0 + 2 * l + (j & 1);
      const size_t o = (size_t)m * N + col;
      if (j < 2)
        y_hi[o] = __float2bfloat16_rn((float)s * hs[col]);
      else
        y_lo[o] = __float2bfloat16_rn((float)s * ls[col]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// verify / prefill: float64 tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int BN = 64;            // output columns of a tile
constexpr int STAGES = 4;         // slices in the cp.async ring
constexpr int BROW = BN + 16;     // bytes of a staged buffer row (padded)
constexpr int TILE_THREADS = 256;

__device__ __forceinline__ void dmma(double* c, const double* a,
                                     const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// cp.async of `n` bytes, zero-filled to the copy's size where n < size
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}

// MT m-tiles (16 rows) per warp; WM x 2 warps tile the outputs; WK warps
// split each slice's K. WM * 2 * WK == 8.
template <int MT, int WM, int WK>
struct TileCfg {
  static constexpr int BM = 16 * MT * WM;
  // K depth of one staged slice: 16-row tiles take deeper slices, so each
  // K-splitting warp has two k16 steps between barriers
  static constexpr int KS = BM == 16 ? 128 : 64;
  static constexpr int XS_ROW = KS + 4;    // doubles of a staged x row
  static constexpr int XRAW = BM * KS * 2;           // bf16 x of a slice
  static constexpr int STAGE = XRAW + KS * BROW;     // + its bytes
  static constexpr int REGS = 2 * MT * 4 * 4;        // accumulator doubles
  static constexpr size_t LOOP_SMEM =
      (size_t)STAGES * STAGE + sizeof(double) * BM * XS_ROW;
  static constexpr size_t RED_SMEM =
      sizeof(double) * (WK - 1) * WM * 2 * REGS * 32;
  static constexpr size_t SMEM = LOOP_SMEM > RED_SMEM ? LOOP_SMEM : RED_SMEM;
  static_assert(WM * 2 * WK * 32 == TILE_THREADS, "8 warps");
};

template <int MT, int WM, int WK>
__global__ void __launch_bounds__(TILE_THREADS, 1)
dual_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ buf,
                const float* __restrict__ hs, const float* __restrict__ ls,
                __nv_bfloat16* __restrict__ y_hi,
                __nv_bfloat16* __restrict__ y_lo, double* __restrict__ part,
                int M, int K, int N, int per) {
  using C = TileCfg<MT, WM, WK>;
  extern __shared__ __align__(16) uint8_t smem[];
  double* xs = reinterpret_cast<double*>(smem + STAGES * C::STAGE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp / (WM * 2), w0 = warp % (WM * 2);
  const int wm = w0 / 2, wn = w0 % 2;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const int s_begin = blockIdx.z * per;
  const int nit = min(per, (K + C::KS - 1) / C::KS - s_begin);

  // slice s_begin + i into ring slot i % STAGES (rows past M and K zero)
  auto stage_slice = [&](int i) {
    if (i < nit) {
      uint8_t* st = smem + (i % STAGES) * C::STAGE;
      const int k0 = (s_begin + i) * C::KS;
      for (int j = tid; j < C::BM * C::KS / 2; j += TILE_THREADS) {
        const int r = j / (C::KS / 2), c = 2 * (j % (C::KS / 2));
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async4(st + 2 * (r * C::KS + c),
                  ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok ? 4 : 0);
      }
      for (int j = tid; j < C::KS * (BN / 16); j += TILE_THREADS) {
        const int r = j / (BN / 16), c = 16 * (j % (BN / 16));
        const bool ok = k0 + r < K;
        cp_async16(st + C::XRAW + r * BROW + c,
                   ok ? buf + (size_t)(k0 + r) * N + n0 + c : buf,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();   // an empty group keeps the count uniform
  };

  double acc[2][MT][4][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[p][mt][nt][r] = 0.0;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) stage_slice(i);
  for (int i = 0; i < nit; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();           // slice i landed; slice i - 1 is consumed
    const uint8_t* st = smem + (i % STAGES) * C::STAGE;
    // x to float64, once per tile
    for (int j = tid; j < C::BM * C::KS / 2; j += TILE_THREADS) {
      const int r = j / (C::KS / 2), c = 2 * (j % (C::KS / 2));
      const float2 f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(st)[j]);
      *reinterpret_cast<double2*>(xs + r * C::XS_ROW + c) =
          make_double2(f.x, f.y);
    }
    stage_slice(i + STAGES - 1);   // into the slot slice i - 1 used
    __syncthreads();
    const uint8_t* bsm = st + C::XRAW;
#pragma unroll
    for (int kk = 16 * wk; kk < C::KS; kk += 16 * WK) {
      double a[MT][8];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int v = 0; v < 8; ++v)
          a[mt][v] = xs[(wm * 16 * MT + mt * 16 + g + 8 * (v & 1))
                        * C::XS_ROW + kk + t + 4 * (v >> 1)];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* bp = bsm + (kk + t) * BROW + wn * 32 + nt * 8 + g;
        double bh[4], bl[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const unsigned b = bp[4 * v * BROW];
          bh[v] = plane_hi(b);
          bl[v] = plane_lo(b);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          dmma(acc[0][mt][nt], a[mt], bh);
          dmma(acc[1][mt][nt], a[mt], bl);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (WK > 1) {                // the K-splitting warps meet (exact sums)
    __syncthreads();
    double* red = reinterpret_cast<double*>(smem);
    for (int w = 1; w < WK; ++w) {
      double* rw = red + ((w - 1) * WM * 2 + w0) * C::REGS * 32 + lane;
      if (wk == w) {
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                rw[32 * (((p * MT + mt) * 4 + nt) * 4 + r)] =
                    acc[p][mt][nt][r];
      }
    }
    __syncthreads();
    if (wk == 0) {
      for (int w = 1; w < WK; ++w) {
        const double* rw = red + ((w - 1) * WM * 2 + w0) * C::REGS * 32
                           + lane;
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                acc[p][mt][nt][r] +=
                    rw[32 * (((p * MT + mt) * 4 + nt) * 4 + r)];
      }
    }
  }
  if (wk != 0) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 16 * MT + mt * 16 + g + 8 * h;
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (row >= M) continue;
        const size_t o = (size_t)row * N + col;
        const double h0 = acc[0][mt][nt][2 * h];
        const double h1 = acc[0][mt][nt][2 * h + 1];
        const double l0 = acc[1][mt][nt][2 * h];
        const double l1 = acc[1][mt][nt][2 * h + 1];
        if (part != nullptr) {
          const size_t plane = (size_t)M * N;
          double* pz = part + 2 * plane * blockIdx.z;
          *reinterpret_cast<double2*>(pz + o) = make_double2(h0, h1);
          *reinterpret_cast<double2*>(pz + plane + o) = make_double2(l0, l1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(y_hi + o) =
              scaled_pair(h0, h1, hs, col);
          *reinterpret_cast<__nv_bfloat162*>(y_lo + o) =
              scaled_pair(l0, l1, ls, col);
        }
      }
}

// the K-split partial sums (exact) added, scaled and rounded; a thread
// per pair of output columns
__global__ void dual_split_finish_kernel(const double* __restrict__ part,
                                         const float* __restrict__ hs,
                                         const float* __restrict__ ls,
                                         __nv_bfloat16* __restrict__ y_hi,
                                         __nv_bfloat16* __restrict__ y_lo,
                                         int M, int N, int ksplit) {
  const size_t plane = (size_t)M * N;
  const size_t o = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (o >= plane) return;
  const int col = (int)(o % N);
  double2 h = make_double2(0.0, 0.0), l = make_double2(0.0, 0.0);
  for (int z = 0; z < ksplit; ++z) {
    const double2 a = *reinterpret_cast<const double2*>(part + 2 * plane * z
                                                        + o);
    const double2 b = *reinterpret_cast<const double2*>(
        part + 2 * plane * z + plane + o);
    h.x += a.x;
    h.y += a.y;
    l.x += b.x;
    l.y += b.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(y_hi + o) = scaled_pair(h.x, h.y, hs,
                                                             col);
  *reinterpret_cast<__nv_bfloat162*>(y_lo + o) = scaled_pair(l.x, l.y, ls,
                                                             col);
}

template <int MT, int WM, int WK>
int launch_tiles(const void* x, const void* buf, const void* hs,
                 const void* ls, void* y_hi, void* y_lo, void* part, int M,
                 int K, int N, int ksplit, cudaStream_t s) {
  using C = TileCfg<MT, WM, WK>;
  auto kernel = dual_mma_kernel<MT, WM, WK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int slices = (K + C::KS - 1) / C::KS;
  const int per = (slices + ksplit - 1) / ksplit;
  dim3 grid(N / BN, (M + C::BM - 1) / C::BM, ksplit);
  kernel<<<grid, TILE_THREADS, C::SMEM, s>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)buf, (const float*)hs,
      (const float*)ls, (__nv_bfloat16*)y_hi, (__nv_bfloat16*)y_lo,
      ksplit > 1 ? (double*)part : nullptr, M, K, N, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const size_t pairs = (size_t)M * N / 2;
  dual_split_finish_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(
      (const double*)part, (const float*)hs, (const float*)ls,
      (__nv_bfloat16*)y_hi, (__nv_bfloat16*)y_lo, M, N, ksplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (4-byte aligned), buf (K, N) uint8 (16-byte aligned),
// hs / ls (N,) f32, y_hi / y_lo (M, N) bf16, all contiguous; K even and
// N % 64 == 0 (checked by the wrapper). ksplit: CTAs splitting K on the
// tile routes (M > 4), each taking cdiv(cdiv(K, KS), ksplit) slices;
// where it is > 1, part holds ksplit * 2 * M * N doubles of scratch
// (kernels/dual_plane_matmul.py's `k_split` picks it from the shapes).
extern "C" int dual_plane_matmul(const void* x, const void* buf,
                                 const void* hs, const void* ls, void* y_hi,
                                 void* y_lo, void* part, int M, int K, int N,
                                 int ksplit, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (M <= GV_ROWS) {
    dual_gemv_kernel<<<N / GV_COLS, GV_WARPS * 32, 0, s>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)buf, (const float*)hs,
        (const float*)ls, (__nv_bfloat16*)y_hi, (__nv_bfloat16*)y_lo, M, K,
        N);
    return (int)cudaGetLastError();
  }
  if (M <= 16)
    return launch_tiles<1, 1, 4>(x, buf, hs, ls, y_hi, y_lo, part, M, K, N,
                                 ksplit, s);
  return launch_tiles<2, 4, 1>(x, buf, hs, ls, y_hi, y_lo, part, M, K, N,
                               ksplit, s);
}
