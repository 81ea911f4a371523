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
// depend on the order it is taken in, so the kernel equals its plain
// version (a float64 matmul) bit for bit on the card, and a row's result
// does not depend on M (decode M = 4, verify M = 16, prefill M = 128).
// Why exact: f32 sums taken in another order than the plain version's
// (tensor-core tiles) move ~0.3% of the bf16 outputs by an ulp; granite's
// int4 KV cache turns such ulps into level flips, and its first prefill
// chunk's logits then miss the plain route's by rel_err 0.094 (measured
// on an NVIDIA H100, 700 W), past the 0.05 the port holds them to.
//
// Bound: at decode / verify (M <= 16) the K*N buffer bytes; at prefill
// (M = batch * chunk) the multiply-adds, here on the float64 CUDA cores
// (half the float32 rate; a tensor-core float64 version is later work).
// One block per 64 output columns (two per lane, so a warp reads 64
// consecutive bytes of a K row) and up to 16 rows of x, which it stages
// as float64 in shared memory 256 columns of K at a time (each value
// converted once per block, read by broadcast); its warps split K row by
// row, and their partial sums meet in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the int4 levels as exact doubles: 2^52 + (v + 8) has v + 8 in its low
// word, so one integer add and one double subtraction replace the slow
// int-to-double conversion
__device__ __forceinline__ double level(int v) {
  return __hiloint2double(0x43300000, v + 8) - 4503599627370504.0;
}

__device__ __forceinline__ double plane_hi(unsigned b) {
  return level((int)(int8_t)b >> 4);
}

__device__ __forceinline__ double plane_lo(unsigned b) {
  return level((int)(int8_t)(b << 4) >> 4);
}

constexpr int GV_COLS = 64;       // two columns per lane
constexpr int GV_ROWS = 16;       // rows of x a block takes at most
constexpr int KC = 256;           // K columns of x staged per round

// MT rows of x per block; WARPS split K (more warps keep more of the
// buffer in flight where few rows leave registers to spare)
template <int MT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
dual_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ buf,
                 const float* __restrict__ hs, const float* __restrict__ ls,
                 __nv_bfloat16* __restrict__ y_hi,
                 __nv_bfloat16* __restrict__ y_lo, int M, int K, int N) {
  __shared__ double xs[MT][KC];
  __shared__ double red[WARPS][4][32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * GV_COLS;
  const int n = n0 + 2 * lane;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
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
              x + (size_t)(m0 + r) * K + k0 + c));
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
      const size_t o = (size_t)(m0 + m) * N + col;
      if (j < 2)
        y_hi[o] = __float2bfloat16_rn((float)s * hs[col]);
      else
        y_lo[o] = __float2bfloat16_rn((float)s * ls[col]);
    }
    __syncthreads();
  }
}

template <int MT, int WARPS>
void launch_gemv(const void* x, const void* buf, const void* hs,
                 const void* ls, void* y_hi, void* y_lo, int M, int K, int N,
                 cudaStream_t s) {
  dim3 grid(N / GV_COLS, (M + MT - 1) / MT);
  dual_gemv_kernel<MT, WARPS><<<grid, WARPS * 32, 0, s>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)buf, (const float*)hs,
      (const float*)ls, (__nv_bfloat16*)y_hi, (__nv_bfloat16*)y_lo, M, K, N);
}

}  // namespace

// x (M, K) bf16 (4-byte aligned), buf (K, N) uint8, hs / ls (N,) f32,
// y_hi / y_lo (M, N) bf16, all contiguous; K even and N % 64 == 0
// (checked by the wrapper).
extern "C" int dual_plane_matmul(const void* x, const void* buf,
                                 const void* hs, const void* ls, void* y_hi,
                                 void* y_lo, int M, int K, int N,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (M <= 4)
    launch_gemv<4, 16>(x, buf, hs, ls, y_hi, y_lo, M, K, N, s);
  else if (M <= 8)
    launch_gemv<8, 8>(x, buf, hs, ls, y_hi, y_lo, M, K, N, s);
  else
    launch_gemv<GV_ROWS, 8>(x, buf, hs, ls, y_hi, y_lo, M, K, N, s);
  return (int)cudaGetLastError();
}
