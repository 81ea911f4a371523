// Fused int4 quantize-and-pack of KV rows for Hopper (sm_90a).
//
// Replaces repro/kernels/quantize_pack_kv.py:quantize_pack_kv_pallas: the
// plain body _qpack_kernel, with a `valid` row mask the masked body
// _qpack_masked_kernel, and with a `words` output the fused-integrity body
// _qpack_integrity_kernel. Per row of D bf16 values:
//   scale = bf16(max(amax, bf16(1e-8)) / 7)
//   q     = clip(rint(bf16(x / scale)), -7, 7)      (rint: half to even)
//   byte j = (q[2j] & 15) << 4 | (q[2j+1] & 15)     (even lane high nibble)
// A row whose valid[row] == 0 (a draft token the speculative verify
// rejected) is written as zero bytes and a scale of exactly 1.0. The
// integrity word of a row is sum_j (j + 1) * byte_j mod 2^32 over its D/2
// packed bytes (core.faults.integrity_word of the row), a warp sum of
// uint32 products: wrap-around addition is exact in any order.
// Bit-exact with the JAX package, whose bf16 arithmetic rounds to bf16
// after each op: both roundings are spelled out below. IEEE division is
// required, so this file must not be built with -use_fast_math.
//
// Bound: bytes (read D*2, write D/2 + 4 per row). One warp per row: the
// row is read once with neighbouring lanes on neighbouring values, amax is
// a warp shuffle reduction, and the packed bytes go straight out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int quant_level(float v, float s) {
  const float y = bf16_round(v / s);
  return (int)fminf(fmaxf(rintf(y), -7.f), 7.f);
}

// WORDS: also write each row's integrity word (the unmasked pack only)
template <bool WORDS>
__global__ void __launch_bounds__(WARPS * 32)
quantize_pack_kv_kernel(const __nv_bfloat16* __restrict__ x,
                        const int* __restrict__ valid,
                        uint8_t* __restrict__ packed,
                        float* __restrict__ scale,
                        int64_t* __restrict__ words, int N, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  uint8_t* pr = packed + (size_t)row * (D / 2);
  if (valid != nullptr && valid[row] == 0) {
    for (int j = lane; j < D / 2; j += 32) pr[j] = 0;
    if (lane == 0) scale[row] = 1.0f;
    return;
  }
  const __nv_bfloat16* xr = x + (size_t)row * D;
  float amax = 0.f;
  for (int j = lane; j < D; j += 32)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[j])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float eps = bf16_round(1e-8f);
  const float s = bf16_round(fmaxf(amax, eps) / 7.0f);
  uint32_t word = 0u;
  for (int j = lane; j < D / 2; j += 32) {
    const int hi = quant_level(__bfloat162float(xr[2 * j]), s);
    const int lo = quant_level(__bfloat162float(xr[2 * j + 1]), s);
    const uint8_t byte = (uint8_t)(((hi & 15) << 4) | (lo & 15));
    pr[j] = byte;
    if (WORDS) word += (uint32_t)(j + 1) * (uint32_t)byte;
  }
  if (lane == 0) scale[row] = s;
  if (WORDS) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      word += __shfl_xor_sync(0xffffffffu, word, off);
    if (lane == 0) words[row] = (int64_t)word;
  }
}

int launch(const void* x, const void* valid, void* packed, void* scale,
           void* words, int N, int D, void* stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  if (blocks > 0) {
    const dim3 grid(blocks), block(WARPS * 32);
    const cudaStream_t st = (cudaStream_t)stream;
    if (words != nullptr)
      quantize_pack_kv_kernel<true><<<grid, block, 0, st>>>(
          (const __nv_bfloat16*)x, (const int*)valid, (uint8_t*)packed,
          (float*)scale, (int64_t*)words, N, D);
    else
      quantize_pack_kv_kernel<false><<<grid, block, 0, st>>>(
          (const __nv_bfloat16*)x, (const int*)valid, (uint8_t*)packed,
          (float*)scale, nullptr, N, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, D) bf16 contiguous, D even; packed (N, D/2) uint8; scale (N,) f32.
extern "C" int quantize_pack_kv(const void* x, void* packed, void* scale,
                                int N, int D, void* stream) {
  return launch(x, nullptr, packed, scale, nullptr, N, D, stream);
}

// The same with valid (N,) int32: rows with valid == 0 -> 0 bytes, scale 1.
extern "C" int quantize_pack_kv_masked(const void* x, const void* valid,
                                       void* packed, void* scale, int N,
                                       int D, void* stream) {
  return launch(x, valid, packed, scale, nullptr, N, D, stream);
}

// The unmasked pack plus words (N,) int64, the integrity word of each
// packed row (a uint32 value).
extern "C" int quantize_pack_kv_integrity(const void* x, void* packed,
                                          void* scale, void* words, int N,
                                          int D, void* stream) {
  return launch(x, nullptr, packed, scale, words, N, D, stream);
}
