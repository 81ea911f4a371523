// Pieces shared by the two split flash-decode kernels for Hopper (sm_90a):
// csrc/packed_kv_attention.cu (a contiguous packed cache) and
// csrc/paged_kv_attention.cu (the paged two-plane pool). Both cut a row's
// tokens into chunks of at most CHUNK, one CTA of WARPS warps each; both
// run QK^T and PV on mma.sync.m16n8k16 (bf16 in, f32 sums) with up to
// MROWS query rows a tile, stage a chunk's K / V rows, q and
// bf16(p * v_scale) in shared memory, and write a partial (max,
// denominator, accumulator) per row and chunk to scratch; `merge_row`
// combines a row's chunks in increasing chunk order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int CHUNK = 64;          // tokens of one CTA, at most
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MROWS = 16;          // the MMA's m: query rows, zero-padded
constexpr int MAX_NT = 8;          // PV n-tiles a warp owns
constexpr int MAX_D = 32 * MAX_NT; // output lanes: D <= 256
constexpr int ROW_PAD = 16;        // bytes after each shared K / V row
constexpr int Q_PAD = 8;           // bf16 after each shared q row
constexpr int P_ROW = CHUNK + 8;   // bf16 of one shared p * v_scale row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// lanes (2j, 2j + 1) of an int4-pair byte: high nibble, then low
__device__ __forceinline__ uint32_t pair_int4(uint32_t b) {
  return pack_bf16((float)((int)(int8_t)b >> 4),
                   (float)((int)(int8_t)(b << 4) >> 4));
}

// lane d of a token row of levels
template <int KV_BITS>
__device__ __forceinline__ float level(const uint8_t* row, int d) {
  if (KV_BITS == 4) {
    const int b = (int)(int8_t)row[d >> 1];
    return (float)((d & 1) ? ((int)(int8_t)(b << 4) >> 4) : (b >> 4));
  }
  return (float)(int8_t)row[d];
}

// the A fragment of rows r0 (g) and r0 + 8 at columns c0 + 2t, c0 + 8 + 2t
__device__ __forceinline__ void a_frag(const __nv_bfloat16* base, int stride,
                                       int r0, int c0, int t, uint32_t* a) {
  const __nv_bfloat16* p0 = base + r0 * stride + c0 + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * stride;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// the partial records of chunk c of (row, KV head) bh, R query rows each
struct Parts {
  float* acc;      // [BH][NC][R][D]
  float2* ml;      // [BH][NC][R]: (chunk max, chunk denominator)
};

__host__ __device__ inline Parts parts_of(void* scratch, int BH, int NC,
                                          int R, int D) {
  Parts p;
  p.acc = reinterpret_cast<float*>(scratch);
  p.ml = reinterpret_cast<float2*>(p.acc + (size_t)BH * NC * R * D);
  return p;
}

// The merge of one query row, called by a CTA of D threads (thread d holds
// output lane d) with the row's records of chunk 0: ml (its (max,
// denominator)) and pa (its accumulator at lane d); a chunk's records are
// `stride` rows past the previous one's. Takes chunks [0, nch): m = max
// m_i, l and acc summed in chunk order by fmaf with weights e^(m_i - m),
// taken a block of them at a time into shared memory so that each
// thread's accumulator loads are independent and stay in flight together.
// Returns acc / l.
__device__ __forceinline__ float merge_row(const float2* ml, const float* pa,
                                           int stride, int nch, int D,
                                           int d) {
  __shared__ float w_s[MAX_D], l_s[MAX_D], red[MAX_D / 32];
  // the row's max over its chunks
  float m = NEG_INF;
  for (int c = d; c < nch; c += D) m = fmaxf(m, ml[(size_t)c * stride].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((d & 31) == 0) red[d >> 5] = m;
  __syncthreads();
  m = NEG_INF;
  for (int w = 0; w < D / 32; ++w) m = fmaxf(m, red[w]);
  float l = 0.f, acc = 0.f;
  for (int c0 = 0; c0 < nch; c0 += D) {
    const int n = min(D, nch - c0);
    __syncthreads();           // the previous block's weights are read
    if (d < n) {
      const float2 e = ml[(size_t)(c0 + d) * stride];
      w_s[d] = expf(e.x - m);
      l_s[d] = e.y;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      l = fmaf(l_s[i], w_s[i], l);
      acc = fmaf(pa[(size_t)(c0 + i) * stride * D], w_s[i], acc);
    }
  }
  return acc / l;
}

}  // namespace
