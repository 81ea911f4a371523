// Contiguous packed-KV flash-decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/packed_kv_attention.py:packed_kv_attention_pallas
// (body _kv_attn_kernel): one query token per row, GQA with Hg query heads
// per KV head, over a head-major packed cache — int4 pairs
// (B, KV, S, D/2) uint8 (byte j holds lane 2j in its high nibble) or int8
// (B, KV, S, D) — with bf16 per-token scales (B, KV, S). The hybrid
// family's ring KV is such a cache; lengths run past S there and are
// clamped to S.
//
// Op order mirrors _kv_attn_kernel, one sequence block of bs tokens at a
// time: integer levels are taken as exact floats, the score is an f32 dot
// times k_scale * D^-1/2, columns at or past the row's length get -1e30,
// the online softmax (running max m, denominator l, accumulator acc) runs
// in f32 and is updated once per block, p * v_scale is rounded to bf16
// before the PV product, and the output is acc / l rounded to bf16. Only
// the cdiv(len, bs) blocks that hold a valid token are visited (at least
// one, so a row of length 0 still writes its output: the mean of its
// first block's V, as the TPU kernel gives); inside the last visited block
// the tokens past the length are not loaded, their p being exactly 0.
//
// Bound: bytes of the valid blocks. One CTA per (row, KV head) walks the
// row's blocks in order. A block's K and then its V are streamed through
// shared memory in tiles of up to 128 tokens (copied with 16-byte loads
// and kept packed: one 32-bit word is 8 int4 levels), since a 512-token
// block of K and V does not fit at once. Scores: each thread takes one
// token and up to 4 query heads of a tile, expanding each K word once for
// all of them. The block's scores stay in shared memory (Hg x bs floats);
// one warp per query head takes the block max, p and the bf16 p * v_scale
// in place. PV: each thread owns 8 consecutive outputs of one head (one
// V word per token), summing the block in token order before the
// online-softmax update acc = acc * alpha + pv.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 512;
constexpr int TILE_MAX = 128;        // tokens per shared-memory tile
constexpr int ROWS_PER_THREAD = 4;   // query heads per score thread

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 levels of one row starting at lane 8 * g: one 32-bit word of int4
// pairs, or two words of int8.
__device__ __forceinline__ void levels8(const uint32_t* row, int g,
                                        int kv_bits, float* out) {
  if (kv_bits == 4) {
    const uint32_t w = row[g];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t b = (int8_t)((w >> (8 * j)) & 0xffu);
      out[2 * j] = (float)(b >> 4);
      out[2 * j + 1] = (float)((int8_t)(b << 4) >> 4);
    }
  } else {
    const uint32_t w0 = row[2 * g], w1 = row[2 * g + 1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j] = (float)(int8_t)((w0 >> (8 * j)) & 0xffu);
      out[4 + j] = (float)(int8_t)((w1 >> (8 * j)) & 0xffu);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
packed_kv_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const uint8_t* __restrict__ k,
                           const uint8_t* __restrict__ v,
                           const __nv_bfloat16* __restrict__ ks,
                           const __nv_bfloat16* __restrict__ vs,
                           const int* __restrict__ lengths,
                           __nv_bfloat16* __restrict__ out,
                           int* __restrict__ visits, int KV, int Hg, int D,
                           int S, int bs, int kv_bits, int tile) {
  extern __shared__ float smem[];
  const int d_store = kv_bits == 4 ? D / 2 : D;
  const int row_words = d_store / 4 + 1;   // +1 word: no bank conflicts
  float* qs = smem;                        // Hg * D
  float* sc = qs + Hg * D;                 // Hg * bs: scores, then p*vs
  float* ksc = sc + Hg * bs;               // bs
  float* vsc = ksc + bs;                   // bs
  float* m_s = vsc + bs;                   // Hg
  float* l_s = m_s + Hg;                   // Hg
  float* a_s = l_s + Hg;                   // Hg: this block's alpha
  uint32_t* tl = reinterpret_cast<uint32_t*>(a_s + Hg);  // tile * row_words

  const int bh = blockIdx.x;
  const int b = bh / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)D));
  const int len = max(min(lengths[b], S), 0);
  const int nvb = max((len + bs - 1) / bs, 1);
  const size_t kv_base = (size_t)bh * S;   // first token row of (b, h)

  const __nv_bfloat16* qb = q + (size_t)bh * Hg * D;
  for (int i = tid; i < Hg * D; i += THREADS) qs[i] = __bfloat162float(qb[i]);
  for (int r = tid; r < Hg; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // PV ownership: head `pr`, lanes [8 * pg, 8 * pg + 8)
  const int groups = D / 8;
  const bool pv_own = tid < Hg * groups;
  const int pr = pv_own ? tid / groups : 0;
  const int pg = pv_own ? tid % groups : 0;
  float acc[8], pv_acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  // score ownership within a tile: token st, heads [4 * srg, 4 * srg + 4)
  const int n_rg = (Hg + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD;

  // copy tokens [t0, t0 + n) of plane `src` into the tile
  auto load_tile = [&](const uint8_t* src, int t0, int n) {
    const int vec_per_row = d_store / 16;
    const uint4* g = reinterpret_cast<const uint4*>(
        src + (kv_base + t0) * (size_t)d_store);
    for (int i = tid; i < n * vec_per_row; i += THREADS) {
      const uint4 raw = g[i];
      uint32_t* dst = tl + (i / vec_per_row) * row_words
                      + (i % vec_per_row) * 4;
      dst[0] = raw.x;
      dst[1] = raw.y;
      dst[2] = raw.z;
      dst[3] = raw.w;
    }
  };

  for (int blk = 0; blk < nvb; ++blk) {
    const int b0 = blk * bs;
    const int n_valid = min(max(len - b0, 0), bs);
    // a row of length 0 averages its first block's V (every p is 1)
    const int n_load = len == 0 ? bs : n_valid;
    __syncthreads();   // the previous block's scores and tile are consumed
    for (int t = tid; t < n_load; t += THREADS) {
      ksc[t] = __bfloat162float(ks[kv_base + b0 + t]);
      vsc[t] = __bfloat162float(vs[kv_base + b0 + t]);
    }
    // -- scores of the block, K streamed tile by tile
    for (int t0 = 0; t0 < n_valid; t0 += tile) {
      const int n = min(tile, n_valid - t0);
      __syncthreads();
      load_tile(k, b0 + t0, n);
      __syncthreads();
      for (int item = tid; item < n_rg * n; item += THREADS) {
        const int st = item % n, r0 = (item / n) * ROWS_PER_THREAD;
        const uint32_t* krow = tl + st * row_words;
        float s[ROWS_PER_THREAD] = {0.f, 0.f, 0.f, 0.f};
        for (int g = 0; g < groups; ++g) {
          float kl[8];
          levels8(krow, g, kv_bits, kl);
#pragma unroll
          for (int rr = 0; rr < ROWS_PER_THREAD; ++rr) {
            if (r0 + rr < Hg) {
              const float4* qv = reinterpret_cast<const float4*>(
                  qs + (r0 + rr) * D + 8 * g);
              const float4 a = qv[0], c = qv[1];
              float x = s[rr];
              x = fmaf(a.x, kl[0], x);
              x = fmaf(a.y, kl[1], x);
              x = fmaf(a.z, kl[2], x);
              x = fmaf(a.w, kl[3], x);
              x = fmaf(c.x, kl[4], x);
              x = fmaf(c.y, kl[5], x);
              x = fmaf(c.z, kl[6], x);
              x = fmaf(c.w, kl[7], x);
              s[rr] = x;
            }
          }
        }
        const float kscale = ksc[t0 + st] * inv_sqrt_d;
#pragma unroll
        for (int rr = 0; rr < ROWS_PER_THREAD; ++rr)
          if (r0 + rr < Hg) sc[(r0 + rr) * bs + t0 + st] = s[rr] * kscale;
      }
    }
    __syncthreads();
    // -- the block's online-softmax statistics, one warp per head; p and
    // then bf16(p * v_scale) replace the scores in place
    for (int r = warp; r < Hg; r += THREADS / 32) {
      float* sr = sc + r * bs;
      float mx = NEG_INF;
      for (int t = lane; t < n_valid; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = lane; t < n_load; t += 32) {
        const float p = expf((t < n_valid ? sr[t] : NEG_INF) - m_new);
        psum += p;
        sr[t] = bf16_round(p * vsc[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = fmaf(l_s[r], alpha, psum);
        m_s[r] = m_new;
      }
    }
    // -- PV of the block, V streamed tile by tile
#pragma unroll
    for (int j = 0; j < 8; ++j) pv_acc[j] = 0.f;
    for (int t0 = 0; t0 < n_load; t0 += tile) {
      const int n = min(tile, n_load - t0);
      __syncthreads();
      load_tile(v, b0 + t0, n);
      __syncthreads();
      if (pv_own) {
        const float* pr_row = sc + pr * bs + t0;
        for (int t = 0; t < n; ++t) {
          float vl[8];
          levels8(tl + t * row_words, pg, kv_bits, vl);
          const float p = pr_row[t];
#pragma unroll
          for (int j = 0; j < 8; ++j) pv_acc[j] = fmaf(p, vl[j], pv_acc[j]);
        }
      }
    }
    __syncthreads();   // a_s of this block is written
    if (pv_own) {
      const float alpha = a_s[pr];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(acc[j], alpha, pv_acc[j]);
    }
  }
  __syncthreads();
  if (pv_own) {
    const float l = l_s[pr];
    __nv_bfloat16* ob = out + ((size_t)bh * Hg + pr) * D + 8 * pg;
#pragma unroll
    for (int j = 0; j < 8; ++j) ob[j] = __float2bfloat16_rn(acc[j] / l);
  }
  if (visits != nullptr && tid == 0) visits[bh] = nvb;
}

size_t shared_bytes(int Hg, int D, int bs, int kv_bits, int tile) {
  const int d_store = kv_bits == 4 ? D / 2 : D;
  return sizeof(float) * ((size_t)Hg * D + (size_t)Hg * bs + 2 * (size_t)bs
                          + 3 * (size_t)Hg)
         + sizeof(uint32_t) * (size_t)tile * (d_store / 4 + 1);
}

}  // namespace

// q (B, KV, Hg, D) bf16; k/v (B, KV, S, D/2) uint8 (kv_bits 4) or
// (B, KV, S, D) int8 (kv_bits 8); ks/vs (B, KV, S) bf16; lengths (B,)
// int32 (clamped to [0, S] here); out (B, KV, Hg, D) bf16; visits (B, KV)
// int32 or null. The wrapper checks shapes, dtypes, contiguity,
// S % bs == 0, D % 32 == 0, Hg * D <= 8 * 512 and the shared memory
// (`shared_bytes`, mirrored by kernels/packed_kv_attention.py).
extern "C" int packed_kv_attention(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* lengths,
                                   void* out, void* visits, int B, int KV,
                                   int Hg, int D, int S, int bs, int kv_bits,
                                   void* stream) {
  const int tile = bs < TILE_MAX ? bs : TILE_MAX;
  const size_t shm = shared_bytes(Hg, D, bs, kv_bits, tile);
  cudaError_t err = cudaFuncSetAttribute(
      packed_kv_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  if (B * KV == 0) return (int)cudaGetLastError();
  packed_kv_attention_kernel<<<B * KV, THREADS, shm, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k, (const uint8_t*)v,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
      (const int*)lengths, (__nv_bfloat16*)out, (int*)visits, KV, Hg, D, S,
      bs, kv_bits, tile);
  return (int)cudaGetLastError();
}

