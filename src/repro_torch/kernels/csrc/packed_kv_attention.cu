// Contiguous packed-KV flash-decode attention for Hopper (sm_90a):
// split-sequence flash decoding on the tensor cores.
//
// Replaces repro/kernels/packed_kv_attention.py:packed_kv_attention_pallas
// (body _kv_attn_kernel): one query token per row, GQA with Hg query heads
// per KV head, over a head-major packed cache — int4 pairs
// (B, KV, S, D/2) uint8 (byte j holds lane 2j in its high nibble) or int8
// (B, KV, S, D) — with bf16 per-token scales (B, KV, S). The hybrid
// family's ring KV is such a cache; lengths run past S there and are
// clamped to S.
//
// Rounding points of _kv_attn_kernel: integer levels are exact in bf16;
// the score is an f32 dot (q bf16 x levels bf16) times k_scale * D^-1/2;
// columns at or past the row's length get -1e30; the softmax runs in f32;
// p * v_scale is rounded to bf16 before the PV product; the output is
// acc / l rounded to bf16. A row of length 0 reads its first bs-block and
// gives that block's mean V, as the TPU kernel does. Tokens past a row's
// length are never loaded.
//
// Bound: bytes of the valid tokens' packed K, V and scales (recurrentgemma-
// 9b, B=4, MQA, S=2048, D=256 int4: 2.1 MB at a full ring). The TPU
// kernel walks a row's blocks in order on one core; one CTA per (row, KV
// head) did the same here and used 4 of 132 SMs. Design:
//  * the sequence is split across CTAs: grid (B * KV, cdiv(S, 64)), one
//    64-token chunk a CTA; a CTA whose chunk starts at or past the row's
//    length (its first bs-block for length 0) exits at once. The grid
//    comes from shapes alone, so the call stays free of host syncs and
//    capturable in a CUDA graph;
//  * the chunk's packed K and V rows are streamed into shared memory with
//    16-byte cp.async copies (K and V in two groups: the scores start when
//    K has landed) and expanded from there into the MMA fragments, so each
//    packed byte is read from device memory once;
//  * both products run on mma.sync.m16n8k16 (bf16 in, f32 sums): the Hg
//    query heads are the instruction's 16 rows (fewer are zero-padded and
//    never written out). QK^T: each of 4 warps takes 16 tokens over all
//    of D; PV: each warp takes D/4 output lanes over the chunk's tokens.
//    wgmma needs 64 rows and would gain nothing at 16 heads;
//  * each CTA writes its partial (m, l, acc[Hg x D] f32) to scratch, with
//    p * v_scale rounded to bf16 against the chunk's own max; a second
//    kernel, one CTA per (row, KV head, query head), merges the chunks:
//    m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
//    out = bf16(acc / l), and counts the bs-blocks whose tokens were read.
//    The fragment helpers and the merge's body are csrc/flash_decode.cuh's,
//    shared with paged_kv_attention.cu.
// Scratch: (B * KV * cdiv(S, 64)) x (Hg * D * 4 + Hg * 8 + 8) bytes, 2.1 MB
// at recurrentgemma's B=4 S=2048 Hg=16 D=256; it is written by the chunk
// kernel and read by the merge for the participating chunks only.
#include "flash_decode.cuh"

namespace {

// tokens of the chunk starting at c0 that are read: the valid ones, or
// for a row of length 0 those of its first bs-block
__device__ __forceinline__ int chunk_tokens(int len, int bs, int c0) {
  return min(max((len > 0 ? len : bs) - c0, 0), CHUNK);
}

// after the partial records: [BH][NC] the first and last bs-block read
__host__ __device__ inline int2* blocks_of(const Parts& p, int BH, int NC,
                                           int Hg) {
  return reinterpret_cast<int2*>(p.ml + (size_t)BH * NC * Hg);
}

template <int KV_BITS>
__global__ void __launch_bounds__(THREADS)
packed_attn_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                         const uint8_t* __restrict__ k,
                         const uint8_t* __restrict__ v,
                         const __nv_bfloat16* __restrict__ ks,
                         const __nv_bfloat16* __restrict__ vs,
                         const int* __restrict__ lengths, Parts parts,
                         int2* __restrict__ blk, int KV, int Hg, int D,
                         int S, int bs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bh = blockIdx.x, c = blockIdx.y, NC = gridDim.y;
  const int len = max(min(lengths[bh / KV], S), 0);
  const int c0 = c * CHUNK;
  const int n_load = chunk_tokens(len, bs, c0);
  if (n_load == 0) return;
  const int n_valid = min(max(len - c0, 0), CHUNK);
  const int d_store = KV_BITS == 4 ? D / 2 : D;
  const int kv_row = d_store + ROW_PAD;
  const int q_row = D + Q_PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* kt = smem + 2 * MROWS * q_row;
  uint8_t* vt = kt + CHUNK * kv_row;
  float* ksc = reinterpret_cast<float*>(vt + CHUNK * kv_row);
  float* vsc = ksc + CHUNK;
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(vsc + CHUNK);
  float* red_m = reinterpret_cast<float*>(ps + MROWS * P_ROW);
  float* red_l = red_m + WARPS * MROWS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)bh * S + c0;   // the chunk's first token

  // -- the chunk's packed K, then V, into shared memory (two groups)
  const int vec = d_store / 16;
  for (int i = tid; i < n_load * vec; i += THREADS) {
    const int r = i / vec, j = i % vec;
    cp_async16(kt + r * kv_row + 16 * j, k + (row0 + r) * d_store + 16 * j);
  }
  cp_async_commit();
  for (int i = tid; i < n_load * vec; i += THREADS) {
    const int r = i / vec, j = i % vec;
    cp_async16(vt + r * kv_row + 16 * j, v + (row0 + r) * d_store + 16 * j);
  }
  cp_async_commit();
  // q as the A operand's 16 rows (rows >= Hg zero), and the scales
  const uint32_t* qb = reinterpret_cast<const uint32_t*>(
      q + (size_t)bh * Hg * D);
  for (int i = tid; i < MROWS * D / 2; i += THREADS) {
    const int r = i / (D / 2), d2 = i % (D / 2);
    reinterpret_cast<uint32_t*>(qs + r * q_row)[d2] =
        r < Hg ? qb[r * (D / 2) + d2] : 0u;
  }
  for (int i = tid; i < n_load; i += THREADS) {
    ksc[i] = __bfloat162float(ks[row0 + i]);
    vsc[i] = __bfloat162float(vs[row0 + i]);
  }
  cp_async_wait<1>();
  __syncthreads();

  // -- scores: warp w takes tokens [16w, 16w + 16) (two n-tiles) over D
  float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  if (16 * warp < n_valid) {
    const uint8_t* kr0 = kt + (16 * warp + g) * kv_row;
    const uint8_t* kr1 = kr0 + 8 * kv_row;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t a[4];
      a_frag(qs, q_row, g, k0, t, a);
      uint32_t b[2][2];
      if (KV_BITS == 4) {        // lanes k0 + 2t, +1: byte k0/2 + t
        b[0][0] = pair_int4(kr0[k0 / 2 + t]);
        b[0][1] = pair_int4(kr0[k0 / 2 + 4 + t]);
        b[1][0] = pair_int4(kr1[k0 / 2 + t]);
        b[1][1] = pair_int4(kr1[k0 / 2 + 4 + t]);
      } else {
        b[0][0] = pack_bf16(level<8>(kr0, k0 + 2 * t),
                            level<8>(kr0, k0 + 2 * t + 1));
        b[0][1] = pack_bf16(level<8>(kr0, k0 + 8 + 2 * t),
                            level<8>(kr0, k0 + 9 + 2 * t));
        b[1][0] = pack_bf16(level<8>(kr1, k0 + 2 * t),
                            level<8>(kr1, k0 + 2 * t + 1));
        b[1][1] = pack_bf16(level<8>(kr1, k0 + 8 + 2 * t),
                            level<8>(kr1, k0 + 9 + 2 * t));
      }
      mma_bf16(sacc[0], a, b[0][0], b[0][1]);
      mma_bf16(sacc[1], a, b[1][0], b[1][1]);
    }
  }
  // -- scale, mask, the chunk's max per head (rows g and g + 8)
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)D));
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tok = 16 * warp + 8 * j + 2 * t + e;
      const bool ok = tok < n_valid;
      const float kscale = ok ? ksc[tok] * inv_sqrt_d : 0.f;
      sacc[j][e] = ok ? sacc[j][e] * kscale : NEG_INF;
      sacc[j][2 + e] = ok ? sacc[j][2 + e] * kscale : NEG_INF;
      mx[0] = fmaxf(mx[0], sacc[j][e]);
      mx[1] = fmaxf(mx[1], sacc[j][2 + e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  if (t == 0) {
    red_m[warp * MROWS + g] = mx[0];
    red_m[warp * MROWS + g + 8] = mx[1];
  }
  __syncthreads();
  float m[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    m[0] = fmaxf(m[0], red_m[w * MROWS + g]);
    m[1] = fmaxf(m[1], red_m[w * MROWS + g + 8]);
  }
  // -- p, the denominators, and bf16(p * v_scale) into shared memory
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tok = 16 * warp + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = tok + e < n_load;
        const float p = in ? expf(sacc[j][2 * h + e] - m[h]) : 0.f;
        lsum[h] += p;
        pv[e] = in ? p * vsc[tok + e] : 0.f;
      }
      *reinterpret_cast<uint32_t*>(ps + (g + 8 * h) * P_ROW + tok) =
          pack_bf16(pv[0], pv[1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  if (t == 0) {
    red_l[warp * MROWS + g] = lsum[0];
    red_l[warp * MROWS + g + 8] = lsum[1];
  }
  cp_async_wait<0>();
  __syncthreads();

  // -- PV: warp w takes output lanes [w * D/4, (w + 1) * D/4)
  const int nt = D / 32;
  const int dw = warp * (D / 4);
  float oacc[MAX_NT][4];
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  for (int t0 = 0; t0 < n_load; t0 += 16) {
    uint32_t a[4];
    a_frag(ps, P_ROW, g, t0, t, a);
    const uint8_t* v0 = vt + (t0 + 2 * t) * kv_row;   // tokens of b0
    const uint8_t* v2 = v0 + 8 * kv_row;              // tokens of b1
#pragma unroll
    for (int j = 0; j < MAX_NT; ++j) {
      if (j < nt) {
        const int d = dw + 8 * j + g;
        const uint32_t b0 = pack_bf16(level<KV_BITS>(v0, d),
                                      level<KV_BITS>(v0 + kv_row, d));
        const uint32_t b1 = pack_bf16(level<KV_BITS>(v2, d),
                                      level<KV_BITS>(v2 + kv_row, d));
        mma_bf16(oacc[j], a, b0, b1);
      }
    }
  }
  // -- the chunk's partial record
  const size_t rec = (size_t)bh * NC + c;
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j) {
    if (j < nt) {
      const int d = dw + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r < Hg)
          *reinterpret_cast<float2*>(parts.acc + (rec * Hg + r) * D + d) =
              make_float2(oacc[j][2 * h], oacc[j][2 * h + 1]);
      }
    }
  }
  if (warp == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r < Hg) {
        float l = 0.f;
        for (int w = 0; w < WARPS; ++w) l += red_l[w * MROWS + r];
        parts.ml[rec * Hg + r] = make_float2(m[h], l);
      }
    }
  }
  if (tid == 0)
    blk[rec] = make_int2(c0 / bs, (c0 + n_load - 1) / bs);
}

// one CTA per (row, KV head, query head), one thread per output lane
// (`merge_row`); the first thread of a row's head 0 counts its visits.
__global__ void __launch_bounds__(MAX_D)
packed_attn_merge_kernel(const int* __restrict__ lengths, Parts parts,
                         const int2* __restrict__ blk,
                         __nv_bfloat16* __restrict__ out,
                         int* __restrict__ visits, int KV, int Hg, int D,
                         int S, int bs, int NC) {
  const int bh = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int len = max(min(lengths[bh / KV], S), 0);
  const int end = len > 0 ? len : bs;
  const int nch = min((end + CHUNK - 1) / CHUNK, NC);
  const size_t rec0 = (size_t)bh * NC * Hg + r;   // chunk 0's record
  out[((size_t)bh * Hg + r) * D + d] = __float2bfloat16_rn(
      merge_row(parts.ml + rec0, parts.acc + rec0 * D + d, Hg, nch, D, d));
  if (visits != nullptr && r == 0 && d == 0) {
    // the distinct bs-blocks the chunks read (chunks are in token order)
    int n = 0, last = -1;
    for (int c = 0; c < nch; ++c) {
      const int2 b = blk[(size_t)bh * NC + c];
      const int lo = max(b.x, last + 1);
      if (b.y >= lo) {
        n += b.y - lo + 1;
        last = b.y;
      }
    }
    visits[bh] = n;
  }
}

size_t shared_bytes(int D, int kv_bits) {
  const int d_store = kv_bits == 4 ? D / 2 : D;
  return 2 * (size_t)MROWS * (D + Q_PAD) + 2 * (size_t)CHUNK * (d_store
         + ROW_PAD) + 2 * sizeof(float) * CHUNK + 2 * (size_t)MROWS * P_ROW
         + 2 * sizeof(float) * WARPS * MROWS;
}

template <int KV_BITS>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const int* lens, Parts parts, int2* blk,
           void* out, void* visits, int B, int KV, int Hg, int D, int S, int bs,
           cudaStream_t stream) {
  const size_t shm = shared_bytes(D, KV_BITS);
  cudaError_t err = cudaFuncSetAttribute(
      packed_attn_chunk_kernel<KV_BITS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  const int NC = (S + CHUNK - 1) / CHUNK;
  packed_attn_chunk_kernel<KV_BITS><<<dim3(B * KV, NC), THREADS, shm,
                                      stream>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k, (const uint8_t*)v,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, lens, parts, blk,
      KV, Hg, D, S, bs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  packed_attn_merge_kernel<<<dim3(B * KV, Hg), D, 0, stream>>>(
      lens, parts, blk, (__nv_bfloat16*)out, (int*)visits, KV, Hg, D, S, bs,
      NC);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, KV, Hg, D) bf16; k/v (B, KV, S, D/2) uint8 (kv_bits 4) or
// (B, KV, S, D) int8 (kv_bits 8), 16-byte aligned; ks/vs (B, KV, S) bf16;
// lengths (B,) int32 (clamped to [0, S] here); out (B, KV, Hg, D) bf16;
// visits (B, KV) int32 or null; scratch of B * KV * cdiv(S, 64) *
// (Hg * D * 4 + Hg * 8 + 8) bytes, 16-byte aligned. The wrapper checks
// shapes, dtypes, contiguity, S % bs == 0, 1 <= Hg <= 16, D % 32 == 0,
// D <= 256 (kernels/packed_kv_attention.py mirrors `shared_bytes` and the
// scratch size).
extern "C" int packed_kv_attention(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* lengths,
                                   void* out, void* visits, void* scratch,
                                   int B, int KV, int Hg, int D, int S,
                                   int bs, int kv_bits, void* stream) {
  if (B * KV == 0) return (int)cudaGetLastError();
  const int NC = (S + CHUNK - 1) / CHUNK;
  const Parts parts = parts_of(scratch, B * KV, NC, Hg, D);
  int2* blk = blocks_of(parts, B * KV, NC, Hg);
  const cudaStream_t s = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  return kv_bits == 4
      ? launch<4>(q, k, v, ks, vs, lens, parts, blk, out, visits, B, KV, Hg,
                  D, S, bs, s)
      : launch<8>(q, k, v, ks, vs, lens, parts, blk, out, visits, B, KV, Hg,
                  D, S, bs, s);
}
