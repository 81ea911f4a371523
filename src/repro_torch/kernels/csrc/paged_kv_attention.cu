// Paged two-plane flash-decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_kv_attention.py:paged_kv_attention_pallas
// (body _paged_kernel). One query token per row, GQA with Hg query heads
// per KV head, over a pool of fixed-size pages that each live in one of two
// planes: Normal (bf16 kn/vn (Nn, KV, page, D)) or Augmented (int4 pairs
// (Np, KV, page, D/2) uint8 or int8 (Np, KV, page, D), with bf16 per-token
// scales ks/vs (Np, KV, page)). page_table/page_modes (B, maxP) give each
// logical page's physical index and plane.
//
// Op order mirrors _paged_kernel: integer levels are taken as exact floats
// (the bf16 cast of the TPU kernel), the score is an f32 dot times
// k_scale * D^-1/2, invalid columns get -1e30, the online softmax runs in
// f32, and p * v_scale is rounded to bf16 before the PV product. Lengths
// are clamped to maxP * page; pages at or past cdiv(len, page) are skipped.
//
// Bound: bytes of the pages a row actually holds. One CTA per (row, KV
// head) walks that row's pages in order (never split across CTAs, so the
// speculative window kernel can later walk them the same way). Up to four
// pages at a time are read once into shared memory with independent
// 16-byte loads (a page's K or V block is contiguous in either plane), so
// one barrier round serves four pages; one warp computes each
// (head, token) score;
// each thread that owns one (head, lane) of the output keeps its
// accumulator and the running max / denominator in registers and applies
// the online-softmax update page by page, in _paged_kernel's order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int PPI_MAX = 4;   // pages loaded per iteration, at most

// 16 stored bytes of an Augmented page as integer levels: 16 int8 values,
// or 32 int4 values (byte j holds lane 2j in its high nibble, 2j+1 low).
__device__ __forceinline__ void expand_levels(uint4 raw, float* dst,
                                              int kv_bits) {
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int8_t b = (int8_t)bytes[j];
    if (kv_bits == 8) {
      dst[j] = (float)b;
    } else {
      dst[2 * j] = (float)(b >> 4);
      dst[2 * j + 1] = (float)((int8_t)(b << 4) >> 4);
    }
  }
}

// 8 bf16 values of a Normal page.
__device__ __forceinline__ void expand_bf16(uint4 raw, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

__global__ void paged_kv_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kn,
    const __nv_bfloat16* __restrict__ vn, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ vp, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ lengths,
    const int* __restrict__ table, const int* __restrict__ modes,
    __nv_bfloat16* __restrict__ out, int KV, int Hg, int D, int page,
    int maxP, int kv_bits, int ppi) {
  extern __shared__ float smem[];
  __shared__ size_t s_base[PPI_MAX];  // first token row of each page
  __shared__ int s_aug[PPI_MAX];      // its plane
  const int span = ppi * page;        // tokens loaded per iteration
  float* qs = smem;                   // Hg * D
  float* kt = qs + Hg * D;            // span * D
  float* vt = kt + span * D;          // span * D
  float* ksc = vt + span * D;         // span
  float* vsc = ksc + span;            // span
  float* S = vsc + span;              // Hg * span

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const int d_store = kv_bits == 4 ? D / 2 : D;
  // D^-1/2 rounded once from double, as the JAX constant 1.0 / D ** 0.5
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)D));

  const int len = min(lengths[b], maxP * page);
  const int nvp = max((len + page - 1) / page, 1);

  const __nv_bfloat16* qb = q + (size_t)(b * KV + h) * Hg * D;
  for (int i = tid; i < Hg * D; i += blockDim.x) qs[i] = __bfloat162float(qb[i]);

  const bool owner = tid < Hg * D;
  const int hg = owner ? tid / D : 0;
  const int d = owner ? tid % D : 0;
  float acc = 0.f, m = NEG_INF, l = 0.f;

  for (int p0 = 0; p0 < nvp; p0 += ppi) {
    const int np = min(ppi, nvp - p0);
    __syncthreads();   // the previous iteration's tiles are no longer read
    if (tid < np) {    // where each page of this iteration lives
      const int lp = p0 + tid;
      s_base[tid] = ((size_t)table[b * maxP + lp] * KV + h) * page;
      s_aug[tid] = modes[b * maxP + lp] == 1;
    }
    __syncthreads();
    // a page's K (or V) block for head h is contiguous in either plane:
    // copy it with independent 16-byte loads, nslot per page
    const int nslot = page * D / 8;          // 16-byte vectors, bf16 page
    const int nvec_aug = page * d_store / 16;
    const int per_vec = kv_bits == 8 ? 16 : 32;
    for (int v = tid; v < np * nslot; v += blockDim.x) {
      const int pi = v / nslot, j = v % nslot;
      const size_t base = s_base[pi];
      float* kd = kt + pi * page * D;
      float* vd = vt + pi * page * D;
      if (s_aug[pi]) {
        if (j < nvec_aug) {
          const uint4 kr = reinterpret_cast<const uint4*>(kp + base * d_store)[j];
          const uint4 vr = reinterpret_cast<const uint4*>(vp + base * d_store)[j];
          expand_levels(kr, kd + j * per_vec, kv_bits);
          expand_levels(vr, vd + j * per_vec, kv_bits);
        }
      } else {
        const uint4 kr = reinterpret_cast<const uint4*>(kn + base * D)[j];
        const uint4 vr = reinterpret_cast<const uint4*>(vn + base * D)[j];
        expand_bf16(kr, kd + j * 8);
        expand_bf16(vr, vd + j * 8);
      }
    }
    for (int tt = tid; tt < np * page; tt += blockDim.x) {
      const int pi = tt / page;
      const size_t row = s_base[pi] + tt % page;
      ksc[tt] = s_aug[pi] ? __bfloat162float(ks[row]) : 1.f;
      vsc[tt] = s_aug[pi] ? __bfloat162float(vs[row]) : 1.f;
    }
    __syncthreads();
    // one warp per (head, token) score: lanes stride over D, then a
    // shuffle reduction
    for (int i = warp; i < Hg * np * page; i += n_warps) {
      const int g = i / (np * page), tt = i % (np * page);
      float s = 0.f;
      for (int dd = lane; dd < D; dd += 32)
        s = fmaf(qs[g * D + dd], kt[tt * D + dd], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        s = s * (ksc[tt] * inv_sqrt_d);
        S[g * span + tt] = (p0 * page + tt < len) ? s : NEG_INF;
      }
    }
    __syncthreads();
    if (owner) {
      // the online-softmax update of _paged_kernel, one page at a time
      for (int pi = 0; pi < np; ++pi) {
        const float* Sr = S + hg * span + pi * page;
        const int t0 = pi * page;
        float m_new = m;
        for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, Sr[t]);
        const float alpha = expf(m - m_new);
        float psum = 0.f, pv_acc = 0.f;
        for (int t = 0; t < page; ++t) {
          const float pt = expf(Sr[t] - m_new);
          psum += pt;
          pv_acc = fmaf(bf16_round(pt * vsc[t0 + t]), vt[(t0 + t) * D + d],
                        pv_acc);
        }
        l = l * alpha + psum;
        acc = acc * alpha + pv_acc;
        m = m_new;
      }
    }
  }
  if (owner)
    out[((size_t)(b * KV + h) * Hg + hg) * D + d] = __float2bfloat16_rn(acc / l);
}

}  // namespace

static size_t shared_bytes(int Hg, int D, int page, int ppi) {
  const size_t span = (size_t)ppi * page;
  return sizeof(float) * ((size_t)Hg * D + 2 * span * D + 2 * span +
                          (size_t)Hg * span);
}

// Shapes as in the header; lengths/table/modes int32; out (B, KV, Hg, D)
// bf16. The wrapper checks shapes, dtypes, contiguity, 16-byte alignment
// of every page block and that one page per iteration fits the default
// 48 KiB of shared memory; up to PPI_MAX pages are loaded per iteration
// when they fit.
extern "C" int paged_kv_attention(
    const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* lengths,
    const void* table, const void* modes, void* out, int B, int KV, int Hg,
    int D, int page, int maxP, int kv_bits, void* stream) {
  // at least 8 warps for the page loads and the per-token scores; one
  // thread per output element (Hg * D <= 1024, checked by the wrapper)
  int threads = ((Hg * D + 31) / 32) * 32;
  if (threads < 256) threads = 256;
  int ppi = PPI_MAX;
  // 48 KiB less room for the static page descriptors
  while (ppi > 1 && shared_bytes(Hg, D, page, ppi) > 48 * 1024 - 256)
    ppi /= 2;
  if (B > 0)
    paged_kv_attention_kernel<<<B * KV, threads,
                                shared_bytes(Hg, D, page, ppi),
                                (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn,
        (const __nv_bfloat16*)vn, (const uint8_t*)kp, (const uint8_t*)vp,
        (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
        (const int*)lengths, (const int*)table, (const int*)modes,
        (__nv_bfloat16*)out, KV, Hg, D, page, maxP, kv_bits, ppi);
  return (int)cudaGetLastError();
}
