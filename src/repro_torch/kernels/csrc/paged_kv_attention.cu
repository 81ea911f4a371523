// Paged two-plane flash-decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_kv_attention.py:paged_kv_attention_pallas
// (body _paged_kernel) and paged_kv_attention_window_pallas (the
// speculative verify read). W query tokens per row (W = 1 at decode), GQA
// with Hg query heads per KV head, over a pool of fixed-size pages that
// each live in one of two
// planes: Normal (bf16 kn/vn (Nn, KV, page, D)) or Augmented (int4 pairs
// (Np, KV, page, D/2) uint8 or int8 (Np, KV, page, D), with bf16 per-token
// scales ks/vs (Np, KV, page)). page_table/page_modes (B, maxP) give each
// logical page's physical index and plane. Window slot w of row b sees
// the tokens < min(base[b] + w + add, maxP * page): base = lengths and
// add = 0 at decode (W = 1), base = starts and add = 1 for the window.
//
// Op order mirrors _paged_kernel: integer levels are taken as exact floats
// (the bf16 cast of the TPU kernel), the score is an f32 dot times
// k_scale * D^-1/2, invalid columns get -1e30, the online softmax runs in
// f32, and p * v_scale is rounded to bf16 before the PV product. Lengths
// are clamped to maxP * page; pages at or past cdiv(len, page) of the
// row's LAST slot are skipped.
//
// Window slot w is bit-identical to the decode walk at length
// starts + w + 1: its scores, the per-score warp reduction and the
// per-page update order are the decode kernel's, and a page past the
// slot's horizon has every score at -1e30, so it adds exp(-1e30 - m) = 0
// to l and to acc and leaves m (alpha = 1) unchanged. The number of pages
// loaded per barrier round does not enter the arithmetic.
//
// Bound: bytes of the pages a row actually holds. One CTA per (row, KV
// head, slot group) walks that row's pages in order up to its last slot's
// horizon (the page walk is never split across CTAs; a window whose W * Hg
// * D outputs exceed one CTA is cut into groups of `wc` slots, the grid's
// second dimension, each its own walk: a slot's arithmetic is the same in
// any group). Up to four pages at a time are read
// once into shared memory with independent 16-byte loads (a page's K or V
// block is contiguous in either plane), so one barrier round serves four
// pages; one warp computes each (slot, head, token) score; each thread
// that owns OUTS (slot, head, lane) outputs keeps their accumulators and
// running max / denominator in registers and applies the online-softmax
// update page by page, in _paged_kernel's order.
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

template <int OUTS>
__global__ void paged_kv_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kn,
    const __nv_bfloat16* __restrict__ vn, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ vp, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ base,
    const int* __restrict__ table, const int* __restrict__ modes,
    __nv_bfloat16* __restrict__ out, int KV, int W, int Hg, int D, int page,
    int maxP, int kv_bits, int add, int ppi, int wc) {
  extern __shared__ float smem[];
  __shared__ size_t s_base[PPI_MAX];  // first token row of each page
  __shared__ int s_aug[PPI_MAX];      // its plane
  const int w0 = blockIdx.y * wc;     // this CTA's slots [w0, w0 + nw)
  const int nw = min(wc, W - w0);
  const int R = nw * Hg;              // score rows: (slot, head)
  const int span = ppi * page;        // tokens loaded per iteration
  float* qs = smem;                   // R * D
  float* kt = qs + R * D;             // span * D
  float* vt = kt + span * D;          // span * D
  float* ksc = vt + span * D;         // span
  float* vsc = ksc + span;            // span
  float* S = vsc + span;              // R * span

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const int d_store = kv_bits == 4 ? D / 2 : D;
  // D^-1/2 rounded once from double, as the JAX constant 1.0 / D ** 0.5
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)D));

  const int cap = maxP * page;
  const int len0 = min(base[b] + w0 + add, cap);      // slot w0's horizon
  const int len_last = min(base[b] + w0 + nw - 1 + add, cap);
  const int nvp = max((len_last + page - 1) / page, 1);

  const size_t row0 = (size_t)(b * KV + h) * W * Hg + (size_t)w0 * Hg;
  const __nv_bfloat16* qb = q + row0 * D;
  for (int i = tid; i < R * D; i += blockDim.x) qs[i] = __bfloat162float(qb[i]);

  // the outputs this thread owns: o = tid + j * blockDim.x < R * D
  bool own[OUTS];
  int orow[OUTS], od[OUTS];
  float acc[OUTS], m[OUTS], l[OUTS];
#pragma unroll
  for (int j = 0; j < OUTS; ++j) {
    const int o = tid + j * blockDim.x;
    own[j] = o < R * D;
    orow[j] = own[j] ? o / D : 0;
    od[j] = own[j] ? o % D : 0;
    acc[j] = 0.f;
    m[j] = NEG_INF;
    l[j] = 0.f;
  }

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
      const size_t pbase = s_base[pi];
      float* kd = kt + pi * page * D;
      float* vd = vt + pi * page * D;
      if (s_aug[pi]) {
        if (j < nvec_aug) {
          const uint4 kr = reinterpret_cast<const uint4*>(kp + pbase * d_store)[j];
          const uint4 vr = reinterpret_cast<const uint4*>(vp + pbase * d_store)[j];
          expand_levels(kr, kd + j * per_vec, kv_bits);
          expand_levels(vr, vd + j * per_vec, kv_bits);
        }
      } else {
        const uint4 kr = reinterpret_cast<const uint4*>(kn + pbase * D)[j];
        const uint4 vr = reinterpret_cast<const uint4*>(vn + pbase * D)[j];
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
    // one warp per (slot, head, token) score: lanes stride over D, then a
    // shuffle reduction; slot w masks tokens at or past its own horizon
    for (int i = warp; i < R * np * page; i += n_warps) {
      const int r = i / (np * page), tt = i % (np * page);
      float s = 0.f;
      for (int dd = lane; dd < D; dd += 32)
        s = fmaf(qs[r * D + dd], kt[tt * D + dd], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        s = s * (ksc[tt] * inv_sqrt_d);
        const int len = min(len0 + r / Hg, cap);
        S[r * span + tt] = (p0 * page + tt < len) ? s : NEG_INF;
      }
    }
    __syncthreads();
    // the online-softmax update of _paged_kernel, one page at a time
#pragma unroll
    for (int j = 0; j < OUTS; ++j) {
      if (!own[j]) continue;
      for (int pi = 0; pi < np; ++pi) {
        const float* Sr = S + orow[j] * span + pi * page;
        const int t0 = pi * page;
        float m_new = m[j];
        for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, Sr[t]);
        const float alpha = expf(m[j] - m_new);
        float psum = 0.f, pv_acc = 0.f;
        for (int t = 0; t < page; ++t) {
          const float pt = expf(Sr[t] - m_new);
          psum += pt;
          pv_acc = fmaf(bf16_round(pt * vsc[t0 + t]),
                        vt[(t0 + t) * D + od[j]], pv_acc);
        }
        l[j] = fmaf(l[j], alpha, psum);
        acc[j] = fmaf(acc[j], alpha, pv_acc);
        m[j] = m_new;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < OUTS; ++j)
    if (own[j])
      out[(row0 + orow[j]) * D + od[j]] =
          __float2bfloat16_rn(acc[j] / l[j]);
}

}  // namespace

static size_t shared_bytes(int R, int D, int page, int ppi) {
  const size_t span = (size_t)ppi * page;
  return sizeof(float) * ((size_t)R * D + 2 * span * D + 2 * span +
                          (size_t)R * span);
}

// 48 KiB less room for the static page descriptors
constexpr size_t SHARED_LIMIT = 48 * 1024 - 256;
constexpr int MAX_THREADS = 1024;

static int launch(const void* q, const void* kn, const void* vn,
                  const void* kp, const void* vp, const void* ks,
                  const void* vs, const void* base, const void* table,
                  const void* modes, void* out, int B, int KV, int W, int Hg,
                  int D, int page, int maxP, int kv_bits, int add, int wc,
                  cudaStream_t stream) {
  const int outputs = wc * Hg * D;    // a CTA's: wc slots of the window
  // at least 8 warps for the page loads and the per-token scores; one
  // output per thread up to 1024, then 2 or 4 each, in the same order
  int threads = ((outputs + 31) / 32) * 32;
  if (threads < 256) threads = 256;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const int outs = (outputs + threads - 1) / threads;
  int ppi = PPI_MAX;
  while (ppi > 1 && shared_bytes(wc * Hg, D, page, ppi) > SHARED_LIMIT)
    ppi /= 2;
  const size_t shm = shared_bytes(wc * Hg, D, page, ppi);
  const dim3 grid(B * KV, (W + wc - 1) / wc);
  if (B == 0) return (int)cudaGetLastError();
#define PAGED_ARGS                                                           \
  (const __nv_bfloat16*)q, (const __nv_bfloat16*)kn,                          \
      (const __nv_bfloat16*)vn, (const uint8_t*)kp, (const uint8_t*)vp,       \
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, (const int*)base,   \
      (const int*)table, (const int*)modes, (__nv_bfloat16*)out, KV, W, Hg,   \
      D, page, maxP, kv_bits, add, ppi, wc
  if (outs <= 1)
    paged_kv_attention_kernel<1><<<grid, threads, shm, stream>>>(PAGED_ARGS);
  else if (outs <= 2)
    paged_kv_attention_kernel<2><<<grid, threads, shm, stream>>>(PAGED_ARGS);
  else
    paged_kv_attention_kernel<4><<<grid, threads, shm, stream>>>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaGetLastError();
}

// Shapes as in the header; lengths/starts/table/modes int32. The wrappers
// check shapes, dtypes, contiguity, 16-byte alignment of every page
// block, and pick the window's slots a CTA (kernels/paged_kv_attention.py:
// window_plan): wc * Hg * D <= 4096 and one page per iteration in the
// default 48 KiB of shared memory; up to PPI_MAX pages are loaded per
// iteration when they fit.
// q (B, KV, Hg, D) -> out (B, KV, Hg, D): one query per row at lengths.
extern "C" int paged_kv_attention(
    const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* lengths,
    const void* table, const void* modes, void* out, int B, int KV, int Hg,
    int D, int page, int maxP, int kv_bits, void* stream) {
  return launch(q, kn, vn, kp, vp, ks, vs, lengths, table, modes, out, B, KV,
                1, Hg, D, page, maxP, kv_bits, 0, 1, (cudaStream_t)stream);
}

// q (B, KV, W, Hg, D) -> out (B, KV, W, Hg, D): slot w at starts + w + 1,
// wc slots a CTA.
extern "C" int paged_kv_attention_window(
    const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* starts,
    const void* table, const void* modes, void* out, int B, int KV, int W,
    int Hg, int D, int page, int maxP, int kv_bits, int wc, void* stream) {
  return launch(q, kn, vn, kp, vp, ks, vs, starts, table, modes, out, B, KV,
                W, Hg, D, page, maxP, kv_bits, 1, wc, (cudaStream_t)stream);
}
