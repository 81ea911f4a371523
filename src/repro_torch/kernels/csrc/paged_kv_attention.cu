// Paged two-plane flash-decode attention for Hopper (sm_90a): split-page
// flash decoding on the tensor cores.
//
// Replaces repro/kernels/paged_kv_attention.py:paged_kv_attention_pallas
// (body _paged_kernel) and paged_kv_attention_window_pallas (body
// _paged_window_kernel, the speculative verify read). W query tokens per
// row (W = 1 at decode), GQA with Hg query heads per KV head, over a pool
// of fixed-size pages that each live in one of two planes: Normal (bf16
// kn/vn (Nn, KV, page, D)) or Augmented (int4 pairs (Np, KV, page, D/2)
// uint8 or int8 (Np, KV, page, D), with bf16 per-token scales ks/vs
// (Np, KV, page)). page_table/page_modes (B, maxP) give each logical
// page's physical index and plane. Window slot w of row b sees the tokens
// < min(base[b] + w + add, maxP * page): base = lengths and add = 0 at
// decode (W = 1), base = starts and add = 1 for the window.
//
// Rounding points of _paged_kernel: integer levels are exact in bf16 and a
// Normal page's bf16 is taken as is; the score is an f32 dot (the bf16 MMA's
// f32 sum) times k_scale * D^-1/2, with k_scale = 1 on Normal pages;
// columns at or past a slot's horizon get -1e30; the softmax runs in f32;
// p * v_scale is rounded to bf16 before the PV product; the output is
// bf16(acc / l). A row of length 0 reads its first page, every score
// masked, and gives that page's mean V, as the TPU kernel does.
//
// Bound: bytes of the pages a row actually holds, read once. One CTA per
// (row, KV head) walking the row's pages in order used 32-64 of 132 SMs.
// Design:
//  * the page walk is split across CTAs: grid (B * KV, cdiv(maxP, ppc)
//    [, slot groups]), one chunk of ppc whole pages a CTA (ppc * page <= 64
//    tokens; `chunk_plan` in kernels/paged_kv_attention.py reads the page
//    size alone). A CTA whose chunk starts at or past its last slot's last
//    page exits at once. The grid comes from shapes alone, so the call
//    stays free of host syncs and capturable in a CUDA graph;
//  * each page's K and V block and its scales, contiguous in either
//    plane, and q are streamed into shared memory with 16-byte cp.async
//    copies (K, its scales and q, then V and its scales: two groups) and
//    expanded from there into the MMA fragments, so each stored byte is
//    read from device memory once; the page descriptors are read beside
//    the row's horizon. Pages of both planes may share a chunk: the mode
//    bit is per page (page % 8 == 0, so an 8-token fragment half lies in
//    one page);
//  * both products run on mma.sync.m16n8k16 (bf16 in, f32 sums): the W *
//    Hg (slot, head) rows of a KV head are the instruction's rows, zero-
//    padded to 16 (MT <= 4 tiles a CTA). QK^T: each of 4 warps takes 16
//    tokens over D in increasing 16-steps; PV: each warp takes D/4 output
//    lanes over the chunk's tokens in increasing 16-steps;
//  * the softmax runs once per (row, token): a row's chunk max m, its p
//    and bf16(p * v_scale) (into shared memory, the PV product's A) are
//    computed once, and its denominator l is summed in one fixed order of
//    the token index (a lane's 4 tokens, two shuffles, then the warps in
//    order), which does not depend on the row's place in its tile;
//  * each CTA writes its partial (m, l, acc[R x D] f32) to scratch; a
//    second kernel, one CTA per (row, KV head, slot, head), merges a row's
//    chunks in increasing chunk order: m = max m_i, l = sum l_i e^(m_i - m),
//    acc = sum acc_i e^(m_i - m), out = bf16(acc / l). For each slot it
//    takes exactly the chunks that start before that slot's own last page
//    (by index, never by value). The fragment helpers and the merge's
//    body are csrc/flash_decode.cuh's, shared with packed_kv_attention.cu.
//
// Window slot w is bit-identical to the decode read at length
// starts + w + 1, by construction:
//  1. chunk boundaries are the same in both entries: they depend only on
//     the page index;
//  2. a row's MMA results do not depend on the other rows of its tile, so
//     its scores and its PV sums are the same at Hg rows and at W * Hg;
//  3. a token past a slot's horizon inside a chunk the slot takes has its
//     score at -1e30 while the chunk holds one of the slot's tokens, so it
//     adds exp(-1e30 - m) = 0 to l and a zero product to acc; the window
//     loading more pages of a chunk than the decode read adds only such
//     zeros (and PV steps whose row is all zeros);
//  4. the merge skips the chunks past the slot's horizon and adds the
//     others in the same order.
// Scratch: (B * KV * cdiv(maxP, ppc)) x W * Hg x (D * 4 + 8) bytes; it is
// written by the chunk kernel and read by the merge for the participating
// chunks only.
#include "flash_decode.cuh"

namespace {

constexpr int MAX_MT = 4;          // row tiles a CTA: 64 rows
constexpr int MAX_PPC = CHUNK / 8; // pages a chunk: page >= 8

// QK^T's B fragment of one token row: lanes k0 + 2t, +1 and k0 + 8 + 2t, +1
template <int KV_BITS>
__device__ __forceinline__ void key_frag(const uint8_t* row, bool aug,
                                         int k0, int t, uint32_t* b) {
  if (!aug) {                        // bf16 pairs, as stored
    const uint32_t* r32 = reinterpret_cast<const uint32_t*>(row);
    b[0] = r32[(k0 >> 1) + t];
    b[1] = r32[(k0 >> 1) + 4 + t];
  } else if (KV_BITS == 4) {         // byte k0/2 + t holds lanes k0 + 2t, +1
    b[0] = pair_int4(row[(k0 >> 1) + t]);
    b[1] = pair_int4(row[(k0 >> 1) + 4 + t]);
  } else {
    b[0] = pack_bf16(level<8>(row, k0 + 2 * t), level<8>(row, k0 + 2 * t + 1));
    b[1] = pack_bf16(level<8>(row, k0 + 8 + 2 * t),
                     level<8>(row, k0 + 9 + 2 * t));
  }
}

// PV's B half-fragment: lane d of two consecutive token rows
template <int KV_BITS>
__device__ __forceinline__ uint32_t value_pair(const uint8_t* row, int stride,
                                               bool aug, int d) {
  if (!aug) {
    const uint32_t lo = reinterpret_cast<const uint16_t*>(row)[d];
    const uint32_t hi = reinterpret_cast<const uint16_t*>(row + stride)[d];
    return lo | (hi << 16);
  }
  return pack_bf16(level<KV_BITS>(row, d), level<KV_BITS>(row + stride, d));
}

// horizon of slot w: the tokens it sees
__device__ __forceinline__ int horizon(int start, int w, int cap) {
  return max(min(start + w, cap), 0);
}

// pages read up to horizon h: at least the first
__device__ __forceinline__ int pages_to(int h, int page) {
  return max((h + page - 1) / page, 1);
}

// kn/vn are read as bytes (bf16 rows of 2 * D bytes), kp/vp as levels
struct Pool {
  const uint8_t* kn;
  const uint8_t* vn;
  const uint8_t* kp;
  const uint8_t* vp;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int* base;
  const int* table;
  const int* modes;
};

template <int KV_BITS, int MT>
__global__ void __launch_bounds__(THREADS)
paged_chunk_kernel(const __nv_bfloat16* __restrict__ q, Pool pool,
                   Parts parts, int KV, int W, int Hg, int D, int page,
                   int maxP, int add, int ppc, int wc) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ size_t s_row[MAX_PPC];   // first token row of each page
  __shared__ int s_aug[MAX_PPC];      // its plane
  const int bh = blockIdx.x, c = blockIdx.y, NC = gridDim.y;
  const int b = bh / KV, h = bh % KV;
  const int w0 = blockIdx.z * wc;     // this CTA's slots [w0, w0 + nw)
  const int nw = min(wc, W - w0);
  const int R = nw * Hg;              // its rows: (slot, head)
  const int RT = W * Hg;
  const int cap = maxP * page;
  const int p0 = c * ppc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // where each page of the chunk lives, read beside the row's horizon
  if (tid < ppc && p0 + tid < maxP) {
    const int lp = b * maxP + p0 + tid;
    s_aug[tid] = pool.modes[lp] == 1;
    s_row[tid] = ((size_t)pool.table[lp] * KV + h) * page;
  }
  const int start = pool.base[b] + add;
  const int nvp = pages_to(horizon(start, w0 + nw - 1, cap), page);
  if (p0 >= nvp) return;
  const int np = min(ppc, nvp - p0);
  const int n_load = np * page;       // tokens loaded
  const int c0 = p0 * page;           // the chunk's first token
  const int d_store = KV_BITS == 4 ? D / 2 : D;
  const int rs = 2 * D + ROW_PAD;     // bytes of a shared K / V row
  const int q_row = D + Q_PAD;
  constexpr int RP = MT * MROWS;      // rows padded to whole tiles
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* kt = smem + 2 * RP * q_row;
  uint8_t* vt = kt + CHUNK * rs;
  __nv_bfloat16* ksr = reinterpret_cast<__nv_bfloat16*>(vt + CHUNK * rs);
  __nv_bfloat16* vsr = ksr + CHUNK;   // the tokens' scales, as stored
  __nv_bfloat16* ps = vsr + CHUNK;
  float* red_m = reinterpret_cast<float*>(ps + RP * P_ROW);
  float* red_l = red_m + WARPS * RP;
  __syncthreads();
  // -- everything from device memory with 16-byte cp.async, in two
  // groups: the pages' K blocks, their k-scales and q; then V and the
  // v-scales (a page's block and its scales are contiguous in its plane)
  const int vmax = D / 8;             // 16-byte vectors of a bf16 row
  const int vaug = d_store / 16;      // of a packed row
  const int sv = page / 8;            // of a page's scales
  for (int kv = 0; kv < 2; ++kv) {
    const uint8_t* nrm = kv ? pool.vn : pool.kn;
    const uint8_t* pkd = kv ? pool.vp : pool.kp;
    const __nv_bfloat16* scl = kv ? pool.vs : pool.ks;
    uint8_t* dst = kv ? vt : kt;
    __nv_bfloat16* sdst = kv ? vsr : ksr;
    for (int i = tid; i < n_load * vmax; i += THREADS) {
      const int r = i / vmax, j = i % vmax;
      const int pi = r / page;
      const size_t row = s_row[pi] + r % page;
      if (s_aug[pi]) {
        if (j < vaug)
          cp_async16(dst + r * rs + 16 * j, pkd + row * d_store + 16 * j);
      } else {
        cp_async16(dst + r * rs + 16 * j, nrm + row * 2 * D + 16 * j);
      }
    }
    for (int i = tid; i < np * sv; i += THREADS) {
      const int pi = i / sv, j = i % sv;
      if (s_aug[pi])
        cp_async16(sdst + pi * page + 8 * j, scl + s_row[pi] + 8 * j);
    }
    if (kv == 0) {    // q as the A operand's RP rows (rows >= R zero)
      const __nv_bfloat16* qb = q + ((size_t)bh * RT + (size_t)w0 * Hg) * D;
      for (int i = tid; i < RP * vmax; i += THREADS) {
        const int r = i / vmax, j = i % vmax;
        uint8_t* qd = reinterpret_cast<uint8_t*>(qs + r * q_row) + 16 * j;
        if (r < R)
          cp_async16(qd, qb + r * D + 8 * j);
        else
          *reinterpret_cast<uint4*>(qd) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  }
  cp_async_wait<1>();
  __syncthreads();

  // -- scores: warp w takes tokens [16w, 16w + 16) (two n-tiles) over D
  const int tw = 16 * warp;
  float sacc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      sacc[mt][j][0] = sacc[mt][j][1] = sacc[mt][j][2] = sacc[mt][j][3] = 0.f;
  if (tw < n_load) {
    // an n-tile past the loaded tokens reads stale rows: its scores are
    // masked below and never reach p
    const bool aug0 = s_aug[tw / page], aug1 = s_aug[(tw + 8) / page];
    const uint8_t* kr0 = kt + (tw + g) * rs;
    const uint8_t* kr1 = kr0 + 8 * rs;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t b[2][2];
      key_frag<KV_BITS>(kr0, aug0, k0, t, b[0]);
      key_frag<KV_BITS>(kr1, aug1, k0, t, b[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        a_frag(qs, q_row, mt * MROWS + g, k0, t, a);
        mma_bf16(sacc[mt][0], a, b[0][0], b[0][1]);
        mma_bf16(sacc[mt][1], a, b[1][0], b[1][1]);
      }
    }
  }
  // -- scale, mask at each row's horizon, the chunk's max per row
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)D));
  float mx[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int hz[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = mt * MROWS + g + 8 * hh;
      hz[hh] = rl < R ? horizon(start, w0 + rl / Hg, cap) - c0 : 0;
      mx[mt][hh] = NEG_INF;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = tw + 8 * j + 2 * t + e;
        const bool in = tok < n_load;
        const float ksc = s_aug[tok / page] ? __bfloat162float(ksr[tok])
                                            : 1.f;
        const float kscale = in ? ksc * inv_sqrt_d : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float& s = sacc[mt][j][2 * hh + e];
          s = (in && tok < hz[hh]) ? s * kscale : NEG_INF;
          mx[mt][hh] = fmaxf(mx[mt][hh], s);
        }
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[mt][hh] = fmaxf(mx[mt][hh],
                         __shfl_xor_sync(0xffffffffu, mx[mt][hh], 1));
      mx[mt][hh] = fmaxf(mx[mt][hh],
                         __shfl_xor_sync(0xffffffffu, mx[mt][hh], 2));
    }
    if (t == 0) {
      red_m[warp * RP + mt * MROWS + g] = mx[mt][0];
      red_m[warp * RP + mt * MROWS + g + 8] = mx[mt][1];
    }
  }
  __syncthreads();
  float m[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = NEG_INF;
      for (int w = 0; w < WARPS; ++w)
        m[mt][hh] = fmaxf(m[mt][hh], red_m[w * RP + mt * MROWS + g + 8 * hh]);
    }
  // -- p once per (row, token), the denominators, bf16(p * v_scale)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tok = tw + 8 * j + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = tok + e < n_load;
          const float p = in ? expf(sacc[mt][j][2 * hh + e] - m[mt][hh])
                             : 0.f;
          lsum[hh] += p;
          const float vsc = s_aug[(tok + e) / page]
                                ? __bfloat162float(vsr[tok + e]) : 1.f;
          pv[e] = in ? p * vsc : 0.f;
        }
        *reinterpret_cast<uint32_t*>(
            ps + (mt * MROWS + g + 8 * hh) * P_ROW + tok) =
            pack_bf16(pv[0], pv[1]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 1);
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 2);
    }
    if (t == 0) {
      red_l[warp * RP + mt * MROWS + g] = lsum[0];
      red_l[warp * RP + mt * MROWS + g + 8] = lsum[1];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // -- PV: warp w takes output lanes [w * D/4, (w + 1) * D/4) of each tile
  const int nt = D / 32;
  const int dw = warp * (D / 4);
  const size_t rec = (size_t)bh * NC + c;
  const int r0 = w0 * Hg;             // this CTA's first row of the RT
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float oacc[MAX_NT][4];
#pragma unroll
    for (int j = 0; j < MAX_NT; ++j)
      oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
    for (int t0 = 0; t0 < n_load; t0 += 16) {
      uint32_t a[4];
      a_frag(ps, P_ROW, mt * MROWS + g, t0, t, a);
      const bool hi_in = t0 + 8 < n_load;  // page = 8: a last half page
      const bool aug0 = s_aug[t0 / page], aug1 = s_aug[(t0 + 8) / page];
      const uint8_t* v0 = vt + (t0 + 2 * t) * rs;   // tokens of b0
      const uint8_t* v1 = v0 + 8 * rs;              // tokens of b1
#pragma unroll
      for (int j = 0; j < MAX_NT; ++j) {
        if (j < nt) {
          const int d = dw + 8 * j + g;
          const uint32_t b0 = value_pair<KV_BITS>(v0, rs, aug0, d);
          const uint32_t b1 = hi_in ? value_pair<KV_BITS>(v1, rs, aug1, d)
                                    : 0u;
          mma_bf16(oacc[j], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_NT; ++j) {
      if (j < nt) {
        const int d = dw + 8 * j + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = mt * MROWS + g + 8 * hh;
          if (rl < R)
            *reinterpret_cast<float2*>(
                parts.acc + (rec * RT + r0 + rl) * D + d) =
                make_float2(oacc[j][2 * hh], oacc[j][2 * hh + 1]);
        }
      }
    }
  }
  // -- each row's (max, denominator): the warps' sums in warp order
  if (warp == 0 && t == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = mt * MROWS + g + 8 * hh;
        if (rl < R) {
          float l = 0.f;
          for (int w = 0; w < WARPS; ++w) l += red_l[w * RP + rl];
          parts.ml[rec * RT + r0 + rl] = make_float2(m[mt][hh], l);
        }
      }
  }
}

// one CTA per (row, KV head, slot, head), one thread per output lane
// (`merge_row`), over the chunks that start before the slot's last page.
__global__ void __launch_bounds__(MAX_D)
paged_merge_kernel(const int* __restrict__ base, Parts parts,
                   __nv_bfloat16* __restrict__ out, int KV, int W, int Hg,
                   int D, int page, int maxP, int add, int ppc, int NC) {
  const int bh = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int RT = W * Hg;
  const int hz = horizon(base[bh / KV] + add, r / Hg, maxP * page);
  const int nch = min((pages_to(hz, page) + ppc - 1) / ppc, NC);
  const size_t rec0 = (size_t)bh * NC * RT + r;   // chunk 0's record
  out[((size_t)bh * RT + r) * D + d] = __float2bfloat16_rn(
      merge_row(parts.ml + rec0, parts.acc + rec0 * D + d, RT, nch, D, d));
}

size_t shared_bytes(int mt, int D) {
  const size_t rp = (size_t)mt * MROWS;
  return 2 * rp * (D + Q_PAD) + 2 * (size_t)CHUNK * (2 * D + ROW_PAD)
         + 2 * 2 * CHUNK + 2 * rp * P_ROW
         + 2 * sizeof(float) * WARPS * rp;
}

template <int KV_BITS, int MT>
int launch_t(const void* q, const Pool& pool, const Parts& parts, void* out,
             int B, int KV, int W, int Hg, int D, int page, int maxP,
             int add, int ppc, int wc, cudaStream_t stream) {
  const size_t shm = shared_bytes(MT, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_chunk_kernel<KV_BITS, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return (int)err;
  const int NC = (maxP + ppc - 1) / ppc;
  paged_chunk_kernel<KV_BITS, MT><<<dim3(B * KV, NC, (W + wc - 1) / wc),
                                    THREADS, shm, stream>>>(
      (const __nv_bfloat16*)q, pool, parts, KV, W, Hg, D, page, maxP, add,
      ppc, wc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_merge_kernel<<<dim3(B * KV, W * Hg), D, 0, stream>>>(
      pool.base, parts, (__nv_bfloat16*)out, KV, W, Hg, D, page, maxP, add,
      ppc, NC);
  return (int)cudaGetLastError();
}

template <int KV_BITS>
int launch_bits(const void* q, const Pool& pool, const Parts& parts,
                void* out, int B, int KV, int W, int Hg, int D, int page,
                int maxP, int add, int ppc, int wc, cudaStream_t stream) {
  const int mt = (wc * Hg + MROWS - 1) / MROWS;
#define PAGED_ARGS q, pool, parts, out, B, KV, W, Hg, D, page, maxP, add, \
                   ppc, wc, stream
  if (mt <= 1) return launch_t<KV_BITS, 1>(PAGED_ARGS);
  if (mt <= 2) return launch_t<KV_BITS, 2>(PAGED_ARGS);
  return launch_t<KV_BITS, MAX_MT>(PAGED_ARGS);
#undef PAGED_ARGS
}

int launch(const void* q, const void* kn, const void* vn, const void* kp,
           const void* vp, const void* ks, const void* vs, const void* base,
           const void* table, const void* modes, void* out, void* scratch,
           int B, int KV, int W, int Hg, int D, int page, int maxP,
           int kv_bits, int add, int ppc, int wc, cudaStream_t stream) {
  if (B * KV == 0) return (int)cudaGetLastError();
  const Pool pool{(const uint8_t*)kn, (const uint8_t*)vn,
                  (const uint8_t*)kp, (const uint8_t*)vp,
                  (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
                  (const int*)base, (const int*)table, (const int*)modes};
  const int NC = (maxP + ppc - 1) / ppc;
  const Parts parts = parts_of(scratch, B * KV, NC, W * Hg, D);
  return kv_bits == 4
      ? launch_bits<4>(q, pool, parts, out, B, KV, W, Hg, D, page, maxP,
                       add, ppc, wc, stream)
      : launch_bits<8>(q, pool, parts, out, B, KV, W, Hg, D, page, maxP,
                       add, ppc, wc, stream);
}

}  // namespace

// Shapes as in the header; lengths/starts/table/modes int32; q, the
// arenas and the scales 16-byte aligned; scratch of B * KV *
// cdiv(maxP, ppc) * W * Hg * (D * 4 + 8) bytes, 16-byte aligned. The wrappers
// (kernels/paged_kv_attention.py) check shapes, dtypes and contiguity,
// D % 32 == 0, D <= 256, page % 8 == 0, 8 <= page <= 64, and pick the
// pages a chunk (`chunk_plan`: ppc * page <= 64) and the window's slots a
// CTA (`window_plan`: wc * Hg <= 64); they mirror the scratch size. A
// CTA's shared memory past the card's limit fails the launch.
// q (B, KV, Hg, D) -> out (B, KV, Hg, D): one query per row at lengths.
extern "C" int paged_kv_attention(
    const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* lengths,
    const void* table, const void* modes, void* out, void* scratch, int B,
    int KV, int Hg, int D, int page, int maxP, int kv_bits, int ppc,
    void* stream) {
  return launch(q, kn, vn, kp, vp, ks, vs, lengths, table, modes, out,
                scratch, B, KV, 1, Hg, D, page, maxP, kv_bits, 0, ppc, 1,
                (cudaStream_t)stream);
}

// q (B, KV, W, Hg, D) -> out (B, KV, W, Hg, D): slot w at starts + w + 1,
// wc slots a CTA.
extern "C" int paged_kv_attention_window(
    const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* starts,
    const void* table, const void* modes, void* out, void* scratch, int B,
    int KV, int W, int Hg, int D, int page, int maxP, int kv_bits, int ppc,
    int wc, void* stream) {
  return launch(q, kn, vn, kp, vp, ks, vs, starts, table, modes, out,
                scratch, B, KV, W, Hg, D, page, maxP, kv_bits, 1, ppc, wc,
                (cudaStream_t)stream);
}
