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
// for K <= 1040), and is the exact one past it. The quantize (quant_level,
// absmax8, quant8) needs IEEE division and round-half-even: no
// -use_fast_math.
//
// Bound: at decode (M = batch) the packed weight bytes, at prefill (M =
// batch x chunk) the multiply-adds.
//  * M <= 16 (decode): ONE launch a call, the quantize fused in. Grid
//    (N / bn, 1, S): the S CTAs of a column block split K into whole
//    64-deep units and form one thread-block cluster along z.
//    decode_plan(K, N) picks bn (64, 32 or 16 columns a CTA) and S (<= 8)
//    from the shapes alone: the widest bn whose (N / bn) * S reaches the
//    card's 132 SMs with a split's weights (<= 64 KB at a byte per (k,
//    column)) and levels in shared memory. It reads no M and no tensor, so
//    a call is free of host syncs and capturable in a CUDA graph; a
//    cluster launch the card refuses fails, it does not shrink. A CTA
//      1. issues its first loads of x (its rows in full: from L2 after the
//         first CTA), then puts its whole weight slice and its columns'
//         scales in flight by 16-byte cp.async (up to 64 KB a CTA, two or
//         three CTAs an SM), then takes each row's amax and derives xs
//         itself: every CTA runs the same arithmetic on the same row, so
//         every CTA, and the prepass of the M > 16 route, get the same xs
//         and the same levels, bit for bit;
//      2. quantizes its own K slice into shared memory, a K group's levels
//         of all rows side by side (the CTAs of column block 0 also write
//         the levels and scales to the caller's scratch: what the call
//         used, for the tests);
//      3. gives each thread 4 columns and every (256 / (bn / 4))-th K
//         group of four: a group's 1, 2 or 4 stored words are unpacked to
//         int8x4 words (unpack_group) and multiplied with __dp4a, both
//         planes from one read for dual;
//      4. sums its K groups by warp shuffles, then its warps in shared
//         memory, into an int32 partial of (rows x bn) per plane, which
//         split s stores into slot s of the leader's (split 0's) shared
//         memory through distributed shared memory and leaves; after the
//         cluster barrier the leader adds the S slots, scales and rounds
//         once.
//    Every partial is an int32, and int32 addition is exact in any order:
//    the split, the warp order and M change no bit of any output.
//  * M > 16 (prefill): the quantize prepass (one warp a row, xq and xs to
//    the caller's scratch), then 32 x 64 output tiles, 64-deep K steps;
//    each step stages the int8 activations and the weights unpacked to
//    int8x4 words in shared memory, and each thread accumulates 2 x 4
//    outputs (x2 for dual). Two launches.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int FMT_TERNARY = 0, FMT_INT4 = 1, FMT_INT8 = 2, FMT_DUAL = 3;

// ---- the quantize: shared by the prepass and the decode kernel -------------

__device__ __forceinline__ uint32_t quant_level(float v, float s, float q) {
  return (uint32_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -q), q) & 0xFFu;
}

// max(a, |v|) over eight bf16 activations
__device__ __forceinline__ float absmax8(uint4 v, float a) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    a = fmaxf(a, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return a;
}

// eight bf16 activations -> their eight int8 levels, in K order
__device__ __forceinline__ uint2 quant8(uint4 v, float s, float q) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    w[j / 2] |= (quant_level(f.x, s, q) | (quant_level(f.y, s, q) << 8))
                << (16 * (j % 2));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float row_scale(float amax, float q) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), q);
}

// ---- quantize prepass (M > 16) ----------------------------------------------
constexpr int Q_WARPS = 8;

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
  for (int k = lane; k < K8; k += 32) amax = absmax8(__ldg(xr + k), amax);
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float q = (float)qmax;
  const float s = row_scale(amax, q);
  uint2* qr = reinterpret_cast<uint2*>(xq + (size_t)row * K);
#pragma unroll 4
  for (int k = lane; k < K8; k += 32) qr[k] = quant8(__ldg(xr + k), s, q);
  if (lane == 0) xs[row] = s;
}

// ---- weight unpack: four K values of one column as an int8x4 word ----------

// per byte: a nibble 0..15 -> its sign-extended int8 value -8..7
__device__ __forceinline__ uint32_t sext4(uint32_t n) {
  return (((n ^ 0x08080808u) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// per byte: a digit 0..2 -> its trit digit - 1 (no byte carries into the
// next: 0x7F + 2 < 0x100)
__device__ __forceinline__ uint32_t trits4(uint32_t d) {
  return (d + 0x7F7F7F7Fu) ^ 0x80808080u;
}

// 4 x 4 byte transpose: byte c of word i -> byte i of word c
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&col)[4]) {
  const uint32_t a = __byte_perm(r[0], r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t b = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t c = __byte_perm(r[0], r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t d = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(a, b, 0x5410);
  col[1] = __byte_perm(a, b, 0x7632);
  col[2] = __byte_perm(c, d, 0x5410);
  col[3] = __byte_perm(c, d, 0x7632);
}

// stored rows that hold one K group (K values 4g .. 4g+3)
__host__ __device__ constexpr int group_rows(int fmt) {
  return fmt == FMT_TERNARY ? 1 : fmt == FMT_INT4 ? 2 : 4;
}

// r[i]: the 32-bit word of 4 columns in stored row i of a K group ->
// wk[0][c], column c's int8x4 word (the hi plane for dual), wk[1][c] the
// lo plane's
template <int FMT>
__device__ __forceinline__ void unpack_group(const uint32_t (&r)[4],
                                             uint32_t (&wk)[2][4]) {
  if (FMT == FMT_TERNARY) {
    // digit i of the 4 columns (one per byte), then a column's 4 digits
    const uint32_t d[4] = {r[0] & 0x03030303u, (r[0] >> 2) & 0x03030303u,
                           (r[0] >> 4) & 0x03030303u,
                           (r[0] >> 6) & 0x03030303u};
    uint32_t col[4];
    transpose4(d, col);
#pragma unroll
    for (int c = 0; c < 4; ++c) wk[0][c] = trits4(col[c]);
  } else if (FMT == FMT_INT4) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // bytes [b0, b0, b1, b1] of column c -> [hi b0, lo b0, hi b1, lo b1]
      const uint32_t b = __byte_perm(r[0], r[1], c | (c << 4) | ((c + 4) << 8)
                                                     | ((c + 4) << 12));
      wk[0][c] = sext4(((b >> 4) & 0x000F000Fu) | (b & 0x0F000F00u));
    }
  } else {
    // rows r0..r3 (bytes = columns) -> columns (bytes = K)
    uint32_t col[4];
    transpose4(r, col);
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

// K group g of columns n .. n+3 of stored rows `stride` bytes apart, read
// from device memory (GLOBAL) or from shared memory
template <int FMT, bool GLOBAL>
__device__ __forceinline__ void load_group(const uint8_t* __restrict__ w,
                                           int g, int n, int stride,
                                           uint32_t (&wk)[2][4]) {
  constexpr int R = group_rows(FMT);
  uint32_t r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint8_t* a = w + (size_t)(R * g + i) * stride + n;
    r[i] = GLOBAL ? __ldg(reinterpret_cast<const unsigned int*>(a))
                  : *reinterpret_cast<const uint32_t*>(a);
  }
  unpack_group<FMT>(r, wk);
}

__device__ __forceinline__ __nv_bfloat16 epilogue(int acc, float sx,
                                                  float sw) {
  return __float2bfloat16_rn(((float)acc * sx) * sw);
}

// ---- decode route (M <= DEC_MAX_M): one launch, quantize fused --------------
constexpr int DEC_MAX_M = 16;
constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int SPLIT_K = 64;          // K of one unit of the split
constexpr int MAX_SPLITS = 8;        // CTAs a cluster (the portable maximum)
constexpr int SM_TARGET = 132;       // SMs of an H100 SXM
constexpr int SLICE_K_MAX = 2048;    // K of one split: its levels, 32 KB at M = 16
constexpr int SLICE_BYTES = 64 * 1024;  // a split's weights at a byte per (k, column)

struct DecodePlan {
  int bn, S;   // columns a CTA, CTAs splitting K (one cluster)
};

// From (K, N) alone: the widest bn whose (N / bn) * S reaches SM_TARGET
// with S <= MAX_SPLITS and a split's slice within SLICE_K_MAX and
// SLICE_BYTES; where none reaches it, the most CTAs. {0, 0} where K is too
// long for any split of MAX_SPLITS.
DecodePlan decode_plan(int K, int N) {
  const int T = K / SPLIT_K;
  DecodePlan best = {0, 0};
  int best_ctas = 0;
  for (int bn = 64; bn >= 16; bn /= 2) {
    const int blocks = N / bn;
    const int u_max = (SLICE_K_MAX < SLICE_BYTES / bn ? SLICE_K_MAX
                                                      : SLICE_BYTES / bn)
                      / SPLIT_K;
    const int s_fit = (T + u_max - 1) / u_max;
    if (s_fit > MAX_SPLITS) continue;
    const int s_fill = (SM_TARGET + blocks - 1) / blocks;
    int S = s_fill < MAX_SPLITS ? s_fill : MAX_SPLITS;
    S = S < T ? S : T;
    S = S > s_fit ? S : s_fit;
    if (blocks * S >= SM_TARGET) return {bn, S};
    if (blocks * S > best_ctas) {
      best = {bn, S};
      best_ctas = blocks * S;
    }
  }
  return best;
}

// shared-memory layout of a decode CTA, in bytes: the weight slice (later
// the warps' partial sums) at 0, then the slice's levels [kmax / 4][MR]
// words, the splits' int32 partials [S][PLANES][MR][bn] (the leader's are
// read), the rows' amax by warp [MR][8], the rows' scales [MR] (64 bytes)
// and the columns' scales [PLANES][bn]
struct DecodeLayout {
  int kmax, xq, part, amax, xs, scl, bytes;
};

__host__ __device__ inline DecodeLayout decode_layout(int K, int S, int bn,
                                                      int fmt, int planes,
                                                      int mr) {
  DecodeLayout L;
  const int T = K / SPLIT_K;
  L.kmax = (T + S - 1) / S * SPLIT_K;
  const int w = L.kmax / 4 * group_rows(fmt) * bn;
  const int red = DEC_WARPS * planes * mr * bn * 4;
  L.xq = w > red ? w : red;
  L.part = L.xq + mr * L.kmax;
  L.amax = L.part + S * planes * mr * bn * 4;
  L.xs = L.amax + mr * DEC_WARPS * 4;
  L.scl = L.xs + 64;
  L.bytes = L.scl + planes * bn * 4;
  return L;
}

struct DecodeParams {
  const __nv_bfloat16* x;   // (M, K)
  const uint8_t* w;         // stored rows of the format, N bytes each
  const float* s0;          // (N,) scale (dual: hi plane's)
  const float* s1;          // (N,) lo plane's scale (dual)
  __nv_bfloat16* y0;        // (M, N)
  __nv_bfloat16* y1;        // (M, N) lo plane (dual)
  int8_t* xq_out;           // (M, K) the levels used
  float* xs_out;            // (M,) the scales used
  int M, K, N, bn, S;
  float q;
};

// the cluster barrier split in two: arrive (release: this thread's
// shared-memory writes are visible to the cluster after the wait; relaxed:
// no ordering), wait (acquire)
__device__ __forceinline__ void cluster_arrive(bool release = true) {
  if (release)
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int FMT, int PLANES, int MR>
__global__ void __launch_bounds__(DEC_THREADS, MR <= 4 ? 2 : 1)
imc_decode_kernel(DecodeParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int R = group_rows(FMT);
  const DecodeLayout L = decode_layout(p.K, p.S, p.bn, FMT, PLANES, MR);
  uint32_t* xqs = reinterpret_cast<uint32_t*>(smem + L.xq);
  int* part = reinterpret_cast<int*>(smem + L.part);
  float* amax_s = reinterpret_cast<float*>(smem + L.amax);
  float* xs_s = reinterpret_cast<float*>(smem + L.xs);
  float* scl_s = reinterpret_cast<float*>(smem + L.scl);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bn = p.bn, n0 = blockIdx.x * bn, split = blockIdx.z;
  const bool lead = split == 0;
  const int T = p.K / SPLIT_K;
  const int u0 = (int)((long long)split * T / p.S);
  const int u1 = (int)((long long)(split + 1) * T / p.S);
  const int k0 = u0 * SPLIT_K, kl = (u1 - u0) * SPLIT_K;
  const int G = kl / 4;                      // this split's K groups
  const int cqn = bn / 4, cq = tid % cqn, ks = tid / cqn;
  const int nks = DEC_THREADS / cqn;         // threads sharing a column
  const int outs = PLANES * MR * bn;

  // 1. each row's amax over all of K. The first loads of x go first (they
  // head the critical path), then the whole weight slice and the columns'
  // scales are put in flight, then the maxima are taken
  const int K8 = p.K / 8;
  float am[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) am[m] = 0.f;
  uint4 v[4][2];
  auto load_rows = [&](int k, int mb) {   // rows mb .. mb+3 at k, k + 256
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4* xr =
          reinterpret_cast<const uint4*>(p.x + (size_t)(mb + j) * p.K) + k;
      if (mb + j < p.M && k < K8) v[j][0] = __ldg(xr);
      if (mb + j < p.M && k + DEC_THREADS < K8)
        v[j][1] = __ldg(xr + DEC_THREADS);
    }
  };
  auto max_rows = [&](int k, int mb) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (mb + j < MR && mb + j < p.M && k < K8)
        am[mb + j] = absmax8(v[j][0], am[mb + j]);
      if (mb + j < MR && mb + j < p.M && k + DEC_THREADS < K8)
        am[mb + j] = absmax8(v[j][1], am[mb + j]);
    }
  };
  load_rows(tid, 0);
  {   // G * R stored rows of bn bytes, and the scales of the bn columns
    const int cs = __ffs(bn / 16) - 1, row0 = k0 / 4 * R;
    for (int i = tid; i < (G * R << cs); i += DEC_THREADS) {
      const int r = i >> cs, c = i & ((1 << cs) - 1);
      cp_async16(smem + r * bn + 16 * c,
                 p.w + (size_t)(row0 + r) * p.N + n0 + 16 * c);
    }
    if (tid < PLANES * bn / 4) {
      const int pl = tid / (bn / 4), c = tid % (bn / 4);
      cp_async16(scl_s + pl * bn + 4 * c, (pl ? p.s1 : p.s0) + n0 + 4 * c);
    }
    cp_async_commit();
  }
  if (p.S > 1) cluster_arrive(false);   // waited on before the first
                                        // remote store: every CTA runs
  max_rows(tid, 0);
#pragma unroll
  for (int mb = 4; mb < MR; mb += 4) {
    load_rows(tid, mb);
    max_rows(tid, mb);
  }
  for (int k = tid + 2 * DEC_THREADS; k < K8; k += 2 * DEC_THREADS) {
#pragma unroll
    for (int mb = 0; mb < MR; mb += 4) {
      load_rows(k, mb);
      max_rows(k, mb);
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m < p.M) {
      float a = am[m];
#pragma unroll
      for (int o = 16; o; o >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      if (lane == 0) amax_s[m * DEC_WARPS + warp] = a;
    }
  }
  __syncthreads();
  auto scale_of = [&](int m) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < DEC_WARPS; ++i)
      a = fmaxf(a, amax_s[m * DEC_WARPS + i]);
    return row_scale(a, p.q);
  };
  const bool writer = blockIdx.x == 0;   // column block 0 reports the levels
  if (tid < p.M) {
    xs_s[tid] = scale_of(tid);
    if (writer && lead) p.xs_out[tid] = xs_s[tid];
  }

  // 2. this split's levels: K group g of row m is the word xqs[g * MR + m]
  const int kl8 = kl / 8;
  for (int i = tid; i < p.M * kl8; i += DEC_THREADS) {
    const int m = i / kl8, k = i - m * kl8;
    const uint2 q8 = quant8(__ldg(reinterpret_cast<const uint4*>(
                                p.x + (size_t)m * p.K + k0) + k),
                            scale_of(m), p.q);
    xqs[2 * k * MR + m] = q8.x;
    xqs[(2 * k + 1) * MR + m] = q8.y;
    if (writer)
      *reinterpret_cast<uint2*>(p.xq_out + (size_t)m * p.K + k0 + 8 * k) = q8;
  }

  // 3. 4 columns a thread (cq), every nks-th K group
  int acc[PLANES][MR][4];
#pragma unroll
  for (int pl = 0; pl < PLANES; ++pl)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[pl][m][c] = 0;
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 4
  for (int g = ks; g < G; g += nks) {
    uint32_t wk[2][4];
    load_group<FMT, false>(smem, g, 4 * cq, bn, wk);
    uint4 xv[MR / 4];
#pragma unroll
    for (int mb = 0; mb < MR / 4; ++mb)
      if (4 * mb < p.M)
        xv[mb] = *reinterpret_cast<const uint4*>(xqs + g * MR + 4 * mb);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m < p.M) {
        const int xw = (int)word_of(xv[m / 4], m % 4);
#pragma unroll
        for (int pl = 0; pl < PLANES; ++pl)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[pl][m][c] = __dp4a((int)wk[pl][c], xw, acc[pl][m][c]);
      }
    }
  }

  // 4. lanes cq, cq + cqn, ... of a warp share columns; then the warps
  // into this CTA's partial; then the leader adds the cluster's partials,
  // read through distributed shared memory: int32 sums, exact in any order
  __syncthreads();                     // the weight slice is read
  int* red = reinterpret_cast<int*>(smem);   // [warp][PLANES][MR][bn]
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // unrolled: the shuffles of a step
    if (o < cqn) continue;             // go out together
#pragma unroll
    for (int pl = 0; pl < PLANES; ++pl)
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (m < p.M)
            acc[pl][m][c] += __shfl_xor_sync(0xffffffffu, acc[pl][m][c], o);
  }
  if (lane < cqn) {
#pragma unroll
    for (int pl = 0; pl < PLANES; ++pl)
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (m < p.M)
            red[((warp * PLANES + pl) * MR + m) * bn + 4 * cq + c] =
                acc[pl][m][c];
  }
  __syncthreads();
  auto finish = [&](int i, int v) {
    const int pl = i / (MR * bn), m = (i / bn) % MR, n = n0 + i % bn;
    (pl ? p.y1 : p.y0)[(size_t)m * p.N + n] =
        epilogue(v, xs_s[m], scl_s[pl * bn + i % bn]);
  };
  // split s's partial goes to slot s of the leader's part; the leader
  // adds the S slots once every split has arrived
  int* slot = part;
  if (p.S > 1) {
    cluster_wait();
    slot = cg::this_cluster().map_shared_rank(part, 0) + split * outs;
  }
  for (int i = tid; i < outs; i += DEC_THREADS) {
    if ((i / bn) % MR >= p.M) continue;
    int v = 0;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) v += red[w * outs + i];
    if (p.S == 1)
      finish(i, v);
    else
      slot[i] = v;
  }
  if (p.S == 1) return;
  cluster_arrive();                    // this split's slot is written
  if (!lead) return;                   // nothing reads its shared memory
  cluster_wait();                      // every split's is
  for (int i = tid; i < outs; i += DEC_THREADS) {
    if ((i / bn) % MR >= p.M) continue;
    int v = 0;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < p.S) v += part[s * outs + i];
    finish(i, v);
  }
}

template <int FMT, int PLANES, int MR>
int launch_decode(const DecodeParams& p, cudaStream_t stream) {
  const DecodeLayout L = decode_layout(p.K, p.S, p.bn, FMT, PLANES, MR);
  auto kern = imc_decode_kernel<FMT, PLANES, MR>;
  static int opted_in = 48 * 1024;
  if (L.bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = L.bytes;
  }
  // the S splits of a column block are one cluster (1, 1, S); a launch
  // the card refuses fails here, at the planned size
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = p.S;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / p.bn, 1, p.S);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, p);
}

// ---- tiled path (M > DEC_MAX_M) ---------------------------------------------
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
      load_group<FMT, true>(w, k0 / 4 + gg, n0 + 4 * cq, N, wk);
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

int launch_quantize(const void* x, void* xq, void* xs, int M, int K,
                    int qmax, cudaStream_t s) {
  imc_quantize_kernel<<<(M + Q_WARPS - 1) / Q_WARPS, Q_WARPS * 32, 0, s>>>(
      (const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs, M, K, qmax);
  return (int)cudaGetLastError();
}

// M <= DEC_MAX_M: the decode kernel; above it the prepass into the
// scratch, then the tiles
template <int FMT, int PLANES>
int launch(const void* x, void* scratch, const void* w, const void* s0,
           const void* s1, void* y0, void* y1, int M, int K, int N,
           int qmax, cudaStream_t s) {
  int8_t* xq = (int8_t*)scratch;
  float* xs = (float*)(xq + (size_t)M * K);
  if (M <= DEC_MAX_M) {
    const DecodePlan plan = decode_plan(K, N);
    if (plan.S == 0) return (int)cudaErrorInvalidValue;
    const DecodeParams p{(const __nv_bfloat16*)x, (const uint8_t*)w,
                         (const float*)s0, (const float*)s1,
                         (__nv_bfloat16*)y0, (__nv_bfloat16*)y1, xq, xs,
                         M, K, N, plan.bn, plan.S, (float)qmax};
    return M <= 4 ? launch_decode<FMT, PLANES, 4>(p, s)
                  : launch_decode<FMT, PLANES, DEC_MAX_M>(p, s);
  }
  const int e = launch_quantize(x, xq, xs, M, K, qmax, s);
  if (e) return e;
  dim3 grid(N / TN, (M + TM - 1) / TM);
  imc_tiled_kernel<FMT, PLANES><<<grid, T_THREADS, 0, s>>>(
      xq, xs, (const uint8_t*)w, (const float*)s0, (const float*)s1,
      (__nv_bfloat16*)y0, (__nv_bfloat16*)y1, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (16-byte aligned) -> xq (M, K) int8, xs (M,) f32;
// contiguous; K % 8 == 0 (checked by the wrapper).
extern "C" int imc_quantize(const void* x, void* xq, void* xs, int M, int K,
                            int qmax, void* stream) {
  return launch_quantize(x, xq, xs, M, K, qmax, (cudaStream_t)stream);
}

// x (M, K) bf16; scratch M * K int8 then M f32, where the call leaves the
// levels and scales it used; w packed per fmt (0 ternary (K/4, N) u8, 1
// int4 rows (K/2, N) u8, 2 int8 (K, N)); scale (N,) f32; y (M, N) bf16;
// all contiguous, x and w 16-byte aligned; K % 64 == 0, N % 64 == 0
// (checked by the wrapper); at M <= 16, K <= 16384 (else
// cudaErrorInvalidValue).
extern "C" int imc_dot(const void* x, void* scratch, const void* w,
                       const void* scale, void* y, int M, int K, int N,
                       int fmt, int qmax, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (fmt) {
    case FMT_TERNARY:
      return launch<FMT_TERNARY, 1>(x, scratch, w, scale, scale, y, y, M, K,
                                    N, qmax, s);
    case FMT_INT4:
      return launch<FMT_INT4, 1>(x, scratch, w, scale, scale, y, y, M, K, N,
                                 qmax, s);
    case FMT_INT8:
      return launch<FMT_INT8, 1>(x, scratch, w, scale, scale, y, y, M, K, N,
                                 qmax, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// buf (K, N) u8, hi / lo scales (N,) f32, y_hi / y_lo (M, N) bf16;
// otherwise as imc_dot.
extern "C" int imc_dual_dot(const void* x, void* scratch, const void* buf,
                            const void* hi_scale, const void* lo_scale,
                            void* y_hi, void* y_lo, int M, int K, int N,
                            int qmax, void* stream) {
  return launch<FMT_DUAL, 2>(x, scratch, buf, hi_scale, lo_scale, y_hi, y_lo,
                             M, K, N, qmax, (cudaStream_t)stream);
}

// The decode route's plan at (K, N): plan[0] columns a CTA, plan[1] CTAs
// splitting K (one cluster); cudaErrorInvalidValue where K is too long.
extern "C" int imc_decode_plan(int K, int N, int* plan) {
  const DecodePlan d = decode_plan(K, N);
  plan[0] = d.bn;
  plan[1] = d.S;
  return d.S ? 0 : (int)cudaErrorInvalidValue;
}
