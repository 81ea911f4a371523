// Fused quantize-and-pack of KV rows for Hopper (sm_90a), and the paged
// KV write built on the same row routine.
//
// Replaces repro/kernels/quantize_pack_kv.py:quantize_pack_kv_pallas: the
// plain body _qpack_kernel (entry quantize_pack_kv), with a `valid` row
// mask the masked body _qpack_masked_kernel (quantize_pack_kv_masked), and
// with a `words` output the fused-integrity body _qpack_integrity_kernel
// (quantize_pack_kv_integrity). The entry paged_kv_write also takes in the
// scatter around the pack (repro/models/transformer.py:_paged_scatter,
// which XLA fuses into the jitted step around the Pallas call): for every
// (b, t, KV head) row of K and of V the page lookup, the write and commit
// masks, the quantize-pack and the stores into one layer's arena views,
// in place, in one launch.
//
// Per row of D bf16 values, at qmax 7 (int4) or 127 (int8):
//   scale = bf16(max(amax, bf16(1e-8)) / qmax)
//   q     = clip(rint(bf16(x / scale)), -qmax, qmax)    (rint: half to even)
//   int4: byte j = (q[2j] & 15) << 4 | (q[2j+1] & 15)   (even lane high nibble)
//   int8: byte j = q[j]
// A row whose valid / commit bit is 0 (a draft token the speculative verify
// rejected) is written as zero bytes and a scale of exactly 1.0, and as a
// zero bf16 row in the Normal plane. The integrity word of a row is
// sum_j (j + 1) * byte_j mod 2^32 over its D/2 packed bytes
// (core.faults.integrity_word of the row): wrap-around addition is exact
// in any order. Bit-exact with the JAX package (int4) and with
// core/quant.py:quantize_int8 (int8), whose bf16 arithmetic rounds to bf16
// after each op: both roundings are spelled out below. IEEE division is
// required, so this file must not be built with -use_fast_math.
//
// Bound: bytes, and at the main path's sizes (a decode step writes 128
// rows, 8 KB packed) the launch and its dependent loads. Where D % 16 == 0
// (and the operands are 16-byte aligned) a row belongs to a group of
// LPR = min(32, pow2ceil(D / 8)) lanes, each holding VPL 16-byte vectors
// (8 values each) in registers: the row is read once, amax is a shuffle
// reduction within the group, the levels come from the registers, and the
// packed bytes leave as 32-bit (int4) or 64-bit (int8) stores, the Normal
// row as 16-byte stores. Any other even D takes one warp a row with scalar
// loads. paged_kv_write puts K and V of one (b, t, head) in neighbouring
// groups, so one grid covers both; each group issues its row's loads
// before it looks its page up.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_VPL = 4;              // vector path up to D = 1024

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// element 0 of a bf16 pair is the low half of its 32-bit word
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int QMAX>
__device__ __forceinline__ float row_scale(float amax) {
  return bf16_round(fmaxf(amax, bf16_round(1e-8f)) / (float)QMAX);
}

// A zero takes level 0 without dividing: IEEE division sends a zero
// dividend down its slow path, and 0 / s is +-0 -> level 0 anyway.
template <int QMAX>
__device__ __forceinline__ int level(float v, float s) {
  const float y = bf16_round((v == 0.f ? s : v) / s);
  return v == 0.f ? 0 : (int)fminf(fmaxf(rintf(y), (float)-QMAX),
                                   (float)QMAX);
}

__device__ __forceinline__ float group_max(float a, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

__device__ __forceinline__ uint32_t group_sum(uint32_t a, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// 8 bf16 values (one 16-byte vector) -> 4 bytes of int4 pairs
__device__ __forceinline__ uint32_t pack_int4_vec(const uint4& v, float s) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t out = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int hi = level<7>(lo_f(w[i]), s);
    const int lo = level<7>(hi_f(w[i]), s);
    out |= (uint32_t)(((hi & 15) << 4) | (lo & 15)) << (8 * i);
  }
  return out;
}

// 8 bf16 values -> 8 int8 levels
__device__ __forceinline__ uint2 pack_int8_vec(const uint4& v, float s) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = ((uint32_t)level<127>(lo_f(w[i]), s) & 255u)
           | (((uint32_t)level<127>(hi_f(w[i]), s) & 255u) << 8);
  return make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
}

// A row's 16-byte vectors in the registers of its group's `lpr` lanes:
// lane g holds vectors g + k * lpr (k < VPL). A vector past the row, or of
// a group with no row, is zero, which leaves amax as it is.
template <int VPL>
struct RowVec {
  uint4 v[VPL];

  __device__ __forceinline__ void load(const __nv_bfloat16* src, int g,
                                       int lpr, int nvec, bool active) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = g + k * lpr;
      v[k] = (active && i < nvec)
                 ? __ldg(reinterpret_cast<const uint4*>(src) + i)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // every lane of the warp must call this (shuffles)
  __device__ __forceinline__ float amax(int lpr) const {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a = fmaxf(a, fmaxf(fabsf(lo_f(w[i])), fabsf(hi_f(w[i]))));
    }
    return group_max(a, lpr);
  }
};

// ---------------------------------------------------------------------------
// the standalone pack: (N, D) contiguous rows -> packed (N, D/2) uint8,
// scale (N,) f32; valid (N,) int32 or null; words (N,) int64 or null
// ---------------------------------------------------------------------------

template <int VPL, bool WORDS>
__global__ void __launch_bounds__(THREADS)
pack_rows_vec(const __nv_bfloat16* __restrict__ x,
              const int* __restrict__ valid, uint8_t* __restrict__ packed,
              float* __restrict__ scale, int64_t* __restrict__ words, int N,
              int D, int lpr) {
  const int g = threadIdx.x & (lpr - 1);
  const int row = (blockIdx.x * THREADS + threadIdx.x) / lpr;
  const bool active = row < N;
  const int nvec = D >> 3;
  RowVec<VPL> r;
  r.load(x + (size_t)row * D, g, lpr, nvec, active);
  const bool keep = active && (valid == nullptr || valid[row] != 0);
  const float s = row_scale<7>(r.amax(lpr));
  uint32_t* pr = reinterpret_cast<uint32_t*>(packed + (size_t)row * (D / 2));
  uint32_t word = 0u;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = g + k * lpr;
    if (active && i < nvec) {
      const uint32_t p = keep ? pack_int4_vec(r.v[k], s) : 0u;
      pr[i] = p;
      if (WORDS) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word += (uint32_t)(4 * i + j + 1) * ((p >> (8 * j)) & 255u);
      }
    }
  }
  if (WORDS) word = group_sum(word, lpr);
  if (active && g == 0) {
    scale[row] = keep ? s : 1.0f;
    if (WORDS) words[row] = (int64_t)word;
  }
}

// any even D: one warp a row, the row read again for the levels
template <bool WORDS>
__global__ void __launch_bounds__(THREADS)
pack_rows_scalar(const __nv_bfloat16* __restrict__ x,
                 const int* __restrict__ valid, uint8_t* __restrict__ packed,
                 float* __restrict__ scale, int64_t* __restrict__ words,
                 int N, int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
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
  const float s = row_scale<7>(group_max(amax, 32));
  uint32_t word = 0u;
  for (int j = lane; j < D / 2; j += 32) {
    const int hi = level<7>(__bfloat162float(xr[2 * j]), s);
    const int lo = level<7>(__bfloat162float(xr[2 * j + 1]), s);
    const uint8_t byte = (uint8_t)(((hi & 15) << 4) | (lo & 15));
    pr[j] = byte;
    if (WORDS) word += (uint32_t)(j + 1) * (uint32_t)byte;
  }
  if (WORDS) word = group_sum(word, 32);
  if (lane == 0) {
    scale[row] = s;
    if (WORDS) words[row] = (int64_t)word;
  }
}

// ---------------------------------------------------------------------------
// the paged KV write
// ---------------------------------------------------------------------------

struct PagedWrite {
  const __nv_bfloat16* k;     // (B, T, KV, D), last stride 1
  const __nv_bfloat16* v;
  const void* pos;            // (B, T) int32 or int64, contiguous
  const uint8_t* write;       // (B, T) bool
  const uint8_t* commit;      // (B, T) bool, or null
  const int* table;           // (>= B, maxP) int32 physical pages
  const int* modes;           // (>= B, maxP) int32: 0 Normal, 1 Augmented
  __nv_bfloat16* kn;          // (Nn, KV, page, D)
  __nv_bfloat16* vn;
  uint8_t* kp;                // (Np, KV, page, D/2 | D)
  uint8_t* vp;
  __nv_bfloat16* ks;          // (Np, KV, page)
  __nv_bfloat16* vs;
  int B, T, KV, D, page, maxP;
  int k_sb, k_st, k_sh, v_sb, v_st, v_sh;   // element strides of k / v
  int pos64, normal, aug;
};

// where row (b, t) goes: its page's physical index and mode, its slot,
// and its write and commit bits (a position past the table is clamped
// into it: such a row is write-masked and lands on the dump page)
struct Dest {
  int phys, mode, slot;
  bool write, keep;
};

__device__ __forceinline__ Dest lookup(const PagedWrite& a, int bt, int b) {
  const long long pos = a.pos64 ? static_cast<const long long*>(a.pos)[bt]
                                : static_cast<const int*>(a.pos)[bt];
  const int lp = (int)min(pos / a.page, (long long)(a.maxP - 1));
  Dest d;
  d.slot = (int)(pos % a.page);
  d.phys = a.table[(size_t)b * a.maxP + lp];
  d.mode = a.modes[(size_t)b * a.maxP + lp];
  d.write = a.write[bt] != 0;
  d.keep = a.commit == nullptr || a.commit[bt] != 0;
  return d;
}

// row r = 2 * ((b * T + t) * KV + h) + plane (0 K, 1 V)
__device__ __forceinline__ const __nv_bfloat16* row_src(const PagedWrite& a,
                                                        int plane, int b,
                                                        int t, int h) {
  return plane ? a.v + (size_t)b * a.v_sb + (size_t)t * a.v_st
                     + (size_t)h * a.v_sh
               : a.k + (size_t)b * a.k_sb + (size_t)t * a.k_st
                     + (size_t)h * a.k_sh;
}

template <int VPL, int BITS>
__global__ void __launch_bounds__(THREADS)
paged_write_vec(const PagedWrite a, int lpr) {
  constexpr int QMAX = BITS == 4 ? 7 : 127;
  const int g = threadIdx.x & (lpr - 1);
  const int r = (blockIdx.x * THREADS + threadIdx.x) / lpr;
  const int th = r >> 1, plane = r & 1;
  const bool active = th < a.B * a.T * a.KV;
  const int h = th % a.KV, bt = th / a.KV;
  const int b = bt / a.T, t = bt % a.T;
  const int nvec = a.D >> 3;
  RowVec<VPL> row;
  row.load(active ? row_src(a, plane, b, t, h) : a.k, g, lpr, nvec, active);
  Dest d{0, 0, 0, false, true};
  if (active) d = lookup(a, bt, b);
  if (a.normal && active) {
    const int pn = d.write && d.mode == 0 ? d.phys : 0;
    uint4* dst = reinterpret_cast<uint4*>(
        (plane ? a.vn : a.kn)
        + (((size_t)pn * a.KV + h) * a.page + d.slot) * a.D);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = g + k * lpr;
      if (i < nvec) dst[i] = d.keep ? row.v[k] : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (a.aug) {                   // uniform: every lane reaches the shuffles
    const float s = row_scale<QMAX>(row.amax(lpr));
    if (active) {
      const int pp = d.write && d.mode == 1 ? d.phys : 0;
      const size_t at = ((size_t)pp * a.KV + h) * a.page + d.slot;
      uint8_t* dst = (plane ? a.vp : a.kp) + at * (BITS == 4 ? a.D / 2 : a.D);
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int i = g + k * lpr;
        if (i >= nvec) continue;
        if (BITS == 4)
          reinterpret_cast<uint32_t*>(dst)[i] =
              d.keep ? pack_int4_vec(row.v[k], s) : 0u;
        else
          reinterpret_cast<uint2*>(dst)[i] =
              d.keep ? pack_int8_vec(row.v[k], s) : make_uint2(0u, 0u);
      }
      if (g == 0)
        (plane ? a.vs : a.ks)[at] = __float2bfloat16_rn(d.keep ? s : 1.0f);
    }
  }
}

// any even D: one warp a row, scalar loads, the row read again per plane
template <int BITS>
__global__ void __launch_bounds__(THREADS)
paged_write_scalar(const PagedWrite a) {
  constexpr int QMAX = BITS == 4 ? 7 : 127;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int th = r >> 1, plane = r & 1;
  if (th >= a.B * a.T * a.KV) return;               // the whole warp
  const int h = th % a.KV, bt = th / a.KV;
  const int b = bt / a.T, t = bt % a.T;
  const __nv_bfloat16* src = row_src(a, plane, b, t, h);
  const Dest d = lookup(a, bt, b);
  const int D = a.D;
  if (a.normal) {
    const int pn = d.write && d.mode == 0 ? d.phys : 0;
    __nv_bfloat16* dst = (plane ? a.vn : a.kn)
                         + (((size_t)pn * a.KV + h) * a.page + d.slot) * D;
    for (int j = lane; j < D; j += 32)
      dst[j] = d.keep ? src[j] : __float2bfloat16_rn(0.f);
  }
  if (a.aug) {
    float amax = 0.f;
    for (int j = lane; j < D; j += 32)
      amax = fmaxf(amax, fabsf(__bfloat162float(src[j])));
    const float s = row_scale<QMAX>(group_max(amax, 32));
    const int pp = d.write && d.mode == 1 ? d.phys : 0;
    const size_t at = ((size_t)pp * a.KV + h) * a.page + d.slot;
    if (BITS == 4) {
      uint8_t* dst = (plane ? a.vp : a.kp) + at * (D / 2);
      for (int j = lane; j < D / 2; j += 32) {
        const int hi = level<7>(__bfloat162float(src[2 * j]), s);
        const int lo = level<7>(__bfloat162float(src[2 * j + 1]), s);
        dst[j] = d.keep ? (uint8_t)(((hi & 15) << 4) | (lo & 15)) : 0;
      }
    } else {
      uint8_t* dst = (plane ? a.vp : a.kp) + at * D;
      for (int j = lane; j < D; j += 32)
        dst[j] = d.keep ? (uint8_t)(level<QMAX>(__bfloat162float(src[j]), s)
                                    & 255)
                        : 0;
    }
    if (lane == 0)
      (plane ? a.vs : a.ks)[at] = __float2bfloat16_rn(d.keep ? s : 1.0f);
  }
}

// lanes a row on the vector path (a power of two, at most a warp) and the
// vectors a lane then holds; 0 where D takes the scalar path
inline int lanes_for(int D) {
  if (D % 16 != 0 || D / 8 > 32 * MAX_VPL) return 0;
  int lpr = 1;
  while (lpr < D / 8 && lpr < 32) lpr <<= 1;
  return lpr;
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

template <int BITS>
void launch_write(const PagedWrite& a, int lpr, bool vec, cudaStream_t st) {
  const int rows = 2 * a.B * a.T * a.KV;
  if (!vec) {
    const int per = THREADS / 32;
    paged_write_scalar<BITS><<<(rows + per - 1) / per, THREADS, 0, st>>>(a);
    return;
  }
  const int vpl = (a.D / 8 + lpr - 1) / lpr;
  const int blocks = (int)(((long long)rows * lpr + THREADS - 1) / THREADS);
  if (vpl == 1)
    paged_write_vec<1, BITS><<<blocks, THREADS, 0, st>>>(a, lpr);
  else if (vpl == 2)
    paged_write_vec<2, BITS><<<blocks, THREADS, 0, st>>>(a, lpr);
  else
    paged_write_vec<4, BITS><<<blocks, THREADS, 0, st>>>(a, lpr);
}

template <bool WORDS>
void launch_pack(const void* x, const void* valid, void* packed, void* scale,
                 void* words, int N, int D, cudaStream_t st) {
  const auto* xb = (const __nv_bfloat16*)x;
  const int lpr = lanes_for(D);
  if (lpr == 0 || !aligned16(x) || !aligned16(packed)) {
    const int per = THREADS / 32;
    pack_rows_scalar<WORDS><<<(N + per - 1) / per, THREADS, 0, st>>>(
        xb, (const int*)valid, (uint8_t*)packed, (float*)scale,
        (int64_t*)words, N, D);
    return;
  }
  const int vpl = (D / 8 + lpr - 1) / lpr;
  const int blocks = (int)(((long long)N * lpr + THREADS - 1) / THREADS);
  if (vpl == 1)
    pack_rows_vec<1, WORDS><<<blocks, THREADS, 0, st>>>(
        xb, (const int*)valid, (uint8_t*)packed, (float*)scale,
        (int64_t*)words, N, D, lpr);
  else if (vpl == 2)
    pack_rows_vec<2, WORDS><<<blocks, THREADS, 0, st>>>(
        xb, (const int*)valid, (uint8_t*)packed, (float*)scale,
        (int64_t*)words, N, D, lpr);
  else
    pack_rows_vec<4, WORDS><<<blocks, THREADS, 0, st>>>(
        xb, (const int*)valid, (uint8_t*)packed, (float*)scale,
        (int64_t*)words, N, D, lpr);
}

int pack(const void* x, const void* valid, void* packed, void* scale,
         void* words, int N, int D, void* stream) {
  if (N > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (words != nullptr)
      launch_pack<true>(x, valid, packed, scale, words, N, D, st);
    else
      launch_pack<false>(x, valid, packed, scale, nullptr, N, D, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, D) bf16 contiguous, D even; packed (N, D/2) uint8; scale (N,) f32.
extern "C" int quantize_pack_kv(const void* x, void* packed, void* scale,
                                int N, int D, void* stream) {
  return pack(x, nullptr, packed, scale, nullptr, N, D, stream);
}

// The same with valid (N,) int32: rows with valid == 0 -> 0 bytes, scale 1.
extern "C" int quantize_pack_kv_masked(const void* x, const void* valid,
                                       void* packed, void* scale, int N,
                                       int D, void* stream) {
  return pack(x, valid, packed, scale, nullptr, N, D, stream);
}

// The unmasked pack plus words (N,) int64, the integrity word of each
// packed row (a uint32 value).
extern "C" int quantize_pack_kv_integrity(const void* x, void* packed,
                                          void* scale, void* words, int N,
                                          int D, void* stream) {
  return pack(x, nullptr, packed, scale, words, N, D, stream);
}

// One layer's paged KV write, K and V, in place. k / v (B, T, KV, D) bf16
// by element strides (b, t, head; the last is 1), D even; pos (B, T) int32
// (pos64 = 0) or int64; write / commit (B, T) bool, commit may be null;
// table / modes (>= B, maxP) int32 contiguous; the arena views contiguous:
// kn / vn (Nn, KV, page, D) bf16, kp / vp (Np, KV, page, D/2 | D) uint8 |
// int8, ks / vs (Np, KV, page) bf16. planes: 1 the Normal plane, 2 the
// Augmented plane (the policy's); aug_bits 4 or 8.
extern "C" int paged_kv_write(const void* k, const void* v, const void* pos,
                              const void* write, const void* commit,
                              const void* table, const void* modes, void* kn,
                              void* vn, void* kp, void* vp, void* ks,
                              void* vs, int B, int T, int KV, int D, int page,
                              int maxP, int k_sb, int k_st, int k_sh,
                              int v_sb, int v_st, int v_sh, int pos64,
                              int planes, int aug_bits, void* stream) {
  if (aug_bits != 4 && aug_bits != 8) return (int)cudaErrorInvalidValue;
  PagedWrite a;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.pos = pos;
  a.write = (const uint8_t*)write;
  a.commit = (const uint8_t*)commit;
  a.table = (const int*)table;
  a.modes = (const int*)modes;
  a.kn = (__nv_bfloat16*)kn;
  a.vn = (__nv_bfloat16*)vn;
  a.kp = (uint8_t*)kp;
  a.vp = (uint8_t*)vp;
  a.ks = (__nv_bfloat16*)ks;
  a.vs = (__nv_bfloat16*)vs;
  a.B = B; a.T = T; a.KV = KV; a.D = D; a.page = page; a.maxP = maxP;
  a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.pos64 = pos64;
  a.normal = planes & 1;
  a.aug = (planes >> 1) & 1;
  if (B * T * KV > 0 && (a.normal || a.aug)) {
    const int lpr = lanes_for(D);
    const bool vec = lpr > 0 && aligned16(k) && aligned16(v)
                     && aligned16(kn) && aligned16(vn) && aligned16(kp)
                     && aligned16(vp) && k_sb % 8 == 0 && k_st % 8 == 0
                     && k_sh % 8 == 0 && v_sb % 8 == 0 && v_st % 8 == 0
                     && v_sh % 8 == 0;
    const cudaStream_t st = (cudaStream_t)stream;
    if (aug_bits == 4)
      launch_write<4>(a, lpr, vec, st);
    else
      launch_write<8>(a, lpr, vec, st);
  }
  return (int)cudaGetLastError();
}
