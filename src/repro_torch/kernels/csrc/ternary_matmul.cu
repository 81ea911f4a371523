// Fixed-order tensor-core GEMMs for Hopper (sm_90a): packed-ternary weights
// (entry ternary_matmul) and bf16 weights (entry dense_matmul), one kernel
// template with three weight loaders.
//
// ternary_matmul replaces
// repro/kernels/ternary_matmul.py:ternary_matmul_pallas:
// y[m, n] = bf16((sum_k x[m, k] * trit[k, n]) * scale[n]), f32 accumulate,
// where w (K/4, N) uint8 holds four 2-bit digits per byte along K (digit i
// at bits 2i..2i+1, trit = digit - 1) and scale (1, N) is float32.
// dense_matmul has no TPU kernel: the JAX package leaves the projections
// that stay bf16 in dual mode (wq, wo, w_down; repro/models/augment.py:124
// and :159) and the tied LM head (repro/models/layers.py:199) to XLA. It
// computes y = bf16(x @ w) with w (K, N) ("kn") or w (N, K) ("nk", the
// embedding read in place as the tied head).
//
// Order (what makes a row's bits independent of M). Every output is ONE
// chain of bf16 mma.sync.m16n8k16 (f32 accumulate) over its K split's
// 16-deep steps in increasing k; the split count S comes from (K, N) alone
// (kernels/ternary_matmul.py:split_plan, at most 8) and split s covers the
// 64-deep stages [s*T/S, (s+1)*T/S) of the T = K/64; the S CTAs of an
// output tile form one thread-block cluster, each leaves its f32 partial
// in its own shared memory, and after a cluster barrier the S partials are
// added in split order (((p0 + p1) + p2) ...) through distributed shared
// memory, each CTA finishing a share of the tile: no global workspace, no
// atomics, no second kernel, no host sync. Nothing in that chain depends
// on M or on a row's position in its tile, so a verify window (M = 4 x
// spec_k) and a decode step (M = 4) give each row the same bits. The M
// tile (16 or 64 rows) is picked from M for speed only.
//
// K permutation. Within each 16-deep step, mma k positions {2t, 2t+1,
// 2t+8, 2t+9} of lane t (t = lane % 4) take the logical k 4t..4t+3, the
// same for A and B at every M: so one packed byte is one lane's whole B
// fragment (b0 = trits 4t, 4t+1; b1 = trits 4t+2, 4t+3), unpacked in
// registers (two byte permutes: a trit is exact in bf16) with no
// shared-memory round trip, and A is read as 8-byte vectors. The "nk"
// head reads its B rows the same way; "kn" weights are stored in shared
// memory with their k rows permuted so ldmatrix.trans yields the same
// fragments.
//
// Bound: at decode (M = batch) the weight stream (K*N/4 bytes ternary,
// 2*K*N bf16), at prefill the multiply-adds. Weights stream through a
// 3- or 4-stage cp.async ring of 64-deep stages with 16-byte loads; the K
// split spreads a layer's columns over about 132 CTAs whatever M is (qwen's
// N = 1024 gives 16 column tiles x 8 splits). At prefill the kernel waits
// on that ring and on the cluster's slowest split (PERF.md).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BN = 64;          // output columns per CTA
constexpr int BK = 64;          // K per pipeline stage: the unit of the split
constexpr int THREADS = 128;    // 4 warps
// cp.async ring depth: 4 stages for decode-sized (16-row) tiles, whose
// CTAs wait on the weight stream; 3 for 64-row tiles
__host__ __device__ constexpr int stages_for(int BM) {
  return BM <= 16 ? 4 : 3;
}
constexpr int A_LD = BK + 16;   // bf16 per A row in shared memory (160 B)
constexpr int MAX_SPLITS = 8;   // CTAs a cluster (the portable maximum)
constexpr int P_LD = BN + 8;    // floats a partial row in shared memory

struct Params {
  const __nv_bfloat16* x;  // (M, K)
  const void* w;           // the loader's layout
  const float* scale;      // (N,) ternary only
  __nv_bfloat16* y;        // (M, N)
  int M, K, N, S;
};

// Two 2-bit digits (bits 0-1, 2-3 of v) -> two bf16 trits (digit - 1) in
// one register, lower k in the low half: each output byte is picked from
// the bf16 bytes of -1, 0, +1, +2 (low bytes 80 00 80 00, high bytes
// BF 00 3F 40).
__device__ __forceinline__ uint32_t trit_pair(uint32_t v) {
  const uint32_t d0 = v & 3u, d1 = (v >> 2) & 3u;
  return __byte_perm(0x403F00BFu, 0x00800080u,
                     (d0 | 4u) | (d0 << 4) | ((d1 | 4u) << 8) | (d1 << 12));
}

// ---- weight loaders: a 64-deep stage of B into shared memory, and one
// 16-deep step's fragments of the warp's NT n8 tiles ----------------------

struct TernaryB {                     // w (K/4, N) uint8
  static constexpr int LD = BN + 32;  // bytes a packed row (96: no conflicts)
  static constexpr int STAGE_BYTES = (BK / 4) * LD;
  static constexpr bool SCALED = true;
  __device__ static void load(uint8_t* s, const Params& p, int n0, int kt,
                              int tid) {
    if (tid < (BK / 4) * (BN / 16)) {  // 64 chunks of 16 bytes
      const int r = tid / (BN / 16), q = tid % (BN / 16);
      cp_async16(s + r * LD + 16 * q,
                 (const uint8_t*)p.w + (size_t)(kt * (BK / 4) + r) * p.N +
                     n0 + 16 * q);
    }
  }
  template <int NT>
  __device__ static void frags(const uint8_t* s, int wn0, int c, int lane,
                               uint32_t (&b)[NT][2]) {
    const uint8_t* row = s + (4 * c + (lane & 3)) * LD + wn0 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t v = row[8 * j];
      b[j][0] = trit_pair(v);
      b[j][1] = trit_pair(v >> 4);
    }
  }
};

struct DenseNK {                      // w (N, K) bf16: the tied head
  static constexpr int LD = BK + 16;  // bf16 a row (160 B)
  static constexpr int STAGE_BYTES = BN * LD * 2;
  static constexpr bool SCALED = false;
  __device__ static void load(uint8_t* s, const Params& p, int n0, int kt,
                              int tid) {
    __nv_bfloat16* d = (__nv_bfloat16*)s;
    const __nv_bfloat16* w = (const __nv_bfloat16*)p.w;
#pragma unroll
    for (int i = 0; i < BN * BK / 8 / THREADS; ++i) {
      const int idx = tid + THREADS * i, r = idx >> 3, q = idx & 7;
      cp_async16(d + r * LD + 8 * q,
                 w + (size_t)(n0 + r) * p.K + kt * BK + 8 * q);
    }
  }
  template <int NT>
  __device__ static void frags(const uint8_t* s, int wn0, int c, int lane,
                               uint32_t (&b)[NT][2]) {
    const __nv_bfloat16* d = (const __nv_bfloat16*)s;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          d + (wn0 + 8 * j + (lane >> 2)) * LD + 16 * c + 4 * (lane & 3));
      b[j][0] = v.x;
      b[j][1] = v.y;
    }
  }
};

struct DenseKN {                      // w (K, N) bf16
  static constexpr int LD = BN + 8;   // bf16 a row (144 B)
  static constexpr int STAGE_BYTES = BK * LD * 2;
  static constexpr bool SCALED = false;
  // k = 16c + 4a + b lands in row 16c + 8(b >> 1) + 2a + (b & 1): rows
  // 0-7 of a step hold k {0,1,4,5,8,9,12,13}, rows 8-15 the rest
  __device__ static int row_of(int k) {
    return (k & ~15) | ((k >> 1) & 1) << 3 | ((k >> 2) & 3) << 1 | (k & 1);
  }
  __device__ static void load(uint8_t* s, const Params& p, int n0, int kt,
                              int tid) {
    __nv_bfloat16* d = (__nv_bfloat16*)s;
    const __nv_bfloat16* w = (const __nv_bfloat16*)p.w;
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
      const int idx = tid + THREADS * i, r = idx >> 3, q = idx & 7;
      cp_async16(d + row_of(r) * LD + 8 * q,
                 w + (size_t)(kt * BK + r) * p.N + n0 + 8 * q);
    }
  }
  template <int NT>
  __device__ static void frags(const uint8_t* s, int wn0, int c, int lane,
                               uint32_t (&b)[NT][2]) {
    const __nv_bfloat16* d = (const __nv_bfloat16*)s;
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      // matrices: (rows 0-7 | 8-15) x (n tile 2jj | 2jj + 1); transposed,
      // lane (g, t) gets rows 2t, 2t+1 of column g: k 4t, 4t+1 | 4t+2, 4t+3
      const __nv_bfloat16* a = d + (16 * c + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * LD +
                               wn0 + 16 * jj + 8 * (lane >> 4);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(b[2 * jj][0]), "=r"(b[2 * jj][1]), "=r"(b[2 * jj + 1][0]),
            "=r"(b[2 * jj + 1][1])
          : "r"(smem_u32(a)));
    }
  }
};

// BM rows x 64 columns a CTA, grid (N/64, cdiv(M, BM), S). Each warp takes
// all BM rows and 16 columns, so a ternary byte unpacked in registers
// feeds MT = BM / 16 MMAs.
template <class LD, int BM>
__global__ void __launch_bounds__(THREADS) fixed_order_gemm(Params p) {
  constexpr int MT = BM / 16;            // m16 tiles a warp
  constexpr int NT = BN / 8 / (THREADS / 32);   // n8 tiles a warp: 2
  constexpr int STAGES = stages_for(BM);
  constexpr int A_BYTES = BM * A_LD * 2;
  constexpr int STAGE = A_BYTES + LD::STAGE_BYTES;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn0 = warp * NT * 8;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int T = p.K / BK;
  const int k0 = (int)((long long)split * T / p.S);
  const int nk = (int)((long long)(split + 1) * T / p.S) - k0;

  auto load = [&](int st, int kt) {
    __nv_bfloat16* as = (__nv_bfloat16*)(smem + st * STAGE);
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {   // BM rows x 8 chunks
      const int idx = tid + THREADS * i, r = idx >> 3, q = idx & 7;
      const int m = m0 + r;
      cp_async16(as + r * A_LD + 8 * q,
                 p.x + (size_t)min(m, p.M - 1) * p.K + kt * BK + 8 * q,
                 m < p.M ? 16 : 0);
    }
    LD::load(smem + st * STAGE + A_BYTES, p, n0, kt, tid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load(i, k0 + i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();      // stage i landed; stage i - 1 is no longer read
    if (i + STAGES - 1 < nk)
      load((i + STAGES - 1) % STAGES, k0 + i + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* as =
        (const __nv_bfloat16*)(smem + (i % STAGES) * STAGE);
    const uint8_t* bs = smem + (i % STAGES) * STAGE + A_BYTES;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* r0 = as + (16 * mt + g) * A_LD + 16 * c + 4 * t;
        const uint2 lo = *reinterpret_cast<const uint2*>(r0);
        const uint2 hi = *reinterpret_cast<const uint2*>(r0 + 8 * A_LD);
        a[mt][0] = lo.x;   // row g,     k 4t, 4t+1
        a[mt][1] = hi.x;   // row g + 8, k 4t, 4t+1
        a[mt][2] = lo.y;   // row g,     k 4t+2, 4t+3
        a[mt][3] = hi.y;   // row g + 8, k 4t+2, 4t+3
      }
      LD::template frags<NT>(bs, wn0, c, lane, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[mt][j], a[mt], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  if (p.S == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * mt + g + 8 * h;
          const int n = n0 + wn0 + 8 * j + 2 * t;
          if (m < p.M) {
            float v0 = acc[mt][j][2 * h], v1 = acc[mt][j][2 * h + 1];
            if (LD::SCALED) {
              v0 *= p.scale[n];
              v1 *= p.scale[n + 1];
            }
            *reinterpret_cast<__nv_bfloat162*>(p.y + (size_t)m * p.N + n) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
    return;
  }

  // this split's partial tile into this CTA's shared memory (the ring is
  // free once every warp is past its last stage)
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            part + (16 * mt + g + 8 * h) * P_LD + wn0 + 8 * j + 2 * t) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // CTA `split` finishes every S-th float4 of the tile: the S partials read
  // from the cluster's shared memory at once, added in split order
  for (int i = split * THREADS + tid; i < BM * BN / 4; i += p.S * THREADS) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    const int m = m0 + r, n = n0 + c;
    if (m >= p.M) continue;
    float4 u[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < p.S)
        u[s] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, s) + r * P_LD + c);
    float4 v = u[0];
#pragma unroll
    for (int s = 1; s < MAX_SPLITS; ++s)
      if (s < p.S) {
        v.x += u[s].x;
        v.y += u[s].y;
        v.z += u[s].z;
        v.w += u[s].w;
      }
    if (LD::SCALED) {
      v.x *= p.scale[n];
      v.y *= p.scale[n + 1];
      v.z *= p.scale[n + 2];
      v.w *= p.scale[n + 3];
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 out;
    out.x = *reinterpret_cast<const uint32_t*>(&lo);
    out.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p.y + (size_t)m * p.N + n) = out;
  }
  cluster.sync();   // no CTA leaves while another still reads its partial
}

template <class LD, int BM>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = stages_for(BM) * (BM * A_LD * 2 + LD::STAGE_BYTES);
  static_assert(BM * P_LD * 4 <= smem, "the partial tile reuses the ring");
  auto kern = fixed_order_gemm<LD, BM>;
  if (smem > 48 * 1024) {
    static bool opted_in = false;
    if (!opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      opted_in = true;
    }
  }
  // the S splits of a tile are one cluster (1, 1, S) along the grid's z
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = p.S;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / BN, (p.M + BM - 1) / BM, p.S);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, p);
}

// the M tile follows M (speed only: no row's bits depend on it)
template <class LD>
int dispatch(const Params& p, cudaStream_t stream) {
  return p.M <= 16 ? launch<LD, 16>(p, stream) : launch<LD, 64>(p, stream);
}

}  // namespace

// x (M, K) bf16, w as the entry says, y (M, N) bf16, all contiguous and
// 16-byte aligned; K % 64 == 0, N % 64 == 0, 1 <= S <= min(K / 64, 8)
// (checked by the wrappers, kernels/ternary_matmul.py).
// w (K/4, N) uint8 packed trits, scale (N,) f32.
extern "C" int ternary_matmul(const void* x, const void* w, const void* scale,
                              void* y, int M, int K, int N, int S,
                              void* stream) {
  const Params p{(const __nv_bfloat16*)x, w, (const float*)scale,
                 (__nv_bfloat16*)y, M, K, N, S};
  return dispatch<TernaryB>(p, (cudaStream_t)stream);
}

// w (K, N) bf16 when w_nk == 0, (N, K) bf16 (the tied head) when 1.
extern "C" int dense_matmul(const void* x, const void* w, void* y, int M,
                            int K, int N, int S, int w_nk, void* stream) {
  const Params p{(const __nv_bfloat16*)x, w, nullptr, (__nv_bfloat16*)y,
                 M, K, N, S};
  return w_nk ? dispatch<DenseNK>(p, (cudaStream_t)stream)
              : dispatch<DenseKN>(p, (cudaStream_t)stream);
}
