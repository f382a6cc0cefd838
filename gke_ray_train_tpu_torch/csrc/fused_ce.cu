// Fused cross-entropy over the vocab for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces the three Pallas TPU kernels of
// gke_ray_train_tpu/ops/fused_ce.py, which compute `token_nll` of the
// logits x @ head without ever materializing the [N, V] logits:
//
// - fused_ce_row_stats replaces `_fwd_kernel` (:70, launched by
//   `_row_stats` :164): per row, lse = logsumexp_v(x @ head) with an fp32
//   online max / sum over vocab tiles, and the target logit gathered in
//   the tile whose column range holds the label. A label outside [0, V)
//   matches no column and gives a target logit of 0 (:88-95).
// - fused_ce_dx replaces `_dx_kernel` (:106, via `_grads` :200):
//   dx = ((softmax - onehot) * wg) @ head^T, the logits recomputed.
// - fused_ce_dhead replaces `_dhead_kernel` (:133): dhead = x^T @
//   ((softmax - onehot) * wg), the logits recomputed.
//
// Bound. At the Llama-3.1-8B training microbatch (N = 2,048 rows, D =
// 4,096, V = 128,256, bf16) the row statistics are one product of
// 2 N D V = 2.15 TFLOP over 1.07 GB of operands: 2.18 ms of bf16 tensor
// cores against 0.32 ms of memory, so they are bound by operations; dx and
// dhead are two products each (the recompute and the gradient product),
// 4.35 ms.
//
// Design. The TPU grid walks vocab tiles in order inside one core and
// carries its row statistics, and the dx / dhead accumulators, in VMEM
// ([256, 4,096] fp32 for dx: 4 MB). An SM has 228 KB of shared memory,
// and 8 row tiles would fill 8 of 132 SMs, so the work is cut anew:
//
// - Row statistics: a grid of (row tile, vocab split). Each CTA walks its
//   vocab tiles, each thread carries (m, l, t) of its rows over its own
//   columns online, and at the end the threads that share a row merge
//   theirs into one per-split partial. A second small launch merges the
//   splits exactly, the merge JAX uses across vocab shards (:282-284): m =
//   max m_s, l = sum l_s exp(m_s - m), t = sum t_s, lse = m + log l.
// - Backward: the vocab is cut into chunks of `chunk` columns (the
//   caller's dl scratch width, 8,192 from ops/fused_ce.py). Per chunk a
//   dlogits launch recomputes the logits tile by tile and writes dl =
//   (exp(logit - lse) - [col = target]) * wg into an [N, chunk] scratch
//   in the input dtype (33.5 MB in bf16 at N = 2,048, against 1.05 GB of
//   fp32 logits); then the dx launch adds dl @ head_c^T into an fp32
//   [N, D] buffer (rounded to the input dtype once, in the last chunk's
//   epilogue), or the dhead launch writes x^T @ dl into dhead[:, chunk].
//   dx and dhead each recompute dl, as the two TPU kernels do. Every
//   output element is summed by one CTA in a fixed order (no split-K, no
//   atomics), so two runs on the same inputs agree bitwise.
//
// Three GEMM bodies run these products, the route chosen by the caller
// (ops/fused_ce.py::grad_route, from shapes, dtype and alignment) and
// refused here with cudaErrorInvalidValue where the shape does not fit:
//
// - wgmma (bf16, D % 8 == 0, V % 8 == 0, 16-byte aligned operands: the
//   rows TMA can address). For the backward's products one persistent
//   CTA of three warpgroups per SM walks the 128 x 256 output tiles: one
//   producer warp starts 2-D TMA loads of 64-deep K slices (128-byte
//   swizzled 64-column blocks, hopper.cuh) into a 4-stage ring with
//   mbarrier full / empty pairs, running on into the next tile while the
//   consumers finish the last; two consumer warpgroups each run wgmma
//   m64n256k16 from shared memory into 128 fp32 registers a thread (168
//   registers, no spills: ptxas's cap for a 384-thread CTA), one commit
//   group kept in flight while the next slice's products start; the
//   epilogue runs from registers. Operands are read in their own layouts
//   through wgmma's transpose immediates: dlogits = x (K-major) @ head
//   (MN-major, the vocab contiguous), dx = dl (K-major) @ head rows
//   (K-major), dhead = x^T (MN-major) @ dl (MN-major). The dl map of
//   each chunk is `vc` columns wide, so the dx and dhead products read
//   zeros past the chunk's last column (never the scratch's stale tail)
//   and the dlogits epilogue stores only columns < vc. Its exp is
//   ex2.approx of a log2e-prescaled argument, fma(logit, log2e, -lse
//   log2e). dx's epilogue loads the earlier chunks' fp32 sums in groups
//   before it stores any, so that their memory round trips overlap.
//   The row statistics run dlogits' product (x @ head, over the whole
//   vocab) on the same body, one CTA a (row tile, vocab split): at N
//   2,048 16 row tiles x 8 splits of 63 vocab tiles, 128 CTAs on 132 SMs,
//   the CTAs of a split walking the same head tiles in step. Their
//   epilogue carries (m, l, t) in registers from tile to tile: each row's
//   tile maximum, then one ex2.approx per element, the label gathered in
//   its column, columns past V (zero-filled by TMA) kept out of all three;
//   the 4 lanes of a row merge by shuffles at the end of the split.
// - mma_sync (bf16 shapes TMA cannot take): a
//   CTA of 8 warps computes a 128 x 128 tile, the K loop staging 32-deep
//   slices of both operands in shared memory through a 3-stage cp.async
//   ring, in the operands' own global layouts (K-, M- or N-contiguous);
//   `ldmatrix` (with `.trans` where a tile is not K-contiguous) builds
//   the fragments of `mma.sync` m16n8k16 (bf16 in, fp32 accumulate).
//   Each warp holds a 64 x 32 accumulator.
// - fp32 (the parity runs, TF32 off): a scalar fp32 FMA body of the same
//   tile and thread mapping as mma_sync, as the flash kernels keep.
//
// bf16 rounds dl to bf16 before the dx / dhead products, where the TPU
// kernels keep it in fp32 (the same kind of rounding point as P and dS in
// flash_bwd.cu); the plain version keeps fp32.
//
// Any N, D, V >= 1 on the mma_sync and fp32 routes: ragged tiles are
// masked on load (zeros) and on store; 16-byte copies where a matrix's
// rows start 16-byte aligned, element copies elsewhere. On the wgmma
// route TMA zero-fills past every edge and the epilogue masks stores.
//
// Later work: one dlogits pass shared by dx and dhead in full
// fine-tuning; a cluster of CTAs splitting
// D and summing partial logits through distributed shared memory, so
// that dl never leaves the chip.
//
// The C entry points return cudaGetLastError() after their launches; the
// Python wrappers raise when that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -2.0e38f;  // ops/attention.py NEG_INF
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 128;             // CTA tile rows
constexpr int kBN = 128;             // CTA tile columns
constexpr int kThreads = 256;        // 8 warps
constexpr int kSlots = 8;            // accumulator rows a thread holds
constexpr int kCols = 8;             // accumulator columns a thread holds
constexpr int kShare = 16;           // threads that share one tile row
constexpr size_t kRedBytes = size_t(kBM) * kShare * 3 * sizeof(float);

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane l holds matrix i's row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 (`.trans`: column l / 4, rows 2 (l % 4), +1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 acc.
// Fragment layout (lane = 4 g + t): a = {A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [0, R) x columns [0, C) of a row-major matrix at g (leading
// dimension ldg; rows < rlim and columns < clim exist) into shared memory
// with leading dimension lds. What does not exist reads as 0. 16-byte
// cp.async where `vec` (rows 16-byte aligned) and the chunk is whole.
template <int R, int C>
__device__ __forceinline__ void stage_tile(bf16* s, int lds, const bf16* g,
                                           size_t ldg, int rlim, int clim,
                                           bool vec) {
  constexpr int CH = C / 8;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* dst = s + r * lds + c;
    if (vec && r < rlim && c + 8 <= clim) {
      cp_async16(dst, g + r * ldg + c);
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (r < rlim && c + e < clim) ? g[r * ldg + c + e]
                                          : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

struct MmaBody {
  static constexpr int BK = 32;          // K slice per stage
  static constexpr int STAGES = 3;
  static constexpr int LD_K = BK + 8;    // K-contiguous tile rows (bf16)
  static constexpr int LD_MN = kBM + 8;  // M- or N-contiguous tile rows
  static constexpr int TILE =
      kBM * LD_K > BK * LD_MN ? kBM * LD_K : BK * LD_MN;
  static constexpr size_t SMEM = size_t(2) * STAGES * TILE * sizeof(bf16);

  // accumulator slot s / column j of this thread -> tile row / column
  __device__ static int row(int s) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp >> 2) * 64 + (s >> 1) * 16 + (lane >> 2) + (s & 1) * 8;
  }
  __device__ static int col(int j) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp & 3) * 32 + (j >> 1) * 8 + 2 * (lane & 3) + (j & 1);
  }
  // which of the kShare threads of its rows this one is
  __device__ static int share() {
    return ((threadIdx.x >> 5) & 3) * 4 + (threadIdx.x & 3);
  }

  // acc = A (kBM x K) @ B (K x kBN). A_K: A is K-contiguous (a[m * lda +
  // k]), else M-contiguous (a[k * lda + m]); B_K: B is K-contiguous
  // (b[n * ldb + k]), else N-contiguous (b[k * ldb + n]). a / b point at
  // the tile's origin; rows m < mlim and columns n < nlim exist.
  template <bool A_K, bool B_K>
  __device__ static void gemm(float (&acc)[kSlots][kCols], const bf16* a,
                              size_t lda, int mlim, const bf16* b, size_t ldb,
                              int nlim, int K, unsigned char* smem_raw) {
    bf16* As = reinterpret_cast<bf16*>(smem_raw);
    bf16* Bs = As + STAGES * TILE;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3;
    const bool va = ((reinterpret_cast<uintptr_t>(a) & 15) | (lda & 7)) == 0;
    const bool vb = ((reinterpret_cast<uintptr_t>(b) & 15) | (ldb & 7)) == 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[s][j] = 0.f;

    const int nk = (K + BK - 1) / BK;
    auto load = [&](int stage, int kt) {
      const int k0 = kt * BK;
      bf16* as = As + stage * TILE;
      bf16* bs = Bs + stage * TILE;
      if (A_K)
        stage_tile<kBM, BK>(as, LD_K, a + k0, lda, mlim, K - k0, va);
      else
        stage_tile<BK, kBM>(as, LD_MN, a + size_t(k0) * lda, lda, K - k0,
                            mlim, va);
      if (B_K)
        stage_tile<kBN, BK>(bs, LD_K, b + k0, ldb, nlim, K - k0, vb);
      else
        stage_tile<BK, kBN>(bs, LD_MN, b + size_t(k0) * ldb, ldb, K - k0,
                            nlim, vb);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      // slice kt has landed, and every warp is done with slice kt - 1,
      // whose buffer the next load refills
      __syncthreads();
      const int next = kt + STAGES - 1;
      if (next < nk) load(next % STAGES, next);
      cp_async_commit();
      const bf16* as = As + (kt % STAGES) * TILE;
      const bf16* bs = Bs + (kt % STAGES) * TILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[4][4], bfr[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int m = wm * 64 + mt * 16;
          if (A_K)
            ldsm_x4(af[mt], as + (m + (lane & 15)) * LD_K + kk * 16 +
                                (lane >> 4) * 8);
          else
            ldsm_x4_t(af[mt], as + (kk * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       LD_MN +
                                   m + ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int n = wn * 32 + np * 16;
          uint32_t r[4];
          if (B_K)
            ldsm_x4(r, bs + (n + (lane >> 4) * 8 + (lane & 7)) * LD_K +
                           kk * 16 + ((lane >> 3) & 1) * 8);
          else
            ldsm_x4_t(r, bs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  LD_MN +
                              n + (lane >> 4) * 8);
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[2 * mt][2 * nt], acc[2 * mt][2 * nt + 1],
                     acc[2 * mt + 1][2 * nt], acc[2 * mt + 1][2 * nt + 1],
                     af[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the caller may reuse shared memory
  }
};

// ---------------------------------------------------------------------------
// fp32 scalar body
// ---------------------------------------------------------------------------

struct ScalarBody {
  static constexpr int BK = 16;
  static constexpr int LD = kBM + 4;  // floats per shared row ([k][m | n])
  static constexpr size_t SMEM = size_t(2) * BK * LD * sizeof(float);

  // a 16 x 16 thread grid; thread (ty, tx) holds rows {ty*4 + i, 64 +
  // ty*4 + i} and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4, so the
  // float4 reads of a quarter warp cover 128 contiguous bytes
  __device__ static int row(int s) {
    return (s >> 2) * 64 + (threadIdx.x >> 4) * 4 + (s & 3);
  }
  __device__ static int col(int j) {
    return (j >> 2) * 64 + (threadIdx.x & 15) * 4 + (j & 3);
  }
  __device__ static int share() { return threadIdx.x & 15; }

  // the tile of A or B as [k][m | n] in shared memory
  template <bool KCONTIG>
  __device__ static void stage(float* s, const float* g, size_t ld, int lim,
                               int k0, int K) {
    if (KCONTIG) {  // g[m * ld + k]
      for (int i = threadIdx.x; i < kBM * BK; i += kThreads) {
        const int m = i / BK, k = i % BK;
        s[k * LD + m] =
            (m < lim && k0 + k < K) ? g[size_t(m) * ld + k0 + k] : 0.f;
      }
    } else {  // g[k * ld + m]
      for (int i = threadIdx.x; i < BK * kBM; i += kThreads) {
        const int k = i / kBM, m = i % kBM;
        s[k * LD + m] =
            (k0 + k < K && m < lim) ? g[size_t(k0 + k) * ld + m] : 0.f;
      }
    }
  }

  template <bool A_K, bool B_K>
  __device__ static void gemm(float (&acc)[kSlots][kCols], const float* a,
                              size_t lda, int mlim, const float* b,
                              size_t ldb, int nlim, int K,
                              unsigned char* smem_raw) {
    float* As = reinterpret_cast<float*>(smem_raw);
    float* Bs = As + BK * LD;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[s][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      stage<A_K>(As, a, lda, mlim, k0, K);
      stage<B_K>(Bs, b, ldb, nlim, k0, K);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        const float* ak = As + k * LD + ty * 4;
        const float* bk = Bs + k * LD + tx * 4;
        const float4 a0 = *reinterpret_cast<const float4*>(ak);
        const float4 a1 = *reinterpret_cast<const float4*>(ak + 64);
        const float4 b0 = *reinterpret_cast<const float4*>(bk);
        const float4 b1 = *reinterpret_cast<const float4*>(bk + 64);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[s][j] = fmaf(av[s], bv[j], acc[s][j]);
      }
      __syncthreads();
    }
  }
};

template <typename T>
struct Body;
template <>
struct Body<bf16> : MmaBody {};
template <>
struct Body<float> : ScalarBody {};

template <typename T>
constexpr size_t smem_bytes() {
  return Body<T>::SMEM > kRedBytes ? Body<T>::SMEM : kRedBytes;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// One (row tile, vocab split): per-split partial (m, l, t) of each row,
// part[(split * 3 + {0, 1, 2}) * N + row].
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ x, const T* __restrict__ head,
                 const int* __restrict__ targets, float* __restrict__ part,
                 int N, int D, int V, int tiles_per_split) {
  using B = Body<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int n_vt = (V + kBN - 1) / kBN;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, n_vt);

  int tr[kSlots];
  float m[kSlots], l[kSlots], t[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int r = m0 + B::row(s);
    tr[s] = r < N ? targets[r] : -1;
    m[s] = kNegInf;
    l[s] = 0.f;
    t[s] = 0.f;
  }
  float acc[kSlots][kCols];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int n0 = vt * kBN;
    B::template gemm<true, false>(acc, x + size_t(m0) * D, D, N - m0,
                                  head + n0, V, V - n0, D, smem_raw);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (n0 + B::col(j) < V) mx = fmaxf(mx, acc[s][j]);
      const float m_new = fmaxf(m[s], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = n0 + B::col(j);
        if (c < V) {
          sum += expf(acc[s][j] - m_new);
          // the label gather: only the label's own column matches
          if (c == tr[s]) t[s] += acc[s][j];
        }
      }
      l[s] = l[s] * expf(m[s] - m_new) + sum;
      m[s] = m_new;
    }
  }
  // the kShare threads of each row merge their (m, l, t)
  float* red = reinterpret_cast<float*>(smem_raw);  // [kBM][kShare][3]
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    float* q = red + (B::row(s) * kShare + B::share()) * 3;
    q[0] = m[s];
    q[1] = l[s];
    q[2] = t[s];
  }
  __syncthreads();
  if (threadIdx.x < kBM && m0 + int(threadIdx.x) < N) {
    const float* q = red + threadIdx.x * kShare * 3;
    float M = kNegInf, L = 0.f, Tt = 0.f;
    for (int i = 0; i < kShare; ++i) M = fmaxf(M, q[3 * i]);
    for (int i = 0; i < kShare; ++i) {
      L += q[3 * i + 1] * expf(q[3 * i] - M);
      Tt += q[3 * i + 2];
    }
    const size_t r = size_t(m0) + threadIdx.x;
    part[size_t(split) * 3 * N + r] = M;
    part[(size_t(split) * 3 + 1) * N + r] = L;
    part[(size_t(split) * 3 + 2) * N + r] = Tt;
  }
}

// The exact merge of the splits' partials: lse = m + log(l), tgt = sum t.
__global__ void merge_kernel(const float* __restrict__ part,
                             float* __restrict__ lse, float* __restrict__ tgt,
                             int N, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part[size_t(s) * 3 * N + r]);
  float L = 0.f, Tt = 0.f;
  for (int s = 0; s < splits; ++s) {
    L += part[(size_t(s) * 3 + 1) * N + r] *
         expf(part[size_t(s) * 3 * N + r] - M);
    Tt += part[(size_t(s) * 3 + 2) * N + r];
  }
  lse[r] = M + logf(L);
  tgt[r] = Tt;
}

// dl[r][c] = (exp(logit - lse[r]) - [c0 + c = target[r]]) * wg[r] for the
// chunk's columns c < vc, 0 beyond; dl rows are ldl long.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dlogits_kernel(const T* __restrict__ x, const T* __restrict__ head,
               const int* __restrict__ targets, const float* __restrict__ wg,
               const float* __restrict__ lse, T* __restrict__ dl, int ldl,
               int N, int D, int V, int c0, int vc) {
  using B = Body<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[kSlots][kCols];
  B::template gemm<true, false>(acc, x + size_t(m0) * D, D, N - m0,
                                head + c0 + n0, V, vc - n0, D, smem_raw);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int r = m0 + B::row(s);
    if (r >= N) continue;
    const float lr = lse[r], wr = wg[r];
    const int tr = targets[r];
    T* out = dl + size_t(r) * ldl + n0;
#pragma unroll
    for (int j = 0; j < kCols; j += 2) {
      const int c = n0 + B::col(j);  // even; c + 1 is column j + 1
      const float v0 =
          c < vc ? (expf(acc[s][j] - lr) - (c0 + c == tr ? 1.f : 0.f)) * wr
                 : 0.f;
      const float v1 =
          c + 1 < vc ? (expf(acc[s][j + 1] - lr) -
                        (c0 + c + 1 == tr ? 1.f : 0.f)) * wr
                     : 0.f;
      store2(out + B::col(j), v0, v1);
    }
  }
}

// acc_buf (+)= dl @ head[:, c0:c0+vc]^T; the last chunk writes dx instead.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ dl, int ldl, const T* __restrict__ head,
          float* acc_buf, T* dx, int N, int D, int V, int c0, int vc,
          int first, int last) {
  using B = Body<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[kSlots][kCols];
  // head^T as the K-contiguous B: b[n = d][k = v] = head[d * V + c0 + v]
  B::template gemm<true, true>(acc, dl + size_t(m0) * ldl, ldl, N - m0,
                               head + size_t(n0) * V + c0, V, D - n0, vc,
                               smem_raw);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int r = m0 + B::row(s);
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = n0 + B::col(j);
      if (d >= D) continue;
      const size_t i = size_t(r) * D + d;
      const float v = acc[s][j] + (first ? 0.f : acc_buf[i]);
      if (last)
        dx[i] = from_float<T>(v);
      else
        acc_buf[i] = v;
    }
  }
}

// dhead[:, c0:c0+vc] = x^T @ dl.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dhead_kernel(const T* __restrict__ x, const T* __restrict__ dl, int ldl,
             T* __restrict__ dhead, int N, int D, int V, int c0, int vc) {
  using B = Body<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[kSlots][kCols];
  // x^T as the M-contiguous A: a[m = d][k = n] = x[n * D + d]; dl as the
  // N-contiguous B
  B::template gemm<false, false>(acc, x + m0, D, D - m0, dl + n0, ldl,
                                 vc - n0, N, smem_raw);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int d = m0 + B::row(s);
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = n0 + B::col(j);
      if (c < vc) dhead[size_t(d) * V + c0 + c] = from_float<T>(acc[s][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// As many vocab splits as the CTA budget `ctas` allows over the row tiles
// (at least one, at most one vocab tile a split); ctas is also the
// partials' capacity in splits.
template <typename T>
cudaError_t row_stats(const void* x, const void* head, const int* targets,
                      float* part, float* lse, float* tgt, int N, int D, int V,
                      int ctas, cudaStream_t st) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = allow_smem(row_stats_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int n_vt = cdiv(V, kBN);
  const int splits = std::max(1, std::min(ctas / cdiv(N, kBM), n_vt));
  const int per = cdiv(n_vt, splits);
  row_stats_kernel<T><<<dim3(cdiv(N, kBM), splits), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(head), targets, part, N,
      D, V, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<cdiv(N, 256), 256, 0, st>>>(part, lse, tgt, N, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dlogits(const void* x, const void* head, const int* targets,
                    const float* wg, const float* lse, void* dl, int ldl, int N,
                    int D, int V, int c0, int vc, cudaStream_t st) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = allow_smem(dlogits_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dlogits_kernel<T><<<dim3(cdiv(N, kBM), cdiv(vc, kBN)), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(head), targets, wg, lse,
      static_cast<T*>(dl), ldl, N, D, V, c0, vc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t grads_dx(const void* x, const void* head, const int* targets,
                     const float* wg, const float* lse, void* dl, int chunk,
                     float* acc, void* dx, int N, int D, int V,
                     cudaStream_t st) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = allow_smem(dx_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  for (int c0 = 0; c0 < V; c0 += chunk) {
    const int vc = std::min(chunk, V - c0);
    err = dlogits<T>(x, head, targets, wg, lse, dl, chunk, N, D, V, c0, vc,
                     st);
    if (err != cudaSuccess) return err;
    dx_kernel<T><<<dim3(cdiv(N, kBM), cdiv(D, kBN)), kThreads, smem, st>>>(
        static_cast<const T*>(dl), chunk, static_cast<const T*>(head), acc,
        static_cast<T*>(dx), N, D, V, c0, vc, int(c0 == 0),
        int(c0 + chunk >= V));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t grads_dhead(const void* x, const void* head, const int* targets,
                        const float* wg, const float* lse, void* dl, int chunk,
                        void* dhead, int N, int D, int V, cudaStream_t st) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = allow_smem(dhead_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  for (int c0 = 0; c0 < V; c0 += chunk) {
    const int vc = std::min(chunk, V - c0);
    err = dlogits<T>(x, head, targets, wg, lse, dl, chunk, N, D, V, c0, vc,
                     st);
    if (err != cudaSuccess) return err;
    dhead_kernel<T><<<dim3(cdiv(D, kBM), cdiv(vc, kBN)), kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dl), chunk,
        static_cast<T*>(dhead), N, D, V, c0, vc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 wgmma body: a TMA ring, a producer warp, two consumer warpgroups
// ---------------------------------------------------------------------------

enum : int { kDlogits = 0, kDx = 1, kDhead = 2, kRowStats = 3 };

constexpr int kHBK = 64;          // K slice per stage: one 128-byte block
constexpr int kHStages = 4;
constexpr int kHThreads = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int kHBM = 128;         // CTA tile rows: 64 per consumer
constexpr int kHBN = 256;         // CTA tile columns
constexpr int kDxGroup = 8;       // dx epilogue: sums loaded at a time

template <int BN>
struct HCfg {
  static constexpr int A_BYTES = kHBM * kHBK * 2;
  static constexpr int B_BYTES = BN * kHBK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OFF_BAR = kHStages * STAGE;
  static constexpr int SMEM = OFF_BAR + 2 * kHStages * 8 + 1024;
};

// One product C [M, Nc] = A @ B over K, and what its epilogue needs.
// Rows r < M and columns c < Nc of C exist; out holds C's transform
// with rows ld_out apart. b_off moves B's column coordinate: the chunk's
// first vocab column where B is the head (dlogits, dx), which is where
// dlogits' label columns start too. Row statistics write per-split
// partials to `part` and walk `per` vocab tiles a split.
struct HParams {
  const int* targets;
  const float* wg;
  const float* lse;
  bf16* out;    // dl (dlogits), dx (dx, last chunk), dhead + c0 (dhead)
  float* acc;   // dx's fp32 sums over the chunks
  int ld_out, M, Nc, K, b_off, first, last;
  float* part;  // row statistics: [splits][3][M] fp32
  int per;
};

// The output tiles a CTA walks. Row statistics: one row tile and one run
// of `per` vocab tiles (a split) in order, CTA i taking row tile i % mt of
// split i / mt, so that the CTAs of a split walk the same head tiles in
// step (each read from HBM about once, then from L2). The other modes:
// tile blockIdx.x and every gridDim.x-th after it, the row tile fastest.
template <int MODE, int BN>
struct Walk {
  int first, end, step, mt;
  __device__ Walk(int mt_, int n_nt, int per) : mt(mt_) {
    if constexpr (MODE == kRowStats) {
      first = int(blockIdx.x) / mt * per;
      end = min(first + per, n_nt);
      step = 1;
    } else {
      first = blockIdx.x;
      end = mt * n_nt;
      step = gridDim.x;
    }
  }
  __device__ int m0(int tile) const {
    return (MODE == kRowStats ? int(blockIdx.x) : tile) % mt * kHBM;
  }
  __device__ int n0(int tile) const {
    return (MODE == kRowStats ? tile : tile / mt) * BN;
  }
};

// The producer warp's lane 0: every K slice of the A and B tiles of each
// of the CTA's output tiles into the ring. A K-major: one box of 128
// rows; MN-major: two 64-column blocks of 64 K rows. B K-major: one box
// of BN rows; MN-major: BN / 64 blocks of 64 K rows. TMA counts the whole
// box, zero-filled past an edge, against the stage's transaction bytes.
// The ring runs on across tiles, so the next tile's first slices land
// while the consumers run the last one's epilogue.
template <int MODE, int TA, int TB, int BN>
__device__ __forceinline__ void hopper_producer(const CUtensorMap* ta,
                                                const CUtensorMap* tb,
                                                unsigned char* sm,
                                                uint64_t* full,
                                                uint64_t* empty,
                                                const Walk<MODE, BN>& w,
                                                int nk, int b_off) {
  using C = HCfg<BN>;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = w.first; tile < w.end; tile += w.step) {
    const int m0 = w.m0(tile), n0 = w.n0(tile);
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kHBK;
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      hopper::mbar_arrive_tx(&full[stage], C::STAGE);
      unsigned char* a = sm + stage * C::STAGE;
      unsigned char* b = a + C::A_BYTES;
      if constexpr (TA != 0) {
#pragma unroll
        for (int i = 0; i < kHBM / 64; ++i)
          hopper::tma_load_2d(a + i * 64 * 128, ta, &full[stage],
                              m0 + 64 * i, k0);
      } else {
        hopper::tma_load_2d(a, ta, &full[stage], k0, m0);
      }
      if constexpr (TB != 0) {
#pragma unroll
        for (int i = 0; i < BN / 64; ++i)
          hopper::tma_load_2d(b + i * 64 * 128, tb, &full[stage],
                              b_off + n0 + 64 * i, k0);
      } else {
        hopper::tma_load_2d(b, tb, &full[stage], b_off + k0, n0);
      }
      if (++stage == kHStages) { stage = 0; phase ^= 1; }
    }
  }
}

// A consumer warpgroup: its 64 rows of one tile over every K slice, one
// wgmma commit group in flight while the next slice starts; a stage goes
// back to the producer once the group that read it has completed.
// (stage, phase): the ring position, carried from tile to tile.
template <int TA, int TB, int BN>
__device__ __forceinline__ void hopper_mainloop(float (&acc)[BN / 2],
                                                unsigned char* sm,
                                                uint64_t* full,
                                                uint64_t* empty, int wgi,
                                                int nk, int& stage,
                                                uint32_t& phase) {
  using C = HCfg<BN>;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // rows 64 wgi.. of a K-major A box and column block wgi of an MN-major
  // A both start 8 KB in; MN-major blocks lie 64 rows x 128 bytes apart
  const uint64_t a0 =
      hopper::desc_sw128(sm + wgi * 64 * 128, TA ? 64 * 128 : 16, 1024);
  const uint64_t b0 =
      hopper::desc_sw128(sm + C::A_BYTES, TB ? 64 * 128 : 16, 1024);
  // a k16 step: 32 bytes along a K-major row, 16 rows down an MN-major
  // block (descriptor addresses count 16-byte units)
  constexpr uint64_t a_step = TA ? 2048 / 16 : 32 / 16;
  constexpr uint64_t b_step = TB ? 2048 / 16 : 32 / 16;
  const int lane = threadIdx.x & 31;
  int prev = stage;
  for (int kt = 0; kt < nk; ++kt) {
    hopper::mbar_wait(&full[stage], phase);
    const uint64_t so = uint64_t(stage * C::STAGE) / 16;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHBK / 16; ++kk)
      hopper::wgmma_ss_t<TA, TB>(acc, a0 + so + kk * a_step,
                                 b0 + so + kk * b_step, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == kHStages) { stage = 0; phase ^= 1; }
  }
  hopper::wgmma_wait<0>();
  hopper::reg_fence(acc);
  if (lane == 0) hopper::mbar_arrive(&empty[prev]);
}

// The epilogue from registers (hopper.cuh's accumulator layout: this
// thread's rows 16 warp + g and + 8, columns 8j + 2t and 8j + 2t + 1).
// Nc is a multiple of 8 on this route, so a column pair is whole.
template <int MODE, int BN>
__device__ __forceinline__ void hopper_epilogue(const float (&acc)[BN / 2],
                                                const HParams& p, int m0,
                                                int n0, int wgi) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c_first = n0 + 2 * t;  // column of register pair j = 0
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = m0 + 64 * wgi + 16 * warp + g + 8 * hr;
    if (r >= p.M) continue;
    const size_t row = size_t(r) * p.ld_out + c_first;
    if constexpr (MODE == kDlogits) {
      // dl = (exp(logit - lse) - [c0 + c = target]) * wg, exp in base 2;
      // `hit` is the label's offset from column c_first (a label outside
      // [0, V) never meets a stored column c < vc)
      const float l2 = p.lse[r] * hopper::kLog2e, w = p.wg[r];
      const int hit = p.targets[r] - p.b_off - c_first;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (c_first + 8 * j >= p.Nc) continue;
        const float e0 = hopper::fast_exp2(
            fmaf(acc[4 * j + 2 * hr], hopper::kLog2e, -l2));
        const float e1 = hopper::fast_exp2(
            fmaf(acc[4 * j + 2 * hr + 1], hopper::kLog2e, -l2));
        const float v0 = (e0 - (8 * j == hit ? 1.f : 0.f)) * w;
        const float v1 = (e1 - (8 * j + 1 == hit ? 1.f : 0.f)) * w;
        *reinterpret_cast<uint32_t*>(p.out + row + 8 * j) =
            hopper::pack_bf16(v0, v1);
      }
    } else if constexpr (MODE == kDx) {
      // the fp32 sums over the chunks, rounded to bf16 once, in the last.
      // The earlier chunks' sums load kDxGroup column pairs at a time
      // before any of them is stored: a load after each store would wait
      // out one memory round trip per pair
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kDxGroup) {
        float2 prev[kDxGroup];
#pragma unroll
        for (int j = j0; j < j0 + kDxGroup; ++j)
          prev[j - j0] = !p.first && c_first + 8 * j < p.Nc
                             ? *reinterpret_cast<const float2*>(
                                   p.acc + row + 8 * j)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = j0; j < j0 + kDxGroup; ++j) {
          if (c_first + 8 * j >= p.Nc) continue;
          float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
          if (!p.first) {
            v0 += prev[j - j0].x;
            v1 += prev[j - j0].y;
          }
          if (p.last)
            *reinterpret_cast<uint32_t*>(p.out + row + 8 * j) =
                hopper::pack_bf16(v0, v1);
          else
            *reinterpret_cast<float2*>(p.acc + row + 8 * j) =
                make_float2(v0, v1);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (c_first + 8 * j >= p.Nc) continue;
        *reinterpret_cast<uint32_t*>(p.out + row + 8 * j) =
            hopper::pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      }
    }
  }
}

// Row statistics of one tile into this thread's running (m, l, t) of
// its rows 16 warp + g and + 8 over its columns 8j + 2t and 8j + 2t + 1
// (the accumulator layout). Columns c >= V (zero-filled by TMA past the
// vocab) take no part: V % 8 == 0 on this route, so a column pair is
// whole and column pair j exists while 8j < V - n0. Each row's tile
// maximum first, then one ex2 per element of a log2e-prescaled argument;
// m is kept in log2 units. tr: the row's label (or -1), gathered in the
// one column equal to it.
template <int BN>
__device__ __forceinline__ void row_stats_tile(const float (&acc)[BN / 2],
                                               float (&m2)[2], float (&l)[2],
                                               float (&tg)[2],
                                               const int (&tr)[2], int n0,
                                               int V) {
  const int c_first = n0 + 2 * (threadIdx.x & 3);
  const int lim = V - n0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (8 * j < lim)
        mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]));
    const float m_new = fmaxf(m2[hr], mx * hopper::kLog2e);
    float sum = 0.f;
    const int hit = tr[hr] - c_first;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (8 * j < lim) {
        const float a0 = acc[4 * j + 2 * hr], a1 = acc[4 * j + 2 * hr + 1];
        sum += hopper::fast_exp2(fmaf(a0, hopper::kLog2e, -m_new)) +
               hopper::fast_exp2(fmaf(a1, hopper::kLog2e, -m_new));
        if (8 * j == hit) tg[hr] += a0;
        if (8 * j + 1 == hit) tg[hr] += a1;
      }
    }
    l[hr] = l[hr] * hopper::fast_exp2(m2[hr] - m_new) + sum;
    m2[hr] = m_new;
  }
}

// The end of a split: the 4 lanes that share a row merge their (m, l, t)
// by shuffles, and the first writes the row's partial, m back in natural
// units, to part[(split * 3 + {0, 1, 2}) * M + row] for merge_kernel.
__device__ __forceinline__ void row_stats_store(float (&m2)[2], float (&l)[2],
                                                float (&tg)[2],
                                                const HParams& p, int m0,
                                                int wgi, int split) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m2[hr], o);
      const float ol = __shfl_xor_sync(0xffffffffu, l[hr], o);
      const float ot = __shfl_xor_sync(0xffffffffu, tg[hr], o);
      const float mm = fmaxf(m2[hr], om);
      l[hr] = l[hr] * hopper::fast_exp2(m2[hr] - mm) +
              ol * hopper::fast_exp2(om - mm);
      m2[hr] = mm;
      tg[hr] += ot;
    }
    const int r = m0 + 64 * wgi + 16 * warp + (lane >> 2) + 8 * hr;
    if ((lane & 3) == 0 && r < p.M) {
      float* q = p.part + size_t(split) * 3 * p.M + r;
      q[0] = m2[hr] * kLn2;
      q[size_t(p.M)] = l[hr];
      q[2 * size_t(p.M)] = tg[hr];
    }
  }
}

// A CTA walks the (128-row, BN-column) tiles of C that `Walk` gives it:
// the gradient modes as a persistent CTA per SM (at most one per tile),
// the row statistics one (row tile, vocab split) each. TA / TB: A / B
// MN-major.
template <int MODE, int TA, int TB, int BN>
__global__ void __launch_bounds__(kHThreads, 1)
ce_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const HParams p) {
  using C = HCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + kHStages;
  const int mt = (p.M + kHBM - 1) / kHBM;
  const Walk<MODE, BN> walk(mt, (p.Nc + BN - 1) / BN, p.per);
  const int nk = (p.K + kHBK - 1) / kHBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's expect_tx
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wgi = hopper::warpgroup_index();
  if (wgi == 2) {
    if (threadIdx.x == 256)
      hopper_producer<MODE, TA, TB, BN>(&ta, &tb, sm, full, empty, walk, nk,
                                        p.b_off);
  } else if constexpr (MODE == kRowStats) {
    // (m, l, t) of this thread's two rows carried across the split's
    // vocab tiles; a label outside [0, V) matches no column
    const int m0 = walk.m0(0);
    float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, tg[2] = {0.f, 0.f};
    int tr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + 64 * wgi + 16 * ((threadIdx.x & 127) >> 5) +
                    ((threadIdx.x & 31) >> 2) + 8 * hr;
      const int lab = r < p.M ? p.targets[r] : -1;
      tr[hr] = lab >= 0 && lab < p.Nc ? lab : -1;
    }
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = walk.first; tile < walk.end; tile += walk.step) {
      hopper_mainloop<TA, TB, BN>(acc, sm, full, empty, wgi, nk, stage,
                                  phase);
      row_stats_tile<BN>(acc, m2, l, tg, tr, walk.n0(tile), p.Nc);
    }
    row_stats_store(m2, l, tg, p, m0, wgi, int(blockIdx.x) / mt);
  } else {
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = walk.first; tile < walk.end; tile += walk.step) {
      hopper_mainloop<TA, TB, BN>(acc, sm, full, empty, wgi, nk, stage,
                                  phase);
      hopper_epilogue<MODE, BN>(acc, p, walk.m0(tile), walk.n0(tile), wgi);
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

template <int MODE, int TA, int TB>
cudaError_t ce_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                     const HParams& p, cudaStream_t st) {
  using C = HCfg<kHBN>;
  auto kern = ce_wgmma_kernel<MODE, TA, TB, kHBN>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(p.M, kHBM) * cdiv(p.Nc, kHBN);
  kern<<<std::min(tiles, sm_count()), kHThreads, C::SMEM, st>>>(ta, tb, p);
  return cudaGetLastError();
}

// dl of chunk [c0, c0 + vc) = dlogits of x (K-major) @ head (MN-major)
cudaError_t hopper_dlogits(const CUtensorMap& tx_k, const CUtensorMap& th_mn,
                           const int* targets, const float* wg,
                           const float* lse, void* dl, int chunk, int N,
                           int D, int c0, int vc, cudaStream_t st) {
  const HParams p{targets, wg, lse, static_cast<bf16*>(dl), nullptr,
                  chunk, N, vc, D, c0, 0, 0};
  return ce_wgmma<kDlogits, 0, 1>(tx_k, th_mn, p, st);
}

// Row statistics on the wgmma body: x (K-major) @ head (MN-major), the
// dlogits product, over the whole vocab; as many vocab splits as one CTA
// an SM (at most `ctas`, the partials' capacity) allows over the row
// tiles, each split a run of whole 256-column tiles; then the exact merge.
cudaError_t hopper_row_stats(const void* x, const void* head,
                             const int* targets, float* part, float* lse,
                             float* tgt, int N, int D, int V, int ctas,
                             cudaStream_t st) {
  CUtensorMap tx_k, th_mn;
  cudaError_t err;
  if ((err = hopper::matrix_map(&tx_k, x, N, D, D, kHBM)) != cudaSuccess ||
      (err = hopper::matrix_map(&th_mn, head, D, V, V, kHBK)) !=
          cudaSuccess)
    return err;
  const int mt = cdiv(N, kHBM), n_vt = cdiv(V, kHBN);
  const int budget = std::min(ctas, sm_count());
  const int per = cdiv(n_vt, std::max(1, std::min(budget / mt, n_vt)));
  const int splits = cdiv(n_vt, per);  // none of them empty
  HParams p{targets, nullptr, nullptr, nullptr, nullptr, 0, N, V, D, 0, 0, 0};
  p.part = part;
  p.per = per;
  using C = HCfg<kHBN>;
  auto kern = ce_wgmma_kernel<kRowStats, 0, 1, kHBN>;
  err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<mt * splits, kHThreads, C::SMEM, st>>>(tx_k, th_mn, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<cdiv(N, 256), 256, 0, st>>>(part, lse, tgt, N, splits);
  return cudaGetLastError();
}

// TMA reads the operands' rows: 16-byte aligned bases and row strides
bool hopper_fits(const void* x, const void* head, const void* dl, int D,
                 int V) {
  const auto a16 = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  return D % 8 == 0 && V % 8 == 0 && a16(x) && a16(head) && a16(dl);
}

cudaError_t hopper_dx(const void* x, const void* head, const int* targets,
                      const float* wg, const float* lse, void* dl, int chunk,
                      float* acc, void* dx, int N, int D, int V,
                      cudaStream_t st) {
  CUtensorMap tx_k, th_mn, th_k, tdl_k;
  cudaError_t err;
  if ((err = hopper::matrix_map(&tx_k, x, N, D, D, kHBM)) != cudaSuccess ||
      (err = hopper::matrix_map(&th_mn, head, D, V, V, kHBK)) !=
          cudaSuccess ||
      (err = hopper::matrix_map(&th_k, head, D, V, V, kHBN)) != cudaSuccess)
    return err;
  for (int c0 = 0; c0 < V; c0 += chunk) {
    const int vc = std::min(chunk, V - c0);
    err = hopper_dlogits(tx_k, th_mn, targets, wg, lse, dl, chunk, N, D, c0,
                         vc, st);
    if (err != cudaSuccess) return err;
    // dl's map is vc wide: the K tail past the chunk reads zeros
    if ((err = hopper::matrix_map(&tdl_k, dl, N, vc, chunk, kHBM)) !=
        cudaSuccess)
      return err;
    const HParams p{nullptr, nullptr, nullptr, static_cast<bf16*>(dx), acc,
                    D, N, D, vc, c0, int(c0 == 0), int(c0 + chunk >= V)};
    err = ce_wgmma<kDx, 0, 0>(tdl_k, th_k, p, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t hopper_dhead(const void* x, const void* head, const int* targets,
                         const float* wg, const float* lse, void* dl,
                         int chunk, void* dhead, int N, int D, int V,
                         cudaStream_t st) {
  CUtensorMap tx_k, th_mn, tx_mn, tdl_mn;
  cudaError_t err;
  if ((err = hopper::matrix_map(&tx_k, x, N, D, D, kHBM)) != cudaSuccess ||
      (err = hopper::matrix_map(&th_mn, head, D, V, V, kHBK)) !=
          cudaSuccess ||
      (err = hopper::matrix_map(&tx_mn, x, N, D, D, kHBK)) != cudaSuccess)
    return err;
  for (int c0 = 0; c0 < V; c0 += chunk) {
    const int vc = std::min(chunk, V - c0);
    err = hopper_dlogits(tx_k, th_mn, targets, wg, lse, dl, chunk, N, D, c0,
                         vc, st);
    if (err != cudaSuccess) return err;
    if ((err = hopper::matrix_map(&tdl_mn, dl, N, vc, chunk, kHBK)) !=
        cudaSuccess)
      return err;
    const HParams p{nullptr, nullptr, nullptr,
                    static_cast<bf16*>(dhead) + c0, nullptr, V, D, vc, N, 0,
                    0, 0};
    err = ce_wgmma<kDhead, 1, 1>(tx_mn, tdl_mn, p, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool shape_ok(int N, int D, int V) {
  return N >= 1 && D >= 1 && V >= 1 && cdiv(D, kBM) <= 65535;
}

// The gradient entries' route: 0 = fp32 (dtype 0), 1 = mma_sync (dtype
// 1), 2 = wgmma (dtype 1, D % 8 == 0, V % 8 == 0, x, head and dl 16-byte
// aligned); a route the dtype or shape does not fit is refused.
enum : int { kRouteFp32 = 0, kRouteMma = 1, kRouteWgmma = 2 };

bool route_ok(int route, int dtype, const void* x, const void* head,
              const void* dl, int D, int V) {
  if (route == kRouteFp32) return dtype == 0;
  if (route == kRouteMma) return dtype == 1;
  return route == kRouteWgmma && dtype == 1 &&
         hopper_fits(x, head, dl, D, V);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x [N, D] and head [D, V] (both
// contiguous). targets [N] int32; ctas: the CTA budget of the row
// statistics launch (the caller's: two an SM), partials [3 * ctas, N] fp32
// scratch; lse, tgt [N] fp32 out; route: 0 fp32, 1 mma_sync, 2 wgmma
// (route_ok, the gradients' predicate). Returns a cudaError_t.
extern "C" int fused_ce_row_stats(const void* x, const void* head,
                                  const void* targets, void* partials,
                                  void* lse, void* tgt, int N, int D, int V,
                                  int ctas, int dtype, int route,
                                  void* stream) {
  if (!shape_ok(N, D, V) || ctas < 1 || ctas > 65535 ||
      !route_ok(route, dtype, x, head, head, D, V))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  float* p = static_cast<float*>(partials);
  float* l = static_cast<float*>(lse);
  float* g = static_cast<float*>(tgt);
  if (route == kRouteFp32)
    return int(row_stats<float>(x, head, t, p, l, g, N, D, V, ctas, st));
  if (route == kRouteMma)
    return int(row_stats<bf16>(x, head, t, p, l, g, N, D, V, ctas, st));
  return int(hopper_row_stats(x, head, t, p, l, g, N, D, V, ctas, st));
}

// dx [N, D] in the input dtype from wg (weight times the loss cotangent)
// and lse [N] fp32. dl: [N, chunk] scratch in the input dtype, one vocab
// chunk of the backward (chunk a positive multiple of 128); acc: [N, D]
// fp32 scratch (bf16 over more than one chunk; float32 passes dx itself);
// route: 0 fp32, 1 mma_sync, 2 wgmma (route_ok). Returns a cudaError_t.
extern "C" int fused_ce_dx(const void* x, const void* head,
                           const void* targets, const void* wg,
                           const void* lse, void* dl, void* acc, void* dx,
                           int N, int D, int V, int chunk, int dtype,
                           int route, void* stream) {
  if (!shape_ok(N, D, V) || chunk < kBN || chunk % kBN != 0 ||
      !route_ok(route, dtype, x, head, dl, D, V))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  const float* w = static_cast<const float*>(wg);
  const float* l = static_cast<const float*>(lse);
  float* a = static_cast<float*>(acc);
  if (route == kRouteFp32)
    return int(
        grads_dx<float>(x, head, t, w, l, dl, chunk, a, dx, N, D, V, st));
  if (route == kRouteMma)
    return int(
        grads_dx<bf16>(x, head, t, w, l, dl, chunk, a, dx, N, D, V, st));
  return int(hopper_dx(x, head, t, w, l, dl, chunk, a, dx, N, D, V, st));
}

// dhead [D, V] in the input dtype; the other arguments as fused_ce_dx.
// Returns a cudaError_t.
extern "C" int fused_ce_dhead(const void* x, const void* head,
                              const void* targets, const void* wg,
                              const void* lse, void* dl, void* dhead, int N,
                              int D, int V, int chunk, int dtype, int route,
                              void* stream) {
  if (!shape_ok(N, D, V) || chunk < kBN || chunk % kBN != 0 ||
      !route_ok(route, dtype, x, head, dl, D, V))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  const float* w = static_cast<const float*>(wg);
  const float* l = static_cast<const float*>(lse);
  if (route == kRouteFp32)
    return int(
        grads_dhead<float>(x, head, t, w, l, dl, chunk, dhead, N, D, V, st));
  if (route == kRouteMma)
    return int(
        grads_dhead<bf16>(x, head, t, w, l, dl, chunk, dhead, N, D, V, st));
  return int(hopper_dhead(x, head, t, w, l, dl, chunk, dhead, N, D, V, st));
}
