// Flash-attention backward for Hopper (sm_90a), behind a plain C interface.
//
// Two kernels, the counterparts of the Pallas TPU kernels that `_bwd`
// (gke_ray_train_tpu/ops/flash_attention.py:381) launches:
//
// - flash_bwd_dq replaces `_dq_kernel` (:303, grid (B, H, n_q, n_kv)):
//   dQ = scale * sum_j dS_ij K_j over the live kv tiles;
// - flash_bwd_dkv replaces `_dkv_kernel` (:339, grid (B, H, n_kv, n_q)):
//   dV = sum_i P_ij^T dO_i and dK = scale * sum_i dS_ij^T Q_i.
//
// Both recompute the probabilities from the forward's logsumexp, P =
// exp(s~ - lse) on kept pairs and 0 elsewhere (s~ the scaled, capped
// score), so a row that attends nothing (lse = NEG_INF) gives P = 0 and
// never exp(0) = 1. Then dP = dO V^T, dS = P (dP - D) with D = rowsum(dO
// O) formed in fp32 by the caller, times the softcap factor 1 - (s~/c)^2
// where P > 0 (:296-300, :329, :370). Operands round where the TPU kernels
// round them: dS to the q/k dtype before dS K and dS^T Q (:331, :372), P
// to the dO dtype before P^T dO (:362). Whole tiles that `_block_live`
// (:94) proves dead are skipped in both loops: the dQ loop runs over kv
// tiles of one query tile, the dK/dV loop over query tiles of one kv tile
// (the same predicate with the roles of the two tiles swapped). A ragged
// tail's missing rows and columns read as segment 0 (never attended).
//
// Layout: q, dO, dQ [B, S, H, dh]; k, v, dK, dV [B, T, K, dh] (the JAX
// public layout, read in place); lse, D [B, H, S] fp32; positions and
// segment ids [B, S] and [B, T] int32. dh is 64, 128 or 256; the dtype is
// float32 or bfloat16.
//
// Design. The TPU grid's sequential fourth axis becomes a loop inside one
// CTA, and the fp32 accumulators live in registers:
// - dQ, bf16 (dh 64 / 128 / 256, operands TMA can address): one CTA per
//   (query head, batch row, query tile) over the kv tiles of kv head h /
//   G, the tiles with the most live kv tiles under causality launched
//   first. Q and dO load once by TMA; one producer warp keeps a ring of
//   64-row K / V tiles in flight by TMA (kv positions and segments beside
//   them by cp.async), the kv tiles classed up front (dead tiles never
//   enter the ring). Two consumer warpgroups compute S = Q K^T and dP = dO
//   V^T by wgmma (both K-major), dS in registers (the softcap and the
//   mask compile-time forms: an interior tile evaluates no mask), and dQ
//   += dS K by wgmma with dS from registers and K read MN-major through
//   the transpose immediate. At dh 64 / 128 each owns 64 query rows of a
//   128-row tile; at dh 256 they share 64 rows and split the kv columns
//   of S and dP and the columns of dQ, trading packed dS halves through
//   shared memory (the dK/dV split, below). One CTA sums each dQ element
//   in kv order: no atomics, bitwise-repeatable.
// - dQ, float32: the scalar body, one CTA per (query tile, query head,
//   batch row); the parity path.
// - dK/dV, bf16 (dh 64 / 128 / 256): one CTA per (query head, batch row,
//   kv tile), the small-t0 tiles (the most live query tiles under
//   causality) launched first; the G CTAs of a kv head form one
//   thread-block cluster (G <= 8). One producer warp loads K and V of the
//   tile once and keeps a ring of Q / dO tiles in flight by TMA (lse, D,
//   positions and segments beside them by cp.async); query tiles are
//   classed up front as in the forward (dead, boundary, interior). Two
//   consumer warpgroups: at dh 64 each owns 64 kv rows and computes
//   S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q by wgmma;
//   from dh 128 they share 64 kv rows: each computes S^T and dP^T for
//   half of the query columns, forms and packs P^T and dS^T there, trades
//   the packed half with the other through shared memory, and
//   accumulates its half of dh of dK and dV (two 64 x dh accumulators
//   and the score tiles do not fit one thread's registers). The second
//   products read Q and dO as MN-major operands: no transposed copies.
//   At the end every CTA writes its fp32 partial to its own shared
//   memory, and rank r of the cluster sums its share of the rows over
//   ranks 0..G-1 in order through distributed shared memory, rounds once
//   and writes [B, T, K, dh]: no [B, H, T, dh] buffer, no atomics,
//   bitwise-repeatable. In bf16 this rounds once where JAX rounds each
//   head's partial before the sum (:465-479); at fp32 the two agree.
// - dK/dV, float32: the scalar body, one CTA per (kv tile, kv head,
//   batch row) over the G query heads; the parity path.
//
// Bound. At the training shape (B=2, S=T=1024, H=32, K=8, dh=128, bf16,
// causal) the dQ kernel does 3 products and the dK/dV kernel 4 over the
// 524,800 live pairs of each (batch row, head): 25.8 and 34.4 GFLOP, and
// each moves ~50-60 MB, so both are bound by operations (~0.026 and
// ~0.035 ms at 989 TFLOP/s bf16). What holds both wgmma bodies back:
// 64-row kv (or query) tiles whose products are short against the
// elementwise phase (and, where the warpgroups split a tile, their
// exchanges), none of it overlapped with the tensor cores (see PERF.md).
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrappers raise when that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;

// Tile shapes of both kernels: "own" rows are the rows a CTA accumulates
// (query rows for dQ, kv rows for dK/dV), "loop" rows those it walks.
template <int DH>
struct Tile {
  static constexpr int BOWN = DH <= 128 ? 64 : 32;
  static constexpr int BLOOP = DH <= 128 ? 64 : 32;
  static constexpr int RPT = BOWN / 16;   // own rows per thread
  static constexpr int CPT = BLOOP / 16;  // loop rows (score columns) / thread
  static constexpr int DPT = DH / 16;     // output columns per thread
  static constexpr int LO = BOWN + 1;     // padded leading dims
  static constexpr int LL = BLOOP + 1;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: an operand as `.astype(dtype)` leaves it.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Block-wide (min v[0], max v[1], min v[2], max v[3]) over WARPS warps;
// every thread gets the result. `red` holds 4 ints per warp.
template <int WARPS>
__device__ __forceinline__ void block_minmax4(int v[4], int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v[0] = min(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
    v[1] = max(v[1], __shfl_xor_sync(0xffffffffu, v[1], o));
    v[2] = min(v[2], __shfl_xor_sync(0xffffffffu, v[2], o));
    v[3] = max(v[3], __shfl_xor_sync(0xffffffffu, v[3], o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[warp * 4 + i] = v[i];
  }
  __syncthreads();
  v[0] = red[0]; v[1] = red[1]; v[2] = red[2]; v[3] = red[3];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    v[0] = min(v[0], red[w * 4 + 0]);
    v[1] = max(v[1], red[w * 4 + 1]);
    v[2] = min(v[2], red[w * 4 + 2]);
    v[3] = max(v[3], red[w * 4 + 3]);
  }
  __syncthreads();  // `red` may be written again after this
}

// (min pos, max pos, min seg, max seg) over the first `n` of a tile's
// positions / segment ids in shared memory.
template <int WARPS = kWarps>
__device__ __forceinline__ void tile_minmax(const int* pos, const int* seg,
                                            int n, int v[4], int* red) {
  const int t = threadIdx.x;
  const bool ok = t < n;
  v[0] = ok ? pos[t] : INT_MAX;
  v[1] = ok ? pos[t] : INT_MIN;
  v[2] = ok ? seg[t] : INT_MAX;
  v[3] = ok ? seg[t] : INT_MIN;
  block_minmax4<WARPS>(v, red);
}

// _block_live: not all causal future, not all window-expired past, and
// overlapping segment-id ranges. q / kv: the tiles' tile_minmax results.
__device__ __forceinline__ bool block_live(const int q[4], const int kv[4],
                                           int causal, int use_window,
                                           int window) {
  bool live = !causal || q[1] >= kv[0];
  if (use_window) live = live && kv[1] > q[0] - window;
  return live && q[2] <= kv[3] && kv[2] <= q[3];
}

struct Mask {
  int causal, use_window, window;
  float scale, softcap;
};

// P and dS of one (query row, kv row) pair from the raw product q.k, the
// product dO.v, the row's lse and D, before any rounding.
__device__ __forceinline__ void p_and_ds(float qk, float dov, float lse,
                                         float dvec, int qp, int qs, int kp,
                                         int ks, const Mask& m, float* p_out,
                                         float* ds_out) {
  float x = qk * m.scale;
  if (m.softcap > 0.f) x = tanhf(x / m.softcap) * m.softcap;
  bool keep = qs == ks && ks != 0;
  if (m.causal) keep = keep && kp <= qp;
  if (m.use_window) keep = keep && kp > qp - m.window;
  const float p = keep ? expf(x - lse) : 0.f;
  float ds = p * (dov - dvec);
  if (m.softcap > 0.f && p > 0.f) {
    const float r = x / m.softcap;
    ds *= 1.f - r * r;
  }
  *p_out = p;
  *ds_out = ds;
}

// Stage rows [r0, r0 + nrows) of a [len, heads, DH] tensor's head `hd`
// (row stride heads * DH) into dst[d * ld + r], fp32, zero past nrows.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ base,
                                                 size_t row_stride, int r0,
                                                 int nrows, float* dst,
                                                 int ld) {
  for (int i = threadIdx.x; i < ROWS * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[d * ld + r] =
        r < nrows ? to_float(base[size_t(r0 + r) * row_stride + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (query tile, query head, batch row)
// ---------------------------------------------------------------------------

template <int DH>
struct DqSmem {
  using C = Tile<DH>;
  // Qt, dOt [DH][LO]; Kt, Vt [DH][LL]; dS [BOWN][LL]; lse, D [BOWN]
  static constexpr int FLOATS =
      2 * DH * C::LO + 2 * DH * C::LL + C::BOWN * C::LL + 2 * C::BOWN;
  static constexpr int INTS = 2 * C::BOWN + 2 * C::BLOOP + 4 * kWarps;
  static constexpr size_t BYTES = size_t(FLOATS + INTS) * 4;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kvpos,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kvseg, T* __restrict__ dq, int S,
                    int T_len, int H, int K, Mask m) {
  using C = Tile<DH>;
  constexpr int BQ = C::BOWN, BKV = C::BLOOP;
  extern __shared__ float smem[];
  float* Qt = smem;                    // [DH][LO]
  float* dOt = Qt + DH * C::LO;        // [DH][LO]
  float* Kt = dOt + DH * C::LO;        // [DH][LL]
  float* Vt = Kt + DH * C::LL;         // [DH][LL]
  float* dS = Vt + DH * C::LL;         // [BQ][LL]
  float* lse_s = dS + BQ * C::LL;
  float* d_s = lse_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(d_s + BQ);
  int* qseg_s = qpos_s + BQ;
  int* kpos_s = qseg_s + BQ;
  int* kseg_s = kpos_s + BKV;
  int* red = kseg_s + BKV;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int qrows = min(BQ, S - q0);
  const size_t q_stride = size_t(H) * DH;
  const size_t kv_stride = size_t(K) * DH;
  const size_t q_off = (size_t(b) * S * H + h) * DH;
  const size_t kv_off = (size_t(b) * T_len * K + kh) * DH;

  stage_transposed<T, DH, BQ>(q + q_off, q_stride, q0, qrows, Qt, C::LO);
  stage_transposed<T, DH, BQ>(dout + q_off, q_stride, q0, qrows, dOt, C::LO);
  if (tid < BQ) {
    const bool ok = tid < qrows;
    const size_t row = size_t(b) * S + q0 + tid;
    const size_t hrow = (size_t(b) * H + h) * S + q0 + tid;
    qpos_s[tid] = ok ? qpos[row] : 0;
    qseg_s[tid] = ok ? qseg[row] : 0;  // missing rows read as padding
    lse_s[tid] = ok ? lse[hrow] : 0.f;
    d_s[tid] = ok ? dvec[hrow] : 0.f;
  }
  __syncthreads();
  int qmm[4];
  tile_minmax(qpos_s, qseg_s, qrows, qmm, red);

  float acc[C::RPT][C::DPT];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) acc[i][j] = 0.f;

  const int n_kv = (T_len + BKV - 1) / BKV;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int t0 = jt * BKV;
    const int kvcols = min(BKV, T_len - t0);
    if (tid < BKV) {
      const bool ok = tid < kvcols;
      kpos_s[tid] = ok ? kvpos[size_t(b) * T_len + t0 + tid] : 0;
      kseg_s[tid] = ok ? kvseg[size_t(b) * T_len + t0 + tid] : 0;
    }
    __syncthreads();
    int kmm[4];
    tile_minmax(kpos_s, kseg_s, kvcols, kmm, red);
    if (!block_live(qmm, kmm, m.causal, m.use_window, m.window))
      continue;  // uniform across the CTA

    stage_transposed<T, DH, BKV>(k + kv_off, kv_stride, t0, kvcols, Kt,
                                 C::LL);
    stage_transposed<T, DH, BKV>(v + kv_off, kv_stride, t0, kvcols, Vt,
                                 C::LL);
    __syncthreads();

    // q.k and dO.v for rows ty*RPT.., kv columns tx*CPT..
    float s[C::RPT][C::CPT], dp[C::RPT][C::CPT];
#pragma unroll
    for (int i = 0; i < C::RPT; ++i)
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[C::RPT], o[C::RPT], bk[C::CPT], bv[C::CPT];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        a[i] = Qt[d * C::LO + ty * C::RPT + i];
        o[i] = dOt[d * C::LO + ty * C::RPT + i];
      }
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) {
        bk[j] = Kt[d * C::LL + tx * C::CPT + j];
        bv[j] = Vt[d * C::LL + tx * C::CPT + j];
      }
#pragma unroll
      for (int i = 0; i < C::RPT; ++i)
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) {
      const int r = ty * C::RPT + i;
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) {
        const int c = tx * C::CPT + j;
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], lse_s[r], d_s[r], qpos_s[r], qseg_s[r],
                 kpos_s[c], kseg_s[c], m, &p, &ds);
        dS[r * C::LL + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dQ += dS K; output columns tx + 16*j
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float dsv[C::RPT];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) dsv[i] = dS[(ty * C::RPT + i) * C::LL + c];
#pragma unroll
      for (int j = 0; j < C::DPT; ++j) {
        const float kv = Kt[(tx + 16 * j) * C::LL + c];
#pragma unroll
        for (int i = 0; i < C::RPT; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const int r = ty * C::RPT + i;
    if (r >= qrows) continue;
    T* row = dq + ((size_t(b) * S + q0 + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < C::DPT; ++j)
      row[tx + 16 * j] = from_float<T>(acc[i][j] * m.scale);
  }
}

// ---------------------------------------------------------------------------
// dK / dV, float32: one CTA per (kv tile, kv head, batch row), over the
// G query heads of the group
// ---------------------------------------------------------------------------

template <int DH>
struct DkvSmem {
  using C = Tile<DH>;
  // Kt, Vt [DH][LO]; Qt, dOt [DH][LL]; P, dS [BOWN][LL]; lse, D [BLOOP]
  static constexpr int FLOATS = 2 * DH * C::LO + 2 * DH * C::LL +
                                2 * C::BOWN * C::LL + 2 * C::BLOOP;
  static constexpr int INTS = 2 * C::BOWN + 2 * C::BLOOP + 4 * kWarps;
  static constexpr size_t BYTES = size_t(FLOATS + INTS) * 4;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kvpos,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kvseg, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int T_len, int H, int K,
                     Mask m) {
  using C = Tile<DH>;
  constexpr int BKV = C::BOWN, BQ = C::BLOOP;
  extern __shared__ float smem[];
  float* Kt = smem;                    // [DH][LO]
  float* Vt = Kt + DH * C::LO;         // [DH][LO]
  float* Qt = Vt + DH * C::LO;         // [DH][LL]
  float* dOt = Qt + DH * C::LL;        // [DH][LL]
  float* Ps = dOt + DH * C::LL;        // [BKV][LL]
  float* dSs = Ps + BKV * C::LL;       // [BKV][LL]
  float* lse_s = dSs + BKV * C::LL;
  float* d_s = lse_s + BQ;
  int* kpos_s = reinterpret_cast<int*>(d_s + BQ);
  int* kseg_s = kpos_s + BKV;
  int* qpos_s = kseg_s + BKV;
  int* qseg_s = qpos_s + BQ;
  int* red = qseg_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.x * BKV;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int kvrows = min(BKV, T_len - t0);
  const size_t q_stride = size_t(H) * DH;
  const size_t kv_stride = size_t(K) * DH;
  const size_t kv_off = (size_t(b) * T_len * K + kh) * DH;

  stage_transposed<T, DH, BKV>(k + kv_off, kv_stride, t0, kvrows, Kt, C::LO);
  stage_transposed<T, DH, BKV>(v + kv_off, kv_stride, t0, kvrows, Vt, C::LO);
  if (tid < BKV) {
    const bool ok = tid < kvrows;
    kpos_s[tid] = ok ? kvpos[size_t(b) * T_len + t0 + tid] : 0;
    kseg_s[tid] = ok ? kvseg[size_t(b) * T_len + t0 + tid] : 0;
  }
  __syncthreads();
  int kmm[4];
  tile_minmax(kpos_s, kseg_s, kvrows, kmm, red);

  float dk_acc[C::RPT][C::DPT], dv_acc[C::RPT][C::DPT];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (S + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = (size_t(b) * S * H + h) * DH;
    for (int it = 0; it < n_q; ++it) {
      const int q0 = it * BQ;
      const int qrows = min(BQ, S - q0);
      if (tid < BQ) {
        const bool ok = tid < qrows;
        const size_t row = size_t(b) * S + q0 + tid;
        const size_t hrow = (size_t(b) * H + h) * S + q0 + tid;
        qpos_s[tid] = ok ? qpos[row] : 0;
        qseg_s[tid] = ok ? qseg[row] : 0;
        lse_s[tid] = ok ? lse[hrow] : 0.f;
        d_s[tid] = ok ? dvec[hrow] : 0.f;
      }
      __syncthreads();
      int qmm[4];
      tile_minmax(qpos_s, qseg_s, qrows, qmm, red);
      if (!block_live(qmm, kmm, m.causal, m.use_window, m.window))
        continue;  // uniform across the CTA

      stage_transposed<T, DH, BQ>(q + q_off, q_stride, q0, qrows, Qt, C::LL);
      stage_transposed<T, DH, BQ>(dout + q_off, q_stride, q0, qrows, dOt,
                                  C::LL);
      __syncthreads();

      // k.q and v.dO for kv rows ty*RPT.., query columns tx*CPT..
      float s[C::RPT][C::CPT], dp[C::RPT][C::CPT];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i)
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float a[C::RPT], w[C::RPT], bq[C::CPT], bo[C::CPT];
#pragma unroll
        for (int i = 0; i < C::RPT; ++i) {
          a[i] = Kt[d * C::LO + ty * C::RPT + i];
          w[i] = Vt[d * C::LO + ty * C::RPT + i];
        }
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) {
          bq[j] = Qt[d * C::LL + tx * C::CPT + j];
          bo[j] = dOt[d * C::LL + tx * C::CPT + j];
        }
#pragma unroll
        for (int i = 0; i < C::RPT; ++i)
#pragma unroll
          for (int j = 0; j < C::CPT; ++j) {
            s[i][j] = fmaf(a[i], bq[j], s[i][j]);
            dp[i][j] = fmaf(w[i], bo[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        const int c = ty * C::RPT + i;     // kv row
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) {
          const int r = tx * C::CPT + j;   // query row
          float p, ds;
          p_and_ds(s[i][j], dp[i][j], lse_s[r], d_s[r], qpos_s[r],
                   qseg_s[r], kpos_s[c], kseg_s[c], m, &p, &ds);
          Ps[c * C::LL + r] = round_to<T>(p);
          dSs[c * C::LL + r] = round_to<T>(ds);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q; output columns tx + 16*j
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[C::RPT], dsv[C::RPT];
#pragma unroll
        for (int i = 0; i < C::RPT; ++i) {
          pv[i] = Ps[(ty * C::RPT + i) * C::LL + r];
          dsv[i] = dSs[(ty * C::RPT + i) * C::LL + r];
        }
#pragma unroll
        for (int j = 0; j < C::DPT; ++j) {
          const float o = dOt[(tx + 16 * j) * C::LL + r];
          const float qv = Qt[(tx + 16 * j) * C::LL + r];
#pragma unroll
          for (int i = 0; i < C::RPT; ++i) {
            dv_acc[i][j] = fmaf(pv[i], o, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const int c = ty * C::RPT + i;
    if (c >= kvrows) continue;
    const size_t off = ((size_t(b) * T_len + t0 + c) * K + kh) * DH;
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) {
      dk[off + tx + 16 * j] = from_float<T>(dk_acc[i][j] * m.scale);
      dv[off + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

using hopper::pack_bf16;

// ---------------------------------------------------------------------------
// dK / dV, bf16: wgmma, a TMA ring, warp specialisation, and a cluster of
// the G query heads of a kv head that sums the group through distributed
// shared memory (dh 64 / 128 / 256)
// ---------------------------------------------------------------------------

constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // see flash_fwd.cu

// Two consumer warpgroups and one producer warpgroup (one warp of it
// issues the loads). At dh 64 each consumer owns 64 kv rows of a 128-row
// tile. From dh 128 the two 64 x dh fp32 accumulators of dK and dV and
// the two score tiles do not fit a thread's registers, so the two
// share one 64-row tile and split dh: warpgroup 0 computes S^T,
// warpgroup 1 dP^T, they swap them through shared memory, and each
// accumulates its half of the columns of dK and dV.
template <int DH>
struct DkvCfg {
  static constexpr bool SPLIT = DH >= 128;
  static constexpr int KVT = SPLIT ? 64 : 128;  // kv rows per CTA
  static constexpr int BQ = 64;                 // query rows per ring entry
  static constexpr int STAGES = DH == 256 ? 2 : 3;
  static constexpr int CB = DH / 64;
  static constexpr int THREADS = 384;
  static constexpr int KV_BYTES = CB * KVT * 128;  // K or V
  static constexpr int QT_BYTES = CB * BQ * 128;   // Q or dO, one stage
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;
  // SPLIT: the warpgroups' exchange, 16 words a thread each way, in
  // buffers of two tile parities (one at dh 256, whose tiles leave no
  // room: a second barrier there keeps a tile's writes after the last
  // tile's reads)
  static constexpr int X_PARITIES = DH == 256 ? 1 : 2;
  static constexpr int OFF_X = OFF_DO + STAGES * QT_BYTES;
  static constexpr int X_BYTES = SPLIT ? X_PARITIES * 2 * 16 * 128 * 4 : 0;
  // per stage: lse, D, positions, segments [BQ] each, then (q0, interior)
  static constexpr int OFF_ROW = OFF_X + X_BYTES;
  static constexpr int ROW_INTS = 4 * BQ + 2;
  static constexpr int OFF_BAR = OFF_ROW + STAGES * ROW_INTS * 4;
  // the class of every query tile (hopper::kDead / kBoundary / kInterior)
  static constexpr int OFF_CLS = OFF_BAR + (1 + 2 * STAGES) * 8;
  static constexpr int BYTES = OFF_CLS + hopper::kMaxTiles + 1024;
  // the reduction's fp32 partials [KVT][SLD] over K, V and the ring
  static constexpr int SLD = DH + 4;
  static_assert(KVT * SLD * 4 <= OFF_X, "partials overflow the tiles");
};

struct DkvParams {
  const float *lse, *dvec;
  const int *qpos, *kvpos, *qseg, *kvseg;
  __nv_bfloat16 *dk, *dv;
  int S, T, H, K, G, causal, use_window, window;
  float scale, softcap;
};

// The producer warp: every live query tile of its head (from the class
// table) into the ring (K and V of the CTA's kv tile are on their way
// since the kernel's start): Q and dO
// by TMA; lse, D, positions and segments by cp.async (rows past S
// zero-filled: segment 0, never attended); its start and class by the
// lane that issues the TMA.
template <int DH>
__device__ __forceinline__ void dkv_producer(const CUtensorMap* tq,
                                             const CUtensorMap* tdo,
                                             const DkvParams& p, int h, int b,
                                             unsigned char* sm) {
  using C = DkvCfg<DH>;
  using namespace hopper;
  int* rows_s = reinterpret_cast<int*>(sm + C::OFF_ROW);
  const uint8_t* cls = sm + C::OFF_CLS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + C::STAGES;
  const int lane = threadIdx.x & 31;

  const int n_q = (p.S + C::BQ - 1) / C::BQ;
  const float* lse = p.lse + (size_t(b) * p.H + h) * p.S;
  const float* dvec = p.dvec + (size_t(b) * p.H + h) * p.S;
  const int* qpos = p.qpos + size_t(b) * p.S;
  const int* qseg = p.qseg + size_t(b) * p.S;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_q; ++it) {
    const uint8_t c = cls[it];
    if (c == kDead) continue;
    const int q0 = it * C::BQ;
    mbar_wait(&empty[stage], phase ^ 1);
    int* rs = rows_s + stage * C::ROW_INTS;
#pragma unroll
    for (int i = 0; i < C::BQ / 32; ++i) {
      const int r = lane + 32 * i;
      const bool ok = q0 + r < p.S;
      const int src = ok ? q0 + r : 0;
      cp_async4(&rs[r], lse + src, ok);
      cp_async4(&rs[C::BQ + r], dvec + src, ok);
      cp_async4(&rs[2 * C::BQ + r], qpos + src, ok);
      cp_async4(&rs[3 * C::BQ + r], qseg + src, ok);
    }
    cp_async_arrive(&full[stage]);
    if (lane == 0) {
      rs[4 * C::BQ] = q0;
      rs[4 * C::BQ + 1] = c == kInterior;
      mbar_arrive_tx(&full[stage], 2 * C::QT_BYTES);
      unsigned char* qdst = sm + C::OFF_Q + stage * C::QT_BYTES;
      unsigned char* odst = sm + C::OFF_DO + stage * C::QT_BYTES;
#pragma unroll
      for (int cb = 0; cb < C::CB; ++cb) {
        tma_load_4d(qdst + cb * C::BQ * 128, tq, &full[stage], cb * 64, h, q0,
                    b);
        tma_load_4d(odst + cb * C::BQ * 128, tdo, &full[stage], cb * 64, h,
                    q0, b);
      }
    }
    if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
  }
  mbar_wait(&empty[stage], phase ^ 1);
  if (lane == 0) {
    rows_s[stage * C::ROW_INTS + 4 * C::BQ] = hopper::kEndTile;
    mbar_arrive(&full[stage]);
  }
  cp_async_arrive(&full[stage]);  // no copies pending: arrives at once
}

// P^T and dS^T of query columns [8 J0, 8 (J0 + NJ)) of one 64 x 64 tile
// from the raw products S^T = K Q^T and dP^T = V dO^T of those columns,
// packed to bf16 as the A operands of dV += P^T dO and dK += dS^T Q
// (query columns 16k..16k+15 form k16 step k). P = 0 where the pair is
// masked (MASK: boundary tiles; rows that attend nothing have no kept
// pair), the softcap factor where P > 0 (CAP). Compile-time forms, so
// that a tile evaluates no softcap or mask it does not have.
template <bool CAP, bool MASK, int J0, int NJ>
__device__ __forceinline__ void dkv_elementwise(
    const float (&st)[4 * NJ], const float (&dpt)[4 * NJ],
    uint32_t (&pf)[4][4], uint32_t (&dsf)[4][4], const float* lse_s,
    const float* d_s, const int* qpos_s, const int* qseg_s,
    const int (&kp)[2], const int (&ksg)[2], int t, const DkvParams& p) {
  using hopper::fast_exp2;
  using hopper::kLog2e;
  using hopper::pack_bf16;
  // exp(x - lse) = 2^(x log2e - lse log2e), the scale folded into the
  // multiplier when there is no softcap
  const float mul = CAP ? kLog2e : p.scale * kLog2e;
  const float cap_in = CAP ? p.scale / p.softcap : 0.f;
  const float inv_cap = CAP ? 1.f / p.softcap : 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float pr[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;                           // kv row c0 + 8 hr
      const int r = 8 * (J0 + j) + 2 * t + (e & 1);    // query row
      float x = st[4 * j + e];
      if constexpr (CAP) x = tanhf(x * cap_in) * p.softcap;
      float pv = fast_exp2(fmaf(x, mul, -lse_s[r] * kLog2e));
      if constexpr (MASK) {
        bool keep = qseg_s[r] == ksg[hr] && ksg[hr] != 0;
        if (p.causal) keep = keep && kp[hr] <= qpos_s[r];
        if (p.use_window) keep = keep && kp[hr] > qpos_s[r] - p.window;
        pv = keep ? pv : 0.f;
      }
      float d = pv * (dpt[4 * j + e] - d_s[r]);
      if constexpr (CAP) {
        const float c = x * inv_cap;
        d = pv > 0.f ? d * (1.f - c * c) : d;
      }
      pr[e] = pv;
      ds[e] = d;
    }
    const int k = (J0 + j) / 2, h2 = ((J0 + j) & 1) * 2;
    pf[k][h2 + 0] = pack_bf16(pr[0], pr[1]);
    pf[k][h2 + 1] = pack_bf16(pr[2], pr[3]);
    dsf[k][h2 + 0] = pack_bf16(ds[0], ds[1]);
    dsf[k][h2 + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// The GQA group sum of one accumulator: every CTA of the cluster (one per
// query head of kv head h / G) writes its fp32 partial to its own shared
// memory (over K, V and the ring, all read by now); rank r then sums its
// share of the rows over ranks 0..G-1 in order, through distributed
// shared memory, scales, rounds once and writes [B, T, K, dh].
template <int DH, int NACC>
__device__ __forceinline__ void group_sum(const float (&acc)[NACC],
                                          __nv_bfloat16* dst, float scale,
                                          const DkvParams& p, int t0, int c0,
                                          int col0, unsigned char* sm) {
  using C = DkvCfg<DH>;
  using namespace hopper;
  float* part = reinterpret_cast<float*>(sm);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = c0 + 8 * hr;
      *reinterpret_cast<float2*>(part + row * C::SLD + col0 + 8 * j +
                                 2 * t) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
  cluster_sync();
  const int rank = int(cluster_rank());
  const int share = (C::KVT + p.G - 1) / p.G;
  const int rlo = rank * share, rhi = min(C::KVT, rlo + share);
  const int b = blockIdx.y, kh = int(blockIdx.x) / p.G;
  for (int i = threadIdx.x; i < (rhi - rlo) * (DH / 4); i += 256) {
    const int row = rlo + i / (DH / 4), c = 4 * (i % (DH / 4));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < p.G; ++src) {
      const float4 v =
          ld_cluster_f4(cluster_addr(part + row * C::SLD + c, src));
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    if (t0 + row < p.T) {
      uint2 w;
      w.x = pack_bf16(sum.x * scale, sum.y * scale);
      w.y = pack_bf16(sum.z * scale, sum.w * scale);
      *reinterpret_cast<uint2*>(
          dst + ((size_t(b) * p.T + t0 + row) * p.K + kh) * DH + c) = w;
    }
  }
  cluster_sync();  // the partials may be overwritten, the CTA may exit
}

template <int DH>
__device__ __forceinline__ void dkv_consumer(const DkvParams& p, int h,
                                             int b, int t0, int wg,
                                             unsigned char* sm) {
  using C = DkvCfg<DH>;
  using namespace hopper;
  constexpr int NACC = C::SPLIT ? DH / 4 : DH / 2;  // 64 x (dh or dh/2)
  const int* rows_s = reinterpret_cast<const int*>(sm + C::OFF_ROW);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + C::STAGES;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // this thread's kv rows c0 and c0 + 8 of the tile
  const int own = C::SPLIT ? 0 : 64 * wg;
  const int c0 = own + 16 * warp + g;
  int kp[2], ksg[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = t0 + c0 + 8 * hr;
    const bool ok = c < p.T;
    kp[hr] = ok ? p.kvpos[size_t(b) * p.T + c] : 0;
    ksg[hr] = ok ? p.kvseg[size_t(b) * p.T + c] : 0;
  }
  float dk[NACC], dv[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk[i] = dv[i] = 0.f;
  // dh columns this warpgroup accumulates: all, or its half at dh 256
  const int cb0 = C::SPLIT ? wg * C::CB / 2 : 0;
  const unsigned char* k_own = sm + own * 128;
  const unsigned char* v_own = sm + C::OFF_V + own * 128;
  // the exchange at dh >= 128: [parity][warpgroup][16][128] words
  uint32_t* xw = reinterpret_cast<uint32_t*>(sm + C::OFF_X);
  int parity = 0;

  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(&full[stage], phase);
    const int* rs = rows_s + stage * C::ROW_INTS;
    if (rs[4 * C::BQ] == hopper::kEndTile) break;
    const bool interior = rs[4 * C::BQ + 1] != 0;
    const float* lse_s = reinterpret_cast<const float*>(rs);
    const float* d_s = lse_s + C::BQ;
    const int* qpos_s = rs + 2 * C::BQ;
    const int* qseg_s = rs + 3 * C::BQ;
    const unsigned char* q_st = sm + C::OFF_Q + stage * C::QT_BYTES;
    const unsigned char* o_st = sm + C::OFF_DO + stage * C::QT_BYTES;

    // S^T = K Q^T and dP^T = V dO^T for 64 kv rows and NQ query columns:
    // all 64, or this warpgroup's half at dh >= 128
    constexpr int NQ = C::SPLIT ? 32 : 64;
    const int q_off = C::SPLIT ? wg * 32 * 128 : 0;
    float st[NQ / 2], dpt[NQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int cb = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(st, desc_sw128(k_own + cb * C::KVT * 128 + off, 16, 1024),
               desc_sw128(q_st + cb * C::BQ * 128 + q_off + off, 16, 1024),
               kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int cb = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(dpt, desc_sw128(v_own + cb * C::KVT * 128 + off, 16, 1024),
               desc_sw128(o_st + cb * C::BQ * 128 + q_off + off, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);
    reg_fence(dpt);

    uint32_t pf[4][4], dsf[4][4];
    const bool capped = p.softcap > 0.f;
#define DKV_ELEMENTWISE(J0, NJ)                                             \
  do {                                                                      \
    if (capped) {                                                           \
      if (interior)                                                         \
        dkv_elementwise<true, false, J0, NJ>(st, dpt, pf, dsf, lse_s, d_s,  \
                                             qpos_s, qseg_s, kp, ksg, t, p); \
      else                                                                  \
        dkv_elementwise<true, true, J0, NJ>(st, dpt, pf, dsf, lse_s, d_s,   \
                                            qpos_s, qseg_s, kp, ksg, t, p); \
    } else {                                                                \
      if (interior)                                                         \
        dkv_elementwise<false, false, J0, NJ>(st, dpt, pf, dsf, lse_s, d_s, \
                                              qpos_s, qseg_s, kp, ksg, t,   \
                                              p);                           \
      else                                                                  \
        dkv_elementwise<false, true, J0, NJ>(st, dpt, pf, dsf, lse_s, d_s,  \
                                             qpos_s, qseg_s, kp, ksg, t, p); \
    }                                                                       \
  } while (0)
    if constexpr (C::SPLIT) {
      // each warpgroup packs its half of the query columns and hands it
      // to the other through a buffer of this tile's parity; the other
      // has read it before it reaches the next tile's exchange, so a
      // write two tiles on is safe
      uint32_t* mine = xw + ((parity * 2 + wg) * 16) * 128;
      const uint32_t* theirs = xw + ((parity * 2 + 1 - wg) * 16) * 128;
      if (wg == 0) {
        DKV_ELEMENTWISE(0, 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mine[i * 128 + tid] = pf[i / 4][i % 4];
          mine[(8 + i) * 128 + tid] = dsf[i / 4][i % 4];
        }
      } else {
        DKV_ELEMENTWISE(4, 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mine[i * 128 + tid] = pf[2 + i / 4][i % 4];
          mine[(8 + i) * 128 + tid] = dsf[2 + i / 4][i % 4];
        }
      }
      named_sync(1, 256);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          pf[2 + i / 4][i % 4] = theirs[i * 128 + tid];
          dsf[2 + i / 4][i % 4] = theirs[(8 + i) * 128 + tid];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          pf[i / 4][i % 4] = theirs[i * 128 + tid];
          dsf[i / 4][i % 4] = theirs[(8 + i) * 128 + tid];
        }
      }
      if constexpr (C::X_PARITIES == 2)
        parity ^= 1;
      else
        named_sync(2, 256);  // both have read before either writes again
    } else {
      DKV_ELEMENTWISE(0, 8);
    }
#undef DKV_ELEMENTWISE

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)
      wgmma_rs(dv, pf[kk],
               desc_sw128(o_st + cb0 * C::BQ * 128 + kk * 16 * 128,
                          C::BQ * 128, 1024),
               1);
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)
      wgmma_rs(dk, dsf[kk],
               desc_sw128(q_st + cb0 * C::BQ * 128 + kk * 16 * 128,
                          C::BQ * 128, 1024),
               1);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dv);
    reg_fence(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
  }

  // The GQA group sum: every CTA of the cluster (one per query head of
  // kv head kh) writes its fp32 partial to its own shared memory; rank r
  // then sums its share of the rows over ranks 0..G-1 in order, through
  // distributed shared memory, and rounds once. dK first, then dV, in
  // the same buffer (over K, V and the ring, all read by now).
  named_sync(3, 256);
  const int col0 = C::SPLIT ? wg * DH / 2 : 0;
  group_sum<DH>(dk, p.dk, p.scale, p, t0, c0, col0, sm);
  group_sum<DH>(dv, p.dv, 1.f, p, t0, c0, col0, sm);
}

// One CTA per (query head, batch row, kv tile), the G CTAs of a kv head
// one cluster; the small-t0 kv tiles (the most live query tiles under
// causality) launch first.
template <int DH>
__global__ void __launch_bounds__(DkvCfg<DH>::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const DkvParams p) {
  using C = DkvCfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int t0 = int(blockIdx.z) * C::KVT;
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
    hopper::mbar_init(&bars[0], 1);
    for (int s = 0; s < C::STAGES; ++s) {
      // full: the 32 producer lanes' copies and the TMA lane's bytes
      hopper::mbar_init(&bars[1 + s], 33);
      hopper::mbar_init(&bars[1 + C::STAGES + s], 8);  // empty
    }
    hopper::fence_barrier_init();
    // K and V now, so that they load while the query tiles are classed
    const int kh = h / p.G;
    hopper::mbar_arrive_tx(&bars[0], 2 * C::KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < C::CB; ++cb) {
      hopper::tma_load_4d(sm + cb * C::KVT * 128, &tk, &bars[0], cb * 64, kh,
                          t0, b);
      hopper::tma_load_4d(sm + C::OFF_V + cb * C::KVT * 128, &tv, &bars[0],
                          cb * 64, kh, t0, b);
    }
  }
  // the class of every query tile against this kv tile, all threads (ends
  // with a CTA barrier, which also publishes the mbarriers)
  hopper::classify_tiles(p.kvpos + size_t(b) * p.T,
                         p.kvseg + size_t(b) * p.T, t0,
                         min(C::KVT, p.T - t0), t0 + C::KVT <= p.T,
                         p.qpos + size_t(b) * p.S, p.qseg + size_t(b) * p.S,
                         p.S, C::BQ, (p.S + C::BQ - 1) / C::BQ, false,
                         p.causal, p.use_window, p.window, sm + C::OFF_CLS);
  const int wg = hopper::warpgroup_index();
  if (wg == 2) {
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x / 32 == 8)
      dkv_producer<DH>(&tq, &tdo, p, h, b, sm);
    // the group sum's four cluster barriers count every thread
#pragma unroll 1
    for (int i = 0; i < 4; ++i) hopper::cluster_sync();
  } else {
    hopper::reg_alloc<kConsumerRegs>();
    dkv_consumer<DH>(p, h, b, t0, wg, sm);
  }
}

// ---------------------------------------------------------------------------
// dQ, bf16: wgmma, a TMA ring, warp specialisation (dh 64 / 128 / 256)
// ---------------------------------------------------------------------------

// Two consumer warpgroups and one producer warpgroup (one warp of it
// issues the loads). At dh 64 / 128 each consumer owns 64 query rows of a
// 128-row tile: S and dP (64 x 64, 32 registers each) and its dQ (64 x
// dh) fit a thread's registers. At dh 256 a 64 x 256 accumulator alone
// takes 128 registers, so the two share one 64-row tile as dK/dV does:
// each computes S and dP for half of the kv columns, forms and packs dS
// there, trades its packed half with the other through shared memory,
// and accumulates its half of dh of dQ (64 x 128).
template <int DH>
struct DqCfg {
  static constexpr bool SPLIT = DH == 256;
  static constexpr int BQ = SPLIT ? 64 : 128;  // query rows per CTA
  static constexpr int BKV = 64;               // kv rows per ring entry
  static constexpr int STAGES = SPLIT ? 2 : 4;
  static constexpr int CB = DH / 64;
  static constexpr int THREADS = 384;
  static constexpr int Q_BYTES = CB * BQ * 128;    // Q or dO
  static constexpr int KV_BYTES = CB * BKV * 128;  // K or V, one stage
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  // SPLIT: the dS exchange, 8 words a thread each way, in buffers of two
  // tile parities
  static constexpr int OFF_X = OFF_V + STAGES * KV_BYTES;
  static constexpr int X_BYTES = SPLIT ? 2 * 2 * 8 * 128 * 4 : 0;
  // per stage: kv positions and segments [BKV] each, then (t0, interior)
  static constexpr int OFF_POS = OFF_X + X_BYTES;
  static constexpr int OFF_BAR = OFF_POS + STAGES * (2 * BKV + 2) * 4;
  // the class of every kv tile (hopper::kDead / kBoundary / kInterior)
  static constexpr int OFF_CLS = OFF_BAR + (1 + 2 * STAGES) * 8;
  static constexpr int BYTES = OFF_CLS + hopper::kMaxTiles + 1024;
  static_assert(BYTES <= 232448, "over the 227 KB of shared memory");
};

struct DqParams {
  const float *lse, *dvec;
  const int *qpos, *kvpos, *qseg, *kvseg;
  __nv_bfloat16* dq;
  int S, T, H, K, causal, use_window, window, n_qt;
  float scale, softcap;
};

// dS of kv columns [8 J0, 8 (J0 + NJ)) of this thread's two query rows
// from the raw products S = Q K^T and dP = dO V^T of those columns (s and
// dp hold them from column 8 J0 on), packed to bf16 as the A operand of
// dQ += dS K (kv columns 16k..16k+15 form k16 step k). P = exp(s~ - lse)
// on kept pairs (MASK: boundary tiles), 0 elsewhere; the softcap factor
// where P > 0 (CAP). Compile-time forms, so that a tile evaluates no
// softcap or mask it does not have. lse2: lse log2e of the two rows.
template <bool CAP, bool MASK, int J0, int NJ>
__device__ __forceinline__ void dq_elementwise(
    const float (&s)[4 * NJ], const float (&dp)[4 * NJ],
    uint32_t (&dsf)[4][4], const float (&lse2)[2], const float (&dv)[2],
    const int (&qp)[2], const int (&qs)[2], const int* kp, const int* ksg,
    int t, const DqParams& p) {
  using hopper::fast_exp2;
  using hopper::kLog2e;
  using hopper::pack_bf16;
  // exp(x - lse) = 2^(x log2e - lse log2e), the scale folded into the
  // multiplier when there is no softcap
  const float mul = CAP ? kLog2e : p.scale * kLog2e;
  const float cap_in = CAP ? p.scale / p.softcap : 0.f;
  const float inv_cap = CAP ? 1.f / p.softcap : 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;                          // query row g + 8 hr
      const int c = 8 * (J0 + j) + 2 * t + (e & 1);   // kv column
      float x = s[4 * j + e];
      if constexpr (CAP) x = tanhf(x * cap_in) * p.softcap;
      float pv = fast_exp2(fmaf(x, mul, -lse2[hr]));
      if constexpr (MASK) {
        bool keep = qs[hr] == ksg[c] && ksg[c] != 0;
        if (p.causal) keep = keep && kp[c] <= qp[hr];
        if (p.use_window) keep = keep && kp[c] > qp[hr] - p.window;
        pv = keep ? pv : 0.f;
      }
      float d = pv * (dp[4 * j + e] - dv[hr]);
      if constexpr (CAP) {
        const float cc = x * inv_cap;
        d = pv > 0.f ? d * (1.f - cc * cc) : d;
      }
      ds[e] = d;
    }
    const int k = (J0 + j) / 2, h2 = ((J0 + j) & 1) * 2;
    dsf[k][h2 + 0] = pack_bf16(ds[0], ds[1]);
    dsf[k][h2 + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// A consumer warpgroup: S = Q K^T and dP = dO V^T by wgmma from shared
// memory (both operands K-major), dS in registers, dQ += dS K by wgmma
// with dS from registers and K read MN-major through the transpose
// immediate (no transposed copy); dQ scaled and rounded once at the end.
template <int DH>
__device__ __forceinline__ void dq_consumer(const DqParams& p, int h, int b,
                                            int q0, int wg,
                                            unsigned char* sm) {
  using C = DqCfg<DH>;
  constexpr int BKV = C::BKV;
  using namespace hopper;
  const int* kpos_s = reinterpret_cast<const int*>(sm + C::OFF_POS);
  const int* kseg_s = kpos_s + C::STAGES * BKV;
  const int* info_s = kseg_s + C::STAGES * BKV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + C::STAGES;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // this thread's query rows r0 and r0 + 8 (the warpgroup's own 64, or
  // the 64 both share at dh 256), with what stays fixed along the kv loop;
  // rows past S read as padding and are never written
  const int own = C::SPLIT ? 0 : 64 * wg;
  const int r0 = q0 + own + 16 * warp + g;
  float lse2[2], dv[2];
  int qp[2], qs[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    const bool ok = r < p.S;
    const size_t hrow = (size_t(b) * p.H + h) * p.S + r;
    lse2[hr] = ok ? p.lse[hrow] * kLog2e : 0.f;
    dv[hr] = ok ? p.dvec[hrow] : 0.f;
    qp[hr] = ok ? p.qpos[size_t(b) * p.S + r] : 0;
    qs[hr] = ok ? p.qseg[size_t(b) * p.S + r] : 0;
  }
  constexpr int NACC = C::SPLIT ? 64 : DH / 2;  // 64 x 128 or 64 x dh
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const unsigned char* q_own = sm + own * 128;
  const unsigned char* o_own = sm + C::OFF_DO + own * 128;
  // dh columns this warpgroup accumulates: all, or its half at dh 256
  const int cb0 = C::SPLIT ? wg * C::CB / 2 : 0;
  // the exchange at dh 256: [parity][warpgroup][8][128] words
  uint32_t* xw = reinterpret_cast<uint32_t*>(sm + C::OFF_X);
  int parity = 0;
  const bool capped = p.softcap > 0.f;

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(&full[stage], phase);
    if (info_s[2 * stage] == hopper::kEndTile) break;
    const bool interior = info_s[2 * stage + 1] != 0;
    const unsigned char* k_st = sm + C::OFF_K + stage * C::KV_BYTES;
    const unsigned char* v_st = sm + C::OFF_V + stage * C::KV_BYTES;
    const int* kp = kpos_s + stage * BKV;
    const int* ksg = kseg_s + stage * BKV;

    // S and dP for the 64 own query rows and NKV kv columns: all 64, or
    // this warpgroup's half at dh 256
    constexpr int NKV = C::SPLIT ? 32 : 64;
    const int kv_off = C::SPLIT ? wg * 32 * 128 : 0;
    float s[NKV / 2], dp[NKV / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int cb = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(s, desc_sw128(q_own + cb * C::BQ * 128 + off, 16, 1024),
               desc_sw128(k_st + cb * BKV * 128 + kv_off + off, 16, 1024),
               kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int cb = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(dp, desc_sw128(o_own + cb * C::BQ * 128 + off, 16, 1024),
               desc_sw128(v_st + cb * BKV * 128 + kv_off + off, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    uint32_t dsf[4][4];
#define DQ_ELEMENTWISE(J0, NJ)                                               \
  do {                                                                       \
    if (capped) {                                                            \
      if (interior)                                                          \
        dq_elementwise<true, false, J0, NJ>(s, dp, dsf, lse2, dv, qp, qs, kp, \
                                            ksg, t, p);                      \
      else                                                                   \
        dq_elementwise<true, true, J0, NJ>(s, dp, dsf, lse2, dv, qp, qs, kp,  \
                                           ksg, t, p);                       \
    } else {                                                                 \
      if (interior)                                                          \
        dq_elementwise<false, false, J0, NJ>(s, dp, dsf, lse2, dv, qp, qs,   \
                                             kp, ksg, t, p);                 \
      else                                                                   \
        dq_elementwise<false, true, J0, NJ>(s, dp, dsf, lse2, dv, qp, qs, kp, \
                                            ksg, t, p);                      \
    }                                                                        \
  } while (0)
    if constexpr (C::SPLIT) {
      // each warpgroup packs dS of its half of the kv columns and hands
      // it to the other through a buffer of this tile's parity; the other
      // has read it before it reaches the next tile's exchange, so a
      // write two tiles on is safe
      uint32_t* mine = xw + ((parity * 2 + wg) * 8) * 128;
      const uint32_t* theirs = xw + ((parity * 2 + 1 - wg) * 8) * 128;
      if (wg == 0) {
        DQ_ELEMENTWISE(0, 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) mine[i * 128 + tid] = dsf[i / 4][i % 4];
      } else {
        DQ_ELEMENTWISE(4, 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mine[i * 128 + tid] = dsf[2 + i / 4][i % 4];
      }
      named_sync(1, 256);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dsf[2 + i / 4][i % 4] = theirs[i * 128 + tid];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) dsf[i / 4][i % 4] = theirs[i * 128 + tid];
      }
      parity ^= 1;
    } else {
      DQ_ELEMENTWISE(0, 8);
    }
#undef DQ_ELEMENTWISE

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs(acc, dsf[kk],
               desc_sw128(k_st + cb0 * BKV * 128 + kk * 16 * 128, BKV * 128,
                          1024),
               1);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= p.S) continue;
    __nv_bfloat16* row =
        p.dq + ((size_t(b) * p.S + r) * p.H + h) * DH + cb0 * 64 + 2 * t;
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[4 * j + 2 * hr] * p.scale,
                    acc[4 * j + 2 * hr + 1] * p.scale);
  }
}

// One CTA per (query head, batch row, query tile), the query tiles with
// the most live kv tiles under causality (the last) launched first. Every
// dQ element is summed by one CTA in kv order: no atomics,
// bitwise-repeatable.
template <int DH>
__global__ void __launch_bounds__(DqCfg<DH>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const DqParams p) {
  using C = DqCfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (p.n_qt - 1 - int(blockIdx.z)) * C::BQ;
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
    hopper::mbar_init(&bars[0], 1);
    for (int s = 0; s < C::STAGES; ++s) {
      // full: the 32 producer lanes' copies and the TMA lane's bytes
      hopper::mbar_init(&bars[1 + s], 33);
      hopper::mbar_init(&bars[1 + C::STAGES + s], 8);  // empty
    }
    hopper::fence_barrier_init();
    // Q and dO now, so that they load while the kv tiles are classed
    hopper::mbar_arrive_tx(&bars[0], 2 * C::Q_BYTES);
#pragma unroll
    for (int cb = 0; cb < C::CB; ++cb) {
      hopper::tma_load_4d(sm + cb * C::BQ * 128, &tq, &bars[0], cb * 64, h,
                          q0, b);
      hopper::tma_load_4d(sm + C::OFF_DO + cb * C::BQ * 128, &tdo, &bars[0],
                          cb * 64, h, q0, b);
    }
  }
  // the class of every kv tile against this query tile, all threads (ends
  // with a CTA barrier, which also publishes the mbarriers); rows past S
  // are never written, so the query tile counts as full
  hopper::classify_tiles(p.qpos + size_t(b) * p.S, p.qseg + size_t(b) * p.S,
                         q0, min(C::BQ, p.S - q0), true,
                         p.kvpos + size_t(b) * p.T,
                         p.kvseg + size_t(b) * p.T, p.T, C::BKV,
                         (p.T + C::BKV - 1) / C::BKV, true, p.causal,
                         p.use_window, p.window, sm + C::OFF_CLS);
  const int wg = hopper::warpgroup_index();
  if (wg == 2) {
    hopper::reg_dealloc<kProducerRegs>();
    // Q and dO are on their way since the kernel's start
    if (threadIdx.x / 32 == 8)
      hopper::kv_ring_producer<C>(&tk, &tv, p.kvpos + size_t(b) * p.T,
                                  p.kvseg + size_t(b) * p.T, p.T,
                                  h / (p.H / p.K), b, sm);
  } else {
    hopper::reg_alloc<kConsumerRegs>();
    dq_consumer<DH>(p, h, b, q0, wg, sm);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dvec;
  const int *qpos, *kvpos, *qseg, *kvseg;
  int B, S, T, H, K;
  Mask m;
};

template <typename T, int DH>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<T, DH>;
  constexpr size_t smem = DqSmem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + Tile<DH>::BOWN - 1) / Tile<DH>::BOWN, a.H, a.B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.dvec, a.qpos, a.kvpos, a.qseg, a.kvseg, static_cast<T*>(dq), a.S,
      a.T, a.H, a.K, a.m);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  auto kern = flash_bwd_dkv_kernel<T, DH>;
  constexpr size_t smem = DkvSmem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + Tile<DH>::BOWN - 1) / Tile<DH>::BOWN, a.K, a.B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.dvec, a.qpos, a.kvpos, a.qseg, a.kvseg, static_cast<T*>(dk),
      static_cast<T*>(dv), a.S, a.T, a.H, a.K, a.m);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_wgmma(const Args& a, void* dk, void* dv,
                             cudaStream_t st) {
  using C = DkvCfg<DH>;
  const int G = a.H / a.K;
  if (G > 8) return cudaErrorInvalidValue;  // the cluster's portable limit
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = hopper::head_rows_map(&tq, a.q, a.B, a.S, a.H, DH, C::BQ)) !=
          cudaSuccess ||
      (err = hopper::head_rows_map(&tdo, a.dout, a.B, a.S, a.H, DH,
                                   C::BQ)) != cudaSuccess ||
      (err = hopper::head_rows_map(&tk, a.k, a.B, a.T, a.K, DH, C::KVT)) !=
          cudaSuccess ||
      (err = hopper::head_rows_map(&tv, a.v, a.B, a.T, a.K, DH, C::KVT)) !=
          cudaSuccess)
    return err;
  if ((a.S + C::BQ - 1) / C::BQ > hopper::kMaxTiles)
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_wgmma_kernel<DH>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::BYTES);
  if (err != cudaSuccess) return err;
  const DkvParams p{a.lse, a.dvec, a.qpos, a.kvpos, a.qseg, a.kvseg,
                    static_cast<__nv_bfloat16*>(dk),
                    static_cast<__nv_bfloat16*>(dv), a.S, a.T, a.H, a.K, G,
                    a.m.causal, a.m.use_window, a.m.window, a.m.scale,
                    a.m.softcap};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.B, (a.T + C::KVT - 1) / C::KVT);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, tq, tk, tv, tdo, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_wgmma(const Args& a, void* dq, cudaStream_t st) {
  using C = DqCfg<DH>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = hopper::head_rows_map(&tq, a.q, a.B, a.S, a.H, DH, C::BQ)) !=
          cudaSuccess ||
      (err = hopper::head_rows_map(&tdo, a.dout, a.B, a.S, a.H, DH,
                                   C::BQ)) != cudaSuccess ||
      (err = hopper::head_rows_map(&tk, a.k, a.B, a.T, a.K, DH, C::BKV)) !=
          cudaSuccess ||
      (err = hopper::head_rows_map(&tv, a.v, a.B, a.T, a.K, DH, C::BKV)) !=
          cudaSuccess)
    return err;
  if ((a.T + C::BKV - 1) / C::BKV > hopper::kMaxTiles)
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_wgmma_kernel<DH>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::BYTES);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.S + C::BQ - 1) / C::BQ;
  const DqParams p{a.lse, a.dvec, a.qpos, a.kvpos, a.qseg, a.kvseg,
                   static_cast<__nv_bfloat16*>(dq), a.S, a.T, a.H, a.K,
                   a.m.causal, a.m.use_window, a.m.window, n_qt, a.m.scale,
                   a.m.softcap};
  kern<<<dim3(a.H, a.B, n_qt), C::THREADS, C::BYTES, st>>>(tq, tk, tv, tdo,
                                                           p);
  return cudaGetLastError();
}

bool make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dvec, const void* qpos,
               const void* kvpos, const void* qseg, const void* kvseg, int B,
               int S, int T_len, int H, int K, int causal, int use_window,
               int window, float scale, float softcap, Args* a) {
  if (B < 1 || S < 1 || T_len < 1 || K < 1 || H % K != 0) return false;
  *a = Args{q, k, v, dout,
            static_cast<const float*>(lse), static_cast<const float*>(dvec),
            static_cast<const int*>(qpos), static_cast<const int*>(kvpos),
            static_cast<const int*>(qseg), static_cast<const int*>(kvseg),
            B, S, T_len, H, K,
            Mask{causal, use_window, window, scale, softcap}};
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means none; use_window = 0
// means no sliding window. In bf16 both entries take their wgmma bodies at
// every head dim (dK/dV: G <= 8); they need q, k, v and dO 16-byte aligned
// (the wrapper checks). float32 takes the scalar bodies. Each returns a
// cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dvec, const void* qpos,
                            const void* kvpos, const void* qseg,
                            const void* kvseg, void* dq, int B, int S,
                            int T_len, int H, int K, int dh, int dtype,
                            int causal, int use_window, int window,
                            float scale, float softcap, void* stream) {
  Args a;
  if (!make_args(q, k, v, dout, lse, dvec, qpos, kvpos, qseg, kvseg, B, S,
                 T_len, H, K, causal, use_window, window, scale, softcap, &a))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (dh) {
      case 64: return int(launch_dq_wgmma<64>(a, dq, st));
      case 128: return int(launch_dq_wgmma<128>(a, dq, st));
      case 256: return int(launch_dq_wgmma<256>(a, dq, st));
    }
  } else if (dtype == 0) {
    switch (dh) {
      case 64: return int(launch_dq<float, 64>(a, dq, st));
      case 128: return int(launch_dq<float, 128>(a, dq, st));
      case 256: return int(launch_dq<float, 256>(a, dq, st));
    }
  }
  return int(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dvec, const void* qpos,
                             const void* kvpos, const void* qseg,
                             const void* kvseg, void* dk, void* dv, int B,
                             int S, int T_len, int H, int K, int dh,
                             int dtype, int causal, int use_window,
                             int window, float scale, float softcap,
                             void* stream) {
  Args a;
  if (!make_args(q, k, v, dout, lse, dvec, qpos, kvpos, qseg, kvseg, B, S,
                 T_len, H, K, causal, use_window, window, scale, softcap, &a))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (dh) {
      case 64: return int(launch_dkv_wgmma<64>(a, dk, dv, st));
      case 128: return int(launch_dkv_wgmma<128>(a, dk, dv, st));
      case 256: return int(launch_dkv_wgmma<256>(a, dk, dv, st));
    }
  } else if (dtype == 0) {
    switch (dh) {
      case 64: return int(launch_dkv<float, 64>(a, dk, dv, st));
      case 128: return int(launch_dkv<float, 128>(a, dk, dv, st));
      case 256: return int(launch_dkv<float, 256>(a, dk, dv, st));
    }
  }
  return int(cudaErrorInvalidValue);
}
