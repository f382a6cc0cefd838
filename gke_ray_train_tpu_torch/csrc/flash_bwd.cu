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
// - dQ: one CTA per (query tile, query head, batch row) loops over the kv
//   tiles of kv head h / G;
// - dK/dV: one CTA per (kv tile, kv head, batch row) loops over the G
//   query heads of its group and all their live query tiles, so the GQA
//   group sum happens in fp32 registers and dK/dV are written once as
//   [B, T, K, dh]: no per-query-head [B, H, T, dh] buffer (JAX :465-479)
//   and no atomics. In bf16 this rounds once where JAX rounds each head's
//   partial before the sum; at fp32 the two agree.
// Two bodies share that structure:
// - bf16 with dh 64 or 128 (every training shape of the shipped Llama /
//   Mistral / Qwen families): tensor cores through `mma.sync` m16n8k16,
//   four warps of 16 own rows, 64-row loop tiles staged in shared memory
//   as bf16, row-major and transposed. P and dS stay in registers between
//   the two products of a tile: the score accumulators are laid out as the
//   A operand of the second product, whose bf16 packing is the rounding
//   the TPU kernels do with `.astype`.
// - float32, and bf16 at dh 256 (Gemma-2): scalar fp32 FMAs, 256 threads
//   as a 16 x 16 grid, each with a register micro-tile of scores and of
//   output columns; tiles staged in shared memory as fp32, transposed
//   where a product reads them down a column, with padded leading
//   dimensions against bank conflicts.
//
// Bound. At the training shape (B=2, S=T=1024, H=32, K=8, dh=128, bf16,
// causal) the dQ kernel does 3 products and the dK/dV kernel 4 over the
// 524,800 live pairs of each (batch row, head): 25.8 and 34.4 GFLOP, and
// each moves ~50-60 MB, so both are bound by operations (~0.026 and
// ~0.035 ms at 989 TFLOP/s bf16). `mma.sync` reaches a fraction of the
// wgmma rate, loads are not overlapped with the products (no cp.async /
// TMA ring), and the dK/dV grid has only T/64 x K x B CTAs with a causal
// imbalance between them; wgmma, a TMA ring, warp specialisation and a
// split of the dK/dV loop over more CTAs are the later work.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrappers raise when that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

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
// dK / dV: one CTA per (kv tile, kv head, batch row), over the G query
// heads of the group
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

// ---------------------------------------------------------------------------
// bf16 tensor-core bodies (dh 64 / 128)
// ---------------------------------------------------------------------------
//
// Four warps, 16 "own" rows each (query rows for dQ, kv rows for dK/dV), a
// 64-row loop tile. Every product is `mma.sync` m16n8k16 (bf16 in, fp32
// accumulate). The score-like products (S = Q K^T and dP = dO V^T, or
// their transposes for dK/dV) read their A operand from registers (dQ: Q
// and dO, loaded once) or from row-major shared memory (dK/dV: K and V),
// their B operand from row-major tiles; their accumulators are laid out
// as the A operand of the second products, so P and dS go from registers
// to dQ += dS K, dV += P^T dO and dK += dS^T Q, rounded to bf16 by the
// operand packing, without touching shared memory. The B operands of the
// second products are the transposed tiles.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaTile = 64;  // own rows per CTA, loop rows per tile

template <int DH>
struct MmaTile {
  static constexpr int LDR = DH + 8;        // bf16 per row-major row
  static constexpr int LDT = kMmaTile + 8;  // bf16 per transposed row
  static constexpr int ROW_ELEMS = kMmaTile * LDR;
  static constexpr int T_ELEMS = DH * LDT;
  static constexpr int INTS = 4 * kMmaTile + 4 * kMmaWarps;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 acc.
// Fragment layout (lane = 4 * g + t): a = {A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r, r + 16) x columns [c, c + 16) of a row-major
// bf16 tile with leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int r, int c, int g, int t) {
  const __nv_bfloat16* p0 = tile + (r + g) * ld + c + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// Stage rows [r0, r0 + nrows) of a [len, heads, DH] bf16 tensor's head
// (row stride `stride` elements) into a row-major tile (leading dim LDR)
// and, when `tr` is given, its transpose (leading dim LDT); rows past
// nrows read as zero. 16-byte loads.
template <int DH>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* base,
                                           size_t stride, int r0, int nrows,
                                           __nv_bfloat16* rows,
                                           __nv_bfloat16* tr) {
  using C = MmaTile<DH>;
  constexpr int VEC = 8;
  for (int i = threadIdx.x; i < kMmaTile * DH / VEC; i += kMmaThreads) {
    const int r = i / (DH / VEC), c = (i % (DH / VEC)) * VEC;
    uint4 v4 = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      v4 = *reinterpret_cast<const uint4*>(base + size_t(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(rows + r * C::LDR + c) = v4;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v4);
#pragma unroll
      for (int j = 0; j < VEC; ++j) tr[(c + j) * C::LDT + r] = e[j];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        const int* __restrict__ qpos,
                        const int* __restrict__ kvpos,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kvseg,
                        __nv_bfloat16* __restrict__ dq, int S, int T_len,
                        int H, int K, Mask m) {
  using C = MmaTile<DH>;
  constexpr int KSTEPS = DH / 16;  // k16 steps over the head dim
  constexpr int NT_O = DH / 8;     // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + C::ROW_ELEMS;
  __nv_bfloat16* Kt = Vs + C::ROW_ELEMS;
  int* qpos_s = reinterpret_cast<int*>(Kt + C::T_ELEMS);
  int* qseg_s = qpos_s + kMmaTile;
  int* kpos_s = qseg_s + kMmaTile;
  int* kseg_s = kpos_s + kMmaTile;
  int* red = kseg_s + kMmaTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int qrows = min(kMmaTile, S - q0);
  const size_t q_stride = size_t(H) * DH;
  const size_t kv_stride = size_t(K) * DH;
  const size_t q_off = (size_t(b) * S * H + h) * DH;
  const size_t kv_off = (size_t(b) * T_len * K + kh) * DH;

  if (tid < kMmaTile) {
    const bool ok = tid < qrows;
    qpos_s[tid] = ok ? qpos[size_t(b) * S + q0 + tid] : 0;
    qseg_s[tid] = ok ? qseg[size_t(b) * S + q0 + tid] : 0;
  }
  // this thread's two query rows, their lse and D, and the A fragments of
  // Q and dO for the whole kv loop
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < qrows, ok1 = r1 < qrows;
  const size_t hrow = (size_t(b) * H + h) * S + q0;
  const float lse_r[2] = {ok0 ? lse[hrow + r0] : 0.f,
                          ok1 ? lse[hrow + r1] : 0.f};
  const float d_r[2] = {ok0 ? dvec[hrow + r0] : 0.f,
                        ok1 ? dvec[hrow + r1] : 0.f};
  uint32_t qf[KSTEPS][4], of[KSTEPS][4];
  {
    const __nv_bfloat16* q_r0 = q + q_off + size_t(q0 + r0) * q_stride + 2 * t;
    const __nv_bfloat16* q_r1 = q + q_off + size_t(q0 + r1) * q_stride + 2 * t;
    const __nv_bfloat16* o_r0 =
        dout + q_off + size_t(q0 + r0) * q_stride + 2 * t;
    const __nv_bfloat16* o_r1 =
        dout + q_off + size_t(q0 + r1) * q_stride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qf[kk][0] = ok0 ? ld32(q_r0 + kk * 16) : 0u;
      qf[kk][1] = ok1 ? ld32(q_r1 + kk * 16) : 0u;
      qf[kk][2] = ok0 ? ld32(q_r0 + kk * 16 + 8) : 0u;
      qf[kk][3] = ok1 ? ld32(q_r1 + kk * 16 + 8) : 0u;
      of[kk][0] = ok0 ? ld32(o_r0 + kk * 16) : 0u;
      of[kk][1] = ok1 ? ld32(o_r1 + kk * 16) : 0u;
      of[kk][2] = ok0 ? ld32(o_r0 + kk * 16 + 8) : 0u;
      of[kk][3] = ok1 ? ld32(o_r1 + kk * 16 + 8) : 0u;
    }
  }
  __syncthreads();
  int qmm[4];
  tile_minmax<kMmaWarps>(qpos_s, qseg_s, qrows, qmm, red);
  const int qp[2] = {qpos_s[r0], qpos_s[r1]};
  const int qs[2] = {qseg_s[r0], qseg_s[r1]};

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int n_kv = (T_len + kMmaTile - 1) / kMmaTile;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int t0 = jt * kMmaTile;
    const int kvcols = min(kMmaTile, T_len - t0);
    if (tid < kMmaTile) {
      const bool ok = tid < kvcols;
      kpos_s[tid] = ok ? kvpos[size_t(b) * T_len + t0 + tid] : 0;
      kseg_s[tid] = ok ? kvseg[size_t(b) * T_len + t0 + tid] : 0;
    }
    __syncthreads();
    int kmm[4];
    tile_minmax<kMmaWarps>(kpos_s, kseg_s, kvcols, kmm, red);
    if (!block_live(qmm, kmm, m.causal, m.use_window, m.window)) continue;

    stage_bf16<DH>(k + kv_off, kv_stride, t0, kvcols, Ks, Kt);
    stage_bf16<DH>(v + kv_off, kv_stride, t0, kvcols, Vs, nullptr);
    __syncthreads();

    // 16 kv columns at a time: S and dP for two n8 tiles, dS packed as the
    // A operand of dQ += dS K
#pragma unroll
    for (int ks = 0; ks < kMmaTile / 16; ++ks) {
      uint32_t dsf[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * ks + half;
        float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* krow = Ks + (j * 8 + g) * C::LDR + 2 * t;
        const __nv_bfloat16* vrow = Vs + (j * 8 + g) * C::LDR + 2 * t;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          mma_bf16(sc, qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
          mma_bf16(dp, of[kk], ld32(vrow + kk * 16), ld32(vrow + kk * 16 + 8));
        }
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int c = j * 8 + 2 * t + (e & 1);
          float p;
          p_and_ds(sc[e], dp[e], lse_r[hr], d_r[hr], qp[hr], qs[hr],
                   kpos_s[c], kseg_s[c], m, &p, &ds[e]);
        }
        dsf[half * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[half * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* kt = Kt + (n * 8 + g) * C::LDT + ks * 16 + 2 * t;
        mma_bf16(o[n], dsf, ld32(kt), ld32(kt + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = hr ? r1 : r0;
    if (r >= qrows) continue;
    __nv_bfloat16* row = dq + ((size_t(b) * S + q0 + r) * H + h) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(o[n][2 * hr] * m.scale, o[n][2 * hr + 1] * m.scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         const int* __restrict__ qpos,
                         const int* __restrict__ kvpos,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kvseg,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int T_len,
                         int H, int K, Mask m) {
  using C = MmaTile<DH>;
  constexpr int KSTEPS = DH / 16;
  constexpr int NT_O = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + C::ROW_ELEMS;
  __nv_bfloat16* Qs = Vs + C::ROW_ELEMS;
  __nv_bfloat16* dOs = Qs + C::ROW_ELEMS;
  __nv_bfloat16* Qt = dOs + C::ROW_ELEMS;
  __nv_bfloat16* dOt = Qt + C::T_ELEMS;
  float* lse_s = reinterpret_cast<float*>(dOt + C::T_ELEMS);
  float* d_s = lse_s + kMmaTile;
  int* qpos_s = reinterpret_cast<int*>(d_s + kMmaTile);
  int* qseg_s = qpos_s + kMmaTile;
  int* kpos_s = qseg_s + kMmaTile;
  int* kseg_s = kpos_s + kMmaTile;
  int* red = kseg_s + kMmaTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.x * kMmaTile;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int kvrows = min(kMmaTile, T_len - t0);
  const size_t q_stride = size_t(H) * DH;
  const size_t kv_stride = size_t(K) * DH;
  const size_t kv_off = (size_t(b) * T_len * K + kh) * DH;

  stage_bf16<DH>(k + kv_off, kv_stride, t0, kvrows, Ks, nullptr);
  stage_bf16<DH>(v + kv_off, kv_stride, t0, kvrows, Vs, nullptr);
  if (tid < kMmaTile) {
    const bool ok = tid < kvrows;
    kpos_s[tid] = ok ? kvpos[size_t(b) * T_len + t0 + tid] : 0;
    kseg_s[tid] = ok ? kvseg[size_t(b) * T_len + t0 + tid] : 0;
  }
  __syncthreads();
  int kmm[4];
  tile_minmax<kMmaWarps>(kpos_s, kseg_s, kvrows, kmm, red);
  // this thread's two kv rows of its warp's 16
  const int c0 = warp * 16 + g, c1 = c0 + 8;
  const int kp[2] = {kpos_s[c0], kpos_s[c1]};
  const int kseg_r[2] = {kseg_s[c0], kseg_s[c1]};

  float dk_acc[NT_O][4], dv_acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_q = (S + kMmaTile - 1) / kMmaTile;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const size_t q_off = (size_t(b) * S * H + h) * DH;
    for (int it = 0; it < n_q; ++it) {
      const int q0 = it * kMmaTile;
      const int qrows = min(kMmaTile, S - q0);
      if (tid < kMmaTile) {
        const bool ok = tid < qrows;
        const size_t hrow = (size_t(b) * H + h) * S + q0 + tid;
        qpos_s[tid] = ok ? qpos[size_t(b) * S + q0 + tid] : 0;
        qseg_s[tid] = ok ? qseg[size_t(b) * S + q0 + tid] : 0;
        lse_s[tid] = ok ? lse[hrow] : 0.f;
        d_s[tid] = ok ? dvec[hrow] : 0.f;
      }
      __syncthreads();
      int qmm[4];
      tile_minmax<kMmaWarps>(qpos_s, qseg_s, qrows, qmm, red);
      if (!block_live(qmm, kmm, m.causal, m.use_window, m.window)) continue;

      stage_bf16<DH>(q + q_off, q_stride, q0, qrows, Qs, Qt);
      stage_bf16<DH>(dout + q_off, q_stride, q0, qrows, dOs, dOt);
      __syncthreads();

      // 16 query columns at a time: S^T = K Q^T and dP^T = V dO^T for two
      // n8 tiles, P^T and dS^T packed as the A operands of dV += P^T dO
      // and dK += dS^T Q
#pragma unroll
      for (int ks = 0; ks < kMmaTile / 16; ++ks) {
        uint32_t pf[4], dsf[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * ks + half;
          float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
          const __nv_bfloat16* qrow = Qs + (j * 8 + g) * C::LDR + 2 * t;
          const __nv_bfloat16* orow = dOs + (j * 8 + g) * C::LDR + 2 * t;
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t a[4];
            load_a(a, Ks, C::LDR, warp * 16, kk * 16, g, t);
            mma_bf16(sc, a, ld32(qrow + kk * 16), ld32(qrow + kk * 16 + 8));
            load_a(a, Vs, C::LDR, warp * 16, kk * 16, g, t);
            mma_bf16(dp, a, ld32(orow + kk * 16), ld32(orow + kk * 16 + 8));
          }
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;                  // kv row c0 or c1
            const int r = j * 8 + 2 * t + (e & 1);  // query row
            p_and_ds(sc[e], dp[e], lse_s[r], d_s[r], qpos_s[r], qseg_s[r],
                     kp[hr], kseg_r[hr], m, &p[e], &ds[e]);
          }
          pf[half * 2 + 0] = pack_bf16(p[0], p[1]);
          pf[half * 2 + 1] = pack_bf16(p[2], p[3]);
          dsf[half * 2 + 0] = pack_bf16(ds[0], ds[1]);
          dsf[half * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          const __nv_bfloat16* ot = dOt + (n * 8 + g) * C::LDT + ks * 16 + 2 * t;
          const __nv_bfloat16* qt = Qt + (n * 8 + g) * C::LDT + ks * 16 + 2 * t;
          mma_bf16(dv_acc[n], pf, ld32(ot), ld32(ot + 8));
          mma_bf16(dk_acc[n], dsf, ld32(qt), ld32(qt + 8));
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int c = hr ? c1 : c0;
    if (c >= kvrows) continue;
    const size_t off = ((size_t(b) * T_len + t0 + c) * K + kh) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) = pack_bf16(
          dk_acc[n][2 * hr] * m.scale, dk_acc[n][2 * hr + 1] * m.scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dv_acc[n][2 * hr], dv_acc[n][2 * hr + 1]);
    }
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
cudaError_t launch_dq_mma(const Args& a, void* dq, cudaStream_t st) {
  using C = MmaTile<DH>;
  auto kern = flash_bwd_dq_mma_kernel<DH>;
  constexpr size_t smem =
      size_t(2 * C::ROW_ELEMS + C::T_ELEMS) * 2 + size_t(C::INTS) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kMmaTile - 1) / kMmaTile, a.H, a.B);
  kern<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.dvec, a.qpos,
      a.kvpos, a.qseg, a.kvseg, static_cast<__nv_bfloat16*>(dq), a.S, a.T,
      a.H, a.K, a.m);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_mma(const Args& a, void* dk, void* dv,
                           cudaStream_t st) {
  using C = MmaTile<DH>;
  auto kern = flash_bwd_dkv_mma_kernel<DH>;
  constexpr size_t smem = size_t(4 * C::ROW_ELEMS + 2 * C::T_ELEMS) * 2 +
                          size_t(2 * kMmaTile + C::INTS) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kMmaTile - 1) / kMmaTile, a.K, a.B);
  kern<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.dvec, a.qpos,
      a.kvpos, a.qseg, a.kvseg, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.S, a.T, a.H, a.K, a.m);
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
// means no sliding window. bf16 with dh 64/128 takes the tensor-core
// bodies; they need q, k, v and dO 16-byte aligned (the wrapper checks).
// Each returns a cudaError_t.
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
      case 64: return int(launch_dq_mma<64>(a, dq, st));
      case 128: return int(launch_dq_mma<128>(a, dq, st));
      case 256: return int(launch_dq<__nv_bfloat16, 256>(a, dq, st));
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
      case 64: return int(launch_dkv_mma<64>(a, dk, dv, st));
      case 128: return int(launch_dkv_mma<128>(a, dk, dv, st));
      case 256: return int(launch_dkv<__nv_bfloat16, 256>(a, dk, dv, st));
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
