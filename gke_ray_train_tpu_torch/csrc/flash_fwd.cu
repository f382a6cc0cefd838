// Flash-attention forward for Hopper (sm_90a), behind a plain C interface.
//
// Replaces gke_ray_train_tpu/ops/flash_attention.py::_fwd_kernel (:175),
// the Pallas TPU kernel that `_fwd` (:228) launches. It computes the same
// function: GQA attention with an fp32 online softmax, the mask built from
// int32 positions and segment ids (segment 0 = padding, never attended),
// causality, an optional sliding window and a tanh logit softcap; whole
// tiles that no (q, kv) pair can attend are skipped (`_block_live`, :94).
// It writes `out` in the input dtype and `lse = m + log(l)` in fp32, with
// out = 0 and lse = NEG_INF for rows that attend nothing (:219-225).
//
// Layout: q [B, S, H, dh], k/v [B, T, K, dh], out [B, S, H, dh] (the JAX
// public layout, read in place: a head's rows are strided by H*dh), lse
// [B, H, S], positions/segments [B, S] and [B, T]. dh is 64, 128 or 256;
// the dtype is float32 or bfloat16.
//
// Design. The TPU grid's sequential fourth axis (kv blocks, with the
// running max/sum/accumulator carried in VMEM scratch) becomes a loop
// inside one CTA. The CTA reads kv head h / G directly, so K/V are never
// repeated in memory. Two bodies:
//
// - bf16, dh 64 / 128 / 256 (every shipped family): one CTA per (query
//   head, batch row, query tile of 64 NC rows), the query tiles with the
//   most live kv tiles under causality launched first. NC consumer
//   warpgroups own 64 query rows each (NC = 2 where 128-row CTAs make two
//   waves on the card, else 1; always 1 at dh 256, see launch_wgmma);
//   one producer warp keeps a ring of K/V tiles in flight by TMA (the
//   public layout's rows, 64-column blocks with the 128-byte swizzle; the
//   ragged tail zero-filled and masked as segment 0) with mbarrier
//   full/empty pairs, the tiles' positions and segments beside them by
//   cp.async. Before the roles split, every thread of the CTA classes
//   each kv tile from its min/max position and segment against the query
//   tile (hopper.cuh::classify_tiles): dead tiles (`_block_live`) never
//   enter the ring, interior tiles (every pair kept) skip the mask, only
//   boundary tiles build it. S = Q K^T is wgmma with both operands in
//   shared memory (K-major); the online softmax runs in registers in base
//   2 (the scale folded into one FMA, ex2.approx; the softcap an accurate
//   tanhf); P goes from registers as the A operand of O += P V, with V
//   read as an MN-major operand: no transposed copy.
// - float32: scalar fp32 FMAs, 256 threads, tiles staged in shared
//   memory as fp32 (K transposed), one CTA per 64 query rows. It is the
//   parity path; no bf16 call reaches it.
//
// Both round the probabilities to the value dtype before the P.V product,
// as `p.astype(v.dtype)` does in the TPU kernel, while the row sum uses
// the unrounded values.
//
// Bound. At the Llama-3.1-8B training shape (B=2, S=T=1024, H=32, K=8,
// dh=128, bf16, causal) the function does ~17.2 GFLOP over its live
// pairs and moves ~34 MB: bound by operations (~0.017 ms at 989 TFLOP/s).
// What holds this body back is the SFU: each score costs one ex2, and
// the two warpgroups' softmax phases do not overlap their own products
// (the FA3-style overlap of S of one tile with P V of the last needs
// more than the 168 registers ptxas allows a thread here; see PERF.md).
//
// The C entry point returns cudaGetLastError() after the launch; the
// Python wrapper raises when that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;  // ops/attention.py NEG_INF
constexpr int kBQ = 64;              // query rows per CTA
constexpr int kThreads = 256;        // a 16 x 16 thread grid
constexpr int kRows = kBQ / 16;      // query rows per thread

template <int DH>
struct Tile {
  static constexpr int BKV = DH <= 128 ? 64 : 32;  // kv rows per tile
  static constexpr int CPT = BKV / 16;             // score columns / thread
  static constexpr int DPT = DH / 16;              // output columns / thread
  static constexpr int QT_LD = kBQ + 1;            // padded leading dims
  static constexpr int KT_LD = BKV + 1;
  static constexpr int P_LD = BKV + 1;
  static constexpr int FLOATS =
      DH * QT_LD + DH * KT_LD + BKV * DH + kBQ * P_LD + 3 * kBQ;
  static constexpr int INTS = 2 * kBQ + 2 * BKV + 4 * (kThreads / 32);
  static constexpr size_t SMEM_BYTES = size_t(FLOATS + INTS) * 4;
};

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// x rounded to T and back: the value `p.astype(v.dtype)` multiplies V with.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Block-wide (min v[0], max v[1], min v[2], max v[3]) over all kWarps
// warps; every thread gets the result. `red` holds 4 ints per warp.
template <int kWarps>
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
  for (int w = 1; w < kWarps; ++w) {
    v[0] = min(v[0], red[w * 4 + 0]);
    v[1] = max(v[1], red[w * 4 + 1]);
    v[2] = min(v[2], red[w * 4 + 2]);
    v[3] = max(v[3], red[w * 4 + 3]);
  }
  __syncthreads();  // `red` may be written again after this
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kvpos, const int* __restrict__ qseg,
                 const int* __restrict__ kvseg, T* __restrict__ out,
                 float* __restrict__ lse, int S, int T_len, int H, int K,
                 int causal, int use_window, int window, float scale,
                 float softcap) {
  using C = Tile<DH>;
  constexpr int BKV = C::BKV;
  extern __shared__ float smem[];
  float* Qt = smem;                      // [DH][QT_LD] query tile, transposed
  float* Kt = Qt + DH * C::QT_LD;        // [DH][KT_LD] key tile, transposed
  float* Vs = Kt + DH * C::KT_LD;        // [BKV][DH]   value tile
  float* P = Vs + BKV * DH;              // [kBQ][P_LD] scores, then probs
  float* m_s = P + kBQ * C::P_LD;        // running max per row
  float* l_s = m_s + kBQ;                // running sum per row
  float* a_s = l_s + kBQ;                // this tile's rescale per row
  int* qpos_s = reinterpret_cast<int*>(a_s + kBQ);
  int* qseg_s = qpos_s + kBQ;
  int* kpos_s = qseg_s + kBQ;
  int* kseg_s = kpos_s + BKV;
  int* red = kseg_s + BKV;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int qrows = min(kBQ, S - q0);
  const size_t q_stride = size_t(H) * DH;    // between consecutive rows
  const size_t kv_stride = size_t(K) * DH;
  const T* qb = q + (size_t(b) * S * H + h) * DH;
  const T* kb = k + (size_t(b) * T_len * K + kh) * DH;
  const T* vb = v + (size_t(b) * T_len * K + kh) * DH;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    Qt[d * C::QT_LD + r] =
        r < qrows ? to_float(qb[size_t(q0 + r) * q_stride + d]) : 0.f;
  }
  if (tid < kBQ) {
    const bool ok = tid < qrows;
    qpos_s[tid] = ok ? qpos[size_t(b) * S + q0 + tid] : 0;
    qseg_s[tid] = ok ? qseg[size_t(b) * S + q0 + tid] : 0;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  int qmm[4];
  {
    const bool ok = tid < qrows;
    qmm[0] = ok ? qpos_s[tid] : INT_MAX;
    qmm[1] = ok ? qpos_s[tid] : INT_MIN;
    qmm[2] = ok ? qseg_s[tid] : INT_MAX;
    qmm[3] = ok ? qseg_s[tid] : INT_MIN;
  }
  block_minmax4<kThreads / 32>(qmm, red);

  float acc[kRows][C::DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) acc[i][j] = 0.f;

  const int n_kv = (T_len + BKV - 1) / BKV;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int t0 = jt * BKV;
    const int kvcols = min(BKV, T_len - t0);
    if (tid < BKV) {
      const bool ok = tid < kvcols;
      kpos_s[tid] = ok ? kvpos[size_t(b) * T_len + t0 + tid] : 0;
      // the ragged tail's missing columns read as padding (segment 0)
      kseg_s[tid] = ok ? kvseg[size_t(b) * T_len + t0 + tid] : 0;
    }
    __syncthreads();
    int kmm[4];
    {
      const bool ok = tid < kvcols;
      kmm[0] = ok ? kpos_s[tid] : INT_MAX;
      kmm[1] = ok ? kpos_s[tid] : INT_MIN;
      kmm[2] = ok ? kseg_s[tid] : INT_MAX;
      kmm[3] = ok ? kseg_s[tid] : INT_MIN;
    }
    block_minmax4<kThreads / 32>(kmm, red);
    // _block_live: causal future, window-expired past, disjoint segments
    bool live = !causal || qmm[1] >= kmm[0];
    if (use_window) live = live && kmm[1] > qmm[0] - window;
    live = live && qmm[2] <= kmm[3] && kmm[2] <= qmm[3];
    if (!live) continue;  // uniform across the CTA

    for (int i = tid; i < BKV * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const bool ok = r < kvcols;
      const size_t off = size_t(t0 + r) * kv_stride + d;
      Kt[d * C::KT_LD + r] = ok ? to_float(kb[off]) : 0.f;
      Vs[r * DH + d] = ok ? to_float(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*kRows.., columns tx*CPT..
    float s[kRows][C::CPT];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[kRows], bk[C::CPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = Qt[d * C::QT_LD + ty * kRows + i];
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) bk[j] = Kt[d * C::KT_LD + tx * C::CPT + j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) {
        const int c = tx * C::CPT + j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const int qp = qpos_s[r], kp = kpos_s[c];
        bool keep = qseg_s[r] == kseg_s[c] && kseg_s[c] != 0;
        if (causal) keep = keep && kp <= qp;
        if (use_window) keep = keep && kp > qp - window;
        // -inf: exp() of a masked score is exactly 0, while the running
        // max keeps the TPU kernel's NEG_INF floor
        P[r * C::P_LD + c] = keep ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, four threads to a row
    {
      const int r = tid >> 2, part = tid & 3;
      float mx = -INFINITY;
      for (int c = part; c < BKV; c += 4) mx = fmaxf(mx, P[r * C::P_LD + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BKV; c += 4) {
        const float p = expf(P[r * C::P_LD + c] - m_new);
        sum += p;
        P[r * C::P_LD + c] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_prev - m_new);
      __syncwarp();
      if (part == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; output columns tx + 16*j
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float al = a_s[ty * kRows + i];
#pragma unroll
      for (int j = 0; j < C::DPT; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = P[(ty * kRows + i) * C::P_LD + c];
#pragma unroll
      for (int j = 0; j < C::DPT; ++j) {
        const float vv = Vs[c * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= qrows) continue;
    const float l = l_s[r];
    T* orow = out + ((size_t(b) * S + q0 + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < C::DPT; ++j)
      orow[tx + 16 * j] = from_float<T>(l > 0.f ? acc[i][j] / l : 0.f);
    if (tx == 0)
      lse[(size_t(b) * H + h) * S + q0 + r] =
          l > 0.f ? m_s[r] + logf(l) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma, a TMA ring, warp specialisation (dh 64 / 128 / 256)
// ---------------------------------------------------------------------------

constexpr float kLn2 = 0.6931471805599453f;
// setmaxnreg: the producer warpgroup's registers a thread, and the
// consumers'. ptxas still allocates the consumers within the launch
// bound's 168 (65,536 / 384), so this only hands the pool over.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// NC consumer warpgroups of 64 query rows each and one producer
// warpgroup (one warp of it issues the loads). A kv tile of BKV rows
// moves through a ring of STAGES K/V buffers.
template <int DH, int NC>
struct Cfg {
  static constexpr int BQ = 64 * NC;
  static constexpr int BKV = DH == 256 ? 64 : 128;
  static constexpr int STAGES = DH == 64 ? 3 : 2;
  static constexpr int CB = DH / 64;            // 64-column blocks
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int Q_BYTES = CB * BQ * 128;
  static constexpr int KV_BYTES = CB * BKV * 128;  // K or V, one stage
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_POS = OFF_V + STAGES * KV_BYTES;
  // per stage: kv positions and segments [BKV] each, then (t0, interior)
  static constexpr int OFF_BAR = OFF_POS + STAGES * (2 * BKV + 2) * 4;
  // the class of every kv tile (hopper::kDead / kBoundary / kInterior)
  static constexpr int OFF_CLS = OFF_BAR + (1 + 2 * STAGES) * 8;
  static constexpr int BYTES = OFF_CLS + hopper::kMaxTiles + 1024;
};

struct FwdParams {
  const int *qpos, *kvpos, *qseg, *kvseg;
  __nv_bfloat16* out;
  float* lse;
  int S, T, H, K, causal, use_window, window, n_qt;
  float scale, softcap;
};

// Scores of one tile in place: the tanh softcap (CAP) and the mask
// (MASK: boundary tiles), and the row maxima of this thread's two rows.
template <bool CAP, bool MASK, int N>
__device__ __forceinline__ void fwd_scores(float (&s)[N], float (&mx)[2],
                                           const FwdParams& p,
                                           const int* kp, const int* ksg,
                                           const int (&qp)[2],
                                           const int (&qs)[2], int t) {
  const float cap_in = CAP ? p.scale / p.softcap : 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      float x = s[4 * j + e];
      if constexpr (CAP) x = tanhf(x * cap_in) * p.softcap;
      if constexpr (MASK) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int kpv = kp[c], ksv = ksg[c];
        bool keep = qs[hr] == ksv && ksv != 0;
        if (p.causal) keep = keep && kpv <= qp[hr];
        if (p.use_window) keep = keep && kpv > qp[hr] - p.window;
        // -inf: 2^x of a masked score is exactly 0, while the running
        // max keeps the TPU kernel's NEG_INF floor
        x = keep ? x : -INFINITY;
      }
      s[4 * j + e] = x;
      mx[hr] = fmaxf(mx[hr], x);
    }
  }
}

// A consumer warpgroup: 64 query rows, S = Q K^T and O += P V by wgmma,
// the online softmax in registers between them.
template <int DH, int NC>
__device__ __forceinline__ void fwd_consumer(const FwdParams& p, int h,
                                             int b, int q0, int wg,
                                             unsigned char* sm) {
  using C = Cfg<DH, NC>;
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

  // this thread's rows r0 and r0 + 8; rows past S read as padding
  const int r0 = q0 + 64 * wg + 16 * warp + g;
  int qp[2], qs[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    const bool ok = r < p.S;
    qp[hr] = ok ? p.qpos[size_t(b) * p.S + r] : 0;
    qs[hr] = ok ? p.qseg[size_t(b) * p.S + r] : 0;
  }
  const bool capped = p.softcap > 0.f;
  // exponents in base 2: exp(x - m) = 2^(x log2e - m log2e), the scale
  // folded into the same multiplier when there is no softcap
  const float mul = capped ? kLog2e : p.scale * kLog2e;
  float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;

  const unsigned char* q_wg = sm + wg * 64 * 128;
  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(&full[stage], phase);
    const int t0 = info_s[2 * stage];
    if (t0 == hopper::kEndTile) break;
    const bool interior = info_s[2 * stage + 1] != 0;
    const unsigned char* ks_ = sm + C::OFF_K + stage * C::KV_BYTES;
    const unsigned char* vs_ = sm + C::OFF_V + stage * C::KV_BYTES;
    float s[BKV / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int cb = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(s, desc_sw128(q_wg + cb * C::BQ * 128 + off, 16, 1024),
               desc_sw128(ks_ + cb * BKV * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    const int* kp = kpos_s + stage * BKV;
    const int* ksg = kseg_s + stage * BKV;
    float mx[2] = {-INFINITY, -INFINITY};
    if (capped) {
      if (interior) fwd_scores<true, false>(s, mx, p, kp, ksg, qp, qs, t);
      else fwd_scores<true, true>(s, mx, p, kp, ksg, qp, qs, t);
    } else {
      if (interior) fwd_scores<false, false>(s, mx, p, kp, ksg, qp, qs, t);
      else fwd_scores<false, true>(s, mx, p, kp, ksg, qp, qs, t);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m2[hr], mx[hr] * mul);
      alpha[hr] = fast_exp2(m2[hr] - m_new);
      m2[hr] = m_new;
    }
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] = fast_exp2(fmaf(s[4 * j + e], mul, -m2[e >> 1]));
        sum[e >> 1] += pr[e];
      }
      pf[j / 2][(j & 1) * 2 + 0] = pack_bf16(pr[0], pr[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(pr[2], pr[3]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      l[hr] = l[hr] * alpha[hr] + sum[hr];
    }
    // O rescaled only where a row max of the warp moved
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs(o, pf[kk], desc_sw128(vs_ + kk * 16 * 128, BKV * 128, 1024),
               1);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= p.S) continue;
    const float lr = l[hr];
    __nv_bfloat16* orow =
        p.out + ((size_t(b) * p.S + r) * p.H + h) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float a0 = lr > 0.f ? o[4 * j + 2 * hr] / lr : 0.f;
      const float a1 = lr > 0.f ? o[4 * j + 2 * hr + 1] / lr : 0.f;
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(a0, a1);
    }
    if (t == 0)
      p.lse[(size_t(b) * p.H + h) * p.S + r] =
          lr > 0.f ? (m2[hr] + log2f(lr)) * kLn2 : kNegInf;
  }
}

// One CTA per (query head, batch row, query tile of 64 NC rows), the
// query tiles with the most live kv tiles under causality first.
template <int DH, int NC>
__global__ void __launch_bounds__(Cfg<DH, NC>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const FwdParams p) {
  using C = Cfg<DH, NC>;
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
      hopper::mbar_init(&bars[1 + C::STAGES + s], 4 * NC);  // empty
    }
    hopper::fence_barrier_init();
    // Q now, so that it loads while the kv tiles are classed
    hopper::mbar_arrive_tx(&bars[0], C::Q_BYTES);
#pragma unroll
    for (int cb = 0; cb < C::CB; ++cb)
      hopper::tma_load_4d(sm + cb * C::BQ * 128, &tq, &bars[0], cb * 64, h,
                          q0, b);
  }
  // the class of every kv tile against this query tile, all threads
  // (ends with a CTA barrier, which also publishes the mbarriers)
  hopper::classify_tiles(p.qpos + size_t(b) * p.S, p.qseg + size_t(b) * p.S,
                         q0, min(C::BQ, p.S - q0), true,
                         p.kvpos + size_t(b) * p.T,
                         p.kvseg + size_t(b) * p.T, p.T, C::BKV,
                         (p.T + C::BKV - 1) / C::BKV, true, p.causal,
                         p.use_window, p.window, sm + C::OFF_CLS);
  const int wg = hopper::warpgroup_index();
  if (wg == NC) {
    if constexpr (NC == 2) hopper::reg_dealloc<kProducerRegs>();
    // Q is on its way since the kernel's start
    if (threadIdx.x / 32 == 4 * NC)
      hopper::kv_ring_producer<C>(&tk, &tv, p.kvpos + size_t(b) * p.T,
                                  p.kvseg + size_t(b) * p.T, p.T,
                                  h / (p.H / p.K), b, sm);
  } else {
    if constexpr (NC == 2) hopper::reg_alloc<kConsumerRegs>();
    fwd_consumer<DH, NC>(p, h, b, q0, wg, sm);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int *qpos, *kvpos, *qseg, *kvseg;
  void* out;
  float* lse;
  int B, S, T, H, K, causal, use_window, window;
  float scale, softcap;
};

template <typename T, typename Kernel>
cudaError_t launch(Kernel kern, int threads, size_t smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.qpos, a.kvpos, a.qseg, a.kvseg,
      static_cast<T*>(a.out), a.lse, a.S, a.T, a.H, a.K, a.causal,
      a.use_window, a.window, a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_scalar(const Args& a, cudaStream_t stream) {
  return launch<T>(flash_fwd_kernel<T, DH>, kThreads, Tile<DH>::SMEM_BYTES,
                   a, stream);
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

template <int DH, int NC>
cudaError_t launch_wgmma_nc(const Args& a, cudaStream_t stream) {
  using C = Cfg<DH, NC>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = hopper::head_rows_map(&tq, a.q, a.B, a.S, a.H, DH, C::BQ)) !=
          cudaSuccess ||
      (err = hopper::head_rows_map(&tk, a.k, a.B, a.T, a.K, DH, C::BKV)) !=
          cudaSuccess ||
      (err = hopper::head_rows_map(&tv, a.v, a.B, a.T, a.K, DH, C::BKV)) !=
          cudaSuccess)
    return err;
  if ((a.T + C::BKV - 1) / C::BKV > hopper::kMaxTiles)
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<DH, NC>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::BYTES);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.S + C::BQ - 1) / C::BQ;
  const FwdParams p{a.qpos, a.kvpos, a.qseg, a.kvseg,
                    static_cast<__nv_bfloat16*>(a.out), a.lse, a.S, a.T, a.H,
                    a.K, a.causal, a.use_window, a.window, n_qt, a.scale,
                    a.softcap};
  kern<<<dim3(a.H, a.B, n_qt), C::THREADS, C::BYTES, stream>>>(tq, tk, tv,
                                                               p);
  return cudaGetLastError();
}

// 128-row CTAs where they make two waves on the card, 64-row ones below
// (the short serving prefills)
// dh 64 / 128: 128-row CTAs where they make two waves on the card,
// 64-row ones below (the short serving prefills). dh 256: 64-row CTAs
// always; two warpgroups' 64 x 256 accumulators spill out of the 168
// registers ptxas gives a thread of a three-warpgroup CTA (it does not
// raise that for the consumers' setmaxnreg), and the spills cost more
// than the second warpgroup gains.
template <int DH>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  if constexpr (DH == 256) {
    return launch_wgmma_nc<DH, 1>(a, stream);
  } else {
    const long ctas128 = long((a.S + 127) / 128) * a.H * a.B;
    return ctas128 >= 2L * sm_count() ? launch_wgmma_nc<DH, 2>(a, stream)
                                      : launch_wgmma_nc<DH, 1>(a, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means none; use_window = 0
// means no sliding window. bf16 takes the wgmma body at every head dim;
// it needs q, k, v and out 16-byte aligned (the wrapper checks). Returns a
// cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kvpos,
                         const void* qseg, const void* kvseg, void* out,
                         void* lse, int B, int S, int T_len, int H, int K,
                         int dh, int dtype, int causal, int use_window,
                         int window, float scale, float softcap,
                         void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || K < 1 || H % K != 0)
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v,
               static_cast<const int*>(qpos), static_cast<const int*>(kvpos),
               static_cast<const int*>(qseg), static_cast<const int*>(kvseg),
               out, static_cast<float*>(lse),
               B, S, T_len, H, K, causal, use_window, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (dh) {
      case 64: return int(launch_wgmma<64>(a, st));
      case 128: return int(launch_wgmma<128>(a, st));
      case 256: return int(launch_wgmma<256>(a, st));
    }
  } else if (dtype == 0) {
    switch (dh) {
      case 64: return int(launch_scalar<float, 64>(a, st));
      case 128: return int(launch_scalar<float, 128>(a, st));
      case 256: return int(launch_scalar<float, 256>(a, st));
    }
  }
  return int(cudaErrorInvalidValue);
}
