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
// inside one CTA: one CTA per (query tile of 64 rows, query head, batch
// row). The CTA reads kv head h / G directly, so K/V are never repeated in
// memory. Two bodies share that structure:
//
// - bf16 with dh 64 or 128 (every serving shape of the shipped Llama /
//   Mistral / Qwen families): tensor cores through `mma.sync` m16n8k16
//   (bf16 in, fp32 accumulate), four warps of 16 query rows each. Q stays
//   in registers for the whole kv loop; each kv tile of 64 rows is staged
//   in shared memory as bf16 (K row-major, V transposed, padded against
//   bank conflicts). The score accumulators are laid out exactly as the
//   A operand of the P.V product wants them, so probabilities go from
//   registers to the second product without touching shared memory; the
//   online max/sum reduce over the four lanes that share a row.
// - float32, and bf16 at dh 256 (Gemma-2): scalar fp32 FMAs, 256 threads,
//   tiles staged in shared memory as fp32 (K transposed), a register
//   micro-tile of scores per thread, four threads to a row for the
//   softmax, the 64 x dh accumulator in registers.
//
// Both round the probabilities to the value dtype before the P.V product,
// as `p.astype(v.dtype)` does in the TPU kernel, while the row sum uses
// the unrounded values. Tiles that the `_block_live` predicate (from each
// tile's min/max position and segment id) proves dead are skipped before
// their K/V are loaded; the ragged last tile masks its missing columns as
// segment 0.
//
// Bound. At the serving shapes (B=1, S=T=512, H=32, K=8, dh=128, bf16,
// causal) the function moves ~10.5 MB and does ~2.15 GFLOP: memory-bound
// on an H100 (3.35 TB/s, 989 TFLOP/s bf16), a bound of ~3.1 us. What
// bounds this version is latency, not either roofline: at 512 tokens
// there are only 8 x 32 = 256 CTAs of four warps, `mma.sync` reaches a
// fraction of the wgmma rate, and K/V loads are not overlapped with the
// products. wgmma, TMA with a multi-stage ring and warp specialisation
// are the later work.
//
// The C entry point returns cudaGetLastError() after the launch; the
// Python wrapper raises when that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

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
// bf16 tensor-core body (dh 64 / 128)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;                  // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBKV = 64;                   // kv rows per tile

template <int DH>
struct MmaTile {
  static constexpr int LDK = DH + 8;          // bf16 per K row in smem
  static constexpr int LDV = kMmaBKV + 8;     // bf16 per V^T row in smem
  static constexpr int INTS = 2 * kBQ + 2 * kMmaBKV + 4 * kMmaWarps;
  static constexpr size_t SMEM_BYTES =
      size_t(kMmaBKV) * LDK * 2 + size_t(DH) * LDV * 2 + size_t(INTS) * 4;
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

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kvpos,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kvseg,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int S, int T_len, int H, int K,
                     int causal, int use_window, int window, float scale,
                     float softcap) {
  using C = MmaTile<DH>;
  constexpr int BKV = kMmaBKV;
  constexpr int KSTEPS = DH / 16;   // k16 steps of Q.K^T over the head dim
  constexpr int NT_S = BKV / 8;     // n8 score tiles per kv tile
  constexpr int NT_O = DH / 8;      // n8 output tiles
  constexpr int VEC = 8;            // bf16 per 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BKV][LDK]
  __nv_bfloat16* Vt = Ks + BKV * C::LDK;                            // [DH][LDV]
  int* qpos_s = reinterpret_cast<int*>(Vt + DH * C::LDV);
  int* qseg_s = qpos_s + kBQ;
  int* kpos_s = qseg_s + kBQ;
  int* kseg_s = kpos_s + BKV;
  int* red = kseg_s + BKV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int qrows = min(kBQ, S - q0);
  const size_t q_stride = size_t(H) * DH;
  const size_t kv_stride = size_t(K) * DH;
  const __nv_bfloat16* qb = q + (size_t(b) * S * H + h) * DH;
  const __nv_bfloat16* kb = k + (size_t(b) * T_len * K + kh) * DH;
  const __nv_bfloat16* vb = v + (size_t(b) * T_len * K + kh) * DH;

  if (tid < kBQ) {
    const bool ok = tid < qrows;
    qpos_s[tid] = ok ? qpos[size_t(b) * S + q0 + tid] : 0;
    qseg_s[tid] = ok ? qseg[size_t(b) * S + q0 + tid] : 0;
  }
  // this thread's two query rows of its warp's 16, and their Q fragments
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < qrows, ok1 = r1 < qrows;
  const __nv_bfloat16* q_r0 = qb + size_t(q0 + r0) * q_stride + 2 * t;
  const __nv_bfloat16* q_r1 = qb + size_t(q0 + r1) * q_stride + 2 * t;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qf[kk][0] = ok0 ? ld32(q_r0 + kk * 16) : 0u;
    qf[kk][1] = ok1 ? ld32(q_r1 + kk * 16) : 0u;
    qf[kk][2] = ok0 ? ld32(q_r0 + kk * 16 + 8) : 0u;
    qf[kk][3] = ok1 ? ld32(q_r1 + kk * 16 + 8) : 0u;
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
  block_minmax4<kMmaWarps>(qmm, red);
  const int qp[2] = {qpos_s[r0], qpos_s[r1]};
  const int qs[2] = {qseg_s[r0], qseg_s[r1]};

  // running max / sum of rows r0, r1 (the four lanes of a row agree)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

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
    {
      const bool ok = tid < kvcols;
      kmm[0] = ok ? kpos_s[tid] : INT_MAX;
      kmm[1] = ok ? kpos_s[tid] : INT_MIN;
      kmm[2] = ok ? kseg_s[tid] : INT_MAX;
      kmm[3] = ok ? kseg_s[tid] : INT_MIN;
    }
    block_minmax4<kMmaWarps>(kmm, red);
    bool live = !causal || qmm[1] >= kmm[0];
    if (use_window) live = live && kmm[1] > qmm[0] - window;
    live = live && qmm[2] <= kmm[3] && kmm[2] <= qmm[3];
    if (!live) continue;  // uniform across the CTA

    // stage K (row-major) and V (transposed), 16 bytes per load
    for (int i = tid; i < BKV * DH / VEC; i += kMmaThreads) {
      const int r = i / (DH / VEC), c = (i % (DH / VEC)) * VEC;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (r < kvcols) {
        const size_t off = size_t(t0 + r) * kv_stride + c;
        kv4 = *reinterpret_cast<const uint4*>(kb + off);
        vv4 = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * C::LDK + c) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vt[(c + e) * C::LDV + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float sc[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (j * 8 + g) * C::LDK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_bf16(sc[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }
    // scale, softcap, mask; the row max over the four lanes of a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;                 // 0: row r0, 1: row r1
        const int c = j * 8 + 2 * t + (e & 1);
        float x = sc[j][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const int kp = kpos_s[c], ks = kseg_s[c];
        bool keep = qs[hr] == ks && ks != 0;
        if (causal) keep = keep && kp <= qp[hr];
        if (use_window) keep = keep && kp > qp[hr] - window;
        // -inf: exp() of a masked score is exactly 0, while the running
        // max keeps the TPU kernel's NEG_INF floor
        x = keep ? x : -INFINITY;
        sc[j][e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
    // probabilities: summed unrounded, rounded to bf16 into the A operand
    // of P.V (score tiles 2ks and 2ks+1 form k-step ks)
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(sc[j][e] - m[e >> 1]);
        sum[e >> 1] += p[e];
      }
      pf[j / 2][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      l[hr] = l[hr] * alpha[hr] + sum[hr];
    }
    // O = O * alpha + P V
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
      const __nv_bfloat16* vrow = Vt + (n * 8 + g) * C::LDV + 2 * t;
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks)
        mma_bf16(o[n], pf[ks], ld32(vrow + ks * 16), ld32(vrow + ks * 16 + 8));
    }
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = hr ? r1 : r0;
    if (r >= qrows) continue;
    const float lr = l[hr];
    __nv_bfloat16* orow = out + ((size_t(b) * S + q0 + r) * H + h) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const float a0 = lr > 0.f ? o[n][2 * hr] / lr : 0.f;
      const float a1 = lr > 0.f ? o[n][2 * hr + 1] / lr : 0.f;
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(a0, a1);
    }
    if (t == 0)
      lse[(size_t(b) * H + h) * S + q0 + r] =
          lr > 0.f ? m[hr] + logf(lr) : kNegInf;
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

template <int DH>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  return launch<__nv_bfloat16>(flash_fwd_mma_kernel<DH>, kMmaThreads,
                               MmaTile<DH>::SMEM_BYTES, a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means none; use_window = 0
// means no sliding window. bf16 with dh 64/128 takes the tensor-core body;
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
      case 64: return int(launch_mma<64>(a, st));
      case 128: return int(launch_mma<128>(a, st));
      case 256: return int(launch_scalar<__nv_bfloat16, 256>(a, st));
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
