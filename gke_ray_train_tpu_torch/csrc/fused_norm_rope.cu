// Fused RMSNorm, one-launch q/k RoPE and per-head RMSNorm + RoPE for Hopper
// (sm_90a), behind a plain C interface.
//
// Three kernels, the counterparts of the Pallas TPU kernels of
// gke_ray_train_tpu/ops/fused_norm_rope.py (plan knob FUSED_OPS and the
// kernel registry):
//
// - rmsnorm_reg_kernel and rmsnorm_kernel (two bodies of one function,
//   below) replace `_rmsnorm_kernel` (:96, launched by
//   `fused_rmsnorm` :129): y = x * rsqrt(mean(x^2) + eps) * s over the last
//   axis, in fp32, with s = scale or 1 + scale (Gemma), cast to x's dtype;
// - rope_qk_kernel replaces `_rope_qk_kernel` (:103, launched by
//   `fused_rope_qk` :189): q [B, S, H, dh] and k [B, S, K, dh] rotated in
//   one launch, split halves (x1 cos - x2 sin, x2 cos + x1 sin) with the
//   angles position * inv_freq in fp32. The backward launches the same
//   kernel with -inv_freq (a rotation's transpose is the inverse rotation);
// - rmsnorm_rope_kernel replaces `_rmsnorm_rope_kernel` (:112, launched by
//   `fused_rmsnorm_rope` :256): for x [B, S, H, dh], per head-row the
//   rms_norm over dh, then the split-half rotation of the unrounded fp32
//   result, cast to x's dtype once, at the store.
//
// All follow the fp32 op order of the JAX `_norm_block` (:74-81) and
// `_rot_block` (:84-93). The products and sums of the norm's scaling and
// of the rotation use the _rn intrinsics, so the compiler contracts none
// of them into an FMA and each rounds where the plain PyTorch version's
// separate kernels round. cos and sin come from the full-range `sincosf`:
// positions reach thousands, and the fast `__sinf` / `__cosf` lose all
// accuracy at angles of thousands of radians.
//
// Bound. All are elementwise passes with a handful of FLOPs per byte, far
// below the H100's ~295 FLOP/byte ridge: they are bound by device memory.
// At Gemma-2-9B's training shape (4,096 rows of D = 3,584 in bf16) the
// norm reads and writes 29.4 MB each way (~17.5 us at 3.35 TB/s); the
// rotation of 16 + 8 heads of 256 reads and writes 50.3 MB each way
// (~30 us); the per-head norm + rotation of a [1, 4,096, 16, 256] bf16 q
// reads and writes 33.5 MB each way (~20 us).
//
// Design. rms_norm has two bodies, chosen by the caller's route code
// (ops/fused_norm_rope.py::norm_route); the C entry refuses a route the
// shape does not fit.
// - "registers" (route 1) for the shipped widths D 3,584 (Gemma-2-9B,
//   Qwen-2-7B), 4,096 (Llama, Mistral, Mixtral), 5,120 (Llama-2-13B) and
//   8,192 (70B), with x, y and scale 16-byte aligned: the row lives in
//   registers. A group of WPR warps (set by D at compile time: 1 at 3,584
//   and 4,096 in bf16, 2 or 4 elsewhere) holds one row, VPL 16-byte
//   vectors a lane (at most 16; 14 at Gemma's width in bf16). Every load
//   of the row is issued before the first square is summed, so they are
//   all in flight together, and x is read from device memory once. Warp
//   shuffles reduce the squares (no shared memory at WPR 1; at WPR > 1
//   one float a warp and one __syncthreads()), then the same registers
//   are scaled and stored. The scale comes by 16-byte vectors (8 bytes
//   for a bf16 scale under fp32 x) from L1 / L2; scale_plus_one is a
//   template form. Four warps a CTA, so 4 / WPR rows; at most 128
//   registers a thread.
// - "two_pass" (route 0) for every other shape (D not a multiple of the
//   vector, a width with no template, operands not 16-byte aligned): one
//   CTA of 128 threads per row. Each thread reads 16-byte vectors of the
//   row (8 bf16 or 4 fp32) where the row's start is 16-byte aligned and D
//   a multiple of the vector, with a scalar tail for what is left, and
//   sums its squares in fp32; a warp-shuffle reduce and a shared-memory
//   reduce across the four warps give the row's sum. The second pass
//   reads the row again (from L1 / L2), scales it and writes it.
// Both sum squares with fmaf and scale with the same _rn products; only
// the order of the sum differs, so var may move in its last bit.
// rope: one CTA per (batch row, tile of 8 sequence rows). The CTA first
// computes cos and sin of the tile's angles once into shared memory, then
// rotates every head of q and of k of those rows with 16-byte vectors of
// each half where the halves allow.
// rmsnorm_rope: the rope kernel's CTA and cos / sin table, and a group of
// L lanes of one warp per head-row (L the power of two that covers the
// row's vectors, up to 32: 8 lanes for dh 128 in bf16, so a warp holds 4
// head-rows at once). The lane that holds x[j] also holds x[j + dh/2],
// the element the rotation pairs it with, so the head-row stays in
// registers between the sum of squares (a shuffle reduce inside the lane
// group, no shared-memory round trip) and the store; dh <= 256 is at
// most 8 pairs a lane. 16-byte vectors where dh/2 and the pointers
// allow, scalar accesses otherwise.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrappers raise when that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kNormThreads = 128;
constexpr int kRopeThreads = 256;
constexpr int kRopeRows = 8;  // sequence rows per rope CTA

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

// N values of T moved as one 16-byte access (N = 1: a scalar access).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, N>& v) {
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// rms_norm
// ---------------------------------------------------------------------------

// Sum of v over the CTA, returned to every thread; `red` holds one float
// per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (lane < int(blockDim.x / 32)) t = red[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// One CTA per row. VEC values per vector access over the first
// D / VEC * VEC columns, scalar accesses over the rest.
template <typename T, typename TS, int VEC>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ y, int D, float eps, int scale_plus_one) {
  __shared__ float red[kNormThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const int nvec = D / VEC;
  const int tail = nvec * VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const Vec<T, VEC> v = load_vec<T, VEC>(xr + i * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_float(v.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
  for (int c = tail + threadIdx.x; c < D; c += blockDim.x) {
    const float f = to_float(xr[c]);
    ss = fmaf(f, f, ss);
  }
  const float var = block_sum(ss, red) / float(D);
  const float r = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const Vec<T, VEC> v = load_vec<T, VEC>(xr + i * VEC);
    Vec<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float s = to_float(scale[i * VEC + e]);
      if (scale_plus_one) s = __fadd_rn(1.f, s);
      o.v[e] = from_float<T>(__fmul_rn(__fmul_rn(to_float(v.v[e]), r), s));
    }
    store_vec<T, VEC>(yr + i * VEC, o);
  }
  for (int c = tail + threadIdx.x; c < D; c += blockDim.x) {
    float s = to_float(scale[c]);
    if (scale_plus_one) s = __fadd_rn(1.f, s);
    yr[c] = from_float<T>(__fmul_rn(__fmul_rn(to_float(xr[c]), r), s));
  }
}

template <typename T, typename TS>
cudaError_t launch_rmsnorm(const void* x, const void* scale, void* y,
                           int rows, int D, float eps, int sp1,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = D % kVec == 0 && aligned16(x) && aligned16(y);
  const dim3 grid(rows), block(kNormThreads);
  if (vec) {
    rmsnorm_kernel<T, TS, kVec><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const TS*>(scale),
        static_cast<T*>(y), D, eps, sp1);
  } else {
    rmsnorm_kernel<T, TS, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const TS*>(scale),
        static_cast<T*>(y), D, eps, sp1);
  }
  return cudaGetLastError();
}

// The route codes of the fused_rmsnorm entry (ops/fused_norm_rope.py's
// NORM_ROUTES).
constexpr int kRouteTwoPass = 0;
constexpr int kRouteRegisters = 1;
constexpr int kRegThreads = 128;  // four warps a CTA

// The row-in-registers layout of width D in T: warps a row (the fewest of
// 1, 2, 4 that leave at most 16 vectors a lane) and vectors a lane.
template <typename T, int D>
struct RegRow {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kVecs = D / kVec;
  static constexpr int kWarps =
      kVecs % 32 == 0 && kVecs / 32 <= 16   ? 1
      : kVecs % 64 == 0 && kVecs / 64 <= 16 ? 2
                                            : 4;
  static constexpr int kPerLane = kVecs / (32 * kWarps);
  static constexpr int kRows = kRegThreads / 32 / kWarps;  // rows a CTA
  static_assert(D % kVec == 0 && kVecs % (32 * kWarps) == 0 &&
                    kPerLane <= 16,
                "no row-in-registers layout for this width");
};

// N scale values from p, widened to fp32, by 16-byte accesses (one 8-byte
// access where N values of TS are 8 bytes: a bf16 scale under fp32 x).
template <typename TS, int N>
__device__ __forceinline__ void load_scale(const TS* __restrict__ p,
                                           float (&s)[N]) {
  constexpr int kPer = 16 / sizeof(TS);
  if constexpr (N >= kPer) {
#pragma unroll
    for (int c = 0; c < N / kPer; ++c) {
      const Vec<TS, kPer> v = load_vec<TS, kPer>(p + c * kPer);
#pragma unroll
      for (int e = 0; e < kPer; ++e) s[c * kPer + e] = to_float(v.v[e]);
    }
  } else {
    const Vec<TS, N> v = load_vec<TS, N>(p);
#pragma unroll
    for (int e = 0; e < N; ++e) s[e] = to_float(v.v[e]);
  }
}

// Hide v's words from the compiler between the two uses of the row: it
// then keeps the row as loaded (4 registers a 16-byte vector) and widens
// it again for the scaling, instead of keeping the fp32 values of the sum
// of squares live (8 registers a bf16 vector; 234 a thread at D 4,096).
template <typename T, int N>
__device__ __forceinline__ void opaque(Vec<T, N>& v) {
  static_assert(sizeof(v) % 4 == 0, "a vector of 32-bit words");
  uint32_t w[sizeof(v) / 4];
  memcpy(w, &v, sizeof(v));
#pragma unroll
  for (int i = 0; i < int(sizeof(v) / 4); ++i) asm volatile("" : "+r"(w[i]));
  memcpy(&v, w, sizeof(v));
}

// One group of WPR warps per row: lane `lane` of warp `sub` of the group
// holds the row's vectors (k * WPR + sub) * 32 + lane, k < VPL, so each
// load instruction of a warp reads 512 contiguous bytes. The row is loaded
// whole, reduced, then scaled from the same registers and stored.
// At most 128 registers a thread (four CTAs an SM): without the cap ptxas
// spilled 8 bytes in two of the 32 forms at 56-72 registers.
template <typename T, typename TS, int D, bool SP1>
__global__ void __launch_bounds__(kRegThreads, 4)
rmsnorm_reg_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                   T* __restrict__ y, int rows, float eps) {
  using L = RegRow<T, D>;
  constexpr int VEC = L::kVec, WPR = L::kWarps, VPL = L::kPerLane;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = warp % WPR;
  const int64_t row = int64_t(blockIdx.x) * L::kRows + warp / WPR;
  const bool live = row < rows;  // uniform over the row's warps
  const T* xr = x + row * D;

  Vec<T, VEC> v[VPL];
  float ss = 0.f;
  if (live) {
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      v[k] = load_vec<T, VEC>(xr + ((k * WPR + sub) * 32 + lane) * VEC);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_float(v[k].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  // a butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (WPR > 1) {
    __shared__ float red[kRegThreads / 32];
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    const int first = warp - sub;  // every warp of a row sums in one order
    ss = red[first];
#pragma unroll
    for (int w = 1; w < WPR; ++w) ss += red[first + w];
  }
  if (!live) return;
  // explicit roundings: with D a compile-time power of two the compiler
  // could otherwise turn the division into a product and fuse it with the
  // add, which the two-pass body (D at run time) never does
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, float(D)), eps));

  T* yr = y + row * D;
#pragma unroll
  for (int k = 0; k < VPL; ++k) opaque(v[k]);
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = ((k * WPR + sub) * 32 + lane) * VEC;
    float s[VEC];
    load_scale<TS, VEC>(scale + c, s);
    Vec<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float se = SP1 ? __fadd_rn(1.f, s[e]) : s[e];
      const float xe = to_float(v[k].v[e]);
      o.v[e] = from_float<T>(__fmul_rn(__fmul_rn(xe, r), se));
    }
    store_vec<T, VEC>(yr + c, o);
  }
}

template <typename T, typename TS, int D>
cudaError_t launch_rmsnorm_reg(const void* x, const void* scale, void* y,
                               int rows, float eps, int sp1,
                               cudaStream_t stream) {
  constexpr int kRows = RegRow<T, D>::kRows;
  const dim3 grid((rows + kRows - 1) / kRows), block(kRegThreads);
  auto kern = sp1 ? rmsnorm_reg_kernel<T, TS, D, true>
                  : rmsnorm_reg_kernel<T, TS, D, false>;
  kern<<<grid, block, 0, stream>>>(static_cast<const T*>(x),
                                   static_cast<const TS*>(scale),
                                   static_cast<T*>(y), rows, eps);
  return cudaGetLastError();
}

// The body `route` names, or cudaErrorInvalidValue where the shape does not
// fit it (registers: a templated width, every operand 16-byte aligned).
template <typename T, typename TS>
cudaError_t launch_rmsnorm_route(const void* x, const void* scale, void* y,
                                 int rows, int D, float eps, int sp1,
                                 int route, cudaStream_t stream) {
  if (route == kRouteTwoPass)
    return launch_rmsnorm<T, TS>(x, scale, y, rows, D, eps, sp1, stream);
  if (route != kRouteRegisters || !aligned16(x) || !aligned16(y) ||
      !aligned16(scale))
    return cudaErrorInvalidValue;
  switch (D) {
    case 3584:
      return launch_rmsnorm_reg<T, TS, 3584>(x, scale, y, rows, eps, sp1,
                                             stream);
    case 4096:
      return launch_rmsnorm_reg<T, TS, 4096>(x, scale, y, rows, eps, sp1,
                                             stream);
    case 5120:
      return launch_rmsnorm_reg<T, TS, 5120>(x, scale, y, rows, eps, sp1,
                                             stream);
    case 8192:
      return launch_rmsnorm_reg<T, TS, 8192>(x, scale, y, rows, eps, sp1,
                                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// rope on q and k
// ---------------------------------------------------------------------------

// One CTA per (tile of kRopeRows sequence rows, batch row). Shared memory:
// cos then sin, [kRopeRows][half] fp32 each.
template <typename T, int VEC>
__global__ void __launch_bounds__(kRopeThreads)
rope_qk_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const int* __restrict__ pos, const float* __restrict__ freqs,
               T* __restrict__ oq, T* __restrict__ ok, int S, int H, int K,
               int dh) {
  extern __shared__ float cs[];
  const int half = dh / 2;
  float* cos_t = cs;
  float* sin_t = cs + kRopeRows * half;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kRopeRows;
  const int rows = min(kRopeRows, S - s0);

  for (int i = threadIdx.x; i < rows * half; i += blockDim.x) {
    const int r = i / half, j = i % half;
    const float a = __fmul_rn(float(pos[int64_t(b) * S + s0 + r]), freqs[j]);
    float sn, c;
    sincosf(a, &sn, &c);
    cos_t[i] = c;
    sin_t[i] = sn;
  }
  __syncthreads();

  const int hv = half / VEC;  // vectors per half of one head
  const int per_row = (H + K) * hv;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int rem = i % per_row;
    const int head = rem / hv;
    const int j0 = (rem % hv) * VEC;
    const int64_t srow = int64_t(b) * S + s0 + r;
    const T* src;
    T* dst;
    if (head < H) {
      src = q + (srow * H + head) * dh;
      dst = oq + (srow * H + head) * dh;
    } else {
      src = k + (srow * K + (head - H)) * dh;
      dst = ok + (srow * K + (head - H)) * dh;
    }
    const Vec<T, VEC> a1 = load_vec<T, VEC>(src + j0);
    const Vec<T, VEC> a2 = load_vec<T, VEC>(src + half + j0);
    Vec<T, VEC> o1, o2;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float c = cos_t[r * half + j0 + e];
      const float sn = sin_t[r * half + j0 + e];
      const float x1 = to_float(a1.v[e]), x2 = to_float(a2.v[e]);
      o1.v[e] = from_float<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
      o2.v[e] = from_float<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn)));
    }
    store_vec<T, VEC>(dst + j0, o1);
    store_vec<T, VEC>(dst + half + j0, o2);
  }
}

template <typename T>
cudaError_t launch_rope(const void* q, const void* k, const int* pos,
                        const float* freqs, void* oq, void* ok, int B, int S,
                        int H, int K, int dh, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int half = dh / 2;
  const bool vec = half % kVec == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(oq) && aligned16(ok);
  const size_t smem = size_t(2) * kRopeRows * half * sizeof(float);
  const dim3 grid((S + kRopeRows - 1) / kRopeRows, B), block(kRopeThreads);
  auto kern = vec ? rope_qk_kernel<T, kVec> : rope_qk_kernel<T, 1>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), pos, freqs,
      static_cast<T*>(oq), static_cast<T*>(ok), S, H, K, dh);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// per-head rms_norm, then rope
// ---------------------------------------------------------------------------

constexpr int kNormRopeThreads = 256;
constexpr int kMaxHalf = 128;  // dh <= 256

// One CTA per (tile of kRopeRows sequence rows, batch row); shared memory
// as rope_qk_kernel's. Head-row hr of the tile (row hr / H, head hr % H)
// belongs to a group of L lanes (L a power of two <= 32): lane `sub` of
// the group holds the vectors sub, sub + L, ... of each half. ITERS
// vectors a lane at most: ceil(kMaxHalf / VEC / 32) when L = 32.
template <typename T, typename TS, int VEC>
__global__ void __launch_bounds__(kNormRopeThreads)
rmsnorm_rope_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    const int* __restrict__ pos,
                    const float* __restrict__ freqs, T* __restrict__ y,
                    int S, int H, int dh, int L, float eps,
                    int scale_plus_one) {
  constexpr int ITERS = (kMaxHalf / VEC + 31) / 32;
  extern __shared__ float cs[];
  const int half = dh / 2;
  float* cos_t = cs;
  float* sin_t = cs + kRopeRows * half;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kRopeRows;
  const int rows = min(kRopeRows, S - s0);

  for (int i = threadIdx.x; i < rows * half; i += blockDim.x) {
    const int r = i / half, j = i % half;
    const float a = __fmul_rn(float(pos[int64_t(b) * S + s0 + r]), freqs[j]);
    float sn, c;
    sincosf(a, &sn, &c);
    cos_t[i] = c;
    sin_t[i] = sn;
  }
  __syncthreads();

  const int nvec = half / VEC;  // vectors per half of one head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = 32 / L;    // head-rows a warp holds at once
  const int sub = lane % L;
  const int total = rows * H;
  const int step = (blockDim.x / 32) * groups;
  // warp-uniform trip count: every lane reaches every shuffle
  for (int base = warp * groups; base < total; base += step) {
    const int hr = base + lane / L;
    const bool live = hr < total;
    const int r = live ? hr / H : 0;
    const int64_t off =
        ((int64_t(b) * S + s0 + r) * H + (live ? hr % H : 0)) * dh;
    float x1[ITERS][VEC], x2[ITERS][VEC];
    float ss = 0.f;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int v = sub + it * L;
      if (live && v < nvec) {
        const Vec<T, VEC> a1 = load_vec<T, VEC>(x + off + v * VEC);
        const Vec<T, VEC> a2 = load_vec<T, VEC>(x + off + half + v * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          x1[it][e] = to_float(a1.v[e]);
          x2[it][e] = to_float(a2.v[e]);
          ss = fmaf(x1[it][e], x1[it][e], ss);
          ss = fmaf(x2[it][e], x2[it][e], ss);
        }
      }
    }
    for (int o = L / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, float(dh)), eps));
    if (!live) continue;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int v = sub + it * L;
      if (v >= nvec) continue;
      Vec<T, VEC> o1, o2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int j = v * VEC + e;
        float sa = to_float(scale[j]), sb = to_float(scale[half + j]);
        if (scale_plus_one) {
          sa = __fadd_rn(1.f, sa);
          sb = __fadd_rn(1.f, sb);
        }
        const float y1 = __fmul_rn(__fmul_rn(x1[it][e], rr), sa);
        const float y2 = __fmul_rn(__fmul_rn(x2[it][e], rr), sb);
        const float c = cos_t[r * half + j], sn = sin_t[r * half + j];
        o1.v[e] = from_float<T>(__fsub_rn(__fmul_rn(y1, c), __fmul_rn(y2, sn)));
        o2.v[e] = from_float<T>(__fadd_rn(__fmul_rn(y2, c), __fmul_rn(y1, sn)));
      }
      store_vec<T, VEC>(y + off + v * VEC, o1);
      store_vec<T, VEC>(y + off + half + v * VEC, o2);
    }
  }
}

template <typename T, typename TS>
cudaError_t launch_rmsnorm_rope(const void* x, const void* scale,
                                const int* pos, const float* freqs, void* y,
                                int B, int S, int H, int dh, float eps,
                                int sp1, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int half = dh / 2;
  const bool vec = half % kVec == 0 && aligned16(x) && aligned16(y);
  const int nvec = vec ? half / kVec : half;
  int L = 1;
  while (L < nvec && L < 32) L *= 2;
  const size_t smem = size_t(2) * kRopeRows * half * sizeof(float);
  const dim3 grid((S + kRopeRows - 1) / kRopeRows, B),
      block(kNormRopeThreads);
  auto kern = vec ? rmsnorm_rope_kernel<T, TS, kVec>
                  : rmsnorm_rope_kernel<T, TS, 1>;
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale), pos, freqs,
      static_cast<T*>(y), S, H, dh, L, eps, sp1);
  return cudaGetLastError();
}

}  // namespace

// dtype / scale_dtype: 0 = float32, 1 = bfloat16. x and y are [rows, D]
// contiguous, scale [D]. route: 0 = two_pass (any shape), 1 = registers
// (D 3,584 / 4,096 / 5,120 / 8,192, x, y and scale 16-byte aligned);
// another route, or one the shape does not fit, is refused. Returns a
// cudaError_t.
extern "C" int fused_rmsnorm(const void* x, const void* scale, void* y,
                             int rows, int D, int dtype, int scale_dtype,
                             float eps, int scale_plus_one, int route,
                             void* stream) {
  if (rows < 1 || D < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && scale_dtype == 0)
    return int(launch_rmsnorm_route<float, float>(
        x, scale, y, rows, D, eps, scale_plus_one, route, st));
  if (dtype == 0 && scale_dtype == 1)
    return int(launch_rmsnorm_route<float, __nv_bfloat16>(
        x, scale, y, rows, D, eps, scale_plus_one, route, st));
  if (dtype == 1 && scale_dtype == 0)
    return int(launch_rmsnorm_route<__nv_bfloat16, float>(
        x, scale, y, rows, D, eps, scale_plus_one, route, st));
  if (dtype == 1 && scale_dtype == 1)
    return int(launch_rmsnorm_route<__nv_bfloat16, __nv_bfloat16>(
        x, scale, y, rows, D, eps, scale_plus_one, route, st));
  return int(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k and both outputs). q, oq
// [B, S, H, dh] and k, ok [B, S, K, dh] contiguous; pos [B, S] int32;
// freqs [dh / 2] fp32. Returns a cudaError_t.
extern "C" int fused_rope_qk(const void* q, const void* k, const void* pos,
                             const void* freqs, void* oq, void* ok, int B,
                             int S, int H, int K, int dh, int dtype,
                             void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || dh < 2 || dh % 2 != 0 ||
      B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const float* f = static_cast<const float*>(freqs);
  if (dtype == 0)
    return int(launch_rope<float>(q, k, p, f, oq, ok, B, S, H, K, dh, st));
  if (dtype == 1)
    return int(launch_rope<__nv_bfloat16>(q, k, p, f, oq, ok, B, S, H, K, dh,
                                          st));
  return int(cudaErrorInvalidValue);
}

// dtype / scale_dtype: 0 = float32, 1 = bfloat16. x and y [B, S, H, dh]
// contiguous, dh even and <= 256; scale [dh]; pos [B, S] int32; freqs
// [dh / 2] fp32. Returns a cudaError_t.
extern "C" int fused_rmsnorm_rope(const void* x, const void* scale,
                                  const void* pos, const void* freqs,
                                  void* y, int B, int S, int H, int dh,
                                  int dtype, int scale_dtype, float eps,
                                  int scale_plus_one, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh < 2 || dh % 2 != 0 ||
      dh > 2 * kMaxHalf || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const float* f = static_cast<const float*>(freqs);
  if (dtype == 0 && scale_dtype == 0)
    return int(launch_rmsnorm_rope<float, float>(
        x, scale, p, f, y, B, S, H, dh, eps, scale_plus_one, st));
  if (dtype == 0 && scale_dtype == 1)
    return int(launch_rmsnorm_rope<float, __nv_bfloat16>(
        x, scale, p, f, y, B, S, H, dh, eps, scale_plus_one, st));
  if (dtype == 1 && scale_dtype == 0)
    return int(launch_rmsnorm_rope<__nv_bfloat16, float>(
        x, scale, p, f, y, B, S, H, dh, eps, scale_plus_one, st));
  if (dtype == 1 && scale_dtype == 1)
    return int(launch_rmsnorm_rope<__nv_bfloat16, __nv_bfloat16>(
        x, scale, p, f, y, B, S, H, dh, eps, scale_plus_one, st));
  return int(cudaErrorInvalidValue);
}
