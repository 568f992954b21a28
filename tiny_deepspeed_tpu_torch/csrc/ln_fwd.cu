// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// LayerNorm's forward for Hopper (sm_90a): (y, mean, rstd) of rows of x,
// and the same with the residual add before it fused in (s = x + r, then
// the norm of s).
//
// Replaces the TPU kernel
//   tiny_deepspeed_tpu/ops/layernorm_pallas.py::ln_fwd_pallas (:78,
//     pallas_call :87): per row mean = sum(x)/N, var = sum(x*x)/N -
//     mean^2, rstd = 1/sqrt(var + eps) in f32, y = (x - mean)*rstd*w + b
//     in x's dtype;
// and, with HAS_R, the add that the JAX package makes before it
// (tiny_deepspeed_tpu/models/gpt2.py's residual `x + y`, then the next
// pre-LN norm).  Contract: x (and r) (rows, N) in T (f32, bf16, f16) with
// unit column stride and a row stride each; w, b (N,) each in any of the
// three; s, y (rows, N) contiguous in T; mean, rstd (rows,) f32.
//
// Bound: bytes.  x (and r) read once, y (and s) written once, w, b and
// the 8 bytes of (mean, rstd) a row: 25.2 MB at gpt2-124m's training
// shape (8192 x 768 bf16), 7.5 us at 3.35 TB/s (15.0 us with r); ~8
// operations an element against the card's ~300 flop/byte balance
// point.  At serving's decode tick (8 rows) the bytes take ~10 ns: a
// launch's floor is the device's cost, and the host's is the wrapper's.
// So the entry is one ctypes call with declared argtypes: no Triton
// launcher, no per-call formatting (the Triton pair it replaced cost
// the H100's host ~0.05-0.14 ms a call at the decode shape).
//
// Numerics: those of the Triton kernels this replaced (ops/layernorm.py
// `_ln_fwd_kernel` / `_add_ln_fwd_kernel`, Triton 3.6), bit for bit, so
// serving's tokens and training's losses stay theirs.  Triton lays a
// row of BLOCK = next_pow2(N) columns over its 4 warps (8 past BLOCK =
// 2048) as spt contiguous elements a thread — 16 bytes' worth when the
// operands' bases are 16-byte aligned and their row strides divide by
// 16, at most BLOCK / threads — repeated every spt * threads columns.
// Its reduction sums a thread's elements in register order (x*x with
// FMAs, the first two squares in one), each warp's lanes by an xor
// butterfly (16, 8, 4, 2, 1; over the lanes with data when BLOCK < 32,
// the first step taking a lone element's x*x into an FMA), then the
// warps' sums by an xor butterfly through shared memory; `/` is
// div.full.f32, `tl.sqrt` sqrt.approx, and y = fma((x - mean) * rstd, w,
// b).  So a kernel here is Triton's program written out: a CTA of the
// same warps a row, thread t holding Triton's thread t's elements,
// masked columns counting as zeros (Triton loads them as `other=0.0`),
// every step in the same order with the same rounding, spelled as _rn
// intrinsics or PTX so no build contracts otherwise.  Checked bit for
// bit against the Triton pair on the H100 at N = 7 to 16384, f32, bf16
// and f16, mixed weight dtypes, strided and misaligned rows.
//
//  * the fast kernels (`ln_fwd_row_kernel`, `add_ln_fwd_row_kernel`):
//    the 16-byte layout at BLOCK 1024 and 2048 (gpt2's 768, 1024, 1280
//    and 1600) when x, y, w, b (r, s) take 16-byte loads and w, b are in
//    T: x (r), w and b loaded in one go, the row in registers, y (s)
//    stored streaming.  A warp a row, each lane standing for Triton's
//    lanes of all 4 warps, took 1.8x Triton's time at 8192 x 768 on the
//    H100 (8 butterflies a row, 148 registers); this layout matches
//    Triton's device time or beats it there (PERF.md);
//  * any other layout (`ln_fwd_any_kernel`, `add_ln_fwd_any_kernel`):
//    spt and reps at run time, element by element, the row read again
//    for y; one warp of data keeps each lane's own sums, as Triton
//    does (no shared-memory fold there, so y takes its lane's FMA'd
//    sum of squares).
//
// With HAS_R the sum x + r is rounded once to T (RTNE, as eager `x + r`
// rounds it), stored as s, and the same body runs on it: s, y, mean,
// rstd are bit for bit `x + r` then the norm.
//
// RMSNorm (the Llama family's norm; an XLA fusion in the JAX package,
// tiny_deepspeed_tpu/ops/rmsnorm.py, no TPU kernel) rides the same
// kernels under the RMS flag, behind a C entry of its own (`rms_fwd`):
// no sum of x, no mean and no bias, rstd = 1/sqrt(sum(x*x)/N + eps) and
// y = (x * rstd) * w, the plain version's order (f32 statistics; its
// rsqrt and this sqrt.approx agree to an ulp or two).  HAS_R works with
// it, so the Llama block's residual add and the next norm are one
// launch.  The kernels are named rms_* / add_rms_* so a profile tells
// them from LayerNorm's; with the flag off the code is LayerNorm's.

#include <string.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxN = 16384;     // the widest row the entry takes
constexpr int kWarpMaxN = 2048;  // Triton's 4-warp blocks, up to here
constexpr int kWarps = 4;        // a CTA's warps: Triton's
constexpr int kWideWarps = 8;    // past kWarpMaxN

struct Args {
  const void* x;
  const void* r;  // null without the residual add
  const void* w;
  const void* b;  // null under RMS
  void* s;
  void* y;
  float* mean;  // null under RMS
  float* rstd;
  long long sx, sr, rows;  // row strides (elements) and the row count
  int n, w_dtype, b_dtype;
  int spt, reps;  // Triton's layout: elements a thread, and reps a row
  int first;      // the butterfly step that contracts a lone x*x (0: none)
  bool own;       // one warp holds the data: each lane keeps its own sums
  float eps;
};

// -- chunks: V contiguous elements of T ---------------------------------------

// the chunk at p (16-byte aligned, inside the row) into t, in one load
template <typename T, int V>
__device__ __forceinline__ void ld_chunk(const T* p, T* t) {
  static_assert(V * sizeof(T) == 16, "a chunk is 16 bytes");
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  memcpy(t, &u, sizeof(u));
}

// f rounded (RTNE) to T and stored as the chunk at p, in one streaming
// store (st.global.cs: 12% off the add kernel at 8192 x 768 bf16 on the
// H100, 8% off the forward at 8192 x 1600)
template <typename T, int V>
__device__ __forceinline__ void st_chunk(T* p, const float* f) {
  T t[V];
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = tds::from_f<T>(f[e]);
  uint4 u;
  memcpy(&u, t, sizeof(u));
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ float load_as_f(const void* p, int code, int i) {
  switch (code) {
    case tds::kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case tds::kF16:
      return __half2float(static_cast<const __half*>(p)[i]);
    default:
      return static_cast<const float*>(p)[i];
  }
}

// -- Triton's arithmetic ------------------------------------------------------

__device__ __forceinline__ float div_full(float a, float b) {
  float q;
  asm("div.full.f32 %0, %1, %2;" : "=f"(q) : "f"(a), "f"(b));
  return q;
}

__device__ __forceinline__ float sqrt_approx(float a) {
  float q;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(q) : "f"(a));
  return q;
}

// a thread's partial sums of x and x*x over its elements in register
// order, as Triton's compiler emits them: the first two squares
// contracted into one FMA, then an FMA a square.  A thread of one
// element keeps x*x unadded: the first butterfly step contracts it.
// Under RMS the sum of x is neither kept nor shuffled.
template <bool RMS>
struct Partial {
  float s1, s2, x0;

  // element i of the thread's (i = 0, 1, 2, ...)
  __device__ __forceinline__ void add(int i, float v) {
    if (i == 0) {
      s1 = x0 = v;
      s2 = __fmul_rn(v, v);
    } else {
      if constexpr (!RMS) s1 = __fadd_rn(s1, v);
      s2 = i == 1 ? __fmaf_rn(x0, x0, __fmul_rn(v, v)) : __fmaf_rn(v, v, s2);
    }
  }

  // one step of the xor butterfly over a warp's lanes (m = 16, 8, 4, 2,
  // 1); `first`: the step that takes a lone element's x*x into an FMA
  __device__ __forceinline__ void step(int m, bool first) {
    if constexpr (!RMS)
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
    const float o2 = __shfl_xor_sync(0xffffffffu, s2, m);
    s2 = first ? __fmaf_rn(x0, x0, o2) : __fadd_rn(s2, o2);
  }
};

// the row's (mean, rstd) from its two sums
__device__ __forceinline__ void stats(float s1, float s2, int n, float eps,
                                      float& mean, float& rstd) {
  const float fn = static_cast<float>(n);
  mean = div_full(s1, fn);
  const float var = __fmaf_rn(-mean, mean, div_full(s2, fn));
  rstd = div_full(1.0f, sqrt_approx(__fadd_rn(var, eps)));
}

// RMSNorm's rstd from the row's sum of squares
__device__ __forceinline__ float rms_rstd(float s2, int n, float eps) {
  return div_full(1.0f, sqrt_approx(__fadd_rn(
                            div_full(s2, static_cast<float>(n)), eps)));
}

__device__ __forceinline__ float y_of(float x, float mean, float rstd,
                                      float w, float b) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(x, mean), rstd), w, b);
}

// RMSNorm's output: (x * rstd) * w, the plain version's order
__device__ __forceinline__ float rms_y(float x, float rstd, float w) {
  return __fmul_rn(__fmul_rn(x, rstd), w);
}

// v rounded to T and back (the value a T tensor holds)
template <typename T>
__device__ __forceinline__ float round_trip(float v) {
  return tds::to_f<T>(tds::from_f<T>(v));
}

// the warps' fold: Triton's xor butterfly over W warp sums through
// shared memory, as lane 0 has it
template <int W>
__device__ __forceinline__ float fold(float* f) {
#pragma unroll
  for (int m = W / 2; m; m >>= 1)
#pragma unroll
    for (int i = 0; i < m; ++i) f[i] = __fadd_rn(f[i], f[i + m]);
  return f[0];
}

// the Triton reduction's tail: lane 0 of each warp leaves its warp's
// sums in shared memory; after the barrier every thread folds them in
// Triton's order
template <int W, bool RMS>
__device__ __forceinline__ void cta_fold(const Partial<RMS>& p,
                                         float (*sums)[W], float& s1,
                                         float& s2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    if constexpr (!RMS) sums[0][warp] = p.s1;
    sums[1][warp] = p.s2;
  }
  __syncthreads();
  float f1[W], f2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (!RMS) f1[i] = sums[0][i];
    f2[i] = sums[1][i];
  }
  if constexpr (!RMS) s1 = fold<W>(f1);
  s2 = fold<W>(f2);
}

// -- the fast kernels: Triton's 16-byte layout at BLOCK 1024 and 2048
// (gpt2's 768, 1024, 1280 and 1600) on rows, w and b that take 16-byte
// loads: a CTA of 4 warps a row, thread t Triton's thread t, its R chunks
// of V elements in registers ------------------------------------------------

template <typename T, int V, int R, bool HAS_R, bool RMS>
__device__ __forceinline__ void fast_row(const Args& a) {
  constexpr int kSpan = V * 32 * kWarps;  // columns one rep covers
  __shared__ float sums[2][kWarps];
  const int n = a.n;
  const long long row = blockIdx.x;
  const T* x = static_cast<const T*>(a.x) + row * a.sx;
  const T* r = HAS_R ? static_cast<const T*>(a.r) + row * a.sr : nullptr;
  const T* w = static_cast<const T*>(a.w);
  const T* b = static_cast<const T*>(a.b);
  T* s = HAS_R ? static_cast<T*>(a.s) + row * n : nullptr;
  T* y = static_cast<T*>(a.y) + row * n;
  const int c0 = V * threadIdx.x;

  // x (and r), w and b: every load issued before any is used
  T cx[R][V], cr[HAS_R ? R : 1][V], cw[R][V], cb[RMS ? 1 : R][V];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int c = j * kSpan + c0;
    if (c < n) {
      ld_chunk<T, V>(x + c, cx[j]);
      if constexpr (HAS_R) ld_chunk<T, V>(r + c, cr[j]);
      ld_chunk<T, V>(w + c, cw[j]);
      if constexpr (!RMS) ld_chunk<T, V>(b + c, cb[j]);
    }
  }
  float v[R * V];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int c = j * kSpan + c0;
#pragma unroll
    for (int e = 0; e < V; ++e)
      v[j * V + e] = c < n ? tds::to_f<T>(cx[j][e]) : 0.f;
    if constexpr (HAS_R) {
      if (c < n) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          v[j * V + e] = round_trip<T>(
              __fadd_rn(v[j * V + e], tds::to_f<T>(cr[j][e])));
        st_chunk<T, V>(s + c, v + j * V);
      }
    }
  }
  Partial<RMS> p;
#pragma unroll
  for (int i = 0; i < R * V; ++i) p.add(i, v[i]);
#pragma unroll
  for (int m = 16; m; m >>= 1) p.step(m, false);
  float s1, s2, mean = 0.f, rstd;
  cta_fold<kWarps>(p, sums, s1, s2);
  if constexpr (RMS)
    rstd = rms_rstd(s2, n, a.eps);
  else
    stats(s1, s2, n, a.eps, mean, rstd);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int c = j * kSpan + c0;
    if (c < n) {
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if constexpr (RMS)
          o[e] = rms_y(v[j * V + e], rstd, tds::to_f<T>(cw[j][e]));
        else
          o[e] = y_of(v[j * V + e], mean, rstd, tds::to_f<T>(cw[j][e]),
                      tds::to_f<T>(cb[j][e]));
      }
      st_chunk<T, V>(y + c, o);
    }
  }
  if (threadIdx.x == 0) {
    if constexpr (!RMS) a.mean[row] = mean;
    a.rstd[row] = rstd;
  }
}

// -- any other layout: Triton's spt and reps at run time, element by
// element, the row read again for y (an L1 hit); a CTA of W warps a row ---

// one element of the row the norm reads (zero past N); with HAS_R the
// sum rounded once to T, stored as s
template <typename T, bool HAS_R>
__device__ __forceinline__ float row_at(const T* x, const T* r, T* s, int c,
                                        int n) {
  if (c >= n) return 0.f;
  float v = tds::to_f<T>(x[c]);
  if constexpr (HAS_R) {
    v = round_trip<T>(__fadd_rn(v, tds::to_f<T>(r[c])));
    s[c] = tds::from_f<T>(v);
  }
  return v;
}

template <typename T, int W, bool HAS_R, bool RMS>
__device__ __forceinline__ void any_row(const Args& a) {
  __shared__ float sums[2][W];
  const int n = a.n, V = a.spt, R = a.reps, span = V * 32 * W;
  const long long row = blockIdx.x;
  const T* x = static_cast<const T*>(a.x) + row * a.sx;
  const T* r = HAS_R ? static_cast<const T*>(a.r) + row * a.sr : nullptr;
  T* s = HAS_R ? static_cast<T*>(a.s) + row * n : nullptr;
  T* y = static_cast<T*>(a.y) + row * n;
  const int c0 = V * threadIdx.x;
  Partial<RMS> p;
#pragma unroll 1  // run-time trip counts: nvcc takes minutes to unroll them
  for (int k = 0; k < R * V; ++k)
    p.add(k, row_at<T, HAS_R>(x, r, s, (k / V) * span + c0 + k % V, n));
  // one element a thread (BLOCK <= 32 * W): Triton's butterfly spans
  // only the lanes with data, and its first step (`a.first`) takes the
  // unadded x*x into an FMA
#pragma unroll
  for (int m = 16; m; m >>= 1) p.step(m, m == a.first);
  float s1 = p.s1, s2 = p.s2, mean = 0.f, rstd;
  if (!a.own) cta_fold<W>(p, sums, s1, s2);
  if constexpr (RMS)
    rstd = rms_rstd(s2, n, a.eps);
  else
    stats(s1, s2, n, a.eps, mean, rstd);
#pragma unroll 1
  for (int k = 0; k < R * V; ++k) {
    const int c = (k / V) * span + c0 + k % V;
    if (c < n) {
      const float v = tds::to_f<T>(HAS_R ? s[c] : x[c]);
      const float w = load_as_f(a.w, a.w_dtype, c);
      y[c] = tds::from_f<T>(RMS ? rms_y(v, rstd, w)
                                : y_of(v, mean, rstd, w,
                                       load_as_f(a.b, a.b_dtype, c)));
    }
  }
  if (threadIdx.x == 0) {
    if constexpr (!RMS) a.mean[row] = mean;
    a.rstd[row] = rstd;
  }
}

// -- the kernels: the plain and the add variants under names of their own,
// so a profile tells them apart ---------------------------------------------

template <typename T, int V, int R>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_row_kernel(const Args a) {
  fast_row<T, V, R, false, false>(a);
}

template <typename T, int V, int R>
__global__ void __launch_bounds__(kWarps * 32)
    add_ln_fwd_row_kernel(const Args a) {
  fast_row<T, V, R, true, false>(a);
}

template <typename T, int W>
__global__ void __launch_bounds__(W * 32) ln_fwd_any_kernel(const Args a) {
  any_row<T, W, false, false>(a);
}

template <typename T, int W>
__global__ void __launch_bounds__(W * 32)
    add_ln_fwd_any_kernel(const Args a) {
  any_row<T, W, true, false>(a);
}

template <typename T, int V, int R>
__global__ void __launch_bounds__(kWarps * 32)
    rms_fwd_row_kernel(const Args a) {
  fast_row<T, V, R, false, true>(a);
}

template <typename T, int V, int R>
__global__ void __launch_bounds__(kWarps * 32)
    add_rms_fwd_row_kernel(const Args a) {
  fast_row<T, V, R, true, true>(a);
}

template <typename T, int W>
__global__ void __launch_bounds__(W * 32) rms_fwd_any_kernel(const Args a) {
  any_row<T, W, false, true>(a);
}

template <typename T, int W>
__global__ void __launch_bounds__(W * 32)
    add_rms_fwd_any_kernel(const Args a) {
  any_row<T, W, true, true>(a);
}

// the kernel of each (RMS, HAS_R) pair: LayerNorm's, or RMSNorm's
template <typename T, int V, int R, bool HAS_R, bool RMS>
auto row_kernel() {
  if constexpr (RMS)
    return HAS_R ? add_rms_fwd_row_kernel<T, V, R>
                 : rms_fwd_row_kernel<T, V, R>;
  else
    return HAS_R ? add_ln_fwd_row_kernel<T, V, R> : ln_fwd_row_kernel<T, V, R>;
}

template <typename T, int W, bool HAS_R, bool RMS>
auto any_kernel() {
  if constexpr (RMS)
    return HAS_R ? add_rms_fwd_any_kernel<T, W> : rms_fwd_any_kernel<T, W>;
  else
    return HAS_R ? add_ln_fwd_any_kernel<T, W> : ln_fwd_any_kernel<T, W>;
}

// -- launches -----------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Triton's elements a thread for one of its kernels' memory operands
// (its coalescing pass): 16 bytes' worth when the operand's base is
// 16-byte aligned and its row stride divides by 16 (Triton specializes
// such integers), else 1
int per_thread(const void* p, long long stride, int elem_bytes) {
  return aligned16(p) && stride % 16 == 0 ? 16 / elem_bytes : 1;
}

int dtype_bytes(int code) { return code == tds::kF32 ? 4 : 2; }

template <typename T>
constexpr int code_of() {
  return std::is_same<T, float>::value           ? tds::kF32
         : std::is_same<T, __nv_bfloat16>::value ? tds::kBF16
                                                 : tds::kF16;
}

template <typename K>
cudaError_t launch(K kernel, const Args& a, int warps, cudaStream_t st) {
  kernel<<<static_cast<unsigned>(a.rows), warps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

// Triton's layout for this row — spt elements a thread: the largest of
// its memory operands' (x, w, b, y; r and s), but no more than BLOCK /
// threads — and the kernel that reproduces it: the fast kernels where
// that is 16 bytes' worth of T at BLOCK 1024 or 2048, else the kernels
// that take any layout.  Under RMS there is no b to count.
template <typename T, bool HAS_R, bool RMS>
cudaError_t dispatch(Args a, cudaStream_t st) {
  constexpr int kT = static_cast<int>(sizeof(T)), kVec = 16 / kT;
  int block = 1;
  while (block < a.n) block <<= 1;
  int most = std::max(per_thread(a.x, a.sx, kT), per_thread(a.y, a.n, kT));
  most = std::max(most, per_thread(a.w, 0, dtype_bytes(a.w_dtype)));
  if (!RMS)
    most = std::max(most, per_thread(a.b, 0, dtype_bytes(a.b_dtype)));
  if (HAS_R)
    most = std::max({most, per_thread(a.r, a.sr, kT),
                     per_thread(a.s, a.n, kT)});
  const int warps = block <= kWarpMaxN ? kWarps : kWideWarps;
  a.spt = std::min(most, std::max(block / (32 * warps), 1));
  a.reps = std::max(block / (a.spt * 32 * warps), 1);
  // a lone element a thread: the butterfly's first step over the lanes
  // that hold data (BLOCK of them, at most 32); with one warp of them,
  // Triton folds nothing through shared memory: each lane's y takes the
  // lane's own sums (its FMA makes them differ from lane to lane)
  const int lanes = std::min(block, 32);
  a.first = a.spt * a.reps == 1 && lanes > 1 ? lanes / 2 : 0;
  a.own = block / a.spt <= 32;
  // the fast kernels: 16-byte chunks of T for x, y, w and b (r and s)
  const bool vec =
      a.n % kVec == 0 && a.sx % kVec == 0 && aligned16(a.x) &&
      aligned16(a.y) && a.w_dtype == code_of<T>() && aligned16(a.w) &&
      (RMS || (a.b_dtype == code_of<T>() && aligned16(a.b))) &&
      (!HAS_R || (a.sr % kVec == 0 && aligned16(a.r) && aligned16(a.s)));
  if (vec && warps == kWarps && a.spt == kVec &&
      (block == 1024 || block == 2048)) {
    constexpr int kR1 = 1024 / (kVec * 32 * kWarps);  // reps at 1024
    if (block == 1024)
      return launch(row_kernel<T, kVec, kR1, HAS_R, RMS>(), a, kWarps, st);
    return launch(row_kernel<T, kVec, 2 * kR1, HAS_R, RMS>(), a, kWarps, st);
  }
  if (warps == kWarps)
    return launch(any_kernel<T, kWarps, HAS_R, RMS>(), a, kWarps, st);
  return launch(any_kernel<T, kWideWarps, HAS_R, RMS>(), a, kWideWarps, st);
}

bool dtype_ok(int code) {
  return code == tds::kF32 || code == tds::kBF16 || code == tds::kF16;
}

template <bool RMS>
cudaError_t dispatch_dtype(const Args& a, int x_dtype, cudaStream_t st) {
  const bool add = a.r != nullptr;
  switch (x_dtype) {
    case tds::kF32:
      return add ? dispatch<float, true, RMS>(a, st)
                 : dispatch<float, false, RMS>(a, st);
    case tds::kBF16:
      return add ? dispatch<__nv_bfloat16, true, RMS>(a, st)
                 : dispatch<__nv_bfloat16, false, RMS>(a, st);
    default:
      return add ? dispatch<__half, true, RMS>(a, st)
                 : dispatch<__half, false, RMS>(a, st);
  }
}

}  // namespace

// LayerNorm's forward on `stream`: x (rows, n) in x_dtype with row stride
// sx (elements); with r non-null (row stride sr, x's dtype) the residual
// add first, its sum stored in s (rows, n) contiguous; y (rows, n)
// contiguous in x_dtype; w in w_dtype and b in b_dtype, (n,); mean, rstd
// (rows,) f32.  Returns the launch's error (cudaGetLastError).
extern "C" int ln_fwd(const void* x, const void* r, const void* w,
                      const void* b, void* s, void* y, float* mean,
                      float* rstd, long long sx, long long sr, long long rows,
                      int n, int x_dtype, int w_dtype, int b_dtype, float eps,
                      void* stream) {
  if (n < 1 || n > kMaxN || rows < 0 || rows > 0x7fffffffLL ||
      !dtype_ok(x_dtype) || !dtype_ok(w_dtype) || !dtype_ok(b_dtype) ||
      (r != nullptr && s == nullptr))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Args a{x, r, w, b, s, y, mean, rstd, sx, sr, rows, n, w_dtype,
               b_dtype, 1, 1, 0, false, eps};
  return dispatch_dtype<false>(a, x_dtype, static_cast<cudaStream_t>(stream));
}

// RMSNorm's forward on `stream` (the RMS flag): as `ln_fwd` without b and
// mean; y = (x * rstd) * w with rstd = 1/sqrt(mean(x*x) + eps) f32
// (rows,).  With r non-null the residual add first, its sum in s.
extern "C" int rms_fwd(const void* x, const void* r, const void* w, void* s,
                       void* y, float* rstd, long long sx, long long sr,
                       long long rows, int n, int x_dtype, int w_dtype,
                       float eps, void* stream) {
  if (n < 1 || n > kMaxN || rows < 0 || rows > 0x7fffffffLL ||
      !dtype_ok(x_dtype) || !dtype_ok(w_dtype) ||
      (r != nullptr && s == nullptr))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Args a{x, r, w, nullptr, s, y, nullptr, rstd, sx, sr, rows, n,
               w_dtype, x_dtype, 1, 1, 0, false, eps};
  return dispatch_dtype<true>(a, x_dtype, static_cast<cudaStream_t>(stream));
}
