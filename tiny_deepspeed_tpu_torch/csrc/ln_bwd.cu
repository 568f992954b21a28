// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// LayerNorm's backward for Hopper (sm_90a) in one pass over gy and x:
// dx, and the per-column sums dw and db, with an upstream gradient g_s
// optionally added to dx (AddLayerNormFn: s = x + r feeds both the norm
// and the residual stream, so s's gradient is g_s + dx).
//
// Replaces the TPU kernels
//   tiny_deepspeed_tpu/ops/layernorm_pallas.py::ln_dx_pallas (:132,
//     pallas_call :139): dx = rstd * (gy*w - mean(gy*w) - xhat *
//     mean(gy*w*xhat)) per row, in x's dtype;
//   tiny_deepspeed_tpu/ops/layernorm_pallas.py::ln_dwdb_pallas (:185,
//     pallas_call :191): dw = sum_rows gy*xhat, db = sum_rows gy, summed
//     in f32 and emitted in x's dtype;
// as the vjp rule tiny_deepspeed_tpu/ops/layernorm.py:158-164 calls them
// (then casting dw, db to the weights' dtypes).  Contract: gy, x and the
// optional g_s (rows, N) in T (f32, bf16, f16), unit column stride and
// a row stride each; w (N,) in any of the three; mean and rstd (rows,)
// f32; dx (rows, N) contiguous in T; dw, db (N,) in the dtypes the
// backward returns; pdw, pdb (G, N) f32 scratch, G = ceil(rows / 64).
//
// Bound: bytes.  gy, x (and g_s) read once, dx written once, the row
// stats, w, the partials and dw/db beside them: 37.7 MB at gpt2-124m's
// 8192 x 768 bf16, 11.3 us at 3.35 TB/s; ~10 operations an element
// against the card's ~300 flop/byte balance point.  The TPU pair reads
// gy and x twice (once per kernel); the port's first version did too,
// in three Triton launches.  Here one C entry launches two kernels:
//
//  * stage 1, `ln_bwd_rows_kernel`: a CTA of W warps owns kRows = 64
//    contiguous rows (G = ceil(rows / 64): a fixed partition, never the
//    SM count, so dw/db are bitwise repeatable run to run and card to
//    card); one warp owns one row at a time.  Rows stream through a
//    per-warp ring of S stages in shared memory, 16-byte cp.async copies
//    (neighbouring lanes on neighbouring addresses), issued S-1 rows
//    ahead of the row being reduced: at 768 bf16, 16 warps x 3 stages,
//    ~96 KB in flight per SM against the ~25 KB that 3.35 TB/s x ~1 us
//    of latency needs.  g_s, when given, goes straight to registers at
//    the row's start (its loads fly while the row reduces), so the ring,
//    the rows' split over the warps and hence dw/db are the same bits
//    with and without it.  A lane owns the same columns in every row:
//    its xhat, dxhat feed the row sums c1 = sum(dxhat)/N, c2 =
//    sum(dxhat*xhat)/N (a fixed butterfly of warp shuffles) and its own
//    f32 dw/db sums in registers, in row order.  dx = dxhat*rstd +
//    xhat*k2 + k1 with k1 = -c1*rstd, k2 = -c2*rstd: two FMAs an element
//    (explicit _rn intrinsics, so every instantiation rounds alike),
//    rounded once to T; with g_s, round(float(round(dx)) + float(g_s)),
//    bit for bit autograd's `g_s + dx` on the same dx.  w is staged once
//    a CTA as f32 and held in registers while a lane's sums leave room
//    (bf16 N <= 1024, every f32 row of this kernel), else read from
//    shared memory per chunk.  At the CTA's end the warps' sums fold
//    through shared memory in warp order into partial row g, stored in
//    w's lane-major layout (a column-major dump has 8-way bank conflicts
//    at the CTA's tail: ln_bwd_ablate.py's colmajor_dump).  No atomics.
//    Rows wider than 8 chunks a lane (bf16/f16 N > 2048, f32 N > 1024,
//    or one-element chunks past N = 256) take `ln_bwd_rows_wide_kernel`:
//    the sums in shared memory, one region a warp (so fewer warps as N
//    grows), two passes over the row;
//  * stage 2, `ln_bwd_cols_kernel`: a CTA owns 8 columns of dw and of db
//    and stages the G partials through shared memory (every thread
//    loading); one thread a column sums g = 0..G-1 in ascending order,
//    rounds to x's dtype (JAX emits x's dtype, :215), then to dw's / db's.
//
// Rows whose bases are not 16-byte aligned (N not a multiple of the
// 16-byte vector, or an odd stride or offset) take one-element chunks:
// the same kernels with E = 1, copies through registers.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using tds::sm90::cp_async16;
using tds::sm90::cp_async4;
using tds::sm90::cp_async_commit;
using tds::sm90::cp_async_wait;
using tds::sm90::smem_u32;

constexpr int kRows = 64;           // rows a CTA owns: G = ceil(rows/64)
constexpr int kMaxN = 16384;        // the widest row the entry takes
constexpr int kMaxChunks = 8;       // chunks a lane holds in registers
constexpr int kRingBytes = 192 * 1024;  // stage 1's ring, at most
constexpr int kWideBytes = 192 * 1024;  // the wide kernel's sums
constexpr int kFoldCols = 8;        // stage 2: columns of dw (and db) a CTA
constexpr int kFoldRows = 128;      // stage 2: partial rows staged at once
constexpr int kFoldThreads = 128;

struct Args {
  const void* gy;
  const void* x;
  const void* gs;  // null: no upstream gradient to add
  const void* w;
  const float* mean;
  const float* rstd;
  void* dx;
  float* pdw;
  float* pdb;
  long long sgy, sx, sgs;  // row strides, elements
  int rows, n, w_dtype;
};

// -- chunks: E contiguous elements of T, as one 16-byte vector or alone --

template <typename T, int E>
struct Chunk {
  uint4 v;
};
template <typename T>
struct Chunk<T, 1> {
  T v;
};

template <typename T, int E>
__device__ __forceinline__ Chunk<T, E> ld_chunk(const T* p) {
  Chunk<T, E> c;
  if constexpr (E == 1)
    c.v = *p;
  else
    c.v = *reinterpret_cast<const uint4*>(p);
  return c;
}

template <typename T, int E>
__device__ __forceinline__ void unpack(const Chunk<T, E>& c, float* f) {
  if constexpr (E == 1) {
    f[0] = tds::to_f<T>(c.v);
  } else if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(c.v.x);
    f[1] = __uint_as_float(c.v.y);
    f[2] = __uint_as_float(c.v.z);
    f[3] = __uint_as_float(c.v.w);
  } else {
    const uint32_t u[4] = {c.v.x, c.v.y, c.v.z, c.v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 t;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        __nv_bfloat162 h;
        *reinterpret_cast<uint32_t*>(&h) = u[j];
        t = __bfloat1622float2(h);
      } else {
        __half2 h;
        *reinterpret_cast<uint32_t*>(&h) = u[j];
        t = __half22float2(h);
      }
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
}

// f rounded (RTNE) to T and stored as one chunk at p
template <typename T, int E>
__device__ __forceinline__ void st_chunk(T* p, const float* f) {
  if constexpr (E == 1) {
    *p = tds::from_f<T>(f[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                   __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
        u[j] = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        const __half2 h = __floats2half2_rn(f[2 * j], f[2 * j + 1]);
        u[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// v rounded to T and back (the value a T tensor holds)
template <typename T>
__device__ __forceinline__ float round_trip(float v) {
  return tds::to_f<T>(tds::from_f<T>(v));
}

// one chunk global -> shared: a 16-byte cp.async, or a copy through a
// register for a one-element chunk (cp.async takes 4, 8 or 16 bytes)
template <typename T, int E>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src) {
  if constexpr (E == 1)
    *dst = *src;
  else
    cp_async16(smem_u32(dst), src, true);
}

__device__ __forceinline__ float load_as_f(const void* p, int code,
                                           long long i) {
  switch (code) {
    case tds::kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case tds::kF16:
      return __half2float(static_cast<const __half*>(p)[i]);
    default:
      return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_as(void* p, int code, int i, float v) {
  switch (code) {
    case tds::kBF16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
      break;
    case tds::kF16:
      static_cast<__half*>(p)[i] = __float2half(v);
      break;
    default:
      static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float round_as(int code, float v) {
  switch (code) {
    case tds::kBF16:
      return __bfloat162float(__float2bfloat16(v));
    case tds::kF16:
      return __half2float(__float2half(v));
    default:
      return v;
  }
}

// the per-element arithmetic: xhat = (x - mean) * rstd as the plain
// version (ops/layernorm.py `_ln_dx_plain`) rounds it, and
//   dx = (dxhat - c1 - xhat*c2) * rstd = dxhat*rstd + (xhat*(-c2 rstd)
//        - c1 rstd)
// as two FMAs on per-row constants k2 = -c2*rstd, k1 = -c1*rstd (the
// same value up to f32 rounding; two operations an element fewer)
__device__ __forceinline__ float xhat_of(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}
__device__ __forceinline__ float dx_of(float dxh, float xh, float rstd,
                                       float k1, float k2) {
  return __fmaf_rn(dxh, rstd, __fmaf_rn(xh, k2, k1));
}

__device__ __forceinline__ void butterfly2(float& a, float& b) {
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, m);
    b += __shfl_xor_sync(0xffffffffu, b, m);
  }
}

// dx (f32 values of one chunk) rounded to T, plus g_s's chunk when
// given, stored
template <typename T, int E, bool HAS_GS>
__device__ __forceinline__ void store_dx(T* dst, float* d,
                                         const Chunk<T, E>& gs) {
  if constexpr (HAS_GS) {
    float g[E];
    unpack<T, E>(gs, g);
#pragma unroll
    for (int j = 0; j < E; ++j) d[j] = __fadd_rn(round_trip<T>(d[j]), g[j]);
  }
  st_chunk<T, E>(dst, d);
}

// -- stage 1: rows held in registers --------------------------------------

// the shape of a stage-1 CTA: 16 warps (128 registers a thread) while
// a lane's dw/db sums take at most 48 registers and two ring stages
// fit, else 8 (past 48, the g_s variant's chunks in registers spill at
// 128); as many stages (up to 3) as the ring's budget holds.  It does
// not depend on g_s: the rows' split over the warps, and so dw/db, are
// the same bits with and without it
template <typename T, int E, int CPL>
struct RowCfg {
  static constexpr int kCols = 32 * E * CPL;  // widest row it takes
  static constexpr int kAcc = 2 * E * CPL;    // dw/db registers a lane
  // bytes of one ring stage for one warp: a row of x and of gy
  static constexpr int kRowBytes = 2 * kCols * static_cast<int>(sizeof(T));
  static constexpr int kWarps =
      (kAcc <= 48 && 16 * 2 * kRowBytes <= kRingBytes) ? 16 : 8;
  static constexpr int kFit = kRingBytes / (kWarps * kRowBytes);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr int kRing = kWarps * kStages * kRowBytes;
  static constexpr int kDump = kWarps * 2 * kCols * 4;  // the warps' sums
  static constexpr int kBody = kRing > kDump ? kRing : kDump;
  static constexpr int kSmem =
      kBody + kCols * 4 /* w */ + kWarps * kStages * 8 /* mean, rstd */;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

// float offset of element j of chunk c in w's shared copy: for E >= 4,
// each (chunk round k, quad q) is a block of 32 float4, one a lane, so
// a warp's float4 reads are conflict-free
template <int E>
__device__ __forceinline__ int w_slot(int c, int j) {
  if constexpr (E == 1)
    return c;
  else
    return (((c >> 5) * (E / 4) + (j >> 2)) * 32 + (c & 31)) * 4 + (j & 3);
}

template <int E>
__device__ __forceinline__ void w_chunk(const float* sw, int c, float* wf) {
  if constexpr (E == 1) {
    wf[0] = sw[c];
  } else {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 v =
          reinterpret_cast<const float4*>(sw)[((c >> 5) * (E / 4) + q) * 32 +
                                              (c & 31)];
      wf[4 * q] = v.x;
      wf[4 * q + 1] = v.y;
      wf[4 * q + 2] = v.z;
      wf[4 * q + 3] = v.w;
    }
  }
}

template <typename T, int E, int CPL, bool HAS_GS>
__global__ void __launch_bounds__(RowCfg<T, E, CPL>::kWarps * 32, 1)
    ln_bwd_rows_kernel(const Args a) {
  using C = RowCfg<T, E, CPL>;
  constexpr int W = C::kWarps, S = C::kStages, K = C::kCols;
  constexpr int kRowElems = C::kRowBytes / static_cast<int>(sizeof(T));
  extern __shared__ uint4 smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_raw);
  T* ring = reinterpret_cast<T*>(base);
  float* sw = reinterpret_cast<float*>(base + C::kBody);
  float* stats = sw + K;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = a.n;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rend = static_cast<int>(
      a.rows - r0 < kRows ? a.rows - r0 : static_cast<long long>(kRows));
  const T* gy = static_cast<const T*>(a.gy);
  const T* x = static_cast<const T*>(a.x);
  const T* gs = static_cast<const T*>(a.gs);
  T* dx = static_cast<T*>(a.dx);

  // local row i of the warp's rows warp, warp + W, ... into ring slot s;
  // a group is committed even when empty, so the wait counts stay uniform
  auto issue = [&](int i, int s) {
    if (i < rend) {
      const long long r = r0 + i;
      T* bx = ring + (warp * S + s) * kRowElems;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = k * 32 + lane;
        if (c * E < n) {
          copy_chunk<T, E>(bx + c * E, x + r * a.sx + c * E);
          copy_chunk<T, E>(bx + K + c * E, gy + r * a.sgy + c * E);
        }
      }
      if (lane < 2)
        cp_async4(smem_u32(stats + (warp * S + s) * 2 + lane),
                  lane ? a.rstd + r : a.mean + r, true);
    }
    cp_async_commit();
  };

  for (int s = 0; s < S - 1; ++s) issue(warp + s * W, s);
  for (int c = threadIdx.x; c < K; c += W * 32)
    sw[w_slot<E>(c / E, c % E)] = c < n ? load_as_f(a.w, a.w_dtype, c) : 0.f;
  __syncthreads();

  float adw[CPL * E], adb[CPL * E];
#pragma unroll
  for (int i = 0; i < CPL * E; ++i) adw[i] = adb[i] = 0.f;
  // w in registers while a lane's sums take at most 64 (no shared-memory
  // reads of it per row), else read from shared memory
  constexpr bool kWRegs = 2 * E * CPL <= 64;
  float wr[kWRegs ? CPL * E : 1];
  if constexpr (kWRegs) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) w_chunk<E>(sw, k * 32 + lane, wr + k * E);
  }

  for (int j = 0; warp + j * W < rend; ++j) {
    issue(warp + (j + S - 1) * W, (j + S - 1) % S);  // S-1 rows ahead
    cp_async_wait<S - 1>();                           // row j has landed
    __syncwarp();  // lanes 0 and 1 copied the row's stats
    const int s = j % S;
    const T* bx = ring + (warp * S + s) * kRowElems;
    const float mean = stats[(warp * S + s) * 2];
    const float rstd = stats[(warp * S + s) * 2 + 1];

    const long long r = r0 + warp + j * W;
    // g_s straight into registers: its loads fly while the row reduces
    Chunk<T, E> gsr[HAS_GS ? CPL : 1];
    if constexpr (HAS_GS) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = k * 32 + lane;
        if (c * E < n) gsr[k] = ld_chunk<T, E>(gs + r * a.sgs + c * E);
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = k * 32 + lane;
      if (c * E < n) {
        float xf[E], gf[E], wl[E];
        unpack<T, E>(ld_chunk<T, E>(bx + c * E), xf);
        unpack<T, E>(ld_chunk<T, E>(bx + K + c * E), gf);
        if constexpr (!kWRegs) w_chunk<E>(sw, c, wl);
        const float* wf = kWRegs ? wr + k * E : wl;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = xhat_of(xf[e], mean, rstd);
          const float dxh = __fmul_rn(gf[e], wf[e]);
          s1 += dxh;
          s2 = fmaf(dxh, xh, s2);
          adw[k * E + e] = fmaf(gf[e], xh, adw[k * E + e]);
          adb[k * E + e] += gf[e];
        }
      }
    }
    butterfly2(s1, s2);
    const float k1 = -(s1 / static_cast<float>(n)) * rstd;
    const float k2 = -(s2 / static_cast<float>(n)) * rstd;

#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = k * 32 + lane;
      if (c * E < n) {
        float xf[E], gf[E], wl[E], d[E];
        unpack<T, E>(ld_chunk<T, E>(bx + c * E), xf);
        unpack<T, E>(ld_chunk<T, E>(bx + K + c * E), gf);
        if constexpr (!kWRegs) w_chunk<E>(sw, c, wl);
        const float* wf = kWRegs ? wr + k * E : wl;
#pragma unroll
        for (int e = 0; e < E; ++e)
          d[e] = dx_of(__fmul_rn(gf[e], wf[e]), xhat_of(xf[e], mean, rstd),
                       rstd, k1, k2);
        store_dx<T, E, HAS_GS>(dx + r * n + c * E, d, gsr[HAS_GS ? k : 0]);
      }
    }
    __syncwarp();  // every lane has read the stats before slot s refills
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead: its space takes the warps' sums

  // [W][2][K] in w's layout (`w_slot`): a warp's stores are conflict-free
  float* dump = reinterpret_cast<float*>(base);
  float* mdw = dump + warp * 2 * K;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = k * 32 + lane;
    if (c * E < n) {
      if constexpr (E == 1) {
        mdw[c] = adw[k];
        mdw[K + c] = adb[k];
      } else {
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          const int at = w_slot<E>(c, 4 * q);
          const float* u = adw + k * E + 4 * q;
          const float* v = adb + k * E + 4 * q;
          *reinterpret_cast<float4*>(mdw + at) =
              make_float4(u[0], u[1], u[2], u[3]);
          *reinterpret_cast<float4*>(mdw + K + at) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
  __syncthreads();
  float* pdw = a.pdw + static_cast<size_t>(blockIdx.x) * n;
  float* pdb = a.pdb + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += W * 32) {
    const int at = w_slot<E>(i / E, i % E);
    float sdw = dump[at], sdb = dump[K + at];
#pragma unroll
    for (int q = 1; q < W; ++q) {  // warp order
      sdw += dump[q * 2 * K + at];
      sdb += dump[q * 2 * K + K + at];
    }
    pdw[i] = sdw;
    pdb[i] = sdb;
  }
}

// -- stage 1: wide rows, the sums in shared memory --------------------------

template <typename T, int E, bool HAS_GS>
__global__ void __launch_bounds__(256, 1)
    ln_bwd_rows_wide_kernel(const Args a) {
  extern __shared__ uint4 smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [W][2][n]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int n = a.n, chunks = n / E;
  float* mdw = acc + static_cast<size_t>(warp) * 2 * n;
  float* mdb = mdw + n;
  for (int i = lane; i < 2 * n; i += 32) mdw[i] = 0.f;
  __syncwarp();
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rend = static_cast<int>(
      a.rows - r0 < kRows ? a.rows - r0 : static_cast<long long>(kRows));
  const T* gy = static_cast<const T*>(a.gy);
  const T* x = static_cast<const T*>(a.x);
  const T* gs = static_cast<const T*>(a.gs);
  T* dx = static_cast<T*>(a.dx);

  for (int i = warp; i < rend; i += W) {
    const long long r = r0 + i;
    const T* xr = x + r * a.sx;
    const T* gr = gy + r * a.sgy;
    const float mean = a.mean[r], rstd = a.rstd[r];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      float xf[E], gf[E];
      unpack<T, E>(ld_chunk<T, E>(xr + c * E), xf);
      unpack<T, E>(ld_chunk<T, E>(gr + c * E), gf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = xhat_of(xf[e], mean, rstd);
        const float dxh = __fmul_rn(gf[e], load_as_f(a.w, a.w_dtype, c * E + e));
        s1 += dxh;
        s2 = fmaf(dxh, xh, s2);
        mdw[c * E + e] = fmaf(gf[e], xh, mdw[c * E + e]);
        mdb[c * E + e] += gf[e];
      }
    }
    butterfly2(s1, s2);
    const float k1 = -(s1 / static_cast<float>(n)) * rstd;
    const float k2 = -(s2 / static_cast<float>(n)) * rstd;
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      float xf[E], gf[E], d[E];
      unpack<T, E>(ld_chunk<T, E>(xr + c * E), xf);
      unpack<T, E>(ld_chunk<T, E>(gr + c * E), gf);
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = dx_of(__fmul_rn(gf[e], load_as_f(a.w, a.w_dtype, c * E + e)),
                     xhat_of(xf[e], mean, rstd), rstd, k1, k2);
      Chunk<T, E> g{};
      if constexpr (HAS_GS) g = ld_chunk<T, E>(gs + r * a.sgs + c * E);
      store_dx<T, E, HAS_GS>(dx + r * n + c * E, d, g);
    }
  }
  __syncthreads();
  float* pdw = a.pdw + static_cast<size_t>(blockIdx.x) * n;
  float* pdb = a.pdb + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float sdw = acc[i], sdb = acc[n + i];
    for (int q = 1; q < W; ++q) {  // warp order
      sdw += acc[static_cast<size_t>(q) * 2 * n + i];
      sdb += acc[static_cast<size_t>(q) * 2 * n + n + i];
    }
    pdw[i] = sdw;
    pdb[i] = sdb;
  }
}

// -- stage 2: the column fold -----------------------------------------------

__global__ void __launch_bounds__(kFoldThreads)
    ln_bwd_cols_kernel(const float* pdw, const float* pdb, void* dw, void* db,
                       int groups, int n, int x_dtype, int dw_dtype,
                       int db_dtype) {
  constexpr int kSpan = 2 * kFoldCols;  // dw's columns, then db's
  __shared__ float tile[kFoldRows * kSpan];
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * kFoldCols;
  float acc = 0.f;
  constexpr int kPer = kFoldRows * kSpan / kFoldThreads;
  for (int g0 = 0; g0 < groups; g0 += kFoldRows) {
    const int gn = groups - g0 < kFoldRows ? groups - g0 : kFoldRows;
    float v[kPer];  // every load of the block issued before any store
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = t + u * kFoldThreads;
      const int j = i % kSpan, c = c0 + j % kFoldCols;
      const float* p = j < kFoldCols ? pdw : pdb;
      v[u] = i < gn * kSpan && c < n
                 ? p[static_cast<size_t>(g0 + i / kSpan) * n + c]
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) tile[t + u * kFoldThreads] = v[u];
    __syncthreads();
    if (t < kSpan) {
#pragma unroll 8
      for (int g = 0; g < gn; ++g) acc += tile[g * kSpan + t];  // ascending
    }
    __syncthreads();
  }
  const int c = c0 + t % kFoldCols;
  if (t < kSpan && c < n) {
    const bool is_db = t >= kFoldCols;
    store_as(is_db ? db : dw, is_db ? db_dtype : dw_dtype, c,
             round_as(x_dtype, acc));
  }
}

// -- launches -----------------------------------------------------------------

template <typename K>
cudaError_t grant_smem(K kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

template <typename T, int E, int CPL, bool HAS_GS>
cudaError_t launch_rows(const Args& a, int groups, cudaStream_t st) {
  using C = RowCfg<T, E, CPL>;
  auto kernel = ln_bwd_rows_kernel<T, E, CPL, HAS_GS>;
  const cudaError_t e = grant_smem(kernel, C::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<groups, C::kWarps * 32, C::kSmem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int E, bool HAS_GS>
cudaError_t launch_wide(const Args& a, int groups, cudaStream_t st) {
  int warps = kWideBytes / (8 * a.n);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const int smem = warps * 8 * a.n;
  auto kernel = ln_bwd_rows_wide_kernel<T, E, HAS_GS>;
  const cudaError_t e = grant_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<groups, warps * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int E, bool HAS_GS>
cudaError_t pick(const Args& a, int groups, cudaStream_t st) {
  const int cpl = (a.n + 32 * E - 1) / (32 * E);
  if constexpr (E == 1) {  // one-element chunks: a few widths suffice
    if (cpl <= 1) return launch_rows<T, E, 1, HAS_GS>(a, groups, st);
    if (cpl <= 2) return launch_rows<T, E, 2, HAS_GS>(a, groups, st);
    if (cpl <= 4) return launch_rows<T, E, 4, HAS_GS>(a, groups, st);
    if (cpl <= kMaxChunks) return launch_rows<T, E, 8, HAS_GS>(a, groups, st);
  } else {
    switch (cpl) {
      case 1: return launch_rows<T, E, 1, HAS_GS>(a, groups, st);
      case 2: return launch_rows<T, E, 2, HAS_GS>(a, groups, st);
      case 3: return launch_rows<T, E, 3, HAS_GS>(a, groups, st);
      case 4: return launch_rows<T, E, 4, HAS_GS>(a, groups, st);
      case 5: return launch_rows<T, E, 5, HAS_GS>(a, groups, st);
      case 6: return launch_rows<T, E, 6, HAS_GS>(a, groups, st);
      case 7: return launch_rows<T, E, 7, HAS_GS>(a, groups, st);
      case 8: return launch_rows<T, E, 8, HAS_GS>(a, groups, st);
      default: break;
    }
  }
  return launch_wide<T, E, HAS_GS>(a, groups, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch_stage1(const Args& a, int groups, cudaStream_t st) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const bool gs = a.gs != nullptr;
  const bool vec = a.n % E == 0 && a.sx % E == 0 && a.sgy % E == 0 &&
                   (!gs || (a.sgs % E == 0 && aligned16(a.gs))) &&
                   aligned16(a.x) && aligned16(a.gy) && aligned16(a.dx);
  if (vec)
    return gs ? pick<T, E, true>(a, groups, st)
              : pick<T, E, false>(a, groups, st);
  return gs ? pick<T, 1, true>(a, groups, st)
            : pick<T, 1, false>(a, groups, st);
}

bool dtype_ok(int code) {
  return code == tds::kF32 || code == tds::kBF16 || code == tds::kF16;
}

}  // namespace

// LayerNorm's backward, both stages on `stream`.  gy, x, gs (null: none)
// (rows, n) in x_dtype with row strides sgy, sx, sgs (elements); w (n,)
// in w_dtype; mean, rstd (rows,) f32; dx (rows, n) contiguous in
// x_dtype; pdw, pdb (groups, n) f32 scratch with groups = ceil(rows /
// 64); dw in dw_dtype, db in db_dtype, (n,).  Returns the first launch
// error (cudaGetLastError after both launches).
extern "C" int ln_bwd(const void* gy, const void* x, const void* gs,
                      const void* w, const float* mean, const float* rstd,
                      void* dx, float* pdw, float* pdb, void* dw, void* db,
                      long long sgy, long long sx, long long sgs, int rows,
                      int n, int groups, int x_dtype, int w_dtype,
                      int dw_dtype, int db_dtype, void* stream) {
  if (n < 1 || n > kMaxN || rows < 0 ||
      groups != (rows + kRows - 1) / kRows || !dtype_ok(x_dtype) ||
      !dtype_ok(w_dtype) || !dtype_ok(dw_dtype) || !dtype_ok(db_dtype))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{gy, x, gs, w, mean, rstd, dx, pdw, pdb, sgy, sx, sgs,
               rows, n, w_dtype};
  if (rows > 0) {
    cudaError_t e;
    switch (x_dtype) {
      case tds::kF32: e = launch_stage1<float>(a, groups, st); break;
      case tds::kBF16: e = launch_stage1<__nv_bfloat16>(a, groups, st); break;
      default: e = launch_stage1<__half>(a, groups, st); break;
    }
    if (e != cudaSuccess) return e;
  }
  ln_bwd_cols_kernel<<<(n + kFoldCols - 1) / kFoldCols, kFoldThreads, 0, st>>>(
      pdw, pdb, dw, db, groups, n, x_dtype, dw_dtype, db_dtype);
  return cudaGetLastError();
}
