// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// Fused lm_head + softmax cross-entropy for Hopper (sm_90a): the forward
// (per-token loss and logsumexp) and the two backward passes (dx, dW).
//
// Replaces the TPU kernels tiny_deepspeed_tpu/ops/xent_pallas.py::
// pallas_fused_xent (:267; _fwd :115, pallas_call :120, kernel
// _xent_fwd_kernel :80) and ::_bwd (:212; dx pallas_call :218, kernel
// _xent_dx_kernel :171; dW pallas_call :235, kernel _xent_dw_kernel :190).
// Same contract: x (S, D), w (D, V) row-major, targets (S,) int32; logits
// z = x w are f32 and never reach device memory; the forward writes only
// loss = lse - z[target] and lse = logsumexp(z) (S f32 each); the backward
// recomputes each logit tile from lse, dz = (exp(z - lse) - onehot) * g/S
// (gscale, one f32 on the device), and returns dx = dz w^T in x's dtype
// and dW = x^T dz in f32.  Columns >= V are masked to -1e30 before any
// reduction, and the tiles of x and w are zero-filled past S, D and V
// when staged, so the vocab tail never reads past the end of w (the TPU
// kernel's 0 * NaN trap, :155-159, cannot occur).
//
// Bound.  At gpt2-124m training shapes (S = 8192, D = 768, V = 50304,
// bf16) each product is 2 S D V = 0.633 TFLOP against ~90 MB of operands:
// ~7000 flop/byte, far past the card's ~300 flop/byte balance point, so
// all three are bound by tensor-core operations (989 TFLOP/s dense bf16):
// forward 0.64 ms, dx and dW 1.28 ms each (recompute + product).
//
// Design.  The TPU grid runs in order and carries its sums in VMEM
// scratch across grid steps; Hopper CTAs run in parallel and in no order.
// So each CTA owns its outputs outright and walks the reduction dimension
// in a loop (no float atomics: every output is bit-repeatable run to run):
//   * rows kernel, forward and dx: one CTA owns RBM = 32 tokens and walks
//     the vocab in RBN = 64-column tiles.  Forward: online max / sum-exp
//     and the gold pick per row.  dx: dz of the tile, then
//     dx += dz w_tile^T;
//   * dW kernel: one CTA owns CBN = 32 vocab columns and walks the tokens
//     in CBT = 64-row tiles: dz of the tile, then dW += x_tile^T dz.
// Every product is nvcuda::wmma on 16x16 fragments with f32 accumulators:
// bf16 / f16 operands at 16x16x16; f32 operands as 3xTF32 (16x16x8, each
// operand split into a TF32 high part and a TF32 remainder; three
// products keep ~f32 accuracy).  The tensor core's f32 accumulator does
// not round to nearest: adding into a running sum it drops the low bits,
// always toward zero, so over a long walk the error grows with the number
// of adds (measured on an H100: dx 2.7e-4 relative L2 from an f64
// reference over V = 50257, lse 5e-5 at D = 1600).  So each f32 k-step's
// three products go into a fresh fragment, which is then added to the
// running sum with ordinary round-to-nearest f32 adds.  The bf16 / f16
// products accumulate in place: their dz is rounded to 8 or 11 bits
// anyway.  Operands are staged into shared memory
// in KC = 128-deep chunks along D (16-byte loads where aligned and in
// range, element loads on the ragged edges).
//
// The accumulator trap.  dx's (tokens, D) and dW's (D, vocab) f32
// accumulators do not fit one CTA's registers at a wide tile: 32 x 768 or
// 768 x 32 f32 is 96 KB.  Each of the 8 warps keeps 12 accumulator
// fragments (96 registers a thread), which covers 768 columns of dx (or
// rows of dW) for the CTA's 32 tokens (vocab columns).  Wider D splits
// across CTAs (blockIdx.y): gpt2-124m's D = 768 is one split; D = 1600
// takes three, each recomputing the logits.  dz is rounded to the operand
// type before its product, as the JAX chunked path does
// (softmax_xent.py:142).
//
// Residency.  A CTA keeps the operand it reuses in shared memory when it
// fits in 227 KB: the rows kernel keeps its x rows for the whole vocab
// walk and, for dx, the tile's w panel for both the recompute and the
// product; the dW kernel keeps its w columns and each token tile's x
// panel.  Otherwise the chunks stream through one slot and the product
// reloads them.  wgmma, TMA and a pipelined ring of tiles are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 128;          // chunk depth along D
constexpr int SLOTS = 12;        // accumulator fragments per warp
constexpr int CPS = SLOTS / 2;   // D chunks per split (two fragments each)
constexpr int RBM = 32, RBN = 64;   // rows kernel: tokens x vocab tile
constexpr int CBN = 32, CBT = 64;   // dW kernel: vocab x token tile
constexpr int SMEM_MAX = 232448;    // a CTA's dynamic shared memory cap

// -- per-dtype tensor-core step ----------------------------------------------

template <typename T> struct Mma;

template <typename T> struct Mma16 {   // bf16 / f16: one 16x16x16 product
  static constexpr int K = 16;
  using C = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  template <typename LA, typename LB>
  static __device__ __forceinline__ void mma(C& c, const T* a, int lda,
                                             const T* b, int ldb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
};
template <> struct Mma<__nv_bfloat16> : Mma16<__nv_bfloat16> {};
template <> struct Mma<__half> : Mma16<__half> {};

template <> struct Mma<float> {        // f32: 3xTF32 at 16x16x8
  static constexpr int K = 8;
  using C = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  template <typename F>
  static __device__ __forceinline__ void split(F& hi, F& lo) {
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) {
      const float v = hi.x[i];
      const float h = wmma::__float_to_tf32(v);
      hi.x[i] = h;
      lo.x[i] = wmma::__float_to_tf32(v - h);
    }
  }
  template <typename LA, typename LB>
  static __device__ __forceinline__ void mma(C& c, const float* a, int lda,
                                             const float* b, int ldb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, LA>
        ah, al;
    wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, LB>
        bh, bl;
    wmma::load_matrix_sync(ah, a, lda);
    wmma::load_matrix_sync(bh, b, ldb);
    split(ah, al);
    split(bh, bl);
    C t;  // this k-step alone, then a round-to-nearest add into c
    wmma::fill_fragment(t, 0.f);
    wmma::mma_sync(t, al, bh, t);
    wmma::mma_sync(t, ah, bl, t);
    wmma::mma_sync(t, ah, bh, t);
#pragma unroll
    for (int i = 0; i < c.num_elements; ++i) c.x[i] += t.x[i];
  }
};

// shared-memory row padding: 16 bytes, so rows stay 16-byte aligned and
// fragment origins 32-byte aligned
template <typename T> constexpr int kPad = 16 / (int)sizeof(T);

// dst[r][c] (row stride ldd) = src[(r0 + r) * lds + c0 + c] for an R x C
// tile, zero where r0 + r >= rlim or c0 + c >= clim: the one-time and
// streaming loads.  Kept apart from `Staged` below: written through it,
// the forward kernel measured ~13% slower on an H100 (xent_ablate.py).
template <typename T, int R, int C>
__device__ __forceinline__ void load_tile(T* dst, int ldd,
                                          const T* __restrict__ src,
                                          long lds, int r0, int c0, int rlim,
                                          int clim) {
  constexpr int VEC = 16 / (int)sizeof(T);
  static_assert(C % VEC == 0, "tile width in 16-byte vectors");
  constexpr int PER_ROW = C / VEC;
  const bool vec_ok = lds % VEC == 0;
  for (int e = threadIdx.x; e < R * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * ldd + c;
    if (vec_ok && gr < rlim && gc + VEC <= clim) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (size_t)gr * lds + gc);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        d[i] = (gr < rlim && gc + i < clim) ? src[(size_t)gr * lds + gc + i]
                                            : tds::from_f<T>(0.f);
    }
  }
}

// A thread's share of one R x C tile in registers (16-byte vectors, zero
// past rlim / clim): `load` issues the global reads, `store` writes them
// to shared memory, so a chunk's reads can be in flight while the
// previous chunk's products run.
template <typename T, int R, int C>
struct Staged {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int PER_ROW = C / VEC;
  static constexpr int N = R * PER_ROW / THREADS;
  static_assert(C % VEC == 0 && R * PER_ROW % THREADS == 0,
                "whole vectors, the same count per thread");
  uint4 v[N];

  __device__ __forceinline__ void load(const T* __restrict__ src, long lds,
                                       int r0, int c0, int rlim, int clim) {
    const bool vec_ok = lds % VEC == 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int gr = r0 + e / PER_ROW, gc = c0 + (e % PER_ROW) * VEC;
      if (vec_ok && gr < rlim && gc + VEC <= clim) {
        v[i] = *reinterpret_cast<const uint4*>(src + (size_t)gr * lds + gc);
      } else {
        T* t = reinterpret_cast<T*>(&v[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          t[j] = (gr < rlim && gc + j < clim) ? src[(size_t)gr * lds + gc + j]
                                              : tds::from_f<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void store(T* dst, int ldd) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * THREADS;
      *reinterpret_cast<uint4*>(dst + (e / PER_ROW) * ldd +
                                (e % PER_ROW) * VEC) = v[i];
    }
  }
};

// c += d, fragment by fragment (two accumulators of one product)
template <typename Frag>
__device__ __forceinline__ void add_frag(Frag& c, const Frag& d) {
#pragma unroll
  for (int i = 0; i < c.num_elements; ++i) c.x[i] += d.x[i];
}

// one warp writes a 16x16 f32 fragment to out[r][c] (row stride ldo,
// cast to O) for r < rlim, c < clim, through a per-warp 16x16 scratch
template <typename O, typename Frag>
__device__ __forceinline__ void store_frag(O* out, long ldo, int r0, int c0,
                                           int rlim, int clim, const Frag& f,
                                           float* scratch) {
  wmma::store_matrix_sync(scratch, f, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32;
  for (int e = lane; e < 256; e += 32) {
    const int r = r0 + e / 16, c = c0 + e % 16;
    if (r < rlim && c < clim)
      out[(size_t)r * ldo + c] = tds::from_f<O>(scratch[e]);
  }
  __syncwarp();
}

__device__ __forceinline__ float group_max(float v, int width) {
  for (int o = 1; o < width; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = 1; o < width; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// byte offset of each shared-memory region (all multiples of 32 bytes)
struct RowsSmem {
  int xs, ws, zs, dzs, rowf, rowt, total;
};

template <typename T>
__host__ __device__ RowsSmem rows_smem(int nch, int xres, int wres) {
  constexpr int P = kPad<T>;
  RowsSmem s;
  s.xs = 0;
  s.ws = s.xs + (xres ? nch : 1) * RBM * (KC + P) * (int)sizeof(T);
  s.zs = s.ws + (wres ? nch : 1) * KC * (RBN + P) * (int)sizeof(T);
  s.dzs = s.zs + RBM * (RBN + 4) * (int)sizeof(float);
  s.rowf = s.dzs + RBM * (RBN + P) * (int)sizeof(T);
  s.rowt = s.rowf + RBM * (int)sizeof(float);
  s.total = s.rowt + RBM * (int)sizeof(int);
  return s;
}

// -- rows kernels: forward (DX = false) and dx (DX = true) ------------------

template <typename T, bool DX>
__device__ __forceinline__ void xent_rows(
    const T* __restrict__ x, const T* __restrict__ w,
    const int* __restrict__ tgt, const float* __restrict__ lse_in,
    const float* __restrict__ gscale, float* __restrict__ loss,
    float* __restrict__ lse_out, T* __restrict__ dx, int S, int D, int V,
    int xres, int wres) {
  using M = Mma<T>;
  constexpr int P = kPad<T>;
  constexpr int LDX = KC + P, LDW = RBN + P, LDZ = RBN + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nch = (D + KC - 1) / KC;
  const RowsSmem so = rows_smem<T>(nch, xres, wres);
  T* xs = reinterpret_cast<T*>(smem + so.xs);
  T* ws = reinterpret_cast<T*>(smem + so.ws);
  float* zs = reinterpret_cast<float*>(smem + so.zs);
  T* dzs = reinterpret_cast<T*>(smem + so.dzs);
  float* rowf = reinterpret_cast<float*>(smem + so.rowf);
  int* rowt = reinterpret_cast<int*>(smem + so.rowt);

  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * RBM;
  const int split = blockIdx.y;          // dx: which CPS chunks of D
  for (int r = threadIdx.x; r < RBM; r += THREADS) {
    const bool ok = row0 + r < S;
    rowt[r] = ok ? tgt[row0 + r] : -1;
    rowf[r] = (DX && ok) ? lse_in[row0 + r] : 0.f;
  }
  if (xres)
    for (int c = 0; c < nch; ++c)
      load_tile<T, RBM, KC>(xs + c * RBM * LDX, LDX, x, D, row0, c * KC, S,
                            D);
  __syncthreads();

  // epilogue layout: 8 threads per row, 8 columns each
  const int er = threadIdx.x / 8, ec = (threadIdx.x % 8) * 8;
  const int tg = rowt[er];
  const bool row_ok = row0 + er < S;
  const float lse_r = rowf[er];
  const float gs = DX ? *gscale : 0.f;
  float run_m = tds::kMasked, run_l = 0.f, run_g = 0.f;

  typename M::C acc[DX ? SLOTS : 1];
  if (DX) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) wmma::fill_fragment(acc[s], 0.f);
  }
  // this warp's logit fragment: rows zr.., columns zc.. of the tile
  const int zr = (warp / 4) * 16, zc = (warp % 4) * 16;

  const int ntile = (V + RBN - 1) / RBN;
  // the w chunks in order (tile jt, chunk c), each prefetched into
  // registers while the previous one's products run
  Staged<T, KC, RBN> next;
  next.load(w, V, 0, 0, D, V);
  for (int jt = 0; jt < ntile; ++jt) {
    const int j0 = jt * RBN;
    typename M::C zf[2];  // even / odd k steps: two independent chains
    wmma::fill_fragment(zf[0], 0.f);
    wmma::fill_fragment(zf[1], 0.f);
    for (int c = 0; c < nch; ++c) {
      T* xc = xs + (xres ? c : 0) * RBM * LDX;
      T* wc = ws + (wres ? c : 0) * KC * LDW;
      __syncthreads();  // the slots' previous readers are done
      if (!xres)
        load_tile<T, RBM, KC>(xc, LDX, x, D, row0, c * KC, S, D);
      next.store(wc, LDW);
      __syncthreads();
      if (c + 1 < nch)
        next.load(w, V, (c + 1) * KC, j0, D, V);
      else if (jt + 1 < ntile)
        next.load(w, V, 0, j0 + RBN, D, V);
#pragma unroll
      for (int k = 0; k < KC; k += M::K)
        M::template mma<wmma::row_major, wmma::row_major>(
            zf[(k / M::K) & 1], xc + zr * LDX + k, LDX, wc + k * LDW + zc,
            LDW);
    }
    add_frag(zf[0], zf[1]);
    wmma::store_matrix_sync(zs + zr * LDZ + zc, zf[0], LDZ,
                            wmma::mem_row_major);
    __syncthreads();

    const float* zrow = zs + er * LDZ;
    if (!DX) {
      // online logsumexp over the tile's columns < V, and the gold logit
      float v[8], tmax = tds::kMasked;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = j0 + ec + i < V ? zrow[ec + i] : tds::kMasked;
        tmax = fmaxf(tmax, v[i]);
      }
      const float m_new = fmaxf(run_m, group_max(tmax, 8));
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += expf(v[i] - m_new);
      run_l = run_l * expf(run_m - m_new) + group_sum(s, 8);
      run_m = m_new;
      if (tg >= j0 + ec && tg < j0 + ec + 8 && tg < V)
        run_g += zrow[tg - j0];
      continue;
    }

    // dx: dz = (exp(z - lse) - onehot) * g/S, rounded to T
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = j0 + ec + i;
      float p = 0.f;
      if (row_ok && col < V) {
        p = expf(zrow[ec + i] - lse_r);
        if (col == tg) p -= 1.f;
      }
      dzs[er * LDW + ec + i] = tds::from_f<T>(p * gs);
    }
    // dx[:, chunk c] += dz w[chunk c, tile]^T: warp owns 16 columns of
    // each of its split's chunks, both 16-row halves
#pragma unroll
    for (int cc = 0; cc < CPS; ++cc) {
      const int c = split * CPS + cc;
      if (c < nch) {
        T* wc = ws + (wres ? c : 0) * KC * LDW;
        __syncthreads();  // dz written; the slot's readers are done
        if (!wres) {
          load_tile<T, KC, RBN>(wc, LDW, w, V, c * KC, j0, D, V);
          __syncthreads();
        }
#pragma unroll
        for (int k = 0; k < RBN; k += M::K)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            M::template mma<wmma::row_major, wmma::col_major>(
                acc[cc * 2 + h], dzs + h * 16 * LDW + k, LDW,
                wc + warp * 16 * LDW + k, LDW);
      }
    }
  }

  if (!DX) {
    const float g = group_sum(run_g, 8);
    if (row_ok && ec == 0) {
      const float l = run_m + logf(run_l);
      lse_out[row0 + er] = l;
      loss[row0 + er] = l - g;
    }
    return;
  }
  __syncthreads();  // zs is free: reuse it as per-warp store scratch
  float* scratch = zs + warp * 256;
#pragma unroll
  for (int cc = 0; cc < CPS; ++cc) {
    const int c = split * CPS + cc;
    if (c < nch) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_frag<T>(dx, D, row0 + h * 16, c * KC + warp * 16, S, D,
                      acc[cc * 2 + h], scratch);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ tgt, float* __restrict__ loss,
                float* __restrict__ lse, int S, int D, int V, int xres) {
  xent_rows<T, false>(x, w, tgt, nullptr, nullptr, loss, lse, nullptr, S, D,
                      V, xres, 0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
xent_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ tgt, const float* __restrict__ lse,
               const float* __restrict__ gscale, T* __restrict__ dx, int S,
               int D, int V, int xres, int wres) {
  xent_rows<T, true>(x, w, tgt, lse, gscale, nullptr, nullptr, dx, S, D, V,
                     xres, wres);
}

// -- dW kernel --------------------------------------------------------------

struct ColsSmem {
  int xs, ws, zs, dzs, rowf, rowt, total;
};

template <typename T>
__host__ __device__ ColsSmem cols_smem(int nch, int xres, int wres) {
  constexpr int P = kPad<T>;
  ColsSmem s;
  s.xs = 0;
  s.ws = s.xs + (xres ? nch : 1) * CBT * (KC + P) * (int)sizeof(T);
  s.zs = s.ws + (wres ? nch : 1) * KC * (CBN + P) * (int)sizeof(T);
  // zs doubles as the 8 warps' 16x16 store scratch at the end
  const int zbytes = CBT * (CBN + 4) * (int)sizeof(float);
  s.dzs = s.zs + (zbytes > WARPS * 1024 ? zbytes : WARPS * 1024);
  s.rowf = s.dzs + CBT * (CBN + P) * (int)sizeof(T);
  s.rowt = s.rowf + CBT * (int)sizeof(float);
  s.total = s.rowt + CBT * (int)sizeof(int);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
xent_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ tgt, const float* __restrict__ lse_in,
               const float* __restrict__ gscale, float* __restrict__ dw,
               int S, int D, int V, int xres, int wres) {
  using M = Mma<T>;
  constexpr int P = kPad<T>;
  constexpr int LDX = KC + P, LDW = CBN + P, LDZ = CBN + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nch = (D + KC - 1) / KC;
  const ColsSmem so = cols_smem<T>(nch, xres, wres);
  T* xs = reinterpret_cast<T*>(smem + so.xs);
  T* ws = reinterpret_cast<T*>(smem + so.ws);
  float* zs = reinterpret_cast<float*>(smem + so.zs);
  T* dzs = reinterpret_cast<T*>(smem + so.dzs);
  float* rowf = reinterpret_cast<float*>(smem + so.rowf);
  int* rowt = reinterpret_cast<int*>(smem + so.rowt);

  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * CBN;
  const int split = blockIdx.y;          // which CPS chunks of D
  if (wres)
    for (int c = 0; c < nch; ++c)
      load_tile<T, KC, CBN>(ws + c * KC * LDW, LDW, w, V, c * KC, j0, D, V);

  // epilogue layout: 4 threads per token row, 8 columns each
  const int er = threadIdx.x / 4, ec = (threadIdx.x % 4) * 8;
  const float gs = *gscale;
  typename M::C acc[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) wmma::fill_fragment(acc[s], 0.f);
  const int zr = (warp / 2) * 16, zc = (warp % 2) * 16;

  // the x chunks in order (token tile, chunk c), each prefetched into
  // registers while the previous one's products run
  Staged<T, CBT, KC> next;
  next.load(x, D, 0, 0, S, D);
  for (int t0 = 0; t0 < S; t0 += CBT) {
    typename M::C zf[2];  // even / odd k steps: two independent chains
    wmma::fill_fragment(zf[0], 0.f);
    wmma::fill_fragment(zf[1], 0.f);
    for (int c = 0; c < nch; ++c) {
      T* xc = xs + (xres ? c : 0) * CBT * LDX;
      T* wc = ws + (wres ? c : 0) * KC * LDW;
      __syncthreads();  // the slots' (and the row stats') readers are done
      if (c == 0)
        for (int r = threadIdx.x; r < CBT; r += THREADS) {
          const bool ok = t0 + r < S;
          rowt[r] = ok ? tgt[t0 + r] : -1;
          rowf[r] = ok ? lse_in[t0 + r] : 0.f;
        }
      next.store(xc, LDX);
      if (!wres)
        load_tile<T, KC, CBN>(wc, LDW, w, V, c * KC, j0, D, V);
      __syncthreads();
      if (c + 1 < nch)
        next.load(x, D, t0, (c + 1) * KC, S, D);
      else if (t0 + CBT < S)
        next.load(x, D, t0 + CBT, 0, S, D);
#pragma unroll
      for (int k = 0; k < KC; k += M::K)
        M::template mma<wmma::row_major, wmma::row_major>(
            zf[(k / M::K) & 1], xc + zr * LDX + k, LDX, wc + k * LDW + zc,
            LDW);
    }
    add_frag(zf[0], zf[1]);
    wmma::store_matrix_sync(zs + zr * LDZ + zc, zf[0], LDZ,
                            wmma::mem_row_major);
    __syncthreads();

    {
      const int tg = rowt[er];
      const float lse_r = rowf[er];
      const bool row_ok = t0 + er < S;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = j0 + ec + i;
        float p = 0.f;
        if (row_ok && col < V) {
          p = expf(zs[er * LDZ + ec + i] - lse_r);
          if (col == tg) p -= 1.f;
        }
        dzs[er * LDW + ec + i] = tds::from_f<T>(p * gs);
      }
    }
    // dW[chunk c, tile] += x[tokens, chunk c]^T dz: warp owns 16 rows of
    // each of its split's chunks, both 16-column halves
#pragma unroll
    for (int cc = 0; cc < CPS; ++cc) {
      const int c = split * CPS + cc;
      if (c < nch) {
        T* xc = xs + (xres ? c : 0) * CBT * LDX;
        __syncthreads();  // dz written; the slot's readers are done
        if (!xres) {
          load_tile<T, CBT, KC>(xc, LDX, x, D, t0, c * KC, S, D);
          __syncthreads();
        }
#pragma unroll
        for (int k = 0; k < CBT; k += M::K)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            M::template mma<wmma::col_major, wmma::row_major>(
                acc[cc * 2 + h], xc + k * LDX + warp * 16, LDX,
                dzs + k * LDW + h * 16, LDW);
      }
    }
  }

  __syncthreads();  // zs is free: reuse it as per-warp store scratch
  float* scratch = zs + warp * 256;
#pragma unroll
  for (int cc = 0; cc < CPS; ++cc) {
    const int c = split * CPS + cc;
    if (c < nch) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_frag<float>(dw, V, c * KC + warp * 16, j0 + h * 16, D, V,
                          acc[cc * 2 + h], scratch);
    }
  }
}

// -- launch -----------------------------------------------------------------

struct Args {
  const void *x, *w;
  const int* tgt;
  const float *lse_in, *gscale;
  float *loss, *lse_out, *dw;
  void* dx;
  int S, D, V;
  cudaStream_t stream;
};

enum Pass { kFwd, kDx, kDw };

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
cudaError_t launch(Pass pass, const Args& a) {
  const int nch = (a.D + KC - 1) / KC;
  const int nsplit = (nch + CPS - 1) / CPS;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  // residency, most reuse first: {x resident, w resident}
  const int prefs[4][2] = {{1, 1}, {1, 0}, {0, 1}, {0, 0}};
  for (const auto& pr : prefs) {
    const int xres = pr[0], wres = pr[1];
    if (pass == kFwd && wres) continue;  // no product reuses w
    const int smem = pass == kDw ? cols_smem<T>(nch, xres, wres).total
                                 : rows_smem<T>(nch, xres, wres).total;
    if (smem > SMEM_MAX) continue;
    cudaError_t err;
    if (pass == kDw) {
      err = allow_smem(xent_dw_kernel<T>, smem);
      if (err != cudaSuccess) return err;
      dim3 grid((a.V + CBN - 1) / CBN, nsplit);
      xent_dw_kernel<T><<<grid, THREADS, smem, a.stream>>>(
          x, w, a.tgt, a.lse_in, a.gscale, a.dw, a.S, a.D, a.V, xres, wres);
    } else if (pass == kDx) {
      err = allow_smem(xent_dx_kernel<T>, smem);
      if (err != cudaSuccess) return err;
      dim3 grid((a.S + RBM - 1) / RBM, nsplit);
      xent_dx_kernel<T><<<grid, THREADS, smem, a.stream>>>(
          x, w, a.tgt, a.lse_in, a.gscale, static_cast<T*>(a.dx), a.S, a.D,
          a.V, xres, wres);
    } else {
      err = allow_smem(xent_fwd_kernel<T>, smem);
      if (err != cudaSuccess) return err;
      dim3 grid((a.S + RBM - 1) / RBM, 1);
      xent_fwd_kernel<T><<<grid, THREADS, smem, a.stream>>>(
          x, w, a.tgt, a.loss, a.lse_out, a.S, a.D, a.V, xres);
    }
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;  // not even the streaming layout fits
}

cudaError_t dispatch(int dtype, Pass pass, const Args& a) {
  if (a.S <= 0 || a.V <= 0 || a.D <= 0 || a.D % 32)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case tds::kF32: return launch<float>(pass, a);
    case tds::kBF16: return launch<__nv_bfloat16>(pass, a);
    case tds::kF16: return launch<__half>(pass, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (S, D) and w (D, V) contiguous, one dtype (tds::DType); targets (S,)
// int32; loss and lse (S,) f32.  Returns the launch's cudaError_t.
extern "C" int fused_xent_fwd(const void* x, const void* w, const int* tgt,
                              float* loss, float* lse, int S, int D, int V,
                              int dtype, void* stream) {
  Args a{x, w, tgt, nullptr, nullptr, loss, lse, nullptr, nullptr, S, D, V,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kFwd, a);
}

// as fused_xent_fwd, with the forward's lse (S,) f32 and gscale (one f32,
// the upstream gradient over S); dx (S, D) in x's dtype.
extern "C" int fused_xent_dx(const void* x, const void* w, const int* tgt,
                             const float* lse, const float* gscale, void* dx,
                             int S, int D, int V, int dtype, void* stream) {
  Args a{x, w, tgt, lse, gscale, nullptr, nullptr, nullptr, dx, S, D, V,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kDx, a);
}

// as fused_xent_dx; dw (D, V) f32.
extern "C" int fused_xent_dw(const void* x, const void* w, const int* tgt,
                             const float* lse, const float* gscale, float* dw,
                             int S, int D, int V, int dtype, void* stream) {
  Args a{x, w, tgt, lse, gscale, nullptr, nullptr, dw, nullptr, S, D, V,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kDw, a);
}
