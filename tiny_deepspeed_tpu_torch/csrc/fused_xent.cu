// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// Fused lm_head + softmax cross-entropy for Hopper (sm_90a): the forward
// (per-token loss and logsumexp) and the two backward passes (dx, dW).
// bf16/f16 run all three on the tensor cores (wgmma); f32 keeps wmma
// (3xTF32) for all three.
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
// kernel's 0 * NaN trap, :155-159, cannot occur).  The bf16/f16 forward
// and dx take w as its transpose w^T (V, D) row-major, through entries
// of their own (below); f32 and dW take w (D, V).
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
//   * forward and dx: one CTA owns a block of tokens and walks the vocab.
//     Forward: online max / sum-exp and the gold pick per row.  dx: dz of
//     the tile, then dx += dz w_tile^T;
//   * dW: one CTA owns a block of vocab columns and walks the tokens in
//     tiles: dz of the tile, then dW += x_tile^T dz.
// dz is rounded to the operand type before its product, as the JAX
// chunked path does (softmax_xent.py:142).
//
// Forward and dx, bf16/f16 (`tc::xent_fwd_wgmma`, `tc::xent_dx_wgmma`:
// one device function, `xent_rows_tc`).  A CTA of two warpgroups owns TM =
// 64 tokens (wgmma's M) and walks the vocab in BN = 32-row tiles of w^T;
// D is cut into 64-wide chunks, each a swizzled 128-byte-row tile
// (hopper.cuh).  Why w^T: w's own rows put a 32-column tile's D rows
// 100 KB apart, 64 bytes each: half a 128-byte line a request.  A w^T
// tile's 32 rows are D contiguous elements: whole lines, half the
// requests for the same bytes of the one operand that streams (a first
// version that read w was slower in both passes, PERF.md).
// Their entries are fused_xent_fwd_wt and fused_xent_dx_wt (the f32
// entries fused_xent_fwd / _dx and every dtype's fused_xent_dw read w);
// FusedXentFn makes w^T once a step for both passes (ops/fused_xent.py):
// a copy for an untied head, a free view of a tied one's wte.  Per tile:
//   Z = x w_tile (64 tokens x 32 vocab): wgmma m64n32k16, the x chunk A
//     and the w^T chunk B, both K-major in shared memory; warpgroup g
//     takes k-steps 2g, 2g+1 of every chunk, and the two f32 partial tiles
//     meet in shared memory (8 KB each): z = own + other in both, the same
//     bits (addition commutes);
//   dx: dZ = (exp(Z - lse) - onehot) g/S in registers, 0 past V and S,
//     rounded to T is the A operand of dx[:, chunk] += dZ w^T_chunk
//     (wgmma m64n64k16, A from registers), the w^T chunk the B operand
//     MN-major (transpose bit: the 32 vocab rows are the contraction), 2
//     k-steps; dZ never passes through shared memory;
//   forward: warpgroup g reduces the tile's columns 16g..16g+15 (half its
//     fragment, so the exchange swaps only halves): max over the row's
//     quad (two shuffles), sum-exp per thread, the gold logit by column
//     match; the two warpgroups' (max, sum-exp, gold) per row meet once
//     at the end, in a fixed order.
// Each thread keeps its two rows' lse and target in registers for the
// whole walk.  The accumulator trap: dx for 64 tokens x D = 768 in f32 is
// 384 a thread of one warpgroup, so warpgroup g accumulates half the
// CTA's chunks (at most CPW = 6: 192 f32, 252 registers, no spills).
// Shared memory: x resident (64 x 768: 96 KB), the w^T tile (32 x 768:
// 48 KB) in two cp.async stages, the exchange (16 KB): 214016 bytes at D
// = 768, one CTA an SM; resident up to D = 832.  Wider, x streams chunk
// by chunk through two slots behind one w^T stage (136192 bytes at D =
// 1600; fused_xent_fwd_smem_bytes / fused_xent_dx_smem_bytes report
// either) and a warpgroup accumulates at most 4 chunks (at 6 ptxas
// spilled in that loop); dx cuts D into slices across CTAs (blockIdx.y),
// each recomputing the logits over all of D (D = 1600: 4 slices).  The
// copy of tile j+1 is issued right behind tile j's recompute wgmmas, so
// it lands during that recompute, the exchange, the epilogue and dx's
// product.  L2 reads a call: every CTA reads all of w^T once, ceil(S/64)
// x D V 2 bytes = 128 x 77.3 MB = 9.9 GB at gpt2-124m, in whole lines;
// 128 CTAs fill 128 of the 132 SMs.  PERF.md has the times and
// xent_ablate.py the split of each kernel's.
//
// dW, bf16/f16 (`tc::xent_dw_wgmma`, wgmma).  A CTA owns BV = 64 vocab
// columns (wgmma's M) and walks the tokens in TT = 32-token tiles; D is
// cut into 64-wide chunks, each a swizzled 128-byte-row tile
// (hopper.cuh).  Per token tile:
//   Z^T = w_blk^T x_tile^T (64 vocab x 32 tokens): wgmma m64n32k16, the
//     w chunk the A operand MN-major in shared memory (transpose bit: w is
//     (D, V) row-major), the x chunk the B operand K-major;
//   dZ^T = (exp(Z^T - lse) - onehot) g/S in registers, 0 past V and S;
//   dW^T[:, chunk] += dZ^T x_chunk: dZ^T rounded to T in registers is the
//     A operand (wgmma m64n64k16, A from registers), the x chunk the B
//     operand MN-major (transpose bit): 2 k-steps of 16 tokens.
// dZ never passes through shared memory.  The x tiles (all of D) with
// their lse and target slices come through a cp.async ring of two stages,
// one tile ahead of the compute; the w block (D x 64) stays resident for
// the whole walk when it fits with them (D <= 832: 214528 bytes of
// dynamic shared memory at D = 768), else it streams chunk by chunk
// through two slots behind a single x stage (136448 bytes at D = 1600;
// fused_xent_dw_smem_bytes reports either).  w rows that are not 16-byte
// aligned (V % 8 != 0) are copied element by element instead.
//
// The accumulator trap, dW's: dW^T for 64 vocab columns x D = 768 is 384
// f32 a thread of one warpgroup, more than its registers.  So the CTA
// runs two warpgroups, each accumulating half of the CTA's chunks (at most
// CPW = 6, 192 f32 a thread), and they share one recompute per tile as
// the forward and dx do.  ptxas: 248-254 registers, no spills; one CTA an
// SM.  D > 768 (more than 2 x CPW chunks) is cut into slices across CTAs
// (blockIdx.y), each recomputing the logits over all of D: at D = 1600,
// three slices do 3 recomputes + 1 product = 4 x 2SDV against the
// bound's 2 x 2SDV, so that width runs at most at half its bound.  L2
// reads a call: every CTA reads all of x once, ceil(V/64) x S x D x 2
// bytes = 786 x 12.6 MB = 9.9 GB at gpt2-124m (the f32 kernel's
// 32-column blocks read twice that), plus the w block once.
//
// Forward, dx, and dW for f32 (`xent_fwd_kernel`, `xent_dx_kernel`,
// `xent_dw_kernel`: nvcuda::wmma on 16x16x8 fragments with f32
// accumulators): f32 operands as 3xTF32 (each operand split into a TF32
// high part and a TF32 remainder; three products keep ~f32 accuracy).
// The tensor core's f32 accumulator does not round to nearest: adding
// into a running sum it drops the low bits, always toward zero, so over a
// long walk the error grows with the number of adds (measured on an H100:
// dx 2.7e-4 relative L2 from an f64 reference over V = 50257, lse 5e-5 at
// D = 1600).  So each k-step's three products go into a fresh fragment,
// which is then added to the running sum with ordinary round-to-nearest
// f32 adds.  Operands are staged into shared memory in KC = 128-deep
// chunks along D (16-byte loads where aligned and in range, element loads
// on the ragged edges).  The forward and dx ("rows kernel") own RBM = 32
// tokens and walk the vocab in RBN = 64-column tiles; dW owns CBN = 32
// vocab columns and walks the tokens in CBT = 64-row tiles.
//
// The wmma kernels' accumulators: dx's (tokens, D) and dW's (D, vocab)
// f32 accumulators do not fit one CTA's registers at a wide tile: 32 x
// 768 or 768 x 32 f32 is 96 KB.  Each of the 8 warps keeps 12 accumulator
// fragments (96 registers a thread), which covers 768 columns of dx (or
// rows of dW) for the CTA's 32 tokens (vocab columns).  Wider D splits
// across CTAs (blockIdx.y): gpt2-124m's D = 768 is one split; D = 1600
// takes three, each recomputing the logits.
//
// Residency (wmma kernels).  A CTA keeps the operand it reuses in shared
// memory when it fits in 227 KB: the rows kernel keeps its x rows for the
// whole vocab walk and, for dx, the tile's w panel for both the
// recompute and the product; the f32 dW kernel keeps its w columns and
// each token tile's x panel.  Otherwise the chunks stream through one
// slot and the product reloads them.

#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

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

template <typename T> struct Mma;      // f32 only: bf16/f16 run on wgmma

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

// -- dW, bf16 / f16: tensor cores -------------------------------------------

namespace tc {

using namespace tds::sm90;

constexpr int WGS = 2;                 // warpgroups a CTA
constexpr int THREADS = 128 * WGS;
constexpr int BV = 64;                 // vocab columns a CTA (wgmma M)
constexpr int TT = 32;                 // tokens a tile
constexpr int CW = 64;                 // a chunk of D: one 128-byte tile row
constexpr int CPW = 6;                 // most chunks a warpgroup accumulates
constexpr int WTILE = CW * BV * 2;     // w chunk: 64 rows of D x 64 vocab
constexpr int XTILE = TT * CW * 2;     // x chunk: 32 tokens x 64 of D
constexpr int XCH = 16 * 128 * 4;      // a warpgroup's partial logits
constexpr int WSLOTS = 2;              // the w ring when the block streams

struct DwSmem {
  int x, xch, stats, total, xstages;
  bool wres;
};

// byte offsets from the 1024-aligned base, where the w block or slots
// start (+1024 in `total` to align it): the whole w block resident and x
// in two stages when that fits, else w streaming through WSLOTS slots
// and x in one stage
__host__ __device__ inline DwSmem dw_smem(int nch) {
  DwSmem s{};
  for (int wres = 1; wres >= 0; --wres) {
    s.wres = wres;
    s.xstages = wres ? 2 : 1;
    s.x = (wres ? nch : WSLOTS) * WTILE;
    s.xch = s.x + s.xstages * nch * XTILE;
    s.stats = s.xch + WGS * XCH;
    s.total = s.stats + s.xstages * TT * 8 + 1024;
    if (s.total <= SMEM_MAX) break;
  }
  return s;
}

// the w chunk load_tile_rc would copy, element by element through
// registers: for a V whose rows are not 16-byte aligned
template <typename T>
__device__ __forceinline__ void load_w_scalar(unsigned char* dst,
                                              const T* __restrict__ w,
                                              int r0, int D, int j0, int V) {
  for (int e = threadIdx.x; e < CW * BV; e += THREADS) {
    const int r = e / BV, c = e % BV;
    const bool ok = r0 + r < D && j0 + c < V;
    *reinterpret_cast<T*>(dst + swz<64>(r, c)) =
        ok ? w[(size_t)(r0 + r) * V + j0 + c] : tds::from_f<T>(0.f);
  }
}

template <typename T, bool WRES>
__global__ void __launch_bounds__(THREADS, 1)
xent_dw_wgmma(const T* __restrict__ x, const T* __restrict__ w,
              const int* __restrict__ tgt, const float* __restrict__ lse_in,
              const float* __restrict__ gscale, float* __restrict__ dw,
              int S, int D, int V) {
  extern __shared__ unsigned char smem_raw[];
  const int nch = (D + CW - 1) / CW;
  const DwSmem L = dw_smem(nch);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_p = smem_raw + (base - raw);
  auto wt = [&](int slot) { return base + slot * WTILE; };
  auto xt = [&](int st, int c) {
    return base + L.x + (st * nch + c) * XTILE;
  };
  float* xch = reinterpret_cast<float*>(base_p + L.xch);

  const int j0 = blockIdx.x * BV;
  // this CTA's slice of D: chunks [cs0, cs1); warpgroup g accumulates
  // [my0, my1), at most CPW of them
  const int cs0 = blockIdx.y * nch / gridDim.y;
  const int cs1 = (blockIdx.y + 1) * nch / gridDim.y;
  const int half = (cs1 - cs0 + 1) / 2;
  const int g = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int my0 = g ? cs0 + half : cs0, my1 = g ? cs1 : cs0 + half;
  const int ntiles = (S + TT - 1) / TT;
  const bool wvec = V % 8 == 0;

  // w rows [64c, 64c + 64) x vocab [j0, j0 + 64) -> slot
  auto load_w = [&](int c, int slot) {
    if (wvec)
      load_tile_rc<T, CW, THREADS>(wt(slot), w, c * CW, D, j0, V, V);
    else
      load_w_scalar<T>(base_p + slot * WTILE, w, c * CW, D, j0, V);
  };
  // tile it's tokens, all of D, and their lse and targets -> stage st
  auto load_x = [&](int it, int st) {
    const int t0 = it * TT;
    for (int c = 0; c < nch; ++c)
      load_tile_rc<T, TT, THREADS>(xt(st, c), x, t0, S, c * CW, D, D);
    if (threadIdx.x < 2 * TT) {
      const int r = threadIdx.x % TT;
      const bool ok = t0 + r < S;
      const void* src = threadIdx.x < TT
                            ? (const void*)(lse_in + (ok ? t0 + r : 0))
                            : (const void*)(tgt + (ok ? t0 + r : 0));
      cp_async4(base + L.stats + (st * 2 * TT + threadIdx.x) * 4, src, ok);
    }
  };

  if (WRES) {
    for (int c = 0; c < nch; ++c) load_w(c, c);
  } else {
    load_w(0, 0);
  }
  load_x(0, 0);
  cp_async_commit();

  const float gs = *gscale;
  const int warp = tid / 32, lane = tid % 32;
  const int vrow = j0 + 16 * warp + lane / 4;      // vocab vrow, vrow + 8
  const int col0 = 2 * (lane % 4);                 // + 8j + e: token or D
  float acc[CPW][32];
#pragma unroll
  for (int i = 0; i < CPW; ++i)
#pragma unroll
    for (int n = 0; n < 32; ++n) acc[i][n] = 0.f;

  int q = 0;  // streamed w: chunks consumed so far (slot q % WSLOTS)
  for (int it = 0; it < ntiles; ++it) {
    const int st = WRES ? it % 2 : 0;
    if (WRES) {
      if (it + 1 < ntiles) load_x(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile it (and the w block) landed
      fence_proxy_async();
      __syncthreads();
    } else if (it > 0) {
      load_x(it, 0);  // the barrier ending tile it - 1 freed the stage
      cp_async_commit();
    }

    // Z^T (BV vocab x TT tokens) = w_blk^T x_tile^T, this warpgroup's
    // share: k-steps 2g and 2g + 1 of every chunk
    float z[16];
    if (WRES) {
      wgmma_fence();
      for (int c = 0; c < nch; ++c) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss_n32_ta<T>(z, desc_mn<CW>(wt(c), 2 * g + kk),
                             desc_k<CW>(xt(st, c), 2 * g + kk), c + kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(z);
    } else {
      for (int c = 0; c < nch; ++c, ++q) {
        if (c + 1 < nch || it + 1 < ntiles)
          load_w(c + 1 < nch ? c + 1 : 0, (q + 1) % WSLOTS);
        cp_async_commit();
        cp_async_wait<1>();  // chunk c (and the x tile) landed
        fence_proxy_async();
        __syncthreads();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss_n32_ta<T>(z, desc_mn<CW>(wt(q % WSLOTS), 2 * g + kk),
                             desc_k<CW>(xt(0, c), 2 * g + kk), c + kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(z);
        __syncthreads();  // the slot is free for the copy two chunks ahead
      }
    }

    // the two halves of the contraction: z = own + other's, the same sum
    // in both warpgroups (f32 addition commutes)
    float* mine = xch + g * (16 * 128);
    const float* other = xch + (1 - g) * (16 * 128);
#pragma unroll
    for (int i = 0; i < 16; ++i) mine[i * 128 + tid] = z[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) z[i] += other[i * 128 + tid];

    // dZ^T = (exp(Z^T - lse) - onehot) g/S, 0 past V and S
    const int t0 = it * TT;
    const float* lse_s =
        reinterpret_cast<const float*>(base_p + L.stats) + st * 2 * TT;
    const int* tgt_s = reinterpret_cast<const int*>(lse_s + TT);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int tok = 8 * (i / 4) + col0 + i % 2;
      const int v = vrow + 8 * ((i / 2) % 2);
      float p = expf(z[i] - lse_s[tok]);
      if (v == tgt_s[tok]) p -= 1.f;
      z[i] = v < V && t0 + tok < S ? p * gs : 0.f;
    }

    // dW^T[:, my chunks] += dZ^T x_tile: dZ^T rounded to T in registers is
    // the A operand, the x chunks MN-major B operands (transpose bit)
    uint32_t a[2][4];
    acc_to_a<T>(z, 0, a[0]);
    acc_to_a<T>(z, 1, a[1]);
#pragma unroll
    for (int i = 0; i < CPW; ++i) fence_regs(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      if (my0 + i < my1) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs<T, CW>(acc[i], a[kk], desc_mn<CW>(xt(st, my0 + i), kk),
                          1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < CPW; ++i) fence_regs(acc[i]);
    __syncthreads();  // stage st and the exchange buffers are free
  }

#pragma unroll
  for (int i = 0; i < CPW; ++i) {
    const int c = my0 + i;
    if (c < my1) {
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int d = c * CW + 8 * (n / 4) + col0 + n % 2;
        const int v = vrow + 8 * ((n / 2) % 2);
        if (d < D && v < V) dw[(size_t)d * V + v] = acc[i][n];
      }
    }
  }
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* w, const int* tgt,
                      const float* lse, const float* gscale, float* dw,
                      int S, int D, int V, cudaStream_t stream) {
  const int nch = (D + CW - 1) / CW;
  const DwSmem L = dw_smem(nch);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = L.wres ? xent_dw_wgmma<T, true> : xent_dw_wgmma<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  // slices of at most 2 * CPW chunks: one at D <= 768
  dim3 grid((V + BV - 1) / BV, (nch + 2 * CPW - 1) / (2 * CPW));
  kernel<<<grid, THREADS, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), tgt, lse, gscale,
      dw, S, D, V);
  return cudaGetLastError();
}

// -- forward and dx, bf16 / f16: tensor cores -------------------------------

constexpr int TM = 64;                 // tokens a CTA (wgmma M)
constexpr int BN = 32;                 // vocab rows of w^T a tile
constexpr int RXT = TM * CW * 2;       // x chunk: 64 tokens x 64 of D
constexpr int RWT = BN * CW * 2;       // w^T chunk: 32 vocab x 64 of D
constexpr int ZCH = 16 * 128 * 4;      // a warpgroup's partial logits
constexpr int CPW_STREAM = 4;          // CPW when x streams (D > 832)

// chunks a warpgroup accumulates: CPW with x resident; fewer when x
// streams, whose loop holds more registers (at 6, ptxas spilled)
__host__ __device__ constexpr int rows_cpw(bool xres) {
  return xres ? CPW : CPW_STREAM;
}

struct RowsTcSmem {
  int x, xch, total;
  bool xres;
};

// byte offsets from the 1024-aligned base, where the w tiles start (+1024
// in `total` to align it): x resident and the w tile (all of D x BN) in
// two stages when that fits (D <= 832), else one w stage and x streaming
// chunk by chunk through two slots
__host__ __device__ inline RowsTcSmem rows_tc_smem(int nch) {
  RowsTcSmem s{};
  for (int xres = 1; xres >= 0; --xres) {
    s.xres = xres;
    s.x = (xres ? 2 : 1) * nch * RWT;
    s.xch = s.x + (xres ? nch : 2) * RXT;
    s.total = s.xch + WGS * ZCH + 1024;
    if (s.total <= SMEM_MAX) break;
  }
  return s;
}

// The forward's running statistics of a thread's two rows (row0, row0 +
// 8) over its warpgroup's half of every tile's columns (fragment columns
// 16g..16g+15: z[8g..8g+7]): max, sum-exp and the gold logit
struct FwdStats {
  float m[2] = {tds::kMasked, tds::kMasked}, l[2] = {0.f, 0.f};
  float gold[2] = {0.f, 0.f};

  // one tile: z, this warpgroup's partial logits of vocab columns j0 +
  // 8j + col0 + e, meets the other warpgroup's through `xch` (each swaps
  // only the half the other reduces), then the online logsumexp along
  // the rows (max over the row's quad) and the gold pick
  __device__ __forceinline__ void tile(const float (&z)[16], float* xch,
                                       int g, int tid, int j0, int col0,
                                       int V, const int (&tg)[2]) {
    float* mine = xch + g * (16 * 128);
    const float* other = xch + (1 - g) * (16 * 128);
#pragma unroll
    for (int i = 0; i < 8; ++i)  // the other's columns
      mine[i * 128 + tid] = g ? z[i] : z[8 + i];
    __syncthreads();
    float zz[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = j0 + 8 * (i / 4 + 2 * g) + col0 + i % 2;
      const float own = g ? z[8 + i] : z[i];
      zz[i] = col < V ? own + other[i * 128 + tid] : tds::kMasked;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = fmaxf(fmaxf(zz[2 * h], zz[2 * h + 1]),
                       fmaxf(zz[4 + 2 * h], zz[5 + 2 * h]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[h], mt);
      float s = l[h] * exp2f((m[h] - mn) * kLog2e);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * q + 2 * h + e;
          s += exp2f((zz[i] - mn) * kLog2e);
          if (j0 + 8 * (q + 2 * g) + col0 + e == tg[h]) gold[h] += zz[i];
        }
      l[h] = s;
      m[h] = mn;
    }
  }

  // after the walk: each warpgroup's (max, sum-exp, gold) per row over
  // its columns; warpgroup 1's meet warpgroup 0's in shared memory and
  // are merged in that order; loss and lse of rows < S
  __device__ __forceinline__ void finish(float* xch, int g, int lane,
                                         int row0, int t0, int S,
                                         float* __restrict__ loss,
                                         float* __restrict__ lse_out) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
        gold[h] += __shfl_xor_sync(0xffffffffu, gold[h], o);
      }
    }
    __syncthreads();  // the exchange buffers are free
    if (g == 1 && lane % 4 == 0) {  // 64 rows x (m, l, gold)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = xch + 3 * (row0 - t0 + 8 * h);
        o[0] = m[h];
        o[1] = l[h];
        o[2] = gold[h];
      }
    }
    __syncthreads();
    if (g == 0 && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const float* o = xch + 3 * (r - t0);
        const float mm = fmaxf(m[h], o[0]);
        const float ll = l[h] * expf(m[h] - mm) + o[1] * expf(o[0] - mm);
        if (r < S) {
          const float lse = mm + logf(ll);
          lse_out[r] = lse;
          loss[r] = lse - (gold[h] + o[2]);
        }
      }
    }
  }
};

// the forward (DX = false: loss and lse) or dx (DX = true) of one CTA's 64
// tokens, walking the vocab in BN-row tiles of wt = w^T (V, D); XRES: x
// resident (else streamed), as rows_tc_smem decides
template <typename T, bool DX, bool XRES>
__device__ __forceinline__ void xent_rows_tc(
    const T* __restrict__ x, const T* __restrict__ wt,
    const int* __restrict__ tgt, const float* __restrict__ lse_in,
    const float* __restrict__ gscale, float* __restrict__ loss,
    float* __restrict__ lse_out, T* __restrict__ dx, int S, int D, int V) {
  extern __shared__ unsigned char smem_raw[];
  const int nch = (D + CW - 1) / CW;
  const RowsTcSmem L = rows_tc_smem(nch);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_p = smem_raw + (base - raw);
  auto ws = [&](int st, int c) { return base + (st * nch + c) * RWT; };
  auto xs = [&](int c) { return base + L.x + c * RXT; };
  float* xch = reinterpret_cast<float*>(base_p + L.xch);

  const int t0 = blockIdx.x * TM;
  // dx: this CTA's slice of D, chunks [cs0, cs1); warpgroup g accumulates
  // [my0, my1), at most rows_cpw(XRES) of them
  const int cs0 = blockIdx.y * nch / gridDim.y;
  const int cs1 = (blockIdx.y + 1) * nch / gridDim.y;
  const int half = (cs1 - cs0 + 1) / 2;
  const int g = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int my0 = g ? cs0 + half : cs0, my1 = g ? cs1 : cs0 + half;
  const int ntiles = (V + BN - 1) / BN;

  // w^T rows (vocab) [j0, j0 + BN), every 64-wide chunk of D -> stage st:
  // whole 128-byte lines of device memory, rows always 16-byte aligned
  auto load_w = [&](int jt, int st) {
    for (int c = 0; c < nch; ++c)
      load_tile_rc<T, BN, THREADS>(ws(st, c), wt, jt * BN, V, c * CW, D, D);
  };
  auto load_x = [&](int c, uint32_t dst) {
    load_tile_rc<T, TM, THREADS>(dst, x, t0, S, c * CW, D, D);
  };

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = t0 + 16 * warp + lane / 4;      // token rows row0, +8
  const int col0 = 2 * (lane % 4);                 // + 8j + e: vocab or D
  int tg[2];
  float lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const int t = r < S ? tgt[r] : -1;
    tg[h] = t < V ? t : -1;  // a target outside [0, V) matches no column
    lse_r[h] = DX && r < S ? lse_in[r] : 0.f;
  }
  const float gs = DX ? *gscale : 0.f;
  constexpr int NA = DX ? rows_cpw(XRES) : 1;
  float acc[NA][32];
  if constexpr (DX) {
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int n = 0; n < 32; ++n) acc[i][n] = 0.f;
  }
  FwdStats fs;  // the forward's

  if (XRES) {
    for (int c = 0; c < nch; ++c) load_x(c, xs(c));
    load_w(0, 0);
    cp_async_commit();
  }

  for (int jt = 0; jt < ntiles; ++jt) {
    const int st = XRES ? jt % 2 : 0;
    float z[16];
    if (XRES) {
      cp_async_wait<0>();  // tile jt (and x) landed
      fence_proxy_async();
      __syncthreads();     // ... for everyone; stage st ^ 1 is free
      // Z (64 tokens x BN vocab) = x w_tile, this warpgroup's share:
      // k-steps 2g and 2g + 1 of every chunk
      wgmma_fence();
      for (int c = 0; c < nch; ++c) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss_n32<T>(z, desc_k<CW>(xs(c), 2 * g + kk),
                          desc_k<CW>(ws(st, c), 2 * g + kk), c + kk > 0);
      }
      wgmma_commit();
      // the next tile's copy, issued behind the products it overlaps
      if (jt + 1 < ntiles) load_w(jt + 1, st ^ 1);
      cp_async_commit();
      wgmma_wait<0>();
      fence_regs(z);
    } else {
      __syncthreads();  // the w stage and the x slots are free
      load_w(jt, 0);
      load_x(0, xs(0));
      cp_async_commit();
      for (int c = 0; c < nch; ++c) {
        if (c + 1 < nch) {
          load_x(c + 1, xs((c + 1) % 2));
          cp_async_commit();
          cp_async_wait<1>();  // chunk c (and the w tile) landed
        } else {
          cp_async_wait<0>();
        }
        fence_proxy_async();
        __syncthreads();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss_n32<T>(z, desc_k<CW>(xs(c % 2), 2 * g + kk),
                          desc_k<CW>(ws(0, c), 2 * g + kk), c + kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(z);
        __syncthreads();  // slot c % 2 is free for chunk c + 2
      }
    }

    // the two halves of the contraction meet: z = own + other's, the same
    // sum in both warpgroups (f32 addition commutes)
    const int j0 = jt * BN;
    if constexpr (DX) {
      float* mine = xch + g * (16 * 128);
      const float* other = xch + (1 - g) * (16 * 128);
#pragma unroll
      for (int i = 0; i < 16; ++i) mine[i * 128 + tid] = z[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 16; ++i) z[i] += other[i * 128 + tid];

      // dZ = (exp(Z - lse) - onehot) g/S, 0 past V and S
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int h = (i / 2) % 2;
        const int col = j0 + 8 * (i / 4) + col0 + i % 2;
        float p = exp2f((z[i] - lse_r[h]) * kLog2e);
        if (col == tg[h]) p -= 1.f;
        z[i] = col < V && row0 + 8 * h < S ? p * gs : 0.f;
      }

      // dx[:, my chunks] += dZ w^T_tile: dZ rounded to T in registers is
      // the A operand, the w^T chunks MN-major B operands (transpose bit:
      // the vocab rows are the contraction)
      uint32_t a[2][4];
      acc_to_a<T>(z, 0, a[0]);
      acc_to_a<T>(z, 1, a[1]);
#pragma unroll
      for (int i = 0; i < NA; ++i) fence_regs(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        if (my0 + i < my1) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_rs<T, CW>(acc[i], a[kk], desc_mn<CW>(ws(st, my0 + i), kk),
                            1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NA; ++i) fence_regs(acc[i]);
    } else {
      fs.tile(z, xch, g, tid, j0, col0, V, tg);
    }
  }

  if constexpr (DX) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int c = my0 + i;
      if (c < my1) {
#pragma unroll
        for (int n = 0; n < 32; n += 2) {
          const int r = row0 + 8 * ((n / 2) % 2);
          const int d = c * CW + 8 * (n / 4) + col0;
          if (r < S && d < D)
            *reinterpret_cast<uint32_t*>(dx + (size_t)r * D + d) =
                pack2<T>(acc[i][n], acc[i][n + 1]);
        }
      }
    }
  } else {
    fs.finish(xch, g, lane, row0, t0, S, loss, lse_out);
  }
}

template <typename T, bool XRES>
__global__ void __launch_bounds__(THREADS, 1)
xent_fwd_wgmma(const T* __restrict__ x, const T* __restrict__ wt,
               const int* __restrict__ tgt, float* __restrict__ loss,
               float* __restrict__ lse, int S, int D, int V) {
  xent_rows_tc<T, false, XRES>(x, wt, tgt, nullptr, nullptr, loss, lse,
                               nullptr, S, D, V);
}

template <typename T, bool XRES>
__global__ void __launch_bounds__(THREADS, 1)
xent_dx_wgmma(const T* __restrict__ x, const T* __restrict__ wt,
              const int* __restrict__ tgt, const float* __restrict__ lse,
              const float* __restrict__ gscale, T* __restrict__ dx, int S,
              int D, int V) {
  xent_rows_tc<T, true, XRES>(x, wt, tgt, lse, gscale, nullptr, nullptr, dx,
                              S, D, V);
}

// the forward (!is_dx) or dx of x (S, D) and wt = w^T (V, D)
template <typename T>
cudaError_t launch_rows(bool is_dx, const void* x, const void* wt,
                        const int* tgt, const float* lse_in,
                        const float* gscale, float* loss, float* lse_out,
                        void* dx, int S, int D, int V, cudaStream_t stream) {
  const int nch = (D + CW - 1) / CW;
  const RowsTcSmem L = rows_tc_smem(nch);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(wt);
  const int mblocks = (S + TM - 1) / TM;
  cudaError_t err;
  if (!is_dx) {
    auto kernel = L.xres ? xent_fwd_wgmma<T, true> : xent_fwd_wgmma<T, false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    kernel<<<mblocks, THREADS, L.total, stream>>>(xp, wp, tgt, loss, lse_out,
                                                  S, D, V);
  } else {
    auto kernel = L.xres ? xent_dx_wgmma<T, true> : xent_dx_wgmma<T, false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    // slices of at most 2 * rows_cpw chunks: one at D <= 768
    const int per = 2 * rows_cpw(L.xres);
    dim3 grid(mblocks, (nch + per - 1) / per);
    kernel<<<grid, THREADS, L.total, stream>>>(
        xp, wp, tgt, lse_in, gscale, static_cast<T*>(dx), S, D, V);
  }
  return cudaGetLastError();
}

}  // namespace tc

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
  if constexpr (!std::is_same<T, float>::value) {
    // bf16/f16: the tensor-core kernels
    if (pass == kDw)
      return tc::launch_dw<T>(a.x, a.w, a.tgt, a.lse_in, a.gscale, a.dw,
                              a.S, a.D, a.V, a.stream);
    return tc::launch_rows<T>(pass == kDx, a.x, a.w, a.tgt, a.lse_in,
                              a.gscale, a.loss, a.lse_out, a.dx, a.S, a.D,
                              a.V, a.stream);
  } else {
    // f32: the 3xTF32 wmma kernels
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
            x, w, a.tgt, a.lse_in, a.gscale, a.dw, a.S, a.D, a.V, xres,
            wres);
      } else if (pass == kDx) {
        err = allow_smem(xent_dx_kernel<T>, smem);
        if (err != cudaSuccess) return err;
        dim3 grid((a.S + RBM - 1) / RBM, nsplit);
        xent_dx_kernel<T><<<grid, THREADS, smem, a.stream>>>(
            x, w, a.tgt, a.lse_in, a.gscale, static_cast<T*>(a.dx), a.S,
            a.D, a.V, xres, wres);
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
}

// `wt`: whether a.w is w^T (V, D), which only the bf16/f16 forward and dx
// read (entries *_wt); every other pass reads w (D, V).  A call whose
// layout is not its kernel's is refused.
cudaError_t dispatch(int dtype, Pass pass, bool wt, const Args& a) {
  if (a.S <= 0 || a.V <= 0 || a.D <= 0 || a.D % 32)
    return cudaErrorInvalidValue;
  if (wt != (dtype != tds::kF32 && pass != kDw)) return cudaErrorInvalidValue;
  switch (dtype) {
    case tds::kF32: return launch<float>(pass, a);
    case tds::kBF16: return launch<__nv_bfloat16>(pass, a);
    case tds::kF16: return launch<__half>(pass, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (S, D) and w (D, V) contiguous f32 (tds::kF32; the 3xTF32 kernel),
// targets (S,) int32; loss and lse (S,) f32.  Returns the launch's
// cudaError_t; bf16/f16 take fused_xent_fwd_wt.
extern "C" int fused_xent_fwd(const void* x, const void* w, const int* tgt,
                              float* loss, float* lse, int S, int D, int V,
                              int dtype, void* stream) {
  Args a{x, w, tgt, nullptr, nullptr, loss, lse, nullptr, nullptr, S, D, V,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kFwd, false, a);
}

// as fused_xent_fwd for bf16/f16 (the tensor-core kernel), reading wt =
// w^T (V, D) contiguous.
extern "C" int fused_xent_fwd_wt(const void* x, const void* wt,
                                 const int* tgt, float* loss, float* lse,
                                 int S, int D, int V, int dtype,
                                 void* stream) {
  Args a{x, wt, tgt, nullptr, nullptr, loss, lse, nullptr, nullptr, S, D, V,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kFwd, true, a);
}

// as fused_xent_fwd (f32, w (D, V)), with the forward's lse (S,) f32 and
// gscale (one f32, the upstream gradient over S); dx (S, D) f32.
extern "C" int fused_xent_dx(const void* x, const void* w, const int* tgt,
                             const float* lse, const float* gscale, void* dx,
                             int S, int D, int V, int dtype, void* stream) {
  Args a{x, w, tgt, lse, gscale, nullptr, nullptr, nullptr, dx, S, D, V,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kDx, false, a);
}

// as fused_xent_dx for bf16/f16, reading wt = w^T (V, D); dx in x's dtype.
extern "C" int fused_xent_dx_wt(const void* x, const void* wt,
                                const int* tgt, const float* lse,
                                const float* gscale, void* dx, int S, int D,
                                int V, int dtype, void* stream) {
  Args a{x, wt, tgt, lse, gscale, nullptr, nullptr, nullptr, dx, S, D, V,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kDx, true, a);
}

// as fused_xent_dx, but w (D, V) for every dtype; dw (D, V) f32.
extern "C" int fused_xent_dw(const void* x, const void* w, const int* tgt,
                             const float* lse, const float* gscale, float* dw,
                             int S, int D, int V, int dtype, void* stream) {
  Args a{x, w, tgt, lse, gscale, nullptr, nullptr, dw, nullptr, S, D, V,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, kDw, false, a);
}

// Dynamic shared memory (bytes) the bf16/f16 dW kernel launches with at
// width D, or -1 where no layout fits.
extern "C" int fused_xent_dw_smem_bytes(int D) {
  if (D <= 0 || D % 32) return -1;
  const tc::DwSmem L = tc::dw_smem((D + tc::CW - 1) / tc::CW);
  return L.total <= SMEM_MAX ? L.total : -1;
}

// ... the bf16/f16 forward and dx kernels (one layout serves both).
static int rows_smem_bytes(int D) {
  if (D <= 0 || D % 32) return -1;
  const tc::RowsTcSmem L = tc::rows_tc_smem((D + tc::CW - 1) / tc::CW);
  return L.total <= SMEM_MAX ? L.total : -1;
}

extern "C" int fused_xent_fwd_smem_bytes(int D) {
  return rows_smem_bytes(D);
}

extern "C" int fused_xent_dx_smem_bytes(int D) {
  return rows_smem_bytes(D);
}
