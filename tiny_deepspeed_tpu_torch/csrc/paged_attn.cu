// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// Paged attention for Hopper (sm_90a), straight out of the paged KV pool:
// the decode variant (one query token per slot) and the span-verify
// variant (K1 query tokens per slot), each over a bf16/f16/f32 pool or an
// int8 / e4m3 pool with per-vector f32 scales.
//
// Replaces the TPU kernel tiny_deepspeed_tpu/ops/paged_attn_pallas.py::
// paged_attention (:228, pallas_call :311, kernel body :140-225).  Same
// contract: q (S, Hq, K1, D); pool k/v (NB, bt, L, KVH, D) in the resting
// dtype; scales (NB, bt, L, KVH) f32 on a quantized pool; tables (S, W)
// int32 physical block ids; pos (S,) int32; output in q's dtype.
//
//  * decode (span_kv=None, K1 = 1): slot s attends to positions
//    0..pos[s] inclusive of layer `layer`.
//  * span (span_kv=(sk, sv), (S, KVH, K1, D) in q's dtype): query offset
//    j of slot s attends to pool positions < pos[s] plus the span's own
//    keys 0..j (the windowed causal mask of `_span_attention`) — the
//    speculative verify step and the prefix cache's suffix prefill.
//  * quantized pool (:196-198): each resting code is dequantized against
//    its per-vector f32 scale — in f32 on the FMA paths, rounded to bf16
//    (as the plain version's `paged_panel` does) on the tensor cores.
//
// The split walk, every kernel.  On the TPU the block table arrives
// through scalar prefetch and a sequential grid walks the table entries,
// the softmax statistics carried from step to step in VMEM.  Hopper's
// blocks carry nothing from one to the next, so here the walk is cut
// into tiles of keys and the tiles are split across a thread-block
// cluster: grid (row tiles x splits, KVH, S), cluster (splits, 1, 1),
// splits <= 8 (the portable cluster size) chosen on the host from W and
// bt (ops/paged_attn.py `split_plan`; one launch, no workspace).  Each
// CTA reads pos itself and takes a contiguous, equal share of the slot's
// LIVE tiles (`split_range`); a share past the live range is the empty
// partial (m = kMasked, l = 0, acc = 0).  A CTA folds its keys into an
// online softmax (scores in log2 units, f32) and the cluster merges the
// partials (m, l, acc) in rank order 0..N-1.  Decode and the FMA span
// push: each CTA stores its partial row r into the shared memory of rank
// r % N, one cluster barrier (release / acquire) later each rank merges
// its own rows and leaves (`push_merge`; every CTA arrives, relaxed, at
// a first barrier phase as it starts and waits on it just before its
// first remote store, so all ranks are resident by then).  The
// tensor-core span, whose ring is busy until its walk ends, pulls: after
// `cluster.sync()` rank k reads rows k, k + N, ... of every partial
// through distributed shared memory and a second barrier keeps them
// alive until read (`cluster_merge`).  The order is fixed and there are
// no atomics, so outputs are bit-identical run to run.  A cluster rather
// than a workspace plus a "last CTA merges" counter: the merge needs no
// device memory, no memset and no fence on global memory.  pos is read
// only on the device.
//
// Decode design.  One CTA of four warps per (split, kv head, slot).  A
// table row of up to TABLE_ROW entries is copied into shared memory
// beside the read of pos (a longer one: the CTA's slice, after it), so
// the walk starts two dependent reads deep, not three.  The CTA's tiles
// of 64 keys then stream through a two-stage cp.async ring in the pool's
// resting dtype (scales beside them): tile t+1's rows are in flight
// while tile t folds, and a CTA that holds two tiles has both requested
// before it folds one.  Each warp copies and folds its own 16 keys of a
// tile and waits only on its own copies (no CTA barrier in the walk),
// LPT lanes to a key, each lane at most 16 elements and 32 bytes of a
// head vector, so six CTAs fit an SM and the 768-CTA grid of
// chip_smoke's decode shape is one wave.  A 1-byte pool is dequantized
// at use, on the ALUs.  The warps merge in shared memory, then the
// cluster.  Grouped query heads loop inside the CTA over the same range.
//
// Span design.  Two kernels, chosen on the host by the rows G*K1 of a
// (slot, kv head) and the dtype:
//  * FMA (`paged_span_fma`): few rows (G*K1 <= 16, the speculative
//    verify step, K1 = spec_k + 1), and every f32 or Dh = 128 span.  A
//    CTA holds 16 rows (row r = g*K1 + j, as Pallas groups them), eight
//    lanes a row, each lane 1/8 of the head vector — or, for up to 8
//    (4) rows, each row twice (four times), each copy folding its half
//    (quarter) of every tile, merged in the CTA; tiles of 32 keys
//    stream through a two-stage cp.async ring in the pool's resting
//    dtype (the span's own tiles in q's dtype), scales beside them, and
//    fold with FP32 FMAs.  The span's tiles follow the pool's in the
//    split, so each folds once, in one rank.
//  * tensor cores (`paged_span_wgmma`): many rows (G*K1 > 16: the prefix
//    cache's suffix prefill), bf16/f16 q with Dh 32 or 64.  FA2's
//    forward (`flash_fwd.cu` tc::flash_fwd_wgmma) over a paged source:
//    one warpgroup owns 64 query rows, its Q tile resident; K/V tiles of
//    64 keys come through a two-stage cp.async ring, each 16-byte chunk
//    addressed through the table row (a tile's rows come from different
//    pool blocks, the pool's token stride nlayer*KVH*D apart), into the
//    swizzled tiles of hopper.cuh; S = Q K^T and O += P V on wgmma, P in
//    q's dtype from registers, as the plain `span_attention` casts its
//    probabilities.  The pool positions < pos0 come first, then the
//    span's own tiles under the windowed mask, none wholly past the
//    CTA's largest offset.  Over an int8 / e4m3 pool the ring holds the
//    codes (and the span's 16-bit rows) and each tile is dequantized
//    into a bf16 swizzled tile before its wgmma.
// f32 and Dh = 128 keep the FMA kernel, as f32 keeps FMA in FA2 (and
// hopper.cuh's tiles stop at D = 64).
//
// Bound: every live K/V element is read once (1 byte plus a 4-byte scale
// per head vector on a quantized pool) with a few flops per element per
// query row (4 at decode; 4*K1 on the span) — far below the card's ~300
// flop/byte balance point at these spans, so they are bound by the bytes
// they must move: live pool K/V (+ scales), q, the span's K/V and the
// output.  At chip_smoke's decode shape that is 2.6 us, below a launch
// plus the two dependent reads (pos and the table row, then the rows)
// that every walk through a paged pool makes; and the pool's layout
// keeps a token's layers and heads together, so each head's K/V row
// (128 bytes at bf16, Dh 64) is a DRAM access of its own, which a
// bound that assumes streaming does not count.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace tds::sm90;

constexpr int THREADS = 128;  // every kernel: four warps
constexpr int NW = THREADS / 32;
constexpr int MAX_SPLITS = 8;  // the portable cluster size
// a slot's table row up to this many entries is copied whole, beside the
// read of pos; a longer one in the CTA's slice, after it
constexpr int TABLE_ROW = 1024;

// tiles [lo, hi) of `n` that rank `rank` of `splits` walks: contiguous,
// ceil(n / splits) each, the last ones short or empty (ops/paged_attn.py
// `split_range` is the same arithmetic)
__device__ __forceinline__ void split_range(int n, int splits, int rank,
                                            int& lo, int& hi) {
  const int per = (n + splits - 1) / splits;
  lo = min(rank * per, n);
  hi = min(lo + per, n);
}

// The largest span offset among query rows [r0, rend) (row r = g*K1 + j
// has offset j).
__device__ __forceinline__ int max_offset(int r0, int rend, int K1) {
  return (rend - r0 >= K1 || r0 / K1 != (rend - 1) / K1) ? K1 - 1
                                                          : (rend - 1) % K1;
}

// The cluster's fixed-order merge.  Every rank has left its partial
// softmax state over the same `rows` rows in shared memory: pm / pl
// (rows) the running max (log2 units) and sum, pacc (rows x D) the
// unnormalised output.  Rank k merges rows k, k + N, ..., reading the N
// partials in rank order 0..N-1 through distributed shared memory, and
// writes row r < nvalid to out + r * D.  wgt: rows + MAX_SPLITS floats.
template <typename TO, int D>
__device__ __forceinline__ void cluster_merge(const float* pm,
                                              const float* pl,
                                              const float* pacc, float* wgt,
                                              int rows, int nvalid,
                                              TO* __restrict__ out) {
  cg::cluster_group cl = cg::this_cluster();
  const int N = cl.num_blocks(), rank = cl.block_rank();
  cl.sync();  // every rank's partial is in place
  const int mine = rank < rows ? (rows - rank + N - 1) / N : 0;
  for (int i = threadIdx.x; i < mine; i += THREADS) {
    const int r = rank + i * N;
    float mk[MAX_SPLITS], lk[MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k) {  // all loads in flight at once
      mk[k] = k < N ? cl.map_shared_rank(pm, k)[r] : tds::kMasked;
      lk[k] = k < N ? cl.map_shared_rank(pl, k)[r] : 0.f;
    }
    float M = tds::kMasked;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k) M = fmaxf(M, mk[k]);
    float L = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k) {
      mk[k] = exp2f(mk[k] - M);
      L = fmaf(lk[k], mk[k], L);
    }
    const float inv = __fdividef(1.f, L);
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < N) wgt[i * N + k] = mk[k] * inv;
  }
  __syncthreads();
  const float* src[MAX_SPLITS];
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k)
    src[k] = cl.map_shared_rank(pacc, k < N ? k : 0);
  for (int e = threadIdx.x; e < mine * D; e += THREADS) {
    const int i = e / D, c = e % D, r = rank + i * N;
    float x[MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      x[k] = k < N ? src[k][r * D + c] : 0.f;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)
      if (k < N) a = fmaf(x[k], wgt[i * N + k], a);
    if (r < nvalid) out[(size_t)r * D + c] = tds::from_f<TO>(a);
  }
  cl.sync();  // no rank leaves while another still reads its partial
}

// Cluster barrier halves (PTX barrier.cluster): a kernel that pushes its
// partial arrives (relaxed) as it starts and waits just before its first
// remote store, which guarantees every rank has started by then.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The fixed-order merge by pushing: each rank stores its partial row r
// (pm, pl, pacc as in cluster_merge) into rank r % N's `recv` (slot
// (r / N) * N + rank, D + 2 floats: acc, m, l), one cluster barrier
// (release / acquire) later each rank merges its rows from its own
// shared memory in rank order 0..N-1 and leaves: one barrier after the
// walk instead of two, and stores in flight instead of remote loads.
// The caller arrived with cluster_arrive_relaxed() at its start.  recv:
// (rows + MAX_SPLITS) * (D + 2) floats.
template <typename TO, int D>
__device__ __forceinline__ void push_merge(const float* pm, const float* pl,
                                           const float* pacc, float* recv,
                                           int rows, int nvalid,
                                           TO* __restrict__ out) {
  constexpr int RS = D + 2;
  cg::cluster_group cl = cg::this_cluster();
  const int N = cl.num_blocks(), rank = cl.block_rank();
  __syncthreads();  // the CTA's partial is complete
  cluster_wait();   // every rank has started
  for (int e = threadIdx.x; e < rows * RS; e += THREADS) {
    const int r = e / RS, c = e % RS;
    const float v = c < D ? pacc[r * D + c] : c == D ? pm[r] : pl[r];
    cl.map_shared_rank(recv, r % N)[((r / N) * N + rank) * RS + c] = v;
  }
  cl.sync();  // every partial has landed
  const int mine = rank < rows ? (rows - rank + N - 1) / N : 0;
  for (int e = threadIdx.x; e < mine * D; e += THREADS) {
    const int i = e / D, c = e % D, r = rank + i * N;
    const float* src = recv + i * N * RS;
    float M = tds::kMasked;
    for (int k = 0; k < N; ++k) M = fmaxf(M, src[k * RS + D]);
    float L = 0.f, a = 0.f;
    for (int k = 0; k < N; ++k) {
      const float w = exp2f(src[k * RS + D] - M);
      L = fmaf(src[k * RS + D + 1], w, L);
      a = fmaf(src[k * RS + c], w, a);
    }
    if (r < nvalid) out[(size_t)r * D + c] = tds::from_f<TO>(__fdividef(a, L));
  }
}

// four 1-byte codes (int8 or e4m3, little-endian in w) -> floats, on
// the ALUs rather than the quarter-rate int-to-float converter: an int8
// byte b is the float 2^23 + (b + 128) less 2^23 + 128 (exact); e4m3
// pairs convert to f16 pairs in one instruction each
template <typename E>
__device__ __forceinline__ void bytes4_to_f(uint32_t w, float* out) {
  if constexpr (std::is_same<E, int8_t>::value) {
    const uint32_t x = w ^ 0x80808080u;  // b + 128, unsigned
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + k))
               - 8388736.f;
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * k)), __NV_E4M3);
      const float2 f = __half22float2(__half2(h));
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
}

// 16 bytes of E -> 16 / sizeof(E) floats
template <typename E>
__device__ __forceinline__ void unpack16(const uint4& u, float* out) {
  if constexpr (std::is_same<E, float>::value) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  } else if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else if constexpr (std::is_same<E, __half>::value) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __half22float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) bytes4_to_f<E>(w[j], out + 4 * j);
  }
}

// N contiguous elements of E in shared memory (aligned to their size,
// 4-64 bytes) -> floats
template <typename E, int N>
__device__ __forceinline__ void load_vec(const E* p, float* out) {
  constexpr int BYTES = N * sizeof(E);
  constexpr int PER16 = 16 / sizeof(E);
  static_assert(BYTES == 4 || BYTES == 8 || BYTES % 16 == 0, "vector size");
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      unpack16<E>(reinterpret_cast<const uint4*>(p)[i], out + i * PER16);
  } else {
    uint4 u = make_uint4(0, 0, 0, 0);
    if constexpr (BYTES == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      u.x = w.x;
      u.y = w.y;
    } else {
      u.x = *reinterpret_cast<const uint32_t*>(p);
    }
    float tmp[PER16];
    unpack16<E>(u, tmp);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = tmp[i];
  }
}

// -- decode ------------------------------------------------------------------

namespace decode {

constexpr int TK = 64;     // keys a tile (the split's unit)
constexpr int STAGES = 2;  // cp.async ring depth

// lanes per token: each lane holds at most 16 elements and 32 bytes of
// a head vector
template <typename TKV, int D>
__host__ __device__ constexpr int lanes_per_token() {
  return D / 16 > D * (int)sizeof(TKV) / 32 ? D / 16
                                            : D * (int)sizeof(TKV) / 32;
}

template <typename TKV, int D>
struct Layout {
  static constexpr int SIDE = TK * D * sizeof(TKV);  // a stage's K (or V)
  // K, V and, on a 1-byte pool, their scales
  static constexpr int STAGE = 2 * SIDE + (sizeof(TKV) == 1 ? 2 * TK * 4 : 0);
  // the ring, then warp buffers, the partial, the merge's weights and the
  // table (row or slice)
  static size_t bytes(int G, int slots) {
    return (size_t)STAGES * STAGE
           + (size_t)(2 * NW + NW * D + 2 * G + G * D
                      + (G + MAX_SPLITS) * (D + 2)) * 4
           + (size_t)slots * 4;
  }
};

// six CTAs an SM (80 registers a thread) where the walk's registers fit
// them, four at Dh = 128
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 4 : 6)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                    const TKV* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, TQ* __restrict__ o,
                    int Hq, int KVH, int bt, int nlayer, int layer, int W,
                    float sl2) {
  using Ly = Layout<TKV, D>;
  constexpr int LPT = lanes_per_token<TKV, D>();
  constexpr int EPL = D / LPT;  // elements a lane holds
  constexpr int TPS = 32 / LPT;  // tokens a warp step
  constexpr int KPW = TK / NW;   // keys of a tile a warp folds
  constexpr int NV = EPL * sizeof(TKV) / 16;  // 16-byte pieces a lane's
  constexpr int PER16 = 16 / sizeof(TKV);     // share of a row
  constexpr bool QUANT = sizeof(TKV) == 1;
  static_assert(EPL <= 16 && NV >= 1 && KPW % TPS == 0 && 2 * KPW == 32,
                "a lane's share of a tile; a lane a scale");

  extern __shared__ __align__(16) unsigned char smem[];
  auto kst = [&](int st) {
    return reinterpret_cast<const TKV*>(smem + st * Ly::STAGE);
  };
  auto vst = [&](int st) {
    return reinterpret_cast<const TKV*>(smem + st * Ly::STAGE + Ly::SIDE);
  };
  auto kss = [&](int st) {
    return reinterpret_cast<float*>(smem + st * Ly::STAGE + 2 * Ly::SIDE);
  };
  auto vss = [&](int st) { return kss(st) + TK; };
  const int G = Hq / KVH;
  float* wm = reinterpret_cast<float*>(smem + STAGES * Ly::STAGE);
  float* wl = wm + NW;          // [NW] each warp's running max, and sum
  float* wacc = wl + NW;        // [NW][D]
  float* pm = wacc + NW * D;    // [G] the CTA's partial, a row a group head
  float* pl = pm + G;           // [G]
  float* pacc = pl + G;         // [G][D]
  float* recv = pacc + G * D;   // [G + MAX_SPLITS][D + 2] pushed partials
  int* stab = reinterpret_cast<int*>(recv + (G + MAX_SPLITS) * (D + 2));

  cg::cluster_group cl = cg::this_cluster();
  const int N = cl.num_blocks(), rank = cl.block_rank();
  cluster_arrive_relaxed();  // push_merge waits on it
  const int kvh = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tok = lane / LPT, part = lane % LPT;

  // the table row comes in beside pos when it is short; this CTA's live
  // keys [k0, k1) of positions 0..pos[s] follow from pos
  const int* trow = tables + (size_t)s * W;
  const bool whole = W <= TABLE_ROW;
  if (whole)
    for (int i = threadIdx.x; i < W; i += THREADS) stab[i] = trow[i];
  const int n = min(pos[s] + 1, W * bt);
  int tlo, thi;
  split_range((n + TK - 1) / TK, N, rank, tlo, thi);
  const int k0 = tlo * TK, k1 = min(thi * TK, n);
  const int e0 = whole ? 0 : k0 / bt;
  if (!whole && k0 < k1)
    for (int i = threadIdx.x; i <= (k1 - 1) / bt - e0; i += THREADS)
      stab[i] = trow[e0 + i];
  __syncthreads();

  const size_t tok_stride = (size_t)nlayer * KVH * D;
  const size_t head_off = ((size_t)layer * KVH + kvh) * D;
  const size_t sc_stride = (size_t)nlayer * KVH;
  const size_t sc_off = (size_t)layer * KVH + kvh;

  // this warp's KPW keys of tile t -> its rows of ring stage st, through
  // the table; nothing past k1 (zero-filled where the slice straddles it)
  auto issue = [&](int t, int st) {
    if (t * TK + warp * KPW >= k1) return;
    constexpr int CPR = D * sizeof(TKV) / 16;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < 2 * KPW * CPR / 32; ++i) {
      const int e = lane + i * 32;
      const int side = e / (KPW * CPR), rem = e % (KPW * CPR);
      const int c = warp * KPW + rem / CPR, ch = rem % CPR;
      const int p = t * TK + c;
      const bool ok = p < k1;
      const size_t tr = ok ? (size_t)stab[p / bt - e0] * bt + p % bt : 0;
      cp_async16(smem_u32(smem + st * Ly::STAGE + side * Ly::SIDE
                          + c * D * sizeof(TKV) + ch * 16),
                 (side ? vpool : kpool) + tr * tok_stride + head_off
                     + ch * (16 / sizeof(TKV)),
                 ok);
    }
    if constexpr (QUANT) {
      const int side = lane / KPW, c = warp * KPW + lane % KPW;
      const int p = t * TK + c;
      const bool ok = p < k1;
      const size_t tr = ok ? (size_t)stab[p / bt - e0] * bt + p % bt : 0;
      cp_async4(smem_u32((side ? vss(st) : kss(st)) + c),
                (side ? vscale : kscale) + tr * sc_stride + sc_off, ok);
    }
  };

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    float qr[EPL], acc[EPL];
    {
      const TQ* qp = q + ((size_t)s * Hq + h) * D + part * EPL;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        qr[i] = tds::to_f(qp[i]) * sl2;
        acc[i] = 0.f;
      }
    }
    float m = tds::kMasked, l = 0.f;
    if (tlo < thi) {
#pragma unroll
      for (int i = 0; i < STAGES - 1; ++i) {  // the ring's first tiles
        if (tlo + i < thi) issue(tlo + i, i);
        cp_async_commit();
      }
      for (int t = tlo; t < thi; ++t) {
        const int st = (t - tlo) % STAGES;
        if (t + STAGES - 1 < thi)
          issue(t + STAGES - 1, (t + STAGES - 1 - tlo) % STAGES);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // this warp's slice of tile t landed
        __syncwarp();
        // the warp's keys of the tile, TPS a step, LPT lanes a key (none
        // when its slice lies past k1: nothing was copied there)
#pragma unroll
        for (int c0 = warp * KPW;
             c0 < (warp + 1) * KPW && t * TK + warp * KPW < k1; c0 += TPS) {
          const int c = c0 + tok;
          const bool ok = t * TK + c < k1;
          const uint4* kp =
              reinterpret_cast<const uint4*>(kst(st) + c * D + part * EPL);
          const uint4* vp =
              reinterpret_cast<const uint4*>(vst(st) + c * D + part * EPL);
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v) {  // 16 bytes at a time: few live
            float f[PER16];
            unpack16<TKV>(kp[v], f);
#pragma unroll
            for (int j = 0; j < PER16; ++j)
              dot = fmaf(qr[v * PER16 + j], f[j], dot);
          }
          if constexpr (QUANT) dot *= kss(st)[c];
#pragma unroll
          for (int off = 1; off < LPT; off <<= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          const float sc = ok ? dot : tds::kMasked;
          float mx = sc;
#pragma unroll
          for (int off = LPT; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mn = fmaxf(m, mx);
          const float alpha = exp2f(m - mn);
          const float p = ok ? exp2f(sc - mn) : 0.f;
          l = fmaf(l, alpha, p);
          const float pv = QUANT ? p * vss(st)[c] : p;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            float f[PER16];
            unpack16<TKV>(vp[v], f);
#pragma unroll
            for (int j = 0; j < PER16; ++j)
              acc[v * PER16 + j] =
                  fmaf(pv, f[j], acc[v * PER16 + j] * alpha);
          }
          m = mn;
        }
        __syncwarp();  // the warp's slice of stage st is free again
      }
    }

    // the warp's token lanes (m is already warp-uniform), then the warps
#pragma unroll
    for (int off = LPT; off < 32; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    if (tok == 0) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) wacc[warp * D + part * EPL + i] = acc[i];
      if (part == 0) {
        wm[warp] = m;
        wl[warp] = l;
      }
    }
    __syncthreads();
    if (threadIdx.x < D) {
      float M = tds::kMasked;
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w]);
      float L = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = exp2f(wm[w] - M);
        L = fmaf(wl[w], c, L);
        a = fmaf(wacc[w * D + threadIdx.x], c, a);
      }
      pacc[g * D + threadIdx.x] = a;
      if (threadIdx.x == 0) {
        pm[g] = M;
        pl[g] = L;
      }
    }
    __syncthreads();  // the warp buffers are reused by the next group head
  }
  push_merge<TQ, D>(pm, pl, pacc, recv, G, G,
                    o + ((size_t)s * Hq + (size_t)kvh * G) * D);
}

}  // namespace decode

// -- span verify, FP32 FMAs -----------------------------------------------------

namespace sfma {

constexpr int ROWS = 16;   // query rows a CTA holds
constexpr int LANES = 8;   // lanes a row
constexpr int TK = 32;     // keys a tile
constexpr int CH = 4;      // keys a fold step
constexpr int STAGES = 2;  // cp.async ring depth
static_assert(ROWS * LANES == THREADS, "a lane group per row");

template <typename TQ, typename TKV, int D>
struct Layout {
  static constexpr int ESZ = sizeof(TQ) > sizeof(TKV) ? sizeof(TQ)
                                                      : sizeof(TKV);
  static constexpr int SIDE = TK * D * ESZ;            // a stage's K (or V)
  static constexpr int STAGE = 2 * SIDE + 2 * TK * 4;  // K, V, their scales
  static constexpr int PART =
      (2 * ROWS + ROWS * D + ROWS + (ROWS + MAX_SPLITS) * (D + 2)) * 4;
  static size_t bytes(int slots) {
    return (size_t)STAGES * STAGE + PART + (size_t)slots * 4;
  }
};

// Fold staged keys [c_lo, c_hi) of a tile, CH at a time, into one row's
// online softmax (m, l, acc), this lane holding dims part*DPT..; keys at
// c > cmax (the span's beyond the row's offset) are masked.  ksc / vsc:
// the keys' scales on a quantized pool, else null.
template <typename E, int D, int DPT>
__device__ __forceinline__ void fold(const E* kt, const E* vt,
                                     const float* ksc, const float* vsc,
                                     int c_lo, int c_hi, int cmax, int part,
                                     const float (&qr)[DPT],
                                     float (&acc)[DPT], float& m, float& l) {
  for (int c0 = c_lo; c0 < c_hi; c0 += CH) {
    float sc[CH];
    float mx = tds::kMasked;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = c0 + i;
      float kv[DPT];
      load_vec<E, DPT>(kt + c * D + part * DPT, kv);
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < DPT; ++j) d = fmaf(qr[j], kv[j], d);
      if (ksc) d *= ksc[c];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      sc[i] = c < c_hi && c <= cmax ? d : tds::kMasked;
      mx = fmaxf(mx, sc[i]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const float p = sc[i] > tds::kMasked ? exp2f(sc[i] - mn) : 0.f;
      l += p;
      const float pv = vsc ? p * vsc[c0 + i] : p;
      float vv[DPT];
      load_vec<E, DPT>(vt + (c0 + i) * D + part * DPT, vv);
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(pv, vv[j], acc[j]);
    }
    m = mn;
  }
}

// six CTAs an SM (80 registers a thread); four for f32 q or Dh = 128,
// whose folds need more
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(TQ) == 4 || D == 128 ? 4 : 6)
paged_span_fma(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
               const TKV* __restrict__ vpool,
               const float* __restrict__ kscale,
               const float* __restrict__ vscale,
               const TQ* __restrict__ sk, const TQ* __restrict__ sv,
               const int* __restrict__ tables, const int* __restrict__ pos0,
               TQ* __restrict__ o, int Hq, int KVH, int K1, int bt,
               int nlayer, int layer, int W, float sl2) {
  using Ly = Layout<TQ, TKV, D>;
  constexpr int DPT = D / LANES;  // a lane's head dims: part*DPT ..
  constexpr bool QUANT = sizeof(TKV) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  auto kst = [&](int st) { return smem + st * Ly::STAGE; };
  auto vst = [&](int st) { return smem + st * Ly::STAGE + Ly::SIDE; };
  auto kss = [&](int st) {
    return reinterpret_cast<float*>(smem + st * Ly::STAGE + 2 * Ly::SIDE);
  };
  auto vss = [&](int st) { return kss(st) + TK; };
  float* pm = reinterpret_cast<float*>(smem + STAGES * Ly::STAGE);
  float* pl = pm + ROWS;
  float* pacc = pl + ROWS;
  float* wgt = pacc + ROWS * D;  // [ROWS] the group merge's weights
  float* recv = wgt + ROWS;       // [ROWS + MAX_SPLITS][D + 2]
  int* stab = reinterpret_cast<int*>(recv + (ROWS + MAX_SPLITS) * (D + 2));

  cg::cluster_group cl = cg::this_cluster();
  const int N = cl.num_blocks(), rank = cl.block_rank();
  cluster_arrive_relaxed();  // push_merge waits on it
  const int rt = blockIdx.x / N, kvh = blockIdx.y, s = blockIdx.z;
  const int R = (Hq / KVH) * K1;  // query rows of this (slot, kv head)
  const int r0 = rt * ROWS, rend = min(r0 + ROWS, R);
  // Few rows leave lanes idle, so the 16 row slots take the CTA's rows
  // ng times over, and group g of them folds the g-th 1/ng of each tile:
  // ng = 4 for up to 4 rows, 2 for up to 8.  A warp's 4 slots share a
  // group.
  const int rc = rend - r0;
  const int ng = rc <= 4 ? 4 : rc <= 8 ? 2 : 1;
  const int rp = ROWS / ng;  // slots a group
  const int kpg = TK / ng;   // keys of a tile a group folds
  const int slot = threadIdx.x / LANES, part = threadIdx.x % LANES;
  const int grp = slot / rp, row = slot % rp;
  const int r = r0 + row;
  const bool live = row < rc;
  const int jq = live ? r % K1 : K1 - 1;  // the row's span offset
  const int jmax = max_offset(r0, rend, K1);

  // tiles: the pool positions < pos0, then the span's offsets 0..jmax
  const int* trow = tables + (size_t)s * W;
  const bool whole = W <= TABLE_ROW;  // the row comes in beside pos0
  if (whole)
    for (int i = threadIdx.x; i < W; i += THREADS) stab[i] = trow[i];
  const int npool = min(pos0[s], W * bt);
  const int npt = (npool + TK - 1) / TK;
  int tlo, thi;
  split_range(npt + jmax / TK + 1, N, rank, tlo, thi);
  const int plo = tlo * TK, phi = min(min(thi, npt) * TK, npool);
  const int e0 = whole ? 0 : plo / bt;
  if (!whole && plo < phi)
    for (int i = threadIdx.x; i <= (phi - 1) / bt - e0; i += THREADS)
      stab[i] = trow[e0 + i];
  __syncthreads();

  const size_t tok_stride = (size_t)nlayer * KVH * D;
  const size_t head_off = ((size_t)layer * KVH + kvh) * D;
  const size_t sc_stride = (size_t)nlayer * KVH;
  const size_t sc_off = (size_t)layer * KVH + kvh;
  const size_t row_base = (size_t)s * Hq * K1 + (size_t)kvh * R;
  const size_t span_base = ((size_t)s * KVH + kvh) * K1 * D;

  float qr[DPT], acc[DPT];
  {
    const TQ* qp = q + (row_base + (live ? r : r0)) * D + part * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = live ? tds::to_f(qp[i]) * sl2 : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = tds::kMasked, l = 0.f;

  // tile t -> ring stage st: pool rows through the table (zero past
  // pos0), or the span's rows (zero past K1)
  auto issue = [&](int t, int st) {
    if (t < npt) {
      constexpr int CPR = D * sizeof(TKV) / 16;  // 16-byte chunks a row
      for (int e = threadIdx.x; e < 2 * TK * CPR; e += THREADS) {
        const int side = e / (TK * CPR), rem = e % (TK * CPR);
        const int c = rem / CPR, ch = rem % CPR;
        const int p = t * TK + c;
        const bool ok = p < npool;
        const size_t tr = ok ? (size_t)stab[p / bt - e0] * bt + p % bt : 0;
        cp_async16(smem_u32((side ? vst(st) : kst(st))
                            + c * D * sizeof(TKV) + ch * 16),
                   (side ? vpool : kpool) + tr * tok_stride + head_off
                       + ch * (16 / sizeof(TKV)),
                   ok);
      }
      if constexpr (QUANT) {
        for (int e = threadIdx.x; e < 2 * TK; e += THREADS) {
          const int side = e / TK, c = e % TK;
          const int p = t * TK + c;
          const bool ok = p < npool;
          const size_t tr = ok ? (size_t)stab[p / bt - e0] * bt + p % bt : 0;
          cp_async4(smem_u32((side ? vss(st) : kss(st)) + c),
                    (side ? vscale : kscale) + tr * sc_stride + sc_off, ok);
        }
      }
    } else {
      constexpr int CPR = D * sizeof(TQ) / 16;
      const int j0 = (t - npt) * TK;
      for (int e = threadIdx.x; e < 2 * TK * CPR; e += THREADS) {
        const int side = e / (TK * CPR), rem = e % (TK * CPR);
        const int c = rem / CPR, ch = rem % CPR;
        const bool ok = j0 + c < K1;
        cp_async16(smem_u32((side ? vst(st) : kst(st))
                            + c * D * sizeof(TQ) + ch * 16),
                   (side ? sv : sk) + span_base
                       + (size_t)(ok ? j0 + c : 0) * D
                       + ch * (16 / sizeof(TQ)),
                   ok);
      }
    }
  };

  if (tlo < thi) {
    issue(tlo, 0);
    cp_async_commit();
    for (int t = tlo; t < thi; ++t) {
      const int st = (t - tlo) % STAGES;
      if (t + 1 < thi) issue(t + 1, (t + 1 - tlo) % STAGES);
      cp_async_commit();
      cp_async_wait<1>();  // tile t landed
      __syncthreads();
      // this group's keys of the tile: the pool's below pos0, or the
      // span's at offsets up to the row's own
      if (t < npt) {
        fold<TKV, D, DPT>(reinterpret_cast<const TKV*>(kst(st)),
                          reinterpret_cast<const TKV*>(vst(st)),
                          QUANT ? kss(st) : nullptr,
                          QUANT ? vss(st) : nullptr, grp * kpg,
                          min((grp + 1) * kpg, npool - t * TK), TK, part,
                          qr, acc, m, l);
      } else {
        const int off0 = (t - npt) * TK;
        fold<TQ, D, DPT>(reinterpret_cast<const TQ*>(kst(st)),
                         reinterpret_cast<const TQ*>(vst(st)), nullptr,
                         nullptr, grp * kpg,
                         min((grp + 1) * kpg, K1 - off0), jq - off0, part,
                         qr, acc, m, l);
      }
      __syncthreads();  // stage st is free for the copy two tiles ahead
    }
  }

#pragma unroll
  for (int i = 0; i < DPT; ++i) pacc[slot * D + part * DPT + i] = acc[i];
  if (part == 0) {
    pm[slot] = m;
    pl[slot] = l;
  }
  if (ng > 1) {  // the groups of each row, in group order, into slot row
    __syncthreads();
    float M = tds::kMasked, L = 0.f;
    if (threadIdx.x < rp) {
      for (int g = 0; g < ng; ++g) M = fmaxf(M, pm[threadIdx.x + g * rp]);
      for (int g = 0; g < ng; ++g) {
        const float c = exp2f(pm[threadIdx.x + g * rp] - M);
        wgt[threadIdx.x * ng + g] = c;
        L = fmaf(pl[threadIdx.x + g * rp], c, L);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rp * D; e += THREADS) {
      const int rr = e / D, c = e % D;
      float a = 0.f;
      for (int g = 0; g < ng; ++g)
        a = fmaf(pacc[(rr + g * rp) * D + c], wgt[rr * ng + g], a);
      pacc[rr * D + c] = a;
    }
    if (threadIdx.x < rp) {
      pm[threadIdx.x] = M;
      pl[threadIdx.x] = L;
    }
  }
  push_merge<TQ, D>(pm, pl, pacc, recv, rp, rc, o + (row_base + r0) * D);
}

}  // namespace sfma

// -- span verify, tensor cores ----------------------------------------------------

namespace tc {

constexpr int BQ = 64;     // query rows a CTA holds (one warpgroup)
constexpr int BK = 64;     // keys a tile
constexpr int STAGES = 2;  // cp.async ring depth
static_assert(THREADS == 2 * BK, "one scale a thread per tile");

template <int D, bool QUANT>
struct Layout {
  static constexpr int TB = BQ * D * 2;  // a swizzled 16-bit tile
  // quantized: a ring side holds a tile's rows as they rest (1-byte
  // codes, or the span's 16-bit rows)
  static constexpr int RAW = BK * D * 2;
  // Q | K, V per stage; quantized: Q | K | V | (raw K, raw V) per stage
  static constexpr int TILES = QUANT ? 3 * TB + STAGES * 2 * RAW
                                     : (1 + 2 * STAGES) * TB;
  static constexpr int SCALES = QUANT ? STAGES * 2 * BK * 4 : 0;
  static constexpr int STATS = (2 * BQ + BQ + MAX_SPLITS) * 4;
  static_assert(2 * TB <= TILES - TB, "the partial fits past Q");
  static size_t bytes(int slots) {
    return 1024 + (size_t)TILES + SCALES + STATS + (size_t)slots * 4;
  }
};

template <typename T, typename TKV, int D>
__global__ void __launch_bounds__(THREADS, 3)
paged_span_wgmma(const T* __restrict__ q, const TKV* __restrict__ kpool,
                 const TKV* __restrict__ vpool,
                 const float* __restrict__ kscale,
                 const float* __restrict__ vscale, const T* __restrict__ sk,
                 const T* __restrict__ sv, const int* __restrict__ tables,
                 const int* __restrict__ pos0, T* __restrict__ o, int Hq,
                 int KVH, int K1, int bt, int nlayer, int layer, int W,
                 float sl2) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  using Ly = Layout<D, QUANT>;
  constexpr uint32_t TB = Ly::TB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw0);
  const uint32_t qs = base;
  auto ks = [&](int st) { return QUANT ? base + TB : base + TB * (1 + 2 * st); };
  auto vs = [&](int st) { return QUANT ? base + 2 * TB : base + TB * (2 + 2 * st); };
  auto rk = [&](int st) { return 3 * TB + st * 2 * Ly::RAW; };  // offsets
  auto rv = [&](int st) { return 3 * TB + st * 2 * Ly::RAW + Ly::RAW; };
  float* scl = reinterpret_cast<float*>(gbase + Ly::TILES);  // [st][side][BK]
  float* pm = reinterpret_cast<float*>(gbase + Ly::TILES + Ly::SCALES);
  float* pl = pm + BQ;
  float* wgt = pl + BQ;
  int* stab = reinterpret_cast<int*>(wgt + BQ + MAX_SPLITS);
  float* pacc = reinterpret_cast<float*>(gbase + TB);  // over the ring, after

  cg::cluster_group cl = cg::this_cluster();
  const int N = cl.num_blocks(), rank = cl.block_rank();
  const int rt = blockIdx.x / N, kvh = blockIdx.y, s = blockIdx.z;
  const int R = (Hq / KVH) * K1;
  const int r0 = rt * BQ, rend = min(r0 + BQ, R);
  const int jmax = max_offset(r0, rend, K1);

  const int* trow = tables + (size_t)s * W;
  const bool whole = W <= TABLE_ROW;  // the row comes in beside pos0
  if (whole)
    for (int i = threadIdx.x; i < W; i += THREADS) stab[i] = trow[i];
  const int npool = min(pos0[s], W * bt);
  const int npt = (npool + BK - 1) / BK;
  int tlo, thi;
  split_range(npt + jmax / BK + 1, N, rank, tlo, thi);
  const int plo = tlo * BK, phi = min(min(thi, npt) * BK, npool);
  const int e0 = whole ? 0 : plo / bt;
  if (!whole && plo < phi)
    for (int i = threadIdx.x; i <= (phi - 1) / bt - e0; i += THREADS)
      stab[i] = trow[e0 + i];
  __syncthreads();

  const size_t tok_stride = (size_t)nlayer * KVH * D;
  const size_t head_off = ((size_t)layer * KVH + kvh) * D;
  const size_t sc_stride = (size_t)nlayer * KVH;
  const size_t sc_off = (size_t)layer * KVH + kvh;
  const size_t row_base = (size_t)s * Hq * K1 + (size_t)kvh * R;
  const size_t span_base = ((size_t)s * KVH + kvh) * K1 * D;

  auto issue = [&](int t, int st) {
    if (t < npt) {  // pool rows through the table, zero past pos0
      constexpr int CPR = D * sizeof(TKV) / 16;
#pragma unroll
      for (int i = 0; i < 2 * BK * CPR / THREADS; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const int side = e / (BK * CPR), rem = e % (BK * CPR);
        const int r = rem / CPR, c = rem % CPR;
        const int p = t * BK + r;
        const bool ok = p < npool;
        const size_t tr = ok ? (size_t)stab[p / bt - e0] * bt + p % bt : 0;
        const TKV* src = (side ? vpool : kpool) + tr * tok_stride + head_off
                         + c * (16 / sizeof(TKV));
        uint32_t dst;
        if constexpr (QUANT)
          dst = base + (side ? rv(st) : rk(st)) + r * D + c * 16;
        else
          dst = (side ? vs(st) : ks(st)) + swz<D>(r, c * 8);
        cp_async16(dst, src, ok);
      }
      if constexpr (QUANT) {
        const int side = threadIdx.x / BK, r = threadIdx.x % BK;
        const int p = t * BK + r;
        const bool ok = p < npool;
        const size_t tr = ok ? (size_t)stab[p / bt - e0] * bt + p % bt : 0;
        cp_async4(smem_u32(scl + (st * 2 + side) * BK + r),
                  (side ? vscale : kscale) + tr * sc_stride + sc_off, ok);
      }
    } else {  // the span's rows, zero past K1
      const int j0 = (t - npt) * BK;
      if constexpr (QUANT) {
        constexpr int CPR = D * 2 / 16;
#pragma unroll
        for (int i = 0; i < 2 * BK * CPR / THREADS; ++i) {
          const int e = threadIdx.x + i * THREADS;
          const int side = e / (BK * CPR), rem = e % (BK * CPR);
          const int r = rem / CPR, c = rem % CPR;
          const bool ok = j0 + r < K1;
          cp_async16(base + (side ? rv(st) : rk(st)) + r * D * 2 + c * 16,
                     (side ? sv : sk) + span_base
                         + (size_t)(ok ? j0 + r : 0) * D + c * 8,
                     ok);
        }
      } else {
        load_tile64<T, D, THREADS>(ks(st), sk + span_base, j0, K1, D);
        load_tile64<T, D, THREADS>(vs(st), sv + span_base, j0, K1, D);
      }
    }
  };

  // quantized: the staged tile -> the swizzled bf16 K and V tiles (codes
  // x scale rounded to bf16, as `paged_panel` dequantizes; span rows as
  // they are)
  auto convert = [&](int t, int st) {
    const bool pool = t < npt;
#pragma unroll
    for (int i = 0; i < 2 * BK * (D / 8) / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int side = e / (BK * D / 8), rem = e % (BK * D / 8);
      const int r = rem / (D / 8), c = rem % (D / 8);
      const int off = side ? rv(st) : rk(st);
      uint4 out;
      if (pool) {
        const uint2 u = *reinterpret_cast<const uint2*>(gbase + off + r * D
                                                         + c * 8);
        const float f = scl[(st * 2 + side) * BK + r];
        float x[16];
        unpack16<TKV>(make_uint4(u.x, u.y, 0, 0), x);
        out.x = pack2<T>(x[0] * f, x[1] * f);
        out.y = pack2<T>(x[2] * f, x[3] * f);
        out.z = pack2<T>(x[4] * f, x[5] * f);
        out.w = pack2<T>(x[6] * f, x[7] * f);
      } else {
        out = *reinterpret_cast<const uint4*>(gbase + off + r * D * 2
                                              + c * 16);
      }
      const uint32_t dst = (side ? vs(st) : ks(st)) + swz<D>(r, c * 8);
      *reinterpret_cast<uint4*>(gbase + (dst - base)) = out;
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lrow0 = 16 * warp + lane / 4;  // local rows lrow0, lrow0 + 8
  const int col0 = 2 * (lane % 4);
  int jq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + lrow0 + 8 * hh;
    jq[hh] = r < R ? r % K1 : K1 - 1;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {tds::kMasked, tds::kMasked}, l[2] = {0.f, 0.f};

  if (tlo < thi) {
    load_tile64<T, D, THREADS>(qs, q + row_base * D, r0, R, D);
    issue(tlo, 0);
    cp_async_commit();
    for (int t = tlo; t < thi; ++t) {
      const int st = (t - tlo) % STAGES;
      if (t + 1 < thi) issue(t + 1, (t + 1 - tlo) % STAGES);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and Q) landed
      if constexpr (QUANT) {
        __syncthreads();
        convert(t, st);
      }
      fence_proxy_async();
      __syncthreads();

      // S = Q K^T
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64<T>(sc, desc_k<D>(qs, kk), desc_k<D>(ks(st), kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in the exp2 domain: the pool's keys < pos0, the
      // span's at offsets <= the row's own
      const bool pool = t < npt;
      const int k0 = pool ? t * BK : (t - npt) * BK;
      float mt[2] = {tds::kMasked, tds::kMasked};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        const int key = k0 + 8 * (i / 4) + col0 + i % 2;
        const bool ok = pool ? key < npool : key <= jq[hh];
        const float x = ok ? sc[i] * sl2 : tds::kMasked;
        sc[i] = x;
        mt[hh] = fmaxf(mt[hh], x);
      }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
        const float mn = fmaxf(m[hh], mt[hh]);
        alpha[hh] = exp2f(m[hh] - mn);
        m[hh] = mn;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        sc[i] = sc[i] > tds::kMasked ? exp2f(sc[i] - m[hh]) : 0.f;
        l[hh] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // O += P V, P in q's dtype from registers
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(sc, kk, pa[kk]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, D>(acc, pa[kk], desc_mn<D>(vs(st), kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();  // stage st is free for the copy two tiles ahead
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial goes over it

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = lrow0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + col0;
    pacc[row * D + col] = acc[i];
    pacc[row * D + col + 1] = acc[i + 1];
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      pm[lrow0 + 8 * hh] = m[hh];
      pl[lrow0 + 8 * hh] = l[hh];
    }
  }
  cluster_merge<T, D>(pm, pl, pacc, wgt, BQ, rend - r0,
                      o + (row_base + r0) * D);
}

}  // namespace tc

// -- launch ---------------------------------------------------------------------

// pool pointers and everything but the span operands, shared by both
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const void *sk, *sv;
  const int *tables, *pos;
  void* o;
  int S, Hq, KVH, K1, bt, nlayer, layer, W, splits;
  bool tensor_cores;
  float scale;
  cudaStream_t st;
};

// one launch of `Kernel` over grid, in clusters of `splits` CTAs along x
template <auto Kernel, typename... Ts>
cudaError_t launch_cluster(dim3 grid, int splits, size_t smem,
                           cudaStream_t st, Ts... args) {
  static size_t allowed = 48 * 1024;  // dynamic shared memory it may take
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// table slots a CTA needs: the whole row (W <= TABLE_ROW), or the slice
// of a split that holds at most ceil(ntiles / splits) tiles of tk keys
inline int table_slots(int ntiles, int splits, int tk, int bt, int W) {
  const int per = (ntiles + splits - 1) / splits;
  return W <= TABLE_ROW ? W : (per * tk - 1) / bt + 2;
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const Args& a) {
  const float sl2 = a.scale * kLog2e;
  const int G = a.Hq / a.KVH, rows = G * a.K1;
  const auto* q = static_cast<const TQ*>(a.q);
  const auto* k = static_cast<const TKV*>(a.k);
  const auto* v = static_cast<const TKV*>(a.v);
  auto* o = static_cast<TQ*>(a.o);
  if (a.sk == nullptr) {
    const int slots = table_slots((a.W * a.bt + decode::TK - 1) / decode::TK,
                                  a.splits, decode::TK, a.bt, a.W);
    return launch_cluster<decode::paged_decode_kernel<TQ, TKV, D>>(
        dim3(a.splits, a.KVH, a.S), a.splits,
        decode::Layout<TKV, D>::bytes(G, slots), a.st, q, k, v, a.ks, a.vs,
        a.tables, a.pos, o, a.Hq, a.KVH, a.bt, a.nlayer, a.layer, a.W, sl2);
  }
  const auto* sk = static_cast<const TQ*>(a.sk);
  const auto* sv = static_cast<const TQ*>(a.sv);
  if (a.tensor_cores) {
    if constexpr (!std::is_same<TQ, float>::value && D <= 64) {
      constexpr bool QUANT = sizeof(TKV) == 1;
      const int slots = table_slots(
          (a.W * a.bt + tc::BK - 1) / tc::BK + (a.K1 + tc::BK - 1) / tc::BK,
          a.splits, tc::BK, a.bt, a.W);
      return launch_cluster<tc::paged_span_wgmma<TQ, TKV, D>>(
          dim3((rows + tc::BQ - 1) / tc::BQ * a.splits, a.KVH, a.S),
          a.splits, tc::Layout<D, QUANT>::bytes(slots), a.st, q, k, v, a.ks,
          a.vs, sk, sv, a.tables, a.pos, o, a.Hq, a.KVH, a.K1, a.bt,
          a.nlayer, a.layer, a.W, sl2);
    } else {
      return cudaErrorInvalidValue;  // f32 and Dh = 128 stay on FMA
    }
  }
  const int slots = table_slots(
      (a.W * a.bt + sfma::TK - 1) / sfma::TK + (a.K1 + sfma::TK - 1) / sfma::TK,
      a.splits, sfma::TK, a.bt, a.W);
  return launch_cluster<sfma::paged_span_fma<TQ, TKV, D>>(
      dim3((rows + sfma::ROWS - 1) / sfma::ROWS * a.splits, a.KVH, a.S),
      a.splits, sfma::Layout<TQ, TKV, D>::bytes(slots), a.st, q, k, v, a.ks,
      a.vs, sk, sv, a.tables, a.pos, o, a.Hq, a.KVH, a.K1, a.bt, a.nlayer,
      a.layer, a.W, sl2);
}

template <typename TQ, typename TKV>
cudaError_t by_dim(int D, const Args& a) {
  switch (D) {
    case 32: return launch<TQ, TKV, 32>(a);
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// supported (q, pool) pairs: equal types, f32 q over a bf16 or f16 pool,
// and f32 or bf16 q over an int8 or e4m3 pool
cudaError_t dispatch(int D, int q_dtype, int kv_dtype, const Args& a) {
  using tds::kBF16; using tds::kF16; using tds::kF32; using tds::kFP8E4M3;
  using tds::kI8;
  if (a.S <= 0 || a.KVH <= 0 || a.Hq % a.KVH || a.K1 <= 0 || a.bt <= 0 ||
      a.W <= 0 || a.layer < 0 || a.layer >= a.nlayer || a.splits < 1 ||
      a.splits > MAX_SPLITS)
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kI8 || kv_dtype == kFP8E4M3;
  if (quant != (a.ks != nullptr && a.vs != nullptr))
    return cudaErrorInvalidValue;  // scales iff the pool is quantized
#define TDS_PAGED(QC, KC, TQ, TKV) \
  if (q_dtype == QC && kv_dtype == KC) return by_dim<TQ, TKV>(D, a)
  TDS_PAGED(kF32, kF32, float, float);
  TDS_PAGED(kBF16, kBF16, __nv_bfloat16, __nv_bfloat16);
  TDS_PAGED(kF16, kF16, __half, __half);
  TDS_PAGED(kF32, kBF16, float, __nv_bfloat16);
  TDS_PAGED(kF32, kF16, float, __half);
  TDS_PAGED(kF32, kI8, float, int8_t);
  TDS_PAGED(kBF16, kI8, __nv_bfloat16, int8_t);
  TDS_PAGED(kF32, kFP8E4M3, float, __nv_fp8_e4m3);
  TDS_PAGED(kBF16, kFP8E4M3, __nv_bfloat16, __nv_fp8_e4m3);
#undef TDS_PAGED
  return cudaErrorInvalidValue;
}

}  // namespace

// Decode.  q/o (S, Hq, D) contiguous; k/v pools (NB, bt, L, KVH, D)
// contiguous; kscale/vscale (NB, bt, L, KVH) f32 on a quantized pool,
// else null; tables (S, W) and pos (S,) int32 on the device.  q_dtype /
// kv_dtype are tds::DType codes; splits (1-8) the CTAs of a cluster that
// share a slot's walk (ops/paged_attn.py split_plan).  Returns the
// launch's cudaError_t.
extern "C" int paged_decode(const void* q, const void* kpool,
                            const void* vpool, const float* kscale,
                            const float* vscale, const int* tables,
                            const int* pos, void* o, int S, int Hq, int KVH,
                            int D, int bt, int nlayer, int layer, int W,
                            int q_dtype, int kv_dtype, float scale,
                            int splits, void* stream) {
  Args a{q, kpool, vpool, kscale, vscale, nullptr, nullptr, tables, pos, o,
         S, Hq, KVH, 1, bt, nlayer, layer, W, splits, false, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(D, q_dtype, kv_dtype, a);
}

// Span verify.  q/o (S, Hq, K1, D) and sk/sv (S, KVH, K1, D) contiguous
// in q's dtype; pos0 (S,) int32 the span's first position (pool positions
// < pos0 are attended); tensor_cores 1 takes the wgmma kernel (bf16/f16
// q, D 32 or 64), 0 the FMA one; the rest as paged_decode.
extern "C" int paged_span(const void* q, const void* kpool,
                          const void* vpool, const float* kscale,
                          const float* vscale, const void* sk,
                          const void* sv, const int* tables,
                          const int* pos0, void* o, int S, int Hq, int KVH,
                          int K1, int D, int bt, int nlayer, int layer,
                          int W, int q_dtype, int kv_dtype, float scale,
                          int splits, int tensor_cores, void* stream) {
  if (sk == nullptr || sv == nullptr) return cudaErrorInvalidValue;
  Args a{q, kpool, vpool, kscale, vscale, sk, sv, tables, pos0, o,
         S, Hq, KVH, K1, bt, nlayer, layer, W, splits, tensor_cores != 0,
         scale, static_cast<cudaStream_t>(stream)};
  return dispatch(D, q_dtype, kv_dtype, a);
}
