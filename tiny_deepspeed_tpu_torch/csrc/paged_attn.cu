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
//  * quantized pool (:196-198): each resting element is dequantized in
//    registers as float(code) * scale[blk, t, l, h], with no rounding to
//    the compute dtype in between.
//
// Decode design.  On the TPU the block table arrives through scalar
// prefetch and the sequential grid walks table entries with VMEM-resident
// softmax stats.  Here one CTA owns one (slot, kv head) and walks the
// slot's table row itself; its warps take table entries round-robin.
// Within a warp, lane pairs own one token each (lanes t and t+16 hold the
// two halves of the head vector), so a warp folds 16 tokens per step: a
// shuffle completes each token's dot product, a 16-lane max gives the
// step's shared running max, and each lane keeps its own partial (l, acc)
// that reduce across the warp once at the end; the warps then merge
// through shared memory.  Rows are read with the pool's own strides, in
// 16-byte loads, and only for positions <= pos[s]: no panel is gathered
// into device memory and no masked token is read.
//
// Span design.  One query per lane pair does not carry a span of up to
// 1024 queries.  Grid (S, KVH, ceil(G*K1 / 16)): a CTA owns 16 query rows
// (row r = g*K1 + j, as Pallas groups them) of one slot and KV head, eight
// lanes per row, each lane holding D/8 of the head dims.  The CTA stages
// 16 keys at a time in shared memory as f32 K and V (dequantized there on
// a quantized pool): first the pool tokens < pos[s], each read once for
// all 16 rows — the reuse that is the variant's point (Pallas docstring
// :25-30) — then the span's own keys up to the largest offset the CTA
// holds.  Each chunk folds into the rows' online softmax: f32 scores,
// masked score -1e30 with its weight forced to 0, output acc / l in q's
// dtype.  Every row sees at least its span key 0, so l > 0 and pad rows
// stay finite.
//
// Bound: both variants read every live K/V element once (1 byte plus a
// 4-byte scale per head vector on a quantized pool) and do a few flops
// per element (the span: ~4 per element per query row, at most K1 rows)
// — far below the card's ~300 flop/byte balance point at these spans, so
// they are bound by the bytes they must move: live pool K/V (+ scales),
// q, the span's K/V and the output.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TOK = 16;  // tokens a warp folds per step

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ kpool,
                    const TK* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, TQ* __restrict__ o,
                    int Hq, int KVH, int bt, int nlayer, int layer, int W,
                    float scale) {
  constexpr int HALF = D / 2;
  constexpr bool QUANT = sizeof(TK) == 1;
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];

  const int s = blockIdx.x, kvh = blockIdx.y;
  const int G = Hq / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tok = lane % TOK, half = lane / TOK;
  const int limit = pos[s];
  const int nblk = min(limit / bt + 1, W);  // table entries holding 0..limit
  const size_t tok_stride = (size_t)nlayer * KVH * D;
  const size_t blk_stride = (size_t)bt * tok_stride;
  const size_t head_off = ((size_t)layer * KVH + kvh) * D + half * HALF;
  const size_t sc_off = (size_t)layer * KVH + kvh;  // scales drop D
  const int* trow = tables + (size_t)s * W;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    float qr[HALF], acc[HALF];
    {
      const TQ* qp = q + ((size_t)s * Hq + h) * D + half * HALF;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        qr[i] = tds::to_f(qp[i]) * scale;
        acc[i] = 0.f;
      }
    }
    float m = tds::kMasked, l = 0.f;

    for (int j = warp; j < nblk; j += WARPS) {
      const size_t base = (size_t)trow[j] * blk_stride + head_off;
      for (int t0 = 0; t0 < bt; t0 += TOK) {
        const int t = t0 + tok;
        const bool ok = t < bt && j * bt + t <= limit;
        float dot = 0.f;
        float vr[HALF];
        if (ok) {
          float kr[HALF];
          tds::load_row<HALF>(kpool + base + (size_t)t * tok_stride, kr);
          tds::load_row<HALF>(vpool + base + (size_t)t * tok_stride, vr);
          if constexpr (QUANT) {
            const size_t si =
                ((size_t)trow[j] * bt + t) * nlayer * KVH + sc_off;
            const float ks = kscale[si], vs = vscale[si];
#pragma unroll
            for (int i = 0; i < HALF; ++i) {
              kr[i] *= ks;
              vr[i] *= vs;
            }
          }
#pragma unroll
          for (int i = 0; i < HALF; ++i) dot = fmaf(qr[i], kr[i], dot);
        } else {
#pragma unroll
          for (int i = 0; i < HALF; ++i) vr[i] = 0.f;
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, TOK);  // join the halves
        const float sc = ok ? dot : tds::kMasked;
        float mx = sc;
#pragma unroll
        for (int off = TOK / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m, mx);
        const float alpha = __expf(m - mn);
        const float p = ok ? __expf(sc - mn) : 0.f;
        l = l * alpha + p;
#pragma unroll
        for (int i = 0; i < HALF; ++i) acc[i] = fmaf(p, vr[i], acc[i] * alpha);
        m = mn;
      }
    }

    // reduce the 16 token lanes of each half (m is already warp-uniform)
#pragma unroll
    for (int off = TOK / 2; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int i = 0; i < HALF; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    if (tok == 0) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) sm_acc[warp][half * HALF + i] = acc[i];
      if (half == 0) {
        sm_m[warp] = m;
        sm_l[warp] = l;
      }
    }
    __syncthreads();
    if (threadIdx.x < D) {
      float M = tds::kMasked;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w]);
      float L = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = __expf(sm_m[w] - M);
        L = fmaf(sm_l[w], c, L);
        a = fmaf(sm_acc[w][threadIdx.x], c, a);
      }
      o[((size_t)s * Hq + h) * D + threadIdx.x] = tds::from_f<TQ>(a / L);
    }
    __syncthreads();  // shared memory is reused by the next group head
  }
}

// -- the span-verify variant -------------------------------------------------

constexpr int SQT = 16;    // query rows a CTA owns
constexpr int SCH = 16;    // keys staged per chunk
constexpr int SLANES = 8;  // lanes per query row
constexpr int STHREADS = SQT * SLANES;
constexpr int SEG = 16;    // elements one staging load moves

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(STHREADS)
paged_span_kernel(const TQ* __restrict__ q, const TK* __restrict__ kpool,
                  const TK* __restrict__ vpool,
                  const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  const TQ* __restrict__ sk, const TQ* __restrict__ sv,
                  const int* __restrict__ tables,
                  const int* __restrict__ pos0, TQ* __restrict__ o, int Hq,
                  int KVH, int K1, int bt, int nlayer, int layer, int W,
                  float scale) {
  constexpr int DPT = D / SLANES;  // a lane's head dims: part + SLANES*i
  constexpr int NSEG = D / SEG;
  constexpr bool QUANT = sizeof(TK) == 1;
  __shared__ float ks_[SCH][D + 1], vs_[SCH][D + 1];

  const int s = blockIdx.x, kvh = blockIdx.y;
  const int R = (Hq / KVH) * K1;  // query rows of this (slot, kv head)
  const int r0 = blockIdx.z * SQT;
  const int row = threadIdx.x / SLANES, part = threadIdx.x % SLANES;
  const int r = r0 + row;
  const bool live = r < R;
  const int jq = live ? r % K1 : 0;  // the row's span offset
  int jmax = 0;                      // the largest offset the CTA holds
  for (int rr = r0; rr < min(r0 + SQT, R); ++rr) jmax = max(jmax, rr % K1);
  const int npool = min(pos0[s], W * bt);  // pool positions < pos0
  const size_t row_base = (size_t)s * Hq * K1 + (size_t)kvh * R;

  float qr[DPT], acc[DPT];
  {
    const TQ* qp = q + (row_base + (live ? r : r0)) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = live ? tds::to_f(qp[part + SLANES * i]) * scale : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = tds::kMasked, l = 0.f;

  // fold the staged chunk's keys [0, nvalid) (all rows) or, on the span,
  // those at offsets <= the row's own (c0 + c <= jq)
  auto fold = [&](int c0, int nvalid, bool span) {
    float sc[SCH];
    float mx = tds::kMasked;
#pragma unroll
    for (int c = 0; c < SCH; ++c) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        d = fmaf(qr[i], ks_[c][part + SLANES * i], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      const bool ok = c < nvalid && (!span || c0 + c <= jq);
      sc[c] = ok ? d : tds::kMasked;
      mx = fmaxf(mx, sc[c]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = __expf(m - mn);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int c = 0; c < SCH; ++c) {
      const float p = sc[c] > tds::kMasked ? __expf(sc[c] - mn) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(p, vs_[c][part + SLANES * i], acc[i]);
    }
    m = mn;
  };

  // stage into ks_/vs_ the rows row_ptr(side, c) for c < nvalid (zeros
  // past it), scaled by scale_of(side, c) on a quantized pool
  auto stage = [&](int nvalid, auto row_ptr, auto scale_of) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < 2 * SCH * NSEG; e += STHREADS) {
      const int side = e / (SCH * NSEG), rem = e % (SCH * NSEG);
      const int c = rem / NSEG, seg = rem % NSEG;
      float buf[SEG];
      if (c < nvalid) {
        row_ptr(side, c, seg, buf);
        const float f = scale_of(side, c);
#pragma unroll
        for (int i = 0; i < SEG; ++i) buf[i] *= f;
      } else {
#pragma unroll
        for (int i = 0; i < SEG; ++i) buf[i] = 0.f;
      }
      float* dst = side ? &vs_[c][seg * SEG] : &ks_[c][seg * SEG];
#pragma unroll
      for (int i = 0; i < SEG; ++i) dst[i] = buf[i];
    }
    __syncthreads();
  };

  // 1. the committed prefix: pool positions < pos0, read once per CTA
  const size_t tok_stride = (size_t)nlayer * KVH * D;
  const size_t head_off = ((size_t)layer * KVH + kvh) * D;
  const size_t sc_off = (size_t)layer * KVH + kvh;
  const int* trow = tables + (size_t)s * W;
  for (int c0 = 0; c0 < npool; c0 += SCH) {
    const int nvalid = min(SCH, npool - c0);
    auto tokrow = [&](int c) {
      const int p = c0 + c;
      return (size_t)trow[p / bt] * bt + p % bt;
    };
    stage(
        nvalid,
        [&](int side, int c, int seg, float* buf) {
          tds::load_row<SEG>((side ? vpool : kpool) + tokrow(c) * tok_stride
                                 + head_off + seg * SEG,
                             buf);
        },
        [&](int side, int c) {
          if constexpr (QUANT)
            return (side ? vscale : kscale)[tokrow(c) * nlayer * KVH
                                            + sc_off];
          return 1.f;
        });
    fold(c0, nvalid, false);
  }

  // 2. the span's own keys, offsets 0..jmax, under the windowed mask
  const size_t span_base = ((size_t)s * KVH + kvh) * K1 * D;
  for (int c0 = 0; c0 <= jmax; c0 += SCH) {
    const int nvalid = min(SCH, K1 - c0);
    stage(
        nvalid,
        [&](int side, int c, int seg, float* buf) {
          tds::load_row<SEG>((side ? sv : sk) + span_base
                                 + (size_t)(c0 + c) * D + seg * SEG,
                             buf);
        },
        [&](int, int) { return 1.f; });
    fold(c0, nvalid, true);
  }

  if (live) {
    TQ* op = o + (row_base + r) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      op[part + SLANES * i] = tds::from_f<TQ>(acc[i] / l);
  }
}

// pool pointers and everything but the span operands, shared by both
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const void *sk, *sv;
  const int *tables, *pos;
  void* o;
  int S, Hq, KVH, K1, bt, nlayer, layer, W;
  float scale;
  cudaStream_t st;
};

template <typename TQ, typename TK, int D>
cudaError_t launch(const Args& a) {
  if (a.sk == nullptr) {
    paged_decode_kernel<TQ, TK, D><<<dim3(a.S, a.KVH), THREADS, 0, a.st>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const TK*>(a.v), a.ks, a.vs, a.tables, a.pos,
        static_cast<TQ*>(a.o), a.Hq, a.KVH, a.bt, a.nlayer, a.layer, a.W,
        a.scale);
  } else {
    const int rows = (a.Hq / a.KVH) * a.K1;
    dim3 grid(a.S, a.KVH, (rows + SQT - 1) / SQT);
    paged_span_kernel<TQ, TK, D><<<grid, STHREADS, 0, a.st>>>(
        static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k),
        static_cast<const TK*>(a.v), a.ks, a.vs,
        static_cast<const TQ*>(a.sk), static_cast<const TQ*>(a.sv),
        a.tables, a.pos, static_cast<TQ*>(a.o), a.Hq, a.KVH, a.K1, a.bt,
        a.nlayer, a.layer, a.W, a.scale);
  }
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t by_dim(int D, const Args& a) {
  switch (D) {
    case 32: return launch<TQ, TK, 32>(a);
    case 64: return launch<TQ, TK, 64>(a);
    case 128: return launch<TQ, TK, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// supported (q, pool) pairs: equal types, f32 q over a bf16 or f16 pool,
// and f32 or bf16 q over an int8 or e4m3 pool
cudaError_t dispatch(int D, int q_dtype, int kv_dtype, const Args& a) {
  using tds::kBF16; using tds::kF16; using tds::kF32; using tds::kFP8E4M3;
  using tds::kI8;
  if (a.S <= 0 || a.KVH <= 0 || a.Hq % a.KVH || a.K1 <= 0 || a.bt <= 0 ||
      a.W <= 0 || a.layer < 0 || a.layer >= a.nlayer)
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kI8 || kv_dtype == kFP8E4M3;
  if (quant != (a.ks != nullptr && a.vs != nullptr))
    return cudaErrorInvalidValue;  // scales iff the pool is quantized
#define TDS_PAGED(QC, KC, TQ, TK) \
  if (q_dtype == QC && kv_dtype == KC) return by_dim<TQ, TK>(D, a)
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
// kv_dtype are tds::DType codes.  Returns the launch's cudaError_t.
extern "C" int paged_decode(const void* q, const void* kpool,
                            const void* vpool, const float* kscale,
                            const float* vscale, const int* tables,
                            const int* pos, void* o, int S, int Hq, int KVH,
                            int D, int bt, int nlayer, int layer, int W,
                            int q_dtype, int kv_dtype, float scale,
                            void* stream) {
  Args a{q, kpool, vpool, kscale, vscale, nullptr, nullptr, tables, pos, o,
         S, Hq, KVH, 1, bt, nlayer, layer, W, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(D, q_dtype, kv_dtype, a);
}

// Span verify.  q/o (S, Hq, K1, D) and sk/sv (S, KVH, K1, D) contiguous
// in q's dtype; pos0 (S,) int32 the span's first position (pool positions
// < pos0 are attended); the rest as paged_decode.
extern "C" int paged_span(const void* q, const void* kpool,
                          const void* vpool, const float* kscale,
                          const float* vscale, const void* sk,
                          const void* sv, const int* tables,
                          const int* pos0, void* o, int S, int Hq, int KVH,
                          int K1, int D, int bt, int nlayer, int layer,
                          int W, int q_dtype, int kv_dtype, float scale,
                          void* stream) {
  if (sk == nullptr || sv == nullptr) return cudaErrorInvalidValue;
  Args a{q, kpool, vpool, kscale, vscale, sk, sv, tables, pos0, o,
         S, Hq, KVH, K1, bt, nlayer, layer, W, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(D, q_dtype, kv_dtype, a);
}
