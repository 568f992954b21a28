// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// Paged decode attention for Hopper (sm_90a): one query token per slot
// attends to its K/V read straight out of the paged pool.
//
// Replaces the TPU kernel tiny_deepspeed_tpu/ops/paged_attn_pallas.py::
// paged_attention (:228, pallas_call :311), decode variant (span_kv=None,
// unquantized pool).  Same contract: q (S, Hq, D); pool k/v
// (NB, bt, L, KVH, D) in the resting dtype; tables (S, W) int32 physical
// block ids; pos (S,) int32; slot s attends to positions 0..pos[s]
// inclusive of layer `layer`; output (S, Hq, D) in q's dtype.
//
// Design.  On the TPU the block table arrives through scalar prefetch and
// the sequential grid walks table entries with VMEM-resident softmax
// stats.  Here one CTA owns one (slot, kv head) and walks the slot's
// table row itself; its warps take table entries round-robin.  Within a
// warp, lane pairs own one token each (lanes t and t+16 hold the two
// halves of the head vector), so a warp folds 16 tokens per step: a
// shuffle completes each token's dot product, a 16-lane max gives the
// step's shared running max, and each lane keeps its own partial
// (l, acc) that reduce across the warp once at the end; the warps then
// merge through shared memory.  Rows are read with the pool's own
// strides, in 16-byte loads, and only for positions <= pos[s]: no panel
// is gathered into device memory and no masked token is read.
//
// Bound: decode reads every live K/V row once and does ~4 flops per
// element read (~2 flop/byte), far below the card's ~300 flop/byte
// balance point: the kernel is bound by the K/V bytes it must read.
// The query heads of one GQA group walk the blocks one after another in
// the same CTA (the second pass hits L2); gpt2 has group 1.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TOK = 16;  // tokens a warp folds per step

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ kpool,
                    const TK* __restrict__ vpool,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, TQ* __restrict__ o,
                    int Hq, int KVH, int bt, int nlayer, int layer, int W,
                    float scale) {
  constexpr int HALF = D / 2;
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

template <typename TQ, typename TK, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* pos, void* o, int S,
                   int Hq, int KVH, int bt, int nlayer, int layer, int W,
                   float scale, cudaStream_t stream) {
  dim3 grid(S, KVH);
  paged_decode_kernel<TQ, TK, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), tables, pos, static_cast<TQ*>(o), Hq, KVH,
      bt, nlayer, layer, W, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v,
                   const int* tables, const int* pos, void* o, int S,
                   int Hq, int KVH, int bt, int nlayer, int layer, int W,
                   float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<TQ, TK, 32>(q, k, v, tables, pos, o, S, Hq, KVH, bt, nlayer, layer, W, scale, st);
    case 64: return launch<TQ, TK, 64>(q, k, v, tables, pos, o, S, Hq, KVH, bt, nlayer, layer, W, scale, st);
    case 128: return launch<TQ, TK, 128>(q, k, v, tables, pos, o, S, Hq, KVH, bt, nlayer, layer, W, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o (S, Hq, D) contiguous; k/v pools (NB, bt, L, KVH, D) contiguous;
// tables (S, W) and pos (S,) int32 on the device.  q_dtype/kv_dtype are
// tds::DType codes; supported pairs: equal types, or f32 q over a bf16 or
// f16 pool.  Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode(const void* q, const void* kpool,
                            const void* vpool, const int* tables,
                            const int* pos, void* o, int S, int Hq, int KVH,
                            int D, int bt, int nlayer, int layer, int W,
                            int q_dtype, int kv_dtype, float scale,
                            void* stream) {
  if (S <= 0 || KVH <= 0 || Hq % KVH || bt <= 0 || W <= 0 || layer < 0 ||
      layer >= nlayer)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TDS_PAGED(TQ, TK) \
  return by_dim<TQ, TK>(D, q, kpool, vpool, tables, pos, o, S, Hq, KVH, bt, nlayer, layer, W, scale, st)
  if (q_dtype == tds::kF32 && kv_dtype == tds::kF32) TDS_PAGED(float, float);
  if (q_dtype == tds::kBF16 && kv_dtype == tds::kBF16) TDS_PAGED(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == tds::kF16 && kv_dtype == tds::kF16) TDS_PAGED(__half, __half);
  if (q_dtype == tds::kF32 && kv_dtype == tds::kBF16) TDS_PAGED(float, __nv_bfloat16);
  if (q_dtype == tds::kF32 && kv_dtype == tds::kF16) TDS_PAGED(float, __half);
#undef TDS_PAGED
  return cudaErrorInvalidValue;
}
