// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// FlashAttention-2 forward for Hopper (sm_90a), plain-FMA version: causal,
// or unmasked for a ring attention chunk.
//
// Replaces the TPU kernel tiny_deepspeed_tpu/ops/flash_fa2.py::
// fa2_flash_attention -> _fwd (:125, pallas_call :129) / _fwd_kernel (:68),
// and its chunk entry fa2_chunk_fwd (:330) with causal=False: every key of
// the chunk is visible to every query (the kernel's nfull = ndiag = all
// k-blocks, :103-108).  `causal` is a template flag chosen at launch, so
// the causal instantiation is the code it was before the flag.
// Same contract: q (B*H, T, D), k/v (B*KVH, T, D) with query head h
// reading kv head h / (H/KVH); emits o in the input dtype and the fused
// softmax statistic lse = m + log(l) in f32, which the training slice's
// backward consumes.
//
// Design.  The TPU kernel keeps whole K/V panels resident in VMEM (up to
// FA2_MAX_T); a Hopper SM has 227 KB of shared memory, so here K/V stream
// through shared memory in BK-key tiles and any T works.  One CTA owns
// BQ query rows of one (batch, head); causal, the loop over key tiles
// stops at the tile holding the CTA's last row (causality by loop bound),
// and a per-key test masks the diagonal tile and the ragged tail;
// unmasked, the loop covers the whole chunk and the test masks only the
// ragged tail.  Each query
// row is split over SPLIT threads that take interleaved keys with their
// own online-softmax state (m, l, acc in f32 registers); the SPLIT partial
// states merge through warp shuffles at the end.
//
// Bound: at gpt2-124m prefill shapes (T <= 1024, D = 64) the op does
// ~4*T^2/2*D flops per head against 4*T*D*2 bytes, ~100-300 flop/byte:
// compute-bound on the tensor cores' scale (989 TFLOP/s bf16).  This
// version computes with FP32 FMAs (67 TFLOP/s), so it is compute-bound
// well above the tensor-core bound; moving QK^T and PV onto mma/wgmma is
// the next step, after this one is right.

#include "common.cuh"

namespace {

constexpr int BQ = 32;                 // query rows per CTA
constexpr int BK = 64;                 // keys per shared-memory tile
constexpr int SPLIT = 4;               // threads per query row
constexpr int THREADS = BQ * SPLIT;    // 128
constexpr int KPT = BK / SPLIT;        // keys per thread per tile

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seqlen, int H, int KVH,
                 float scale) {
  // +1 pad: the SPLIT threads of a row read SPLIT different key rows at
  // the same column; the odd stride puts them in different banks
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];

  const int bh = blockIdx.y;                       // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvbh = b * KVH + h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int part = tid % SPLIT;                    // key residue mod SPLIT
  const int row = q0 + tid / SPLIT;
  const bool valid = row < seqlen;

  const T* kp = k + (size_t)kvbh * seqlen * D;
  const T* vp = v + (size_t)kvbh * seqlen * D;

  float qr[D], acc[D];
  {
    const T* qp = q + ((size_t)bh * seqlen + (valid ? row : 0)) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = valid ? tds::to_f(qp[d]) * scale : 0.f;
      acc[d] = 0.f;
    }
  }
  float m = tds::kMasked, l = 0.f;

  // causal: no row of this CTA sees a key past its last row; unmasked:
  // every key of the chunk
  const int kend = CAUSAL ? min(seqlen, q0 + BQ) : seqlen;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int kr = e / D, c = e % D;
      const int key = k0 + kr;
      float kv = 0.f, vv = 0.f;
      if (key < kend) {
        kv = tds::to_f(kp[(size_t)key * D + c]);
        vv = tds::to_f(vp[(size_t)key * D + c]);
      }
      ks[kr][c] = kv;
      vs[kr][c] = vv;
    }
    __syncthreads();

    float s[KPT];
    float mt = tds::kMasked;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kr = i * SPLIT + part;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[kr][d], dot);
      const bool ok = valid && (CAUSAL ? (k0 + kr) <= row
                                       : (k0 + kr) < seqlen);
      s[i] = ok ? dot : tds::kMasked;
      mt = fmaxf(mt, s[i]);
    }
    const float mn = fmaxf(m, mt);
    const float alpha = __expf(m - mn);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kr = i * SPLIT + part;
      const bool ok = valid && (CAUSAL ? (k0 + kr) <= row
                                       : (k0 + kr) < seqlen);
      const float p = ok ? __expf(s[i] - mn) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[kr][d], acc[d]);
    }
    m = mn;
  }

  // merge the SPLIT partial states of each row (adjacent lanes)
  float M = m;
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  const float c = __expf(m - M);
  l *= c;
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d] * c;
#pragma unroll
    for (int off = 1; off < SPLIT; off <<= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    acc[d] = a;
  }
  if (!valid) return;
  const float inv = 1.f / l;
  T* op = o + ((size_t)bh * seqlen + row) * D;
  constexpr int DPT = D / SPLIT;  // columns each thread of the row stores
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d / DPT == part) op[d] = tds::from_f<T>(acc[d] * inv);
  }
  if (part == 0) lse[(size_t)bh * seqlen + row] = M + logf(l);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KVH, int seqlen,
                   bool causal, float scale, cudaStream_t stream) {
  dim3 grid((seqlen + BQ - 1) / BQ, B * H);
  auto kernel = causal ? flash_fwd_kernel<T, D, true>
                       : flash_fwd_kernel<T, D, false>;
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seqlen, H, KVH,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int H, int KVH, int seqlen,
                   bool causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, KVH, seqlen, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, KVH, seqlen, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B*H, T, D), k/v (B*KVH, T, D), o like q, lse (B*H, T) f32; all
// contiguous on the device; dtype: tds::DType; causal 1 (a query sees the
// keys at or before its position) or 0 (every key).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int KVH,
                         int seqlen, int D, int dtype, int causal,
                         float scale, void* stream) {
  if (B <= 0 || seqlen <= 0 || KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  switch (dtype) {
    case tds::kF32:
      return by_dim<float>(D, q, k, v, o, lse, B, H, KVH, seqlen, c, scale, st);
    case tds::kBF16:
      return by_dim<__nv_bfloat16>(D, q, k, v, o, lse, B, H, KVH, seqlen, c, scale, st);
    case tds::kF16:
      return by_dim<__half>(D, q, k, v, o, lse, B, H, KVH, seqlen, c, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
