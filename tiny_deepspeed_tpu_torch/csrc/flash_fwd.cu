// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// FlashAttention-2 forward for Hopper (sm_90a): causal, or unmasked for a
// ring attention chunk.  bf16/f16 run on the tensor cores (wgmma); f32
// keeps the FP32-FMA kernel.
//
// Replaces the TPU kernel tiny_deepspeed_tpu/ops/flash_fa2.py::
// fa2_flash_attention -> _fwd (:125, pallas_call :129) / _fwd_kernel (:68),
// and its chunk entry fa2_chunk_fwd (:330) with causal=False: every key of
// the chunk is visible to every query (the kernel's nfull = ndiag = all
// k-blocks, :103-108).  `causal` is a template flag chosen at launch.
// Same contract: q (B*H, T, D), k/v (B*KVH, T, D) with query head h
// reading kv head h / (H/KVH); emits o in the input dtype and the fused
// softmax statistic lse = m + log(l) in f32, which the training slice's
// backward consumes.
//
// Heads-last (`flash_fwd_bthd`): also replaces the TPU kernel of
// fa2_flash_attention_bthd (:596) -> _fa2_bthd_fwd (:616, pallas_call
// :630, kernel _fwd_kernel_ah :453), causal, on q/k/v/o (B, T, H, D) with
// lse still f32 (B*H, T).  The TPU kernel reads each batch element's
// whole (T, H*D) panel and loops the heads inside one program (Mosaic's
// tiling rule forbids a one-head block; VMEM bounds the panel).  Here the
// layout is only a stride: the `BTHD` template flag addresses row r of
// head h at ((b*T + r)*H + h)*D, rows H*D apart, and everything else is
// the same kernel — the same operations in the same order, so its
// results are bit for bit those of the (B, H, T, D) kernel on the
// transposed copies.  Each row is still D contiguous elements (128 B at
// bf16, D = 64).
//
// Design, bf16/f16 (`flash_fwd_wgmma`).  The TPU kernel keeps whole K/V
// panels resident in VMEM (up to FA2_MAX_T); a Hopper SM has 227 KB of
// shared memory, so here K/V stream through it and any T works.  One CTA
// is one warpgroup (128 threads) and owns BQ = 64 query rows of one
// (batch, head); causal CTAs are launched heaviest (last row block) first.
// Its Q tile is copied into shared memory once; K and V stream through a
// ring of STAGES = 2 stages of BK = 64-key tiles, each copied with
// cp.async (16 bytes a thread, zero-filled past T) one tile ahead of the
// compute, so the copy of tile j+1 overlaps the products of tile j.
// Tiles are bf16/f16 rows in the 128-byte (D = 64) or 64-byte (D = 32)
// swizzle (hopper.cuh).  Per key tile:
//   S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//     D/16 k-steps, f32 accumulators in registers (32 a thread);
//   online softmax on the accumulator fragment: each thread holds two rows
//     x 16 keys; row max by two shuffles over the 4 lanes of a row, exp2
//     of the scores pre-scaled by scale*log2(e) in f32, the row sum kept
//     per thread and reduced once at the end;
//   O += P V: P rounded to the input dtype in registers is the A operand
//     (wgmma m64nDk16, A from registers), V the B operand in shared
//     memory, MN-major (transpose bit): 4 k-steps of 16 keys.
// Causal, the key loop stops at the tile holding the CTA's last row
// (BQ = BK: the diagonal tile), and only that tile and the ragged tail
// are masked; unmasked, only the ragged tail.  o = acc / l in the input
// dtype, lse = (m + log2 l) ln 2.  ptxas: 96 registers at D = 64 (104
// heads-last), 75 at D = 32, no spills; dynamic shared memory (5 tiles +
// alignment) 41984 bytes at D = 64, 21504 at D = 32 (flash_fwd_smem_bytes
// reports it): 5 CTAs an SM.
// Filling the card: at B=1 T=1024 (serving's prefill) 16 x 12 = 192
// CTAs, at B=8 1536; with 5 resident on each of the 132 SMs (660), B=1
// is one partial wave and B=8 between two and three.
//
// Design, f32 (`flash_fwd_kernel`, unchanged).  f32 attention stays f32:
// the tests hold it to 1e-4 and the f32 serving path's greedy tokens to
// identity, which TF32 (about three digits) would not keep.  One CTA owns
// 32 query rows, each split over 4 threads that take interleaved keys
// with their own online-softmax state (m, l, acc in f32 registers) and
// merge through warp shuffles; K/V tiles are converted to f32 in shared
// memory.  The dispatch by dtype picks one of two hand-written kernels;
// neither falls back to the other.
//
// Bound: at gpt2-124m prefill shapes (T <= 1024, D = 64) the op does
// 4*T^2/2*D flops per head against 4*T*D*2 bytes, ~100-300 flop/byte: the
// tensor cores (989 TFLOP/s bf16) and HBM (3.35 TB/s) bound it within a
// factor of ~1.2 of each other (at B=8 T=1024: 0.0130 ms of operations,
// 0.0151 ms of bytes).  The wgmma kernel's limits are the serial chain
// within a tile (S, then softmax, then PV, with no second warpgroup to
// overlap it) and the one-warpgroup CTA re-reading K/V per 64 rows; the
// f32 kernel's is the FP32 FMA rate (67 TFLOP/s).

#include "common.cuh"
#include "hopper.cuh"

namespace {

// -- f32: FP32 FMAs ---------------------------------------------------------

namespace fp32 {

constexpr int BQ = 32;                 // query rows per CTA
constexpr int BK = 64;                 // keys per shared-memory tile
constexpr int SPLIT = 4;               // threads per query row
constexpr int THREADS = BQ * SPLIT;    // 128
constexpr int KPT = BK / SPLIT;        // keys per thread per tile

template <typename T, int D, bool CAUSAL, bool BTHD>
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
  const size_t qoff = tds::panel_offset<BTHD>(b, h, H, seqlen, D);
  const size_t kvoff = tds::panel_offset<BTHD>(b, h / (H / KVH), KVH,
                                               seqlen, D);
  const int qld = tds::row_stride<BTHD>(H, D);
  const int kvld = tds::row_stride<BTHD>(KVH, D);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int part = tid % SPLIT;                    // key residue mod SPLIT
  const int row = q0 + tid / SPLIT;
  const bool valid = row < seqlen;

  const T* kp = k + kvoff;
  const T* vp = v + kvoff;

  float qr[D], acc[D];
  {
    const T* qp = q + qoff + (size_t)(valid ? row : 0) * qld;
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
        kv = tds::to_f(kp[(size_t)key * kvld + c]);
        vv = tds::to_f(vp[(size_t)key * kvld + c]);
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
  T* op = o + qoff + (size_t)row * qld;
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
                   bool causal, bool bthd, float scale, cudaStream_t stream) {
  dim3 grid((seqlen + BQ - 1) / BQ, B * H);
  // heads-last is causal only (its one entry, fa2_flash_attention_bthd)
  auto kernel = bthd ? flash_fwd_kernel<T, D, true, true>
                : causal ? flash_fwd_kernel<T, D, true, false>
                         : flash_fwd_kernel<T, D, false, false>;
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seqlen, H, KVH,
      scale);
  return cudaGetLastError();
}

}  // namespace fp32

// -- bf16 / f16: tensor cores ----------------------------------------------

namespace tc {

using namespace tds::sm90;

constexpr int BQ = 64;                 // query rows per CTA (one warpgroup)
constexpr int BK = 64;                 // keys per tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int THREADS = 128;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return 64 * D * 2; }

// Q, then K and V of each stage; +1024 to align the base
template <int D>
__host__ __device__ constexpr int smem_bytes() { return (1 + 2 * STAGES) * tile_bytes<D>() + 1024; }

template <typename T, int D, bool CAUSAL, bool BTHD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int seqlen, int H, int KVH,
                float scale) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t TB = tile_bytes<D>();
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto ks = [&](int st) { return qs + TB * (1 + 2 * st); };
  auto vs = [&](int st) { return qs + TB * (2 + 2 * st); };

  const int bh = blockIdx.y;                       // b * H + h
  const int b = bh / H, h = bh % H;
  // causal: the row blocks with the most key tiles start first
  const int q0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const size_t qoff = tds::panel_offset<BTHD>(b, h, H, seqlen, D);
  const size_t kvoff = tds::panel_offset<BTHD>(b, h / (H / KVH), KVH,
                                               seqlen, D);
  const int qld = tds::row_stride<BTHD>(H, D);
  const int kvld = tds::row_stride<BTHD>(KVH, D);
  const T* kp = k + kvoff;
  const T* vp = v + kvoff;
  // causal: no row of this CTA sees a key past its last row; unmasked:
  // every key of the chunk
  const int kend = CAUSAL ? min(seqlen, q0 + BQ) : seqlen;
  const int ntiles = (kend + BK - 1) / BK;

  load_tile64<T, D, THREADS>(qs, q + qoff, q0, seqlen, qld);
  load_tile64<T, D, THREADS>(ks(0), kp, 0, seqlen, kvld);
  load_tile64<T, D, THREADS>(vs(0), vp, 0, seqlen, kvld);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp + lane / 4;      // rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);                 // + 8j + e in a tile
  const float sl2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {tds::kMasked, tds::kMasked}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < ntiles; ++kt) {
    const int st = kt % STAGES;
    if (kt + 1 < ntiles) {  // the next tile's copy overlaps this one
      const int nst = (kt + 1) % STAGES;
      load_tile64<T, D, THREADS>(ks(nst), kp, (kt + 1) * BK, seqlen, kvld);
      load_tile64<T, D, THREADS>(vs(nst), vp, (kt + 1) * BK, seqlen, kvld);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(s, desc_k<D>(qs, kk), desc_k<D>(ks(st), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax over this tile, in the exp2 domain
    const int k0 = kt * BK;
    const bool edge = (CAUSAL && k0 + BK > q0 + 1) || k0 + BK > seqlen;
    float mt[2] = {tds::kMasked, tds::kMasked};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i / 2) % 2;
      float x = s[i] * sl2;
      if (edge) {
        const int key = k0 + 8 * (i / 4) + col0 + i % 2;
        const int row = row0 + 8 * hh;
        const bool ok = CAUSAL ? key <= row && key < seqlen : key < seqlen;
        x = ok ? x : tds::kMasked;
      }
      s[i] = x;
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
      s[i] = exp2f(s[i] - m[hh]);
      l[hh] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // O += P V, P in the input dtype from registers
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(s, kk, pa[kk]);
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

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hh = (i / 2) % 2;
    const int row = row0 + 8 * hh;
    if (row < seqlen) {
      T* op = o + qoff + (size_t)row * qld + 8 * (i / 4) + col0;
      *reinterpret_cast<uint32_t*>(op) =
          pack2<T>(acc[i] * inv[hh], acc[i + 1] * inv[hh]);
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row < seqlen)
        lse[(size_t)bh * seqlen + row] = (m[hh] + log2f(l[hh])) * kLn2;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KVH, int seqlen,
                   bool causal, bool bthd, float scale, cudaStream_t stream) {
  dim3 grid((seqlen + BQ - 1) / BQ, B * H);
  // heads-last is causal only (its one entry, fa2_flash_attention_bthd)
  auto kernel = bthd ? flash_fwd_wgmma<T, D, true, true>
                : causal ? flash_fwd_wgmma<T, D, true, false>
                         : flash_fwd_wgmma<T, D, false, false>;
  kernel<<<grid, THREADS, smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seqlen, H, KVH,
      scale);
  return cudaGetLastError();
}

}  // namespace tc

// f32 -> the FMA kernel, bf16/f16 -> the tensor-core kernel
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KVH, int seqlen,
                   bool causal, bool bthd, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return fp32::launch<T, D>(q, k, v, o, lse, B, H, KVH, seqlen, causal,
                              bthd, scale, stream);
  else
    return tc::launch<T, D>(q, k, v, o, lse, B, H, KVH, seqlen, causal,
                            bthd, scale, stream);
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int H, int KVH, int seqlen,
                   bool causal, bool bthd, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, KVH, seqlen, causal, bthd, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, KVH, seqlen, causal, bthd, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int KVH, int seqlen, int D,
             int dtype, bool causal, bool bthd, float scale, void* stream) {
  if (B <= 0 || seqlen <= 0 || KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tds::kF32:
      return by_dim<float>(D, q, k, v, o, lse, B, H, KVH, seqlen, causal, bthd, scale, st);
    case tds::kBF16:
      return by_dim<__nv_bfloat16>(D, q, k, v, o, lse, B, H, KVH, seqlen, causal, bthd, scale, st);
    case tds::kF16:
      return by_dim<__half>(D, q, k, v, o, lse, B, H, KVH, seqlen, causal, bthd, scale, st);
    default:
      return cudaErrorInvalidValue;
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
  return dispatch(q, k, v, o, lse, B, H, KVH, seqlen, D, dtype, causal != 0,
                  false, scale, stream);
}

// Heads-last, causal: q/o (B, T, H, D), k/v (B, T, KVH, D), lse (B*H, T)
// f32; otherwise as flash_fwd.
extern "C" int flash_fwd_bthd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int KVH,
                              int seqlen, int D, int dtype, float scale,
                              void* stream) {
  return dispatch(q, k, v, o, lse, B, H, KVH, seqlen, D, dtype, true, true,
                  scale, stream);
}

// Dynamic shared memory (bytes) the bf16/f16 forward launches with at
// head dim D (32 or 64), or -1.
extern "C" int flash_fwd_smem_bytes(int D) {
  return D == 32 ? tc::smem_bytes<32>() : D == 64 ? tc::smem_bytes<64>() : -1;
}
