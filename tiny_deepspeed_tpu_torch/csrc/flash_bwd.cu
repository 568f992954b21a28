// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// FlashAttention-2 backward for Hopper (sm_90a), plain-FMA version: the dq
// pass and the dk/dv pass, causal or unmasked (a ring attention chunk).
//
// Replaces the TPU kernels tiny_deepspeed_tpu/ops/flash_fa2.py::_dq_call
// (:281, pallas_call :285, kernel _bwd_dq_kernel :210) and ::_dkv_call
// (:248, pallas_call :258, kernel _bwd_dkv_kernel :155), reached from
// _fa2_bwd (:410) -> _bwd (:302) and, with causal=False, from the chunk
// entries fa2_chunk_dq (:341) and fa2_chunk_dkv (:350), which take the
// ring's GLOBAL (merged) lse and di.  `causal` is a template flag chosen
// at launch, so the causal instantiations are the code they were before
// the flag.  Same contract: q/do (B*H, T, D),
// k/v (B*KVH, T, D) with query head h reading kv head h / (H/KVH); lse
// (the forward's fused m + log l) and di = rowsum(do*o), both f32
// (B*H, T); p = exp(s*scale - lse) is recomputed, never stored; every
// product accumulates in f32; outputs in the input dtype.  Under GQA,
// dk/dv are summed over the kv head's query-head group in one f32
// accumulator and come back at KVH heads.
//
// Heads-last (`flash_bwd_dq_bthd`, `flash_bwd_dkv_bthd`): also replace the
// TPU kernels of _fa2_bthd_bwd (:649) — dk/dv (pallas_call :668, kernel
// _bwd_dkv_kernel_ah :496) and dq (pallas_call :685, kernel
// _bwd_dq_kernel_ah :547) — causal, on q/k/v/do/dq/dk/dv (B, T, H, D)
// with lse and di still f32 (B*H, T).  As in flash_fwd.cu the layout is
// a stride (the `BTHD` template flag: row r of head h at
// ((b*T + r)*H + h)*D), not the TPU's whole-panel head loop, and the
// operations are those of the (B, H, T, D) kernels in the same order:
// bit for bit their results on the transposed copies.
//
// Design.  The JAX decomposition stays: two passes, no atomics, so both
// are deterministic (fixed loop order, bit-repeatable run to run).
//   * dq: one CTA owns BQ query rows of one (batch, head) and walks the
//     key tiles up to the diagonal (causality by loop bound; unmasked, all
//     of them):
//     dq += ds K, ds = p (dp - di) scale, dp = do V^T.
//   * dkv: one CTA owns BK keys of one (batch, kv head), loops over the
//     group's query heads and over the q tiles from the diagonal (unmasked,
//     from 0) to T:
//     dv += p^T do, dk += ds^T q.
// The TPU kernels keep whole (T, D) panels resident in VMEM; a Hopper SM
// has 227 KB of shared memory, so here every operand streams through
// shared memory in 32-row f32 tiles (padded to D+1 columns: the threads of
// a warp read different rows at one column without bank conflicts) and
// any T works; a per-element test masks the diagonal tile and the ragged
// tail.  Each step is two small shared-memory GEMMs: phase A builds the
// (BQ, BK) score-gradient tile (each thread a 2 x 4 micro-tile), phase B
// folds it into the thread's 2 x D/8 micro-tile of the output
// accumulators.  Registers: at D = 64 a dkv thread holds 2 x 8 dk and
// 2 x 8 dv accumulators (32 floats) plus 16 phase-A sums — the whole key
// row is split over 8 threads, never held by one.
//
// Bound.  At gpt2-124m training shapes (T = 1024, D = 64) dq does
// 6*D*T(T+1)/2 flops per head and dkv 8*D*T(T+1)/2 against ~6*T*D*2
// bytes: ~500 flop/byte, compute-bound on the tensor cores' scale
// (989 TFLOP/s bf16).  This version computes with FP32 FMAs out of
// shared memory (67 TFLOP/s peak, and about one shared-memory load per
// 1.5 FMAs), so it sits far above that bound; moving both GEMM phases
// onto mma/wgmma is the next step, after this one is right.

#include "common.cuh"

namespace {

constexpr int BQ = 32;                  // query rows per tile
constexpr int BK = 32;                  // keys per tile
constexpr int TX = 8, TY = 16;          // thread grid of a CTA
constexpr int THREADS = TX * TY;        // 128
constexpr int KPT = BK / TX;            // phase-A columns per thread (4)
static_assert(BQ == 2 * TY && BK == 2 * TY, "each thread owns two rows");

// rows [r0, r0 + 32) of a (T, D) panel whose rows lie `ld` elements
// apart -> f32 shared tile; rows at or past `limit` read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1],
                                          const T* __restrict__ src, int r0,
                                          int limit, int ld) {
  for (int e = threadIdx.x; e < 32 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int g = r0 + r;
    dst[r][c] = g < limit ? tds::to_f(src[(size_t)g * ld + c]) : 0.f;
  }
}

template <typename T, int D, bool CAUSAL, bool BTHD>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                T* __restrict__ dq, int seqlen, int H, int KVH, float scale) {
  constexpr int CPT = D / TX;           // phase-B columns per thread
  __shared__ float qs[BQ][D + 1];
  __shared__ float dos[BQ][D + 1];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  __shared__ float dss[BQ][BK + 1];

  const int bh = blockIdx.y;                       // b * H + h
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const size_t qbase = (size_t)bh * seqlen;        // lse / di rows
  const size_t qoff = tds::panel_offset<BTHD>(b, h, H, seqlen, D);
  const size_t kvoff = tds::panel_offset<BTHD>(b, h / (H / KVH), KVH,
                                               seqlen, D);
  const int qld = tds::row_stride<BTHD>(H, D);
  const int kvld = tds::row_stride<BTHD>(KVH, D);
  const T* kp = k + kvoff;
  const T* vp = v + kvoff;

  load_tile<T, D>(qs, q + qoff, q0, seqlen, qld);
  load_tile<T, D>(dos, dout + qoff, q0, seqlen, qld);
  int row[2];
  float lse_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 2 * ty + i;
    const bool ok = row[i] < seqlen;
    lse_r[i] = ok ? lse[qbase + row[i]] : 0.f;
    di_r[i] = ok ? di[qbase + row[i]] : 0.f;
  }
  float acc[2][CPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // causal: no row of this CTA sees a key past its last row; unmasked:
  // every key of the chunk
  const int kend = CAUSAL ? min(seqlen, q0 + BQ) : seqlen;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<T, D>(ks, kp, k0, kend, kvld);
    load_tile<T, D>(vs, vp, k0, kend, kvld);
    __syncthreads();

    // phase A: s = q k^T, dp = do v^T for a 2 x KPT micro-tile
    float s[2][KPT], dp[2][KPT];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qa0 = qs[2 * ty][d], qa1 = qs[2 * ty + 1][d];
      const float da0 = dos[2 * ty][d], da1 = dos[2 * ty + 1][d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float kb = ks[tx + TX * j][d], vb = vs[tx + TX * j][d];
        s[0][j] = fmaf(qa0, kb, s[0][j]);
        s[1][j] = fmaf(qa1, kb, s[1][j]);
        dp[0][j] = fmaf(da0, vb, dp[0][j]);
        dp[1][j] = fmaf(da1, vb, dp[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = k0 + tx + TX * j;
        const bool ok = row[i] < seqlen
                        && (CAUSAL ? key <= row[i] : key < seqlen);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[2 * ty + i][tx + TX * j] = p * (dp[i][j] - di_r[i]) * scale;
      }
    __syncthreads();

    // phase B: dq += ds k
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float a0 = dss[2 * ty][j], a1 = dss[2 * ty + 1][j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kb = ks[j][tx + TX * c];
        acc[0][c] = fmaf(a0, kb, acc[0][c]);
        acc[1][c] = fmaf(a1, kb, acc[1][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= seqlen) continue;
    T* out = dq + qoff + (size_t)row[i] * qld;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      out[tx + TX * c] = tds::from_f<T>(acc[i][c]);
  }
}

template <typename T, int D, bool CAUSAL, bool BTHD>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dk, T* __restrict__ dv, int seqlen, int H,
                 int KVH, float scale) {
  constexpr int CPT = D / TX;
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  __shared__ float qs[BQ][D + 1];
  __shared__ float dos[BQ][D + 1];
  __shared__ float ps[BQ][BK + 1];
  __shared__ float dss[BQ][BK + 1];
  __shared__ float lse_s[BQ];
  __shared__ float di_s[BQ];

  const int kvbh = blockIdx.y;                     // b * KVH + kv head
  const int b = kvbh / KVH, kvh = kvbh % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const size_t kvoff = tds::panel_offset<BTHD>(b, kvh, KVH, seqlen, D);
  const int qld = tds::row_stride<BTHD>(H, D);
  const int kvld = tds::row_stride<BTHD>(KVH, D);

  load_tile<T, D>(ks, k + kvoff, k0, seqlen, kvld);
  load_tile<T, D>(vs, v + kvoff, k0, seqlen, kvld);
  float acc_k[2][CPT], acc_v[2][CPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {   // the query heads sharing this k/v
    const int hq = kvh * group + g;
    const size_t qbase = (size_t)(b * H + hq) * seqlen;  // lse / di rows
    const size_t qoff = tds::panel_offset<BTHD>(b, hq, H, seqlen, D);
    // causal: q tiles before the one holding key k0 see none of its keys;
    // unmasked: every q tile sees them
    for (int q0 = CAUSAL ? (k0 / BQ) * BQ : 0; q0 < seqlen; q0 += BQ) {
      __syncthreads();  // the previous tile is fully consumed
      load_tile<T, D>(qs, q + qoff, q0, seqlen, qld);
      load_tile<T, D>(dos, dout + qoff, q0, seqlen, qld);
      for (int e = threadIdx.x; e < BQ; e += THREADS) {
        const bool ok = q0 + e < seqlen;
        lse_s[e] = ok ? lse[qbase + q0 + e] : 0.f;
        di_s[e] = ok ? di[qbase + q0 + e] : 0.f;
      }
      __syncthreads();

      // phase A: p and ds for query rows 2ty, 2ty+1 x KPT keys
      float s[2][KPT], dp[2][KPT];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qa0 = qs[2 * ty][d], qa1 = qs[2 * ty + 1][d];
        const float da0 = dos[2 * ty][d], da1 = dos[2 * ty + 1][d];
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const float kb = ks[tx + TX * j][d], vb = vs[tx + TX * j][d];
          s[0][j] = fmaf(qa0, kb, s[0][j]);
          s[1][j] = fmaf(qa1, kb, s[1][j]);
          dp[0][j] = fmaf(da0, vb, dp[0][j]);
          dp[1][j] = fmaf(da1, vb, dp[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * ty + i, rowg = q0 + r;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int key = k0 + tx + TX * j;
          const bool ok = rowg < seqlen && key < seqlen
                          && (!CAUSAL || key <= rowg);
          const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          ps[r][tx + TX * j] = p;
          dss[r][tx + TX * j] = p * (dp[i][j] - di_s[r]) * scale;
        }
      }
      __syncthreads();

      // phase B: dv += p^T do, dk += ds^T q for key rows 2ty, 2ty+1
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float p0 = ps[i][2 * ty], p1 = ps[i][2 * ty + 1];
        const float s0 = dss[i][2 * ty], s1 = dss[i][2 * ty + 1];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float dov = dos[i][tx + TX * c], qv = qs[i][tx + TX * c];
          acc_v[0][c] = fmaf(p0, dov, acc_v[0][c]);
          acc_v[1][c] = fmaf(p1, dov, acc_v[1][c]);
          acc_k[0][c] = fmaf(s0, qv, acc_k[0][c]);
          acc_k[1][c] = fmaf(s1, qv, acc_k[1][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * ty + i;
    if (key >= seqlen) continue;
    T* dkrow = dk + kvoff + (size_t)key * kvld;
    T* dvrow = dv + kvoff + (size_t)key * kvld;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkrow[tx + TX * c] = tds::from_f<T>(acc_k[i][c]);
      dvrow[tx + TX * c] = tds::from_f<T>(acc_v[i][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  int B, H, KVH, seqlen;
  bool causal;
  bool bthd;  // heads-last (B, T, H, D); causal only
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a, bool dkv) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (dkv) {
    dim3 grid((a.seqlen + BK - 1) / BK, a.B * a.KVH);
    auto kernel = a.bthd ? flash_dkv_kernel<T, D, true, true>
                  : a.causal ? flash_dkv_kernel<T, D, true, false>
                             : flash_dkv_kernel<T, D, false, false>;
    kernel<<<grid, THREADS, 0, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.seqlen, a.H, a.KVH, a.scale);
  } else {
    dim3 grid((a.seqlen + BQ - 1) / BQ, a.B * a.H);
    auto kernel = a.bthd ? flash_dq_kernel<T, D, true, true>
                  : a.causal ? flash_dq_kernel<T, D, true, false>
                             : flash_dq_kernel<T, D, false, false>;
    kernel<<<grid, THREADS, 0, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<T*>(a.dq), a.seqlen, a.H,
        a.KVH, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const Args& a, bool dkv) {
  switch (D) {
    case 32: return launch<T, 32>(a, dkv);
    case 64: return launch<T, 64>(a, dkv);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int D, const Args& a, bool dkv) {
  if (a.B <= 0 || a.seqlen <= 0 || a.KVH <= 0 || a.H % a.KVH)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case tds::kF32: return by_dim<float>(D, a, dkv);
    case tds::kBF16: return by_dim<__nv_bfloat16>(D, a, dkv);
    case tds::kF16: return by_dim<__half>(D, a, dkv);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout (B*H, T, D), k/v (B*KVH, T, D), lse/di (B*H, T) f32, dq like q;
// all contiguous on the device; dtype: tds::DType; causal 1 (a query sees
// the keys at or before its position) or 0 (every key).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* di, void* dq, int B, int H,
                            int KVH, int seqlen, int D, int dtype,
                            int causal, float scale, void* stream) {
  Args a{q, k, v, dout, lse, di, dq, nullptr, nullptr, B, H, KVH, seqlen,
         causal != 0, false, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, a, false);
}

// as flash_bwd_dq; dk/dv (B*KVH, T, D) like k/v, each summed over the kv
// head's H/KVH query heads.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* di, void* dk, void* dv, int B,
                             int H, int KVH, int seqlen, int D, int dtype,
                             int causal, float scale, void* stream) {
  Args a{q, k, v, dout, lse, di, nullptr, dk, dv, B, H, KVH, seqlen,
         causal != 0, false, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, a, true);
}

// Heads-last, causal: q/dout/dq (B, T, H, D), k/v/dk/dv (B, T, KVH, D),
// lse/di (B*H, T) f32; otherwise as flash_bwd_dq / flash_bwd_dkv.
extern "C" int flash_bwd_dq_bthd(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* di, void* dq,
                                 int B, int H, int KVH, int seqlen, int D,
                                 int dtype, float scale, void* stream) {
  Args a{q, k, v, dout, lse, di, dq, nullptr, nullptr, B, H, KVH, seqlen,
         true, true, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, a, false);
}

extern "C" int flash_bwd_dkv_bthd(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* di,
                                  void* dk, void* dv, int B, int H, int KVH,
                                  int seqlen, int D, int dtype, float scale,
                                  void* stream) {
  Args a{q, k, v, dout, lse, di, nullptr, dk, dv, B, H, KVH, seqlen,
         true, true, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, a, true);
}
