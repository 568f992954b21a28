// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// FlashAttention-2 backward for Hopper (sm_90a): the dq pass and the dk/dv
// pass, causal or unmasked (a ring attention chunk).  bf16/f16 run both
// passes on the tensor cores (wgmma); f32 keeps the FP32-FMA kernels.
//
// Replaces the TPU kernels tiny_deepspeed_tpu/ops/flash_fa2.py::_dq_call
// (:281, pallas_call :285, kernel _bwd_dq_kernel :210) and ::_dkv_call
// (:248, pallas_call :258, kernel _bwd_dkv_kernel :155), reached from
// _fa2_bwd (:410) -> _bwd (:302) and, with causal=False, from the chunk
// entries fa2_chunk_dq (:341) and fa2_chunk_dkv (:350), which take the
// ring's GLOBAL (merged) lse and di.  `causal` is a template flag chosen
// at launch.  Same contract: q/do (B*H, T, D),
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
//   * dq: one CTA owns the query rows of one query block of one (batch,
//     head) and walks the key tiles up to the diagonal (causality by loop
//     bound; unmasked, all of them):
//     dq += ds K, ds = p (dp - di) scale, dp = do V^T.
//   * dkv: one CTA owns the keys of one key block of one (batch, kv
//     head), loops over the group's query heads and over the q tiles from
//     the diagonal (unmasked, from 0) to T:
//     dv += p^T do, dk += ds^T q.
// The TPU kernels keep whole (T, D) panels resident in VMEM; a Hopper SM
// has 227 KB of shared memory, so here the streamed operands pass through
// shared memory in tiles and any T works.  Tiles are bf16/f16 rows in the
// 128-byte (D = 64) or 64-byte (D = 32) swizzle (hopper.cuh), copied with
// cp.async (16 bytes a thread, zero-filled past T) one tile ahead of the
// compute through a ring of STAGES = 2.  One CTA is one warpgroup (128
// threads); every product is wgmma with f32 accumulators in registers.
//
// dq, bf16/f16 (`tc::flash_dq_wgmma`).  The CTA owns BQ = 64 query rows;
// its Q and dO tiles stay in shared memory, and the lse and di of the
// thread's own two accumulator rows (16w + l/4 + 8h, hopper.cuh) sit in
// registers (0 past T).  K and V stream through the ring in BKV = 64-key
// tiles; causal CTAs are launched heaviest (last row block) first, as
// the forward's.  Per key tile:
//   S = Q K^T and dP = dO V^T: wgmma m64n64k16, both operands K-major in
//     shared memory, D/16 k-steps each (32 f32 a thread each);
//   P = exp2(S scale log2(e) - lse log2(e)), masked only on the diagonal
//     tile (causal) and past T; dS = P (dP - di) scale, the scale where
//     the plain version applies it;
//   dQ += dS K: dS rounded to the input dtype in registers is the A
//     operand (wgmma m64nDk16, A from registers), K the B operand,
//     MN-major (transpose bit): 4 k-steps of 16 keys — the forward's
//     O += P V with K for V.
// dQ (32 f32 at D = 64) lives in registers for the whole walk and is
// stored once.  ptxas: 128-131 registers at D = 64 (the three variants),
// 107-110 at D = 32, no spills; 50176 bytes of dynamic
// shared memory at D = 64 (Q, dO and two stages of K and V + alignment;
// 25600 at D = 32; flash_dq_smem_bytes reports it), granted with
// cudaFuncSetAttribute at each launch.
//
// dk/dv, bf16/f16 (`tc::flash_dkv_wgmma`).  The CTA owns BKV = 64 keys;
// its K and V tiles stay in shared memory.  The Q and dO tiles (BQ = 64
// rows) with their lse and di slices (4-byte cp.async) come through the
// ring, which runs across the group's query heads.  Per q tile, in f32
// registers:
//   S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands
//     K-major in shared memory, D/16 k-steps each;
//   P^T = exp2(S^T scale log2(e) - lse log2(e)), masked only on the
//     diagonal tile (causal) and the ragged q tail;
//     dS^T = P^T (dP^T - di) scale;
//   dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to the input
//     dtype in registers are the A operands, dO and Q the B operands in
//     shared memory, MN-major (transpose bit): 4 k-steps of 16 query rows.
// dK and dV (32 f32 each at D = 64) live in registers for the whole
// loop and are stored once.  ptxas: 194 registers at D = 64
// causal (168 unmasked, 196 heads-last), 146 at D = 32, no spills; 51200
// bytes of dynamic shared memory at D = 64 (26624 at D = 32;
// flash_dkv_smem_bytes reports it): 2 CTAs an SM.
//
// f32 (`flash_dq_kernel`, `flash_dkv_kernel`).  f32 attention stays f32
// (the tests hold it to 1e-4; TF32 keeps about three digits): the
// dispatch by dtype picks these FMA kernels, neither a fallback for the
// tensor-core ones.  Every operand streams through shared memory in
// 32-row f32 tiles (padded to D+1 columns: the threads of a warp read
// different rows at one column without bank conflicts); a per-element
// test masks the diagonal tile and the ragged tail.  Each step is two
// small shared-memory GEMMs: phase A builds the (BQ, BK) score-gradient
// tile (each thread a 2 x 4 micro-tile), phase B folds it into the
// thread's 2 x D/8 micro-tile of the output accumulators.
//
// Bound.  At gpt2-124m training shapes (T = 1024, D = 64) dq does
// 6*D*T(T+1)/2 flops per head and dkv 8*D*T(T+1)/2 against ~6*T*D*2
// bytes: ~500 flop/byte, compute-bound on the tensor cores (989 TFLOP/s
// bf16).  The wgmma kernels' limit is their serial chain per tile (the
// first products, the elementwise pass, the last ones) in one
// warpgroup, with nothing to overlap it but the other resident CTAs.
// The FMA kernels compute out of shared memory at the FP32 FMA rate (67
// TFLOP/s peak, about one shared-memory load per 1.5 FMAs): far above
// the bound.

#include "common.cuh"
#include "hopper.cuh"

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

// -- dq and dk/dv, bf16 / f16: tensor cores -------------------------------

namespace tc {

using namespace tds::sm90;

constexpr int BKV = 64;                // keys: dk/dv's CTA, dq's K/V tile
constexpr int BQ = 64;                 // query rows: dq's CTA, dk/dv's tile
constexpr int STAGES = 2;              // ring depth of the streamed tiles
constexpr int THREADS = 128;
static_assert(BKV == BQ, "causal: the diagonal is one whole q tile");

template <int D>
__host__ __device__ constexpr int tile_bytes() { return 64 * D * 2; }

// K, V, then Q and dO of each stage, then each stage's lse and di (64 f32
// each); +1024 to align the base
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (2 + 2 * STAGES) * tile_bytes<D>() + STAGES * 2 * BQ * 4 + 1024;
}

template <typename T, int D, bool CAUSAL, bool BTHD>
__global__ void __launch_bounds__(THREADS)
flash_dkv_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                T* __restrict__ dk, T* __restrict__ dv, int seqlen, int H,
                int KVH, float scale) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t TB = tile_bytes<D>();
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;
  const uint32_t vs = ks + TB;
  auto qs = [&](int st) { return ks + TB * (2 + 2 * st); };
  auto dos = [&](int st) { return ks + TB * (3 + 2 * st); };
  // each stage's lse (64 f32) then di (64 f32)
  const uint32_t stats = ks + TB * (2 + 2 * STAGES);
  const float* stats_p =
      reinterpret_cast<const float*>(smem_raw + (stats - raw));

  const int kvbh = blockIdx.y;                     // b * KVH + kv head
  const int b = kvbh / KVH, kvh = kvbh % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.x * BKV;
  const size_t kvoff = tds::panel_offset<BTHD>(b, kvh, KVH, seqlen, D);
  const int qld = tds::row_stride<BTHD>(H, D);
  const int kvld = tds::row_stride<BTHD>(KVH, D);
  // causal: q tiles before the one holding key k0 see none of its keys;
  // unmasked: every q tile sees them.  The CTA walks (query head of the
  // group, q tile) in one sequence, so the ring runs across heads.
  const int qt0 = CAUSAL ? blockIdx.x : 0;
  const int per = (seqlen + BQ - 1) / BQ - qt0;
  const int ntiles = group * per;

  auto load_q = [&](int it, int st) {
    const int hq = kvh * group + it / per;
    const int q0 = (qt0 + it % per) * BQ;
    const size_t qoff = tds::panel_offset<BTHD>(b, hq, H, seqlen, D);
    load_tile64<T, D, THREADS>(qs(st), q + qoff, q0, seqlen, qld);
    load_tile64<T, D, THREADS>(dos(st), dout + qoff, q0, seqlen, qld);
    // one f32 a thread: threads 0-63 lse, 64-127 di; 0 past T
    const int r = threadIdx.x % BQ;
    const bool ok = q0 + r < seqlen;
    const float* src = (threadIdx.x < BQ ? lse : di)
                       + (size_t)(b * H + hq) * seqlen + (ok ? q0 + r : 0);
    cp_async4(stats + (st * 2 * BQ + threadIdx.x) * 4, src, ok);
  };

  load_tile64<T, D, THREADS>(ks, k + kvoff, k0, seqlen, kvld);
  load_tile64<T, D, THREADS>(vs, v + kvoff, k0, seqlen, kvld);
  load_q(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key0 = k0 + 16 * warp + lane / 4;      // keys key0, key0 + 8
  const int col0 = 2 * (lane % 4);                 // + 8j + e in a q tile
  const float sl2 = scale * kLog2e;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    if (it + 1 < ntiles) load_q(it + 1, (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and K/V) landed
    fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(s, desc_k<D>(ks, kk), desc_k<D>(qs(st), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(dp, desc_k<D>(vs, kk), desc_k<D>(dos(st), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - di) scale
    const int q0 = (qt0 + it % per) * BQ;
    const bool edge = (CAUSAL && q0 == k0) || q0 + BQ > seqlen;
    const float* lse_s = stats_p + st * 2 * BQ;
    const float* di_s = lse_s + BQ;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + col0 + i % 2;
      float p = exp2f(fmaf(s[i], sl2, -lse_s[c] * kLog2e));
      if (edge) {
        const int key = key0 + 8 * ((i / 2) % 2);
        const bool ok = q0 + c < seqlen && (!CAUSAL || key <= q0 + c);
        p = ok ? p : 0.f;
      }
      s[i] = p;
      dp[i] = p * (dp[i] - di_s[c]) * scale;
    }

    // dV += P^T dO, dK += dS^T Q: A from registers in the input dtype,
    // dO and Q MN-major (transpose bit)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a<T>(s, kk, pa[kk]);
      acc_to_a<T>(dp, kk, da[kk]);
    }
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, D>(acc_v, pa[kk], desc_mn<D>(dos(st), kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, D>(acc_k, da[kk], desc_mn<D>(qs(st), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    __syncthreads();  // stage st is free for the copy two tiles ahead
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = key0 + 8 * ((i / 2) % 2);
    if (key < seqlen) {
      const size_t off = kvoff + (size_t)key * kvld + 8 * (i / 4) + col0;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack2<T>(acc_k[i], acc_k[i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack2<T>(acc_v[i], acc_v[i + 1]);
    }
  }
}

// Q and dO, then K and V of each stage; +1024 to align the base
template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (2 + 2 * STAGES) * tile_bytes<D>() + 1024;
}

template <typename T, int D, bool CAUSAL, bool BTHD>
__global__ void __launch_bounds__(THREADS)
flash_dq_wgmma(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               T* __restrict__ dq, int seqlen, int H, int KVH, float scale) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t TB = tile_bytes<D>();
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + TB;
  auto ks = [&](int st) { return qs + TB * (2 + 2 * st); };
  auto vs = [&](int st) { return qs + TB * (3 + 2 * st); };

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
  const int ntiles = (kend + BKV - 1) / BKV;

  load_tile64<T, D, THREADS>(qs, q + qoff, q0, seqlen, qld);
  load_tile64<T, D, THREADS>(dos, dout + qoff, q0, seqlen, qld);
  load_tile64<T, D, THREADS>(ks(0), kp, 0, seqlen, kvld);
  load_tile64<T, D, THREADS>(vs(0), vp, 0, seqlen, kvld);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp + lane / 4;      // rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);                 // + 8j + e in a k tile
  const float sl2 = scale * kLog2e;
  // this thread's two rows' statistics (0 past T: those rows' Q and dO
  // are zero-filled, so their dS is 0 and they are never stored)
  float lse2[2], di_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool ok = row < seqlen;
    lse2[hh] = ok ? lse[(size_t)bh * seqlen + row] * kLog2e : 0.f;
    di_r[hh] = ok ? di[(size_t)bh * seqlen + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int st = kt % STAGES;
    if (kt + 1 < ntiles) {  // the next tile's copy overlaps this one
      const int nst = (kt + 1) % STAGES;
      load_tile64<T, D, THREADS>(ks(nst), kp, (kt + 1) * BKV, seqlen, kvld);
      load_tile64<T, D, THREADS>(vs(nst), vp, (kt + 1) * BKV, seqlen, kvld);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(s, desc_k<D>(qs, kk), desc_k<D>(ks(st), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(dp, desc_k<D>(dos, kk), desc_k<D>(vs(st), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S scale - lse), dS = P (dP - di) scale
    const int k0 = kt * BKV;
    const bool edge = (CAUSAL && k0 + BKV > q0 + 1) || k0 + BKV > seqlen;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i / 2) % 2;
      float p = exp2f(fmaf(s[i], sl2, -lse2[hh]));
      if (edge) {
        const int key = k0 + 8 * (i / 4) + col0 + i % 2;
        const bool ok = key < seqlen && (!CAUSAL || key <= row0 + 8 * hh);
        p = ok ? p : 0.f;
      }
      s[i] = p * (dp[i] - di_r[hh]) * scale;
    }

    // dQ += dS K: dS from registers in the input dtype, K MN-major
    // (transpose bit)
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(s, kk, da[kk]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, D>(acc, da[kk], desc_mn<D>(ks(st), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // stage st is free for the copy two tiles ahead
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2);
    if (row < seqlen) {
      T* op = dq + qoff + (size_t)row * qld + 8 * (i / 4) + col0;
      *reinterpret_cast<uint32_t*>(op) = pack2<T>(acc[i], acc[i + 1]);
    }
  }
}

// above 48 KB dynamic shared memory must be granted on the current
// device: granted at every launch, so no state outlives the call
template <typename K>
cudaError_t grant_smem(K kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

template <typename T, int D, bool CAUSAL, bool BTHD>
cudaError_t launch_one(const Args& a, bool dkv) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (dkv) {
    auto kernel = flash_dkv_wgmma<T, D, CAUSAL, BTHD>;
    constexpr int smem = smem_bytes<D>();
    if ((err = grant_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((a.seqlen + BKV - 1) / BKV, a.B * a.KVH);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.seqlen, a.H, a.KVH, a.scale);
  } else {
    auto kernel = flash_dq_wgmma<T, D, CAUSAL, BTHD>;
    constexpr int smem = dq_smem_bytes<D>();
    if ((err = grant_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((a.seqlen + BQ - 1) / BQ, a.B * a.H);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<T*>(a.dq), a.seqlen, a.H,
        a.KVH, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args& a, bool dkv) {
  // heads-last is causal only (its one entry, fa2_flash_attention_bthd)
  return a.bthd ? launch_one<T, D, true, true>(a, dkv)
         : a.causal ? launch_one<T, D, true, false>(a, dkv)
                    : launch_one<T, D, false, false>(a, dkv);
}

}  // namespace tc

// f32 -> the FMA kernels, bf16/f16 -> the tensor-core kernels
template <typename T, int D>
cudaError_t launch(const Args& a, bool dkv) {
  if constexpr (!std::is_same<T, float>::value) {
    return tc::launch<T, D>(a, dkv);
  } else {
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
          q, k, v, dout, a.lse, a.di, static_cast<T*>(a.dq), a.seqlen,
          a.H, a.KVH, a.scale);
    }
    return cudaGetLastError();
  }
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

// Dynamic shared memory (bytes) the bf16/f16 dk/dv kernel launches with
// at head dim D (32 or 64), or -1.
extern "C" int flash_dkv_smem_bytes(int D) {
  return D == 32 ? tc::smem_bytes<32>() : D == 64 ? tc::smem_bytes<64>() : -1;
}

// Dynamic shared memory (bytes) the bf16/f16 dq kernel launches with at
// head dim D (32 or 64), or -1.
extern "C" int flash_dq_smem_bytes(int D) {
  return D == 32 ? tc::dq_smem_bytes<32>()
         : D == 64 ? tc::dq_smem_bytes<64>() : -1;
}
