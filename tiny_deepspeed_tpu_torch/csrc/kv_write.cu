// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// The KV-pool write for Hopper (sm_90a): K and V head vectors of one
// writer call quantized (or cast) and stored at their pool rows, both
// sides in ONE launch.
//
// Replaces, on the serving path, the TPU kernel
// tiny_deepspeed_tpu/ops/quant_pallas.py::pallas_quantize_blockwise (:59,
// pallas_call :71) as the pool uses it — codec block = one Dh head vector,
// tiny_deepspeed_tpu/serving/pool.py `_quant_vectors` / `paged_append`
// (:96-127), `paged_append_span` (:153) and `paged_scatter` (:284) —
// together with the scatter that follows it.  The decode append itself
// rides in the paged-decode launch (csrc/paged_attn.cu, `APPEND`); this
// file serves the prefill scatter and the verify span's commit, and the
// append of callers outside the decode tick.  Contract: the pool k/v
// (NB, bt, NL, KVH, Dh) contiguous in its resting dtype (an e4m3 pool
// arrives as its bytes), scales (NB, bt, NL, KVH) f32 on an int8 / e4m3
// pool.  Source row r of layer l and kv head h is the Dh vector at
//   src[l] + (r / r2)*s1 + (r % r2)*s2 + h*sh   (element strides,
// innermost stride 1): a pointer per layer and side, one set of strides
// per side — the prefill's per-layer column slices of the qkv product
// ((1, KVH, P, Dh) views), the verify span's (L, S, KVH, K1, Dh) stacks
// and the decode slice are all read where they lie, without a copy or a
// stack.  Its destination is (blk[r / blk_div], off ? off[r] : r % bt,
// l0 + l, h): (blk, off) int64 pairs per row (decode, span commit), or
// whole blocks of bt rows (prefill, blk_div = bt, off = null).  The codec
// and the cast are csrc/kv_codec.cuh's, shared with the decode append.
//
// Rows that share a destination (invalid slots, bucket padding and
// rejected drafts all land in scratch block 0) race; which one lands is
// undefined, as it is for index_put, and every read masks those rows.
// A destination outside the pool traps, as index_put's device assert
// does.
//
// Bound: bytes — each source vector read once, codes (1 B an element)
// and a 4-byte scale, or the cast row, written once; a few operations an
// element against the card's ~300 flop/byte balance point.  A prefill of
// 512 rows x 12 layers x 12 heads x 64 bf16 into int8 moves 28.9 MB
// (8.6 us at 3.35 TB/s); the decode append's 37-49 KB is a launch.
//
// Design (`kv_write_kernel`): a lane group of Dh * sizeof(src) / 16 lanes
// per head vector (8 for Dh 64 bf16, 16 for Dh 128), each lane ONE
// 16-byte load and its codes stored packed (8 B for Dh 64 int8) or its
// cast elements as one 16-byte store; the absmax by shuffles inside the
// group.  Vectors are numbered (side, row, layer, head), so a warp's
// groups read neighbouring head vectors of one source row and store
// neighbouring pool vectors and scales.  Each group keeps kUnroll vectors
// in flight: every load (source, blk, off) of a thread is issued before
// its first store.  Sources that are not 16-byte aligned take element
// loads (same lanes, same codes).
//
// `kv_write_v1_kernel` is the first design, kept off every path behind
// the C entry `kv_write_v1` as the new kernel's bit-for-bit and timing
// reference: one warp per head vector, each lane up to four elements 32
// lanes apart, a 2-byte load and a 1-byte store at a time.

#include "common.cuh"
#include "kv_codec.cuh"

namespace {

using tds::kv::store_vector;

constexpr int kThreads = 128;
constexpr int kUnroll = 2;      // vectors a lane group keeps in flight
constexpr int kMaxLayers = 64;  // layers one launch takes (a pointer each)

// n / d for 0 <= n < 2^31 as a multiply-high and a shift, the divisor's
// magic number made on the host (CUTLASS's FastDivmod): the index
// arithmetic of every vector costs a few instructions, not a division
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < d) ++l;  // ceil(log2 d)
    f.mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
    f.shr = l - 1;
  }
  return f;
}

__device__ __forceinline__ unsigned div_of(unsigned n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

struct Args {
  const void* src[2][kMaxLayers];  // K, V: a source pointer per layer
  void* pool[2];                   // K, V pools (an e4m3 pool as its bytes)
  float* scale[2];                 // K, V scales (null on a float pool)
  long long s1[2], s2[2], sh[2];   // source element strides, per side
  const long long* blk;
  const long long* off;  // null: whole blocks, off = r % bt
  FastDiv kvh, lc, r2, blk_div, bt;
  unsigned per_side;  // rows * lc * kvh
  int nb, nl, l0;
  int vec;  // every source pointer and stride 16-byte aligned
};

template <typename TS>
__device__ __forceinline__ void unpack16(const uint4& u, float* out) {
  const TS* e = reinterpret_cast<const TS*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(TS); ++i) out[i] = tds::to_f<TS>(e[i]);
}

// U vectors a lane group (kUnroll for a large call; 1 where that would
// leave the card's SMs without two CTAs each, as at the decode and span
// shapes, so the few vectors spread over more CTAs)
template <typename TS, int POOL, int D, int U>
__global__ void __launch_bounds__(kThreads)
kv_write_kernel(const __grid_constant__ Args a) {
  constexpr int EPL = 16 / sizeof(TS);  // elements a lane: one 16-byte load
  constexpr int L = D / EPL;            // lanes a head vector
  constexpr int VPS = kThreads / L;     // vectors a CTA step
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "lane group");
  const int part = threadIdx.x % L;
  const unsigned first = blockIdx.x * (VPS * U) + threadIdx.x / L;

  uint4 raw[U];
  long long b[U], o[U];
  unsigned lh[U];  // (l0 + l) * kvh + h
  int side[U];
  bool live[U];
  // every load first: the sources, then the destinations
#pragma unroll
  for (int u = 0; u < U; ++u) {
    unsigned w = first + u * VPS;
    live[u] = w < 2 * a.per_side;
    side[u] = w >= a.per_side;
    w = live[u] ? w - side[u] * a.per_side : 0;
    const unsigned hl = div_of(w, a.kvh), h = w - hl * a.kvh.d;
    const unsigned r = div_of(hl, a.lc), l = hl - r * a.lc.d;
    const unsigned r1 = div_of(r, a.r2), r2 = r - r1 * a.r2.d;
    const TS* x = static_cast<const TS*>(a.src[side[u]][l]) +
                  r1 * a.s1[side[u]] + r2 * a.s2[side[u]] +
                  h * a.sh[side[u]] + part * EPL;
    raw[u] = make_uint4(0, 0, 0, 0);
    if (live[u]) {
      if (a.vec) {
        raw[u] = __ldg(reinterpret_cast<const uint4*>(x));
      } else {
        TS* e = reinterpret_cast<TS*>(&raw[u]);
#pragma unroll
        for (int i = 0; i < EPL; ++i) e[i] = x[i];
      }
      b[u] = a.blk[div_of(r, a.blk_div)];
      o[u] = a.off ? a.off[r] : r - div_of(r, a.bt) * a.bt.d;
    } else {
      b[u] = o[u] = 0;
    }
    lh[u] = (a.l0 + l) * a.kvh.d + h;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (live[u] && (b[u] < 0 || b[u] >= a.nb || o[u] < 0 || o[u] >= a.bt.d))
      __trap();
    float v[EPL];
    unpack16<TS>(raw[u], v);
    store_vector<POOL, EPL, L>(
        v, live[u], part, side[u] ? a.pool[1] : a.pool[0],
        side[u] ? a.scale[1] : a.scale[0],
        (b[u] * a.bt.d + o[u]) * a.nl * a.kvh.d + lh[u]);
  }
}

// the card's SM count, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;  // the launch that follows reports the error
  }
  return sms;
}

template <typename TS, int POOL, int D>
cudaError_t launch_dim(const Args& a, cudaStream_t st) {
  constexpr int VPS = kThreads / (D / (16 / (int)sizeof(TS)));
  const long long vectors = 2LL * a.per_side;
  const long long big = (vectors + VPS * kUnroll - 1) / (VPS * kUnroll);
  if (big >= 2LL * sm_count())
    kv_write_kernel<TS, POOL, D, kUnroll>
        <<<(unsigned)big, kThreads, 0, st>>>(a);
  else
    kv_write_kernel<TS, POOL, D, 1>
        <<<(unsigned)((vectors + VPS - 1) / VPS), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TS, int POOL>
cudaError_t launch_pool(int dh, const Args& a, cudaStream_t st) {
  switch (dh) {
    case 32: return launch_dim<TS, POOL, 32>(a, st);
    case 64: return launch_dim<TS, POOL, 64>(a, st);
    case 128: return launch_dim<TS, POOL, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TS>
cudaError_t launch_src(int pool_dtype, int dh, const Args& a,
                       cudaStream_t st) {
  switch (pool_dtype) {
    case tds::kF32: return launch_pool<TS, tds::kF32>(dh, a, st);
    case tds::kBF16: return launch_pool<TS, tds::kBF16>(dh, a, st);
    case tds::kF16: return launch_pool<TS, tds::kF16>(dh, a, st);
    case tds::kI8: return launch_pool<TS, tds::kI8>(dh, a, st);
    case tds::kFP8E4M3: return launch_pool<TS, tds::kFP8E4M3>(dh, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// -- the v1 kernel: off every path, the reference in bits and time --------

constexpr int kWarps = 4;    // head vectors a CTA
constexpr int kPerLane = 4;  // elements a lane: Dh <= 128

struct ArgsV1 {
  const void* src[2];  // K, V sources
  void* pool[2];       // K, V pools (an e4m3 pool as its bytes)
  float* scale[2];     // K, V scales (null on a bf16/f16/f32 pool)
  long long sl[2], s1[2], s2[2], sh[2];  // source element strides
  const long long* blk;
  const long long* off;  // null: whole blocks, off = r % bt
  int rows, r2, lc, kvh, dh, blk_div, bt, nb, nl, l0;
};

template <typename TS, int POOL>
__global__ void __launch_bounds__(kWarps * 32)
kv_write_v1_kernel(const ArgsV1 a) {
  const int lane = threadIdx.x & 31;
  const long long per_side = (long long)a.rows * a.lc * a.kvh;
  long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= 2 * per_side) return;
  const int side = w >= per_side;
  w -= side * per_side;
  const int h = (int)(w % a.kvh);
  w /= a.kvh;
  const int l = (int)(w % a.lc);
  const int r = (int)(w / a.lc);

  const long long b = a.blk[r / a.blk_div];
  const long long o = a.off ? a.off[r] : r % a.bt;
  if (b < 0 || b >= a.nb || o < 0 || o >= a.bt) __trap();
  const long long dst = ((b * a.bt + o) * a.nl + a.l0 + l) * a.kvh + h;

  // selects, not a dynamic index: the arguments stay in parameter space
  const TS* x = static_cast<const TS*>(side ? a.src[1] : a.src[0]) +
                l * (side ? a.sl[1] : a.sl[0]) +
                (r / a.r2) * (side ? a.s1[1] : a.s1[0]) +
                (r % a.r2) * (side ? a.s2[1] : a.s2[0]) +
                h * (side ? a.sh[1] : a.sh[0]);
  float v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < a.dh ? tds::to_f<TS>(x[d]) : 0.f;
  }

  if constexpr (tds::kv::quantized<POOL>()) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) amax = fmaxf(amax, fabsf(v[i]));
    amax = tds::kv::group_max<32>(amax);
    const float s = tds::kv::scale_of<POOL>(amax);
    unsigned char* q =
        static_cast<unsigned char*>(side ? a.pool[1] : a.pool[0]) + dst * a.dh;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d >= a.dh) break;
      q[d] = tds::kv::code_of<POOL>(v[i], s);
    }
    if (lane == 0) (side ? a.scale[1] : a.scale[0])[dst] = s;
  } else {
    using TP = tds::kv::cast_t<POOL>;
    TP* p = static_cast<TP*>(side ? a.pool[1] : a.pool[0]) + dst * a.dh;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < a.dh) p[d] = tds::from_f<TP>(v[i]);
    }
  }
}

template <typename TS>
cudaError_t launch_v1(int pool_dtype, const ArgsV1& a, unsigned grid,
                      cudaStream_t st) {
  switch (pool_dtype) {
    case tds::kF32:
      kv_write_v1_kernel<TS, tds::kF32><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    case tds::kBF16:
      kv_write_v1_kernel<TS, tds::kBF16><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    case tds::kF16:
      kv_write_v1_kernel<TS, tds::kF16><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    case tds::kI8:
      kv_write_v1_kernel<TS, tds::kI8><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    case tds::kFP8E4M3:
      kv_write_v1_kernel<TS, tds::kFP8E4M3><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One writer call, both sides.  k_src/v_src: `lc` source pointers each
// (host arrays; layer l's rows at k_src[l]), in src_dtype (f32, bf16,
// f16) with element strides (outer row, inner row, head) per side;
// k_pool/v_pool (NB, bt, NL, KVH, Dh) in pool_dtype, Dh 32, 64 or 128;
// k_scale/v_scale (NB, bt, NL, KVH) f32 on an int8 / e4m3 pool; `rows`
// source rows (r2 of them an outer step), layers l0 .. l0 + lc - 1 (lc
// at most 64: a deeper write is one call per layer group); blk (rows /
// blk_div,) and off (rows,) int64, or off null for whole blocks.
extern "C" int kv_write(const void* const* k_src, const void* const* v_src,
                        void* k_pool, void* v_pool, float* k_scale,
                        float* v_scale, const long long* blk,
                        const long long* off, long long k_s1, long long k_s2,
                        long long k_sh, long long v_s1, long long v_s2,
                        long long v_sh, int rows, int r2, int lc, int kvh,
                        int dh, int blk_div, int bt, int nb, int nl, int l0,
                        int src_dtype, int pool_dtype, void* stream) {
  if (rows < 0 || r2 < 1 || lc < 1 || lc > kMaxLayers || kvh < 1 ||
      blk_div < 1 || bt < 1 || l0 < 0 || l0 + lc > nl)
    return cudaErrorInvalidValue;
  const bool quant = pool_dtype == tds::kI8 || pool_dtype == tds::kFP8E4M3;
  if (quant && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  if (2LL * rows * lc * kvh > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int esize = src_dtype == tds::kF32 ? 4 : 2;
  Args a{};
  bool vec = (k_s1 * esize) % 16 == 0 && (k_s2 * esize) % 16 == 0 &&
             (k_sh * esize) % 16 == 0 && (v_s1 * esize) % 16 == 0 &&
             (v_s2 * esize) % 16 == 0 && (v_sh * esize) % 16 == 0;
  for (int l = 0; l < lc; ++l) {
    a.src[0][l] = k_src[l];
    a.src[1][l] = v_src[l];
    vec = vec && reinterpret_cast<uintptr_t>(k_src[l]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v_src[l]) % 16 == 0;
  }
  a.pool[0] = k_pool;
  a.pool[1] = v_pool;
  a.scale[0] = k_scale;
  a.scale[1] = v_scale;
  a.s1[0] = k_s1; a.s2[0] = k_s2; a.sh[0] = k_sh;
  a.s1[1] = v_s1; a.s2[1] = v_s2; a.sh[1] = v_sh;
  a.blk = blk;
  a.off = off;
  a.kvh = fast_div(kvh);
  a.lc = fast_div(lc);
  a.r2 = fast_div(r2);
  a.blk_div = fast_div(blk_div);
  a.bt = fast_div(bt);
  a.per_side = (unsigned)rows * lc * kvh;
  a.nb = nb; a.nl = nl; a.l0 = l0;
  a.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case tds::kF32: return launch_src<float>(pool_dtype, dh, a, st);
    case tds::kBF16: return launch_src<__nv_bfloat16>(pool_dtype, dh, a, st);
    case tds::kF16: return launch_src<__half>(pool_dtype, dh, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The v1 kernel (off every path): one writer call from stacked sources,
// k_src/v_src in src_dtype with element strides (layer, outer row, inner
// row, head) each, any Dh <= 128; the rest as `kv_write`.
extern "C" int kv_write_v1(const void* k_src, const void* v_src, void* k_pool,
                           void* v_pool, float* k_scale, float* v_scale,
                           const long long* blk, const long long* off,
                           long long k_sl, long long k_s1, long long k_s2,
                           long long k_sh, long long v_sl, long long v_s1,
                           long long v_s2, long long v_sh, int rows, int r2,
                           int lc, int kvh, int dh, int blk_div, int bt,
                           int nb, int nl, int l0, int src_dtype,
                           int pool_dtype, void* stream) {
  if (dh < 1 || dh > 32 * kPerLane || rows < 0 || r2 < 1 || lc < 1 ||
      kvh < 1 || blk_div < 1 || l0 < 0 || l0 + lc > nl)
    return cudaErrorInvalidValue;
  const bool quant = pool_dtype == tds::kI8 || pool_dtype == tds::kFP8E4M3;
  if (quant && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  const long long vectors = 2LL * rows * lc * kvh;
  if (vectors == 0) return cudaSuccess;
  const long long grid = (vectors + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ArgsV1 a{{k_src, v_src}, {k_pool, v_pool}, {k_scale, v_scale},
           {k_sl, v_sl}, {k_s1, v_s1}, {k_s2, v_s2}, {k_sh, v_sh},
           blk, off, rows, r2, lc, kvh, dh, blk_div, bt, nb, nl, l0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case tds::kF32:
      return launch_v1<float>(pool_dtype, a, (unsigned)grid, st);
    case tds::kBF16:
      return launch_v1<__nv_bfloat16>(pool_dtype, a, (unsigned)grid, st);
    case tds::kF16:
      return launch_v1<__half>(pool_dtype, a, (unsigned)grid, st);
    default:
      return cudaErrorInvalidValue;
  }
}
