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
// together with the scatter that follows it.  Contract: the pool k/v
// (NB, bt, NL, KVH, Dh) contiguous in its resting dtype (an e4m3 pool
// arrives as its bytes), scales (NB, bt, NL, KVH) f32 on an int8 / e4m3
// pool.  Source row r of layer l and kv head h is the Dh vector at
//   src + l*sl + (r / r2)*s1 + (r % r2)*s2 + h*sh   (element strides,
// innermost stride 1): the decode slice of the qkv product, the verify
// span's (L, S, KVH, K1, Dh) stacks and the prefill's (L, 1, KVH, P, Dh)
// stacks are all read where they lie, without a contiguous copy.  Its
// destination is (blk[r / blk_div], off ? off[r] : r % bt, l0 + l, h):
// (blk, off) int64 pairs per row (decode, span commit), or whole blocks
// of bt rows (prefill, blk_div = bt, off = null).
//
//  * int8 / e4m3 pool: per vector s = absmax / qmax + 1e-12 and
//    y = x / s, the code rint(y) clamped to +-127 or the RTNE e4m3 cast
//    of y (|y| <= 448 by construction, so saturation never decides a
//    code), and s stored beside it — bit for bit the plain codec
//    (ops/quant.py `_quantize_plain`) and its Triton kernel: IEEE
//    division (__fdiv_rn, never the approximate `/` of fast math), no
//    FMA in reach (the add follows a division), bf16 / f16 inputs
//    converted to f32 first as JAX's `astype(f32)` does;
//  * bf16 / f16 / f32 pool: the row cast to the pool's type (RTNE), as
//    `x.to(pool.dtype)` rounds it.
//
// Rows that share a destination (invalid slots, bucket padding and
// rejected drafts all land in scratch block 0) race; which one lands is
// undefined, as it is for index_put, and every read masks those rows.
// A destination outside the pool traps, as index_put's device assert
// does.
//
// Bound: bytes — each source vector read once, codes (1 B an element)
// and a 4-byte scale, or the cast row, written once; a few operations an
// element against the card's ~300 flop/byte balance point.  At the
// decode shape (8 slots x 12 heads x 64, both sides) that is 37-49 KB, a
// few nanoseconds: the launch is the cost.  So the design is about
// launches: the plain version (serving/pool.py `_write`) runs, per
// writer call and side, a copy of the strided source, the quantizer and
// two index writes (codes, scales); here one launch covers both sides,
// every layer of the call and the codec.  One warp per head vector
// (Dh <= 128: up to four elements a lane, neighbouring lanes on
// neighbouring elements), the absmax by warp shuffle, four warps a CTA;
// vectors are numbered (side, row, layer, head), so a warp's neighbours
// write the neighbouring pool vectors.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;       // head vectors a CTA
constexpr int kPerLane = 4;     // elements a lane: Dh <= 128
constexpr float kEps = 1e-12f;  // ops/quant.py _EPS

struct Args {
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
kv_write_kernel(const Args a) {
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

  if constexpr (POOL == tds::kI8 || POOL == tds::kFP8E4M3) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
    for (int m = 16; m; m >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
    const float qmax = POOL == tds::kI8 ? 127.f : 448.f;
    const float s = __fadd_rn(__fdiv_rn(amax, qmax), kEps);
    unsigned char* q =
        static_cast<unsigned char*>(side ? a.pool[1] : a.pool[0]) + dst * a.dh;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d >= a.dh) break;
      const float y = __fdiv_rn(v[i], s);
      if constexpr (POOL == tds::kI8) {
        const float c = fminf(fmaxf(rintf(y), -127.f), 127.f);
        q[d] = static_cast<unsigned char>(static_cast<signed char>(c));
      } else {
        q[d] = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
      }
    }
    if (lane == 0) (side ? a.scale[1] : a.scale[0])[dst] = s;
  } else {
    using TP = typename std::conditional<
        POOL == tds::kF32, float,
        typename std::conditional<POOL == tds::kBF16, __nv_bfloat16,
                                  __half>::type>::type;
    TP* p = static_cast<TP*>(side ? a.pool[1] : a.pool[0]) + dst * a.dh;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < a.dh) p[d] = tds::from_f<TP>(v[i]);
    }
  }
}

template <typename TS>
cudaError_t launch_src(int pool_dtype, const Args& a, unsigned grid,
                       cudaStream_t st) {
  switch (pool_dtype) {
    case tds::kF32:
      kv_write_kernel<TS, tds::kF32><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    case tds::kBF16:
      kv_write_kernel<TS, tds::kBF16><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    case tds::kF16:
      kv_write_kernel<TS, tds::kF16><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    case tds::kI8:
      kv_write_kernel<TS, tds::kI8><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    case tds::kFP8E4M3:
      kv_write_kernel<TS, tds::kFP8E4M3><<<grid, kWarps * 32, 0, st>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One writer call, both sides.  k_src/v_src in src_dtype (f32, bf16,
// f16) with element strides (layer, outer row, inner row, head) each;
// k_pool/v_pool (NB, bt, NL, KVH, Dh) in pool_dtype, k_scale/v_scale
// (NB, bt, NL, KVH) f32 on an int8 / e4m3 pool; `rows` source rows (r2
// of them an outer step), `lc` layers from l0; blk (rows / blk_div,)
// and off (rows,) int64, or off null for whole blocks.
extern "C" int kv_write(const void* k_src, const void* v_src, void* k_pool,
                        void* v_pool, float* k_scale, float* v_scale,
                        const long long* blk, const long long* off,
                        long long k_sl, long long k_s1, long long k_s2,
                        long long k_sh, long long v_sl, long long v_s1,
                        long long v_s2, long long v_sh, int rows, int r2,
                        int lc, int kvh, int dh, int blk_div, int bt, int nb,
                        int nl, int l0, int src_dtype, int pool_dtype,
                        void* stream) {
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
  Args a{{k_src, v_src}, {k_pool, v_pool}, {k_scale, v_scale},
         {k_sl, v_sl}, {k_s1, v_s1}, {k_s2, v_s2}, {k_sh, v_sh},
         blk, off, rows, r2, lc, kvh, dh, blk_div, bt, nb, nl, l0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case tds::kF32:
      return launch_src<float>(pool_dtype, a, (unsigned)grid, st);
    case tds::kBF16:
      return launch_src<__nv_bfloat16>(pool_dtype, a, (unsigned)grid, st);
    case tds::kF16:
      return launch_src<__half>(pool_dtype, a, (unsigned)grid, st);
    default:
      return cudaErrorInvalidValue;
  }
}
