// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// The KV pool's per-vector codec, in ONE place for every kernel that
// writes the pool: the writer kernels of csrc/kv_write.cu and the decode
// append folded into csrc/paged_attn.cu's decode kernel.  Both must store
// the same bits for the same head vector, so both call these functions.
//
// The codec is #10's (tiny_deepspeed_tpu/ops/quant_pallas.py:59,
// `pallas_quantize_blockwise`) with the codec block = one Dh head vector,
// as the pool uses it (tiny_deepspeed_tpu/serving/pool.py
// `_quant_vectors`): per vector s = absmax / qmax + 1e-12 and y = x / s,
// the code rint(y) clamped to +-127 (int8) or the RTNE e4m3 cast of y
// (|y| <= 448 by construction, so saturation never decides a code), and
// s stored beside it; IEEE division (__fdiv_rn, never the approximate `/`
// of fast math) and no FMA in reach (the add follows a division), inputs
// converted to f32 first as JAX's `astype(f32)` does.  A bf16 / f16 / f32
// pool takes the RTNE cast of the row instead, as `x.to(pool.dtype)`.
// fmaxf is exact, so the order in which a vector's absmax is folded
// cannot change a code.

#pragma once

#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace tds {
namespace kv {

constexpr float kEps = 1e-12f;  // ops/quant.py _EPS

template <int POOL>
__host__ __device__ constexpr bool quantized() {
  return POOL == kI8 || POOL == kFP8E4M3;
}

// the element type of a bf16 / f16 / f32 pool
template <int POOL>
using cast_t = typename std::conditional<
    POOL == kF32, float,
    typename std::conditional<POOL == kBF16, __nv_bfloat16,
                              __half>::type>::type;

// the pool code of a resting element type (paged_attn.cu's TKV)
template <typename T>
__host__ __device__ constexpr int pool_code() {
  return std::is_same<T, float>::value           ? kF32
         : std::is_same<T, __nv_bfloat16>::value ? kBF16
         : std::is_same<T, __half>::value        ? kF16
         : std::is_same<T, int8_t>::value        ? kI8
                                                 : kFP8E4M3;
}

// the absmax of a vector held by an aligned group of L lanes (every lane
// of the warp calls it: the shuffles take the whole warp's mask)
template <int L>
__device__ __forceinline__ float group_max(float a) {
#pragma unroll
  for (int m = L / 2; m; m >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, m));
  return a;
}

template <int POOL>
__device__ __forceinline__ float scale_of(float amax) {
  constexpr float qmax = POOL == kI8 ? 127.f : 448.f;
  return __fadd_rn(__fdiv_rn(amax, qmax), kEps);
}

// one element's code byte under scale s
template <int POOL>
__device__ __forceinline__ unsigned char code_of(float x, float s) {
  const float y = __fdiv_rn(x, s);
  if constexpr (POOL == kI8) {
    const float c = fminf(fmaxf(rintf(y), -127.f), 127.f);
    return static_cast<unsigned char>(static_cast<signed char>(c));
  } else {
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  }
}

template <int BYTES> struct Chunk;
template <> struct Chunk<1> { using T = uint8_t; };
template <> struct Chunk<2> { using T = uint16_t; };
template <> struct Chunk<4> { using T = uint32_t; };
template <> struct Chunk<8> { using T = uint2; };
template <> struct Chunk<16> { using T = uint4; };

// N elements in registers -> dst (aligned to their size, or to 16 bytes
// past 16), in as few stores as their bytes allow
template <typename T, int N>
__device__ __forceinline__ void store_packed(T* dst, const T (&v)[N]) {
  constexpr int B = N * (int)sizeof(T);
  constexpr int W = B < 16 ? B : 16;
  using C = typename Chunk<W>::T;
#pragma unroll
  for (int i = 0; i < B / W; ++i) {
    C c;
    memcpy(&c, reinterpret_cast<const unsigned char*>(v) + i * W, W);
    reinterpret_cast<C*>(dst)[i] = c;
  }
}

// One head vector of D = EPL * L elements, held EPL contiguous elements a
// lane by an aligned group of L lanes (lane `part` of the group holds
// elements part*EPL ..), stored at pool row `dst`: the codec's codes and,
// from lane 0 of the group, the scale on an int8 / e4m3 pool; the cast
// row on a bf16 / f16 / f32 pool.  `store` false: the group only takes
// part in the absmax's shuffles (every lane of the warp must).
template <int POOL, int EPL, int L>
__device__ __forceinline__ void store_vector(const float (&v)[EPL],
                                             bool store, int part,
                                             void* pool, float* scale,
                                             long long dst) {
  constexpr int D = EPL * L;
  if constexpr (quantized<POOL>()) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) amax = fmaxf(amax, fabsf(v[i]));
    amax = group_max<L>(amax);
    if (!store) return;
    const float s = scale_of<POOL>(amax);
    unsigned char c[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) c[i] = code_of<POOL>(v[i], s);
    store_packed(static_cast<unsigned char*>(pool) + dst * D + part * EPL,
                 c);
    if (part == 0) scale[dst] = s;
  } else {
    if (!store) return;
    using TP = cast_t<POOL>;
    TP t[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) t[i] = from_f<TP>(v[i]);
    store_packed(static_cast<TP*>(pool) + dst * D + part * EPL, t);
  }
}

}  // namespace kv
}  // namespace tds
