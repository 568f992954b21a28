// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// Shared helpers for the port's hand-written kernels: dtype codes used by
// the ctypes interface, float conversion, and vector row loads (the
// 1-byte int8 / e4m3 loads serve the quantized KV pool).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tds {

// dtype codes passed from Python (ops/_build.py callers)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kFP8E4M3 = 4 };

// masked score: finite, so an all-masked tile never turns the online
// softmax stats into NaN; exp(-1e30 - m) underflows to 0 against any
// live max
constexpr float kMasked = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}
// e4m3 -> half is exact, and so is half -> float
__device__ __forceinline__ float fp8_byte_to_f(unsigned char b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}
template <> __device__ __forceinline__ float to_f<__nv_fp8_e4m3>(__nv_fp8_e4m3 v) {
  return fp8_byte_to_f(v.__x);
}

// Offset of row 0 of head `hh`'s (T, D) panel in batch element `b` of a
// tensor with `nh` heads, laid out (B, nh, T, D) (rows D apart) or
// heads-last, (B, T, nh, D) (rows nh * D apart: `row_stride`).
template <bool BTHD>
__host__ __device__ __forceinline__ size_t panel_offset(int b, int hh, int nh,
                                                        int seqlen, int D) {
  return BTHD ? ((size_t)b * seqlen * nh + hh) * D
              : ((size_t)b * nh + hh) * seqlen * D;
}

template <bool BTHD>
__host__ __device__ __forceinline__ int row_stride(int nh, int D) {
  return BTHD ? nh * D : D;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// N contiguous elements at p (16-byte aligned) -> out[0..N) as float,
// in 16-byte loads.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  static_assert(N % 4 == 0, "float rows load as float4");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    float4 u = *reinterpret_cast<const float4*>(p + i);
    out[i] = u.x; out[i + 1] = u.y; out[i + 2] = u.z; out[i + 3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  static_assert(N % 8 == 0, "bf16 rows load as 8-element uint4");
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h2[j]);
      out[i + 2 * j] = f.x;
      out[i + 2 * j + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __half* p, float* out) {
  static_assert(N % 8 == 0, "f16 rows load as 8-element uint4");
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const __half2* h2 = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __half22float2(h2[j]);
      out[i + 2 * j] = f.x;
      out[i + 2 * j + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_row(const int8_t* p, float* out) {
  static_assert(N % 16 == 0, "int8 rows load as 16-element uint4");
#pragma unroll
  for (int i = 0; i < N; i += 16) {
    uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 16; ++j) out[i + j] = static_cast<float>(b[j]);
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_fp8_e4m3* p, float* out) {
  static_assert(N % 16 == 0, "e4m3 rows load as 16-element uint4");
#pragma unroll
  for (int i = 0; i < N; i += 16) {
    uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&u);
#pragma unroll
    for (int j = 0; j < 16; ++j) out[i + j] = fp8_byte_to_f(b[j]);
  }
}

}  // namespace tds
