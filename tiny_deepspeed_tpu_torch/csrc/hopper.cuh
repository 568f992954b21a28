// Copyright 2026 tiny-deepspeed-tpu authors
// SPDX-License-Identifier: Apache-2.0
//
// Hopper (sm_90a) building blocks for the tensor-core kernels (FA2 in
// flash_fwd.cu and flash_bwd.cu, the fused head's forward, dx and dW in
// fused_xent.cu):
// asynchronous 16-byte copies into shared memory, swizzled shared-memory
// tiles, wgmma descriptors and the warpgroup matrix products they feed.
//
// Tiles.  A tile is R rows of D bf16/f16 elements (D = 32 or 64), each
// row D*2 contiguous bytes (64 or 128), its base aligned to 1024 bytes.
// The 16-byte chunk c of row r sits at chunk c ^ ((r*D*2 >> 7) & mask):
// the 128-byte swizzle for D = 64 (mask 7) and the 64-byte swizzle for
// D = 32 (mask 3), the layouts wgmma's descriptors name B128 and B64.
// One tile serves both ways round:
//   * K-major (the contraction runs along D): A or B of S = Q K^T, and of
//     the fused head's logits x w (x and w^T chunks, both (rows, D));
//     eight-row groups SBO = 8*D*2 bytes apart, each k-step of 16
//     elements 32 bytes further along the row;
//   * MN-major (the contraction runs along the rows, N along D): the B
//     operand of P V (and of dx = dZ w, the w^T chunk's rows the vocab
//     contracted over), with wgmma's transpose bit; eight-row groups SBO
//     apart again, each k-step of 16 rows 16*D*2 bytes further.  With
//     D = 64 the same descriptor serves an MN-major A operand (M = 64
//     along the row, the A transpose bit): dW's w chunk, (D, V) row-major
//     in device memory, read as w^T.
// A wider row-major matrix (x (S, D), w (D, V)) is cut into 64-column
// chunks, each its own tile (`load_tile_rc`, zero past the row and
// column limits).
//
// Fragments (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup owns rows
// 16w..16w+15; lane l holds, of an f32 accumulator, d[4j + 2h + e] = row
// 16w + l/4 + 8h, column 8j + 2(l%4) + e.  Pairs d[8k + 2i], d[8k + 2i + 1]
// (i = 0..3), rounded to 16 bits and packed, are exactly register i of
// the A fragment for the k-step of columns 16k..16k+15: an accumulator
// becomes the next product's A operand without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace tds {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; !valid zero-fills the chunk
// and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronously; !valid writes 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// make this thread's generic-proxy shared-memory writes (the copies
// above) visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// pin the accumulators: the compiler must not move their reads or writes
// across a wgmma's issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// byte offset of element (r, c) in a swizzled tile with rows of D elements
template <int D>
__host__ __device__ __forceinline__ uint32_t swz(uint32_t r, uint32_t c) {
  static_assert(D == 32 || D == 64, "rows of 64 or 128 bytes");
  constexpr uint32_t mask = D == 64 ? 7 : 3;
  const uint32_t off = r * (D * 2) + c * 2;
  return off ^ (((off >> 7) & mask) << 4);
}

// wgmma shared-memory descriptor of a swizzled tile (PTX ISA "matrix
// descriptor"): start address, leading and stride byte offsets in
// 16-byte units, layout B128 (1) or B64 (2) in bits 62-63
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t layout = D == 64 ? 1 : 2;
  constexpr uint32_t sbo = 8 * D * 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows of the tile at `base`, the k-step of elements
// 16k..16k+15 of each row (LBO unused by swizzled K-major layouts)
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int k) {
  return desc<D>(base + k * 32, 16);
}

// MN-major operand (transposed B): rows 16k..16k+15 of the tile at `base`
// are the k-step; N runs along the row (one swizzle atom, so LBO unused)
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int k) {
  return desc<D>(base + k * 16 * D * 2, 16);
}

constexpr float kLog2e = 1.4426950408889634f;

// rows [r0, r0 + 64) of a (T, D) panel whose rows lie `ld` elements apart
// -> the swizzled tile at shared address `dst`, asynchronously, 16 bytes a
// thread of a THREADS-thread CTA; rows at or past `limit` are zero-filled
template <typename T, int D, int THREADS>
__device__ __forceinline__ void load_tile64(uint32_t dst, const T* src,
                                            int r0, int limit, int ld) {
  constexpr int CPR = D / 8;           // 16-byte chunks per row
  static_assert(64 * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < 64 * CPR / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CPR, c = e % CPR;
    const int g = r0 + r;
    const bool ok = g < limit;
    cp_async16(dst + swz<D>(r, c * 8),
               src + (size_t)(ok ? g : 0) * ld + c * 8, ok);
  }
}

// rows [r0, r0 + R) x columns [c0, c0 + 64) of a row-major matrix whose
// rows lie `ld` elements apart -> the swizzled R x 64 tile (128-byte
// rows) at shared address `dst`, asynchronously, 16 bytes a thread of a
// THREADS-thread CTA; 16-byte pieces at or past row `rlim` or column
// `clim` are zero-filled (ld, c0 and clim multiples of 8)
template <typename T, int R, int THREADS>
__device__ __forceinline__ void load_tile_rc(uint32_t dst, const T* src,
                                             int r0, int rlim, int c0,
                                             int clim, size_t ld) {
  static_assert(R * 8 % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < R * 8 / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / 8, c = e % 8;
    const int gr = r0 + r, gc = c0 + 8 * c;
    const bool ok = gr < rlim && gc < clim;
    cp_async16(dst + swz<64>(r, 8 * c),
               src + (ok ? (size_t)gr * ld + gc : 0), ok);
  }
}

// two f32 -> one register of packed 16-bit values (lo in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

#define TDS_D16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define TDS_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define TDS_O8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TDS_O16(d) TDS_O8(d, 0), TDS_O8(d, 8)
#define TDS_O32(d) TDS_O8(d, 0), TDS_O8(d, 8), TDS_O8(d, 16), TDS_O8(d, 24)

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) . B (64 x 16,
// shared, K-major)^T; scale_d 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " TDS_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : TDS_O32(d) : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TDS_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : TDS_O32(d) : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x 32, f32) (+)= A (64 x 16, shared, K-major) . B (32 x 16,
// shared, K-major)^T; scale_d 0 overwrites d.  The fused head's logits
// x w_tile with w^T's 32 vocab rows as B
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " TDS_D16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : TDS_O16(d) : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " TDS_D16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : TDS_O16(d) : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x 32, f32) (+)= A (64 x 16, shared, MN-major: the transpose
// bit) . B (32 x 16, shared, K-major)^T; scale_d 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32_ta(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " TDS_D16
        ", %16, %17, p, 1, 1, 1, 0;\n}\n"
        : TDS_O16(d) : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " TDS_D16
        ", %16, %17, p, 1, 1, 1, 0;\n}\n"
        : TDS_O16(d) : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x N, f32) (+)= A (64 x 16, registers) . B (16 x N, shared,
// MN-major: the transpose bit), N = D = 32 or 64; scale_d 0 overwrites d
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64, "N is the head dim");
  if constexpr (N == 64) {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " TDS_D32
          ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
          : TDS_O32(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
            "r"(scale_d));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TDS_D32
          ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
          : TDS_O32(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
            "r"(scale_d));
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " TDS_D16
          ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
          : TDS_O16(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
            "r"(scale_d));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " TDS_D16
          ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
          : TDS_O16(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
            "r"(scale_d));
    }
  }
}

#undef TDS_D16
#undef TDS_D32
#undef TDS_O8
#undef TDS_O16
#undef TDS_O32

// A fragment of k-step k (columns 16k..16k+15) from an f32 accumulator
// row block (see the header): four packed registers
template <typename T, int NACC>
__device__ __forceinline__ void acc_to_a(const float (&s)[NACC], int k,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack2<T>(s[8 * k + 2 * i], s[8 * k + 2 * i + 1]);
}

}  // namespace sm90
}  // namespace tds
