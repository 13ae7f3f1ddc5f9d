// bf16 on Hopper's tensor cores: the pieces of the bf16 compute mode that K1/K2
// (chain_fused.cu) and K4/K5 (sa_fused.cu) share.
//
// The mode is the JAX kernels' `cdt = bfloat16`: every product takes bf16
// operands (rounded to nearest even) and accumulates in f32; one tensor-core
// pass a product, where 3xTF32 (tf32_tc.cuh) takes three. Weights are rounded
// and packed once on the host (ops/chain_fused.py::pack_chunks_bf16) in the
// same chunks of kCC output x kKC input channels as the TF32 mode, one part
// (no lo), each in wgmma's no-swizzle K-major layout for 16-bit types (wofs16):
// "core matrices" of 8 channels x 8 inputs (128 contiguous bytes), 128 bytes
// between core matrices along k (LBO), 8 * kKC * 2 bytes between groups of 8
// channels (SBO). A chunk is 8 KB; one bulk copy (TMA) brings it into shared
// memory. Activations are rounded to bf16 in registers as each A fragment is
// loaded (cvt.rn.bf16x2.f32), or stored as bf16 where a kernel keeps them so.
//
// A k16 step's A fragment (mma.sync m16n8k16 and wgmma m64nNk16 alike, per
// warp of 16 rows): a0 = rows g, inputs 2q, 2q + 1; a1 = rows g + 8, the same
// inputs; a2, a3 = the same rows at inputs 2q + 8, 2q + 9; the lower input in
// the low half. The f32 accumulators are laid out as in the TF32 mode.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tc.cuh"  // kCC, kKC, the mbarriers and the bulk copy

namespace {

constexpr int kWPart16 = kCC * kKC;       // bf16 values of one chunk
constexpr int kWStage16 = kWPart16 / 2;   // floats of one chunk (8 KB)

// the bits of x rounded to bf16, to nearest even
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  uint16_t h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return h;
}

// x rounded to bf16, as an f32: the value the tensor cores multiply
__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits(x)) << 16);
}

// {lo, hi} rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Element offset of (output channel n, input channel k) in a bf16 chunk. An
// mma.sync B fragment (channel n0 + g, inputs k0 + 2q, +1) is one 32-bit word;
// the 32 lanes read 32 consecutive words: no bank conflict.
__device__ __forceinline__ int wofs16(int n, int k) {
  return (n >> 3) * (8 * kKC) + (k >> 3) * 64 + (n & 7) * 8 + (k & 7);
}

__device__ __forceinline__ uint64_t smem_desc16(const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |            // LBO: next core matrix along k
         (static_cast<uint64_t>((8 * kKC * 2) >> 4) << 32);   // SBO: next 8 channels
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (64 x 64, f32) (+)= A (64 x 16, bf16, registers) * B (16 x 64, bf16, smem,
// K-major). kAdd 1: d += a * b; 0: d = a * b
template <int kAdd>
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[8][4], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, %37, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kAdd)
      : "memory");
}

}  // namespace
