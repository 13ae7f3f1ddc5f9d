// 3xTF32 on Hopper's tensor cores: the pieces K1/K2 (chain_fused.cu) and K6
// (sa_fused_train.cu) share.
//
//   a = a_hi + a_lo, a_hi = rna_tf32(a), a_lo = rna_tf32(a - a_hi), w likewise,
//   a * w ~ a_lo * w_hi + a_hi * w_lo + a_hi * w_hi   (f32 accumulators),
//
// dropping a_lo * w_lo (about 2^-22 of the product). Weights are split and
// packed on the host (ops/chain_fused.py::pack_chunks) as chunks of kCC
// output x kKC input channels, W^T hi then W^T lo, each part in wgmma's
// no-swizzle K-major layout (wofs below); one bulk copy (TMA) brings a chunk
// into shared memory as the tensor cores read it, completing on an mbarrier.
// Activations are split as they are loaded: into A fragments in registers
// (K1/K2), or into shared memory in the weights' layout (K6).
//
// The tensor cores do not round their f32 sums to nearest, so a caller sums
// each chunk's products in registers of their own and adds them on the CUDA
// cores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCC = 128;           // output channels per weight chunk
constexpr int kKC = 32;            // input channels per weight chunk
constexpr int kWPart = kCC * kKC;  // floats of one part (hi or lo) of a chunk
constexpr int kWStage = 2 * kWPart;  // floats of one chunk: hi then lo

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- mbarriers and the bulk copy (TMA) of a weight chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One thread: a chunk of kWStage floats from device memory into a stage, the
// stage's mbarrier completing when the bytes have landed.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint64_t* bar) {
  constexpr uint32_t bytes = kWStage * sizeof(float);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after generic reads of dst
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Float offset of (output channel n, input channel k) in one part of a weight
// chunk: "core matrices" of 8 channels x 4 inputs (128 contiguous bytes),
// K-major, as wgmma's no-swizzle layout takes B: 128 bytes between core
// matrices along k (LBO), 8 * kKC * 4 bytes between groups of 8 channels (SBO).
// An mma.sync B fragment (channel n0 + g, input k0 + q) reads 32 consecutive
// words: no bank conflict either.
__device__ __forceinline__ int wofs(int n, int k) {
  return (n >> 3) * (8 * kKC) + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// --- wgmma: D (64 x N, f32) += A (64 x 8, TF32, registers) * B (8 x N, TF32, smem)

__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |            // LBO: next core matrix along k
         (static_cast<uint64_t>((8 * kKC * 4) >> 4) << 32);   // SBO: next 8 channels
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// kAdd 1: d += a * b; 0: d = a * b
template <int kAdd>
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, %37, 1, 1;\n"
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

// D (64 x 128, f32) += A (64 x 8) * B (8 x 128), both TF32 from shared memory
// (descriptors of smem_desc's layout); d[nt] holds columns nt * 8 + 2q, +1.
// Nothing of the product is read from registers after the issue, so the
// threads may go on while it runs.
template <int kAdd>
__device__ __forceinline__ void wgmma_m64n128k8_ss(float (&d)[16][4], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, %66, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "n"(kAdd)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to the tensor cores'
// reads (wgmma, TMA); each writing thread, before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins a register across an asynchronous product: its value is used only
// after this point.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

}  // namespace
