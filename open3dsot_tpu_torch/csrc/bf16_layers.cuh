// bf16 Dense layers over 64-row tiles with A and B both read by the tensor
// cores from shared memory: what the bf16 modes of K1/K2 (chain_fused_bf16.cu)
// and K4/K5 (sa_fused_bf16.cu) share.
//
// Weights. Packed once on the host (ops/chain_fused.py::pack_panels_bf16): W^T
// rounded to bf16 in panels of one output chunk x 64 input channels, output
// chunk major, then input k-block, zero-padded. A layer's chunk is 64 channels
// where the layer has at most 64, else 128 (wgmma m64n64k16 / m64n128k16: the
// wider one reads A half as often a product and drains half as often). A
// panel (8 or 16 KB) is in wgmma's no-swizzle K-major layout: core matrices of
// 8 channels x 8 inputs (128 contiguous bytes), 128 bytes apart along k (LBO),
// 1024 bytes between groups of 8 channels (SBO). One bulk copy (TMA) brings a
// panel into a stage of a ring.
//
// Activations. A tile of 64 rows x ka inputs (ka a multiple of 64) in bf16, in
// the same layout with rows in place of channels: 16 * ka bytes between groups
// of 8 rows. A warp's 32-bit stores of an accumulator fragment (rows g, columns
// 2q of one n8 tile) land on 32 banks; its 16-byte stores of 8 inputs of rows
// m (lane & 7) at 4 k-groups (lane >> 3) take the 4 wavefronts 512 bytes need.
//
// The ring. Stages of one panel, full / empty mbarriers; a producer warp fills
// them in the order the consumer warpgroups take the panels, the same for
// every tile (a round: each warpgroup's tile of the round). Where a round's
// panels all fit (resident), the producer loads each once and the consumers
// never release them. A consumer warpgroup sums a chunk's whole K on the
// tensor cores (64-input k-blocks, one group in flight), as the JAX kernels'
// bf16 dots sum it (preferred_element_type f32).
//
// Found on the card: a load into registers still in flight when a wgmma fence
// issues stalls the fence until it lands (so biases are read from shared
// memory); keeping a second chunk's products in flight across the epilogue
// made ptxas serialize every wgmma (C7518) and spill; a ring of its own for
// each warpgroup of a block was no faster than one shared ring.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_tc.cuh"  // bf16 rounding, wgmma_n64, wait_bar, the bulk copy

namespace {

constexpr int kRows = 64;   // rows of a tile: wgmma's M
constexpr int kKB = 64;     // inputs of a k-block
// A layer's output chunk: 64 channels where the layer has at most 64, else 128
// (wgmma's N); a panel is a chunk's weights for one k-block, 8 or 16 KB.
__host__ __device__ constexpr int chunk_width(int c) { return c > 64 ? 128 : 64; }
__host__ __device__ constexpr int panel_bytes(int c) { return chunk_width(c) * kKB * 2; }
constexpr int kWGThreads = 128;          // a consumer warpgroup
constexpr int kSmemMax = 232448;         // 227 KB, the most a block may take

// Threads of a block of nwg consumer warpgroups: one consumer warpgroup and a
// producer warp; or two and a producer warpgroup, which gives its registers
// to the consumers (setmaxnreg: 128 x kProducerRegs + 256 x kConsumerRegs <=
// 65536), since at 288 threads a thread may hold at most 168 and the
// consumers' gather, accumulators and epilogues spilled there.
__host__ __device__ constexpr int block_threads(int nwg) { return nwg == 2 ? 3 * kWGThreads : kWGThreads + 32; }
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__host__ __device__ constexpr int round64(int n) { return (n + 63) & ~63; }
__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
__host__ __device__ constexpr long long align128(long long n) { return (n + 127) & ~127LL; }

// Byte offset of (row m, input k) in a tile of width ka.
__device__ __forceinline__ uint32_t tile_ofs(int m, int k, int ka) {
  return (m >> 3) * (16 * ka) + (k >> 3) * 128 + (m & 7) * 16 + (k & 7) * 2;
}

// No-swizzle K-major descriptor: LBO 128 bytes (the next 8 inputs), sbo bytes
// to the next 8 rows.
__device__ __forceinline__ uint64_t desc_ns(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The barrier of consumer warpgroup wg alone (named barriers 1, 2).
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWGThreads) : "memory");
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// ---- clock64() phase counters: only in a build with -DBF16_PHASES (the timing
// build chip_smoke.py makes); thread 0 of each consumer warpgroup adds the
// cycles of each phase of its tiles to bf16_phase_cycles.
constexpr int kPhases = 8;
#ifdef BF16_PHASES
__device__ unsigned long long bf16_phase_cycles[kPhases];
#define PHASE_START() long long ph_t_ = clock64()
#define PHASE_END(i)                                                                   \
  do {                                                                                 \
    const long long t_ = clock64();                                                    \
    if ((threadIdx.x & (kWGThreads - 1)) == 0) atomicAdd(&bf16_phase_cycles[i], static_cast<unsigned long long>(t_ - ph_t_)); \
    ph_t_ = t_;                                                                        \
  } while (0)
#define PHASE_ADD(i, c) \
  do { if ((threadIdx.x & (kWGThreads - 1)) == 0) atomicAdd(&bf16_phase_cycles[i], static_cast<unsigned long long>(c)); } while (0)
#else
#define PHASE_START()
#define PHASE_END(i)
#define PHASE_ADD(i, c)
#endif

// n8 tiles of a chunk as a type: 8 (64 channels) or 16 (128); a kernel picks
// a layer's instantiation at run time (if cw == 128: f(Tiles<16>{}) ...)
template <int N>
using Tiles = std::integral_constant<int, N>;

// A consumer warpgroup's view of the ring.
struct Ring {
  uint32_t stages;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int nst;          // stages
  int sbytes;       // bytes between stages: the widest panel
  int resident;     // the round's panels all fit: loaded once, never released
  int u;            // panels taken in this round
  long long g;      // panels taken in all rounds
  long long waited; // cycles waiting on full (the phase build)
};

// acc = A (the tile at shared address a, width ka) x the ring's next ka / 64
// panels of NT x 8 output channels (NT 8 or 16: wgmma m64n64k16 or m64n128k16),
// summed over the whole K on the tensor cores, one group in flight: each
// panel's stage is freed once the products after it are issued.
template <int NT>
__device__ __forceinline__ void chunk_products(float (&acc)[NT][4], uint32_t a, int ka, Ring& r) {
  const int lane = threadIdx.x & 31, nkb = ka / kKB;
  const uint32_t sbo = 16 * ka;
#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = r.resident ? r.u : static_cast<int>(r.g % r.nst);
#ifdef BF16_PHASES
    const long long w0 = clock64();
#endif
    wait_bar(&r.full[s], r.resident ? 0u : static_cast<uint32_t>((r.g / r.nst) & 1));
#ifdef BF16_PHASES
    r.waited += clock64() - w0;
#endif
    const uint32_t ak = a + kb * (kKB / 8) * 128, b = r.stages + s * r.sbytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKB / 16; ++ks)
      wgmma_ns<NT * 8, 0, 0>(acc, desc_ns(ak + ks * 256, sbo), desc_ns(b + ks * 256, 1024), kb | ks);
    wgmma_commit();
    if (kb > 0) {  // the previous k-block's products are done: free its stage
      wgmma_wait<1>();
      if (!r.resident && lane == 0) mbar_arrive(&r.empty[(r.g - 1) % r.nst]);
    }
    ++r.u;
    ++r.g;
  }
  wgmma_wait<0>();
  if (!r.resident && lane == 0) mbar_arrive(&r.empty[(r.g - 1) % r.nst]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_operand(acc[nt][i]);
}

// Bytes of a k-block of a tile (64 rows x 64 inputs, sbo 1024).
constexpr int kKBBytes = kRows * kKB * 2;

// As chunk_products, for a tile too wide to keep in shared memory: its
// k-blocks are built one at a time by fill(kb, dst) into two buffers of
// kKBBytes at bufs, k-block kb + 1 while kb's products run. Consumer
// warpgroup wg; nothing may read bufs when it is called, nor after it returns.
template <int NT, class Fill>
__device__ __forceinline__ void chunk_products_streamed(float (&acc)[NT][4], uint8_t* bufs, int nkb,
                                                        Ring& r, int wg, Fill fill) {
  const int lane = threadIdx.x & 31;
  fill(0, bufs);
  fence_proxy_async();
  wg_bar(wg);
#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = r.resident ? r.u : static_cast<int>(r.g % r.nst);
#ifdef BF16_PHASES
    const long long w0 = clock64();
#endif
    wait_bar(&r.full[s], r.resident ? 0u : static_cast<uint32_t>((r.g / r.nst) & 1));
#ifdef BF16_PHASES
    r.waited += clock64() - w0;
#endif
    const uint32_t ak = smem_addr(bufs + (kb & 1) * kKBBytes), b = r.stages + s * r.sbytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKB / 16; ++ks)
      wgmma_ns<NT * 8, 0, 0>(acc, desc_ns(ak + ks * 256, 16 * kKB), desc_ns(b + ks * 256, 1024), kb | ks);
    wgmma_commit();
    if (kb + 1 < nkb) {  // the other buffer: its last reader, k-block kb - 1, is done
      fill(kb + 1, bufs + ((kb + 1) & 1) * kKBBytes);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    if (!r.resident && lane == 0) mbar_arrive(&r.empty[s]);
    ++r.u;
    ++r.g;
    wg_bar(wg);  // every warp's products of kb are done; k-block kb + 1 is in place
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_operand(acc[nt][i]);
}

// The producer's side: panel g of all rounds (u of its round; `bytes` of it)
// from src into its stage (sbytes apart); resident rings are filled in round 0
// only.
__device__ __forceinline__ void ring_fill(uint8_t* stages, int sbytes, uint64_t* full,
                                          uint64_t* empty, int nst, int resident, long long g,
                                          int u, const float* src, int bytes) {
  const int s = resident ? u : static_cast<int>(g % nst);
  if (!resident && g >= nst) wait_bar(&empty[s], static_cast<uint32_t>(((g / nst) + 1) & 1));
  bulk_load(reinterpret_cast<float*>(stages + static_cast<size_t>(s) * sbytes), src, &full[s], bytes);
}

// Asynchronous copies into shared memory (cp.async), `bytes` of them read and
// the rest of the 16 / 4 zero-filled: 0 bytes reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Two values of row m, columns k, k + 1 (k even) of a tile, rounded to bf16.
__device__ __forceinline__ void put_pair(uint8_t* tile, int m, int k, int ka, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(tile + tile_ofs(m, k, ka)) = pack_bf16(v0, v1);
}

}  // namespace
