// K3's step on Hopper: the pieces of furthest point sampling's serial step that
// the kernel (fps.cu) and its skeleton floor (fps_floor.cu, design v2) share,
// so that the floor times the kernel's own reduction.
//
// Shared memory is addressed by 32-bit shared-window addresses, computed once
// before the loop: through a C++ pointer nvcc recomputes a shared address
// from the CTA's cluster id (S2R SR_CgaCtaId) at each use in the loop, on the
// step's chain.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared(unsigned addr, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_shared_u32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float ld_shared_f32(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The argmax of (key, idx) over a warp, as every lane gets it: the largest
// key (redux.sync max), then the lowest index among the lanes that hold it
// (redux.sync min). Keys are the bits of d^2 >= +0, which order as the floats.
__device__ __forceinline__ void warp_argmax(unsigned key, unsigned idx, unsigned& wkey,
                                            unsigned& widx) {
  wkey = __reduce_max_sync(kFull, key);
  widx = __reduce_min_sync(kFull, key == wkey ? idx : UINT_MAX);
}

// The warps' slots, [2][32] keys then [2][32] indices from `base` (32-bit
// shared addresses), double-buffered by step parity. Slots of lanes past the
// last warp hold key 0 and index UINT_MAX for good, so every lane reads one.
__device__ __forceinline__ void init_slots(unsigned base, int tid, int n_warps) {
  if (tid < 64 && (tid & 31) >= n_warps) {
    st_shared(base + 4 * tid, 0u);
    st_shared(base + 4 * (64 + tid), UINT_MAX);
  }
}

// The block's argmax at step parity `buf`, from each warp's (wkey, widx): the
// owner of each warp's winner (its idx == widx) writes the warp's slot, one
// barrier, then every warp reduces the slots. Every thread gets the result.
__device__ __forceinline__ void block_argmax(unsigned base, int buf, int lane, int warp,
                                             unsigned idx, unsigned& wkey, unsigned& widx) {
  if (idx == widx) {
    st_shared(base + 4 * (32 * buf + warp), wkey);
    st_shared(base + 4 * (64 + 32 * buf + warp), widx);
  }
  __syncthreads();
  const unsigned sk = ld_shared_u32(base + 4 * (32 * buf + lane));
  const unsigned si = ld_shared_u32(base + 4 * (64 + 32 * buf + lane));
  warp_argmax(sk, si, wkey, widx);
}

}  // namespace
