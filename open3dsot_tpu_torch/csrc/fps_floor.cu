// K3's skeleton floors for Hopper (sm_90a): measuring kernels, on no model path.
//
// Each runs the serial skeleton of one design of furthest point sampling's
// step alone, without its points, each step fed by the last. Its time over
// npoint - 1 steps is the least a one-block FPS with that step's reduction
// can take: a floor of that design, which chip_smoke.py reports beside K3
// (replacing open3dsot_tpu/ops/fps_pallas.py::furthest_point_sample_pallas).
// It is not the card's bound: K3's operations and bytes over the card's peak
// rates count no latency of the chain, and another design has another floor.
//
//  v1  K3 before its redesign, one point a thread (32 warps at N = 1024): a
//      5-round shuffle reduction of (value, index) with compare-selects, the
//      winner's slot write, one barrier, a second 5-round reduction of
//      (value, index, warp) over the slots in every warp, the winner's read.
//  v2  csrc/fps.cu::fps_kernel as it is, from the same code (fps_step.cuh):
//      two redux.sync (the largest key, the lowest index holding it) a warp,
//      the owner's slot write, one barrier, two redux.sync over the slots, the
//      winner's coordinates read from the cloud's copy in shared memory; no
//      barrier at all for one warp.
//
// Interface: plain C, loaded with ctypes; the pointer is a device pointer and
// the stream is PyTorch's current stream. Returns 0, a CUDA error code, or -1
// for arguments the kernels do not take.

#include <climits>
#include <cuda_runtime.h>

#include "fps_step.cuh"

namespace {

constexpr int kErrArgs = -1;
constexpr int kMaxThreads = 1024;

// (v, i) beats (bv, bi): a larger value, or the lower index on an equal value (as K3 v1)
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kMaxThreads) chain_v1(int steps, float* __restrict__ out) {
  __shared__ float slot_v[2][32], slot_x[2][32];
  __shared__ int slot_i[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  float lx = 0.f;
  for (int s = 1; s <= steps; ++s) {
    const int buf = s & 1;
    float wv = lx + static_cast<float>(tid);  // depends on the last step's winner
    int wi = tid;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, wv, off);
      const int oi = __shfl_xor_sync(kFull, wi, off);
      if (beats(ov, oi, wv, wi)) {
        wv = ov;
        wi = oi;
      }
    }
    if (tid == wi) {
      slot_v[buf][warp] = wv;
      slot_i[buf][warp] = wi;
      slot_x[buf][warp] = wv;
    }
    __syncthreads();
    wv = lane < n_warps ? slot_v[buf][lane] : -1.f;
    wi = lane < n_warps ? slot_i[buf][lane] : INT_MAX;
    int ww = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, wv, off);
      const int oi = __shfl_xor_sync(kFull, wi, off);
      const int ow = __shfl_xor_sync(kFull, ww, off);
      if (beats(ov, oi, wv, wi)) {
        wv = ov;
        wi = oi;
        ww = ow;
      }
    }
    lx = slot_x[buf][ww] * 1e-30f;
  }
  if (tid == 0) out[0] = lx;
}

__global__ void __launch_bounds__(kMaxThreads) chain_v2(int steps, float* __restrict__ out) {
  __shared__ unsigned slots[2][2][32];
  __shared__ float cloud[kMaxThreads];  // stands for the cloud's copy: the winner's read
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const unsigned s_slots = smem_u32(slots), s_cloud = smem_u32(cloud);
  cloud[tid] = 0.f;
  init_slots(s_slots, tid, n_warps);
  __syncthreads();
  float lx = 0.f;
  for (int s = 1; s <= steps; ++s) {
    const int buf = s & 1;
    const unsigned idx = static_cast<unsigned>(tid);
    unsigned wkey, widx;
    warp_argmax(__float_as_uint(lx + static_cast<float>(tid)), idx, wkey, widx);  // fed by the last step
    if (n_warps > 1) block_argmax(s_slots, buf, lane, warp, idx, wkey, widx);
    lx = ld_shared_f32(s_cloud + 4 * widx) * 1e-30f;
  }
  if (tid == 0) out[0] = lx;
}

}  // namespace

// `steps` steps of design 1 or 2's skeleton on one block of `threads` threads
// (the design's block for the cloud's N); out: one float, written so that the
// chain is kept.
extern "C" int fps_chain_floor(int design, int steps, int threads, float* out, void* stream) {
  if (steps < 1 || threads < 32 || threads > kMaxThreads || threads % 32) return kErrArgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    chain_v1<<<1, threads, 0, s>>>(steps, out);
  } else if (design == 2) {
    chain_v2<<<1, threads, 0, s>>>(steps, out);
  } else {
    return kErrArgs;
  }
  return static_cast<int>(cudaGetLastError());
}
