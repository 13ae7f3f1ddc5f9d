// K3's latency floor for Hopper (sm_90a): a measuring kernel, on no model path.
//
// fps_chain_floor runs the serial skeleton of furthest point sampling's steps
// alone (csrc/fps.cu::fps_kernel without its points): a warp reduction of
// (value, index), the winner's slot write, one barrier, the second reduction
// over the slots and the winner's read, each step fed by the last. Its time
// over npoint - 1 steps on K3's block is the least a one-block FPS with this
// reduction can take: the latency-aware bound chip_smoke.py reports beside K3
// (replacing open3dsot_tpu/ops/fps_pallas.py::furthest_point_sample_pallas),
// whose operations over the card's peak rate count no latency of the chain.
//
// Interface: plain C, loaded with ctypes; the pointer is a device pointer and
// the stream is PyTorch's current stream. Returns 0, a CUDA error code, or -1
// for arguments the kernel does not take.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kErrArgs = -1;
constexpr int kMaxThreads = 1024;  // K3's largest block (csrc/fps.cu)

// (v, i) beats (bv, bi): a larger value, or the lower index on an equal value (as K3)
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kMaxThreads) fps_chain_kernel(int steps, float* __restrict__ out) {
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
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
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
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
      const int ow = __shfl_xor_sync(0xffffffffu, ww, off);
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

}  // namespace

// `steps` steps of the skeleton on one block of `threads` threads (K3's block
// at N = threads); out: one float, written so that the chain is kept.
extern "C" int fps_chain_floor(int steps, int threads, float* out, void* stream) {
  if (steps < 1 || threads < 32 || threads > kMaxThreads || threads % 32) return kErrArgs;
  fps_chain_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(steps, out);
  return static_cast<int>(cudaGetLastError());
}
