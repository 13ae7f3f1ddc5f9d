// Furthest point sampling for Hopper (sm_90a).
//
// K3  fps_k3 replaces open3dsot_tpu/ops/fps_pallas.py::furthest_point_sample_pallas
//     (Pallas kernel _fps_kernel). xyz (B, N, 3) f32 -> (B, npoint) int32:
//     seed index 0; each step picks the point whose squared distance to the
//     selected set (a running min that starts at 1e10) is largest, the lowest
//     index on ties.
//
// What bounds it on this card. The npoint - 1 steps form a serial chain: step
// s needs the point that step s - 1 picked. The work per step is tiny (N
// distance updates and one argmax); its time is the latency of one block-wide
// reduction and one barrier. One cloud is one block, so at B = 1 (the eval
// loop) the kernel runs on one SM of 132 and its time is npoint x the step
// latency; at B = 16 sixteen SMs run side by side. Spreading one cloud over
// several SMs (a cluster reduction over distributed shared memory) is left to
// a later change.
//
// What the design does about it.
//  - The cloud and its running min stay in registers for the whole loop: PPT
//    points per thread, point j on thread j % T (T threads). Device memory is
//    read once.
//  - One barrier per step. Each warp reduces (value, index) with shuffles;
//    the lane that owns the warp's winner writes value, index and the
//    winner's coordinates to a shared slot; after the barrier every warp
//    reduces the slots again and reads the winner's coordinates from its
//    slot. The slots are double-buffered by step parity, so no second
//    barrier is needed before the next step overwrites them.
//  - Ties: a thread scans its points in ascending index with a strict >, and
//    the shuffle reductions prefer the lower index on equal values, so the
//    argmax is the lowest index, as torch.argmax and jnp.argmax.
//  - Exact indices need the same rounding as the plain version: d^2 is
//    ((dx*dx) + (dy*dy)) + (dz*dz) with __fmul_rn/__fadd_rn, which nvcc does
//    not contract into FMAs.
//  - The TPU kernel padded N with copies of point 0 and B to 8; here the
//    slots past N are masked and B is the grid.
//
// Interface: plain C, loaded with ctypes; pointers are device pointers and the
// stream is PyTorch's current stream. Returns 0, a CUDA error code, or -1 for
// arguments the kernel does not take.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kErrArgs = -1;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPPT = 32;  // N <= 32768

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (v, i) beats (bv, bi): a larger value, or the lower index on an equal value
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  __shared__ float slot_v[2][32], slot_x[2][32], slot_y[2][32], slot_z[2][32];
  __shared__ int slot_i[2][32];
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;

  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = tid + i * T;
    const bool valid = j < N;
    px[i] = valid ? p[3 * j] : 0.f;
    py[i] = valid ? p[3 * j + 1] : 0.f;
    pz[i] = valid ? p[3 * j + 2] : 0.f;
    md[i] = valid ? 1e10f : -1.f;  // a masked slot never wins
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (tid == 0) o[0] = 0;

  for (int s = 1; s < npoint; ++s) {
    const int buf = s & 1;
    float best = -1.f, bx = 0.f, by = 0.f, bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int j = tid + i * T;
      if (j < N) {
        md[i] = fminf(md[i], sqdist(px[i], py[i], pz[i], lx, ly, lz));
        if (md[i] > best) {
          best = md[i];
          bi = j;
          bx = px[i];
          by = py[i];
          bz = pz[i];
        }
      }
    }
    float wv = best;
    int wi = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
      if (beats(ov, oi, wv, wi)) {
        wv = ov;
        wi = oi;
      }
    }
    // the owner of the warp's winner publishes it (lane 0 for a warp with no point)
    if (bi == wi && (wi != INT_MAX || lane == 0)) {
      slot_v[buf][warp] = wv;
      slot_i[buf][warp] = wi;
      slot_x[buf][warp] = bx;
      slot_y[buf][warp] = by;
      slot_z[buf][warp] = bz;
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
    lx = slot_x[buf][ww];
    ly = slot_y[buf][ww];
    lz = slot_z[buf][ww];
    if (tid == 0) o[s] = wi;
  }
}

template <int PPT>
int launch(const float* xyz, int B, int N, int npoint, int* out, int threads, cudaStream_t s) {
  fps_kernel<PPT><<<B, threads, 0, s>>>(xyz, N, npoint, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fps_k3(const float* xyz, int B, int N, int npoint, int* out, void* stream) {
  if (B < 1 || N < 1 || npoint < 1 || N > kMaxThreads * kMaxPPT) return kErrArgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = N < kMaxThreads ? (N + 31) / 32 * 32 : kMaxThreads;
  const int ppt = (N + threads - 1) / threads;
  if (ppt <= 1) return launch<1>(xyz, B, N, npoint, out, threads, s);
  if (ppt <= 2) return launch<2>(xyz, B, N, npoint, out, threads, s);
  if (ppt <= 4) return launch<4>(xyz, B, N, npoint, out, threads, s);
  if (ppt <= 8) return launch<8>(xyz, B, N, npoint, out, threads, s);
  if (ppt <= 16) return launch<16>(xyz, B, N, npoint, out, threads, s);
  return launch<32>(xyz, B, N, npoint, out, threads, s);
}
