// K4's ball query, shared by both modes of K4/K5 (sa_fused.cu, 3xTF32;
// sa_fused_bf16.cu, bf16): one warp per centroid walks the points in chunks of
// 32 (strict d^2 < r^2, d^2 = ((dx*dx) + (dy*dy)) + (dz*dz) with
// __fmul_rn/__fadd_rn, the rounding of the plain version); a ballot and popc
// give each in-ball point its slot in ascending index order; the walk stops
// once K are found; slots past the count repeat the first; a centroid with no
// point in the ball gets index 0 (the CUDA op's convention).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBqThreads = 256;  // ball query: a warp per centroid

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// K4's ball query: warp w of block x takes centroid x * 8 + w of batch element y.
__global__ void __launch_bounds__(kBqThreads) bq_kernel(const float* __restrict__ xyz,
                                                        const float* __restrict__ centers,
                                                        int* __restrict__ idx, int N, int S, int K,
                                                        float r2) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int s = blockIdx.x * (kBqThreads / 32) + (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp
  const float* c = centers + (static_cast<long long>(b) * S + s) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  const float* x = xyz + static_cast<long long>(b) * N * 3;
  int* slots = idx + (static_cast<long long>(b) * S + s) * K;
  int count = 0, first = 0;
  for (int base = 0; base < N && count < K; base += 32) {
    const int j = base + lane;
    bool in_ball = false;
    if (j < N) in_ball = sqdist(cx, cy, cz, x[3 * j], x[3 * j + 1], x[3 * j + 2]) < r2;
    const unsigned m = __ballot_sync(0xffffffffu, in_ball);
    if (count == 0 && m) first = base + __ffs(m) - 1;
    const int pos = count + __popc(m & ((1u << lane) - 1u));
    if (in_ball && pos < K) slots[pos] = j;
    count += __popc(m);
  }
  for (int k = min(count, K) + lane; k < K; k += 32) slots[k] = first;
}

}  // namespace
