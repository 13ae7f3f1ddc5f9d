// Training-mode set abstraction (K6) for Hopper (sm_90a), f32 on CUDA cores.
//
// Replaces open3dsot_tpu/ops/sa_fused_train.py::fused_sa_train_apply, the
// eight pallas_calls of its forward (F1-F4, :608-:668) and backward (B1-B4,
// :709-:776). One SA layer of PointNet++ in training mode over the rows
// r = (b, s, k) of the neighbourhood grid, R = B * S * K of them:
//
//   y1 = a[idx] + ct                  (layer 1 in A-form, computed outside)
//   h1 = relu(BN1(y1)), y2 = h1 W2 + b2, h2 = relu(BN2(y2)), y3 = h2 W3 + b3
//   out = max_k relu(BN3(y3))         (B, S, C3)
//
// with every BatchNorm at the statistics of this batch: mean and biased
// variance E[y^2] - E[y]^2 over all R rows, folded into a scale s = gamma /
// sqrt(var + eps) and shift t = beta - mean * s. The backward is the exact
// BN-training chain rule (global sums of dz and dz * yhat per channel), the
// max gradient split evenly over exact ties, dW = h^T dy over all rows, the
// scatter-add of dy1 into da (B, N, C1) and dct = sum_k dy1. db2 = db3 = 0
// are not computed here (the wrapper returns zeros).
//
// What bounds it on this card. At BAT_Car widths a train step makes four
// calls of R = 2048-8192 rows per sample and widths 128-256: 2.82 GFLOP of
// useful matrix work per sample forward and twice that backward, about 35
// flops per byte of the grids it must hold for the backward. At f32 on CUDA
// cores (67 TFLOP/s) that is arithmetic-bound in principle; this first
// version runs its matrix products at a fraction of that peak.
//
// What the design does about it.
//  - The passes are separate kernels on one stream, because each BatchNorm
//    needs the statistics of ALL rows before the next layer can run (on the
//    TPU the grid ran in order and carried sums in a revisited block; here
//    blocks run in parallel on 132 SMs). Each statistics pass writes one
//    partial sum per block of 512 rows, in double, and a finalize kernel
//    reduces them in a fixed order: the statistics are the same from run to
//    run, and double sums keep E[y^2] - E[y]^2 from losing digits to the
//    summation itself.
//  - Grids kept in device memory, written once: y1 = a[idx] + ct, y2 and y3
//    (pre-BN, f32), which the backward reads; dz3/dy3, dz2/dy2 and dz1/dy1
//    in the backward (each BN-backward rewrites its dz grid in place). h1,
//    h2 and h3 are never stored: relu(y * s + t) is recomputed where a kernel
//    loads y. So each useful matrix product runs once (2 forward, 4
//    backward), against about 3.5 KB of grid traffic per row at C = 256.
//  - Matrix products: one tiled SGEMM (128 x 128 block tile, 8 x 8 outputs a
//    thread, k-steps of 8 through shared memory) for y = relu(x s + t) W + b
//    (the fold and ReLU applied as the A tile is loaded) and for dz = (dy
//    W^T) * relu'(h) (the mask applied as the tile is stored). dW = h^T dy
//    is the same core with the rows as the contraction, split over row
//    chunks into per-chunk partial tiles that a second kernel sums in a fixed
//    order: no float atomics in any gradient but da.
//  - Gather: indexed float4 loads of A-form rows; the TPU's one-hot MXU
//    gather and int8 bit-plane gather have no counterpart. An index outside
//    [0, N) gives NaN rows.
//  - Scatter: da += dy1 with atomicAdd. The pad-with-first ball query
//    repeats one index up to K times per centroid, so one row of da takes
//    many adds: its sum order changes from run to run (relative rounding
//    about K * 2^-24 of the row's magnitude).
//  - Rounding pinned where a decision depends on it: relu(y * s + t) with
//    __fmul_rn/__fadd_rn (no FMA contraction), s and t from 1 / sqrt(var +
//    eps) rounded as IEEE division and square root, the tie split g / cnt
//    as IEEE division. The plain version (ops/sa_fused_train.py) computes
//    them in the same order, so on the same grids the max masks, ties and
//    ReLU masks agree bit for bit.
//
// Interface: plain C, loaded with ctypes; pointers are device pointers and
// the stream is PyTorch's current stream. The caller allocates outputs and
// the workspace (sa_train_workspace bytes). Returns 0, a CUDA error code, or
// a negative code for arguments the kernels do not take.

#include <cuda_runtime.h>

namespace {

constexpr int kErrArgs = -1;   // B, N, S, K or widths not accepted
constexpr int kErrWidth = -2;  // a width is not a multiple of 4
constexpr float kEps = 1e-5f;
constexpr int kStatRows = 512;  // rows of one partial sum
constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 8;  // SGEMM block tile
constexpr int kWantBlocks = 528;           // dW: 4 blocks of 256 threads per SM

struct Dims {
  long long R;  // B * S * K
  int B, N, S, K, C1, C2, C3;
};

__device__ __forceinline__ float fold_relu(float y, float s, float t) {
  return fmaxf(__fadd_rn(__fmul_rn(y, s), t), 0.f);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// s = gamma / sqrt(var + eps), t = beta - mean * s, inv = 1 / sqrt(var + eps)
__device__ __forceinline__ void fold_of(float mean, float var, float gamma, float beta, float* s,
                                        float* t, float* inv) {
  const float iv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kEps)));
  const float sc = __fmul_rn(gamma, iv);
  *s = sc;
  *t = __fsub_rn(beta, __fmul_rn(mean, sc));
  *inv = iv;
}

// ---- F1: y1 = a[idx] + ct ------------------------------------------------
__global__ void gather_kernel(const float* __restrict__ a, const float* __restrict__ ct,
                              const int* __restrict__ idx, float* __restrict__ y1, Dims d) {
  const int c4 = d.C1 / 4;
  const long long total = d.R * c4;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / c4;
    const int c = static_cast<int>(e - r * c4) * 4;
    const long long bs = r / d.K;
    const long long b = bs / d.S;
    const int j = idx[r];
    float4 v;
    if (j >= 0 && j < d.N) {
      const float4 av = ld4(a + (b * d.N + j) * d.C1 + c);
      const float4 cv = ld4(ct + bs * d.C1 + c);
      v = make_float4(av.x + cv.x, av.y + cv.y, av.z + cv.z, av.w + cv.w);
    } else {
      const float nan = __int_as_float(0x7fc00000);
      v = make_float4(nan, nan, nan, nan);
    }
    st4(y1 + r * d.C1 + c, v);
  }
}

// ---- per-channel sums over the rows, one partial per chunk of rows --------
// y == nullptr: (sum x, sum x^2); else (sum x, sum x * yhat), yhat = (y - mu) * inv.
// Block (32, 8): 32 channels, 8 row lanes; grid (C / 32, chunks).
__global__ void stats_kernel(const float* __restrict__ x, const float* __restrict__ y,
                             const float* __restrict__ mu, const float* __restrict__ inv,
                             double* __restrict__ part, long long R, int C) {
  __shared__ double sh[2][8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const long long r0 = static_cast<long long>(blockIdx.y) * kStatRows;
  const long long r1 = min(R, r0 + kStatRows);
  double s1 = 0.0, s2 = 0.0;
  if (c < C) {
    const float m = y ? mu[c] : 0.f, iv = y ? inv[c] : 0.f;
    for (long long r = r0 + ty; r < r1; r += 8) {
      const float v = x[r * C + c];
      const float w = y ? __fmul_rn(__fsub_rn(y[r * C + c], m), iv) : v;
      s1 += v;
      s2 += static_cast<double>(v) * static_cast<double>(w);
    }
  }
  sh[0][ty][tx] = s1;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty == 0 && c < C) {
    double a = 0.0, b = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a += sh[0][i][tx];
      b += sh[1][i][tx];
    }
    part[(static_cast<long long>(blockIdx.y) * 2) * C + c] = a;
    part[(static_cast<long long>(blockIdx.y) * 2 + 1) * C + c] = b;
  }
}

// Sum the partials of each channel in a fixed order (one warp a channel).
__device__ __forceinline__ void reduce_partials(const double* part, int P, int C, int c,
                                                double* s1, double* s2) {
  const int lane = threadIdx.x & 31;
  double a = 0.0, b = 0.0;
  for (int p = lane; p < P; p += 32) {
    a += part[(static_cast<long long>(p) * 2) * C + c];
    b += part[(static_cast<long long>(p) * 2 + 1) * C + c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  *s1 = a;
  *s2 = b;
}

// Forward: mean, biased var -> stats; fold (s, t, inv) for the next pass.
__global__ void finalize_fwd_kernel(const double* __restrict__ part, int P, int C, double M,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta, float* __restrict__ mean,
                                    float* __restrict__ var, float* __restrict__ fold) {
  const int c = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (c >= C) return;
  double s1, s2;
  reduce_partials(part, P, C, c, &s1, &s2);
  if ((threadIdx.x & 31) == 0) {
    const double md = s1 / M;
    const float mu = static_cast<float>(md), v = static_cast<float>(s2 / M - md * md);
    mean[c] = mu;
    var[c] = v;
    fold_of(mu, v, gamma[c], beta[c], fold + c, fold + C + c, fold + 2 * C + c);
  }
}

// Backward: dbeta = sum dz, dgamma = sum dz * yhat; coef = (sum dz / M, sum dz yhat / M).
__global__ void finalize_bwd_kernel(const double* __restrict__ part, int P, int C, double M,
                                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                                    float* __restrict__ coef) {
  const int c = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (c >= C) return;
  double s1, s2;
  reduce_partials(part, P, C, c, &s1, &s2);
  if ((threadIdx.x & 31) == 0) {
    const float sdz = static_cast<float>(s1), sdzy = static_cast<float>(s2);
    dbeta[c] = sdz;
    dgamma[c] = sdzy;
    coef[c] = __fdiv_rn(sdz, static_cast<float>(M));
    coef[C + c] = __fdiv_rn(sdzy, static_cast<float>(M));
  }
}

// Backward: the fold of each layer again from the saved statistics.
__global__ void fold_kernel(const float* __restrict__ mean, const float* __restrict__ var,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            float* __restrict__ fold, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) fold_of(mean[c], var[c], gamma[c], beta[c], fold + c, fold + C + c, fold + 2 * C + c);
}

// ---- SGEMM core: acc[8][8] += As^T-tile x Bs-tile over BK ------------------
__device__ __forceinline__ void mma_tile(const float (&As)[BK][BM], const float (&Bs)[BK][BN],
                                         int tx, int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// row of acc index i (0..7) within the block tile, and likewise columns
__device__ __forceinline__ int tile_row(int i, int ty) { return (i >> 2) * 64 + ty * 4 + (i & 3); }

// C (M x N) = op(A) (M x K) B (K x N) [+ bias], op(a) = relu(a * ps + pt) when ps;
// with my: C = C where relu(my * ms + mt) > 0, else 0. K, N multiples of 4.
__global__ void __launch_bounds__(kThreads, 2)
    gemm_nn_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                   float* __restrict__ Cm, long long M, int N, int K, const float* __restrict__ ps,
                   const float* __restrict__ pt, const float* __restrict__ bias,
                   const float* __restrict__ my, const float* __restrict__ ms,
                   const float* __restrict__ mt) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ar = tid / 2, ak = (tid % 2) * 4;   // A tile: 128 rows x 8 k
  const int bk = tid / 32, bn = (tid % 32) * 4;  // B tile: 8 k x 128 n
  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const long long r = m0 + ar;
      const int k = k0 + ak;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < M && k < K) {
        v = ld4(A + r * K + k);
        if (ps) {
          v.x = fold_relu(v.x, ps[k], pt[k]);
          v.y = fold_relu(v.y, ps[k + 1], pt[k + 1]);
          v.z = fold_relu(v.z, ps[k + 2], pt[k + 2]);
          v.w = fold_relu(v.w, ps[k + 3], pt[k + 3]);
        }
      }
      As[ak][ar] = v.x;
      As[ak + 1][ar] = v.y;
      As[ak + 2][ar] = v.z;
      As[ak + 3][ar] = v.w;
    }
    {
      const int k = k0 + bk, n = n0 + bn;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K && n < N) v = ld4(Bm + static_cast<long long>(k) * N + n);
      st4(&Bs[bk][bn], v);
    }
    __syncthreads();
    mma_tile(As, Bs, tx, ty, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + tile_row(i, ty);
    if (r >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + jh * 64 + tx * 4;
      if (n >= N) continue;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][jh * 4 + j];
        if (bias) v += bias[n + j];
        if (my && !(fold_relu(my[r * N + n + j], ms[n + j], mt[n + j]) > 0.f)) v = 0.f;
        o[j] = v;
      }
      st4(Cm + r * N + n, make_float4(o[0], o[1], o[2], o[3]));
    }
  }
}

// Partial dW over one chunk of rows: part[p] (I x J) = sum_r op(X[r, :])^T D[r, :],
// op(x) = relu(x * ps + pt). I, J multiples of 4.
__global__ void __launch_bounds__(kThreads, 2)
    gemm_tn_kernel(const float* __restrict__ X, const float* __restrict__ D,
                   float* __restrict__ part, long long R, int I, int J, long long chunk,
                   const float* __restrict__ ps, const float* __restrict__ pt) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const long long r0 = static_cast<long long>(blockIdx.z) * chunk;
  const long long r1 = min(R, r0 + chunk);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int lk = tid / 32, lc = (tid % 32) * 4;  // both tiles: 8 rows x 128 columns
  for (long long rb = r0; rb < r1; rb += BK) {
    const long long r = rb + lk;
    {
      const int i = i0 + lc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < r1 && i < I) {
        v = ld4(X + r * I + i);
        v.x = fold_relu(v.x, ps[i], pt[i]);
        v.y = fold_relu(v.y, ps[i + 1], pt[i + 1]);
        v.z = fold_relu(v.z, ps[i + 2], pt[i + 2]);
        v.w = fold_relu(v.w, ps[i + 3], pt[i + 3]);
      }
      st4(&As[lk][lc], v);
    }
    {
      const int j = j0 + lc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < r1 && j < J) v = ld4(D + r * J + j);
      st4(&Bs[lk][lc], v);
    }
    __syncthreads();
    mma_tile(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.z) * I * J;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ii = i0 + tile_row(i, ty);
    if (ii >= I) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int j = j0 + jh * 64 + tx * 4;
      if (j >= J) continue;
      st4(out + static_cast<long long>(ii) * J + j,
          make_float4(acc[i][jh * 4], acc[i][jh * 4 + 1], acc[i][jh * 4 + 2], acc[i][jh * 4 + 3]));
    }
  }
}

// dW[e] = sum_p part[p][e], p in order.
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int P, long long E) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[p * E + e];
  out[e] = s;
}

// ---- F4: out[bs, c] = max_k relu(y3 * s3 + t3) ----------------------------
__global__ void maxpool_kernel(const float* __restrict__ y3, const float* __restrict__ fold,
                               float* __restrict__ out, long long BS, int K, int C) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= BS * C) return;
  const long long bs = e / C;
  const int c = static_cast<int>(e - bs * C);
  const float s = fold[c], t = fold[C + c];
  float m = 0.f;  // every value is a ReLU output, so >= 0
  for (int k = 0; k < K; ++k) m = fmaxf(m, fold_relu(y3[(bs * K + k) * C + c], s, t));
  out[e] = m;
}

// ---- B1: dz3 = g / (number of tied maxima) at the maxima, * relu' ---------
__global__ void maxgrad_kernel(const float* __restrict__ y3, const float* __restrict__ fold,
                               const float* __restrict__ g, float* __restrict__ dz3,
                               long long BS, int K, int C) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= BS * C) return;
  const long long bs = e / C;
  const int c = static_cast<int>(e - bs * C);
  const float s = fold[c], t = fold[C + c];
  const float* y = y3 + bs * K * C + c;
  float m = 0.f;
  for (int k = 0; k < K; ++k) m = fmaxf(m, fold_relu(y[k * C], s, t));
  int cnt = 0;
  for (int k = 0; k < K; ++k) cnt += fold_relu(y[k * C], s, t) == m;
  const float share = __fdiv_rn(g[e], static_cast<float>(cnt));
  float* dz = dz3 + bs * K * C + c;
  for (int k = 0; k < K; ++k) {
    const float h = fold_relu(y[k * C], s, t);
    dz[k * C] = (h == m && h > 0.f) ? share : 0.f;
  }
}

// ---- BN backward, in place: dz -> dy = s * ((dz - m1) - yhat * m2) -------
__global__ void bn_bwd_kernel(float* __restrict__ dz, const float* __restrict__ y,
                              const float* __restrict__ mean, const float* __restrict__ fold,
                              const float* __restrict__ coef, long long R, int C) {
  const int c4 = C / 4;
  const long long total = R * c4;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / c4;
    const int c = static_cast<int>(e - r * c4) * 4;
    float4 v = ld4(dz + r * C + c);
    const float4 yv = ld4(y + r * C + c);
    float* vp = &v.x;
    const float* yp = &yv.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c + j;
      const float yh = __fmul_rn(__fsub_rn(yp[j], mean[cc]), fold[2 * C + cc]);
      vp[j] = __fmul_rn(fold[cc], __fsub_rn(__fsub_rn(vp[j], coef[cc]), __fmul_rn(yh, coef[C + cc])));
    }
    st4(dz + r * C + c, v);
  }
}

// ---- B4: da[b, idx[r]] += dy1[r]; dct[bs] = sum_k dy1 ---------------------
__global__ void scatter_kernel(const float* __restrict__ dy1, const int* __restrict__ idx,
                               float* __restrict__ da, float* __restrict__ dct, Dims d) {
  const long long BS = static_cast<long long>(d.B) * d.S;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= BS * d.C1) return;
  const long long bs = e / d.C1;
  const int c = static_cast<int>(e - bs * d.C1);
  const long long b = bs / d.S;
  float acc = 0.f;
  for (int k = 0; k < d.K; ++k) {
    const long long r = bs * d.K + k;
    const float v = dy1[r * d.C1 + c];
    acc += v;
    const int j = idx[r];
    if (j >= 0 && j < d.N) atomicAdd(da + (b * d.N + j) * d.C1 + c, v);
  }
  dct[e] = acc;
}

// ---- host side ---------------------------------------------------------------
inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

int stat_chunks(const Dims& d) { return static_cast<int>(cdiv(d.R, kStatRows)); }
int cmax(const Dims& d) { return d.C1 > d.C2 ? (d.C1 > d.C3 ? d.C1 : d.C3) : (d.C2 > d.C3 ? d.C2 : d.C3); }

// dW row split: about kWantBlocks blocks over the tiles, chunks of whole k-steps
void dw_split(const Dims& d, int I, int J, int* P, long long* chunk) {
  const long long tiles = cdiv(I, BM) * cdiv(J, BN);
  long long p = cdiv(kWantBlocks, tiles);
  p = p < cdiv(d.R, 64) ? p : cdiv(d.R, 64);
  long long ch = cdiv(cdiv(d.R, p), BK) * BK;
  *P = static_cast<int>(cdiv(d.R, ch));
  *chunk = ch;
}

struct Workspace {  // byte offsets into one buffer
  size_t part, fold, coef, dwpart, g3, g2, g1, total;
};

Workspace layout(const Dims& d, bool backward) {
  Workspace w{};
  const size_t C = static_cast<size_t>(cmax(d));
  size_t off = 0;
  w.part = off;
  off += align256(static_cast<size_t>(stat_chunks(d)) * 2 * C * sizeof(double));
  w.fold = off;  // (s, t, inv) of each of the 3 layers
  off += align256(9 * C * sizeof(float));
  if (backward) {
    w.coef = off;
    off += align256(2 * C * sizeof(float));
    int P3, P2;
    long long ch;
    dw_split(d, d.C2, d.C3, &P3, &ch);
    dw_split(d, d.C1, d.C2, &P2, &ch);
    const size_t e3 = static_cast<size_t>(P3) * d.C2 * d.C3, e2 = static_cast<size_t>(P2) * d.C1 * d.C2;
    w.dwpart = off;
    off += align256((e3 > e2 ? e3 : e2) * sizeof(float));
    w.g3 = off;
    off += align256(static_cast<size_t>(d.R) * d.C3 * sizeof(float));
    w.g2 = off;
    off += align256(static_cast<size_t>(d.R) * d.C2 * sizeof(float));
    w.g1 = off;
    off += align256(static_cast<size_t>(d.R) * d.C1 * sizeof(float));
  }
  w.total = off;
  return w;
}

int check(int B, int N, int S, int K, int C1, int C2, int C3, Dims* d) {
  if (B < 1 || N < 1 || S < 1 || K < 1 || C1 < 1 || C2 < 1 || C3 < 1) return kErrArgs;
  if (C1 % 4 || C2 % 4 || C3 % 4) return kErrWidth;
  d->B = B;
  d->N = N;
  d->S = S;
  d->K = K;
  d->C1 = C1;
  d->C2 = C2;
  d->C3 = C3;
  d->R = static_cast<long long>(B) * S * K;
  if (cdiv(d->R, kStatRows) > 65535 || cdiv(d->R, BM) > 0x7fffffffLL) return kErrArgs;
  return 0;
}

int grid_1d(long long n) {
  const long long g = cdiv(n, kThreads);
  return static_cast<int>(g < 132LL * 64 ? g : 132LL * 64);
}

#define LAUNCH_CHECK()                               \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// stats of one grid (fwd: fold for the next pass; bwd: dgamma/dbeta and coef)
int stats_pass(const float* x, const float* y, const float* mu, const float* inv, double* part,
               const Dims& d, int C, cudaStream_t st) {
  stats_kernel<<<dim3(cdiv(C, 32), stat_chunks(d)), dim3(32, 8), 0, st>>>(x, y, mu, inv, part, d.R, C);
  LAUNCH_CHECK();
  return 0;
}

int gemm_nn(const float* A, const float* Bm, float* Cm, long long M, int N, int K, const float* ps,
            const float* pt, const float* bias, const float* my, const float* ms, const float* mt,
            cudaStream_t st) {
  gemm_nn_kernel<<<dim3(cdiv(M, BM), cdiv(N, BN)), kThreads, 0, st>>>(A, Bm, Cm, M, N, K, ps, pt, bias,
                                                                       my, ms, mt);
  LAUNCH_CHECK();
  return 0;
}

int gemm_tn(const float* X, const float* D, float* part, float* out, const Dims& d, int I, int J,
            const float* ps, const float* pt, cudaStream_t st) {
  int P;
  long long chunk;
  dw_split(d, I, J, &P, &chunk);
  gemm_tn_kernel<<<dim3(cdiv(I, BM), cdiv(J, BN), P), kThreads, 0, st>>>(X, D, part, d.R, I, J, chunk,
                                                                         ps, pt);
  LAUNCH_CHECK();
  const long long E = static_cast<long long>(I) * J;
  sum_partials_kernel<<<cdiv(E, kThreads), kThreads, 0, st>>>(part, out, P, E);
  LAUNCH_CHECK();
  return 0;
}

#define RUN(expr)            \
  do {                       \
    const int rc_ = (expr);  \
    if (rc_) return rc_;     \
  } while (0)

}  // namespace

// Bytes of workspace that sa_train_fwd (backward = 0) or sa_train_bwd (1) needs.
extern "C" long long sa_train_workspace(int B, int N, int S, int K, int C1, int C2, int C3,
                                        int backward) {
  Dims d;
  const int rc = check(B, N, S, K, C1, C2, C3, &d);
  if (rc) return rc;
  return static_cast<long long>(layout(d, backward != 0).total);
}

// Forward F1-F4. bn = [g1, bt1 (C1), g2, bt2 (C2), g3, bt3 (C3)];
// stats (out) = [mean1, var1, mean2, var2, mean3, var3]; y1/y2/y3 (out) the
// pre-BN grids (R x C1, C2, C3) that the backward reads; out (B, S, C3).
extern "C" int sa_train_fwd(const float* a, const float* ct, const int* idx, const float* w2,
                            const float* b2, const float* w3, const float* b3, const float* bn,
                            float* y1, float* y2, float* y3, float* out, float* stats, void* ws,
                            int B, int N, int S, int K, int C1, int C2, int C3, void* stream) {
  Dims d;
  RUN(check(B, N, S, K, C1, C2, C3, &d));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = layout(d, false);
  char* base = static_cast<char*>(ws);
  double* part = reinterpret_cast<double*>(base + w.part);
  float* fold = reinterpret_cast<float*>(base + w.fold);
  const int Cm = cmax(d);
  float* f1 = fold;
  float* f2 = fold + 3 * Cm;
  float* f3 = fold + 6 * Cm;
  const float *g1 = bn, *bt1 = bn + C1, *g2 = bn + 2 * C1, *bt2 = g2 + C2, *g3 = bt2 + C2,
              *bt3 = g3 + C3;
  float *mu1 = stats, *v1 = stats + C1, *mu2 = stats + 2 * C1, *v2 = mu2 + C2, *mu3 = v2 + C2,
        *v3 = mu3 + C3;
  const double M = static_cast<double>(d.R);
  const int P = stat_chunks(d);

  gather_kernel<<<grid_1d(d.R * (C1 / 4)), kThreads, 0, st>>>(a, ct, idx, y1, d);
  LAUNCH_CHECK();
  RUN(stats_pass(y1, nullptr, nullptr, nullptr, part, d, C1, st));
  finalize_fwd_kernel<<<cdiv(C1, 8), kThreads, 0, st>>>(part, P, C1, M, g1, bt1, mu1, v1, f1);
  LAUNCH_CHECK();
  RUN(gemm_nn(y1, w2, y2, d.R, C2, C1, f1, f1 + C1, b2, nullptr, nullptr, nullptr, st));
  RUN(stats_pass(y2, nullptr, nullptr, nullptr, part, d, C2, st));
  finalize_fwd_kernel<<<cdiv(C2, 8), kThreads, 0, st>>>(part, P, C2, M, g2, bt2, mu2, v2, f2);
  LAUNCH_CHECK();
  RUN(gemm_nn(y2, w3, y3, d.R, C3, C2, f2, f2 + C2, b3, nullptr, nullptr, nullptr, st));
  RUN(stats_pass(y3, nullptr, nullptr, nullptr, part, d, C3, st));
  finalize_fwd_kernel<<<cdiv(C3, 8), kThreads, 0, st>>>(part, P, C3, M, g3, bt3, mu3, v3, f3);
  LAUNCH_CHECK();
  const long long BS = static_cast<long long>(B) * S;
  maxpool_kernel<<<cdiv(BS * C3, kThreads), kThreads, 0, st>>>(y3, f3, out, BS, K, C3);
  LAUNCH_CHECK();
  return 0;
}

// Backward B1-B4 from the forward's grids and statistics and the output's
// cotangent g (B, S, C3). w2t (C2 x C1) and w3t (C3 x C2) are W2^T and W3^T.
// Writes da (B, N, C1), dct (B, S, C1), dw2 (C1 x C2), dw3 (C2 x C3) and
// dbn = [dg1, dbt1, dg2, dbt2, dg3, dbt3].
extern "C" int sa_train_bwd(const float* g, const int* idx, const float* y1, const float* y2,
                            const float* y3, const float* stats, const float* w2t,
                            const float* w3t, const float* bn, float* da, float* dct, float* dw2,
                            float* dw3, float* dbn, void* ws, int B, int N, int S, int K, int C1,
                            int C2, int C3, void* stream) {
  Dims d;
  RUN(check(B, N, S, K, C1, C2, C3, &d));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = layout(d, true);
  char* base = static_cast<char*>(ws);
  double* part = reinterpret_cast<double*>(base + w.part);
  float* fold = reinterpret_cast<float*>(base + w.fold);
  float* coef = reinterpret_cast<float*>(base + w.coef);
  float* dwpart = reinterpret_cast<float*>(base + w.dwpart);
  float* g3 = reinterpret_cast<float*>(base + w.g3);
  float* g2 = reinterpret_cast<float*>(base + w.g2);
  float* g1 = reinterpret_cast<float*>(base + w.g1);
  const int Cm = cmax(d);
  float* f1 = fold;
  float* f2 = fold + 3 * Cm;
  float* f3 = fold + 6 * Cm;
  const float *ga1 = bn, *bt1 = bn + C1, *ga2 = bn + 2 * C1, *bt2 = ga2 + C2, *ga3 = bt2 + C2,
              *bt3 = ga3 + C3;
  const float *mu1 = stats, *v1 = stats + C1, *mu2 = stats + 2 * C1, *v2 = mu2 + C2,
              *mu3 = v2 + C2, *v3 = mu3 + C3;
  float *dg1 = dbn, *dbt1 = dbn + C1, *dg2 = dbn + 2 * C1, *dbt2 = dg2 + C2, *dg3 = dbt2 + C2,
        *dbt3 = dg3 + C3;
  const double M = static_cast<double>(d.R);
  const int P = stat_chunks(d);
  const long long BS = static_cast<long long>(B) * S;

  fold_kernel<<<cdiv(C1, kThreads), kThreads, 0, st>>>(mu1, v1, ga1, bt1, f1, C1);
  LAUNCH_CHECK();
  fold_kernel<<<cdiv(C2, kThreads), kThreads, 0, st>>>(mu2, v2, ga2, bt2, f2, C2);
  LAUNCH_CHECK();
  fold_kernel<<<cdiv(C3, kThreads), kThreads, 0, st>>>(mu3, v3, ga3, bt3, f3, C3);
  LAUNCH_CHECK();

  // B1: dz3, its sums; dy3 in place
  maxgrad_kernel<<<cdiv(BS * C3, kThreads), kThreads, 0, st>>>(y3, f3, g, g3, BS, K, C3);
  LAUNCH_CHECK();
  RUN(stats_pass(g3, y3, mu3, f3 + 2 * C3, part, d, C3, st));
  finalize_bwd_kernel<<<cdiv(C3, 8), kThreads, 0, st>>>(part, P, C3, M, dg3, dbt3, coef);
  LAUNCH_CHECK();
  bn_bwd_kernel<<<grid_1d(d.R * (C3 / 4)), kThreads, 0, st>>>(g3, y3, mu3, f3, coef, d.R, C3);
  LAUNCH_CHECK();
  // B2: dW3 = h2^T dy3; dz2 = (dy3 W3^T) * relu'(h2); its sums; dy2 in place
  RUN(gemm_tn(y2, g3, dwpart, dw3, d, C2, C3, f2, f2 + C2, st));
  RUN(gemm_nn(g3, w3t, g2, d.R, C2, C3, nullptr, nullptr, nullptr, y2, f2, f2 + C2, st));
  RUN(stats_pass(g2, y2, mu2, f2 + 2 * C2, part, d, C2, st));
  finalize_bwd_kernel<<<cdiv(C2, 8), kThreads, 0, st>>>(part, P, C2, M, dg2, dbt2, coef);
  LAUNCH_CHECK();
  bn_bwd_kernel<<<grid_1d(d.R * (C2 / 4)), kThreads, 0, st>>>(g2, y2, mu2, f2, coef, d.R, C2);
  LAUNCH_CHECK();
  // B3: dW2 = h1^T dy2; dz1 = (dy2 W2^T) * relu'(h1); its sums; dy1 in place
  RUN(gemm_tn(y1, g2, dwpart, dw2, d, C1, C2, f1, f1 + C1, st));
  RUN(gemm_nn(g2, w2t, g1, d.R, C1, C2, nullptr, nullptr, nullptr, y1, f1, f1 + C1, st));
  RUN(stats_pass(g1, y1, mu1, f1 + 2 * C1, part, d, C1, st));
  finalize_bwd_kernel<<<cdiv(C1, 8), kThreads, 0, st>>>(part, P, C1, M, dg1, dbt1, coef);
  LAUNCH_CHECK();
  bn_bwd_kernel<<<grid_1d(d.R * (C1 / 4)), kThreads, 0, st>>>(g1, y1, mu1, f1, coef, d.R, C1);
  LAUNCH_CHECK();
  // B4: da (zeroed here) += dy1 at idx; dct = sum_k dy1
  cudaError_t e = cudaMemsetAsync(da, 0, static_cast<size_t>(B) * N * C1 * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<<<cdiv(BS * C1, kThreads), kThreads, 0, st>>>(g1, idx, da, dct, d);
  LAUNCH_CHECK();
  return 0;
}
