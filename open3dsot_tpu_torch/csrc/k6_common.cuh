// What both modes of K6 (sa_fused_train.cu, 3xTF32; sa_fused_train_bf16.cu,
// bf16) share: the grid's dimensions, the BatchNorm arithmetic with its
// rounding pinned, y1's statistics, the fixed-order reductions of the
// per-block partial sums, and B4's ordered path for da.
//
// Rounding pinned where a decision depends on it: relu(y * s + t) with
// __fmul_rn/__fadd_rn, s and t from 1 / sqrt(var + eps) rounded as IEEE
// division and square root. The plain version (ops/sa_fused_train.py)
// computes them in the same order, so on the same grids the max masks, ties
// and ReLU masks agree bit for bit. Every partial sum is a double, and the
// finalize kernels reduce the partials in a fixed order: the statistics are
// the same from run to run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tc.cuh"  // round_bf16

namespace {

constexpr float kEps = 1e-5f;
constexpr int kStatRows = 512;  // rows of one partial of y1's sums
constexpr int kFinWarps = 32;   // finalize: warps over the partials of a block
constexpr int kFinSlices = 16;  // finalize: blocks over the partials of 32 channels
constexpr long long kMaxGridY = 65535;  // blocks a grid may have along y

struct Dims {
  long long R;  // B * S * K
  int B, N, S, K, C1, C2, C3;
};

__device__ __forceinline__ float fold_relu(float y, float s, float t) {
  return fmaxf(__fadd_rn(__fmul_rn(y, s), t), 0.f);
}
__device__ __forceinline__ float yhat_of(float y, float mu, float inv) {
  return __fmul_rn(__fsub_rn(y, mu), inv);
}
// the BN-training backward of one value: s * ((dz - c1) - yhat * c2)
__device__ __forceinline__ float bn_bwd(float dz, float yh, float s, float c1, float c2) {
  return __fmul_rn(s, __fsub_rn(__fsub_rn(dz, c1), __fmul_rn(yh, c2)));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// s = gamma / sqrt(var + eps), t = beta - mean * s, inv = 1 / sqrt(var + eps)
__device__ __forceinline__ void fold_of(float mean, float var, float gamma, float beta, float* s,
                                        float* t, float* inv) {
  const float iv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kEps)));
  const float sc = __fmul_rn(gamma, iv);
  *s = sc;
  *t = __fsub_rn(beta, __fmul_rn(mean, sc));
  *inv = iv;
}

// Rows are below 2^31 (each entry's check), so their centroid comes from a
// 32-bit division.
__device__ __forceinline__ unsigned centroid_of(const Dims& d, int r) {
  return static_cast<unsigned>(r) / static_cast<unsigned>(d.K);
}

// ---- y1's (sum, sum of squares), one partial per kStatRows rows --------------
// y1 = a[b, idx[r]] + ct[b, s], RA: a rounded to bf16 as it is read (the bf16
// mode). Block (32, 8): 32 channels, 8 row lanes; grid (C1 / 32, up to
// kMaxGridY), block y taking partials y, y + gridDim.y, ... The rows' gather
// offsets are computed once per partial; an index outside [0, N) gives a NaN row.
template <bool RA>
__device__ __forceinline__ void y1_stats_chunk(const float* __restrict__ a,
                                               const float* __restrict__ ct,
                                               const int* __restrict__ idx, const Dims& d,
                                               double* __restrict__ part, long long chunk) {
  __shared__ double sh[2][8][33];
  __shared__ long long off_a[kStatRows], off_c[kStatRows];  // off_a -1: index outside [0, N)
  const int tx = threadIdx.x, ty = threadIdx.y, C = d.C1;
  const int r0 = static_cast<int>(chunk) * kStatRows, n = min(static_cast<int>(d.R) - r0, kStatRows);
  for (int i = ty * 32 + tx; i < n; i += 256) {
    const unsigned bs = centroid_of(d, r0 + i), b = bs / static_cast<unsigned>(d.S);
    const int j = __ldg(idx + r0 + i);
    off_a[i] = (j >= 0 && j < d.N) ? (static_cast<long long>(b) * d.N + j) * C : -1;
    off_c[i] = static_cast<long long>(bs) * C;
  }
  __syncthreads();
  const int c = blockIdx.x * 32 + tx;
  double s1 = 0.0, s2 = 0.0;
  if (c < C) {
    for (int i = ty; i < n; i += 8) {
      float av = off_a[i] < 0 ? __int_as_float(0x7fc00000) : __ldg(a + off_a[i] + c);
      if (RA) av = round_bf16(av);
      const float v = __fadd_rn(av, __ldg(ct + off_c[i] + c));
      s1 += v;
      s2 += static_cast<double>(v) * static_cast<double>(v);
    }
  }
  sh[0][ty][tx] = s1;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty == 0 && c < C) {
    double s = 0.0, q = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += sh[0][i][tx];
      q += sh[1][i][tx];
    }
    part[(chunk * 2) * C + c] = s;
    part[(chunk * 2 + 1) * C + c] = q;
  }
  __syncthreads();  // sh and the offsets are read before the next partial writes them
}

template <bool RA>
__global__ void y1_stats_kernel(const float* __restrict__ a, const float* __restrict__ ct,
                                const int* __restrict__ idx, const Dims d,
                                double* __restrict__ part) {
  const long long chunks = (d.R + kStatRows - 1) / kStatRows;
  for (long long chunk = blockIdx.y; chunk < chunks; chunk += gridDim.y)
    y1_stats_chunk<RA>(a, ct, idx, d, part, chunk);
}

// Sum the P partials (P x 2 x C doubles) of channels blockIdx.x * 32 + lane in
// a fixed order, in two levels: block (x, y) sums slice y of the partials (warp
// w takes w, w + kFinWarps, ...; warp 0 adds the warps' sums) into part2; the
// last block of x to finish (count) adds the slices in order and returns
// true, with the result in its warp 0. Block of 32 x kFinWarps threads, grid
// (C / 32, slices).
__device__ __forceinline__ bool reduce_partials(const double* part, int P, int C, double* part2,
                                                unsigned* count, double* s1, double* s2) {
  __shared__ double sh[2][kFinWarps][33];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane, G = gridDim.y;
  const int p0 = static_cast<int>(static_cast<long long>(P) * blockIdx.y / G);
  const int p1 = static_cast<int>(static_cast<long long>(P) * (blockIdx.y + 1) / G);
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int p = p0 + w; p < p1; p += kFinWarps) {
      a += part[(static_cast<long long>(p) * 2) * C + c];
      b += part[(static_cast<long long>(p) * 2 + 1) * C + c];
    }
  }
  sh[0][w][lane] = a;
  sh[1][w][lane] = b;
  __syncthreads();
  if (w == 0 && c < C) {
    a = b = 0.0;
    for (int i = 0; i < kFinWarps; ++i) {
      a += sh[0][i][lane];
      b += sh[1][i][lane];
    }
    part2[(blockIdx.y * 2) * C + c] = a;
    part2[(blockIdx.y * 2 + 1) * C + c] = b;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count + blockIdx.x, 1u) == static_cast<unsigned>(G - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  a = b = 0.0;
  if (w == 0 && c < C) {
    for (int y = 0; y < G; ++y) {
      a += __ldcg(part2 + (y * 2) * C + c);
      b += __ldcg(part2 + (y * 2 + 1) * C + c);
    }
  }
  if (threadIdx.x == 0) count[blockIdx.x] = 0;  // ready for the next finalize
  *s1 = a;
  *s2 = b;
  return true;
}

// Forward: mean, biased var -> stats; fold (s, t, inv) for the next pass.
__global__ void finalize_fwd_kernel(const double* __restrict__ part, int P, int C, double M,
                                    double* part2, unsigned* count,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta, float* __restrict__ mean,
                                    float* __restrict__ var, float* __restrict__ fold) {
  double s1, s2;
  if (!reduce_partials(part, P, C, part2, count, &s1, &s2)) return;
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  if (threadIdx.x < 32 && c < C) {
    const double md = s1 / M;
    const float mu = static_cast<float>(md), v = static_cast<float>(s2 / M - md * md);
    mean[c] = mu;
    var[c] = v;
    fold_of(mu, v, gamma[c], beta[c], fold + c, fold + C + c, fold + 2 * C + c);
  }
}

// Backward: dbeta = sum dz, dgamma = sum dz * yhat; coef = (sum dz / M, sum dz yhat / M).
__global__ void finalize_bwd_kernel(const double* __restrict__ part, int P, int C, double M,
                                    double* part2, unsigned* count, float* __restrict__ dgamma,
                                    float* __restrict__ dbeta, float* __restrict__ coef) {
  double s1, s2;
  if (!reduce_partials(part, P, C, part2, count, &s1, &s2)) return;
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  if (threadIdx.x < 32 && c < C) {
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

// dW[e] = sum_p part[p][e], p in order.
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int P, long long E) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[p * E + e];
  out[e] = s;
}

// ---- host side ---------------------------------------------------------------
inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
// grid.y of a kernel over n partials (it strides over them by gridDim.y)
inline unsigned grid_y(long long n) { return static_cast<unsigned>(n < kMaxGridY ? n : kMaxGridY); }
inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The finalize kernels' scratch: the slices' sums and the per-block counters
// (zeroed once per entry; each finalize leaves them zero).
struct Fin {
  double* part2;
  unsigned* count;
};

inline dim3 fin_grid(long long P, int C) {
  const long long slices = P < kFinSlices ? P : kFinSlices;
  return dim3(static_cast<unsigned>(cdiv(C, 32)), static_cast<unsigned>(slices));
}

inline int finalize_fwd(const double* part, long long P, int C, const Dims& d, const Fin& f,
                        const float* gamma, const float* beta, float* mean, float* var,
                        float* fold, cudaStream_t st) {
  finalize_fwd_kernel<<<fin_grid(P, C), 32 * kFinWarps, 0, st>>>(
      part, static_cast<int>(P), C, static_cast<double>(d.R), f.part2, f.count, gamma, beta,
      mean, var, fold);
  return static_cast<int>(cudaGetLastError());
}

inline int finalize_bwd(const double* part, long long P, int C, const Dims& d, const Fin& f,
                        float* dgamma, float* dbeta, float* coef, cudaStream_t st) {
  finalize_bwd_kernel<<<fin_grid(P, C), 32 * kFinWarps, 0, st>>>(
      part, static_cast<int>(P), C, static_cast<double>(d.R), f.part2, f.count, dgamma, dbeta,
      coef);
  return static_cast<int>(cudaGetLastError());
}

// ---- staged entries: statistics summed over a process group -----------------
// Under a process group whose BatchNorm statistics are those of the global
// batch, each pass's sums have to be added up over the processes before the
// finalize that needs them. A staged entry runs one stage: stage k ends
// where pass k's sums are complete, with the 2 x C doubles (sum, sum of
// squares; for the backward, sum dz and sum dz * yhat) in `sums`; the caller
// adds them and the row count up over the processes into sums[0 .. 2C] (the
// count at sums[2C]) and calls stage k + 1, which starts with the finalize
// from them. With sums[2C] = R and one process that is the finalize of the
// single call, bit for bit. dgamma and dbeta are this process's own sums:
// the gradient is averaged over the processes after the backward.
struct Staging {
  int stage;  // < 0: the single call, all stages
  double* sums;
};

__global__ void stage_sums_kernel(const double* __restrict__ part, int P, int C, double* part2,
                                  unsigned* count, double* __restrict__ sums,
                                  float* __restrict__ dgamma, float* __restrict__ dbeta) {
  double s1, s2;
  if (!reduce_partials(part, P, C, part2, count, &s1, &s2)) return;
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  if (threadIdx.x < 32 && c < C) {
    sums[c] = s1;
    sums[C + c] = s2;
    if (dgamma) {
      dbeta[c] = static_cast<float>(s1);
      dgamma[c] = static_cast<float>(s2);
    }
  }
}

// finalize_fwd_kernel's arithmetic from the summed sums, M = sums[2C].
__global__ void finalize_fwd_sums_kernel(const double* __restrict__ sums, int C,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta, float* __restrict__ mean,
                                         float* __restrict__ var, float* __restrict__ fold) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const double M = sums[2 * C];
  const double md = sums[c] / M;
  const float mu = static_cast<float>(md), v = static_cast<float>(sums[C + c] / M - md * md);
  mean[c] = mu;
  var[c] = v;
  fold_of(mu, v, gamma[c], beta[c], fold + c, fold + C + c, fold + 2 * C + c);
}

// finalize_bwd_kernel's coefficients from the summed sums, M = sums[2C].
__global__ void coef_sums_kernel(const double* __restrict__ sums, int C, float* __restrict__ coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float M = static_cast<float>(sums[2 * C]);
  coef[c] = __fdiv_rn(static_cast<float>(sums[c]), M);
  coef[C + c] = __fdiv_rn(static_cast<float>(sums[C + c]), M);
}

// Where pass k's statistics are complete (forward): the single call
// finalizes; staged, stage k ends here (*stop) with the sums, and stage k + 1
// starts here with the finalize from the summed ones.
inline int sync_fwd(const Staging& sg, int k, const double* part, long long P, int C,
                    const Dims& d, const Fin& f, const float* gamma, const float* beta,
                    float* mean, float* var, float* fold, cudaStream_t st, bool* stop) {
  *stop = false;
  if (sg.stage < 0) return finalize_fwd(part, P, C, d, f, gamma, beta, mean, var, fold, st);
  if (sg.stage == k) {
    stage_sums_kernel<<<fin_grid(P, C), 32 * kFinWarps, 0, st>>>(
        part, static_cast<int>(P), C, f.part2, f.count, sg.sums, nullptr, nullptr);
    *stop = true;
  } else if (sg.stage == k + 1) {
    finalize_fwd_sums_kernel<<<cdiv(C, 128), 128, 0, st>>>(sg.sums, C, gamma, beta, mean, var,
                                                           fold);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's: stage k ends with dgamma, dbeta (this process's) and the
// sums; stage k + 1 starts with the coefficients from the summed ones.
inline int sync_bwd(const Staging& sg, int k, const double* part, long long P, int C,
                    const Dims& d, const Fin& f, float* dgamma, float* dbeta, float* coef,
                    cudaStream_t st, bool* stop) {
  *stop = false;
  if (sg.stage < 0) return finalize_bwd(part, P, C, d, f, dgamma, dbeta, coef, st);
  if (sg.stage == k) {
    stage_sums_kernel<<<fin_grid(P, C), 32 * kFinWarps, 0, st>>>(
        part, static_cast<int>(P), C, f.part2, f.count, sg.sums, dgamma, dbeta);
    *stop = true;
  } else if (sg.stage == k + 1) {
    coef_sums_kernel<<<cdiv(C, 128), 128, 0, st>>>(sg.sums, C, coef);
  }
  return static_cast<int>(cudaGetLastError());
}

#define LAUNCH_CHECK()                                  \
  do {                                                  \
    const cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

#define RUN(expr)           \
  do {                      \
    const int rc_ = (expr); \
    if (rc_) return rc_;    \
  } while (0)

// ---- B4's ordered path: da summed in a fixed order ---------------------------
// Taken under torch.use_deterministic_algorithms (the wrapper reads the flag at
// each call). da[b, n] = the sum of dy1[r] over the rows r of sample b with
// idx[r] = n, in the order of r, as the JAX kernel's onehot^T @ dy1 sums it in
// a fixed order. An inverse index, built by a stable counting sort of idx per
// sample: the counts by integer atomics (exact in any order), an exclusive scan
// of them, then a fill that keeps the rows of one target in the order of r.
// One thread per (b, n, c) then sums its target's rows down that list. The
// scatter pass leaves dy1 in its dz1 grid for it (in place: each element is
// read and written by one thread). Every step is the same from run to run.

constexpr int kScanThreads = 1024;
constexpr int kFillSmem = 48 * 1024;  // cursors in shared memory up to this many bytes

// cnt[b * N + j] = the number of rows of sample b with idx = j in [0, N)
__global__ void da_count_kernel(const int* __restrict__ idx, const Dims d, int* __restrict__ cnt) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= d.R) return;
  const int j = __ldg(idx + r);
  if (j >= 0 && j < d.N)
    atomicAdd(cnt + (r / (static_cast<long long>(d.S) * d.K)) * d.N + j, 1);
}

// off[i] = cnt[0] + ... + cnt[i - 1] for i <= n: one block, each thread over a
// contiguous run, its runs' sums scanned in shared memory.
__global__ void __launch_bounds__(kScanThreads) da_scan_kernel(const int* __restrict__ cnt,
                                                               long long n, int* __restrict__ off) {
  __shared__ int sums[kScanThreads];
  const int t = threadIdx.x;
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long lo = t * per < n ? t * per : n, hi = lo + per < n ? lo + per : n;
  int s = 0;
  for (long long i = lo; i < hi; ++i) s += cnt[i];
  sums[t] = s;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {  // inclusive scan of the runs' sums
    const int v = t >= o ? sums[t - o] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - s;
  for (long long i = lo; i < hi; ++i) {
    off[i] = run;
    run += cnt[i];
  }
  if (t == kScanThreads - 1) off[n] = sums[t];
}

// rows[off[b * N + j] + m] = the m-th row of sample b (in the order of r) with
// idx = j. One warp a sample walks its rows 32 at a time: lanes with the same
// target rank themselves by lane (match.any), the group's last lane moves the
// target's cursor on. Cursors in shared memory (SH) or in cur (zeroed).
template <bool SH>
__global__ void da_fill_kernel(const int* __restrict__ idx, const Dims d,
                               const int* __restrict__ off, int* __restrict__ cur_g,
                               int* __restrict__ rows) {
  extern __shared__ int cur_s[];
  const int b = blockIdx.x, lane = threadIdx.x;
  int* cur = SH ? cur_s : cur_g + static_cast<long long>(b) * d.N;
  if (SH)
    for (int n = lane; n < d.N; n += 32) cur[n] = 0;
  __syncwarp();
  const long long r0 = static_cast<long long>(b) * d.S * d.K, r1 = r0 + static_cast<long long>(d.S) * d.K;
  const int* o = off + static_cast<long long>(b) * d.N;
  int j_next = r0 + lane < r1 ? __ldg(idx + r0 + lane) : -1;
  for (long long base = r0; base < r1; base += 32) {
    const long long r = base + lane;
    const int j = j_next;
    j_next = r + 32 < r1 ? __ldg(idx + r + 32) : -1;
    const bool in = r < r1 && j >= 0 && j < d.N;
    const unsigned peers = __match_any_sync(0xffffffffu, in ? j : -1);
    const int at = in ? cur[j] : 0;
    __syncwarp();
    if (in) {
      rows[o[j] + at + __popc(peers & ((1u << lane) - 1u))] = static_cast<int>(r);
      if ((peers >> lane) == 1u) cur[j] = at + __popc(peers);  // the group's last lane
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float dy1_value(float v) { return v; }
__device__ __forceinline__ float dy1_value(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// da[b, n, c] = the sum of dy1[r, c] over rows[off[b * N + n] ...], in order.
// dy1 is f32 (the f32 mode) or bf16 bits (the bf16 mode), ld elements a row.
template <typename T>
__global__ void da_sum_kernel(const T* __restrict__ dy1, int ld, const int* __restrict__ off,
                              const int* __restrict__ rows, const Dims d, float* __restrict__ da) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= static_cast<long long>(d.B) * d.N * d.C1) return;
  const long long bn = e / d.C1;
  const int c = static_cast<int>(e - bn * d.C1);
  const int end = __ldg(off + bn + 1);
  float s = 0.f;
  for (int i = __ldg(off + bn); i < end; ++i)
    s += dy1_value(dy1[static_cast<long long>(__ldg(rows + i)) * ld + c]);
  da[e] = s;
}

// The ordered path's scratch: cnt (B * N ints, also the cursors where they do
// not fit in shared memory), off (B * N + 1) and rows (R).
struct Ordered {
  int* cnt;
  int* off;
  int* rows;
};

inline size_t ordered_ints(const Dims& d) {
  return 2 * static_cast<size_t>(d.B) * d.N + 1 + static_cast<size_t>(d.R);
}

inline Ordered ordered_at(const Dims& d, void* p) {
  int* q = static_cast<int*>(p);
  const size_t BN = static_cast<size_t>(d.B) * d.N;
  return Ordered{q, q + BN, q + 2 * BN + 1};
}

// da (B, N, C1) from dy1 (R rows of ld elements) in the order of r.
template <typename T>
inline int ordered_da(const Dims& d, const int* idx, const T* dy1, int ld, const Ordered& o,
                      float* da, cudaStream_t st) {
  const long long BN = static_cast<long long>(d.B) * d.N;
  cudaError_t e = cudaMemsetAsync(o.cnt, 0, BN * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  da_count_kernel<<<cdiv(d.R, 256), 256, 0, st>>>(idx, d, o.cnt);
  LAUNCH_CHECK();
  da_scan_kernel<<<1, kScanThreads, 0, st>>>(o.cnt, BN, o.off);
  LAUNCH_CHECK();
  const size_t smem = static_cast<size_t>(d.N) * sizeof(int);
  if (smem <= kFillSmem) {
    da_fill_kernel<true><<<d.B, 32, smem, st>>>(idx, d, o.off, o.cnt, o.rows);
  } else {
    e = cudaMemsetAsync(o.cnt, 0, BN * sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    da_fill_kernel<false><<<d.B, 32, 0, st>>>(idx, d, o.off, o.cnt, o.rows);
  }
  LAUNCH_CHECK();
  da_sum_kernel<T><<<cdiv(BN * d.C1, 256), 256, 0, st>>>(dy1, ld, o.off, o.rows, d, da);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace
