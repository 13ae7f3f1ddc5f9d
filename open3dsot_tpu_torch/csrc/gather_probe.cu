// Row-gather probes for Hopper (sm_90a): the forms a fused set abstraction
// (K4, sa_fused.cu) could gather its A-form rows with, timed side by side.
//
// P1  gather_rows / gather_elems / onehot_rowsums replace scripts/probe_gather.py::
//     try_one (the pallas_call at :24) and its kernels k_take_full (axis-0 take,
//     one index per row), k_taa_full (take_along_axis, one index per element),
//     k_onehot (one-hot (M, N) times A on the MXU) and k_onehot_dbg (the
//     one-hot's row sums). On the TPU the probe asked which forms Mosaic lowers;
//     here every form compiles, and the question is which is fastest at K4's
//     shapes. out[b, m] = a[b, idx[b, m]] for a (B, N, C) f32, idx (B, M):
//       form 0 ldg       each thread one 16-byte __ldg of a row, stored to out;
//       form 1 cp_async  a block stages its rows into shared memory with 16-byte
//                        cp.async (no registers on the way), then writes them out;
//       form 2 bulk      one cp.async.bulk (the TMA's plain copy) per row into
//                        shared memory, completing on an mbarrier, then written
//                        out. Hopper's TMA has no gather mode (tile::gather4 is
//                        sm_100), so a bulk copy per row is its gather;
//       form 3 onehot    the TPU's form: a one-hot (M, N) times a on the tensor
//                        cores, mma.sync m16n8k8 TF32, a split into hi + lo (two
//                        products; the one-hot is exact in TF32). hi + lo keeps
//                        about 21 of a's 24 bits: close, not bit-exact.
//     gather_elems: out[b, m, c] = a[b, idx[b, m, c], c], one 4-byte load per
//     element. onehot_rowsums: the one-hot times a table of ones on the tensor
//     cores, so every row of the result is its one-hot's row sum (1 in range).
// P2  gather_bf16_rows replaces scripts/probe_pallas_int8.py::kernel (the
//     pallas_call at :51): an exact gather of bf16 rows widened to f32. On the
//     TPU an int8 one-hot product of the rows' two byte planes, reassembled in
//     the kernel; here one 16-byte load of 8 bf16 values per thread, widened by
//     a shift (exact), and two 16-byte stores.
//
// What bounds them on this card: bytes. A gather must read each table row it
// names once (at most N x C floats; repeats come from L2, which holds every
// K4 table: at most 4 MB at B = 16), read its M indices and write M rows of C
// floats: 4 (rows x C + M + M x C) bytes against 3.35 TB/s of device memory,
// most of it the output at K4's shapes (M / N = 16 at K = 32). The one-hot
// form adds 2 x 2 x M x N x C TF32 operations (495 TFLOP/s dense): at K4's
// shapes more time than its bytes.
//
// An index outside [0, N) gives a NaN row in the copy forms and a zero row in
// the one-hot form (no column of its one-hot is set, as on the TPU).
//
// Interface: plain C, loaded with ctypes; device pointers; PyTorch's stream.
// Returns 0, a CUDA error code, or a negative code for arguments not taken.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tc.cuh"  // split_tf32, mma_tf32, mbarriers

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 32 * 1024;  // rows a copy block stages in shared memory
constexpr int kOhRows = 128;            // one-hot: rows of a block (8 warps x 16)
constexpr int kOhCols = 64;             // one-hot: columns of a block (8 n8 tiles a warp)
constexpr int kOhK = 32;                // one-hot: table rows staged per step

constexpr int kErrArgs = -1;   // B, N, M, C or form not accepted
constexpr int kErrWidth = -2;  // C not a multiple of 4 (8 for bf16)

enum Form { kLdg = 0, kCpAsync = 1, kBulk = 2, kOnehot = 3 };

__device__ __forceinline__ float4 nan4() {
  const float n = __int_as_float(0x7fc00000);
  return make_float4(n, n, n, n);
}

__device__ __forceinline__ bool in_range(int j, int N) { return j >= 0 && j < N; }

// ---- form 0: one 16-byte load per thread ---------------------------------------
__global__ void __launch_bounds__(kThreads) ldg_kernel(const float* __restrict__ a,
                                                       const int* __restrict__ idx,
                                                       float* __restrict__ out, int N, int M,
                                                       int C) {
  const int b = blockIdx.y, c4 = C / 4;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(M) * c4) return;
  const int m = static_cast<int>(e / c4), c = static_cast<int>(e - static_cast<long long>(m) * c4) * 4;
  const int j = __ldg(idx + static_cast<long long>(b) * M + m);
  const float4 v = in_range(j, N)
                       ? __ldg(reinterpret_cast<const float4*>(a + (static_cast<long long>(b) * N + j) * C + c))
                       : nan4();
  *reinterpret_cast<float4*>(out + (static_cast<long long>(b) * M + m) * C + c) = v;
}

// ---- forms 1 and 2: a block's rows staged in shared memory ----------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// rows [m0, m0 + T) of batch element b from the staged tile into out; bad rows NaN
__device__ __forceinline__ void write_rows(const float* tile, const int* rows, float* out, int b,
                                           int M, int m0, int T, int C, int N) {
  const int c4 = C / 4, nr = min(T, M - m0);
  for (int e = threadIdx.x; e < nr * c4; e += kThreads) {
    const int r = e / c4, c = (e - r * c4) * 4;
    const float4 v = in_range(rows[r], N) ? *reinterpret_cast<const float4*>(tile + r * C + c)
                                          : nan4();
    *reinterpret_cast<float4*>(out + (static_cast<long long>(b) * M + m0 + r) * C + c) = v;
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads) staged_kernel(const float* __restrict__ a,
                                                          const int* __restrict__ idx,
                                                          float* __restrict__ out, int N, int M,
                                                          int C, int T) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  int* rows = reinterpret_cast<int*>(tile + T * C);
  __shared__ uint64_t bar;
  const int b = blockIdx.y, m0 = blockIdx.x * T, nr = min(T, M - m0);
  const float* ab = a + static_cast<long long>(b) * N * C;
  for (int r = threadIdx.x; r < T; r += kThreads)
    rows[r] = r < nr ? __ldg(idx + static_cast<long long>(b) * M + m0 + r) : 0;
  if (F == kBulk && threadIdx.x == 0) {
    mbar_init(&bar, T);  // every row's thread arrives once
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (F == kCpAsync) {
    const int c4 = C / 4;
    for (int e = threadIdx.x; e < nr * c4; e += kThreads) {
      const int r = e / c4, c = (e - r * c4) * 4;
      if (in_range(rows[r], N)) cp_async16(tile + r * C + c, ab + static_cast<long long>(rows[r]) * C + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    const uint32_t bytes = C * 4;
    for (int r = threadIdx.x; r < T; r += kThreads) {
      if (r < nr && in_range(rows[r], N)) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(smem_addr(&bar)), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            ::"r"(smem_addr(tile + r * C)), "l"(ab + static_cast<long long>(rows[r]) * C),
            "r"(bytes), "r"(smem_addr(&bar)) : "memory");
      } else {
        mbar_arrive(&bar);
      }
    }
    mbar_wait(&bar, 0);
  }
  __syncthreads();
  write_rows(tile, rows, out, b, M, m0, T, C, N);
}

// ---- form 3 and the row sums: one-hot (M, N) x table (N, C) on the tensor cores --
// Block: 128 rows (warp w: rows 16 w ..) x 64 columns; the table is staged 32
// rows at a time, split hi/lo as it is stored (kOnes: a table of ones). Each
// warp builds its one-hot A fragments from its rows' indices and runs
// mma.sync m16n8k8 over 8 n8 tiles: onehot * lo + onehot * hi.
template <bool kOnes>
__global__ void __launch_bounds__(kThreads) onehot_kernel(const float* __restrict__ a,
                                                          const int* __restrict__ idx,
                                                          float* __restrict__ out, int N, int M,
                                                          int C) {
  constexpr int kStride = kOhCols + 8;  // B fragment loads (row q, column g) hit 32 banks
  __shared__ float th[kOhK * kStride], tl[kOhK * kStride];
  const int b = blockIdx.y, m0 = blockIdx.x * kOhRows, n0 = blockIdx.z * kOhCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
  const int* ib = idx + static_cast<long long>(b) * M;
  const int j0 = r0 < M ? __ldg(ib + r0) : -1, j1 = r1 < M ? __ldg(ib + r1) : -1;
  const float* ab = a + static_cast<long long>(b) * N * C;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  const uint32_t one = __float_as_uint(1.f);
  for (int k0 = 0; k0 < N; k0 += kOhK) {
    __syncthreads();  // the previous step's fragments are read
    for (int e = tid; e < kOhK * kOhCols; e += kThreads) {
      const int k = e / kOhCols, c = e - k * kOhCols;
      float v = 0.f;
      if (k0 + k < N && n0 + c < C) v = kOnes ? 1.f : __ldg(ab + static_cast<long long>(k0 + k) * C + n0 + c);
      uint32_t h, l;
      split_tf32(v, h, l);
      th[k * kStride + c] = __uint_as_float(h);
      tl[k * kStride + c] = __uint_as_float(l);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kOhK / 8; ++ks) {
      const int k = k0 + ks * 8 + q;  // A fragment: (row g, col q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
      const uint32_t oh[4] = {j0 == k ? one : 0u, j1 == k ? one : 0u, j0 == k + 4 ? one : 0u,
                              j1 == k + 4 ? one : 0u};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = (ks * 8 + q) * kStride + nt * 8 + g;  // B fragment: (k q, n g), (k q + 4, n g)
        mma_tf32(acc[nt], oh, __float_as_uint(tl[o]), __float_as_uint(tl[o + 4 * kStride]));
        mma_tf32(acc[nt], oh, __float_as_uint(th[o]), __float_as_uint(th[o + 4 * kStride]));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = n0 + nt * 8 + 2 * q;  // D fragment: (row g, cols 2q, 2q + 1), (g + 8, ...)
    if (c >= C) continue;
    if (r0 < M)
      *reinterpret_cast<float2*>(out + (static_cast<long long>(b) * M + r0) * C + c) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r1 < M)
      *reinterpret_cast<float2*>(out + (static_cast<long long>(b) * M + r1) * C + c) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- per-element indices (k_taa_full) ---------------------------------------------
__global__ void __launch_bounds__(kThreads) elems_kernel(const float* __restrict__ a,
                                                         const int* __restrict__ idx,
                                                         float* __restrict__ out, int N, int M,
                                                         int C) {
  const int b = blockIdx.y;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(M) * C) return;
  const long long o = static_cast<long long>(b) * M * C + e;
  const int c = static_cast<int>(e % C), j = __ldg(idx + o);
  out[o] = in_range(j, N) ? __ldg(a + (static_cast<long long>(b) * N + j) * C + c)
                          : __int_as_float(0x7fc00000);
}

// ---- P2: bf16 rows widened to f32 -------------------------------------------------
__global__ void __launch_bounds__(kThreads) bf16_kernel(const uint16_t* __restrict__ a,
                                                        const int* __restrict__ idx,
                                                        float* __restrict__ out, int N, int M,
                                                        int C) {
  const int b = blockIdx.y, c8 = C / 8;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(M) * c8) return;
  const int m = static_cast<int>(e / c8), c = static_cast<int>(e - static_cast<long long>(m) * c8) * 8;
  const int j = __ldg(idx + static_cast<long long>(b) * M + m);
  float4 lo = nan4(), hi = nan4();
  if (in_range(j, N)) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(a + (static_cast<long long>(b) * N + j) * C + c));
    // a bf16 value is the high half of the f32 with the same bits: widening is a shift
    lo = make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
    hi = make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
                     __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
  }
  float4* dst = reinterpret_cast<float4*>(out + (static_cast<long long>(b) * M + m) * C + c);
  dst[0] = lo;
  dst[1] = hi;
}

bool args_ok(int B, int N, int M, int C) {
  return B >= 1 && B <= 65535 && N >= 1 && M >= 1 && C >= 1;
}

unsigned blocks_of(long long n, int per) { return static_cast<unsigned>((n + per - 1) / per); }

}  // namespace

extern "C" int gather_rows(const float* a, const int* idx, float* out, int B, int N, int M, int C,
                           int form, void* stream) {
  if (!args_ok(B, N, M, C) || form < kLdg || form > kOnehot) return kErrArgs;
  if (C % 4) return kErrWidth;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == kLdg) {
    ldg_kernel<<<dim3(blocks_of(static_cast<long long>(M) * (C / 4), kThreads), B), kThreads, 0, s>>>(
        a, idx, out, N, M, C);
  } else if (form == kOnehot) {
    const dim3 grid(blocks_of(M, kOhRows), B, blocks_of(C, kOhCols));
    onehot_kernel<false><<<grid, kThreads, 0, s>>>(a, idx, out, N, M, C);
  } else {
    const int T = kStageBytes / (C * 4) > 0 ? kStageBytes / (C * 4) : 1;
    const size_t smem = static_cast<size_t>(T) * C * 4 + T * sizeof(int);
    if (smem > 200 * 1024) return kErrArgs;
    const dim3 grid(blocks_of(M, T), B);
    const void* k = form == kCpAsync ? reinterpret_cast<const void*>(staged_kernel<kCpAsync>)
                                     : reinterpret_cast<const void*>(staged_kernel<kBulk>);
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (form == kCpAsync) staged_kernel<kCpAsync><<<grid, kThreads, smem, s>>>(a, idx, out, N, M, C, T);
    else staged_kernel<kBulk><<<grid, kThreads, smem, s>>>(a, idx, out, N, M, C, T);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_elems(const float* a, const int* idx, float* out, int B, int N, int M, int C,
                            void* stream) {
  if (!args_ok(B, N, M, C)) return kErrArgs;
  elems_kernel<<<dim3(blocks_of(static_cast<long long>(M) * C, kThreads), B), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, idx, out, N, M, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int onehot_rowsums(const int* idx, float* out, int B, int N, int M, int C,
                              void* stream) {
  if (!args_ok(B, N, M, C)) return kErrArgs;
  const dim3 grid(blocks_of(M, kOhRows), B, blocks_of(C, kOhCols));
  onehot_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(nullptr, idx, out,
                                                                              N, M, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_bf16_rows(const uint16_t* a, const int* idx, float* out, int B, int N, int M,
                                int C, void* stream) {
  if (!args_ok(B, N, M, C)) return kErrArgs;
  if (C % 8) return kErrWidth;
  bf16_kernel<<<dim3(blocks_of(static_cast<long long>(M) * (C / 8), kThreads), B), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a, idx, out, N, M, C);
  return static_cast<int>(cudaGetLastError());
}
