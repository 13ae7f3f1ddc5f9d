// Fused eval-mode set abstraction for Hopper (sm_90a), f32 on CUDA cores.
//
// K4  sa_fused_k4 with idx == nullptr replaces open3dsot_tpu/ops/sa_fused.py::
//     fused_sa_apply with idx=None (Pallas kernel _sa_bq_kernel): ball query in
//     the kernel, gather of the layer-1 A-form rows, + ct, ReLU, two folded
//     Dense+ReLU layers, max over the K neighbors -> (B, S, C3).
// K5  the same entry with idx (B, S, K) given replaces fused_sa_apply with idx
//     (Pallas kernel _sa_kernel): the ball query is skipped, the rest is K4.
//
// The A-form (open3dsot_tpu/ops/sa_fused.py::a_form) is computed outside, by
// torch.matmul, as JAX computes it in XLA outside the pallas_call:
//   layer1(concat((x_j - c_s) / r, f_j)) = A[j] + ct[s],
//   A = (x / r) W1_xyz + f W1_feat over all N points (B, N, C1),
//   ct = b1 - (c / r) W1_xyz per centroid (B, S, C1).
//
// What bounds it on this card. At BAT/P2B widths a centroid's K x C1 -> C2 ->
// C3 chain is 32 x (64x64 + 64x128) up to 32 x (256x256 x 2) multiply-adds,
// against 3 + C3 floats in and out per centroid: arithmetic, not device
// memory, once the (B, S, K, C) activations stay on chip. The folded weights
// (up to 256 KB each) do not fit beside the activations in one block's
// shared memory, so they stream through L1/L2 (all of them fit in the 50 MB
// L2), as in chain_fused.cu.
//
// What the design does about it.
//  - A block owns a tile of ts = ROWS / K centroids and all of their K rows,
//    so the max over K is a reduction inside the block: no atomics, no second
//    pass. Blocks run in any order (the TPU grid ran in order; nothing here
//    needs that).
//  - Ball query: one warp per centroid walks the points in chunks of 32; each
//    lane tests one point (strict d^2 < r^2, d^2 = ((dx*dx) + (dy*dy)) +
//    (dz*dz) with __fmul_rn/__fadd_rn, the rounding of the plain version), and
//    a ballot plus popc give each in-ball point its slot in ascending index
//    order. The walk stops once K points are found. Slots past the count
//    repeat slot 0; a centroid with no point in the ball gets index 0 (the
//    CUDA op's convention; unreachable where the centroids are points of the
//    cloud). This replaces the TPU's triangular-matmul prefix count. r^2 comes
//    from the host, rounded once from double to f32 as JAX's weak-typed float.
//  - Gather: indexed float4 loads of A rows (B, N, C1) from L2. The TPU's
//    one-hot MXU gather and int8 bit-plane trick existed only because Mosaic
//    has no row gather; they have no counterpart here. An index outside
//    [0, N) in K5's idx gives NaN rows instead of a read out of bounds.
//  - Layers 2 and 3: each thread computes a 4-row x 4-channel register tile;
//    per input channel it loads one float4 of weights and four smem
//    activations, then issues 16 FMAs. Activations live in two smem buffers
//    (h1: ROWS x C1, h2: ROWS x C2), rows padded by 4 floats so that the row
//    groups of one warp read different banks. Layer 3 is never stored whole:
//    each chunk of output channels goes to h1 (free by then) and is reduced
//    over K at once.
//  - Tile size: ROWS in {128, 64, 32, 16}, the largest whose buffers leave
//    room for two blocks on an SM and whose grid gives every SM two blocks;
//    else the smallest ROWS >= K, for the most blocks. At C = 256 and K = 32
//    a 256-row tile would need 256 KB, more than a block's 227 KB; the rule
//    never picks it. At B = 1 the grid is S / ts blocks, 32 to 512 on the
//    BAT path: the template's last layer and the vote layer fill a quarter
//    of the card.
//  - A ragged last tile (S not a multiple of ts) is masked: its rows past S
//    are neither gathered, reduced nor written.
//
// Interface: plain C, loaded with ctypes; pointers are device pointers and the
// stream is PyTorch's current stream. Returns 0, a CUDA error code, or a
// negative code for arguments the kernel does not take.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRP = 4;  // rows per thread
constexpr int kRC = 4;  // output channels per thread (one float4)
constexpr int kPad = 4;  // floats of padding per smem row
constexpr size_t kSmemBudget = 220 * 1024;     // one block per SM (of 227 KB)
constexpr size_t kSmemTwoBlocks = 110 * 1024;  // two blocks per SM

constexpr int kErrArgs = -1;   // B, N, S, K or widths not accepted
constexpr int kErrWidth = -2;  // a width is not a multiple of 4
constexpr int kErrSmem = -3;   // the smallest tile does not fit in shared memory

struct SAArgs {
  const float* xyz;      // (B, N, 3): K4
  const float* centers;  // (B, S, 3): K4
  const int* idx;        // (B, S, K): K5; nullptr for K4
  const float* a;        // (B, N, C1) A-form rows
  const float* ct;       // (B, S, C1)
  const float* w2;       // (C1, C2)
  const float* b2;       // (C2)
  const float* w3;       // (C2, C3)
  const float* b3;       // (C3)
  float* out;            // (B, S, C3)
  int B, N, S, K, C1, C2, C3;
  float r2;
  int ts;         // centroids per block
  int h1_floats;  // size of the h1 buffer
};

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// hout[r][c] = relu(hin[r] . W[:, c] + bias[c]) for the ROWS rows of the tile and
// the 4 channels [c, c + 4) of this thread; acc holds the result.
template <int ROWS>
__device__ __forceinline__ void dense_relu_tile(const float* hin, int ld_in, int K_in,
                                                const float* __restrict__ W,
                                                const float* __restrict__ bias, int C, int c,
                                                int tp, float (&acc)[kRP][kRC]) {
  const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c));
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    acc[i][0] = bv.x;
    acc[i][1] = bv.y;
    acc[i][2] = bv.z;
    acc[i][3] = bv.w;
  }
  const float* h = hin + tp * kRP * ld_in;
#pragma unroll 4
  for (int k = 0; k < K_in; ++k) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(W + static_cast<size_t>(k) * C + c));
#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const float hv = h[i * ld_in + k];
      acc[i][0] = fmaf(hv, w.x, acc[i][0]);
      acc[i][1] = fmaf(hv, w.y, acc[i][1]);
      acc[i][2] = fmaf(hv, w.z, acc[i][2]);
      acc[i][3] = fmaf(hv, w.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRP; ++i)
#pragma unroll
    for (int j = 0; j < kRC; ++j) acc[i][j] = fmaxf(acc[i][j], 0.f);
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads) sa_kernel(const SAArgs a) {
  constexpr int PG = ROWS / kRP;    // row groups
  constexpr int CG = kThreads / PG;  // channel groups
  constexpr int CHUNK = CG * kRC;    // output channels per pass
  extern __shared__ float4 smem4[];
  const int ld1 = a.C1 + kPad, ld2 = a.C2 + kPad;
  float* h1 = reinterpret_cast<float*>(smem4);
  float* h2 = h1 + a.h1_floats;
  int* sidx = reinterpret_cast<int*>(h2 + ROWS * ld2);

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * a.ts;
  const int ns = min(a.ts, a.S - s0);  // centroids of this tile
  const int K = a.K;
  const int n_rows = ns * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tp = tid / CG, tc = tid % CG;

  // 1. neighbor indices of the tile's rows
  if (a.idx) {
    const int* src = a.idx + (static_cast<size_t>(b) * a.S + s0) * K;
    for (int r = tid; r < n_rows; r += kThreads) sidx[r] = src[r];
  } else {
    const float* xyz = a.xyz + static_cast<size_t>(b) * a.N * 3;
    for (int t = warp; t < ns; t += kWarps) {
      const float* c = a.centers + (static_cast<size_t>(b) * a.S + s0 + t) * 3;
      const float cx = c[0], cy = c[1], cz = c[2];
      int* slots = sidx + t * K;
      int count = 0;
      for (int base = 0; base < a.N && count < K; base += 32) {
        const int j = base + lane;
        bool in_ball = false;
        if (j < a.N) in_ball = sqdist(cx, cy, cz, xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2]) < a.r2;
        const unsigned m = __ballot_sync(0xffffffffu, in_ball);
        const int pos = count + __popc(m & ((1u << lane) - 1u));
        if (in_ball && pos < K) slots[pos] = j;
        count += __popc(m);
      }
      __syncwarp();
      const int filled = min(count, K);
      const int first = filled > 0 ? slots[0] : 0;
      __syncwarp();
      for (int k = filled + lane; k < K; k += 32) slots[k] = first;
    }
  }
  __syncthreads();

  // 2. layer 1: h1[r] = relu(A[idx[r]] + ct[centroid of r]); rows past the tile are 0
  {
    const int c1v = a.C1 / 4;
    const float* A = a.a + static_cast<size_t>(b) * a.N * a.C1;
    const float* ct = a.ct + (static_cast<size_t>(b) * a.S + s0) * a.C1;
    for (int e = tid; e < ROWS * c1v; e += kThreads) {
      const int r = e / c1v, c = (e - r * c1v) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n_rows) {
        const int j = sidx[r];
        if (j >= 0 && j < a.N) {
          const float4 av = __ldg(reinterpret_cast<const float4*>(A + static_cast<size_t>(j) * a.C1 + c));
          const float4 cv = __ldg(reinterpret_cast<const float4*>(ct + (r / K) * a.C1 + c));
          v = make_float4(fmaxf(av.x + cv.x, 0.f), fmaxf(av.y + cv.y, 0.f),
                          fmaxf(av.z + cv.z, 0.f), fmaxf(av.w + cv.w, 0.f));
        } else {
          const float nan = __int_as_float(0x7fc00000);
          v = make_float4(nan, nan, nan, nan);
        }
      }
      *reinterpret_cast<float4*>(h1 + r * ld1 + c) = v;
    }
  }
  __syncthreads();

  // 3. layer 2: h2 = relu(h1 W2 + b2)
  for (int cb = 0; cb < a.C2; cb += CHUNK) {
    const int c = cb + tc * kRC;
    if (c < a.C2) {
      float acc[kRP][kRC];
      dense_relu_tile<ROWS>(h1, ld1, a.C1, a.w2, a.b2, a.C2, c, tp, acc);
#pragma unroll
      for (int i = 0; i < kRP; ++i)
        *reinterpret_cast<float4*>(h2 + (tp * kRP + i) * ld2 + c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();

  // 4. layer 3 chunk by chunk into h1 (ROWS x CHUNK), then the max over each centroid's K rows
  float* red = h1;
  for (int cb = 0; cb < a.C3; cb += CHUNK) {
    const int c = cb + tc * kRC;
    if (c < a.C3) {
      float acc[kRP][kRC];
      dense_relu_tile<ROWS>(h2, ld2, a.C2, a.w3, a.b3, a.C3, c, tp, acc);
#pragma unroll
      for (int i = 0; i < kRP; ++i)
        *reinterpret_cast<float4*>(red + (tp * kRP + i) * CHUNK + tc * kRC) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    for (int e = tid; e < ns * CHUNK; e += kThreads) {
      const int t = e / CHUNK, j = e - t * CHUNK;
      if (cb + j < a.C3) {
        float m = 0.f;  // every value is a ReLU output, so >= 0
        for (int k = 0; k < K; ++k) m = fmaxf(m, red[(t * K + k) * CHUNK + j]);
        a.out[(static_cast<size_t>(b) * a.S + s0 + t) * a.C3 + cb + j] = m;
      }
    }
    __syncthreads();
  }
}

template <int ROWS>
size_t smem_bytes(const SAArgs& a, int* h1_floats) {
  constexpr int CHUNK = kThreads / (ROWS / kRP) * kRC;
  const int h1 = ROWS * (a.C1 + kPad);
  *h1_floats = h1 > ROWS * CHUNK ? h1 : ROWS * CHUNK;  // h1 also holds layer 3's chunk
  return (static_cast<size_t>(*h1_floats) + static_cast<size_t>(ROWS) * (a.C2 + kPad)) *
             sizeof(float) +
         ROWS * sizeof(int);
}

template <int ROWS>
int launch(SAArgs a, cudaStream_t stream) {
  const size_t smem = smem_bytes<ROWS>(a, &a.h1_floats);
  if (smem > kSmemBudget) return kErrSmem;
  cudaError_t e = cudaFuncSetAttribute(sa_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  a.ts = ROWS / a.K;
  const dim3 grid((a.S + a.ts - 1) / a.ts, a.B);
  sa_kernel<ROWS><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int ROWS>
bool fits_two_blocks_and_fills(const SAArgs& a, long long want) {
  if (ROWS < a.K) return false;
  int scratch;
  const long long ts = ROWS / a.K;
  const long long blocks = (a.S + ts - 1) / ts * a.B;
  return smem_bytes<ROWS>(a, &scratch) <= kSmemTwoBlocks && blocks >= want;
}

int run(const SAArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = 2LL * sms;
  if (fits_two_blocks_and_fills<128>(a, want)) return launch<128>(a, stream);
  if (fits_two_blocks_and_fills<64>(a, want)) return launch<64>(a, stream);
  if (fits_two_blocks_and_fills<32>(a, want)) return launch<32>(a, stream);
  if (fits_two_blocks_and_fills<16>(a, want)) return launch<16>(a, stream);
  // a small grid: the smallest tile that holds K rows, for the most blocks
  if (a.K <= 16) return launch<16>(a, stream);
  if (a.K <= 32) return launch<32>(a, stream);
  if (a.K <= 64) return launch<64>(a, stream);
  return launch<128>(a, stream);
}

}  // namespace

// idx == nullptr: K4 (ball query in the kernel, xyz and centers used);
// otherwise K5 (xyz and centers unused). r2 is the squared radius in f32.
extern "C" int sa_fused_k4(const float* xyz, const float* centers, const int* idx,
                           const float* a_rows, const float* ct, const float* w2,
                           const float* b2, const float* w3, const float* b3, float* out,
                           int B, int N, int S, int K, int C1, int C2, int C3, float r2,
                           void* stream) {
  if (B < 1 || N < 1 || S < 1 || K < 1 || K > 128 || C1 < 1 || C2 < 1 || C3 < 1)
    return kErrArgs;
  if (!idx && (!xyz || !centers)) return kErrArgs;
  if (C1 % 4 || C2 % 4 || C3 % 4) return kErrWidth;
  SAArgs a{};
  a.xyz = xyz;
  a.centers = centers;
  a.idx = idx;
  a.a = a_rows;
  a.ct = ct;
  a.w2 = w2;
  a.b2 = b2;
  a.w3 = w3;
  a.b3 = b3;
  a.out = out;
  a.B = B;
  a.N = N;
  a.S = S;
  a.K = K;
  a.C1 = C1;
  a.C2 = C2;
  a.C3 = C3;
  a.r2 = r2;
  return run(a, static_cast<cudaStream_t>(stream));
}
