// Training-mode set abstraction (K6) for Hopper (sm_90a), its grid products on
// the tensor cores in 3xTF32 (tf32_tc.cuh).
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
// grid products per sample forward and twice that backward. f32 needs the
// CUDA cores (67 TFLOP/s); 3xTF32 keeps f32 accuracy on the tensor cores at
// three TF32 products per multiply-add (3 x FLOP / 494.7 TFLOP/s, 2.5x less
// time). The products of width 128 then sit near the memory bound (about 96
// TF32 flops per byte of grid), those of width 256 above it. On the chip the
// limit is nearer: a block holds 128 rows, so every 128-row tile streams the
// whole weight (hi and lo, 8 bytes per weight) from L2 again, as much L2
// traffic as its operands.
//
// What the design does about it.
//  - Passes: separate kernels on one stream, because each BatchNorm needs the
//    statistics of ALL rows before the next layer can run (blocks run in
//    parallel on 132 SMs; the TPU's grid ran in order). Every partial sum is
//    a double, one per block, and a finalize kernel reduces the partials in
//    a fixed order: the statistics are the same from run to run.
//  - Row products (y2 = h1 W2 + b2, y3 = h2 W3 + b3, dh2 = dy3 W3^T, dh1 =
//    dy2 W2^T; rowmm_kernel): one persistent block per SM walks over 128-row
//    tiles; each tile is a run of chunks (128 output x 32 input channels).
//    Warp-specialised: a producer warpgroup fetches the A operands raw
//    (cp.async, two chunks ahead), transforms them (relu(y * s + t), or the
//    BN backward), splits them hi/lo into shared memory in the weights'
//    core-matrix layout and streams the weight chunks (packed on the host by
//    ops/chain_fused.py::pack_chunks, W^T for dh; TMA bulk copies); two
//    consumer warpgroups run `wgmma` m64n128k8 with A and W both from shared
//    memory and do the epilogues. Full and empty mbarriers pass the two
//    stages of each between them. Measured on the card: the tensor cores
//    take 1536 cycles for a chunk's 12 wgmma from shared memory (peak), but
//    issuing them holds the issuing warps that long, so staging A in the
//    same warps added its time to theirs. No branch around wgmma (ptxas
//    would serialise it): rows past R are zero A rows kept out of the
//    epilogue, widths are zero-padded chunks.
//  - dW = h^T dy (dw_kernel) contracts over rows, and h and dy are row-major:
//    MN-major for this product, which TF32 wgmma does not take (its
//    transpose flags are for 16-bit types only). mma.sync m16n8k8 loads its
//    own fragments, so both operands stay row-major in shared memory (row
//    stride 136 floats: the fragment loads hit 32 banks), folded and split
//    hi/lo once as they are stored; no transposing store is needed. A block
//    owns a 128 x 128 tile of dW over a chunk of rows in steps of 32, the raw
//    operands of step s + 2 loading (cp.async) while step s multiplies; the
//    per-chunk partial tiles are summed in a fixed order by a second kernel.
//    No float atomics in any gradient but da.
//  - Sums: the tensor cores do not round their f32 sums to nearest, so each
//    32-deep chunk's products (a 32-input weight chunk; 32 rows for dW) go to
//    registers of their own and are added to the accumulators on the CUDA
//    cores.
//  - BatchNorm sums in the epilogues: y2's and y3's (sum y, sum y^2) and the
//    backward's (sum dz, sum dz * yhat) come from the tile of the product
//    that makes the grid, in double, one partial per 128-row tile; y1's from
//    the pass that gathers it; dz3's from the max gradient pass. The BN
//    backward dy = s * ((dz - sum dz / M) - yhat * sum(dz yhat) / M) is
//    applied as the next products load dz: no pass rewrites a grid. The
//    epilogue's double sums are reduced over a warp's row groups by halving
//    (56 shuffles of doubles a thread, not 192), in registers: an array
//    indexed by a value the compiler could not fold went to the stack and
//    cost 6x.
//  - Grids kept in device memory: y2, y3 (forward, for the backward), dz2,
//    dz1 (backward). y1 = a[idx] + ct is not stored: it is gathered again
//    wherever it is read (its statistics, y2's A, dW2's h1, dh1's ReLU mask,
//    the scatter), from a (B, N, C1) and ct (B, S, C1), which L2 holds; one
//    f32 add, so bit for bit the grid it would have been. That saves R * C1
//    * 4 bytes of writes and four reads of them. dz3 is not stored either:
//    the max gradient pass keeps (max, g / ties) per (b, s, c), and dW3 and
//    dh2 rebuild dz3 and dy3 from y3 as they load it. What is per centroid
//    (ct, max, share) is read once per chunk and row as the operand
//    transforms, not copied per row; rows' offsets and centroids are
//    computed once per tile (32-bit rows: R < 2^31).
//  - Gather: indexed float4 loads of A-form rows; an index outside [0, N)
//    gives NaN rows. Scatter: da += dy1 with atomicAdd (the pad-with-first
//    ball query repeats an index up to K times, so a row of da sums in an
//    order that changes from run to run, about K * 2^-24 of its magnitude).
//  - Rounding pinned where a decision depends on it: relu(y * s + t) with
//    __fmul_rn/__fadd_rn, s and t from 1 / sqrt(var + eps) rounded as IEEE
//    division and square root, the tie split g / cnt as IEEE division. The
//    plain version (ops/sa_fused_train.py) computes them in the same order,
//    so on the same grids the max masks, ties and ReLU masks agree bit for bit.
//
// The bf16 mode (template flag BF; the JAX kernels' cdt = bfloat16,
// open3dsot_tpu/ops/sa_fused_train.py:281-338, :407-528). The caller rounds
// the A-form rows to bf16 once (the TPU gathers them as bf16) and keeps them
// in f32, so the gathers are the f32 mode's. Every operand of a product is
// rounded to bf16 as it is stored for the tensor cores: h1, h2 and dy3, dy2 in
// the row products (one wgmma m64n64k16 pass per 64 outputs and k16 step, A
// from registers, loaded from a row-major bf16 stage; weights packed in bf16
// by ops/chain_fused.py::pack_chunks_bf16, 8 KB chunks), and h, dy in dW
// (mma.sync m16n8k16, fragments packed from the f32 tile as they load).
// y2 and y3 stay f32 (the JAX kernel recomputes them from the bf16 h1, h2: the
// same values), and so do the statistics and the folds. The dz grids dz2, dz1
// are stored in bf16 (half the bytes), their BN sums taken from the unrounded
// values in the epilogue, as the JAX passes sum before they store; dz3 is
// rounded as dW3 and dh2 rebuild it. The scatter adds dy1 rounded to bf16
// into da (the JAX one-hot product's bf16 operand) and the unrounded dy1 into
// dct. Widths stay multiples of 4: every bf16 access moves four channels (8
// bytes) and the k16 steps run over zero-padded 32-wide chunks.
//
// Interface: plain C, loaded with ctypes; pointers are device pointers and
// the stream is PyTorch's current stream. The caller allocates outputs and
// the workspace (sa_train_workspace bytes). Returns 0, a CUDA error code, or
// a negative code for arguments the kernels do not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tc.cuh"  // kCC x kKC weight chunks, the TF32 split, mma.sync, wgmma, TMA
#include "bf16_tc.cuh"  // the bf16 mode's weight chunks, fragments and wgmma

namespace {

constexpr int kErrArgs = -1;   // B, N, S, K or widths not accepted
constexpr int kErrWidth = -2;  // a width is not a multiple of 4
constexpr int kErrPacked = -3;  // a packed weight has the wrong size
constexpr int kErrWide = -4;    // a width too large for the products' shared memory
constexpr float kEps = 1e-5f;
constexpr int kThreads = 256;
constexpr int kStatRows = 512;     // rows of one partial of y1's sums
constexpr int kTile = 128;         // rows of a row-product block: two warpgroups of 64
constexpr int kCent = 64;          // centroids of one partial of the max gradient pass
constexpr int kDwT = 128;          // dW block tile, I x J
constexpr int kDwRows = 32;        // rows of one dW step, its products summed apart
constexpr int kDwStride = kDwT + 8;  // floats between rows of a dW operand tile
constexpr int kWantBlocks = 264;   // dW: about two blocks per SM over the tiles
constexpr int kFinWarps = 32;      // finalize: warps over the partials of a block
constexpr int kFinSlices = 16;     // finalize: blocks over the partials of 32 channels

constexpr int kSmemMax = 232448;   // 227 KB, the most a block may take

struct Dims {
  long long R;  // B * S * K
  int B, N, S, K, C1, C2, C3;
};

// What a pass reads besides its own operands; per-channel vectors of layer l
// (width C_l) at [l].
struct Ctx {
  Dims d;
  const float* a;     // (B, N, C1)
  const float* ct;    // (B, S, C1)
  const int* idx;     // (B, S, K)
  const float* y2;    // (R, C2)
  const float* y3;    // (R, C3)
  const void* dz2;    // (R, C2), f32 (bf16 in the bf16 mode)
  const float* mx3;   // (B * S, C3): max_k relu(BN3(y3))
  const float* sh3;   // (B * S, C3): g / number of tied maxima
  const float* fold[3];  // s, t, inv = 1 / sqrt(var + eps), each C_l
  const float* mean[3];
  const float* coef[3];  // sum dz / M, sum dz * yhat / M, each C_l
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
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float& el(float4& v, int j) { return (&v.x)[j]; }
__device__ __forceinline__ float el(const float4& v, int j) { return (&v.x)[j]; }

// s = gamma / sqrt(var + eps), t = beta - mean * s, inv = 1 / sqrt(var + eps)
__device__ __forceinline__ void fold_of(float mean, float var, float gamma, float beta, float* s,
                                        float* t, float* inv) {
  const float iv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, kEps)));
  const float sc = __fmul_rn(gamma, iv);
  *s = sc;
  *t = __fsub_rn(beta, __fmul_rn(mean, sc));
  *inv = iv;
}

// ---- rows --------------------------------------------------------------------
// Rows are below 2^31 (check()), so their centroid and batch element come
// from 32-bit divisions.
__device__ __forceinline__ unsigned centroid_of(const Dims& d, int r) {
  return static_cast<unsigned>(r) / static_cast<unsigned>(d.K);
}

// ---- what the products load ---------------------------------------------------
// A product's operand rows are fetched raw, 16 bytes at a time, by cp.async
// into shared memory a chunk or two ahead, and transformed as they are stored
// for the tensor cores. Loader L's raw arrays and its transform, per channel
// c..c+3 of row r (of layer l, width C):
//   kLoadH1   a[b, idx[r]]                -> relu((a + ct[b, s]) * s1 + t1)  (h1)
//   kLoadH2   y2[r]                       -> relu(y2 * s2 + t2)            (h2)
//   kLoadDy3  y3[r]                       -> dz3 = share[b, s] where h3 is the
//             max[b, s] (> 0), else 0, then dy3 = s3 * ((dz3 - c1) - yhat3 * c2)
// What is per centroid (ct, max, share; 32 rows share it) is read as the
// operand transforms (aux_at), not copied once per row.
//   kLoadDy2  dz2[r], y2[r]               -> dy2 = s2 * ((dz2 - c1) - yhat2 * c2)
// Rows past the end, channels past C and rows with an index outside [0, N)
// are zero-filled: their products are zero or kept out of every sum (an index
// outside [0, N) makes y1's statistics NaN, and with them the outputs).
enum Load { kLoadH1, kLoadH2, kLoadDy3, kLoadDy2 };

template <int L>
__host__ __device__ constexpr int n_raw() {
  return L == kLoadDy2 ? 2 : 1;
}
// per-channel vectors in shared memory: (s, t), or (s, t, inv, mean, c1, c2)
template <int L>
__host__ __device__ constexpr int n_vec() {
  return L == kLoadH1 || L == kLoadH2 ? 2 : 6;
}
template <int L>
__host__ __device__ constexpr int layer_of() {
  return L == kLoadH1 ? 0 : L == kLoadDy3 ? 2 : 1;
}

__device__ __forceinline__ int width_of(const Dims& d, int l) {
  return l == 0 ? d.C1 : l == 1 ? d.C2 : d.C3;
}

// Vectors of loader L for channels c0 .. c0 + Cv of its layer, zero past its width.
template <int L>
__device__ __forceinline__ void fill_vec(float* vec, const Ctx& x, int c0, int Cv) {
  constexpr int l = layer_of<L>();
  const int C = width_of(x.d, l);
  for (int i = threadIdx.x; i < n_vec<L>() * Cv; i += blockDim.x) {
    const int k = i / Cv, c = c0 + i % Cv;
    float v = 0.f;
    if (c < C) {
      if (k < 2) v = x.fold[l][k * C + c];          // s, t
      else if (k == 2) v = x.fold[l][2 * C + c];    // inv
      else if (k == 3) v = x.mean[l][c];
      else v = x.coef[l][(k - 4) * C + c];          // c1, c2
    }
    vec[i] = v;
  }
}

// Where a row's raw operands start (an element offset): row r of its grid, or
// for kLoadH1 row idx[r] = j of a.
template <int L>
__device__ __forceinline__ long long row_ref(const Ctx& x, int r, int j) {
  const long long C = width_of(x.d, layer_of<L>());
  if constexpr (L == kLoadH1) {
    const unsigned b = centroid_of(x.d, r) / static_cast<unsigned>(x.d.S);
    return (static_cast<long long>(b) * x.d.N + j) * C;
  }
  return r * C;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 8 bytes (four bf16), zero-filled where !ok
__device__ __forceinline__ void cp_async8(float* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 8 : 0) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fetch channels c..c+3 of a row into raw arrays dst, dst + stride, ... at offset o.
// BF: dz2 is bf16 (its four values in the first 8 bytes of the slot).
template <int L, bool BF>
__device__ __forceinline__ void fetch_raw(const Ctx& x, float* dst, int stride, int o,
                                          long long ref, int c, bool ok) {
  const float* base = x.a;  // a valid address for the zero-filling copies
  if constexpr (L == kLoadH1) {
    cp_async16(dst + o, ok ? x.a + ref + c : base, ok);
  } else if constexpr (L == kLoadH2) {
    cp_async16(dst + o, ok ? x.y2 + ref + c : base, ok);
  } else if constexpr (L == kLoadDy3) {
    cp_async16(dst + o, ok ? x.y3 + ref + c : base, ok);
  } else {
    if constexpr (BF)
      cp_async8(dst + o, ok ? static_cast<const void*>(static_cast<const uint16_t*>(x.dz2) + ref + c)
                            : static_cast<const void*>(base), ok);
    else
      cp_async16(dst + o, ok ? static_cast<const float*>(x.dz2) + ref + c : base, ok);
    cp_async16(dst + stride + o, ok ? x.y2 + ref + c : base, ok);
  }
}

// dW copies the per-centroid operands too, once per row, into raw arrays of
// their own after the loader's: n_aux of them.
template <int L>
__host__ __device__ constexpr int n_aux() {
  return L == kLoadH1 ? 1 : L == kLoadDy3 ? 2 : 0;
}

// Per-centroid operands at channels c..c+3: ct (kLoadH1), the max and the tie
// share (kLoadDy3). cent is the row's centroid, or 0 for a row past R; a
// channel past the width reads channel 0 (the vectors zero its operand). The
// loads are unconditional, so a thread's loads of several rows fly together.
struct Aux {
  float4 a, b;
};

template <int L>
__device__ __forceinline__ int aux_width(const Dims& d) { return L == kLoadH1 ? d.C1 : d.C3; }

template <int L>
__device__ __forceinline__ unsigned aux_cent(const Dims& d, int r) {
  return (L == kLoadH1 || L == kLoadDy3) && r < d.R ? centroid_of(d, r) : 0u;
}

template <int L>
__device__ __forceinline__ Aux aux_at(const Ctx& x, unsigned cent, int c) {
  Aux u{make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  if constexpr (L == kLoadH1 || L == kLoadDy3) {
    const int C = aux_width<L>(x.d);
    const long long o = static_cast<long long>(cent) * C + (c < C ? c : 0);
    if constexpr (L == kLoadH1) {
      u.a = ldg4(x.ct + o);
    } else {
      u.a = ldg4(x.mx3 + o);
      u.b = ldg4(x.sh3 + o);
    }
  }
  return u;
}

// Fetch the per-centroid operands of channels c..c+3 into the n_aux<L> raw
// arrays from dst (stride apart) at offset o; cent the row's centroid.
template <int L>
__device__ __forceinline__ void fetch_aux(const Ctx& x, float* dst, int stride, int o,
                                          unsigned cent, int c, bool ok) {
  if constexpr (n_aux<L>() > 0) {
    const long long off = static_cast<long long>(cent) * aux_width<L>(x.d) + c;
    if constexpr (L == kLoadH1) {
      cp_async16(dst + o, ok ? x.ct + off : x.a, ok);
    } else {
      cp_async16(dst + o, ok ? x.mx3 + off : x.a, ok);
      cp_async16(dst + stride + o, ok ? x.sh3 + off : x.a, ok);
    }
  }
}

// The per-centroid operands as fetch_aux left them.
template <int L>
__device__ __forceinline__ Aux aux_raw(const float* src, int stride, int o) {
  Aux u{make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  if constexpr (n_aux<L>() > 0) u.a = *reinterpret_cast<const float4*>(src + o);
  if constexpr (n_aux<L>() > 1) u.b = *reinterpret_cast<const float4*>(src + stride + o);
  return u;
}

// The operand from the raw arrays at offset o, vec (n_vec x Cv) at channel cl
// and aux from aux_at. BF: dz3 and dz2 are taken as bf16 (the JAX kernel's
// B2 and B3 read the dz grids it stored as bf16); the caller rounds the result.
template <int L, bool BF>
__device__ __forceinline__ float4 transform(const float* src, int stride, int o, const float* vec,
                                            int Cv, int cl, const Aux& aux) {
  const float4 s = *reinterpret_cast<const float4*>(vec + cl);
  const float4 t = *reinterpret_cast<const float4*>(vec + Cv + cl);
  float4 u = *reinterpret_cast<const float4*>(src + o), out;
  if constexpr (L == kLoadH1 || L == kLoadH2) {
    if constexpr (L == kLoadH1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) el(u, j) = __fadd_rn(el(u, j), el(aux.a, j));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) el(out, j) = fold_relu(el(u, j), el(s, j), el(t, j));
  } else {
    const float4 inv = *reinterpret_cast<const float4*>(vec + 2 * Cv + cl);
    const float4 mu = *reinterpret_cast<const float4*>(vec + 3 * Cv + cl);
    const float4 c1 = *reinterpret_cast<const float4*>(vec + 4 * Cv + cl);
    const float4 c2 = *reinterpret_cast<const float4*>(vec + 5 * Cv + cl);
    float4 y, dz;
    if constexpr (L == kLoadDy3) {
      y = u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = fold_relu(el(y, j), el(s, j), el(t, j));
        el(dz, j) = (h == el(aux.a, j) && h > 0.f) ? el(aux.b, j) : 0.f;
        if constexpr (BF) el(dz, j) = round_bf16(el(dz, j));
      }
    } else {
      if constexpr (BF) {
        const uint2 w = *reinterpret_cast<const uint2*>(src + o);
        dz = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
      } else {
        dz = u;
      }
      y = *reinterpret_cast<const float4*>(src + stride + o);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      el(out, j) = bn_bwd(el(dz, j), yhat_of(el(y, j), el(mu, j), el(inv, j)), el(s, j),
                          el(c1, j), el(c2, j));
  }
  return out;
}

// ---- F1: y1's (sum, sum of squares), one partial per kStatRows rows -----------
// Block (32, 8): 32 channels, 8 row lanes; grid (C1 / 32, partials). The rows'
// gather offsets are computed once per block.
__global__ void y1_stats_kernel(const Ctx x, double* __restrict__ part) {
  __shared__ double sh[2][8][33];
  __shared__ long long off_a[kStatRows], off_c[kStatRows];  // off_a -1: index outside [0, N)
  const int tx = threadIdx.x, ty = threadIdx.y, C = x.d.C1;
  const int r0 = blockIdx.y * kStatRows, n = min(static_cast<int>(x.d.R) - r0, kStatRows);
  for (int i = ty * 32 + tx; i < n; i += 256) {
    const unsigned bs = centroid_of(x.d, r0 + i), b = bs / static_cast<unsigned>(x.d.S);
    const int j = __ldg(x.idx + r0 + i);
    off_a[i] = (j >= 0 && j < x.d.N) ? (static_cast<long long>(b) * x.d.N + j) * C : -1;
    off_c[i] = static_cast<long long>(bs) * C;
  }
  __syncthreads();
  const int c = blockIdx.x * 32 + tx;
  double s1 = 0.0, s2 = 0.0;
  if (c < C) {
    for (int i = ty; i < n; i += 8) {
      const float v = off_a[i] < 0
                          ? __int_as_float(0x7fc00000)
                          : __fadd_rn(__ldg(x.a + off_a[i] + c), __ldg(x.ct + off_c[i] + c));
      s1 += v;
      s2 += static_cast<double>(v) * static_cast<double>(v);
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

// Sum the P partials of channels blockIdx.x * 32 + lane in a fixed order, in
// two levels: block (x, y) sums slice y of the partials (warp w takes w, w +
// kFinWarps, ...; warp 0 adds the warps' sums) into part2; the last block of
// x to finish (count) adds the slices in order and returns true, with the
// result in its warp 0. Block of 32 x kFinWarps threads, grid (C / 32, slices).
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

// ---- row products on the tensor cores --------------------------------------
enum Epi { kEpiBias, kEpiMaskY2, kEpiMaskY1 };

struct RowArgs {
  Ctx x;
  const float* w;     // the product's weight, packed (ops/chain_fused.py::pack_chunks)
  const float* bias;  // kEpiBias: (nout)
  void* out;          // (R, nout), f32 (the masked epilogues: bf16 in the bf16 mode)
  double* part;       // (tiles, 2, nout): the epilogue's sums
  int kin, nout, nk, nc;  // widths; input and output chunks
  int kinp, noutp;        // widths padded to whole chunks
  int tiles;              // 128-row tiles
};

constexpr int kAStage = 2 * kTile * kKC;  // floats of one A chunk in shared memory: hi, then lo
constexpr int kAPart = kTile * kKC;
// The bf16 mode's A chunk: rows of kKC bf16, kA16Stride apart (20 words: the
// fragment loads of a warp's rows g and inputs 2q hit 32 banks); fits in kAStage.
constexpr int kA16Stride = kKC + 8;
constexpr int kRaw = kTile * kKC;         // floats of one raw array of an A chunk
constexpr int kRed = 8 * kCC * 2 * 2;     // floats of the epilogue's sums: 8 warps x 128 x 2 doubles
constexpr int kConsumerWarps = 8;       // two warpgroups of wgmma
constexpr int kProducerThreads = 128;   // a warpgroup that stages A and streams the weights
constexpr int kPE = kTile * kKC / 4 / kProducerThreads;  // float4 of an A chunk per producer
constexpr int kRowThreads = kConsumerWarps * 32 + kProducerThreads;

// The consumer warps' barrier (named barrier 1; the producers go on).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// rowmm_kernel's shared memory in floats: two weight stages, two A stages, two
// raw stages, the epilogue's sums, the loader's vectors, the epilogue's vectors
// (bias, or s, t, inv, mean), eight mbarriers.
template <int L>
constexpr long long row_smem_floats(int kinp, int noutp) {
  return 2LL * kWStage + 2 * kAStage + 2LL * n_raw<L>() * kRaw + kRed + n_vec<L>() * kinp +
         4LL * noutp + 16;
}

// One step of a reduction over lanes by halving: the lane keeps vs[H..2H) if
// up, else vs[0..H), adds the partner's (lane ^ mask) copy of it, and leaves
// the result in vs[0..H). The indices are constants, so vs stays in registers.
template <int H>
__device__ __forceinline__ void halve(double (&vs)[16], bool up, int mask) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const double lo = vs[k], hi = vs[H + k];
    vs[k] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, mask);
  }
}

// The epilogue of output chunk cb of a tile: columns n = cb * kCC + nt * 8 +
// 2q + j, rows 16 warp + g + 8h. E = kEpiBias: out = acc + bias, sums (out,
// out^2); kEpiMaskY2/Y1: out = acc where relu(BN(y)) > 0 (y = y2, or y1
// gathered), else 0, sums (out, out * yhat). The sums are doubles, taken four
// column blocks nt at a time, reduced over the warp's 8 row groups by halving
// and over the 8 consumer warps in order: one partial per tile.
// BF: the masked grids (dz2, dz1) are stored as bf16, their sums taken unrounded.
template <int E, bool BF>
__device__ __forceinline__ void row_epilogue(const RowArgs& p, const float (&acc)[16][4], int tile,
                                             int cb, double* red, const float* evec) {
  const Ctx& x = p.x;
  const int R = static_cast<int>(x.d.R);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
  // this thread's two rows, and where the mask operand y of each starts
  // (kEpiMaskY1: a's row idx[r] and ct's row; NaN for an index outside [0, N))
  int rr[2];
  long long yo[2] = {0, 0}, co[2] = {0, 0};
  bool bad[2] = {false, false};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = tile * kTile + 16 * warp + g + 8 * h;
    const int rc = rr[h] < R ? rr[h] : 0;
    if constexpr (E == kEpiMaskY2) yo[h] = static_cast<long long>(rc) * p.nout;
    if constexpr (E == kEpiMaskY1) {
      const unsigned bs = centroid_of(x.d, rc), b = bs / static_cast<unsigned>(x.d.S);
      const int j = __ldg(x.idx + rc);
      bad[h] = !(j >= 0 && j < x.d.N);
      yo[h] = (static_cast<long long>(b) * x.d.N + (bad[h] ? 0 : j)) * p.nout;
      co[h] = static_cast<long long>(bs) * p.nout;
    }
  }
#pragma unroll
  for (int n4 = 0; n4 < 4; ++n4) {
    float2 y[4][2];  // the mask operand of (m, h), loaded together
    if constexpr (E != kEpiBias) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = cb * kCC + (4 * n4 + m) * 8 + 2 * q, nc = n < p.nout ? n : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (E == kEpiMaskY2) {
            y[m][h] = ldg2(x.y2 + yo[h] + nc);
          } else {
            const float2 av = ldg2(x.a + yo[h] + nc), cv = ldg2(x.ct + co[h] + nc);
            const float nan = __int_as_float(0x7fc00000);
            y[m][h] = bad[h] ? make_float2(nan, nan)
                             : make_float2(__fadd_rn(av.x, cv.x), __fadd_rn(av.y, cv.y));
          }
        }
      }
    }
    double vs[16];  // [s * 8 + m * 2 + j], nt = 4 n4 + m: s = 0 sum, 1 sum of out * w
#pragma unroll
    for (int i = 0; i < 16; ++i) vs[i] = 0.0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int nt = 4 * n4 + m, n = cb * kCC + nt * 8 + 2 * q;
      if (n >= p.nout) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rr[h];
        if (r >= R) continue;
        float v[2] = {acc[nt][2 * h], acc[nt][2 * h + 1]}, w[2];
        if constexpr (E == kEpiBias) {
          v[0] += evec[n];
          v[1] += evec[n + 1];
          w[0] = v[0];
          w[1] = v[1];
        } else {
          const float2 yv = y[m][h];
          const float* e = evec + n;
          const int P = p.noutp;
          if (!(fold_relu(yv.x, e[0], e[P]) > 0.f)) v[0] = 0.f;
          if (!(fold_relu(yv.y, e[1], e[P + 1]) > 0.f)) v[1] = 0.f;
          w[0] = yhat_of(yv.x, e[3 * P], e[2 * P]);
          w[1] = yhat_of(yv.y, e[3 * P + 1], e[2 * P + 1]);
        }
        const long long oe = static_cast<long long>(r) * p.nout + n;
        if constexpr (BF && E != kEpiBias)
          static_cast<uint32_t*>(p.out)[oe >> 1] = pack_bf16(v[0], v[1]);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + oe) = make_float2(v[0], v[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          vs[m * 2 + j] += v[j];
          vs[8 + m * 2 + j] += static_cast<double>(v[j]) * static_cast<double>(w[j]);
        }
      }
    }
    halve<8>(vs, g & 1, 4);
    halve<4>(vs, (g >> 1) & 1, 8);
    halve<2>(vs, (g >> 2) & 1, 16);
    // lane (g, q) holds vs[j], j < 2: the original index j + 2 g2 + 4 g1 + 8 g0,
    // so s = g0 and m = g2 + 2 g1 (g0, g1, g2 the bits of g)
    const int m = ((g >> 2) & 1) + 2 * ((g >> 1) & 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      red[(warp * kCC + (4 * n4 + m) * 8 + 2 * q + j) * 2 + (g & 1)] = vs[j];
  }
  consumer_sync();
  if (tid < kCC && cb * kCC + tid < p.nout) {  // the 8 warps' sums in order
    double a = 0.0, b = 0.0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      a += red[(w * kCC + tid) * 2];
      b += red[(w * kCC + tid) * 2 + 1];
    }
    const long long base = static_cast<long long>(tile) * 2 * p.nout + cb * kCC + tid;
    p.part[base] = a;
    p.part[base + p.nout] = b;
  }
  consumer_sync();  // red is read before it is written again
}

// out = op(A) W with the A rows transformed by loader L as they are stored,
// and the epilogue E (row_epilogue). Persistent: block z takes tiles z, z +
// grid, ...; its chunks (tile, output chunk, input chunk) run as one sequence
// u. Warp-specialised: the two producer warps fetch each chunk's raw operands
// two chunks ahead (cp.async), transform, split and store its A into A stage
// u & 1 and bring its weights into weight stage u & 1 (TMA); the two consumer
// warpgroups run the 3xTF32 products of each chunk (wgmma, A and W from shared
// memory), add them to their sums and run the epilogues. Full and empty
// mbarriers of each stage pass it between them. Consumer warp w holds tile
// rows 16 w + g and + 8 (warpgroup w / 4 owns 64 of them).
//
// BF, the bf16 mode: the producers round each transformed operand to bf16 and
// store it row-major (kA16Stride); the weight chunks are bf16 (kWStage16
// floats); each consumer warp loads its 16 rows' A fragments from shared
// memory and runs wgmma m64n64k16 (A from registers) twice a k16 step, one for
// each 64 output channels of the chunk: two k16 steps a chunk, one pass each.
template <int L, int E, bool BF>
__global__ void __launch_bounds__(kRowThreads, 1) rowmm_kernel(const RowArgs p) {
  constexpr int NR = n_raw<L>();
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  float* asm0 = wsm + 2 * kWStage;
  float* raw0 = asm0 + 2 * kAStage;
  double* red = reinterpret_cast<double*>(raw0 + 2 * NR * kRaw);
  float* vec = raw0 + 2 * NR * kRaw + kRed;
  float* evec = vec + n_vec<L>() * p.kinp;
  uint64_t* bars = reinterpret_cast<uint64_t*>(evec + 4 * p.noutp);
  uint64_t *wfull = bars, *wempty = bars + 2, *afull = bars + 4, *aempty = bars + 6;
  const Ctx& x = p.x;
  const int R = static_cast<int>(x.d.R);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_tile = p.nc * p.nk;
  const int U = (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * per_tile;
  constexpr int kWst = BF ? kWStage16 : kWStage;  // floats of a weight chunk in device memory

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], kConsumerWarps);
      mbar_init(&afull[i], kProducerThreads);
      mbar_init(&aempty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fill_vec<L>(vec, x, 0, p.kinp);
  // bias, or s, t, inv, mean of the output layer
  for (int i = tid; i < 4 * p.noutp; i += blockDim.x) {
    const int k = i / p.noutp, c = i % p.noutp;
    float v = 0.f;
    if (c < p.nout) {
      if constexpr (E == kEpiBias) v = k == 0 ? p.bias[c] : 0.f;
      else {
        constexpr int l = E == kEpiMaskY2 ? 1 : 0;
        v = k < 3 ? x.fold[l][k * p.nout + c] : x.mean[l][c];
      }
    }
    evec[i] = v;
  }
  __syncthreads();  // the vectors are in place, the barriers initialised

  if (warp >= kConsumerWarps) {
    // ---- producers: thread pt stages rows rl + 8 (pt / 64 + i * kProducerThreads / 64),
    // i < kPE, channels ((pt >> 3) & 7) * 4..+3 of each chunk (a quarter warp's
    // stores fill 128 contiguous bytes of the core-matrix layout)
    const int pt = tid - kConsumerWarps * 32;
    const int rl = (pt & 7) + 8 * (pt >> 6), ec = ((pt >> 3) & 7) * 4;
    constexpr int kRowStep = 8 * kProducerThreads / 64;
    const int Cin = width_of(x.d, layer_of<L>());
    // fetch state: the next chunk's tile and input chunk, and where this
    // thread's 16 rows of that tile start (computed once per tile)
    int f_tile = blockIdx.x, f_kb = 0, f_in_tile = 0, f_ref_tile = -1;
    long long ref[kPE];
    uint32_t okm = 0;  // bit i: row i is in range (and its index in [0, N))
    const auto fetch = [&](int v) {
      if (v < U) {
        if (f_tile != f_ref_tile) {
          f_ref_tile = f_tile;
          okm = 0;
#pragma unroll
          for (int i = 0; i < kPE; ++i) {
            const int r = f_tile * kTile + rl + kRowStep * i;
            int j = 0;
            if constexpr (L == kLoadH1) j = r < R ? __ldg(x.idx + r) : 0;
            ref[i] = row_ref<L>(x, r, j);
            okm |= static_cast<uint32_t>(r < R && (L != kLoadH1 || (j >= 0 && j < x.d.N))) << i;
          }
        }
        float* st = raw0 + (v & 1) * NR * kRaw;
        const int c = f_kb * kKC + ec;
#pragma unroll
        for (int i = 0; i < kPE; ++i)
          fetch_raw<L, BF>(x, st, kRaw, (pt + kProducerThreads * i) * 4, ref[i], c,
                           ((okm >> i) & 1) && c < Cin);
        if (++f_kb == p.nk) f_kb = 0;
        if (++f_in_tile == per_tile) {
          f_in_tile = 0;
          f_tile += gridDim.x;
        }
      }
      cp_async_commit();
    };
    fetch(0);
    fetch(1);
    // staging state: chunk v's tile and input chunk, its rows' centroids
    int t_tile = blockIdx.x, t_kb = 0, t_in_tile = 0;
    unsigned cent[kPE];
    const auto set_cent = [&]() {
#pragma unroll
      for (int i = 0; i < kPE; ++i) cent[i] = aux_cent<L>(x.d, t_tile * kTile + rl + kRowStep * i);
    };
    set_cent();
    for (int v = 0; v < U; ++v) {
      const int s = v & 1;
      if (v >= 2) {  // chunk v - 2 is done with the stages
        mbar_wait(&aempty[s], ((v - 2) >> 1) & 1);
        if (pt == 0) mbar_wait(&wempty[s], ((v - 2) >> 1) & 1);
      }
      if (pt == 0)
        bulk_load(wsm + s * kWStage, p.w + static_cast<long long>(t_in_tile) * kWst, &wfull[s],
                  kWst * sizeof(float));
      cp_async_wait<1>();  // this thread's copies of chunk v have landed
      const float* st = raw0 + s * NR * kRaw;
      float* ah = asm0 + s * kAStage;
      const int cl = t_kb * kKC + ec;
#pragma unroll 4
      for (int i = 0; i < kPE; ++i) {
        const int row = rl + kRowStep * i;
        const float4 a = transform<L, BF>(st, kRaw, (pt + kProducerThreads * i) * 4, vec, p.kinp,
                                          cl, aux_at<L>(x, cent[i], cl));
        if constexpr (BF) {
          *reinterpret_cast<uint2*>(reinterpret_cast<uint16_t*>(ah) + row * kA16Stride + ec) =
              make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
        } else {
          uint32_t h[4], l[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(el(a, j), h[j], l[j]);
          const int o = wofs(row, ec);
          st4(ah + o, make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                  __uint_as_float(h[2]), __uint_as_float(h[3])));
          st4(ah + kAPart + o, make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                           __uint_as_float(l[2]), __uint_as_float(l[3])));
        }
      }
      fence_proxy_async();  // the stores are seen by the tensor cores
      mbar_arrive(&afull[s]);
      fetch(v + 2);
      if (++t_kb == p.nk) t_kb = 0;
      if (++t_in_tile == per_tile) {
        t_in_tile = 0;
        t_tile += gridDim.x;
        set_cent();
      }
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  int tile = blockIdx.x, cb = 0, kb = 0;
  for (int u = 0; u < U; ++u) {
    const int s = u & 1;
    mbar_wait(&afull[s], (u >> 1) & 1);
    mbar_wait(&wfull[s], (u >> 1) & 1);
    const float* wh = wsm + s * kWStage;
    float part[16][4];
    if constexpr (BF) {
      // this warp's rows 16 warp + g (+ 8), inputs ks * 16 + 2q (+ 1, + 8, + 9)
      const uint16_t* a16 = reinterpret_cast<const uint16_t*>(asm0 + s * kAStage) +
                            (16 * warp + (lane >> 2)) * kA16Stride + 2 * (lane & 3);
      const uint16_t* w16 = reinterpret_cast<const uint16_t*>(wh);
      float(&plo)[8][4] = *reinterpret_cast<float(*)[8][4]>(&part[0][0]);
      float(&phi)[8][4] = *reinterpret_cast<float(*)[8][4]>(&part[8][0]);
      uint32_t af[kKC / 16][4];
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        const uint16_t* r0 = a16 + ks * 16;
        af[ks][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[ks][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kA16Stride);
        af[ks][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        af[ks][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kA16Stride + 8);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        if (ks == 0) {
          wgmma_m64n64k16_bf16<0>(plo, af[ks], smem_desc16(w16 + wofs16(0, 0)));
          wgmma_m64n64k16_bf16<0>(phi, af[ks], smem_desc16(w16 + wofs16(64, 0)));
        } else {
          wgmma_m64n64k16_bf16<1>(plo, af[ks], smem_desc16(w16 + wofs16(0, ks * 16)));
          wgmma_m64n64k16_bf16<1>(phi, af[ks], smem_desc16(w16 + wofs16(64, ks * 16)));
        }
      }
    } else {
      const float* as = asm0 + s * kAStage + wofs(64 * (warp >> 2), 0);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        const uint64_t a_hi = smem_desc(as + wofs(0, ks * 8));
        const uint64_t a_lo = smem_desc(as + kAPart + wofs(0, ks * 8));
        const uint64_t w_hi = smem_desc(wh + wofs(0, ks * 8));
        const uint64_t w_lo = smem_desc(wh + kWPart + wofs(0, ks * 8));
        if (ks == 0) wgmma_m64n128k8_ss<0>(part, a_lo, w_hi);
        else wgmma_m64n128k8_ss<1>(part, a_lo, w_hi);
        wgmma_m64n128k8_ss<1>(part, a_hi, w_lo);
        wgmma_m64n128k8_ss<1>(part, a_hi, w_hi);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) {  // the stages are free for chunk u + 2
      mbar_arrive(&aempty[s]);
      mbar_arrive(&wempty[s]);
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_operand(part[nt][i]);
        acc[nt][i] += part[nt][i];  // the chunk's sum added on the CUDA cores
      }
    if (++kb == p.nk) {
      row_epilogue<E, BF>(p, acc, tile, cb, red, evec);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      kb = 0;
      if (++cb == p.nc) {
        cb = 0;
        tile += gridDim.x;
      }
    }
  }
}

// ---- dW = h^T dy over a chunk of rows, mma.sync -------------------------------
struct DwArgs {
  Ctx x;
  float* part;  // (chunks, I, J)
  int I, J;
  int chunk;    // rows of a chunk
};

constexpr int kDwTileF = kDwRows * kDwStride;  // floats of one split operand tile
constexpr int kDwRaw = kDwRows * kDwT;         // floats of one raw array of a step

// raw arrays of a dW step: X's, its per-centroid ones, D's, its per-centroid ones
template <int LX, int LD>
__host__ __device__ constexpr int dw_raw_arrays() {
  return n_raw<LX>() + n_aux<LX>() + n_raw<LD>() + n_aux<LD>();
}

template <int LX, int LD>
constexpr long long dw_smem_floats() {
  return 4LL * kDwTileF + 2LL * dw_raw_arrays<LX, LD>() * kDwRaw +
         (n_vec<LX>() + n_vec<LD>()) * kDwT;
}

// BF: the value rounded to bf16, kept as f32 in hi (lo unused).
template <bool BF>
__device__ __forceinline__ void store_split(float* hi, float* lo, int o, float4 v) {
  if constexpr (BF) {
    st4(hi + o, make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w)));
    return;
  }
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) split_tf32(el(v, j), h[j], l[j]);
  st4(hi + o, make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                          __uint_as_float(h[3])));
  st4(lo + o, make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                          __uint_as_float(l[3])));
}

// Block: a 128 x 128 tile (i0, j0) of dW over rows [z * chunk, ...) in steps
// of 32 rows, the raw operands of step s + 2 loading while step s multiplies;
// X = h (loader LX, I wide), D = dy (loader LD, J wide), both row-major, split
// hi/lo as they are stored. Warp (wi, wj) = (warp / 4, warp % 4) owns rows
// i0 + 64 wi .. and columns j0 + 32 wj .. of the tile. BF, the bf16 mode: the
// operands are rounded to bf16 as they are stored (kept as f32 values), and
// each step is two k16 passes of mma.sync m16n8k16, whose fragments pack the
// two rows k, k + 1 of a column into one word as they are loaded.
template <int LX, int LD, bool BF>
__global__ void __launch_bounds__(kThreads, 1) dw_kernel(const DwArgs p) {
  // a raw stage: X's arrays, X's per-centroid ones, D's, D's per-centroid ones
  constexpr int NX = n_raw<LX>(), AX = NX + n_aux<LX>(), ND = AX + n_raw<LD>();
  constexpr int NA = dw_raw_arrays<LX, LD>();
  extern __shared__ float4 smem4[];
  float* xh = reinterpret_cast<float*>(smem4);
  float* xl = xh + kDwTileF;
  float* dh = xl + kDwTileF;
  float* dl = dh + kDwTileF;
  float* raw0 = dl + kDwTileF;
  float* vx = raw0 + 2 * NA * kDwRaw;
  float* vd = vx + n_vec<LX>() * kDwT;
  const Ctx& x = p.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mi = (warp >> 2) * 64, nj = (warp & 3) * 32;
  const int i0 = blockIdx.x * kDwT, j0 = blockIdx.y * kDwT;
  const int r0 = blockIdx.z * p.chunk;
  const int r1 = min(static_cast<int>(x.d.R), r0 + p.chunk);
  const int steps = (r1 - r0 + kDwRows - 1) / kDwRows;
  // this thread's elements: rows er + 8 i, channels ec..ec+3
  const int er = tid >> 5, ec = (tid & 31) * 4;

  fill_vec<LX>(vx, x, i0, kDwT);
  fill_vec<LD>(vd, x, j0, kDwT);
  int jq[4] = {0, 0, 0, 0};  // LX == H1: idx of the rows of the step fetched next
  const auto load_idx = [&](int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + s * kDwRows + er + 8 * i;
      jq[i] = r < r1 ? __ldg(x.idx + r) : 0;
    }
  };
  if constexpr (LX == kLoadH1) load_idx(0);
  const auto fetch = [&](int s) {
    if (s < steps) {
      float* st = raw0 + (s & 1) * NA * kDwRaw;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + s * kDwRows + er + 8 * i;
        const int o = (er + 8 * i) * kDwT + ec, j = jq[i];
        const bool in = r < r1, inx = in && i0 + ec < p.I, ind = in && j0 + ec < p.J;
        fetch_raw<LX, BF>(x, st, kDwRaw, o, row_ref<LX>(x, r, j), i0 + ec,
                          inx && (LX != kLoadH1 || (j >= 0 && j < x.d.N)));
        fetch_aux<LX>(x, st + NX * kDwRaw, kDwRaw, o, aux_cent<LX>(x.d, r), i0 + ec, inx);
        fetch_raw<LD, BF>(x, st + AX * kDwRaw, kDwRaw, o, row_ref<LD>(x, r, 0), j0 + ec, ind);
        fetch_aux<LD>(x, st + ND * kDwRaw, kDwRaw, o, aux_cent<LD>(x.d, r), j0 + ec, ind);
      }
      if constexpr (LX == kLoadH1) load_idx(s + 1);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  __syncthreads();  // the vectors are in place

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();  // this thread's copies of step s have landed
    {
      const float* st = raw0 + (s & 1) * NA * kDwRaw;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (er + 8 * i) * kDwT + ec, ot = (er + 8 * i) * kDwStride + ec;
        const Aux ax = aux_raw<LX>(st + NX * kDwRaw, kDwRaw, o);
        const Aux ad = aux_raw<LD>(st + ND * kDwRaw, kDwRaw, o);
        // a zero-filled row does not transform to zero
        const bool in = r0 + s * kDwRows + er + 8 * i < r1;
        store_split<BF>(xh, xl, ot, in ? transform<LX, BF>(st, kDwRaw, o, vx, kDwT, ec, ax) : zero);
        store_split<BF>(dh, dl, ot,
                        in ? transform<LD, BF>(st + AX * kDwRaw, kDwRaw, o, vd, kDwT, ec, ad)
                           : zero);
      }
    }
    __syncthreads();
    fetch(s + 2);
    float part[4][4][4];  // this step's 3xTF32 products, added to acc on the CUDA cores
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
    if constexpr (BF) {
#pragma unroll
      for (int ks = 0; ks < kDwRows / 16; ++ks) {
        // rows k = ks * 16 + 2q, + 1 (k0, k1) and + 8, + 9 (k8, k9)
        const int k0 = (ks * 16 + 2 * q) * kDwStride, k1 = k0 + kDwStride;
        const int k8 = k0 + 8 * kDwStride, k9 = k8 + kDwStride;
        uint32_t b[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {  // B[k][n] = D[row k][n]
          const int n = nj + nt * 8 + g;
          b[nt][0] = pack_bf16(dh[k0 + n], dh[k1 + n]);
          b[nt][1] = pack_bf16(dh[k8 + n], dh[k9 + n]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {  // A[m][k] = X[row k][m]
          const int m = mi + mt * 16 + g;
          const uint32_t a[4] = {pack_bf16(xh[k0 + m], xh[k1 + m]),
                                 pack_bf16(xh[k0 + m + 8], xh[k1 + m + 8]),
                                 pack_bf16(xh[k8 + m], xh[k9 + m]),
                                 pack_bf16(xh[k8 + m + 8], xh[k9 + m + 8])};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(part[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    } else {
#pragma unroll
    for (int ks = 0; ks < kDwRows / 8; ++ks) {
      const int k0 = (ks * 8 + q) * kDwStride, k4 = k0 + 4 * kDwStride;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {  // B[k][n] = D[row k][n]
        const int n = nj + nt * 8 + g;
        bh[nt][0] = __float_as_uint(dh[k0 + n]);
        bh[nt][1] = __float_as_uint(dh[k4 + n]);
        bl[nt][0] = __float_as_uint(dl[k0 + n]);
        bl[nt][1] = __float_as_uint(dl[k4 + n]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {  // A[m][k] = X[row k][m]
        const int m = mi + mt * 16 + g;
        const uint32_t ah[4] = {__float_as_uint(xh[k0 + m]), __float_as_uint(xh[k0 + m + 8]),
                                __float_as_uint(xh[k4 + m]), __float_as_uint(xh[k4 + m + 8])};
        const uint32_t al[4] = {__float_as_uint(xl[k0 + m]), __float_as_uint(xl[k0 + m + 8]),
                                __float_as_uint(xl[k4 + m]), __float_as_uint(xl[k4 + m + 8])};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(part[mt][nt], al, bh[nt][0], bh[nt][1]);
          mma_tf32(part[mt][nt], ah, bl[nt][0], bl[nt][1]);
          mma_tf32(part[mt][nt], ah, bh[nt][0], bh[nt][1]);
        }
      }
    }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    __syncthreads();  // every warp is done with this step's tiles
  }
  cp_async_wait<0>();
  float* out = p.part + static_cast<long long>(blockIdx.z) * p.I * p.J;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = i0 + mi + mt * 16 + g + 8 * h, n = j0 + nj + nt * 8 + 2 * q;
        if (m < p.I && n < p.J)
          *reinterpret_cast<float2*>(out + static_cast<long long>(m) * p.J + n) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
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

// ---- B1: per (b, s, c) the max of h3 and g / (number of tied maxima); dz3 =
// that share at the maxima where h3 > 0, else 0, and its sums (dz3, dz3 *
// yhat3), one partial per kCent centroids. Block (32, 8): 32 channels, 8
// centroid lanes; grid (C3 / 32, partials).
__global__ void maxgrad_kernel(const Ctx x, const float* __restrict__ g, float* __restrict__ mx3,
                               float* __restrict__ sh3, double* __restrict__ part) {
  __shared__ double sh[2][8][33];
  const int tx = threadIdx.x, ty = threadIdx.y, C = x.d.C3, K = x.d.K;
  const long long BS = static_cast<long long>(x.d.B) * x.d.S;
  const int c = blockIdx.x * 32 + tx;
  double s1 = 0.0, s2 = 0.0;
  if (c < C) {
    const float s = x.fold[2][c], t = x.fold[2][C + c], inv = x.fold[2][2 * C + c];
    const float mu = x.mean[2][c];
    for (int i = 0; i < kCent / 8; ++i) {
      const long long bs = static_cast<long long>(blockIdx.y) * kCent + ty + 8 * i;
      if (bs >= BS) break;
      const float* y = x.y3 + bs * K * C + c;
      float m = 0.f;
      for (int k = 0; k < K; ++k) m = fmaxf(m, fold_relu(y[k * C], s, t));
      int cnt = 0;
      for (int k = 0; k < K; ++k) cnt += fold_relu(y[k * C], s, t) == m;
      const float share = __fdiv_rn(g[bs * C + c], static_cast<float>(cnt));
      mx3[bs * C + c] = m;
      sh3[bs * C + c] = share;
      for (int k = 0; k < K; ++k) {
        const float h = fold_relu(y[k * C], s, t);
        if (h == m && h > 0.f) {
          s1 += share;
          s2 += static_cast<double>(share) * static_cast<double>(yhat_of(y[k * C], mu, inv));
        }
      }
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

// ---- B4: dy1 = BN backward of dz1; da[b, idx[r]] += dy1[r]; dct[bs] = sum_k dy1
// BF: dz1 is bf16, and da sums dy1 rounded to bf16 (the JAX kernel's bf16
// one-hot product), dct the unrounded dy1.
template <bool BF>
__global__ void scatter_kernel(const Ctx x, const void* __restrict__ dz1, float* __restrict__ da,
                               float* __restrict__ dct) {
  const Dims& d = x.d;
  const long long BS = static_cast<long long>(d.B) * d.S;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= BS * d.C1) return;
  const long long bs = e / d.C1;
  const int c = static_cast<int>(e - bs * d.C1);
  const long long b = bs / d.S;
  const float s = x.fold[0][c], inv = x.fold[0][2 * d.C1 + c], mu = x.mean[0][c];
  const float c1 = x.coef[0][c], c2 = x.coef[0][d.C1 + c];
  const float ctv = __ldg(x.ct + bs * d.C1 + c);
  float acc = 0.f;
  for (int k = 0; k < d.K; ++k) {
    const long long r = bs * d.K + k;
    const int j = __ldg(x.idx + r);
    const bool in = j >= 0 && j < d.N;
    const long long row = (b * d.N + j) * d.C1 + c;
    const float y1 = in ? __fadd_rn(__ldg(x.a + row), ctv) : __int_as_float(0x7fc00000);
    const long long e1 = r * d.C1 + c;
    const float dz = BF ? __uint_as_float(static_cast<uint32_t>(
                              static_cast<const uint16_t*>(dz1)[e1]) << 16)
                        : static_cast<const float*>(dz1)[e1];
    const float v = bn_bwd(dz, yhat_of(y1, mu, inv), s, c1, c2);
    acc += v;
    if (in) atomicAdd(da + row, BF ? round_bf16(v) : v);
  }
  dct[e] = acc;
}

// ---- host side ---------------------------------------------------------------
inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }
inline int round8(int n) { return (n + 7) & ~7; }

int cmax(const Dims& d) { return d.C1 > d.C2 ? (d.C1 > d.C3 ? d.C1 : d.C3) : (d.C2 > d.C3 ? d.C2 : d.C3); }
long long centroids(const Dims& d) { return static_cast<long long>(d.B) * d.S; }
long long row_tiles(const Dims& d) { return cdiv(d.R, kTile); }
long long stat_chunks(const Dims& d) { return cdiv(d.R, kStatRows); }
long long cent_chunks(const Dims& d) { return cdiv(centroids(d), kCent); }

// Floats of a weight (k_in x n_out) packed as whole kCC x kKC chunks, hi and
// lo (3xTF32), or one bf16 part (bf16: half a float a value).
long long packed_floats(int k_in, int n_out, bool bf16) {
  return cdiv(round8(n_out), kCC) * cdiv(round8(k_in), kKC) * (bf16 ? kWStage16 : kWStage);
}

// Bytes of shared memory of a row product kin -> nout with loader L.
template <int L>
long long row_smem(int kin, int nout) {
  return 4 * row_smem_floats<L>(static_cast<int>(cdiv(round8(kin), kKC)) * kKC,
                                static_cast<int>(cdiv(round8(nout), kCC)) * kCC);
}

// dW row split: about kWantBlocks blocks over the tiles, chunks of whole steps
void dw_split(const Dims& d, int I, int J, int* P, long long* chunk) {
  const long long tiles = cdiv(I, kDwT) * cdiv(J, kDwT);
  long long p = cdiv(kWantBlocks, tiles);
  p = p < cdiv(d.R, kDwRows) ? p : cdiv(d.R, kDwRows);
  const long long ch = cdiv(cdiv(d.R, p), kDwRows) * kDwRows;
  *P = static_cast<int>(cdiv(d.R, ch));
  *chunk = ch;
}

struct Workspace {  // byte offsets into one buffer
  size_t part, part2, count, fold, coef, mx, sh, dwpart, dz2, dz1, total;
};

Workspace layout(const Dims& d, bool backward, bool bf16) {
  Workspace w{};
  const size_t C = static_cast<size_t>(cmax(d));
  long long P = row_tiles(d);
  if (stat_chunks(d) > P) P = stat_chunks(d);
  if (cent_chunks(d) > P) P = cent_chunks(d);
  size_t off = 0;
  const auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  w.part = take(static_cast<size_t>(P) * 2 * C * sizeof(double));
  w.part2 = take(static_cast<size_t>(kFinSlices) * 2 * C * sizeof(double));
  w.count = take(cdiv(C, 32) * sizeof(unsigned));
  w.fold = take(9 * C * sizeof(float));  // (s, t, inv) of each of the 3 layers
  if (backward) {
    w.coef = take(6 * C * sizeof(float));
    const size_t cent = static_cast<size_t>(centroids(d)) * d.C3 * sizeof(float);
    w.mx = take(cent);
    w.sh = take(cent);
    int P3, P2;
    long long ch;
    dw_split(d, d.C2, d.C3, &P3, &ch);
    dw_split(d, d.C1, d.C2, &P2, &ch);
    const size_t e3 = static_cast<size_t>(P3) * d.C2 * d.C3, e2 = static_cast<size_t>(P2) * d.C1 * d.C2;
    w.dwpart = take((e3 > e2 ? e3 : e2) * sizeof(float));
    const size_t grid = bf16 ? sizeof(uint16_t) : sizeof(float);  // the dz grids' values
    w.dz2 = take(static_cast<size_t>(d.R) * d.C2 * grid);
    w.dz1 = take(static_cast<size_t>(d.R) * d.C1 * grid);
  }
  w.total = off;
  return w;
}

int check(int B, int N, int S, int K, int C1, int C2, int C3, Dims* d) {
  if (B < 1 || N < 1 || S < 1 || K < 1 || C1 < 1 || C2 < 1 || C3 < 1) return kErrArgs;
  if (C1 % 4 || C2 % 4 || C3 % 4) return kErrWidth;
  *d = Dims{static_cast<long long>(B) * S * K, B, N, S, K, C1, C2, C3};
  // rows are 32-bit in the kernels, with a tile's worth to spare
  if (d->R > 0x7fffffffLL - kTile || stat_chunks(*d) > 65535 || cent_chunks(*d) > 65535)
    return kErrArgs;
  int P;
  long long ch;
  dw_split(*d, d->C2, d->C3, &P, &ch);  // the larger split of the two dW
  if (P > 65535) return kErrArgs;
  if (row_smem<kLoadH1>(C1, C2) > kSmemMax || row_smem<kLoadH2>(C2, C3) > kSmemMax ||
      row_smem<kLoadDy3>(C3, C2) > kSmemMax || row_smem<kLoadDy2>(C2, C1) > kSmemMax)
    return kErrWide;
  return 0;
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

// The SM count and the kernels' shared-memory limit, once per process.
struct DeviceInfo {
  int sms;
  int err;
};

const DeviceInfo& device_info() {
  static const DeviceInfo info = [] {
    DeviceInfo d{132, 0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    const void* kernels[] = {
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH1, kEpiBias, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH2, kEpiBias, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadDy3, kEpiMaskY2, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadDy2, kEpiMaskY1, false>),
        reinterpret_cast<const void*>(dw_kernel<kLoadH2, kLoadDy3, false>),
        reinterpret_cast<const void*>(dw_kernel<kLoadH1, kLoadDy2, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH1, kEpiBias, true>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH2, kEpiBias, true>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadDy3, kEpiMaskY2, true>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadDy2, kEpiMaskY1, true>),
        reinterpret_cast<const void*>(dw_kernel<kLoadH2, kLoadDy3, true>),
        reinterpret_cast<const void*>(dw_kernel<kLoadH1, kLoadDy2, true>)};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    d.err = static_cast<int>(e);
    return d;
  }();
  return info;
}

template <int L, int E, bool BF>
int rowmm(const Ctx& x, const float* w, const float* bias, void* out, double* part, int kin,
          int nout, cudaStream_t st) {
  const int nk = static_cast<int>(cdiv(round8(kin), kKC));
  const int nc = static_cast<int>(cdiv(round8(nout), kCC));
  const RowArgs p{x, w, bias, out, part, kin, nout, nk, nc, nk * kKC, nc * kCC,
                    static_cast<int>(row_tiles(x.d))};
  const int sms = device_info().sms;
  const unsigned blocks = static_cast<unsigned>(p.tiles < sms ? p.tiles : sms);
  const size_t smem = static_cast<size_t>(row_smem<L>(kin, nout));
  rowmm_kernel<L, E, BF><<<blocks, kRowThreads, smem, st>>>(p);
  LAUNCH_CHECK();
  return 0;
}

template <int LX, int LD, bool BF>
int dw(const Ctx& x, float* part, float* out, int I, int J, cudaStream_t st) {
  int P;
  long long chunk;
  dw_split(x.d, I, J, &P, &chunk);
  const size_t smem = 4 * dw_smem_floats<LX, LD>();
  dw_kernel<LX, LD, BF><<<dim3(cdiv(I, kDwT), cdiv(J, kDwT), P), kThreads, smem, st>>>(
      DwArgs{x, part, I, J, static_cast<int>(chunk)});
  LAUNCH_CHECK();
  const long long E = static_cast<long long>(I) * J;
  sum_partials_kernel<<<cdiv(E, kThreads), kThreads, 0, st>>>(part, out, P, E);
  LAUNCH_CHECK();
  return 0;
}

// The finalize kernels' scratch: the slices' sums and the per-block counters
// (zeroed once per entry; each finalize leaves them zero).
struct Fin {
  double* part2;
  unsigned* count;
};

dim3 fin_grid(long long P, int C) {
  const long long slices = P < kFinSlices ? P : kFinSlices;
  return dim3(static_cast<unsigned>(cdiv(C, 32)), static_cast<unsigned>(slices));
}

int finalize_fwd(const double* part, long long P, int C, const Dims& d, const Fin& f,
                 const float* gamma, const float* beta, float* mean, float* var, float* fold,
                 cudaStream_t st) {
  finalize_fwd_kernel<<<fin_grid(P, C), 32 * kFinWarps, 0, st>>>(
      part, static_cast<int>(P), C, static_cast<double>(d.R), f.part2, f.count, gamma, beta,
      mean, var, fold);
  LAUNCH_CHECK();
  return 0;
}

int finalize_bwd(const double* part, long long P, int C, const Dims& d, const Fin& f,
                 float* dgamma, float* dbeta, float* coef, cudaStream_t st) {
  finalize_bwd_kernel<<<fin_grid(P, C), 32 * kFinWarps, 0, st>>>(
      part, static_cast<int>(P), C, static_cast<double>(d.R), f.part2, f.count, dgamma, dbeta,
      coef);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

// Bytes of workspace that sa_train_fwd (backward = 0) or sa_train_bwd (1) needs
// in the mode bf16 (0 or 1).
extern "C" long long sa_train_workspace(int B, int N, int S, int K, int C1, int C2, int C3,
                                        int backward, int bf16) {
  Dims d;
  const int rc = check(B, N, S, K, C1, C2, C3, &d);
  if (rc) return rc;
  if (bf16 < 0 || bf16 > 1) return kErrArgs;
  return static_cast<long long>(layout(d, backward != 0, bf16 != 0).total);
}

// Floats of a k_in x n_out weight packed by ops/chain_fused.py::pack_chunks
// (bf16 = 1: pack_chunks_bf16).
extern "C" long long sa_train_packed_floats(int k_in, int n_out, int bf16) {
  if (k_in < 1 || n_out < 1 || bf16 < 0 || bf16 > 1) return kErrArgs;
  return packed_floats(k_in, n_out, bf16 != 0);
}

// Forward F1-F4. w2p, w3p: W2 (C1 x C2) and W3 (C2 x C3) packed (n2, n3
// floats); bn = [g1, bt1 (C1), g2, bt2 (C2), g3, bt3 (C3)]; stats (out) =
// [mean1, var1, mean2, var2, mean3, var3]; y2/y3 (out) the pre-BN grids (R x
// C2, C3) that the backward reads; out (B, S, C3). bf16 = 1: the bf16 mode
// (a rounded to bf16 by the caller, w2p/w3p packed in bf16); all f32 here.
extern "C" int sa_train_fwd(const float* a, const float* ct, const int* idx, const float* w2p,
                            long long n2, const float* b2, const float* w3p, long long n3,
                            const float* b3, const float* bn, float* y2, float* y3, float* out,
                            float* stats, void* ws, int B, int N, int S, int K, int C1, int C2,
                            int C3, int bf16, void* stream) {
  Dims d;
  RUN(check(B, N, S, K, C1, C2, C3, &d));
  if (bf16 < 0 || bf16 > 1) return kErrArgs;
  const bool bf = bf16 != 0;
  if (n2 != packed_floats(C1, C2, bf) || n3 != packed_floats(C2, C3, bf)) return kErrPacked;
  RUN(device_info().err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = layout(d, false, bf);
  char* base = static_cast<char*>(ws);
  double* part = reinterpret_cast<double*>(base + w.part);
  float* fold = reinterpret_cast<float*>(base + w.fold);
  const Fin fin{reinterpret_cast<double*>(base + w.part2),
                reinterpret_cast<unsigned*>(base + w.count)};
  cudaError_t e = cudaMemsetAsync(fin.count, 0, w.fold - w.count, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int Cm = cmax(d);
  const float *g1 = bn, *bt1 = bn + C1, *g2 = bn + 2 * C1, *bt2 = g2 + C2, *g3 = bt2 + C2,
              *bt3 = g3 + C3;
  float *mu1 = stats, *v1 = stats + C1, *mu2 = stats + 2 * C1, *v2 = mu2 + C2, *mu3 = v2 + C2,
        *v3 = mu3 + C3;
  Ctx x{};
  x.d = d;
  x.a = a;
  x.ct = ct;
  x.idx = idx;
  x.y2 = y2;
  for (int l = 0; l < 3; ++l) x.fold[l] = fold + 3 * Cm * l;
  x.mean[0] = mu1;
  x.mean[1] = mu2;
  x.mean[2] = mu3;

  // F1: y1's statistics, gathered
  y1_stats_kernel<<<dim3(cdiv(C1, 32), stat_chunks(d)), dim3(32, 8), 0, st>>>(x, part);
  LAUNCH_CHECK();
  RUN(finalize_fwd(part, stat_chunks(d), C1, d, fin, g1, bt1, mu1, v1, fold, st));
  // F2, F3: the products, their statistics from the epilogues
  RUN((bf ? rowmm<kLoadH1, kEpiBias, true>(x, w2p, b2, y2, part, C1, C2, st)
         : rowmm<kLoadH1, kEpiBias, false>(x, w2p, b2, y2, part, C1, C2, st)));
  RUN(finalize_fwd(part, row_tiles(d), C2, d, fin, g2, bt2, mu2, v2, fold + 3 * Cm, st));
  RUN((bf ? rowmm<kLoadH2, kEpiBias, true>(x, w3p, b3, y3, part, C2, C3, st)
         : rowmm<kLoadH2, kEpiBias, false>(x, w3p, b3, y3, part, C2, C3, st)));
  RUN(finalize_fwd(part, row_tiles(d), C3, d, fin, g3, bt3, mu3, v3, fold + 6 * Cm, st));
  // F4
  const long long BS = centroids(d);
  maxpool_kernel<<<cdiv(BS * C3, kThreads), kThreads, 0, st>>>(y3, fold + 6 * Cm, out, BS, K, C3);
  LAUNCH_CHECK();
  return 0;
}

// Backward B1-B4 from the forward's inputs a, ct, idx, its grids y2, y3 and
// statistics, and the output's cotangent g (B, S, C3). w2tp (n2 floats) and
// w3tp (n3) are W2^T (C2 x C1) and W3^T (C3 x C2) packed. Writes da (B, N,
// C1), dct (B, S, C1), dw2 (C1 x C2), dw3 (C2 x C3) and dbn = [dg1, dbt1, dg2,
// dbt2, dg3, dbt3]. bf16 = 1: the bf16 mode, as sa_train_fwd's.
extern "C" int sa_train_bwd(const float* g, const float* a, const float* ct, const int* idx,
                            const float* y2, const float* y3, const float* stats,
                            const float* w2tp, long long n2, const float* w3tp, long long n3,
                            const float* bn, float* da, float* dct, float* dw2, float* dw3,
                            float* dbn, void* ws, int B, int N, int S, int K, int C1, int C2,
                            int C3, int bf16, void* stream) {
  Dims d;
  RUN(check(B, N, S, K, C1, C2, C3, &d));
  if (bf16 < 0 || bf16 > 1) return kErrArgs;
  const bool bf = bf16 != 0;
  if (n2 != packed_floats(C2, C1, bf) || n3 != packed_floats(C3, C2, bf)) return kErrPacked;
  RUN(device_info().err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = layout(d, true, bf);
  char* base = static_cast<char*>(ws);
  double* part = reinterpret_cast<double*>(base + w.part);
  float* fold = reinterpret_cast<float*>(base + w.fold);
  const Fin fin{reinterpret_cast<double*>(base + w.part2),
                reinterpret_cast<unsigned*>(base + w.count)};
  cudaError_t e = cudaMemsetAsync(fin.count, 0, w.fold - w.count, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* coef = reinterpret_cast<float*>(base + w.coef);
  float* mx = reinterpret_cast<float*>(base + w.mx);
  float* sh = reinterpret_cast<float*>(base + w.sh);
  float* dwpart = reinterpret_cast<float*>(base + w.dwpart);
  void* dz2 = base + w.dz2;
  void* dz1 = base + w.dz1;
  const int Cm = cmax(d);
  const int Cs[3] = {C1, C2, C3};
  float* dbn_l[3] = {dbn, dbn + 2 * C1, dbn + 2 * (C1 + C2)};  // (dgamma, dbeta) of each layer
  Ctx x{};
  x.d = d;
  x.a = a;
  x.ct = ct;
  x.idx = idx;
  x.y2 = y2;
  x.y3 = y3;
  x.dz2 = dz2;
  x.mx3 = mx;
  x.sh3 = sh;
  const float* st_l = stats;
  const float* bn_l = bn;
  for (int l = 0; l < 3; ++l) {
    x.fold[l] = fold + 3 * Cm * l;
    x.coef[l] = coef + 2 * Cm * l;
    x.mean[l] = st_l;
    fold_kernel<<<cdiv(Cs[l], kThreads), kThreads, 0, st>>>(st_l, st_l + Cs[l], bn_l,
                                                             bn_l + Cs[l], fold + 3 * Cm * l, Cs[l]);
    LAUNCH_CHECK();
    st_l += 2 * Cs[l];
    bn_l += 2 * Cs[l];
  }
  float* coef_l[3] = {coef, coef + 2 * Cm, coef + 4 * Cm};
  // B1: the max, the tie shares and dz3's sums
  maxgrad_kernel<<<dim3(cdiv(C3, 32), cent_chunks(d)), dim3(32, 8), 0, st>>>(x, g, mx, sh, part);
  LAUNCH_CHECK();
  RUN(finalize_bwd(part, cent_chunks(d), C3, d, fin, dbn_l[2], dbn_l[2] + C3, coef_l[2], st));
  // B2: dW3 = h2^T dy3; dz2 = (dy3 W3^T) * relu'(h2) and its sums; dy3 from y3 as it loads
  RUN((bf ? dw<kLoadH2, kLoadDy3, true>(x, dwpart, dw3, C2, C3, st)
         : dw<kLoadH2, kLoadDy3, false>(x, dwpart, dw3, C2, C3, st)));
  RUN((bf ? rowmm<kLoadDy3, kEpiMaskY2, true>(x, w3tp, nullptr, dz2, part, C3, C2, st)
         : rowmm<kLoadDy3, kEpiMaskY2, false>(x, w3tp, nullptr, dz2, part, C3, C2, st)));
  RUN(finalize_bwd(part, row_tiles(d), C2, d, fin, dbn_l[1], dbn_l[1] + C2, coef_l[1], st));
  // B3: dW2 = h1^T dy2; dz1 = (dy2 W2^T) * relu'(h1) and its sums; dy2 from dz2 as it loads
  RUN((bf ? dw<kLoadH1, kLoadDy2, true>(x, dwpart, dw2, C1, C2, st)
         : dw<kLoadH1, kLoadDy2, false>(x, dwpart, dw2, C1, C2, st)));
  RUN((bf ? rowmm<kLoadDy2, kEpiMaskY1, true>(x, w2tp, nullptr, dz1, part, C2, C1, st)
         : rowmm<kLoadDy2, kEpiMaskY1, false>(x, w2tp, nullptr, dz1, part, C2, C1, st)));
  RUN(finalize_bwd(part, row_tiles(d), C1, d, fin, dbn_l[0], dbn_l[0] + C1, coef_l[0], st));
  // B4: da (zeroed here) += dy1 at idx; dct = sum_k dy1
  e = cudaMemsetAsync(da, 0, static_cast<size_t>(B) * N * C1 * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bf)
    scatter_kernel<true><<<cdiv(centroids(d) * C1, kThreads), kThreads, 0, st>>>(x, dz1, da, dct);
  else
    scatter_kernel<false><<<cdiv(centroids(d) * C1, kThreads), kThreads, 0, st>>>(x, dz1, da, dct);
  LAUNCH_CHECK();
  return 0;
}
