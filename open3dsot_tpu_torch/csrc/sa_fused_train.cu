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
//    order that changes from run to run, about K * 2^-24 of its magnitude);
//    under torch's deterministic algorithms the entry's `ordered` flag sums
//    each row of da in the order of r instead (k6_common.cuh::ordered_da).
//  - Widths. A row product keeps its per-channel vectors (folds, means, the
//    BN backward's coefficients, the bias) in shared memory beside its
//    stages, which leaves room for kin + nout up to about 900; a wider
//    product (GV) reads them from device memory, filled before it runs by
//    row_vectors_kernel, so any width runs and the narrower keep their plan.
//  - Rounding pinned where a decision depends on it: relu(y * s + t) with
//    __fmul_rn/__fadd_rn, s and t from 1 / sqrt(var + eps) rounded as IEEE
//    division and square root, the tie split g / cnt as IEEE division. The
//    plain version (ops/sa_fused_train.py) computes them in the same order,
//    so on the same grids the max masks, ties and ReLU masks agree bit for bit.
//
// The bf16 mode lives in sa_fused_train_bf16.cu; what both modes share is in
// k6_common.cuh. The eval rows path of K4/K5 (sa_rows_eval, at the end) runs
// on these row products too.
//
// Interface: plain C, loaded with ctypes; pointers are device pointers and
// the stream is PyTorch's current stream. The caller allocates outputs and
// the workspace (sa_train_workspace bytes). Returns 0, a CUDA error code, or
// a negative code for arguments the kernels do not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tc.cuh"  // kCC x kKC weight chunks, the TF32 split, mma.sync, wgmma, TMA
#include "k6_common.cuh"  // Dims, the BatchNorm arithmetic, y1's statistics, the finalizes
#include "ball_query.cuh"  // K4's ball query, for the eval rows path
#include "per_device.cuh"  // per_device: set-up once for each card

namespace {

constexpr int kErrArgs = -1;   // B, N, S, K or widths not accepted
constexpr int kErrWidth = -2;  // a width is not a multiple of 4
constexpr int kErrPacked = -3;  // a packed weight has the wrong size
constexpr int kThreads = 256;
constexpr int kTile = 128;         // rows of a row-product block: two warpgroups of 64
constexpr int kCent = 64;          // centroids of one partial of the max gradient pass
constexpr int kDwT = 128;          // dW block tile, I x J
constexpr int kDwRows = 32;        // rows of one dW step, its products summed apart
constexpr int kDwStride = kDwT + 8;  // floats between rows of a dW operand tile
constexpr int kWantBlocks = 264;   // dW: about two blocks per SM over the tiles

constexpr int kSmemMax = 232448;   // 227 KB, the most a block may take

// What a pass reads besides its own operands; per-channel vectors of layer l
// (width C_l) at [l].
struct Ctx {
  Dims d;
  const float* a;     // (B, N, C1)
  const float* ct;    // (B, S, C1)
  const int* idx;     // (B, S, K)
  const float* y2;    // (R, C2)
  const float* y3;    // (R, C3)
  const float* dz2;   // (R, C2)
  const float* mx3;   // (B * S, C3): max_k relu(BN3(y3))
  const float* sh3;   // (B * S, C3): g / number of tied maxima
  const float* fold[3];  // s, t, inv = 1 / sqrt(var + eps), each C_l
  const float* mean[3];
  const float* coef[3];  // sum dz / M, sum dz * yhat / M, each C_l
};

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float& el(float4& v, int j) { return (&v.x)[j]; }
__device__ __forceinline__ float el(const float4& v, int j) { return (&v.x)[j]; }

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

// Vectors of loader L for channels c0 .. c0 + Cv of its layer, zero past its
// width; elements i0, i0 + step, ... (a block's threads, or a grid's).
template <int L>
__device__ __forceinline__ void fill_vec(float* vec, const Ctx& x, int c0, int Cv, int i0,
                                         int step) {
  constexpr int l = layer_of<L>();
  const int C = width_of(x.d, l);
  for (int i = i0; i < n_vec<L>() * Cv; i += step) {
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fetch channels c..c+3 of a row into raw arrays dst, dst + stride, ... at offset o.
template <int L>
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
    cp_async16(dst + o, ok ? x.dz2 + ref + c : base, ok);
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
// and aux from aux_at. RB (the forward loaders of the eval rows path in its
// bf16 mode): a rounded to bf16 as it is read, and the operand rounded to bf16.
template <int L, bool RB = false>
__device__ __forceinline__ float4 transform(const float* src, int stride, int o, const float* vec,
                                            int Cv, int cl, const Aux& aux) {
  const float4 s = *reinterpret_cast<const float4*>(vec + cl);
  const float4 t = *reinterpret_cast<const float4*>(vec + Cv + cl);
  float4 u = *reinterpret_cast<const float4*>(src + o), out;
  if constexpr (L == kLoadH1 || L == kLoadH2) {
    if constexpr (L == kLoadH1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        el(u, j) = __fadd_rn(RB ? round_bf16(el(u, j)) : el(u, j), el(aux.a, j));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      el(out, j) = fold_relu(el(u, j), el(s, j), el(t, j));
      if (RB) el(out, j) = round_bf16(el(out, j));
    }
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
      }
    } else {
      dz = u;
      y = *reinterpret_cast<const float4*>(src + stride + o);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      el(out, j) = bn_bwd(el(dz, j), yhat_of(el(y, j), el(mu, j), el(inv, j)), el(s, j),
                          el(c1, j), el(c2, j));
  }
  return out;
}

// ---- row products on the tensor cores --------------------------------------
enum Epi { kEpiBias, kEpiMaskY2, kEpiMaskY1 };

struct RowArgs {
  Ctx x;
  const float* w;     // the product's weight, packed (ops/chain_fused.py::pack_chunks)
  const float* bias;  // kEpiBias: (nout)
  float* out;         // (R, nout)
  double* part;       // (tiles, 2, nout): the epilogue's sums
  float* gvec;        // GV: the loader's then the epilogue's vectors in device memory
  int kin, nout, nk, nc;  // widths; input and output chunks
  int kinp, noutp;        // widths padded to whole chunks
  int tiles;              // 128-row tiles
};

constexpr int kAStage = 2 * kTile * kKC;  // floats of one A chunk in shared memory: hi, then lo
constexpr int kAPart = kTile * kKC;
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

// Floats of the per-channel vectors of a row product: the loader's (n_vec x
// kinp), then the epilogue's (bias, or s, t, inv, mean: 4 x noutp).
template <int L>
__host__ __device__ constexpr long long row_vec_floats(int kinp, int noutp) {
  return static_cast<long long>(n_vec<L>()) * kinp + 4LL * noutp;
}

// rowmm_kernel's shared memory in floats: two weight stages, two A stages, two
// raw stages, the epilogue's sums, the vectors (not with GV: then they are
// read from device memory, so that no width is too wide), eight mbarriers.
template <int L>
constexpr long long row_smem_floats(int kinp, int noutp, bool gv) {
  return 2LL * kWStage + 2 * kAStage + 2LL * n_raw<L>() * kRaw + kRed +
         (gv ? 0 : row_vec_floats<L>(kinp, noutp)) + 16;
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
template <int E>
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
        *reinterpret_cast<float2*>(p.out + oe) = make_float2(v[0], v[1]);
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

// The vectors of a row product (row_vec_floats): loader L's, then epilogue
// E's (bias, or s, t, inv, mean of the output layer); elements i0, i0 + step, ...
template <int L, int E>
__device__ __forceinline__ void fill_vectors(const RowArgs& p, float* vec, int i0, int step) {
  const Ctx& x = p.x;
  fill_vec<L>(vec, x, 0, p.kinp, i0, step);
  float* evec = vec + n_vec<L>() * p.kinp;
  for (int i = i0; i < 4 * p.noutp; i += step) {
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
}

// The vectors of a GV row product into p.gvec, before it runs.
template <int L, int E>
__global__ void row_vectors_kernel(const RowArgs p) {
  fill_vectors<L, E>(p, p.gvec, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
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
// GV: the per-channel vectors are read from device memory (p.gvec, filled by
// row_vectors_kernel) where in shared memory they would not fit beside the
// stages (kin + nout above about 900). RB: the loader rounds to bf16 (the
// eval rows path's bf16 mode, transform).
template <int L, int E, bool GV, bool RB>
__global__ void __launch_bounds__(kRowThreads, 1) rowmm_kernel(const RowArgs p) {
  constexpr int NR = n_raw<L>();
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  float* asm0 = wsm + 2 * kWStage;
  float* raw0 = asm0 + 2 * kAStage;
  double* red = reinterpret_cast<double*>(raw0 + 2 * NR * kRaw);
  float* vec = GV ? p.gvec : raw0 + 2 * NR * kRaw + kRed;
  float* evec = vec + n_vec<L>() * p.kinp;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      raw0 + 2 * NR * kRaw + kRed + (GV ? 0 : row_vec_floats<L>(p.kinp, p.noutp)));
  uint64_t *wfull = bars, *wempty = bars + 2, *afull = bars + 4, *aempty = bars + 6;
  const Ctx& x = p.x;
  const int R = static_cast<int>(x.d.R);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_tile = p.nc * p.nk;
  const int U = (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * per_tile;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], kConsumerWarps);
      mbar_init(&afull[i], kProducerThreads);
      mbar_init(&aempty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!GV) fill_vectors<L, E>(p, vec, tid, blockDim.x);
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
          fetch_raw<L>(x, st, kRaw, (pt + kProducerThreads * i) * 4, ref[i], c,
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
        bulk_load(wsm + s * kWStage, p.w + static_cast<long long>(t_in_tile) * kWStage, &wfull[s]);
      cp_async_wait<1>();  // this thread's copies of chunk v have landed
      const float* st = raw0 + s * NR * kRaw;
      float* ah = asm0 + s * kAStage;
      const int cl = t_kb * kKC + ec;
#pragma unroll 4
      for (int i = 0; i < kPE; ++i) {
        const int row = rl + kRowStep * i;
        const float4 a = transform<L, RB>(st, kRaw, (pt + kProducerThreads * i) * 4, vec,
                                          p.kinp, cl, aux_at<L>(x, cent[i], cl));
        uint32_t h[4], l[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(el(a, j), h[j], l[j]);
        const int o = wofs(row, ec);
        st4(ah + o, make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                __uint_as_float(h[2]), __uint_as_float(h[3])));
        st4(ah + kAPart + o, make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                         __uint_as_float(l[2]), __uint_as_float(l[3])));
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
    {
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
      row_epilogue<E>(p, acc, tile, cb, red, evec);
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

// The value split hi/lo (TF32) into hi + o and lo + o.
__device__ __forceinline__ void store_split(float* hi, float* lo, int o, float4 v) {
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
// i0 + 64 wi .. and columns j0 + 32 wj .. of the tile.
template <int LX, int LD>
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

  fill_vec<LX>(vx, x, i0, kDwT, tid, blockDim.x);
  fill_vec<LD>(vd, x, j0, kDwT, tid, blockDim.x);
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
        fetch_raw<LX>(x, st, kDwRaw, o, row_ref<LX>(x, r, j), i0 + ec,
                          inx && (LX != kLoadH1 || (j >= 0 && j < x.d.N)));
        fetch_aux<LX>(x, st + NX * kDwRaw, kDwRaw, o, aux_cent<LX>(x.d, r), i0 + ec, inx);
        fetch_raw<LD>(x, st + AX * kDwRaw, kDwRaw, o, row_ref<LD>(x, r, 0), j0 + ec, ind);
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
        store_split(xh, xl, ot, in ? transform<LX>(st, kDwRaw, o, vx, kDwT, ec, ax) : zero);
        store_split(dh, dl, ot,
                    in ? transform<LD>(st + AX * kDwRaw, kDwRaw, o, vd, kDwT, ec, ad) : zero);
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
// centroid lanes; grid (C3 / 32, up to kMaxGridY), block y taking partials y,
// y + gridDim.y, ...
__device__ __forceinline__ void maxgrad_chunk(const Ctx& x, const float* __restrict__ g,
                                              float* __restrict__ mx3, float* __restrict__ sh3,
                                              double* __restrict__ part, long long chunk) {
  __shared__ double sh[2][8][33];
  const int tx = threadIdx.x, ty = threadIdx.y, C = x.d.C3, K = x.d.K;
  const long long BS = static_cast<long long>(x.d.B) * x.d.S;
  const int c = blockIdx.x * 32 + tx;
  double s1 = 0.0, s2 = 0.0;
  if (c < C) {
    const float s = x.fold[2][c], t = x.fold[2][C + c], inv = x.fold[2][2 * C + c];
    const float mu = x.mean[2][c];
    for (int i = 0; i < kCent / 8; ++i) {
      const long long bs = chunk * kCent + ty + 8 * i;
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
    part[(chunk * 2) * C + c] = a;
    part[(chunk * 2 + 1) * C + c] = b;
  }
  __syncthreads();  // sh is read before the next partial writes it
}

__global__ void maxgrad_kernel(const Ctx x, const float* __restrict__ g, float* __restrict__ mx3,
                               float* __restrict__ sh3, double* __restrict__ part) {
  const long long chunks = (static_cast<long long>(x.d.B) * x.d.S + kCent - 1) / kCent;
  for (long long chunk = blockIdx.y; chunk < chunks; chunk += gridDim.y)
    maxgrad_chunk(x, g, mx3, sh3, part, chunk);
}

// ---- B4: dy1 = BN backward of dz1; da[b, idx[r]] += dy1[r]; dct[bs] = sum_k dy1.
// ORDERED: dy1 is written over dz1 for ordered_da (k6_common.cuh), no atomics.
template <bool ORDERED>
__global__ void scatter_kernel(const Ctx x, float* __restrict__ dz1, float* __restrict__ da,
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
    const float v = bn_bwd(dz1[r * d.C1 + c], yhat_of(y1, mu, inv), s, c1, c2);
    acc += v;
    if (ORDERED)
      dz1[r * d.C1 + c] = v;
    else if (in)
      atomicAdd(da + row, v);
  }
  dct[e] = acc;
}

// ---- host side ---------------------------------------------------------------
inline int round8(int n) { return (n + 7) & ~7; }

int cmax(const Dims& d) { return d.C1 > d.C2 ? (d.C1 > d.C3 ? d.C1 : d.C3) : (d.C2 > d.C3 ? d.C2 : d.C3); }
long long centroids(const Dims& d) { return static_cast<long long>(d.B) * d.S; }
long long row_tiles(const Dims& d) { return cdiv(d.R, kTile); }
long long stat_chunks(const Dims& d) { return cdiv(d.R, kStatRows); }
long long cent_chunks(const Dims& d) { return cdiv(centroids(d), kCent); }

// Floats of a weight (k_in x n_out) packed as whole kCC x kKC chunks, hi and
// lo (3xTF32).
long long packed_floats(int k_in, int n_out) {
  return cdiv(round8(n_out), kCC) * cdiv(round8(k_in), kKC) * kWStage;
}

int pad_in(int kin) { return static_cast<int>(cdiv(round8(kin), kKC)) * kKC; }
int pad_out(int nout) { return static_cast<int>(cdiv(round8(nout), kCC)) * kCC; }

// Whether a row product kin -> nout with loader L reads its vectors from
// device memory (GV): where in shared memory they do not fit.
template <int L>
bool row_gv(int kin, int nout) {
  return 4 * row_smem_floats<L>(pad_in(kin), pad_out(nout), false) > kSmemMax;
}

// Bytes of shared memory of a row product kin -> nout with loader L.
template <int L>
long long row_smem(int kin, int nout) {
  return 4 * row_smem_floats<L>(pad_in(kin), pad_out(nout), row_gv<L>(kin, nout));
}

// Floats of device memory for the vectors of any row product of widths up to C.
long long vec_floats(int C) { return row_vec_floats<kLoadDy3>(pad_in(C), pad_out(C)); }

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
  size_t part, part2, count, fold, vec, coef, mx, sh, dwpart, dz2, dz1, ordered, total;
};

Workspace layout(const Dims& d, bool backward) {
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
  w.vec = take(static_cast<size_t>(vec_floats(static_cast<int>(C))) * sizeof(float));
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
    w.dz2 = take(static_cast<size_t>(d.R) * d.C2 * sizeof(float));
    w.dz1 = take(static_cast<size_t>(d.R) * d.C1 * sizeof(float));
    w.ordered = take(ordered_ints(d) * sizeof(int));
  }
  w.total = off;
  return w;
}

int check(int B, int N, int S, int K, int C1, int C2, int C3, Dims* d) {
  if (B < 1 || N < 1 || S < 1 || K < 1 || C1 < 1 || C2 < 1 || C3 < 1) return kErrArgs;
  if (C1 % 4 || C2 % 4 || C3 % 4) return kErrWidth;
  *d = Dims{static_cast<long long>(B) * S * K, B, N, S, K, C1, C2, C3};
  // rows are 32-bit in the kernels, with a tile's worth to spare
  if (d->R > 0x7fffffffLL - kTile) return kErrArgs;
  int P;
  long long ch;
  dw_split(*d, d->C2, d->C3, &P, &ch);  // the larger split of the two dW
  if (P > 65535) return kErrArgs;
  // every width fits: a product whose vectors would not reads them from device memory
  return 0;
}

// The SM count and the kernels' shared-memory limit, once per device.
struct DeviceInfo {
  int sms;
  int err;
};

const DeviceInfo& device_info() {
  return per_device<DeviceInfo>([](int dev) {
    DeviceInfo d{132, 0};
    cudaError_t e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    const void* kernels[] = {
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH1, kEpiBias, false, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH2, kEpiBias, false, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadDy3, kEpiMaskY2, false, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadDy2, kEpiMaskY1, false, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH1, kEpiBias, true, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH2, kEpiBias, true, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadDy3, kEpiMaskY2, true, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadDy2, kEpiMaskY1, true, false>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH1, kEpiBias, false, true>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH2, kEpiBias, false, true>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH1, kEpiBias, true, true>),
        reinterpret_cast<const void*>(rowmm_kernel<kLoadH2, kEpiBias, true, true>),
        reinterpret_cast<const void*>(dw_kernel<kLoadH2, kLoadDy3>),
        reinterpret_cast<const void*>(dw_kernel<kLoadH1, kLoadDy2>)};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    d.err = static_cast<int>(e);
    return d;
  });
}

// A row product; vec: device memory for its vectors (vec_floats) should they
// not fit in shared memory. RB: the eval rows path's bf16 loaders.
template <int L, int E, bool RB = false>
int rowmm(const Ctx& x, const float* w, const float* bias, float* out, double* part, int kin,
          int nout, float* vec, cudaStream_t st) {
  const int nk = static_cast<int>(cdiv(round8(kin), kKC));
  const int nc = static_cast<int>(cdiv(round8(nout), kCC));
  const RowArgs p{x, w, bias, out, part, vec, kin, nout, nk, nc, nk * kKC, nc * kCC,
                    static_cast<int>(row_tiles(x.d))};
  const int sms = device_info().sms;
  const unsigned blocks = static_cast<unsigned>(p.tiles < sms ? p.tiles : sms);
  const size_t smem = static_cast<size_t>(row_smem<L>(kin, nout));
  if (row_gv<L>(kin, nout)) {
    const long long n = row_vec_floats<L>(p.kinp, p.noutp);
    row_vectors_kernel<L, E><<<cdiv(n, kThreads), kThreads, 0, st>>>(p);
    LAUNCH_CHECK();
    rowmm_kernel<L, E, true, RB><<<blocks, kRowThreads, smem, st>>>(p);
  } else {
    rowmm_kernel<L, E, false, RB><<<blocks, kRowThreads, smem, st>>>(p);
  }
  LAUNCH_CHECK();
  return 0;
}

template <int LX, int LD>
int dw(const Ctx& x, float* part, float* out, int I, int J, cudaStream_t st) {
  int P;
  long long chunk;
  dw_split(x.d, I, J, &P, &chunk);
  const size_t smem = 4 * dw_smem_floats<LX, LD>();
  dw_kernel<LX, LD><<<dim3(cdiv(I, kDwT), cdiv(J, kDwT), P), kThreads, smem, st>>>(
      DwArgs{x, part, I, J, static_cast<int>(chunk)});
  LAUNCH_CHECK();
  const long long E = static_cast<long long>(I) * J;
  sum_partials_kernel<<<cdiv(E, kThreads), kThreads, 0, st>>>(part, out, P, E);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

// Bytes of workspace that sa_train_fwd (backward = 0) or sa_train_bwd (1) needs.
extern "C" long long sa_train_workspace(int B, int N, int S, int K, int C1, int C2, int C3,
                                        int backward) {
  Dims d;
  const int rc = check(B, N, S, K, C1, C2, C3, &d);
  if (rc) return rc;
  return static_cast<long long>(layout(d, backward != 0).total);
}

// Floats of a k_in x n_out weight packed by ops/chain_fused.py::pack_chunks.
extern "C" long long sa_train_packed_floats(int k_in, int n_out) {
  if (k_in < 1 || n_out < 1) return kErrArgs;
  return packed_floats(k_in, n_out);
}

// The forward, in one call (sg.stage < 0) or one stage of it.
static int fwd_impl(const float* a, const float* ct, const int* idx, const float* w2p,
                    long long n2, const float* b2, const float* w3p, long long n3,
                    const float* b3, const float* bn, float* y2, float* y3, float* out,
                    float* stats, void* ws, int B, int N, int S, int K, int C1, int C2, int C3,
                    const Staging& sg, void* stream) {
  Dims d;
  RUN(check(B, N, S, K, C1, C2, C3, &d));
  if (n2 != packed_floats(C1, C2) || n3 != packed_floats(C2, C3)) return kErrPacked;
  RUN(device_info().err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = layout(d, false);
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

  const auto in = [&](int k) { return sg.stage < 0 || sg.stage == k; };
  bool stop = false;
  // F1: y1's statistics, gathered
  if (in(0)) {
    y1_stats_kernel<false><<<dim3(cdiv(C1, 32), grid_y(stat_chunks(d))), dim3(32, 8), 0, st>>>(a, ct, idx,
                                                                                        d, part);
    LAUNCH_CHECK();
  }
  RUN(sync_fwd(sg, 0, part, stat_chunks(d), C1, d, fin, g1, bt1, mu1, v1, fold, st, &stop));
  if (stop) return 0;
  // F2, F3: the products, their statistics from the epilogues
  float* vec = reinterpret_cast<float*>(base + w.vec);
  if (in(1)) RUN((rowmm<kLoadH1, kEpiBias>(x, w2p, b2, y2, part, C1, C2, vec, st)));
  RUN(sync_fwd(sg, 1, part, row_tiles(d), C2, d, fin, g2, bt2, mu2, v2, fold + 3 * Cm, st,
               &stop));
  if (stop) return 0;
  if (in(2)) RUN((rowmm<kLoadH2, kEpiBias>(x, w3p, b3, y3, part, C2, C3, vec, st)));
  RUN(sync_fwd(sg, 2, part, row_tiles(d), C3, d, fin, g3, bt3, mu3, v3, fold + 6 * Cm, st,
               &stop));
  if (stop) return 0;
  // F4
  const long long BS = centroids(d);
  maxpool_kernel<<<cdiv(BS * C3, kThreads), kThreads, 0, st>>>(y3, fold + 6 * Cm, out, BS, K, C3);
  LAUNCH_CHECK();
  return 0;
}

// Forward F1-F4. w2p, w3p: W2 (C1 x C2) and W3 (C2 x C3) packed (n2, n3
// floats); bn = [g1, bt1 (C1), g2, bt2 (C2), g3, bt3 (C3)]; stats (out) =
// [mean1, var1, mean2, var2, mean3, var3]; y2/y3 (out) the pre-BN grids (R x
// C2, C3) that the backward reads; out (B, S, C3).
extern "C" int sa_train_fwd(const float* a, const float* ct, const int* idx, const float* w2p,
                            long long n2, const float* b2, const float* w3p, long long n3,
                            const float* b3, const float* bn, float* y2, float* y3, float* out,
                            float* stats, void* ws, int B, int N, int S, int K, int C1, int C2,
                            int C3, void* stream) {
  return fwd_impl(a, ct, idx, w2p, n2, b2, w3p, n3, b3, bn, y2, y3, out, stats, ws, B, N, S, K, C1,
                  C2, C3, Staging{-1, nullptr}, stream);
}

// sa_train_fwd in stages 0-3 (k6_common.cuh, Staging): the same arguments
// and workspace at every stage, and sums (2 * max(C1, C2, C3) + 1 doubles).
extern "C" int sa_train_fwd_staged(const float* a, const float* ct, const int* idx,
                                   const float* w2p, long long n2, const float* b2,
                                   const float* w3p, long long n3, const float* b3,
                                   const float* bn, float* y2, float* y3, float* out, float* stats,
                                   void* ws, int B, int N, int S, int K, int C1, int C2, int C3,
                                   int stage, double* sums, void* stream) {
  if (stage < 0 || stage > 3) return kErrArgs;
  return fwd_impl(a, ct, idx, w2p, n2, b2, w3p, n3, b3, bn, y2, y3, out, stats, ws, B, N, S, K, C1,
                  C2, C3, Staging{stage, sums}, stream);
}

// The backward, in one call (sg.stage < 0) or one stage of it.
static int bwd_impl(const float* g, const float* a, const float* ct, const int* idx,
                    const float* y2, const float* y3, const float* stats, const float* w2tp,
                    long long n2, const float* w3tp, long long n3, const float* bn, float* da,
                    float* dct, float* dw2, float* dw3, float* dbn, void* ws, int B, int N, int S,
                    int K, int C1, int C2, int C3, int ordered, const Staging& sg,
                    void* stream) {
  Dims d;
  RUN(check(B, N, S, K, C1, C2, C3, &d));
  if (n2 != packed_floats(C2, C1) || n3 != packed_floats(C3, C2)) return kErrPacked;
  RUN(device_info().err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = layout(d, true);
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
  float* dz2 = reinterpret_cast<float*>(base + w.dz2);
  float* dz1 = reinterpret_cast<float*>(base + w.dz1);
  float* vec = reinterpret_cast<float*>(base + w.vec);
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
  const auto in = [&](int k) { return sg.stage < 0 || sg.stage == k; };
  bool stop = false;
  const float* st_l = stats;
  const float* bn_l = bn;
  for (int l = 0; l < 3; ++l) {
    x.fold[l] = fold + 3 * Cm * l;
    x.coef[l] = coef + 2 * Cm * l;
    x.mean[l] = st_l;
    if (in(0)) {
      fold_kernel<<<cdiv(Cs[l], kThreads), kThreads, 0, st>>>(st_l, st_l + Cs[l], bn_l,
                                                               bn_l + Cs[l], fold + 3 * Cm * l,
                                                               Cs[l]);
      LAUNCH_CHECK();
    }
    st_l += 2 * Cs[l];
    bn_l += 2 * Cs[l];
  }
  float* coef_l[3] = {coef, coef + 2 * Cm, coef + 4 * Cm};
  // B1: the max, the tie shares and dz3's sums
  if (in(0)) {
    maxgrad_kernel<<<dim3(cdiv(C3, 32), grid_y(cent_chunks(d))), dim3(32, 8), 0, st>>>(x, g, mx, sh,
                                                                                     part);
    LAUNCH_CHECK();
  }
  RUN(sync_bwd(sg, 0, part, cent_chunks(d), C3, d, fin, dbn_l[2], dbn_l[2] + C3, coef_l[2], st,
               &stop));
  if (stop) return 0;
  // B2: dW3 = h2^T dy3; dz2 = (dy3 W3^T) * relu'(h2) and its sums; dy3 from y3 as it loads
  if (in(1)) {
    RUN((dw<kLoadH2, kLoadDy3>(x, dwpart, dw3, C2, C3, st)));
    RUN((rowmm<kLoadDy3, kEpiMaskY2>(x, w3tp, nullptr, dz2, part, C3, C2, vec, st)));
  }
  RUN(sync_bwd(sg, 1, part, row_tiles(d), C2, d, fin, dbn_l[1], dbn_l[1] + C2, coef_l[1], st,
               &stop));
  if (stop) return 0;
  // B3: dW2 = h1^T dy2; dz1 = (dy2 W2^T) * relu'(h1) and its sums; dy2 from dz2 as it loads
  if (in(2)) {
    RUN((dw<kLoadH1, kLoadDy2>(x, dwpart, dw2, C1, C2, st)));
    RUN((rowmm<kLoadDy2, kEpiMaskY1>(x, w2tp, nullptr, dz1, part, C2, C1, vec, st)));
  }
  RUN(sync_bwd(sg, 2, part, row_tiles(d), C1, d, fin, dbn_l[0], dbn_l[0] + C1, coef_l[0], st,
               &stop));
  if (stop) return 0;
  // B4: dct = sum_k dy1; da = the sum of dy1 at idx, in a fixed order or by atomics
  const unsigned blocks = static_cast<unsigned>(cdiv(centroids(d) * C1, kThreads));
  if (ordered) {
    scatter_kernel<true><<<blocks, kThreads, 0, st>>>(x, dz1, da, dct);
    LAUNCH_CHECK();
    return ordered_da(d, idx, dz1, C1, ordered_at(d, base + w.ordered), da, st);
  }
  e = cudaMemsetAsync(da, 0, static_cast<size_t>(B) * N * C1 * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<false><<<blocks, kThreads, 0, st>>>(x, dz1, da, dct);
  LAUNCH_CHECK();
  return 0;
}

// Backward B1-B4 from the forward's inputs a, ct, idx, its grids y2, y3 and
// statistics, and the output's cotangent g (B, S, C3). w2tp (n2 floats) and
// w3tp (n3) are W2^T (C2 x C1) and W3^T (C3 x C2) packed. Writes da (B, N,
// C1), dct (B, S, C1), dw2 (C1 x C2), dw3 (C2 x C3) and dbn = [dg1, dbt1, dg2,
// dbt2, dg3, dbt3]. ordered != 0: da summed in a fixed order (ordered_da),
// else by float atomics.
extern "C" int sa_train_bwd(const float* g, const float* a, const float* ct, const int* idx,
                            const float* y2, const float* y3, const float* stats,
                            const float* w2tp, long long n2, const float* w3tp, long long n3,
                            const float* bn, float* da, float* dct, float* dw2, float* dw3,
                            float* dbn, void* ws, int B, int N, int S, int K, int C1, int C2,
                            int C3, int ordered, void* stream) {
  return bwd_impl(g, a, ct, idx, y2, y3, stats, w2tp, n2, w3tp, n3, bn, da, dct, dw2, dw3, dbn, ws,
                  B, N, S, K, C1, C2, C3, ordered, Staging{-1, nullptr}, stream);
}

// sa_train_bwd in stages 0-3 (k6_common.cuh, Staging), as sa_train_fwd_staged.
extern "C" int sa_train_bwd_staged(const float* g, const float* a, const float* ct,
                                   const int* idx, const float* y2, const float* y3,
                                   const float* stats, const float* w2tp, long long n2,
                                   const float* w3tp, long long n3, const float* bn, float* da,
                                   float* dct, float* dw2, float* dw3, float* dbn, void* ws, int B,
                                   int N, int S, int K, int C1, int C2, int C3, int ordered,
                                   int stage, double* sums, void* stream) {
  if (stage < 0 || stage > 3) return kErrArgs;
  return bwd_impl(g, a, ct, idx, y2, y3, stats, w2tp, n2, w3tp, n3, bn, da, dct, dw2, dw3, dbn, ws,
                  B, N, S, K, C1, C2, C3, ordered, Staging{stage, sums}, stream);
}

namespace {

// ---- the eval rows path of K4/K5 ----------------------------------------------
// K4/K5 (sa_fused.cu, sa_fused_bf16.cu) hold a 64-row tile of whole centroids
// and its layer-2 activations in shared memory, which takes K <= 64 and widths
// whose tiles fit. Every other shape runs here, on the row products above with
// the BatchNorm folds set to the identity (s = 1, t = 0: relu(y * 1 + 0) is
// relu(y) exactly): y2 = relu(A[idx] + ct) W2 + b2 over all R = B S K rows
// (the A-form rows gathered by the loader, ct computed first as K4 computes
// it), y3 = relu(y2) W3 + b3, then out = max_k relu(y3) a centroid, NaN where
// an index lies outside [0, N). Any K, any width: a centroid's rows span as
// many 128-row tiles as they need and its max is taken over all of them from
// y3, and a product whose vectors do not fit in shared memory reads them from
// device memory (GV). The bf16 mode (RB) rounds as sa_fused_bf16.cu does: A as
// it is gathered, h1 and h2 to bf16 (the row products then multiply bf16
// values exactly in 3xTF32, from weights rounded to bf16 before they are
// packed), the output to bf16. The epilogues' BatchNorm sums are computed and
// not read.

// ct[bs, c] = b1 - ((x W1x0 + y W1x1) + z W1x2), (x, y, z) the centroid times
// inv_r (K4's order), b1 where layer 1 reads no xyz; and the identity folds
// (s = 1, t = 0) of layers 1 and 2.
__global__ void rows_setup_kernel(const float* __restrict__ centers, const float* __restrict__ w1x,
                                  const float* __restrict__ b1, float* __restrict__ ct,
                                  float* __restrict__ fold, long long BS, int C1, int C2, int Cf,
                                  float inv_r) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < BS * C1;
       e += step) {
    const long long bs = e / C1;
    const int c = static_cast<int>(e - bs * C1);
    float v = __ldg(b1 + c);
    if (w1x) {
      const float* cp = centers + bs * 3;
      const float x = __fmul_rn(cp[0], inv_r), y = __fmul_rn(cp[1], inv_r),
                  z = __fmul_rn(cp[2], inv_r);
      v = __fsub_rn(v, __fmaf_rn(z, __ldg(w1x + 2 * C1 + c),
                                 __fmaf_rn(y, __ldg(w1x + C1 + c), __fmul_rn(x, __ldg(w1x + c)))));
    }
    ct[e] = v;
  }
  // layer l's (s, t, inv), each C_l wide, from fold + 3 Cf l
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < 6LL * Cf;
       e += step)
    fold[e] = (e % (3LL * Cf)) < (e < 3LL * Cf ? C1 : C2) ? 1.f : 0.f;
}

// out[bs, c] = max_k relu(y3[bs K + k, c]), NaN where an index of centroid bs
// lies outside [0, N); BF: as bf16 bits.
template <bool BF>
__global__ void rows_max_kernel(const float* __restrict__ y3, const int* __restrict__ idx,
                                void* __restrict__ out, long long BS, int K, int C, int N) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= BS * C) return;
  const long long bs = e / C;
  const int c = static_cast<int>(e - bs * C);
  float m = 0.f;  // every value is a ReLU output, so >= 0
  bool bad = false;
  for (int k = 0; k < K; ++k) {
    const int j = __ldg(idx + bs * K + k);
    bad |= !(j >= 0 && j < N);
    m = fmaxf(m, y3[(bs * K + k) * C + c]);
  }
  if constexpr (BF)
    static_cast<uint16_t*>(out)[e] = bad ? static_cast<uint16_t>(0x7fc0) : bf16_bits(m);
  else
    static_cast<float*>(out)[e] = bad ? __int_as_float(0x7fc00000) : m;
}

struct RowsWorkspace {  // byte offsets into one buffer
  size_t idx, ct, fold, part, vec, y2, y3, total;
};

RowsWorkspace rows_layout(const Dims& d) {
  RowsWorkspace w{};
  const int C = cmax(d);
  size_t off = 0;
  const auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  w.idx = take(static_cast<size_t>(d.R) * sizeof(int));
  w.ct = take(static_cast<size_t>(centroids(d)) * d.C1 * sizeof(float));
  w.fold = take(6 * static_cast<size_t>(C) * sizeof(float));
  w.part = take(static_cast<size_t>(row_tiles(d)) * 2 * C * sizeof(double));
  w.vec = take(static_cast<size_t>(vec_floats(C)) * sizeof(float));
  w.y2 = take(static_cast<size_t>(d.R) * d.C2 * sizeof(float));
  w.y3 = take(static_cast<size_t>(d.R) * d.C3 * sizeof(float));
  w.total = off;
  return w;
}

int rows_check(int B, int N, int S, int K, int C1, int C2, int C3, Dims* d) {
  if (B < 1 || B > 65535 || N < 1 || S < 1 || K < 1 || C1 < 1 || C2 < 1 || C3 < 1) return kErrArgs;
  if (C1 % 4 || C2 % 4 || C3 % 4) return kErrWidth;
  *d = Dims{static_cast<long long>(B) * S * K, B, N, S, K, C1, C2, C3};
  // rows are 32-bit in the kernels, with a tile's worth to spare
  if (d->R > 0x7fffffffLL - kTile) return kErrArgs;
  return 0;
}

}  // namespace

// Bytes of workspace that sa_rows_eval needs, or a negative error code.
extern "C" long long sa_rows_workspace(int B, int N, int S, int K, int C1, int C2, int C3) {
  Dims d;
  const int rc = rows_check(B, N, S, K, C1, C2, C3, &d);
  if (rc) return rc;
  return static_cast<long long>(rows_layout(d).total);
}

// K4/K5 by row products (the note above), for the shapes sa_fused_k4 and
// sa_fused_k4_bf16 do not take. Arguments as theirs, with w2p, w3p packed by
// pack_chunks (of the weights rounded to bf16 in the bf16 mode), ws the
// workspace (sa_rows_workspace bytes) and bf16 the mode: out is (B, S, C3) f32,
// or bf16 where bf16 != 0. idx == nullptr: the ball query (r2) gives the
// indices; otherwise idx (B, S, K) is K5's.
extern "C" int sa_rows_eval(const float* xyz, const float* centers, const int* idx,
                            const float* a_rows, const float* w1x, const float* b1,
                            const float* w2p, long long n2, const float* b2, const float* w3p,
                            long long n3, const float* b3, void* out, void* ws, int B, int N,
                            int S, int K, int C1, int C2, int C3, float r2, float inv_r, int bf16,
                            void* stream) {
  Dims d;
  RUN(rows_check(B, N, S, K, C1, C2, C3, &d));
  if (!centers || !a_rows || !b1 || (!idx && !xyz)) return kErrArgs;
  if (n2 != packed_floats(C1, C2) || n3 != packed_floats(C2, C3)) return kErrPacked;
  RUN(device_info().err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowsWorkspace w = rows_layout(d);
  char* base = static_cast<char*>(ws);
  int* idx_ws = reinterpret_cast<int*>(base + w.idx);
  float* ct = reinterpret_cast<float*>(base + w.ct);
  float* fold = reinterpret_cast<float*>(base + w.fold);
  double* part = reinterpret_cast<double*>(base + w.part);
  float* vec = reinterpret_cast<float*>(base + w.vec);
  float* y2 = reinterpret_cast<float*>(base + w.y2);
  float* y3 = reinterpret_cast<float*>(base + w.y3);
  if (!idx) {
    bq_kernel<<<dim3(static_cast<unsigned>(cdiv(S, kBqThreads / 32)), B), kBqThreads, 0, st>>>(
        xyz, centers, idx_ws, N, S, K, r2);
    LAUNCH_CHECK();
    idx = idx_ws;
  }
  const int Cm = cmax(d);
  const long long BS = centroids(d);
  const long long setup = cdiv(BS * C1 > 6LL * Cm ? BS * C1 : 6LL * Cm, kThreads);
  rows_setup_kernel<<<static_cast<unsigned>(setup < 4096 ? setup : 4096), kThreads, 0, st>>>(
      centers, w1x, b1, ct, fold, BS, C1, C2, Cm, inv_r);
  LAUNCH_CHECK();
  Ctx x{};
  x.d = d;
  x.a = a_rows;
  x.ct = ct;
  x.idx = idx;
  x.y2 = y2;
  x.fold[0] = fold;
  x.fold[1] = fold + 3 * Cm;
  if (bf16) {
    RUN((rowmm<kLoadH1, kEpiBias, true>(x, w2p, b2, y2, part, C1, C2, vec, st)));
    RUN((rowmm<kLoadH2, kEpiBias, true>(x, w3p, b3, y3, part, C2, C3, vec, st)));
    rows_max_kernel<true><<<static_cast<unsigned>(cdiv(BS * C3, kThreads)), kThreads, 0, st>>>(
        y3, idx, out, BS, K, C3, N);
  } else {
    RUN((rowmm<kLoadH1, kEpiBias>(x, w2p, b2, y2, part, C1, C2, vec, st)));
    RUN((rowmm<kLoadH2, kEpiBias>(x, w3p, b3, y3, part, C2, C3, vec, st)));
    rows_max_kernel<false><<<static_cast<unsigned>(cdiv(BS * C3, kThreads)), kThreads, 0, st>>>(
        y3, idx, out, BS, K, C3, N);
  }
  LAUNCH_CHECK();
  return 0;
}
