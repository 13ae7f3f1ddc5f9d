// Training-mode set abstraction (K6) in bf16 for Hopper (sm_90a): the JAX
// kernels' `cdt = bfloat16` on bf16 wgmma, with TMA-fed tiles and resident
// weights. The f32 mode (3xTF32) is sa_fused_train.cu; both share k6_common.cuh.
//
// Replaces open3dsot_tpu/ops/sa_fused_train.py::fused_sa_train_apply with
// dtype=bfloat16, its forward F1-F4 (:608-:668, `_kf1`-`_kf4`) and backward
// B1-B4 (:709-:776, `_kb1`-`_kb4`). Over the rows r = (b, s, k) of the
// neighbourhood grid, R = B * S * K of them:
//
//   y1 = bf16(a)[idx] + ct, h1 = bf16(relu(BN1(y1)))     (a rounded as it is read)
//   y2 = h1 W2 + b2,        h2 = bf16(relu(BN2(y2)))     (bf16 operands, f32 sums)
//   y3 = h2 W3 + b3,        out = max_k relu(BN3(y3))
//
// with each BatchNorm at this batch's statistics, and the exact BN-training
// backward (k6_common.cuh, sa_fused_train.cu's header).
//
// What the forward keeps, as JAX's bf16 kernel keeps it: the grids h1 (R x C1)
// and h2 (R x C2) in bf16, not the f32 y2, y3; every later pass computes y2 =
// h1 W2 + b2 and y3 = h2 W3 + b3 again on the tensor cores, with the same
// product code (rp_kernel's product loop: wgmma m64nNSk16 over 64-input
// k-blocks in one order, N = NS for the whole call) as the pass that took
// that grid's statistics, so the values are bit for bit the ones the
// statistics, ReLU masks and maxima were taken on. The max pass also keeps,
// per (b, s, channel), the number of tied maxima and the sum of yhat3 over
// them (`mxt`), so the backward's first pass (dz3's sums) needs no product.
//
// What bounds it on this card. At BAT_Car widths a K6 call's products are
// 2-6 MFLOP a row over 0.1-0.4 M rows, at 989 TFLOP/s; a row's bf16 grid is
// 256-512 bytes, at 3.35 TB/s. Recomputing y2 from h1 takes about 8
// tensor-core cycles a row on one SM where reading it as f32 would take about
// 37 of its share of the memory's: every pass is bound by the bytes of its
// grids, not by its products.
//
// What the design does about it. The passes of a call, in order: F1 y1's
// statistics (k6_common.cuh), h1_kernel (the h1 grid, elementwise), F2 y2's
// statistics, F3 h2, F4 y3's statistics, F5 the max; B1 dz3's sums (no
// product), B2 dy3, dW3, B3 dz2 and its sums, B4 dy2, dW2, B5 dz1 and its
// sums, the scatter. Each F/B pass after h1_kernel is one launch of:
//  - Row passes (rp_kernel<P, NS>): one persistent block per SM, two consumer
//    warpgroups of 64-row tiles and a producer warp for each (a warpgroup
//    that gives its registers to the consumers: setmaxnreg). The block's
//    weight slices (NS output channels x all inputs, K-major, 128-byte
//    swizzle) come by TMA into shared memory once; A tiles of the stored bf16
//    grids come by TMA in 64 x 64 k-blocks (8 KB, the same swizzle) into a
//    ring of up to kMaxStages per consumer with full/empty mbarriers. The
//    consumers run wgmma with A and B from shared memory over the whole input
//    width into their accumulators, one group in flight (wait_group 1), and
//    do the pass's epilogue in registers. Output channels are split over
//    blocks (gridDim.y) in slices of NS = 128, or 64 where a pass's weights
//    would not fit at 128. A pass whose weight slices do not fit in shared
//    memory even at 64 (about 600 inputs a product) streams them instead: each
//    stage of its ring holds the A k-block and the weight slices' k-block,
//    both by TMA. So any width that is a multiple of 4 runs.
//  - dW = h^T dy (dw_kernel): both operands MN-major from their stored grids
//    by TMA, wgmma with the transpose bits; a block owns a 128 x 128 tile of
//    dW over a chunk of rows; the per-chunk partials are summed in a fixed
//    order (sum_partials_kernel). dy3 and dy2 are written once in bf16 by
//    the passes that make them.
//  - Statistics: per-warpgroup double partials over its tiles (add_sums; F2
//    and F4 keep a thread's f32 sums of 4 tiles first), in a fixed order (the
//    tiles a warpgroup takes depend on the grid only), reduced by the
//    finalize kernels. The BN backward's sums take dz2 and dz1 unrounded,
//    the products and grids bf16(dz), as JAX's `_kb2` / `_kb3` sum before
//    they store.
//  - The max over the K neighbours (F5): where K is a power of two up to 64,
//    a 64-row tile holds whole centroids; the tile's y3 goes to shared memory
//    and a thread scans a column of each centroid (scan_rows). At any other K
//    a centroid can cross tiles: F5 writes y3 (f32, R x C3, in the workspace)
//    and scan_kernel scans each centroid's column from there, in the same
//    order of sums.
//  - Epilogue loads (B2's max and shares, B4's dz2, B5's gathered y1) are
//    issued together before they are used; F3 stages its h2 tile in shared
//    memory and writes it by TMA stores.
//  - Rounding pinned as the plain version pins it (k6_common.cuh), and the
//    masks compare bf16(relu(BN(y))) > 0, the stored activation.
//
// Interface: plain C, loaded with ctypes; device pointers, PyTorch's current
// stream. Returns 0, a CUDA error code, or a negative code for arguments the
// kernels do not take.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "k6_common.cuh"  // Dims, the BatchNorm arithmetic, y1's statistics, the finalizes
#include "per_device.cuh"  // per_device: set-up once for each card

namespace {

constexpr int kErrArgs = -1;   // B, N, S, K or widths not accepted
constexpr int kErrWidth = -2;  // a width is not a multiple of 4
constexpr int kErrMap = -6;    // a TMA tensor map was refused

constexpr int kRows = 64;        // rows of a consumer warpgroup's tile
constexpr int kKB = 64;          // inputs of a k-block: 128 bytes of bf16, one swizzle row
constexpr int kMaxStages = 4;    // A k-blocks in flight per consumer warpgroup, at most
constexpr int kMinStages = 2;    // ... and at least
constexpr int kABytes = kRows * kKB * 2;  // one A k-block, 8 KB
constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kRPThreads = 3 * kWG;  // two consumer warpgroups, one producer warpgroup
constexpr int kThreads = 256;
constexpr int kCent = 64;        // centroids of one partial of dz3's sums
constexpr int kSmemMax = 232448;  // 227 KB, the most a block may take
constexpr int kDwStages = 4;     // dW: 64-row steps in flight
constexpr int kDwStage = 4 * kABytes;  // dW step: two X boxes, two D boxes (32 KB)
constexpr int kWantBlocks = 264;  // dW: about two blocks per SM over the tiles
// dW: rows a block's accumulators sum at most. The tensor cores do not round
// their f32 sums to nearest, so a longer chunk drifts: at 34M rows in 264
// chunks of 130000 dW2 sat 3.7e-3 (relative norm) from its float64 value, 25x
// the plain bf16 path's distance, in chunks of 8192 rows 9.0e-4 (chip_smoke.py
// phase 26a). The shipped shapes' chunks are shorter (BAT_Car at B = 50: at
// most 3136 rows), so their split is as before.
constexpr long long kDwMaxRows = 4096;

// ---- TMA, mbarriers, wgmma ---------------------------------------------------

// A (box_cols x box_rows) box at column c0, row r0 of a 2D tensor map into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int r0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)),
      "r"(c0), "r"(r0)
      : "memory");
}

// A (64 x 64) box of a 2D tensor map at column c0, row r0 from src (a bulk
// group of the issuing thread); parts past the map's edges are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int r0) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(map), "r"(smem_addr(src)), "r"(c0), "r"(r0) : "memory");
}

// Two bf16 of row `row`, columns col, col + 1 (even) of an output tile staged
// for tma_store: 64-column boxes of 64 rows, 128-byte swizzle, 8 KB apart
__device__ __forceinline__ void put_out(uint8_t* sb, int row, int col, uint32_t v) {
  const int cc = col & 63;
  *reinterpret_cast<uint32_t*>(sb + (col >> 6) * kABytes + row * 128 +
                               (((cc >> 3) ^ (row & 7)) << 4) + (cc & 7) * 2) = v;
}

// 128-byte-swizzle shared-memory descriptor. K-major (rows of 64 inputs):
// sbo 1024 bytes between 8-row groups, lbo unused. MN-major (rows of 64
// channels along k): lbo between 64-channel blocks, sbo 1024 bytes between
// groups of 8 k.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The barrier of consumer warpgroup c alone (named barriers 1, 2)
__device__ __forceinline__ void wg_sync(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(kWG) : "memory");
}

// ---- the row passes ------------------------------------------------------------
// Each pass: one or two products of a 64-row tile, A from a stored grid, B a
// weight slice; then its epilogue.
//   kF2  A = h1 (h1_kernel's); y2 = A W2 + b2 -> y2's sums
//   kF3  A = h1; y2 -> h2 = bf16(relu(BN2(y2)))                       (writes h2)
//   kF4  A = h2; y3 = A W3 + b3 -> y3's sums
//   kF5  A = h2; y3 -> per (b, s, c): max_k h3, its ties, sum of yhat3 over them
//   kB2  A = h2; y3 -> dz3 (at the ties) -> dy3 = bf16(BN3 backward)  (writes dy3)
//   kB3  A = dy3 (W3 rows), h1 (W2^T rows): dh2, y2 -> dz2 = dh2 where h2 > 0,
//        sums (dz2, dz2 * yhat2)                                      (writes dz2)
//   kB4  A = h1; y2 -> dy2 = bf16(BN2 backward of dz2)                 (writes dy2)
//   kB5  A = dy2 (W2 rows): dh1 -> dz1 = dh1 where h1 > 0, sums (dz1, dz1 * yhat1)
//        with y1 gathered                                              (writes dz1)
enum Pass { kF2, kF3, kF4, kF5, kB2, kB3, kB4, kB5 };

template <int P>
__host__ __device__ constexpr int n_prod() {
  return P == kB3 ? 2 : 1;
}
template <int P>
__host__ __device__ constexpr bool has_stats() {
  return P == kF2 || P == kF4 || P == kB3 || P == kB5;
}
// F3 stages its output tile in shared memory and writes it by TMA stores; the
// backward's passes, which read per-element operands in their epilogues, store
// from registers (staging them measured slower there).
template <int P>
__host__ __device__ constexpr bool tma_out() {
  return P == kF3;
}

struct PassArgs {
  Dims d;
  int nout;            // output channels
  int kin0, kin1;      // input widths of the products
  int tiles;           // 64-row tiles
  int stages;          // the ring's stages per consumer (2..kMaxStages)
  int wstream;         // the weight slices come with each A k-block (not resident)
  int tscan;           // kF5: the max over K within the tile (K a power of two up to 64)
  const float* bias;   // (nout) or null
  const float* fold;   // the output layer's s, t, inv (each nout), or null
  const float* mean;   // the output layer's mean, or null
  const float* coef;   // the output layer's sum dz / M, sum dz yhat / M, or null
  const float* a;      // (B, N, C1), rounded to bf16 as it is read
  const float* ct;     // (B, S, C1)
  const int* idx;      // (B, S, K)
  float* mxt;          // (3, B * S, C3): max, ties, sum of yhat3 over the ties
  float* y3;           // kF5: y3 (R, C3) f32 where not null (scan_kernel's, or a check's copy)
  const float* share;  // (B * S, C3): g / ties
  uint16_t* out;       // the bf16 grid the pass writes, out_ld apart
  int out_ld;
  const uint16_t* gin;  // kB4: dz2, gin_ld apart
  int gin_ld;
  double* part;        // (2 * gridDim.x, 2, nout): the pass's sums
};

// Bytes of a pass's shared memory at slice NS: the weight slices (none where
// they are streamed), the rings, the warps' sums, the vectors (7 of NS), the
// mbarriers; 1 KB of slack for the 1024-byte alignment of the swizzled tiles.
__host__ __device__ constexpr long long rp_wbytes(int ns, int kin) {
  return static_cast<long long>((kin + kKB - 1) / kKB) * ns * 128;
}
// F5's tile buffers: y3 of each consumer's 64-row tile, rows NS + 8 floats apart
__host__ __device__ constexpr long long rp_ybytes(int ns) {
  return 2LL * kRows * (ns + 8) * 4;
}
// A stage of a consumer's ring: the A k-block, and the weight slices' where
// they are streamed
__host__ __device__ constexpr int rp_stage_bytes(int ns, bool ws) {
  return kABytes + (ws ? ns * 128 : 0);
}
// The bytes besides the rings, and the most stages that fit next to them
// (ybuf: F5's tile buffers; out: the output tiles staged for TMA stores; ws:
// the weights streamed)
__host__ __device__ constexpr long long rp_fixed(int ns, int kin0, int kin1, bool ybuf, bool out,
                                                 bool ws) {
  return 1024 + (ws ? 0 : rp_wbytes(ns, kin0) + (kin1 ? rp_wbytes(ns, kin1) : 0)) +
         (out ? 2LL * ns * 128 : 0) + 2LL * 4 * ns * 2 * 8 + (ybuf ? rp_ybytes(ns) : 0) +
         4LL * 7 * ns + 8LL * (4 * kMaxStages + 1);
}
__host__ __device__ constexpr int rp_stages(int ns, int kin0, int kin1, bool ybuf, bool out,
                                            bool ws) {
  const long long s =
      (kSmemMax - rp_fixed(ns, kin0, kin1, ybuf, out, ws)) / (2LL * rp_stage_bytes(ns, ws));
  return static_cast<int>(s < kMaxStages ? s : kMaxStages);
}

// Per-warp sums of (v, w) over the warp's 16 rows for each of its columns:
// vs[n4][...] as row_epilogue of sa_fused_train.cu reduces them, by halving
// over the 8 row groups; then red[warp][col][2]. cols: NT / 4 blocks of 32.
template <int H>
__device__ __forceinline__ void halve(double (&vs)[16], bool up, int mask) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const double lo = vs[k], hi = vs[H + k];
    vs[k] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, mask);
  }
}

// Column sums of a consumer warpgroup's rows: pair(nt, j) gives this thread's
// (sum, second sum) of column nt * 8 + 2q + j over its rows in double; they
// are reduced over the warp's 8 row groups by halving (as sa_fused_train.cu's
// row_epilogue), then over the 4 warps in order through red, and added to the
// running sums of column tid (thread tid < NS of the warpgroup).
template <int NS, class Pair>
__device__ __forceinline__ void add_sums(Pair pair, double* red, int c, double& run1,
                                         double& run2) {
  const int tid = threadIdx.x & (kWG - 1), warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
  for (int n4 = 0; n4 < NS / 32; ++n4) {
    double vs[16];  // [s * 8 + m * 2 + j], nt = 4 n4 + m: s = 0 sum, 1 second sum
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double2 v = pair(4 * n4 + m, j);
        vs[m * 2 + j] = v.x;
        vs[8 + m * 2 + j] = v.y;
      }
    halve<8>(vs, g & 1, 4);
    halve<4>(vs, (g >> 1) & 1, 8);
    halve<2>(vs, (g >> 2) & 1, 16);
    // lane (g, q) holds vs[j], j < 2: the original index j + 2 g2 + 4 g1 + 8 g0
    const int m = ((g >> 2) & 1) + 2 * ((g >> 1) & 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) red[(warp * NS + (4 * n4 + m) * 8 + 2 * q + j) * 2 + (g & 1)] = vs[j];
  }
  wg_sync(c);
  if (tid < NS) {
#pragma unroll
    for (int w4 = 0; w4 < 4; ++w4) {
      run1 += red[(w4 * NS + tid) * 2];
      run2 += red[(w4 * NS + tid) * 2 + 1];
    }
  }
  wg_sync(c);  // red is read before it is written again
}

// F2 and F4 keep a thread's sums (ps[nt][j], ps[nt][2 + j]) of kFlush tiles in
// f32 (8 rows) before they add them, in double, to the running sums
// (add_sums); B3 and B5, whose registers are full, add each tile's.
constexpr int kFlush = 4;

template <int NS>
__device__ __forceinline__ void flush_sums(float (&ps)[NS / 8][4], double* red, int c,
                                           double& run1, double& run2) {
  add_sums<NS>([&](int nt, int j) { return make_double2(ps[nt][j], ps[nt][2 + j]); }, red, c,
               run1, run2);
#pragma unroll
  for (int nt = 0; nt < NS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ps[nt][e] = 0.f;
}

// One column of a centroid's KK rows (ld apart) after the fold: m = their
// max, then the ties of it and the sum of yhat over them; the values held in
// registers, the max and the sum taken in interleaved chains (the max exactly,
// the sum in a fixed order).
template <int KK>
__device__ __forceinline__ void scan_rows(const float* col, int ld, float sv, float tv, float mu,
                                          float iv, float& m, float& ties, float& ty) {
  constexpr int C = KK < 4 ? KK : 4;
  float y[KK], h[KK], mc[C], tc[C], yc[C];
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    y[k] = col[k * ld];
    h[k] = fold_relu(y[k], sv, tv);
  }
#pragma unroll
  for (int i = 0; i < C; ++i) mc[i] = 0.f;  // every value is a ReLU output, so >= 0
#pragma unroll
  for (int k = 0; k < KK; ++k) mc[k % C] = fmaxf(mc[k % C], h[k]);
  m = mc[0];
#pragma unroll
  for (int i = 1; i < C; ++i) m = fmaxf(m, mc[i]);
#pragma unroll
  for (int i = 0; i < C; ++i) tc[i] = yc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < KK; ++k)
    if (h[k] == m) {
      tc[k % C] += 1.f;
      yc[k % C] += yhat_of(y[k], mu, iv);
    }
  ties = tc[0];
  ty = yc[0];
#pragma unroll
  for (int i = 1; i < C; ++i) {
    ties += tc[i];
    ty += yc[i];
  }
}

// Registers a thread of the producer warpgroup and of a consumer warpgroup
// keeps (setmaxnreg; 128 * 40 + 256 * 232 = 64512): the producers only issue
// TMA, the consumers of B3 hold two products' accumulators.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int P, int NS>
__global__ void __launch_bounds__(kRPThreads, 1)
    rp_kernel(const __grid_constant__ CUtensorMap ma0, const __grid_constant__ CUtensorMap ma1,
              const __grid_constant__ CUtensorMap mw0, const __grid_constant__ CUtensorMap mw1,
              const __grid_constant__ CUtensorMap mo, const PassArgs p) {
  constexpr int NT = NS / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const int nkb0 = (p.kin0 + kKB - 1) / kKB, nkb1 = (p.kin1 + kKB - 1) / kKB;
  const bool ws = p.wstream != 0;
  const int SB = rp_stage_bytes(NS, ws);
  uint8_t* w0 = smem;  // the resident weight slices (none where they are streamed)
  uint8_t* w1 = w0 + (ws ? 0 : nkb0 * NS * 128);
  uint8_t* ring = w1 + (ws ? 0 : nkb1 * NS * 128);  // [consumer][stage] SB bytes each
  const int S = p.stages;
  uint8_t* obuf = ring + 2 * S * SB;  // [consumer] NS / 64 boxes of 8 KB, where the pass writes
  double* red = reinterpret_cast<double*>(obuf + (tma_out<P>() ? 2 * NS * 128 : 0));  // [consumer][4][NS][2]
  float* ybuf = reinterpret_cast<float*>(red + 2 * 4 * NS * 2);  // F5: [consumer][64][NS + 8]
  float* vec = ybuf + (P == kF5 ? rp_ybytes(NS) / 4 : 0);  // 7 x NS: bias s t inv mean c1 c2
  uint64_t* bars = reinterpret_cast<uint64_t*>(vec + 7 * NS);
  uint64_t* full = bars;                 // [consumer][stage]
  uint64_t* empty = bars + 2 * S;  // [consumer][stage]
  uint64_t* wbar = bars + 4 * S;
  const Dims& d = p.d;
  const int R = static_cast<int>(d.R);
  const int tid = threadIdx.x, wg = tid / kWG;
  const int n0 = blockIdx.y * NS;
  const int stride = 2 * gridDim.x;  // warpgroups over the tiles

  if (tid == 0) {
    for (int i = 0; i < 2 * S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 7 * NS; i += blockDim.x) {
    const int k = i / NS, n = n0 + i % NS;
    float v = 0.f;
    if (n < p.nout) {
      if (k == 0) v = p.bias ? p.bias[n] : 0.f;
      else if (k <= 3) v = p.fold ? p.fold[(k - 1) * p.nout + n] : 0.f;
      else if (k == 4) v = p.mean ? p.mean[n] : 0.f;
      else v = p.coef ? p.coef[(k - 5) * p.nout + n] : 0.f;
    }
    vec[i] = v;
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup: consumer c's producer is thread 32 c (its own
    // warp), which fills that consumer's ring alone, so a consumer in its
    // epilogue holds back no other
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int pt = tid - 2 * kWG;
    if (pt & 31 || pt >= 64) return;
    const int c = pt >> 5;
    if (c == 0 && !ws) {
      mbar_expect(wbar, static_cast<uint32_t>((nkb0 + nkb1) * NS * 128));
      for (int kb = 0; kb < nkb0; ++kb) tma_load(w0 + kb * NS * 128, &mw0, kb * kKB, n0, wbar);
      for (int kb = 0; kb < nkb1; ++kb) tma_load(w1 + kb * NS * 128, &mw1, kb * kKB, n0, wbar);
    }
    int u = 0;  // stages issued
    for (int t = blockIdx.x * 2 + c; t < p.tiles; t += stride) {
      for (int kb = 0; kb < nkb0 + nkb1; ++kb, ++u) {
        const int s = u % S;
        if (u >= S) wait_bar(&empty[c * S + s], ((u / S) + 1) & 1);
        uint64_t* bar = &full[c * S + s];
        mbar_expect(bar, SB);
        uint8_t* dst = ring + (c * S + s) * SB;
        if (kb < nkb0) {
          tma_load(dst, &ma0, kb * kKB, t * kRows, bar);
          if (ws) tma_load(dst + kABytes, &mw0, kb * kKB, n0, bar);
        } else {
          tma_load(dst, &ma1, (kb - nkb0) * kKB, t * kRows, bar);
          if (ws) tma_load(dst + kABytes, &mw1, (kb - nkb0) * kKB, n0, bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int c = wg, ct_ = tid & (kWG - 1), warp = ct_ >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  double* cred = red + c * 4 * NS * 2;
  double run1 = 0.0, run2 = 0.0;  // the warpgroup's sums of column ct_
  constexpr bool kPs = P == kF2 || P == kF4;  // sums kept over kFlush tiles
  float ps[kPs ? NT : 1][4] = {};  // this thread's sums of its last tiles' rows
  int done = 0;  // tiles of this warpgroup
  uint8_t* cring = ring + c * S * SB;
  const uint32_t w0a = smem_addr(w0), w1a = smem_addr(w1);
  if (!ws) wait_bar(wbar, 0);
  int u = 0;  // stages consumed
  for (int i = 0;; ++i) {
    const int t = blockIdx.x * 2 + c + i * stride;
    if (t >= p.tiles) break;
    float acc0[NT][4], acc1[n_prod<P>() == 2 ? NT : 1][4];
    // the products: k-block kb of A in stage u % S, the weight's k-block kb
#pragma unroll 1
    for (int kb = 0; kb < nkb0; ++kb, ++u) {
      const int s = u % S;
      wait_bar(&full[c * S + s], (u / S) & 1);
      const uint32_t aa = smem_addr(cring + s * SB), ba = ws ? aa + kABytes : w0a + kb * NS * 128;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKB / 16; ++ks)
        wgmma_ns<NS, 0, 0>(acc0, sw128_desc(aa + ks * 32, 16, 1024),
                           sw128_desc(ba + ks * 32, 16, 1024), kb | ks);
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[c * S + (u - 1) % S]);
      }
    }
    if constexpr (n_prod<P>() == 2) {
#pragma unroll 1
      for (int kb = 0; kb < nkb1; ++kb, ++u) {
        const int s = u % S;
        wait_bar(&full[c * S + s], (u / S) & 1);
        const uint32_t aa = smem_addr(cring + s * SB), ba = ws ? aa + kABytes : w1a + kb * NS * 128;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKB / 16; ++ks)
          wgmma_ns<NS, 0, 0>(acc1, sw128_desc(aa + ks * 32, 16, 1024),
                             sw128_desc(ba + ks * 32, 16, 1024), kb | ks);
        wgmma_commit();
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[c * S + (u - 1) % S]);
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[c * S + (u - 1) % S]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fence_operand(acc0[nt][j]);
        if constexpr (n_prod<P>() == 2) fence_operand(acc1[nt][j]);
      }

    uint8_t* sb = obuf + c * NS * 128;  // this warpgroup's output tile (tma_out)
    if constexpr (tma_out<P>()) {  // the last tile's stores are done reading it
      if (ct_ == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      wg_sync(c);
    }

    // ---- the epilogue: rows rw[h] = t * 64 + 16 warp + g + 8 h, columns
    // n0 + nt * 8 + 2q + j; element (nt, 2 h + j) of the fragments
    int rw[2];
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rw[h] = t * kRows + 16 * warp + g + 8 * h;
      in[h] = rw[h] < R;
    }
    const float* vb = vec;
    const float *vs = vec + NS, *vt = vec + 2 * NS, *vi = vec + 3 * NS, *vm = vec + 4 * NS;
    const float *vc1 = vec + 5 * NS, *vc2 = vec + 6 * NS;

    // two bf16 of row rw[h], columns n0 + nl, + 1 to the pass's grid
    const auto emit = [&](int h, int nl, uint32_t v) {
      if constexpr (tma_out<P>())
        put_out(sb, 16 * warp + g + 8 * h, nl, v);
      else if (in[h] && n0 + nl < p.nout)
        *reinterpret_cast<uint32_t*>(p.out + static_cast<long long>(rw[h]) * p.out_ld + n0 + nl) = v;
    };

    if constexpr (P == kF2 || P == kF4) {  // the sums of y and y^2
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nl = nt * 8 + 2 * q + (e & 1);
          const float y = in[e >> 1] && n0 + nl < p.nout ? __fadd_rn(acc0[nt][e], vb[nl]) : 0.f;
          ps[nt][e & 1] += y;
          ps[nt][2 + (e & 1)] += y * y;
        }
    } else if constexpr (P == kF3) {  // h2
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nl = nt * 8 + 2 * q, n = n0 + nl;
          if (!in[h] || n >= p.nout) continue;
          float hv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            hv[j] = fold_relu(__fadd_rn(acc0[nt][2 * h + j], vb[nl + j]), vs[nl + j], vt[nl + j]);
          emit(h, nl, pack_bf16(hv[0], hv[1]));
        }
    } else if constexpr (P == kF5) {  // per centroid: max, ties, sum of yhat over the ties
      // y3 into the warpgroup's tile buffer (tscan) and to p.y3 (where given),
      // then column ct_ of each of the tile's centroids (K rows, a power of two
      // up to 64): its max, then its ties and their yhat3. Without tscan,
      // scan_kernel scans p.y3.
      constexpr int LD = NS + 8;
      float* yb = ybuf + c * kRows * LD;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nl = nt * 8 + 2 * q, row = 16 * warp + g + 8 * h;
          const float2 y = make_float2(__fadd_rn(acc0[nt][2 * h], vb[nl]),
                                       __fadd_rn(acc0[nt][2 * h + 1], vb[nl + 1]));
          if (p.tscan) *reinterpret_cast<float2*>(yb + row * LD + nl) = y;
          if (p.y3 && in[h] && n0 + nl < p.nout)
            *reinterpret_cast<float2*>(p.y3 + static_cast<long long>(rw[h]) * p.nout + n0 + nl) = y;
        }
      if (p.tscan) wg_sync(c);
      if (p.tscan && ct_ < NS && n0 + ct_ < p.nout) {
        const int K = d.K;
        const long long BS = static_cast<long long>(d.B) * d.S, plane = BS * p.nout;
        const float sv = vs[ct_], tv = vt[ct_], mu = vm[ct_], iv = vi[ct_];
        for (int j0 = 0; j0 < kRows && t * kRows + j0 < R; j0 += K) {
          const float* col = yb + j0 * LD + ct_;
          float m, ties, ty;
          switch (K) {  // a power of two up to 64 (check())
            case 1: scan_rows<1>(col, LD, sv, tv, mu, iv, m, ties, ty); break;
            case 2: scan_rows<2>(col, LD, sv, tv, mu, iv, m, ties, ty); break;
            case 4: scan_rows<4>(col, LD, sv, tv, mu, iv, m, ties, ty); break;
            case 8: scan_rows<8>(col, LD, sv, tv, mu, iv, m, ties, ty); break;
            case 16: scan_rows<16>(col, LD, sv, tv, mu, iv, m, ties, ty); break;
            case 32: scan_rows<32>(col, LD, sv, tv, mu, iv, m, ties, ty); break;
            default: scan_rows<64>(col, LD, sv, tv, mu, iv, m, ties, ty); break;
          }
          const long long o = (static_cast<long long>(t) * kRows + j0) / K * p.nout + n0 + ct_;
          p.mxt[o] = m;
          p.mxt[plane + o] = ties;
          p.mxt[2 * plane + o] = ty;
        }
      }
      if (p.tscan) wg_sync(c);  // the buffer is read before it is written again
    } else if constexpr (P == kB2) {  // dy3
      long long co[2];  // the rows' centroids' offsets
#pragma unroll
      for (int h = 0; h < 2; ++h)
        co[h] = static_cast<long long>(centroid_of(d, in[h] ? rw[h] : 0)) * p.nout;
#pragma unroll
      for (int n4 = 0; n4 < NT / 4; ++n4) {
        float2 mx[4][2], sh[4][2];  // loaded together, then used
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = n0 + (4 * n4 + m) * 8 + 2 * q;
            const long long o = in[h] && n < p.nout ? co[h] + n : 0;
            mx[m][h] = ldg2(p.mxt + o);
            sh[m][h] = ldg2(p.share + o);
          }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int nt = 4 * n4 + m, nl = nt * 8 + 2 * q, n = n0 + nl;
            if (!in[h] || n >= p.nout) continue;
            float dy[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float y = __fadd_rn(acc0[nt][2 * h + j], vb[nl + j]);
              const float h3 = fold_relu(y, vs[nl + j], vt[nl + j]);
              const float mj = j ? mx[m][h].y : mx[m][h].x, sj = j ? sh[m][h].y : sh[m][h].x;
              const float dz = (h3 == mj && h3 > 0.f) ? round_bf16(sj) : 0.f;
              dy[j] = bn_bwd(dz, yhat_of(y, vm[nl + j], vi[nl + j]), vs[nl + j], vc1[nl + j],
                             vc2[nl + j]);
            }
            emit(h, nl, pack_bf16(dy[0], dy[1]));
          }
      }
    } else if constexpr (P == kB3) {  // dz2 = dh2 (acc0) where h2 > 0, in place; yhat2 (acc1)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nl = nt * 8 + 2 * q + (e & 1);
          const float y = __fadd_rn(acc1[nt][e], vb[nl]);
          const bool on = round_bf16(fold_relu(y, vs[nl], vt[nl])) > 0.f;
          const bool ok = in[e >> 1] && n0 + nl < p.nout;
          acc0[nt][e] = ok && on ? acc0[nt][e] : 0.f;
          acc1[nt][e] = ok ? yhat_of(y, vm[nl], vi[nl]) : 0.f;
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          emit(h, nt * 8 + 2 * q, pack_bf16(acc0[nt][2 * h], acc0[nt][2 * h + 1]));
      add_sums<NS>([&](int nt, int j) {
        const double a = acc0[nt][j], b = acc0[nt][2 + j];
        return make_double2(a + b, a * acc1[nt][j] + b * acc1[nt][2 + j]);
      }, cred, c, run1, run2);
    } else if constexpr (P == kB4) {  // dy2 from dz2 (gin)
#pragma unroll
      for (int n4 = 0; n4 < NT / 4; ++n4) {
        uint32_t dz[4][2];  // loaded together, then used
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = n0 + (4 * n4 + m) * 8 + 2 * q;
            const long long o = in[h] && n < p.nout ? static_cast<long long>(rw[h]) * p.gin_ld + n : 0;
            dz[m][h] = __ldg(reinterpret_cast<const uint32_t*>(p.gin + o));
          }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int nt = 4 * n4 + m, nl = nt * 8 + 2 * q, n = n0 + nl;
            if (!in[h] || n >= p.nout) continue;
            float dy[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float y = __fadd_rn(acc0[nt][2 * h + j], vb[nl + j]);
              dy[j] = bn_bwd(j ? bf16_hi(dz[m][h]) : bf16_lo(dz[m][h]),
                             yhat_of(y, vm[nl + j], vi[nl + j]), vs[nl + j], vc1[nl + j],
                             vc2[nl + j]);
            }
            emit(h, nl, pack_bf16(dy[0], dy[1]));
          }
      }
    } else {  // kB5: dz1 = dh1 where h1 > 0, with y1 gathered
      long long ao[2], co[2];
      bool bad[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rc = in[h] ? rw[h] : 0;
        const unsigned bs = centroid_of(d, rc), b = bs / static_cast<unsigned>(d.S);
        const int jn = __ldg(p.idx + rc);
        bad[h] = !(jn >= 0 && jn < d.N);
        ao[h] = (static_cast<long long>(b) * d.N + (bad[h] ? 0 : jn)) * d.C1;
        co[h] = static_cast<long long>(bs) * d.C1;
      }
      float w[NT][4];  // yhat1; dz1 in place of dh1 (acc0)
#pragma unroll
      for (int n4 = 0; n4 < NT / 4; ++n4) {
        float2 av[4][2], cv[4][2];  // loaded together, then used
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = n0 + (4 * n4 + m) * 8 + 2 * q, nc = in[h] && n < p.nout ? n : 0;
            av[m][h] = ldg2(p.a + ao[h] + nc);
            cv[m][h] = ldg2(p.ct + co[h] + nc);
          }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int nt = 4 * n4 + m, nl = nt * 8 + 2 * q, n = n0 + nl;
            const bool ok = in[h] && n < p.nout;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float nan = __int_as_float(0x7fc00000);
              const float y = bad[h] ? nan
                                     : __fadd_rn(round_bf16(j ? av[m][h].y : av[m][h].x),
                                                 j ? cv[m][h].y : cv[m][h].x);
              const bool on = round_bf16(fold_relu(y, vs[nl + j], vt[nl + j])) > 0.f;
              acc0[nt][2 * h + j] = ok && on ? acc0[nt][2 * h + j] : 0.f;
              w[nt][2 * h + j] = ok ? yhat_of(y, vm[nl + j], vi[nl + j]) : 0.f;
            }
            emit(h, nl, pack_bf16(acc0[nt][2 * h], acc0[nt][2 * h + 1]));
          }
      }
      add_sums<NS>([&](int nt, int j) {
        const double a = acc0[nt][j], b = acc0[nt][2 + j];
        return make_double2(a + b, a * w[nt][j] + b * w[nt][2 + j]);
      }, cred, c, run1, run2);
    }
    if constexpr (tma_out<P>()) {  // the tile to the grid: one bulk store a 64-column box
      fence_proxy_async();
      wg_sync(c);
      if (ct_ == 0) {
        for (int b = 0; b < NS / 64 && n0 + 64 * b < p.nout; ++b)
          tma_store(&mo, sb + b * kABytes, n0 + 64 * b, t * kRows);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if constexpr (kPs) {
      if (++done % kFlush == 0) flush_sums<NS>(ps, cred, c, run1, run2);
    }
  }
  if constexpr (tma_out<P>()) {  // the stores complete before the block ends
    if (ct_ == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  if constexpr (has_stats<P>()) {  // the warpgroup's partial
    if constexpr (kPs) {
      if (done % kFlush) flush_sums<NS>(ps, cred, c, run1, run2);
    }
    if (ct_ < NS && n0 + ct_ < p.nout) {
      const long long base = (static_cast<long long>(blockIdx.x) * 2 + c) * 2 * p.nout + n0 + ct_;
      p.part[base] = run1;
      p.part[base + p.nout] = run2;
    }
  }
}

// ---- F2's A: h1 = bf16(relu(BN1(y1))), y1 = bf16(a)[idx] + ct, the grid (R x
// round8(C1), ld apart) the products read. Block (32, 8): four channels a
// thread, 8 row lanes, rows strided over the grid's y; a row's gather offsets
// once per row. An index outside [0, N) gives a NaN y1 (zeros after the ReLU,
// as the f32 mode's).
__global__ void h1_kernel(const float* __restrict__ a, const float* __restrict__ ct,
                          const int* __restrict__ idx, const Dims d,
                          const float* __restrict__ fold, uint16_t* __restrict__ h1, int ld) {
  const int c = (blockIdx.x * 32 + threadIdx.x) * 4;
  if (c >= d.C1) return;
  const float4 sv = ldg4(fold + c), tv = ldg4(fold + d.C1 + c);
  const float nan = __int_as_float(0x7fc00000);
  const int R = static_cast<int>(d.R);
  for (int r = blockIdx.y * 8 + threadIdx.y; r < R; r += gridDim.y * 8) {
    const unsigned bs = centroid_of(d, r), b = bs / static_cast<unsigned>(d.S);
    const int j = __ldg(idx + r);
    const float4 av = j >= 0 && j < d.N ? ldg4(a + (static_cast<long long>(b) * d.N + j) * d.C1 + c)
                                        : make_float4(nan, nan, nan, nan);
    const float4 cv = ldg4(ct + static_cast<long long>(bs) * d.C1 + c);
    const float x0 = fold_relu(__fadd_rn(round_bf16(av.x), cv.x), sv.x, tv.x);
    const float x1 = fold_relu(__fadd_rn(round_bf16(av.y), cv.y), sv.y, tv.y);
    const float x2 = fold_relu(__fadd_rn(round_bf16(av.z), cv.z), sv.z, tv.z);
    const float x3 = fold_relu(__fadd_rn(round_bf16(av.w), cv.w), sv.w, tv.w);
    *reinterpret_cast<uint2*>(h1 + static_cast<long long>(r) * ld + c) =
        make_uint2(pack_bf16(x0, x1), pack_bf16(x2, x3));
  }
}

// ---- F5's scan at a K that is not a power of two up to 64: per (b, s, c),
// from y3 (R x C3 f32), what scan_rows gives: the max of h3 = relu(BN3(y3))
// over the K rows, its ties and the sum of yhat3 over them, in the same
// chains (row k in chain k % 4, the chains added in order). A thread a
// column; two reads of the column (the max, then the ties).
__global__ void scan_kernel(const float* __restrict__ y3, const float* __restrict__ fold,
                            const float* __restrict__ mean, const Dims d, float* __restrict__ mxt) {
  const long long BS = static_cast<long long>(d.B) * d.S, plane = BS * d.C3;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= plane) return;
  const long long bs = e / d.C3;
  const int c = static_cast<int>(e - bs * d.C3), K = d.K, C = K < 4 ? K : 4;
  const float sv = fold[c], tv = fold[d.C3 + c], iv = fold[2 * d.C3 + c], mu = mean[c];
  const float* col = y3 + bs * K * d.C3 + c;
  float mc[4] = {0.f, 0.f, 0.f, 0.f};  // every value is a ReLU output, so >= 0
  for (int k0 = 0; k0 < K; k0 += 4)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k0 + i < K) mc[i] = fmaxf(mc[i], fold_relu(col[static_cast<long long>(k0 + i) * d.C3], sv, tv));
  float m = mc[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (i < C) m = fmaxf(m, mc[i]);
  float tc[4] = {0.f, 0.f, 0.f, 0.f}, yc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 4)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k0 + i < K) {
        const float y = col[static_cast<long long>(k0 + i) * d.C3];
        if (fold_relu(y, sv, tv) == m) {
          tc[i] += 1.f;
          yc[i] += yhat_of(y, mu, iv);
        }
      }
  float ties = tc[0], ty = yc[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (i < C) {
      ties += tc[i];
      ty += yc[i];
    }
  mxt[e] = m;
  mxt[plane + e] = ties;
  mxt[2 * plane + e] = ty;
}

// ---- B1: dz3's sums from the max pass's (max, ties, sum of yhat3 over them):
// where the max is > 0, each of the ties has dz3 = g / ties. share = g / ties
// for B2; one partial per kCent centroids. Block (32, 8), grid (C3 / 32, up to
// kMaxGridY), block y taking partials y, y + gridDim.y, ...
__device__ __forceinline__ void dz3_sums_chunk(const float* __restrict__ mxt,
                                               const float* __restrict__ g,
                                               float* __restrict__ share,
                                               double* __restrict__ part, long long BS, int C,
                                               long long chunk) {
  __shared__ double sh[2][8][33];
  const int tx = threadIdx.x, ty = threadIdx.y, c = blockIdx.x * 32 + tx;
  double s1 = 0.0, s2 = 0.0;
  if (c < C) {
    for (int i = 0; i < kCent / 8; ++i) {
      const long long bs = chunk * kCent + ty + 8 * i;
      if (bs >= BS) break;
      const long long o = bs * C + c;
      const float m = mxt[o], ties = mxt[BS * C + o], ty3 = mxt[2 * BS * C + o];
      const float s = __fdiv_rn(g[o], ties);
      share[o] = s;
      if (m > 0.f) {
        s1 += static_cast<double>(s) * static_cast<double>(ties);
        s2 += static_cast<double>(s) * static_cast<double>(ty3);
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

__global__ void dz3_sums_kernel(const float* __restrict__ mxt, const float* __restrict__ g,
                                float* __restrict__ share, double* __restrict__ part, long long BS,
                                int C) {
  for (long long chunk = blockIdx.y; chunk < (BS + kCent - 1) / kCent; chunk += gridDim.y)
    dz3_sums_chunk(mxt, g, share, part, BS, C, chunk);
}

// ---- dW = X^T D over a chunk of rows (X: R x I, D: R x J, bf16 grids) --------
// Block: a 128 x 128 tile (i0, j0) of dW over rows [z * chunk, ...) in steps of
// 64 rows; per step two 64 x 64 boxes of X (i0, i0 + 64) and two of D (j0, j0 +
// 64) by TMA into a ring of kDwStages; consumer warpgroup c computes rows i0 +
// 64 c .. of the tile with wgmma m64n128k16, A = X box c and B = the D boxes,
// both MN-major (rows of the boxes are k). Rows past R and channels past I, J
// are zero-filled by TMA.
__global__ void __launch_bounds__(kRPThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap md,
              float* __restrict__ part, int I, int J, int R, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kDwStage);
  uint64_t* empty = full + kDwStages;
  const int tid = threadIdx.x, wg = tid / kWG;
  const int i0 = blockIdx.x * 128, j0 = blockIdx.y * 128;
  const int r0 = blockIdx.z * chunk;
  const int r1 = min(R, r0 + chunk);
  const int steps = (r1 - r0 + kRows - 1) / kRows;
  if (tid == 0) {
    for (int i = 0; i < kDwStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {
    if (tid != 2 * kWG) return;
    for (int u = 0; u < steps; ++u) {
      const int s = u % kDwStages;
      if (u >= kDwStages) wait_bar(&empty[s], ((u / kDwStages) + 1) & 1);
      uint8_t* st = smem + s * kDwStage;
      const int r = r0 + u * kRows;
      mbar_expect(&full[s], kDwStage);
      tma_load(st, &mx, i0, r, &full[s]);
      tma_load(st + kABytes, &mx, i0 + 64, r, &full[s]);
      tma_load(st + 2 * kABytes, &md, j0, r, &full[s]);
      tma_load(st + 3 * kABytes, &md, j0 + 64, r, &full[s]);
    }
    return;
  }
  const int lane = tid & 31, warp = (tid & (kWG - 1)) >> 5, g = lane >> 2, q = lane & 3;
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
  for (int u = 0; u < steps; ++u) {
    const int s = u % kDwStages;
    wait_bar(&full[s], (u / kDwStages) & 1);
    const uint32_t st = smem_addr(smem + s * kDwStage);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks)
      wgmma_n128<1, 1>(acc, sw128_desc(st + wg * kABytes + ks * 2048, kABytes, 1024),
                       sw128_desc(st + 2 * kABytes + ks * 2048, kABytes, 1024), 1);
    wgmma_commit();
    if (u > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[(u - 1) % kDwStages]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(acc[nt][e]);
  float* out = part + static_cast<long long>(blockIdx.z) * I * J;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = i0 + 64 * wg + 16 * warp + g + 8 * h, n = j0 + nt * 8 + 2 * q;
      if (m < I && n < J)  // J is a multiple of 4, so n + 1 < J too
        *reinterpret_cast<float2*>(out + static_cast<long long>(m) * J + n) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
}

// ---- B4: dy1 = BN backward of dz1 (bf16); da[b, idx[r]] += bf16(dy1[r]) (the
// JAX kernel's bf16 one-hot product); dct[bs] = sum_k dy1 unrounded. y1 with a
// rounded to bf16. An index outside [0, N) gives a NaN y1 and adds nothing.
// ORDERED: bf16(dy1) is written over dz1 for ordered_da (k6_common.cuh), no atomics.
template <bool ORDERED>
__global__ void scatter_kernel(const float* __restrict__ a, const float* __restrict__ ct,
                               const int* __restrict__ idx, const Dims d,
                               uint16_t* __restrict__ dz1, int ld,
                               const float* __restrict__ fold, const float* __restrict__ mean,
                               const float* __restrict__ coef, float* __restrict__ da,
                               float* __restrict__ dct) {
  const long long BS = static_cast<long long>(d.B) * d.S;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= BS * d.C1) return;
  const long long bs = e / d.C1;
  const int c = static_cast<int>(e - bs * d.C1);
  const long long b = bs / d.S;
  const float s = fold[c], inv = fold[2 * d.C1 + c], mu = mean[c];
  const float c1 = coef[c], c2 = coef[d.C1 + c];
  const float ctv = __ldg(ct + bs * d.C1 + c);
  float acc = 0.f;
  for (int k = 0; k < d.K; ++k) {
    const long long r = bs * d.K + k;
    const int j = __ldg(idx + r);
    const bool in = j >= 0 && j < d.N;
    const long long row = (b * d.N + j) * d.C1 + c;
    const float y1 = in ? __fadd_rn(round_bf16(__ldg(a + row)), ctv) : __int_as_float(0x7fc00000);
    const float dz = __uint_as_float(static_cast<uint32_t>(dz1[r * ld + c]) << 16);
    const float v = bn_bwd(dz, yhat_of(y1, mu, inv), s, c1, c2);
    acc += v;
    if (ORDERED)
      dz1[r * ld + c] = bf16_bits(v);
    else if (in)
      atomicAdd(da + row, round_bf16(v));
  }
  dct[e] = acc;
}

// ---- host side ---------------------------------------------------------------
inline int round8(int n) { return (n + 7) & ~7; }
int cmax(const Dims& d) { return d.C1 > d.C2 ? (d.C1 > d.C3 ? d.C1 : d.C3) : (d.C2 > d.C3 ? d.C2 : d.C3); }
long long centroids(const Dims& d) { return static_cast<long long>(d.B) * d.S; }
long long tiles_of(const Dims& d) { return cdiv(d.R, kRows); }
long long stat_chunks(const Dims& d) { return cdiv(d.R, kStatRows); }
long long cent_chunks(const Dims& d) { return cdiv(centroids(d), kCent); }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The SM count, the kernels' shared-memory limit and the CUDA driver's tensor-map
// encoder, once per device.
struct DeviceInfo {
  int sms;
  int err;
  EncodeTiled encode;
};

template <int NS>
cudaError_t allow_smem() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(rp_kernel<kF2, NS>), reinterpret_cast<const void*>(rp_kernel<kF3, NS>),
      reinterpret_cast<const void*>(rp_kernel<kF4, NS>), reinterpret_cast<const void*>(rp_kernel<kF5, NS>),
      reinterpret_cast<const void*>(rp_kernel<kB2, NS>), reinterpret_cast<const void*>(rp_kernel<kB3, NS>),
      reinterpret_cast<const void*>(rp_kernel<kB4, NS>), reinterpret_cast<const void*>(rp_kernel<kB5, NS>)};
  cudaError_t e = cudaSuccess;
  for (const void* k : kernels)
    if (e == cudaSuccess) e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return e;
}

const DeviceInfo& device_info() {
  return per_device<DeviceInfo>([](int dev) {
    DeviceInfo d{132, 0, nullptr};
    cudaError_t e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = allow_smem<128>();
    if (e == cudaSuccess) e = allow_smem<64>();
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(reinterpret_cast<const void*>(dw_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    if (e == cudaSuccess) e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e == cudaSuccess && (q != cudaDriverEntryPointSuccess || !fn)) e = cudaErrorSymbolNotFound;
    d.encode = reinterpret_cast<EncodeTiled>(fn);
    d.err = static_cast<int>(e);
    return d;
  });
}

// A 2D map over a bf16 matrix (rows x cols, ld elements apart), boxes of
// box_rows x 64 columns, 128-byte swizzle; reads past the edges give zeros.
int make_map(CUtensorMap* m, const void* base, long long rows, int cols, int ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKB), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = device_info().encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, es,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrMap;
}

// Whether a pass streams its weight slices at slice ns: they do not fit in
// shared memory beside rings of kMinStages
bool streams(int ns, int kin0, int kin1, bool ybuf, bool out) {
  return rp_stages(ns, kin0, kin1, ybuf, out, false) < kMinStages;
}

// The slice of every pass of a call: 128 output channels where every pass's
// weights fit in shared memory at 128, else 64 (a pass whose weights do not
// fit at 64 either streams them).
int slice_of(const Dims& d) {
  struct Need {
    int kin0, kin1;
    bool ybuf, out;
  };
  const Need passes[] = {{d.C1, 0, false, false}, {d.C1, 0, false, true},   // F2, F3
                         {d.C2, 0, false, false}, {d.C2, 0, true, false},   // F4, F5
                         {d.C2, 0, false, true},  {d.C3, d.C1, false, true},  // B2, B3
                         {d.C1, 0, false, true},  {d.C2, 0, false, true}};  // B4, B5
  for (const Need& n : passes)
    if (streams(128, n.kin0, n.kin1, n.ybuf, n.out)) return 64;
  return 128;
}

// F5 takes the max over K within its tiles where K is a power of two up to
// 64; else scan_kernel takes it from y3
bool tile_scan(const Dims& d) { return d.K <= 64 && (d.K & (d.K - 1)) == 0; }

// Blocks of a pass along the rows: the SMs over its slices, and no more than
// the pairs of tiles.
int row_blocks(const Dims& d, int nout, int ns) {
  const long long slices = cdiv(nout, ns);
  long long x = device_info().sms / slices;
  if (x < 1) x = 1;
  const long long pairs = cdiv(tiles_of(d), 2);
  return static_cast<int>(x < pairs ? x : pairs);
}

// dW row split: about kWantBlocks blocks over the tiles, chunks of whole 64-row
// steps, of at most kDwMaxRows rows where the grid's z allows it
void dw_split(const Dims& d, int I, int J, int* P, long long* chunk) {
  const long long tiles = cdiv(I, 128) * cdiv(J, 128);
  long long p = cdiv(kWantBlocks, tiles);
  p = p < tiles_of(d) ? p : tiles_of(d);
  const long long most = cdiv(d.R, kDwMaxRows) < kMaxGridY ? cdiv(d.R, kDwMaxRows) : kMaxGridY;
  if (p < most) p = most;
  const long long ch = cdiv(cdiv(d.R, p), kRows) * kRows;
  *P = static_cast<int>(cdiv(d.R, ch));
  *chunk = ch;
}

struct Workspace {  // byte offsets into one buffer
  size_t part, part2, count, fold, y3, coef, share, dwpart, dy3, dz2, dy2, dz1, ordered, total;
};

Workspace layout(const Dims& d, bool backward) {
  Workspace w{};
  const size_t C = static_cast<size_t>(cmax(d));
  long long P = stat_chunks(d);
  if (2LL * device_info().sms > P) P = 2LL * device_info().sms;
  if (backward && cent_chunks(d) > P) P = cent_chunks(d);
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
  if (!backward && !tile_scan(d)) w.y3 = take(static_cast<size_t>(d.R) * d.C3 * sizeof(float));
  if (backward) {
    w.coef = take(6 * C * sizeof(float));
    w.share = take(static_cast<size_t>(centroids(d)) * d.C3 * sizeof(float));
    int P3, P2;
    long long ch;
    dw_split(d, d.C2, d.C3, &P3, &ch);
    dw_split(d, d.C1, d.C2, &P2, &ch);
    const size_t e3 = static_cast<size_t>(P3) * d.C2 * d.C3, e2 = static_cast<size_t>(P2) * d.C1 * d.C2;
    w.dwpart = take((e3 > e2 ? e3 : e2) * sizeof(float));
    const size_t R = static_cast<size_t>(d.R);
    w.dy3 = take(R * round8(d.C3) * 2);
    w.dz2 = take(R * round8(d.C2) * 2);
    w.dy2 = take(R * round8(d.C2) * 2);
    w.dz1 = take(R * round8(d.C1) * 2);
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
  if (d->R > 0x7fffffffLL - 2 * kRows || static_cast<long long>(B) * N > 0x7fffffffLL)
    return kErrArgs;
  int P;
  long long ch;
  dw_split(*d, d->C2, d->C3, &P, &ch);
  if (P > 65535) return kErrArgs;
  return 0;
}

// One row pass: maps of its A grids (a0, a1; R rows, widths kin0, kin1, ld
// round8 of them) and weights (w0, w1: nout rows, ld round8 of the inputs).
template <int P>
int run_pass(const Dims& d, PassArgs p, const void* a0, const void* a1, const void* wt0,
             const void* wt1, cudaStream_t st) {
  const int ns = slice_of(d);
  CUtensorMap m[5];  // A of each product, each weight, the output; an unused one repeats W0's
  RUN(make_map(&m[2], wt0, p.nout, p.kin0, round8(p.kin0), ns));
  m[0] = m[1] = m[3] = m[4] = m[2];
  if (tma_out<P>()) RUN(make_map(&m[4], p.out, d.R, p.nout, p.out_ld, kRows));
  if (wt1) RUN(make_map(&m[3], wt1, p.nout, p.kin1, round8(p.kin1), ns));
  if (a0) RUN(make_map(&m[0], a0, d.R, p.kin0, round8(p.kin0), kRows));
  if (a1) RUN(make_map(&m[1], a1, d.R, p.kin1, round8(p.kin1), kRows));
  p.tiles = static_cast<int>(tiles_of(d));
  const bool ws = streams(ns, p.kin0, p.kin1, P == kF5, tma_out<P>());
  p.wstream = ws;
  p.stages = rp_stages(ns, p.kin0, p.kin1, P == kF5, tma_out<P>(), ws);
  const dim3 grid(row_blocks(d, p.nout, ns), static_cast<unsigned>(cdiv(p.nout, ns)));
  const size_t smem = static_cast<size_t>(rp_fixed(ns, p.kin0, p.kin1, P == kF5, tma_out<P>(), ws) +
                                          2LL * p.stages * rp_stage_bytes(ns, ws));
  if (ns == 128) rp_kernel<P, 128><<<grid, kRPThreads, smem, st>>>(m[0], m[1], m[2], m[3], m[4], p);
  else rp_kernel<P, 64><<<grid, kRPThreads, smem, st>>>(m[0], m[1], m[2], m[3], m[4], p);
  LAUNCH_CHECK();
  return 0;
}

int dw(const Dims& d, const void* x, int I, const void* dy, int J, float* part, float* out,
       cudaStream_t st) {
  int P;
  long long chunk;
  dw_split(d, I, J, &P, &chunk);
  CUtensorMap mx, md;
  RUN(make_map(&mx, x, d.R, I, round8(I), kRows));
  RUN(make_map(&md, dy, d.R, J, round8(J), kRows));
  const size_t smem = 1024 + kDwStages * kDwStage + 16 * kDwStages;
  dw_kernel<<<dim3(cdiv(I, 128), cdiv(J, 128), P), kRPThreads, smem, st>>>(
      mx, md, part, I, J, static_cast<int>(d.R), static_cast<int>(chunk));
  LAUNCH_CHECK();
  const long long E = static_cast<long long>(I) * J;
  sum_partials_kernel<<<cdiv(E, kThreads), kThreads, 0, st>>>(part, out, P, E);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

// Bytes of workspace that sa_train_bf16_fwd (backward = 0) or
// sa_train_bf16_bwd (1) needs; a negative code for shapes they refuse.
extern "C" long long sa_train_bf16_workspace(int B, int N, int S, int K, int C1, int C2, int C3,
                                             int backward) {
  Dims d;
  const int rc = check(B, N, S, K, C1, C2, C3, &d);
  if (rc) return rc;
  if (device_info().err) return device_info().err;
  return static_cast<long long>(layout(d, backward != 0).total);
}

// The forward, in one call (sg.stage < 0) or one stage of it.
static int fwd_impl(const float* a, const float* ct, const int* idx, const uint16_t* w2t,
                    const float* b2, const uint16_t* w3t, const float* b3, const float* bn,
                    uint16_t* h1, uint16_t* h2, float* mxt, float* y3, float* stats, void* ws,
                    int B, int N, int S, int K, int C1, int C2, int C3, const Staging& sg,
                    void* stream) {
  Dims d;
  RUN(check(B, N, S, K, C1, C2, C3, &d));
  RUN(device_info().err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w = layout(d, false);
  char* base = static_cast<char*>(ws);
  double* part = reinterpret_cast<double*>(base + w.part);
  float* fold = reinterpret_cast<float*>(base + w.fold);
  const Fin fin{reinterpret_cast<double*>(base + w.part2),
                reinterpret_cast<unsigned*>(base + w.count)};
  const cudaError_t e = cudaMemsetAsync(fin.count, 0, w.fold - w.count, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int Cm = cmax(d), ns = slice_of(d);
  const float *g1 = bn, *bt1 = bn + C1, *g2 = bn + 2 * C1, *bt2 = g2 + C2, *g3 = bt2 + C2,
              *bt3 = g3 + C3;
  float *mu1 = stats, *v1 = stats + C1, *mu2 = stats + 2 * C1, *v2 = mu2 + C2, *mu3 = v2 + C2,
        *v3 = mu3 + C3;
  float *fold1 = fold, *fold2 = fold + 3 * Cm, *fold3 = fold + 6 * Cm;
  const int P2 = 2 * row_blocks(d, C2, ns), P3 = 2 * row_blocks(d, C3, ns);

  const auto in = [&](int k) { return sg.stage < 0 || sg.stage == k; };
  bool stop = false;
  // F1: y1's statistics, gathered
  if (in(0)) {
    y1_stats_kernel<true><<<dim3(cdiv(C1, 32), grid_y(stat_chunks(d))), dim3(32, 8), 0, st>>>(
        a, ct, idx, d, part);
    LAUNCH_CHECK();
  }
  RUN(sync_fwd(sg, 0, part, stat_chunks(d), C1, d, fin, g1, bt1, mu1, v1, fold1, st, &stop));
  if (stop) return 0;
  PassArgs p{};
  p.d = d;
  p.a = a;
  p.ct = ct;
  p.idx = idx;
  // h1; F2: y2's sums
  p.nout = C2;
  p.kin0 = C1;
  p.bias = b2;
  p.part = part;
  if (in(1)) {
    const long long row_blocks8 = cdiv(d.R, 8);
    h1_kernel<<<dim3(cdiv(C1 / 4, 32), row_blocks8 < 65535 ? row_blocks8 : 65535), dim3(32, 8), 0,
                st>>>(a, ct, idx, d, fold1, h1, round8(C1));
    LAUNCH_CHECK();
    RUN(run_pass<kF2>(d, p, h1, nullptr, w2t, nullptr, st));
  }
  RUN(sync_fwd(sg, 1, part, P2, C2, d, fin, g2, bt2, mu2, v2, fold2, st, &stop));
  if (stop) return 0;
  // F3: h2
  p.fold = fold2;
  p.out = h2;
  p.out_ld = round8(C2);
  if (in(2)) RUN(run_pass<kF3>(d, p, h1, nullptr, w2t, nullptr, st));
  // F4: y3's sums
  p.nout = C3;
  p.kin0 = C2;
  p.bias = b3;
  p.fold = nullptr;
  p.out = nullptr;
  if (in(2)) RUN(run_pass<kF4>(d, p, h2, nullptr, w3t, nullptr, st));
  RUN(sync_fwd(sg, 2, part, P3, C3, d, fin, g3, bt3, mu3, v3, fold3, st, &stop));
  if (stop) return 0;
  // F5: the max over K, its ties and their yhat3
  p.fold = fold3;
  p.mean = mu3;
  p.mxt = mxt;
  p.tscan = tile_scan(d);
  p.y3 = y3 || p.tscan ? y3 : reinterpret_cast<float*>(base + w.y3);
  RUN(run_pass<kF5>(d, p, h2, nullptr, w3t, nullptr, st));
  if (!p.tscan) {
    scan_kernel<<<cdiv(centroids(d) * C3, kThreads), kThreads, 0, st>>>(p.y3, fold3, mu3, d, mxt);
    LAUNCH_CHECK();
  }
  return 0;
}

// Forward. a (B, N, C1) f32 (rounded to bf16 here as it is read), ct (B, S,
// C1), idx (B, S, K); w2t (C2 x round8(C1)) and w3t (C3 x round8(C2)): W2^T and
// W3^T in bf16; bn = [g1, bt1 (C1), g2, bt2 (C2), g3, bt3 (C3)]. Writes h1 (R x
// round8(C1)) and h2 (R x round8(C2)) in bf16, mxt (3, B * S, C3): out = max_k
// relu(BN3(y3)), the number of its ties and the sum of yhat3 over them; stats =
// [mean1, var1, mean2, var2, mean3, var3]. y3: null, or (R x C3) f32 where the
// max pass writes the y3 it took the maxima on (a check's copy of the
// product the backward computes again; where null and K is not a power of two
// up to 64, the workspace holds it for scan_kernel).
extern "C" int sa_train_bf16_fwd(const float* a, const float* ct, const int* idx,
                                 const uint16_t* w2t, const float* b2, const uint16_t* w3t,
                                 const float* b3, const float* bn, uint16_t* h1, uint16_t* h2,
                                 float* mxt, float* y3, float* stats, void* ws, int B, int N, int S,
                                 int K, int C1, int C2, int C3, void* stream) {
  return fwd_impl(a, ct, idx, w2t, b2, w3t, b3, bn, h1, h2, mxt, y3, stats, ws, B, N, S, K, C1, C2,
                  C3, Staging{-1, nullptr}, stream);
}

// sa_train_bf16_fwd in stages 0-3 (k6_common.cuh, Staging): the same
// arguments and workspace at every stage, and sums (2 * max(C1, C2, C3) + 1
// doubles).
extern "C" int sa_train_bf16_fwd_staged(const float* a, const float* ct, const int* idx,
                                        const uint16_t* w2t, const float* b2, const uint16_t* w3t,
                                        const float* b3, const float* bn, uint16_t* h1,
                                        uint16_t* h2, float* mxt, float* y3, float* stats,
                                        void* ws, int B, int N, int S, int K, int C1, int C2,
                                        int C3, int stage, double* sums, void* stream) {
  if (stage < 0 || stage > 3) return kErrArgs;
  return fwd_impl(a, ct, idx, w2t, b2, w3t, b3, bn, h1, h2, mxt, y3, stats, ws, B, N, S, K, C1, C2,
                  C3, Staging{stage, sums}, stream);
}

// The backward, in one call (sg.stage < 0) or one stage of it.
static int bwd_impl(const float* g, const float* a, const float* ct, const int* idx,
                    const uint16_t* h1, const uint16_t* h2, const float* mxt, const float* stats,
                    const uint16_t* w2t, const uint16_t* w3t, const uint16_t* w2,
                    const uint16_t* w3, const float* b2, const float* b3, const float* bn,
                    float* da, float* dct, float* dw2, float* dw3, float* dbn, void* ws, int B,
                    int N, int S, int K, int C1, int C2, int C3, int ordered, const Staging& sg,
                    void* stream) {
  Dims d;
  RUN(check(B, N, S, K, C1, C2, C3, &d));
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
  float* share = reinterpret_cast<float*>(base + w.share);
  float* dwpart = reinterpret_cast<float*>(base + w.dwpart);
  uint16_t* dy3 = reinterpret_cast<uint16_t*>(base + w.dy3);
  uint16_t* dz2 = reinterpret_cast<uint16_t*>(base + w.dz2);
  uint16_t* dy2 = reinterpret_cast<uint16_t*>(base + w.dy2);
  uint16_t* dz1 = reinterpret_cast<uint16_t*>(base + w.dz1);
  const int Cm = cmax(d), ns = slice_of(d);
  const int Cs[3] = {C1, C2, C3};
  float* dbn_l[3] = {dbn, dbn + 2 * C1, dbn + 2 * (C1 + C2)};  // (dgamma, dbeta) of each layer
  float* fold_l[3] = {fold, fold + 3 * Cm, fold + 6 * Cm};
  float* coef_l[3] = {coef, coef + 2 * Cm, coef + 4 * Cm};
  const float* mean_l[3] = {stats, stats + 2 * C1, stats + 2 * (C1 + C2)};
  const auto in = [&](int k) { return sg.stage < 0 || sg.stage == k; };
  bool stop = false;
  const float* bn_l = bn;
  for (int l = 0; l < 3 && in(0); ++l) {
    fold_kernel<<<cdiv(Cs[l], kThreads), kThreads, 0, st>>>(mean_l[l], mean_l[l] + Cs[l], bn_l,
                                                             bn_l + Cs[l], fold_l[l], Cs[l]);
    LAUNCH_CHECK();
    bn_l += 2 * Cs[l];
  }
  const long long BS = centroids(d);
  // B1: dz3's sums from the forward's ties, and the shares
  if (in(0)) {
    dz3_sums_kernel<<<dim3(cdiv(C3, 32), grid_y(cent_chunks(d))), dim3(32, 8), 0, st>>>(
        mxt, g, share, part, BS, C3);
    LAUNCH_CHECK();
  }
  RUN(sync_bwd(sg, 0, part, cent_chunks(d), C3, d, fin, dbn_l[2], dbn_l[2] + C3, coef_l[2], st,
               &stop));
  if (stop) return 0;
  PassArgs p{};
  p.d = d;
  p.a = a;
  p.ct = ct;
  p.idx = idx;
  p.part = part;
  // B2: dy3
  p.nout = C3;
  p.kin0 = C2;
  p.bias = b3;
  p.fold = fold_l[2];
  p.mean = mean_l[2];
  p.coef = coef_l[2];
  p.mxt = const_cast<float*>(mxt);
  p.share = share;
  p.out = dy3;
  p.out_ld = round8(C3);
  if (in(1)) {
    RUN(run_pass<kB2>(d, p, h2, nullptr, w3t, nullptr, st));
    // dW3 = h2^T dy3
    RUN(dw(d, h2, C2, dy3, C3, dwpart, dw3, st));
  }
  // B3: dz2 = (dy3 W3^T) where h2 > 0, its sums with yhat2
  p.nout = C2;
  p.kin0 = C3;
  p.kin1 = C1;
  p.bias = b2;
  p.fold = fold_l[1];
  p.mean = mean_l[1];
  p.coef = nullptr;
  p.out = dz2;
  p.out_ld = round8(C2);
  if (in(1)) RUN(run_pass<kB3>(d, p, dy3, h1, w3, w2t, st));
  RUN(sync_bwd(sg, 1, part, 2 * row_blocks(d, C2, ns), C2, d, fin, dbn_l[1], dbn_l[1] + C2,
               coef_l[1], st, &stop));
  if (stop) return 0;
  // B4: dy2
  p.kin0 = C1;
  p.kin1 = 0;
  p.coef = coef_l[1];
  p.gin = dz2;
  p.gin_ld = round8(C2);
  p.out = dy2;
  if (in(2)) {
    RUN(run_pass<kB4>(d, p, h1, nullptr, w2t, nullptr, st));
    // dW2 = h1^T dy2
    RUN(dw(d, h1, C1, dy2, C2, dwpart, dw2, st));
  }
  // B5: dz1 = (dy2 W2^T) where h1 > 0, its sums with yhat1
  p.nout = C1;
  p.kin0 = C2;
  p.bias = nullptr;
  p.fold = fold_l[0];
  p.mean = mean_l[0];
  p.coef = nullptr;
  p.out = dz1;
  p.out_ld = round8(C1);
  if (in(2)) RUN(run_pass<kB5>(d, p, dy2, nullptr, w2, nullptr, st));
  RUN(sync_bwd(sg, 2, part, 2 * row_blocks(d, C1, ns), C1, d, fin, dbn_l[0], dbn_l[0] + C1,
               coef_l[0], st, &stop));
  if (stop) return 0;
  // B6: dct = sum_k dy1; da = the sum of bf16(dy1) at idx, in a fixed order or by atomics
  const unsigned blocks = static_cast<unsigned>(cdiv(BS * C1, kThreads));
  if (ordered) {
    scatter_kernel<true><<<blocks, kThreads, 0, st>>>(a, ct, idx, d, dz1, round8(C1), fold_l[0],
                                                      mean_l[0], coef_l[0], da, dct);
    LAUNCH_CHECK();
    return ordered_da(d, idx, dz1, round8(C1), ordered_at(d, base + w.ordered), da, st);
  }
  e = cudaMemsetAsync(da, 0, static_cast<size_t>(B) * N * C1 * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<false><<<blocks, kThreads, 0, st>>>(a, ct, idx, d, dz1, round8(C1), fold_l[0],
                                                     mean_l[0], coef_l[0], da, dct);
  LAUNCH_CHECK();
  return 0;
}

// Backward from the forward's inputs a, ct, idx, its grids h1, h2, mxt and
// statistics, and the output's cotangent g (B, S, C3) f32. w2t, w3t as the
// forward's; w2 (C1 x round8(C2)) and w3 (C2 x round8(C3)) W2 and W3 in bf16.
// Writes da (B, N, C1), dct (B, S, C1), dw2 (C1 x C2), dw3 (C2 x C3) and dbn =
// [dg1, dbt1, dg2, dbt2, dg3, dbt3]. ordered != 0: da summed in a fixed order
// (ordered_da), else by float atomics.
extern "C" int sa_train_bf16_bwd(const float* g, const float* a, const float* ct, const int* idx,
                                 const uint16_t* h1, const uint16_t* h2, const float* mxt,
                                 const float* stats, const uint16_t* w2t, const uint16_t* w3t,
                                 const uint16_t* w2, const uint16_t* w3, const float* b2,
                                 const float* b3, const float* bn, float* da, float* dct,
                                 float* dw2, float* dw3, float* dbn, void* ws, int B, int N, int S,
                                 int K, int C1, int C2, int C3, int ordered, void* stream) {
  return bwd_impl(g, a, ct, idx, h1, h2, mxt, stats, w2t, w3t, w2, w3, b2, b3, bn, da, dct, dw2,
                  dw3, dbn, ws, B, N, S, K, C1, C2, C3, ordered, Staging{-1, nullptr}, stream);
}

// sa_train_bf16_bwd in stages 0-3 (k6_common.cuh, Staging), as
// sa_train_bf16_fwd_staged.
extern "C" int sa_train_bf16_bwd_staged(const float* g, const float* a, const float* ct,
                                        const int* idx, const uint16_t* h1, const uint16_t* h2,
                                        const float* mxt, const float* stats, const uint16_t* w2t,
                                        const uint16_t* w3t, const uint16_t* w2,
                                        const uint16_t* w3, const float* b2, const float* b3,
                                        const float* bn, float* da, float* dct, float* dw2,
                                        float* dw3, float* dbn, void* ws, int B, int N, int S,
                                        int K, int C1, int C2, int C3, int ordered, int stage,
                                        double* sums, void* stream) {
  if (stage < 0 || stage > 3) return kErrArgs;
  return bwd_impl(g, a, ct, idx, h1, h2, mxt, stats, w2t, w3t, w2, w3, b2, b3, bn, da, dct, dw2,
                  dw3, dbn, ws, B, N, S, K, C1, C2, C3, ordered, Staging{stage, sums}, stream);
}
