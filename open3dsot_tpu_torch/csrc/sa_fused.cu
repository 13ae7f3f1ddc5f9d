// Fused eval-mode set abstraction for Hopper (sm_90a), layers 2-3 on the tensor
// cores in 3xTF32 (tf32_tc.cuh).
//
// K4  sa_fused_k4 with idx == nullptr replaces open3dsot_tpu/ops/sa_fused.py::
//     fused_sa_apply with idx=None (Pallas kernel _sa_bq_kernel, call :384):
//     ball query, gather of the layer-1 A-form rows, + ct, ReLU, two folded
//     Dense+ReLU layers, max over the K neighbors -> (B, S, C3).
// K5  the same entry with idx (B, S, K) given replaces fused_sa_apply with idx
//     (Pallas kernel _sa_kernel, call :415): the ball query is skipped.
//
// Layer 1 in A-form (open3dsot_tpu/ops/sa_fused.py::a_form):
//   layer1(concat((x_j - c_s) / r, f_j)) = A[j] + ct[s],
//   A = (x / r) W1_xyz + f W1_feat over all N points (B, N, C1): torch.matmul
//   outside, as JAX computes it in XLA outside the pallas_call;
//   ct = b1 - (c / r) W1_xyz per centroid: here, three FMAs a channel.
//
// What bounds it on this card. At BAT/P2B widths a centroid's K x (C1 C2 +
// C2 C3) multiply-adds (32 x 12288 up to 32 x 131072) dwarf its bytes, so the
// products bound it: 67 TFLOP/s in f32 on the CUDA cores, or 3 x FLOP at 494.7
// TFLOP/s in 3xTF32 on the tensor cores (2.5x less time, f32 accuracy:
//   a * w ~ a_lo * w_hi + a_hi * w_lo + a_hi * w_hi,  hi = rna_tf32, lo = rna_tf32(x - hi)).
// Nearer on the chip: a 64-row tile is 786K multiply-adds of 3xTF32 a
// weight chunk, and the same warps that run them first load and split that
// chunk's A fragments and then wait for the products; the narrow first
// layers (64 -> 64 -> 128: four chunks a tile) pay a tile's fixed costs
// (indices, ct, the gather, the max) for little product.
//
// What the design does about it.
//  - Tiles. A block owns 64 rows of the (B, S, K) grid: ts = 64 / K whole
//    centroids (2 at K = 32, 4 at the vote layer's K = 16), so the max over
//    K is the block's own; no atomics, no second pass. Two warpgroups each run
//    wgmma m64n64k8 (TF32, f32 accumulate) on half of a 128-channel weight
//    chunk, A from registers, split hi/lo as each fragment is loaded from a
//    padded row-major tile (row stride width + 4 floats: the fragment loads
//    hit 32 banks), B (W^T) from shared memory. No branch around wgmma
//    (ptxas would serialise it): widths are zero-padded chunks.
//  - Sums. The tensor cores do not round their f32 sums to nearest, so only
//    one chunk's 12 products (32 inputs, lo * hi, hi * lo, hi * hi) are
//    summed there, queued back to back; each chunk's sum is added to the
//    accumulators on the CUDA cores (as K6 does). Summing each 8-input hi *
//    hi product apart as well (K1/K2's order) needs about 190 registers a
//    thread, more than the 168 that 288 threads leave, and spilled: the
//    products took 1.38 ms over the seven BAT calls at B = 16 against 1.22
//    (H100 80GB HBM3, 700 W).
//  - Weights. Packed once on the host (ops/chain_fused.py::pack_chunks) in
//    whole chunks of 128 output x 32 input channels, W^T hi then W^T lo in the
//    tensor cores' layout; one bulk copy (TMA) a chunk, on an mbarrier, into a
//    ring of as many stages as shared memory holds (2 at C = 256, 4 below).
//    A producer warp streams them: it refills a stage as soon as the eight
//    product warps have released it (empty mbarriers), so no block barrier
//    stands between chunks and the warpgroups need not run in step; the
//    first chunks load while the block gathers its rows.
//  - Gather. Layer 1 is never formed: the block copies its rows' A-form rows
//    raw into shared memory, and relu(A + ct) is applied as layer 2 loads its
//    A fragments; ct is computed per tile. Two of the P1 probe's exact forms
//    (probes/gather.py) are built: 16-byte loads through registers, four in
//    flight a thread (kLdg), and 16-byte cp.async (kCpAsync). Timed in K4 at
//    BAT's seven calls, loads win where a row is 64 floats (search SA0 at B =
//    16: 0.2480 against 0.2931 ms) and cp.async by 1-3% at 128 and 256, at B
//    = 1 and 16 alike (H100 80GB HBM3, 700 W), so the form follows C1.
//  - Layer 3 and the max. Each 128-channel chunk of layer 3 is ReLU'd into
//    shared memory (the gathered rows' space, free by then) and reduced over
//    each centroid's K rows by one thread a channel; the max starts at 0
//    (every value is a ReLU output), and only the tile's real rows enter it:
//    a zero row would give relu(b), not 0. Taking the max from the
//    accumulators instead (a reduce-scatter of each thread's 16 column maxima
//    over the warp's rows by shuffles, then an atomic max of the bits across
//    warps) was 2% slower over the seven calls at B = 1 and 16, and one
//    shuffle chain and atomic per value 12% slower: the staged chunk's
//    stores and column loads cost less than the shuffles.
//  - Filling the card (the host's plan). At B = 1 the tiles alone fill at
//    most a card's width (16 at the vote layer, 32-256 elsewhere), so the
//    grid may also split layer 3's output chunks over blocks, each block then
//    computing layer 2 again: the plan picks the split with the fewest
//    chunk-steps on the slowest SM (waves x chunks a block). At BAT's widths
//    that splits template SA1/SA2, search SA2 and the vote layer in two at
//    B = 1 (layer 2 computed twice: a third to a half more products) and
//    nothing at B = 16.
//  - Ball query (K4): a kernel of its own before the products, one warp per
//    centroid walking the points in chunks of 32 (strict d^2 < r^2, d^2 =
//    ((dx*dx) + (dy*dy)) + (dz*dz) with __fmul_rn/__fadd_rn, the rounding of
//    the plain version); a ballot and popc give each in-ball point its slot
//    in ascending index order; the walk stops once K are found; slots past
//    the count repeat the first; a centroid with no point in the ball gets
//    index 0 (the CUDA op's convention). r^2 comes from the host, rounded
//    once from double to f32 as JAX's weak-typed float. The indices go to a
//    (B, S, K) buffer the wrapper allocates, and the product kernel reads
//    them as K5 reads the caller's.
//  - Ragged tiles. A last tile with fewer centroids gathers zero rows past
//    them, and they stay out of the max and the output. An index outside
//    [0, N) in K5's idx reads nothing; its centroid's output is NaN.
//
//  - Shapes the tiles do not hold: K > 64, or h1's and h2's tiles beside two
//    weight stages past 227 KB (C1 + C2 above about 600), run on the eval
//    rows path (sa_fused_train.cu::sa_rows_eval), which the wrapper
//    (ops/sa_fused.py::_launch) takes for K > 64 and for kErrSmem.
//
// The bf16 mode is sa_fused_bf16.cu; the ball query is ball_query.cuh.
//
// Interface: plain C, loaded with ctypes; pointers are device pointers and the
// stream is PyTorch's current stream. Returns 0, a CUDA error code, or a
// negative code for arguments the kernels do not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_query.cuh"  // bq_kernel
#include "tf32_tc.cuh"     // kCC x kKC weight chunks, the TF32 split, wgmma, TMA
#include "per_device.cuh"  // per_device: set-up once for each card

namespace {

constexpr int kTile = 64;            // rows of a tile: wgmma's M
constexpr int kConsumers = 256;      // two warpgroups of products
constexpr int kThreads = kConsumers + 32;  // and a producer warp that streams the weights
constexpr int kMaxStages = 4;        // weight chunks in shared memory
constexpr int kRedStride = kCC + 8;  // floats between rows of layer 3's staged chunk
constexpr int kSmemMax = 232448;     // 227 KB, the most a block may take

constexpr int kErrArgs = -1;    // B, N, S, K or widths not accepted
constexpr int kErrWidth = -2;   // a width is not a multiple of 4
constexpr int kErrSmem = -3;    // two weight stages do not fit beside the tile
constexpr int kErrPacked = -4;  // a packed weight has the wrong size

// How a tile's A-form rows reach shared memory (the forms of the P1 probe,
// csrc/gather_probe.cu): 16-byte loads through registers, or 16-byte cp.async.
enum Gather { kLdg = 0, kCpAsync = 1 };

struct SAArgs {
  const float* centers;  // (B, S, 3)
  const int* idx;        // (B, S, K)
  const float* a;        // (B, N, C1) A-form rows
  const float* w1x;      // (3, C1): layer 1's rows for xyz, or nullptr (ct = b1)
  const float* b1;       // (C1)
  const float* w2;       // packed (ops/chain_fused.py::pack_chunks)
  const float* b2;       // (C2)
  const float* w3;       // packed
  const float* b3;       // (C3)
  float* out;            // (B, S, C3)
  int B, N, S, K, C1, C2, C3;
  float inv_r;
  int ts;                // centroids per tile: kTile / K
  int nk2, nk3;          // input chunks of layers 2 and 3
  int nc2, nc3;          // output chunks of layers 2 and 3
  int cz;                // layer-3 output chunks per block: blockIdx.z takes [z cz, z cz + cz)
  int nst;               // weight stages
  int s1, s2;            // row strides (elements) of the gathered rows and of layer 2
  int o_h2, o_ct, o_idx, o_w, o_bar;  // shared-memory offsets in floats
};

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Weight chunk u of this block: layer 2's chunks in order, then layer 3's
// output chunks [c30, ...) with their input chunks.
__device__ __forceinline__ const float* chunk_src(const SAArgs& p, int u, int c30) {
  const int u2 = p.nc2 * p.nk2;
  return u < u2 ? p.w2 + static_cast<long long>(u) * kWStage
                : p.w3 + (static_cast<long long>(c30) * p.nk3 + (u - u2)) * kWStage;
}

// The consumer warps' barrier (named barrier 1; the producer warp goes on).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// One weight chunk's products into acc: chunk t (stage t % nst) times the 32
// input channels [kb * kKC, +32) of the row tile hin (stride sin floats). kCt:
// the rows are raw A-form rows, so each value is relu(v + ct) of its row's
// centroid (ct0, ct1 for the thread's rows g and g + 8). full[s]: stage s holds
// its chunk; empty[s]: the eight consumer warps are done with it.
template <bool kCt>
__device__ __forceinline__ void chunk_products(const SAArgs& p, float (&acc)[8][4], int t,
                                               float* wsm, uint64_t* full, uint64_t* empty,
                                               const float* hin, int sin, int kb, const float* ct0,
                                               const float* ct1) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int rbase = (warp & 3) * 16, cbase = (warp >> 2) * 64;
  const int st = t % p.nst;
  mbar_wait(&full[st], (t / p.nst) & 1);  // chunk t has landed
  // the chunk's products queue on the tensor cores back to back, summed there
  // (32 inputs), and the chunk's sum is added to acc on the CUDA cores
  float part[8][4];
  const float* wh = wsm + st * kWStage;
  const float* wl = wh + kWPart;
  uint32_t ah[kKC / 8][4], al[kKC / 8][4];
#pragma unroll
  for (int ks = 0; ks < kKC / 8; ++ks) {
    const int k = kb * kKC + ks * 8 + q;
    const float* pa = hin + (rbase + g) * sin + k;
    float v[4] = {pa[0], pa[8 * sin], pa[4], pa[8 * sin + 4]};
    if constexpr (kCt) {
      v[0] = fmaxf(v[0] + ct0[k], 0.f);
      v[1] = fmaxf(v[1] + ct1[k], 0.f);
      v[2] = fmaxf(v[2] + ct0[k + 4], 0.f);
      v[3] = fmaxf(v[3] + ct1[k + 4], 0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[ks][i], al[ks][i]);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kKC / 8; ++ks) {
    const uint64_t dh = smem_desc(wh + wofs(cbase, ks * 8));
    const uint64_t dl = smem_desc(wl + wofs(cbase, ks * 8));
    if (ks == 0) wgmma_m64n64k8<0>(part, al[ks], dh);
    else wgmma_m64n64k8<1>(part, al[ks], dh);
    wgmma_m64n64k8<1>(part, ah[ks], dl);
    wgmma_m64n64k8<1>(part, ah[ks], dh);
  }
  wgmma_commit();
  wgmma_wait<0>();  // all of the chunk's products are in before its stage is refilled
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_operand(part[nt][i]);
      acc[nt][i] += part[nt][i];
    }
}

// acc = the bias of output chunk cb at this thread's columns (0 past C)
__device__ __forceinline__ void init_bias(float (&acc)[8][4], const float* bias, int C, int cb) {
  const int tid = threadIdx.x, q = tid & 3, cbase = ((tid >> 5) >> 2) * 64;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = cb * kCC + cbase + nt * 8 + 2 * q;
    const float b0 = n < C ? __ldg(bias + n) : 0.f, b1 = n + 1 < C ? __ldg(bias + n + 1) : 0.f;
    acc[nt][0] = acc[nt][2] = b0;
    acc[nt][1] = acc[nt][3] = b1;
  }
}

// Block (x, y, z): tile x of batch element y (centroids [x ts, x ts + ts)),
// layer 3's output chunks [z cz, z cz + cz); the rows gathered in form F.
template <int F>
__global__ void __launch_bounds__(kThreads, 1) sa_tc_kernel(const SAArgs p) {
  constexpr int kVec = 4;  // floats a 16-byte copy
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* h1 = sm;  // the gathered rows (kTile x s1); then layer 3's
  float* y3 = sm;  // chunk (kTile x kRedStride)
  float* h2 = sm + p.o_h2;  // kTile x s2
  float* cts = sm + p.o_ct;  // ts x (nk2 * kKC)
  int* sidx = reinterpret_cast<int*>(sm + p.o_idx);  // kTile
  int* bad = sidx + kTile;   // ts: the centroid has an index outside [0, N)
  float* wsm = sm + p.o_w;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.o_bar);
  uint64_t* empty = full + p.nst;

  const int b = blockIdx.y, s0 = blockIdx.x * p.ts, K = p.K;
  const int ns = min(p.ts, p.S - s0), nrows = ns * K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int rbase = (warp & 3) * 16, cbase = (warp >> 2) * 64;
  const int c30 = blockIdx.z * p.cz, c31 = min(p.nc3, c30 + p.cz);
  const int U = p.nc2 * p.nk2 + (c31 - c30) * p.nk3;  // this block's weight chunks
  const int w1 = p.nk2 * kKC, w2 = p.nk3 * kKC;       // padded widths of layers 1 and 2

  if (tid == kConsumers) {  // the producer: the first chunks load while the rows are gathered
    for (int i = 0; i < p.nst; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < p.nst && u < U; ++u)
      bulk_load(wsm + u * kWStage, chunk_src(p, u, c30), &full[u]);
  }
  // the tile's indices (-1 past its rows), flags and ct = b1 - (c * inv_r) W1_xyz
  for (int r = tid; r < kTile; r += kThreads)
    sidx[r] = r < nrows ? __ldg(p.idx + (static_cast<long long>(b) * p.S + s0) * K + r) : -1;
  for (int t = tid; t < p.ts; t += kThreads) bad[t] = 0;
  for (int e = tid; e < p.ts * w1; e += kThreads) {
    const int t = e / w1, c = e - t * w1;
    float v = 0.f;
    if (t < ns && c < p.C1) {
      v = __ldg(p.b1 + c);
      if (p.w1x) {
        const float* cp = p.centers + (static_cast<long long>(b) * p.S + s0 + t) * 3;
        const float x = __fmul_rn(cp[0], p.inv_r), y = __fmul_rn(cp[1], p.inv_r),
                    z = __fmul_rn(cp[2], p.inv_r);
        const float d = __fmaf_rn(z, __ldg(p.w1x + 2 * p.C1 + c),
                                  __fmaf_rn(y, __ldg(p.w1x + p.C1 + c), __fmul_rn(x, __ldg(p.w1x + c))));
        v = __fsub_rn(v, d);
      }
    }
    cts[e] = v;
  }
  __syncthreads();  // the barriers, indices and flags are in place

  {  // gather the tile's A-form rows raw; zeros past C1, for rows past the tile and bad indices
    const int c4 = w1 / kVec;  // 16-byte copies a padded row
    const float* ab = p.a + static_cast<long long>(b) * p.N * p.C1;
    if constexpr (F == kCpAsync) {
      for (int e = tid; e < kTile * c4; e += kThreads) {
        const int r = e / c4, c = (e - r * c4) * kVec;
        const int j = sidx[r];
        float* dst = h1 + r * p.s1 + c;
        const bool ok = j >= 0 && j < p.N;
        if (ok && c < p.C1) {
          cp_async16(dst, ab + static_cast<long long>(j) * p.C1 + c);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < nrows && !ok) bad[r / K] = 1;
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    } else {  // kU loads in flight a thread, then their stores
      constexpr int kU = 4;
      for (int e0 = tid; e0 < kTile * c4; e0 += kU * kThreads) {
        float4 v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = e0 + u * kThreads, r = e / c4, c = (e - r * c4) * kVec;
          const int j = e < kTile * c4 ? sidx[r] : -1;
          const bool ok = j >= 0 && j < p.N;
          v[u] = ok && c < p.C1
                     ? __ldg(reinterpret_cast<const float4*>(ab + static_cast<long long>(j) * p.C1 + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
          if (e < kTile * c4 && r < nrows && !ok) bad[r / K] = 1;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = e0 + u * kThreads, r = e / c4, c = (e - r * c4) * kVec;
          if (e < kTile * c4) *reinterpret_cast<float4*>(h1 + r * p.s1 + c) = v[u];
        }
      }
    }
  }
  __syncthreads();  // every thread's copies are seen

  if (warp == kConsumers / 32) {  // the producer warp: chunk u into its stage once all are done with it
    if (lane == 0)
      for (int u = p.nst; u < U; ++u) {
        mbar_wait(&empty[u % p.nst], ((u - p.nst) / p.nst) & 1);
        bulk_load(wsm + (u % p.nst) * kWStage, chunk_src(p, u, c30), &full[u % p.nst]);
      }
    return;
  }

  // the centroids of this thread's rows g and g + 8 (0 past the tile's)
  const int t0 = (rbase + g) / K, t1 = (rbase + g + 8) / K;
  const float* ct0 = cts + (t0 < p.ts ? t0 : 0) * w1;
  const float* ct1 = cts + (t1 < p.ts ? t1 : 0) * w1;

  int t = 0;  // weight chunks consumed
  float acc[8][4];
  // layer 2: h2 = relu(relu(A + ct) W2 + b2), every row, columns up to w2
  for (int cb = 0; cb < p.nc2; ++cb) {
    init_bias(acc, p.b2, p.C2, cb);
    for (int kb = 0; kb < p.nk2; ++kb, ++t)
      chunk_products<true>(p, acc, t, wsm, full, empty, h1, p.s1, kb, ct0, ct1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = cb * kCC + cbase + nt * 8 + 2 * q;
      if (n >= w2) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = fmaxf(acc[nt][2 * h], 0.f), v1 = fmaxf(acc[nt][2 * h + 1], 0.f);
        *reinterpret_cast<float2*>(h2 + (rbase + g + 8 * h) * p.s2 + n) = make_float2(v0, v1);
      }
    }
  }
  consumer_sync();  // h2 is whole, and no warp reads h1 again
  // layer 3, chunk by chunk: relu(h2 W3 + b3) into y3, then the max over each
  // centroid's K rows
  for (int cb = c30; cb < c31; ++cb) {
    init_bias(acc, p.b3, p.C3, cb);
    for (int kb = 0; kb < p.nk3; ++kb, ++t)
      chunk_products<false>(p, acc, t, wsm, full, empty, h2, p.s2, kb, nullptr, nullptr);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = cbase + nt * 8 + 2 * q;
      *reinterpret_cast<float2*>(y3 + (rbase + g) * kRedStride + c) =
          make_float2(fmaxf(acc[nt][0], 0.f), fmaxf(acc[nt][1], 0.f));
      *reinterpret_cast<float2*>(y3 + (rbase + g + 8) * kRedStride + c) =
          make_float2(fmaxf(acc[nt][2], 0.f), fmaxf(acc[nt][3], 0.f));
    }
    consumer_sync();
    for (int e = tid; e < ns * kCC; e += kConsumers) {
      const int tc = e / kCC, c = e - tc * kCC, n = cb * kCC + c;
      if (n >= p.C3) continue;
      float m = 0.f;  // every value is a ReLU output, so >= 0
      const float* col = y3 + tc * K * kRedStride + c;
      for (int k = 0; k < K; ++k) m = fmaxf(m, col[k * kRedStride]);
      const long long o = (static_cast<long long>(b) * p.S + s0 + tc) * p.C3 + n;
      p.out[o] = bad[tc] ? __int_as_float(0x7fc00000) : m;
    }
    consumer_sync();  // y3 is read before the next chunk writes it
  }
}

// --- host: the plan and the launches ----------------------------------------------

struct DeviceInfo {
  int sms;
  int err;
};

const DeviceInfo& device_info() {
  return per_device<DeviceInfo>([](int dev) {
    DeviceInfo d{132, 0};
    cudaError_t e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    const void* kernels[] = {reinterpret_cast<const void*>(sa_tc_kernel<kLdg>),
                             reinterpret_cast<const void*>(sa_tc_kernel<kCpAsync>)};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    d.err = static_cast<int>(e);
    return d;
  });
}

long long packed_floats(int k, int c) {
  return static_cast<long long>(cdiv(round8(c), kCC)) * cdiv(round8(k), kKC) * kWStage;
}

// Widths, shared-memory layout, weight stages and the grid (tiles, B, nz). Rows
// are padded by 4 floats: the fragment loads of a warp hit 32 banks.
int make_plan(SAArgs* p, int sms, dim3* grid, size_t* smem) {
  p->ts = kTile / p->K;
  p->nk2 = cdiv(round8(p->C1), kKC);
  p->nk3 = cdiv(round8(p->C2), kKC);
  p->nc2 = cdiv(round8(p->C2), kCC);
  p->nc3 = cdiv(round8(p->C3), kCC);
  p->s1 = p->nk2 * kKC + 4;
  p->s2 = p->nk3 * kKC + 4;
  const int r1 = kTile * p->s1 > kTile * kRedStride ? kTile * p->s1 : kTile * kRedStride;
  p->o_h2 = r1;
  p->o_ct = p->o_h2 + kTile * p->s2;
  p->o_idx = p->o_ct + p->ts * p->nk2 * kKC;
  p->o_w = (p->o_idx + kTile + p->ts + 31) & ~31;  // 128-byte aligned stages
  for (p->nst = kMaxStages; p->nst >= 2; --p->nst) {
    p->o_bar = p->o_w + p->nst * kWStage;
    *smem = static_cast<size_t>(p->o_bar + 4 * p->nst) * sizeof(float);  // full and empty
    if (*smem <= static_cast<size_t>(kSmemMax)) break;
  }
  if (p->nst < 2) return kErrSmem;
  // split layer 3's output chunks over nz blocks where that shortens the
  // slowest SM's run of chunks (one block per SM: waves x chunks per block)
  const int tiles = cdiv(p->S, p->ts);
  const long long blocks = static_cast<long long>(tiles) * p->B;
  long long best = -1;
  for (int nz = 1; nz <= p->nc3; ++nz) {
    const int cz = cdiv(p->nc3, nz), nzr = cdiv(p->nc3, cz);
    const long long waves = (blocks * nzr + sms - 1) / sms;
    const long long cost = waves * (p->nc2 * p->nk2 + cz * p->nk3);
    if (best < 0 || cost < best) {
      best = cost;
      p->cz = cz;
      *grid = dim3(tiles, p->B, nzr);
    }
  }
  return 0;
}

// The gather form: 16-byte loads for rows of up to 64 floats, cp.async for
// wider ones (K4 timed in both forms at BAT's seven calls; the note at the top).
int plan_gather(int C1) { return C1 <= 64 ? kLdg : kCpAsync; }

}  // namespace

// idx == nullptr: K4 (ball query into idx_ws (B, S, K), xyz used); otherwise
// K5 (xyz and idx_ws unused). centers are read by both (ct). w1x: layer 1's
// three xyz rows (3, C1), or nullptr when layer 1 reads no xyz. r2 is the
// squared radius in f32, inv_r 1 / r or 1. gather: kLdg or kCpAsync, or -1
// for the plan's choice.
extern "C" int sa_fused_k4(const float* xyz, const float* centers, const int* idx, int* idx_ws,
                           const float* a_rows, const float* w1x, const float* b1,
                           const float* w2, long long n_w2, const float* b2, const float* w3,
                           long long n_w3, const float* b3, float* out, int B, int N, int S,
                           int K, int C1, int C2, int C3, float r2, float inv_r, int gather,
                           void* stream) {
  if (B < 1 || B > 65535 || N < 1 || S < 1 || K < 1 || K > kTile || C1 < 1 || C2 < 1 || C3 < 1 ||
      gather < -1 || gather > kCpAsync)
    return kErrArgs;
  if (!centers || (!idx && (!xyz || !idx_ws))) return kErrArgs;
  if (C1 % 4 || C2 % 4 || C3 % 4) return kErrWidth;
  if (n_w2 != packed_floats(C1, C2) || n_w3 != packed_floats(C2, C3)) return kErrPacked;
  const DeviceInfo& dev = device_info();
  if (dev.err) return dev.err;
  SAArgs p{};
  p.centers = centers;
  p.idx = idx ? idx : idx_ws;
  p.a = a_rows;
  p.w1x = w1x;
  p.b1 = b1;
  p.w2 = w2;
  p.b2 = b2;
  p.w3 = w3;
  p.b3 = b3;
  p.out = out;
  p.B = B;
  p.N = N;
  p.S = S;
  p.K = K;
  p.C1 = C1;
  p.C2 = C2;
  p.C3 = C3;
  p.inv_r = inv_r;
  dim3 grid;
  size_t smem = 0;
  const int err = make_plan(&p, dev.sms, &grid, &smem);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!idx) {
    bq_kernel<<<dim3(cdiv(S, kBqThreads / 32), B), kBqThreads, 0, s>>>(xyz, centers, idx_ws, N, S,
                                                                      K, r2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (gather < 0) gather = plan_gather(C1);
  if (gather == kLdg) sa_tc_kernel<kLdg><<<grid, kThreads, smem, s>>>(p);
  else sa_tc_kernel<kCpAsync><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
