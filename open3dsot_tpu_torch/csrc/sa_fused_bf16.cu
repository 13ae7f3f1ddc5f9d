// Fused eval-mode set abstraction in bf16 for Hopper (sm_90a): K4/K5 in the
// JAX kernels' `cdt = bfloat16` (open3dsot_tpu/ops/sa_fused.py:276-420). The
// 3xTF32 mode is sa_fused.cu; the ball query is ball_query.cuh.
//
// K4  sa_fused_k4_bf16 with idx == nullptr replaces open3dsot_tpu/ops/sa_fused.py::
//     fused_sa_apply(dtype=bfloat16) with idx=None (Pallas kernel _sa_bq_kernel,
//     call :384): ball query, then per centroid s and neighbour k (j = idx[s, k])
//       h1 = bf16(relu(bf16(A[j]) + ct[s])), h2 = bf16(relu(h1 W2 + b2)),
//       out[s] = bf16(max_k relu(h2 W3 + b3)),
//     bf16 operands and f32 sums over the whole K of each product. A (B, N, C1)
//     and ct = b1 - (c / r) W1_xyz are layer 1 in A-form (sa_fused.cu's note):
//     A comes f32 from the caller's matmul and is rounded here as it is
//     gathered (the compiled TPU kernel gathers it as bf16); ct is computed here.
// K5  the same entry with idx (B, S, K) given replaces fused_sa_apply with idx
//     (Pallas kernel _sa_kernel, call :415).
//
// What bounds it on this card. At BAT_Car widths a tile of 64 rows (B x S x K
// grid rows) costs 64 x (C1 C2 + C2 C3) multiply-adds, 0.8-8.4 M, against a few
// KB of gathered rows: products at 989 TFLOP/s dense bf16, about 0.1-1.1 us a
// tile on one SM. Nearer: the weights, 24-256 KB of bf16 a tile, cross from L2
// at a few tens of bytes a cycle an SM, as long as the products or longer, and
// a tile's fixed costs (indices, ct, the gather, the max) are paid once a tile.
//
// What the design does about it.
//  - Persistent blocks of one or two consumer warpgroups and a producer warp;
//    each warpgroup takes its own 64-row tile of whole centroids (64 / K of
//    them; a ragged K leaves the tile's last rows empty) in each round, and
//    the warpgroups of a block share one ring of weight panels (bf16_layers.cuh):
//    a panel crossing L2 serves two tiles. Where a round's panels fit in shared
//    memory beside the tiles (SA0 and SA1 of BAT), they are loaded once and
//    stay resident for the block's life.
//  - h1 is formed once per tile, as bf16 in shared memory in the tensor cores'
//    layout: the gather reads the f32 A rows by 16-byte loads (eight in flight a
//    thread, the next batch's while one is stored), rounds them, adds ct (the
//    tile's, computed before into shared memory), applies the ReLU and rounds
//    again. Layers 2 and 3 read A (h1, h2) and B (the panels) from
//    shared-memory descriptors: no fragment is built in registers, none twice.
//  - Each output chunk (128 channels, or 64 for a layer of at most 64) sums
//    its layer's whole K on the tensor cores (chunk_products: 64-input
//    k-blocks, one group in flight). Layer 2's chunks go through the bias (from
//    shared memory) and ReLU to h2 (bf16, the same layout); layer 3's to a bf16
//    staging of the chunk (bf16(max) = max(bf16): rounding is monotone), two
//    buffers over h1's space, so one warpgroup barrier a chunk orders the max's
//    reads; the max takes a column pair of a centroid a thread, in four chains
//    of max.bf16x2, and writes it as one 32-bit store.
//  - A tile's indices and centroids come a round ahead by cp.async (a load
//    into registers would stall the next wgmma fence); b1 and W1_xyz, b2 and b3
//    are read from shared memory. Tried and slower on the card: the next
//    tile's first batch of A rows prefetched the same way (SA0 at B = 16 2x);
//    ct computed in the gather for each item (10%, a barrier fewer); sixteen
//    loads in flight a thread (spills).
//  - Filling the card (the host's plan). Two consumer warpgroups where the tiles
//    give each SM at least two, else one; where the tiles do not fill the card
//    (B = 1) layer 3's output chunks are split over grid.z, layer 2 computed in
//    each, as sa_fused.cu plans it, among the splits that fit.
//  - Wide layers (choose_plan). Where h1's and h2's tiles and a ring of three
//    panels do not fit (C1 = C2 = 704 at K = 64; ct's ts x C1 at small K),
//    one warpgroup, then a ring of two, then h1 streamed (sa_bf16_kernel<1,
//    true>): only h2's tile stays whole, so every shape whose h2 tile fits
//    beside a ring of two panels runs (C2 up to 1408 at C1 = 8).
//  - Conventions kept from the 3xTF32 mode: a centroid with no point in the
//    ball gets index 0; an index outside [0, N) in K5's idx reads nothing and
//    gives its centroid NaN; rows past a ragged tile stay out of the max.
//
// Phase counters: a build with -DBF16_PHASES adds clock64() counters of each
// phase of a tile (bf16_layers.cuh) and the entry sa_bf16_phases that reads and
// clears them; chip_smoke.py's timing loads that build, nothing else does.
//
// Interface: plain C, loaded with ctypes; pointers are device pointers and the
// stream is PyTorch's current stream. Returns 0, a CUDA error code, or a
// negative code for arguments the kernels do not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_query.cuh"   // bq_kernel
#include "bf16_layers.cuh"  // tiles, panels, the ring, chunk_products

namespace {

constexpr int kErrArgs = -1;    // B, N, S, K or widths not accepted
constexpr int kErrWidth = -2;   // a width is not a multiple of 4
constexpr int kErrSmem = -3;    // h2's tile and a ring of two panels do not fit
constexpr int kErrPacked = -4;  // a packed weight has the wrong size

constexpr int kMinStages = 3;   // panels in flight at least
constexpr int kMaxStages = 32;  // and at most
constexpr int kU = 4;           // gather items in flight a thread: eight 16-byte loads

struct SAArgs {
  const float* centers;  // (B, S, 3)
  const int* idx;        // (B, S, K)
  const float* a;        // (B, N, C1) A-form rows, f32
  const float* w1x;      // (3, C1): layer 1's rows for xyz, or nullptr (ct = b1)
  const float* b1;       // (C1)
  const float* w2;       // panels (ops/chain_fused.py::pack_panels_bf16)
  const float* b2;       // (C2)
  const float* w3;       // panels
  const float* b3;       // (C3)
  uint16_t* out;         // (B, S, C3) bf16
  int B, N, S, K, C1, C2, C3;
  float inv_r;
  int ts;          // centroids per tile: kRows / K
  int tpb, tiles;  // tiles per batch element, in all
  int ka1, ka2;    // widths of h1 and h2 in shared memory (multiples of 64)
  int cw2, cw3;    // output chunk widths of layers 2 and 3 (64 or 128)
  int nc2, nc3;    // output chunks of layers 2 and 3
  int ld3;         // bf16 between rows of layer 3's staged chunk: cw3 + 8 (32 banks)
  int cz;          // layer-3 chunks per block: blockIdx.z takes [z cz, z cz + cz)
  int stream;      // h1 streamed a k-block at a time (sa_bf16_kernel<1, true>)
  int P;           // panels a round at most: layer 2's, then cz chunks' of layer 3
  int nst, sbytes, resident;  // stages of the ring, bytes a stage; whether a round's panels fit
  int wg_bytes;    // shared memory of one consumer warpgroup
  int o_h2, o_ct, o_idx, o_xyz;  // offsets in it (h1 and the staging at 0)
  int o_bias, o_ring, o_bar;  // offsets of b1 | W1_xyz | b2 | b3 (none when streamed), the ring, the mbarriers
};

// Panel u of a round of a block whose layer-3 chunks start at c30; *bytes its size.
__device__ __forceinline__ const float* panel_src(const SAArgs& p, int u, int c30, int* bytes) {
  const int u2 = p.nc2 * (p.ka1 / kKB);
  if (u < u2) {
    *bytes = panel_bytes(p.C2);
    return p.w2 + static_cast<long long>(u) * (*bytes / 4);
  }
  *bytes = panel_bytes(p.C3);
  return p.w3 + (static_cast<long long>(c30) * (p.ka2 / kKB) + (u - u2)) * (*bytes / 4);
}

// ct of one channel: b1 - ((x W1x0 + y W1x1) + z W1x2), (x, y, z) the
// centroid times inv_r: the plain version's order.
__device__ __forceinline__ float ct_of(float b, float x, float y, float z, float w0, float w1, float w2) {
  return __fsub_rn(b, __fmaf_rn(z, w2, __fmaf_rn(y, w1, __fmul_rn(x, w0))));
}

// The max over each centroid's K rows of a staged chunk (ld apart) into out
// (the tile's first centroid, this chunk's first column; ldo apart a
// centroid, cw columns of the chunk real): a thread a column pair, four
// chains of max.bf16x2; NaN where an index was out of range.
__device__ __forceinline__ void max_over_k(const uint16_t* st, int ld, int chunk, uint16_t* out,
                                           const int* bad, int ns, int K, int ldo, int cw) {
  const int half = chunk / 2, pairs = ns * half;
  for (int e = threadIdx.x & (kWGThreads - 1); e < pairs; e += kWGThreads) {
    const int tc = e / half, c = 2 * (e - tc * half);
    const uint16_t* col = st + tc * K * ld + c;
    uint32_t m[4] = {0u, 0u, 0u, 0u};  // every value is a ReLU output, so >= +0
    int k = 0;
#pragma unroll 2
    for (; k + 3 < K; k += 4, col += 4 * ld)
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = max_bf16x2(m[i], *reinterpret_cast<const uint32_t*>(col + i * ld));
    for (; k < K; ++k, col += ld) m[0] = max_bf16x2(m[0], *reinterpret_cast<const uint32_t*>(col));
    if (c < cw)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(tc) * ldo + c) =
          bad[tc] ? 0x7fc07fc0u : max_bf16x2(max_bf16x2(m[0], m[1]), max_bf16x2(m[2], m[3]));
  }
}

// ST: h1 streamed, for widths where h1's and h2's tiles do not fit together:
// one consumer warpgroup; layer 2 gathers each 64-input k-block of h1 into one
// of two 8 KB buffers while the previous one's products run, again for each
// of its output chunks; ct is computed in that gather, the biases are read
// from device memory, the indices come one round at a time and layer 3 stages
// its chunks in one buffer (a barrier more a chunk).
template <int NWG, bool ST>
__global__ void __launch_bounds__(block_threads(NWG), 1) sa_bf16_kernel(const SAArgs p) {
  static_assert(!ST || NWG == 1, "the streamed mode runs one consumer warpgroup");
  constexpr int kNB = ST ? 1 : 2;  // rounds of indices and centroids in shared memory
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* stages = smem + p.o_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.o_bar);
  uint64_t* empty = full + p.nst;
  const int tid = threadIdx.x, wg = tid / kWGThreads;
  const int c30 = blockIdx.z * p.cz, c31 = min(p.nc3, c30 + p.cz);
  const int units = (p.tiles + NWG - 1) / NWG;  // rounds of NWG tiles over the grid
  const int rounds = units > static_cast<int>(blockIdx.x)
                         ? (units - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x : 0;

  if (tid == NWG * kWGThreads) {
    for (int i = 0; i < p.nst; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i], 4 * NWG);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // b1 and W1_xyz's rows (ka1 each, zero past C1; W1_xyz zero where layer 1
  // reads no xyz), b2 (nc2 x cw2, zero past C2) and this block's chunks of b3 (cz x
  // cw3, zero past C3)
  float* w1s = reinterpret_cast<float*>(smem + p.o_bias);
  float* b2s = w1s + 4 * p.ka1;
  float* b3s = b2s + p.nc2 * p.cw2;
  if constexpr (!ST) {
    for (int i = tid; i < 4 * p.ka1; i += blockDim.x) {
      const int row = i / p.ka1, c = i - row * p.ka1;
      w1s[i] = c >= p.C1 ? 0.f : row == 0 ? __ldg(p.b1 + c) : p.w1x ? __ldg(p.w1x + (row - 1) * p.C1 + c) : 0.f;
    }
    for (int i = tid; i < p.nc2 * p.cw2 + p.cz * p.cw3; i += blockDim.x) {
      const bool l2 = i < p.nc2 * p.cw2;
      const int n = l2 ? i : c30 * p.cw3 + i - p.nc2 * p.cw2;
      b2s[i] = n < (l2 ? p.C2 : p.C3) ? __ldg((l2 ? p.b2 : p.b3) + n) : 0.f;
    }
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warp: a round's panels in order, every round
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid == NWG * kWGThreads) {
      // this block's: the last z may have fewer layer-3 chunks than cz
      const int P = p.nc2 * (p.ka1 / kKB) + (c31 - c30) * (p.ka2 / kKB);
      long long g = 0;
      for (int r = 0; r < rounds && (r == 0 || !p.resident); ++r)
        for (int u = 0; u < P; ++u, ++g) {
          int bytes;
          const float* src = panel_src(p, u, c30, &bytes);
          ring_fill(stages, p.sbytes, full, empty, p.nst, p.resident, g, u, src, bytes);
        }
    }
    return;
  }

  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  uint8_t* base = smem + wg * p.wg_bytes;
  uint8_t* h1 = base;  // the tile's h1 (64 x ka1; ST: two k-blocks); then layer 3's staged chunks
  uint8_t* h2 = base + p.o_h2;
  float* cts = reinterpret_cast<float*>(base + p.o_ct);  // ts x ka1 (none in ST)
  int* sidx = reinterpret_cast<int*>(base + p.o_idx);    // [kNB][kRows]: the indices of kNB rounds
  int* bad = sidx + kNB * kRows;  // ts: the centroid has an index outside [0, N)
  float* xyz = reinterpret_cast<float*>(base + p.o_xyz);  // [kNB][kRows * 3]: their centroids
  const int ct_ = tid & (kWGThreads - 1), warp = ct_ >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, K = p.K;
  const uint32_t h1a = smem_addr(h1), h2a = smem_addr(h2);
  Ring ring{smem_addr(stages), full, empty, p.nst, p.sbytes, p.resident, 0, 0, 0};
  const auto slot = [](int r) { return ST ? 0 : r & 1; };
  // the biases of layer 2's and of layer 3's output n
  const auto bias2 = [&](int n) { return ST ? (n < p.C2 ? __ldg(p.b2 + n) : 0.f) : b2s[n]; };
  const auto bias3 = [&](int n) { return ST ? (n < p.C3 ? __ldg(p.b3 + n) : 0.f) : b3s[n - c30 * p.cw3]; };

  // the tile of this warpgroup in round r: batch element, first centroid, centroids
  const auto tile_of = [&](int r, int& b, int& s0, int& ns) {
    const int t = (static_cast<int>(blockIdx.x) + r * static_cast<int>(gridDim.x)) * NWG + wg;
    const bool live = t < p.tiles;  // a round's last tile may be past the end: it runs empty
    b = live ? t / p.tpb : 0;
    s0 = live ? (t - b * p.tpb) * p.ts : 0;
    ns = live ? min(p.ts, p.S - s0) : 0;
  };
  // the indices and centroids of round r into sidx[slot(r)], xyz[slot(r)],
  // asynchronously (0 past its rows)
  const auto fetch_idx = [&](int r) {
    int b, s0, ns;
    tile_of(r, b, s0, ns);
    if (ct_ < kRows)
      cp_async4(sidx + slot(r) * kRows + ct_,
                p.idx + (static_cast<long long>(b) * p.S + s0) * K + (ct_ < ns * K ? ct_ : 0),
                ct_ < ns * K ? 4 : 0);
    for (int i = ct_; i < p.ts * 3; i += kWGThreads)
      cp_async4(xyz + slot(r) * kRows * 3 + i,
                p.centers + (static_cast<long long>(b) * p.S + s0) * 3 + (i < ns * 3 ? i : 0),
                i < ns * 3 ? 4 : 0);
  };
  // The gather's batch jb (kU items a thread) of inputs [k0, k0 + 8 G) of a
  // tile: the f32 A rows its indices name, as 16-byte loads; zeros past C1,
  // past the rows and for an index outside [0, N).
  const auto load_batch = [&](float4 (&v)[kU][2], const int* ix, int jb, int b, int nrows, int G, int k0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = ct_ + (jb * kU + u) * kWGThreads, rest = e >> 3;
      const int k = k0 + (rest % G) * 8, m = (rest / G) * 8 + (e & 7);
      v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int j = e < kRows * G && m < nrows ? ix[m] : -1;
      if (j < 0 || j >= p.N) continue;
      const float* src = p.a + (static_cast<long long>(b) * p.N + j) * p.C1 + k;
      if (k < p.C1) v[u][0] = __ldg(reinterpret_cast<const float4*>(src));
      if (k + 4 < p.C1) v[u][1] = __ldg(reinterpret_cast<const float4*>(src + 4));
    }
  };
  // ... and its h1 = bf16(relu(bf16(A) + ct)) into dst, a tile of width 8 G
  // (16-byte stores, rows fastest within 8: bf16_layers.cuh); ct from cts, or
  // in ST computed here from the centroids cxyz
  const auto store_batch = [&](const float4 (&v)[kU][2], const int* ix, int jb, int nrows, int G,
                               int k0, uint8_t* dst, const float* cxyz) {
    const auto h = [](float a, float c) { return fmaxf(__fadd_rn(round_bf16(a), c), 0.f); };
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = ct_ + (jb * kU + u) * kWGThreads, rest = e >> 3;
      if (e >= kRows * G) continue;
      const int k = (rest % G) * 8, m = (rest / G) * 8 + (e & 7);
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (m < nrows) {
        const int j = ix[m];
        if (j < 0 || j >= p.N) {
          bad[m / K] = 1;
        } else {
          float c[8];
          if constexpr (ST) {
            const float* cc = cxyz + 3 * (m / K);
            const float x = __fmul_rn(cc[0], p.inv_r), y = __fmul_rn(cc[1], p.inv_r),
                        z = __fmul_rn(cc[2], p.inv_r);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int n = k0 + k + i;
              c[i] = n >= p.C1 ? 0.f
                     : p.w1x ? ct_of(__ldg(p.b1 + n), x, y, z, __ldg(p.w1x + n), __ldg(p.w1x + p.C1 + n),
                                     __ldg(p.w1x + 2 * p.C1 + n))
                             : __ldg(p.b1 + n);
            }
          } else {
            const float* cr = cts + (m / K) * p.ka1 + k0 + k;
            const float4 c0 = *reinterpret_cast<const float4*>(cr), c1 = *reinterpret_cast<const float4*>(cr + 4);
            c[0] = c0.x, c[1] = c0.y, c[2] = c0.z, c[3] = c0.w, c[4] = c1.x, c[5] = c1.y, c[6] = c1.z, c[7] = c1.w;
          }
          w = make_uint4(pack_bf16(h(v[u][0].x, c[0]), h(v[u][0].y, c[1])),
                         pack_bf16(h(v[u][0].z, c[2]), h(v[u][0].w, c[3])),
                         pack_bf16(h(v[u][1].x, c[4]), h(v[u][1].y, c[5])),
                         pack_bf16(h(v[u][1].z, c[6]), h(v[u][1].w, c[7])));
        }
      }
      *reinterpret_cast<uint4*>(dst + tile_ofs(m, k, 8 * G)) = w;
    }
  };

  // round 0's indices and centroids; each later round's come during the
  // round before it, by cp.async, which (unlike loads into registers) no wgmma
  // fence waits for (ST: at the start of its round)
  if constexpr (!ST) fetch_idx(0);
  for (int r = 0; r < rounds; ++r) {
    int b, s0, ns;
    tile_of(r, b, s0, ns);
    const int nrows = ns * K;
    const int* ix = sidx + slot(r) * kRows;
    const float* cxyz = xyz + slot(r) * kRows * 3;
    ring.u = 0;
    if constexpr (ST) {
      wg_bar(wg);  // the last tile's readers of the indices, the flags and the staging are done
      for (int i = ct_; i < p.ts; i += kWGThreads) bad[i] = 0;
      fetch_idx(r);
    }
    cp_async_wait_all();  // this thread's part of this round's prefetches
    wg_bar(wg);  // ... everyone's; the last tile's readers of cts, bad, h1 / the staging are done
    PHASE_START();
    if constexpr (!ST) {
      const int G = p.ka1 >> 3;  // the gather's items: 8 inputs of a row
      const int batches = (kRows * G + kU * kWGThreads - 1) / (kU * kWGThreads);
      float4 cur[kU][2];  // the gather's batch being stored
      load_batch(cur, ix, 0, b, nrows, G, 0);  // the first in flight while ct is computed
      if (r + 1 < rounds) fetch_idx(r + 1);
      for (int i = ct_; i < p.ts; i += kWGThreads) bad[i] = 0;
      for (int e = ct_; e < p.ts * p.ka1; e += kWGThreads) {  // ct = b1 - (c * inv_r) W1_xyz
        const int tc = e / p.ka1, c = e - tc * p.ka1;
        float v = w1s[c];
        if (p.w1x)
          v = ct_of(v, __fmul_rn(cxyz[3 * tc], p.inv_r), __fmul_rn(cxyz[3 * tc + 1], p.inv_r),
                    __fmul_rn(cxyz[3 * tc + 2], p.inv_r), w1s[p.ka1 + c], w1s[2 * p.ka1 + c],
                    w1s[3 * p.ka1 + c]);
        cts[e] = tc < ns ? v : 0.f;
      }
      wg_bar(wg);  // ct and the flags are in place
      PHASE_END(0);
      for (int jb = 0; jb < batches; ++jb) {  // the next batch's loads in flight while one is stored
        float4 v[kU][2];
        if (jb + 1 < batches) load_batch(v, ix, jb + 1, b, nrows, G, 0);
        store_batch(cur, ix, jb, nrows, G, 0, h1, cxyz);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          cur[u][0] = v[u][0];
          cur[u][1] = v[u][1];
        }
      }
      fence_proxy_async();  // the tensor cores read h1
      wg_bar(wg);
      PHASE_END(1);
    }

    // layer 2: h2 = bf16(relu(h1 W2 + b2)), every row, columns up to ka2
    const auto layer2 = [&](auto tiles) {
      constexpr int NT = decltype(tiles)::value;
      for (int cb = 0; cb < p.nc2; ++cb) {
        float acc[NT][4];
        if constexpr (ST)  // one k-block of h1 a fill: 64 rows x 8 groups, one batch
          chunk_products_streamed<NT>(acc, h1, p.ka1 / kKB, ring, wg, [&](int kb, uint8_t* dst) {
            float4 v[kU][2];
            load_batch(v, ix, 0, b, nrows, kKB / 8, kb * kKB);
            store_batch(v, ix, 0, nrows, kKB / 8, kb * kKB, dst, cxyz);
          });
        else
          chunk_products<NT>(acc, h1a, p.ka1, ring);
        PHASE_END(2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = cb * NT * 8 + nt * 8 + 2 * q;
          if (n >= p.ka2) continue;  // a 128-wide chunk past a width of 64k + 1..64
          const float b0 = bias2(n), b1 = bias2(n + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            put_pair(h2, 16 * warp + g + 8 * h, n, p.ka2, fmaxf(acc[nt][2 * h] + b0, 0.f),
                     fmaxf(acc[nt][2 * h + 1] + b1, 0.f));
        }
        PHASE_END(3);
      }
    };
    if (p.cw2 == 128) layer2(Tiles<16>{});
    else layer2(Tiles<8>{});
    fence_proxy_async();  // the tensor cores read h2
    wg_bar(wg);           // h2 is whole, and no warp reads h1 again

    // layer 3, chunk by chunk: bf16(relu(h2 W3 + b3)) staged in two buffers
    // (ST: one) over h1's space, then the max over each centroid's K rows
    const auto layer3 = [&](auto tiles) {
      constexpr int NT = decltype(tiles)::value;
      for (int cb = c30; cb < c31; ++cb) {
        float acc[NT][4];
        chunk_products<NT>(acc, h2a, p.ka2, ring);
        PHASE_END(4);
        uint16_t* st = reinterpret_cast<uint16_t*>(h1) + (ST ? 0 : ((cb - c30) & 1) * kRows * p.ld3);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = nt * 8 + 2 * q, n = cb * NT * 8 + c;
          const float b0 = bias3(n), b1 = bias3(n + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(st + (16 * warp + g + 8 * h) * p.ld3 + c) =
                pack_bf16(fmaxf(acc[nt][2 * h] + b0, 0.f), fmaxf(acc[nt][2 * h + 1] + b1, 0.f));
        }
        wg_bar(wg);  // the chunk is staged; the other buffer's readers are done (the last barrier)
        PHASE_END(5);
        max_over_k(st, p.ld3, NT * 8, p.out + (static_cast<long long>(b) * p.S + s0) * p.C3 + cb * NT * 8,
                   bad, ns, K, p.C3, p.C3 - cb * NT * 8);
        if constexpr (ST) wg_bar(wg);  // the one buffer's readers are done
        PHASE_END(6);
      }
    };
    if (p.cw3 == 128) layer3(Tiles<16>{});
    else layer3(Tiles<8>{});
    PHASE_ADD(7, ring.waited);
#ifdef BF16_PHASES
    ring.waited = 0;
#endif
  }
}

// --- host: the plan and the launches ----------------------------------------------

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
    const void* kernels[] = {reinterpret_cast<const void*>(sa_bf16_kernel<1, false>),
                             reinterpret_cast<const void*>(sa_bf16_kernel<2, false>),
                             reinterpret_cast<const void*>(sa_bf16_kernel<1, true>)};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    d.err = static_cast<int>(e);
    return d;
  }();
  return info;
}

// Floats of a layer's panels (k inputs, c outputs: ops/chain_fused.py::pack_panels_bf16).
long long panel_floats(int k, int c) { return cdiv(c, chunk_width(c)) * cdiv(k, kKB) * panel_bytes(c) / 4; }

// Tiles, shared-memory layout, the ring and the grid (persistent blocks over
// the rounds, layer 3's chunks over grid.z) with nwg consumer warpgroups, h1
// streamed or not, and a ring of at least min_stages panels; kErrSmem where
// no split of layer 3's chunks fits.
int make_plan(SAArgs* p, int sms, int nwg, int stream, int min_stages, dim3* grid, size_t* smem) {
  p->stream = stream;
  p->ts = kRows / p->K;
  p->tpb = static_cast<int>(cdiv(p->S, p->ts));
  p->tiles = p->B * p->tpb;
  p->ka1 = round64(p->C1);
  p->ka2 = round64(p->C2);
  p->cw2 = chunk_width(p->C2);
  p->cw3 = chunk_width(p->C3);
  p->nc2 = static_cast<int>(cdiv(p->C2, p->cw2));
  p->nc3 = static_cast<int>(cdiv(p->C3, p->cw3));
  p->ld3 = p->cw3 + 8;
  const int nb = stream ? 1 : 2;  // rounds of indices and centroids, staging buffers
  const long long h1 = stream ? 2LL * kKBBytes : 2LL * kRows * p->ka1,
                  staging = nb * 2LL * kRows * p->ld3;
  p->o_h2 = static_cast<int>(align128(h1 > staging ? h1 : staging));
  p->o_ct = p->o_h2 + static_cast<int>(align128(2LL * kRows * p->ka2));
  p->o_idx = p->o_ct + (stream ? 0 : static_cast<int>(align128(4LL * p->ts * p->ka1)));
  p->o_xyz = p->o_idx + static_cast<int>(align128((nb + 1) * kRows * 4));  // sidx[nb], bad
  p->wg_bytes = p->o_xyz + static_cast<int>(align128(nb * kRows * 3 * 4));
  p->o_bias = nwg * p->wg_bytes;
  p->sbytes = panel_bytes(p->C2 > p->C3 ? p->C2 : p->C3);
  // of the splits of layer 3's output chunks over nz that fit, the one with
  // the shortest run of panels on the slowest block (rounds x panels a round)
  const long long units = cdiv(p->tiles, nwg);
  const int nk2 = p->ka1 / kKB, nk3 = p->ka2 / kKB;
  long long best = -1;
  for (int nz = 1; nz <= p->nc3; ++nz) {
    const int cz = static_cast<int>(cdiv(p->nc3, nz)), nzr = static_cast<int>(cdiv(p->nc3, cz));
    const int P = p->nc2 * nk2 + cz * nk3;
    const long long biases = stream ? 0 : align128(4LL * (4 * p->ka1 + p->nc2 * p->cw2 + cz * p->cw3));
    const long long o_ring = p->o_bias + biases;
    const long long fit = (kSmemMax - o_ring) / (p->sbytes + 16);  // stages and their mbarriers
    const int most = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
    const bool resident = P <= most;
    if (!resident && most < min_stages) continue;
    long long gx = sms / nzr;
    gx = gx < 1 ? 1 : gx < units ? gx : units;
    const long long cost = cdiv(units, gx) * (p->nc2 * nk2 * p->cw2 + cz * nk3 * p->cw3);
    if (best < 0 || cost < best) {
      best = cost;
      p->cz = cz;
      p->P = P;
      p->resident = resident;
      p->nst = resident ? P : most;
      p->o_ring = static_cast<int>(o_ring);
      *grid = dim3(static_cast<unsigned>(gx), 1, nzr);
    }
  }
  if (best < 0) return kErrSmem;
  p->o_bar = p->o_ring + p->nst * p->sbytes;
  *smem = static_cast<size_t>(p->o_bar) + 16 * p->nst;
  return 0;
}

// The first plan that fits, in order: h1's tile in shared memory on two
// consumer warpgroups where the tiles give every SM two (else one) and a ring
// of kMinStages panels; on one warpgroup; on a ring of two; then h1 streamed
// (one warpgroup, a ring of two). *nwg: the plan's consumer warpgroups.
int choose_plan(SAArgs* p, int sms, int* nwg, dim3* grid, size_t* smem) {
  const int first = cdiv(p->S, kRows / p->K) * p->B >= 2LL * sms ? 2 : 1;
  const int tiers[4][3] = {{first, 0, kMinStages}, {1, 0, kMinStages}, {1, 0, 2}, {1, 1, 2}};
  for (const auto& t : tiers) {
    const int err = make_plan(p, sms, t[0], t[1], t[2], grid, smem);
    if (err != kErrSmem) {
      *nwg = t[0];
      return err;
    }
  }
  return kErrSmem;
}

}  // namespace

// idx == nullptr: K4 (ball query into idx_ws (B, S, K), xyz used); otherwise
// K5 (xyz and idx_ws unused). a_rows: layer 1's A (B, N, C1), f32; centers are
// read by both (ct). w1x: layer 1's three xyz rows (3, C1), or nullptr when
// layer 1 reads no xyz. w2, w3: panels (n_w2, n_w3 floats); out (B, S, C3)
// bf16. r2 is the squared radius in f32, inv_r 1 / r or 1.
extern "C" int sa_fused_k4_bf16(const float* xyz, const float* centers, const int* idx,
                                int* idx_ws, const float* a_rows, const float* w1x,
                                const float* b1, const float* w2, long long n_w2, const float* b2,
                                const float* w3, long long n_w3, const float* b3, void* out, int B,
                                int N, int S, int K, int C1, int C2, int C3, float r2, float inv_r,
                                void* stream) {
  if (B < 1 || B > 65535 || N < 1 || S < 1 || K < 1 || K > kRows || C1 < 1 || C2 < 1 || C3 < 1)
    return kErrArgs;
  if (!centers || (!idx && (!xyz || !idx_ws))) return kErrArgs;
  if (C1 % 4 || C2 % 4 || C3 % 4) return kErrWidth;
  if (n_w2 != panel_floats(C1, C2) || n_w3 != panel_floats(C2, C3)) return kErrPacked;
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
  p.out = static_cast<uint16_t*>(out);
  p.B = B;
  p.N = N;
  p.S = S;
  p.K = K;
  p.C1 = C1;
  p.C2 = C2;
  p.C3 = C3;
  p.inv_r = inv_r;
  int nwg = 1;
  dim3 grid;
  size_t smem = 0;
  const int err = choose_plan(&p, dev.sms, &nwg, &grid, &smem);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!idx) {
    bq_kernel<<<dim3(static_cast<unsigned>(cdiv(S, kBqThreads / 32)), B), kBqThreads, 0, s>>>(
        xyz, centers, idx_ws, N, S, K, r2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.stream) sa_bf16_kernel<1, true><<<grid, block_threads(1), smem, s>>>(p);
  else if (nwg == 2) sa_bf16_kernel<2, false><<<grid, block_threads(2), smem, s>>>(p);
  else sa_bf16_kernel<1, false><<<grid, block_threads(1), smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

#ifdef BF16_PHASES
extern "C" {
// The phase counters' cycles since the last call (kPhases of them), then zero.
int sa_bf16_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, bf16_phase_cycles, sizeof(unsigned long long) * kPhases);
  const unsigned long long zero[kPhases] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(bf16_phase_cycles, zero, sizeof(zero));
  return static_cast<int>(e);
}

// The plan sa_fused_k4_bf16 makes for a shape, without a launch: out = {consumer
// warpgroups, h1 streamed, ring stages, panels resident, shared bytes}; returns
// 0 or kErrSmem.
int sa_bf16_plan(int B, int S, int K, int C1, int C2, int C3, int* out) {
  const DeviceInfo& dev = device_info();
  if (dev.err) return dev.err;
  SAArgs p{};
  p.B = B;
  p.S = S;
  p.K = K;
  p.C1 = C1;
  p.C2 = C2;
  p.C3 = C3;
  int nwg = 1;
  dim3 grid;
  size_t smem = 0;
  const int err = choose_plan(&p, dev.sms, &nwg, &grid, &smem);
  out[0] = nwg;
  out[1] = p.stream;
  out[2] = p.nst;
  out[3] = p.resident;
  out[4] = static_cast<int>(smem);
  return err;
}
}
#endif
