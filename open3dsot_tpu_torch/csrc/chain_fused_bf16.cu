// Fused eval-mode PointNet chains in bf16 for Hopper (sm_90a): K1/K2 in the JAX
// kernels' `cdt = bfloat16` (open3dsot_tpu/ops/chain_fused.py:51-93). The
// 3xTF32 mode is chain_fused.cu.
//
// K1  chain_fused_k1_bf16 replaces open3dsot_tpu/ops/chain_fused.py::
//     fused_pointnet_encoder(dtype=bfloat16) (Pallas kernel _k_p1, call :150):
//     per point, folded Dense layers with ReLU, each product on bf16 operands
//     with f32 sums over its whole K; optionally layer `tap_at` written out
//     (f32); the last layer max-pooled over the N points (f32).
// K2  chain_fused_k2_bf16 replaces fused_seg_head(dtype=bfloat16) (_k_p2, call
//     :217): concat(tap, broadcast(pooled)) -> folded chain with ReLU -> plain
//     head Dense -> per-point logits (f32). The first weight is split: g[b] =
//     bf16(pooled[b]) bf16(W_pool) + b'_0 once per batch element
//     (pool_bias_kernel), then relu(bf16(tap) W_tap + g[b]) per point.
//
// What bounds it on this card. At M2-Track's widths a point costs 145-360
// thousand multiply-adds against a few hundred bytes in and out: products at
// 989 TFLOP/s dense bf16 once the activations stay on chip. Nearer: a 64-point
// tile streams 290-600 KB of bf16 weights from L2 (seg mlp1's 128 -> 1024
// alone 256 KB), as long as its products take on one SM.
//
// What the design does about it.
//  - Persistent blocks of one or two consumer warpgroups and a producer warp
//    (bf16_layers.cuh). Each warpgroup takes its own 64-point tile in each
//    round and runs the stage's layers on it; the warpgroups of a block share
//    one ring of weight panels (8 or 16 KB, full / empty mbarriers, no block
//    barrier), so a panel crossing L2 serves two tiles; a ring that holds a
//    round's panels keeps them resident.
//  - Activations stay bf16: each layer's output is rounded in the epilogue to
//    bf16 in shared memory, in the tensor cores' layout, and the next layer
//    reads it as A from a descriptor (the JAX kernel rounds h.astype(bf16)
//    before each dot, so storing the rounded value loses nothing). The tap,
//    the pool and K2's logits are f32, from the f32 accumulators.
//  - Each output chunk (128 channels, or 64 for a layer of at most 64) sums the
//    layer's whole K on the tensor cores (64-input k-blocks, one group in
//    flight); no per-chunk sum on the CUDA cores. Biases from shared memory.
//  - A tile's input comes by 16-byte cp.async from a stage buffer, or as f32
//    loads, four items in flight a thread, rounded here.
//  - Stages (the host's plan): a stage is as many layers as fit in shared
//    memory beside a ring of kMinStages panels; between stages the activations
//    go through a (B, N, C) bf16 buffer in device memory. Where the tiles do
//    not fill the card (B = 1), a wide layer (more than 128 x 256 multiply-adds
//    a point) is a stage of its own whose grid also splits its output chunks,
//    one a block (its panels then resident). Two warpgroups a block where the
//    tiles give every SM two, and they fit; else one. A layer whose input
//    tile or biases do not fit even so is a stage of its own that streams its
//    input (chain_bf16_kernel<1, true>), so every width runs.
//  - Pool across blocks: every pooled value is a ReLU output (>= 0), whose int
//    bits order like the float: the pool starts at 0, each warp reduces its
//    rows by shuffles, the warpgroup its four warps' maxima through shared
//    memory, and one atomicMax on the bits a column a tile adds it. Exact.
//  - Ragged tiles: rows past N are zeros in, and kept out of the max, the tap
//    and every store.
//  - Widths: any, padded with zeros to whole 64-input k-blocks and chunks (the
//    inputs 12, 13, 14 to 64; the head's 11 to 64).
//
// Phase counters: a build with -DBF16_PHASES adds clock64() counters of each
// phase of a tile (bf16_layers.cuh) and the entry chain_bf16_phases that reads
// and clears them; chip_smoke.py's timing loads that build, nothing else does.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// stream is PyTorch's current stream. Each entry returns 0, a CUDA error code,
// or a negative code for arguments the kernels do not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_layers.cuh"  // tiles, panels, the ring, chunk_products

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMinStages = 3;               // panels in flight at least
constexpr int kMaxStages = 32;              // and at most
constexpr long long kWideMacs = 128 * 256;  // a layer above this is "wide" (own stage at small B)

constexpr int kErrLayout = -1;     // layer count, widths or packed size wrong
constexpr int kErrWidth = -2;      // the tap or K2's first width is not a multiple of 8
constexpr int kErrSmem = -3;       // a layer does not fit in shared memory, even streamed
constexpr int kErrWorkspace = -4;  // workspace smaller than the plan needs

enum Mode { kStore = 0, kPool = 1, kPlain = 2 };

struct Chain {
  int n_layers;
  int c[kMaxLayers + 1];  // real widths
  int ka[kMaxLayers];     // input widths in shared memory: multiples of 64
  int cw[kMaxLayers];     // output chunk widths: 64 or 128 (chunk_width)
  int nc[kMaxLayers];     // output chunks
  int cp[kMaxLayers];     // output widths padded to 8 (a stage buffer's rows)
  long long w[kMaxLayers], bias[kMaxLayers];  // float offsets in params
};

struct StageArgs {
  const void* in;       // (B, N, in_width): f32 (the chain's input), or bf16 (a stage's buffer)
  int in_bf16;
  const float* params;  // per layer: its panels, then b (cp)
  const float* bias0;   // nullptr, or (B, cp[0]): per-batch bias of layer 0 (K2's g)
  float* tap;           // (B, N, c[tap_at + 1]) when tap_at >= 0
  void* out;            // kStore: bf16 (B, N, cp[l1 - 1]); kPool: f32 (B, c[L]); kPlain: f32 (B, N, c[L])
  int in_width, tap_at, mode, l0, l1;
  int cpz;              // 0: every chunk of the last layer; else chunks [z cpz, z cpz + cpz)
  int B, N, tpb, tiles;  // 64-point tiles per batch element, in all
  int P, nst, resident;  // panels a round; stages of the ring; whether the panels all fit (loaded once)
  int sbytes;           // bytes between stages: the stage's widest panel
  int wg_bytes, o_buf1, o_b0, o_pool, o_bias, o_ring, o_bar;  // a consumer warpgroup's shared bytes; offsets
  Chain ch;
};

// Offsets of each layer's panels and b in the packed buffer: a layer is nc x
// (ka / 64) panels of cw x 64 channels, output chunk major
// (ops/chain_fused.py::pack_panels_bf16), then b (f32) zero-padded to cp;
// ops/chain_fused.py::pack_layer packs by the same rule.
// n_params < 0 skips the size check.
int make_layout(const int* widths, int n_layers, long long n_params, Chain* ch) {
  if (n_layers < 1 || n_layers > kMaxLayers) return kErrLayout;
  ch->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1) return kErrLayout;
    ch->c[l] = widths[l];
  }
  long long off = 0;
  for (int l = 0; l < n_layers; ++l) {
    ch->ka[l] = round64(ch->c[l]);
    ch->cw[l] = chunk_width(ch->c[l + 1]);
    ch->nc[l] = static_cast<int>(cdiv(ch->c[l + 1], ch->cw[l]));
    ch->cp[l] = round8(ch->c[l + 1]);
    ch->w[l] = off;
    off += static_cast<long long>(ch->nc[l]) * (ch->ka[l] / kKB) * panel_bytes(ch->c[l + 1]) / 4;
    ch->bias[l] = off;
    off += ch->cp[l];
  }
  return n_params < 0 || off == n_params ? 0 : kErrLayout;
}

// Output chunks [c0, c1) of layer l that this block computes.
__device__ __forceinline__ void chunk_range(const StageArgs& a, int l, int z, int& c0, int& c1) {
  const int n = a.ch.nc[l];
  if (l == a.l1 - 1 && a.cpz > 0) {
    c0 = z * a.cpz;
    c1 = min(n, c0 + a.cpz);
  } else {
    c0 = 0;
    c1 = n;
  }
}

// The tile's inputs [k0, k0 + 8 G) into buf, a tile of width 8 G: 8 inputs
// of a row an item, rows fastest within 8; zeros past the row's width and
// past N. A stage buffer (bf16) by 16-byte cp.async; the chain's f32 input
// rounded here, kU items' loads in flight a thread.
__device__ __forceinline__ void load_input(const StageArgs& a, uint8_t* buf, int k0, int G, int b,
                                           int p0, int nv) {
  const int ka = 8 * G, items = kRows * G, w = a.in_width;
  const int t = threadIdx.x & (kWGThreads - 1);
  if (a.in_bf16) {  // rows of cp (a multiple of 8) bf16
    for (int e = t; e < items; e += kWGThreads) {
      const int rest = e >> 3, k = (rest % G) * 8, m = (rest / G) * 8 + (e & 7);
      const bool in = m < nv && k0 + k < w;
      const uint16_t* src = static_cast<const uint16_t*>(a.in) +
                            (in ? (static_cast<long long>(b) * a.N + p0 + m) * w + k0 + k : 0);
      cp_async16(buf + tile_ofs(m, k, ka), src, in ? 16 : 0);
    }
    cp_async_wait_all();
    return;
  }
  constexpr int kU = 4;
  for (int e0 = t; e0 < items; e0 += kU * kWGThreads) {
    float f[kU][8];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kWGThreads, rest = e >> 3;
      const int k = k0 + (rest % G) * 8, m = (rest / G) * 8 + (e & 7);
      const bool in = e < items && m < nv && k < w;
      const float* src = static_cast<const float*>(a.in) +
                         (in ? (static_cast<long long>(b) * a.N + p0 + m) * w + k : 0);
      if (in && w % 4 == 0) {
        const float4 f0 = __ldg(reinterpret_cast<const float4*>(src));
        const float4 f1 = k + 4 < w ? __ldg(reinterpret_cast<const float4*>(src + 4))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        f[u][0] = f0.x; f[u][1] = f0.y; f[u][2] = f0.z; f[u][3] = f0.w;
        f[u][4] = f1.x; f[u][5] = f1.y; f[u][6] = f1.z; f[u][7] = f1.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[u][i] = in && k + i < w ? __ldg(src + i) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kWGThreads, rest = e >> 3;
      if (e >= items) continue;
      const int k = (rest % G) * 8, m = (rest / G) * 8 + (e & 7);
      *reinterpret_cast<uint4*>(buf + tile_ofs(m, k, ka)) =
          make_uint4(pack_bf16(f[u][0], f[u][1]), pack_bf16(f[u][2], f[u][3]),
                     pack_bf16(f[u][4], f[u][5]), pack_bf16(f[u][6], f[u][7]));
    }
  }
}

// ST: a stage of one layer whose input tile does not fit in shared memory
// beside its ring (a wide input), or whose biases do not (a wide output): one
// consumer warpgroup; each output chunk reads the tile's input a 64-input
// k-block at a time into one of two 8 KB buffers while the previous one's
// products run; the biases are read from device memory.
template <int NWG, bool ST>
__global__ void __launch_bounds__(block_threads(NWG), 1) chain_bf16_kernel(const StageArgs a) {
  static_assert(!ST || NWG == 1, "the streamed mode runs one consumer warpgroup");
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* stages = smem + a.o_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.o_bar);
  uint64_t* empty = full + a.nst;
  float* bsm = reinterpret_cast<float*>(smem + a.o_bias);  // the stage's biases, nc x cw a layer
  const int tid = threadIdx.x, wg = tid / kWGThreads, z = blockIdx.z;
  const int units = (a.tiles + NWG - 1) / NWG;
  const int rounds = units > static_cast<int>(blockIdx.x)
                         ? (units - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x : 0;

  if (tid == NWG * kWGThreads) {
    for (int i = 0; i < a.nst; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i], 4 * NWG);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!ST)
    for (int l = a.l0, off = 0; l < a.l1; off += a.ch.nc[l] * a.ch.cw[l], ++l)
      for (int i = tid; i < a.ch.nc[l] * a.ch.cw[l]; i += blockDim.x)
        bsm[off + i] = i < a.ch.c[l + 1] ? __ldg(a.params + a.ch.bias[l] + i) : 0.f;
  __syncthreads();

  if (wg == NWG) {  // the producer warp: the stage's panels in the layers' order, every round
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid == NWG * kWGThreads) {
      long long g = 0;
      for (int r = 0; r < rounds && (r == 0 || !a.resident); ++r) {
        int u = 0;
        for (int l = a.l0; l < a.l1; ++l) {
          int c0, c1;
          chunk_range(a, l, z, c0, c1);
          const int nk = a.ch.ka[l] / kKB, bytes = panel_bytes(a.ch.c[l + 1]);
          for (int cb = c0; cb < c1; ++cb)
            for (int kb = 0; kb < nk; ++kb, ++u, ++g)
              ring_fill(stages, a.sbytes, full, empty, a.nst, a.resident, g,
                        u, a.params + a.ch.w[l] + (static_cast<long long>(cb) * nk + kb) * (bytes / 4),
                        bytes);
        }
      }
    }
    return;
  }

  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  uint8_t* wbase = smem + wg * a.wg_bytes;
  uint8_t* bufs[2] = {wbase, wbase + a.o_buf1};
  float* b0s = reinterpret_cast<float*>(wbase + a.o_b0);  // K2: this tile's g (layer 0's bias)
  float* pool = reinterpret_cast<float*>(wbase + a.o_pool);  // [2][4 warps][128]: column maxima
  const int ct_ = tid & (kWGThreads - 1), warp = ct_ >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  Ring ring{smem_addr(stages), full, empty, a.nst, a.sbytes, a.resident, 0, 0, 0};

  for (int r = 0; r < rounds; ++r) {
    const int t = (static_cast<int>(blockIdx.x) + r * static_cast<int>(gridDim.x)) * NWG + wg;
    const bool live = t < a.tiles;  // a round's last tile may be past the end: it runs empty
    const int b = live ? t / a.tpb : 0, p0 = live ? (t - b * a.tpb) * kRows : 0;
    const int nv = live ? min(kRows, a.N - p0) : 0;
    ring.u = 0;
    wg_bar(wg);  // the last tile's readers of the buffers are done
    PHASE_START();
    if constexpr (!ST) {
      if (a.bias0 && a.l0 == 0)
        for (int i = ct_; i < a.ch.nc[0] * a.ch.cw[0]; i += kWGThreads)
          b0s[i] = i < a.ch.c[1] ? __ldg(a.bias0 + static_cast<size_t>(b) * a.ch.cp[0] + i) : 0.f;
      load_input(a, bufs[0], 0, a.ch.ka[a.l0] >> 3, b, p0, nv);
      fence_proxy_async();
      wg_bar(wg);
    }
    PHASE_END(0);

    for (int l = a.l0, boff = 0; l < a.l1; boff += a.ch.nc[l] * a.ch.cw[l], ++l) {
      const bool last = l == a.l1 - 1, is_tap = l == a.tap_at;
      uint8_t* hout = bufs[(l - a.l0 + 1) & 1];
      const uint32_t hin = smem_addr(bufs[(l - a.l0) & 1]);
      const int ka = a.ch.ka[l], co = a.ch.c[l + 1], cpo = a.ch.cp[l];
      const int kout = last ? 0 : a.ch.ka[l + 1];
      const float* bs = (l == 0 && a.bias0) ? b0s : bsm + boff;
      // the bias of output n: from shared memory, or (ST) device memory
      const auto bias = [&](int n) {
        if constexpr (ST)
          return n >= co ? 0.f
                 : l == 0 && a.bias0 ? __ldg(a.bias0 + static_cast<size_t>(b) * a.ch.cp[0] + n)
                                     : __ldg(a.params + a.ch.bias[l] + n);
        else
          return bs[n];
      };
      int c0, c1;
      chunk_range(a, l, z, c0, c1);
      // fragment (nt, 2h + j): row 16 warp + g + 8h, column cb * NT * 8 + nt * 8 + 2q + j
      const auto layer = [&](auto tiles) {
        constexpr int NT = decltype(tiles)::value;
        for (int cb = c0; cb < c1; ++cb) {
          float acc[NT][4];
          if constexpr (ST)
            chunk_products_streamed<NT>(acc, bufs[0], ka / kKB, ring, wg, [&](int kb, uint8_t* dst) {
              load_input(a, dst, kb * kKB, kKB / 8, b, p0, nv);
            });
          else
            chunk_products<NT>(acc, hin, ka, ring);
          PHASE_END(1);
          if (!last || a.mode == kStore) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int n = cb * NT * 8 + nt * 8 + 2 * q;
              const float b0 = bias(n), b1 = bias(n + 1);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = 16 * warp + g + 8 * h;
                const float v0 = fmaxf(acc[nt][2 * h] + b0, 0.f), v1 = fmaxf(acc[nt][2 * h + 1] + b1, 0.f);
                if (!last && n < kout) put_pair(hout, row, n, kout, v0, v1);
                if (row < nv) {  // past co the values are 0: zero weights and bias
                  const size_t pt = static_cast<size_t>(b) * a.N + p0 + row;
                  if (last && n < cpo)
                    *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(a.out) + pt * cpo + n) =
                        pack_bf16(v0, v1);
                  if (is_tap && n < co) *reinterpret_cast<float2*>(a.tap + pt * co + n) = make_float2(v0, v1);
                }
              }
            }
            PHASE_END(2);
          } else if (a.mode == kPool) {  // each warp's column maxima, then the warpgroup's: one
            float* red = pool + (cb & 1) * 4 * 128;  // atomic a column a tile (two buffers: one
#pragma unroll                                      // barrier a chunk orders their reads)
            for (int nt = 0; nt < NT; ++nt) {
              const int c = nt * 8 + 2 * q, n = cb * NT * 8 + c;
              const float b0 = bias(n), b1 = bias(n + 1);
              float m0 = 0.f, m1 = 0.f;  // the ReLU: the pool starts at 0
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (16 * warp + g + 8 * h < nv) {
                  m0 = fmaxf(m0, acc[nt][2 * h] + b0);
                  m1 = fmaxf(m1, acc[nt][2 * h + 1] + b1);
                }
#pragma unroll
              for (int off = 4; off < 32; off <<= 1) {
                m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
                m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
              }
              if (g == 0) *reinterpret_cast<float2*>(red + warp * 128 + c) = make_float2(m0, m1);
            }
            wg_bar(wg);
            if (ct_ < NT * 8) {
              const float m = fmaxf(fmaxf(red[ct_], red[128 + ct_]), fmaxf(red[256 + ct_], red[384 + ct_]));
              const int n = cb * NT * 8 + ct_;
              if (n < co && m > 0.f)
                atomicMax(reinterpret_cast<int*>(static_cast<float*>(a.out) + static_cast<size_t>(b) * co + n),
                          __float_as_int(m));
            }
            PHASE_END(3);
          } else {  // kPlain: the head, no ReLU, only the real columns
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int n = cb * NT * 8 + nt * 8 + 2 * q;
              const float b0 = bias(n), b1 = bias(n + 1);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = 16 * warp + g + 8 * h;
                if (row >= nv) continue;
                float* dst = static_cast<float*>(a.out) + (static_cast<size_t>(b) * a.N + p0 + row) * co + n;
                if (n < co) dst[0] = acc[nt][2 * h] + b0;
                if (n + 1 < co) dst[1] = acc[nt][2 * h + 1] + b1;
              }
            }
            PHASE_END(3);
          }
        }
      };
      if (a.ch.cw[l] == 128) layer(Tiles<16>{});
      else layer(Tiles<8>{});
      if (!last) {
        fence_proxy_async();  // the tensor cores read hout
        wg_bar(wg);
      }
    }
    PHASE_ADD(4, ring.waited);
#ifdef BF16_PHASES
    ring.waited = 0;
#endif
  }
}

// g[b, o] = b0[o] + sum_k bf16(pooled[b, k]) * bf16(w_pool[k, o]), the sums in
// f32; 32 outputs x 8 slices of k per block: the pooled rows of K2's first
// layer. (Four batch elements a block, W_pool read once for them, was 4x
// slower: a quarter of the blocks.)
constexpr int kGemvThreads = 256;
constexpr int kGemvO = 32;
constexpr int kGemvK = kGemvThreads / kGemvO;

__global__ void __launch_bounds__(kGemvThreads) pool_bias_kernel(
    const float* pooled, const float* w_pool, const float* b0, float* g, int Cp, int C) {
  __shared__ float part[kGemvK][kGemvO];
  const int b = blockIdx.y;
  const int lo = threadIdx.x % kGemvO, kg = threadIdx.x / kGemvO;
  const int o = blockIdx.x * kGemvO + lo;
  const float* pv = pooled + static_cast<size_t>(b) * Cp;
  float acc = 0.f;
  if (o < C)
    for (int k = kg; k < Cp; k += kGemvK)
      acc = fmaf(round_bf16(pv[k]), round_bf16(__ldg(w_pool + static_cast<size_t>(k) * C + o)), acc);
  part[kg][lo] = acc;
  __syncthreads();
  if (kg == 0 && o < C) {
    float s = b0[o];
    for (int i = 0; i < kGemvK; ++i) s += part[i][lo];
    g[static_cast<size_t>(b) * C + o] = s;
  }
}

// --- host: once per process, the plan, the launches ---------------------------

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
    const void* kernels[] = {reinterpret_cast<const void*>(chain_bf16_kernel<1, false>),
                             reinterpret_cast<const void*>(chain_bf16_kernel<2, false>),
                             reinterpret_cast<const void*>(chain_bf16_kernel<1, true>)};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    d.err = static_cast<int>(e);
    return d;
  }();
  return info;
}

struct Stage {
  int l0, l1, cpz, nz, gx;
  int nwg, stream;  // consumer warpgroups; the input streamed (chain_bf16_kernel<1, true>)
  int P, nst, sbytes, resident, wg_bytes, o_buf1, o_b0, o_pool, o_bias, o_ring, o_bar;
  size_t smem;
};

struct Plan {
  int n, tpb, tiles;
  Stage s[kMaxLayers];
};

// Shared memory of layers [l0, l1) with nwg warpgroups: each warpgroup's buffer
// 0 holds the input of layers l0, l0 + 2, ..., buffer 1 of l0 + 1, ..., and
// (l0 = 0) K2's g of its tile; the stage's biases; then the ring: a round's
// panels where they fit, else as many as fit (at least kMinStages). cpz > 0:
// the last layer's chunks split one a block. stream (one layer, one
// warpgroup): buffer 0 is two k-blocks, no biases, a ring of two at least.
bool stage_fits(const Chain& ch, int l0, int l1, int nwg, int cpz, int stream, Stage* st) {
  long long w[2] = {0, 0}, P = 0, biases = 0;
  int sbytes = 0;
  for (int l = l0; l < l1; ++l) {
    const long long f = stream ? 2LL * kKBBytes : 2LL * kRows * ch.ka[l];
    const int i = (l - l0) & 1;
    if (f > w[i]) w[i] = f;
    P += static_cast<long long>(l == l1 - 1 && cpz ? cpz : ch.nc[l]) * (ch.ka[l] / kKB);
    if (!stream) biases += 4LL * ch.cw[l] * ch.nc[l];
    if (panel_bytes(ch.c[l + 1]) > sbytes) sbytes = panel_bytes(ch.c[l + 1]);
  }
  const long long b0 = l0 == 0 && !stream ? align128(4LL * ch.cw[0] * ch.nc[0]) : 0;
  const long long pool = 2 * 4 * 128 * 4;  // the pool's column maxima
  const long long wg_bytes = align128(w[0]) + align128(w[1]) + b0 + pool;
  const long long room = kSmemMax - nwg * wg_bytes - align128(biases);
  const long long fit = room / (sbytes + 16);
  const bool resident = P <= (fit < kMaxStages ? fit : kMaxStages);
  const int nst = static_cast<int>(resident ? P : fit < kMaxStages ? fit : kMaxStages);
  if (!resident && nst < (stream ? 2 : kMinStages)) return false;
  st->l0 = l0;
  st->l1 = l1;
  st->nwg = nwg;
  st->stream = stream;
  st->cpz = cpz;
  st->P = static_cast<int>(P);
  st->resident = resident;
  st->nst = nst;
  st->sbytes = sbytes;
  st->wg_bytes = static_cast<int>(wg_bytes);
  st->o_buf1 = static_cast<int>(align128(w[0]));
  st->o_b0 = static_cast<int>(align128(w[0]) + align128(w[1]));
  st->o_pool = static_cast<int>(align128(w[0]) + align128(w[1]) + b0);
  st->o_bias = static_cast<int>(nwg * wg_bytes);
  st->o_ring = static_cast<int>(nwg * wg_bytes + align128(biases));
  st->o_bar = st->o_ring + nst * sbytes;
  st->smem = static_cast<size_t>(st->o_bar) + 16 * nst;
  return true;
}

int make_plan(const Chain& ch, int B, int N, int sms, Plan* plan) {
  const int L = ch.n_layers;
  plan->tpb = static_cast<int>(cdiv(N, kRows));
  plan->tiles = B * plan->tpb;
  const int nwg = plan->tiles >= 2 * sms ? 2 : 1;
  const auto wide = [&](int l) { return static_cast<long long>(round8(ch.c[l])) * ch.cp[l] > kWideMacs; };
  const bool full = plan->tiles >= sms;
  // layer l0 alone: on nwg warpgroups, else on one, else streamed
  const auto one_layer = [&](int l0, int cpz, Stage* st) {
    return stage_fits(ch, l0, l0 + 1, nwg, cpz, 0, st) ||
           (nwg == 2 && stage_fits(ch, l0, l0 + 1, 1, cpz, 0, st)) ||
           stage_fits(ch, l0, l0 + 1, 1, cpz, 1, st);
  };
  plan->n = 0;
  for (int l0 = 0; l0 < L;) {
    Stage st{};
    if (!full && wide(l0)) {  // one layer, its output chunks split one a block
      if (!one_layer(l0, 1, &st)) return kErrSmem;
      st.nz = ch.nc[l0];
    } else {  // as many layers as fit
      if (!one_layer(l0, 0, &st)) return kErrSmem;
      Stage longer{};
      while (!st.stream && st.l1 < L && (full || !wide(st.l1)) &&
             stage_fits(ch, l0, st.l1 + 1, st.nwg, 0, 0, &longer))
        st = longer;
      st.nz = 1;
    }
    // persistent blocks over the rounds; a split stage's blocks (a chunk each,
    // little shared memory) one round each, several to an SM
    const long long units = cdiv(plan->tiles, st.nwg);
    long long gx = st.nz > 1 ? units : sms;
    st.gx = static_cast<int>(gx < units ? gx : units);
    plan->s[plan->n++] = st;
    l0 = st.l1;
  }
  return 0;
}

// Floats of device memory between the stages: two (B, N, cp) bf16 buffers, ping-pong.
long long plan_workspace(const Chain& ch, const Plan& plan, int B, int N) {
  long long most = 0;
  for (int i = 0; i + 1 < plan.n; ++i) {
    const long long f = cdiv(static_cast<long long>(B) * N * ch.cp[plan.s[i].l1 - 1], 2);
    if (f > most) most = f;
  }
  most = (most + 3) & ~3LL;  // 16-byte aligned halves
  return plan.n > 2 ? 2 * most : most;
}

int run_plan(StageArgs a, int final_mode, float* final_out, float* ws, long long ws_floats,
             cudaStream_t stream) {
  const DeviceInfo& dev = device_info();
  if (dev.err) return dev.err;
  Plan plan;
  int err = make_plan(a.ch, a.B, a.N, dev.sms, &plan);
  if (err) return err;
  const long long need = plan_workspace(a.ch, plan, a.B, a.N);
  if (ws_floats < need) return kErrWorkspace;
  const long long half = plan.n > 2 ? need / 2 : need;
  a.tpb = plan.tpb;
  a.tiles = plan.tiles;
  for (int i = 0; i < plan.n; ++i) {
    const Stage& st = plan.s[i];
    const bool final_stage = i == plan.n - 1;
    a.l0 = st.l0;
    a.l1 = st.l1;
    a.cpz = st.cpz;
    a.P = st.P;
    a.nst = st.nst;
    a.resident = st.resident;
    a.sbytes = st.sbytes;
    a.wg_bytes = st.wg_bytes;
    a.o_buf1 = st.o_buf1;
    a.o_b0 = st.o_b0;
    a.o_pool = st.o_pool;
    a.o_bias = st.o_bias;
    a.o_ring = st.o_ring;
    a.o_bar = st.o_bar;
    a.mode = final_stage ? final_mode : kStore;
    a.out = final_stage ? static_cast<void*>(final_out) : static_cast<void*>(ws + (i & 1) * half);
    const dim3 grid(st.gx, 1, st.nz);
    if (st.stream) chain_bf16_kernel<1, true><<<grid, block_threads(1), st.smem, stream>>>(a);
    else if (st.nwg == 2) chain_bf16_kernel<2, false><<<grid, block_threads(2), st.smem, stream>>>(a);
    else chain_bf16_kernel<1, false><<<grid, block_threads(1), st.smem, stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    a.in = a.out;
    a.in_bf16 = 1;
    a.in_width = a.ch.cp[st.l1 - 1];
  }
  return 0;
}

}  // namespace

// Floats of workspace that chain_fused_k1_bf16 / _k2_bf16 need for this chain
// and shape (0 when the chain runs as one launch), or a negative error code.
extern "C" long long chain_fused_bf16_workspace(const int* widths, int n_layers, int B, int N) {
  Chain ch;
  int err = make_layout(widths, n_layers, -1, &ch);
  if (err) return err;
  if (B < 1 || N < 1) return kErrLayout;
  const DeviceInfo& dev = device_info();
  if (dev.err) return dev.err;
  Plan plan;
  if ((err = make_plan(ch, B, N, dev.sms, &plan))) return err;
  return plan_workspace(ch, plan, B, N);
}

// params packed by pack_layer_bf16; x, tap and pooled f32.
extern "C" int chain_fused_k1_bf16(const float* x, const float* params, long long n_params,
                                   const int* widths, int n_layers, int B, int N, int tap_at,
                                   float* tap, float* pooled, float* ws, long long ws_floats,
                                   void* stream) {
  StageArgs a{};
  int err = make_layout(widths, n_layers, n_params, &a.ch);
  if (err) return err;
  if (tap_at >= n_layers - 1 || (tap_at >= 0 && !tap) || B < 1 || N < 1) return kErrLayout;
  if (tap_at >= 0 && a.ch.c[tap_at + 1] % 8) return kErrWidth;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(
      pooled, 0, static_cast<size_t>(B) * a.ch.c[n_layers] * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.in = x;
  a.in_width = a.ch.c[0];
  a.params = params;
  a.tap = tap;
  a.tap_at = tap_at;
  a.B = B;
  a.N = N;
  return run_plan(a, kPool, pooled, ws, ws_floats, s);
}

// widths = [C_tap, C1, ..., C_out]; params packs W_tap (C_tap x C1) and b'_0
// as layer 0; w_pool is (C_pool x C1) row-major f32 (rounded to bf16 here); g
// is scratch of (B, C1).
extern "C" int chain_fused_k2_bf16(const float* tap, const float* pooled, const float* w_pool,
                                   const float* params, long long n_params, const int* widths,
                                   int n_layers, int c_pool, int B, int N, float* g, float* out,
                                   float* ws, long long ws_floats, void* stream) {
  StageArgs a{};
  int err = make_layout(widths, n_layers, n_params, &a.ch);
  if (err) return err;
  if (n_layers < 2 || c_pool < 1 || B < 1 || N < 1) return kErrLayout;
  if (a.ch.c[1] % 8) return kErrWidth;  // g's rows are read as the padded bias of layer 0
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c1 = a.ch.c[1];
  const dim3 grid(static_cast<unsigned>(cdiv(c1, kGemvO)), B);
  pool_bias_kernel<<<grid, kGemvThreads, 0, s>>>(pooled, w_pool, params + a.ch.bias[0], g, c_pool, c1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  a.in = tap;
  a.in_width = a.ch.c[0];
  a.params = params;
  a.bias0 = g;
  a.tap_at = -1;
  a.B = B;
  a.N = N;
  return run_plan(a, kPlain, out, ws, ws_floats, s);
}

#ifdef BF16_PHASES
extern "C" {
// The phase counters' cycles since the last call (kPhases of them), then zero.
int chain_bf16_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, bf16_phase_cycles, sizeof(unsigned long long) * kPhases);
  const unsigned long long zero[kPhases] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(bf16_phase_cycles, zero, sizeof(zero));
  return static_cast<int>(e);
}

// The plan the entries make for a chain and shape, without a launch: out[0]
// the stages, then {l0, l1, consumer warpgroups, input streamed} a stage
// (1 + 4 kMaxLayers ints); returns 0 or an error code.
int chain_bf16_plan(const int* widths, int n_layers, int B, int N, int* out) {
  Chain ch;
  int err = make_layout(widths, n_layers, -1, &ch);
  if (err) return err;
  const DeviceInfo& dev = device_info();
  if (dev.err) return dev.err;
  Plan plan;
  if ((err = make_plan(ch, B, N, dev.sms, &plan))) return err;
  out[0] = plan.n;
  for (int i = 0; i < plan.n; ++i) {
    out[1 + 4 * i] = plan.s[i].l0;
    out[2 + 4 * i] = plan.s[i].l1;
    out[3 + 4 * i] = plan.s[i].nwg;
    out[4 + 4 * i] = plan.s[i].stream;
  }
  return 0;
}
}
#endif
