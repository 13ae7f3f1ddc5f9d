// Fused eval-mode PointNet chains for Hopper (sm_90a) on the tensor cores, in 3xTF32.
//
// K1  chain_fused_k1 replaces open3dsot_tpu/ops/chain_fused.py::fused_pointnet_encoder
//     (Pallas kernel _k_p1). Per point: Dense layers with BatchNorm folded in,
//     each followed by ReLU; optionally layer `tap_at` is written out as a tap;
//     the last layer is max-pooled over all N points into (B, C_last).
// K2  chain_fused_k2 replaces open3dsot_tpu/ops/chain_fused.py::fused_seg_head
//     (Pallas kernel _k_p2). concat(tap, broadcast(pooled)) -> folded chain with
//     ReLU -> plain head Dense -> per-point logits (B, N, C_out).
//
// What bounds them on this card. At M2-Track's widths (SegPointNet mlp1
// 14-64-64-64-128-1024, mlp2 1088-512-256-128-128 + head 11, MiniPointNet
// 13-64-128-256-512) the work is 150-300 thousand multiply-adds per point
// against a few hundred bytes of input and output per point: arithmetic, not
// device memory, once the activations stay on chip. CUDA cores give 67
// TFLOP/s in f32; the tensor cores 494.7 TFLOP/s dense in TF32. TF32 keeps 10
// mantissa bits, enough to flip the argmax of the seg logits that picks
// M2-Track's foreground points, so every product here is 3xTF32:
//   a = a_hi + a_lo, a_hi = rna_tf32(a), a_lo = rna_tf32(a - a_hi), w likewise,
//   a * w ~ a_lo * w_hi + a_hi * w_lo + a_hi * w_hi   (f32 accumulators),
// dropping a_lo * w_lo (about 2^-22 of the product). Three tensor-core
// products per multiply-add: a bound of 3 x FLOP / 494.7 TFLOP/s, about 2.5x
// below the CUDA-core f32 bound. The weights' hi and lo parts are split once
// on the host (ops/chain_fused.py::FoldedChain), the activations' in registers
// as each fragment is loaded.
//
// What the design does about it.
//  - Instructions. A block owns a tile of TP points of one batch element.
//    TP = 64: two warpgroups, each wgmma m64n64k8 (TF32, f32 accumulate) on
//    half of a 128-channel weight chunk, A (the activations) from registers,
//    B (W^T) from shared memory. TF32 wgmma takes B only K-major, so W is
//    packed transposed at fold time. A from registers lets each warp load its
//    fragment from a padded row-major tile (row stride K + 4 floats: the 32
//    loads hit 32 banks) and split it into hi and lo as it loads, with no
//    second copy of the activations in shared memory. The wgmma code has no
//    branch around it (ptxas serialises wgmma in a divergent path): past the
//    layer's width the A fragments are zeros and the chunk's weights are zero
//    padding. TP = 16 or 32 (the narrow layers at small B, below): eight
//    warps side by side over the chunk's channels with mma.sync m16n8k8,
//    whose 16-row tiles leave no rows empty where wgmma's 64 would.
//  - Weights staged in shared memory. The host packs each layer as whole
//    chunks of 128 output x 32 input channels, W^T hi then W^T lo, each in
//    wgmma's no-swizzle K-major layout (8 x 4 "core matrices" of 128 bytes),
//    so one bulk copy (TMA, cp.async.bulk) brings a 32 KB chunk into shared
//    memory as the tensor cores read it, completing on an mbarrier. Two
//    stages: the next chunk (of this layer or the next) loads while the
//    current one multiplies. Nothing in the inner loop reads L2.
//  - Stages (the host's plan): a chain runs as one or more launches, each a
//    run of layers over point tiles; between launches the activations go
//    through a (B, N, C) buffer in device memory (at most 32 MB, mostly held
//    in the 50 MB L2). When B x N / 64 tiles fill the card (B = 16), a stage
//    is as many layers as fit in shared memory at TP = 64 (seg mlp1 and the
//    MiniPointNets in one launch; K2 as 64->512->256, then 256->128->128->11).
//    When they do not (B = 1: 32 tiles for 132 SMs), a wide layer (more than
//    128 x 256 multiply-adds per point: 128->1024, 256->512, 512->256) is a
//    launch of its own at TP = 64 whose grid also splits its output channels,
//    one 128-wide chunk per block, and the narrow layers between run on 16-
//    or 32-point tiles. No layer is computed twice.
//  - Pool across blocks: blocks run in no order, so the TPU's "start at -inf
//    on the first tile, max-accumulate in grid order" cannot be carried over.
//    The pooled layer is ReLU'd, so every value is >= 0 and the int bit
//    pattern of a non-negative float orders like the float: the pool starts at
//    0 (cudaMemsetAsync) and each warp reduces its rows with shuffles and does
//    one atomicMax on the int bits per channel. Exact, independent of order.
//  - Ragged tiles: the last tile is masked. A zero input row does not give a
//    zero output (it gives relu(b') through the chain), so rows past N are
//    kept out of the max, the tap and the stored output.
//  - Widths the tensor cores do not take: every layer's input width is padded
//    to a multiple of 8 (14, 13, 12 -> 16) with zeros in shared memory and
//    zero weight columns; its output width likewise (the head's 11 -> 16)
//    with zero weight rows, and only the real columns are stored.
//  - K2's concat: the first weight (C_tap + C_pool) x C1 is split into W_tap
//    and W_pool. g[b] = pooled[b] W_pool + b'_0 is computed once per batch
//    element by pool_bias_kernel (an f32 GEMV split over input channels), and
//    the per-point chain then starts from relu(tap W_tap + g[b]).
//  - Host work per launch is the plan and the launches: the device's SM count
//    and the kernels' shared-memory limit are set once per process.
//
// The bf16 mode is chain_fused_bf16.cu.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// stream is PyTorch's current stream. Each entry returns 0, a CUDA error code,
// or a negative code for arguments the kernels do not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tc.cuh"  // kCC x kKC weight chunks, the TF32 split, mma.sync, wgmma, TMA

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;                // weight chunks in shared memory: one loads ahead
constexpr int kAhead = kStages - 1;       // chunks loading while one multiplies
constexpr int kSmemMax = 232448;          // 227 KB, the most a block may take
constexpr long long kWideMacs = 128 * 256;  // a layer above this is "wide" (own launch at small B)

constexpr int kErrLayout = -1;   // layer count, widths or packed size wrong
constexpr int kErrWidth = -2;    // the tap or K2's first width is not a multiple of 8
constexpr int kErrSmem = -3;     // a layer does not fit in shared memory
constexpr int kErrWorkspace = -4;  // workspace smaller than the plan needs

enum Mode { kStore = 0, kPool = 1, kPlain = 2 };

struct Chain {
  int n_layers;
  int c[kMaxLayers + 1];           // real widths
  int kp[kMaxLayers], cp[kMaxLayers];  // input / output widths padded to 8
  int nk[kMaxLayers];              // input chunks of kKC channels
  long long w[kMaxLayers], bias[kMaxLayers];  // float offsets in params
};

struct StageArgs {
  const float* in;      // (B, N, in_width)
  const float* params;  // per layer: its weight chunks, then b (cp)
  const float* bias0;   // nullptr, or (B, cp[0]): per-batch bias of layer 0 (K2's g)
  float* tap;           // (B, N, c[tap_at + 1]) when tap_at >= 0
  float* out;           // kStore: (B, N, cp[l1 - 1]); kPool: (B, c[L]); kPlain: (B, N, c[L])
  int in_width, tap_at, mode, l0, l1;
  int cpz;              // 0: every chunk of the last layer; else chunks [z * cpz, z * cpz + cpz)
  int B, N;
  int buf1, wbase, bars;  // smem float offsets: activation buffer 1, weight stages, mbarriers
  Chain ch;
};

inline int round8(int n) { return (n + 7) & ~7; }

// Offsets of each layer's weight chunks and b in the packed buffer. A layer
// is ceil(cp / kCC) x nk chunks, output chunk major; a chunk is kWStage
// contiguous floats, W^T hi then W^T lo of kCC output x kKC input channels,
// zero-padded, each in the order of wofs() (tf32_tc.cuh): one bulk copy brings
// a chunk into shared memory as the tensor cores read it. The Python side
// (open3dsot_tpu_torch/ops/chain_fused.py::pack_layer) packs by the same rule.
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
    ch->kp[l] = round8(ch->c[l]);
    ch->cp[l] = round8(ch->c[l + 1]);
    ch->nk[l] = (ch->kp[l] + kKC - 1) / kKC;
    ch->w[l] = off;
    off += static_cast<long long>((ch->cp[l] + kCC - 1) / kCC) * ch->nk[l] * kWStage;
    ch->bias[l] = off;
    off += ch->cp[l];
  }
  return n_params < 0 || off == n_params ? 0 : kErrLayout;
}

// Output-channel chunks [c0, c1) of layer l that this block computes.
__device__ __forceinline__ void chunk_range(const StageArgs& a, int l, int& c0, int& c1) {
  const int n = (a.ch.cp[l] + kCC - 1) / kCC;
  if (l == a.l1 - 1 && a.cpz > 0) {
    c0 = blockIdx.z * a.cpz;
    c1 = min(n, c0 + a.cpz);
  } else {
    c0 = 0;
    c1 = n;
  }
}

// Weight chunk (layer l, output chunk cb, input chunk kb) in device memory.
__device__ __forceinline__ const float* chunk_src(const StageArgs& a, int l, int cb, int kb) {
  return a.params + a.ch.w[l] + (static_cast<long long>(cb) * a.ch.nk[l] + kb) * kWStage;
}

// The chunk after (l, cb, kb) in this block's order; false past the stage's end.
__device__ __forceinline__ bool next_chunk(const StageArgs& a, int& l, int& cb, int& kb) {
  if (++kb < a.ch.nk[l]) return true;
  kb = 0;
  int c0, c1;
  chunk_range(a, l, c0, c1);
  if (++cb < c1) return true;
  if (++l >= a.l1) return false;
  chunk_range(a, l, cb, c1);
  return true;
}

// TP = 64: two warpgroups, each wgmma m64n64 on half of a 128-channel chunk
// (warp w of a warpgroup holds rows 16w..16w+15 of the D fragment). TP = 16,
// 32: eight warps side by side over the chunk's channels, mma.sync m16n8k8,
// for the small point tiles that wgmma's 64 rows would leave mostly empty.
template <int TP>
__global__ void __launch_bounds__(kThreads) chain_tc_kernel(const StageArgs a) {
  constexpr bool WG = TP == 64;
  constexpr int WN = WG ? 2 : kWarps;  // warp columns over a chunk
  constexpr int RW = WG ? 16 : TP;     // points per warp
  constexpr int MT = RW / 16;          // m16 tiles per warp
  constexpr int CW = kCC / WN;         // channels per warp
  constexpr int NT = CW / 8;           // n8 tiles per warp
  static_assert(MT >= 1 && NT >= 1 && (!WG || (MT == 1 && NT == 8)), "warp tile");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* wsm = sm + a.wbase;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + a.bars);  // one per weight stage

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  const int nv = min(TP, a.N - p0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;  // fragment row group, thread in group
  const int rbase = WG ? (warp & 3) * 16 : 0, cbase = WG ? (warp >> 2) * CW : warp * CW;

  // thread 0 keeps kAhead weight chunks in flight: (pl, pcb, pkb) is the next
  int c0, c1;
  int pl = a.l0, pcb, pkb = 0;
  chunk_range(a, pl, pcb, c1);
  bool more = true;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < kAhead && more; ++st) {
      bulk_load(wsm + st * kWStage, chunk_src(a, pl, pcb, pkb), &bars[st]);
      more = next_chunk(a, pl, pcb, pkb);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  {  // input tile -> buffer 0; rows past N and columns past in_width are zeros
    const int kp = a.ch.kp[a.l0], s = kp + 4, w = a.in_width;
    const float* src = a.in + (static_cast<size_t>(b) * a.N + p0) * w;
    if (w == kp) {  // a stage's buffer from device memory, rows of kp floats
      const int k4 = kp / 4;
      for (int i = tid; i < TP * k4; i += kThreads) {
        const int p = i / k4, k = (i - p * k4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < nv) v = __ldg(reinterpret_cast<const float4*>(src + p * w + k));
        *reinterpret_cast<float4*>(sm + p * s + k) = v;
      }
    } else {  // the chain's own input (14, 13, 12 wide): one contiguous span of x
      for (int i = tid; i < TP * kp; i += kThreads) {
        const int p = i / kp, k = i - p * kp;
        sm[p * s + k] = (p < nv && k < w) ? src[p * w + k] : 0.f;
      }
    }
  }


  int t = 0;  // weight chunks consumed: stage t % kStages holds chunk t
  for (int l = a.l0; l < a.l1; ++l) {
    const int kp = a.ch.kp[l], cp = a.ch.cp[l], nk = (kp + kKC - 1) / kKC;
    const bool last = l == a.l1 - 1;
    const bool odd = (l - a.l0) & 1;
    const float* hin = odd ? sm + a.buf1 : sm;
    float* hout = odd ? sm : sm + a.buf1;
    const int sin = kp + 4, sout = cp + 4;
    chunk_range(a, l, c0, c1);
    const float* bias = (l == 0 && a.bias0) ? a.bias0 + static_cast<size_t>(b) * cp
                                            : a.params + a.ch.bias[l];
    for (int cb = c0; cb < c1; ++cb) {
      const int cw = min(kCC, cp - cb * kCC);
      float acc[MT][NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = cb * kCC + cbase + nt * 8 + 2 * q;
        const bool ok = cbase + nt * 8 < cw;
        const float b0 = ok ? __ldg(bias + n) : 0.f, b1 = ok ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][0] = b0; acc[mt][nt][1] = b1;
          acc[mt][nt][2] = b0; acc[mt][nt][3] = b1;
        }
      }
      for (int kb = 0; kb < nk; ++kb, ++t) {
        mbar_wait(&bars[t % kStages], (t / kStages) & 1);  // chunk t has landed
        __syncthreads();  // every warp is done with chunk t - 1 and its stage
        if (tid == 0 && more) {  // refill chunk t - 1's stage, kAhead chunks ahead, across layers
          const int st = (t + kAhead) % kStages;
          bulk_load(wsm + st * kWStage, chunk_src(a, pl, pcb, pkb), &bars[st]);
          more = next_chunk(a, pl, pcb, pkb);
        }
        const float* wh = wsm + (t % kStages) * kWStage;
        const float* wl = wh + kWPart;
        const int ks_n = min(kKC, kp - kb * kKC) / 8;
        // The tensor cores do not round their f32 sums to nearest, and over
        // K = 512 that moved M2-Track's boxes by 7e-3 from the plain path. So
        // the two small terms go into small, whose roundings are 2^-11 the
        // size, and acc takes the large ones on the CUDA cores: wgmma writes
        // each 8-input hi * hi product to a fresh bg (two in flight), mma.sync
        // sums a chunk's into big; both added to acc after the chunk.
        float big[MT][NT][4], small[MT][NT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) big[mt][nt][i] = small[mt][nt][i] = 0.f;
        if constexpr (WG) {
          // no branch around wgmma (ptxas would serialise them all): past kp
          // the A fragments are zeros, past cw the chunk's weights are
          uint32_t ah[kKC / 8][4], al[kKC / 8][4];
#pragma unroll
          for (int ks = 0; ks < kKC / 8; ++ks) {
            const float* pa = hin + (rbase + g) * sin + kb * kKC + ks * 8 + q;
            const bool in = ks < ks_n;
            split_tf32(in ? pa[0] : 0.f, ah[ks][0], al[ks][0]);
            split_tf32(in ? pa[8 * sin] : 0.f, ah[ks][1], al[ks][1]);
            split_tf32(in ? pa[4] : 0.f, ah[ks][2], al[ks][2]);
            split_tf32(in ? pa[8 * sin + 4] : 0.f, ah[ks][3], al[ks][3]);
          }
          float bg[2][NT][4];
#pragma unroll
          for (int ks = 0; ks < kKC / 8; ++ks) {
            const uint64_t dh = smem_desc(wh + wofs(cbase, ks * 8));
            const uint64_t dl = smem_desc(wl + wofs(cbase, ks * 8));
            wgmma_fence();
            wgmma_m64n64k8<1>(small[0], al[ks], dh);
            wgmma_m64n64k8<1>(small[0], ah[ks], dl);
            wgmma_m64n64k8<0>(bg[ks & 1], ah[ks], dh);
            wgmma_commit();
            if (ks > 0) {
              wgmma_wait<1>();  // step ks - 1 is done: its hi * hi into acc
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[0][nt][i] += bg[(ks - 1) & 1][nt][i];
            }
          }
          // all of chunk t's products are in before its A registers are reused
          // and, after the next __syncthreads, its stage is refilled
          wgmma_wait<0>();
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[0][nt][i] += bg[(kKC / 8 - 1) & 1][nt][i];
        } else {
#pragma unroll
          for (int ks = 0; ks < kKC / 8; ++ks) {
            if (ks < ks_n) {
              uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const int off = wofs(cbase + nt * 8 + g, ks * 8 + q);
                bh[nt][0] = __float_as_uint(wh[off]);
                bh[nt][1] = __float_as_uint(wh[off + 32]);
                bl[nt][0] = __float_as_uint(wl[off]);
                bl[nt][1] = __float_as_uint(wl[off + 32]);
              }
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const float* pa = hin + (rbase + mt * 16 + g) * sin + kb * kKC + ks * 8 + q;
                uint32_t ah[4], al[4];
                split_tf32(pa[0], ah[0], al[0]);
                split_tf32(pa[8 * sin], ah[1], al[1]);
                split_tf32(pa[4], ah[2], al[2]);
                split_tf32(pa[8 * sin + 4], ah[3], al[3]);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  if (cbase + nt * 8 < cw) {
                    mma_tf32(small[mt][nt], al, bh[nt][0], bh[nt][1]);
                    mma_tf32(small[mt][nt], ah, bl[nt][0], bl[nt][1]);
                    mma_tf32(big[mt][nt], ah, bh[nt][0], bh[nt][1]);
                  }
                }
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += big[mt][nt][i] + small[mt][nt][i];
      }

      // epilogue of chunk cb: fragment (mt, nt) holds rows rbase + mt*16 + g (+8),
      // columns n, n + 1
      const bool is_tap = l == a.tap_at;
      const int ct = a.ch.c[l + 1];
      if (!last || a.mode == kStore) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (cbase + nt * 8 >= cw) continue;
          const int n = cb * kCC + cbase + nt * 8 + 2 * q;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rbase + mt * 16 + g + 8 * h;
              const float2 v = make_float2(fmaxf(acc[mt][nt][2 * h], 0.f),
                                           fmaxf(acc[mt][nt][2 * h + 1], 0.f));
              if (!last) *reinterpret_cast<float2*>(hout + r * sout + n) = v;
              if (r < nv) {
                const size_t row = static_cast<size_t>(b) * a.N + p0 + r;
                if (last) *reinterpret_cast<float2*>(a.out + row * cp + n) = v;
                if (is_tap) *reinterpret_cast<float2*>(a.tap + row * ct + n) = v;
              }
            }
          }
        }
      } else if (a.mode == kPool) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (cbase + nt * 8 >= cw) continue;
          float m0 = 0.f, m1 = 0.f;  // the ReLU: the pool starts at 0
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (rbase + mt * 16 + g + 8 * h < nv) {
                m0 = fmaxf(m0, acc[mt][nt][2 * h]);
                m1 = fmaxf(m1, acc[mt][nt][2 * h + 1]);
              }
            }
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          const int n = cb * kCC + cbase + nt * 8 + 2 * q;
          int* dst = reinterpret_cast<int*>(a.out + static_cast<size_t>(b) * ct + n);
          if (g == 0 && n < ct && m0 > 0.f) atomicMax(dst, __float_as_int(m0));
          if (g == 0 && n + 1 < ct && m1 > 0.f) atomicMax(dst + 1, __float_as_int(m1));
        }
      } else {  // kPlain: the head, no ReLU, only the real columns
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (cbase + nt * 8 >= cw) continue;
          const int n = cb * kCC + cbase + nt * 8 + 2 * q;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rbase + mt * 16 + g + 8 * h;
              if (r >= nv) continue;
              float* dst = a.out + (static_cast<size_t>(b) * a.N + p0 + r) * ct + n;
              if (n < ct) dst[0] = acc[mt][nt][2 * h];
              if (n + 1 < ct) dst[1] = acc[mt][nt][2 * h + 1];
            }
          }
        }
      }
    }
  }
}

// g[b, o] = b0[o] + sum_k pooled[b, k] * w_pool[k, o]; 32 outputs x 8 slices of k per block.
constexpr int kGemvO = 32;
constexpr int kGemvK = kThreads / kGemvO;

__global__ void __launch_bounds__(kThreads) pool_bias_kernel(
    const float* pooled, const float* w_pool, const float* b0, float* g, int Cp, int C) {
  __shared__ float part[kGemvK][kGemvO];
  const int b = blockIdx.y;
  const int lo = threadIdx.x % kGemvO, kg = threadIdx.x / kGemvO;
  const int o = blockIdx.x * kGemvO + lo;
  const float* pv = pooled + static_cast<size_t>(b) * Cp;
  float acc = 0.f;
  if (o < C)
    for (int k = kg; k < Cp; k += kGemvK) {
      const float p = pv[k], w = __ldg(w_pool + static_cast<size_t>(k) * C + o);
      acc = fmaf(p, w, acc);
    }
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
    const void* kernels[] = {reinterpret_cast<const void*>(chain_tc_kernel<16>),
                             reinterpret_cast<const void*>(chain_tc_kernel<32>),
                             reinterpret_cast<const void*>(chain_tc_kernel<64>)};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    d.err = static_cast<int>(e);
    return d;
  }();
  return info;
}

struct Stage {
  int l0, l1, tp, cpz, nz;
  int buf1, wbase, bars;
  size_t smem;
};

struct Plan {
  int n;
  Stage s[kMaxLayers];
};

// Shared memory of layers [l0, l1) on TP-point tiles: buffer 0 holds the
// input of layers l0, l0 + 2, ...; buffer 1 of l0 + 1, ...; then two weight stages.
bool stage_fits(const Chain& ch, int l0, int l1, int tp, Stage* st) {
  long long w[2] = {0, 0};
  for (int l = l0; l < l1; ++l) {
    const long long f = static_cast<long long>(tp) * (ch.kp[l] + 4);
    const int i = (l - l0) & 1;
    if (f > w[i]) w[i] = f;
  }
  const long long wbase = (w[0] + w[1] + 31) & ~31LL;  // 128-byte aligned weight stages
  const long long bars = wbase + static_cast<long long>(kStages) * kWStage;
  const long long floats = bars + 2 * kStages;
  if (floats * 4 > kSmemMax) return false;
  st->l0 = l0;
  st->l1 = l1;
  st->tp = tp;
  st->buf1 = static_cast<int>(w[0]);
  st->wbase = static_cast<int>(wbase);
  st->bars = static_cast<int>(bars);
  st->smem = static_cast<size_t>(floats) * 4;
  return true;
}

int make_plan(const Chain& ch, int B, int N, int sms, Plan* plan) {
  const int L = ch.n_layers;
  const auto tiles = [&](int tp) { return static_cast<long long>(B) * ((N + tp - 1) / tp); };
  const auto wide = [&](int l) { return static_cast<long long>(ch.kp[l]) * ch.cp[l] > kWideMacs; };
  const bool full = tiles(64) >= sms;
  plan->n = 0;
  for (int l0 = 0; l0 < L;) {
    Stage st{};
    if (!full && wide(l0)) {  // one layer, its output channels split over the grid
      const int nz = (ch.cp[l0] + kCC - 1) / kCC;
      int tp = 64;
      while (tp > 16 && !stage_fits(ch, l0, l0 + 1, tp, &st)) tp /= 2;
      if (!stage_fits(ch, l0, l0 + 1, tp, &st)) return kErrSmem;
      st.cpz = 1;
      st.nz = nz;
    } else {  // as many layers as fit, on the largest tile that fills the card
      int tp = 64;
      while (tp > 16 && !(tiles(tp) >= sms && stage_fits(ch, l0, l0 + 1, tp, &st))) tp /= 2;
      if (!stage_fits(ch, l0, l0 + 1, tp, &st)) return kErrSmem;
      int l1 = l0 + 1;
      Stage longer{};
      while (l1 < L && (full || !wide(l1)) && stage_fits(ch, l0, l1 + 1, tp, &longer)) {
        st = longer;
        ++l1;
      }
      st.cpz = 0;
      st.nz = 1;
    }
    plan->s[plan->n++] = st;
    l0 = st.l1;
  }
  return 0;
}

// Floats of device memory between the stages: two (B, N, C) buffers, ping-pong.
long long plan_workspace(const Chain& ch, const Plan& plan, int B, int N) {
  long long most = 0;
  for (int i = 0; i + 1 < plan.n; ++i) {
    const long long f = static_cast<long long>(B) * N * ch.cp[plan.s[i].l1 - 1];
    if (f > most) most = f;
  }
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
  for (int i = 0; i < plan.n; ++i) {
    const Stage& st = plan.s[i];
    const bool final_stage = i == plan.n - 1;
    a.l0 = st.l0;
    a.l1 = st.l1;
    a.cpz = st.cpz;
    a.buf1 = st.buf1;
    a.wbase = st.wbase;
    a.bars = st.bars;
    a.mode = final_stage ? final_mode : kStore;
    a.out = final_stage ? final_out : ws + (i & 1) * half;
    const dim3 grid((a.N + st.tp - 1) / st.tp, a.B, st.nz);
    if (st.tp == 64) chain_tc_kernel<64><<<grid, kThreads, st.smem, stream>>>(a);
    else if (st.tp == 32) chain_tc_kernel<32><<<grid, kThreads, st.smem, stream>>>(a);
    else chain_tc_kernel<16><<<grid, kThreads, st.smem, stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    a.in = a.out;
    a.in_width = a.ch.cp[st.l1 - 1];
  }
  return 0;
}

}  // namespace

// Floats of workspace that chain_fused_k1 / _k2 need for this chain and shape
// (0 when the chain runs as one launch), or a negative error code.
extern "C" long long chain_fused_workspace(const int* widths, int n_layers, int B, int N) {
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

extern "C" int chain_fused_k1(const float* x, const float* params, long long n_params,
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
// as layer 0; w_pool is (C_pool x C1) row-major f32; g is scratch of (B, C1).
extern "C" int chain_fused_k2(const float* tap, const float* pooled, const float* w_pool,
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
  const dim3 grid((c1 + kGemvO - 1) / kGemvO, B);
  pool_bias_kernel<<<grid, kThreads, 0, s>>>(pooled, w_pool, params + a.ch.bias[0], g, c_pool, c1);
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
