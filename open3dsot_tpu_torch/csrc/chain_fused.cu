// Fused eval-mode PointNet chains for Hopper (sm_90a), f32 on CUDA cores.
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
// 13-64-128-256-512) the work is some 150-300 thousand multiply-adds per point
// against a few hundred bytes of input and output per point, so both kernels
// are bound by arithmetic, not by device memory, once the wide activations stay
// on chip. The folded weights do not fit in one block's shared memory (mlp1 is
// about 593 KB against 227 KB), so they are read through L1/L2 (50 MB L2 holds
// all of them); per-block smem holds activations only.
//
// What the design does about it.
//  - One block owns a tile of TP consecutive points of one batch element and
//    runs the whole chain on it. Activations ping-pong between two smem
//    buffers, each sized for the widest activation it holds; the
//    (B, N, 1024) / (B, N, 512) pooled layer is never stored: it is computed
//    in chunks of output channels and reduced at once.
//  - TP is 64, 32 or 16 (run_chain): the largest tile that leaves room for
//    two blocks per SM and still gives every SM two blocks of grid. The eval
//    loop runs B = 1, N = 2048, where 64-point tiles would give 32 blocks for
//    132 SMs; 16-point tiles give 128.
//  - Each thread computes a 4-point x 4-channel register tile: per input
//    channel k it loads one float4 of weights (neighbouring lanes read
//    neighbouring float4s of one weight row) and four broadcast smem
//    activations, then issues 16 FMAs.
//  - Pool across blocks: blocks run in no order, so the TPU's "start at -inf on
//    the first tile, max-accumulate in grid order" cannot be carried over.
//    The pooled layer is ReLU'd, so every value is >= 0 and the int bit
//    pattern of a non-negative float orders like the float: the pool starts at
//    0 (cudaMemsetAsync) and each block does one atomicMax on the int bits per
//    channel after reducing its own tile in smem. Exact, independent of order.
//  - Ragged tiles: the TPU picks a tile that divides N; here the last tile is
//    masked. A zero input row does not give a zero output (it gives relu(b')
//    through the chain), so rows past N are kept out of the max, the tap and
//    the stored output.
//  - Unaligned input widths (14, 13, 12): the input tile is TP rows of c[0]
//    floats, which is one contiguous span of x, loaded with coalesced scalar
//    loads whatever c[0] is. Weight rows are read as float4, so every width
//    after the first must be a multiple of 4 (checked below); the plain head of
//    K2 (11 wide) takes a scalar path.
//  - K2's concat: the first weight (C_tap + C_pool) x C1 is split into W_tap
//    and W_pool. g[b] = pooled[b] W_pool + b'_0 is computed once per batch
//    element by pool_bias_kernel (a GEMV split over input channels), and the
//    per-point chain then starts from relu(tap W_tap + g[b]).
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// stream is PyTorch's current stream. Each entry returns 0, a CUDA error code,
// or a negative code for arguments the kernels do not take.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kRP = 4;  // points per thread
constexpr int kRC = 4;  // output channels per thread (one float4)
constexpr int kMinBuf = 1024;  // the pool reduction uses PG * CHUNK = 1024 floats
constexpr size_t kSmemBudget = 200 * 1024;     // one block per SM (of 227 KB)
constexpr size_t kSmemTwoBlocks = 110 * 1024;  // two blocks per SM

constexpr int kErrLayout = -1;   // layer count, widths or packed size wrong
constexpr int kErrWidth = -2;    // a vector-path width is not a multiple of 4
constexpr int kErrSmem = -3;     // activations do not fit in shared memory

struct Chain {
  int n_layers;
  int c[kMaxLayers + 1];
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
};

struct ChainArgs {
  const float* x;       // (B, N, c[0])
  const float* params;  // packed per layer: W (c[l] x c[l+1], row-major), b (c[l+1])
  const float* bias0;   // nullptr, or (B, c[1]): per-batch bias of layer 0 (K2)
  float* tap;           // (B, N, c[tap_at + 1]) when tap_at >= 0
  float* out;           // pool mode: (B, c[L]); plain mode: (B, N, c[L])
  int tap_at;           // -1: no tap
  int plain_last;       // 0: last layer ReLU + max over points; 1: plain Dense per point
  int B, N;
  int buf_floats[2];  // ping-pong buffers: [0] holds c[0], c[2], ...; [1] holds c[1], c[3], ...
  Chain ch;
};

inline int round4(long long n) { return static_cast<int>((n + 3) & ~3LL); }

// Offsets of each layer's W and b in the packed buffer; every segment is
// padded to a multiple of 4 floats so float4 loads stay aligned. The Python
// side (open3dsot_tpu_torch/ops/chain_fused.py::_pack) packs by the same rule.
int make_layout(const int* widths, int n_layers, long long n_params, Chain* ch) {
  if (n_layers < 1 || n_layers > kMaxLayers) return kErrLayout;
  ch->n_layers = n_layers;
  long long off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1) return kErrLayout;
    ch->c[l] = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    ch->w_off[l] = static_cast<int>(off);
    off += round4(static_cast<long long>(ch->c[l]) * ch->c[l + 1]);
    ch->b_off[l] = static_cast<int>(off);
    off += round4(ch->c[l + 1]);
  }
  return off == n_params ? 0 : kErrLayout;
}

template <int TP>
__global__ void __launch_bounds__(kThreads) chain_kernel(const ChainArgs a) {
  constexpr int PG = TP / kRP;         // point groups
  constexpr int CG = kThreads / PG;    // channel groups
  constexpr int CHUNK = CG * kRC;      // output channels per pass
  static_assert(PG * CHUNK == kMinBuf, "pool reduction buffer size");
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  const int nv = min(TP, a.N - p0);
  const int tid = threadIdx.x;
  const int tp = tid / CG, tc = tid % CG;

  {  // input tile: one contiguous span of x; rows past N are zeros
    const int c0 = a.ch.c[0];
    const float* src = a.x + (static_cast<size_t>(b) * a.N + p0) * c0;
    const int n_in = nv * c0;
    for (int i = tid; i < TP * c0; i += kThreads) bufs[i] = i < n_in ? src[i] : 0.f;
  }
  __syncthreads();

  int cur = 0;
  const int L = a.ch.n_layers;
  for (int l = 0; l < L; ++l) {
    const int K = a.ch.c[l], C = a.ch.c[l + 1];
    const float* W = a.params + a.ch.w_off[l];
    const float* bias = (l == 0 && a.bias0) ? a.bias0 + static_cast<size_t>(b) * C
                                            : a.params + a.ch.b_off[l];
    const float* hin = cur ? bufs + a.buf_floats[0] : bufs;
    float* hout = cur ? bufs : bufs + a.buf_floats[0];
    const bool last = l == L - 1;

    if (last && a.plain_last) {  // K2 head: plain Dense, any width, valid rows only
      float* dst = a.out + (static_cast<size_t>(b) * a.N + p0) * C;
      for (int i = tid; i < nv * C; i += kThreads) {
        const int p = i / C, o = i - p * C;
        const float* h = hin + p * K;
        float acc = bias[o];
        for (int k = 0; k < K; ++k) acc = fmaf(h[k], __ldg(W + static_cast<size_t>(k) * C + o), acc);
        dst[i] = acc;
      }
      return;
    }

    for (int cb = 0; cb < C; cb += CHUNK) {
      const int c = cb + tc * kRC;
      const bool active = c < C;
      float acc[kRP][kRC];
      if (active) {
        const float4 bv = *reinterpret_cast<const float4*>(bias + c);
#pragma unroll
        for (int i = 0; i < kRP; ++i) {
          acc[i][0] = bv.x; acc[i][1] = bv.y; acc[i][2] = bv.z; acc[i][3] = bv.w;
        }
        const float* h = hin + tp * kRP * K;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(W + static_cast<size_t>(k) * C + c));
#pragma unroll
          for (int i = 0; i < kRP; ++i) {
            const float hv = h[i * K + k];
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
      if (!last) {
        if (active) {
#pragma unroll
          for (int i = 0; i < kRP; ++i) {
            const int row = tp * kRP + i;
            const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            *reinterpret_cast<float4*>(hout + row * C + c) = v;
            if (l == a.tap_at && row < nv)
              *reinterpret_cast<float4*>(a.tap + (static_cast<size_t>(b) * a.N + p0 + row) * C + c) = v;
          }
        }
      } else {  // pooled layer: tile max in smem, then one atomicMax per channel
        float* red = hout;  // the output buffer is free during the last layer
        if (active) {
#pragma unroll
          for (int j = 0; j < kRC; ++j) {
            float m = 0.f;
#pragma unroll
            for (int i = 0; i < kRP; ++i)
              if (tp * kRP + i < nv) m = fmaxf(m, acc[i][j]);
            red[tp * CHUNK + tc * kRC + j] = m;
          }
        }
        __syncthreads();
        for (int j = tid; j < CHUNK && cb + j < C; j += kThreads) {
          float m = 0.f;
          for (int g = 0; g < PG; ++g) m = fmaxf(m, red[g * CHUNK + j]);
          if (m > 0.f)  // the pool starts at 0: a 0 can raise nothing
            atomicMax(reinterpret_cast<int*>(a.out + static_cast<size_t>(b) * C + cb + j),
                      __float_as_int(m));
        }
        __syncthreads();
      }
    }
    __syncthreads();
    cur ^= 1;
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
    for (int k = kg; k < Cp; k += kGemvK) acc = fmaf(pv[k], __ldg(w_pool + static_cast<size_t>(k) * C + o), acc);
  part[kg][lo] = acc;
  __syncthreads();
  if (kg == 0 && o < C) {
    float s = b0[o];
    for (int i = 0; i < kGemvK; ++i) s += part[i][lo];
    g[static_cast<size_t>(b) * C + o] = s;
  }
}

// Widest activation each ping-pong buffer holds: layer l reads buffer l % 2
// and writes buffer (l + 1) % 2; the last layer's output is never stored.
void held_widths(const Chain& ch, int w[2]) {
  w[0] = w[1] = 0;
  for (int l = 0; l < ch.n_layers; ++l) w[l & 1] = ch.c[l] > w[l & 1] ? ch.c[l] : w[l & 1];
}

template <int TP>
size_t smem_bytes(const Chain& ch, int buf_floats[2]) {
  int w[2];
  held_widths(ch, w);
  for (int i = 0; i < 2; ++i) {
    const int held = round4(static_cast<long long>(TP) * w[i]);
    buf_floats[i] = held > kMinBuf ? held : kMinBuf;  // also the pool reduction's room
  }
  return static_cast<size_t>(buf_floats[0] + buf_floats[1]) * sizeof(float);
}

template <int TP>
int launch_chain(ChainArgs a, cudaStream_t stream) {
  const size_t smem = smem_bytes<TP>(a.ch, a.buf_floats);
  if (smem > kSmemBudget) return kErrSmem;
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<TP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.N + TP - 1) / TP, a.B);
  chain_kernel<TP><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest tile (more reuse of each weight load) that still leaves room
// for two blocks on an SM and gives every SM two blocks of grid; else the
// 16-point tile. At N = 2048: B = 1 takes 16 (128 blocks); B = 16 takes 64
// for K1 and 32 for K2, whose 512-wide activations need 96 KB at 32 points.
int run_chain(const ChainArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int scratch[2];
  const long long want = 2LL * sms;
  const auto blocks = [&](int tp) { return static_cast<long long>((a.N + tp - 1) / tp) * a.B; };
  if (smem_bytes<64>(a.ch, scratch) <= kSmemTwoBlocks && blocks(64) >= want)
    return launch_chain<64>(a, stream);
  if (smem_bytes<32>(a.ch, scratch) <= kSmemTwoBlocks && blocks(32) >= want)
    return launch_chain<32>(a, stream);
  return launch_chain<16>(a, stream);
}

int check_vector_widths(const Chain& ch, int plain_last) {
  const int n_vec = ch.n_layers - (plain_last ? 1 : 0);
  for (int l = 1; l <= n_vec; ++l)
    if (ch.c[l] % 4) return kErrWidth;
  return 0;
}

}  // namespace

extern "C" int chain_fused_k1(const float* x, const float* params, long long n_params,
                              const int* widths, int n_layers, int B, int N, int tap_at,
                              float* tap, float* pooled, void* stream) {
  ChainArgs a{};
  int err = make_layout(widths, n_layers, n_params, &a.ch);
  if (err) return err;
  if ((err = check_vector_widths(a.ch, 0))) return err;
  if (tap_at >= n_layers - 1 || (tap_at >= 0 && !tap) || B < 1 || N < 1) return kErrLayout;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c_last = a.ch.c[n_layers];
  cudaError_t e = cudaMemsetAsync(pooled, 0, static_cast<size_t>(B) * c_last * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.x = x;
  a.params = params;
  a.bias0 = nullptr;
  a.tap = tap;
  a.out = pooled;
  a.tap_at = tap_at;
  a.plain_last = 0;
  a.B = B;
  a.N = N;
  return run_chain(a, s);
}

// widths = [C_tap, C1, ..., C_out]; params packs W_tap (C_tap x C1) and b'_0
// as layer 0; w_pool is (C_pool x C1); g is scratch of (B, C1).
extern "C" int chain_fused_k2(const float* tap, const float* pooled, const float* w_pool,
                              const float* params, long long n_params, const int* widths,
                              int n_layers, int c_pool, int B, int N, float* g, float* out,
                              void* stream) {
  ChainArgs a{};
  int err = make_layout(widths, n_layers, n_params, &a.ch);
  if (err) return err;
  if ((err = check_vector_widths(a.ch, 1))) return err;
  if (n_layers < 2 || c_pool < 1 || B < 1 || N < 1) return kErrLayout;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c1 = a.ch.c[1];
  const dim3 grid((c1 + kGemvO - 1) / kGemvO, B);
  pool_bias_kernel<<<grid, kThreads, 0, s>>>(pooled, w_pool, params + a.ch.b_off[0], g, c_pool, c1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  a.x = tap;
  a.params = params;
  a.bias0 = g;
  a.tap = nullptr;
  a.out = out;
  a.tap_at = -1;
  a.plain_last = 1;
  a.B = B;
  a.N = N;
  return run_chain(a, s);
}
