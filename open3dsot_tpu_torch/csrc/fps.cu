// Furthest point sampling for Hopper (sm_90a).
//
// K3  fps_k3 replaces open3dsot_tpu/ops/fps_pallas.py::furthest_point_sample_pallas
//     (Pallas kernel _fps_kernel). xyz (B, N, 3) f32 -> (B, npoint) int32:
//     seed index 0; each step picks the point whose squared distance to the
//     selected set (a running min that starts at 1e10) is largest, the lowest
//     index on ties.
//
// What bounds it on this card. The npoint - 1 steps form a serial chain: step
// s needs the point that step s - 1 picked. The work per step is tiny (about
// 9 operations a point and one argmax), so the card's peak rate bounds
// nothing; the time is npoint times the latency of one step: the distance
// updates a thread issues, its argmax, the warp's and the block's argmax and
// the read of the winner's coordinates. One cloud is one block, so at B = 1
// (the eval loop) the kernel runs on one SM of 132.
//
// What the design does about it.
//  - Fewer, fuller warps. T threads hold PPT points each, point j on thread
//    j % T, the cloud and its running min in registers for the whole loop.
//    ops/sampling.py::fps_block picks T by N from the block sweep of
//    chip_smoke.py phase 6 (256 threads at N = 1024, 512 at N = 512); this
//    file only checks it. One warp (T = 32) needs no barrier, but its one
//    issue slot of four SMSPs makes the distance updates its whole step.
//  - A thread's argmax over its PPT points is a tree (the lower slot wins a
//    tie), not a chain of compare-selects.
//  - A warp's argmax is two redux.sync: the largest key, then the lowest
//    index among the lanes that hold it. The bits of a float d^2 >= +0 order
//    as the float does, so the key is d^2's bits as an unsigned int. A masked
//    slot (j >= N) keeps d^2 = +0, key 0: it loses to every real point of a
//    larger key, and on key 0 to every real point by its index j >= N.
//  - One barrier a step: the owner of each warp's winner writes (key, index)
//    to the warp's slot, double-buffered by step parity; after the barrier
//    every warp reduces the slots with the same two redux.sync
//    (fps_step.cuh, which the skeleton floor in fps_floor.cu shares).
//  - The winner's coordinates come from a copy of the cloud in shared memory
//    (kShared, where 12 N bytes fit) or from the warp's slot, written by the
//    owner beside its key (kSlot, above 19264 points; then a thread's tree
//    carries coordinates). The copy was faster at every T above one warp.
//  - Tried on the card and slower: a ballot for the lowest lane in place of
//    redux.sync min, with points in ranges by thread and the coordinates
//    shuffled from the slots (about 16% a step); a 64-bit shared atomic max
//    of (key, ~index) in place of the slots' reduction (ptxas makes it a CAS
//    loop, about 60%).
//  - Exact indices need the same rounding as the plain version: d^2 is
//    ((dx*dx) + (dy*dy)) + (dz*dz) with __fmul_rn/__fadd_rn, which nvcc does
//    not contract into FMAs.
//  - The TPU kernel padded N with copies of point 0 and B to 8; here the
//    slots past N are masked and B is the grid.
//  - Clouds above kMaxN points (fps_k3_cluster): one block holds at most
//    1024 x 32 points in registers, so a cloud is split over a thread-block
//    cluster of kClusterBlocks blocks on one GPC, block r holding points [r
//    Nb, r Nb + Nb), Nb = 1024 PPT. Each step every block takes its own
//    argmax as above (the slots, one barrier), its thread 0 writes the
//    block's (key, index) into the block's cluster slot (double-buffered by
//    step parity), one cluster barrier, and every warp reads the
//    kClusterBlocks slots through distributed shared memory (lane r reads
//    block r's) and reduces them with the same two redux.sync. The winner's
//    coordinates are read from the cloud in device memory (L2): a load on
//    the step's chain, not a third barrier. Up to kClusterBlocks x 1024 x 32
//    = 262144 points.
//
// Interface: plain C, loaded with ctypes; pointers are device pointers and the
// stream is PyTorch's current stream. Returns 0, a CUDA error code, or a
// negative code for arguments the kernel does not take.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fps_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kErrArgs = -1;
constexpr int kErrBlock = -2;
constexpr int kErrShared = -3;
constexpr int kMaxN = 32768;
constexpr int kMaxPPT = 32;
constexpr int kSlot = 0, kShared = 1;  // where the winner's coordinates come from
// a block may use 227 KB of shared memory, 48 KB without opting in; the slots
// take 1280 bytes of it
constexpr int kStatic = 1280;
constexpr int kMaxShared = 232448 - kStatic;
constexpr int kClusterBlocks = 8;       // the blocks of a cloud above kMaxN (portable cluster size)
constexpr int kClusterThreads = 1024;
constexpr long long kMaxClusterN = static_cast<long long>(kClusterBlocks) * kClusterThreads * kMaxPPT;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// MAXT: the most threads the instantiation takes (its register budget)
template <int PPT, int MAXT, int WIN>
__global__ void __launch_bounds__(MAXT)
    fps_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  __shared__ unsigned slots[2][2][32];          // [key, index][step parity][warp]
  __shared__ float slot_xyz[3][2][32];          // kSlot: the winner's coordinates
  extern __shared__ float cloud[];              // kShared: x[N], y[N], z[N]
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  const unsigned s_slots = smem_u32(slots), s_xyz = smem_u32(slot_xyz);
  const unsigned s_cx = smem_u32(cloud), s_cy = s_cx + 4 * N, s_cz = s_cy + 4 * N;

  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = tid + i * T;
    const bool valid = j < N;
    px[i] = valid ? p[3 * j] : 0.f;
    py[i] = valid ? p[3 * j + 1] : 0.f;
    pz[i] = valid ? p[3 * j + 2] : 0.f;
    md[i] = valid ? 1e10f : 0.f;  // a masked slot stays at +0: key 0
    if (WIN == kShared && valid) {
      cloud[j] = px[i];
      cloud[N + j] = py[i];
      cloud[2 * N + j] = pz[i];
    }
  }
  init_slots(s_slots, tid, n_warps);
  float lx = p[0], ly = p[1], lz = p[2];
  if (tid == 0) o[0] = 0;
  __syncthreads();

  for (int s = 1; s < npoint; ++s) {
    const int buf = s & 1;
    // the running min, and the thread's argmax as a tree (the lower slot on ties)
    float v[PPT], bx[PPT], by[PPT], bz[PPT];
    int k[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      md[i] = fminf(md[i], sqdist(px[i], py[i], pz[i], lx, ly, lz));
      v[i] = md[i];
      k[i] = i;
      if (WIN == kSlot) {
        bx[i] = px[i];
        by[i] = py[i];
        bz[i] = pz[i];
      }
    }
#pragma unroll
    for (int w = 1; w < PPT; w *= 2) {
#pragma unroll
      for (int i = 0; i + w < PPT; i += 2 * w) {
        if (v[i + w] > v[i]) {
          v[i] = v[i + w];
          k[i] = k[i + w];
          if (WIN == kSlot) {
            bx[i] = bx[i + w];
            by[i] = by[i + w];
            bz[i] = bz[i + w];
          }
        }
      }
    }
    const unsigned idx = static_cast<unsigned>(tid + k[0] * T);
    unsigned wkey, widx;
    warp_argmax(__float_as_uint(v[0]), idx, wkey, widx);
    if (n_warps > 1) {  // uniform over the block
      if (WIN == kSlot && idx == widx) {
        const unsigned a = s_xyz + 4 * (32 * buf + warp);
        st_shared(a, bx[0]);
        st_shared(a + 4 * 64, by[0]);
        st_shared(a + 4 * 128, bz[0]);
      }
      block_argmax(s_slots, buf, lane, warp, idx, wkey, widx);
    }
    if (WIN == kShared) {
      lx = ld_shared_f32(s_cx + 4 * widx);
      ly = ld_shared_f32(s_cy + 4 * widx);
      lz = ld_shared_f32(s_cz + 4 * widx);
    } else if (n_warps > 1) {  // the winner's warp
      const unsigned a = s_xyz + 4 * (32 * buf + ((widx & static_cast<unsigned>(T - 1)) >> 5));
      lx = ld_shared_f32(a);
      ly = ld_shared_f32(a + 4 * 64);
      lz = ld_shared_f32(a + 4 * 128);
    } else {  // one warp: from the winner's lane
      const int l = static_cast<int>(widx & 31u);
      lx = __shfl_sync(kFull, bx[0], l);
      ly = __shfl_sync(kFull, by[0], l);
      lz = __shfl_sync(kFull, bz[0], l);
    }
    if (tid == 0) o[s] = static_cast<int>(widx);
  }
}

// A cloud over a cluster of kClusterBlocks blocks (the note at the top):
// block rank r of cloud blockIdx.x / kClusterBlocks holds points r Nb + tid +
// i T, Nb = T PPT.
template <int PPT>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kClusterThreads, 1)
    fps_cluster_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  __shared__ unsigned slots[2][2][32];  // [key, index][step parity][warp]
  __shared__ unsigned cslot[2][2];      // [step parity][key, index]: this block's winner
  const cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  constexpr int T = kClusterThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cloud = blockIdx.x / kClusterBlocks;
  const int base = static_cast<int>(rank) * T * PPT;
  const float* p = xyz + static_cast<size_t>(cloud) * N * 3;
  int* o = out + static_cast<size_t>(cloud) * npoint;
  const unsigned s_slots = smem_u32(slots);
  // lane r < kClusterBlocks reads block r's cluster slot
  const unsigned* remote =
      cluster.map_shared_rank(&cslot[0][0], lane < kClusterBlocks ? static_cast<unsigned>(lane) : 0u);

  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = base + tid + i * T;
    const bool valid = j < N;
    px[i] = valid ? p[3 * j] : 0.f;
    py[i] = valid ? p[3 * j + 1] : 0.f;
    pz[i] = valid ? p[3 * j + 2] : 0.f;
    md[i] = valid ? 1e10f : 0.f;  // a masked slot stays at +0: key 0
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  cluster.sync();  // every block of the cluster runs before any reads another's slot

  for (int s = 1; s < npoint; ++s) {
    const int buf = s & 1;
    float v[PPT];
    int k[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      md[i] = fminf(md[i], sqdist(px[i], py[i], pz[i], lx, ly, lz));
      v[i] = md[i];
      k[i] = i;
    }
#pragma unroll
    for (int w = 1; w < PPT; w *= 2) {
#pragma unroll
      for (int i = 0; i + w < PPT; i += 2 * w) {
        if (v[i + w] > v[i]) {
          v[i] = v[i + w];
          k[i] = k[i + w];
        }
      }
    }
    const unsigned idx = static_cast<unsigned>(base + tid + k[0] * T);
    unsigned wkey, widx;
    warp_argmax(__float_as_uint(v[0]), idx, wkey, widx);
    block_argmax(s_slots, buf, lane, warp, idx, wkey, widx);
    if (tid == 0) {
      cslot[buf][0] = wkey;
      cslot[buf][1] = widx;
    }
    // the slots of step s are written; every block has read those of step s - 1
    cluster.sync();
    const unsigned ck = lane < kClusterBlocks ? remote[2 * buf] : 0u;
    const unsigned ci = lane < kClusterBlocks ? remote[2 * buf + 1] : UINT_MAX;
    warp_argmax(ck, ci, wkey, widx);
    lx = __ldg(p + 3 * widx);
    ly = __ldg(p + 3 * widx + 1);
    lz = __ldg(p + 3 * widx + 2);
    if (rank == 0 && tid == 0) o[s] = static_cast<int>(widx);
  }
  cluster.sync();  // no block leaves while another may read its slots
}

template <int PPT, int MAXT, int WIN>
int launch(const float* xyz, int B, int N, int npoint, int* out, int threads, cudaStream_t s) {
  auto kernel = fps_kernel<PPT, MAXT, WIN>;
  const int smem = WIN == kShared ? 12 * N : 0;
  if (smem + kStatic > 48 * 1024) {  // above the default, with the slots
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, threads, smem, s>>>(xyz, N, npoint, out);
  return static_cast<int>(cudaGetLastError());
}

template <int PPT, int WIN>
int launch_ppt(const float* xyz, int B, int N, int npoint, int* out, int threads,
               cudaStream_t s) {
  return threads <= 256 ? launch<PPT, 256, WIN>(xyz, B, N, npoint, out, threads, s)
                        : launch<PPT, 1024, WIN>(xyz, B, N, npoint, out, threads, s);
}

template <int WIN>
int launch_win(const float* xyz, int B, int N, int npoint, int* out, int threads, int ppt,
               cudaStream_t s) {
  switch (ppt) {
    case 1: return launch_ppt<1, WIN>(xyz, B, N, npoint, out, threads, s);
    case 2: return launch_ppt<2, WIN>(xyz, B, N, npoint, out, threads, s);
    case 4: return launch_ppt<4, WIN>(xyz, B, N, npoint, out, threads, s);
    case 8: return launch_ppt<8, WIN>(xyz, B, N, npoint, out, threads, s);
    case 16: return launch_ppt<16, WIN>(xyz, B, N, npoint, out, threads, s);
    default: return launch_ppt<32, WIN>(xyz, B, N, npoint, out, threads, s);
  }
}

}  // namespace

// threads (T, a power of two in [32, 1024]) and ppt (points a thread holds, a
// power of two up to 32, T * ppt >= N) as ops/sampling.py::fps_block gives
// them; winner 0 reads the winner's coordinates from the warps' slots, 1 from
// a copy of the cloud in shared memory (12 N bytes).
extern "C" int fps_k3(const float* xyz, int B, int N, int npoint, int threads, int ppt,
                      int winner, int* out, void* stream) {
  if (B < 1 || N < 1 || npoint < 1 || N > kMaxN) return kErrArgs;
  if (threads < 32 || threads > 1024 || (threads & (threads - 1)) || ppt < 1 || ppt > kMaxPPT ||
      (ppt & (ppt - 1)) || static_cast<long long>(threads) * ppt < N)
    return kErrBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (winner == kShared) {
    if (12 * N > kMaxShared) return kErrShared;
    return launch_win<kShared>(xyz, B, N, npoint, out, threads, ppt, s);
  }
  if (winner != kSlot) return kErrArgs;
  return launch_win<kSlot>(xyz, B, N, npoint, out, threads, ppt, s);
}

// A cloud of kMaxN < N <= kMaxClusterN points over a cluster of kClusterBlocks
// blocks of 1024 threads; ppt (8, 16 or 32) the points a thread holds,
// kClusterBlocks x 1024 x ppt >= N (ops/sampling.py::fps_cluster_ppt).
extern "C" int fps_k3_cluster(const float* xyz, int B, int N, int npoint, int ppt, int* out,
                              void* stream) {
  if (B < 1 || N < 1 || npoint < 1 || N > kMaxClusterN ||
      static_cast<long long>(B) * kClusterBlocks > 0x7fffffffLL)
    return kErrArgs;
  if ((ppt != 8 && ppt != 16 && ppt != 32) ||
      static_cast<long long>(kClusterBlocks) * kClusterThreads * ppt < N)
    return kErrBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B) * kClusterBlocks);
  if (ppt == 8) fps_cluster_kernel<8><<<grid, kClusterThreads, 0, s>>>(xyz, N, npoint, out);
  else if (ppt == 16) fps_cluster_kernel<16><<<grid, kClusterThreads, 0, s>>>(xyz, N, npoint, out);
  else fps_cluster_kernel<32><<<grid, kClusterThreads, 0, s>>>(xyz, N, npoint, out);
  return static_cast<int>(cudaGetLastError());
}
