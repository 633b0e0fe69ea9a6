// Pieces shared by the Sinkhorn forward (sinkhorn_fwd.cu) and backward
// (sinkhorn_bwd.cu) kernels.
//
// Both files have two paths, picked by B:
// * register (B <= 64): a problem lives in registers, a group of P lanes
//   holding row r and column r of C; the groups meet through shared
//   memory once a half-step.
// * band (any larger B): a thread-block cluster of up to 16 blocks a
//   problem (non-portable size where the card schedules it); block r owns
//   row band r and column band r of C, in its shared memory where they
//   fit, else read through L2.  The forward's blocks write each new u and
//   v entry into every block's copy over distributed shared memory (up to
//   B = kStageMax; past it through the history in device memory); the
//   backward's pass b_bar and a_bar through a scratch matrix in device
//   memory.  Each phase ends in one barrier.cluster arrive/wait (release /
//   acquire at cluster scope), which orders those writes before the other
//   blocks' reads; reads of device memory another block wrote load at L2
//   (ld.global.cg), never from an SM's own L1.  Every sum is taken in a
//   fixed order: no float atomics.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace kccot {
namespace sinkhorn {

namespace cg = cooperative_groups;

constexpr int kRegMaxB = 32;        // the register path's B (2 * kRegMaxB at 16 lanes a row)
constexpr int kMaxSmem = 232448;    // the opt-in limit of one block on sm_90
constexpr int kBandThreads = 1024;  // a band block
constexpr int kBandRows = 16;       // rows a band block aims at
constexpr int kMaxCluster = 16;     // band blocks a problem, at most
constexpr int kStageMax = 8192;     // band: u and v staged in shared memory up to this B

// x / y, correctly rounded, from inv = 1 / y (itself a correctly rounded
// division): the product and one FMA correction (Markstein's theorem).
// It equals the IEEE quotient away from overflow and subnormal quotients,
// and unlike the division it is three instructions with no branch to a
// slow path, so the unrolled loops keep their loads and MUFU work in
// flight.
__device__ __forceinline__ float div_by(float x, float y, float inv) {
  const float q = x * inv;
  return fmaf(fmaf(-y, q, x), inv, q);
}

// Reductions over a group of P consecutive lanes (P a power of 2, at
// most 32), the same value in every lane of the group.
template <int P>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < P; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int P>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < P; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A band block's column work: thread (jl, s) takes column j0 + jl of a
// chunk of W columns and rows i = s, s + S, ..., so that a warp's loads
// of one row are contiguous.
struct ColSplit {
  int W, S, jl, s;
  __device__ explicit ColSplit(int ncols) {
    W = min(max(ncols, 1), (int)blockDim.x);
    S = blockDim.x / W;
    jl = threadIdx.x % W;
    s = threadIdx.x / W;
  }
  __device__ bool has(int j, int hi) const { return s < S && j < hi; }
};

__device__ __forceinline__ float warp_max(float v) { return group_max<32>(v); }
__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

struct MaxOp {
  static constexpr float kIdentity = -INFINITY;
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  static constexpr float kIdentity = 0.0f;
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Folds the S partials of each column, a warp a column: lane l takes
// slices l, l + 32, ... in order, then the warp's butterfly; a fixed order.
// Called by every thread of the block (two barriers).  red [blockDim.x],
// out [W].
template <class Op>
__device__ __forceinline__ float combine(float* red, float* out, float part, const ColSplit& cs,
                                         Op op) {
  red[threadIdx.x] = part;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int col = threadIdx.x >> 5; col < cs.W; col += blockDim.x >> 5) {
    float r = Op::kIdentity;
    for (int q = lane; q < cs.S; q += 32) r = op(r, red[q * cs.W + col]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r = op(r, __shfl_xor_sync(0xffffffffu, r, o));
    if (lane == 0) out[col] = r;
  }
  __syncthreads();
  return out[cs.jl];
}

// A band launch: blocks a problem (the cluster size), rows a block, and
// whether u and v are staged in shared memory.
struct Band {
  int nblk, nb;
  bool staged;
};

// The largest cluster, up to ceil(B / kBandRows) and kMaxCluster blocks,
// that the card can schedule; a block takes smem_base + smem_row * nb
// bytes of shared memory (*smem on return).
template <class Kernel>
cudaError_t pick_band(Kernel kernel, int B, size_t smem_base, size_t smem_row, Band* band,
                      size_t* smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  for (int n = min(kMaxCluster, (B + kBandRows - 1) / kBandRows); n >= 1; --n) {
    const int nb = (B + n - 1) / n;
    const size_t bytes = smem_base + smem_row * nb;
    if (bytes > (size_t)kMaxSmem) break;  // fewer blocks only need more
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n);
    cfg.blockDim = dim3(kBandThreads);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) == cudaSuccess && clusters > 0) {
      *band = Band{n, nb, B <= kStageMax};
      *smem = bytes;
      return cudaSuccess;
    }
    (void)cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;
}

// Launches `kernel` over K problems of `band.nblk` blocks each, one
// cluster a problem.
template <class Kernel, class... Args>
cudaError_t launch_band(Kernel kernel, int K, const Band& band, size_t smem, cudaStream_t stream,
                        Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * band.nblk);
  cfg.blockDim = dim3(kBandThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = band.nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace sinkhorn
}  // namespace kccot
