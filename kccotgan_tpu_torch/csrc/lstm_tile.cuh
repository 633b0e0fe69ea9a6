// Pieces shared by the dense LSTM forward (lstm_fwd.cu) and backward
// (lstm_bwd.cu) kernels.
//
// Both kernels run all T steps of a call in one launch; a block owns a
// group of batch rows for all T steps.  The bf16 engine runs each step's
// products on the tensor cores (mma.sync.m16n8k16, bf16 x bf16 -> f32);
// the f32 engine runs them as FMAs on the CUDA cores.
//
// Tensor-core layout (bf16).  A block owns 8 batch rows, the valid half
// of one m16 tile (rows 8-15 of every staged operand stay zero; rows past
// B are padding too, computed and never stored).  U is padded to Kp =
// 16*KT (KT = 1, 2, 4 or 8: U <= 16, 32, 64, 128).  The block has 4*KT warps;
// warp w owns units 4w .. 4w+3, and a thread exactly one (row, unit):
// row lane/4, unit 4w + lane%4.  What a step costs is the instructions
// and shared-memory traffic its SM issues, so a block takes few rows and
// a thread one element; warps whose units are all padding skip the gate
// math.
//
// * R = cdt(R) [U][4U] is staged once, as bf16, in Rs [Kp][4*Kp + 8]:
//   row k, column gcol(g, j) holds R[k][g*U + j]; every other entry is
//   zero.  gcol is the ConvLSTM's gate interleave (convlstm_tile.cuh):
//   16*(j/4) + 8*(g/2) + 2*(j%4) + g%2, so the m16n8 accumulators of the
//   warp's two n-tiles hold gates (i, f) and (c, o) of unit 4w + lane%4
//   in row lane/4: the gate math needs no exchange.
// * h_{t-1} (bf16, rounded as the step's input) sits in shared memory as
//   [16][Kp + 8]; it is the gate product's A (ldmatrix) and, in the
//   backward, the dR product's A^T (ldmatrix.trans).
// * The gate product reads B = Rs by ldmatrix.trans (Rs is [k][n], n
//   contiguous); the backward's dh^T = cdt(R) cdt(dz)^T reads A = Rs by
//   plain ldmatrix (the same array as [m = h unit][k = gate column]): no
//   second copy of R.
#pragma once

#include "convlstm_tile.cuh"

namespace kccot {
namespace lstm {

constexpr int kMaxU = 64;        // units the staged kernels take (R in shared memory)
constexpr int kMaxUTc = 128;     // units the bf16 tensor-core kernels take (KT = 8 past kMaxU)
constexpr int kL2Threads = 256;  // threads of a block of the L2 kernels (U > kMaxU)
constexpr int kL2MaxRows = 4;    // batch rows a block of the L2 kernels owns, at most
constexpr int kTcRows = 8;       // batch rows a tensor-core block owns (of its m16 tile)
constexpr int kMaxCluster = 8;   // blocks a backward call sums in one cluster
constexpr int kFmaThreads = 256; // threads of a CUDA-core block, about

__device__ __forceinline__ float activation(float z, int act) {
  return act == 0 ? tanhf(z) : sigmoid(z);
}

// Derivative of the activation from its value a (the TPU kernel's _dact).
__device__ __forceinline__ float dactivation(float a, int act) {
  return act == 0 ? 1.0f - a * a : a * (1.0f - a);
}

// The instance axis (the counterpart of pallas_call's batching rule under
// jax.vmap): a call runs N independent problems, each with its own x, h0,
// c0, R, b and outputs, stored one instance after another, and a block
// takes instance blockIdx.y (blockIdx.z in lstm_wgrad_l2_kernel).  It
// shifts its pointers to that instance's arrays and then computes what a
// one-instance call computes: the same blocks, the same sums in the same
// order, the same bits.
template <typename P>
__device__ __forceinline__ P* at_instance(P* p, long long per_instance, int n) {
  return p == nullptr ? p : p + per_instance * n;
}

// Instances a call takes (grid dimension y).
constexpr int kMaxInstances = 65535;

__host__ __device__ __forceinline__ int gcol(int g, int j) {
  return 16 * (j / 4) + 8 * (g / 2) + 2 * (j % 4) + g % 2;
}

// Batch rows of a CUDA-core (f32) block: one thread a (row, unit), at
// most kFmaThreads threads (U <= kMaxU).
__host__ __device__ __forceinline__ int fma_rows(int U) { return kFmaThreads / U; }

__device__ __forceinline__ float load_r(const float* R, int idx) { return __ldg(R + idx); }

// Shared memory of the L2 kernels (U > kMaxU): the forward keeps two h
// buffers and c of its rows, [3][rows][U]; the backward h, dh and dc of
// its rows, cdt(dz) [rows][4U] and the block's db [4U].
inline size_t l2_smem(bool backward, int rows, int U) {
  return (backward ? (size_t)(7 * rows + 4) * U : (size_t)3 * rows * U) * sizeof(float);
}

// Rows a block of the L2 kernels owns: the most, up to kL2MaxRows, whose
// shared memory fits one block (0: none does).
inline int l2_rows(bool backward, int U) {
  for (int rows = kL2MaxRows; rows >= 1; rows /= 2)
    if (l2_smem(backward, rows, U) <= (size_t)232448) return rows;
  return 0;
}

template <int KT>
struct Tc {
  static constexpr int Kp = 16 * KT;
  static constexpr int kWarps = 4 * KT, kThreads = 32 * kWarps;
  static constexpr int LDR = 4 * Kp + 8;  // Rs and dz rows
  static constexpr int LDH = Kp + 8;      // h rows
  // The +8 columns put the 8 rows an ldmatrix reads on distinct banks.
};

__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  int4* q = static_cast<int4*>(p);
  for (int i = threadIdx.x + threadIdx.y * blockDim.x; i < bytes / 16; i += blockDim.x * blockDim.y)
    q[i] = make_int4(0, 0, 0, 0);
}

// Rs[k][gcol(g, j)] = bf16(R[k][g*U + j]); Rs is zero beforehand.
// Warp w stages rows k = w, w + 4KT, ... (at most 4: U <= 16KT), its
// lanes along j, two columns a lane at a time (64 units a pass), every
// load of a pass issued before its first store so that one memory
// latency covers them.
template <int KT>
__device__ __forceinline__ void stage_r_tc(bf16* Rs, const float* R, int U) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j0 = 0; j0 < 16 * KT; j0 += 64) {
    float v[4][4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int k = warp + i * Tc<KT>::kWarps, j = j0 + lane + 32 * jj;
          v[i][g][jj] = k < U && j < U ? load_r(R, (k * 4 + g) * U + j) : 0.0f;
        }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int k = warp + i * Tc<KT>::kWarps, j = j0 + lane + 32 * jj;
          if (k < U && j < U) Rs[k * Tc<KT>::LDR + gcol(g, j)] = __float2bfloat16(v[i][g][jj]);
        }
  }
}

// The f32 kernels' R4[k][j] = (R[k][j], R[k][U+j], R[k][2U+j], R[k][3U+j]),
// rows of U+1 float4: thread (rl, j) of a block of `rows` rows stages
// rows k = rl, rl + rows, ..., four rows' loads in flight at a time.
__device__ __forceinline__ void stage_r_fma(float4* R4, const float* R, int U, int rows) {
  const int j = threadIdx.x, rl = threadIdx.y;
  for (int k0 = rl; k0 < U; k0 += 4 * rows) {
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int k = k0 + i * rows;
        v[i][g] = k < U ? load_r(R, (k * 4 + g) * U + j) : 0.0f;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k0 + i * rows < U) R4[(k0 + i * rows) * (U + 1) + j] = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
  }
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p))
               : "memory");
}

// The warp's B fragments of the gate product, k16 step kt, n-tile ni
// (its 16 columns: gates (i, f), then (c, o), of its 4 units).
template <int KT>
__device__ __forceinline__ void load_gate_b(unsigned (&b)[KT][2][2], const bf16* Rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    unsigned r[4];
    ldsm_x4_t(r, Rs + (kt * 16 + (lane & 15)) * Tc<KT>::LDR + 16 * warp + (lane >> 4) * 8);
    b[kt][0][0] = r[0];
    b[kt][0][1] = r[1];
    b[kt][1][0] = r[2];
    b[kt][1][1] = r[3];
  }
}

// acc[ni] = h [16 x Kp] @ Rs[:, warp's 16 columns]: the step's gate
// sums, the k16 steps in two independent chains (even and odd) added at
// the end.
template <int KT>
__device__ __forceinline__ void gate_mma(float (&acc)[2][4], const bf16* hs,
                                         const unsigned (&b)[KT][2][2]) {
  const int lane = threadIdx.x % 32;
  float odd[2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = odd[ni][r] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    unsigned a[4];
    ldsm_x4(a, hs + (lane & 15) * Tc<KT>::LDH + kt * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) mma_bf16(kt % 2 ? odd[ni] : acc[ni], a, b[kt][ni][0], b[kt][ni][1]);
  }
  if (KT > 1) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[ni][r] += odd[ni][r];
  }
}

// gate_mma with each k16 step's B fragments read from Rs as it goes: at
// KT = 8 (32 warps, 64 registers a thread) they cannot stay in
// registers for all T steps.
template <int KT>
__device__ __forceinline__ void gate_mma_rs(float (&acc)[2][4], const bf16* hs, const bf16* Rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float odd[2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = odd[ni][r] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    unsigned a[4], b[4];
    ldsm_x4(a, hs + (lane & 15) * Tc<KT>::LDH + kt * 16 + (lane >> 4) * 8);
    ldsm_x4_t(b, Rs + (kt * 16 + (lane & 15)) * Tc<KT>::LDR + 16 * warp + (lane >> 4) * 8);
    mma_bf16(kt % 2 ? odd[0] : acc[0], a, b[0], b[1]);
    mma_bf16(kt % 2 ? odd[1] : acc[1], a, b[2], b[3]);
  }
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] += odd[ni][r];
}

// The thread's (row, unit) of a tensor-core block, and gate g of it in
// the gate product's accumulators (row lane/4: slots 0 and 1).
__device__ __forceinline__ int tc_row() { return (threadIdx.x % 32) / 4; }
__device__ __forceinline__ int tc_unit() { return 4 * (threadIdx.x / 32) + threadIdx.x % 4; }
__device__ __forceinline__ float tc_gate(const float (&acc)[2][4], int g) { return acc[g / 2][g % 2]; }

// The block's partial dR and db, f32 in shared memory as U+1 rows of 4U:
// part[k*4U + 4j + g] (dR[k][g*U + j]) and part[4U*U + 4j + g] (db[g*U +
// j]), summed over the blocks of the call in block order and written
// out.  nclust > 1: the grid is one thread-block cluster; each block sums
// every nclust-th row over the cluster's shared memory, rank 0 first.
// part_global != null: more blocks than a cluster holds; each block
// copies its partial there and lstm_wgrad_sum_kernel adds them in a
// second launch.  Else the grid is one block.  The caller has
// synchronised the block after writing part.
__device__ __forceinline__ void finish_wgrad(float* part, int U, int nclust, float* part_global,
                                             float* __restrict__ dR, float* __restrict__ db) {
  const int U4 = 4 * U;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x, nth = blockDim.x * blockDim.y;
  if (part_global != nullptr) {
    float* dst = part_global + (long long)blockIdx.x * (U4 * U + U4);
    for (int e = tid; e < U4 * U + U4; e += nth) dst[e] = part[e];
    return;
  }
  namespace cg = cooperative_groups;
  if (nclust > 1) cg::this_cluster().sync();
  const float* src[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    src[q] = q < nclust ? (nclust > 1 ? cg::this_cluster().map_shared_rank(part, q) : part) : part;
  const int warp = tid / 32, lane = tid % 32, nwarps = (nth + 31) / 32;
  for (int k = blockIdx.x + nclust * warp; k <= U; k += nclust * nwarps) {
    float* out = k < U ? dR + k * U4 : db;
#pragma unroll 4
    for (int m = lane; m < U4; m += 32) {  // m = 4j + g
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < nclust) s += src[q][k * U4 + m];
      out[(m % 4) * U + m / 4] = s;
    }
  }
  if (nclust > 1) cg::this_cluster().sync();  // peers' smem stays until every block has read it
}

}  // namespace lstm
}  // namespace kccot
