// Log-domain Sinkhorn forward, K independent problems, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/ot/pallas_sinkhorn.py::_kernel, the TPU kernel that
// keeps the [K, B, B] cost stack and both dual vectors in VMEM for all L
// iterations.  Here one block solves one problem (K = 3 at the training
// step: xy, xx, yy), with its cost matrix staged once in shared memory as
// [B][B + 1] floats (the padding column puts a column's elements in
// different banks) and u, v beside it.  The TPU kernel's +1e9 padding and
// masks exist only for its (8, 128) tile: loops here are bounded by B.
//
// What it computes, uniform marginals mu = nu = 1/B, L fixed iterations in
// the reference order (u first; v then uses the new u):
//   a_ij = ((-c_ij + u_i) + v_j) / eps;   u_i <- eps * (log_mu - lse_j a_ij) + u_i
//   b_ij = ((-c_ij + u_i) + v_j) / eps;   v_j <- eps * (log_mu - lse_i b_ij) + v_j
// recording the post-update (u, v) of every iteration in uhist / vhist
// [L, K, B] for the backward (sinkhorn_bwd.cu), then
//   cost_k = sum_ij exp(((-c_ij + u_i) + v_j) / eps) * c_ij.
// lse is max-shifted, log(sum exp(x - max)) + max, as jax.nn.logsumexp.
//
// What bounds it: neither bytes nor arithmetic.  At [3, 32, 32] with L = 100
// it reads 12 KB, writes 77 KB of history and does about 5 MFLOP; the
// limit is the latency of 2 * L dependent block-wide phases (each a warp
// max, an exp pass and a warp sum per row or column, then a barrier).
// What the design does about that: nothing leaves the SM inside the loop
// but the history stores, every reduction is a warp shuffle (a warp owns
// a whole row or column), and one barrier separates the phases.  Spreading
// a problem over a cluster, or several problems per block, is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // the opt-in limit of one block on sm_90

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// eps * (log_mu - lse) + x, rounded after each operation (no FMA), as the
// reference computes it.
__device__ __forceinline__ float dual_update(float eps, float log_mu, float lse, float x) {
  return __fadd_rn(__fmul_rn(eps, log_mu - lse), x);
}

size_t smem_bytes(int B) { return ((size_t)B * (B + 1) + 2 * (size_t)B + kMaxWarps) * sizeof(float); }

__global__ void __launch_bounds__(1024)
sinkhorn_fwd_kernel(const float* __restrict__ c, float* __restrict__ cost,
                    float* __restrict__ uhist, float* __restrict__ vhist,
                    int K, int B, int L, float eps) {
  extern __shared__ float smem[];
  const int ld = B + 1;
  float* cs = smem;          // [B][B + 1]
  float* u = cs + B * ld;    // [B]
  float* v = u + B;          // [B]
  float* red = v + B;        // [kMaxWarps]
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  const float* ck = c + (long long)k * B * B;
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) cs[(idx / B) * ld + idx % B] = ck[idx];
  for (int i = threadIdx.x; i < B; i += blockDim.x) u[i] = v[i] = 0.0f;
  __syncthreads();
  const float log_mu = -logf((float)B);

  for (int it = 0; it < L; ++it) {
    float* uh = uhist + ((long long)it * K + k) * B;
    float* vh = vhist + ((long long)it * K + k) * B;
    // u-update: a warp per row, lse over the row's B columns.
    for (int i = warp; i < B; i += nwarps) {
      const float ui = u[i];
      const float* row = cs + i * ld;
      float m = -INFINITY;
      for (int j = lane; j < B; j += 32) m = fmaxf(m, ((-row[j] + ui) + v[j]) / eps);
      m = warp_max(m);
      float s = 0.0f;
      for (int j = lane; j < B; j += 32) s += expf(((-row[j] + ui) + v[j]) / eps - m);
      s = warp_sum(s);
      if (lane == 0) {
        const float un = dual_update(eps, log_mu, logf(s) + (isfinite(m) ? m : 0.0f), ui);
        u[i] = un;
        uh[i] = un;
      }
    }
    __syncthreads();
    // v-update with the new u: a warp per column, lse over the B rows.
    for (int j = warp; j < B; j += nwarps) {
      const float vj = v[j];
      float m = -INFINITY;
      for (int i = lane; i < B; i += 32) m = fmaxf(m, ((-cs[i * ld + j] + u[i]) + vj) / eps);
      m = warp_max(m);
      float s = 0.0f;
      for (int i = lane; i < B; i += 32) s += expf(((-cs[i * ld + j] + u[i]) + vj) / eps - m);
      s = warp_sum(s);
      if (lane == 0) {
        const float vn = dual_update(eps, log_mu, logf(s) + (isfinite(m) ? m : 0.0f), vj);
        v[j] = vn;
        vh[j] = vn;
      }
    }
    __syncthreads();
  }

  // cost_k = sum exp(((-c + u) + v) / eps) * c, a block reduction.
  float acc = 0.0f;
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int i = idx / B, j = idx % B;
    const float cij = cs[i * ld + j];
    acc += expf(((-cij + u[i]) + v[j]) / eps) * cij;
  }
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? red[lane] : 0.0f;
    t = warp_sum(t);
    if (lane == 0) cost[k] = t;
  }
}

}  // namespace

// The largest B this kernel takes: its [B][B + 1] tile and vectors must fit
// one block's opt-in shared memory.
extern "C" int kccot_sinkhorn_fwd_max_batch() {
  int b = 1;
  while (smem_bytes(b + 1) <= (size_t)kMaxSmem) ++b;
  return b;
}

// c [K, B, B] float32; outputs cost [K], uhist and vhist [L, K, B] float32,
// all contiguous.  Returns the launch's cudaError_t (0 on success).
extern "C" int kccot_sinkhorn_fwd(const void* c, void* cost, void* uhist, void* vhist, int K,
                                  int B, int L, float eps, void* stream) {
  if (K <= 0 || B <= 0 || L <= 0 || !(eps > 0.0f)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        sinkhorn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nwarps = B < kMaxWarps ? B : kMaxWarps;
  sinkhorn_fwd_kernel<<<K, 32 * nwarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<float*>(cost), static_cast<float*>(uhist),
      static_cast<float*>(vhist), K, B, L, eps);
  return cudaGetLastError();
}
