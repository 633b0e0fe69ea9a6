// Log-domain Sinkhorn backward, K independent problems, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/ot/pallas_sinkhorn.py::_bwd, the custom-VJP backward
// of the fused TPU kernel: a hand-derived adjoint of the L unrolled dual
// updates, run there as a reverse lax.scan over the saved (u, v) history.
// It carries the L * B^2 work of the gradient, so it is a kernel here.
//
// What it computes, per problem k (one block), from c [B, B], the
// post-update history uhist / vhist [L, K, B] of sinkhorn_fwd.cu and the
// cotangent g_k of cost_k:
//   pi = exp(((-c + u_L) + v_L) / eps);  m_bar = (g pi) c
//   c_bar = g pi - m_bar / eps;  u_bar = rowsum(m_bar) / eps;  v_bar = colsum(m_bar) / eps
//   for i = L-1 .. 0, with (u_i, v_i) = history entry i-1 (zeros at i = 0)
//   and u_{i+1} = entry i:
//     b_bar = softmax_rows(((-c + u_{i+1}) + v_i) / eps) * (-eps v_bar)   (per column)
//     c_bar -= b_bar / eps;  u_bar += rowsum(b_bar) / eps;  v_bar += colsum(b_bar) / eps
//     a_bar = softmax_cols(((-c + u_i) + v_i) / eps) * (-eps u_bar)       (per row)
//     c_bar -= a_bar / eps;  u_bar += rowsum(a_bar) / eps;  v_bar += colsum(a_bar) / eps
// the same operations in the same order as _bwd (only the sums' order differs).
//
// What bounds it: like the forward, the latency of dependent block-wide
// phases (three a step: column softmax, row softmax, column sums), not
// bytes (c, the 77 KB history and c_bar at [3, 32, 32], L = 100) nor
// arithmetic (about 9 MFLOP).  What the design does about that: c and one
// scratch matrix P (m_bar, then b_bar, then a_bar) sit in shared memory as
// [B][B + 1]; a warp owns whole rows in the row phase and whole columns in
// the column phases, so every reduction is a warp shuffle; c_bar never
// leaves registers until the end, because the thread that owns element
// (i, j) in the row phase is the same at every step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxPerThread = 5;  // rows a warp, columns a lane: B <= 160
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;

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

size_t smem_bytes(int B) { return (2 * (size_t)B * (B + 1) + 5 * (size_t)B) * sizeof(float); }

// N = ceil(B / 32): with 32 warps (B > 32) a warp owns N rows and a lane N
// columns; with B <= 32 there are B warps and N = 1.
template <int N>
__global__ void __launch_bounds__(1024)
sinkhorn_bwd_kernel(const float* __restrict__ c, const float* __restrict__ uhist,
                    const float* __restrict__ vhist, const float* __restrict__ g,
                    float* __restrict__ c_bar, int K, int B, int L, float eps) {
  extern __shared__ float smem[];
  const int ld = B + 1;
  float* cs = smem;          // [B][B + 1] cost
  float* P = cs + B * ld;    // [B][B + 1] m_bar, b_bar or a_bar
  float* u_i = P + B * ld;   // u before the step
  float* v_i = u_i + B;      // v before the step
  float* u_n = v_i + B;      // u after the step's u-update
  float* ub = u_n + B;       // cotangent of u
  float* vb = ub + B;        // cotangent of v
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float gk = g[k];

  const float* ck = c + (long long)k * B * B;
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) cs[(idx / B) * ld + idx % B] = ck[idx];
  for (int idx = threadIdx.x; idx < B; idx += blockDim.x) {
    u_n[idx] = uhist[((long long)(L - 1) * K + k) * B + idx];
    v_i[idx] = vhist[((long long)(L - 1) * K + k) * B + idx];
  }
  __syncthreads();

  // Terminal cost: c_bar, m_bar into P, u_bar from the rows.
  float cb[N][N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
#pragma unroll
    for (int p = 0; p < N; ++p) cb[q][p] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int i = warp + q * nwarps;
    if (i >= B) continue;  // uniform over the warp
    float rs = 0.0f;
#pragma unroll
    for (int p = 0; p < N; ++p) {
      const int j = lane + 32 * p;
      if (j >= B) continue;
      const float cij = cs[i * ld + j];
      const float gp = gk * expf(((-cij + u_n[i]) + v_i[j]) / eps);
      const float mb = gp * cij;
      cb[q][p] = gp - mb / eps;
      P[i * ld + j] = mb;
      rs += mb;
    }
    rs = warp_sum(rs);
    if (lane == 0) ub[i] = rs / eps;
  }
  __syncthreads();
  for (int j = warp; j < B; j += nwarps) {
    float s = 0.0f;
    for (int i = lane; i < B; i += 32) s += P[i * ld + j];
    s = warp_sum(s);
    if (lane == 0) vb[j] = s / eps;
  }

  for (int it = L - 1; it >= 0; --it) {
    // P's column sums above (or phase C of the step before) end before
    // this barrier, and phase A writes P only after it.
    __syncthreads();
    for (int idx = threadIdx.x; idx < B; idx += blockDim.x) {
      u_n[idx] = uhist[((long long)it * K + k) * B + idx];
      u_i[idx] = it > 0 ? uhist[((long long)(it - 1) * K + k) * B + idx] : 0.0f;
      v_i[idx] = it > 0 ? vhist[((long long)(it - 1) * K + k) * B + idx] : 0.0f;
    }
    __syncthreads();

    // Phase A, v-update adjoint: a warp per column, softmax over rows.
    for (int j = warp; j < B; j += nwarps) {
      const float vbj = vb[j];
      const float sb = -eps * vbj;
      const float vj = v_i[j];
      float m = -INFINITY;
      for (int i = lane; i < B; i += 32) m = fmaxf(m, ((-cs[i * ld + j] + u_n[i]) + vj) / eps);
      m = warp_max(m);
      float s = 0.0f;
      for (int i = lane; i < B; i += 32) s += expf(((-cs[i * ld + j] + u_n[i]) + vj) / eps - m);
      s = warp_sum(s);
      float colsum = 0.0f;
      for (int i = lane; i < B; i += 32) {
        const float bb = (expf(((-cs[i * ld + j] + u_n[i]) + vj) / eps - m) / s) * sb;
        P[i * ld + j] = bb;
        colsum += bb;
      }
      colsum = warp_sum(colsum);
      if (lane == 0) vb[j] = vbj + colsum / eps;
    }
    __syncthreads();

    // Phase B, the b_bar rows into c_bar and u_bar, then the u-update
    // adjoint: a warp per row, softmax over columns.
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int i = warp + q * nwarps;
      if (i >= B) continue;
      float rs = 0.0f;
#pragma unroll
      for (int p = 0; p < N; ++p) {
        const int j = lane + 32 * p;
        if (j >= B) continue;
        const float bb = P[i * ld + j];
        cb[q][p] = cb[q][p] - bb / eps;
        rs += bb;
      }
      rs = warp_sum(rs);
      const float ubi = ub[i] + rs / eps;
      const float rb = -eps * ubi;
      const float ui = u_i[i];
      float a[N];
      float m = -INFINITY;
#pragma unroll
      for (int p = 0; p < N; ++p) {
        const int j = lane + 32 * p;
        a[p] = j < B ? ((-cs[i * ld + j] + ui) + v_i[j]) / eps : -INFINITY;
        m = fmaxf(m, a[p]);
      }
      m = warp_max(m);
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < N; ++p) {
        const int j = lane + 32 * p;
        if (j < B) s += expf(a[p] - m);
      }
      s = warp_sum(s);
      float ra = 0.0f;
#pragma unroll
      for (int p = 0; p < N; ++p) {
        const int j = lane + 32 * p;
        if (j >= B) continue;
        const float ab = (expf(a[p] - m) / s) * rb;
        cb[q][p] = cb[q][p] - ab / eps;
        P[i * ld + j] = ab;
        ra += ab;
      }
      ra = warp_sum(ra);
      if (lane == 0) ub[i] = ubi + ra / eps;
    }
    __syncthreads();

    // Phase C, the a_bar columns into v_bar.
    for (int j = warp; j < B; j += nwarps) {
      float s = 0.0f;
      for (int i = lane; i < B; i += 32) s += P[i * ld + j];
      s = warp_sum(s);
      if (lane == 0) vb[j] = vb[j] + s / eps;
    }
  }

  float* out = c_bar + (long long)k * B * B;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int i = warp + q * nwarps;
    if (i >= B) continue;
#pragma unroll
    for (int p = 0; p < N; ++p) {
      const int j = lane + 32 * p;
      if (j < B) out[(long long)i * B + j] = cb[q][p];
    }
  }
}

template <int N>
cudaError_t launch(const void* c, const void* uhist, const void* vhist, const void* g,
                   void* c_bar, int K, int B, int L, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(B);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        sinkhorn_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nwarps = B < kMaxWarps ? B : kMaxWarps;
  sinkhorn_bwd_kernel<N><<<K, 32 * nwarps, smem, stream>>>(
      static_cast<const float*>(c), static_cast<const float*>(uhist),
      static_cast<const float*>(vhist), static_cast<const float*>(g), static_cast<float*>(c_bar),
      K, B, L, eps);
  return cudaGetLastError();
}

}  // namespace

// The largest B this kernel takes: its two [B][B + 1] tiles must fit one
// block's opt-in shared memory, and a thread's c_bar at most N x N registers.
extern "C" int kccot_sinkhorn_bwd_max_batch() {
  int b = 1;
  while (b + 1 <= 32 * kMaxPerThread && smem_bytes(b + 1) <= (size_t)kMaxSmem) ++b;
  return b;
}

// c [K, B, B], uhist and vhist [L, K, B] (sinkhorn_fwd.cu's history), g [K];
// output c_bar [K, B, B]; all float32 and contiguous.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int kccot_sinkhorn_bwd(const void* c, const void* uhist, const void* vhist,
                                  const void* g, void* c_bar, int K, int B, int L, float eps,
                                  void* stream) {
  if (K <= 0 || B <= 0 || L <= 0 || !(eps > 0.0f)) return cudaErrorInvalidValue;
  if (B > kccot_sinkhorn_bwd_max_batch()) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((B + 31) / 32) {
    case 1: return launch<1>(c, uhist, vhist, g, c_bar, K, B, L, eps, s);
    case 2: return launch<2>(c, uhist, vhist, g, c_bar, K, B, L, eps, s);
    case 3: return launch<3>(c, uhist, vhist, g, c_bar, K, B, L, eps, s);
    case 4: return launch<4>(c, uhist, vhist, g, c_bar, K, B, L, eps, s);
    case 5: return launch<5>(c, uhist, vhist, g, c_bar, K, B, L, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
