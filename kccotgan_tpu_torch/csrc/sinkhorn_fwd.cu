// Log-domain Sinkhorn forward, K independent problems, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/ot/pallas_sinkhorn.py::_kernel, the TPU kernel that
// keeps the [K, B, B] cost stack and both dual vectors in VMEM for all L
// iterations (K = 3 at the training step: xy, xx, yy).  The TPU kernel's
// +1e9 padding and masks exist only for its (8, 128) tile: loops here are
// bounded by B.
//
// What it computes, uniform marginals mu = nu = 1/B, L fixed iterations in
// the reference order (u first; v then uses the new u):
//   a_ij = ((-c_ij + u_i) + v_j) / eps;   u_i <- eps * (log_mu - lse_j a_ij) + u_i
//   b_ij = ((-c_ij + u_i) + v_j) / eps;   v_j <- eps * (log_mu - lse_i b_ij) + v_j
// recording the post-update (u, v) of every iteration in uhist / vhist
// [L, K, B] for the backward (sinkhorn_bwd.cu), then
//   cost_k = sum_ij exp(((-c_ij + u_i) + v_j) / eps) * c_ij.
// lse is max-shifted, log(sum exp(x - max)) + max, as jax.nn.logsumexp;
// only the order of the sums differs from the reference.
//
// What bounds it: neither bytes nor arithmetic.  At [3, 32, 32] with L = 100
// it reads 12 KB, writes 77 KB of history and does about 5 MFLOP; the
// limit is the chain of 2 L dependent half-steps, each an lse per row or
// column.  What the design does about that (paths in sinkhorn_common.cuh):
// * register (B <= 64; the training step's B = 32): the row phase of row
//   r and the column phase of column r belong to one group of P lanes,
//   which holds the row's and the column's costs in registers and reduces
//   over them there, then over its P lanes by shuffles.  The groups meet once
//   a half-step, through B floats of shared memory and one barrier.  P =
//   16 (16 warps a problem up to B = 32, 32 up to 64) was the fastest of
//   1, 4, 8, 16 and 32 lanes a row on the card: the step is a chain of
//   two reductions, exp, log and a barrier, and more lanes a row shorten
//   the in-register part of the chain until the shuffles dominate.
// * band (B > 64): a cluster of blocks a problem; the row phase a warp a
//   row of the block's band, lanes along it; the column phase a thread a
//   (column, slice of rows), so that a warp reads row-contiguous costs,
//   the slices folded in order through shared memory.  The block's row
//   and column bands of C stay in its shared memory where they fit (B up
//   to about 600 at 16 blocks), and each new u or v entry goes straight
//   into every block's copy of the vector over distributed shared memory,
//   so a half-step waits on no device memory.

#include "sinkhorn_common.cuh"

namespace {

using namespace kccot::sinkhorn;

// eps * (log_mu - lse) + x, rounded after each operation (no FMA), as the
// reference computes it.
__device__ __forceinline__ float dual_update(float eps, float log_mu, float lse, float x) {
  return __fadd_rn(__fmul_rn(eps, log_mu - lse), x);
}

// log(sum exp(a - m)) + m from the shifted sum, as jax.nn.logsumexp.
__device__ __forceinline__ float shifted_lse(float s, float m) {
  return logf(s) + (isfinite(m) ? m : 0.0f);
}

// Entry i of a dual vector another block of the cluster may have written
// in this launch (null: the zero vector of the first iteration).
__device__ __forceinline__ float ld_vec(const float* p, int i) { return p ? __ldcg(p + i) : 0.0f; }

// dst[0:B] = src[0:B] (or zeros), by the whole block.
__device__ __forceinline__ void stage(float* dst, const float* src, int B) {
  for (int i = threadIdx.x; i < B; i += blockDim.x) dst[i] = ld_vec(src, i);
}

// NR rows (B <= NR), P lanes a row: thread t takes row (and column)
// r = t / P and the elements x = q + P e (q = t % P, e < NR / P) of both.
template <int P, int NR>
__global__ void __launch_bounds__(NR * P)
sinkhorn_fwd_reg_kernel(const float* __restrict__ c, float* __restrict__ cost,
                        float* __restrict__ uhist, float* __restrict__ vhist, int K, int B, int L,
                        float eps) {
  constexpr int E = NR / P, kWarps = NR * P / 32;
  __shared__ float us[NR], vs[NR], red[kWarps];
  const int k = blockIdx.x, t = threadIdx.x, r = t / P, q = t % P;
  const bool live = r < B;
  const float* ck = c + (long long)k * B * B;
  float cr[E], cc[E];  // c[r][x] and c[x][r]
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = q + P * e;
    cr[e] = live && x < B ? ck[r * B + x] : 0.0f;
    cc[e] = live && x < B ? ck[x * B + r] : 0.0f;
  }
  if (t < NR) us[t] = vs[t] = 0.0f;
  __syncthreads();
  const float log_mu = -logf((float)B), inv_eps = 1.0f / eps;
  float u = 0.0f, v = 0.0f;  // u_r and v_r

  for (int it = 0; it < L; ++it) {
    const long long h = ((long long)it * K + k) * B;
    {  // u-update of row r
      float a[E], m = -INFINITY, s = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int x = q + P * e;
        a[e] = x < B ? div_by((-cr[e] + u) + vs[x], eps, inv_eps) : -INFINITY;
        m = fmaxf(m, a[e]);
      }
      m = group_max<P>(m);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (q + P * e < B) s += expf(a[e] - m);
      s = group_sum<P>(s);
      u = dual_update(eps, log_mu, shifted_lse(s, m), u);
      if (live && q == 0) {
        us[r] = u;
        uhist[h + r] = u;
      }
    }
    __syncthreads();
    {  // v-update of column r, with the new u
      float b[E], m = -INFINITY, s = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int x = q + P * e;
        b[e] = x < B ? div_by((-cc[e] + us[x]) + v, eps, inv_eps) : -INFINITY;
        m = fmaxf(m, b[e]);
      }
      m = group_max<P>(m);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (q + P * e < B) s += expf(b[e] - m);
      s = group_sum<P>(s);
      v = dual_update(eps, log_mu, shifted_lse(s, m), v);
      if (live && q == 0) {
        vs[r] = v;
        vhist[h + r] = v;
      }
    }
    __syncthreads();
  }

  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = q + P * e;
    if (live && x < B) acc += expf(div_by((-cr[e] + u) + vs[x], eps, inv_eps)) * cr[e];
  }
  acc = warp_sum(acc);
  if (t % 32 == 0) red[t / 32] = acc;
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w];
    cost[k] = total;
  }
}

// A cluster of nblk blocks a problem; block r owns rows and columns
// [r nb, r nb + nb).  Shared memory: u and v [B] each when staged (B <=
// kStageMax: every block keeps whole copies, and the block that updates
// an entry writes it into every block's copy over distributed shared
// memory); red and out [kBandThreads] each; then, when resident, the
// block's row band [nb][B] and column band [B][nb] of C, loaded once.
// Otherwise u and v pass through the history in device memory and C is
// read through L2.
__global__ void __launch_bounds__(kBandThreads)
sinkhorn_fwd_band_kernel(const float* __restrict__ c, float* __restrict__ cost, float* uhist,
                         float* vhist, int K, int B, int L, float eps, int nb, int staged,
                         int resident) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int k = blockIdx.x / nblk, lo = min(B, rank * nb), hi = min(B, lo + nb);
  float* us = smem;                     // u of the last u-update, when staged
  float* vs = us + (staged ? B : 0);    // v of the last v-update, when staged
  float* red = vs + (staged ? B : 0);
  float* out = red + kBandThreads;
  float* crow = out + kBandThreads;               // [nb][B], when resident
  float* ccol = crow + (resident ? nb * B : 0);   // [B][nb], when resident
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float* ck = c + (long long)k * B * B;
  const float log_mu = -logf((float)B), inv_eps = 1.0f / eps;
  const ColSplit cs(hi - lo);
  if (resident) {
    for (int e = threadIdx.x; e < (hi - lo) * B; e += blockDim.x) crow[e] = ck[(long long)lo * B + e];
    for (int e = threadIdx.x; e < B * (hi - lo); e += blockDim.x)
      ccol[(e / (hi - lo)) * nb + e % (hi - lo)] = ck[(long long)(e / (hi - lo)) * B + lo + e % (hi - lo)];
  }
  if (staged) stage(us, nullptr, B);
  if (staged) stage(vs, nullptr, B);
  cluster.sync();  // no peer writes into this block's u and v before they are zero
  auto row_of = [&](int i) { return resident ? crow + (i - lo) * B : ck + (long long)i * B; };
  auto col_at = [&](int i, int j) { return resident ? ccol[i * nb + j - lo] : ck[(long long)i * B + j]; };
  const float* uprev = nullptr;  // unstaged: the dual vectors of the last iteration (null: zeros)
  const float* vprev = nullptr;

  for (int it = 0; it < L; ++it) {
    float* uh = uhist + ((long long)it * K + k) * B;
    float* vh = vhist + ((long long)it * K + k) * B;
    auto V = [&](int j) { return staged ? vs[j] : ld_vec(vprev, j); };
    for (int i = lo + warp; i < hi; i += nwarps) {  // u-update, a warp a row
      const float ui = staged ? us[i] : ld_vec(uprev, i);
      const float* row = row_of(i);
      float m = -INFINITY;
#pragma unroll 4
      for (int j = lane; j < B; j += 32) m = fmaxf(m, div_by((-row[j] + ui) + V(j), eps, inv_eps));
      m = warp_max(m);
      float s = 0.0f;
#pragma unroll 4
      for (int j = lane; j < B; j += 32) s += expf(div_by((-row[j] + ui) + V(j), eps, inv_eps) - m);
      s = warp_sum(s);
      const float un = dual_update(eps, log_mu, shifted_lse(s, m), ui);
      if (lane == 0) uh[i] = un;
      if (staged) {  // peers read only their own rows' u in this phase
        for (int q = lane; q < nblk; q += 32) *cluster.map_shared_rank(us + i, q) = un;
      }
    }
    cluster.sync();  // every block's u written
    auto U = [&](int i) { return staged ? us[i] : __ldcg(uh + i); };
    for (int j0 = lo; j0 < hi; j0 += cs.W) {  // v-update, a thread a (column, slice)
      const int j = j0 + cs.jl;
      const bool has = cs.has(j, hi);
      const float vj = has ? V(j) : 0.0f;
      float m = -INFINITY;
      if (has) {
#pragma unroll 4
        for (int i = cs.s; i < B; i += cs.S) m = fmaxf(m, div_by((-col_at(i, j) + U(i)) + vj, eps, inv_eps));
      }
      m = combine(red, out, m, cs, MaxOp());
      float s = 0.0f;
      if (has) {
#pragma unroll 4
        for (int i = cs.s; i < B; i += cs.S) s += expf(div_by((-col_at(i, j) + U(i)) + vj, eps, inv_eps) - m);
      }
      s = combine(red, out, s, cs, SumOp());
      if (has) {
        const float vn = dual_update(eps, log_mu, shifted_lse(s, m), vj);
        if (cs.s == 0) vh[j] = vn;
        if (staged) {  // peers read only their own columns' v in this phase
          for (int q = cs.s; q < nblk; q += cs.S) *cluster.map_shared_rank(vs + j, q) = vn;
        }
      }
    }
    cluster.sync();  // every block's v written
    uprev = uh;
    vprev = vh;
  }

  // cost_k: each block sums its rows; rank 0 adds the blocks in rank order
  // over distributed shared memory.
  float acc = 0.0f;
  for (int i = lo + warp; i < hi; i += nwarps) {
    const float ui = staged ? us[i] : __ldcg(uprev + i);
    const float* row = row_of(i);
    for (int j = lane; j < B; j += 32) {
      const float cij = row[j];
      acc += expf(div_by((-cij + ui) + (staged ? vs[j] : __ldcg(vprev + j)), eps, inv_eps)) * cij;
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < nwarps; ++w) total += red[w];
    red[0] = total;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.0f;
    for (int q = 0; q < nblk; ++q) total += *cluster.map_shared_rank(red, q);
    cost[k] = total;
  }
  cluster.sync();  // peers' shared memory stays until rank 0 has read it
}

// The register path up to B = 64, else the band path.
cudaError_t launch(const float* c, float* cost, float* uhist, float* vhist, int K, int B, int L,
                   float eps, cudaStream_t stream) {
  if (K <= 0 || B <= 0 || L <= 0 || !(eps > 0.0f)) return cudaErrorInvalidValue;
  if (B <= kRegMaxB) {
    sinkhorn_fwd_reg_kernel<16, 32><<<K, 512, 0, stream>>>(c, cost, uhist, vhist, K, B, L, eps);
    return cudaGetLastError();
  }
  if (B <= 2 * kRegMaxB) {
    sinkhorn_fwd_reg_kernel<16, 64><<<K, 1024, 0, stream>>>(c, cost, uhist, vhist, K, B, L, eps);
    return cudaGetLastError();
  }
  // C's bands resident in shared memory where they fit, else read through L2
  const size_t base = ((B <= kStageMax ? 2 * (size_t)B : 0) + 2 * kBandThreads) * sizeof(float);
  Band band;
  size_t band_smem = 0;
  int resident = 1;
  cudaError_t err = pick_band(sinkhorn_fwd_band_kernel, B, base, 2 * (size_t)B * sizeof(float), &band,
                              &band_smem);
  if (err != cudaSuccess) {
    resident = 0;
    err = pick_band(sinkhorn_fwd_band_kernel, B, base, 0, &band, &band_smem);
  }
  if (err != cudaSuccess) return err;
  return launch_band(sinkhorn_fwd_band_kernel, K, band, band_smem, stream, c, cost, uhist, vhist, K,
                     B, L, eps, band.nb, (int)band.staged, resident);
}

}  // namespace

// c [K, B, B] float32; outputs cost [K], uhist and vhist [L, K, B] float32,
// all contiguous; any B.  Returns the launch's cudaError_t (0 on success).
extern "C" int kccot_sinkhorn_fwd(const void* c, void* cost, void* uhist, void* vhist, int K,
                                  int B, int L, float eps, void* stream) {
  return launch(static_cast<const float*>(c), static_cast<float*>(cost), static_cast<float*>(uhist),
                static_cast<float*>(vhist), K, B, L, eps, static_cast<cudaStream_t>(stream));
}
