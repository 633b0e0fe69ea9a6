// Log-domain Sinkhorn backward, K independent problems, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/ot/pallas_sinkhorn.py::_bwd, the custom-VJP backward
// of the fused TPU kernel: a hand-derived adjoint of the L unrolled dual
// updates, run there as a reverse lax.scan over the saved (u, v) history.
// It carries the L * B^2 work of the gradient, so it is a kernel here.
//
// What it computes, per problem k, from c [B, B], the post-update history
// uhist / vhist [L, K, B] of sinkhorn_fwd.cu and the cotangent g_k of
// cost_k:
//   pi = exp(((-c + u_L) + v_L) / eps);  m_bar = (g pi) c
//   c_bar = g pi - m_bar / eps;  u_bar = rowsum(m_bar) / eps;  v_bar = colsum(m_bar) / eps
//   for i = L-1 .. 0, with (u_i, v_i) = history entry i-1 (zeros at i = 0)
//   and u_{i+1} = entry i:
//     b_bar = softmax_rows(((-c + u_{i+1}) + v_i) / eps) * (-eps v_bar)   (per column)
//     c_bar -= b_bar / eps;  u_bar += rowsum(b_bar) / eps;  v_bar += colsum(b_bar) / eps
//     a_bar = softmax_cols(((-c + u_i) + v_i) / eps) * (-eps u_bar)       (per row)
//     c_bar -= a_bar / eps;  u_bar += rowsum(a_bar) / eps;  v_bar += colsum(a_bar) / eps
// the same operations in the same order as _bwd (only the sums' order
// differs); c_bar takes b_bar / eps, then a_bar / eps, of every step in
// the reference's order, so no accumulator is split.
//
// What bounds it: like the forward, the chain of dependent phases (three a
// step: column softmax, row softmax, column sums), not bytes (c, the 77 KB
// history and c_bar at [3, 32, 32], L = 100) nor arithmetic (about 9
// MFLOP).  What the design does about that (paths in sinkhorn_common.cuh):
// * register (B <= 64; the training step's B = 32): a group of P lanes
//   owns row r and column r of C and row r of c_bar, in registers.  A step is
//   the column softmax of column r (b_bar into a shared [N][N + 1] tile),
//   the row softmax of row r (its b_bar row read back from the tile, so
//   the row sums need no exchange across groups; a_bar into a second
//   tile), then the column sums of a_bar from that tile: two barriers a
//   step.  u_{i+1} and v_i are double-buffered in shared memory and the
//   history entries a lane needs arrive in registers two steps ahead, so
//   no step waits on device memory.  P = 16, as the forward.
// * band (B > 64): a cluster of blocks a problem; block r owns row band r
//   (its c_bar rows, in device memory) and column band r (C's bands in
//   its shared memory where they fit, as the forward's).  A step: the
//   column softmaxes of its columns (a thread a (column, slice of rows))
//   write b_bar into the scratch matrix bm; barrier; each row of its band
//   takes its b_bar row, its row softmax, and writes a_bar over bm;
//   barrier; the column sums of a_bar over its columns.  The next step's
//   u_{i+1} and v_i are copied into shared memory by cp.async during the
//   step.

#include "sinkhorn_common.cuh"

namespace {

using namespace kccot::sinkhorn;

// N rows (B <= N), P lanes a row: thread t takes row (and column) r = t /
// P and the elements x = q + P e (q = t % P, e < N / P) of both.  Two
// barriers a step: u_{i+1} and v_i are double-buffered (written a step
// ahead), b_bar and a_bar have a tile each.
template <int P, int N>
__global__ void __launch_bounds__(N * P)
sinkhorn_bwd_reg_kernel(const float* __restrict__ c, const float* __restrict__ uhist,
                        const float* __restrict__ vhist, const float* __restrict__ g,
                        float* __restrict__ c_bar, int K, int B, int L, float eps) {
  constexpr int E = N / P;
  __shared__ float un[2][N], vp[2][N];  // u_{i+1} and v_i of step i, at i & 1
  __shared__ float tb[N][N + 1], ta[N][N + 1];  // b_bar and a_bar of the step
  const int k = blockIdx.x, t = threadIdx.x, r = t / P, q = t % P;
  const bool live = r < B;
  const float* ck = c + (long long)k * B * B;
  const float gk = g[k], inv_eps = 1.0f / eps;
  float cr[E], cc[E], acc[E];  // c[r][x], c[x][r], c_bar[r][x]
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = q + P * e;
    cr[e] = live && x < B ? ck[r * B + x] : 0.0f;
    cc[e] = live && x < B ? ck[x * B + r] : 0.0f;
  }
  auto hist = [&](const float* h, int it) {
    return live && it >= 0 ? h[((long long)it * K + k) * B + r] : 0.0f;
  };
  auto over_eps = [&](float x) { return div_by(x, eps, inv_eps); };

  // Terminal cost: c_bar and u_bar in row layout, v_bar in column layout
  // (m_bar recomputed there from the same operands).  Buffer 1 - (L-1)&1
  // holds (u_L, v_L) for it; buffer (L-1)&1 the first step's entries.
  const float ul = hist(uhist, L - 1), vl = hist(vhist, L - 1);
  // Entries i-1, i-2, i-3 of the history at step i: (u1, v1) are the
  // step's own u_i[r], v_i[r]; the rest arrive a step or two ahead.
  float u1 = hist(uhist, L - 2), v1 = hist(vhist, L - 2), u2 = hist(uhist, L - 3),
        v2 = hist(vhist, L - 3), u3 = hist(uhist, L - 4), v3 = hist(vhist, L - 4);
  const int b0 = (L - 1) & 1;
  if (q == 0) {
    un[1 - b0][r] = ul;  // (u_L, v_L) for the terminal cost
    vp[1 - b0][r] = vl;
    un[b0][r] = ul;      // step L-1: u_{i+1} = u_L, v_i = v_{L-1}
    vp[b0][r] = v1;
  }
  __syncthreads();
  float ub = 0.0f, vb = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int x = q + P * e;
    const float gp = gk * expf(over_eps((-cr[e] + ul) + vp[1 - b0][x]));
    const float mb = gp * cr[e];
    acc[e] = gp - over_eps(mb);
    if (x < B) {
      ub += mb;
      vb += gk * expf(over_eps((-cc[e] + un[1 - b0][x]) + vl)) * cc[e];
    }
  }
  ub = over_eps(group_sum<P>(ub));
  vb = over_eps(group_sum<P>(vb));
  __syncthreads();  // buffer 1 - b0 read; the first step writes it

  for (int it = L - 1; it >= 0; --it) {
    const float* unb = un[it & 1];
    const float* vpb = vp[it & 1];
    if (it > 0 && q == 0) {  // step i-1's vectors, into the buffer step i+1 read before the last barrier
      un[(it - 1) & 1][r] = u1;
      vp[(it - 1) & 1][r] = v2;
    }
    const float upl = u1, vpl = v1;

    // Column r: b_bar[x][r] = softmax over x of ((-c + u_{i+1}) + v_i) / eps,
    // times -eps v_bar[r].
    float a[E], m = -INFINITY, s = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = q + P * e;
      a[e] = x < B ? over_eps((-cc[e] + unb[x]) + vpl) : -INFINITY;
      m = fmaxf(m, a[e]);
    }
    m = group_max<P>(m);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a[e] = q + P * e < B ? expf(a[e] - m) : 0.0f;  // the softmax's numerators
      s += a[e];
    }
    s = group_sum<P>(s);
    float inv_s = 1.0f / s;
    const float sb = -eps * vb;
    float csum_b = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = q + P * e;
      const float bb = x < B ? div_by(a[e], s, inv_s) * sb : 0.0f;
      tb[x][r] = bb;
      csum_b += bb;
    }
    __syncthreads();  // b_bar and step it-1's vectors staged

    // Row r: u_bar[r] += rowsum(b_bar) / eps; a_bar[r][x] = softmax over x of
    // ((-c + u_i) + v_i) / eps, times -eps u_bar[r]; c_bar -= b_bar / eps,
    // then a_bar / eps; u_bar[r] += rowsum(a_bar) / eps.
    float bb[E], rsum = 0.0f;  // row r of b_bar
#pragma unroll
    for (int e = 0; e < E; ++e) {
      bb[e] = q + P * e < B ? tb[r][q + P * e] : 0.0f;
      rsum += bb[e];
    }
    m = -INFINITY;
    s = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = q + P * e;
      a[e] = x < B ? over_eps((-cr[e] + upl) + vpb[x]) : -INFINITY;
      m = fmaxf(m, a[e]);
    }
    const float ubi = ub + over_eps(group_sum<P>(rsum));
    const float rb = -eps * ubi;
    m = group_max<P>(m);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a[e] = q + P * e < B ? expf(a[e] - m) : 0.0f;
      s += a[e];
    }
    s = group_sum<P>(s);
    inv_s = 1.0f / s;
    float ra = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = q + P * e;
      const float ab = x < B ? div_by(a[e], s, inv_s) * rb : 0.0f;
      acc[e] = (acc[e] - over_eps(bb[e])) - over_eps(ab);
      ta[r][x] = ab;
      ra += ab;
    }
    // v_bar[r]: b_bar's column sum, off the step's critical path
    vb = vb + over_eps(group_sum<P>(csum_b));
    ub = ubi + over_eps(group_sum<P>(ra));
    __syncthreads();  // a_bar staged

    // Column r: v_bar[r] += colsum(a_bar) / eps.
    float csum_a = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (q + P * e < B) csum_a += ta[q + P * e][r];
    vb = vb + over_eps(group_sum<P>(csum_a));
    u1 = u2;
    v1 = v2;
    u2 = u3;
    v2 = v3;
    u3 = hist(uhist, it - 4);
    v3 = hist(vhist, it - 4);
  }

  if (live) {
    float* out = c_bar + (long long)k * B * B + (long long)r * B;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (q + P * e < B) out[q + P * e] = acc[e];
  }
}

// One 4-byte copy from device to shared memory, not waited for
// (cp.async; cp.async.wait_all waits for all of the thread's copies).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// A cluster of nblk blocks a problem; block r owns rows and columns
// [r nb, r nb + nb): c_bar's rows (accumulated in place in device memory),
// u_bar of its rows and v_bar of its columns (shared memory).  bm [K, B,
// B] carries b_bar from the column owners to the row owners and a_bar
// back.  Shared memory: u_{i+1} and v_i [2][B] each when staged (B <=
// kStageMax; a step's pair copied in by cp.async during the step before),
// red and out [kBandThreads] each, u_bar and v_bar [nb] each, then, when
// resident, the block's row band [nb][B] and column band [B][nb] of C.
__global__ void __launch_bounds__(kBandThreads)
sinkhorn_bwd_band_kernel(const float* __restrict__ c, const float* __restrict__ uhist,
                         const float* __restrict__ vhist, const float* __restrict__ g,
                         float* c_bar, float* bm, int K, int B, int L, float eps, int nb,
                         int staged, int resident) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int k = blockIdx.x / nblk, lo = min(B, rank * nb), hi = min(B, lo + nb);
  const int nv = staged ? B : 0;
  float* un2 = smem;                   // [2][B] u_{i+1} of step i at i & 1, when staged
  float* vp2 = un2 + 2 * nv;           // [2][B] v_i
  float* red = vp2 + 2 * nv;
  float* out = red + kBandThreads;
  float* ub = out + kBandThreads;      // [nb] u_bar of rows lo..hi
  float* vb = ub + nb;                 // [nb] v_bar of columns lo..hi
  float* crow = vb + nb;                          // [nb][B], when resident
  float* ccol = crow + (resident ? nb * B : 0);   // [B][nb], when resident
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long long kbb = (long long)k * B * B;
  const float* ck = c + kbb;
  float* cbk = c_bar + kbb;
  float* bk = bm + kbb;
  const float gk = g[k], inv_eps = 1.0f / eps;
  const ColSplit cs(hi - lo);
  if (resident) {
    for (int e = threadIdx.x; e < (hi - lo) * B; e += blockDim.x) crow[e] = ck[(long long)lo * B + e];
    for (int e = threadIdx.x; e < B * (hi - lo); e += blockDim.x)
      ccol[(e / (hi - lo)) * nb + e % (hi - lo)] = ck[(long long)(e / (hi - lo)) * B + lo + e % (hi - lo)];
  }
  auto row_of = [&](int i) { return resident ? crow + (i - lo) * B : ck + (long long)i * B; };
  auto col_at = [&](int i, int j) { return resident ? ccol[i * nb + j - lo] : ck[(long long)i * B + j]; };
  auto entry = [&](const float* h, int it) {
    return it >= 0 ? h + ((long long)it * K + k) * B : nullptr;
  };
  // Copies (u, v) = (entry iu of uhist, entry iv of vhist, or zeros) into
  // buffer slot.
  auto fetch = [&](int slot, int iu, int iv) {
    const float* su = entry(uhist, iu);
    const float* sv = entry(vhist, iv);
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      cp_async4(un2 + slot * B + i, su + i);
      if (sv)
        cp_async4(vp2 + slot * B + i, sv + i);
      else
        vp2[slot * B + i] = 0.0f;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // The history is an input: unstaged, plain loads.  un_g / vp_g: u_{i+1}, v_i.
  const float* un_g = entry(uhist, L - 1);
  const float* vp_g = entry(vhist, L - 1);
  const float* unb = un2;
  const float* vpb = vp2;
  auto UN = [&](int i) { return staged ? unb[i] : un_g[i]; };
  auto VP = [&](int j) { return staged ? vpb[j] : (vp_g ? vp_g[j] : 0.0f); };
  const int first = (L - 1) & 1;  // step L-1's slot; the terminal cost takes the other
  if (staged) {
    fetch(1 - first, L - 1, L - 1);
    fetch(first, L - 1, L - 2);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    unb = un2 + (1 - first) * B;
    vpb = vp2 + (1 - first) * B;
  }
  __syncthreads();

  // Terminal cost: c_bar and u_bar by rows, v_bar by columns (m_bar
  // recomputed there from the same operands).
  for (int i = lo + warp; i < hi; i += nwarps) {
    const float ui = UN(i);
    const float* row = row_of(i);
    float rs = 0.0f;
    for (int j = lane; j < B; j += 32) {
      const float cij = row[j];
      const float gp = gk * expf(div_by((-cij + ui) + VP(j), eps, inv_eps));
      const float mb = gp * cij;
      cbk[(long long)i * B + j] = gp - div_by(mb, eps, inv_eps);
      rs += mb;
    }
    rs = warp_sum(rs);
    if (lane == 0) ub[i - lo] = div_by(rs, eps, inv_eps);
  }
  for (int j0 = lo; j0 < hi; j0 += cs.W) {
    const int j = j0 + cs.jl;
    const bool has = cs.has(j, hi);
    float part = 0.0f;
    if (has) {
      const float vj = VP(j);
      for (int i = cs.s; i < B; i += cs.S) {
        const float cij = col_at(i, j);
        part += gk * expf(div_by((-cij + UN(i)) + vj, eps, inv_eps)) * cij;
      }
    }
    part = combine(red, out, part, cs, SumOp());
    if (has && cs.s == 0) vb[j - lo] = div_by(part, eps, inv_eps);
  }

  for (int it = L - 1; it >= 0; --it) {
    un_g = entry(uhist, it);
    vp_g = entry(vhist, it - 1);
    const float* up_g = entry(uhist, it - 1);
    if (staged) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // step it's vectors staged; the last reads of the other slot and vb's updates done
    if (staged) {
      unb = un2 + (it & 1) * B;
      vpb = vp2 + (it & 1) * B;
      if (it > 0) fetch((it - 1) & 1, it - 1, it - 2);  // the next step's, during this one
    }

    // Columns: b_bar[:, j] = softmax over i of ((-c + u_{i+1}) + v_i) / eps,
    // times -eps v_bar[j], into bm; v_bar[j] += colsum(b_bar) / eps.
    for (int j0 = lo; j0 < hi; j0 += cs.W) {
      const int j = j0 + cs.jl;
      const bool has = cs.has(j, hi);
      const float vj = has ? VP(j) : 0.0f;
      float m = -INFINITY;
      if (has) {
#pragma unroll 4
        for (int i = cs.s; i < B; i += cs.S) m = fmaxf(m, div_by((-col_at(i, j) + UN(i)) + vj, eps, inv_eps));
      }
      m = combine(red, out, m, cs, MaxOp());
      float s = 0.0f;
      if (has) {
#pragma unroll 4
        for (int i = cs.s; i < B; i += cs.S) s += expf(div_by((-col_at(i, j) + UN(i)) + vj, eps, inv_eps) - m);
      }
      s = combine(red, out, s, cs, SumOp());
      const float inv_s = 1.0f / s;
      float csum = 0.0f;
      if (has) {
        const float sb = -eps * vb[j - lo];
#pragma unroll 4
        for (int i = cs.s; i < B; i += cs.S) {
          const float bb = div_by(expf(div_by((-col_at(i, j) + UN(i)) + vj, eps, inv_eps) - m), s, inv_s) * sb;
          bk[(long long)i * B + j] = bb;
          csum += bb;
        }
      }
      csum = combine(red, out, csum, cs, SumOp());
      if (has && cs.s == 0) vb[j - lo] = vb[j - lo] + div_by(csum, eps, inv_eps);
    }
    cluster.sync();  // every block's b_bar columns written

    // Rows: u_bar[i] += rowsum(b_bar) / eps; a_bar[i, :] = softmax over j of
    // ((-c + u_i) + v_i) / eps, times -eps u_bar[i]; c_bar -= b_bar / eps,
    // then a_bar / eps; a_bar over bm; u_bar[i] += rowsum(a_bar) / eps.
    for (int i = lo + warp; i < hi; i += nwarps) {
      const long long ro = (long long)i * B;
      const float* row = row_of(i);
      float rs = 0.0f;
#pragma unroll 4
      for (int j = lane; j < B; j += 32) rs += __ldcg(bk + ro + j);
      rs = warp_sum(rs);
      const float ubi = ub[i - lo] + div_by(rs, eps, inv_eps);
      const float rb = -eps * ubi;
      const float ui = up_g ? up_g[i] : 0.0f;
      float m = -INFINITY;
#pragma unroll 4
      for (int j = lane; j < B; j += 32) m = fmaxf(m, div_by((-row[j] + ui) + VP(j), eps, inv_eps));
      m = warp_max(m);
      float s = 0.0f;
#pragma unroll 4
      for (int j = lane; j < B; j += 32) s += expf(div_by((-row[j] + ui) + VP(j), eps, inv_eps) - m);
      s = warp_sum(s);
      const float inv_s = 1.0f / s;
      float ra = 0.0f;
#pragma unroll 4
      for (int j = lane; j < B; j += 32) {
        const float ab = div_by(expf(div_by((-row[j] + ui) + VP(j), eps, inv_eps) - m), s, inv_s) * rb;
        cbk[ro + j] = (cbk[ro + j] - div_by(__ldcg(bk + ro + j), eps, inv_eps)) - div_by(ab, eps, inv_eps);
        bk[ro + j] = ab;
        ra += ab;
      }
      ra = warp_sum(ra);
      if (lane == 0) ub[i - lo] = ubi + div_by(ra, eps, inv_eps);
    }
    cluster.sync();  // every block's a_bar rows written

    // Columns: v_bar[j] += colsum(a_bar) / eps.
    for (int j0 = lo; j0 < hi; j0 += cs.W) {
      const int j = j0 + cs.jl;
      const bool has = cs.has(j, hi);
      float csum = 0.0f;
      if (has) {
#pragma unroll 4
        for (int i = cs.s; i < B; i += cs.S) csum += __ldcg(bk + (long long)i * B + j);
      }
      csum = combine(red, out, csum, cs, SumOp());
      if (has && cs.s == 0) vb[j - lo] = vb[j - lo] + div_by(csum, eps, inv_eps);
    }
  }
}

// Float32 elements of the scratch bm: K * B * B on the band path, else 0.
long long scratch_floats(int K, int B) { return K > 0 && B > 2 * kRegMaxB ? (long long)K * B * B : 0; }

// As the forward's launch(): the register path up to B = 64, else the band
// path, which needs bm.
cudaError_t launch(const void* c, const void* uhist, const void* vhist, const void* g, void* c_bar,
                   void* bm, int K, int B, int L, float eps, cudaStream_t s) {
  if (K <= 0 || B <= 0 || L <= 0 || !(eps > 0.0f)) return cudaErrorInvalidValue;
  const auto* cp = static_cast<const float*>(c);
  const auto* uh = static_cast<const float*>(uhist);
  const auto* vh = static_cast<const float*>(vhist);
  const auto* gp = static_cast<const float*>(g);
  auto* out = static_cast<float*>(c_bar);
  if (B <= kRegMaxB) {
    sinkhorn_bwd_reg_kernel<16, 32><<<K, 512, 0, s>>>(cp, uh, vh, gp, out, K, B, L, eps);
    return cudaGetLastError();
  }
  if (B <= 2 * kRegMaxB) {
    sinkhorn_bwd_reg_kernel<16, 64><<<K, 1024, 0, s>>>(cp, uh, vh, gp, out, K, B, L, eps);
    return cudaGetLastError();
  }
  if (bm == nullptr) return cudaErrorInvalidValue;
  // C's bands resident in shared memory where they fit, else read through L2
  const size_t base = ((B <= kStageMax ? 4 * (size_t)B : 0) + 2 * kBandThreads) * sizeof(float);
  Band band;
  size_t smem = 0;
  int resident = 1;
  cudaError_t err = pick_band(sinkhorn_bwd_band_kernel, B, base, (2 * (size_t)B + 2) * sizeof(float),
                              &band, &smem);
  if (err != cudaSuccess) {
    resident = 0;
    err = pick_band(sinkhorn_bwd_band_kernel, B, base, 2 * sizeof(float), &band, &smem);
  }
  if (err != cudaSuccess) return err;
  return launch_band(sinkhorn_bwd_band_kernel, K, band, smem, s, cp, uh, vh, gp, out,
                     static_cast<float*>(bm), K, B, L, eps, band.nb, (int)band.staged, resident);
}

}  // namespace

// Float32 elements of the scratch bm one backward call needs: K * B * B
// on the band path (B > 64), else 0 (bm null).
extern "C" long long kccot_sinkhorn_bwd_scratch(int K, int B) { return scratch_floats(K, B); }

// c [K, B, B], uhist and vhist [L, K, B] (sinkhorn_fwd.cu's history), g [K];
// output c_bar [K, B, B]; bm as kccot_sinkhorn_bwd_scratch says; all
// float32 and contiguous; any B.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int kccot_sinkhorn_bwd(const void* c, const void* uhist, const void* vhist,
                                  const void* g, void* c_bar, void* bm, int K, int B, int L,
                                  float eps, void* stream) {
  return launch(c, uhist, vhist, g, c_bar, bm, K, B, L, eps, static_cast<cudaStream_t>(stream));
}
