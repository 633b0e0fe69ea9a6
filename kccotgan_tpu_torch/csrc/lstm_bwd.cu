// Dense LSTM backward, all T steps, dR and db in one launch, for Hopper
// (sm_90a).
//
// Replaces kccotgan_tpu/models/pallas_lstm.py::_bwd_kernel, the TPU
// kernel that walks t = T-1 .. 0, recomputing the gates from the saved
// y and c stacks and accumulating dR and db in VMEM across the grid.
// Here each block owns a group of batch rows for all T steps (rows are
// independent), per step:
//
//   recompute z_t from cdt(h_{t-1}) (y[t-1], or cdt(h0) at t=0), the x
//   stack, b and c_{t-1} (c stack, or c0), as the forward did;
//   dh = dh_carry + dy_t;  dc = dc_carry + dh*o*act'(act(c_t))
//   dz = [dc*g*i(1-i), dc*c_{t-1}*f(1-f), dc*i*act'(g), dh*act(c_t)*o(1-o)]
//   dx_t = cdt(dz);  db += dz (f32)
//   dh_carry = cdt(dz) @ cdt(R)^T, accumulated in f32, not rounded
//   dc_carry = dc * f
//   dR += cdt(h_{t-1})^T cdt(dz), accumulated in f32
// with act' written on the activation's value (1 - a^2 for tanh, a(1-a)
// for sigmoid), as the TPU kernel's _dact.
//
// dR and db without float atomics, the same on every run: each block
// keeps its rows' partial sums (registers, or shared memory), and the
// blocks of a call form one thread-block cluster; each block adds a share
// of the entries over the cluster's shared memory, rank 0's partial
// first (lstm_tile.cuh, finish_wgrad).  A call with
// more blocks than a cluster holds (kMaxCluster; B > 64 in bf16, B >
// 8 * rows in f32) is an explicit second path: each block writes its
// partial to a scratch buffer the wrapper allocates, and
// lstm_wgrad_sum_kernel adds them in block order in a second launch.
// At mmnist_full (B = 32) every call is one launch.
//
// What bounds it on this card: as the forward, the serial chain of T
// steps (latency), not bytes or FLOPs.  What the design does about it:
// * bf16: the three per-step products on the tensor cores (layouts in
//   lstm_tile.cuh), 8 rows a block (half an m16 tile), a thread one
//   (row, unit): the recompute h_{t-1} @ R (B fragments held in registers
//   for all T steps); after the step's first barrier, dh^T = cdt(R)
//   cdt(dz)^T (M = U, N = the 8 rows, K = 4U split in four slices over
//   the warps; A from the same shared bf16 copy of R by plain ldmatrix,
//   held in registers for all T steps), whose partials meet in shared
//   memory at the step's second barrier, and dR += h_{t-1}^T cdt(dz) (M =
//   U, N = 4U, K = the rows; A by ldmatrix.trans of the staged h, B by
//   ldmatrix.trans of the staged dz), which no later step waits for.
//   h_{t-1} is triple-buffered and dz double-buffered in shared memory:
//   a step has two barriers, one after dz and the next h are staged, one
//   after dh's partials.
// * f32: the CUDA cores, a thread a (row, unit), U a template parameter
//   for 8, 32, 64 (dR partials in registers) and a generic instantiation
//   (dR partials in shared memory); R staged once, gates of (k, j) side
//   by side, rows padded to U+1 float4 so that the recompute (R[k][j]
//   over j) and dh (R[j][j'] over j) both read it without bank conflicts.
// * bf16 at 64 < U <= 128: the tensor-core kernel at KT = 8 (32 warps),
//   R's fragments read from shared memory each step, dR left to a second
//   launch (lstm_wgrad_l2_kernel, dR from dx and y in a fixed order, db
//   from the blocks' partials): 64 registers a thread hold neither.
// * Past that (f32 past 64, bf16 past 128): L2 kernels on the CUDA cores
//   that read cdt(R) at every step instead of staging it
//   (lstm_bwd_l2_kernel), then the same second launch.  They are meant
//   to be right for any U, not fast.
// * Both: step t-2's x, c, dy and h are loaded into registers during
//   step t; dx is written row-contiguous; R is read as stored (f32) and
//   rounded while staging, h0 rounded in the kernel: the wrapper launches
//   nothing else.
// * N instances, each with its own R, b, dR and db, run in the launches
//   of a one-instance call: the instance is the grid's y (z in
//   lstm_wgrad_l2_kernel), a cluster never spans two instances, and each
//   instance's dR and db are summed from its own blocks alone in the
//   fixed order above, so an instance equals a one-instance call to the
//   bit (at_instance, lstm_tile.cuh).

#include "lstm_tile.cuh"

namespace {

using namespace kccot;
using namespace kccot::lstm;

// A backward step's operands of one (row, unit): x_s (4 gates), dy_s,
// c_{s-1}, and h_{s-1} (in the compute dtype, held as f32).
struct Operands {
  float x[4], dy, c, h;
};

// dz of one element from its gate pre-activations and carries.
struct Adjoint {
  float dz[4], f;
};

__device__ __forceinline__ Adjoint adjoint(const float (&z)[4], float cp, float dhv, float dcin,
                                           int act) {
  const float i = sigmoid(z[0]), fg = sigmoid(z[1]), gg = activation(z[2], act);
  const float o = sigmoid(z[3]);
  const float tc = activation(fg * cp + i * gg, act);
  const float dcv = dcin + dhv * o * dactivation(tc, act);
  Adjoint a;
  a.dz[0] = dcv * gg * i * (1.0f - i);
  a.dz[1] = dcv * cp * fg * (1.0f - fg);
  a.dz[2] = dcv * i * dactivation(gg, act);
  a.dz[3] = dhv * tc * o * (1.0f - o);
  a.f = dcv * fg;  // the next dc carry
  return a;
}

template <int KT>
__global__ void __launch_bounds__(Tc<KT>::kThreads)
    lstm_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                       const float* __restrict__ cs, const float* __restrict__ h0,
                       const float* __restrict__ c0, const float* __restrict__ R,
                       const float* __restrict__ bias, const bf16* __restrict__ dy,
                       const float* __restrict__ dhn, const float* __restrict__ dcn,
                       bf16* __restrict__ dx, float* __restrict__ dh0, float* __restrict__ dc0,
                       float* __restrict__ dR, float* __restrict__ db, float* part_global, int B,
                       int T_, int U, int act, int nclust) {
  using C = Tc<KT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Rs = reinterpret_cast<bf16*>(smem_raw);  // [Kp][LDR]
  bf16* hb = Rs + C::Kp * C::LDR;                 // [3][16][LDH]: h_s at slot (s + 3) % 3
  bf16* dzs = hb + 3 * 16 * C::LDH;               // [2][16][LDR]: cdt(dz_t) at t & 1
  float* dhp = reinterpret_cast<float*>(dzs + 2 * 16 * C::LDR);  // [4][Kp][8]: dh^T by K slice
  float* part = dhp + 4 * C::Kp * 8;                              // [4U*U + 4U]
  const int r0 = blockIdx.x * kTcRows, U4 = 4 * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr bool kWide = KT > 4;
  {  // instance blockIdx.y's arrays
    const int n = blockIdx.y;
    const long long bt = (long long)B * T_;
    x = at_instance(x, bt * U4, n);
    y = at_instance(y, bt * U, n);
    cs = at_instance(cs, bt * U, n);
    h0 = at_instance(h0, (long long)B * U, n);
    c0 = at_instance(c0, (long long)B * U, n);
    R = at_instance(R, (long long)U * U4, n);
    bias = at_instance(bias, U4, n);
    dy = at_instance(dy, bt * U, n);
    dhn = at_instance(dhn, (long long)B * U, n);
    dcn = at_instance(dcn, (long long)B * U, n);
    dx = at_instance(dx, bt * U4, n);
    dh0 = at_instance(dh0, (long long)B * U, n);
    dc0 = at_instance(dc0, (long long)B * U, n);
    dR = at_instance(dR, (long long)U * U4, n);
    db = at_instance(db, U4, n);
    // the blocks' partials: [blocks][4U] (kWide) or [blocks][4U*U + 4U]
    part_global = at_instance(part_global, (long long)gridDim.x * (kWide ? U4 : U4 * U + U4), n);
  }
  const int rl = tc_row(), j = tc_unit(), row = r0 + rl;
  const bool ok = row < B && j < U, live = 4 * warp < U;  // live: warp-uniform
  // The coalesced dx store: column scol of rows srow, srow + sstep, ...
  const int scol = threadIdx.x % U4, srow = threadIdx.x / U4, sstep = C::kThreads / U4;
  const int sgc = gcol(scol / U, scol % U);

  zero_smem(smem_raw, (C::Kp * C::LDR + 3 * 16 * C::LDH + 2 * 16 * C::LDR) * 2);
  __syncthreads();
  stage_r_tc<KT>(Rs, R, U);

  float bj[4], dbacc[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bj[g] = j < U ? bias[g * U + j] : 0.0f;
    dbacc[g] = 0.0f;
  }
  // The operands of step s (x_s, dy_s, c_{s-1}, and h_{s-1} to stage),
  // loaded two steps before their use: cur for step t, n1 for t-1, n2
  // for t-2.
  const long long rt0 = (long long)row * T_;
  auto fetch = [&](int s) {
    Operands o;
    const long long rt = rt0 + s;
#pragma unroll
    for (int g = 0; g < 4; ++g) o.x[g] = ok ? __bfloat162float(x[rt * U4 + g * U + j]) : 0.0f;
    o.dy = ok && dy != nullptr ? __bfloat162float(dy[rt * U + j]) : 0.0f;
    o.c = !ok ? 0.0f : (s > 0 ? cs[(rt - 1) * U + j] : c0[row * U + j]);
    o.h = !ok ? 0.0f : (s > 0 ? __bfloat162float(y[(rt - 1) * U + j]) : round_to<bf16>(h0[row * U + j]));
    return o;
  };
  Operands cur = fetch(T_ - 1), n1 = cur, n2 = cur;
  if (T_ > 1) n1 = fetch(T_ - 2);
  float dh = ok && dhn != nullptr ? dhn[row * U + j] : 0.0f;
  float dc = ok && dcn != nullptr ? dcn[row * U + j] : 0.0f;
  if (j < U) hb[((T_ + 1) % 3 * 16 + rl) * C::LDH + j] = __float2bfloat16(cur.h);
  __syncthreads();
  // kWide (KT = 8, 64 registers a thread): R's fragments are read from
  // shared memory each step instead of held, and dR is left to a second
  // launch (lstm_wgrad_l2_kernel, from dx and y): its 64 accumulators a
  // thread would not fit either.
  unsigned bfr[kWide ? 1 : KT][2][2];
  if constexpr (!kWide) {
    if (live) load_gate_b<KT>(bfr, Rs);
  }
  // dh^T's A = Rs: warp w takes units 16*(w % KT) .. +15 (an m-tile) and
  // gate columns 16*KT*(w / KT) .. (a quarter of K), for all T steps.
  const int dmt = warp % KT, dks = (warp / KT) * KT;
  auto ra_ptr = [&](int kk) { return Rs + (dmt * 16 + (lane & 15)) * C::LDR + (dks + kk) * 16 + (lane >> 4) * 8; };
  unsigned ra[kWide ? 1 : KT][4];
  float dracc[kWide ? 1 : KT][2][4];
  if constexpr (!kWide) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) ldsm_x4(ra[kk], ra_ptr(kk));
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) dracc[mt][ni][0] = dracc[mt][ni][1] = dracc[mt][ni][2] = dracc[mt][ni][3] = 0.0f;
  }

  for (int t = T_ - 1; t >= 0; --t) {
    const bf16* hcur = hb + (t + 2) % 3 * 16 * C::LDH;  // h_{t-1}
    bf16* hprev = hb + (t + 1) % 3 * 16 * C::LDH;       // h_{t-2}, for step t-1
    bf16* dz = dzs + (t & 1) * 16 * C::LDR;
    if (t > 1) n2 = fetch(t - 2);
    if (live) {
      float acc[2][4];
      if constexpr (kWide)
        gate_mma_rs<KT>(acc, hcur, Rs);
      else
        gate_mma<KT>(acc, hcur, bfr);
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] = (cur.x[g] + bj[g]) + round_to<bf16>(tc_gate(acc, g));
      const Adjoint a = adjoint(z, cur.c, dh + cur.dy, dc, act);
      dc = a.f;
      if (j < U) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float d = ok ? a.dz[g] : 0.0f;  // padding rows add nothing to dR, db
          dbacc[g] += d;
          dz[rl * C::LDR + gcol(g, j)] = __float2bfloat16(d);
        }
        if (t > 0) hprev[rl * C::LDH + j] = __float2bfloat16(n1.h);
      }
    }
    __syncthreads();  // dz_t and h_{t-2} staged; every read of the buffers they replace done

    // dh_{t-1}^T = cdt(R) cdt(dz)^T: M = Kp units, N = the 8 rows, K = 4Kp
    // gate columns in four slices, one warp a (m-tile, slice); the
    // slices' partials meet in shared memory.
    {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        unsigned bv[2];
        ldsm_x2(bv, dz + (lane & 7) * C::LDR + (dks + kk) * 16 + ((lane >> 3) & 1) * 8);
        if constexpr (kWide) {
          unsigned rk[4];
          ldsm_x4(rk, ra_ptr(kk));
          mma_bf16(d, rk, bv[0], bv[1]);
        } else {
          mma_bf16(d, ra[kk], bv[0], bv[1]);
        }
      }
      float* out = dhp + ((warp / KT) * C::Kp + dmt * 16 + lane / 4) * 8 + 2 * (lane % 4);
      out[0] = d[0];
      out[1] = d[1];
      out[64] = d[2];  // unit + 8
      out[65] = d[3];
    }
    if constexpr (!kWide) {
      if (live) {
        // dR += h_{t-1}^T cdt(dz): M = Kp units, K = 16 rows, the warp's 16
        // columns.
        unsigned b[2][2], r[4];
        ldsm_x4_t(r, dz + (lane & 15) * C::LDR + 16 * warp + (lane >> 4) * 8);
        b[0][0] = r[0];
        b[0][1] = r[1];
        b[1][0] = r[2];
        b[1][1] = r[3];
#pragma unroll
        for (int mt = 0; mt < KT; ++mt) {
          unsigned a[4];
          ldsm_x4_t(a, hcur + ((lane & 7) + ((lane >> 4) << 3)) * C::LDH + mt * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) mma_bf16(dracc[mt][ni], a, b[ni][0], b[ni][1]);
        }
      }
    }

    // dx_t = cdt(dz), row-contiguous.  dz is next written in step t-2.
    for (int q = srow; q < kTcRows; q += sstep) {
      if (r0 + q < B) dx[((long long)(r0 + q) * T_ + t) * U4 + scol] = dz[q * C::LDR + sgc];
    }
    __syncthreads();  // dh's partials staged (rewritten after the next step's first barrier)
    const float* dj = dhp + j * 8 + rl;
    dh = ((dj[0] + dj[C::Kp * 8]) + dj[2 * C::Kp * 8]) + dj[3 * C::Kp * 8];
    cur = n1;
    n1 = n2;
  }
  if (ok) {
    dh0[row * U + j] = dh;
    dc0[row * U + j] = dc;
  }
  if constexpr (kWide) {  // the block's db, summed over its 8 rows, gate-major
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float v = dbacc[g];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4 && j < U) part_global[(long long)blockIdx.x * U4 + g * U + j] = v;
    }
  } else {
    // The block's partials: dR from the accumulators (interleaved column
    // -> (j, g)); db summed over the 8 rows of the warp
    // (a fixed butterfly over lane/4), then written by lanes 0-3.
    if (live) {
#pragma unroll
      for (int mt = 0; mt < KT; ++mt)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = mt * 16 + lane / 4 + 8 * (r / 2);
            const int c = 16 * warp + 8 * ni + 2 * (lane % 4) + r % 2;
            const int jj = 4 * (c / 16) + (c % 8) / 2, g = 2 * ((c % 16) / 8) + c % 2;
            if (k < U && jj < U) part[k * U4 + 4 * jj + g] = dracc[mt][ni][r];
          }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float v = dbacc[g];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4 && j < U) part[U4 * U + 4 * j + g] = v;
    }
    __syncthreads();
    finish_wgrad(part, U, nclust, part_global, dR, db);
  }
}

// f32 on the CUDA cores: threadIdx.x = unit j, threadIdx.y = row in the
// block.  kU = U (then rows * U = kFmaThreads and the thread's dR
// partials live in registers), or 0 for any U (partials in shared memory).
template <int kU>
__global__ void __launch_bounds__(kFmaThreads)
    lstm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ cs, const float* __restrict__ h0,
                    const float* __restrict__ c0, const float* __restrict__ R,
                    const float* __restrict__ bias, const float* __restrict__ dy,
                    const float* __restrict__ dhn, const float* __restrict__ dcn,
                    float* __restrict__ dx, float* __restrict__ dh0, float* __restrict__ dc0,
                    float* __restrict__ dR, float* __restrict__ db, float* part_global, int B,
                    int T_, int U_, int act, int nclust) {
  const int U = kU ? kU : U_;
  const int U1 = U + 1, U4 = 4 * U;
  {  // instance blockIdx.y's arrays
    const int n = blockIdx.y;
    const long long bt = (long long)B * T_;
    x = at_instance(x, bt * U4, n);
    y = at_instance(y, bt * U, n);
    cs = at_instance(cs, bt * U, n);
    h0 = at_instance(h0, (long long)B * U, n);
    c0 = at_instance(c0, (long long)B * U, n);
    R = at_instance(R, (long long)U * U4, n);
    bias = at_instance(bias, U4, n);
    dy = at_instance(dy, bt * U, n);
    dhn = at_instance(dhn, (long long)B * U, n);
    dcn = at_instance(dcn, (long long)B * U, n);
    dx = at_instance(dx, bt * U4, n);
    dh0 = at_instance(dh0, (long long)B * U, n);
    dc0 = at_instance(dc0, (long long)B * U, n);
    dR = at_instance(dR, (long long)U * U4, n);
    db = at_instance(db, U4, n);
    part_global = at_instance(part_global, (long long)gridDim.x * (U4 * U + U4), n);
  }
  const int j = threadIdx.x, rl = threadIdx.y;
  const int rows = kU ? kFmaThreads / kU : blockDim.y;  // fma_rows(U)
  const int tid = rl * U + j, nthreads = rows * U;
  extern __shared__ __align__(16) float smem[];
  float4* R4 = reinterpret_cast<float4*>(smem);  // [U][U+1]: gates of R[k, g*U+j]
  float4* dz4 = R4 + U * U1;                     // [2][rows][U]: dz_t's gates at t & 1
  float* hs = reinterpret_cast<float*>(dz4 + 2 * rows * U);  // [3][rows][U]: h_s at (s+3) % 3
  float* part = hs + 3 * rows * U;               // [4U*U + 4U]
  float* dbs = part + U4 * U + U4;               // [rows][4U]
  const int r = blockIdx.x * rows + rl;
  const bool valid = r < B;

  stage_r_fma(R4, R, U, rows);
  if (kU == 0)
    for (int idx = tid; idx < U4 * U; idx += nthreads) part[idx] = 0.0f;
  constexpr int E = kU ? 4 * kU * kU / kFmaThreads : 1;  // dR entries a thread
  float dracc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) dracc[i] = 0.0f;

  float bj[4], dbacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int g = 0; g < 4; ++g) bj[g] = bias[g * U + j];
  float dh = valid && dhn != nullptr ? dhn[r * U + j] : 0.0f;
  float dc = valid && dcn != nullptr ? dcn[r * U + j] : 0.0f;
  // The operands of step s, loaded two steps before their use (cur, n1, n2).
  const long long rt0 = (long long)r * T_;
  auto fetch = [&](int s) {
    Operands o;
    const long long rt = rt0 + s;
#pragma unroll
    for (int g = 0; g < 4; ++g) o.x[g] = valid ? x[rt * U4 + g * U + j] : 0.0f;
    o.dy = valid && dy != nullptr ? dy[rt * U + j] : 0.0f;
    o.c = !valid ? 0.0f : (s > 0 ? cs[(rt - 1) * U + j] : c0[r * U + j]);
    o.h = !valid ? 0.0f : (s > 0 ? y[(rt - 1) * U + j] : h0[r * U + j]);
    return o;
  };
  Operands cur = fetch(T_ - 1), n1 = cur, n2 = cur;
  if (T_ > 1) n1 = fetch(T_ - 2);
  hs[((T_ + 1) % 3 * rows + rl) * U + j] = cur.h;
  __syncthreads();

  for (int t = T_ - 1; t >= 0; --t) {
    const float* hcur = hs + (t + 2) % 3 * rows * U;  // h_{t-1}
    float4* dzt = dz4 + (t & 1) * rows * U;
    if (t > 1) n2 = fetch(t - 2);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* hr = hcur + rl * U;
#pragma unroll 16
    for (int k = 0; k < U; ++k) {
      const float hv = hr[k];
      const float4 w = R4[k * U1 + j];
      a[0] = fmaf(hv, w.x, a[0]);
      a[1] = fmaf(hv, w.y, a[1]);
      a[2] = fmaf(hv, w.z, a[2]);
      a[3] = fmaf(hv, w.w, a[3]);
    }
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g] = (cur.x[g] + bj[g]) + a[g];
    const Adjoint ad = adjoint(z, cur.c, dh + cur.dy, dc, act);
    dc = ad.f;
    float d[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      d[g] = valid ? ad.dz[g] : 0.0f;
      dbacc[g] += d[g];
      if (valid) dx[((long long)r * T_ + t) * U4 + g * U + j] = d[g];
    }
    dzt[rl * U + j] = make_float4(d[0], d[1], d[2], d[3]);
    if (t > 0) hs[((t + 1) % 3 * rows + rl) * U + j] = n1.h;
    __syncthreads();  // dz_t and h_{t-2} staged; every read of the buffers they replace done

    // dh_{t-1}[j] = sum over (j', g) of dz[g*U+j'] R[j][g*U+j'], a chain a gate
    float ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float4* dzr = dzt + rl * U;
    const float4* Rj = R4 + j * U1;
#pragma unroll 8
    for (int jj = 0; jj < U; ++jj) {
      const float4 dv = dzr[jj], w = Rj[jj];
      ds[0] = fmaf(dv.x, w.x, ds[0]);
      ds[1] = fmaf(dv.y, w.y, ds[1]);
      ds[2] = fmaf(dv.z, w.z, ds[2]);
      ds[3] = fmaf(dv.w, w.w, ds[3]);
    }
    dh = (ds[0] + ds[1]) + (ds[2] + ds[3]);
    // dR[k][4j'+g] += sum over the block's rows of h_{t-1}[k] dz[4j'+g]
    const float* dzf = reinterpret_cast<const float*>(dzt);
    if constexpr (kU > 0) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int e = tid + i * kFmaThreads, k = e / U4, m = e % U4;
        float s = dracc[i];
        for (int q = 0; q < rows; ++q) s = fmaf(hcur[q * U + k], dzf[q * U4 + m], s);
        dracc[i] = s;
      }
    } else {
      for (int e = tid; e < U4 * U; e += nthreads) {
        const int k = e / U4, m = e % U4;
        float s = part[e];
        for (int q = 0; q < rows; ++q) s = fmaf(hcur[q * U + k], dzf[q * U4 + m], s);
        part[e] = s;
      }
    }
    cur = n1;
    n1 = n2;
  }
  if (valid) {
    dh0[r * U + j] = dh;
    dc0[r * U + j] = dc;
  }
  if constexpr (kU > 0) {
#pragma unroll
    for (int i = 0; i < E; ++i) part[tid + i * kFmaThreads] = dracc[i];
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) dbs[rl * U4 + 4 * j + g] = dbacc[g];
  __syncthreads();
  for (int m = tid; m < U4; m += nthreads) {
    float s = 0.0f;
    for (int q = 0; q < rows; ++q) s += dbs[q * U4 + m];
    part[U4 * U + m] = s;
  }
  __syncthreads();
  finish_wgrad(part, U, nclust, part_global, dR, db);
}

// part [blocks][4U*U + 4U] (each block's partials, interleaved as in
// finish_wgrad) summed in block order into dR [U][4U] and db [4U]; the
// instance is blockIdx.y.
__global__ void lstm_wgrad_sum_kernel(const float* __restrict__ part, int blocks, int U,
                                      float* __restrict__ dR, float* __restrict__ db) {
  const int n = 4 * U * U + 4 * U;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  part = at_instance(part, (long long)blocks * n, blockIdx.y);  // instance blockIdx.y
  dR = at_instance(dR, 4LL * U * U, blockIdx.y);
  db = at_instance(db, 4 * U, blockIdx.y);
  float s = 0.0f;
  for (int q = 0; q < blocks; ++q) s += part[(long long)q * n + e];
  const int m = e % (4 * U);
  if (e < 4 * U * U)
    dR[(e / (4 * U)) * 4 * U + (m % 4) * U + m / 4] = s;
  else
    db[(m % 4) * U + m / 4] = s;
}

// Any U past kMaxU, either dtype (X), on the CUDA cores, with cdt(R) read
// through L2 at every step as in lstm_fwd_l2_kernel: a block owns `rows`
// batch rows for all T steps, its threads units j (the recompute and the
// adjoint) and then units k (dh_{t-1}[k] = sum over m of cdt(dz)[m]
// cdt(R)[k][m], a thread reading row k of R as float4s).  dx = cdt(dz)
// is all that dR needs (dR = sum over rows and steps of cdt(h_{t-1})^T dx),
// so dR is left to lstm_wgrad_l2_kernel; each block writes its f32 db
// partial [4U] to part[blockIdx.x], which that kernel adds in block order.
template <typename X>
__global__ void __launch_bounds__(kL2Threads)
    lstm_bwd_l2_kernel(const X* __restrict__ x, const X* __restrict__ y,
                       const float* __restrict__ cs, const float* __restrict__ h0,
                       const float* __restrict__ c0, const float* __restrict__ R,
                       const float* __restrict__ bias, const X* __restrict__ dy,
                       const float* __restrict__ dhn, const float* __restrict__ dcn,
                       X* __restrict__ dx, float* __restrict__ dh0, float* __restrict__ dc0,
                       float* __restrict__ part, int B, int T_, int U, int act, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int U4 = 4 * U, r0 = blockIdx.x * rows;
  {  // instance blockIdx.y's arrays
    const int n = blockIdx.y;
    const long long bt = (long long)B * T_;
    x = at_instance(x, bt * U4, n);
    y = at_instance(y, bt * U, n);
    cs = at_instance(cs, bt * U, n);
    h0 = at_instance(h0, (long long)B * U, n);
    c0 = at_instance(c0, (long long)B * U, n);
    R = at_instance(R, (long long)U * U4, n);
    bias = at_instance(bias, U4, n);
    dy = at_instance(dy, bt * U, n);
    dhn = at_instance(dhn, (long long)B * U, n);
    dcn = at_instance(dcn, (long long)B * U, n);
    dx = at_instance(dx, bt * U4, n);
    dh0 = at_instance(dh0, (long long)B * U, n);
    dc0 = at_instance(dc0, (long long)B * U, n);
    part = at_instance(part, (long long)gridDim.x * U4, n);
  }
  float* hs = smem;               // [rows][U]: cdt(h_{t-1})
  float* dhc = hs + rows * U;     // [rows][U]: the dh carry
  float* dcc = dhc + rows * U;    // [rows][U]: the dc carry
  float* dzs = dcc + rows * U;    // [rows][4U]: cdt(dz_t)
  float* dbs = dzs + rows * U4;   // [4U]: the block's db
  for (int e = threadIdx.x; e < rows * U; e += blockDim.x) {
    const int row = r0 + e / U, j = e % U;
    const bool ok = row < B;
    dhc[e] = ok && dhn != nullptr ? dhn[row * U + j] : 0.0f;
    dcc[e] = ok && dcn != nullptr ? dcn[row * U + j] : 0.0f;
  }
  for (int m = threadIdx.x; m < U4; m += blockDim.x) dbs[m] = 0.0f;
  for (int t = T_ - 1; t >= 0; --t) {
    for (int e = threadIdx.x; e < rows * U; e += blockDim.x) {
      const int row = r0 + e / U, k = e % U;
      hs[e] = row >= B ? 0.0f
                       : (t > 0 ? to_f32(y[((long long)row * T_ + t - 1) * U + k])
                                : round_to<X>(h0[row * U + k]));
    }
    __syncthreads();  // h_{t-1} staged; the last step's reads of dzs are done
    for (int j = threadIdx.x; j < U; j += blockDim.x) {
      float acc[kL2MaxRows][4] = {};
#pragma unroll 4
      for (int k = 0; k < U; ++k) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = round_to<X>(__ldg(R + (long long)k * U4 + g * U + j));
#pragma unroll
        for (int rr = 0; rr < kL2MaxRows; ++rr) {
          if (rr >= rows) break;
          const float hv = hs[rr * U + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[rr][g] = fmaf(hv, w[g], acc[rr][g]);
        }
      }
      float dbsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int rr = 0; rr < kL2MaxRows; ++rr) {
        if (rr >= rows) break;
        const int row = r0 + rr;
        if (row >= B) {  // padding rows add nothing to dh, dR, db
#pragma unroll
          for (int g = 0; g < 4; ++g) dzs[rr * U4 + g * U + j] = 0.0f;
          continue;
        }
        const long long o = (long long)row * T_ + t;
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          z[g] = (to_f32(x[o * U4 + g * U + j]) + bias[g * U + j]) + round_to<X>(acc[rr][g]);
        const float cp = t > 0 ? cs[(o - 1) * U + j] : c0[row * U + j];
        const float dhv = dhc[rr * U + j] + (dy != nullptr ? to_f32(dy[o * U + j]) : 0.0f);
        const Adjoint a = adjoint(z, cp, dhv, dcc[rr * U + j], act);
        dcc[rr * U + j] = a.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dx[o * U4 + g * U + j] = from_f32<X>(a.dz[g]);
          dzs[rr * U4 + g * U + j] = round_to<X>(a.dz[g]);
          dbsum[g] += a.dz[g];
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) dbs[g * U + j] += dbsum[g];
    }
    __syncthreads();  // cdt(dz_t) staged
    // dh_{t-1}: the thread of unit j above takes k = j, so the dh carry it
    // read is the one it now writes.
    for (int k = threadIdx.x; k < U; k += blockDim.x) {
      float d[kL2MaxRows] = {};
      const float4* Rk = reinterpret_cast<const float4*>(R + (long long)k * U4);
#pragma unroll 2
      for (int m4 = 0; m4 < U; ++m4) {  // U float4s = 4U columns
        const float4 w4 = __ldg(Rk + m4);
        const float w[4] = {round_to<X>(w4.x), round_to<X>(w4.y), round_to<X>(w4.z), round_to<X>(w4.w)};
#pragma unroll
        for (int rr = 0; rr < kL2MaxRows; ++rr) {
          if (rr >= rows) break;
          const float* dz = dzs + rr * U4 + 4 * m4;
#pragma unroll
          for (int q = 0; q < 4; ++q) d[rr] = fmaf(dz[q], w[q], d[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kL2MaxRows; ++rr)
        if (rr < rows) dhc[rr * U + k] = d[rr];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * U; e += blockDim.x) {
    const int row = r0 + e / U, k = e % U;
    if (row < B) {
      dh0[row * U + k] = dhc[e];
      dc0[row * U + k] = dcc[e];
    }
  }
  for (int m = threadIdx.x; m < U4; m += blockDim.x) part[(long long)blockIdx.x * U4 + m] = dbs[m];
}

// dR[k][m] = sum over rows b, then steps t, of cdt(h_{t-1})[b][k] dx[b][t][m]
// (h_{-1} = h0), a thread an entry, in that fixed order; the row k = U
// sums db[m] over the nparts blocks' partials in block order.  The
// instance is blockIdx.z.
template <typename X>
__global__ void lstm_wgrad_l2_kernel(const X* __restrict__ y, const float* __restrict__ h0,
                                     const X* __restrict__ dx, const float* __restrict__ part,
                                     int nparts, float* __restrict__ dR, float* __restrict__ db,
                                     int B, int T_, int U) {
  const int U4 = 4 * U;
  const int m = blockIdx.x * blockDim.x + threadIdx.x, k = blockIdx.y * blockDim.y + threadIdx.y;
  if (m >= U4 || k > U) return;
  {  // instance blockIdx.z's arrays
    const int n = blockIdx.z;
    y = at_instance(y, (long long)B * T_ * U, n);
    h0 = at_instance(h0, (long long)B * U, n);
    dx = at_instance(dx, (long long)B * T_ * U4, n);
    part = at_instance(part, (long long)nparts * U4, n);
    dR = at_instance(dR, (long long)U * U4, n);
    db = at_instance(db, U4, n);
  }
  float s = 0.0f;
  if (k == U) {
    for (int q = 0; q < nparts; ++q) s += part[(long long)q * U4 + m];
    db[m] = s;
    return;
  }
  for (int b = 0; b < B; ++b) {
    const long long bt = (long long)b * T_;
    for (int t = 0; t < T_; ++t) {
      const float hv = t > 0 ? to_f32(y[(bt + t - 1) * U + k]) : round_to<X>(h0[b * U + k]);
      s = fmaf(hv, to_f32(dx[(bt + t) * U4 + m]), s);
    }
  }
  dR[(long long)k * U4 + m] = s;
}

int bwd_rows(int dtype, int U) {
  if (dtype == 1 && U <= kMaxUTc) return kTcRows;
  if (U > kMaxU) return l2_rows(true, U);
  return fma_rows(U);
}

int bwd_blocks(int dtype, int B, int U) {
  const int rows = bwd_rows(dtype, U);
  return (B + rows - 1) / rows;
}

struct Args {
  const void *x, *y, *cs, *h0, *c0, *R, *bias, *dy, *dhn, *dcn;
  void *dx, *dh0, *dc0, *dR, *db, *part;
  int N, B, T, U, act;
};

// One launch of kernel over `blocks` blocks, as one cluster when they
// sum their partials there (1 < blocks <= kMaxCluster), then the
// second-pass sum when they do not fit.
template <class X, class K>
cudaError_t launch(K kernel, dim3 block, size_t smem, const Args& a, cudaStream_t stream,
                   int dtype) {
  const int blocks = bwd_blocks(dtype, a.B, a.U);
  const bool two_pass = blocks > kMaxCluster;
  if (two_pass != (a.part != nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int nclust = two_pass ? 1 : blocks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, a.N);  // clusters along x: each within one instance
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nclust;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nclust > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const X*>(a.x), static_cast<const X*>(a.y),
      static_cast<const float*>(a.cs), static_cast<const float*>(a.h0),
      static_cast<const float*>(a.c0), static_cast<const float*>(a.R),
      static_cast<const float*>(a.bias),
      static_cast<const X*>(a.dy), static_cast<const float*>(a.dhn),
      static_cast<const float*>(a.dcn), static_cast<X*>(a.dx), static_cast<float*>(a.dh0),
      static_cast<float*>(a.dc0), static_cast<float*>(a.dR), static_cast<float*>(a.db),
      static_cast<float*>(a.part), a.B, a.T, a.U, a.act, nclust);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || !two_pass) return err;
  const int n = 4 * a.U * a.U + 4 * a.U;
  lstm_wgrad_sum_kernel<<<dim3((n + 255) / 256, a.N), 256, 0, stream>>>(
      static_cast<const float*>(a.part), blocks, a.U, static_cast<float*>(a.dR),
      static_cast<float*>(a.db));
  return cudaGetLastError();
}

// dR and db of a call whose `blocks` blocks wrote dx and their db
// partials (part [blocks][4U]): lstm_wgrad_l2_kernel.
template <typename X>
cudaError_t launch_wgrad_l2(const Args& a, int blocks, cudaStream_t stream) {
  const dim3 block(32, 8), grid((4 * a.U + 31) / 32, (a.U + 1 + 7) / 8, a.N);
  lstm_wgrad_l2_kernel<X><<<grid, block, 0, stream>>>(
      static_cast<const X*>(a.y), static_cast<const float*>(a.h0), static_cast<const X*>(a.dx),
      static_cast<const float*>(a.part), blocks, static_cast<float*>(a.dR),
      static_cast<float*>(a.db), a.B, a.T, a.U);
  return cudaGetLastError();
}

// bf16 at 64 < U <= 128: lstm_bwd_tc_kernel<8> (dR left out), then the
// L2 path's dR and db launch.
cudaError_t launch_tc_wide(const Args& a, cudaStream_t stream) {
  using C = Tc<8>;
  if (a.part == nullptr) return cudaErrorInvalidValue;
  const int blocks = (a.B + kTcRows - 1) / kTcRows;
  const size_t smem = (size_t)(C::Kp * C::LDR + 3 * 16 * C::LDH + 2 * 16 * C::LDR) * 2 +
                      (size_t)4 * C::Kp * 8 * 4;
  cudaError_t err = allow_smem((const void*)lstm_bwd_tc_kernel<8>, smem);
  if (err != cudaSuccess) return err;
  lstm_bwd_tc_kernel<8><<<dim3(blocks, a.N), C::kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.y), static_cast<const float*>(a.cs),
      static_cast<const float*>(a.h0), static_cast<const float*>(a.c0),
      static_cast<const float*>(a.R), static_cast<const float*>(a.bias),
      static_cast<const bf16*>(a.dy), static_cast<const float*>(a.dhn),
      static_cast<const float*>(a.dcn), static_cast<bf16*>(a.dx), static_cast<float*>(a.dh0),
      static_cast<float*>(a.dc0), static_cast<float*>(a.dR), static_cast<float*>(a.db),
      static_cast<float*>(a.part), a.B, a.T, a.U, a.act, 1);
  err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_wgrad_l2<bf16>(a, blocks, stream);
}

template <typename X>
cudaError_t launch_l2(const Args& a, cudaStream_t stream) {
  const int rows = l2_rows(true, a.U);
  if (rows == 0 || a.part == nullptr) return cudaErrorInvalidValue;
  const int blocks = (a.B + rows - 1) / rows;
  const size_t smem = l2_smem(true, rows, a.U);
  cudaError_t err = allow_smem((const void*)lstm_bwd_l2_kernel<X>, smem);
  if (err != cudaSuccess) return err;
  lstm_bwd_l2_kernel<X><<<dim3(blocks, a.N), kL2Threads, smem, stream>>>(
      static_cast<const X*>(a.x), static_cast<const X*>(a.y), static_cast<const float*>(a.cs),
      static_cast<const float*>(a.h0), static_cast<const float*>(a.c0),
      static_cast<const float*>(a.R), static_cast<const float*>(a.bias),
      static_cast<const X*>(a.dy), static_cast<const float*>(a.dhn),
      static_cast<const float*>(a.dcn), static_cast<X*>(a.dx), static_cast<float*>(a.dh0),
      static_cast<float*>(a.dc0), static_cast<float*>(a.part), a.B, a.T, a.U, a.act, rows);
  err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_wgrad_l2<X>(a, blocks, stream);
}

template <int KT>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  using C = Tc<KT>;
  const size_t smem = (size_t)(C::Kp * C::LDR + 3 * 16 * C::LDH + 2 * 16 * C::LDR) * 2 +
                      (size_t)(4 * C::Kp * 8 + 4 * a.U * a.U + 4 * a.U) * 4;
  return launch<bf16>(lstm_bwd_tc_kernel<KT>, dim3(C::kThreads), smem, a, stream, 1);
}

template <int kU>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  const int U = a.U, rows = fma_rows(U);
  const size_t smem = ((size_t)4 * U * (U + 1) + (size_t)8 * rows * U + (size_t)3 * rows * U +
                       (size_t)4 * U * U + 4 * U + (size_t)rows * 4 * U) * sizeof(float);
  return launch<float>(lstm_bwd_kernel<kU>, dim3(U, rows), smem, a, stream, 0);
}

}  // namespace

// Float32 elements of the scratch `part` one backward call of N
// instances needs: 0 when an instance's blocks fit one cluster (one
// launch, `part` null), else [N, blocks, 4U*U + 4U] (two launches); past
// kMaxU (bf16 KT = 8 or the L2 kernels, two launches) the blocks' db
// partials, [N, blocks, 4U].
extern "C" long long kccot_lstm_bwd_scratch(int dtype, int N, int B, int U) {
  if (N <= 0 || B <= 0 || U <= 0 || bwd_rows(dtype, U) == 0) return 0;
  const int blocks = bwd_blocks(dtype, B, U);
  if (U > kMaxU) return (long long)N * blocks * 4 * U;
  return blocks > kMaxCluster ? (long long)N * blocks * (4 * U * U + 4 * U) : 0;
}

// The largest U the forward and backward kernels take: the L2 backward's
// shared memory at one row a block.
extern "C" int kccot_lstm_max_units() {
  int u = kMaxU;
  while (l2_rows(true, u + 1) > 0) ++u;
  return u;
}

// dtype 0 = float32, 1 = bfloat16 (of x, y, dy and dx; 1 runs the
// tensor-core kernel, 0 the CUDA-core one); act 0 = tanh, 1 = sigmoid.
// N instances (1 to kMaxInstances), each its own problem with its own dR
// and db, in the launches of a one-instance call: x, dx [N, B, T, 4U];
// y, dy [N, B, T, U]; cs the f32 c stacks [N, B, T, U]; h0, c0, dhn,
// dcn, dh0, dc0 [N, B, U] float32; R [N, U, 4U] the recurrent kernels,
// float32 (the kernel rounds them to the compute dtype); bias [N, 4U];
// dR [N, U, 4U] and db [N, 4U] float32; part as kccot_lstm_bwd_scratch
// says.  dy, dhn, dcn may be null (zero cotangents).  Any U up to
// kccot_lstm_max_units() (U > 64: the L2 kernels, either dtype).  All
// contiguous.  Returns the launches' cudaError_t.
extern "C" int kccot_lstm_bwd(int dtype, int act, const void* x, const void* y,
                              const void* cs, const void* h0, const void* c0, const void* R,
                              const void* bias, const void* dy, const void* dhn, const void* dcn,
                              void* dx, void* dh0, void* dc0, void* dR, void* db, void* part,
                              int N, int B, int T, int U, void* stream) {
  if (N <= 0 || N > kMaxInstances || B <= 0 || T <= 0 || U <= 0 || (act != 0 && act != 1) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Args a{x, y, cs, h0, c0, R, bias, dy, dhn, dcn, dx, dh0, dc0, dR, db, part,
               N, B, T, U, act};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && U <= kMaxUTc) {
    if (U <= 16) return launch_tc<1>(a, s);
    if (U <= 32) return launch_tc<2>(a, s);
    if (U <= 64) return launch_tc<4>(a, s);
    return launch_tc_wide(a, s);
  }
  if (U > kMaxU) return dtype == 1 ? launch_l2<bf16>(a, s) : launch_l2<float>(a, s);
  switch (U) {
    case 8: return launch_fma<8>(a, s);
    case 32: return launch_fma<32>(a, s);
    case 64: return launch_fma<64>(a, s);
    default: return launch_fma<0>(a, s);
  }
}
