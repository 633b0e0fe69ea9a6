// Dense LSTM forward, all T steps in one launch, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/models/pallas_lstm.py::_fwd_kernel, the TPU
// kernel that keeps (h, c) in VMEM over a (batch tile, T) grid.  Rows of
// the batch are independent, so here each block owns a group of rows for
// all T steps, with no step boundary in device memory at all:
//
//   rproj_g = sum_k cdt(h_{t-1})[k] * cdt(R)[k, g*U+j]    f32, rounded once to cdt
//   z_g     = (f32(x_t[g*U+j]) + b[g*U+j]) + rproj_g       g in [i, f, c, o]
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * act(z_c)
//   h_t = sigmoid(z_o) * act(c_t);  y_t = cdt(h_t)
// with act = tanh, or sigmoid for the discriminator's last LSTM (a
// runtime argument: the TPU path falls back to lax.scan there, this one
// does not).  Under autograd it also writes c_t into the f32 c stack.
//
// What bounds it on this card: neither bytes nor FLOPs (0.2 GFLOP and a
// few MB an iteration at mmnist_full) but the serial chain of T dependent
// steps, each a small product, the gate math and a barrier: latency.
// What the design does about it (layouts in lstm_tile.cuh):
// * bf16: the step's [8 x U] x [U x 4U] product on the tensor cores,
//   mma.sync.m16n8k16, 8 batch rows a block (half an m16 tile: a step's
//   time is the instructions its SM issues, so few rows a block and one
//   element a thread), 4*KT warps (U <= 16*KT).  cdt(R) is rounded and
//   staged once a launch, gate columns interleaved, and each warp holds
//   its B fragments in registers for all T steps (up to KT = 4); h_{t-1}
//   passes between steps as bf16 in a ping-pong shared buffer that is the
//   next step's A (ldmatrix), so a step has one barrier.  A thread's accumulators hold
//   i, f, c, o of its own (row, unit): the gate math and the c state stay
//   in registers.
// * f32: the CUDA cores (TF32 would break the f32 contract), a thread a
//   (row, unit), U a template parameter for 8, 32 and 64 (the k loop
//   unrolled) and a generic instantiation for any other U <= 64; cdt(R)
//   staged once with the four gates of (k, j) side by side (one 16-byte
//   load feeds four FMAs); the same ping-pong h buffer and one barrier.
// * Both: x_{t+2} is loaded into registers during step t; y and the c
//   stack are written row-contiguous (bf16: from the shared buffers after
//   the barrier); R is read as stored (f32) and rounded while staging, so
//   the wrapper launches nothing but this kernel.
// * bf16 at 64 < U <= 128: the tensor-core kernel at KT = 8 (32 warps,
//   R staged as 133 KB of bf16), its B fragments read from shared memory
//   each step (64 registers a thread cannot hold them).
// * Past that (f32 past 64, bf16 past 128): an L2 kernel on the CUDA
//   cores that reads cdt(R) at every step instead of staging it
//   (lstm_fwd_l2_kernel).  It is meant to be right for any U, not fast.
// * N instances (the discriminators' four passes under the fused
//   discriminators, each with its own R and b) run in the one launch of
//   any of these paths: the instance is the grid's y, and each block
//   computes its instance's rows as a one-instance call would, to the bit
//   (at_instance, lstm_tile.cuh).

#include "lstm_tile.cuh"

namespace {

using namespace kccot;
using namespace kccot::lstm;

template <int KT>
__global__ void __launch_bounds__(Tc<KT>::kThreads)
    lstm_fwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ h0,
                       const float* __restrict__ c0, const float* __restrict__ R,
                       const float* __restrict__ bias, bf16* __restrict__ y,
                       float* __restrict__ cs, float* __restrict__ hn, float* __restrict__ cn,
                       int B, int T_, int U, int act) {
  using C = Tc<KT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Rs = reinterpret_cast<bf16*>(smem_raw);           // [Kp][LDR]
  bf16* hb = Rs + C::Kp * C::LDR;                          // [2][16][LDH]: h_t at t & 1
  float* cb = reinterpret_cast<float*>(hb + 2 * 16 * C::LDH);  // [2][kTcRows][Kp]
  const int r0 = blockIdx.x * kTcRows, U4 = 4 * U;
  const int rl = tc_row(), j = tc_unit(), row = r0 + rl;
  {  // instance blockIdx.y's arrays
    const int n = blockIdx.y;
    x = at_instance(x, (long long)B * T_ * U4, n);
    h0 = at_instance(h0, (long long)B * U, n);
    c0 = at_instance(c0, (long long)B * U, n);
    R = at_instance(R, (long long)U * U4, n);
    bias = at_instance(bias, U4, n);
    y = at_instance(y, (long long)B * T_ * U, n);
    cs = at_instance(cs, (long long)B * T_ * U, n);
    hn = at_instance(hn, (long long)B * U, n);
    cn = at_instance(cn, (long long)B * U, n);
  }
  const bool ok = row < B && j < U, live = 4 * (threadIdx.x / 32) < U;  // live: warp-uniform
  // The coalesced y / c store: thread (srow, scol), one element a step.
  const int scol = threadIdx.x % U, srow = threadIdx.x / U;
  const bool store = srow < kTcRows && r0 + srow < B;

  zero_smem(smem_raw, (C::Kp * C::LDR + 2 * 16 * C::LDH) * 2);
  __syncthreads();
  stage_r_tc<KT>(Rs, R, U);
  float c = ok ? c0[row * U + j] : 0.0f;
  float h = ok ? h0[row * U + j] : 0.0f;
  if (j < U) hb[rl * C::LDH + j] = __float2bfloat16(h);
  float bj[4];
  // x_t, x_{t+1}, x_{t+2} of the thread's element, gate by gate: loads
  // are issued two steps before their use
  bf16 xr[4], xn[4], xnn[4];
  const bf16 zero = __float2bfloat16(0.0f);
  const bf16* xrow = x + (long long)row * T_ * U4 + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bj[g] = j < U ? bias[g * U + j] : 0.0f;
    xr[g] = ok ? xrow[g * U] : zero;
    xn[g] = ok && T_ > 1 ? xrow[U4 + g * U] : zero;
    xnn[g] = zero;
  }
  __syncthreads();
  constexpr bool kHeld = KT <= 4;  // the gate product's B fragments kept in registers
  unsigned bfr[kHeld ? KT : 1][2][2];
  if constexpr (kHeld) {
    if (live) load_gate_b<KT>(bfr, Rs);
  }

  for (int t = 0; t < T_; ++t) {
    const bf16* hcur = hb + (t & 1) * 16 * C::LDH;
    bf16* hnext = hb + ((t + 1) & 1) * 16 * C::LDH;
    float* cnow = cb + (t & 1) * kTcRows * C::Kp;
    if (ok && t + 2 < T_) {
#pragma unroll
      for (int g = 0; g < 4; ++g) xnn[g] = xrow[(long long)(t + 2) * U4 + g * U];
    }
    if (live) {
      float acc[2][4];
      if constexpr (kHeld)
        gate_mma<KT>(acc, hcur, bfr);
      else
        gate_mma_rs<KT>(acc, hcur, Rs);
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        z[g] = (__bfloat162float(xr[g]) + bj[g]) + round_to<bf16>(tc_gate(acc, g));
      c = sigmoid(z[1]) * c + sigmoid(z[0]) * activation(z[2], act);
      h = sigmoid(z[3]) * activation(c, act);
      if (j < U) {  // padding units keep h = 0: they are the product's zero K columns
        hnext[rl * C::LDH + j] = __float2bfloat16(h);
        cnow[rl * C::Kp + j] = c;
      }
    }
    __syncthreads();  // h_t staged for step t+1; every read of h_{t-1} done
    // y_t and c_t, row-contiguous.  hnext and cnow are next written in
    // step t+2, after step t+1's barrier.
    if (store) {
      const long long o = ((long long)(r0 + srow) * T_ + t) * U + scol;
      y[o] = hnext[srow * C::LDH + scol];
      if (cs != nullptr) cs[o] = cnow[srow * C::Kp + scol];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      xr[g] = xn[g];
      xn[g] = xnn[g];
    }
  }
  if (ok) {
    hn[row * U + j] = h;
    cn[row * U + j] = c;
  }
}

// f32 on the CUDA cores: threadIdx.x = unit j, threadIdx.y = row in the
// block.  kU = U, or 0 for any U (runtime).
template <int kU>
__global__ void __launch_bounds__(kFmaThreads)
    lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h0,
                    const float* __restrict__ c0, const float* __restrict__ R,
                    const float* __restrict__ bias, float* __restrict__ y,
                    float* __restrict__ cs, float* __restrict__ hn, float* __restrict__ cn,
                    int B, int T_, int U_, int act) {
  const int U = kU ? kU : U_;
  const int U4 = 4 * U, U1 = U + 1;
  {  // instance blockIdx.y's arrays
    const int n = blockIdx.y;
    x = at_instance(x, (long long)B * T_ * U4, n);
    h0 = at_instance(h0, (long long)B * U, n);
    c0 = at_instance(c0, (long long)B * U, n);
    R = at_instance(R, (long long)U * U4, n);
    bias = at_instance(bias, U4, n);
    y = at_instance(y, (long long)B * T_ * U, n);
    cs = at_instance(cs, (long long)B * T_ * U, n);
    hn = at_instance(hn, (long long)B * U, n);
    cn = at_instance(cn, (long long)B * U, n);
  }
  extern __shared__ __align__(16) float smem[];
  float4* R4 = reinterpret_cast<float4*>(smem);  // [U][U+1]: gates of R[k, g*U+j]
  float* hs = smem + 4 * U * U1;                   // [2][rows][U]
  const int j = threadIdx.x, rl = threadIdx.y, rows = blockDim.y;
  const int r = blockIdx.x * rows + rl;
  const bool valid = r < B;

  stage_r_fma(R4, R, U, rows);
  float c = valid ? c0[r * U + j] : 0.0f;
  float h = valid ? h0[r * U + j] : 0.0f;
  hs[rl * U + j] = h;
  float bj[4], xr[4], xn[4], xnn[4];  // x_t, x_{t+1}, x_{t+2}
  const float* xrow = x + (long long)r * T_ * U4 + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bj[g] = bias[g * U + j];
    xr[g] = valid ? xrow[g * U] : 0.0f;
    xn[g] = valid && T_ > 1 ? xrow[U4 + g * U] : 0.0f;
    xnn[g] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    const float* hr = hs + ((t & 1) * rows + rl) * U;
    if (valid && t + 2 < T_) {
#pragma unroll
      for (int g = 0; g < 4; ++g) xnn[g] = xrow[(long long)(t + 2) * U4 + g * U];
    }
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 16
    for (int k = 0; k < U; ++k) {
      const float hv = hr[k];
      const float4 w = R4[k * U1 + j];
      a0 = fmaf(hv, w.x, a0);
      a1 = fmaf(hv, w.y, a1);
      a2 = fmaf(hv, w.z, a2);
      a3 = fmaf(hv, w.w, a3);
    }
    const float zi = (xr[0] + bj[0]) + a0, zf = (xr[1] + bj[1]) + a1;
    const float zc = (xr[2] + bj[2]) + a2, zo = (xr[3] + bj[3]) + a3;
    c = sigmoid(zf) * c + sigmoid(zi) * activation(zc, act);
    h = sigmoid(zo) * activation(c, act);
    if (valid) {
      const long long o = ((long long)r * T_ + t) * U + j;
      y[o] = h;
      if (cs != nullptr) cs[o] = c;
    }
    hs[(((t + 1) & 1) * rows + rl) * U + j] = h;
    __syncthreads();  // h_t staged; every read of h_{t-1} (the other buffer) done
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      xr[g] = xn[g];
      xn[g] = xnn[g];
    }
  }
  if (valid) {
    hn[r * U + j] = h;
    cn[r * U + j] = c;
  }
}

// Any U past kMaxU, either dtype (X), on the CUDA cores: cdt(R) is read
// through L2 at every step, rounded on load, not staged (at U = 128 the
// f32 R alone would need 264 KB of shared memory).  A block owns `rows`
// batch rows; its threads take units j = tid, tid + blockDim, ... and, for
// each, the four gates of every row of the block, so that one load of R
// feeds `rows` FMAs.  The products accumulate in f32 and are rounded once
// to X, as the staged kernels do.
template <typename X>
__global__ void __launch_bounds__(kL2Threads)
    lstm_fwd_l2_kernel(const X* __restrict__ x, const float* __restrict__ h0,
                       const float* __restrict__ c0, const float* __restrict__ R,
                       const float* __restrict__ bias, X* __restrict__ y, float* __restrict__ cs,
                       float* __restrict__ hn, float* __restrict__ cn, int B, int T_, int U, int act,
                       int rows) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;               // [2][rows][U]: cdt(h) of step t's input at t & 1
  float* cst = hs + 2 * rows * U; // [rows][U]: c
  const int r0 = blockIdx.x * rows, U4 = 4 * U;
  {  // instance blockIdx.y's arrays
    const int n = blockIdx.y;
    x = at_instance(x, (long long)B * T_ * U4, n);
    h0 = at_instance(h0, (long long)B * U, n);
    c0 = at_instance(c0, (long long)B * U, n);
    R = at_instance(R, (long long)U * U4, n);
    bias = at_instance(bias, U4, n);
    y = at_instance(y, (long long)B * T_ * U, n);
    cs = at_instance(cs, (long long)B * T_ * U, n);
    hn = at_instance(hn, (long long)B * U, n);
    cn = at_instance(cn, (long long)B * U, n);
  }
  for (int e = threadIdx.x; e < rows * U; e += blockDim.x) {
    const int row = r0 + e / U, j = e % U;
    hs[e] = row < B ? round_to<X>(h0[row * U + j]) : 0.0f;
    cst[e] = row < B ? c0[row * U + j] : 0.0f;
  }
  __syncthreads();
  for (int t = 0; t < T_; ++t) {
    const float* hcur = hs + (t & 1) * rows * U;
    float* hnext = hs + ((t + 1) & 1) * rows * U;
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
          const float hv = hcur[rr * U + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[rr][g] = fmaf(hv, w[g], acc[rr][g]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kL2MaxRows; ++rr) {
        const int row = r0 + rr;
        if (rr >= rows || row >= B) break;
        const long long o = (long long)row * T_ + t;
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          z[g] = (to_f32(x[o * U4 + g * U + j]) + bias[g * U + j]) + round_to<X>(acc[rr][g]);
        const float c = sigmoid(z[1]) * cst[rr * U + j] + sigmoid(z[0]) * activation(z[2], act);
        const float h = sigmoid(z[3]) * activation(c, act);
        cst[rr * U + j] = c;
        hnext[rr * U + j] = round_to<X>(h);
        y[o * U + j] = from_f32<X>(h);
        if (cs != nullptr) cs[o * U + j] = c;
        if (t == T_ - 1) {
          hn[row * U + j] = h;
          cn[row * U + j] = c;
        }
      }
    }
    __syncthreads();  // h_t staged; every read of h_{t-1} (the other buffer) done
  }
}

template <typename X>
cudaError_t launch_l2(const void* x, const void* h0, const void* c0, const void* R,
                      const void* bias, void* y, void* cs, void* hn, void* cn, int N, int B, int T_,
                      int U, int act, cudaStream_t stream) {
  const int rows = l2_rows(false, U);
  if (rows == 0) return cudaErrorInvalidValue;
  const size_t smem = l2_smem(false, rows, U);
  const cudaError_t err = allow_smem((const void*)lstm_fwd_l2_kernel<X>, smem);
  if (err != cudaSuccess) return err;
  lstm_fwd_l2_kernel<X><<<dim3((B + rows - 1) / rows, N), kL2Threads, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(R), static_cast<const float*>(bias), static_cast<X*>(y),
      static_cast<float*>(cs), static_cast<float*>(hn), static_cast<float*>(cn), B, T_, U, act,
      rows);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_tc(const void* x, const void* h0, const void* c0, const void* R,
                      const void* bias, void* y, void* cs, void* hn, void* cn, int N, int B, int T_,
                      int U, int act, cudaStream_t stream) {
  using C = Tc<KT>;
  const size_t smem = (size_t)(C::Kp * C::LDR + 2 * 16 * C::LDH) * 2 +
                      (size_t)2 * kTcRows * C::Kp * 4;
  const cudaError_t err = allow_smem((const void*)lstm_fwd_tc_kernel<KT>, smem);
  if (err != cudaSuccess) return err;
  lstm_fwd_tc_kernel<KT><<<dim3((B + kTcRows - 1) / kTcRows, N), C::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(R), static_cast<const float*>(bias), static_cast<bf16*>(y),
      static_cast<float*>(cs), static_cast<float*>(hn), static_cast<float*>(cn), B, T_, U, act);
  return cudaGetLastError();
}

template <int kU>
cudaError_t launch_fma(const void* x, const void* h0, const void* c0, const void* R,
                       const void* bias, void* y, void* cs, void* hn, void* cn, int N, int B, int T_,
                       int U, int act, cudaStream_t stream) {
  const int rows = fma_rows(U);
  const size_t smem = ((size_t)4 * U * (U + 1) + (size_t)2 * rows * U) * sizeof(float);
  const cudaError_t err = allow_smem((const void*)lstm_fwd_kernel<kU>, smem);
  if (err != cudaSuccess) return err;
  lstm_fwd_kernel<kU><<<dim3((B + rows - 1) / rows, N), dim3(U, rows), smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(R), static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<float*>(cs), static_cast<float*>(hn), static_cast<float*>(cn), B, T_, U, act);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (of x and y; 1 runs the tensor-core
// kernel, 0 the CUDA-core one); act 0 = tanh, 1 = sigmoid.  N instances
// (1 to kMaxInstances), each its own problem, in one launch on every
// path: x [N, B, T, 4U]; h0, c0, hn, cn [N, B, U] float32; R [N, U, 4U]
// the recurrent kernels, float32 (the kernel rounds them to the compute
// dtype); bias [N, 4U] float32; y [N, B, T, U]; cs, if not null, the c
// stacks [N, B, T, U] float32.  Any U up to kccot_lstm_max_units() (bf16
// up to 128 on the tensor cores; past that, and f32 past 64, the L2
// kernel).  All contiguous.  Returns the launch's cudaError_t.
extern "C" int kccot_lstm_fwd(int dtype, int act, const void* x, const void* h0, const void* c0,
                              const void* R, const void* bias, void* y, void* cs, void* hn,
                              void* cn, int N, int B, int T, int U, void* stream) {
  if (N <= 0 || N > kccot::lstm::kMaxInstances || B <= 0 || T <= 0 || U <= 0 ||
      (act != 0 && act != 1) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && U <= kccot::lstm::kMaxUTc) {
    if (U <= 16) return launch_tc<1>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
    if (U <= 32) return launch_tc<2>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
    if (U <= 64) return launch_tc<4>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
    return launch_tc<8>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
  }
  if (U > kccot::lstm::kMaxU) {
    return dtype == 1 ? launch_l2<bf16>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s)
                      : launch_l2<float>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
  }
  switch (U) {
    case 8: return launch_fma<8>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
    case 32: return launch_fma<32>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
    case 64: return launch_fma<64>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
    default: return launch_fma<0>(x, h0, c0, R, bias, y, cs, hn, cn, N, B, T, U, act, s);
  }
}
