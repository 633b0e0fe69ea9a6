// Dense LSTM backward, all T steps in one launch, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/models/pallas_lstm.py::_bwd_kernel, the TPU
// kernel that walks t = T-1 .. 0, recomputing the gates from the saved
// y and c stacks and accumulating dR and db in VMEM across the grid.
// Here each block owns `rows` batch rows for all T steps (rows are
// independent), per step:
//
//   recompute z_t from cdt(h_{t-1}) (y[t-1], or cdt(h0) at t=0), the x
//   stack, b and c_{t-1} (c stack, or c0), as the forward did;
//   dh = dh_carry + dy_t;  dc = dc_carry + dh*o*act'(act(c_t))
//   dz = [dc*g*i(1-i), dc*c_{t-1}*f(1-f), dc*i*act'(g), dh*act(c_t)*o(1-o)]
//   dx_t = cdt(dz);  db_row += dz (f32)
//   dh_carry = cdt(dz) @ cdt(R)^T, accumulated in f32, not rounded
//   dc_carry = dc * f
// with act' written on the activation's value (1 - a^2 for tanh, a(1-a)
// for sigmoid), as the TPU kernel's _dact.  dR = sum over rows and steps
// of cdt(h_{t-1})^T cdt(dz_t) is the ConvLSTM's weight-gradient sum with
// a 1x1 frame and kernel (convlstm_bwd.cu, kccot_recurrent_wgrad), run
// after this kernel on the saved y and dx stacks; it also adds the
// per-row db partials this kernel writes.  Both sums run in a fixed
// order: no atomics.
//
// What bounds it: latency, as the forward (3 chains of U or 4U dependent
// FMAs and three barriers a step).  What the design does: one launch for
// all T steps; R (rounded to the compute dtype, as f32) is staged once
// in shared memory transposed, [4U][U+1]: the recompute reads
// R^T[g*U+j][k] and dh reads R^T[n][j], both conflict-free for even U
// thanks to the padding column; a thread owns one (row, unit j), keeps
// dh, dc and its four db sums in registers, and only h_{t-1} and the
// rounded dz row pass through shared memory.

#include "convlstm_tile.cuh"

namespace {

using namespace kccot;

__device__ __forceinline__ float activation(float z, int act) {
  return act == 0 ? tanhf(z) : sigmoid(z);
}

// Derivative of the activation from its value a.
__device__ __forceinline__ float dactivation(float a, int act) {
  return act == 0 ? 1.0f - a * a : a * (1.0f - a);
}

template <typename T>
__global__ void lstm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                const float* __restrict__ cs, const float* __restrict__ h0,
                                const float* __restrict__ c0, const float* __restrict__ R,
                                const float* __restrict__ bias, const T* __restrict__ dy,
                                const float* __restrict__ dhn, const float* __restrict__ dcn,
                                T* __restrict__ dx, float* __restrict__ dh0,
                                float* __restrict__ dc0, float* __restrict__ dbpart, int B, int T_,
                                int U, int act) {
  extern __shared__ __align__(16) float smem[];
  const int U1 = U + 1, U4 = 4 * U;
  const int j = threadIdx.x, rl = threadIdx.y, rows = blockDim.y;
  float* RT = smem;                // [4U][U+1]: RT[n][k] = R[k][n]
  float* hs = RT + U4 * U1;        // [rows][U]
  float* dzs = hs + rows * U;      // [rows][4U]
  const int r = blockIdx.x * rows + rl;
  const bool valid = r < B;
  const int tid = rl * U + j, nthreads = rows * U;

  for (int idx = tid; idx < U * U4; idx += nthreads) RT[(idx % U4) * U1 + idx / U4] = R[idx];
  float dh = valid ? dhn[r * U + j] : 0.0f;
  float dc = valid ? dcn[r * U + j] : 0.0f;
  float bj[4], dbacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int g = 0; g < 4; ++g) bj[g] = bias[g * U + j];
  const float* hr = hs + rl * U;
  const float* dzr = dzs + rl * U4;

  for (int t = T_ - 1; t >= 0; --t) {
    const long long row = (long long)r * T_ + t;
    float cp = 0.0f;
    if (valid) {
      hs[rl * U + j] = t > 0 ? to_f32(y[(row - 1) * U + j]) : round_to<T>(h0[r * U + j]);
      cp = t > 0 ? cs[(row - 1) * U + j] : c0[r * U + j];
    } else {
      hs[rl * U + j] = 0.0f;
    }
    __syncthreads();  // h_{t-1} staged

    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < U; ++k) {
      const float hv = hr[k];
#pragma unroll
      for (int g = 0; g < 4; ++g) a[g] = fmaf(hv, RT[(g * U + j) * U1 + k], a[g]);
    }
    float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (valid) {
      const T* xp = x + row * U4 + j;
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] = (to_f32(xp[g * U]) + bj[g]) + round_to<T>(a[g]);
      const float i = sigmoid(z[0]), fg = sigmoid(z[1]), gg = activation(z[2], act);
      const float o = sigmoid(z[3]);
      const float tc = activation(fg * cp + i * gg, act);
      const float dhv = dh + to_f32(dy[row * U + j]);
      const float dcv = dc + dhv * o * dactivation(tc, act);
      dz[0] = dcv * gg * i * (1.0f - i);
      dz[1] = dcv * cp * fg * (1.0f - fg);
      dz[2] = dcv * i * dactivation(gg, act);
      dz[3] = dhv * tc * o * (1.0f - o);
      T* dxp = dx + row * U4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dxp[g * U] = from_f32<T>(dz[g]);
        dbacc[g] += dz[g];
      }
      dc = dcv * fg;
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) dzs[rl * U4 + g * U + j] = round_to<T>(dz[g]);
    __syncthreads();  // the row's rounded dz staged; h_{t-1} no longer read

    float d = 0.0f;
    for (int n = 0; n < U4; ++n) d = fmaf(dzr[n], RT[n * U1 + j], d);
    dh = d;
    // hs is rewritten next step before its barrier: every read of it was
    // before the barrier above.  dzs is rewritten after that barrier.
  }
  if (valid) {
    dh0[r * U + j] = dh;
    dc0[r * U + j] = dc;
#pragma unroll
    for (int g = 0; g < 4; ++g) dbpart[(long long)r * U4 + g * U + j] = dbacc[g];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* cs, const void* h0, const void* c0,
                   const void* R, const void* bias, const void* dy, const void* dhn,
                   const void* dcn, void* dx, void* dh0, void* dc0, void* dbpart, int B, int T_,
                   int U, int act, cudaStream_t stream) {
  int rows = 128 / U;
  if (rows < 1) rows = 1;
  if (rows > B) rows = B;
  if (U * rows > 1024) return cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)4 * U * (U + 1) + (size_t)rows * U + (size_t)rows * 4 * U) * sizeof(float);
  const cudaError_t err = allow_smem((const void*)lstm_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  lstm_bwd_kernel<T><<<(B + rows - 1) / rows, dim3(U, rows), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const float*>(cs),
      static_cast<const float*>(h0), static_cast<const float*>(c0), static_cast<const float*>(R),
      static_cast<const float*>(bias), static_cast<const T*>(dy),
      static_cast<const float*>(dhn), static_cast<const float*>(dcn), static_cast<T*>(dx),
      static_cast<float*>(dh0), static_cast<float*>(dc0), static_cast<float*>(dbpart), B, T_, U,
      act);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (of x, y, dy and dx); act 0 = tanh,
// 1 = sigmoid.  x, dx [B, T, 4U]; y, dy [B, T, U]; cs the f32 c stack
// [B, T, U]; h0, c0, dhn, dcn, dh0, dc0 [B, U] float32; R [U, 4U] the
// recurrent kernel rounded to the compute dtype, as float32; bias [4U];
// dbpart [B, 4U] float32, each row's sum of dz over the steps.  All
// contiguous.  Returns the launch's cudaError_t.
extern "C" int kccot_lstm_bwd(int dtype, int act, const void* x, const void* y, const void* cs,
                              const void* h0, const void* c0, const void* R, const void* bias,
                              const void* dy, const void* dhn, const void* dcn, void* dx,
                              void* dh0, void* dc0, void* dbpart, int B, int T, int U,
                              void* stream) {
  if (B <= 0 || T <= 0 || U <= 0 || (act != 0 && act != 1)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, cs, h0, c0, R, bias, dy, dhn, dcn, dx, dh0, dc0, dbpart, B, T, U,
                         act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, cs, h0, c0, R, bias, dy, dhn, dcn, dx, dh0, dc0, dbpart, B,
                                 T, U, act, s);
  return cudaErrorInvalidValue;
}
