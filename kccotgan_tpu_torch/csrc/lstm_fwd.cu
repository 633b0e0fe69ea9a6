// Dense LSTM forward, all T steps in one launch, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/models/pallas_lstm.py::_fwd_kernel, the TPU
// kernel that keeps (h, c) in VMEM over a (batch tile, T) grid.  Rows of
// the batch are independent, so here each block owns `rows` of them for
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
// What bounds it: nothing the card is short of.  The work is 2*U*4U
// FLOP a row and step (0.2 GFLOP an iteration at mmnist_full) and the
// bytes are the x stack in and y out; each step is a chain of U
// dependent FMAs and two barriers, so latency sets the time.  What the
// design does about that: one launch for all T steps; R (rounded to the
// compute dtype, held as f32, the four gates of (k, j) interleaved so one
// 16-byte load feeds four FMAs) and h (rounded) stay in shared memory; a
// thread owns one (row, unit j), keeps c in a register and computes all
// four gates of j, so the gate math needs no exchange and only h passes
// through shared memory between steps.

#include "convlstm_tile.cuh"

namespace {

using namespace kccot;

__device__ __forceinline__ float activation(float z, int act) {
  return act == 0 ? tanhf(z) : sigmoid(z);
}

template <typename T>
__global__ void lstm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ h0,
                                const float* __restrict__ c0, const float* __restrict__ R,
                                const float* __restrict__ bias, T* __restrict__ y,
                                float* __restrict__ cs, float* __restrict__ hn,
                                float* __restrict__ cn, int B, int T_, int U, int act) {
  extern __shared__ __align__(16) float smem[];
  const int U4 = 4 * U;
  float4* R4 = reinterpret_cast<float4*>(smem);  // [U][U]: gates of R[k, g*U+j]
  float* hs = smem + 4 * U * U;                    // [rows][U]
  const int j = threadIdx.x, rl = threadIdx.y, rows = blockDim.y;
  const int r = blockIdx.x * rows + rl;
  const bool valid = r < B;
  const int tid = rl * U + j, nthreads = rows * U;

  for (int idx = tid; idx < U * U4; idx += nthreads) {
    const int k = idx / U4, n = idx % U4;
    smem[(k * U + n % U) * 4 + n / U] = R[idx];
  }
  float c = valid ? c0[r * U + j] : 0.0f;
  float h = valid ? h0[r * U + j] : 0.0f;
  hs[rl * U + j] = round_to<T>(h);
  float bj[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bj[g] = bias[g * U + j];
  __syncthreads();

  const float* hr = hs + rl * U;
  for (int t = 0; t < T_; ++t) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int k = 0; k < U; ++k) {
      const float hv = hr[k];
      const float4 w = R4[k * U + j];
      a0 = fmaf(hv, w.x, a0);
      a1 = fmaf(hv, w.y, a1);
      a2 = fmaf(hv, w.z, a2);
      a3 = fmaf(hv, w.w, a3);
    }
    if (valid) {
      const long long row = (long long)r * T_ + t;
      const T* xp = x + row * U4 + j;
      const float zi = (to_f32(xp[0]) + bj[0]) + round_to<T>(a0);
      const float zf = (to_f32(xp[U]) + bj[1]) + round_to<T>(a1);
      const float zc = (to_f32(xp[2 * U]) + bj[2]) + round_to<T>(a2);
      const float zo = (to_f32(xp[3 * U]) + bj[3]) + round_to<T>(a3);
      c = sigmoid(zf) * c + sigmoid(zi) * activation(zc, act);
      h = sigmoid(zo) * activation(c, act);
      y[row * U + j] = from_f32<T>(h);
      if (cs != nullptr) cs[row * U + j] = c;
    }
    __syncthreads();  // every thread has read h_{t-1}
    hs[rl * U + j] = round_to<T>(h);
    __syncthreads();
  }
  if (valid) {
    hn[r * U + j] = h;
    cn[r * U + j] = c;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* h0, const void* c0, const void* R, const void* bias,
                   void* y, void* cs, void* hn, void* cn, int B, int T_, int U, int act,
                   cudaStream_t stream) {
  int rows = 128 / U;
  if (rows < 1) rows = 1;
  if (rows > B) rows = B;
  if (U * rows > 1024) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)4 * U * U + (size_t)rows * U) * sizeof(float);
  const cudaError_t err = allow_smem((const void*)lstm_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  lstm_fwd_kernel<T><<<(B + rows - 1) / rows, dim3(U, rows), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(R), static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<float*>(cs), static_cast<float*>(hn), static_cast<float*>(cn), B, T_, U, act);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (of x and y); act 0 = tanh, 1 =
// sigmoid.  x [B, T, 4U]; h0, c0, hn, cn [B, U] float32; R [U, 4U] the
// recurrent kernel rounded to the compute dtype, held as float32; bias
// [4U] float32; y [B, T, U]; cs, if not null, the c stack [B, T, U]
// float32.  All contiguous.  Returns the launch's cudaError_t.
extern "C" int kccot_lstm_fwd(int dtype, int act, const void* x, const void* h0, const void* c0,
                              const void* R, const void* bias, void* y, void* cs, void* hn,
                              void* cn, int B, int T, int U, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0 || (act != 0 && act != 1)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, h0, c0, R, bias, y, cs, hn, cn, B, T, U, act, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, h0, c0, R, bias, y, cs, hn, cn, B, T, U, act, s);
  return cudaErrorInvalidValue;
}
