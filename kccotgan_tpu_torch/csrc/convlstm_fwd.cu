// ConvLSTM forward, one time step, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/models/pallas_convlstm.py::_fwd_kernel, the TPU
// kernel that runs all T steps of a layer in one pallas_call with (h, c)
// resident in VMEM.  Here the wrapper (models/cuda_convlstm.py) launches
// this kernel once per step, with h and c double-buffered in device
// memory: the encoder1 carry alone is 4 MiB of f32 at B=32, far beyond
// one SM's shared memory, so the step boundary is a launch boundary.
//
// What it computes, for every (sample, pixel, channel j):
//   rconv_g = sum_{ky,kx,ci} cdt(h_{t-1})[y+ky-lo, x+kx-lo, ci] * cdt(rk)[ky,kx,ci,g*f+j]
//             accumulated in f32, rounded once to cdt and back to f32
//   z_g     = (f32(x_t[g*f+j]) + bias[g*f+j]) + rconv_g        g in [i, f, c, o]
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_c)
//   h_t = sigmoid(z_o) * tanh(c_t);  y_t = cdt(h_t)
// with TF 'SAME' stride-1 padding (lo = (k-1)/2, the odd pad high).
//
// What bounds it: the recurrent conv, kh*kw*f*4f multiply-adds per pixel
// (an implicit GEMM with M = B*H*W, N = 4f, K = kh*kw*f).  This first
// version runs it on the CUDA cores in f32, not on the tensor cores, so
// it is bound by FMA issue and by the loads feeding the FMAs.  What the
// design does about that: each block stages its tile of h_{t-1}, halo
// included, in shared memory once (rounded to the compute dtype, held as
// f32 so the inner loop converts nothing); each thread keeps the four
// gate sums of kPix pixels in registers, so one 16-byte load of a
// weight's four gates (the wrapper interleaves them, [kh, kw, f, f, 4])
// feeds 4*kPix FMAs; a thread's pixels are strided over the tile so the
// threads of a warp read neighbouring pixels.  The pre-activations never
// go to device memory: the gate math runs on the accumulators.  wgmma,
// TMA and fusing the T steps into one persistent launch are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per block, at most
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and widened back to f32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// Block: threadIdx.x = output channel j within the block's channel tile;
// threadIdx.y = one of nruns threads sharing the spatial tile, each
// computing kPix of its pixels (pixel q = p * nruns + threadIdx.y).
// Grid: x = spatial tile, y = channel tile, z = sample.
template <typename T, int kPix>
__global__ void __launch_bounds__(kThreads)
convlstm_step_kernel(const T* __restrict__ x, long long x_bstride,
                     const float* __restrict__ h_prev, const float* __restrict__ c_prev,
                     const float4* __restrict__ rk4, const float* __restrict__ bias,
                     float* __restrict__ h_next, float* __restrict__ c_next,
                     T* __restrict__ y, long long y_bstride,
                     int H, int W, int f, int kh, int kw,
                     int tile_h, int tile_w, int tiles_w) {
  extern __shared__ float hs[];  // [tile_h+kh-1][tile_w+kw-1][f]

  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * tile_h;
  const int tx0 = (blockIdx.x % tiles_w) * tile_w;
  const int lo_h = (kh - 1) / 2, lo_w = (kw - 1) / 2;
  const int sw = tile_w + kw - 1;
  const int n_stage = (tile_h + kh - 1) * sw * f;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // Stage h_{t-1} over the tile and its halo, rounded to the compute
  // dtype.  Zeros outside the image are the 'SAME' padding.
  const float* hb = h_prev + (long long)b * H * W * f;
  for (int idx = tid; idx < n_stage; idx += nthreads) {
    const int ci = idx % f;
    const int r = idx / f;
    const int gy = ty0 - lo_h + r / sw;
    const int gx = tx0 - lo_w + r % sw;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = hb[((long long)gy * W + gx) * f + ci];
    hs[idx] = round_to<T>(v);
  }
  __syncthreads();

  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= f) return;
  const int nruns = blockDim.y;
  int off[kPix];  // smem offset of each pixel's top-left tap
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = p * nruns + threadIdx.y;
    off[p] = q < tile_h * tile_w ? ((q / tile_w) * sw + q % tile_w) * f : 0;
  }

  float acc[kPix][4];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
    acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;

  for (int ky = 0; ky < kh; ++ky) {
    for (int kx = 0; kx < kw; ++kx) {
      const float4* w = rk4 + (long long)(ky * kw + kx) * f * f + j;
      const float* ht = hs + (ky * sw + kx) * f;
      for (int ci = 0; ci < f; ++ci) {
        const float4 wv = __ldg(w + (long long)ci * f);
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const float hv = ht[off[p] + ci];
          acc[p][0] = fmaf(hv, wv.x, acc[p][0]);
          acc[p][1] = fmaf(hv, wv.y, acc[p][1]);
          acc[p][2] = fmaf(hv, wv.z, acc[p][2]);
          acc[p][3] = fmaf(hv, wv.w, acc[p][3]);
        }
      }
    }
  }

  const int f4 = 4 * f;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = p * nruns + threadIdx.y;
    const int gy = ty0 + q / tile_w, gx = tx0 + q % tile_w;
    if (q >= tile_h * tile_w || gy >= H || gx >= W) continue;
    const long long pix = (long long)gy * W + gx;
    const T* xp = x + b * x_bstride + pix * f4 + j;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      z[g] = (to_f32(xp[g * f]) + bias[g * f + j]) + round_to<T>(acc[p][g]);
    const long long s = ((long long)b * H * W + pix) * f + j;
    const float c = sigmoid(z[1]) * c_prev[s] + sigmoid(z[0]) * tanhf(z[2]);
    const float h = sigmoid(z[3]) * tanhf(c);
    c_next[s] = c;
    h_next[s] = h;
    y[b * y_bstride + pix * f + j] = from_f32<T>(h);
  }
}

template <typename T, int kPix>
cudaError_t launch(const void* x, long long x_bstride, const void* h_prev, const void* c_prev,
                   const void* rk4, const void* bias, void* h_next, void* c_next, void* y,
                   long long y_bstride, int B, int H, int W, int f, int kh, int kw,
                   cudaStream_t stream) {
  const int jt = f < 32 ? f : 32;
  const int tile_w = W < 16 ? W : 16;
  int tile_h = kThreads / jt * kPix / tile_w;
  if (tile_h > H) tile_h = H;
  if (tile_h < 1) tile_h = 1;
  const int nruns = (tile_h * tile_w + kPix - 1) / kPix;
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int tiles_h = (H + tile_h - 1) / tile_h;
  const dim3 block(jt, nruns);
  const dim3 grid(tiles_w * tiles_h, (f + jt - 1) / jt, B);
  const size_t smem = (size_t)(tile_h + kh - 1) * (tile_w + kw - 1) * f * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        convlstm_step_kernel<T, kPix>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  convlstm_step_kernel<T, kPix><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), x_bstride, static_cast<const float*>(h_prev),
      static_cast<const float*>(c_prev), static_cast<const float4*>(rk4),
      static_cast<const float*>(bias), static_cast<float*>(h_next),
      static_cast<float*>(c_next), static_cast<T*>(y), y_bstride, H, W, f, kh, kw,
      tile_h, tile_w, tiles_w);
  return cudaGetLastError();
}

// Pixels a thread: more pixels give more FMAs per load, fewer give more
// threads.  Frames of 256 pixels or more fill the card at 8; the 8x8 and
// 4x4 frames of the deep layers need 4 and 2 to keep enough threads.
template <typename T>
cudaError_t dispatch(const void* x, long long x_bstride, const void* h_prev, const void* c_prev,
                     const void* rk4, const void* bias, void* h_next, void* c_next, void* y,
                     long long y_bstride, int B, int H, int W, int f, int kh, int kw,
                     cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || f <= 0 || kh <= 0 || kw <= 0) return cudaErrorInvalidValue;
  if (H * W >= 256)
    return launch<T, 8>(x, x_bstride, h_prev, c_prev, rk4, bias, h_next, c_next, y, y_bstride,
                        B, H, W, f, kh, kw, stream);
  if (H * W >= 64)
    return launch<T, 4>(x, x_bstride, h_prev, c_prev, rk4, bias, h_next, c_next, y, y_bstride,
                        B, H, W, f, kh, kw, stream);
  return launch<T, 2>(x, x_bstride, h_prev, c_prev, rk4, bias, h_next, c_next, y, y_bstride,
                      B, H, W, f, kh, kw, stream);
}

}  // namespace

// One step: dtype 0 = float32, 1 = bfloat16 (the dtype of x and y).
// x and y point at time step t of [B, T, H, W, 4f] / [B, T, H, W, f]
// stacks, with the given per-sample strides in elements; h and c are
// [B, H, W, f] float32; rk4 is the recurrent kernel rounded to the
// compute dtype, held as float32 with its gates interleaved,
// [kh, kw, f_in, f_out, 4] (16-byte aligned); bias [4f] float32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int kccot_convlstm_fwd_step(int dtype, const void* x, long long x_bstride,
                                       const void* h_prev, const void* c_prev, const void* rk4,
                                       const void* bias, void* h_next, void* c_next, void* y,
                                       long long y_bstride, int B, int H, int W, int f, int kh,
                                       int kw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, x_bstride, h_prev, c_prev, rk4, bias, h_next, c_next, y,
                           y_bstride, B, H, W, f, kh, kw, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, x_bstride, h_prev, c_prev, rk4, bias, h_next, c_next, y,
                                   y_bstride, B, H, W, f, kh, kw, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kccot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
