// ConvLSTM backward for Hopper (sm_90a): the reverse-time adjoint of
// convlstm_fwd.cu, and the weight gradient shared with the dense LSTM.
//
// Replaces kccotgan_tpu/models/pallas_convlstm.py::_bwd_kernel, the TPU
// kernel that walks t = T-1 .. 0 in one pallas_call, recomputing the
// gates from the saved y and c stacks and accumulating drk and db in
// VMEM across the whole grid.  Here, as in the forward, the step
// boundary is a launch boundary (the carries are megabytes), and each
// step is two launches, because dh_{t-1} at a pixel needs dz at every
// pixel of its halo:
//
// 1. convlstm_bwd_step_kernel, per (sample, pixel, channel j):
//      recompute z_t from cdt(h_{t-1}) (y[t-1], or cdt(h0) at t=0),
//      the x stack, bias and c_{t-1} (c stack, or c0), exactly as the
//      forward did; then the cell adjoint
//        dh = dh_carry + dy_t;  dc = dc_carry + dh*o*(1 - tanh(c_t)^2)
//        dz = [dc*g*i(1-i), dc*c_{t-1}*f(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o(1-o)]
//      dx_t = cdt(dz); dc_carry = dc * f; and the block's sum of the
//      f32 dz per channel into its own row of a db partial (each block
//      owns its row across all steps: no atomics, deterministic).
// 2. convlstm_bwd_dh_kernel: dh_carry = the transposed 'SAME' conv of
//    cdt(dz) (read back from dx_t) with cdt(rk), accumulated in f32 and
//    kept f32, with the flipped pads (k-1-lo before, lo after).
// 3. After the loop, recurrent_wgrad_kernel: drk[ky,kx,ci,n] =
//    sum over t, samples and pixels of cdt(h_{t-1})[shifted by ky,kx][ci]
//    * dx_t[n] -- the TPU kernel's per-step drk update, done once over
//    the saved y and dx stacks (dx_t is exactly cdt(dz_t)).  An implicit
//    GEMM, M = kh*kw*f, N = 4f, K = B*T*H*W, split over K into per-split
//    partial sums; recurrent_finalize_kernel adds the splits and the db
//    partials in a fixed order.  The dense LSTM's dR is the same sum with
//    H = W = kh = kw = 1 (models/cuda_lstm.py calls it so).
//
// What bounds it: three convs' worth of multiply-adds a step (the
// recomputed rconv, dh and drk; about 3 TFLOP an iteration at
// mmnist_full), run here on the CUDA cores in f32, so FMA throughput and the
// loads that feed it.  What the design does about that: kernels 1 and 2
// stage their input tile (halo included) in shared memory and keep kPix
// pixels' sums in registers per weight load, as the forward does; kernel
// 2 chunks the 4f input channels so the staged tile fits, and reads four
// of them per 16-byte load; the drk GEMM uses 64x64 output tiles with a
// 4x4 register tile per thread, and splits K until about 4 blocks per SM
// are in flight, which is what keeps enc4 (4x4 frames, K = B*T*16) and
// dec5 (M = 512, N = 32) from starving the card.  Tensor cores (bf16
// mma with f32 sums is exact for the bf16 path) are later work.

#include "convlstm_tile.cuh"

namespace {

using namespace kccot;

template <typename T, int kPix>
__global__ void __launch_bounds__(kThreads)
convlstm_bwd_step_kernel(const T* __restrict__ x, long long x_bstride,
                         const T* __restrict__ hp, long long hp_bstride,
                         const float* __restrict__ c_prev, long long cp_bstride,
                         const float4* __restrict__ rk4, const float* __restrict__ bias,
                         const T* __restrict__ dy, long long dy_bstride,
                         const float* __restrict__ dh, float* __restrict__ dc,
                         T* __restrict__ dx, long long dx_bstride, float* __restrict__ dbpart,
                         int H, int W, int f, int kh, int kw,
                         int tile_h, int tile_w, int tiles_w) {
  extern __shared__ float hs[];  // [tile_h+kh-1][tile_w+kw-1][f], then the db reduction

  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * tile_h;
  const int tx0 = (blockIdx.x % tiles_w) * tile_w;
  const int sw = tile_w + kw - 1;
  stage_h<T>(hs, hp + b * hp_bstride, H, W, f, kh, kw, ty0, tx0, tile_h, tile_w);
  __syncthreads();

  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const bool valid_j = j < f;
  const int nruns = blockDim.y;
  int off[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = p * nruns + threadIdx.y;
    off[p] = q < tile_h * tile_w ? ((q / tile_w) * sw + q % tile_w) * f : 0;
  }
  float acc[kPix][4];
#pragma unroll
  for (int p = 0; p < kPix; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
  if (valid_j) rconv_gates<kPix>(acc, hs, rk4, off, j, f, kh, kw, sw);

  const int f4 = 4 * f;
  float dbp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = p * nruns + threadIdx.y;
    const int gy = ty0 + q / tile_w, gx = tx0 + q % tile_w;
    if (!valid_j || q >= tile_h * tile_w || gy >= H || gx >= W) continue;
    const long long pix = (long long)gy * W + gx;
    const T* xp = x + b * x_bstride + pix * f4 + j;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      z[g] = (to_f32(xp[g * f]) + bias[g * f + j]) + round_to<T>(acc[p][g]);
    const float i = sigmoid(z[0]), fg = sigmoid(z[1]), gg = tanhf(z[2]), o = sigmoid(z[3]);
    const float cp = c_prev[b * cp_bstride + pix * f + j];
    const float tc = tanhf(fg * cp + i * gg);
    const long long s = ((long long)b * H * W + pix) * f + j;
    const float dhv = dh[s] + to_f32(dy[b * dy_bstride + pix * f + j]);
    const float dcv = dc[s] + dhv * o * (1.0f - tc * tc);
    float dz[4];
    dz[0] = dcv * gg * i * (1.0f - i);
    dz[1] = dcv * cp * fg * (1.0f - fg);
    dz[2] = dcv * i * (1.0f - gg * gg);
    dz[3] = dhv * tc * o * (1.0f - o);
    T* dxp = dx + b * dx_bstride + pix * f4 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      dxp[g * f] = from_f32<T>(dz[g]);
      dbp[g] += dz[g];
    }
    dc[s] = dcv * fg;
  }

  // The block's db partial: sum over the nruns threads of each channel in
  // a fixed order, added to the block's own row.
  __syncthreads();
  float* red = hs;  // [nruns][jt][4]
  const int slot = (threadIdx.y * blockDim.x + threadIdx.x) * 4;
#pragma unroll
  for (int g = 0; g < 4; ++g) red[slot + g] = dbp[g];
  __syncthreads();
  if (threadIdx.y == 0 && valid_j) {
    float* row = dbpart + ((long long)b * gridDim.x + blockIdx.x) * f4;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float sum = 0.0f;
      for (int r = 0; r < nruns; ++r) sum += red[(r * blockDim.x + threadIdx.x) * 4 + g];
      row[g * f + j] += sum;
    }
  }
}

// dh[b, y, x, ci] = sum_{ky,kx,n} cdt(dz)[b, y+lo_h-ky, x+lo_w-kx, n] * cdt(rk)[ky,kx,ci,n]
// (zero outside the frame).  rkT4 is cdt(rk) as f32, [kh, kw, 4f/4, f, 4]:
// one 16-byte load holds four consecutive n of one ci.  The dz tile is
// staged nc channels at a time, [tile_h+kh-1][tile_w+kw-1][nc], its row
// r holding frame row ty0 - (kh-1-lo_h) + r.
template <typename T, int kPix>
__global__ void __launch_bounds__(kThreads)
convlstm_bwd_dh_kernel(const T* __restrict__ dx, long long dx_bstride,
                       const float4* __restrict__ rkT4, float* __restrict__ dh,
                       int H, int W, int f, int kh, int kw, int nc,
                       int tile_h, int tile_w, int tiles_w) {
  extern __shared__ __align__(16) float dzs[];

  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * tile_h;
  const int tx0 = (blockIdx.x % tiles_w) * tile_w;
  const int before_h = kh - 1 - (kh - 1) / 2, before_w = kw - 1 - (kw - 1) / 2;
  const int sw = tile_w + kw - 1;
  const int n_rows = (tile_h + kh - 1) * sw;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int ci = blockIdx.y * blockDim.x + threadIdx.x;
  const bool valid = ci < f;
  const int nruns = blockDim.y;
  const int f4 = 4 * f;
  const T* dxb = dx + b * dx_bstride;

  int off[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = p * nruns + threadIdx.y;
    off[p] = q < tile_h * tile_w ? ((q / tile_w) * sw + q % tile_w) * nc : 0;
  }
  float acc[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) acc[p] = 0.0f;

  for (int n0 = 0; n0 < f4; n0 += nc) {
    const int ncur = f4 - n0 < nc ? f4 - n0 : nc;
    for (int idx = tid; idx < n_rows * ncur; idx += nthreads) {
      const int cc = idx % ncur;
      const int r = idx / ncur;
      const int gy = ty0 - before_h + r / sw;
      const int gx = tx0 - before_w + r % sw;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(dxb[((long long)gy * W + gx) * f4 + n0 + cc]);
      dzs[r * nc + cc] = v;
    }
    __syncthreads();
    if (valid) {
      for (int ky = 0; ky < kh; ++ky) {
        for (int kx = 0; kx < kw; ++kx) {
          const float* base = dzs + ((kh - 1 - ky) * sw + (kw - 1 - kx)) * nc;
          const float4* w = rkT4 + ((long long)(ky * kw + kx) * (f4 / 4) + n0 / 4) * f + ci;
          for (int n4 = 0; n4 < ncur / 4; ++n4) {
            const float4 wv = __ldg(w + (long long)n4 * f);
#pragma unroll
            for (int p = 0; p < kPix; ++p) {
              const float4 d = *reinterpret_cast<const float4*>(base + off[p] + 4 * n4);
              acc[p] = fmaf(d.x, wv.x, acc[p]);
              acc[p] = fmaf(d.y, wv.y, acc[p]);
              acc[p] = fmaf(d.z, wv.z, acc[p]);
              acc[p] = fmaf(d.w, wv.w, acc[p]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (!valid) return;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = p * nruns + threadIdx.y;
    const int gy = ty0 + q / tile_w, gx = tx0 + q % tile_w;
    if (q >= tile_h * tile_w || gy >= H || gx >= W) continue;
    dh[(((long long)b * H + gy) * W + gx) * f + ci] = acc[p];
  }
}

constexpr int kTileM = 64, kTileN = 64, kTileK = 16;

// part[s][m][n] = sum over the pixels p of split s of A[p][m] * dx[p][n],
// A[p][m] = cdt(h_{t-1})[b, y+ky-lo_h, x+kx-lo_w, ci] (zero outside the
// frame), m = (ky*kw + kx)*f + ci, p = ((b*T + t)*H + y)*W + x.
// h_{t-1} is y[b, t-1] for t >= 1 and h0c[b] (cdt(h0)) at t = 0.
template <typename T>
__global__ void __launch_bounds__(256)
recurrent_wgrad_kernel(const T* __restrict__ y, const T* __restrict__ h0c,
                       const T* __restrict__ dx, float* __restrict__ part,
                       int T_, int H, int W, int f, int kh, int kw,
                       long long P, long long chunk) {
  __shared__ __align__(16) float As[kTileK][kTileM];
  __shared__ __align__(16) float Bs[kTileK][kTileN];

  const int M = kh * kw * f, N = 4 * f;
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const long long p_begin = (long long)blockIdx.z * chunk;
  const long long p_end = p_begin + chunk < P ? p_begin + chunk : P;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // Each thread loads the same column (m or n) of every tile: rows
  // tid/64 + 4q, q = 0..3.
  const int mm = tid % kTileM, nn = tid % kTileN, kk0 = tid / kTileM;
  const int m = m0 + mm, n = n0 + nn;
  const bool m_ok = m < M, n_ok = n < N;
  const int tap = m_ok ? m / f : 0, ci = m_ok ? m % f : 0;
  const int dy_ = tap / kw - (kh - 1) / 2, dx_ = tap % kw - (kw - 1) / 2;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;

  for (long long p0 = p_begin; p0 < p_end; p0 += kTileK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = kk0 + 4 * q;
      const long long p = p0 + kk;
      float av = 0.0f, bv = 0.0f;
      if (p < p_end) {
        if (m_ok) {
          const int px = (int)(p % W);
          long long rest = p / W;
          const int py = (int)(rest % H);
          rest /= H;
          const int t = (int)(rest % T_);
          const long long bb = rest / T_;
          const int yy = py + dy_, xx = px + dx_;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const long long pix = (long long)yy * W + xx;
            av = t == 0 ? to_f32(h0c[(bb * H * W + pix) * f + ci])
                        : to_f32(y[((bb * T_ + t - 1) * H * W + pix) * f + ci]);
          }
        }
        if (n_ok) bv = to_f32(dx[p * N + n]);
      }
      As[kk][mm] = av;
      Bs[kk][nn] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bw[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int mo = m0 + ty * 4 + r;
    if (mo >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int no = n0 + tx * 4 + c;
      if (no < N) out[(long long)mo * N + no] = acc[r][c];
    }
  }
}

// drk = sum of the splits' partials; db = sum of the db partial rows.
__global__ void recurrent_finalize_kernel(const float* __restrict__ part, int splits, long long MN,
                                          const float* __restrict__ dbpart, int rows, int N,
                                          float* __restrict__ drk, float* __restrict__ dbias) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < MN) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[k * MN + idx];
    drk[idx] = s;
  }
  if (idx < N) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += dbpart[(long long)r * N + idx];
    dbias[idx] = s;
  }
}

template <typename T, int kPix>
cudaError_t launch_step(const void* x, long long x_bstride, const void* hp, long long hp_bstride,
                        const void* c_prev, long long cp_bstride, const void* rk4,
                        const void* bias, const void* dy, long long dy_bstride, const void* dh,
                        void* dc, void* dx, long long dx_bstride, void* dbpart, int B, int H,
                        int W, int f, int kh, int kw, cudaStream_t stream) {
  const Tile t = make_tile(H, W, f, kPix);
  const dim3 block(t.jt, t.nruns);
  const dim3 grid(t.tiles_w * t.tiles_h, (f + t.jt - 1) / t.jt, B);
  size_t smem = (size_t)(t.tile_h + kh - 1) * (t.tile_w + kw - 1) * f;
  if (smem < (size_t)t.jt * t.nruns * 4) smem = (size_t)t.jt * t.nruns * 4;
  smem *= sizeof(float);
  const cudaError_t err = allow_smem((const void*)convlstm_bwd_step_kernel<T, kPix>, smem);
  if (err != cudaSuccess) return err;
  convlstm_bwd_step_kernel<T, kPix><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), x_bstride, static_cast<const T*>(hp), hp_bstride,
      static_cast<const float*>(c_prev), cp_bstride, static_cast<const float4*>(rk4),
      static_cast<const float*>(bias), static_cast<const T*>(dy), dy_bstride,
      static_cast<const float*>(dh), static_cast<float*>(dc), static_cast<T*>(dx), dx_bstride,
      static_cast<float*>(dbpart), H, W, f, kh, kw, t.tile_h, t.tile_w, t.tiles_w);
  return cudaGetLastError();
}

template <typename T, int kPix>
cudaError_t launch_dh(const void* dx, long long dx_bstride, const void* rkT4, void* dh, int B,
                      int H, int W, int f, int kh, int kw, cudaStream_t stream) {
  const Tile t = make_tile(H, W, f, kPix);
  const int nc = 4 * f < 64 ? 4 * f : 64;
  const dim3 block(t.jt, t.nruns);
  const dim3 grid(t.tiles_w * t.tiles_h, (f + t.jt - 1) / t.jt, B);
  const size_t smem = (size_t)(t.tile_h + kh - 1) * (t.tile_w + kw - 1) * nc * sizeof(float);
  const cudaError_t err = allow_smem((const void*)convlstm_bwd_dh_kernel<T, kPix>, smem);
  if (err != cudaSuccess) return err;
  convlstm_bwd_dh_kernel<T, kPix><<<grid, block, smem, stream>>>(
      static_cast<const T*>(dx), dx_bstride, static_cast<const float4*>(rkT4),
      static_cast<float*>(dh), H, W, f, kh, kw, nc, t.tile_h, t.tile_w, t.tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t step(const void* x, long long x_bstride, const void* hp, long long hp_bstride,
                 const void* c_prev, long long cp_bstride, const void* rk4, const void* bias,
                 const void* dy, long long dy_bstride, const void* dh, void* dc, void* dx,
                 long long dx_bstride, void* dbpart, int B, int H, int W, int f, int kh, int kw,
                 cudaStream_t s) {
  switch (pixels_per_thread(H, W)) {
    case 8:
      return launch_step<T, 8>(x, x_bstride, hp, hp_bstride, c_prev, cp_bstride, rk4, bias, dy,
                               dy_bstride, dh, dc, dx, dx_bstride, dbpart, B, H, W, f, kh, kw, s);
    case 4:
      return launch_step<T, 4>(x, x_bstride, hp, hp_bstride, c_prev, cp_bstride, rk4, bias, dy,
                               dy_bstride, dh, dc, dx, dx_bstride, dbpart, B, H, W, f, kh, kw, s);
    default:
      return launch_step<T, 2>(x, x_bstride, hp, hp_bstride, c_prev, cp_bstride, rk4, bias, dy,
                               dy_bstride, dh, dc, dx, dx_bstride, dbpart, B, H, W, f, kh, kw, s);
  }
}

template <typename T>
cudaError_t dh_step(const void* dx, long long dx_bstride, const void* rkT4, void* dh, int B, int H,
                    int W, int f, int kh, int kw, cudaStream_t s) {
  switch (pixels_per_thread(H, W)) {
    case 8: return launch_dh<T, 8>(dx, dx_bstride, rkT4, dh, B, H, W, f, kh, kw, s);
    case 4: return launch_dh<T, 4>(dx, dx_bstride, rkT4, dh, B, H, W, f, kh, kw, s);
    default: return launch_dh<T, 2>(dx, dx_bstride, rkT4, dh, B, H, W, f, kh, kw, s);
  }
}

template <typename T>
cudaError_t wgrad(const void* y, const void* h0c, const void* dx, void* part, int splits,
                  long long chunk, const void* dbpart, int rows, void* drk, void* dbias, int B,
                  int T_, int H, int W, int f, int kh, int kw, cudaStream_t s) {
  const int M = kh * kw * f, N = 4 * f;
  const long long P = (long long)B * T_ * H * W;
  if (splits <= 0 || chunk <= 0 || (long long)splits * chunk < P) return cudaErrorInvalidValue;
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN, splits);
  recurrent_wgrad_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(h0c), static_cast<const T*>(dx),
      static_cast<float*>(part), T_, H, W, f, kh, kw, P, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long MN = (long long)M * N;
  const int threads = 256;
  const long long blocks = ((MN > N ? MN : N) + threads - 1) / threads;
  recurrent_finalize_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const float*>(part), splits, MN, static_cast<const float*>(dbpart), rows, N,
      static_cast<float*>(drk), static_cast<float*>(dbias));
  return cudaGetLastError();
}

}  // namespace

// Rows of the db partial that kccot_convlstm_bwd_step accumulates into:
// one per (sample, spatial tile), [rows, 4f] float32, zeroed by the caller.
extern "C" int kccot_convlstm_bwd_rows(int B, int H, int W, int f) {
  if (B <= 0 || H <= 0 || W <= 0 || f <= 0) return 0;
  const Tile t = make_tile(H, W, f, pixels_per_thread(H, W));
  return B * t.tiles_w * t.tiles_h;
}

// Step t of the reverse loop, kernel 1 (module comment).  dtype 0 =
// float32, 1 = bfloat16: the dtype of x, hp, dy and dx.  x, dy and dx
// point at step t of their [B, T, H, W, *] stacks; hp at y[:, t-1] or at
// cdt(h0); c_prev at c_stack[:, t-1] or at c0; each with its per-sample
// stride in elements.  dh (read) and dc (read and written) are the f32
// carries [B, H, W, f]; rk4 as in kccot_convlstm_fwd_step.
extern "C" int kccot_convlstm_bwd_step(int dtype, const void* x, long long x_bstride,
                                       const void* hp, long long hp_bstride, const void* c_prev,
                                       long long cp_bstride, const void* rk4, const void* bias,
                                       const void* dy, long long dy_bstride, const void* dh,
                                       void* dc, void* dx, long long dx_bstride, void* dbpart,
                                       int B, int H, int W, int f, int kh, int kw, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || f <= 0 || kh <= 0 || kw <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return step<float>(x, x_bstride, hp, hp_bstride, c_prev, cp_bstride, rk4, bias, dy,
                       dy_bstride, dh, dc, dx, dx_bstride, dbpart, B, H, W, f, kh, kw, s);
  if (dtype == 1)
    return step<__nv_bfloat16>(x, x_bstride, hp, hp_bstride, c_prev, cp_bstride, rk4, bias, dy,
                               dy_bstride, dh, dc, dx, dx_bstride, dbpart, B, H, W, f, kh, kw, s);
  return cudaErrorInvalidValue;
}

// Step t, kernel 2: dh [B, H, W, f] float32 from dx at step t (per-sample
// stride dx_bstride) and rkT4 = cdt(rk) as float32, [kh, kw, 4f/4, f, 4].
extern "C" int kccot_convlstm_bwd_dh(int dtype, const void* dx, long long dx_bstride,
                                     const void* rkT4, void* dh, int B, int H, int W, int f,
                                     int kh, int kw, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || f <= 0 || kh <= 0 || kw <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dh_step<float>(dx, dx_bstride, rkT4, dh, B, H, W, f, kh, kw, s);
  if (dtype == 1) return dh_step<__nv_bfloat16>(dx, dx_bstride, rkT4, dh, B, H, W, f, kh, kw, s);
  return cudaErrorInvalidValue;
}

// After the loop: drk [kh, kw, f, 4f] and db [4f], float32, from the y
// stack [B, T, H, W, f], h0c = cdt(h0) [B, H, W, f], the dx stack
// [B, T, H, W, 4f] (all of the compute dtype), and the db partial
// [rows, 4f].  part is float32 scratch [splits, kh*kw*f, 4f]; split s
// covers pixels [s*chunk, (s+1)*chunk) of the B*T*H*W.  Two launches.
extern "C" int kccot_recurrent_wgrad(int dtype, const void* y, const void* h0c, const void* dx,
                                     void* part, int splits, long long chunk, const void* dbpart,
                                     int rows, void* drk, void* dbias, int B, int T, int H, int W,
                                     int f, int kh, int kw, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || f <= 0 || kh <= 0 || kw <= 0 || rows < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return wgrad<float>(y, h0c, dx, part, splits, chunk, dbpart, rows, drk, dbias, B, T, H, W, f,
                        kh, kw, s);
  if (dtype == 1)
    return wgrad<__nv_bfloat16>(y, h0c, dx, part, splits, chunk, dbpart, rows, drk, dbias, B, T,
                                H, W, f, kh, kw, s);
  return cudaErrorInvalidValue;
}
