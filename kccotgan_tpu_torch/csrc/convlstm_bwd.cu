// ConvLSTM backward for Hopper (sm_90a): the reverse-time adjoint of
// convlstm_fwd.cu, and the weight gradient shared with the dense LSTM.
//
// Replaces kccotgan_tpu/models/pallas_convlstm.py::_bwd_kernel, the TPU
// kernel that walks t = T-1 .. 0 in one pallas_call, recomputing the
// gates from the saved y and c stacks and accumulating drk and db in
// VMEM across the whole grid.  Here, as in the forward, the step
// boundary is a launch boundary (the carries are megabytes), and each
// step is two launches, because dh_{t-1} at a pixel needs dz at every
// pixel of its halo.  The gates are not recomputed: under autograd the
// forward saved each step's pre-activations z_t in the f32 gate stack
// [B, T, H, W, 4f] (gate g of channel j at 4j + g), exactly the values
// its epilogue ran on, so the recurrent conv runs once, in the forward.
//
// 1. The step kernel, per (sample, pixel, channel j): the cell adjoint
//    on z_t (one 16-byte load) and c_{t-1} (c stack, or c0)
//        i, f, g, o = sigmoid(z_i), sigmoid(z_f), tanh(z_c), sigmoid(z_o)
//        dh = dh_carry + dy_t;  dc = dc_carry + dh*o*(1 - tanh(c_t)^2)
//        dz = [dc*g*i(1-i), dc*c_{t-1}*f(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o(1-o)]
//    with c_t = f*c_{t-1} + i*g; dx_t = cdt(dz); dc_carry = dc * f; and
//    the block's sum of the f32 dz per channel into its own row of a db
//    partial (each block owns its row across all steps: no atomics,
//    deterministic).  No halo, no weight, no product: it reads 16 bytes
//    of gates, c_{t-1}, dy_t and the two carries and writes dx_t and dc,
//    some 42 bytes a (pixel, j) in bf16, so memory bounds it.  One kernel
//    for both dtypes (T = the dtype of dy and dx), pixel-major: a thread
//    takes 4 consecutive channels of a pixel where f allows (four 16-byte
//    gate loads, 16-byte c and carries, 8- or 16-byte dy and dx), and a
//    warp's accesses to each stack are one contiguous span.  db sums over
//    the block's pixels by a fixed butterfly and then the warps in order.
// 2. The dh kernel: dh_carry = the transposed 'SAME' conv of cdt(dz)
//    (read back from dx_t) with cdt(rk), accumulated in f32 and kept
//    f32, with the flipped pads (k-1-lo before, lo after).
// 3. After the loop, the weight gradient: drk[ky,kx,ci,n] = sum over t,
//    samples and pixels of cdt(h_{t-1})[shifted by ky,kx][ci] * dx_t[n]
//    -- the TPU kernel's per-step drk update, done once over the saved y
//    and dx stacks (dx_t is exactly cdt(dz_t)).  An implicit GEMM, M =
//    kh*kw*f, N = 4f, K = B*T*H*W, split over K into per-split partial
//    sums; recurrent_finalize_kernel adds the splits and the db partials
//    in a fixed order, so drk and db are bitwise deterministic.  The
//    dense LSTM's dR is the same sum with H = W = kh = kw = 1
//    (models/cuda_lstm.py calls it so).
//
// What bounds it: two convs' worth of multiply-adds a step (dh and drk;
// about 2 TFLOP an iteration at mmnist_full) -- on the tensor cores, the
// latency of the per-step launches and their K loops rather than the MMA
// rate -- and the adjoint's bytes.  Two engines, by dtype:
// * bf16 (dtype 1): both products on the tensor cores through the
//   implicit-GEMM block of convlstm_tile.cuh (mma.sync m16n8k16, ldmatrix,
//   cp.async in three stages).  Every operand is already bf16 (y, dx,
//   cdt(h0), and cdt(rk) transposed, [kh*kw*4f, 8*ceil(f/8)], which the
//   wrapper packs once per call for dh), so the products are exact in f32
//   and only the order of the f32 sums differs.  The drk GEMM reads A =
//   shifted cdt(h_{t-1}) transposed (ldmatrix .trans) and B = dx, split
//   over K until about 4 blocks an SM are in flight.  Tiles are chosen
//   per layer so a launch has at least one block per SM where the shape
//   allows.
// * f32 (dtype 0): the CUDA cores in f32 FMA (TF32 would miss the f32
//   tolerances): kernel 2 stages its dz tile (halo included) in shared
//   memory, nc input channels at a time, and keeps kPix pixels' sums in
//   registers per weight load; the drk GEMM uses 64x64 output tiles with
//   a 4x4 register tile a thread.
//
// Recurrent dropout (convlstm_fwd.cu): gate g's conv read hm_g =
// cdt(h_{t-1} * mask_g), which the forward saved as the [B, T, H, W, 4f]
// hm stack (hm_{-1} apart).  Kernel 1 is the same: the masks enter only
// the convs, and the gates it reads already hold them.  Kernel 2 needs,
// per (pixel, ci), the four gates' transposed convs apart, dh = sum_g
// mask_g * dhm_g: on the tensor cores its GEMM takes N = 4 gates x f in
// the gate-quad column order of the forward (B the transposed
// block-diagonal weight), so one thread holds the four dhm_g of a (pixel,
// ci) and sums them with the masks in its epilogue; in f32 the kernel
// walks the gates one after the other.  Kernel 3 runs one GEMM a gate
// over the grid (drk's gate-g columns from hm_g and dz_g), the MMAs of
// the unmasked one.

#include "convlstm_tile.cuh"

namespace {

using namespace kccot;

// V consecutive elements at p, widened to f32 / rounded from f32: one
// 16-byte (f32) or 8-byte (bf16) access where V = 4.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<bf16>(v[i]);
  }
}

// Kernel 1: the cell adjoint (module comment, 1), T the dtype of dy and
// dx.  Pixel-major: m = (sample, pixel) in row-major order, a thread V
// consecutive channels of `it` pixels (j0 = V * channel group).  A block
// is kThreads = nr x jt threads, jt channel groups (a power of two, so a
// warp reads one contiguous span of each stack) by nr pixels, and covers
// nr * it consecutive m; its db partial goes to row blockIdx.x.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
convlstm_bwd_step_kernel(const float* __restrict__ gates, long long g_bstride,
                         const float* __restrict__ c_prev, long long cp_bstride,
                         const T* __restrict__ dy, long long dy_bstride,
                         const float* __restrict__ dh, float* __restrict__ dc,
                         T* __restrict__ dx, long long dx_bstride, float* __restrict__ dbpart,
                         int M, int HW, int f, int jt, int it) {
  __shared__ float red[4 * V][kThreads];
  const int nr = kThreads / jt, c = threadIdx.x % jt, r = threadIdx.x / jt;
  const int j0 = (blockIdx.y * jt + c) * V;
  const int f4 = 4 * f;
  float dbp[4][V];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int v = 0; v < V; ++v) dbp[g][v] = 0.0f;
  for (int k = 0; k < it; ++k) {
    const int m = (blockIdx.x * it + k) * nr + r;
    if (j0 >= f || m >= M) break;
    const int b = m / HW, pix = m - b * HW;
    const long long s = (long long)m * f + j0;
    float cp[V], dyv[V], dhv[V], dcv[V];
    load_vec<V>(c_prev + b * cp_bstride + (long long)pix * f + j0, cp);
    load_vec<V>(dy + b * dy_bstride + (long long)pix * f + j0, dyv);
    load_vec<V>(dh + s, dhv);
    load_vec<V>(dc + s, dcv);
    const float* zp = gates + b * g_bstride + (long long)pix * f4 + 4 * j0;
    float dz[4][V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float4 z = *reinterpret_cast<const float4*>(zp + 4 * v);
      const float i = sigmoid(z.x), fg = sigmoid(z.y), gg = tanhf(z.z), o = sigmoid(z.w);
      const float tc = tanhf(fg * cp[v] + i * gg);
      const float dhs = dhv[v] + dyv[v];
      const float dcs = dcv[v] + dhs * o * (1.0f - tc * tc);
      dz[0][v] = dcs * gg * i * (1.0f - i);
      dz[1][v] = dcs * cp[v] * fg * (1.0f - fg);
      dz[2][v] = dcs * i * (1.0f - gg * gg);
      dz[3][v] = dhs * tc * o * (1.0f - o);
      dcv[v] = dcs * fg;
    }
    T* dxp = dx + b * dx_bstride + (long long)pix * f4 + j0;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      store_vec<V>(dxp + g * f, dz[g]);
#pragma unroll
      for (int v = 0; v < V; ++v) dbp[g][v] += dz[g][v];
    }
    store_vec<V>(dc + s, dcv);
  }

  // db: each channel's sum over the block's pixels in a fixed order.
  // Where jt < 32 a warp holds 32 / jt pixels of each channel: a fixed
  // butterfly over them first, so the sums to finish are the warps'.
  const int stride = jt < 32 ? 32 : jt;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float x = dbp[g][v];
      for (int o = jt; o < 32; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
      red[g * V + v][threadIdx.x] = x;
    }
  __syncthreads();
  for (int q = threadIdx.x; q < 4 * V * jt; q += kThreads) {
    const int e = q / jt, cq = q % jt, j = (blockIdx.y * jt + cq) * V + e % V;
    if (j >= f) continue;
    float sum = 0.0f;
    for (int w = 0; w < kThreads / stride; ++w) sum += red[e][w * stride + cq];
    dbpart[(long long)blockIdx.x * f4 + (e / V) * f + j] += sum;
  }
}

// dh[b, y, x, ci] = sum_{ky,kx,n} cdt(dz)[b, y+lo_h-ky, x+lo_w-kx, n] * cdt(rk)[ky,kx,ci,n]
// (zero outside the frame).  rkT4 is cdt(rk) as f32, [kh, kw, 4f/4, f, 4]:
// one 16-byte load holds four consecutive n of one ci.  The dz tile is
// staged nc channels at a time, [tile_h+kh-1][tile_w+kw-1][nc], its row
// r holding frame row ty0 - (kh-1-lo_h) + r.
template <int kPix>
__global__ void __launch_bounds__(kThreads)
convlstm_bwd_dh_kernel(const float* __restrict__ dx, long long dx_bstride,
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
  const float* dxb = dx + b * dx_bstride;

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
        v = dxb[((long long)gy * W + gx) * f4 + n0 + cc];
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

// Recurrent dropout: dh[b, y, x, ci] = sum_g mask_g[b, y, x, ci] * dhm_g,
// dhm_g the transposed conv over gate g's channels n = g*f .. g*f+f-1
// alone.  The gates are walked in order, each in chunks of nc channels;
// rkT4 as above, read a weight at a time.  mask [B, H, W, 4f].
template <int kPix>
__global__ void __launch_bounds__(kThreads)
convlstm_bwd_dh_masked_kernel(const float* __restrict__ dx, long long dx_bstride,
                              const float4* __restrict__ rkT4, const float* __restrict__ mask,
                              float* __restrict__ dh, int H, int W, int f, int kh, int kw, int nc,
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
  const float* dxb = dx + b * dx_bstride;
  const float* rkT = reinterpret_cast<const float*>(rkT4);

  int off[kPix];
  bool in[kPix];
  long long pixel[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = p * nruns + threadIdx.y;
    off[p] = q < tile_h * tile_w ? ((q / tile_w) * sw + q % tile_w) * nc : 0;
    const int gy = ty0 + q / tile_w, gx = tx0 + q % tile_w;
    in[p] = valid && q < tile_h * tile_w && gy < H && gx < W;
    pixel[p] = ((long long)b * H + gy) * W + gx;
  }
  float out[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) out[p] = 0.0f;

  for (int g = 0; g < 4; ++g) {
    float acc[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) acc[p] = 0.0f;
    for (int c0 = 0; c0 < f; c0 += nc) {
      const int ncur = f - c0 < nc ? f - c0 : nc;
      const int n0 = g * f + c0;
      for (int idx = tid; idx < n_rows * ncur; idx += nthreads) {
        const int cc = idx % ncur;
        const int r = idx / ncur;
        const int gy = ty0 - before_h + r / sw;
        const int gx = tx0 - before_w + r % sw;
        float v = 0.0f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = dxb[((long long)gy * W + gx) * f4 + n0 + cc];
        dzs[r * nc + cc] = v;
      }
      __syncthreads();
      if (valid) {
        for (int ky = 0; ky < kh; ++ky) {
          for (int kx = 0; kx < kw; ++kx) {
            const float* base = dzs + ((kh - 1 - ky) * sw + (kw - 1 - kx)) * nc;
            const long long tap = (long long)(ky * kw + kx) * (f4 / 4);
            for (int cc = 0; cc < ncur; ++cc) {
              const int n = n0 + cc;
              const float wv = __ldg(rkT + ((tap + n / 4) * f + ci) * 4 + n % 4);
#pragma unroll
              for (int p = 0; p < kPix; ++p) acc[p] = fmaf(base[off[p] + cc], wv, acc[p]);
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < kPix; ++p)
      if (in[p]) out[p] = fmaf(mask[pixel[p] * f4 + g * f + ci], acc[p], out[p]);
  }

#pragma unroll
  for (int p = 0; p < kPix; ++p)
    if (in[p]) dh[pixel[p] * f + ci] = out[p];
}

constexpr int kTileM = 64, kTileN = 64, kTileK = 16;

// part[s][m][n] = sum over the pixels p of split s of A[p][m] * dx[p][n],
// A[p][m] = cdt(h_{t-1})[b, y+ky-lo_h, x+kx-lo_w, ci] (zero outside the
// frame), m = (ky*kw + kx)*f + ci, p = ((b*T + t)*H + y)*W + x.
// h_{t-1} is y[b, t-1] for t >= 1 and h0c[b] (cdt(h0)) at t = 0.
// ngates = 4 (recurrent dropout): y and h0c are the hm stack and hm_{-1}
// with 4f channels, and the grid's y runs over the gates too: the gate-g
// columns of drk read hm_g (channels g*f ..) and dz_g (columns g*f ..).
__global__ void __launch_bounds__(256)
recurrent_wgrad_kernel(const float* __restrict__ y, const float* __restrict__ h0c,
                       const float* __restrict__ dx, float* __restrict__ part,
                       int T_, int H, int W, int f, int kh, int kw, int ngates,
                       long long P, long long chunk) {
  __shared__ __align__(16) float As[kTileK][kTileM];
  __shared__ __align__(16) float Bs[kTileK][kTileN];

  const int M = kh * kw * f, N = 4 * f, Ng = N / ngates, lda = ngates == 4 ? N : f;
  const int tiles_n = (Ng + kTileN - 1) / kTileN, gate = blockIdx.y / tiles_n;
  const int m0 = blockIdx.x * kTileM, n0 = (blockIdx.y % tiles_n) * kTileN;
  const int a_off = ngates == 4 ? gate * f : 0, b_off = gate * Ng;
  const long long p_begin = (long long)blockIdx.z * chunk;
  const long long p_end = p_begin + chunk < P ? p_begin + chunk : P;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // Each thread loads the same column (m or n) of every tile: rows
  // tid/64 + 4q, q = 0..3.
  const int mm = tid % kTileM, nn = tid % kTileN, kk0 = tid / kTileM;
  const int m = m0 + mm, n = n0 + nn;
  const bool m_ok = m < M, n_ok = n < Ng;
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
            av = t == 0 ? h0c[(bb * H * W + pix) * lda + a_off + ci]
                        : y[((bb * T_ + t - 1) * H * W + pix) * lda + a_off + ci];
          }
        }
        if (n_ok) bv = dx[p * N + b_off + n];
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
      if (no < Ng) out[(long long)mo * N + b_off + no] = acc[r][c];
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

// ---------------------------------------------------------------------------
// bf16, tensor cores.

// Kernel 2: dh[m][ci] = sum_k A[m][k] wT[k][ci], A the transposed conv's
// gather of dx_t (C = 4f, sgn = -1, o = +lo: the flipped pads).  With
// mask [B, H, W, 4f] (recurrent dropout), wT has the gate-quad columns of
// the gate GEMM, 16*ceil(f/4) of them, column (g, ci) holding gate g's
// rows alone, and dh[m][ci] = sum_g mask[m][g*f + ci] * (A wT)[m][(g, ci)].
template <class Cfg, bool kVec>
__global__ void __launch_bounds__(Cfg::kThreads)
convlstm_bwd_dh_tc_kernel(const bf16* __restrict__ dx, long long dx_bstride,
                          const bf16* __restrict__ wT, int npad, const float* __restrict__ mask,
                          float* __restrict__ dh, int B, int H, int W, int f, int kh, int kw) {
  extern __shared__ __align__(16) unsigned char dh_tc_smem[];
  const int M = B * H * W, K = kh * kw * 4 * f;
  const int m0 = blockIdx.x * Cfg::BM, n0 = blockIdx.y * Cfg::BN;
  int kt0, kt1;
  split_range((K + Cfg::BK - 1) / Cfg::BK, blockIdx.z, gridDim.z, kt0, kt1);
  ConvGatherA<Cfg, kVec> load_a(dx, dx_bstride, H, W, 4 * f, kw, K, -1, (kh - 1) / 2,
                                (kw - 1) / 2, m0, M, kt0);
  const DenseB<Cfg> load_b{wT, K, npad, n0};
  float acc[2][Cfg::NI][4];
  tc_gemm<Cfg, false>(acc, reinterpret_cast<bf16*>(dh_tc_smem), kt0, kt1, load_a, load_b);
  if (!cluster_sum<Cfg>(acc, dh_tc_smem, gridDim.z)) return;
  if (mask != nullptr) {
    for_each_gate_quad<Cfg>(acc, m0, n0, [&](int m, int ci, int, const float(&a)[4]) {
      if (m >= M || ci >= f) return;
      const float* mp = mask + (long long)m * 4 * f + ci;
      float v = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) v = fmaf(mp[g * f], a[g], v);
      dh[(long long)m * f + ci] = v;
    });
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % Cfg::WM, wn = warp / Cfg::WM;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 32 + mi * 16 + (r >> 1) * 8 + (lane >> 2);
        const int n = n0 + wn * 8 * Cfg::NI + ni * 8 + 2 * (lane & 3) + (r & 1);
        if (m < M && n < f) dh[(long long)m * f + n] = acc[mi][ni][r];
      }
}

// The drk GEMM's A, stored transposed ([BK pixels][BM]): A^T[p][m] =
// cdt(h_{t-1})[b, y+ky-lo_h, x+kx-lo_w, ci], m = (ky*kw + kx)*f + ci,
// p = ((b*T + t)*H + y)*W + x, over pixels [p_begin, p_end); h_{t-1} is
// y[b, t-1] for t >= 1 and h0c[b] at t = 0.  A thread copies the same
// pixel row of every k-tile, kCols 8-wide columns of it: it keeps its
// columns' taps and walks its pixel (b, t, y, x) forward by BK a k-tile,
// without divisions.  kVec: f is a multiple of 8, so 8 consecutive m are
// 8 channels of one tap, one cp.async; else element by element.
template <class Cfg, bool kVec>
struct WgradA {
  static constexpr int kTpr = Cfg::kThreads / Cfg::BK;  // threads a pixel row
  static constexpr int kCols = Cfg::BM / 8 / kTpr;
  static_assert(Cfg::kThreads % Cfg::BK == 0 && (Cfg::BM / 8) % kTpr == 0, "wgrad A layout");
  const bf16 *y, *h0c;
  int T, H, W, f, ld, kh, kw, M, m_first;  // ld: the pixel stride of y and h0c
  int p, p_end, b, t, py, px;  // this thread's pixel in the next k-tile
  int dy[kCols], dx[kCols], ci[kCols];

  __device__ __forceinline__ WgradA(const bf16* y_, const bf16* h0c_, int T_, int H_, int W_,
                                    int f_, int ld_, int kh_, int kw_, int m0, int p_begin,
                                    int p_end_)
      : y(y_), h0c(h0c_), T(T_), H(H_), W(W_), f(f_), ld(ld_), kh(kh_), kw(kw_),
        M(kh_ * kw_ * f_), p_end(p_end_) {
    m_first = m0 + (int)(threadIdx.x % kTpr) * 8;
    p = p_begin + (int)threadIdx.x / kTpr;
    px = p % W;
    const int r = p / W;
    py = r % H;
    t = (r / H) % T;
    b = r / H / T;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int m = m_first + i * kTpr * 8;
      const int tap = m / f;
      ci[i] = m < M ? m - tap * f : -1;
      dy[i] = tap / kw - (kh - 1) / 2;
      dx[i] = tap % kw - (kw - 1) / 2;
    }
  }

  // h_{t-1} at this thread's pixel shifted by (sy, sx), channel c: false
  // outside the frame.
  __device__ __forceinline__ bool at(int sy, int sx, int c, const bf16*& src,
                                     long long& off) const {
    const int yy = py + sy, xx = px + sx;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return false;
    const long long pix = (long long)yy * W + xx;
    src = t == 0 ? h0c : y;
    off = (t == 0 ? (long long)b * H * W + pix : ((long long)b * T + t - 1) * H * W + pix) * ld + c;
    return true;
  }

  __device__ __forceinline__ void operator()(bf16* dst) {
    const int row = (int)threadIdx.x / kTpr;
    const bool p_ok = p < p_end;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      bf16* d = dst + row * Cfg::AT_LD + ((int)(threadIdx.x % kTpr) + i * kTpr) * 8;
      const bf16* src = y;
      long long off = 0;
      if constexpr (kVec) {
        const bool ok = p_ok && ci[i] >= 0 && at(dy[i], dx[i], ci[i], src, off);
        cp_async16(d, ok ? src + off : y, ok);
      } else {
        for (int e = 0; e < 8; ++e) {
          const int m = m_first + i * kTpr * 8 + e, tap = m / f;
          const bool ok = p_ok && m < M &&
                          at(tap / kw - (kh - 1) / 2, tap % kw - (kw - 1) / 2, m - tap * f, src, off);
          d[e] = ok ? src[off] : __float2bfloat16(0.0f);
        }
      }
    }
    p += Cfg::BK;
    px += Cfg::BK;
    while (px >= W) {
      px -= W;
      if (++py == H) {
        py = 0;
        if (++t == T) t = 0, ++b;
      }
    }
  }
};

// The drk GEMM's B: dx[p][n0 .. n0+BN], [BK pixels][BN], each thread the
// same pixel row of every k-tile.
template <class Cfg, bool kVec>
struct WgradB {
  static constexpr int kTpr = Cfg::kThreads / Cfg::BK, kCols = Cfg::BN / 8 / kTpr;
  static_assert((Cfg::BN / 8) % kTpr == 0, "wgrad B layout");
  const bf16* dx;
  int N, ld, n0, p_begin, p_end;  // columns n < N of rows ld apart
  __device__ __forceinline__ void operator()(int kt, bf16* dst) const {
    const int row = (int)threadIdx.x / kTpr;
    const int p = p_begin + kt * Cfg::BK + row;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int cc = (int)(threadIdx.x % kTpr) + i * kTpr, n = n0 + cc * 8;
      bf16* d = dst + row * Cfg::B_LD + cc * 8;
      if constexpr (kVec) {
        const bool ok = p < p_end && n < N;
        cp_async16(d, ok ? dx + (long long)p * ld + n : dx, ok);
      } else {
        for (int e = 0; e < 8; ++e)
          d[e] = p < p_end && n + e < N ? dx[(long long)p * ld + n + e] : __float2bfloat16(0.0f);
      }
    }
  }
};

// part[s][m][n] = sum over the pixels of split s of A[p][m] * dx[p][n].
// ngates = 4 (recurrent dropout): y and h0c are the hm stack and hm_{-1}
// (4f channels), and grid y covers each gate's columns apart: gate g's
// from hm_g and dx's gate-g columns.
template <class Cfg, bool kVec>
__global__ void __launch_bounds__(Cfg::kThreads)
recurrent_wgrad_tc_kernel(const bf16* __restrict__ y, const bf16* __restrict__ h0c,
                          const bf16* __restrict__ dx, float* __restrict__ part,
                          int T_, int H, int W, int f, int kh, int kw, int ngates, long long P,
                          long long chunk) {
  extern __shared__ __align__(16) unsigned char wgrad_tc_smem[];
  const int M = kh * kw * f, N = 4 * f, Ng = N / ngates, lda = ngates == 4 ? N : f;
  const int tiles_n = (Ng + Cfg::BN - 1) / Cfg::BN, gate = blockIdx.y / tiles_n;
  const int a_off = ngates == 4 ? gate * f : 0, b_off = gate * Ng;
  const int m0 = blockIdx.x * Cfg::BM, n0 = (blockIdx.y % tiles_n) * Cfg::BN;
  const int p_begin = (int)(blockIdx.z * chunk);
  const int p_end = (int)(p_begin + chunk < P ? p_begin + chunk : P);
  const int nk = p_end > p_begin ? (p_end - p_begin + Cfg::BK - 1) / Cfg::BK : 0;
  WgradA<Cfg, kVec> load_a(y + a_off, h0c + a_off, T_, H, W, f, lda, kh, kw, m0, p_begin, p_end);
  const WgradB<Cfg, kVec> load_b{dx + b_off, Ng, N, n0, p_begin, p_end};
  float acc[2][Cfg::NI][4];
  tc_gemm<Cfg, true>(acc, reinterpret_cast<bf16*>(wgrad_tc_smem), 0, nk, load_a, load_b);
  float* out = part + (long long)blockIdx.z * M * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % Cfg::WM, wn = warp / Cfg::WM;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 32 + mi * 16 + (r >> 1) * 8 + (lane >> 2);
        const int n = n0 + wn * 8 * Cfg::NI + ni * 8 + 2 * (lane & 3) + (r & 1);
        if (m < M && n < Ng) out[(long long)m * N + b_off + n] = acc[mi][ni][r];
      }
}

// The dh GEMM's padded N: f columns, or the four gates' quads with masks.
inline int dh_npad(int f, bool masked) { return masked ? 16 * ((f + 3) / 4) : 8 * ((f + 7) / 8); }

template <class Cfg, bool kVec>
cudaError_t launch_dh_tc(const void* dx, long long dx_bstride, const void* wT, const void* mask,
                         void* dh, int B, int H, int W, int f, int kh, int kw,
                         cudaStream_t stream) {
  const int npad = dh_npad(f, mask != nullptr);
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + Cfg::BM - 1) / Cfg::BM), (npad + Cfg::BN - 1) / Cfg::BN);
  const int split = pick_split(grid.x * grid.y, (kh * kw * 4 * f + Cfg::BK - 1) / Cfg::BK);
  return launch_split<Cfg>(convlstm_bwd_dh_tc_kernel<Cfg, kVec>, grid, split, stream,
                           static_cast<const bf16*>(dx), dx_bstride, static_cast<const bf16*>(wT),
                           npad, static_cast<const float*>(mask), static_cast<float*>(dh), B, H,
                           W, f, kh, kw);
}

cudaError_t dh_tc(const void* dx, long long dx_bstride, const void* wT, const void* mask, void* dh,
                  int B, int H, int W, int f, int kh, int kw, cudaStream_t s) {
#define KCCOT_DH_TC(CFG, VEC) \
  launch_dh_tc<CFG, VEC>(dx, dx_bstride, wT, mask, dh, B, H, W, f, kh, kw, s)
  if (f % 2 != 0) return KCCOT_DH_TC(Cfg64x64, false);
  if (!aligned16(dx) || dx_bstride % 8 != 0) return cudaErrorMisalignedAddress;
  // with masks N >= 16, so never the 128x8 tile, whose one n-tile a warp
  // cannot hold a gate quad
  switch (pick_shape((long long)B * H * W, dh_npad(f, mask != nullptr))) {
    case k128x64: return KCCOT_DH_TC(Cfg128x64, true);
    case k64x64: return KCCOT_DH_TC(Cfg64x64, true);
    case k32x64: return KCCOT_DH_TC(Cfg32x64, true);
    case k128x32: return KCCOT_DH_TC(Cfg128x32, true);
    case k128x16: return KCCOT_DH_TC(Cfg128x16, true);
    default: return KCCOT_DH_TC(Cfg128x8, true);
  }
#undef KCCOT_DH_TC
}

// The drk GEMM's tile: 128 x 64, or 128 x 32 when a GEMM's N (4f, or f
// a gate with masks) is at most 32.
inline TcShape wgrad_shape(int f, int ngates) {
  if (f % 8 != 0) return k64x64;
  return 4 * f / ngates <= 32 ? k128x32 : k128x64;
}

template <class Cfg, bool kVec>
cudaError_t launch_wgrad_tc(const void* y, const void* h0c, const void* dx, void* part,
                            int splits, long long chunk, int T_, int H, int W, int f, int kh,
                            int kw, int ngates, long long P, cudaStream_t s) {
  const int M = kh * kw * f, Ng = 4 * f / ngates;
  const dim3 grid((M + Cfg::BM - 1) / Cfg::BM, ngates * ((Ng + Cfg::BN - 1) / Cfg::BN), splits);
  const auto kernel = recurrent_wgrad_tc_kernel<Cfg, kVec>;
  const cudaError_t err = allow_smem((const void*)kernel, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, s>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(h0c), static_cast<const bf16*>(dx),
      static_cast<float*>(part), T_, H, W, f, kh, kw, ngates, P, chunk);
  return cudaGetLastError();
}

template <int kPix>
cudaError_t launch_dh(const void* dx, long long dx_bstride, const void* rkT4, const void* mask,
                      void* dh, int B, int H, int W, int f, int kh, int kw, cudaStream_t stream) {
  const Tile t = make_tile(H, W, f, kPix);
  const dim3 block(t.jt, t.nruns);
  const dim3 grid(t.tiles_w * t.tiles_h, (f + t.jt - 1) / t.jt, B);
  if (mask != nullptr) {
    const int nc = f < 64 ? f : 64;
    const size_t smem = (size_t)(t.tile_h + kh - 1) * (t.tile_w + kw - 1) * nc * sizeof(float);
    const cudaError_t err = allow_smem((const void*)convlstm_bwd_dh_masked_kernel<kPix>, smem);
    if (err != cudaSuccess) return err;
    convlstm_bwd_dh_masked_kernel<kPix><<<grid, block, smem, stream>>>(
        static_cast<const float*>(dx), dx_bstride, static_cast<const float4*>(rkT4),
        static_cast<const float*>(mask), static_cast<float*>(dh), H, W, f, kh, kw, nc, t.tile_h,
        t.tile_w, t.tiles_w);
    return cudaGetLastError();
  }
  const int nc = 4 * f < 64 ? 4 * f : 64;
  const size_t smem = (size_t)(t.tile_h + kh - 1) * (t.tile_w + kw - 1) * nc * sizeof(float);
  const cudaError_t err = allow_smem((const void*)convlstm_bwd_dh_kernel<kPix>, smem);
  if (err != cudaSuccess) return err;
  convlstm_bwd_dh_kernel<kPix><<<grid, block, smem, stream>>>(
      static_cast<const float*>(dx), dx_bstride, static_cast<const float4*>(rkT4),
      static_cast<float*>(dh), H, W, f, kh, kw, nc, t.tile_h, t.tile_w, t.tiles_w);
  return cudaGetLastError();
}

// The adjoint's grid at this shape: V = 4 channels a thread where f
// allows, jt channel groups a block (a power of two, at most 128), `it`
// pixels a thread, doubled while about 4 blocks an SM (132) stay in
// flight; a block a db row.
struct StepGrid {
  int v, jt, it;
  dim3 grid;
};

inline StepGrid step_grid(int B, int H, int W, int f) {
  StepGrid sg;
  sg.v = f % 4 == 0 ? 4 : 1;
  const int groups = f / sg.v;
  sg.jt = 1;
  while (sg.jt < groups && sg.jt < 128) sg.jt *= 2;
  const long long M = (long long)B * H * W, nr = kThreads / sg.jt;
  const unsigned ty = (groups + sg.jt - 1) / sg.jt;
  auto rows = [&](int it) { return (unsigned)((M + nr * it - 1) / (nr * it)); };
  sg.it = 1;
  while (sg.it < 8 && (long long)rows(2 * sg.it) * ty >= 4 * 132) sg.it *= 2;
  sg.grid = dim3(rows(sg.it), ty);
  return sg;
}

template <typename T, int V>
cudaError_t launch_step(const StepGrid& sg, const void* gates, long long g_bstride,
                        const void* c_prev, long long cp_bstride, const void* dy,
                        long long dy_bstride, const void* dh, void* dc, void* dx,
                        long long dx_bstride, void* dbpart, int B, int H, int W, int f,
                        cudaStream_t s) {
  convlstm_bwd_step_kernel<T, V><<<sg.grid, kThreads, 0, s>>>(
      static_cast<const float*>(gates), g_bstride, static_cast<const float*>(c_prev), cp_bstride,
      static_cast<const T*>(dy), dy_bstride, static_cast<const float*>(dh),
      static_cast<float*>(dc), static_cast<T*>(dx), dx_bstride, static_cast<float*>(dbpart),
      B * H * W, H * W, f, sg.jt, sg.it);
  return cudaGetLastError();
}

template <typename T>
cudaError_t step(const void* gates, long long g_bstride, const void* c_prev, long long cp_bstride,
                 const void* dy, long long dy_bstride, const void* dh, void* dc, void* dx,
                 long long dx_bstride, void* dbpart, int B, int H, int W, int f, cudaStream_t s) {
  const StepGrid sg = step_grid(B, H, W, f);
  if (sg.v == 1)
    return launch_step<T, 1>(sg, gates, g_bstride, c_prev, cp_bstride, dy, dy_bstride, dh, dc,
                             dx, dx_bstride, dbpart, B, H, W, f, s);
  // 4 channels a thread: every stack's rows and strides keep V-element
  // accesses aligned to their width
  const size_t w = 4 * sizeof(T);
  if (!aligned16(c_prev) || !aligned16(dh) || !aligned16(dc) || cp_bstride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % w != 0 || reinterpret_cast<uintptr_t>(dx) % w != 0 ||
      dy_bstride % 4 != 0 || dx_bstride % 4 != 0)
    return cudaErrorMisalignedAddress;
  return launch_step<T, 4>(sg, gates, g_bstride, c_prev, cp_bstride, dy, dy_bstride, dh, dc, dx,
                           dx_bstride, dbpart, B, H, W, f, s);
}

cudaError_t dh_step(const void* dx, long long dx_bstride, const void* rkT4, const void* mask,
                    void* dh, int B, int H, int W, int f, int kh, int kw, cudaStream_t s) {
  switch (pixels_per_thread(H, W)) {
    case 8: return launch_dh<8>(dx, dx_bstride, rkT4, mask, dh, B, H, W, f, kh, kw, s);
    case 4: return launch_dh<4>(dx, dx_bstride, rkT4, mask, dh, B, H, W, f, kh, kw, s);
    default: return launch_dh<2>(dx, dx_bstride, rkT4, mask, dh, B, H, W, f, kh, kw, s);
  }
}

cudaError_t wgrad(int dtype, const void* y, const void* h0c, const void* dx, void* part,
                  int splits, long long chunk, const void* dbpart, int rows, void* drk,
                  void* dbias, int B, int T_, int H, int W, int f, int kh, int kw, int ngates,
                  cudaStream_t s) {
  const int M = kh * kw * f, N = 4 * f, Ng = N / ngates;
  const long long P = (long long)B * T_ * H * W;
  if (splits <= 0 || chunk <= 0 || (long long)splits * chunk < P) return cudaErrorInvalidValue;
  if (dtype == 1 && (long long)splits * chunk >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    const dim3 grid((M + kTileM - 1) / kTileM, ngates * ((Ng + kTileN - 1) / kTileN), splits);
    recurrent_wgrad_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(h0c),
        static_cast<const float*>(dx), static_cast<float*>(part), T_, H, W, f, kh, kw, ngates, P,
        chunk);
    err = cudaGetLastError();
  } else {
#define KCCOT_WGRAD_TC(CFG, VEC) \
  launch_wgrad_tc<CFG, VEC>(y, h0c, dx, part, splits, chunk, T_, H, W, f, kh, kw, ngates, P, s)
    if (f % 8 != 0) {
      err = KCCOT_WGRAD_TC(Cfg64x64, false);
    } else if (!aligned16(y) || !aligned16(h0c) || !aligned16(dx)) {
      err = cudaErrorMisalignedAddress;
    } else {
      err = wgrad_shape(f, ngates) == k128x32 ? KCCOT_WGRAD_TC(Cfg128x32, true)
                                              : KCCOT_WGRAD_TC(Cfg128x64, true);
    }
#undef KCCOT_WGRAD_TC
  }
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

// Rows of the db partial that kccot_convlstm_bwd_step accumulates into,
// [rows, 4f] float32, zeroed by the caller: one per block of the
// adjoint's grid (its x extent), either dtype.
extern "C" int kccot_convlstm_bwd_rows(int B, int H, int W, int f) {
  if (B <= 0 || H <= 0 || W <= 0 || f <= 0) return 0;
  return (int)step_grid(B, H, W, f).grid.x;
}

// Output tiles of the weight-gradient GEMM at M = kh*kw*f, N = 4f (the
// wrapper splits K so that tiles x splits fill the card); masked: the
// recurrent-dropout mode, four GEMMs of N = f.
extern "C" int kccot_recurrent_wgrad_tiles(int dtype, int M, int f, int masked) {
  if (M <= 0 || f <= 0) return 0;
  const int ngates = masked ? 4 : 1, Ng = 4 * f / ngates;
  if (dtype == 0) return ((M + kTileM - 1) / kTileM) * ngates * ((Ng + kTileN - 1) / kTileN);
  const TcShape sh = wgrad_shape(f, ngates);
  const int bm = shape_bm(sh), bn = sh == k128x32 ? 32 : 64;
  return ngates * tc_blocks(M, Ng, bm, bn);
}

// Step t of the reverse loop, kernel 1 (module comment).  dtype 0 =
// float32, 1 = bfloat16: the dtype of dy and dx.  gates points at step t
// of the forward's f32 gate stack [B, T, H, W, 4f] (gate g of channel j
// at 4j + g; 16-byte aligned, g_bstride a multiple of 4), dy and dx at
// step t of theirs ([B, T, H, W, f] and [B, T, H, W, 4f]), c_prev at
// c_stack[:, t-1] or at c0; each with its per-sample stride in elements.
// dh (read) and dc (read and written) are the f32 carries [B, H, W, f].
// Where f is a multiple of 4 every pointer and stride must keep 4-element
// accesses aligned (16 bytes for the f32 ones, 4 elements for dy and dx).
// The same call serves recurrent dropout: the masks enter only the convs.
extern "C" int kccot_convlstm_bwd_step(int dtype, const void* gates, long long g_bstride,
                                       const void* c_prev, long long cp_bstride, const void* dy,
                                       long long dy_bstride, const void* dh, void* dc, void* dx,
                                       long long dx_bstride, void* dbpart, int B, int H, int W,
                                       int f, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || f <= 0) return cudaErrorInvalidValue;
  if (!aligned16(gates) || g_bstride % 4 != 0) return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return step<float>(gates, g_bstride, c_prev, cp_bstride, dy, dy_bstride, dh, dc, dx,
                       dx_bstride, dbpart, B, H, W, f, s);
  if (dtype == 1)
    return step<bf16>(gates, g_bstride, c_prev, cp_bstride, dy, dy_bstride, dh, dc, dx,
                      dx_bstride, dbpart, B, H, W, f, s);
  return cudaErrorInvalidValue;
}

// Step t, kernel 2: dh [B, H, W, f] float32 from dx at step t (per-sample
// stride dx_bstride) and w: float32, rkT4 = cdt(rk) as float32,
// [kh, kw, 4f/4, f, 4]; bfloat16 (tensor cores), wT = cdt(rk) transposed,
// [kh*kw*4f, 8*ceil(f/8)] (models/cuda_convlstm.py::_pack_dh).  With
// mask ([B, H, W, 4f] float32, recurrent dropout) the sum of the four
// gates' transposed convs, each times its mask; bfloat16 then takes wT
// with gate-quad columns, [kh*kw*4f, 16*ceil(f/4)]
// (models/cuda_convlstm.py::_pack_dh_gates), float32 rkT4 as without.
extern "C" int kccot_convlstm_bwd_dh(int dtype, const void* dx, long long dx_bstride,
                                     const void* w, const void* mask, void* dh, int B, int H,
                                     int W, int f, int kh, int kw, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || f <= 0 || kh <= 0 || kw <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dh_step(dx, dx_bstride, w, mask, dh, B, H, W, f, kh, kw, s);
  if (dtype == 1) return dh_tc(dx, dx_bstride, w, mask, dh, B, H, W, f, kh, kw, s);
  return cudaErrorInvalidValue;
}

// After the loop: drk [kh, kw, f, 4f] and db [4f], float32, from the y
// stack [B, T, H, W, f], h0c = cdt(h0) [B, H, W, f], the dx stack
// [B, T, H, W, 4f] (all of the compute dtype), and the db partial
// [rows, 4f].  part is float32 scratch [splits, kh*kw*f, 4f]; split s
// covers pixels [s*chunk, (s+1)*chunk) of the B*T*H*W.  Two launches:
// the GEMM (CUDA cores for float32, tensor cores for bfloat16), then the
// fixed-order finalize.  masked (recurrent dropout): y and h0c are the
// hm stack [B, T, H, W, 4f] and hm_{-1} [B, H, W, 4f], and gate g's
// columns of drk sum hm_g against dz_g alone.
extern "C" int kccot_recurrent_wgrad(int dtype, const void* y, const void* h0c, const void* dx,
                                     void* part, int splits, long long chunk, const void* dbpart,
                                     int rows, void* drk, void* dbias, int B, int T, int H, int W,
                                     int f, int kh, int kw, int masked, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || f <= 0 || kh <= 0 || kw <= 0 || rows < 0)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  return wgrad(dtype, y, h0c, dx, part, splits, chunk, dbpart, rows, drk, dbias, B, T, H, W, f,
               kh, kw, masked ? 4 : 1, static_cast<cudaStream_t>(stream));
}
