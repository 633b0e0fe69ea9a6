// ConvLSTM forward, one time step, for Hopper (sm_90a).
//
// Replaces kccotgan_tpu/models/pallas_convlstm.py::_fwd_kernel, the TPU
// kernel that runs all T steps of a layer in one pallas_call with (h, c)
// resident in VMEM.  Here the wrapper (models/cuda_convlstm.py) launches
// this kernel once per step, with the carries in device memory: the
// encoder1 carry alone is 4 MiB of f32 at B=32, far beyond one SM's
// shared memory, so the step boundary is a launch boundary.
//
// What it computes, for every (sample, pixel, channel j):
//   rconv_g = sum_{ky,kx,ci} cdt(h_{t-1})[y+ky-lo, x+kx-lo, ci] * cdt(rk)[ky,kx,ci,g*f+j]
//             accumulated in f32, rounded once to cdt and back to f32
//   z_g     = (f32(x_t[g*f+j]) + bias[g*f+j]) + rconv_g        g in [i, f, c, o]
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_c)
//   h_t = sigmoid(z_o) * tanh(c_t);  y_t = cdt(h_t)
// with TF 'SAME' stride-1 padding (lo = (k-1)/2, the odd pad high).
// Under autograd it also writes what the backward reads: c_t into the f32
// c stack (the TPU kernel's cs_ref) and the four pre-activations z_g into
// the f32 gate stack [B, T, H, W, 4f], those of channel j side by side at
// 4j + g, one 16-byte store from the thread that holds them.  The backward
// then runs the cell adjoint on them instead of the recurrent conv again
// (convlstm_bwd.cu).  A forward-only call (serving, eval) writes neither.
//
// What bounds it: the recurrent conv, an implicit GEMM with M = B*H*W,
// N = 4f, K = kh*kw*f (2*M*N*K FLOP a step), and, once that runs on the
// tensor cores, the latency of one step's launch and K loop: the
// largest step (dec4, M = 32768, N = 128, K = 2048) is 17 GFLOP, some
// 20-40 us at the rates mma.sync reaches.  Two engines, by dtype:
// * bf16 (dtype 1): the tensor cores (convlstm_tile.cuh, tc_gemm).  A is
//   gathered from cdt(h_{t-1}) -- y[t-1], or cdt(h0) at t = 0, which the
//   wrapper rounds once -- halo included; B is cdt(rk) packed once per
//   call by the wrapper, [kh*kw*f, 16*ceil(f/4)], its columns ordered so
//   that a thread's accumulators hold the four gates of its (pixel, j)
//   and the gate math runs on them: the pre-activations go to memory only
//   as the gate stack, one 16-byte store each.  The tile is chosen per
//   layer so a launch has at least one block per SM where the shape
//   allows (enc4: 32x64 tiles, 256 blocks).
//   bf16 x bf16 products are exact in f32, so only the order of the f32
//   sums differs from the f32-FMA version.
// * f32 (dtype 0): the CUDA cores in f32 FMA, as TF32 would miss the f32
//   tolerance.  Each block stages its tile of h_{t-1}, halo included, in
//   shared memory once; each thread keeps the four gate sums of kPix
//   pixels in registers, so one 16-byte load of a weight's four gates
//   (interleaved [kh, kw, f, f, 4]) feeds 4*kPix FMAs.
// Recurrent dropout (Keras, models/layers.py::ConvLSTM2D): gate g's conv
// reads hm_g = cdt(h_{t-1} * mask_g), four masks [B, H, W, f] fixed over
// time.  The step that makes h_t also writes hm_t, gate-major [B, H, W,
// 4f] (channel g*f + j), from the f32 h and the masks; the wrapper
// rounds hm_{-1} from h0 once.  The bf16 engine then runs the gate GEMM
// over K = kh*kw*4f, A gathered from hm with 4f channels, B the wrapper's
// block-diagonal weight (gate g's columns read only hm_g's rows): four
// times the MMAs, the same kernel.  The f32 engine stages hm_g gate by
// gate (rconv_gates_masked), the FMAs of the unmasked kernel.
// wgmma, TMA and fusing the T steps into one persistent launch are later
// work.

#include "convlstm_tile.cuh"

namespace {

using namespace kccot;

template <int kPix>
__global__ void __launch_bounds__(kThreads)
convlstm_step_kernel(const float* __restrict__ x, long long x_bstride,
                     const float* __restrict__ h_prev, const float* __restrict__ c_prev,
                     const float4* __restrict__ rk4, const float* __restrict__ bias,
                     float* __restrict__ h_next, float* __restrict__ c_next,
                     float* __restrict__ y, long long y_bstride,
                     float* __restrict__ cs, long long cs_bstride,
                     float* __restrict__ gates, long long g_bstride,
                     const float* __restrict__ hm, long long hm_bstride,
                     const float* __restrict__ mask, float* __restrict__ hm_out,
                     long long hmo_bstride, int H, int W, int f, int kh, int kw,
                     int tile_h, int tile_w, int tiles_w) {
  extern __shared__ float hs[];  // [tile_h+kh-1][tile_w+kw-1][f]

  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * tile_h;
  const int tx0 = (blockIdx.x % tiles_w) * tile_w;
  const int sw = tile_w + kw - 1;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
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
  if (mask != nullptr) {
    rconv_gates_masked<kPix>(acc, hs, hm + b * hm_bstride, rk4, off, j, j < f, H, W, f, kh, kw,
                             ty0, tx0, tile_h, tile_w);
    if (j >= f) return;
  } else {
    stage_h(hs, h_prev + (long long)b * H * W * f, H, W, f, f, kh, kw, ty0, tx0, tile_h, tile_w);
    __syncthreads();
    if (j >= f) return;
    rconv_gates<kPix>(acc, hs, rk4, off, j, f, kh, kw, sw);
  }

  const int f4 = 4 * f;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int q = p * nruns + threadIdx.y;
    const int gy = ty0 + q / tile_w, gx = tx0 + q % tile_w;
    if (q >= tile_h * tile_w || gy >= H || gx >= W) continue;
    const long long pix = (long long)gy * W + gx;
    const float* xp = x + b * x_bstride + pix * f4 + j;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      z[g] = (xp[g * f] + bias[g * f + j]) + acc[p][g];
    const long long s = ((long long)b * H * W + pix) * f + j;
    const float c = sigmoid(z[1]) * c_prev[s] + sigmoid(z[0]) * tanhf(z[2]);
    const float h = sigmoid(z[3]) * tanhf(c);
    c_next[s] = c;
    h_next[s] = h;
    y[b * y_bstride + pix * f + j] = h;
    if (cs != nullptr) cs[b * cs_bstride + pix * f + j] = c;
    if (gates != nullptr)
      *reinterpret_cast<float4*>(gates + b * g_bstride + pix * f4 + 4 * j) =
          make_float4(z[0], z[1], z[2], z[3]);
    if (hm_out != nullptr) {
      const float* mp = mask + ((long long)b * H * W + pix) * f4 + j;
      float* hp = hm_out + b * hmo_bstride + pix * f4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) hp[g * f] = h * mp[g * f];
    }
  }
}

// What a step saves for the backward, each at step t of its stack with
// its per-sample stride (both null in a forward-only call): the c stack
// [B, T, H, W, f] and the gate stack [B, T, H, W, 4f], float32.
struct Saved {
  void* cs;
  long long cs_bstride;
  void* gates;
  long long g_bstride;
};

// The masked-mode operands of a step (all null without recurrent dropout):
// hm = hm_{t-1} with its per-sample stride, the masks [B, H, W, 4f] f32,
// and hm_out, where this step writes hm_t (null at the last step).
struct Masked {
  const void* hm;
  long long hm_bstride;
  const void* mask;
  void* hm_out;
  long long hmo_bstride;
};

template <int kPix>
cudaError_t launch(const void* x, long long x_bstride, const void* h_prev, const void* c_prev,
                   const void* rk4, const void* bias, void* h_next, void* c_next, void* y,
                   long long y_bstride, const Saved& sv, const Masked& mk, int B, int H, int W,
                   int f, int kh, int kw, cudaStream_t stream) {
  const Tile t = make_tile(H, W, f, kPix);
  const dim3 block(t.jt, t.nruns);
  const dim3 grid(t.tiles_w * t.tiles_h, (f + t.jt - 1) / t.jt, B);
  const size_t smem = (size_t)(t.tile_h + kh - 1) * (t.tile_w + kw - 1) * f * sizeof(float);
  const cudaError_t err = allow_smem((const void*)convlstm_step_kernel<kPix>, smem);
  if (err != cudaSuccess) return err;
  convlstm_step_kernel<kPix><<<grid, block, smem, stream>>>(
      static_cast<const float*>(x), x_bstride, static_cast<const float*>(h_prev),
      static_cast<const float*>(c_prev), static_cast<const float4*>(rk4),
      static_cast<const float*>(bias), static_cast<float*>(h_next),
      static_cast<float*>(c_next), static_cast<float*>(y), y_bstride, static_cast<float*>(sv.cs),
      sv.cs_bstride, static_cast<float*>(sv.gates), sv.g_bstride, static_cast<const float*>(mk.hm),
      mk.hm_bstride,
      static_cast<const float*>(mk.mask), static_cast<float*>(mk.hm_out), mk.hmo_bstride, H, W, f,
      kh, kw, t.tile_h, t.tile_w, t.tiles_w);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, long long x_bstride, const void* h_prev, const void* c_prev,
                     const void* rk4, const void* bias, void* h_next, void* c_next, void* y,
                     long long y_bstride, const Saved& sv, const Masked& mk, int B, int H, int W,
                     int f, int kh, int kw, cudaStream_t stream) {
#define KCCOT_FWD(PIX)                                                                           \
  launch<PIX>(x, x_bstride, h_prev, c_prev, rk4, bias, h_next, c_next, y, y_bstride, sv, mk, B, \
              H, W, f, kh, kw, stream)
  switch (pixels_per_thread(H, W)) {
    case 8: return KCCOT_FWD(8);
    case 4: return KCCOT_FWD(4);
    default: return KCCOT_FWD(2);
  }
#undef KCCOT_FWD
}

// bf16, tensor cores.  wpk is cdt(rk) as [kh*kw*f, npad] with the gate
// columns interleaved (for_each_gate_quad); hp is cdt(h_{t-1}).
template <class Cfg, bool kVec>
__global__ void __launch_bounds__(Cfg::kThreads)
convlstm_step_tc_kernel(const bf16* __restrict__ x, long long x_bstride,
                        const bf16* __restrict__ hp, long long hp_bstride,
                        const float* __restrict__ c_prev, const bf16* __restrict__ wpk, int npad,
                        const float* __restrict__ bias, float* __restrict__ h_next,
                        float* __restrict__ c_next, bf16* __restrict__ y, long long y_bstride,
                        float* __restrict__ cs, long long cs_bstride,
                        float* __restrict__ gates, long long g_bstride,
                        const float* __restrict__ mask, bf16* __restrict__ hm_out,
                        long long hmo_bstride, int B, int H, int W, int f, int cin, int kh,
                        int kw) {
  extern __shared__ __align__(16) unsigned char fwd_tc_smem[];
  const int HW = H * W, M = B * HW, K = kh * kw * cin;
  const int m0 = blockIdx.x * Cfg::BM, n0 = blockIdx.y * Cfg::BN;
  int kt0, kt1;
  split_range((K + Cfg::BK - 1) / Cfg::BK, blockIdx.z, gridDim.z, kt0, kt1);
  ConvGatherA<Cfg, kVec> load_a(hp, hp_bstride, H, W, cin, kw, K, 1, -(kh - 1) / 2,
                                -(kw - 1) / 2, m0, M, kt0);
  const DenseB<Cfg> load_b{wpk, K, npad, n0};
  float acc[2][Cfg::NI][4];
  tc_gemm<Cfg, false>(acc, reinterpret_cast<bf16*>(fwd_tc_smem), kt0, kt1, load_a, load_b);
  if (!cluster_sum<Cfg>(acc, fwd_tc_smem, gridDim.z)) return;

  const int f4 = 4 * f;
  for_each_gate_quad<Cfg>(acc, m0, n0, [&](int m, int j, int, const float(&a)[4]) {
    if (m >= M || j >= f) return;
    const int b = m / HW, pix = m - b * HW;
    const bf16* xp = x + b * x_bstride + (long long)pix * f4 + j;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      z[g] = (to_f32(xp[g * f]) + bias[g * f + j]) + round_to<bf16>(a[g]);
    const long long s = (long long)m * f + j;
    const float c = sigmoid(z[1]) * c_prev[s] + sigmoid(z[0]) * tanhf(z[2]);
    const float h = sigmoid(z[3]) * tanhf(c);
    c_next[s] = c;
    h_next[s] = h;
    y[b * y_bstride + (long long)pix * f + j] = from_f32<bf16>(h);
    if (cs != nullptr) cs[b * cs_bstride + (long long)pix * f + j] = c;
    if (gates != nullptr)
      *reinterpret_cast<float4*>(gates + b * g_bstride + (long long)pix * f4 + 4 * j) =
          make_float4(z[0], z[1], z[2], z[3]);
    if (hm_out != nullptr) {
      const float* mp = mask + (long long)m * f4 + j;
      bf16* hq = hm_out + b * hmo_bstride + (long long)pix * f4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) hq[g * f] = from_f32<bf16>(h * mp[g * f]);
    }
  });
}

template <class Cfg, bool kVec>
cudaError_t launch_tc(const void* x, long long x_bstride, const void* hp, long long hp_bstride,
                      const void* c_prev, const void* wpk, const void* bias, void* h_next,
                      void* c_next, void* y, long long y_bstride, const Saved& sv,
                      const Masked& mk, int B, int H, int W, int f, int cin, int kh, int kw,
                      cudaStream_t stream) {
  const int npad = 16 * ((f + 3) / 4);
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + Cfg::BM - 1) / Cfg::BM), (npad + Cfg::BN - 1) / Cfg::BN);
  const int split = pick_split(grid.x * grid.y, (kh * kw * cin + Cfg::BK - 1) / Cfg::BK);
  return launch_split<Cfg>(
      convlstm_step_tc_kernel<Cfg, kVec>, grid, split, stream, static_cast<const bf16*>(x),
      x_bstride, static_cast<const bf16*>(hp), hp_bstride, static_cast<const float*>(c_prev),
      static_cast<const bf16*>(wpk), npad, static_cast<const float*>(bias),
      static_cast<float*>(h_next), static_cast<float*>(c_next), static_cast<bf16*>(y), y_bstride,
      static_cast<float*>(sv.cs), sv.cs_bstride, static_cast<float*>(sv.gates), sv.g_bstride,
      static_cast<const float*>(mk.mask),
      static_cast<bf16*>(mk.hm_out), mk.hmo_bstride, B, H, W, f, cin, kh, kw);
}

// hp: cdt(h_{t-1}) with f channels, or hm_{t-1} with 4f under recurrent
// dropout (then wpk is the block-diagonal weight, [kh*kw*4f, npad]).
cudaError_t dispatch_tc(const void* x, long long x_bstride, const void* hp, long long hp_bstride,
                        const void* c_prev, const void* wpk, const void* bias, void* h_next,
                        void* c_next, void* y, long long y_bstride, const Saved& sv,
                        const Masked& mk, int B, int H, int W, int f, int kh, int kw,
                        cudaStream_t stream) {
  const int cin = mk.mask != nullptr ? 4 * f : f;
#define KCCOT_FWD_TC(CFG, VEC)                                                                  \
  launch_tc<CFG, VEC>(x, x_bstride, hp, hp_bstride, c_prev, wpk, bias, h_next, c_next, y,      \
                      y_bstride, sv, mk, B, H, W, f, cin, kh, kw, stream)
  if (cin % 8 != 0) return KCCOT_FWD_TC(Cfg64x64, false);
  if (!aligned16(hp) || hp_bstride % 8 != 0) return cudaErrorMisalignedAddress;
  switch (pick_shape((long long)B * H * W, 16 * ((f + 3) / 4))) {
    case k128x64: return KCCOT_FWD_TC(Cfg128x64, true);
    case k64x64: return KCCOT_FWD_TC(Cfg64x64, true);
    case k32x64: return KCCOT_FWD_TC(Cfg32x64, true);
    default: return KCCOT_FWD_TC(Cfg128x32, true);
  }
#undef KCCOT_FWD_TC
}

}  // namespace

// One step: dtype 0 = float32, 1 = bfloat16 (the dtype of x and y).
// x and y point at time step t of [B, T, H, W, 4f] / [B, T, H, W, f]
// stacks, with the given per-sample strides in elements; h and c are
// [B, H, W, f] float32; bias [4f] float32.  cs and gates, if not null,
// point at step t of the f32 c stack [B, T, H, W, f] and of the f32 gate
// stack [B, T, H, W, 4f] (gate g of channel j at 4j + g; 16-byte aligned,
// g_bstride a multiple of 4), each with its per-sample stride.
// float32: the CUDA-core kernel reads h_prev; w is rk4, the recurrent
// kernel as float32 with its gates interleaved, [kh, kw, f_in, f_out, 4]
// (16-byte aligned); hp is not read.
// bfloat16: the tensor-core kernel reads hp = cdt(h_{t-1}) (y at step
// t-1, or cdt(h0)) with per-sample stride hp_bstride; w is cdt(rk)
// packed [kh*kw*f, 16*ceil(f/4)] (models/cuda_convlstm.py::_pack_gates);
// h_prev is not read.
// Recurrent dropout: mask (the four masks, [B, H, W, 4f] float32, gate
// g's at channel g*f + j) is not null.  Then hp is hm_{t-1} = cdt(h_{t-1}
// * mask) [B, H, W, 4f] of the compute dtype, for both dtypes, with
// per-sample stride hp_bstride (h_prev is not read); bfloat16 takes w
// packed from the block-diagonal [kh, kw, 4f, 4f] weight
// (models/cuda_convlstm.py::_block_diagonal), float32 rk4 as without
// masks; and, if hm_out is not null, the step writes hm_t there with
// per-sample stride hmo_bstride.
// Returns the launch's cudaError_t (0 on success).
extern "C" int kccot_convlstm_fwd_step(int dtype, const void* x, long long x_bstride,
                                       const void* h_prev, const void* hp, long long hp_bstride,
                                       const void* c_prev, const void* w, const void* bias,
                                       void* h_next, void* c_next, void* y, long long y_bstride,
                                       void* cs, long long cs_bstride, void* gates,
                                       long long g_bstride, const void* mask, void* hm_out,
                                       long long hmo_bstride, int B, int H, int W, int f, int kh,
                                       int kw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || f <= 0 || kh <= 0 || kw <= 0) return cudaErrorInvalidValue;
  if (mask == nullptr && hm_out != nullptr) return cudaErrorInvalidValue;
  if (gates != nullptr && (!aligned16(gates) || g_bstride % 4 != 0))
    return cudaErrorMisalignedAddress;
  const Saved sv{cs, cs_bstride, gates, g_bstride};
  const Masked mk{mask != nullptr ? hp : nullptr, hp_bstride, mask, hm_out, hmo_bstride};
  if (dtype == 0)
    return dispatch(x, x_bstride, h_prev, c_prev, w, bias, h_next, c_next, y, y_bstride, sv, mk,
                    B, H, W, f, kh, kw, s);
  if (dtype == 1)
    return dispatch_tc(x, x_bstride, hp, hp_bstride, c_prev, w, bias, h_next, c_next, y,
                       y_bstride, sv, mk, B, H, W, f, kh, kw, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kccot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
