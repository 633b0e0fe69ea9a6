// Pieces shared by the ConvLSTM forward (convlstm_fwd.cu) and backward
// (convlstm_bwd.cu) step kernels: dtype helpers, the spatial tiling of a
// frame, staging a tile of h (halo included) in shared memory, and the
// recurrent conv's four gate sums over that tile.
//
// Tiling: a block covers tile_h x tile_w pixels of one sample and up to
// 32 channels j.  threadIdx.x = channel within the block's channel tile,
// threadIdx.y = one of nruns threads sharing the spatial tile, each
// owning kPix pixels (pixel q = p * nruns + threadIdx.y), so the threads
// of a warp read neighbouring pixels.  Grid: x = spatial tile, y =
// channel tile, z = sample.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kccot {

constexpr int kThreads = 256;  // threads per block, at most
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

struct Tile {
  int jt;       // channels a block
  int tile_h, tile_w, tiles_w, tiles_h;
  int nruns;    // threads sharing the spatial tile
};

// Pixels a thread: more pixels give more FMAs per load, fewer give more
// threads.  Frames of 256 pixels or more fill the card at 8; the 8x8 and
// 4x4 frames of the deep layers need 4 and 2 to keep enough threads.
inline int pixels_per_thread(int H, int W) { return H * W >= 256 ? 8 : (H * W >= 64 ? 4 : 2); }

inline Tile make_tile(int H, int W, int channels, int kPix) {
  Tile t;
  t.jt = channels < 32 ? channels : 32;
  t.tile_w = W < 16 ? W : 16;
  t.tile_h = kThreads / t.jt * kPix / t.tile_w;
  if (t.tile_h > H) t.tile_h = H;
  if (t.tile_h < 1) t.tile_h = 1;
  t.nruns = (t.tile_h * t.tile_w + kPix - 1) / kPix;
  t.tiles_w = (W + t.tile_w - 1) / t.tile_w;
  t.tiles_h = (H + t.tile_h - 1) / t.tile_h;
  return t;
}

inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Stage h over the block's tile and its 'SAME' halo (lo = (k-1)/2 rows
// and columns before the tile), rounded to the compute dtype T and held
// as f32, [tile_h+kh-1][tile_w+kw-1][f].  Zeros outside the frame are
// the padding.  hb points at this sample's [H, W, f] frame of type S.
template <typename T, typename S>
__device__ __forceinline__ void stage_h(float* hs, const S* __restrict__ hb, int H, int W, int f,
                                        int kh, int kw, int ty0, int tx0, int tile_h, int tile_w) {
  const int lo_h = (kh - 1) / 2, lo_w = (kw - 1) / 2;
  const int sw = tile_w + kw - 1;
  const int n_stage = (tile_h + kh - 1) * sw * f;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int idx = tid; idx < n_stage; idx += nthreads) {
    const int ci = idx % f;
    const int r = idx / f;
    const int gy = ty0 - lo_h + r / sw;
    const int gx = tx0 - lo_w + r % sw;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f32(hb[((long long)gy * W + gx) * f + ci]);
    hs[idx] = round_to<T>(v);
  }
}

// acc[p][g] += sum_{ky,kx,ci} hs[pixel p shifted by (ky,kx)][ci] * rk[ky,kx,ci,g*f+j]
// for the thread's kPix pixels.  rk4 is the recurrent kernel rounded to
// the compute dtype, gates interleaved [kh, kw, f_in, f_out, 4]: one
// 16-byte load feeds 4 * kPix FMAs.  off[p] is the smem offset of pixel
// p's top-left tap.
template <int kPix>
__device__ __forceinline__ void rconv_gates(float (&acc)[kPix][4], const float* hs,
                                            const float4* __restrict__ rk4, const int (&off)[kPix],
                                            int j, int f, int kh, int kw, int sw) {
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
}

}  // namespace kccot
