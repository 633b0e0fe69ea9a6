// Pieces shared by the ConvLSTM forward (convlstm_fwd.cu) and backward
// (convlstm_bwd.cu) kernels.
//
// f32 path (CUDA cores): dtype helpers, the spatial tiling of a frame,
// staging a tile of h (halo included) in shared memory, and the recurrent
// conv's four gate sums over that tile.  Tiling: a block covers tile_h x
// tile_w pixels of one sample and up to 32 channels j.  threadIdx.x =
// channel within the block's channel tile, threadIdx.y = one of nruns
// threads sharing the spatial tile, each owning kPix pixels (pixel q =
// p * nruns + threadIdx.y), so the threads of a warp read neighbouring
// pixels.  Grid: x = spatial tile, y = channel tile, z = sample.
//
// bf16 path (tensor cores): one implicit-GEMM building block that all
// three products of the recurrence use -- the forward step's conv (M =
// B*H*W, N = 4f, K = kh*kw*f), the backward's transposed conv dh (N = f,
// K = kh*kw*4f) and the weight gradient drk (M = kh*kw*f, N = 4f, K =
// B*T*H*W).  A block computes a BM x BN tile of C = A B with warps of
// 32 x 8*NI each, by mma.sync.m16n8k16 (bf16 x bf16 -> f32) on fragments
// read by ldmatrix; A and B reach shared memory by cp.async, kStages
// k-tiles of 32 in flight.  The loaders gather: A as (pixel, (tap, ci))
// from a frame with its halo (zero outside), K ordered tap by tap with
// the ci of a tap contiguous, so one 16-byte copy moves 8 channels of one
// tap and a k16 step spans two taps when f = 8.  Where the channel count
// is not a multiple of 8 the loaders copy element by element instead
// (same tiles, same mma).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Stage f32 h over the block's tile and its 'SAME' halo (lo = (k-1)/2
// rows and columns before the tile), [tile_h+kh-1][tile_w+kw-1][f].
// Zeros outside the frame are the padding.  hb points at this sample's
// [H, W, ld] frame (f channels of each pixel's ld).
__device__ __forceinline__ void stage_h(float* hs, const float* __restrict__ hb, int H, int W,
                                        int f, int ld, int kh, int kw, int ty0, int tx0,
                                        int tile_h, int tile_w) {
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
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = hb[((long long)gy * W + gx) * ld + ci];
    hs[idx] = v;
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

// Recurrent dropout (f32): gate g's conv reads hm_g = h_{t-1} * mask_g,
// which the previous step wrote, gate-major, into hmb's [H, W, 4f] frame
// (channel g*f + ci).  The gates are staged one at a time into the tile
// of stage_h, so shared memory stays that of the unmasked kernel, and
// each gate's sum runs in the order of rconv_gates.  Every thread of the
// block must call it (it holds barriers); `valid` says whether this
// thread's channel j exists.
template <int kPix>
__device__ __forceinline__ void rconv_gates_masked(float (&acc)[kPix][4], float* hs,
                                                   const float* __restrict__ hmb,
                                                   const float4* __restrict__ rk4,
                                                   const int (&off)[kPix], int j, bool valid,
                                                   int H, int W, int f, int kh, int kw, int ty0,
                                                   int tx0, int tile_h, int tile_w) {
  const int sw = tile_w + kw - 1;
  const float* rk = reinterpret_cast<const float*>(rk4);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    __syncthreads();  // the previous gate's tile has been read
    stage_h(hs, hmb + g * f, H, W, f, 4 * f, kh, kw, ty0, tx0, tile_h, tile_w);
    __syncthreads();
    if (!valid) continue;
    for (int ky = 0; ky < kh; ++ky) {
      for (int kx = 0; kx < kw; ++kx) {
        const float* w = rk + ((long long)(ky * kw + kx) * f * f + j) * 4 + g;
        const float* ht = hs + (ky * sw + kx) * f;
        for (int ci = 0; ci < f; ++ci) {
          const float wv = __ldg(w + (long long)ci * f * 4);
#pragma unroll
          for (int p = 0; p < kPix; ++p) acc[p][g] = fmaf(ht[off[p] + ci], wv, acc[p][g]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor cores (bf16 inputs, f32 sums).

using bf16 = __nv_bfloat16;

// Block tile: WM x WN warps, each 32 rows (two m16) by 8*NI columns; a
// k-tile of BK, kStages k-tiles in flight.
template <int WM_, int WN_, int NI_>
struct TcCfg {
  static constexpr int WM = WM_, WN = WN_, NI = NI_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 32 * WM, BN = 8 * NI * WN, BK = 32;
  static constexpr int kStages = 3;
  static constexpr int A_LD = BK + 8;   // A as [BM][A_LD], k contiguous
  static constexpr int AT_LD = BM + 8;  // A as [BK][AT_LD], m contiguous
  static constexpr int B_LD = BN + 8;   // B as [BK][B_LD], n contiguous
  static constexpr int A_ELEMS = BM * A_LD > BK * AT_LD ? BM * A_LD : BK * AT_LD;
  static constexpr int B_ELEMS = BK * B_LD;
  static constexpr int kSmem = kStages * (A_ELEMS + B_ELEMS) * 2;
  static_assert(kSmem >= BM * BN * 4, "the split-K reduction reuses the pipeline's smem");
};
// The padding of 8 elements a row makes the 8 rows an ldmatrix reads
// fall on distinct banks at every width used.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p))
               : "memory");
}

// d += a b for one m16n8k16 tile: a row-major 16x16, b 16x8, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = A B over k-tiles kt0 .. kt1-1.  load_a(dst) and load_b(kt, dst)
// put the next k-tile into a stage (load_a keeps its own position and is
// called once per k-tile, in order): A as [BM][A_LD] (kAT false) or
// [BK][AT_LD] (kAT true), B as [BK][B_LD].  acc[mi][ni] is the m16n8
// tile (warp row + 16 mi, warp column + 8 ni): c0, c1 at row lane/4 and
// columns 2*(lane%4) + {0, 1}, c2, c3 eight rows below.
template <class Cfg, bool kAT, class LoadA, class LoadB>
__device__ __forceinline__ void tc_gemm(float (&acc)[2][Cfg::NI][4], bf16* smem, int kt0, int kt1,
                                        LoadA& load_a, const LoadB& load_b) {
  constexpr int S = Cfg::kStages, NI = Cfg::NI;
  bf16* sa = smem;
  bf16* sb = smem + S * Cfg::A_ELEMS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % Cfg::WM, wn = warp / Cfg::WM;
  const int nk = kt1 - kt0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) {
      load_a(sa + s * Cfg::A_ELEMS);
      load_b(kt0 + s, sb + s * Cfg::B_ELEMS);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // k-tile i has landed; stage (i - 1) % S is free
    const int pf = i + S - 1;
    if (pf < nk) {
      load_a(sa + (pf % S) * Cfg::A_ELEMS);
      load_b(kt0 + pf, sb + (pf % S) * Cfg::B_ELEMS);
    }
    cp_async_commit();
    const bf16* a = sa + (i % S) * Cfg::A_ELEMS;
    const bf16* b = sb + (i % S) * Cfg::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < Cfg::BK; kk += 16) {
      unsigned af[2][4], bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int mb = wm * 32 + mi * 16;
        if constexpr (kAT)
          ldsm_x4_t(af[mi], a + (kk + (lane & 7) + ((lane >> 4) << 3)) * Cfg::AT_LD + mb +
                                ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(af[mi], a + (mb + (lane & 15)) * Cfg::A_LD + kk + (lane >> 4) * 8);
      }
      const bf16* brow = b + (kk + (lane & 15)) * Cfg::B_LD + wn * 8 * NI;
      if constexpr (NI == 1) {
        unsigned r[2];
        ldsm_x2_t(r, brow);
        bfr[0][0] = r[0];
        bfr[0][1] = r[1];
      } else {
#pragma unroll
        for (int ni = 0; ni + 1 < NI; ni += 2) {
          unsigned r[4];
          ldsm_x4_t(r, brow + ni * 8 + (lane >> 4) * 8);
          bfr[ni][0] = r[0];
          bfr[ni][1] = r[1];
          bfr[ni + 1][0] = r[2];
          bfr[ni + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();
}

// Split-K over a thread-block cluster: the `split` blocks of a cluster
// (along grid z) each summed one K range into acc; block rank 0 adds the
// others' partial tiles, read from their shared memory in rank order, so
// the sum is the same on every run.  Returns true in the block that holds
// the sum (every block, with split 1).  smem is the pipeline's, free now.
template <class Cfg>
__device__ __forceinline__ bool cluster_sum(float (&acc)[2][Cfg::NI][4], void* smem, int split) {
  if (split == 1) return true;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  float* part = static_cast<float*>(smem);  // [2*NI*4][kThreads]
  constexpr int T = Cfg::kThreads;
  __syncthreads();
  if (rank != 0) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < Cfg::NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[((mi * Cfg::NI + ni) * 4 + r) * T + threadIdx.x] = acc[mi][ni][r];
  }
  cluster.sync();
  if (rank == 0) {
    for (int q = 1; q < split; ++q) {
      const float* peer = cluster.map_shared_rank(part, q);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < Cfg::NI; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] += peer[((mi * Cfg::NI + ni) * 4 + r) * T + threadIdx.x];
    }
  }
  cluster.sync();  // the peers' shared memory stays until rank 0 has read it
  return rank == 0;
}

// The k-tiles of split part `r` of `split` over nk.
__device__ __forceinline__ void split_range(int nk, int r, int split, int& kt0, int& kt1) {
  kt0 = (int)((long long)nk * r / split);
  kt1 = (int)((long long)nk * (r + 1) / split);
}

// A[m][k] of a stride-1 conv as a GEMM: m = (b, y, x) over the B*H*W
// pixels, k = (ky*kw + kx)*C + c over the taps and channels, and
// A[m][k] = src[b, y + sgn*ky + oy, x + sgn*kx + ox, c], zero outside
// the frame.  The forward conv has sgn = +1, o = -lo; the transposed
// conv of the backward sgn = -1, o = +lo (its flipped pads).  src has
// per-sample stride bstride (elements) and pixel stride C.  A thread
// copies the same 8-channel column of kRows rows in every k-tile, so it
// keeps its rows' pixels and walks (tap, c) forward by BK a k-tile,
// without divisions.  kVec: C is a multiple of 8 and src 16-byte
// aligned, so 8 channels of one tap are one cp.async; else element by
// element.
template <class Cfg, bool kVec>
struct ConvGatherA {
  static constexpr int kPerRow = Cfg::BK / 8, kRowStep = Cfg::kThreads / kPerRow;
  static constexpr int kRows = Cfg::BM / kRowStep;  // rows a thread
  static_assert(Cfg::kThreads % kPerRow == 0 && Cfg::BM % kRowStep == 0, "gather layout");
  const bf16* src;
  int H, W, C, kw, K, sgn, oy, ox;
  int k, ky, kx, c;  // this thread's column in the next k-tile
  int y[kRows], x[kRows];
  long long base[kRows];  // offset of the row's pixel

  __device__ __forceinline__ ConvGatherA(const bf16* src_, long long bstride, int H_, int W_,
                                         int C_, int kw_, int K_, int sgn_, int oy_, int ox_,
                                         int m0, int M, int kt0)
      : src(src_), H(H_), W(W_), C(C_), kw(kw_), K(K_), sgn(sgn_), oy(oy_), ox(ox_) {
    const int HW = H * W;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + (int)threadIdx.x / kPerRow + i * kRowStep;
      const int b = m / HW, pix = m - b * HW;
      y[i] = m < M ? pix / W : -(1 << 29);  // never inside the frame
      x[i] = pix - (pix / W) * W;
      base[i] = b * bstride + (long long)pix * C;
    }
    k = kt0 * Cfg::BK + (int)(threadIdx.x % kPerRow) * 8;
    const int tap = k / C;
    c = k - tap * C;
    ky = tap / kw;
    kx = tap - ky * kw;
  }

  __device__ __forceinline__ void load_elem(bf16* d, int i, int ke, int ky_, int kx_, int c_) const {
    const int dy = sgn * ky_ + oy, dx = sgn * kx_ + ox;
    const int yy = y[i] + dy, xx = x[i] + dx;
    const bool ok = ke < K && yy >= 0 && yy < H && xx >= 0 && xx < W;
    *d = ok ? src[base[i] + ((long long)dy * W + dx) * C + c_] : __float2bfloat16(0.0f);
  }

  __device__ __forceinline__ void operator()(bf16* dst) {
    const int col = (int)(threadIdx.x % kPerRow) * 8;
    const int dy = sgn * ky + oy, dx = sgn * kx + ox;
    const long long shift = ((long long)dy * W + dx) * C + c;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      bf16* d = dst + ((int)threadIdx.x / kPerRow + i * kRowStep) * Cfg::A_LD + col;
      if constexpr (kVec) {
        const int yy = y[i] + dy, xx = x[i] + dx;
        const bool ok = k < K && yy >= 0 && yy < H && xx >= 0 && xx < W;
        cp_async16(d, ok ? src + base[i] + shift : src, ok);
      } else {
        int ky_ = ky, kx_ = kx, c_ = c;
        for (int e = 0; e < 8; ++e) {
          load_elem(d + e, i, k + e, ky_, kx_, c_);
          if (++c_ == C) {
            c_ = 0;
            if (++kx_ == kw) kx_ = 0, ++ky_;
          }
        }
      }
    }
    k += Cfg::BK;
    c += Cfg::BK;
    while (c >= C) {
      c -= C;
      if (++kx == kw) kx = 0, ++ky;
    }
  }
};

// B = a dense row-major [K][ld] weight, columns n0 .. n0+BN (zero past
// ld); ld is a multiple of 8 and w 16-byte aligned.
template <class Cfg>
struct DenseB {
  const bf16* w;
  int K, ld, n0;
  __device__ __forceinline__ void operator()(int kt, bf16* dst) const {
    constexpr int kPerRow = Cfg::BN / 8, kChunks = Cfg::BK * kPerRow;
#pragma unroll
    for (int c = threadIdx.x; c < kChunks; c += Cfg::kThreads) {
      const int row = c / kPerRow, cc = c % kPerRow;
      const int k = kt * Cfg::BK + row, n = n0 + cc * 8;
      const bool ok = k < K && n < ld;
      cp_async16(dst + row * Cfg::B_LD + cc * 8, ok ? w + (long long)k * ld + n : w, ok);
    }
  }
};

// The four gate pre-activations of one (pixel, channel) in one thread.
// The gate GEMMs' B columns are ordered so that each 16 columns hold 4
// channels: column 16*(j/4) + 8*(g/2) + 2*(j%4) + g%2 is gate g of
// channel j (the wrapper packs the weight so).  A thread's accumulators
// of n-tiles 2p and 2p+1 then hold gates (0, 1) and (2, 3) of channel
// j = 4*(column of tile 2p)/16 + lane%4 for rows lane/4 and lane/4 + 8.
// fn(m, j, p, z) is called for every (row, channel) of the thread; p
// numbers the thread's channel groups (NI/2 of them).
template <class Cfg, class Fn>
__device__ __forceinline__ void for_each_gate_quad(const float (&acc)[2][Cfg::NI][4], int m0,
                                                   int n0, Fn&& fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % Cfg::WM, wn = warp / Cfg::WM;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < Cfg::NI / 2; ++p) {
        const int m = m0 + wm * 32 + mi * 16 + h * 8 + (lane >> 2);
        const int j = (n0 + wn * 8 * Cfg::NI + p * 16) / 4 + (lane & 3);
        const float z[4] = {acc[mi][2 * p][2 * h], acc[mi][2 * p][2 * h + 1],
                            acc[mi][2 * p + 1][2 * h], acc[mi][2 * p + 1][2 * h + 1]};
        fn(m, j, p, z);
      }
}

// Tile shapes of the gate and dh GEMMs, by M and the padded N: the
// largest tile that still gives at least one block per SM (132 on the
// H100), else the one with the most blocks.
enum TcShape { k128x64, k64x64, k32x64, k128x32, k128x16, k128x8 };

inline int tc_blocks(long long M, int N, int bm, int bn) {
  return (int)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

inline TcShape pick_shape(long long M, int N) {
  if (N <= 8) return k128x8;
  if (N <= 16) return k128x16;
  if (N <= 32) return k128x32;
  if (tc_blocks(M, N, 128, 64) >= 132) return k128x64;
  if (tc_blocks(M, N, 64, 64) >= 132) return k64x64;
  return k32x64;
}

inline int shape_bm(TcShape s) { return s == k64x64 ? 64 : (s == k32x64 ? 32 : 128); }

// K splits (a cluster of that many blocks) for a launch of `blocks`
// tiles with nk k-tiles each: double until two blocks an SM are in
// flight, keeping at least 16 k-tiles a split and at most 8 (the
// portable cluster size).
inline int pick_split(int blocks, int nk) {
  int split = 1;
  while (split < 8 && (long long)blocks * split < 2 * 132 && nk / (2 * split) >= 16) split *= 2;
  return split;
}

// Launch kernel<<<grid (z = split), Cfg threads, Cfg::kSmem>>> with the
// split blocks of each tile as one cluster.
template <class Cfg, class... Params, class... Args>
cudaError_t launch_split(void (*kernel)(Params...), dim3 grid, int split, cudaStream_t stream,
                         Args... args) {
  cudaError_t err = allow_smem((const void*)kernel, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  grid.z = split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Cfg::kThreads);
  cfg.dynamicSmemBytes = Cfg::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

using Cfg128x64 = TcCfg<4, 2, 4>;
using Cfg64x64 = TcCfg<2, 2, 4>;
using Cfg32x64 = TcCfg<1, 4, 2>;
using Cfg128x32 = TcCfg<4, 1, 4>;
using Cfg128x16 = TcCfg<4, 1, 2>;
using Cfg128x8 = TcCfg<4, 1, 1>;

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace kccot
