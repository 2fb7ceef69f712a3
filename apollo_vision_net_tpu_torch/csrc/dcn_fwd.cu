// Modulated deformable convolution v2 forward (3x3 taps) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel apollo_vision_net_tpu/ops/dcn_pallas.py
// _dcn_kernel (R101-DCN stages 3-4, reached through ops/dcnv3.py
// modulated_deform_conv). The TPU kernel builds the modulated bilinear
// im2col tile (QT, 9*C) with one-hot masks on its matrix unit and multiplies
// it by the (9*C, O) weight in its own body. This kernel is the same
// product as an implicit GEMM: the im2col tile is gathered straight from x
// into shared memory, chunk by chunk of the 9*C reduction, and never exists
// in device memory.
//
// Semantics (equal to modulated_deform_conv_ref in ops/dcn.py):
//   pos[b, i, j, k] = (j*s + kx - 1, i*s + ky - 1) + offset[b, i, j, k]
//                     (k = ky*3 + kx, offsets (x, y) in input pixels)
//   sample[b, i, j, k, c] = mask[b, i, j, k] * bilinear(x[b, :, :, c], pos)
//                           rounded to x's dtype
//   out[b, i, j, o] = sum_{k, c} sample[b, i, j, k, c] * weight[k, c, o]
// with zero padding outside the image, f32 accumulation and the output in
// x's dtype. Each sample is summed over its corners in the plain version's
// order and rounding (corner (0,0), (1,0), (0,1), (1,1); each product and
// sum rounded to f32), so kernel and plain version round the same samples.
//
// Layout: x (B, H, W, C), offset (B, Ho, Wo, 9, 2) f32, mask (B, Ho, Wo, 9)
// f32, weight (9, C, O) in x's dtype, out (B, Ho, Wo, O), all contiguous.
//
// What bounds it. The product is 2*9*C*O operations per output pixel: 10.6
// GFLOP a call at each of the four R101 shapes, 10.7 us at the H100's dense
// bf16 tensor rate, 158 us at its f32 CUDA-core rate. Device memory is no
// limit (a few MB a call). In practice the gather sets the pace: every
// sample reads four corner rows of x (M x 9 x 4 x C x 2 B = 166 MB a call
// in bf16 at 30x50x256, from L1 and L2, since x is 4.6 MB), and each output
// pixel needs all of its 9*C samples before the product can use them.
//
// Design. A block owns BM output pixels and BN output channels, 256
// threads, and walks the 9*C reduction in chunks of BK channels of one tap
// (BK = 64 in bf16, 32 in f32), so the tap is fixed per chunk and no
// element pays a k / C division.
//   - Corners. At the start the block computes, for its BM pixels and 9
//     taps, the four corner element offsets and modulated bilinear weights
//     into shared memory (32 B per pixel and tap); a chunk reads each of
//     its pixels' entries once.
//   - Gather, vector variant (C and O multiples of 16 bytes' worth of
//     elements, 16-byte aligned tensors; the R101 shapes run it): a thread
//     owns 16 bytes of channels (8 bf16 or 4 f32) of one or two pixels and
//     reads each of its four corner rows with one 16-byte load; it sums the
//     modulated corners in f32, rounds to x's dtype and stores 16 bytes to
//     shared memory (bf16: pixel-major; f32: channel-major for the FMA
//     loop's 16-byte reads).
//   - Weights: the chunk's BK rows of BN columns arrive by cp.async
//     (16 bytes, zero-filled past C and O).
//   - Overlap: a two-stage ring in shared memory. While chunk k is
//     multiplied, chunk k+1's weight rows are in flight by cp.async and
//     its corner loads are in flight in registers; one __syncthreads per
//     chunk.
//   - No re-gather per output tile: a block covers all O (BN = 256 with
//     BM = 64 for O <= 256; BN = 512 with BM = 32 for O <= 512; more O
//     tiles only beyond 512), so each sample is gathered once. This fills
//     the card thinly (141 blocks at stage 3, 71 at stage 4 on 132 SMs).
//     The other option, a thread-block cluster along O sharing one gathered
//     tile through distributed shared memory, would give more blocks at the
//     price of a cluster barrier and remote stores each chunk; it moves the
//     same weight bytes (each pixel tile reads all 9*C*O weights from L2)
//     and gathers as often, so the simpler full-width tile was chosen. At
//     64 x 256 in bf16 two blocks share an SM (<= 128 registers; ptxas
//     spills 32 bytes) and hide each other's chunk latency.
//   - Product. bf16: mma.sync m16n8k16 (f32 accumulators) on the tensor
//     cores, operands from shared memory by ldmatrix (B transposed), 8
//     warps of 32 x 64 each. f32: CUDA-core FMAs, no TF32 (the f32
//     tolerance of 1e-4 would not survive it at K = 2304-4608), a thread
//     computing an 8 x 8 sub-tile from 16-byte shared loads.
//   General variant (any C, O or alignment): the same 64 x 256 tile, scalar
//   loads for the gather and the weights, and guarded scalar stores.
// mma.sync rather than wgmma: the product is not what sets the pace (the
// bf16 kernel runs ~11x its tensor-core bound while a cuDNN 3x3 conv of the
// same shape, which gathers nothing, runs ~2.5x; see PERF.md), and
// mma.sync keeps the warp tiles simple.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cast_bf16.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;

// A pixel's four corners for one tap: element offsets of the corner rows in
// x (-1 outside the image) and modulated bilinear weights (0 outside).
struct TapCorners {
  int4 idx;
  float4 wt;
};

template <typename T, int BM_, int BN_>
struct DcnTile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int BK = kBf16 ? 64 : 32;       // reduction chunk
  static constexpr int VEC = 16 / sizeof(T);        // channels per 16 bytes
  static constexpr int GROUPS = BK / VEC;           // 16-byte units per pixel
  static constexpr int UPT = BM * GROUPS / kThreads;  // units per thread
  // bf16: As[BM][BK + 8] (pixel-major), Bs[BK][BN + 8]; f32: As[BK][BM + 4]
  // (channel-major), Bs[BK][BN + 4]; the padding keeps ldmatrix and the
  // 16-byte shared loads free of bank conflicts
  static constexpr int LDA = kBf16 ? BK + 8 : BM + 4;
  static constexpr int LDB = BN + (kBf16 ? 8 : 4);
  static constexpr int A_STAGE = kBf16 ? BM * LDA : BK * LDA;
  static constexpr int B_STAGE = BK * LDB;
  static constexpr int SMEM = (2 * A_STAGE + 2 * B_STAGE) * (int)sizeof(T) +
                              kTaps * BM * (int)sizeof(TapCorners);
  // bf16: warps of 32 x 64 outputs; f32: threads of 8 x 8
  static constexpr int WARPS_N = BN / 64, WARPS_M = 8 / WARPS_N;
  static constexpr int MT = 2, NT = 8;
  static constexpr int TX = BN / 8;
  // bf16 64 x 256: two blocks an SM (<= 128 registers, 2 x 102 KB shared)
  // hide each other's chunk latency, faster at stage 3 on the H100; the
  // other tiles measured no faster or slower so
  static constexpr int kMinBlocks = kBf16 && BM == 64 ? 2 : 1;
  static_assert(BM * GROUPS % kThreads == 0, "whole units per thread");
  static_assert(!kBf16 || WARPS_M * 32 == BM, "bf16 warp grid covers BM");
  static_assert(kBf16 || (BM / 8) * TX == kThreads, "f32 thread grid");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 acc
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Channel e of a 16-byte unit as f32.
__device__ __forceinline__ float unit_elem(const uint4& v, int e,
                                           const __nv_bfloat16*) {
  const uint32_t w = (e >> 1) == 0 ? v.x : (e >> 1) == 1 ? v.y
                   : (e >> 1) == 2 ? v.z : v.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float unit_elem(const uint4& v, int e,
                                           const float*) {
  const uint32_t w = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  return __uint_as_float(w);
}

// Tap `tap` of output pixel m: the four corner element offsets in x (-1
// outside the image), their bilinear weights (0 outside), the fractions
// fx = px - floor(px), fy = py - floor(py) and the mask. The forward and
// the backward (dcn_bwd.cuh) both form their samples from it, so both round
// the positions and weights the same way.
struct TapSample {
  int idx[4];
  float bw[4];
  float fx, fy, mk;
};

__device__ __forceinline__ TapSample tap_sample(const float* __restrict__ offset,
                                                const float* __restrict__ mask,
                                                int m, int tap, int H, int W,
                                                int C, int Ho, int Wo,
                                                int stride) {
  const int Q = Ho * Wo;
  const int b = m / Q, q = m - b * Q;
  const int oy = q / Wo, ox = q - oy * Wo;
  const float* om = offset + ((int64_t)m * kTaps + tap) * 2;
  const float px = (float)(ox * stride + tap % 3 - 1) + om[0];
  const float py = (float)(oy * stride + tap / 3 - 1) + om[1];
  TapSample t;
  t.mk = mask[(int64_t)m * kTaps + tap];
  const float fx0 = floorf(px), fy0 = floorf(py);
  t.fx = px - fx0;
  t.fy = py - fy0;
  const int x0 = (int)fx0, y0 = (int)fy0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cx = j & 1, cy = j >> 1;
    const int xx = x0 + cx, yy = y0 + cy;
    const bool in = xx >= 0 && xx < W && yy >= 0 && yy < H;
    t.idx[j] = in ? ((b * H + yy) * W + xx) * C : -1;
    t.bw[j] = in ? __fmul_rn(cx ? t.fx : 1.f - t.fx, cy ? t.fy : 1.f - t.fy)
                 : 0.f;
  }
  return t;
}

template <int BM>
__device__ void fill_corners(TapCorners* tab, const float* __restrict__ offset,
                             const float* __restrict__ mask, int m0, int M,
                             int H, int W, int C, int Ho, int Wo,
                             int stride) {
  for (int e = threadIdx.x; e < kTaps * BM; e += kThreads) {
    const int tap = e / BM, i = e - tap * BM;
    const int m = m0 + i;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < M) {
      const TapSample t =
          tap_sample(offset, mask, m, tap, H, W, C, Ho, Wo, stride);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        idx[j] = t.idx[j];
        wt[j] = t.idx[j] >= 0 ? __fmul_rn(t.bw[j], t.mk) : 0.f;
      }
    }
    tab[e].idx = make_int4(idx[0], idx[1], idx[2], idx[3]);
    tab[e].wt = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
}

// The chunk's weight rows (tap * C + c0 + kk, kk < BK) x (n0 .. n0 + BN) to
// a B stage: cp.async of 16 bytes (zero-filled past C and O) in the vector
// variant, scalar loads and stores in the general one.
template <typename Tl, bool VEC, typename T>
__device__ __forceinline__ void load_b(T* bs, const T* __restrict__ weight,
                                       int tap, int c0, int C, int n0, int O) {
  constexpr int BK = Tl::BK, BN = Tl::BN, VC = Tl::VEC, LDB = Tl::LDB;
  if constexpr (VEC) {
    constexpr int BCH = BN / VC;
    for (int e = threadIdx.x; e < BK * BCH; e += kThreads) {
      const int kk = e / BCH, nc = e - kk * BCH;
      const bool ok = c0 + kk < C && n0 + nc * VC < O;
      const T* src =
          ok ? weight + (int64_t)(tap * C + c0 + kk) * O + n0 + nc * VC : weight;
      cp_async16(bs + kk * LDB + nc * VC, src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * BN; e += kThreads) {
      const int kk = e / BN, n = e - kk * BN;
      const bool ok = c0 + kk < C && n0 + n < O;
      store_elem(bs + kk * LDB + n,
                 ok ? to_f32(weight[(int64_t)(tap * C + c0 + kk) * O + n0 + n])
                    : 0.f);
    }
  }
}

// Vector gather, first half: the 16-byte corner loads of the thread's units
// (unit u = threadIdx.x + r * kThreads: pixel u / GROUPS, channels
// c0 + (u % GROUPS) * VEC ...) go in flight into registers.
template <typename Tl, typename T>
__device__ __forceinline__ void gather_issue(uint4 (&gv)[Tl::UPT][4],
                                             float4 (&gw)[Tl::UPT],
                                             const TapCorners* tab,
                                             const T* __restrict__ x, int tap,
                                             int c0, int C) {
#pragma unroll
  for (int r = 0; r < Tl::UPT; ++r) {
    const int u = threadIdx.x + r * kThreads, i = u / Tl::GROUPS;
    const int c = c0 + (u - i * Tl::GROUPS) * Tl::VEC;
    const TapCorners tc = tab[tap * Tl::BM + i];
    const int id[4] = {tc.idx.x, tc.idx.y, tc.idx.z, tc.idx.w};
    gw[r] = tc.wt;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gv[r][k] = (c < C && id[k] >= 0)
                     ? __ldg(reinterpret_cast<const uint4*>(x + id[k] + c))
                     : make_uint4(0, 0, 0, 0);
    }
  }
}

// The chunk's samples, summed over the corners as the plain version sums
// them, rounded to T and stored to an A stage: from the registers of
// gather_issue in the vector variant, by scalar loads in the general one.
template <typename Tl, bool VEC, typename T>
__device__ __forceinline__ void gather_store(T* as, const uint4 (&gv)[Tl::UPT][4],
                                             const float4 (&gw)[Tl::UPT],
                                             const TapCorners* tab,
                                             const T* __restrict__ x, int tap,
                                             int c0, int C) {
  constexpr int VC = Tl::VEC, LDA = Tl::LDA;
#pragma unroll
  for (int r = 0; r < Tl::UPT; ++r) {
    const int u = threadIdx.x + r * kThreads, i = u / Tl::GROUPS;
    const int g = u - i * Tl::GROUPS;
    float s[VC];
    if constexpr (VEC) {
      const float w[4] = {gw[r].x, gw[r].y, gw[r].z, gw[r].w};
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        s[e] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s[e] = __fadd_rn(s[e], __fmul_rn(unit_elem(gv[r][k], e, x), w[k]));
        }
      }
    } else {
      const TapCorners tc = tab[tap * Tl::BM + i];
      const int id[4] = {tc.idx.x, tc.idx.y, tc.idx.z, tc.idx.w};
      const float w[4] = {tc.wt.x, tc.wt.y, tc.wt.z, tc.wt.w};
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        const int c = c0 + g * VC + e;
        s[e] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c < C && id[k] >= 0) {
            s[e] = __fadd_rn(s[e], __fmul_rn(to_f32(x[id[k] + c]), w[k]));
          }
        }
      }
    }
    if constexpr (Tl::kBf16) {
      *reinterpret_cast<uint4*>(as + i * LDA + g * VC) =
          make_uint4(pack_bf16x2(s[0], s[1]), pack_bf16x2(s[2], s[3]),
                     pack_bf16x2(s[4], s[5]), pack_bf16x2(s[6], s[7]));
    } else {
#pragma unroll
      for (int e = 0; e < VC; ++e) store_elem(as + (g * VC + e) * LDA + i, s[e]);
    }
  }
}

// acc += the A stage times the B stage. bf16: warp (wm, wn) owns rows
// wm * 32 .. + 32 and columns wn * 64 .. + 64 as 2 x 8 m16n8 tiles, acc
// index (mt * 8 + nt) * 4 + fragment element. f32: thread (tx, ty) owns
// rows ty * 4 + {0..3} and BM / 2 + ty * 4 + {0..3}, columns likewise with
// tx and BN / 2, acc index row * 8 + column.
template <typename Tl, typename T>
__device__ __forceinline__ void compute(float (&acc)[64], const T* as,
                                        const T* bs, int n0, int O) {
  constexpr int BK = Tl::BK, LDA = Tl::LDA, LDB = Tl::LDB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (Tl::kBf16) {
    const int wm = warp / Tl::WARPS_N, wn = warp - wm * Tl::WARPS_N;
    if (n0 + wn * 64 >= O) return;  // the warp's columns are all past O
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[Tl::MT][4];
#pragma unroll
      for (int mt = 0; mt < Tl::MT; ++mt) {
        ldmatrix_x4(a[mt], as + (wm * 32 + mt * 16 + (lane & 15)) * LDA + ks +
                               (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < Tl::NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                                 wn * 64 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < Tl::MT; ++mt) {
          mma_bf16(&acc[(mt * Tl::NT + 2 * np) * 4], a[mt], b[0], b[1]);
          mma_bf16(&acc[(mt * Tl::NT + 2 * np + 1) * 4], a[mt], b[2], b[3]);
        }
      }
    }
  } else {
    const int tx = threadIdx.x % Tl::TX, ty = threadIdx.x / Tl::TX;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LDA + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * LDA + Tl::BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LDB + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * LDB + Tl::BN / 2 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
      }
    }
  }
}

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, (DcnTile<T, BM, BN>::kMinBlocks))
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const T* __restrict__ weight,
               T* __restrict__ out, int M, int H, int W, int C, int Ho, int Wo,
               int O, int stride) {
  using Tl = DcnTile<T, BM, BN>;
  constexpr int BK = Tl::BK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + 2 * Tl::A_STAGE;
  TapCorners* tab = reinterpret_cast<TapCorners*>(Bs + 2 * Tl::B_STAGE);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cpt = (C + BK - 1) / BK;  // chunks per tap
  const int n_chunks = kTaps * cpt;

  fill_corners<BM>(tab, offset, mask, m0, M, H, W, C, Ho, Wo, stride);
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  uint4 gv[Tl::UPT][4];  // the vector gather's loads in flight
  float4 gw[Tl::UPT];

  // two-stage ring in shared memory: chunk j + 1's weights (cp.async) and
  // corner loads (registers) are in flight while chunk j multiplies (a
  // third weight stage measured no faster on the H100)
  load_b<Tl, VEC>(Bs, weight, 0, 0, C, n0, O);
  cp_async_commit();
  if constexpr (VEC) gather_issue<Tl>(gv, gw, tab, x, 0, 0, C);
  gather_store<Tl, VEC>(As, gv, gw, tab, x, 0, 0, C);
  cp_async_wait_all();
  __syncthreads();
  for (int j = 0; j < n_chunks; ++j) {
    const int cur = j & 1, nxt = cur ^ 1;
    const bool more = j + 1 < n_chunks;
    const int tap = (j + 1) / cpt, c0 = (j + 1 - tap * cpt) * BK;
    if (more) {
      load_b<Tl, VEC>(Bs + nxt * Tl::B_STAGE, weight, tap, c0, C, n0, O);
      cp_async_commit();
      if constexpr (VEC) gather_issue<Tl>(gv, gw, tab, x, tap, c0, C);
    }
    compute<Tl>(acc, As + cur * Tl::A_STAGE, Bs + cur * Tl::B_STAGE, n0, O);
    if (more) {
      gather_store<Tl, VEC>(As + nxt * Tl::A_STAGE, gv, gw, tab, x, tap, c0, C);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: f32 accumulators rounded to T
  if constexpr (Tl::kBf16) {
    const int wm = warp / Tl::WARPS_N, wn = warp - wm * Tl::WARPS_N;
#pragma unroll
    for (int mt = 0; mt < Tl::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 32 + mt * 16 + (lane >> 2) + half * 8;
        if (m >= M) continue;
#pragma unroll
        for (int nt = 0; nt < Tl::NT; ++nt) {
          const int n = n0 + wn * 64 + nt * 8 + (lane & 3) * 2;
          const int a = (mt * Tl::NT + nt) * 4 + half * 2;
          T* o = out + (int64_t)m * O + n;
          if (VEC) {
            // O is a multiple of 8, so n < O covers the pair
            if (n < O) {
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(acc[a], acc[a + 1]);
            }
          } else {
            if (n < O) store_elem(o, acc[a]);
            if (n + 1 < O) store_elem(o + 1, acc[a + 1]);
          }
        }
      }
    }
  } else {
    const int tx = threadIdx.x % Tl::TX, ty = threadIdx.x / Tl::TX;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
      if (m >= M) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + half * (BN / 2) + tx * 4;
        const int a = i * 8 + half * 4;
        T* o = out + (int64_t)m * O + n;
        if (VEC) {
          // O is a multiple of 4, so n < O covers the four
          if (n < O) {
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[a], acc[a + 1], acc[a + 2], acc[a + 3]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (n + e < O) store_elem(o + e, acc[a + e]);
          }
        }
      }
    }
  }
}

template <typename T, int BM, int BN, bool VEC>
int launch(const void* x, const float* offset, const float* mask,
           const void* weight, void* out, int M, int H, int W, int C, int Ho,
           int Wo, int O, int stride, cudaStream_t s) {
  using Tl = DcnTile<T, BM, BN>;
  auto kernel = dcn_fwd_kernel<T, BM, BN, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN);
  kernel<<<grid, kThreads, Tl::SMEM, s>>>(
      (const T*)x, offset, mask, (const T*)weight, (T*)out, M, H, W, C, Ho, Wo,
      O, stride);
  return (int)cudaGetLastError();
}

// The vector variant when C and O are whole 16-byte units and x, weight and
// out are 16-byte aligned (tile 64 x 256 for O <= 256, else 32 x 512), the
// general variant (tile 64 x 256) otherwise. *variant = 1 / 0.
template <typename T>
int dispatch(const void* x, const float* offset, const float* mask,
             const void* weight, void* out, int M, int H, int W, int C,
             int Ho, int Wo, int O, int stride, cudaStream_t s,
             int* variant) {
  constexpr int VC = 16 / sizeof(T);
  const bool vec = C % VC == 0 && O % VC == 0 &&
                   (((uintptr_t)x | (uintptr_t)weight | (uintptr_t)out) & 15) == 0;
  *variant = vec ? 1 : 0;
  if (!vec) {
    return launch<T, 64, 256, false>(x, offset, mask, weight, out, M, H, W, C,
                                     Ho, Wo, O, stride, s);
  }
  if (O > 256) {
    return launch<T, 32, 512, true>(x, offset, mask, weight, out, M, H, W, C,
                                    Ho, Wo, O, stride, s);
  }
  return launch<T, 64, 256, true>(x, offset, mask, weight, out, M, H, W, C, Ho,
                                  Wo, O, stride, s);
}

// The backward's kernels (im2col and col2im), which use the helpers above.
#include "dcn_bwd.cuh"

}  // namespace

// Returns 0 on success, else a cudaError_t code. dtype 0 = f32, 1 = bf16
// (x, weight and out share it). *variant is set to 1 when the vector
// variant ran, 0 when the general one did.
extern "C" int dcn_fwd(const void* x, int dtype, const float* offset,
                       const float* mask, const void* weight, void* out, int B,
                       int H, int W, int C, int Ho, int Wo, int O, int stride,
                       void* stream, int* variant) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || O < 1 || stride < 1 || Ho < 0 ||
      Wo < 0 || (int64_t)B * H * W * C > INT32_MAX ||
      (int64_t)B * Ho * Wo > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = B * Ho * Wo;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch<float>(x, offset, mask, weight, out, M, H, W, C, Ho, Wo, O,
                           stride, s, variant);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(x, offset, mask, weight, out, M, H, W, C,
                                   Ho, Wo, O, stride, s, variant);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------- backward
// The entries of the backward (dcn_bwd.cuh). They live in this source so
// that the forward and its backward build into one library, bound by one
// wrapper (ops/dcn_cuda.py).

static bool dcn_shape_ok(int B, int H, int W, int C, int Ho, int Wo,
                         int stride) {
  return B >= 0 && H >= 1 && W >= 1 && C >= 1 && stride >= 1 && Ho >= 0 &&
         Wo >= 0 && (int64_t)B * H * W * C <= INT32_MAX &&
         (int64_t)B * Ho * Wo * kTaps <= INT32_MAX - kBwdItems;
}

// col (B * Ho * Wo, 9 * C) in x's dtype: the modulated samples rounded to
// x's dtype, exactly as the forward forms them. Returns 0 on success, else
// a cudaError_t code; *variant as dcn_fwd's.
extern "C" int dcn_bwd_im2col(const void* x, int dtype, const float* offset,
                              const float* mask, void* col, int B, int H,
                              int W, int C, int Ho, int Wo, int stride,
                              void* stream, int* variant) {
  if (!dcn_shape_ok(B, H, W, C, Ho, Wo, stride)) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = B * Ho * Wo;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return im2col_dispatch<float>(x, offset, mask, col, M, H, W, C, Ho, Wo,
                                  stride, s, variant);
  }
  if (dtype == 1) {
    return im2col_dispatch<__nv_bfloat16>(x, offset, mask, col, M, H, W, C,
                                          Ho, Wo, stride, s, variant);
  }
  return (int)cudaErrorInvalidValue;
}

// From dcol (B * Ho * Wo, 9 * C) in x's dtype, the gradient of the samples:
// grad_x (B, H, W, C) in x's dtype through the f32 scratch grad_x_f32
// (zero-filled here; for f32 x it is grad_x itself), grad_offset
// (B, Ho, Wo, 9, 2) and grad_mask (B, Ho, Wo, 9) in f32. Returns 0 on
// success, else a cudaError_t code; *variant is 1 when the quad variant
// ran, 0 when the general one did.
extern "C" int dcn_bwd_col2im(const void* x, int dtype, const float* offset,
                              const float* mask, const void* dcol,
                              float* grad_x_f32, void* grad_x,
                              float* grad_offset, float* grad_mask, int B,
                              int H, int W, int C, int Ho, int Wo, int stride,
                              void* stream, int* variant) {
  if (!dcn_shape_ok(B, H, W, C, Ho, Wo, stride)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_x = (int64_t)B * H * W * C;
  if (n_x > 0) {
    const cudaError_t e =
        cudaMemsetAsync(grad_x_f32, 0, n_x * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  const int M = B * Ho * Wo;
  if (M > 0) {
    const int err =
        dtype == 0
            ? col2im_dispatch<float>(x, offset, mask, dcol, grad_x_f32,
                                     grad_offset, grad_mask, M, H, W, C, Ho,
                                     Wo, stride, s, variant)
            : col2im_dispatch<__nv_bfloat16>(x, offset, mask, dcol,
                                             grad_x_f32, grad_offset,
                                             grad_mask, M, H, W, C, Ho, Wo,
                                             stride, s, variant);
    if (err != 0) return err;
  }
  if (dtype == 1 && n_x > 0) {
    const int64_t blocks = (n_x + kThreads - 1) / kThreads;
    cast_bf16_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536),
                       kThreads, 0, s>>>(
        grad_x_f32, (__nv_bfloat16*)grad_x, n_x);
  }
  return (int)cudaGetLastError();
}
