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
// x's dtype.
//
// Layout: x (B, H, W, C), offset (B, Ho, Wo, 9, 2) f32, mask (B, Ho, Wo, 9)
// f32, weight (9, C, O) in x's dtype, out (B, Ho, Wo, O), all contiguous.
//
// Design: a block computes a tile of 64 output pixels x 64 output channels
// with 256 threads. It first computes, for its 64 pixels and 9 taps, the
// four corner indices and modulated bilinear weights into shared memory.
// Then it walks the 9*C reduction in chunks of 32: the threads gather the
// chunk's samples (pixel x (tap, channel), neighbouring threads on
// neighbouring channels, so each corner read is a coalesced row of x) and
// stage the matching rows of the weight, then multiply. f32: each thread
// accumulates a 4x4 sub-tile with FMAs on the CUDA cores. bf16: the samples
// and weights are staged in bf16 and each warp multiplies a 16x32 sub-tile
// on the tensor cores (WMMA m16n16k16, f32 accumulators).
//
// Bound: operations. Each call at the base shapes is 10.6 GFLOP
// (2*6*1500*2304*256 in stage 3, 2*6*375*4608*512 in stage 4) on a few MB,
// 10.7 us at the H100's dense bf16 tensor rate; 26 calls a frame. This first
// version is simple and right; feeding the tensor cores faster (wgmma, TMA
// for the weight, a larger tile, fewer re-gathers across output tiles) is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // reduction chunk
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Corner indices (flat pixel of x, or -1 outside the image) and modulated
// bilinear weights of the block's pixels for every tap.
struct Corners {
  int idx[kTaps * 4][BM];
  float wt[kTaps * 4][BM];
};

__device__ void fill_corners(Corners& cs, const float* __restrict__ offset,
                             const float* __restrict__ mask, int m0, int M,
                             int H, int W, int Ho, int Wo, int stride) {
  const int Q = Ho * Wo;
  for (int e = threadIdx.x; e < kTaps * BM; e += kThreads) {
    const int tap = e / BM, i = e % BM;
    const int m = m0 + i;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < M) {
      const int b = m / Q, q = m % Q;
      const int oy = q / Wo, ox = q % Wo;
      const float* om = offset + ((int64_t)m * kTaps + tap) * 2;
      const float px = (float)(ox * stride + tap % 3 - 1) + om[0];
      const float py = (float)(oy * stride + tap / 3 - 1) + om[1];
      const float mk = mask[(int64_t)m * kTaps + tap];
      const float fx0 = floorf(px), fy0 = floorf(py);
      const float fx = px - fx0, fy = py - fy0;
      const int x0 = (int)fx0, y0 = (int)fy0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cx = j & 1, cy = j >> 1;
        const int xx = x0 + cx, yy = y0 + cy;
        if (xx >= 0 && xx < W && yy >= 0 && yy < H) {
          idx[j] = (b * H + yy) * W + xx;
          wt[j] = (cx ? fx : 1.f - fx) * (cy ? fy : 1.f - fy) * mk;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cs.idx[tap * 4 + j][i] = idx[j];
      cs.wt[tap * 4 + j][i] = wt[j];
    }
  }
}

// The modulated bilinear sample of pixel i at reduction index k = tap*C + c.
template <typename T>
__device__ __forceinline__ float gather(const Corners& cs,
                                        const T* __restrict__ x, int i, int k,
                                        int C) {
  const int tap = k / C, c = k - tap * C;
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int id = cs.idx[tap * 4 + j][i];
    if (id >= 0) v += cs.wt[tap * 4 + j][i] * to_f32(x[(int64_t)id * C + c]);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
dcn_fwd_f32_kernel(const float* __restrict__ x,
                   const float* __restrict__ offset,
                   const float* __restrict__ mask,
                   const float* __restrict__ weight, float* __restrict__ out,
                   int M, int H, int W, int C, int Ho, int Wo, int O,
                   int stride) {
  __shared__ Corners cs;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ty = tid / 16, tx = tid % 16;
  const int Kdim = kTaps * C;
  fill_corners(cs, offset, mask, m0, M, H, W, Ho, Wo, stride);
  __syncthreads();

  float acc[4][4] = {};
  for (int k0 = 0; k0 < Kdim; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int i = e / BK, kk = e % BK;
      As[kk][i] = k0 + kk < Kdim ? gather(cs, x, i, k0 + kk, C) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, n = e % BN;
      const int k = k0 + kk, o = n0 + n;
      Bs[kk][n] = (k < Kdim && o < O) ? weight[(int64_t)k * O + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] += av[r] * bv[s];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int o = n0 + tx * 4 + s;
      if (o < O) out[(int64_t)m * O + o] = acc[r][s];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dcn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ offset,
                    const float* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ weight,
                    __nv_bfloat16* __restrict__ out, int M, int H, int W,
                    int C, int Ho, int Wo, int O, int stride) {
  using namespace nvcuda;
  constexpr int LA = BK + 8, LB = BN + 8, LC = BN + 4;  // padded strides
  __shared__ Corners cs;
  __shared__ __align__(32) __nv_bfloat16 As[BM][LA];  // pixel x k
  __shared__ __align__(32) __nv_bfloat16 Bs[BK][LB];  // k x out channel
  __shared__ __align__(32) float Cs[BM][LC];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 16-row x 32-column sub-tile
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int Kdim = kTaps * C;
  fill_corners(cs, offset, mask, m0, M, H, W, Ho, Wo, stride);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k0 = 0; k0 < Kdim; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int i = e / BK, kk = e % BK;
      As[i][kk] = __float2bfloat16(
          k0 + kk < Kdim ? gather(cs, x, i, k0 + kk, C) : 0.f);
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, n = e % BN;
      const int k = k0 + kk, o = n0 + n;
      Bs[kk][n] = (k < Kdim && o < O) ? weight[(int64_t)k * O + o]
                                      : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, &As[wm * 16][ks], LA);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[ks][wn * 32 + f * 16], LB);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(&Cs[wm * 16][wn * 32 + f * 16], acc[f], LC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int i = e / BN, n = e % BN;
    const int m = m0 + i, o = n0 + n;
    if (m < M && o < O) out[(int64_t)m * O + o] = __float2bfloat16(Cs[i][n]);
  }
}

}  // namespace

// Returns 0 on success, else a cudaError_t code. dtype 0 = f32, 1 = bf16
// (x, weight and out share it).
extern "C" int dcn_fwd(const void* x, int dtype, const float* offset,
                       const float* mask, const void* weight, void* out, int B,
                       int H, int W, int C, int Ho, int Wo, int O, int stride,
                       void* stream) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || O < 1 || stride < 1 || Ho < 0 ||
      Wo < 0 || (int64_t)B * H * W > INT32_MAX ||
      (int64_t)B * Ho * Wo > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = B * Ho * Wo;
  if (M == 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    dcn_fwd_f32_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)x, offset, mask, (const float*)weight, (float*)out, M,
        H, W, C, Ho, Wo, O, stride);
  } else if (dtype == 1) {
    dcn_fwd_bf16_kernel<<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, offset, mask, (const __nv_bfloat16*)weight,
        (__nv_bfloat16*)out, M, H, W, C, Ho, Wo, O, stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
