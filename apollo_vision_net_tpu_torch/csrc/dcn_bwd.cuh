// Modulated deformable convolution v2 backward (3x3 taps) for Hopper
// (sm_90a): the sampling kernels. Included by dcn_fwd.cu, inside its
// anonymous namespace, after the forward's helpers (TapSample, tap_sample,
// unit_elem, pack_bf16x2, to_f32, store_elem); its C entries
// (dcn_bwd_im2col, dcn_bwd_col2im) are at the end of dcn_fwd.cu, and
// ops/dcn_cuda.py dcn_bwd composes them.
//
// The JAX package's backward of the Pallas kernel _dcn_kernel is the XLA
// VJP of _dcn_xla_ref (apollo_vision_net_tpu/ops/dcn_pallas.py:212-230,
// _dense_bwd :248-254): sample first, then contract the taps with the
// weight. It differentiates with respect to locations normalized to the
// input grid, this backward with respect to pixel offsets and the sigmoid
// mask; both compute the same function of the parameters. With
// sample[m, k, c] = mask[m, k] * sum_j bw_j * x[corner_j, c] rounded to
// x's dtype (col, the im2col matrix (M, 9 * C)) and g the output's
// gradient (M, O):
//   dcol        = g . W^T                               (M, 9 * C)
//   grad_weight = col^T . g                             (9 * C, O)
//   grad_x[corner_j, c]  += mask * bw_j * dcol[m, k, c]
//   grad_mask[m, k]       = sum_c dcol[m, k, c] * sum_j bw_j * x[corner_j, c]
//   grad_offset[m, k, xy] = mask * sum_c dcol[m, k, c]
//                                * sum_j dbw_j / d(px, py) * x[corner_j, c]
// (floor has no gradient; corners outside the image take no part). The two
// products stay torch.matmul in ops/dcn_cuda.py, as the JAX package leaves
// both to XLA einsums inside its VJP, outside any Pallas kernel; dcol is
// rounded to x's dtype there, as the plain version's cast of the samples
// rounds its gradient. The hand-written kernels are the sampling work:
//   - dcn_im2col_kernel writes col, each sample summed over its corners
//     with the forward's order and rounding (so grad_weight is the gradient
//     of what the forward computed);
//   - dcn_col2im_kernel reads dcol and x and gives grad_x (a bilinear
//     scatter into an f32 scratch with atomics, then cast to x's dtype),
//     grad_offset and grad_mask.
// Design: one warp per (pixel, tap) item, 8 a block. The warp forms the
// tap's corners once (tap_sample); vector variant (C a whole number of
// 16-byte units, x, col and dcol 16-byte aligned; the R101 shapes run it):
// each lane takes 16 bytes of channels at a time (8 bf16 or 4 f32), reads
// the four corner units with 16-byte loads and, in col2im, adds its share
// of the scatter with 16-byte vector atomics (sm_90) and its parts of the
// three dot products, which the warp then reduces with __shfl_xor_sync.
// General variant: the same with one channel a lane at a time.
//
// Bound: the two products, 2 x 2 * 9 * C * O operations a pixel (10.6
// GFLOP each at 30x50x256, ~0.021 ms at the dense bf16 tensor rate). In
// practice the scatter sets the pace: 4 corners x C f32 adds per (pixel,
// tap), ~83M a call at 30x50x256 on six cameras, issued as 16-byte
// atomics.

constexpr int kBwdItems = kThreads / 32;  // (pixel, tap) items a block

__device__ __forceinline__ float dcn_warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dcn_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, T* __restrict__ col, int M,
                  int H, int W, int C, int Ho, int Wo, int stride) {
  constexpr int VC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kBwdItems + (threadIdx.x >> 5);
  if (item >= M * kTaps) return;
  const int m = item / kTaps, tap = item - m * kTaps;
  const TapSample t = tap_sample(offset, mask, m, tap, H, W, C, Ho, Wo, stride);
  float wt[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wt[j] = t.idx[j] >= 0 ? __fmul_rn(t.bw[j], t.mk) : 0.f;
  T* out = col + (int64_t)item * C;  // col[m, tap * C + c]
  if constexpr (VEC) {
    for (int c = lane * VC; c < C; c += 32 * VC) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = t.idx[j] >= 0
                   ? __ldg(reinterpret_cast<const uint4*>(x + t.idx[j] + c))
                   : make_uint4(0, 0, 0, 0);
      }
      float s[VC];
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        s[e] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[e] = __fadd_rn(s[e], __fmul_rn(unit_elem(v[j], e, x), wt[j]));
        }
      }
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(out + c) =
            make_uint4(pack_bf16x2(s[0], s[1]), pack_bf16x2(s[2], s[3]),
                       pack_bf16x2(s[4], s[5]), pack_bf16x2(s[6], s[7]));
      } else {
        *reinterpret_cast<uint4*>(out + c) =
            make_uint4(__float_as_uint(s[0]), __float_as_uint(s[1]),
                       __float_as_uint(s[2]), __float_as_uint(s[3]));
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t.idx[j] >= 0) {
          s = __fadd_rn(s, __fmul_rn(to_f32(x[t.idx[j] + c]), wt[j]));
        }
      }
      store_elem(out + c, s);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dcn_col2im_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const T* __restrict__ dcol,
                  float* __restrict__ grad_x, float* __restrict__ grad_offset,
                  float* __restrict__ grad_mask, int M, int H, int W, int C,
                  int Ho, int Wo, int stride) {
  constexpr int VC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kBwdItems + (threadIdx.x >> 5);
  if (item >= M * kTaps) return;
  const int m = item / kTaps, tap = item - m * kTaps;
  const TapSample t = tap_sample(offset, mask, m, tap, H, W, C, Ho, Wo, stride);
  // per corner: the scatter weight mask * bw, and d bw / d px, d bw / d py
  // (all 0 outside the image)
  float wt[4], dbx[4], dby[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cx = j & 1, cy = j >> 1;
    const bool in = t.idx[j] >= 0;
    wt[j] = in ? t.bw[j] * t.mk : 0.f;
    dbx[j] = in ? (cx ? 1.f : -1.f) * (cy ? t.fy : 1.f - t.fy) : 0.f;
    dby[j] = in ? (cx ? t.fx : 1.f - t.fx) * (cy ? 1.f : -1.f) : 0.f;
  }
  const T* d = dcol + (int64_t)item * C;
  float sm = 0.f, sx = 0.f, sy = 0.f;
  if constexpr (VEC) {
    for (int c = lane * VC; c < C; c += 32 * VC) {
      const uint4 du = __ldg(reinterpret_cast<const uint4*>(d + c));
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = t.idx[j] >= 0
                   ? __ldg(reinterpret_cast<const uint4*>(x + t.idx[j] + c))
                   : make_uint4(0, 0, 0, 0);
      }
      float de[VC];
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        de[e] = unit_elem(du, e, d);
        float smp = 0.f, gx = 0.f, gy = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = unit_elem(v[j], e, x);
          smp = fmaf(t.bw[j], xv, smp);
          gx = fmaf(dbx[j], xv, gx);
          gy = fmaf(dby[j], xv, gy);
        }
        sm = fmaf(de[e], smp, sm);
        sx = fmaf(de[e], gx, sx);
        sy = fmaf(de[e], gy, sy);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t.idx[j] < 0) continue;
#pragma unroll
        for (int e = 0; e < VC; e += 4) {
          atomicAdd(reinterpret_cast<float4*>(grad_x + t.idx[j] + c + e),
                    make_float4(wt[j] * de[e], wt[j] * de[e + 1],
                                wt[j] * de[e + 2], wt[j] * de[e + 3]));
        }
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float de = to_f32(d[c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t.idx[j] < 0) continue;
        const float xv = to_f32(x[t.idx[j] + c]);
        sm = fmaf(de, t.bw[j] * xv, sm);
        sx = fmaf(de, dbx[j] * xv, sx);
        sy = fmaf(de, dby[j] * xv, sy);
        atomicAdd(grad_x + t.idx[j] + c, wt[j] * de);
      }
    }
  }
  sm = dcn_warp_sum(sm);
  sx = dcn_warp_sum(sx);
  sy = dcn_warp_sum(sy);
  if (lane == 0) {
    grad_mask[item] = sm;
    grad_offset[2 * (int64_t)item] = t.mk * sx;
    grad_offset[2 * (int64_t)item + 1] = t.mk * sy;
  }
}

// The vector variant when C is a whole number of 16-byte units and the
// tensors the kernel reads in 16-byte units are aligned; *variant = 1 / 0.
template <typename T>
bool dcn_bwd_vector(int C, const void* a, const void* b) {
  return C % (16 / (int)sizeof(T)) == 0 &&
         (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

template <typename T>
int im2col_dispatch(const void* x, const float* offset, const float* mask,
                    void* col, int M, int H, int W, int C, int Ho, int Wo,
                    int stride, cudaStream_t s, int* variant) {
  const unsigned grid = (unsigned)(((int64_t)M * kTaps + kBwdItems - 1) / kBwdItems);
  const bool vec = dcn_bwd_vector<T>(C, x, col);
  *variant = vec ? 1 : 0;
  if (vec) {
    dcn_im2col_kernel<T, true><<<grid, kThreads, 0, s>>>(
        (const T*)x, offset, mask, (T*)col, M, H, W, C, Ho, Wo, stride);
  } else {
    dcn_im2col_kernel<T, false><<<grid, kThreads, 0, s>>>(
        (const T*)x, offset, mask, (T*)col, M, H, W, C, Ho, Wo, stride);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int col2im_dispatch(const void* x, const float* offset, const float* mask,
                    const void* dcol, float* grad_x, float* grad_offset,
                    float* grad_mask, int M, int H, int W, int C, int Ho,
                    int Wo, int stride, cudaStream_t s, int* variant) {
  const unsigned grid = (unsigned)(((int64_t)M * kTaps + kBwdItems - 1) / kBwdItems);
  // grad_x is the wrapper's f32 scratch, 16-byte aligned
  const bool vec = dcn_bwd_vector<T>(C, x, dcol);
  *variant = vec ? 1 : 0;
  if (vec) {
    dcn_col2im_kernel<T, true><<<grid, kThreads, 0, s>>>(
        (const T*)x, offset, mask, (const T*)dcol, grad_x, grad_offset,
        grad_mask, M, H, W, C, Ho, Wo, stride);
  } else {
    dcn_col2im_kernel<T, false><<<grid, kThreads, 0, s>>>(
        (const T*)x, offset, mask, (const T*)dcol, grad_x, grad_offset,
        grad_mask, M, H, W, C, Ho, Wo, stride);
  }
  return (int)cudaGetLastError();
}
