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
//     of what the forward computed): one warp per (pixel, tap), 16 bytes of
//     channels a lane in its vector variant;
//   - dcn_dinput_kernel (the "quad" variant: C a multiple of 4, x and dcol
//     aligned to 4 channels; the R101 shapes run it) reads dcol and x and
//     gives grad_x (into an f32 scratch, then cast to x's dtype),
//     grad_offset and grad_mask; dcn_col2im_kernel does the same for any C
//     or alignment (the "general" variant, one channel a lane).
//
// What bounds it on the H100. As a function: the two products, 2 x 2 * 9 *
// C * O operations a pixel (10.6 GFLOP each at 30x50x256, ~0.021 ms at the
// dense bf16 tensor rate). The first design's split (PERF.md §6, bf16 at
// 30x50x256, 0.317 ms a call): col2im 0.212 ms, im2col 0.033, the two
// cuBLAS products 0.056, memset and cast 0.012. col2im was set by its
// scatter, ~83M f32 adds a call as 16-byte global atomics: 8 bf16 channels
// a lane made two atomics 16 bytes apart per lane and corner, so each warp
// instruction touched twice the L2 sectors that f32's one atomic a lane
// does (the same kernel ran 0.119 ms in f32). This design's split, the
// same shape (0.219 ms): d-input 0.115, im2col 0.031, grad_weight product
// 0.033, dcol product 0.024, memset and cast 0.012; the scatter's atomics
// still set the pace.
//
// dcn_dinput_kernel's design: one warp per (pixel, tap), 8 a block; it
// forms the tap's corners once (tap_sample), and each lane takes 4
// channels of a 128-channel pass (8-byte bf16 or 16-byte f32 loads of dcol
// and of the four corner rows), two passes in flight at once. Each corner
// add is one 16-byte atomic a lane, so a warp's adds to a corner row are 32
// contiguous 16-byte pieces, in both dtypes. d mask and d offset are
// reduced over the warp with __shfl_xor_sync and written once. Tried on
// the card and dropped (PERF.md §6):
//   - a shared f32 window over each 8 x 8 output tile's input pixels
//     (sm_90 compiles an f32 shared-memory atomic into a compare-and-swap
//     loop; 0.417 ms at 30x50x256 bf16), and the same window summed
//     through a per-block counting sort (integer shared atomics, native;
//     0.296 ms): the scatter's global atomics cost less than either;
//   - dcol formed inside the d-input kernel and used at once (bf16: a
//     block's 64 pixels x 128 channels of one tap by mma.sync m16n8k16
//     from grad_out and the weight rows through a cp.async ring, rounded
//     to bf16 in shared memory, then this kernel's scatter): 0.149 ms
//     against 0.139 for the dcol product and this kernel at 30x50x256,
//     0.112 against 0.073 at 15x25x512. It re-reads grad_out once per
//     (tap, channel tile) and the weights once per pixel tile, ~250 MB of
//     L2 reads a call, as cuBLAS does, while saving only dcol's 83 MB round
//     trip, and its products do not overlap the scatter's atomics, which
//     share the same L2.
// The grad_weight product stays cuBLAS after im2col for the same reason:
// the forward (dcn_fwd_kernel) is that product with the gather fused, and
// takes 0.13 ms at these shapes where im2col and cuBLAS take 0.064.

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

// The general variant: one warp per (pixel, tap), one channel a lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_col2im_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const T* __restrict__ dcol,
                  float* __restrict__ grad_x, float* __restrict__ grad_offset,
                  float* __restrict__ grad_mask, int M, int H, int W, int C,
                  int Ho, int Wo, int stride) {
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
  sm = dcn_warp_sum(sm);
  sx = dcn_warp_sum(sx);
  sy = dcn_warp_sum(sy);
  if (lane == 0) {
    grad_mask[item] = sm;
    grad_offset[2 * (int64_t)item] = t.mk * sx;
    grad_offset[2 * (int64_t)item + 1] = t.mk * sy;
  }
}

// Four channels of x or dcol as loaded (8 bytes of bf16, 16 of f32).
__device__ __forceinline__ uint2 dcn_raw4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 dcn_raw4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void dcn_f32x4(float* f, uint2 v) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void dcn_f32x4(float* f, float4 v) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// The quad d-input kernel (see the design notes at the top).
constexpr int kQuadBatch = 2;  // 128-channel passes a lane has in flight

template <typename T>
__global__ void __launch_bounds__(kThreads)
dcn_dinput_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const T* __restrict__ dcol,
                  float* __restrict__ grad_x, float* __restrict__ grad_offset,
                  float* __restrict__ grad_mask, int M, int H, int W, int C,
                  int Ho, int Wo, int stride) {
  using Raw = decltype(dcn_raw4(dcol));
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
  for (int c0 = lane * 4; c0 < C; c0 += 128 * kQuadBatch) {
    Raw dr[kQuadBatch], vr[kQuadBatch][4];
#pragma unroll
    for (int r = 0; r < kQuadBatch; ++r) {  // the loads in flight
      const int c = c0 + r * 128;
      dr[r] = c < C ? dcn_raw4(d + c) : Raw{};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vr[r][j] = c < C && t.idx[j] >= 0 ? dcn_raw4(x + t.idx[j] + c) : Raw{};
      }
    }
#pragma unroll
    for (int r = 0; r < kQuadBatch; ++r) {
      const int c = c0 + r * 128;
      float de[4], v[4][4];
      dcn_f32x4(de, dr[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) dcn_f32x4(v[j], vr[r][j]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float smp = 0.f, gx = 0.f, gy = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          smp = fmaf(t.bw[j], v[j][q], smp);
          gx = fmaf(dbx[j], v[j][q], gx);
          gy = fmaf(dby[j], v[j][q], gy);
        }
        sm = fmaf(de[q], smp, sm);
        sx = fmaf(de[q], gx, sx);
        sy = fmaf(de[q], gy, sy);
      }
      if (c < C) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (t.idx[j] < 0) continue;
          atomicAdd(reinterpret_cast<float4*>(grad_x + t.idx[j] + c),
                    make_float4(wt[j] * de[0], wt[j] * de[1], wt[j] * de[2],
                                wt[j] * de[3]));
        }
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

// im2col's vector variant when C is a whole number of 16-byte units and x
// and col are 16-byte aligned; *variant = 1 / 0.
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

// The quad variant (dcn_dinput_kernel) when C is a multiple of 4 and x and
// dcol are aligned to 4 channels: *variant = 1; else the general variant
// (dcn_col2im_kernel, 0).
template <typename T>
int col2im_dispatch(const void* x, const float* offset, const float* mask,
                    const void* dcol, float* grad_x, float* grad_offset,
                    float* grad_mask, int M, int H, int W, int C, int Ho,
                    int Wo, int stride, cudaStream_t s, int* variant) {
  const unsigned grid = (unsigned)(((int64_t)M * kTaps + kBwdItems - 1) / kBwdItems);
  // grad_x is the wrapper's f32 scratch, 16-byte aligned
  const bool quad = C % 4 == 0 &&
                    (((uintptr_t)x | (uintptr_t)dcol) % (4 * sizeof(T))) == 0;
  *variant = quad ? 1 : 0;
  if (quad) {
    dcn_dinput_kernel<T><<<grid, kThreads, 0, s>>>(
        (const T*)x, offset, mask, (const T*)dcol, grad_x, grad_offset,
        grad_mask, M, H, W, C, Ho, Wo, stride);
  } else {
    dcn_col2im_kernel<T><<<grid, kThreads, 0, s>>>(
        (const T*)x, offset, mask, (const T*)dcol, grad_x, grad_offset,
        grad_mask, M, H, W, C, Ho, Wo, stride);
  }
  return (int)cudaGetLastError();
}
