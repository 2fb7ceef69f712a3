// Multi-scale deformable attention backward for Hopper (sm_90a).
//
// The gradient of the plain and masked MSDA entry (msda_fwd in
// msda_fwd.cu) with respect to value, the sampling locations and the
// attention weights. In the JAX package the backward of every MSDA Pallas
// kernel is the XLA VJP of ms_deform_attn_xla
// (apollo_vision_net_tpu/ops/msda_pallas.py:1468-1484, :1521-1537,
// :1586-1606); this kernel computes the same function, which is also what
// autograd gives through ms_deform_attn_ref (ops/msda.py).
//
// For a query q, head h, level l and point p with location (lx, ly),
// weight a and grad_out row g (D channels of head h):
//   px = lx * w_l - 0.5, py = ly * h_l - 0.5, fx = px - floor(px),
//   fy = py - floor(py); corner k = (cx, cy) in {0, 1}^2 at
//   (floor(px) + cx, floor(py) + cy) with bilinear weight
//   cw_k = (cx ? fx : 1 - fx) * (cy ? fy : 1 - fy), valid_k when inside the
//   grid, and dot_k = <g, value[corner k, h, :]>. Then
//   grad_attn            = sum_k valid_k * cw_k * dot_k
//   grad_value[corner k] += a * cw_k * valid_k * g
//   grad_loc.x           = a * w_l * sum_k valid_k * dcw_k/dfx * dot_k
//   grad_loc.y           = a * h_l * sum_k valid_k * dcw_k/dfy * dot_k
// (floor has no gradient). Queries of a tile whose mask is 0 get zero
// grad_loc and grad_attn and add nothing to grad_value, as the plain
// version's multiply by the mask gives.
//
// Layout: value (B, V, H, D) f32 or bf16; loc (B, Q, H, L, P, 2) f32; attn
// (B, Q, H, L, P) f32; tile_mask (B, ceil(Q / q_tile)) int32 or null;
// grad_out (B, Q, H * D) in value's dtype; grad_value (B, V, H, D) in
// value's dtype; grad_loc and grad_attn f32 like loc and attn. All
// contiguous.
//
// Design (simple first version):
//   1. The entry zero-fills an f32 scratch of value's shape
//      (cudaMemsetAsync); grad_value is accumulated there with atomicAdd
//      and, for bf16 value, cast once into grad_value by a second kernel.
//      The JAX VJP also accumulates in f32 and casts at the boundary.
//   2. One warp per (batch, query, head) item, 4 warps a block. Lane s
//      forms the corners, bilinear weights and fractions of sample s (in
//      rounds of 32 samples over the head's L * P) in registers.
//   3. The warp walks the samples one at a time: it takes the sample's
//      corner offsets and weights from the owner lane with __shfl_sync;
//      for each in-grid corner the lanes hold the head's channels (lane c
//      channel c when D <= 32, the "lane_per_channel" variant; chunks of 32
//      channels otherwise, the "chunked" variant), read the corner row and
//      g, add a * cw * g to the scratch row with atomicAdd and reduce
//      <g, v> across the lanes with __shfl_xor_sync. The owner lane keeps
//      the four dot products of its sample.
//   4. Each lane writes its sample's grad_loc and grad_attn.
// The level table (w, h, first cell) is staged in shared memory once per
// block; the corners are formed by msda_common.cuh's bilinear_at, as the
// forward forms them.

#include "msda_common.cuh"

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  return v;
}

constexpr int kBwdWarps = 4;  // warps per block, one (batch, query, head) each

template <typename T, bool kOnePass>
__global__ void __launch_bounds__(kBwdWarps * 32)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn,
                const int* __restrict__ tile_mask,
                const T* __restrict__ grad_out, float* __restrict__ grad_value,
                float* __restrict__ grad_loc, float* __restrict__ grad_attn,
                int B, int V, int H, int D, int Q, int P, int LP, int q_tile,
                int n_tiles, MsdaLevels lv) {
  __shared__ SharedLevels sl;
  stage_levels(sl, lv);

  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (item >= B * Q * H) return;
  const int bq = item / H, hh = item - bq * H;
  const int b = bq / Q;
  const int row = H * D;  // elements between value cells
  const float* lq = loc + (int64_t)item * LP * 2;
  const float* aq = attn + (int64_t)item * LP;
  float* glq = grad_loc + (int64_t)item * LP * 2;
  float* gaq = grad_attn + (int64_t)item * LP;
  if (tile_mask != nullptr &&
      __ldg(tile_mask + (int64_t)b * n_tiles + (bq - b * Q) / q_tile) == 0) {
    for (int i = lane; i < LP; i += 32) {
      glq[2 * i] = 0.f;
      glq[2 * i + 1] = 0.f;
      gaq[i] = 0.f;
    }
    return;
  }
  const T* vb = value + (int64_t)b * V * row + hh * D;
  float* gvb = grad_value + (int64_t)b * V * row + hh * D;
  const T* go = grad_out + (int64_t)bq * row + hh * D;
  const float g_lane = (kOnePass && lane < D) ? load_f32(go + lane) : 0.f;

  for (int r0 = 0; r0 < LP; r0 += 32) {
    const int i = r0 + lane;  // the lane's sample
    Bilinear4 c = {{-1, -1, -1, -1}, {0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
    float a = 0.f, wl = 0.f, hl = 0.f;
    if (i < LP) {
      const int l = i / P;
      wl = sl.whi[l].x;
      hl = sl.whi[l].y;
      a = __ldg(aq + i);
      c = bilinear_at(sl, l, __ldg(lq + 2 * i), __ldg(lq + 2 * i + 1), row);
    }
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    const int ns = min(32, LP - r0);
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // the same for every lane: the warp takes the branch as one
        const int id = __shfl_sync(FULL_MASK, c.idx[k], s);
        if (id < 0) continue;
        const float wv = __shfl_sync(FULL_MASK, a * c.cw[k], s);
        float part = 0.f;
        if (kOnePass) {
          if (lane < D) {
            part = g_lane * load_f32(vb + id + lane);
            atomicAdd(gvb + id + lane, wv * g_lane);
          }
        } else {
          for (int ch = lane; ch < D; ch += 32) {
            const float g = load_f32(go + ch);
            part = fmaf(g, load_f32(vb + id + ch), part);
            atomicAdd(gvb + id + ch, wv * g);
          }
        }
        part = warp_sum(part);
        if (lane == s) dot[k] = part;
      }
    }
    if (i < LP) {
      // cw and dot are 0 for a corner outside the grid
      const float v0 = c.idx[0] >= 0, v1 = c.idx[1] >= 0,
                  v2 = c.idx[2] >= 0, v3 = c.idx[3] >= 0;
      const float fx = c.fx, fy = c.fy;
      const float ga = c.cw[0] * dot[0] + c.cw[1] * dot[1] +
                       c.cw[2] * dot[2] + c.cw[3] * dot[3];
      const float gfx = -(1.f - fy) * v0 * dot[0] + (1.f - fy) * v1 * dot[1] -
                        fy * v2 * dot[2] + fy * v3 * dot[3];
      const float gfy = -(1.f - fx) * v0 * dot[0] - fx * v1 * dot[1] +
                        (1.f - fx) * v2 * dot[2] + fx * v3 * dot[3];
      glq[2 * i] = a * gfx * wl;
      glq[2 * i + 1] = a * gfy * hl;
      gaq[i] = ga;
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 __nv_bfloat16* __restrict__ dst, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

template <typename T>
static int launch_bwd(cudaStream_t s, const void* value, const float* loc,
                      const float* attn, const int* tile_mask,
                      const void* grad_out, float* grad_value, float* grad_loc,
                      float* grad_attn, int B, int V, int H, int D, int Q,
                      int P, int LP, int q_tile, int n_tiles,
                      const MsdaLevels& lv) {
  const unsigned grid =
      (unsigned)(((int64_t)B * Q * H + kBwdWarps - 1) / kBwdWarps);
  if (D <= 32) {
    msda_bwd_kernel<T, true><<<grid, kBwdWarps * 32, 0, s>>>(
        (const T*)value, loc, attn, tile_mask, (const T*)grad_out, grad_value,
        grad_loc, grad_attn, B, V, H, D, Q, P, LP, q_tile, n_tiles, lv);
    return 1;
  }
  msda_bwd_kernel<T, false><<<grid, kBwdWarps * 32, 0, s>>>(
      (const T*)value, loc, attn, tile_mask, (const T*)grad_out, grad_value,
      grad_loc, grad_attn, B, V, H, D, Q, P, LP, q_tile, n_tiles, lv);
  return 0;
}

// Returns 0 on success, else a cudaError_t code. shapes points to 2 * L host
// ints (h0, w0, h1, w1, ...); tile_mask may be null; dtype 0 = f32, 1 =
// bf16. grad_value_f32 is the f32 scratch of value's shape (zero-filled
// here); for f32 value it is grad_value itself. *variant is set to 1 when
// the lane-per-channel variant ran (D <= 32), 0 when the chunked one did.
extern "C" int msda_bwd(const void* value, int dtype, const float* loc,
                        const float* attn, const int* tile_mask,
                        const void* grad_out, float* grad_value_f32,
                        void* grad_value, float* grad_loc, float* grad_attn,
                        int B, int V, int H, int D, int Q, int L, int P,
                        const int* shapes, int q_tile, void* stream,
                        int* variant) {
  MsdaLevels lv;
  if (q_tile < 1 || D < 1 || P < 1 || (int64_t)V * H * D > INT32_MAX ||
      (int64_t)B * Q * H > INT32_MAX - kBwdWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = fill_levels(&lv, L, shapes, V);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_value = (int64_t)B * V * H * D;
  if (n_value > 0) {
    const cudaError_t e =
        cudaMemsetAsync(grad_value_f32, 0, n_value * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_tiles = (Q + q_tile - 1) / q_tile;
  if ((int64_t)B * Q * H > 0) {
    if (dtype == 0) {
      *variant = launch_bwd<float>(s, value, loc, attn, tile_mask, grad_out,
                                   grad_value_f32, grad_loc, grad_attn, B, V,
                                   H, D, Q, P, L * P, q_tile, n_tiles, lv);
    } else if (dtype == 1) {
      *variant = launch_bwd<__nv_bfloat16>(
          s, value, loc, attn, tile_mask, grad_out, grad_value_f32, grad_loc,
          grad_attn, B, V, H, D, Q, P, L * P, q_tile, n_tiles, lv);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1 && n_value > 0) {
    const int64_t blocks = (n_value + 255) / 256;
    cast_bf16_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
                       s>>>(grad_value_f32, (__nv_bfloat16*)grad_value,
                            n_value);
  }
  return (int)cudaGetLastError();
}
