// Multi-scale deformable attention backward for Hopper (sm_90a).
//
// Two entries: msda_bwd, the gradient of the plain and masked MSDA entry
// (msda_fwd in msda_fwd.cu) with respect to value, the sampling locations
// and the attention weights; and msda_bwd_factored, the gradient of the
// factored entry (msda_fwd_factored), described at its section below. In
// the JAX package the backward of every MSDA Pallas kernel is the XLA VJP
// of ms_deform_attn_xla (apollo_vision_net_tpu/ops/msda_pallas.py
// :1468-1484, :1521-1537, :1586-1606); these kernels compute the same
// functions, which are also what autograd gives through
// ms_deform_attn_ref (ops/msda.py).
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

#include "cast_bf16.cuh"
#include "msda_common.cuh"

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  return v;
}

constexpr int kBwdWarps = 4;  // warps per block, one (batch, query, head) each

// The gradients of one sample from its corners (c) and the dot products
// dot[k] = <g, value[corner k]>: d attn, and d (lx, ly) of its normalized
// location (floor has no gradient; cw and dot are 0 outside the grid).
struct SampleGrad {
  float attn, lx, ly;
};

__device__ __forceinline__ SampleGrad sample_grad(const Bilinear4& c,
                                                  const float* dot, float a,
                                                  float wl, float hl) {
  const float v0 = c.idx[0] >= 0, v1 = c.idx[1] >= 0, v2 = c.idx[2] >= 0,
              v3 = c.idx[3] >= 0;
  const float fx = c.fx, fy = c.fy;
  const float gfx = -(1.f - fy) * v0 * dot[0] + (1.f - fy) * v1 * dot[1] -
                    fy * v2 * dot[2] + fy * v3 * dot[3];
  const float gfy = -(1.f - fx) * v0 * dot[0] - fx * v1 * dot[1] +
                    (1.f - fx) * v2 * dot[2] + fx * v3 * dot[3];
  SampleGrad g;
  g.attn = c.cw[0] * dot[0] + c.cw[1] * dot[1] + c.cw[2] * dot[2] +
           c.cw[3] * dot[3];
  g.lx = a * gfx * wl;
  g.ly = a * gfy * hl;
  return g;
}

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
      const SampleGrad sg = sample_grad(c, dot, a, wl, hl);
      glq[2 * i] = sg.lx;
      glq[2 * i + 1] = sg.ly;
      gaq[i] = sg.attn;
    }
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

// ------------------------------------------------------- factored entry
//
// The gradient of msda_fwd_factored: the VJP of materialize_factored
// followed by the MSDA (apollo_vision_net_tpu/ops/msda_pallas.py
// _factored_bwd, :1586-1609, which differentiates the XLA composition).
// With loc = ref[b, q, p] + off[bs, q, h, l, p] * (1 / w_l, 1 / h_l) and the
// weights attn[bs, q, h, l, p] shared by the N cameras b = bs * N + n:
//   grad_value[b]            bilinear scatter, as msda_bwd
//   grad_off[bs, q, h, l, p] = sum_n d loc[b, q, h, l, p] * (1 / w_l, 1 / h_l)
//   grad_attn[bs, q, h, l, p] = sum_n <g, sample>
//   grad_ref[b, q, p]        = sum_{h, l} d loc[b, q, h, l, p]  (optional)
// A masked (camera, tile) reads nothing and adds nothing.
//
// Design: one warp per (bs, query, head) item; it walks the N cameras of
// the sample and skips a camera whose tile is masked (476 of 1,878 tiles
// are active at the base SCA shape). Lane s owns sample s of the head (in
// rounds of 32 over L * P; 32 at the base shape) and keeps its d off and
// d attn in registers across the cameras: no atomics there, and the same
// result every run. Vector variant (msda_bwd_factored_vec_kernel; D = 4 * G
// with G in {1, 2, 4, 8}; value and grad_out aligned to 4 channels): G
// lanes hold one corner row, 4 channels each, so one warp instruction
// serves 32 / G corner rows; each lane loads its 4 channels of g once per
// camera, forms its part of <g, v> and adds a * cw * g to the f32 scratch
// with one 16-byte vector atomic (sm_90), so a row's adds are contiguous
// (16-byte value units, 8 bf16 a lane, put each lane's two atomics 32
// bytes apart and ran bf16 at 4.85 ms against f32's 2.51 ms, H100); the
// G lanes' parts are reduced with __shfl_xor_sync and handed to the
// sample's owner lane. General variant
// (msda_bwd_factored_scalar_kernel; any D or alignment): the lanes walk the
// channels of each (sample, corner) one at a time, as msda_bwd's chunked
// variant. grad_ref, when asked for, takes f32 atomicAdds (a (camera,
// query, point) sums over heads and levels); the model's reference points
// are camera geometry and need none.
//
// Bound: bytes, ~0.1 ms a bf16 call at the base SCA shape (6 cameras x
// 40,000 queries over 4 levels, H = 8, D = 32, L * P = 32; grad_out of the
// active tiles, off, attn and ref read once, the touched value rows read
// once, d off, d attn and d value written once). What sets the pace is the
// scatter into the f32 scratch: 128 corner rows x 32 channels per active
// (camera, query, head), ~2.0e9 f32 adds a call, which the vector variant
// issues as 16-byte atomics of 4 adds each.

// Four channels as f32, from one 8-byte (bf16) or 16-byte (f32) load.
__device__ __forceinline__ void load4(float* f, const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(float* f, const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// The (bs, query, head) item of a warp (item = (bs * Q + q) * H + hh).
struct FactoredBwdItem {
  int bs, q, hh;
};

__device__ __forceinline__ FactoredBwdItem factored_bwd_item(int item, int H,
                                                             int Q) {
  FactoredBwdItem it;
  const int sq = item / H;
  it.hh = item - sq * H;
  it.bs = sq / Q;
  it.q = sq - it.bs * Q;
  return it;
}

// d off and d ref of one sample from its d loc; d attn is summed by the
// caller.
__device__ __forceinline__ void add_loc_grad(const SampleGrad& sg,
                                             const float4& f, float* gox,
                                             float* goy, float* gref) {
  *gox += sg.lx * f.z;
  *goy += sg.ly * f.w;
  if (gref != nullptr) {
    atomicAdd(gref, sg.lx);
    atomicAdd(gref + 1, sg.ly);
  }
}

// G = D / 4 lanes hold one corner row, 4 channels each.
template <typename T, int G>
__global__ void __launch_bounds__(kBwdWarps * 32)
msda_bwd_factored_vec_kernel(const T* __restrict__ value,
                             const float* __restrict__ ref,
                             const float* __restrict__ off,
                             const float* __restrict__ attn,
                             const int* __restrict__ tile_mask,
                             const T* __restrict__ grad_out,
                             float* __restrict__ grad_value,
                             float* __restrict__ grad_ref,
                             float* __restrict__ grad_off,
                             float* __restrict__ grad_attn, int Bs, int N,
                             int V, int H, int Q, int P, int LP, int q_tile,
                             int n_tiles, MsdaLevels lv) {
  constexpr int D = 4 * G;
  constexpr int ROWS = 32 / G;  // corner rows per warp instruction
  __shared__ SharedLevels sl;
  stage_levels(sl, lv);

  const int lane = threadIdx.x & 31;
  const int grp = lane / G, sub = lane % G;
  const int item = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (item >= Bs * Q * H) return;
  const FactoredBwdItem it = factored_bwd_item(item, H, Q);
  const int row = H * D;  // elements between value cells
  const float* oq = off + (int64_t)item * LP * 2;
  const float* aq = attn + (int64_t)item * LP;

  for (int r0 = 0; r0 < LP; r0 += 32) {
    const int i = r0 + lane;  // the lane's sample
    const bool own = i < LP;
    const int l = own ? i / P : 0, p = own ? i - l * P : 0;
    const float ox = own ? __ldg(oq + 2 * i) : 0.f;
    const float oy = own ? __ldg(oq + 2 * i + 1) : 0.f;
    const float a = own ? __ldg(aq + i) : 0.f;
    const float4 f = sl.whi[l];
    float gox = 0.f, goy = 0.f, ga = 0.f;
    for (int n = 0; n < N; ++n) {
      const int b = it.bs * N + n;
      // the same for every lane: the warp skips the camera as one
      if (tile_mask != nullptr &&
          __ldg(tile_mask + (int64_t)b * n_tiles + it.q / q_tile) == 0) {
        continue;
      }
      const int64_t bq = (int64_t)b * Q + it.q;
      Bilinear4 c = {{-1, -1, -1, -1}, {0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
      if (own) {
        const float2 xy = factored_loc(sl, l, __ldg(ref + bq * P * 2 + 2 * p),
                                       __ldg(ref + bq * P * 2 + 2 * p + 1),
                                       ox, oy);
        c = bilinear_at(sl, l, xy.x, xy.y, row);
      }
      float g[4];
      load4(g, grad_out + bq * row + it.hh * D + sub * 4);
      const T* vb = value + (int64_t)b * V * row + it.hh * D + sub * 4;
      float* gvb = grad_value + (int64_t)b * V * row + it.hh * D + sub * 4;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // corner
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int src = t * ROWS + grp;  // owner lane of the group's row
          // the same for the G lanes of a group
          const int id = __shfl_sync(FULL_MASK, c.idx[k], src);
          const float wv = __shfl_sync(FULL_MASK, a * c.cw[k], src);
          float part = 0.f;
          if (id >= 0) {
            float v[4];
            load4(v, vb + id);
            part = g[0] * v[0] + g[1] * v[1] + g[2] * v[2] + g[3] * v[3];
            // the G lanes' 16-byte adds cover the row's D f32 contiguously
            atomicAdd(reinterpret_cast<float4*>(gvb + id),
                      make_float4(wv * g[0], wv * g[1], wv * g[2], wv * g[3]));
          }
#pragma unroll
          for (int m = 1; m < G; m <<= 1) {
            part += __shfl_xor_sync(FULL_MASK, part, m);
          }
          // the owner lanes of this step's rows take their group's sum
          const float d = __shfl_sync(FULL_MASK, part, (lane % ROWS) * G);
          if (lane / ROWS == t) dot[k] = d;
        }
      }
      if (own) {
        const SampleGrad sg = sample_grad(c, dot, a, f.x, f.y);
        ga += sg.attn;
        add_loc_grad(sg, f, &gox, &goy,
                     grad_ref != nullptr ? grad_ref + bq * P * 2 + 2 * p
                                         : nullptr);
      }
    }
    if (own) {
      grad_off[(int64_t)item * LP * 2 + 2 * i] = gox;
      grad_off[(int64_t)item * LP * 2 + 2 * i + 1] = goy;
      grad_attn[(int64_t)item * LP + i] = ga;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
msda_bwd_factored_scalar_kernel(const T* __restrict__ value,
                                const float* __restrict__ ref,
                                const float* __restrict__ off,
                                const float* __restrict__ attn,
                                const int* __restrict__ tile_mask,
                                const T* __restrict__ grad_out,
                                float* __restrict__ grad_value,
                                float* __restrict__ grad_ref,
                                float* __restrict__ grad_off,
                                float* __restrict__ grad_attn, int Bs, int N,
                                int V, int H, int D, int Q, int P, int LP,
                                int q_tile, int n_tiles, MsdaLevels lv) {
  __shared__ SharedLevels sl;
  stage_levels(sl, lv);

  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (item >= Bs * Q * H) return;
  const FactoredBwdItem it = factored_bwd_item(item, H, Q);
  const int row = H * D;
  const float* oq = off + (int64_t)item * LP * 2;
  const float* aq = attn + (int64_t)item * LP;

  for (int r0 = 0; r0 < LP; r0 += 32) {
    const int i = r0 + lane;
    const bool own = i < LP;
    const int l = own ? i / P : 0, p = own ? i - l * P : 0;
    const float ox = own ? oq[2 * i] : 0.f, oy = own ? oq[2 * i + 1] : 0.f;
    const float a = own ? aq[i] : 0.f;
    const float4 f = sl.whi[l];
    const int ns = min(32, LP - r0);
    float gox = 0.f, goy = 0.f, ga = 0.f;
    for (int n = 0; n < N; ++n) {
      const int b = it.bs * N + n;
      if (tile_mask != nullptr &&
          __ldg(tile_mask + (int64_t)b * n_tiles + it.q / q_tile) == 0) {
        continue;
      }
      const int64_t bq = (int64_t)b * Q + it.q;
      Bilinear4 c = {{-1, -1, -1, -1}, {0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
      if (own) {
        const float2 xy = factored_loc(sl, l, ref[bq * P * 2 + 2 * p],
                                       ref[bq * P * 2 + 2 * p + 1], ox, oy);
        c = bilinear_at(sl, l, xy.x, xy.y, row);
      }
      const T* vb = value + (int64_t)b * V * row + it.hh * D;
      float* gvb = grad_value + (int64_t)b * V * row + it.hh * D;
      const T* go = grad_out + bq * row + it.hh * D;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < ns; ++s) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int id = __shfl_sync(FULL_MASK, c.idx[k], s);
          if (id < 0) continue;  // the same for every lane
          const float wv = __shfl_sync(FULL_MASK, a * c.cw[k], s);
          float part = 0.f;
          for (int ch = lane; ch < D; ch += 32) {
            const float gc = load_f32(go + ch);
            part = fmaf(gc, load_f32(vb + id + ch), part);
            atomicAdd(gvb + id + ch, wv * gc);
          }
          part = warp_sum(part);
          if (lane == s) dot[k] = part;
        }
      }
      if (own) {
        const SampleGrad sg = sample_grad(c, dot, a, f.x, f.y);
        ga += sg.attn;
        add_loc_grad(sg, f, &gox, &goy,
                     grad_ref != nullptr ? grad_ref + bq * P * 2 + 2 * p
                                         : nullptr);
      }
    }
    if (own) {
      grad_off[(int64_t)item * LP * 2 + 2 * i] = gox;
      grad_off[(int64_t)item * LP * 2 + 2 * i + 1] = goy;
      grad_attn[(int64_t)item * LP + i] = ga;
    }
  }
}

// The vector variant when D = 4 * G with G in {1, 2, 4, 8} and value and
// grad_out are aligned to 4 channels (16 bytes in f32, 8 in bf16), else
// the general one. Returns 1 / 0.
template <typename T>
static int launch_bwd_factored(unsigned grid, cudaStream_t s,
                               const void* value, const float* ref,
                               const float* off, const float* attn,
                               const int* tile_mask, const void* grad_out,
                               float* grad_value, float* grad_ref,
                               float* grad_off, float* grad_attn, int Bs,
                               int N, int V, int H, int D, int Q, int P,
                               int LP, int q_tile, int n_tiles,
                               const MsdaLevels& lv) {
  const bool aligned =
      (((uintptr_t)value | (uintptr_t)grad_out) % (4 * sizeof(T))) == 0 &&
      D % 4 == 0;
  const int G = aligned ? D / 4 : 0;
#define MSDA_BWD_VEC_CASE(G_)                                               \
  if (G == G_) {                                                            \
    msda_bwd_factored_vec_kernel<T, G_><<<grid, kBwdWarps * 32, 0, s>>>(    \
        (const T*)value, ref, off, attn, tile_mask, (const T*)grad_out,     \
        grad_value, grad_ref, grad_off, grad_attn, Bs, N, V, H, Q, P, LP,   \
        q_tile, n_tiles, lv);                                               \
    return 1;                                                               \
  }
  MSDA_BWD_VEC_CASE(1)
  MSDA_BWD_VEC_CASE(2)
  MSDA_BWD_VEC_CASE(4)
  MSDA_BWD_VEC_CASE(8)
#undef MSDA_BWD_VEC_CASE
  msda_bwd_factored_scalar_kernel<T><<<grid, kBwdWarps * 32, 0, s>>>(
      (const T*)value, ref, off, attn, tile_mask, (const T*)grad_out,
      grad_value, grad_ref, grad_off, grad_attn, Bs, N, V, H, D, Q, P, LP,
      q_tile, n_tiles, lv);
  return 0;
}

// The factored entry: value (B, V, H, D), ref (B, Q, P, 2), off
// (B / N, Q, H, L, P, 2), attn (B / N, Q, H, L, P), tile_mask
// (B, ceil(Q / q_tile)) or null, grad_out (B, Q, H * D) in value's dtype ->
// grad_value (through the f32 scratch grad_value_f32, as msda_bwd),
// grad_ref (like ref, f32; null when not wanted), grad_off and grad_attn
// (like off and attn, f32). *variant is set to 1 when the vector variant
// ran, 0 when the general one did.
extern "C" int msda_bwd_factored(const void* value, int dtype,
                                 const float* ref, const float* off,
                                 const float* attn, const int* tile_mask,
                                 const void* grad_out, float* grad_value_f32,
                                 void* grad_value, float* grad_ref,
                                 float* grad_off, float* grad_attn, int B,
                                 int N, int V, int H, int D, int Q, int L,
                                 int P, const int* shapes, int q_tile,
                                 void* stream, int* variant) {
  MsdaLevels lv;
  if (q_tile < 1 || D < 1 || P < 1 || N < 1 || B % N != 0 ||
      (int64_t)V * H * D > INT32_MAX ||
      (int64_t)B * Q * H > INT32_MAX - kBwdWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = fill_levels(&lv, L, shapes, V);
  if (err != 0) return err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int Bs = B / N;
  const int64_t n_value = (int64_t)B * V * H * D;
  if (n_value > 0) {
    const cudaError_t e =
        cudaMemsetAsync(grad_value_f32, 0, n_value * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (grad_ref != nullptr && (int64_t)B * Q * P > 0) {
    const cudaError_t e = cudaMemsetAsync(
        grad_ref, 0, (int64_t)B * Q * P * 2 * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t items = (int64_t)Bs * Q * H;
  if (items > 0) {
    const unsigned grid = (unsigned)((items + kBwdWarps - 1) / kBwdWarps);
    const int n_tiles = (Q + q_tile - 1) / q_tile;
    if (dtype == 0) {
      *variant = launch_bwd_factored<float>(
          grid, s, value, ref, off, attn, tile_mask, grad_out, grad_value_f32,
          grad_ref, grad_off, grad_attn, Bs, N, V, H, D, Q, P, L * P, q_tile,
          n_tiles, lv);
    } else {
      *variant = launch_bwd_factored<__nv_bfloat16>(
          grid, s, value, ref, off, attn, tile_mask, grad_out, grad_value_f32,
          grad_ref, grad_off, grad_attn, Bs, N, V, H, D, Q, P, L * P, q_tile,
          n_tiles, lv);
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
