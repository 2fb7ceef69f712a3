// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of apollo_vision_net_tpu/ops/msda_pallas.py:
//   - _msda_kernel         (decoder cross-attention, det and map decoders)
//   - _msda_kernel_slab    (temporal self-attention without a mask; spatial
//                           cross-attention with a per-(camera, query-tile)
//                           mask)
//   - _msda_kernel_masked  (the masked entry's contract, no slab)
//   - _msda_kernel_window  (200x200 TSA: the plain entry, exact; the TPU
//                           kernel's per-tile window clamp is not copied)
//   - _msda_kernel_ml_chunk (multi-level SCA on materialized operands: the
//                           masked entry at L = 4)
//   - _msda_kernel_pt2d    (multi-level SCA on factored operands: the
//                           msda_fwd_factored entry below)
// The Pallas kernels contract a one-hot bilinear mask against the whole
// value block on the TPU's matrix unit, because the TPU gathers rows slowly.
// Hopper gathers well, so these kernels gather the four bilinear corners
// directly.
//
// Semantics (equal to ms_deform_attn_ref in ops/msda.py):
//   out[b, q, h*D + c] = sum_{l, p} attn[b, q, h, l, p]
//                        * bilinear(value[b, level l, :, h, c], loc * (w, h) - 0.5)
// with zero padding outside the grid (grid_sample, align_corners=False) and
// f32 accumulation. value is f32 or bf16; loc and attn are f32; out has the
// dtype of value. With a tile mask (B, ceil(Q / q_tile)), a query tile whose
// mask is 0 writes zeros and reads nothing.
//
// Layout: value (B, V, H, D), loc (B, Q, H, L, P, 2), attn (B, Q, H, L, P),
// out (B, Q, H * D), all contiguous.
//
// The factored entry (SCA over several camera views, ops/msda.py
// ms_deform_attn_factored) takes, in place of loc and attn,
//   ref (B, Q, P, 2)          reference point per camera and point,
//   off (Bs, Q, H, L, P, 2)   offsets in cells of each level,
//   attn (Bs, Q, H, L, P)     weights,
// with B = Bs * N and the camera axis fast (b = bs * N + n): offsets and
// weights are shared by the N cameras of a sample. It forms
//   loc = ref[b, q, p] + off[b / N, q, h, l, p] / (w_l, h_l)
// in registers, so the (B, Q, H, L, P, 2) locations (491.5 MB f32 at the
// base SCA shape) are never written or read.
//
// Design: one warp per (batch, query, head), lanes across the D channels (a
// lane loops over channels when D > 32; lanes >= D idle when D < 32). Each
// lane reads its channel of the four corners, so a corner read is one
// coalesced 32-element row when D = 32.
//
// Bound: memory. Each input is read once and the output written once; at the
// flagship shapes and f32 value that is about 12.2 MB for TSA, 36 MB for SCA
// before the mask, 3.8 MB for the det decoder and 4.0 MB for the map decoder
// per call: ~190 MB, 57 us a frame at 3.35 TB/s (3 TSA, 3 SCA, 6 + 6 decoder
// calls). At the base shape the factored SCA call reads ~286 MB before the
// mask (value 24.5, ref 15.4, off 81.9, attn 41, out 122.9 MB in f32), and
// the 200x200 TSA call ~35 MB. The arithmetic, 4 corners x D FMAs per
// sample, stays under the byte bound at the card's f32 rate. chip_smoke.py
// computes each call's bound from its inputs. The value re-reads of the
// gather stay in the 50 MB L2. This first version is simple and right;
// making it fast (several queries per warp at small D, vectorised bf16
// loads, loc/attn staged through shared memory) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8

struct MsdaLevels {
  int n;
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc += a * bilinear sample of one channel of a (h, w) level at normalized
// location (lx, ly); vl points at that channel of the level's first cell and
// row is the stride between cells. Corners outside the grid are zero.
template <typename T>
__device__ __forceinline__ float sample_acc(float acc, const T* vl, int64_t row,
                                            int h, int w, float lx, float ly,
                                            float a) {
  const float px = lx * (float)w - 0.5f;
  const float py = ly * (float)h - 0.5f;
  const float fx0 = floorf(px), fy0 = floorf(py);
  const float fx = px - fx0, fy = py - fy0;
  const int x0 = (int)fx0, y0 = (int)fy0;
  const bool x0_in = x0 >= 0 && x0 < w, x1_in = x0 + 1 >= 0 && x0 + 1 < w;
  const bool y0_in = y0 >= 0 && y0 < h, y1_in = y0 + 1 >= 0 && y0 + 1 < h;
  if (y0_in) {
    const T* vr = vl + (int64_t)y0 * w * row;
    if (x0_in) acc += (1.f - fx) * (1.f - fy) * a * load_f32(vr + (int64_t)x0 * row);
    if (x1_in) acc += fx * (1.f - fy) * a * load_f32(vr + (int64_t)(x0 + 1) * row);
  }
  if (y1_in) {
    const T* vr = vl + (int64_t)(y0 + 1) * w * row;
    if (x0_in) acc += (1.f - fx) * fy * a * load_f32(vr + (int64_t)x0 * row);
    if (x1_in) acc += fx * fy * a * load_f32(vr + (int64_t)(x0 + 1) * row);
  }
  return acc;
}

template <typename T>
__global__ void msda_fwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                const int* __restrict__ tile_mask,
                                T* __restrict__ out, int B, int V, int H,
                                int D, int Q, int P, int q_tile, int n_tiles,
                                MsdaLevels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (int64_t)B * Q * H) return;
  const int hh = (int)(warp % H);
  const int64_t bq = warp / H;  // b * Q + q
  const int q = (int)(bq % Q);
  const int b = (int)(bq / Q);
  T* o = out + warp * D;  // ((b * Q + q) * H + hh) * D

  if (tile_mask != nullptr && tile_mask[(int64_t)b * n_tiles + q / q_tile] == 0) {
    for (int c = lane; c < D; c += 32) store_f32(o + c, 0.f);
    return;
  }

  const int L = lv.n;
  const float* lq = loc + warp * L * P * 2;
  const float* aq = attn + warp * L * P;
  const int64_t row = (int64_t)H * D;  // stride between value cells
  const T* vb = value + (int64_t)b * V * row + (int64_t)hh * D;

  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    if (c >= D) break;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const T* vl = vb + (int64_t)lv.start[l] * row + c;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        acc = sample_acc(acc, vl, row, lv.h[l], lv.w[l], lq[2 * i],
                         lq[2 * i + 1], aq[i]);
      }
    }
    store_f32(o + c, acc);
  }
}

template <typename T>
__global__ void msda_fwd_factored_kernel(
    const T* __restrict__ value, const float* __restrict__ ref,
    const float* __restrict__ off, const float* __restrict__ attn,
    const int* __restrict__ tile_mask, T* __restrict__ out, int B, int N,
    int V, int H, int D, int Q, int P, int q_tile, int n_tiles,
    MsdaLevels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (int64_t)B * Q * H) return;
  const int hh = (int)(warp % H);
  const int64_t bq = warp / H;  // b * Q + q
  const int q = (int)(bq % Q);
  const int b = (int)(bq / Q);
  T* o = out + warp * D;

  if (tile_mask != nullptr && tile_mask[(int64_t)b * n_tiles + q / q_tile] == 0) {
    for (int c = lane; c < D; c += 32) store_f32(o + c, 0.f);
    return;
  }

  const int L = lv.n;
  const int64_t sq = (int64_t)(b / N) * Q + q;  // shared (sample, query)
  const float* rq = ref + bq * P * 2;
  const float* oq = off + (sq * H + hh) * L * P * 2;
  const float* aq = attn + (sq * H + hh) * L * P;
  const int64_t row = (int64_t)H * D;
  const T* vb = value + (int64_t)b * V * row + (int64_t)hh * D;

  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    if (c >= D) break;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int h = lv.h[l], w = lv.w[l];
      const float inv_w = 1.f / (float)w, inv_h = 1.f / (float)h;
      const T* vl = vb + (int64_t)lv.start[l] * row + c;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const float lx = rq[2 * p] + oq[2 * i] * inv_w;
        const float ly = rq[2 * p + 1] + oq[2 * i + 1] * inv_h;
        acc = sample_acc(acc, vl, row, h, w, lx, ly, aq[i]);
      }
    }
    store_f32(o + c, acc);
  }
}

static int fill_levels(MsdaLevels* lv, int L, const int* shapes, int V) {
  if (L < 1 || L > MSDA_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  lv->n = L;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == V ? 0 : (int)cudaErrorInvalidValue;
}

static const int kThreads = 256;

static unsigned n_blocks(int64_t warps) {
  return (unsigned)((warps * 32 + kThreads - 1) / kThreads);
}

// Returns 0 on success, else a cudaError_t code. shapes points to 2 * L host
// ints (h0, w0, h1, w1, ...); tile_mask may be null; dtype 0 = f32, 1 = bf16.
extern "C" int msda_fwd(const void* value, int dtype, const float* loc,
                        const float* attn, const int* tile_mask, void* out,
                        int B, int V, int H, int D, int Q, int L, int P,
                        const int* shapes, int q_tile, void* stream) {
  MsdaLevels lv;
  if (q_tile < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int err = fill_levels(&lv, L, shapes, V);
  if (err != 0) return err;
  const int64_t warps = (int64_t)B * Q * H;
  if (warps == 0) return 0;
  const int n_tiles = (Q + q_tile - 1) / q_tile;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    msda_fwd_kernel<float><<<n_blocks(warps), kThreads, 0, s>>>(
        (const float*)value, loc, attn, tile_mask, (float*)out, B, V, H, D, Q,
        P, q_tile, n_tiles, lv);
  } else if (dtype == 1) {
    msda_fwd_kernel<__nv_bfloat16><<<n_blocks(warps), kThreads, 0, s>>>(
        (const __nv_bfloat16*)value, loc, attn, tile_mask,
        (__nv_bfloat16*)out, B, V, H, D, Q, P, q_tile, n_tiles, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The factored entry: ref (B, Q, P, 2), off (B / N, Q, H, L, P, 2), attn
// (B / N, Q, H, L, P); otherwise as msda_fwd.
extern "C" int msda_fwd_factored(const void* value, int dtype,
                                 const float* ref, const float* off,
                                 const float* attn, const int* tile_mask,
                                 void* out, int B, int N, int V, int H, int D,
                                 int Q, int L, int P, const int* shapes,
                                 int q_tile, void* stream) {
  MsdaLevels lv;
  if (q_tile < 1 || D < 1 || N < 1 || B % N != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = fill_levels(&lv, L, shapes, V);
  if (err != 0) return err;
  const int64_t warps = (int64_t)B * Q * H;
  if (warps == 0) return 0;
  const int n_tiles = (Q + q_tile - 1) / q_tile;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    msda_fwd_factored_kernel<float><<<n_blocks(warps), kThreads, 0, s>>>(
        (const float*)value, ref, off, attn, tile_mask, (float*)out, B, N, V,
        H, D, Q, P, q_tile, n_tiles, lv);
  } else if (dtype == 1) {
    msda_fwd_factored_kernel<__nv_bfloat16>
        <<<n_blocks(warps), kThreads, 0, s>>>(
            (const __nv_bfloat16*)value, ref, off, attn, tile_mask,
            (__nv_bfloat16*)out, B, N, V, H, D, Q, P, q_tile, n_tiles, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
