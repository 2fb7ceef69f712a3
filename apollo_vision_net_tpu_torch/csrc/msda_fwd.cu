// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of apollo_vision_net_tpu/ops/msda_pallas.py:
//   - _msda_kernel       (decoder cross-attention, det and map decoders)
//   - _msda_kernel_slab  (temporal self-attention without a mask; spatial
//                         cross-attention with a per-(camera, query-tile) mask)
// The Pallas kernels contract a one-hot bilinear mask against the whole
// value block on the TPU's matrix unit, because the TPU gathers rows slowly.
// Hopper gathers well, so this kernel gathers the four bilinear corners
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
// Design: one warp per (batch, query, head), lanes across the D channels (a
// lane loops over channels when D > 32; lanes >= D idle when D < 32). Each
// lane reads its channel of the four corners, so a corner read is one
// coalesced 32-element row when D = 32.
//
// Bound: memory. Each input is read once and the output written once; at the
// flagship shapes and f32 value that is about 12.2 MB for TSA, 36 MB for SCA
// before the mask, 3.8 MB for the det decoder and 4.0 MB for the map decoder
// per call: ~190 MB, 57 us a frame at 3.35 TB/s (3 TSA, 3 SCA, 6 + 6 decoder
// calls). The arithmetic, 4 corners x D FMAs per sample, is at most 0.25
// GFLOP a call (SCA before the mask), under the byte bound at the card's f32
// rate. chip_smoke.py computes each call's bound from its inputs. The value
// re-reads of the gather stay in the 50 MB L2. This first version is simple
// and right; making it fast (several queries per warp at small D, vectorised
// bf16 loads, loc/attn staged through shared memory) is later work.

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
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int h = lv.h[l], w = lv.w[l];
      const T* vl = vb + (int64_t)lv.start[l] * row + c;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const float a = aq[i];
        const float px = lq[2 * i] * (float)w - 0.5f;
        const float py = lq[2 * i + 1] * (float)h - 0.5f;
        const float fx0 = floorf(px), fy0 = floorf(py);
        const float fx = px - fx0, fy = py - fy0;
        const int x0 = (int)fx0, y0 = (int)fy0;
        if (c >= D) continue;
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
      }
    }
    if (c < D) store_f32(o + c, acc);
  }
}

// Returns 0 on success, else a cudaError_t code. shapes points to 2 * L host
// ints (h0, w0, h1, w1, ...); tile_mask may be null; dtype 0 = f32, 1 = bf16.
extern "C" int msda_fwd(const void* value, int dtype, const float* loc,
                        const float* attn, const int* tile_mask, void* out,
                        int B, int V, int H, int D, int Q, int L, int P,
                        const int* shapes, int q_tile, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || q_tile < 1 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  MsdaLevels lv;
  lv.n = L;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != V) return (int)cudaErrorInvalidValue;
  const int64_t warps = (int64_t)B * Q * H;
  if (warps == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (warps * 32 + threads - 1) / threads;
  const int n_tiles = (Q + q_tile - 1) / q_tile;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    msda_fwd_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)value, loc, attn, tile_mask, (float*)out, B, V, H, D, Q,
        P, q_tile, n_tiles, lv);
  } else if (dtype == 1) {
    msda_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)value, loc, attn, tile_mask,
        (__nv_bfloat16*)out, B, V, H, D, Q, P, q_tile, n_tiles, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
