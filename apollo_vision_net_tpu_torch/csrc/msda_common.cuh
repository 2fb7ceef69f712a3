// What the MSDA forward (msda_fwd.cu) and backward (msda_bwd.cu) share: the
// level table, the loads and stores of f32 and bf16, and the formation of a
// sample's location (on factored operands) and four bilinear corners. The backward must form its corners, and
// round them, exactly as the forward does, so both take them from here.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8
#define FULL_MASK 0xffffffffu

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

// The level table of a block, in shared memory.
struct SharedLevels {
  float4 whi[MSDA_MAX_LEVELS];  // (w, h, 1 / w, 1 / h)
  int2 wh[MSDA_MAX_LEVELS];     // (w, h)
  int start[MSDA_MAX_LEVELS];   // first cell of the level
};

// Every thread of the block must call it (it ends in __syncthreads). The
// loop is unrolled, so lv is read at constant indices and stays in the
// parameter bank.
__device__ __forceinline__ void stage_levels(SharedLevels& s,
                                             const MsdaLevels& lv) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < MSDA_MAX_LEVELS; ++l) {
      if (l < lv.n) {
        const float w = (float)lv.w[l], h = (float)lv.h[l];
        s.whi[l] = make_float4(w, h, 1.f / w, 1.f / h);
        s.wh[l] = make_int2(lv.w[l], lv.h[l]);
        s.start[l] = lv.start[l];
      }
    }
  }
  __syncthreads();
}

// The four bilinear corners of one sample, (x0, y0), (x0 + 1, y0),
// (x0, y0 + 1), (x0 + 1, y0 + 1): each corner's element offset in its
// batch's value block (its cell times row, -1 outside the grid) and its
// bilinear weight (0 outside the grid), and the sample's fractions
// fx = px - floor(px), fy = py - floor(py).
struct Bilinear4 {
  int idx[4];
  float cw[4];
  float fx, fy;
};

// The bilinear corners of a sample of level l at normalized location
// (lx, ly).
__device__ __forceinline__ Bilinear4 bilinear_at(const SharedLevels& s, int l,
                                                 float lx, float ly, int row) {
  const float4 f = s.whi[l];
  const int2 wh = s.wh[l];
  const int start = s.start[l];
  // px = loc * w - 0.5, each op rounded as the plain version rounds it (no
  // contraction into an FMA)
  const float px = __fsub_rn(__fmul_rn(lx, f.x), 0.5f);
  const float py = __fsub_rn(__fmul_rn(ly, f.y), 0.5f);
  const float fx0 = floorf(px), fy0 = floorf(py);
  Bilinear4 c;
  c.fx = px - fx0;
  c.fy = py - fy0;
  const int x0 = (int)fx0, y0 = (int)fy0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = k & 1, cy = k >> 1;
    const int xx = x0 + cx, yy = y0 + cy;
    const bool in = xx >= 0 && xx < wh.x && yy >= 0 && yy < wh.y;
    c.idx[k] = in ? (start + yy * wh.x + xx) * row : -1;
    c.cw[k] = in ? __fmul_rn(cx ? c.fx : 1.f - c.fx, cy ? c.fy : 1.f - c.fy)
                 : 0.f;
  }
  return c;
}

// The location of a sample of level l on factored operands (the factored
// entries of msda_fwd.cu and msda_bwd.cu): loc = ref + off * (1 / w_l,
// 1 / h_l), the f32 reciprocal, then a multiply and an add, each rounded as
// the plain materialize_factored rounds them.
__device__ __forceinline__ float2 factored_loc(const SharedLevels& s, int l,
                                               float rx, float ry, float ox,
                                               float oy) {
  const float4 f = s.whi[l];
  return make_float2(__fadd_rn(rx, __fmul_rn(ox, f.z)),
                     __fadd_rn(ry, __fmul_rn(oy, f.w)));
}

// The corners of a sample with its weight attn x bilinear (0 outside the
// grid).
struct Corners4 {
  int idx[4];
  float wt[4];
};

__device__ __forceinline__ Corners4 no_corners() {
  Corners4 c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.idx[k] = -1;
    c.wt[k] = 0.f;
  }
  return c;
}

__device__ __forceinline__ Corners4 corners_at(const SharedLevels& s, int l,
                                               float lx, float ly, float a,
                                               int row) {
  const Bilinear4 bl = bilinear_at(s, l, lx, ly, row);
  Corners4 c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.idx[k] = bl.idx[k];
    c.wt[k] = bl.idx[k] >= 0 ? __fmul_rn(bl.cw[k], a) : 0.f;
  }
  return c;
}

// The corners of a factored sample (see factored_loc).
__device__ __forceinline__ Corners4 sample_corners(const SharedLevels& s,
                                                   int l, float rx, float ry,
                                                   float ox, float oy,
                                                   float a, int row) {
  const float2 xy = factored_loc(s, l, rx, ry, ox, oy);
  return corners_at(s, l, xy.x, xy.y, a, row);
}

// Host side: the level table from 2 * L host ints (h0, w0, h1, w1, ...);
// fails unless the levels' cells add up to V.
static inline int fill_levels(MsdaLevels* lv, int L, const int* shapes, int V) {
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
