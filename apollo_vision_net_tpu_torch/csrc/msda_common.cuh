// What the MSDA forward (msda_fwd.cu) and backward (msda_bwd.cu) share: the
// level table, the loads and stores of f32 and bf16, and the formation of a
// sample's location (on factored operands) and four bilinear corners. The backward must form its corners, and
// round them, exactly as the forward does, so both take them from here.
// Also the narrow variants' rows, lane slots and block runs, the
// tile-local entries' tiles, halos and corners, and the map-resident
// entries' head groups, staging and corners.
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

// The first corner (x0, y0) = (floor(px), floor(py)) of a sample at
// normalized location (lx, ly) on a w x h grid, and its fractions.
struct SamplePos {
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ SamplePos sample_pos(float w, float h, float lx,
                                                float ly) {
  // px = loc * w - 0.5, each op rounded as the plain version rounds it (no
  // contraction into an FMA)
  const float px = __fsub_rn(__fmul_rn(lx, w), 0.5f);
  const float py = __fsub_rn(__fmul_rn(ly, h), 0.5f);
  const float fx0 = floorf(px), fy0 = floorf(py);
  SamplePos s;
  s.fx = px - fx0;
  s.fy = py - fy0;
  s.x0 = (int)fx0;
  s.y0 = (int)fy0;
  return s;
}

// The bilinear weight of corner k = (cx, cy) = (k & 1, k >> 1).
__device__ __forceinline__ float corner_cw(int k, float fx, float fy) {
  return __fmul_rn((k & 1) ? fx : 1.f - fx, (k >> 1) ? fy : 1.f - fy);
}

// The bilinear corners of a sample of level l at normalized location
// (lx, ly).
__device__ __forceinline__ Bilinear4 bilinear_at(const SharedLevels& s, int l,
                                                 float lx, float ly, int row) {
  const float4 f = s.whi[l];
  const int2 wh = s.wh[l];
  const int start = s.start[l];
  const SamplePos sp = sample_pos(f.x, f.y, lx, ly);
  Bilinear4 c;
  c.fx = sp.fx;
  c.fy = sp.fy;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xx = sp.x0 + (k & 1), yy = sp.y0 + (k >> 1);
    const bool in = xx >= 0 && xx < wh.x && yy >= 0 && yy < wh.y;
    c.idx[k] = in ? (start + yy * wh.x + xx) * row : -1;
    c.cw[k] = in ? corner_cw(k, c.fx, c.fy) : 0.f;
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

// ------------------------------------------------------------ narrow rows
//
// The narrow variants (msda_narrow_kernel in msda_fwd.cu,
// msda_bwd_private_kernel in msda_bwd.cu) read a (cell, head) row of D
// channels as one load of D * sizeof(T) bytes (2, 4 or 8): heads too narrow
// for a 16-byte row, such as the hybrids' D = 2 stage.

template <int NB>
struct NarrowRaw;
template <>
struct NarrowRaw<2> {
  using type = unsigned short;
};
template <>
struct NarrowRaw<4> {
  using type = unsigned int;
};
template <>
struct NarrowRaw<8> {
  using type = uint2;
};

// The D channels of a raw row as f32 (bf16: channel 0 in the low half).
template <typename T, int D>
__device__ __forceinline__ void unpack_row(
    float (&f)[D], typename NarrowRaw<D * sizeof(T)>::type v) {
  if constexpr (sizeof(T) == 4 && D == 1) {
    f[0] = __uint_as_float(v);
  } else if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
  } else if constexpr (D == 1) {
    f[0] = __uint_as_float((unsigned)v << 16);
  } else if constexpr (D == 2) {
    f[0] = __uint_as_float(v << 16);
    f[1] = __uint_as_float(v & 0xffff0000u);
  } else {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// log2 of the lane slot S of an item in the kernels that give a lane to
// each sample of several items (msda_bwd_vec_kernel, the narrow variants):
// L * P rounded up to a power of two, at least 4 (so that a group of G <= 8
// lanes spans at most two items) and at most 32 (rounds of 32 samples
// beyond). ops/msda_cuda.py bwd_items_per_warp mirrors it (BWD_SLOT_MIN,
// BWD_SLOT_MAX).
constexpr int kSlotLog2Min = 2, kSlotLog2Max = 5;

static inline int bwd_slot_log2(int LP) {
  int s = kSlotLog2Min;
  while (s < kSlotLog2Max && (1 << s) < LP) ++s;
  return s;
}

// Host side: the runs of the narrow variants' blocks. A block takes `run`
// consecutive items of one batch element (a multiple of `per_round`, the
// items its warps take at once) and a batch element `blocks_per_b` runs, so
// that the grid is one wave of resident blocks: few enough that staging the
// value rows (and, in the backward, flushing the private grad_value rows)
// costs little, enough to fill every SM.
struct NarrowRuns {
  int run, blocks_per_b;
};

static inline cudaError_t narrow_runs(const void* kernel, int threads,
                                      int smem, int items_per_b, int B,
                                      int per_round, NarrowRuns* r) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  if (e != cudaSuccess) return e;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t want = (resident + B - 1) / B;  // blocks a batch element
  int64_t run = ((int64_t)items_per_b + want - 1) / want;
  run = (run + per_round - 1) / per_round * per_round;
  r->run = (int)run;
  r->blocks_per_b = (int)(((int64_t)items_per_b + run - 1) / run);
  return cudaSuccess;
}

// ------------------------------------------------------------ tile-local
//
// The tile-local entries (msda_fwd_local in msda_fwd.cu, msda_bwd_local in
// msda_bwd.cu) take calls whose queries are the cells of the value's own
// single level: L = 1, Q = h * w, query q at cell (q / w, q % w), as
// DCNv3 makes them. A block takes a tile of TY x TX cells of one batch
// element and one head and stages the tile's halo in shared memory: the
// value rows of the tile grown by kLocalHalo cells a side, clipped to the
// map (a map that one tile and its halo cover is staged whole). A corner
// in the halo is read there, any other corner in the grid from global
// memory, so the result never depends on the halo's size. ops/msda_cuda.py
// mirrors the constants (LOCAL_HALO, LOCAL_THREADS, LOCAL_FWD_TILE,
// LOCAL_BWD_TILE, LOCAL_MAX_SMEM).
constexpr int kLocalHalo = 2;
constexpr int kLocalThreads = 256;
constexpr int kLocalFwdTileY = 8, kLocalFwdTileX = 16;
constexpr int kLocalBwdTileY = 8, kLocalBwdTileX = 16;
// the shared memory a block may take on sm_90 (227 KB)
constexpr int kLocalMaxSmem = 232448;

// The lanes that take a query (4 channels a lane): D / 4 rounded up to a
// power of two.
__host__ __device__ constexpr int local_lanes(int D) {
  return D <= 4 ? 1 : D <= 8 ? 2 : D <= 16 ? 4 : 8;
}

struct LocalTile {
  int b, hh;              // batch element, head
  int y0, x0, y1, x1;     // the tile's cells [y0, y1) x [x0, x1)
  int hy0, hx0, HY, HX;   // the staged halo: HY x HX cells from (hy0, hx0)
  int tw, nq;             // the tile's width and cells (a tile at the map's
                          // edge holds fewer than TY x TX)
  unsigned tw_magic;      // qi / tw as __umulhi(qi, tw_magic)
};

// The cell of the tile's query qi (0 <= qi < t.nq, row-major over the
// tile's cells, so an edge tile's queries are packed).
struct TileCell {
  int y, x;
};

__device__ __forceinline__ TileCell tile_cell(const LocalTile& t, int qi) {
  const int r = (int)__umulhi((unsigned)qi, t.tw_magic);
  return TileCell{t.y0 + r, t.x0 + qi - r * t.tw};
}

// The tile of block `bid`: heads fastest, then tile columns, tile rows and
// batch elements, so that the blocks in flight share their value rows and
// their queries' location rows in L2.
__device__ __forceinline__ LocalTile local_tile(int bid, int H, int tiles_x,
                                                int tiles_y, int h, int w,
                                                int TY, int TX) {
  LocalTile t;
  t.hh = bid % H;
  int r = bid / H;
  const int tx = r % tiles_x;
  r /= tiles_x;
  const int ty = r % tiles_y;
  t.b = r / tiles_y;
  t.y0 = ty * TY;
  t.x0 = tx * TX;
  t.y1 = min(h, t.y0 + TY);
  t.x1 = min(w, t.x0 + TX);
  t.hy0 = max(0, t.y0 - kLocalHalo);
  t.hx0 = max(0, t.x0 - kLocalHalo);
  t.HY = min(h, t.y1 + kLocalHalo) - t.hy0;
  t.HX = min(w, t.x1 + kLocalHalo) - t.hx0;
  t.tw = t.x1 - t.x0;
  t.nq = (t.y1 - t.y0) * t.tw;
  t.tw_magic = 0xffffffffu / (unsigned)t.tw + 1u;
  return t;
}

// cp.async of N bytes (16: through L2 only; 8 or 4: through L1), and the
// group commit and wait.
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(N));
  }
}
__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of the tile's halo rows (D f32 channels of head t.hh a
// cell, D a multiple of 4 up to 4 G; vb: the head's channels of cell 0 of
// the batch element, row: elements between cells) to dst, row r = ry * HX
// + rx: a warp a line of the halo, G lanes a cell, 16 bytes a lane.
template <int G>
__device__ __forceinline__ void stage_halo(float* dst, const float* vb,
                                           const LocalTile& t, int w, int row,
                                           int D) {
  const int lane = threadIdx.x & 31, c4 = (lane % G) * 4;
  for (int ry = threadIdx.x >> 5; ry < t.HY; ry += blockDim.x >> 5) {
    const float* src = vb + ((int64_t)(t.hy0 + ry) * w + t.hx0) * row + c4;
    float* out = dst + ry * t.HX * D + c4;
    for (int rx = lane / G; rx < t.HX; rx += 32 / G) {
      if (c4 < D) cp_async_n<16>(out + rx * D, src + (int64_t)rx * row);
    }
  }
}

// Issues the copies of a warp's round of samples: the locations (8 bytes)
// and weights of queries i0 .. i0 + QW - 1 of the tile, P samples each,
// sample s = (query - i0) * P + p, into xy_s and a_s; a query past the
// tile's last copies nothing. lb and ab: the batch element's first
// location and weight; magic_p: s / P as __umulhi(s, magic_p).
template <int QW>
__device__ __forceinline__ void stage_round(float2* xy_s, float* a_s,
                                            const float2* lb, const float* ab,
                                            const LocalTile& t, int w, int H,
                                            int P, int i0, unsigned magic_p) {
  for (int s = threadIdx.x & 31; s < QW * P; s += 32) {
    const int qi = i0 + (int)__umulhi((unsigned)s, magic_p);
    const int p = s - (qi - i0) * P;
    if (qi < t.nq) {
      const TileCell q = tile_cell(t, qi);
      const int at = ((q.y * w + q.x) * H + t.hh) * P + p;
      cp_async_n<8>(xy_s + s, lb + at);
      cp_async_n<4>(a_s + s, ab + at);
    }
  }
}

// The four corners of a sample on the tile's map, as the tile-local kernels
// read them: code[k] is the corner's staged halo row, `zero` (the block's
// row of zeros, past the largest halo) for a corner outside the grid, or
// ~cell (negative) for a corner in the grid but outside the halo; cw[k] is
// its bilinear weight (0 outside the grid), rounded as bilinear_at rounds
// it. A halo lies in the grid, so a corner in it is in the grid.
__device__ __forceinline__ void local_corners(const SamplePos& s,
                                              const LocalTile& t, int h,
                                              int w, int zero, int (&code)[4],
                                              float (&cw)[4]) {
  const int hx = s.x0 - t.hx0, hy = s.y0 - t.hy0;
  const int hrow = hy * t.HX + hx, cell = s.y0 * w + s.x0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // every arm formed, then selected
    const int cx = k & 1, cy = k >> 1;
    const bool in = (unsigned)(s.x0 + cx) < (unsigned)w &&
                    (unsigned)(s.y0 + cy) < (unsigned)h;
    const bool halo = (unsigned)(hx + cx) < (unsigned)t.HX &&
                      (unsigned)(hy + cy) < (unsigned)t.HY;
    const int far = ~(cell + cy * w + cx);
    const int r = hrow + cy * t.HX + cx;
    code[k] = halo ? r : in ? far : zero;
    const float c = corner_cw(k, s.fx, s.fy);
    cw[k] = in ? c : 0.f;
  }
}

// ------------------------------------------------------------ resident
//
// The map-resident entries (msda_fwd_resident in msda_fwd.cu,
// msda_bwd_resident in msda_bwd.cu) take f32 single-level calls whose
// whole map is small, such as SCA over the six cameras' stride-32 15 x 25
// map: a block takes one batch element b and a group of Hb heads h0 .. h0 +
// Hb - 1, stages the group's whole map, value[b, :, h0 : h0 + Hb, :], in
// shared memory, so that every corner of any query is read there, and
// takes every blocks_per_pair-th tile of that pair's (query, head) items
// (or samples), so that the pair's blocks share its masked and
// out-of-view queries. Row r = cell * Hb + hl of the staged map is
// head h0 + hl's D channels at `cell`; row V * Hb holds zeros. Hb is the
// largest divisor of H whose map takes at most kResidentMapBytes
// (resident_heads; ops/msda_cuda.py RESIDENT_MAP_BYTES and
// resident_heads mirror them).
constexpr int kResidentMapBytes = 48 * 1024;
constexpr int kResidentThreads = 256;
// the most samples a head (a group of lanes walks an item's samples)
constexpr int kResidentMaxPoints = 128;

// Host side: the heads a block stages, 0 when not even one head's map fits.
static inline int resident_heads(int V, int H, int D) {
  for (int hb = H; hb >= 1; --hb) {
    if (H % hb == 0 && (int64_t)V * hb * D * 4 <= kResidentMapBytes) return hb;
  }
  return 0;
}

// Issues the copies of the Hb heads' map: vb points at value[b, 0, h0, 0];
// a cell's Hb rows are contiguous in value and in the staged map, so
// 16-byte piece k of the map is piece k % (Hb * D / 4) of cell k / (Hb *
// D / 4).
__device__ __forceinline__ void stage_resident_map(float* dst,
                                                   const float* vb, int V,
                                                   int H, int Hb, int D) {
  const int per_cell = Hb * D / 4;
  const int n = V * per_cell;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int c = k / per_cell;
    cp_async_n<16>(dst + 4 * k, vb + (int64_t)c * H * D + 4 * (k - c * per_cell));
  }
}

// Host side: the blocks a (batch element, head group) pair of a resident
// entry's kernel gets, so that the grid is one wave of resident blocks
// (each block stages its map once), and no more than the pair's tiles of
// `tile` of its Q * Hb items (samples: Q = queries x points).
static inline int resident_blocks_per_pair(const void* kernel, int smem,
                                           int B, int H, int Hb, int Q,
                                           int tile, cudaError_t* e) {
  int dev = 0, sms = 0, per_sm = 0;
  *e = cudaGetDevice(&dev);
  if (*e == cudaSuccess) {
    *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (*e == cudaSuccess) {
    *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kResidentThreads, smem);
  }
  const int64_t pairs = (int64_t)B * (H / Hb);
  const int64_t tiles = ((int64_t)Q * Hb + tile - 1) / tile;
  const int64_t want = ((int64_t)sms * (per_sm > 0 ? per_sm : 1) + pairs - 1) / pairs;
  return (int)(want < tiles ? want : tiles);
}

// The samples, as bits from the group's first lane, that a group of G
// lanes walks at points p0 .. p0 + G - 1 (`left` of them remain): those
// whose corners fall in the grid (`in`) where G >= kResidentBallotLanes,
// else all of them, a sample without a corner in the grid skipped after
// its codes are passed round. (H100: the ballot everywhere ran D = 4 twice
// as long, a fixed walk everywhere D = 16 and 32 1.2-1.45 times as long.)
constexpr int kResidentBallotLanes = 4;

template <int G>
__device__ __forceinline__ unsigned resident_walk(unsigned gmask, int g,
                                                  bool in, int left) {
  if constexpr (G >= kResidentBallotLanes) {
    return __ballot_sync(gmask, in) >> (g * G);
  } else {
    return (1u << (left < G ? left : G)) - 1u;
  }
}

// The lanes that take part in a shuffle of a warp's group g of G lanes (G
// = 1, 2, 4, 8): the group's own where G >= kResidentBallotLanes, so that a
// group may skip alone; else the whole warp, whose groups then walk in step
// (shuffles over 2-lane groups ran D = 8 about 1.5 times as long, H100).
template <int G>
__device__ __forceinline__ unsigned resident_group_mask(int g) {
  return G >= kResidentBallotLanes ? ((1u << G) - 1u) << (g * G) : FULL_MASK;
}

// The four corners of a sample of head hl on the staged map: code[k] is
// the corner's staged row, or `zero` (the row of zeros) outside the grid;
// cw[k] its bilinear weight (0 outside the grid), rounded as bilinear_at
// rounds it.
__device__ __forceinline__ void resident_corners(const SamplePos& s, int h,
                                                 int w, int Hb, int hl,
                                                 int zero, int (&code)[4],
                                                 float (&cw)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xx = s.x0 + (k & 1), yy = s.y0 + (k >> 1);
    const bool in = (unsigned)xx < (unsigned)w && (unsigned)yy < (unsigned)h;
    code[k] = in ? (yy * w + xx) * Hb + hl : zero;
    cw[k] = in ? corner_cw(k, s.fx, s.fy) : 0.f;
  }
}

// Host side: cells of a tile's largest halo.
static inline int local_halo_rows(int TY, int TX) {
  return (TY + 2 * kLocalHalo) * (TX + 2 * kLocalHalo);
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
