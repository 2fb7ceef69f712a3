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
//   loc = ref[b, q, p] + off[b / N, q, h, l, p] * (1 / w_l, 1 / h_l)
// in registers (the f32 reciprocal, then a multiply and an add, rounded as
// the plain materialize_factored rounds them), so the (B, Q, H, L, P, 2)
// locations (491.5 MB f32 at the base SCA shape) are never written or read.
//
// Every kernel forms a sample's corners the same way: px = loc * w - 0.5 and
// py = loc * h - 0.5, each product and difference rounded as the plain
// version rounds them (no contraction into an FMA), the four corner cells
// and their weights attn x bilinear (0 outside the grid) in registers, from
// a level table (w, h, 1/w, 1/h, first cell) staged in shared memory once
// per block, so nothing is indexed in local memory (ptxas: 0 bytes stack
// frame).
//
// Plain and masked entries (msda_fwd), vector variant (msda_vec_kernel;
// G = D * sizeof(T) / 16 in {1, 2, 4, 8, 16}; value and out 16-byte
// aligned, loc 8-byte aligned; every call of the flagship and base frames
// runs it):
//   1. One warp per (batch, query), all heads. A block of 4 warps takes 4
//      consecutive queries, and consecutive blocks their neighbours, so L1
//      catches overlapping corner rows (TSA queries are row-major on the
//      BEV, the flagship SCA's in 8 x 4 spatial blocks). One query a warp
//      ran the decoders and the flagship SCA faster than two, and the base
//      TSA as fast (H100 runs).
//   2. A corner row of a head is D contiguous values, read by G lanes as G
//      16-byte loads; the warp's 32 / G lane groups take 32 / G heads at
//      once (8 at bf16 D = 32: the whole query; 4 at f32 D = 32, in two
//      passes).
//   3. Lane `sub` of a group owns sample r0 + sub of the group's head, in
//      rounds of G samples over the head's L * P (one round at TSA and the
//      decoders in bf16, two at the flagship SCA). It loads its location
//      (8 bytes) and weight and forms its four corners in registers.
//   4. The group walks the round's samples one at a time: each lane takes a
//      sample's corner offsets and weights from the owner lane in its own
//      group with __shfl_sync, issues the sample's four 16-byte corner loads
//      before it uses any, and accumulates its 16 bytes of channels in f32.
//      No reduction across lanes: the group holds the head's D channels, and
//      the query's H * D output row (512 B at bf16 D = 32, H = 8) leaves as
//      one run of 16-byte stores. Every instance takes at most 64 registers
//      (at least 8 blocks an SM) and no stack frame.
//   5. A query of a masked tile writes its row of zeros with 16-byte stores
//      and reads nothing else.
// Plain and masked entries, general variant (msda_scalar_kernel; any other
// D or a misaligned row): one warp per (batch, query, head), lane s forms
// the corners of sample s, then the lanes walk the channels with scalar
// loads, taking each sample's corners by __shfl_sync.
//
// Factored entry, vector variant (msda_factored_vec_kernel; D a power of
// two from 4 to 64 in f32, 16 or 32 in bf16; value and out 16-byte
// aligned; the base SCA runs it):
//   1. One warp per (batch, query, head); a block of 4 warps takes 8
//      consecutive queries x 8 heads, so its warps work on neighbouring
//      queries of one tile (SCA orders queries in 8 x 16 spatial blocks)
//      and L1 catches their overlapping corner rows.
//   2. Lane s owns sample s of the (query, head) (L * P = 32 at the base
//      shape; fewer leave lanes idle, more take several rounds). The warp
//      loads the offsets, weights and the camera's references with
//      coalesced loads, and each lane forms its location, four corner cell
//      offsets and four weights in registers.
//   3. A corner row of a head is D contiguous values; G = D * sizeof(T) /
//      16 lanes read it as G 16-byte loads, so one warp load instruction
//      serves 32 / G corner rows (8 at bf16 D = 32). Each lane takes its
//      row's offset and weight from the owner lane with __shfl_sync; the
//      loads of a batch of 4 instructions are all issued before any is
//      used, with no dependent load between them. Each lane accumulates
//      its 16 bytes of channels in f32; the 32 / G lane groups are reduced
//      with __shfl_xor_sync and the row is stored with 16-byte stores.
//   4. A query of a masked tile writes zeros with 16-byte stores and reads
//      nothing else.
// Factored entry, general variant (msda_factored_scalar_kernel; any other
// D or a misaligned row): the same sampling stage, then for each sample
// the lanes walk the channels with scalar loads and stores.
//
// Bound: memory. Each input is read once and the output written once; at
// the flagship shapes and f32 value that is about 12.2 MB for TSA, 36 MB
// for SCA before the mask, 3.8 MB for the det decoder and 4.0 MB for the
// map decoder per call: ~190 MB, 57 us a frame at 3.35 TB/s (3 TSA, 3 SCA,
// 6 + 6 decoder calls). At the base shape the factored SCA call reads ~286
// MB before the mask (value 24.5 MB in bf16, ref 15.4, off 81.9 and attn
// 41 MB in f32; the output is 122.9 MB in bf16, 245.8 MB in f32), and the
// 200x200 TSA call ~112 MB in bf16 (value 41 MB, loc 20.5, attn 10.2,
// out 41). The arithmetic, 4 corners x D FMAs per sample, stays under the
// byte bound at the card's f32 rate. chip_smoke.py computes each call's
// bound from its inputs (0.082 ms for the base SCA with its tile mask,
// 0.034 ms for the base TSA, bf16).
// The practical limit of both vector kernels is the gather, not device
// memory. The factored kernel reads about 480k active (query, head) pairs x
// 128 corner rows x 64 B = ~3.9 GB a call at the base shape; the base TSA
// reads 80k queries x 8 heads x 16 corner rows x 64 B = ~655 MB a call in
// bf16, 1.28M warp load instructions of 512 B. Both are served by L1 and
// L2: the base SCA's value is 24.5 MB, the two TSA slots' 41 MB, and the
// L2 holds 50 MB.

#include "msda_common.cuh"

// Warps in flight matter more than loads in flight per warp: with batches of
// 4 loads and blocks of 4 warps the base shape's instance (bf16, G = 4) takes
// 64 registers and runs 0.71 ms a call, with batches of 8 and blocks of 8
// warps 79 registers and 0.79 ms (chip_smoke.py on the H100; f32 0.81
// against 0.90 ms).
constexpr int kFactoredWarps = 4;          // warps per block
constexpr int kFactoredItemsPerWarp = 16;  // (query, head) items per warp
constexpr int kFactoredItems = kFactoredWarps * kFactoredItemsPerWarp;
constexpr int kFactoredBatch = 4;          // loads issued before any is used

// The (query, head) item of a block's warp (item = (b * Q + q) * H + hh;
// the entry checks that B * Q * H fits an int, so the divisions are 32-bit).
struct FactoredItem {
  int b, q, hh;
  int bq, sq;  // b * Q + q; (b / N) * Q + q
};

__device__ __forceinline__ FactoredItem factored_item(int item, int N, int H,
                                                      int Q) {
  FactoredItem it;
  it.bq = item / H;
  it.hh = item - it.bq * H;
  it.b = it.bq / Q;
  it.q = it.bq - it.b * Q;
  it.sq = (it.b / N) * Q + it.q;
  return it;
}

// 16 bytes of value as f32: 8 bf16 or 4 f32 channels.
__device__ __forceinline__ void fma16(float* acc, uint4 v, float w,
                                      const __nv_bfloat16*) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[2 * e] = fmaf(w, __uint_as_float(u[e] << 16), acc[2 * e]);
    acc[2 * e + 1] = fmaf(w, __uint_as_float(u[e] & 0xffff0000u), acc[2 * e + 1]);
  }
}
__device__ __forceinline__ void fma16(float* acc, uint4 v, float w,
                                      const float*) {
  acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
  acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
  acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
  acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ uint4 pack16(const float* acc, __nv_bfloat16*) {
  return make_uint4(pack_bf16x2(acc[0], acc[1]), pack_bf16x2(acc[2], acc[3]),
                    pack_bf16x2(acc[4], acc[5]), pack_bf16x2(acc[6], acc[7]));
}
__device__ __forceinline__ uint4 pack16(const float* acc, float*) {
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                    __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}

// ------------------------------------------------------- factored entry

// G lanes read one corner row (D = G * 16 / sizeof(T) channels).
template <typename T, int G>
// No minimum of blocks in the launch bounds: asked for at least 1 block an
// SM, ptxas took far more registers and the kernel ran slower; asked for
// more blocks than its registers allow, it spilled (H100 runs).
__global__ void __launch_bounds__(kFactoredWarps * 32)
msda_factored_vec_kernel(const T* __restrict__ value,
                         const float* __restrict__ ref,
                         const float* __restrict__ off,
                         const float* __restrict__ attn,
                         const int* __restrict__ tile_mask,
                         T* __restrict__ out, int B, int N, int V, int H,
                         int Q, int P, int LP, int q_tile, int n_tiles,
                         MsdaLevels lv) {
  constexpr int VEC = 16 / sizeof(T);  // channels per 16-byte load
  constexpr int D = G * VEC;
  constexpr int ROWS = 32 / G;         // corner rows per load instruction
  constexpr int STEPS = 4 * G;         // instructions per 32 samples
  constexpr int BATCH = STEPS < kFactoredBatch ? STEPS : kFactoredBatch;
  __shared__ SharedLevels sl;
  stage_levels(sl, lv);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, sub = lane % G;
  const int row = H * D;  // elements between value cells
  const int total = B * Q * H;
  // the lane's sample in the first round: level and point
  const int l_first = lane / P, p_first = lane - l_first * P;

  for (int j = 0; j < kFactoredItemsPerWarp; ++j) {
    const int item = blockIdx.x * kFactoredItems + j * kFactoredWarps + warp;
    if (item >= total) return;
    const FactoredItem it = factored_item(item, N, H, Q);
    T* o = out + (int64_t)item * D + sub * VEC;
    if (tile_mask != nullptr &&
        __ldg(tile_mask + (int64_t)it.b * n_tiles + it.q / q_tile) == 0) {
      if (grp == 0) *reinterpret_cast<uint4*>(o) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const float* oq = off + ((int64_t)it.sq * H + it.hh) * LP * 2;
    const float* aq = attn + ((int64_t)it.sq * H + it.hh) * LP;
    const float* rq = ref + (int64_t)it.bq * P * 2;
    const T* vb = value + (int64_t)it.b * V * row + it.hh * D + sub * VEC;

    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int r0 = 0; r0 < LP; r0 += 32) {
      const int i = r0 + lane;
      Corners4 c = no_corners();
      if (i < LP) {
        int l = l_first, p = p_first;
        if (r0 > 0) {
          l = i / P;
          p = i - l * P;
        }
        c = sample_corners(sl, l, __ldg(rq + 2 * p), __ldg(rq + 2 * p + 1),
                           __ldg(oq + 2 * i), __ldg(oq + 2 * i + 1),
                           __ldg(aq + i), row);
      }
#pragma unroll
      for (int s0 = 0; s0 < STEPS; s0 += BATCH) {
        uint4 v[BATCH];
        float w[BATCH];
#pragma unroll
        for (int t = 0; t < BATCH; ++t) {
          const int step = s0 + t;
          const int k = step / G;                    // corner
          const int src = (step % G) * ROWS + grp;   // owner lane
          const int id = __shfl_sync(FULL_MASK, c.idx[k], src);
          w[t] = __shfl_sync(FULL_MASK, c.wt[k], src);
          v[t] = id >= 0 ? __ldg(reinterpret_cast<const uint4*>(vb + id))
                         : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int t = 0; t < BATCH; ++t) fma16(acc, v[t], w[t], vb);
      }
    }
#pragma unroll
    for (int m = G; m < 32; m <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(FULL_MASK, acc[e], m);
    }
    if (grp == 0) *reinterpret_cast<uint4*>(o) = pack16(acc, o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFactoredWarps * 32)
msda_factored_scalar_kernel(const T* __restrict__ value,
                            const float* __restrict__ ref,
                            const float* __restrict__ off,
                            const float* __restrict__ attn,
                            const int* __restrict__ tile_mask,
                            T* __restrict__ out, int B, int N, int V, int H,
                            int D, int Q, int P, int LP, int q_tile,
                            int n_tiles, MsdaLevels lv) {
  __shared__ SharedLevels sl;
  stage_levels(sl, lv);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = H * D;
  const int total = B * Q * H;
  for (int j = 0; j < kFactoredItemsPerWarp; ++j) {
    const int item = blockIdx.x * kFactoredItems + j * kFactoredWarps + warp;
    if (item >= total) return;
    const FactoredItem it = factored_item(item, N, H, Q);
    T* o = out + (int64_t)item * D;
    if (tile_mask != nullptr &&
        __ldg(tile_mask + (int64_t)it.b * n_tiles + it.q / q_tile) == 0) {
      for (int ch = lane; ch < D; ch += 32) store_f32(o + ch, 0.f);
      continue;
    }
    const float* oq = off + ((int64_t)it.sq * H + it.hh) * LP * 2;
    const float* aq = attn + ((int64_t)it.sq * H + it.hh) * LP;
    const float* rq = ref + (int64_t)it.bq * P * 2;
    const T* vb = value + (int64_t)it.b * V * row + it.hh * D;
    for (int c0 = 0; c0 < D; c0 += 32) {
      const int ch = c0 + lane;
      float acc = 0.f;
      for (int r0 = 0; r0 < LP; r0 += 32) {
        const int i = r0 + lane;
        Corners4 c = no_corners();
        if (i < LP) {
          const int l = i / P, p = i - l * P;
          c = sample_corners(sl, l, rq[2 * p], rq[2 * p + 1], oq[2 * i],
                             oq[2 * i + 1], aq[i], row);
        }
        const int ns = min(32, LP - r0);
        for (int s = 0; s < ns; ++s) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int id = __shfl_sync(FULL_MASK, c.idx[k], s);
            const float w = __shfl_sync(FULL_MASK, c.wt[k], s);
            if (ch < D && id >= 0) acc = fmaf(w, load_f32(vb + id + ch), acc);
          }
        }
      }
      if (ch < D) store_f32(o + ch, acc);
    }
  }
}

// ------------------------------------------------ plain and masked entries

constexpr int kMsdaWarps = 4;  // warps per block, one (batch, query) each
// At least 8 blocks an SM, so at most 64 registers: every instance then
// builds without spills, where ptxas left to itself gave f32 G = 2 48
// registers and a spill, at a base TSA time a few percent lower (H100
// runs). The general variant takes the same bound, which removed its
// 8-byte stack frame.
constexpr int kMsdaMinBlocks = 8;

// G lanes read one corner row of a head (D = G * 16 / sizeof(T) channels);
// 32 / G heads are in flight.
template <typename T, int G>
__global__ void __launch_bounds__(kMsdaWarps * 32, kMsdaMinBlocks)
msda_vec_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn,
                const int* __restrict__ tile_mask, T* __restrict__ out, int B,
                int V, int H, int Q, int P, int LP, int q_tile, int n_tiles,
                MsdaLevels lv) {
  constexpr int VEC = 16 / sizeof(T);  // channels per 16-byte load
  constexpr int D = G * VEC;
  constexpr int GROUPS = 32 / G;       // heads in flight
  __shared__ SharedLevels sl;
  stage_levels(sl, lv);

  const int lane = threadIdx.x & 31;
  const int grp = lane / G, sub = lane % G;
  const int row = H * D;  // elements between value cells, and of an output row
  const int bq = blockIdx.x * kMsdaWarps + (threadIdx.x >> 5);  // b * Q + q
  if (bq >= B * Q) return;
  const int b = bq / Q;
  T* o = out + (int64_t)bq * row;
  if (tile_mask != nullptr &&
      __ldg(tile_mask + (int64_t)b * n_tiles + (bq - b * Q) / q_tile) == 0) {
    for (int c = lane * VEC; c < row; c += 32 * VEC) {
      *reinterpret_cast<uint4*>(o + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const T* vb = value + (int64_t)b * V * row + sub * VEC;
  for (int h0 = 0; h0 < H; h0 += GROUPS) {
    const int hh = h0 + grp;
    const bool on = hh < H;  // the group has a head in this pass
    const int64_t s0 = ((int64_t)bq * H + hh) * LP;  // the head's first sample
    const T* vh = vb + hh * D;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int r0 = 0; r0 < LP; r0 += G) {
      const int i = r0 + sub;  // the lane's sample (level i / P)
      Corners4 c = no_corners();
      if (on && i < LP) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + s0 + i);
        c = corners_at(sl, i / P, xy.x, xy.y, __ldg(attn + s0 + i), row);
      }
      // Sample r0 + t lives in lane grp * G + t. Not unrolled: unrolled,
      // ptxas hoists all 4 * G corner loads and spills at G >= 8 even with
      // 128 registers (at G = 4 it ran the base TSA a few percent faster,
      // spilling).
#pragma unroll 1
      for (int t = 0; t < G; ++t) {
        const int src = grp * G + t;
        uint4 v[4];
        float w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int id = __shfl_sync(FULL_MASK, c.idx[k], src);
          w[k] = __shfl_sync(FULL_MASK, c.wt[k], src);
          v[k] = id >= 0 ? __ldg(reinterpret_cast<const uint4*>(vh + id))
                         : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) fma16(acc, v[k], w[k], vh);
      }
    }
    if (on) *reinterpret_cast<uint4*>(o + hh * D + sub * VEC) = pack16(acc, o);
  }
}

// One warp per (batch, query, head) item, tiled as the factored general
// variant.
template <typename T>
__global__ void __launch_bounds__(kFactoredWarps * 32, kMsdaMinBlocks)
msda_scalar_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                   const float* __restrict__ attn,
                   const int* __restrict__ tile_mask, T* __restrict__ out,
                   int B, int V, int H, int D, int Q, int P, int LP,
                   int q_tile, int n_tiles, MsdaLevels lv) {
  __shared__ SharedLevels sl;
  stage_levels(sl, lv);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = H * D;
  const int total = B * Q * H;
  for (int j = 0; j < kFactoredItemsPerWarp; ++j) {
    const int item = blockIdx.x * kFactoredItems + j * kFactoredWarps + warp;
    if (item >= total) return;
    const int bq = item / H, hh = item - bq * H;
    const int b = bq / Q;
    T* o = out + (int64_t)item * D;
    if (tile_mask != nullptr &&
        __ldg(tile_mask + (int64_t)b * n_tiles + (bq - b * Q) / q_tile) == 0) {
      for (int ch = lane; ch < D; ch += 32) store_f32(o + ch, 0.f);
      continue;
    }
    const float* lq = loc + (int64_t)item * LP * 2;
    const float* aq = attn + (int64_t)item * LP;
    const T* vb = value + (int64_t)b * V * row + hh * D;
    for (int c0 = 0; c0 < D; c0 += 32) {
      const int ch = c0 + lane;
      float acc = 0.f;
      for (int r0 = 0; r0 < LP; r0 += 32) {
        const int i = r0 + lane;
        Corners4 c = no_corners();
        if (i < LP) c = corners_at(sl, i / P, lq[2 * i], lq[2 * i + 1], aq[i], row);
        const int ns = min(32, LP - r0);
        for (int s = 0; s < ns; ++s) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int id = __shfl_sync(FULL_MASK, c.idx[k], s);
            const float w = __shfl_sync(FULL_MASK, c.wt[k], s);
            if (ch < D && id >= 0) acc = fmaf(w, load_f32(vb + id + ch), acc);
          }
        }
      }
      if (ch < D) store_f32(o + ch, acc);
    }
  }
}

// ------------------------------------------------------------- host side

// Launches the vector variant when D fills G = D * sizeof(T) / 16 lanes (G
// a power of two up to 16), value and out are 16-byte aligned and loc
// 8-byte aligned, else the general variant. Returns 1 for the vector
// variant, 0 for the general.
template <typename T>
static int launch_msda(cudaStream_t s, const void* value, const float* loc,
                       const float* attn, const int* tile_mask, void* out,
                       int B, int V, int H, int D, int Q, int P, int LP,
                       int q_tile, int n_tiles, const MsdaLevels& lv) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = (((uintptr_t)value | (uintptr_t)out) & 15) == 0 &&
                       ((uintptr_t)loc & 7) == 0 && D % VEC == 0;
  const unsigned grid = (unsigned)(((int64_t)B * Q + kMsdaWarps - 1) / kMsdaWarps);
  switch (aligned ? D / VEC : 0) {
#define MSDA_VEC_CASE(G_)                                                    \
  case G_:                                                                   \
    msda_vec_kernel<T, G_><<<grid, kMsdaWarps * 32, 0, s>>>(                 \
        (const T*)value, loc, attn, tile_mask, (T*)out, B, V, H, Q, P, LP,   \
        q_tile, n_tiles, lv);                                                \
    return 1;
    MSDA_VEC_CASE(1)
    MSDA_VEC_CASE(2)
    MSDA_VEC_CASE(4)
    MSDA_VEC_CASE(8)
    MSDA_VEC_CASE(16)
#undef MSDA_VEC_CASE
    default:
      break;
  }
  const unsigned items =
      (unsigned)(((int64_t)B * Q * H + kFactoredItems - 1) / kFactoredItems);
  msda_scalar_kernel<T><<<items, kFactoredWarps * 32, 0, s>>>(
      (const T*)value, loc, attn, tile_mask, (T*)out, B, V, H, D, Q, P, LP,
      q_tile, n_tiles, lv);
  return 0;
}

// Returns 0 on success, else a cudaError_t code. shapes points to 2 * L host
// ints (h0, w0, h1, w1, ...); tile_mask may be null; dtype 0 = f32, 1 = bf16.
// *variant is set to 1 when the vector variant ran, 0 when the general one
// did.
extern "C" int msda_fwd(const void* value, int dtype, const float* loc,
                        const float* attn, const int* tile_mask, void* out,
                        int B, int V, int H, int D, int Q, int L, int P,
                        const int* shapes, int q_tile, void* stream,
                        int* variant) {
  MsdaLevels lv;
  if (q_tile < 1 || D < 1 || P < 1 || (int64_t)V * H * D > INT32_MAX ||
      (int64_t)B * Q * H > INT32_MAX - kFactoredItems) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = fill_levels(&lv, L, shapes, V);
  if (err != 0) return err;
  if ((int64_t)B * Q * H == 0) return 0;
  const int n_tiles = (Q + q_tile - 1) / q_tile;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    *variant = launch_msda<float>(s, value, loc, attn, tile_mask, out, B, V,
                                  H, D, Q, P, L * P, q_tile, n_tiles, lv);
  } else if (dtype == 1) {
    *variant = launch_msda<__nv_bfloat16>(s, value, loc, attn, tile_mask, out,
                                          B, V, H, D, Q, P, L * P, q_tile,
                                          n_tiles, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches the vector variant with G lanes a row; returns false where there
// is none. In bf16 ptxas compiles G = 1 (D = 8) and G >= 8 (D >= 64) with
// spills at the register count it picks for this block, so those widths go
// to the general variant (no configuration has them; all run D = 32).
template <typename T, int G>
static bool launch_factored_vec(unsigned grid, cudaStream_t s,
                                const void* value, const float* ref,
                                const float* off, const float* attn,
                                const int* tile_mask, void* out, int B, int N,
                                int V, int H, int Q, int P, int LP,
                                int q_tile, int n_tiles,
                                const MsdaLevels& lv) {
  if constexpr (sizeof(T) == 2 && (G == 1 || G >= 8)) {
    return false;
  } else {
    msda_factored_vec_kernel<T, G><<<grid, kFactoredWarps * 32, 0, s>>>(
        (const T*)value, ref, off, attn, tile_mask, (T*)out, B, N, V, H, Q,
        P, LP, q_tile, n_tiles, lv);
    return true;
  }
}

// Launches the vector variant when D fills G = D * sizeof(T) / 16 lanes
// (G a power of two up to 16 in f32, 2 or 4 in bf16) and value and out are
// 16-byte aligned, else the general variant. Returns 1 for the vector
// variant, 0 for the general.
template <typename T>
static int launch_factored(unsigned grid, cudaStream_t s, const void* value,
                           const float* ref, const float* off,
                           const float* attn, const int* tile_mask, void* out,
                           int B, int N, int V, int H, int D, int Q, int P,
                           int LP, int q_tile, int n_tiles,
                           const MsdaLevels& lv) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned =
      (((uintptr_t)value | (uintptr_t)out) & 15) == 0 && D % VEC == 0;
  switch (aligned ? D / VEC : 0) {
#define MSDA_VEC_CASE(G_)                                                   \
  case G_:                                                                  \
    if (launch_factored_vec<T, G_>(grid, s, value, ref, off, attn,          \
                                   tile_mask, out, B, N, V, H, Q, P, LP,    \
                                   q_tile, n_tiles, lv)) {                  \
      return 1;                                                             \
    }                                                                       \
    break;
    MSDA_VEC_CASE(1)
    MSDA_VEC_CASE(2)
    MSDA_VEC_CASE(4)
    MSDA_VEC_CASE(8)
    MSDA_VEC_CASE(16)
#undef MSDA_VEC_CASE
    default:
      break;
  }
  msda_factored_scalar_kernel<T><<<grid, kFactoredWarps * 32, 0, s>>>(
      (const T*)value, ref, off, attn, tile_mask, (T*)out, B, N, V, H, D, Q,
      P, LP, q_tile, n_tiles, lv);
  return 0;
}

// The factored entry: ref (B, Q, P, 2), off (B / N, Q, H, L, P, 2), attn
// (B / N, Q, H, L, P); otherwise as msda_fwd. *variant is set to 1 when the
// vector variant ran, 0 when the general one did.
extern "C" int msda_fwd_factored(const void* value, int dtype,
                                 const float* ref, const float* off,
                                 const float* attn, const int* tile_mask,
                                 void* out, int B, int N, int V, int H, int D,
                                 int Q, int L, int P, const int* shapes,
                                 int q_tile, void* stream, int* variant) {
  MsdaLevels lv;
  if (q_tile < 1 || D < 1 || P < 1 || N < 1 || B % N != 0 ||
      (int64_t)V * H * D > INT32_MAX ||
      (int64_t)B * Q * H > INT32_MAX - kFactoredItems) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = fill_levels(&lv, L, shapes, V);
  if (err != 0) return err;
  const int64_t items = (int64_t)B * Q * H;
  if (items == 0) return 0;
  const unsigned grid = (unsigned)((items + kFactoredItems - 1) / kFactoredItems);
  const int n_tiles = (Q + q_tile - 1) / q_tile;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    *variant = launch_factored<float>(grid, s, value, ref, off, attn,
                                      tile_mask, out, B, N, V, H, D, Q, P,
                                      L * P, q_tile, n_tiles, lv);
  } else if (dtype == 1) {
    *variant = launch_factored<__nv_bfloat16>(grid, s, value, ref, off, attn,
                                              tile_mask, out, B, N, V, H, D,
                                              Q, P, L * P, q_tile, n_tiles,
                                              lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
