// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of apollo_vision_net_tpu/ops/msda_pallas.py:
//   - _msda_kernel         (decoder cross-attention, det and map decoders;
//                           at DCNv3's call sites the msda_fwd_local entry
//                           below)
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
// and, at the f32 single-level SCA over a small map, _msda_kernel_slab and
// _msda_kernel_masked through the msda_fwd_resident entry below.
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
// Plain and masked entries, narrow variant (msda_narrow_kernel<T, D>; a row
// of 4 or 8 bytes: f32 D = 1 or 2, bf16 D = 2 or 4; value and out aligned
// to a row, loc to 8 bytes; a batch element's value rows within
// kNarrowStageBytes). It serves _msda_kernel_slab
// (msda_pallas.py:234) at the voxel SCA of the hybrids' last stage: (6,
// 40,000) and (6, 160,000) voxels over one 15 x 25 map, 8 heads of D = 2, 8
// samples a head. What bounds it: bytes, the loc and attn stream (491.5 +
// 245.8 MB f32 at 160,000 voxels) and the output; value is (6, 375, 8, 2),
// 144 KB. A 16-byte row does not exist here, and the general variant's
// warp per item left 30 of 32 lanes idle in the channel walk (4% of the
// bound). The design:
//   1. A lane a sample: lane s owns sample s % S of item s / S, S = L * P
//      rounded up to a power of two (bwd_slot_log2, as msda_bwd's gather
//      kernel; rounds of 32 samples beyond 32), so a warp serves 32 / S
//      consecutive (batch, query, head) items (4 at the voxel SCA) and reads
//      their locations and weights in one coalesced load each.
//   2. Each lane forms its sample's corners with corners_at, issues its
//      four corner rows' loads (one 4- or 8-byte load each) before it uses
//      any and accumulates w x v in f32 registers; the item's S lanes are
//      reduced with __shfl_xor_sync and its first lane stores the D
//      channels (neighbouring items' stores share a sector).
//   3. A block takes a run of consecutive items of one batch element, the
//      grid one wave of resident blocks, and stages that element's value
//      rows in shared memory first (24 KB a camera at the hybrids' shape):
//      the scattered 8-byte gathers then cost a bank-conflict pass where
//      L1 costs one a cache line (staged 0.6223 ms against 0.6541 through
//      L1 at 160,000 voxels f32, 0.6159 against 0.7115 bf16; H100 at 700
//      W). Larger values take the general variant: no configuration has
//      them.
//   4. A masked tile's items write zeros and read nothing else.
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
// Tile-local entry (msda_fwd_local, msda_local_kernel<D>; f32, L = 1, the
// queries the cells of the level itself, D a multiple of 4 up to 32). It
// replaces _msda_kernel (msda_pallas.py:194) at InternImage-S's DCNv3 call
// sites (apollo_vision_net_tpu/ops/dcnv3.py dcnv3_core, ms_deform_attn at
// one level, the 9 taps as points, the groups as heads): (6, 120 x 200 /
// 60 x 100 / 30 x 50 / 15 x 25) cells, G = 5 / 10 / 20 / 40 heads of D =
// 16, 33 calls a frame. What bounds it: bytes, each input read once and the
// output written once (stage 0: value 46 MB, loc 52, attn 26, out 46:
// 0.0507 ms at 3.35 TB/s). What held the vector kernel at 18% of it: each
// value row is a corner of ~36 samples, and those ~1.66 GB of 16-byte
// gathers a call at stage 0 ran at the L2's rate (~5.8 TB/s), a block of 4
// queries sharing too few rows for L1 to help. The design:
//   1. A block takes a tile of kLocalFwdTileY x kLocalFwdTileX cells of one
//      batch element and one head (heads fastest in the grid) and copies
//      the tile's halo of value rows (kLocalHalo cells a side, clipped to
//      the map: 12 x 20 rows of 64 bytes, 15 KB, at D = 16) into shared
//      memory by 16-byte cp.async, beside a row of zeros. Every corner in
//      the halo is read there: a value row comes from L2 about twice (the
//      halos overlap) instead of ~36 times. A corner outside the halo (1.4%
//      of them at N(0, 1) px offsets) is read from global memory, so an
//      offset of any size stays exact. An edge tile packs its cells, so no
//      lane idles on a cell past the map.
//   2. A warp takes rounds of 32 / G queries (8 at D = 16). A round's
//      locations and weights arrive by cp.async into one of two buffers
//      while the warp works on the round before. A lane a sample forms the
//      corners once (sample_pos and corner_cw, the rounding of
//      bilinear_at): a code a corner (its halo row, the zero row outside
//      the grid, or ~cell outside the halo) and its weight, into the
//      warp's scratch.
//   3. G = D / 4 lanes (rounded up to a power of two) take a query, 4
//      channels a lane, and walk its P samples from the scratch, the four
//      corner loads in flight before any is used: no corner is formed or
//      passed twice and nothing is reduced across lanes; the group's D
//      channels leave as one 64-byte row.
//   4. What is left (splits below): the corner reads are shared memory's
//      (~2 wavefronts a sample, ~0.07 ms at stage 0 at 128 bytes a clock
//      an SM), the corner forming, the staging and the rounds' barriers.
//      Four blocks an SM at D = 16 (local_fwd_min_blocks).
//   Measured (chip_smoke.py, f32, NVIDIA H100 80GB HBM3 at 700 W):
//   0.1441, 0.0777, 0.0443, 0.0240 ms at stages 0-3, where the vector
//   kernel ran 0.2831, 0.1385, 0.0670, 0.0329 in the same run (bounds
//   0.0507, 0.0254, 0.0127, 0.0063). The split comes from edited copies of
//   this source built and timed beside it outside the tree, which no
//   script here reruns: at stage 0 the build without the sample walk ran
//   0.0815, without the corner forming 0.1164, without the halo's
//   staging 0.1375; a halo of 1 or 3 cells 0.1561 / 0.1449, tiles of 8 x
//   32 or 16 x 16 0.1440 / 0.1454, three blocks an SM 0.1522.
//
// Map-resident entry (msda_fwd_resident, msda_resident_kernel<D>; f32, L =
// 1, D = 4, 8, 16 or 32, a head's map within kResidentMapBytes, with or
// without a tile mask). It replaces _msda_kernel_slab (msda_pallas.py:234)
// and _msda_kernel_masked (:212) at the f32 single-level SCA over the six
// cameras' stride-32 15 x 25 map: bev_tiny_det's masked SCA (40,000
// pillars, D = 32), the voxel heads' (10,000 or 40,000 voxels, D = 32)
// and the hybrids' stages 0-3 (D = 32, 16, 8, 4). What bounds it: bytes,
// the loc and attn stream and the output (voxel_base: 184 MB in, 246 MB
// out, 0.129 ms at 3.35 TB/s); the value is 2.3 MB. What held the vector
// kernel at 14-32% of it: every corner row came through L2, each row a
// corner of 645 samples a call on average. The design:
//   1. A block takes one batch element and a group of Hb heads (the
//      largest divisor of H whose maps fit 48 KB: 1 at D = 32, 8 at D = 4
//      over 15 x 25), copies the group's whole map into shared memory by
//      16-byte cp.async once, and reads every corner there. The grid is
//      one wave of resident blocks (four an SM).
//   2. A block takes every blocks_per_pair-th tile of its pair's (query,
//      head) items, so that the masked tiles and the voxels out of a
//      camera's view (~80% of the voxel samples have no corner in the
//      grid), which cluster in query order, spread over the pair's blocks:
//      contiguous runs of items a block ran bev_tiny_det's masked SCA at
//      0.31 ms, longer than the vector kernel's 0.19.
//   3. G = D / 4 lanes an item, 4 channels a lane; lane sub forms the
//      corners of samples p0 + sub (sample_pos, corner_cw: the rounding of
//      bilinear_at) and the group walks them, each lane taking a sample's
//      codes and weights by __shfl_sync and reading its four rows. At D >=
//      16 a group walks only its samples with a corner in the grid
//      (resident_walk) and skips a masked item alone; at D <= 8 the warp's
//      groups walk in step (resident_group_mask). The first sample of a
//      lane's next item is loaded while the warp works on this one.
//   4. A masked tile's items read nothing and write zeros.
//   Measured (chip_smoke.py, f32, NVIDIA H100 80GB HBM3 at 700 W; PERF.md
//   §6): 0.2214 ms at voxel_base's SCA against the vector kernel's 0.4684
//   in the same run (bound 0.1291), 0.1748 against 0.1896 at
//   bev_tiny_det's masked SCA (bound 0.0857). Slower, in edited copies of this source timed beside
//   it outside the tree (no script here reruns them): a thread a sample
//   writing codes to a shared scratch in chunks of 1,024 samples (0.6458
//   ms at voxel_base), the walk without the ballot (0.3169).
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

// The D channels of an output row in value's dtype, as one store.
template <typename T, int D>
__device__ __forceinline__ typename NarrowRaw<D * sizeof(T)>::type pack_row(
    const float (&f)[D]) {
  if constexpr (sizeof(T) == 4 && D == 1) {
    return __float_as_uint(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    return make_uint2(__float_as_uint(f[0]), __float_as_uint(f[1]));
  } else if constexpr (D == 2) {
    return pack_bf16x2(f[0], f[1]);
  } else {
    return make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
  }
}

// The narrow variant (design notes in the header): a block takes `run`
// consecutive items of batch element blockIdx.x / blocks_per_b; lane s of a
// warp owns sample s % S of item s / S (S = 2^s_log). The batch element's
// value rows (V * H raw rows) are copied to shared memory first.
template <typename T, int D>
__global__ void __launch_bounds__(kMsdaWarps * 32, kMsdaMinBlocks)
msda_narrow_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                   const float* __restrict__ attn,
                   const int* __restrict__ tile_mask, T* __restrict__ out,
                   int V, int H, int Q, int P, int LP, int s_log, int run,
                   int blocks_per_b, int q_tile, int n_tiles, MsdaLevels lv) {
  using Raw = typename NarrowRaw<D * sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char narrow_smem[];
  __shared__ SharedLevels sl;
  const int b = blockIdx.x / blocks_per_b;
  const int per_b = Q * H;
  const int first = b * per_b + (blockIdx.x - b * blocks_per_b) * run;
  const int last = min(first + run, (b + 1) * per_b);
  const Raw* rows = reinterpret_cast<const Raw*>(value) + (int64_t)b * V * H;
  Raw* staged = reinterpret_cast<Raw*>(narrow_smem);
  for (int i = threadIdx.x; i < V * H; i += blockDim.x) {
    staged[i] = __ldg(rows + i);
  }
  stage_levels(sl, lv);  // its barrier also ends the staging

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = 1 << s_log, sub = lane & (S - 1);
  const int per_warp = 32 >> s_log;
  Raw* o = reinterpret_cast<Raw*>(out);
  // the warp's items: the same bound for all its lanes
  for (int item0 = first + warp * per_warp; item0 < last;
       item0 += kMsdaWarps * per_warp) {
    const int item = item0 + (lane >> s_log);
    const bool live = item < last;
    const int bq = item / H, hh = item - bq * H;
    bool on = live;
    if (on && tile_mask != nullptr) {
      on = __ldg(tile_mask + (int64_t)b * n_tiles + (bq - b * Q) / q_tile) != 0;
    }
    float acc[D];
#pragma unroll
    for (int e = 0; e < D; ++e) acc[e] = 0.f;
    for (int r0 = 0; r0 < LP; r0 += S) {  // several rounds only when S = 32
      const int s = r0 + sub;
      if (on && s < LP) {
        const int64_t at = (int64_t)item * LP + s;
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + at);
        // row H: idx = cell * H, the corner's row idx + hh
        const Corners4 c = corners_at(sl, s / P, xy.x, xy.y, __ldg(attn + at), H);
        Raw v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // the four loads in flight
          v[k] = c.idx[k] < 0 ? Raw{} : staged[c.idx[k] + hh];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float f[D];
          unpack_row<T, D>(f, v[k]);
#pragma unroll
          for (int e = 0; e < D; ++e) acc[e] = fmaf(c.wt[k], f[e], acc[e]);
        }
      }
    }
    for (int m = 1; m < S; m <<= 1) {
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] += __shfl_xor_sync(FULL_MASK, acc[e], m);
    }
    if (live && sub == 0) o[item] = pack_row<T, D>(acc);  // zeros when masked
  }
}

// ------------------------------------------------------------ local entry

// Four blocks an SM (at most 64 registers) at D = 4, 8, 16 and 32, as many
// as the forward's shared memory allows at D = 16: left to itself ptxas
// took 66 registers and three blocks, 7% slower at DCNv3's stage 0 (H100).
// The widths with a lane of each query idle (12, 20, 24, 28) spill at 64
// and keep three.
template <int D>
constexpr int local_fwd_min_blocks() {
  return (D & (D - 1)) == 0 ? 4 : 3;
}

// The tile-local forward (design notes in the header): a block stages its
// tile's halo; each warp takes 32 / G queries a round. The round's
// locations and weights arrive by cp.async while the warp works on the
// round before; its lanes form the round's corners, a lane a sample (codes
// and weights into the warp's scratch); then G lanes take a query, 4
// channels a lane (D <= 4 G; lanes past D hold none), and walk its P
// samples' corners from the scratch.
template <int D>
__global__ void __launch_bounds__(kLocalThreads, local_fwd_min_blocks<D>())
msda_local_kernel(const float* __restrict__ value,
                  const float* __restrict__ loc,
                  const float* __restrict__ attn, float* __restrict__ out,
                  int h, int w, int H, int P, int tiles_y, int tiles_x) {
  constexpr int G = local_lanes(D);
  constexpr int TY = kLocalFwdTileY, TX = kLocalFwdTileX;
  constexpr int NH = (TY + 2 * kLocalHalo) * (TX + 2 * kLocalHalo);
  constexpr int QW = 32 / G;                  // queries a warp's round
  constexpr int WARPS = kLocalThreads / 32;
  extern __shared__ __align__(16) float local_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_round = QW * P;               // samples a round
  const int all = WARPS * per_round;          // the warps' rounds
  float* halo = local_smem;                   // (NH + 1) x D: row NH zeros
  int4* codes = reinterpret_cast<int4*>(halo + (NH + 1) * D) + warp * per_round;
  float4* wts = reinterpret_cast<float4*>(codes - warp * per_round + all) +
                warp * per_round;
  // two buffers of a round's locations and weights
  float2* xy_s = reinterpret_cast<float2*>(wts - warp * per_round + all) +
                 warp * per_round;
  float* a_s = reinterpret_cast<float*>(xy_s - warp * per_round + 2 * all) +
               warp * per_round;
  const LocalTile t =
      local_tile(blockIdx.x, H, tiles_x, tiles_y, h, w, TY, TX);
  const int V = h * w, row = H * D;  // row: elements between cells
  const float* vb = value + (int64_t)t.b * V * row + t.hh * D;
  const int64_t lo = (int64_t)t.b * V * H * P;
  const float2* lb = reinterpret_cast<const float2*>(loc) + lo;
  const float* ab = attn + lo;
  // s / P as __umulhi(s, magic): exact for s * P < 2^32
  const unsigned magic = 0xffffffffu / (unsigned)P + 1u;
  int i0 = warp * QW;
  stage_halo<G>(halo, vb, t, w, row, D);
  stage_round<QW>(xy_s, a_s, lb, ab, t, w, H, P, i0, magic);
  cp_async_commit_group();
  for (int i = threadIdx.x; i < D; i += blockDim.x) halo[NH * D + i] = 0.f;
  cp_async_wait_group<0>();
  __syncthreads();

  const int grp = lane / G, ch = (lane % G) * 4;
  const bool chan = ch < D;
  const int cr = chan ? ch : 0;  // a lane past D reads channels it drops
  const float fw = (float)w, fh = (float)h;
  for (int r = 0; i0 < t.nq; i0 += WARPS * QW, ++r) {
    const int buf = (r & 1) * all;
    if (i0 + WARPS * QW < t.nq) {  // the next round's, in flight
      stage_round<QW>(xy_s + all - buf, a_s + all - buf, lb, ab, t, w, H, P,
                      i0 + WARPS * QW, magic);
    }
    cp_async_commit_group();
    cp_async_wait_group<1>();
    __syncwarp();
    // a lane a sample: the round's corners
    for (int s = lane; s < per_round; s += 32) {
      const int qi = i0 + (int)__umulhi((unsigned)s, magic);
      int code[4] = {NH, NH, NH, NH};
      float cw[4] = {0.f, 0.f, 0.f, 0.f};
      if (qi < t.nq) {
        const float2 xy = xy_s[buf + s];
        const float a = a_s[buf + s];
        local_corners(sample_pos(fw, fh, xy.x, xy.y), t, h, w, NH, code, cw);
#pragma unroll
        for (int k = 0; k < 4; ++k) cw[k] = __fmul_rn(cw[k], a);
      }
      codes[s] = make_int4(code[0], code[1], code[2], code[3]);
      wts[s] = make_float4(cw[0], cw[1], cw[2], cw[3]);
    }
    __syncwarp();
    // G lanes a query: its samples' corner rows, 4 channels a lane
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 3
    for (int p = 0; p < P; ++p) {
      const int4 cd = codes[grp * P + p];
      const float4 wt = wts[grp * P + p];
      const int c[4] = {cd.x, cd.y, cd.z, cd.w};
      const float wk[4] = {wt.x, wt.y, wt.z, wt.w};
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // the four loads in flight
        v[k] = *reinterpret_cast<const float4*>(
            halo + (c[k] < 0 ? NH : c[k]) * D + cr);
      }
      if ((c[0] | c[1] | c[2] | c[3]) < 0) {  // in the grid, outside the halo
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c[k] < 0) {
            v[k] = __ldg(reinterpret_cast<const float4*>(
                vb + (int64_t)~c[k] * row + cr));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc.x = fmaf(wk[k], v[k].x, acc.x);
        acc.y = fmaf(wk[k], v[k].y, acc.y);
        acc.z = fmaf(wk[k], v[k].z, acc.z);
        acc.w = fmaf(wk[k], v[k].w, acc.w);
      }
    }
    const int qi = i0 + grp;
    if (chan && qi < t.nq) {
      const TileCell q = tile_cell(t, qi);
      const int64_t item = ((int64_t)t.b * V + q.y * w + q.x) * H + t.hh;
      *reinterpret_cast<float4*>(out + item * D + ch) = acc;
    }
    __syncwarp();  // the scratch is the next round's
  }
}

// ------------------------------------------------------------ resident entry

// The map-resident forward (design notes in the header): a block stages
// its head group's whole map, then takes tiles of 8 x 32 / G items of its
// (batch element, head group) pair, every blocks_per_pair-th tile from
// its own, so that the pair's blocks share its masked and out-of-view
// queries. Each warp takes 32 / G items of a tile, G = D / 4 lanes an item
// and 4 channels a lane. Lane `sub` of a group forms the corners of samples
// p0 + sub; the group walks them, each lane taking a sample's codes and
// weights from its owner by __shfl_sync (G = 1: its own), and reads the
// four corner rows from the staged map. The first sample of each lane's
// next item is loaded while the warp works on this one. A sample with no
// corner in the grid reads no row; an item of a masked tile reads nothing
// and writes zeros.
template <int D>
__global__ void __launch_bounds__(kResidentThreads)
msda_resident_kernel(const float* __restrict__ value,
                     const float* __restrict__ loc,
                     const float* __restrict__ attn,
                     const int* __restrict__ tile_mask,
                     float* __restrict__ out, int h, int w, int H, int Hb,
                     int Q, int P, int blocks_per_pair, int q_tile,
                     int n_tiles) {
  constexpr int G = D / 4;
  constexpr int QW = 32 / G;  // items a warp takes at once
  constexpr int TILE = kResidentThreads / G;
  extern __shared__ __align__(16) float res_smem[];
  const int V = h * w, NR = V * Hb;
  const int pair = blockIdx.x / blocks_per_pair;
  const int first = (blockIdx.x - pair * blocks_per_pair) * TILE;
  const int stride = blocks_per_pair * TILE, n_items = Q * Hb;
  const int groups = H / Hb;
  const int b = pair / groups, h0 = (pair - b * groups) * Hb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, sub = lane % G;
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  // item it's row of out and its first sample; whether its tile is active
  auto item_of = [&](int it, int64_t& row, bool& on) {
    const int q = it / Hb;
    row = ((int64_t)b * Q + q) * H + h0 + it - q * Hb;
    on = it < n_items && (tile_mask == nullptr ||
                          __ldg(tile_mask + b * n_tiles + q / q_tile) != 0);
  };
  int64_t row;
  bool on;
  float2 nxy = make_float2(0.f, 0.f);
  float na = 0.f;
  item_of(first + warp * QW + grp, row, on);
  if (on && sub < P) {
    nxy = __ldg(loc2 + row * P + sub);
    na = __ldg(attn + row * P + sub);
  }
  stage_resident_map(res_smem, value + ((int64_t)b * V * H + h0) * D, V, H,
                     Hb, D);
  cp_async_commit_group();
  for (int i = threadIdx.x; i < D; i += blockDim.x) res_smem[NR * D + i] = 0.f;
  cp_async_wait_group<0>();
  __syncthreads();

  const float fw = (float)w, fh = (float)h;
  // the lanes that pass a sample round: the group's own where it may skip
  // alone (resident_walk), else the warp's
  const unsigned gmask = resident_group_mask<G>(grp);
  for (int t0 = first; t0 < n_items; t0 += stride) {
    const int it = t0 + warp * QW + grp;
    const int64_t item = row;
    const bool live = it < n_items, cur_on = on;
    const float2 cxy = nxy;
    const float ca = na;
    // the next tile's first samples, in flight during this one
    item_of(it + stride, row, on);
    if (on && sub < P) {
      nxy = __ldg(loc2 + row * P + sub);
      na = __ldg(attn + row * P + sub);
    }
    if (G >= kResidentBallotLanes && !cur_on) {  // past the end or masked
      if (live) {
        *reinterpret_cast<float4*>(out + item * D + sub * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      continue;
    }
    const int hl = it % Hb;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p0 = 0; p0 < P; p0 += G) {
      int code[4] = {NR, NR, NR, NR};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      const int p = p0 + sub;
      if (cur_on && p < P) {
        float2 xy = cxy;
        float a = ca;
        if (p0 > 0) {
          xy = __ldg(loc2 + item * P + p);
          a = __ldg(attn + item * P + p);
        }
        resident_corners(sample_pos(fw, fh, xy.x, xy.y), h, w, Hb, hl, NR,
                         code, wt);
#pragma unroll
        for (int k = 0; k < 4; ++k) wt[k] = __fmul_rn(wt[k], a);
      }
      // the group's samples with a corner in the grid, one at a time
      unsigned todo = resident_walk<G>(
          gmask, grp, code[0] != NR || code[1] != NR || code[2] != NR ||
                          code[3] != NR, P - p0);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        int c[4];
        float wk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (G == 1) {
            c[k] = code[k];
            wk[k] = wt[k];
          } else {
            c[k] = __shfl_sync(gmask, code[k], grp * G + j);
            wk[k] = __shfl_sync(gmask, wt[k], grp * G + j);
          }
        }
        if (c[0] == NR && c[1] == NR && c[2] == NR && c[3] == NR) {
          continue;  // no corner in the grid
        }
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // the four loads in flight
          v[k] = *reinterpret_cast<const float4*>(res_smem + c[k] * D + sub * 4);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc.x = fmaf(wk[k], v[k].x, acc.x);
          acc.y = fmaf(wk[k], v[k].y, acc.y);
          acc.z = fmaf(wk[k], v[k].z, acc.z);
          acc.w = fmaf(wk[k], v[k].w, acc.w);
        }
      }
    }
    if (live) *reinterpret_cast<float4*>(out + item * D + sub * 4) = acc;
  }
}

// ------------------------------------------------------------- host side

// The narrow variant stages a batch element's value rows in shared memory
// and takes only those of at most this many bytes (the hybrids' D = 2
// stage: 375 cells x 8 heads x 8 bytes = 24 KB in f32); with the level
// table the block stays under the 48 KB a launch takes without an opt-in.
constexpr int kNarrowStageBytes = 40 * 1024;

// The narrow variant at head width D.
template <typename T, int D>
static cudaError_t launch_narrow(cudaStream_t s, const void* value,
                                 const float* loc, const float* attn,
                                 const int* tile_mask, void* out, int B, int V,
                                 int H, int Q, int P, int LP, int q_tile,
                                 int n_tiles, const MsdaLevels& lv) {
  using Raw = typename NarrowRaw<D * sizeof(T)>::type;
  const int s_log = bwd_slot_log2(LP);
  const int smem = V * H * (int)sizeof(Raw);
  auto kernel = &msda_narrow_kernel<T, D>;
  NarrowRuns r;
  const cudaError_t e =
      narrow_runs((const void*)kernel, kMsdaWarps * 32, smem, Q * H, B,
                  kMsdaWarps * (32 >> s_log), &r);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)((int64_t)r.blocks_per_b * B), kMsdaWarps * 32, smem, s>>>(
      (const T*)value, loc, attn, tile_mask, (T*)out, V, H, Q, P, LP, s_log,
      r.run, r.blocks_per_b, q_tile, n_tiles, lv);
  return cudaSuccess;
}

// The variants of the plain and masked entry (ops/msda_cuda.py VARIANTS).
constexpr int kFwdGeneral = 0, kFwdVector = 1, kFwdNarrow = 2;

// Launches the vector variant when D fills G = D * sizeof(T) / 16 lanes (G
// a power of two up to 16), value and out are 16-byte aligned and loc
// 8-byte aligned; else the narrow variant when a row is 4 or 8 bytes (f32
// D = 1 or 2, bf16 D = 2 or 4), value and out are aligned to it, loc to 8
// bytes and a batch element's V * H rows take at most kNarrowStageBytes;
// else the general variant. Sets *variant to kFwdVector,
// kFwdNarrow or kFwdGeneral; returns a cudaError_t of the host-side set-up.
template <typename T>
static cudaError_t launch_msda(cudaStream_t s, const void* value,
                               const float* loc, const float* attn,
                               const int* tile_mask, void* out, int B, int V,
                               int H, int D, int Q, int P, int LP, int q_tile,
                               int n_tiles, const MsdaLevels& lv,
                               int* variant) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = (((uintptr_t)value | (uintptr_t)out) & 15) == 0 &&
                       ((uintptr_t)loc & 7) == 0 && D % VEC == 0;
  const unsigned grid = (unsigned)(((int64_t)B * Q + kMsdaWarps - 1) / kMsdaWarps);
  *variant = kFwdVector;
  switch (aligned ? D / VEC : 0) {
#define MSDA_VEC_CASE(G_)                                                    \
  case G_:                                                                   \
    msda_vec_kernel<T, G_><<<grid, kMsdaWarps * 32, 0, s>>>(                 \
        (const T*)value, loc, attn, tile_mask, (T*)out, B, V, H, Q, P, LP,   \
        q_tile, n_tiles, lv);                                                \
    return cudaSuccess;
    MSDA_VEC_CASE(1)
    MSDA_VEC_CASE(2)
    MSDA_VEC_CASE(4)
    MSDA_VEC_CASE(8)
    MSDA_VEC_CASE(16)
#undef MSDA_VEC_CASE
    default:
      break;
  }
  const int nb = D * (int)sizeof(T);  // bytes of a row
  if ((nb == 4 || nb == 8) && ((uintptr_t)value | (uintptr_t)out) % nb == 0 &&
      ((uintptr_t)loc & 7) == 0 && (int64_t)V * H * nb <= kNarrowStageBytes) {
    *variant = kFwdNarrow;
#define MSDA_NARROW(D_)                                                       \
  launch_narrow<T, D_>(s, value, loc, attn, tile_mask, out, B, V, H, Q, P,    \
                       LP, q_tile, n_tiles, lv)
    if constexpr (sizeof(T) == 4) {
      return D == 1 ? MSDA_NARROW(1) : MSDA_NARROW(2);
    } else {
      return D == 2 ? MSDA_NARROW(2) : MSDA_NARROW(4);
    }
#undef MSDA_NARROW
  }
  *variant = kFwdGeneral;
  const unsigned items =
      (unsigned)(((int64_t)B * Q * H + kFactoredItems - 1) / kFactoredItems);
  msda_scalar_kernel<T><<<items, kFactoredWarps * 32, 0, s>>>(
      (const T*)value, loc, attn, tile_mask, (T*)out, B, V, H, D, Q, P, LP,
      q_tile, n_tiles, lv);
  return cudaSuccess;
}

// Returns 0 on success, else a cudaError_t code. shapes points to 2 * L host
// ints (h0, w0, h1, w1, ...); tile_mask may be null; dtype 0 = f32, 1 = bf16.
// *variant is set to the variant that ran: 1 vector, 2 narrow, 0 general.
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
  cudaError_t e;
  if (dtype == 0) {
    e = launch_msda<float>(s, value, loc, attn, tile_mask, out, B, V, H, D, Q,
                           P, L * P, q_tile, n_tiles, lv, variant);
  } else if (dtype == 1) {
    e = launch_msda<__nv_bfloat16>(s, value, loc, attn, tile_mask, out, B, V,
                                   H, D, Q, P, L * P, q_tile, n_tiles, lv,
                                   variant);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
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

// The shared memory of msda_local_kernel: the largest halo's rows and a
// row of zeros, and for each warp's round of samples their corner codes
// and weights and two buffers of locations and weights (ops/msda_cuda.py
// local_fwd_smem mirrors it).
static inline int local_fwd_smem(int D, int P) {
  return (local_halo_rows(kLocalFwdTileY, kLocalFwdTileX) + 1) * D * 4 +
         (kLocalThreads / 32) * (32 / local_lanes(D)) * P * (16 + 16 + 2 * 12);
}

// The tile-local entry: value (B, h * w, H, D) f32 with D a multiple of 4
// from 4 to 32, loc (B, h * w, H, 1, P, 2) and attn (B, h * w, H, 1, P)
// f32 (query q at cell (q / w, q % w)), out (B, h * w, H * D) f32; value
// and out 16-byte aligned, loc 8-byte aligned. Returns 0 on success, else
// a cudaError_t code (cudaErrorInvalidValue for inputs it does not take).
extern "C" int msda_fwd_local(const float* value, const float* loc,
                              const float* attn, float* out, int B, int h,
                              int w, int H, int D, int P, void* stream) {
  constexpr int TY = kLocalFwdTileY, TX = kLocalFwdTileX;
  if (B < 0 || h < 1 || w < 1 || H < 1 || P < 1 || P > 1024 || D < 4 ||
      D > 32 || D % 4 != 0 ||
      (((uintptr_t)value | (uintptr_t)out) & 15) != 0 ||
      ((uintptr_t)loc & 7) != 0 || (int64_t)h * w * H * P > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_y = (h + TY - 1) / TY, tiles_x = (w + TX - 1) / TX;
  const int64_t blocks = (int64_t)B * tiles_y * tiles_x * H;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const int smem = local_fwd_smem(D, P);
  if (smem > kLocalMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, const float*, float*, int, int,
                 int, int, int, int) = nullptr;
  switch (D) {
#define MSDA_LOCAL_CASE(D_) \
  case D_:                  \
    kernel = msda_local_kernel<D_>; \
    break;
    MSDA_LOCAL_CASE(4)
    MSDA_LOCAL_CASE(8)
    MSDA_LOCAL_CASE(12)
    MSDA_LOCAL_CASE(16)
    MSDA_LOCAL_CASE(20)
    MSDA_LOCAL_CASE(24)
    MSDA_LOCAL_CASE(28)
    MSDA_LOCAL_CASE(32)
#undef MSDA_LOCAL_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, kLocalThreads, smem, (cudaStream_t)stream>>>(
      value, loc, attn, out, h, w, H, P, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

// The shared memory of msda_resident_kernel: the head group's map and a
// row of zeros (ops/msda_cuda.py resident_fwd_smem mirrors it).
static inline int resident_fwd_smem(int V, int Hb, int D) {
  return (V * Hb + 1) * D * 4;
}

// The map-resident entry: value (B, V, H, D) f32 over one h x w level (V =
// h * w), D = 4, 8, 16 or 32; loc (B, Q, H, 1, P, 2) and attn (B, Q, H,
// 1, P) f32; tile_mask (B, ceil(Q / q_tile)) int32 or null; out (B, Q,
// H * D) f32. value and out 16-byte aligned, loc 8-byte aligned, and at
// least one head's map within kResidentMapBytes (resident_heads). Returns 0
// on success, else a cudaError_t code (cudaErrorInvalidValue for inputs
// it does not take).
extern "C" int msda_fwd_resident(const float* value, const float* loc,
                                 const float* attn, const int* tile_mask,
                                 float* out, int B, int h, int w, int H,
                                 int D, int Q, int P, int q_tile,
                                 void* stream) {
  if (B < 0 || Q < 0 || h < 1 || w < 1 || H < 1 || P < 1 ||
      P > kResidentMaxPoints || q_tile < 1 ||
      (D != 4 && D != 8 && D != 16 && D != 32) ||
      (((uintptr_t)value | (uintptr_t)out) & 15) != 0 ||
      ((uintptr_t)loc & 7) != 0 || (int64_t)Q * H > INT32_MAX ||
      (int64_t)B * H > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)h * w * 16 > kResidentMapBytes) return (int)cudaErrorInvalidValue;
  const int V = h * w, Hb = resident_heads(V, H, D);
  if (Hb < 1) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Q == 0) return 0;
  const int smem = resident_fwd_smem(V, Hb, D);
  void (*kernel)(const float*, const float*, const float*, const int*,
                 float*, int, int, int, int, int, int, int, int, int) = nullptr;
  switch (D) {
    case 4:
      kernel = msda_resident_kernel<4>;
      break;
    case 8:
      kernel = msda_resident_kernel<8>;
      break;
    case 16:
      kernel = msda_resident_kernel<16>;
      break;
    default:
      kernel = msda_resident_kernel<32>;
      break;
  }
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int pairs = B * (H / Hb);
  const int per_pair = resident_blocks_per_pair(
      (const void*)kernel, smem, B, H, Hb, Q, kResidentThreads / (D / 4), &e);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)((int64_t)per_pair * pairs), kResidentThreads, smem,
           (cudaStream_t)stream>>>(value, loc, attn, tile_mask, out, h, w, H,
                                   Hb, Q, P, per_pair, q_tile,
                                   (Q + q_tile - 1) / q_tile);
  return (int)cudaGetLastError();
}
