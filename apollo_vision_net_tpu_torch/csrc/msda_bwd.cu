// Multi-scale deformable attention backward for Hopper (sm_90a).
//
// Four entries: msda_bwd, the gradient of the plain and masked MSDA entry
// (msda_fwd in msda_fwd.cu) with respect to value, the sampling locations
// and the attention weights; msda_bwd_factored, the gradient of the
// factored entry (msda_fwd_factored), described at its section below;
// msda_bwd_local, the gradient of the tile-local entry (msda_fwd_local);
// and msda_bwd_resident, the gradient of the map-resident entry
// (msda_fwd_resident). In
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
// contiguous. An item is a (batch, query, head), item = (b * Q + q) * H + h;
// a row is a (batch, cell, head) of value, row = (b * V + cell) * H + h.
//
// What bounds msda_bwd on the H100: as a function, bytes (grad_out, loc
// and attn read once, the touched value rows read once, the three
// gradients written once): 0.055 ms bf16 at the base TSA (2 x 40,000
// queries, H = 8, D = 32, L * P = 4 over 200 x 200). The work is 16 corner
// rows of D channels per item, each read (a dot product with g) and added
// to (a * cw * g): 10.24M rows at the base TSA. Measured (PERF.md §6, bf16,
// NVIDIA H100 80GB HBM3, 700 W):
//   - The first design (a warp per item, L * P = 4 lanes of 32 busy, one
//     corner row in flight, a scalar f32 atomicAdd a channel into an f32
//     scratch that a memset clears and a kernel casts) ran 0.886 ms at the
//     base TSA, 0.746 without its adds: bound by latency, not the adds; at
//     the base decoders the scratch's memset and cast were 0.047 of 0.070.
//   - The vector kernel below with 16-byte f32 atomicAdds into the scratch
//     ran 0.534 (its adds 0.28: ~3e11 16-byte atomics a second); a block
//     summing a window of rows around a tile of TSA queries through a
//     counting sort in shared memory ran 0.547 (two blocks an SM, barriers);
//     the gather below 0.37, and 0.02 at the base decoders (no scratch).
//
// Design of msda_bwd's vector plan, "gather" (D = 4 G, G = 1, 2, 4 or 8,
// value and grad_out aligned to 4 channels):
//   1. Several items a warp: lane s owns sample s % S of item s / S, with
//      S = L * P rounded up to a power of two (at least 4; rounds of 32
//      samples of one item when L * P > 32), so a warp serves 32 / S items
//      (8 at L * P = 4, 4 at L * P = 8). Each lane forms its sample's
//      corners and weights; a masked tile's items own nothing and write
//      zero gradients, per item, so a warp may straddle tiles; a warp with
//      no active item only writes zeros.
//   2. G lanes hold one corner row, 4 channels a lane (round_dots, as the
//      factored kernel's round): for each corner the group takes the rows
//      of its own G lanes' samples, keeps a batch of loads in flight (64
//      bytes a lane: a corner's rows at bf16 D = 32, half of them in f32)
//      before it uses any and reduce-scatters the G partial dot products
//      (group_reduce_scatter) so that each owner lane ends with its own
//      dot. A group's lanes span at most two items, so a lane keeps two
//      grad_out rows' channels.
//   3. grad_value without float atomics or a scratch: the owner lane of
//      each in-grid corner pushes the corner's fixed slot onto its value
//      row's list with one integer atomicExch before the dots, and stores
//      the slot's (link, weight) after them (the exchange's return is
//      waited on there). A second kernel (msda_bwd_gather_kernel) walks
//      each row's list, sums weight x grad_out row in f32 registers and
//      writes the row in value's dtype, zeros included (the JAX VJP also
//      sums in f32 and casts at the boundary). The lists group the slots by
//      row as a counting sort would, without the global scan a sort needs.
//      At the base TSA the exchanges cost ~0.08 ms and the row pass ~0.13
//      (a chain of dependent loads and a grad_out row re-read per corner).
// Design of msda_bwd's "private" plan (D = 1 or 2, value and grad_out
// aligned to a row, a batch element's V * H * D f32 grad_value rows and
// value rows within kPrivateMaxBytes; msda_bwd_private_kernel). It serves _bwd
// (msda_pallas.py:1468, the XLA VJP) at the hybrids' last stage, D = 2
// over one 15 x 25 map: grad_value is (6, 375, 8, 2), 36,000 floats, onto
// which the general kernel made ~82M scalar f32 global atomics at 160,000
// voxels (7% of the bound). What bounds it: bytes, the loc, attn and
// grad_out stream and the grad_loc and grad_attn writes (0.4586 ms f32).
//   1. The forward's narrow layout: a lane a sample of 32 / S items (4 at
//      L * P = 8); each lane reads its item's D channels of grad_out, forms
//      its corners with bilinear_at, loads the four corner rows, computes
//      the dots and the sample's d loc and d attn with sample_grad and
//      stores them (coalesced across the warp).
//   2. A block of 8 warps takes a run of consecutive items of one batch
//      element (the grid one wave of resident blocks), zeroes a private
//      f32 copy of that element's grad_value rows in shared memory (24 KB
//      at the hybrids' shape) and stages its value rows beside them
//      (staged 1.3589 ms against 1.4519 through L1 at 160,000 voxels f32,
//      1.1574 against 1.4480 bf16; H100 at 700 W); each corner's a * cw * g is added there with shared f32
//      atomics, which sm_90 runs as a compare-and-swap loop (the reason
//      msda_bwd_factored sorts instead), cheap here with 2 channels a row
//      and rows spread over 8 heads.
//   3. At the end of its run the block adds its nonzero private channels to
//      the f32 scratch with global atomics: ~6,000 a block against ~82M in
//      the general kernel. The scratch is zeroed before and, for bf16
//      value, cast once after, as the general plan does; the sum's order
//      varies from run to run.
//   4. A masked tile's items write zero d loc and d attn and add nothing.
// Design of the tile-local entry, msda_bwd_local (msda_bwd_local_kernel<D>;
// f32, L = 1, the queries the cells of the level itself, D a multiple of 4
// up to 32): the gradient of msda_fwd_local (msda_fwd.cu). It replaces the
// backward of _msda_kernel at InternImage-S's DCNv3 call sites, the XLA VJP
// _bwd (msda_pallas.py:1468). What bounds it: bytes (stage 0, (6, 120 x
// 200), G = 5 heads of D = 16, 9 taps: grad_out 46 MB, loc and attn 78,
// value 46 read; grad_value 46 and grad_loc and grad_attn 78 written:
// 0.0877 ms at 3.35 TB/s). The gather plan reads ~1.66 GB of corner rows
// at stage 0 through L2 for its dots, pushes each of its ~25.9M corners
// onto a global list and re-reads a grad_out row per corner in its row
// pass (0.663 + 0.330 ms f32). Here:
//   1. A block takes a tile of kLocalBwdTileY x kLocalBwdTileX cells of
//      one batch element and one head, stages its halo of value rows and
//      its warps' rounds of locations and weights as the forward does, and
//      forms each sample's corners once, a lane a sample.
//   2. G lanes take a query, 4 channels a lane: the query's grad_out row is
//      read once, coalesced, and kept in registers and in shared memory;
//      each sample's four partial dot products are reduce-scattered over
//      the group (log2 G shuffles); a lane a sample then forms d loc and d
//      attn (sample_grad) and stores them coalesced.
//   3. grad_value by a block-local counting sort: a corner of nonzero
//      weight in the halo takes a fixed slot (weight) and counts into its
//      halo row with an integer shared atomic (native, where a shared f32
//      add is a compare-and-swap loop on sm_90); one scan and one placement
//      later the block sums each halo row's slots in registers and adds
//      the row to the f32 grad_value once with 16-byte global atomics
//      (~1,000 adds a tile of 128 queries against ~4,600 corners). A corner
//      outside the halo adds its row at once. Corners of weight exactly 0
//      add nothing (three of four at a zero offset). Design (a), every
//      corner a 16-byte global add, lost to it (splits below).
//   4. A block takes ~74 KB of shared memory at D = 16, three an SM: the
//      halo of 2 cells a side keeps it there (3 cells took 81 KB, two an
//      SM, and ran 30% slower).
//   Measured (chip_smoke.py, f32, NVIDIA H100 80GB HBM3 at 700 W):
//   0.5167, 0.2740, 0.1518, 0.0841 ms at DCNv3's stages 0-3, where the
//   gather plan ran 0.9956, 0.5488, 0.2951, 0.1414 in the same run (bounds
//   0.0877, 0.0438, 0.0219, 0.0110). The split comes from edited copies of
//   this source built and timed beside it outside the tree, which no
//   script here reruns: at stage 0 the build without the counting sort (record, place, sum) ran 0.2664, without the row sums
//   0.3239, without the corner reads 0.4787, without d loc and d attn
//   0.4811; design (a) 0.7398; a halo of 3 cells 0.6625 (two blocks an
//   SM), of 1 cell 0.5018; tiles of 4 x 32 or 8 x 32 0.6285 / 0.9261. The
//   row sums read a grad_out row from shared memory a corner: ~1
//   wavefront a corner, ~0.12 ms at stage 0 at 128 bytes a clock an SM.
// Design of the map-resident entry, msda_bwd_resident
// (msda_bwd_resident_items_kernel<D> at D = 16, 32,
// msda_bwd_resident_samples_kernel<D> at D = 4, 8; f32, L = 1, a head's
// map within kResidentMapBytes, with or without a tile mask): the gradient
// of msda_fwd_resident. It replaces _bwd (msda_pallas.py:1468, the XLA
// VJP) at the f32 single-level SCA over the cameras' 15 x 25 map. What
// bounds it: bytes, the loc, attn and grad_out stream and the grad_loc and
// grad_attn writes (voxel_base: 0.1848 ms). The gather plan walked each
// row's list, 645 corners on average and 2,415 at most there, as a chain
// of dependent loads, after pushing every corner onto it with a global
// atomicExch. Here:
//   1. A block stages a head group's whole map as the forward does and
//      takes every blocks_per_pair-th tile of its pair; every corner row is
//      read from shared memory.
//   2. D = 16, 32: G = D / 4 lanes an item, as the forward: the item's
//      grad_out row read once, 4 channels a lane; the group walks its
//      samples with a corner in the grid, the four partial dot products
//      summed over the group (log2 G shuffles each), the owner lane keeps
//      its sample's and stores d loc and d attn (sample_grad). D = 4, 8: G
//      lanes a sample (32 or 16 samples a warp in flight), every lane
//      forming the sample's corners.
//   3. grad_value: each corner in the grid of nonzero weight adds weight x
//      grad_out to its row of the f32 grad_value (zero-filled first) by a
//      16-byte atomic a lane, the group's G adds one contiguous row, in an
//      order that varies from run to run. Other designs, built from edited
//      copies of this source and timed beside it outside the tree (no
//      script here reruns them; f32, NVIDIA H100 80GB HBM3 at 700 W; PERF.md
//      §6): a block-local counting sort of a chunk's corners by map row,
//      one add a row and chunk, ran 1.26 ms at voxel_base's SCA (1.85 with
//      the chunks dealt round the blocks); shared f32 atomics into a
//      private copy of the map, flushed once a block, 2.83 in this lane
//      layout and 3.56 in the chunked one (a compare-and-swap loop a
//      channel on sm_90); per-corner adds by a thread a sample, the
//      atomics scattered over rows, 1.60; these coalesced adds 0.81-0.95
//      (chip_smoke.py: 0.8484-0.8747, gather 2.16-2.17, bound 0.1848).
//   4. A masked tile's items read nothing and get zero d loc and d attn.
// The general kernel (any D or alignment; msda_bwd_scalar_kernel): one
// warp per item, lane s forming sample s; the warp walks the samples, the
// lanes the channels of each corner row (chunks of 32), each row's load
// used at once, a shuffle reduction a row and a scalar f32 atomicAdd a
// channel into an f32 scratch, cast once for bf16.
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

constexpr int kBwdWarps = 4;  // warps a block: msda_bwd's, the general kernels
constexpr int kGatherThreads = 256;  // threads per block of the gather kernel

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

// Four f32 channels stored in one 8-byte (bf16, rounded once) or 16-byte
// (f32) store.
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// Recursive-halving reduce-scatter over the G lanes of a group: lane `sub`
// holds G partial sums p[0..G-1] (one per row) and ends with the group's
// total of row `sub` in p[0]. G - 1 shuffles.
template <int G>
__device__ __forceinline__ void group_reduce_scatter(float (&p)[G], int sub) {
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1) {
    const bool upper = (sub & m) != 0;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const float send = upper ? p[j] : p[j + m];
      const float keep = upper ? p[j + m] : p[j];
      p[j] = keep + __shfl_xor_sync(FULL_MASK, send, m);
    }
  }
}

// Four channels of value as loaded (8 bytes of bf16, 16 of f32), kept raw
// while in flight, and their dot product with g in f32.
__device__ __forceinline__ uint2 load_raw4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 load_raw4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float dot4(const float (&g)[4], uint2 v) {
  return g[0] * __uint_as_float(v.x << 16) +
         g[1] * __uint_as_float(v.x & 0xffff0000u) +
         g[2] * __uint_as_float(v.y << 16) +
         g[3] * __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ float dot4(const float (&g)[4], float4 v) {
  return g[0] * v.x + g[1] * v.y + g[2] * v.z + g[3] * v.w;
}

// Rows a lane has in flight: 64 bytes of raw loads (8 in bf16, 4 in f32).
template <typename T, int G>
struct FactoredBwdBatch {
  static constexpr int kRaw = 4 * (int)sizeof(T);
  static constexpr int value = G < 64 / kRaw ? G : 64 / kRaw;
};

// The dot products of one round of msda_bwd's vector kernel: lane s owns
// a sample with corners c and row offset `base` (corner k's row at element
// base + c.idx[k]; nothing outside the grid). The G lanes of a group hold
// a corner row, 4 channels a lane (vb: the lane's channels of element 0),
// and take the rows of their own G lanes' samples in turn, a batch of
// loads in flight before any is used (FactoredBwdBatch rows of a corner,
// or several corners' rows when one corner's take less than 64 bytes);
// then each corner's G partial dot products (with grad_out channels
// g[t < G / 2 ? 0 : 1] for the row of lane grp * G + t) are
// reduce-scattered so that each owner lane ends with its own dot. Reads
// only: the second pass gathers the rows' grad_value (the factored
// round adds to them as it goes).
template <typename T, int G>
__device__ __forceinline__ void round_dots(const T* __restrict__ vb,
                                           const Bilinear4& c, int base,
                                           const float (&g)[2][4], int lane,
                                           float (&dot)[4]) {
  constexpr int SB = FactoredBwdBatch<T, G>::value;  // steps a batch
  // corners a batch: as many as 64 bytes of rows hold, 1 to 4
  constexpr int fit = 64 / (FactoredBwdBatch<T, G>::kRaw * G);
  constexpr int KB = fit < 1 ? 1 : fit > 4 ? 4 : fit;
  using Raw = decltype(load_raw4(vb));
  const int grp = lane / G, sub = lane % G;
#pragma unroll
  for (int k0 = 0; k0 < 4; k0 += KB) {
    float pd[KB][G];
#pragma unroll
    for (int t0 = 0; t0 < G; t0 += SB) {
      int id[KB][SB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const int k = k0 + kk;
        const int tgt = c.idx[k] < 0 ? -1 : base + c.idx[k];
#pragma unroll
        for (int t = 0; t < SB; ++t) {
          id[kk][t] = __shfl_sync(FULL_MASK, tgt, grp * G + t0 + t);
        }
      }
      Raw v[KB][SB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
        for (int t = 0; t < SB; ++t) {  // the batch's loads in flight
          v[kk][t] = id[kk][t] >= 0 ? load_raw4(vb + id[kk][t]) : Raw{};
        }
      }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
        for (int t = 0; t < SB; ++t) {
          pd[kk][t0 + t] = dot4(g[t0 + t < G / 2 ? 0 : 1], v[kk][t]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      group_reduce_scatter<G>(pd[kk], sub);
      dot[k0 + kk] = pd[kk][0];
    }
  }
}

// ------------------------------------------------------------ msda_bwd

// The vector kernel's first pass (design notes 1-3 above): the dots, d loc
// and d attn of every sample, and each in-grid corner's slot pushed onto
// its row's list, row_head[row] (read by msda_bwd_gather_kernel). s_log:
// log2 of the lane slot of an item (S); a warp takes 32 / S items.
template <typename T, int G>
__global__ void __launch_bounds__(kBwdWarps * 32)
msda_bwd_vec_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn,
                    const int* __restrict__ tile_mask,
                    const T* __restrict__ grad_out, int* __restrict__ row_head,
                    int2* __restrict__ links, float* __restrict__ grad_loc,
                    float* __restrict__ grad_attn, int n_items, int V, int H,
                    int Q, int P, int LP, int s_log, int q_tile, int n_tiles,
                    MsdaLevels lv) {
  constexpr int D = 4 * G;
  __shared__ SharedLevels sl;
  stage_levels(sl, lv);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = 1 << s_log;
  const int item0 =
      (blockIdx.x * kBwdWarps + warp) * (32 >> s_log);  // the warp's first
  if (item0 >= n_items) return;  // the same for the whole warp
  const int grp = lane / G, sub = lane % G;
  const int row = H * D;  // elements between value cells

  // the lane's item (the same for the S lanes of its slot)
  const int item = item0 + (lane >> s_log);
  const int bq = item / H, hh = item - bq * H;
  const int b = bq / Q;
  bool on = item < n_items;
  if (on && tile_mask != nullptr) {
    on = __ldg(tile_mask + (int64_t)b * n_tiles + (bq - b * Q) / q_tile) != 0;
  }
  float* glq = grad_loc + (int64_t)item * LP * 2;
  float* gaq = grad_attn + (int64_t)item * LP;
  if (!__any_sync(FULL_MASK, on)) {  // masked tiles or the tail: zeros
    for (int s = lane & (S - 1); item < n_items && s < LP; s += S) {
      glq[2 * s] = 0.f;
      glq[2 * s + 1] = 0.f;
      gaq[s] = 0.f;
    }
    return;
  }
  // the grad_out channels of the group's two halves' items (one item
  // unless S < G); zeros for an item that is masked or past the end
  float g[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int src = grp * G + half * (G / 2);
    const bool src_on = __shfl_sync(FULL_MASK, on, src);
    const int src_item = item0 + (src >> s_log);
    if (src_on) {
      load4(g[half], grad_out + (int64_t)src_item * D + sub * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) g[half][j] = 0.f;
    }
  }
  const int base = b * V * row + hh * D;  // the item's rows: base + cell * row
  const float* lq = loc + (int64_t)item * LP * 2;
  const float* aq = attn + (int64_t)item * LP;

  for (int r0 = 0; r0 < LP; r0 += S) {  // several rounds only when S = 32
    const int s = r0 + (lane & (S - 1));  // the lane's sample
    const bool own = on && s < LP;
    Bilinear4 c = {{-1, -1, -1, -1}, {0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
    float a = 0.f, wl = 0.f, hl = 0.f;
    if (own) {
      const int l = s / P;
      wl = sl.whi[l].x;
      hl = sl.whi[l].y;
      a = __ldg(aq + s);
      c = bilinear_at(sl, l, __ldg(lq + 2 * s), __ldg(lq + 2 * s + 1), row);
    }
    // push each in-grid corner's slot first; store its link (which waits
    // on the exchange) after the dots
    const int slot = (item * LP + s) * 4;
    int prev[4] = {-1, -1, -1, -1};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c.idx[k] >= 0) {
        prev[k] = atomicExch(row_head + (base + c.idx[k]) / D, slot + k);
      }
    }
    float dot[4];
    round_dots<T, G>(value + sub * 4, c, base, g, lane, dot);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c.idx[k] >= 0) {
        links[slot + k] = make_int2(prev[k], __float_as_int(a * c.cw[k]));
      }
    }
    if (own) {
      const SampleGrad sg = sample_grad(c, dot, a, wl, hl);
      glq[2 * s] = sg.lx;
      glq[2 * s + 1] = sg.ly;
      gaq[s] = sg.attn;
    } else if (item < n_items && s < LP) {  // a masked tile's sample
      glq[2 * s] = 0.f;
      glq[2 * s + 1] = 0.f;
      gaq[s] = 0.f;
    }
  }
}

// The second pass: a thread takes C = min(D, 8) channels of a value row
// (D / C threads a row, rows in memory order), walks the row's list of
// corner slots, sums weight x the slot's grad_out channels (item = slot /
// (4 L P)) in f32 and writes them in value's dtype (zeros for a row no
// sample touched).
template <typename T, int G>
__global__ void __launch_bounds__(kGatherThreads)
msda_bwd_gather_kernel(const T* __restrict__ grad_out,
                       const int* __restrict__ row_head,
                       const int2* __restrict__ links,
                       T* __restrict__ grad_value, int64_t n_rows,
                       int slots_per_item) {
  constexpr int D = 4 * G;
  constexpr int C = D < 8 ? D : 8;  // channels a thread
  constexpr int PARTS = D / C;      // threads a row
  const int64_t gid = (int64_t)blockIdx.x * kGatherThreads + threadIdx.x;
  const int64_t r = gid / PARTS;
  const int c0 = (int)(gid % PARTS) * C;
  if (r >= n_rows) return;
  float acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.f;
  for (int s = __ldg(row_head + r); s >= 0;) {
    const int2 e = __ldg(links + s);
    const T* gq = grad_out + (int64_t)(s / slots_per_item) * D + c0;
    float gv[C];
#pragma unroll
    for (int j = 0; j < C; j += 4) load4(gv + j, gq + j);
    const float w = __int_as_float(e.y);
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = fmaf(w, gv[j], acc[j]);
    s = e.x;
  }
#pragma unroll
  for (int j = 0; j < C; j += 4) store4(grad_value + r * D + c0 + j, acc + j);
}

// The general kernel: one warp per item, any D and alignment. kOnePass:
// lane c holds channel c (D <= 32); else the lanes walk the channels in
// chunks of 32.
template <typename T, bool kOnePass>
__global__ void __launch_bounds__(kBwdWarps * 32)
msda_bwd_scalar_kernel(const T* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       const int* __restrict__ tile_mask,
                       const T* __restrict__ grad_out,
                       float* __restrict__ grad_value,
                       float* __restrict__ grad_loc,
                       float* __restrict__ grad_attn, int B, int V, int H,
                       int D, int Q, int P, int LP, int q_tile, int n_tiles,
                       MsdaLevels lv) {
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

// The private plan (design notes above): a block of kPrivateWarps warps
// takes `run` consecutive items of batch element blockIdx.x / blocks_per_b,
// zeroes a private f32 copy of that element's grad_value rows (V * H rows
// of D channels) in shared memory and copies its value rows there too;
// lane s of a warp owns sample s % S of item s / S (S = 2^s_log,
// msda_common.cuh bwd_slot_log2). At the end the block adds its
// nonzero private channels to the f32 scratch grad_value.
constexpr int kPrivateWarps = 8;
// At least 4 blocks an SM (at most 64 registers): left to itself, ptxas
// gave D = 1 instances of this kernel that read value through L1 an
// 8-byte stack frame at 40 registers (H100 build).
constexpr int kPrivateMinBlocks = 4;
// The shared memory a block may take for its private f32 grad_value rows
// and its staged value rows, counted at 4 bytes a channel each in either
// dtype: V * H * D * 8 (two blocks an SM); ops/msda_cuda.py
// PRIVATE_BWD_BYTES holds the same number, and the entry refuses the plan
// beyond it.
constexpr int kPrivateMaxBytes = 96 * 1024;

template <typename T, int D>
__global__ void __launch_bounds__(kPrivateWarps * 32, kPrivateMinBlocks)
msda_bwd_private_kernel(const T* __restrict__ value,
                        const float* __restrict__ loc,
                        const float* __restrict__ attn,
                        const int* __restrict__ tile_mask,
                        const T* __restrict__ grad_out,
                        float* __restrict__ grad_value,
                        float* __restrict__ grad_loc,
                        float* __restrict__ grad_attn, int V, int H, int Q,
                        int P, int LP, int s_log, int run, int blocks_per_b,
                        int q_tile, int n_tiles, MsdaLevels lv) {
  using Raw = typename NarrowRaw<D * sizeof(T)>::type;
  extern __shared__ __align__(16) float private_smem[];
  __shared__ SharedLevels sl;
  const int n_rows = V * H;  // (cell, head) rows of the batch element
  float* gs = private_smem;  // n_rows x D
  Raw* staged = reinterpret_cast<Raw*>(gs + n_rows * D);  // n_rows
  const int b = blockIdx.x / blocks_per_b;
  const int per_b = Q * H;
  const int first = b * per_b + (blockIdx.x - b * blocks_per_b) * run;
  const int last = min(first + run, (b + 1) * per_b);
  const Raw* rows = reinterpret_cast<const Raw*>(value) + (int64_t)b * n_rows;
  for (int i = threadIdx.x; i < n_rows * D; i += blockDim.x) gs[i] = 0.f;
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) {
    staged[i] = __ldg(rows + i);
  }
  stage_levels(sl, lv);  // its barrier also ends the zeroing and staging

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = 1 << s_log, sub = lane & (S - 1);
  const int per_warp = 32 >> s_log;
  const Raw* go = reinterpret_cast<const Raw*>(grad_out);
  // the warp's items: the same bound for all its lanes
  for (int item0 = first + warp * per_warp; item0 < last;
       item0 += kPrivateWarps * per_warp) {
    const int item = item0 + (lane >> s_log);
    const bool live = item < last;
    const int bq = item / H, hh = item - bq * H;
    bool on = live;
    if (on && tile_mask != nullptr) {
      on = __ldg(tile_mask + (int64_t)b * n_tiles + (bq - b * Q) / q_tile) != 0;
    }
    float g[D];
    if (on) {
      unpack_row<T, D>(g, __ldg(go + item));
    } else {
#pragma unroll
      for (int e = 0; e < D; ++e) g[e] = 0.f;
    }
    for (int r0 = 0; r0 < LP; r0 += S) {  // several rounds only when S = 32
      const int s = r0 + sub;
      if (!live || s >= LP) continue;
      const int64_t at = (int64_t)item * LP + s;
      float glx = 0.f, gly = 0.f, ga = 0.f;  // a masked tile's sample: zeros
      if (on) {
        const int l = s / P;
        const float a = __ldg(attn + at);
        // row H: idx = cell * H, the corner's row idx + hh
        const Bilinear4 c =
            bilinear_at(sl, l, __ldg(loc + 2 * at), __ldg(loc + 2 * at + 1), H);
        Raw v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // the four loads in flight
          v[k] = c.idx[k] < 0 ? Raw{} : staged[c.idx[k] + hh];
        }
        // a * cw * g into the private rows, while the loads fly
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c.idx[k] >= 0) {
            const float w = a * c.cw[k];
            float* r = gs + (c.idx[k] + hh) * D;
#pragma unroll
            for (int e = 0; e < D; ++e) atomicAdd(r + e, w * g[e]);
          }
        }
        float dot[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float f[D];
          unpack_row<T, D>(f, v[k]);
          dot[k] = 0.f;
#pragma unroll
          for (int e = 0; e < D; ++e) dot[k] = fmaf(g[e], f[e], dot[k]);
        }
        const SampleGrad sg = sample_grad(c, dot, a, sl.whi[l].x, sl.whi[l].y);
        glx = sg.lx;
        gly = sg.ly;
        ga = sg.attn;
      }
      grad_loc[2 * at] = glx;
      grad_loc[2 * at + 1] = gly;
      grad_attn[at] = ga;
    }
  }
  __syncthreads();
  float* gv = grad_value + (int64_t)b * n_rows * D;
  for (int i = threadIdx.x; i < n_rows * D; i += blockDim.x) {
    const float x = gs[i];
    if (x != 0.f) atomicAdd(gv + i, x);
  }
}

// The plans of msda_bwd (ops/msda_cuda.py BWD_VARIANTS and bwd_plan).
constexpr int kPlanGeneral = 0, kPlanGather = 1, kPlanPrivate = 2;

// The private plan at head width D (1 or 2).
template <typename T, int D>
static cudaError_t launch_private(cudaStream_t s, const void* value,
                                  const float* loc, const float* attn,
                                  const int* tile_mask, const void* grad_out,
                                  float* grad_value_f32, float* grad_loc,
                                  float* grad_attn, int B, int V, int H, int Q,
                                  int P, int LP, int q_tile, int n_tiles,
                                  const MsdaLevels& lv) {
  using Raw = typename NarrowRaw<D * sizeof(T)>::type;
  const int s_log = bwd_slot_log2(LP);
  const int smem = V * H * (D * 4 + (int)sizeof(Raw));  // f32 rows, value rows
  auto kernel = &msda_bwd_private_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  NarrowRuns r;
  e = narrow_runs((const void*)kernel, kPrivateWarps * 32, smem, Q * H, B,
                  kPrivateWarps * (32 >> s_log), &r);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)((int64_t)r.blocks_per_b * B), kPrivateWarps * 32, smem,
           s>>>((const T*)value, loc, attn, tile_mask, (const T*)grad_out,
                grad_value_f32, grad_loc, grad_attn, V, H, Q, P, LP, s_log,
                r.run, r.blocks_per_b, q_tile, n_tiles, lv);
  return cudaSuccess;
}

template <typename T, int G>
static void launch_gather(cudaStream_t s, const void* value, const float* loc,
                          const float* attn, const int* tile_mask,
                          const void* grad_out, void* grad_value,
                          int* row_head, int2* links, float* grad_loc,
                          float* grad_attn, int B, int V, int H, int Q, int P,
                          int LP, int q_tile, int n_tiles,
                          const MsdaLevels& lv) {
  const int s_log = bwd_slot_log2(LP);
  const int n_items = B * Q * H;
  const int per_block = kBwdWarps * (32 >> s_log);
  msda_bwd_vec_kernel<T, G>
      <<<(unsigned)((n_items + per_block - 1) / per_block), kBwdWarps * 32, 0,
         s>>>((const T*)value, loc, attn, tile_mask, (const T*)grad_out,
              row_head, links, grad_loc, grad_attn, n_items, V, H, Q, P, LP,
              s_log, q_tile, n_tiles, lv);
  const int64_t n_rows = (int64_t)B * V * H;
  const int64_t threads = n_rows * (G > 2 ? G / 2 : 1);  // D / min(D, 8) a row
  msda_bwd_gather_kernel<T, G>
      <<<(unsigned)((threads + kGatherThreads - 1) / kGatherThreads),
         kGatherThreads, 0, s>>>((const T*)grad_out, row_head, links,
                                 (T*)grad_value, n_rows, 4 * LP);
}

template <typename T>
static cudaError_t launch_bwd(cudaStream_t s, int plan, const void* value,
                              const float* loc, const float* attn,
                              const int* tile_mask, const void* grad_out,
                              float* grad_value_f32, void* grad_value,
                              int* row_head, int2* links, float* grad_loc,
                              float* grad_attn, int B, int V, int H, int D,
                              int Q, int P, int LP, int q_tile, int n_tiles,
                              const MsdaLevels& lv) {
  if (plan == kPlanPrivate) {
#define MSDA_BWD_PRIVATE(D_)                                                  \
  launch_private<T, D_>(s, value, loc, attn, tile_mask, grad_out,             \
                        grad_value_f32, grad_loc, grad_attn, B, V, H, Q, P,   \
                        LP, q_tile, n_tiles, lv)
    return D == 1 ? MSDA_BWD_PRIVATE(1) : MSDA_BWD_PRIVATE(2);
#undef MSDA_BWD_PRIVATE
  }
  if (plan == kPlanGeneral) {
    const unsigned grid =
        (unsigned)(((int64_t)B * Q * H + kBwdWarps - 1) / kBwdWarps);
    if (D <= 32) {
      msda_bwd_scalar_kernel<T, true><<<grid, kBwdWarps * 32, 0, s>>>(
          (const T*)value, loc, attn, tile_mask, (const T*)grad_out,
          grad_value_f32, grad_loc, grad_attn, B, V, H, D, Q, P, LP, q_tile,
          n_tiles, lv);
    } else {
      msda_bwd_scalar_kernel<T, false><<<grid, kBwdWarps * 32, 0, s>>>(
          (const T*)value, loc, attn, tile_mask, (const T*)grad_out,
          grad_value_f32, grad_loc, grad_attn, B, V, H, D, Q, P, LP, q_tile,
          n_tiles, lv);
    }
    return cudaSuccess;
  }
#define MSDA_BWD_GATHER(G_)                                                   \
  launch_gather<T, G_>(s, value, loc, attn, tile_mask, grad_out, grad_value,  \
                       row_head, links, grad_loc, grad_attn, B, V, H, Q, P,   \
                       LP, q_tile, n_tiles, lv)
  switch (D / 4) {
    case 8: MSDA_BWD_GATHER(8); break;
    case 4: MSDA_BWD_GATHER(4); break;
    case 2: MSDA_BWD_GATHER(2); break;
    default: MSDA_BWD_GATHER(1); break;
  }
#undef MSDA_BWD_GATHER
  return cudaSuccess;
}

// Returns 0 on success, else a cudaError_t code. shapes points to 2 * L host
// ints (h0, w0, h1, w1, ...); tile_mask may be null; dtype 0 = f32, 1 =
// bf16. plan (ops/msda_cuda.py bwd_plan): 1 "gather" (D = 4, 8, 16 or 32,
// value and grad_out aligned to 4 channels, B * V * H * D and the
// B * Q * H * L * P * 4 corner slots below 2^31), 2 "private" (D = 1 or 2,
// value and grad_out aligned to a row of D channels, a batch element's
// f32 grad_value and value rows, V * H * D * 8 bytes, within
// kPrivateMaxBytes), 0 "general"; a
// plan the inputs do not allow is refused. grad_value_f32 is the general
// and private plans' f32 scratch of value's shape (zero-filled here;
// grad_value itself for f32 value), null for gather; row_head (B V H ints,
// set to -1 here) and slot_links (B Q H L P 4 int pairs) are the gather
// plan's lists, null for the others. *variant is set to the plan that
// ran.
extern "C" int msda_bwd(const void* value, int dtype, const float* loc,
                        const float* attn, const int* tile_mask,
                        const void* grad_out, float* grad_value_f32,
                        void* grad_value, float* grad_loc, float* grad_attn,
                        int* row_head, int* slot_links, int B, int V, int H,
                        int D, int Q, int L, int P, const int* shapes,
                        int q_tile, int plan, void* stream, int* variant) {
  MsdaLevels lv;
  if (q_tile < 1 || D < 1 || P < 1 || (int64_t)V * H * D > INT32_MAX ||
      (int64_t)B * Q * H > INT32_MAX - 32 * kBwdWarps ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = fill_levels(&lv, L, shapes, V);
  if (err != 0) return err;
  const int LP = L * P;
  const int64_t n_value = (int64_t)B * V * H * D;
  if (plan == kPlanGather) {
    const size_t align = 4 * (dtype == 0 ? sizeof(float) : sizeof(uint16_t));
    const bool ok =
        (D == 4 || D == 8 || D == 16 || D == 32) &&
        (((uintptr_t)value | (uintptr_t)grad_out) % align) == 0 &&
        n_value <= INT32_MAX && (int64_t)B * Q * H * LP * 4 <= INT32_MAX &&
        row_head != nullptr && slot_links != nullptr;
    if (!ok) return (int)cudaErrorInvalidValue;
  } else if (plan == kPlanPrivate) {
    const size_t align = D * (dtype == 0 ? sizeof(float) : sizeof(uint16_t));
    const bool ok =
        (D == 1 || D == 2) &&
        (((uintptr_t)value | (uintptr_t)grad_out) % align) == 0 &&
        (int64_t)V * H * D * 8 <= kPrivateMaxBytes && grad_value_f32 != nullptr;
    if (!ok) return (int)cudaErrorInvalidValue;
  } else if (plan != kPlanGeneral || grad_value_f32 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (plan == kPlanGather) {
    const int64_t n_rows = (int64_t)B * V * H;
    if (n_rows > 0) {
      const cudaError_t e =
          cudaMemsetAsync(row_head, 0xff, n_rows * sizeof(int), s);
      if (e != cudaSuccess) return (int)e;
    }
  } else if (n_value > 0) {
    const cudaError_t e =
        cudaMemsetAsync(grad_value_f32, 0, n_value * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_tiles = (Q + q_tile - 1) / q_tile;
  if ((int64_t)B * Q * H > 0) {
    int2* links = reinterpret_cast<int2*>(slot_links);
    const cudaError_t e =
        dtype == 0
            ? launch_bwd<float>(s, plan, value, loc, attn, tile_mask, grad_out,
                                grad_value_f32, grad_value, row_head, links,
                                grad_loc, grad_attn, B, V, H, D, Q, P, LP,
                                q_tile, n_tiles, lv)
            : launch_bwd<__nv_bfloat16>(s, plan, value, loc, attn, tile_mask,
                                        grad_out, grad_value_f32, grad_value,
                                        row_head, links, grad_loc, grad_attn,
                                        B, V, H, D, Q, P, LP, q_tile, n_tiles,
                                        lv);
    if (e != cudaSuccess) return (int)e;
    *variant = plan;
  } else if (plan == kPlanGather && n_value > 0) {
    // no item: every row is zero
    const cudaError_t e = cudaMemsetAsync(
        grad_value, 0, n_value * (dtype == 0 ? 4 : 2), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (plan != kPlanGather && dtype == 1 && n_value > 0) {
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
// What bounds it on the H100. As a function, bytes: ~0.12 ms a call at the
// base SCA shape (6 cameras x 40,000 queries over 4 levels, H = 8, D = 32,
// L * P = 32, 476 of 1,878 (camera, tile) pairs active; grad_out of the
// active tiles, off, attn and ref read once, the touched value rows read
// once, the four gradients written once). The work is 128 corner rows of
// D channels per active (camera, query, head): ~62M rows a call, each read
// (a dot product with g) and added to (a * cw * g into an f32 scratch),
// ~2.0e9 f32 adds. Measured on the H100 (PERF.md §6):
//   - The first design (one warp per (query, head), each row's load used at
//     once, four shuffles a row, every add a 16-byte global atomic) ran
//     2.50 ms, and without any add still 2.12 ms: bound by load latency,
//     one row in flight per warp.
//   - Batching the loads and reduce-scattering the dots (below) brought
//     the same kernel without adds to 1.19 ms; with them it stayed at
//     2.51 ms: the ~5e8 16-byte atomics (~2.5e8 L2 sectors) then set the
//     pace, about one sector per L2 slice per clock.
//   - An f32 atomicAdd to shared memory is a compare-and-swap loop on sm_90
//     (ATOMS.CAST.SPIN), so rows summed in shared memory that way cost more
//     than the global atomics they save; an integer shared atomic is
//     native. Hence the counting sort below.
//
// Design of the vector variant (D = 4 G, G = 1, 2, 4 or 8, value and
// grad_out aligned to 4 channels; msda_bwd_factored_priv_kernel; 1.87 ms
// bf16 at the base shape where the first design ran 2.49, and 1.34 ms at
// D = 16 where it ran 1.67, PERF.md §6):
//   1. Rows of a (camera, query, head): G lanes hold one corner row, 4
//      channels each (16-byte f32 or 8-byte bf16 loads, kept raw while in
//      flight), so one warp instruction serves 32 / G rows. For each corner
//      the warp takes the G steps' rows from their owner lanes, issues a
//      batch of loads (64 bytes a lane) before it uses any and the global
//      adds (which do not depend on the loads) while they fly, then forms
//      the partial dot products and reduces them across the group by a
//      recursive-halving reduce-scatter (G - 1 shuffles for G rows, where a
//      reduction per row took 3 each at G = 8); one shuffle then hands
//      every owner lane its dot (factored_round_grads).
//   2. Private levels: the wrapper picks the longest run of levels, from
//      the last, whose block fits its shared budget (levels 2-3 at the base
//      shape: 479 rows that take 866 and 3,123 adds each per (camera, head)
//      over the call). A block of 8 warps owns a run of 128 queries of one
//      head and walks the cameras; per camera the owner lane of a private
//      sample records each corner's row and weight in a fixed slot and
//      counts it into its row with an integer shared atomic, warp 0 scans
//      the counts, the slots are placed in a row-sorted list, and the block
//      sums each row's slots (weight x the query's g, staged in shared
//      memory) in equal pieces of the list a lane group, adding a row's D
//      channels to the scratch with 16-byte atomics: the rows' adds become
//      about one per block and camera. The other levels keep 16-byte
//      global atomics. The barriers between a block's phases cost: without
//      any add the block runs 1.45 ms where a warp per (query, head) ran
//      1.19 (bf16), and the sort and the row sums cost ~0.3 ms (PERF.md §6).
//   3. d off and d attn: the same lane owns the same (query, head, sample)
//      on every camera, so it stores the first active camera's gradient and
//      adds each later camera's to it in place (no atomics, the same result
//      every run); queries active on no camera get zeros.
//   4. When no level fits the budget the same kernel runs with no private
//      level: every add a global atomic. No FPN pyramid of the configs gets
//      there (its coarsest level always fits); a single 60 x 100 level at
//      the base size runs 1.38 ms bf16 where the first design ran 1.10,
//      since a round serves 32 samples of a (query, head) and L * P = 8
//      fills a quarter of it.
//   5. Two blocks an SM (the shared budget's aim) in __launch_bounds__:
//      without the minimum ptxas gave the bf16 G = 2 and 4 instances a
//      stack frame; with it every instance builds without one at the same
//      speed.
// d ref, when asked for, takes f32 atomicAdds (a (camera, query, point)
// sums over heads and levels); the model's reference points are camera
// geometry and need none.
// General variant (msda_bwd_factored_scalar_kernel; any D or alignment):
// one warp per (bs, query, head), the lanes walking the channels of each
// (sample, corner) one at a time as msda_bwd's general kernel, every add a
// global atomic, d off and d attn summed over the cameras in registers.

// The shared memory a privatizing block may take (two blocks an SM) and the
// queries it takes. ops/msda_cuda.py factored_bwd_plan picks the private
// levels within the same budget (FACTORED_BWD_PRIVATE_BYTES,
// FACTORED_BWD_RUN); the entry refuses a plan beyond it.
constexpr int kPrivMaxBytes = 100 * 1024;
constexpr int kPrivRun = 128;
constexpr int kPrivWarps = 8;  // warps per block of the privatizing kernel

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

// One round of one (camera, query, head) in the vector variant: lane s owns
// the sample whose corners are c (row 1: cells, -1 outside the grid), weight
// a and level f = (w, h, 1 / w, 1 / h). For each corner the warp takes the
// G steps' rows from their owner lanes in batches, issues a batch's loads
// before it uses any and its grad_value adds (which do not depend on the
// loads) while they fly, then reduce-scatters the G partial dot products
// and hands each owner lane its dot. A sample with priv set adds nothing
// here (its block sums its rows, see msda_bwd_factored_priv_kernel).
// Returns the lane's d off (x, y) and d attn for this camera (zeros for a
// lane that owns no sample); adds d ref to gref unless it is null.
template <typename T, int G>
__device__ __forceinline__ float3 factored_round_grads(
    const T* __restrict__ vb, float* __restrict__ gvb, int pstart, int row,
    const Bilinear4& c, bool priv, float a, float4 f, bool own,
    const float (&g)[4], int lane, float* gref) {
  constexpr int ROWS = 32 / G;  // corner rows per warp instruction
  constexpr int BATCH = FactoredBwdBatch<T, G>::value;
  using Raw = decltype(load_raw4(vb));
  const int grp = lane / G, sub = lane % G;
  float dot[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // corner
    // this lane's target for corner k: a global cell (>= 0), the private
    // row -2 - tgt (<= -2), or nothing (-1)
    const int tgt = c.idx[k] < 0 ? -1
                    : priv       ? pstart - 2 - c.idx[k]
                                 : c.idx[k];
    const float wk = a * c.cw[k];
    float pd[G];
#pragma unroll
    for (int t0 = 0; t0 < G; t0 += BATCH) {
      int id[BATCH];
      float wv[BATCH];
#pragma unroll
      for (int t = 0; t < BATCH; ++t) {  // the group's row of step t0 + t
        const int src = (t0 + t) * ROWS + grp;
        id[t] = __shfl_sync(FULL_MASK, tgt, src);
        wv[t] = __shfl_sync(FULL_MASK, wk, src);
      }
      Raw v[BATCH];
#pragma unroll
      for (int t = 0; t < BATCH; ++t) {  // the batch's loads in flight
        const int cell = id[t] >= 0 ? id[t] : pstart - 2 - id[t];
        v[t] = id[t] != -1 ? load_raw4(vb + (int64_t)cell * row) : Raw{};
      }
#pragma unroll
      for (int t = 0; t < BATCH; ++t) {  // the adds, while the loads fly
        if (id[t] >= 0) {
          // the G lanes' 16-byte adds cover the row's D f32
          atomicAdd(reinterpret_cast<float4*>(gvb + (int64_t)id[t] * row),
                    make_float4(wv[t] * g[0], wv[t] * g[1], wv[t] * g[2],
                                wv[t] * g[3]));
        }
      }
#pragma unroll
      for (int t = 0; t < BATCH; ++t) pd[t0 + t] = dot4(g, v[t]);
    }
    group_reduce_scatter<G>(pd, sub);
    // lane grp' * G + t holds step t's dot of group grp'; its owner is lane
    // t * ROWS + grp'
    dot[k] = __shfl_sync(FULL_MASK, pd[0], (lane % ROWS) * G + lane / ROWS);
  }
  float3 out = make_float3(0.f, 0.f, 0.f);
  if (own) {
    const SampleGrad sg = sample_grad(c, dot, a, f.x, f.y);
    if (gref != nullptr) {
      atomicAdd(gref, sg.lx);
      atomicAdd(gref + 1, sg.ly);
    }
    out = make_float3(sg.lx * f.z, sg.ly * f.w, sg.attn);
  }
  return out;
}

// The shared memory of msda_bwd_factored_priv_kernel for a run of `run`
// queries, `sp` private samples a query and `keys` private rows a head:
// the run's grad_out rows (f32), each private corner's weight, row key and
// place in the row-sorted list, and each row's count, start and cursor
// (ops/msda_cuda.py factored_bwd_plan mirrors it).
__host__ __device__ __forceinline__ int64_t factored_priv_smem(int run, int D,
                                                               int sp,
                                                               int keys) {
  const int64_t slots = (int64_t)run * sp * 4;
  return (int64_t)run * D * 4 + slots * (4 + 2 + 2) + ((int64_t)3 * keys + 1) * 4;
}

// The vector variant (design notes 2-4 above): a block of kPrivWarps warps
// owns a run of queries of one head and walks the cameras in turn,
// skipping a camera none of whose tiles in the run is active. For each
// camera:
//   A. its warps take the run's queries one at a time
//      (factored_round_grads: the dots of every sample, the adds of the
//      samples before the private levels); the owner lane of a private
//      sample records each corner's row key (-1 outside the grid) and
//      weight a * cw in the corner's fixed slot and counts it into its row;
//      the lanes stage g in shared memory;
//   B. warp 0 turns the counts into row starts (an exclusive scan) and
//      every counted slot takes its place in the row-sorted list;
//   C. the 8-lane groups cut the row-sorted list into equal pieces and
//      sum each row's slots (weight x the slot's staged g), adding a row's
//      sum to the scratch when it ends (a row split between two pieces
//      takes two adds).
template <typename T, int G>
__global__ void __launch_bounds__(kPrivWarps * 32, 2)
msda_bwd_factored_priv_kernel(const T* __restrict__ value,
                              const float* __restrict__ ref,
                              const float* __restrict__ off,
                              const float* __restrict__ attn,
                              const int* __restrict__ tile_mask,
                              const T* __restrict__ grad_out,
                              float* __restrict__ grad_value,
                              float* __restrict__ grad_ref,
                              float* __restrict__ grad_off,
                              float* __restrict__ grad_attn, int N, int V,
                              int H, int Q, int P, int LP, int q_tile,
                              int n_tiles, int run, int pstart, int pfirst,
                              MsdaLevels lv) {
  constexpr int D = 4 * G;
  constexpr int ROWS = 32 / G;  // lane groups of a warp
  extern __shared__ __align__(16) float smem_f[];
  __shared__ SharedLevels sl;
  const int sp = LP - pfirst;       // private samples a query
  const int keys = V - pstart;      // private rows a head
  const int slots = run * sp * 4;   // a corner each
  float* g_s = smem_f;                           // run x D
  float* w_s = g_s + run * D;                    // slots
  int* start = reinterpret_cast<int*>(w_s + slots);  // keys + 1
  int* cursor = start + keys + 1;                // keys
  int* count = cursor + keys;                    // keys
  short* key_s = reinterpret_cast<short*>(count + keys);        // slots
  unsigned short* list = reinterpret_cast<unsigned short*>(key_s + slots);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / G, sub = lane % G;
  const int hh = blockIdx.x % H;
  const int runs = (Q + run - 1) / run;
  const int rb = blockIdx.x / H;
  const int bs = rb / runs;
  const int q0 = (rb - bs * runs) * run, q1 = min(Q, q0 + run);
  const int row = H * D;  // elements between value cells
  stage_levels(sl, lv);   // ends in __syncthreads
  const int t0 = q0 / q_tile, t1 = (q1 - 1) / q_tile;  // the run's tiles
  // slot / (sp * 4), the slot's query, as __umulhi(slot, magic): exact for
  // slot * sp * 4 < 2^32 (slots < 2^16)
  const unsigned magic = sp > 0 ? 0xffffffffu / (unsigned)(sp * 4) + 1u : 0u;

  for (int n = 0; n < N; ++n) {
    const int b = bs * N + n;
    int act = tile_mask == nullptr;
    for (int t = t0 + tid; !act && t <= t1; t += blockDim.x) {
      act = __ldg(tile_mask + (int64_t)b * n_tiles + t) != 0;
    }
    if (!__syncthreads_or(act)) continue;  // the same for the whole block
    for (int i = tid; i < keys; i += blockDim.x) count[i] = 0;
    __syncthreads();
    // A
    const int64_t vo = (int64_t)b * V * row + hh * D + sub * 4;
    for (int ql = warp; ql < run; ql += kPrivWarps) {
      const int q = q0 + ql;
      // the same for the whole warp
      bool on = q < q1, seen = n > 0;
      const int tile = q / q_tile;
      if (on && tile_mask != nullptr) {
        on = __ldg(tile_mask + (int64_t)b * n_tiles + tile) != 0;
        seen = false;
        for (int n2 = 0; n2 < n; ++n2) {
          seen |= __ldg(tile_mask + (int64_t)(bs * N + n2) * n_tiles + tile) != 0;
        }
      }
      if (!on) {  // its slots count nothing
        for (int e = lane; e < sp * 4; e += 32) key_s[ql * sp * 4 + e] = -1;
        continue;
      }
      const int64_t item = ((int64_t)bs * Q + q) * H + hh;
      const int64_t bq = (int64_t)b * Q + q;
      const float* oq = off + item * LP * 2;
      const float* aq = attn + item * LP;
      float g[4];
      load4(g, grad_out + bq * row + hh * D + sub * 4);
      if (grp == 0) {
        *reinterpret_cast<float4*>(g_s + ql * D + sub * 4) =
            make_float4(g[0], g[1], g[2], g[3]);
      }
      for (int r0 = 0; r0 < LP; r0 += 32) {
        const int i = r0 + lane;  // the lane's sample
        const bool own = i < LP;
        const int l = own ? i / P : 0, p = own ? i - l * P : 0;
        const float a = own ? __ldg(aq + i) : 0.f;
        Bilinear4 c = {{-1, -1, -1, -1}, {0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
        if (own) {
          const float2 xy = factored_loc(
              sl, l, __ldg(ref + bq * P * 2 + 2 * p),
              __ldg(ref + bq * P * 2 + 2 * p + 1), __ldg(oq + 2 * i),
              __ldg(oq + 2 * i + 1));
          c = bilinear_at(sl, l, xy.x, xy.y, 1);
        }
        const bool priv = own && i >= pfirst;
        if (priv) {
          const int base = (ql * sp + i - pfirst) * 4;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int key = c.idx[k] < 0 ? -1 : c.idx[k] - pstart;
            key_s[base + k] = (short)key;
            w_s[base + k] = a * c.cw[k];
            if (key >= 0) atomicAdd(count + key, 1);
          }
        }
        const float3 d = factored_round_grads<T, G>(
            value + vo, grad_value + vo, pstart, row, c, priv, a, sl.whi[l],
            own, g, lane,
            grad_ref != nullptr && own ? grad_ref + bq * P * 2 + 2 * p
                                       : nullptr);
        if (own) {
          float* go = grad_off + item * LP * 2 + 2 * i;
          float* gat = grad_attn + item * LP + i;
          float gx = d.x, gy = d.y, gz = d.z;
          if (seen) {
            gx += go[0];
            gy += go[1];
            gz += *gat;
          }
          go[0] = gx;
          go[1] = gy;
          *gat = gz;
        }
      }
    }
    __syncthreads();
    // B: exclusive scan of the counts by warp 0, a run of rows a lane
    if (tid < 32) {
      const int per = (keys + 31) / 32, k0 = lane * per;
      const int k1 = min(keys, k0 + per);
      int sum = 0;
      for (int k = k0; k < k1; ++k) sum += count[k];
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += y;
      }
      int at = incl - sum;
      for (int k = k0; k < k1; ++k) {
        start[k] = at;
        cursor[k] = at;
        at += count[k];
      }
      if (lane == 31) start[keys] = incl;
    }
    __syncthreads();
    for (int e = tid; e < slots; e += blockDim.x) {
      const int key = key_s[e];
      if (key >= 0) list[atomicAdd(cursor + key, 1)] = (unsigned short)e;
    }
    __syncthreads();
    // C: the row-sorted list cut into one equal piece per 8-lane group (lane
    // sub: 4 channels); a group walks its piece, summing in registers, and
    // adds the sum to the scratch whenever the row changes and at its end
    float* gv = grad_value + ((int64_t)b * V + pstart) * row + hh * D;
    const float4* g4 = reinterpret_cast<const float4*>(g_s);
    const int n_groups = kPrivWarps * ROWS;
    const int total = start[keys];
    const int piece = (total + n_groups - 1) / n_groups;
    const int e0 = (warp * ROWS + grp) * piece;
    const int e1 = min(total, e0 + piece);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int cur = -1;
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      const unsigned slot = list[e];
      const int key = key_s[slot];
      if (key != cur) {  // the same for the group's lanes
        if (cur >= 0) {
          atomicAdd(reinterpret_cast<float4*>(gv + (int64_t)cur * row + sub * 4),
                    acc);
        }
        acc = make_float4(0.f, 0.f, 0.f, 0.f);
        cur = key;
      }
      const float w = w_s[slot];
      const float4 gq = g4[__umulhi(slot, magic) * G + sub];
      acc.x = fmaf(w, gq.x, acc.x);
      acc.y = fmaf(w, gq.y, acc.y);
      acc.z = fmaf(w, gq.z, acc.z);
      acc.w = fmaf(w, gq.w, acc.w);
    }
    if (cur >= 0) {
      atomicAdd(reinterpret_cast<float4*>(gv + (int64_t)cur * row + sub * 4),
                acc);
    }
    __syncthreads();
  }
  if (tile_mask != nullptr) {
    // queries active on no camera: zero d off and d attn
    for (int q = q0 + warp; q < q1; q += kPrivWarps) {
      const int tile = q / q_tile;
      bool any = false;
      for (int n = 0; n < N; ++n) {
        any |= __ldg(tile_mask + (int64_t)(bs * N + n) * n_tiles + tile) != 0;
      }
      if (any) continue;
      const int64_t item = ((int64_t)bs * Q + q) * H + hh;
      for (int i = lane; i < LP; i += 32) {
        grad_off[item * LP * 2 + 2 * i] = 0.f;
        grad_off[item * LP * 2 + 2 * i + 1] = 0.f;
        grad_attn[item * LP + i] = 0.f;
      }
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

template <typename T, int G>
static int launch_priv(cudaStream_t s, unsigned grid, int smem,
                       const void* value, const float* ref, const float* off,
                       const float* attn, const int* tile_mask,
                       const void* grad_out, float* grad_value,
                       float* grad_ref, float* grad_off, float* grad_attn,
                       int N, int V, int H, int Q, int P, int LP, int q_tile,
                       int n_tiles, int run, int pstart, int pfirst,
                       const MsdaLevels& lv) {
  auto kernel = msda_bwd_factored_priv_kernel<T, G>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  kernel<<<grid, kPrivWarps * 32, smem, s>>>(
      (const T*)value, ref, off, attn, tile_mask, (const T*)grad_out,
      grad_value, grad_ref, grad_off, grad_attn, N, V, H, Q, P, LP, q_tile,
      n_tiles, run, pstart, pfirst, lv);
  return pstart < V ? 2 : 1;
}

// The vector variant when D = 4 * G with G in {1, 2, 4, 8} (D = 4 .. 32)
// and value and grad_out are aligned to 4 channels (16 bytes in f32, 8 in
// bf16), else the general one. Returns 2 when the vector variant ran with
// private levels, 1 when it ran without, 0 for the general one; a negative
// cudaError_t code when the launch was refused before it ran.
template <typename T>
static int launch_bwd_factored(cudaStream_t s, const void* value,
                               const float* ref, const float* off,
                               const float* attn, const int* tile_mask,
                               const void* grad_out, float* grad_value,
                               float* grad_ref, float* grad_off,
                               float* grad_attn, int Bs, int N, int V, int H,
                               int D, int Q, int P, int LP, int q_tile,
                               int n_tiles, int run, int pstart, int pfirst,
                               const MsdaLevels& lv) {
  const bool aligned =
      (((uintptr_t)value | (uintptr_t)grad_out) % (4 * sizeof(T))) == 0 &&
      D % 4 == 0;
  const int G = aligned ? D / 4 : 0;
  const int smem = (int)factored_priv_smem(run, D, LP - pfirst, V - pstart);
  const unsigned grid = (unsigned)((int64_t)Bs * ((Q + run - 1) / run) * H);
#define MSDA_BWD_PRIV(G_)                                                    \
  launch_priv<T, G_>(s, grid, smem, value, ref, off, attn, tile_mask,        \
                     grad_out, grad_value, grad_ref, grad_off, grad_attn, N, \
                     V, H, Q, P, LP, q_tile, n_tiles, run, pstart, pfirst, lv)
  switch (G) {
    case 8: return MSDA_BWD_PRIV(8);
    case 4: return MSDA_BWD_PRIV(4);
    case 2: return MSDA_BWD_PRIV(2);
    case 1: return MSDA_BWD_PRIV(1);
    default: break;
  }
#undef MSDA_BWD_PRIV
  const unsigned warps_grid =
      (unsigned)(((int64_t)Bs * Q * H + kBwdWarps - 1) / kBwdWarps);
  msda_bwd_factored_scalar_kernel<T><<<warps_grid, kBwdWarps * 32, 0, s>>>(
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
// (like off and attn, f32). private_from is the first of the levels whose
// grad_value rows the vector variant sums in shared memory (L for none;
// they run to the last level), within kPrivMaxBytes at kPrivRun queries a
// block.
// *variant is set to 2 when the vector variant ran with private levels, 1
// when it ran without, 0 when the general one ran.
extern "C" int msda_bwd_factored(const void* value, int dtype,
                                 const float* ref, const float* off,
                                 const float* attn, const int* tile_mask,
                                 const void* grad_out, float* grad_value_f32,
                                 void* grad_value, float* grad_ref,
                                 float* grad_off, float* grad_attn, int B,
                                 int N, int V, int H, int D, int Q, int L,
                                 int P, const int* shapes, int q_tile,
                                 int private_from, void* stream,
                                 int* variant) {
  MsdaLevels lv;
  constexpr int run = kPrivRun;
  if (q_tile < 1 || D < 1 || P < 1 || N < 1 || B % N != 0 ||
      (int64_t)V * H * D > INT32_MAX ||
      (int64_t)B * Q * H > INT32_MAX - kBwdWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = fill_levels(&lv, L, shapes, V);
  if (err != 0) return err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (private_from < 0 || private_from > L) return (int)cudaErrorInvalidValue;
  const int pstart = private_from < L ? lv.start[private_from] : V;
  const int pfirst = private_from * P;  // first private sample of a head
  if (pstart < V &&
      (factored_priv_smem(run, D, L * P - pfirst, V - pstart) > kPrivMaxBytes ||
       (int64_t)run * (L * P - pfirst) * 4 > 65536 || V - pstart > 32767)) {
    return (int)cudaErrorInvalidValue;
  }
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
  if ((int64_t)Bs * Q * H > 0) {
    const int n_tiles = (Q + q_tile - 1) / q_tile;
    const int ran =
        dtype == 0
            ? launch_bwd_factored<float>(
                  s, value, ref, off, attn, tile_mask, grad_out,
                  grad_value_f32, grad_ref, grad_off, grad_attn, Bs, N, V, H,
                  D, Q, P, L * P, q_tile, n_tiles, run, pstart, pfirst, lv)
            : launch_bwd_factored<__nv_bfloat16>(
                  s, value, ref, off, attn, tile_mask, grad_out,
                  grad_value_f32, grad_ref, grad_off, grad_attn, Bs, N, V, H,
                  D, Q, P, L * P, q_tile, n_tiles, run, pstart, pfirst, lv);
    if (ran < 0) return -ran;
    *variant = ran;
  }
  if (dtype == 1 && n_value > 0) {
    const int64_t blocks = (n_value + 255) / 256;
    cast_bf16_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
                       s>>>(grad_value_f32, (__nv_bfloat16*)grad_value,
                            n_value);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- local entry

// The shared memory of msda_bwd_local_kernel, in bytes, and where its
// parts start: the halo's value rows and a row of zeros, the tile's
// grad_out rows (f32), each corner's weight (slots), then one region that
// holds the warps' rounds of samples (corner codes, then dot products; 16
// bytes a sample) in phase A and the row-sorted list (2 bytes a slot)
// after it, two buffers of the rounds' locations and weights (12 bytes a
// sample), each halo row's start (one more) and cursor, and each slot's
// halo row key (ops/msda_cuda.py local_bwd_smem mirrors it).
struct LocalBwdSmem {
  int64_t scratch, xy, a, start, cursor, key, total;
};

__host__ __device__ __forceinline__ LocalBwdSmem local_bwd_layout(int D, int P,
                                                                 int lanes) {
  constexpr int NH = (kLocalBwdTileY + 2 * kLocalHalo) *
                     (kLocalBwdTileX + 2 * kLocalHalo);
  constexpr int NQ = kLocalBwdTileY * kLocalBwdTileX;
  const int64_t slots = (int64_t)NQ * P * 4;
  const int64_t all = (int64_t)(kLocalThreads / 32) * (32 / lanes) * P;
  const int64_t region = ((slots * 2 > all * 16 ? slots * 2 : all * 16) + 15) / 16 * 16;
  LocalBwdSmem m;
  m.scratch = ((int64_t)NH + 1 + NQ) * D * 4 + slots * 4;
  m.xy = m.scratch + region;
  m.a = m.xy + 2 * all * 8;
  m.start = m.a + 2 * all * 4;
  m.cursor = m.start + ((int64_t)NH + 1) * 4;
  m.key = m.cursor + (int64_t)NH * 4;
  m.total = m.key + slots * 2;
  return m;
}

// The tile-local backward (design notes in the header): a block stages its
// tile's halo; each warp takes 32 / G queries at a time, in three phases:
//   A. the lanes form the corners of the round's samples, a lane a sample
//      (codes into the warp's scratch, weights a * cw into their slots);
//      then G lanes take a query, 4 channels a lane, with its grad_out row
//      (kept for phase C), and for each sample read its four corner rows
//      (the halo's, global memory's outside it), reduce-scatter the four
//      partial dot products over the group into the scratch, add a corner
//      outside the halo to grad_value by 16-byte global atomics at once,
//      and record a corner in the halo (its halo row key in its slot, one
//      integer shared atomic into its row's count); corners of weight
//      exactly 0 add and record nothing. Last, a lane a sample again: d loc
//      and d attn (sample_grad) from the sample's four dots, stored
//      coalesced.
//   B. warp 0 turns the counts into row starts (an exclusive scan) and
//      every recorded slot takes its place in the row-sorted list;
//   C. the lane groups cut the list into equal pieces and walk each a
//      halo row at a time, summing the row's slots (weight x the slot
//      query's staged grad_out row) in registers and adding the sum to
//      grad_value by 16-byte global atomics (a row split between two
//      pieces takes two adds; the halos of neighbouring tiles overlap).
template <int D>
__global__ void __launch_bounds__(kLocalThreads)
msda_bwd_local_kernel(const float* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn,
                      const float* __restrict__ grad_out,
                      float* __restrict__ grad_value,
                      float* __restrict__ grad_loc,
                      float* __restrict__ grad_attn, int h, int w, int H,
                      int P, int tiles_y, int tiles_x) {
  constexpr int G = local_lanes(D);
  constexpr int TY = kLocalBwdTileY, TX = kLocalBwdTileX, NQ = TY * TX;
  constexpr int NH = (TY + 2 * kLocalHalo) * (TX + 2 * kLocalHalo);
  constexpr int QW = 32 / G;  // queries a warp takes at once
  constexpr int WARPS = kLocalThreads / 32;
  extern __shared__ __align__(16) float local_smem[];
  const LocalBwdSmem m = local_bwd_layout(D, P, G);
  char* base = reinterpret_cast<char*>(local_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_round = QW * P;
  const int all = WARPS * per_round;  // the warps' rounds
  float* halo = local_smem;           // (NH + 1) x D: row NH zeros
  float* g_s = halo + (NH + 1) * D;   // NQ x D
  float* w_s = g_s + NQ * D;          // slots
  int4* scratch = reinterpret_cast<int4*>(base + m.scratch) + warp * per_round;
  unsigned short* list = reinterpret_cast<unsigned short*>(base + m.scratch);
  // two buffers of a round's locations and weights
  float2* xy_s = reinterpret_cast<float2*>(base + m.xy) + warp * per_round;
  float* a_s = reinterpret_cast<float*>(base + m.a) + warp * per_round;
  int* start = reinterpret_cast<int*>(base + m.start);    // NH + 1
  int* cursor = reinterpret_cast<int*>(base + m.cursor);  // NH
  short* key_s = reinterpret_cast<short*>(base + m.key);  // slots

  const LocalTile t =
      local_tile(blockIdx.x, H, tiles_x, tiles_y, h, w, TY, TX);
  const int V = h * w, row = H * D;  // row: elements between cells
  const int nh = t.HY * t.HX;
  const int64_t vo = (int64_t)t.b * V * row + t.hh * D;
  const int64_t lo = (int64_t)t.b * V * H * P;
  const float2* lb = reinterpret_cast<const float2*>(loc) + lo;
  const float* ab = attn + lo;
  // s / P as __umulhi(s, magic): exact for s * P < 2^32
  const unsigned magic_p = 0xffffffffu / (unsigned)P + 1u;
  int i0 = warp * QW;
  stage_halo<G>(halo, value + vo, t, w, row, D);
  stage_round<QW>(xy_s, a_s, lb, ab, t, w, H, P, i0, magic_p);
  cp_async_commit_group();
  for (int i = threadIdx.x; i < D; i += blockDim.x) halo[NH * D + i] = 0.f;
  for (int i = threadIdx.x; i < nh; i += blockDim.x) cursor[i] = 0;
  cp_async_wait_group<0>();
  __syncthreads();

  const int tid = threadIdx.x;
  const int grp = lane / G, sub = lane % G, ch = sub * 4;
  const bool chan = ch < D;
  const int cr = chan ? ch : 0;  // a lane past D reads channels it drops
  const float fw = (float)w, fh = (float)h;
  float* gvb = grad_value + vo + cr;
  // A
  for (int r = 0; i0 < t.nq; i0 += WARPS * QW, ++r) {
    const int buf = (r & 1) * all;
    if (i0 + WARPS * QW < t.nq) {  // the next round's, in flight
      stage_round<QW>(xy_s + all - buf, a_s + all - buf, lb, ab, t, w, H, P,
                      i0 + WARPS * QW, magic_p);
    }
    cp_async_commit_group();
    cp_async_wait_group<1>();
    __syncwarp();
    // a lane a sample: the round's corners
    for (int s = lane; s < per_round; s += 32) {
      const int qi = i0 + (int)__umulhi((unsigned)s, magic_p);
      const int p = s - (qi - i0) * P;
      int code[4] = {NH, NH, NH, NH};
      float cw[4] = {0.f, 0.f, 0.f, 0.f};
      if (qi < t.nq) {
        const float2 xy = xy_s[buf + s];
        const float a = a_s[buf + s];
        local_corners(sample_pos(fw, fh, xy.x, xy.y), t, h, w, NH, code, cw);
#pragma unroll
        for (int k = 0; k < 4; ++k) cw[k] = __fmul_rn(cw[k], a);
      }
      scratch[s] = make_int4(code[0], code[1], code[2], code[3]);
      *reinterpret_cast<float4*>(w_s + (qi * P + p) * 4) =
          make_float4(cw[0], cw[1], cw[2], cw[3]);
    }
    __syncwarp();
    // G lanes a query
    const int qi = i0 + grp;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < t.nq && chan) {
      const TileCell q = tile_cell(t, qi);
      const int64_t item = ((int64_t)t.b * V + q.y * w + q.x) * H + t.hh;
      g = __ldg(reinterpret_cast<const float4*>(grad_out + item * D + ch));
    }
    if (chan) *reinterpret_cast<float4*>(g_s + qi * D + ch) = g;
#pragma unroll 3
    for (int p = 0; p < P; ++p) {
      const int s = grp * P + p, slot = (qi * P + p) * 4;
      const int4 cd = scratch[s];
      const float4 wt = *reinterpret_cast<const float4*>(w_s + slot);
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
                value + vo + (int64_t)~c[k] * row + cr));
            if (chan && wk[k] != 0.f) {  // its add, at once
              atomicAdd(reinterpret_cast<float4*>(gvb + (int64_t)~c[k] * row),
                        make_float4(wk[k] * g.x, wk[k] * g.y, wk[k] * g.z,
                                    wk[k] * g.w));
            }
          }
        }
      }
      float pd[G < 4 ? 4 : G];
#pragma unroll
      for (int k = 0; k < (G < 4 ? 4 : G); ++k) {
        pd[k] = k < 4 ? g.x * v[k & 3].x + g.y * v[k & 3].y +
                            g.z * v[k & 3].z + g.w * v[k & 3].w
                      : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k % G == sub) {  // the corner's recording lane
          const int key = c[k] >= 0 && c[k] != NH && wk[k] != 0.f ? c[k] : -1;
          key_s[slot + k] = (short)key;
          if (key >= 0) atomicAdd(cursor + key, 1);
        }
      }
      // the group's dot of corner k ends in lane k % G
      float dot[G < 4 ? 4 / G : 1];
      if constexpr (G >= 4) {
        group_reduce_scatter<G>(pd, sub);
        dot[0] = pd[0];
      } else {
#pragma unroll
        for (int k0 = 0; k0 < 4; k0 += G) {
          float part[G];
#pragma unroll
          for (int j = 0; j < G; ++j) part[j] = pd[k0 + j];
          group_reduce_scatter<G>(part, sub);
          dot[k0 / G] = part[0];
        }
      }
      __syncwarp();  // every lane has read the sample's codes
      float* ds = reinterpret_cast<float*>(scratch + s);
#pragma unroll
      for (int j = 0; j < (G < 4 ? 4 / G : 1); ++j) {
        if (j * G + sub < 4) ds[j * G + sub] = dot[j];
      }
    }
    __syncwarp();
    // a lane a sample again: d loc and d attn from the four dots
    for (int s = lane; s < per_round; s += 32) {
      const int qs = i0 + (int)__umulhi((unsigned)s, magic_p);
      const int p = s - (qs - i0) * P;
      if (qs >= t.nq) continue;
      const TileCell q = tile_cell(t, qs);
      const int64_t at = lo + ((q.y * w + q.x) * H + t.hh) * P + p;
      const float2 xy = xy_s[buf + s];
      const float a = a_s[buf + s];
      const SamplePos sp = sample_pos(fw, fh, xy.x, xy.y);
      const float4 d4 = *reinterpret_cast<const float4*>(scratch + s);
      const float dot[4] = {d4.x, d4.y, d4.z, d4.w};
      // a corner outside the grid has dot 0 (the zero row), so its term
      // vanishes whatever its flag and weight
      Bilinear4 bl;
      bl.fx = sp.fx;
      bl.fy = sp.fy;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bl.idx[k] = 0;
        bl.cw[k] = corner_cw(k, sp.fx, sp.fy);
      }
      const SampleGrad sg = sample_grad(bl, dot, a, fw, fh);
      grad_loc[2 * at] = sg.lx;
      grad_loc[2 * at + 1] = sg.ly;
      grad_attn[at] = sg.attn;
    }
    __syncwarp();  // the scratch is the next round's
  }
  __syncthreads();
  // B: exclusive scan of the counts by warp 0, a run of rows a lane
  if (tid < 32) {
    const int per = (nh + 31) / 32, k0 = lane * per;
    const int k1 = min(nh, k0 + per);
    int sum = 0;
    for (int k = k0; k < k1; ++k) sum += cursor[k];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    int at = incl - sum;
    for (int k = k0; k < k1; ++k) {
      const int n = cursor[k];
      start[k] = at;
      cursor[k] = at;
      at += n;
    }
    if (lane == 31) start[nh] = incl;
  }
  __syncthreads();
  for (int e = tid; e < t.nq * P * 4; e += blockDim.x) {  // recorded slots
    const int key = key_s[e];
    if (key >= 0) list[atomicAdd(cursor + key, 1)] = (unsigned short)e;
  }
  __syncthreads();
  // C: the list cut into one equal piece a group, walked a halo row at a
  // time (the rows' starts bound each run, so no entry's row is looked
  // up); the group's lanes walk the same slots
  constexpr int GROUPS = kLocalThreads / G;
  const int total = start[nh];
  const int piece = (total + GROUPS - 1) / GROUPS;
  int e = (tid / G) * piece;
  const int e1 = min(total, e + piece);
  // slot / (P * 4), the slot's query, as __umulhi(slot, magic): exact for
  // slot * P * 4 < 2^32 (slots <= 2^16, P * 4 <= 2^16)
  const unsigned magic = 0xffffffffu / (unsigned)(P * 4) + 1u;
  if (e < e1) {
    // the row of entry e: the last r with start[r] <= e
    int r = 0, hi = nh - 1;
    while (r < hi) {
      const int mid = (r + hi + 1) >> 1;
      if (start[mid] <= e) {
        r = mid;
      } else {
        hi = mid - 1;
      }
    }
    int ry = r / t.HX, rx = r - ry * t.HX;
    while (e < e1) {
      const int end = min(e1, start[r + 1]);
      if (end > e) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (; e < end; ++e) {
          const unsigned slot = list[e];
          const float wk = w_s[slot];
          const float4 gq = *reinterpret_cast<const float4*>(
              g_s + __umulhi(slot, magic) * D + cr);
          acc.x = fmaf(wk, gq.x, acc.x);
          acc.y = fmaf(wk, gq.y, acc.y);
          acc.z = fmaf(wk, gq.z, acc.z);
          acc.w = fmaf(wk, gq.w, acc.w);
        }
        if (chan) {
          const int cell = (t.hy0 + ry) * w + t.hx0 + rx;
          atomicAdd(reinterpret_cast<float4*>(gvb + (int64_t)cell * row), acc);
        }
      }
      ++r;
      if (++rx == t.HX) {
        rx = 0;
        ++ry;
      }
    }
  }
}

// The tile-local entry's backward: the gradients of msda_fwd_local (value,
// loc, attn as it takes them) for grad_out (B, h * w, H * D) f32 ->
// grad_value (B, h * w, H, D) f32 (zero-filled here, then summed by f32
// atomics), grad_loc and grad_attn like loc and attn. value, grad_out and
// grad_value 16-byte aligned, loc 8-byte aligned; P at most 128 (a tile's
// slots index a 16-bit list) and the block's shared memory
// (local_bwd_layout) within kLocalMaxSmem. Returns 0 on success, else a
// cudaError_t code (cudaErrorInvalidValue for inputs it does not take).
extern "C" int msda_bwd_local(const float* value, const float* loc,
                              const float* attn, const float* grad_out,
                              float* grad_value, float* grad_loc,
                              float* grad_attn, int B, int h, int w, int H,
                              int D, int P, void* stream) {
  constexpr int TY = kLocalBwdTileY, TX = kLocalBwdTileX;
  if (B < 0 || h < 1 || w < 1 || H < 1 || P < 1 || D < 4 || D > 32 ||
      D % 4 != 0 ||
      (((uintptr_t)value | (uintptr_t)grad_out | (uintptr_t)grad_value) &
       15) != 0 ||
      ((uintptr_t)loc & 7) != 0 || (int64_t)h * w * H * P > INT32_MAX ||
      (int64_t)TY * TX * P * 4 > 65536 ||
      local_bwd_layout(D, P, local_lanes(D)).total > kLocalMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_y = (h + TY - 1) / TY, tiles_x = (w + TX - 1) / TX;
  const int64_t blocks = (int64_t)B * tiles_y * tiles_x * H;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      grad_value, 0, (size_t)B * h * w * H * D * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const int smem = (int)local_bwd_layout(D, P, local_lanes(D)).total;
  void (*kernel)(const float*, const float*, const float*, const float*,
                 float*, float*, float*, int, int, int, int, int, int) =
      nullptr;
  switch (D) {
#define MSDA_BWD_LOCAL_CASE(D_) \
  case D_:                      \
    kernel = msda_bwd_local_kernel<D_>; \
    break;
    MSDA_BWD_LOCAL_CASE(4)
    MSDA_BWD_LOCAL_CASE(8)
    MSDA_BWD_LOCAL_CASE(12)
    MSDA_BWD_LOCAL_CASE(16)
    MSDA_BWD_LOCAL_CASE(20)
    MSDA_BWD_LOCAL_CASE(24)
    MSDA_BWD_LOCAL_CASE(28)
    MSDA_BWD_LOCAL_CASE(32)
#undef MSDA_BWD_LOCAL_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, kLocalThreads, smem, s>>>(
      value, loc, attn, grad_out, grad_value, grad_loc, grad_attn, h, w, H, P,
      tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- resident entry

// The shared memory of the map-resident backward kernels: the head
// group's map and a row of zeros (ops/msda_cuda.py resident_smem mirrors
// it).
static inline int resident_bwd_smem(int V, int Hb, int D) {
  return (V * Hb + 1) * D * 4;
}

// The map-resident backward at D = 16 and 32 (design notes in the header):
// a block stages its head group's whole map and takes tiles of its (batch
// element, head group) pair as the forward does, G = D / 4 lanes an item,
// 4 channels a lane. The lanes read the item's grad_out row once; lane `sub` forms the
// corners of samples p0 + sub, and the group walks those with a corner in
// the grid: each lane reads its 4 channels of the four rows, the four
// partial dot products are summed over the group (log2 G shuffles each),
// the sample's owner keeps them, and each lane adds weight x its grad_out
// channels to each corner's row of the f32 grad_value by one 16-byte
// atomic, the group's G atomics one contiguous row. The owner then stores
// the sample's d loc and d attn.
template <int D>
__global__ void __launch_bounds__(kResidentThreads)
msda_bwd_resident_items_kernel(const float* __restrict__ value,
                         const float* __restrict__ loc,
                         const float* __restrict__ attn,
                         const int* __restrict__ tile_mask,
                         const float* __restrict__ grad_out,
                         float* __restrict__ grad_value,
                         float* __restrict__ grad_loc,
                         float* __restrict__ grad_attn, int h, int w, int H,
                         int Hb, int Q, int P, int blocks_per_pair,
                         int q_tile, int n_tiles) {
  constexpr int G = D / 4;
  static_assert(G >= kResidentBallotLanes, "a group walks its item alone");
  constexpr int QW = 32 / G;  // items a warp takes at once
  constexpr int TILE = kResidentThreads / G;
  extern __shared__ __align__(16) float res_smem[];
  const int V = h * w, NR = V * Hb;
  float* map = res_smem;  // (NR + 1) x D: row NR zeros
  const int pair = blockIdx.x / blocks_per_pair;
  const int first = (blockIdx.x - pair * blocks_per_pair) * TILE;
  const int stride = blocks_per_pair * TILE, n_items = Q * Hb;
  const int groups = H / Hb;
  const int b = pair / groups, h0 = (pair - b * groups) * Hb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, sub = lane % G;
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  float2* gloc2 = reinterpret_cast<float2*>(grad_loc);
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
  stage_resident_map(map, value + ((int64_t)b * V * H + h0) * D, V, H, Hb, D);
  cp_async_commit_group();
  for (int i = threadIdx.x; i < D; i += blockDim.x) map[NR * D + i] = 0.f;
  cp_async_wait_group<0>();
  __syncthreads();

  const float fw = (float)w, fh = (float)h;
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
    if (!live) continue;
    if (!cur_on) {  // a masked tile's item: zero d loc and d attn
      for (int p = sub; p < P; p += G) {
        gloc2[item * P + p] = make_float2(0.f, 0.f);
        grad_attn[item * P + p] = 0.f;
      }
      continue;
    }
    const int hl = it % Hb;
    const float4 g4 =
        __ldg(reinterpret_cast<const float4*>(grad_out + item * D + sub * 4));
    // the item's head's channels of cell 0 in grad_value
    float* gv = grad_value + ((int64_t)b * V * H + h0 + hl) * D + sub * 4;
    for (int p0 = 0; p0 < P; p0 += G) {
      const int p = p0 + sub;
      float2 xy = cxy;
      float a = ca;
      SamplePos sp = {0, 0, 0.f, 0.f};
      int code[4] = {NR, NR, NR, NR};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < P) {
        if (p0 > 0) {
          xy = __ldg(loc2 + item * P + p);
          a = __ldg(attn + item * P + p);
        }
        sp = sample_pos(fw, fh, xy.x, xy.y);
        resident_corners(sp, h, w, Hb, hl, NR, code, wt);
#pragma unroll
        for (int k = 0; k < 4; ++k) wt[k] = __fmul_rn(wt[k], a);
      }
      float mine[4] = {0.f, 0.f, 0.f, 0.f};  // this lane's sample's dots
      // the group's samples with a corner in the grid, one at a time
      unsigned todo = __ballot_sync(gmask, code[0] != NR || code[1] != NR ||
                                               code[2] != NR || code[3] != NR) >>
                      (grp * G);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        int c[4];
        float wk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          c[k] = __shfl_sync(gmask, code[k], grp * G + j);
          wk[k] = __shfl_sync(gmask, wt[k], grp * G + j);
        }
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // the four loads in flight
          v[k] = *reinterpret_cast<const float4*>(map + c[k] * D + sub * 4);
        }
        float pd[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pd[k] = g4.x * v[k].x + g4.y * v[k].y + g4.z * v[k].z + g4.w * v[k].w;
        }
#pragma unroll
        for (int m = 1; m < G; m <<= 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) pd[k] += __shfl_xor_sync(gmask, pd[k], m);
        }
        if (j == sub) {
#pragma unroll
          for (int k = 0; k < 4; ++k) mine[k] = pd[k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c[k] != NR && wk[k] != 0.f) {
            atomicAdd(reinterpret_cast<float4*>(gv + (int64_t)(c[k] / Hb) * H * D),
                      make_float4(wk[k] * g4.x, wk[k] * g4.y, wk[k] * g4.z,
                                  wk[k] * g4.w));
          }
        }
      }
      if (p < P) {
        // a corner outside the grid has dot 0 (the zero row), so its term
        // vanishes whatever its flag and weight
        Bilinear4 bl;
        bl.fx = sp.fx;
        bl.fy = sp.fy;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bl.idx[k] = 0;
          bl.cw[k] = corner_cw(k, sp.fx, sp.fy);
        }
        const SampleGrad sg = sample_grad(bl, mine, a, fw, fh);
        gloc2[item * P + p] = make_float2(sg.lx, sg.ly);
        grad_attn[item * P + p] = sg.attn;
      }
    }
  }
}

// The map-resident backward at D = 4 and 8 (design notes in the header): a
// block stages its head group's whole map, then takes tiles of 8 x 32 / G
// samples of its (batch element, head group) pair, every
// blocks_per_pair-th tile, G = D / 4 lanes a sample and 4 channels a lane. The group's lanes all form the
// sample's corners (no shuffle passes them round), read their 4 channels
// of the item's grad_out row and of the four corner rows, sum the four
// partial dot products over the group (log2 G shuffles each) and add
// weight x their grad_out channels to each corner's row of the f32
// grad_value by one 16-byte atomic, the group's G atomics one contiguous
// row. The group's first lane stores the sample's d loc and d attn. The
// next tile's sample is loaded while the group works on this one.
template <int D>
__global__ void __launch_bounds__(kResidentThreads)
msda_bwd_resident_samples_kernel(const float* __restrict__ value,
                         const float* __restrict__ loc,
                         const float* __restrict__ attn,
                         const int* __restrict__ tile_mask,
                         const float* __restrict__ grad_out,
                         float* __restrict__ grad_value,
                         float* __restrict__ grad_loc,
                         float* __restrict__ grad_attn, int h, int w, int H,
                         int Hb, int Q, int P, int blocks_per_pair,
                         int q_tile, int n_tiles) {
  constexpr int G = D / 4;
  static_assert(G < kResidentBallotLanes, "the warp's groups walk in step");
  constexpr int SW = 32 / G;  // samples a warp takes at once
  constexpr int TILE = kResidentThreads / G;
  extern __shared__ __align__(16) float res_smem[];
  const int V = h * w, NR = V * Hb;
  float* map = res_smem;  // (NR + 1) x D: row NR zeros
  const int pair = blockIdx.x / blocks_per_pair;
  const int first = (blockIdx.x - pair * blocks_per_pair) * TILE;
  const int stride = blocks_per_pair * TILE, n_samples = Q * Hb * P;
  const int groups = H / Hb;
  const int b = pair / groups, h0 = (pair - b * groups) * Hb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, sub = lane % G;
  const float2* loc2 = reinterpret_cast<const float2*>(loc);
  float2* gloc2 = reinterpret_cast<float2*>(grad_loc);
  // sample s: its item's row of grad_out (the item's (b, q, h) index), its
  // element of loc and attn, its head in the group, and whether it is live
  // and its tile active
  struct Sample {
    int64_t row, at;
    int hl;
    bool live, on;
  };
  auto sample_of = [&](int s) {
    Sample t;
    const int it = s / P, q = it / Hb;
    t.hl = it - q * Hb;
    t.row = ((int64_t)b * Q + q) * H + h0 + t.hl;
    t.at = t.row * P + s - it * P;
    t.live = s < n_samples;
    t.on = t.live && (tile_mask == nullptr ||
                      __ldg(tile_mask + b * n_tiles + q / q_tile) != 0);
    return t;
  };
  Sample nxt = sample_of(first + warp * SW + grp);
  float2 nxy = make_float2(0.f, 0.f);
  float na = 0.f;
  if (nxt.on) {
    nxy = __ldg(loc2 + nxt.at);
    na = __ldg(attn + nxt.at);
  }
  stage_resident_map(map, value + ((int64_t)b * V * H + h0) * D, V, H, Hb, D);
  cp_async_commit_group();
  for (int i = threadIdx.x; i < D; i += blockDim.x) map[NR * D + i] = 0.f;
  cp_async_wait_group<0>();
  __syncthreads();

  const float fw = (float)w, fh = (float)h;
  for (int t0 = first; t0 < n_samples; t0 += stride) {
    const Sample cur = nxt;
    const float2 xy = nxy;
    const float a = na;
    // the next tile's sample, in flight during this one
    nxt = sample_of(t0 + stride + warp * SW + grp);
    if (nxt.on) {
      nxy = __ldg(loc2 + nxt.at);
      na = __ldg(attn + nxt.at);
    }
    SamplePos sp = {0, 0, 0.f, 0.f};
    int code[4] = {NR, NR, NR, NR};
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cur.on) {
      sp = sample_pos(fw, fh, xy.x, xy.y);
      resident_corners(sp, h, w, Hb, cur.hl, NR, code, cw);
      g4 = __ldg(reinterpret_cast<const float4*>(grad_out + cur.row * D + sub * 4));
    }
    // every lane of the warp takes part in the shuffles: a sample without a
    // corner in the grid reads the row of zeros
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // the four loads in flight
        v[k] = *reinterpret_cast<const float4*>(map + code[k] * D + sub * 4);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dot[k] = g4.x * v[k].x + g4.y * v[k].y + g4.z * v[k].z + g4.w * v[k].w;
      }
#pragma unroll
      for (int m = 1; m < G; m <<= 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) dot[k] += __shfl_xor_sync(FULL_MASK, dot[k], m);
      }
      float* gv = grad_value + ((int64_t)b * V * H + h0 + cur.hl) * D + sub * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float wk = __fmul_rn(cw[k], a);
        if (code[k] != NR && wk != 0.f) {
          atomicAdd(reinterpret_cast<float4*>(gv + (int64_t)(code[k] / Hb) * H * D),
                    make_float4(wk * g4.x, wk * g4.y, wk * g4.z, wk * g4.w));
        }
      }
    }
    if (cur.live && sub == 0) {
      float2 gl = make_float2(0.f, 0.f);
      float ga = 0.f;
      if (cur.on) {
        // a corner outside the grid has dot 0 (the zero row), so its term
        // vanishes whatever its flag and weight
        Bilinear4 bl;
        bl.fx = sp.fx;
        bl.fy = sp.fy;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bl.idx[k] = 0;
          bl.cw[k] = corner_cw(k, sp.fx, sp.fy);
        }
        const SampleGrad sg = sample_grad(bl, dot, a, fw, fh);
        gl = make_float2(sg.lx, sg.ly);
        ga = sg.attn;
      }
      gloc2[cur.at] = gl;
      grad_attn[cur.at] = ga;
    }
  }
}

// The map-resident entry's backward: the gradients of msda_fwd_resident
// (value, loc, attn, tile_mask as it takes them) for grad_out (B, Q, H *
// D) f32 -> grad_value (B, V, H, D) f32 (zero-filled here, then summed by
// f32 atomics), grad_loc and grad_attn like loc and attn. value, grad_out
// and grad_value 16-byte aligned, loc 8-byte aligned, P at most
// kResidentMaxPoints. Returns 0 on success, else a cudaError_t code
// (cudaErrorInvalidValue for inputs it does not take).
extern "C" int msda_bwd_resident(const float* value, const float* loc,
                                 const float* attn, const int* tile_mask,
                                 const float* grad_out, float* grad_value,
                                 float* grad_loc, float* grad_attn, int B,
                                 int h, int w, int H, int D, int Q, int P,
                                 int q_tile, void* stream) {
  if (B < 0 || Q < 0 || h < 1 || w < 1 || H < 1 || P < 1 ||
      P > kResidentMaxPoints || q_tile < 1 ||
      (D != 4 && D != 8 && D != 16 && D != 32) ||
      (((uintptr_t)value | (uintptr_t)grad_out | (uintptr_t)grad_value) &
       15) != 0 ||
      ((uintptr_t)loc & 7) != 0 || (int64_t)Q * H * P > INT32_MAX ||
      (int64_t)B * H > INT32_MAX ||
      (int64_t)h * w * 16 > kResidentMapBytes) {
    return (int)cudaErrorInvalidValue;
  }
  const int V = h * w, Hb = resident_heads(V, H, D);
  if (Hb < 1) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      grad_value, 0, (size_t)B * V * H * D * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const int smem = resident_bwd_smem(V, Hb, D);
  // D = 16, 32: G lanes an item, the item's grad_out row read once; D = 4,
  // 8: G lanes a sample, so that a warp has 16 or 32 samples in flight
  // (either way round was the slower one at the other widths, H100)
  void (*kernel)(const float*, const float*, const float*, const int*,
                 const float*, float*, float*, float*, int, int, int, int,
                 int, int, int, int, int) = nullptr;
  switch (D) {
    case 4:
      kernel = msda_bwd_resident_samples_kernel<4>;
      break;
    case 8:
      kernel = msda_bwd_resident_samples_kernel<8>;
      break;
    case 16:
      kernel = msda_bwd_resident_items_kernel<16>;
      break;
    default:
      kernel = msda_bwd_resident_items_kernel<32>;
      break;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  // tiles of 256 / G items (D >= 16) or samples (D <= 8) a block round
  const int blocks = resident_blocks_per_pair(
      (const void*)kernel, smem, B, H, Hb, D >= 16 ? Q : Q * P,
      kResidentThreads / (D / 4), &e);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)((int64_t)blocks * B * (H / Hb)), kResidentThreads, smem,
           s>>>(value, loc, attn, tile_mask, grad_out, grad_value, grad_loc,
                grad_attn, h, w, H, Hb, Q, P, blocks, q_tile,
                (Q + q_tile - 1) / q_tile);
  return (int)cudaGetLastError();
}
