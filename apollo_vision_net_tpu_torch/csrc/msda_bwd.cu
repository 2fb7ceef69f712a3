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

// log2 of the lane slot of an item in msda_bwd_vec_kernel: L * P rounded
// up to a power of two, at least 4 (so that a group of G <= 8 lanes spans
// at most two items) and at most 32 (rounds of 32 samples beyond).
// ops/msda_cuda.py bwd_items_per_warp mirrors it (BWD_SLOT_MIN,
// BWD_SLOT_MAX).
constexpr int kSlotLog2Min = 2, kSlotLog2Max = 5;

static inline int bwd_slot_log2(int LP) {
  int s = kSlotLog2Min;
  while (s < kSlotLog2Max && (1 << s) < LP) ++s;
  return s;
}

// The plans of msda_bwd (ops/msda_cuda.py BWD_VARIANTS and bwd_plan).
constexpr int kPlanGeneral = 0, kPlanGather = 1;

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
static void launch_bwd(cudaStream_t s, int plan, const void* value,
                       const float* loc, const float* attn,
                       const int* tile_mask, const void* grad_out,
                       float* grad_value_f32, void* grad_value, int* row_head,
                       int2* links, float* grad_loc, float* grad_attn, int B,
                       int V, int H, int D, int Q, int P, int LP, int q_tile,
                       int n_tiles, const MsdaLevels& lv) {
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
    return;
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
}

// Returns 0 on success, else a cudaError_t code. shapes points to 2 * L host
// ints (h0, w0, h1, w1, ...); tile_mask may be null; dtype 0 = f32, 1 =
// bf16. plan (ops/msda_cuda.py bwd_plan): 1 "gather" (D = 4, 8, 16 or 32,
// value and grad_out aligned to 4 channels, B * V * H * D and the
// B * Q * H * L * P * 4 corner slots below 2^31), 0 "general"; a plan the
// inputs do not allow is refused. grad_value_f32 is the general plan's f32
// scratch of value's shape (zero-filled here; grad_value itself for f32
// value), null for gather; row_head (B V H ints, set to -1 here) and
// slot_links (B Q H L P 4 int pairs) are the gather plan's lists, null for
// general. *variant is set to the plan that ran.
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
    if (dtype == 0) {
      launch_bwd<float>(s, plan, value, loc, attn, tile_mask, grad_out,
                        grad_value_f32, grad_value, row_head, links, grad_loc,
                        grad_attn, B, V, H, D, Q, P, LP, q_tile, n_tiles, lv);
    } else {
      launch_bwd<__nv_bfloat16>(s, plan, value, loc, attn, tile_mask,
                                grad_out, grad_value_f32, grad_value,
                                row_head, links, grad_loc, grad_attn, B, V, H,
                                D, Q, P, LP, q_tile, n_tiles, lv);
    }
    *variant = plan;
  } else if (plan == kPlanGather && n_value > 0) {
    // no item: every row is zero
    const cudaError_t e = cudaMemsetAsync(
        grad_value, 0, n_value * (dtype == 0 ? 4 : 2), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (plan == kPlanGeneral && dtype == 1 && n_value > 0) {
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
