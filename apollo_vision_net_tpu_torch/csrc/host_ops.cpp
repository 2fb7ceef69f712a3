// The port's native host library (C ABI, loaded by data/native.py through
// ctypes): a copy of the JAX package's csrc/host_ops.cpp, kept here so that
// the port builds it from its own tree.
//
// Two host-side hot paths of the data layer, multi-threaded over
// std::thread: the camera ring's fused resize + normalize + pad on the eval
// path (the numpy version in data/pipeline.py is its plain version: the
// same bilinear convention and normalize/pad semantics, normalizing after
// the resize instead of before it, so the two agree to rounding), and the
// majority-vote voxelizer behind tools/convert_lidar_to_occ.py (plain
// version: that tool's voxelize_numpy, equal to it label for label).
//
// Built at first use by data/native.py with g++ -O3 -march=native
// -std=c++17 -fPIC -shared -pthread -Wall (the JAX package's csrc/Makefile
// flags) into apollo_vision_net_tpu_torch/build/.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename F>
void parallel_for(int n, F&& fn) {
  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Bilinear resize (align_corners=False convention: src = (dst+0.5)/s - 0.5,
// clamped; as data/pipeline.py scale_images), then per-channel
// normalize (x - mean) / std, then zero-pad to (out_h, out_w).
// in:  (n, h, w, 3) uint8 RGB
// out: (n, out_h, out_w, 3) float32 — out_h/out_w >= resized dims.
void resize_normalize_pad(const uint8_t* in, int n, int h, int w,
                          float scale, const float* mean, const float* std_,
                          float* out, int out_h, int out_w) {
  const int nh = static_cast<int>(std::lround(h * scale));
  const int nw = static_cast<int>(std::lround(w * scale));
  const float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};

  parallel_for(n * nh, [&](int job) {
    const int img = job / nh;
    const int y = job % nh;
    const uint8_t* src = in + static_cast<int64_t>(img) * h * w * 3;
    float* dst = out + (static_cast<int64_t>(img) * out_h + y) * out_w * 3;
    // zero the row tail (padding)
    std::memset(dst, 0, sizeof(float) * out_w * 3);

    float sy = (y + 0.5f) / scale - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > h - 1) sy = static_cast<float>(h - 1);
    const int y0 = static_cast<int>(sy);
    const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const float fy = sy - y0;

    for (int x = 0; x < nw; ++x) {
      float sx = (x + 0.5f) / scale - 0.5f;
      if (sx < 0) sx = 0;
      if (sx > w - 1) sx = static_cast<float>(w - 1);
      const int x0 = static_cast<int>(sx);
      const int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      const float fx = sx - x0;
      const uint8_t* p00 = src + (static_cast<int64_t>(y0) * w + x0) * 3;
      const uint8_t* p01 = src + (static_cast<int64_t>(y0) * w + x1) * 3;
      const uint8_t* p10 = src + (static_cast<int64_t>(y1) * w + x0) * 3;
      const uint8_t* p11 = src + (static_cast<int64_t>(y1) * w + x1) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * fx;
        const float bot = p10[c] + (p11[c] - p10[c]) * fx;
        const float v = top + (bot - top) * fy;
        dst[x * 3 + c] = (v - mean[c]) * inv_std[c];
      }
    }
  });

  // zero remaining padded rows
  parallel_for(n, [&](int img) {
    for (int y = nh; y < out_h; ++y) {
      std::memset(out + (static_cast<int64_t>(img) * out_h + y) * out_w * 3,
                  0, sizeof(float) * out_w * 3);
    }
  });
}

// Occupancy GT voxelization: label each voxel with the majority semantic
// class of the points inside it (ties -> smallest label; empty voxels
// untouched). The reference builds these offline with
// tools/convert_lidar_pcd_to_occ.py.
// points: (n, 4) float32 [x, y, z, label]
// dense:  (zdim*xdim*ydim,) int32 pre-filled with empty_label by the caller
// counts: scratch (num_classes,) per call — internal.
void voxelize_points(const float* points, int64_t n_points,
                     const float* pc_range,  // x0 y0 z0 x1 y1 z1
                     float vx, float vy, float vz, int xdim, int ydim,
                     int zdim, int num_classes, int32_t* dense) {
  // two passes: histogram per voxel is memory-heavy; instead keep
  // (best_label, best_count) via count array hashed per voxel serially.
  // Points per frame ~1e5-1e6: a simple per-voxel last-write-wins with
  // per-class counts in a flat int16 map would be 16*voxels; use
  // majority-by-count with a count map of num_classes per touched voxel.
  const int64_t n_vox = static_cast<int64_t>(xdim) * ydim * zdim;
  std::vector<int16_t> counts(n_vox * num_classes, 0);
  for (int64_t i = 0; i < n_points; ++i) {
    const float* p = points + i * 4;
    if (p[0] < pc_range[0] || p[0] >= pc_range[3] || p[1] < pc_range[1] ||
        p[1] >= pc_range[4] || p[2] < pc_range[2] || p[2] >= pc_range[5]) {
      continue;
    }
    const int xi = static_cast<int>((p[0] - pc_range[0]) / vx);
    const int yi = static_cast<int>((p[1] - pc_range[1]) / vy);
    const int zi = static_cast<int>((p[2] - pc_range[2]) / vz);
    int lab = static_cast<int>(p[3]);
    if (lab < 0 || lab >= num_classes) continue;
    if (xi < 0 || xi >= xdim || yi < 0 || yi >= ydim || zi < 0 || zi >= zdim)
      continue;
    // (z, y, x) voxel order, x minor — the reference's dense layout
    // (convert_lidar_pcd_to_occ.py:122: vox = x + y*xdim + z*xdim*ydim),
    // matching the occ heads' (z, bev_row=y, bev_col=x) flat output
    const int64_t v =
        (static_cast<int64_t>(zi) * ydim + yi) * xdim + xi;
    if (counts[v * num_classes + lab] < INT16_MAX)
      counts[v * num_classes + lab]++;
  }
  parallel_for(static_cast<int>(n_vox), [&](int v) {
    int best = -1;
    int16_t best_c = 0;
    const int16_t* c = counts.data() + static_cast<int64_t>(v) * num_classes;
    for (int k = 0; k < num_classes; ++k) {
      if (c[k] > best_c) {
        best_c = c[k];
        best = k;
      }
    }
    if (best >= 0) dense[v] = best;
  });
}

}  // extern "C"
