// Native binned-SAH BVH builder (C ABI, loaded via ctypes).
//
// The runtime counterpart of caitlynrenderer_tpu/accel/bvh.py: identical
// algorithm (32-bin SAH over centroid bounds, leaf width max_leaf, flat
// layout with right = left + 1, contiguous leaf triangle ranges) so the
// two builders are interchangeable — the Python twin is the test oracle,
// this one is the production path for large scenes (the reference's
// host-side C++ builders, sbvh.h, play the same role).
//
// Build: g++ -O3 -shared -fPIC -o libbvh.so bvh_builder.cpp

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Box& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow_point(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

constexpr int kBins = 32;

struct Range {
  int node_id;
  int start;
  int end;
};

}  // namespace

extern "C" {

// Builds the BVH; writes flat arrays (children adjacent: right = left+1).
//   node_bounds: (cap, 6) float   node_meta: (cap, 2) int32
//   tri_order:   (T,)    int32    cap must be >= 2*T
// Returns the number of nodes written, or -1 on overflow.
int build_bvh_sah(const float* bmin, const float* bmax, const float* cent,
                  int num_tris, int max_leaf, float* node_bounds,
                  int* node_meta, int* tri_order, int cap) {
  if (num_tris <= 0) return 0;
  max_leaf = std::max(max_leaf, 1);

  std::vector<int> order(num_tris);
  for (int i = 0; i < num_tris; ++i) order[i] = i;

  auto ref_box = [&](int id) {
    return Box{{bmin[3 * id], bmin[3 * id + 1], bmin[3 * id + 2]},
               {bmax[3 * id], bmax[3 * id + 1], bmax[3 * id + 2]}};
  };

  int n_nodes = 1;  // root = 0
  std::vector<Range> stack;
  stack.push_back({0, 0, num_tris});

  while (!stack.empty()) {
    Range rg = stack.back();
    stack.pop_back();
    int n = rg.end - rg.start;

    Box nb, cb;
    for (int i = rg.start; i < rg.end; ++i) {
      int id = order[i];
      nb.grow(ref_box(id));
      cb.grow_point({cent[3 * id], cent[3 * id + 1], cent[3 * id + 2]});
    }
    node_bounds[6 * rg.node_id + 0] = nb.lo.x;
    node_bounds[6 * rg.node_id + 1] = nb.lo.y;
    node_bounds[6 * rg.node_id + 2] = nb.lo.z;
    node_bounds[6 * rg.node_id + 3] = nb.hi.x;
    node_bounds[6 * rg.node_id + 4] = nb.hi.y;
    node_bounds[6 * rg.node_id + 5] = nb.hi.z;

    if (n <= max_leaf) {
      node_meta[2 * rg.node_id + 0] = rg.start;
      node_meta[2 * rg.node_id + 1] = n;
      continue;
    }

    float best_cost = FLT_MAX;
    int best_axis = -1, best_bin = -1;
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    const float* clo = &cb.lo.x;
    for (int axis = 0; axis < 3; ++axis) {
      if (ext[axis] <= 0.f) continue;
      float scale = kBins / ext[axis];
      Box bins[kBins];
      int counts[kBins] = {0};
      for (int i = rg.start; i < rg.end; ++i) {
        int id = order[i];
        int b = (int)((cent[3 * id + axis] - clo[axis]) * scale);
        b = std::min(std::max(b, 0), kBins - 1);
        bins[b].grow(ref_box(id));
        counts[b]++;
      }
      float rarea[kBins];
      int rcount[kBins];
      Box acc;
      int rc = 0;
      for (int b = kBins - 1; b > 0; --b) {
        acc.grow(bins[b]);
        rc += counts[b];
        rarea[b] = acc.area();
        rcount[b] = rc;
      }
      Box lacc;
      int lc = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        lacc.grow(bins[b]);
        lc += counts[b];
        if (lc == 0 || rcount[b + 1] == 0) continue;
        float cost = lacc.area() * lc + rarea[b + 1] * rcount[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      mid = rg.start + n / 2;
      std::nth_element(order.begin() + rg.start, order.begin() + mid,
                       order.begin() + rg.end);
    } else {
      float scale = kBins / ext[best_axis];
      float lo = clo[best_axis];
      int axis = best_axis;
      int threshold = best_bin;
      auto it = std::partition(order.begin() + rg.start,
                               order.begin() + rg.end, [&](int id) {
                                 int b = (int)((cent[3 * id + axis] - lo) *
                                               scale);
                                 b = std::min(std::max(b, 0), kBins - 1);
                                 return b <= threshold;
                               });
      mid = (int)(it - order.begin());
      if (mid == rg.start || mid == rg.end) mid = rg.start + n / 2;
    }

    if (n_nodes + 2 > cap) return -1;
    int left = n_nodes;
    n_nodes += 2;  // children adjacent (right = left + 1)
    node_meta[2 * rg.node_id + 0] = left;
    node_meta[2 * rg.node_id + 1] = 0;
    stack.push_back({left + 1, mid, rg.end});
    stack.push_back({left, rg.start, mid});
  }

  std::memcpy(tri_order, order.data(), sizeof(int) * num_tris);
  return n_nodes;
}

}  // extern "C"
