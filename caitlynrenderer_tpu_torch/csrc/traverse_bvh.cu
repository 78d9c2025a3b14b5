// Binary-BVH closest-hit and any-hit walk for Hopper (sm_90a): kernel B4.
//
// Replaces caitlynrenderer_tpu/ops/traverse_xla.py:traverse_closest (:52)
// and :traverse_anyhit (:160), the reference's XLA stack machine (a
// lax.while_loop over the whole batch, not a Pallas kernel), for the "bvh2"
// and "sbvh" accelerators.  Inputs: the FlatBVH of accel/bvh.py
// (node_bounds (Nn, 6) f32 min | max, node_meta (Nn, 2) i32: left child or
// first triangle, and the triangle count, 0 at an inner node whose children
// are left and left + 1) and the leaf-ordered scene (verts (V, 3) f32,
// tri_v (T, 4) i32).
//
// One thread per ray walks the tree as the reference's loop body does
// (traverse_xla.py:95-150) and as the plain twin (ops/traverse_bvh.py) does:
//   - at an inner node both children get the slab test
//       t0 = (lo - o) * d_inv, t1 = (hi - o) * d_inv,
//       t_near = max over axes of min(t0, t1), t_far = min of max(t0, t1),
//     with NaN propagated as torch.minimum / amax propagate it (fminf and
//     fmaxf would drop it: an axis-parallel ray has d_inv = +-inf, and where
//     lo - o is 0 the product is NaN, which rejects the child), and a child
//     is accepted when t_far > 0, t_far >= t_near and t_near < t_limit
//     (closest: the best t so far; any-hit: t_max).  The child index is
//     clamped into [0, Nn - 1] for the read, as the twin does;
//   - the walk descends into the nearer accepted child and pushes the
//     other only when both are accepted (go right first when near_l >
//     near_r); it pops at a leaf and at an inner node that accepts nothing;
//   - a leaf tests min(count, max_leaf) triangles of its contiguous range
//     (triangle index clamped into [0, T - 1] for the read, reported
//     unclamped) with Moller-Trumbore in ops/intersect.mt_uvt's order and
//     acceptance (u >= 0, v >= 0, (1 - u) - v >= 0, t >= 0, t < t_best,
//     inv_det = 1 / (|det| < 1e-20 ? 1e-20 : det)); closest keeps a strict
//     < update over the leaf in index order, which is the twin's first index
//     of the leaf's minimum; any-hit stops at the first accepted triangle.
// d_inv = 1 / d is IEEE division.  Built with --fmad=false and without fast
// math, every multiply and add is rounded as the twin rounds it, so t, tri,
// u, v and occlusion equal the twin's bit for bit.
//
// The stack holds max_stack entries (scene.required_stack: tree depth + 1,
// at least 32; grid1m's SAH tree needs 32) in local memory; the kernel is
// instantiated for 32, 64 and 128 entries and the wrapper raises above that
// (render/integrator._check_stack names the limit for a deeper tree).  A
// push past max_stack, or a node or vertex index out of range, traps: never
// clamped, never read back (the twin raises ValueError or IndexError there).
//
// What bounds it on an H100: each level of the walk is a dependent load
// (a node's children are found from its meta, read from device memory or
// L2), so one ray's walk is a chain of ~2 x depth load latencies and the
// card's rates are far off; the needed work (chip_smoke.py bvh_bound, from
// the stats variant's oracle walk) is small.  The design is the simplest
// exact one: many rays in flight (one thread each, 128 a block) to hide the
// latency, both children's 48 bytes adjacent, read with __ldg.  No ray
// sorting, no wide nodes, no shared-memory stack: B3 is the wide design.
//
// The stats variant (kStats) runs the same walk and also counts, per ray,
// the inner nodes visited, the leaf triangles tested and the stack's
// high-water mark, and flags what some ray read: a node's meta (the walk
// stood on it), a node's bounds (slab-tested as a child), a tri_v row and a
// vertex.  Given t_seed (a known closest t per ray) it also
// rejects a child whose t_near exceeds the seed (with a relative margin of
// 1e-5, so that a hit on a flat box's face is kept), acceptance otherwise
// unchanged: the oracle walk, whose counts are the work the query needs.

#include <cuda_runtime.h>

// The stats variant's arguments (ctypes mirrors this layout in
// ops/traverse_bvh.py); an entry point given a null Stats* runs the plain
// kernel.  It lies outside the anonymous namespace because the C entry
// points take it: nvcc gives a function whose parameter type has internal
// linkage internal linkage too, and the library would not export it.
struct Stats {
  const float* t_seed;  // (n,) or null
  int* counts;          // (n, 3): inner nodes, leaf triangles, stack high-water
  int* meta_seen;       // (nn,)
  int* bounds_seen;     // (nn,)
  int* tri_seen;        // (nt,)
  int* vert_seen;       // (nv,)
};

namespace {

constexpr int kBlock = 128;  // threads (rays) per block
constexpr float kInf = 1e9f;
constexpr float kSeedMargin = 1e-5f;  // relative margin of the oracle's seed cull
constexpr int kStatCount = 3;  // inner nodes, leaf triangles, stack high-water

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Tree {
  const float* bounds;  // (nn, 6)
  const int* meta;      // (nn, 2)
  const float* verts;   // (nv, 3)
  const int* tri_v;     // (nt, 4)
  int nn, nv, nt;
};

// The twin's slab test of node c: returns whether the child is accepted
// against t_limit (and, seeded, the oracle's cull), its t_near in `near`.
__device__ __forceinline__ bool child_hit(const Tree& tr, int c, const float o[3],
                                          const float inv[3], float t_limit,
                                          bool seeded, float seed, float& near) {
  const float* b = tr.bounds + static_cast<size_t>(c) * 6;
  float tn = 0.f, tf = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (__ldg(b + a) - o[a]) * inv[a];
    const float t1 = (__ldg(b + 3 + a) - o[a]) * inv[a];
    const float lo = nan_min(t0, t1);
    const float hi = nan_max(t0, t1);
    tn = a == 0 ? lo : nan_max(tn, lo);
    tf = a == 0 ? hi : nan_min(tf, hi);
  }
  near = tn;
  bool hit = (tf > 0.f) && (tf >= tn) && (tn < t_limit);
  if (seeded) hit = hit && (tn <= seed + kSeedMargin * fabsf(seed));
  return hit;
}

// Moller-Trumbore of triangle k (clamped for the read) in mt_uvt's order;
// true when accepted against t_best, with its t, u, v.  vert_seen (null
// but in the stats variant) flags the three vertices read.
__device__ __forceinline__ bool mt_test(const Tree& tr, int k, const float o[3],
                                        const float d[3], float t_best, float& t_out,
                                        float& u_out, float& v_out, int* vert_seen) {
  const int kc = min(max(k, 0), tr.nt - 1);
  const int* tv = tr.tri_v + static_cast<size_t>(kc) * 4;
  const int i0 = __ldg(tv), i1 = __ldg(tv + 1), i2 = __ldg(tv + 2);
  if (i0 < 0 || i0 >= tr.nv || i1 < 0 || i1 >= tr.nv || i2 < 0 || i2 >= tr.nv) __trap();
  if (vert_seen != nullptr) vert_seen[i0] = vert_seen[i1] = vert_seen[i2] = 1;
  const float* p0 = tr.verts + static_cast<size_t>(i0) * 3;
  const float* p1 = tr.verts + static_cast<size_t>(i1) * 3;
  const float* p2 = tr.verts + static_cast<size_t>(i2) * 3;
  const float v0x = __ldg(p0), v0y = __ldg(p0 + 1), v0z = __ldg(p0 + 2);
  const float e1x = __ldg(p1) - v0x, e1y = __ldg(p1 + 1) - v0y, e1z = __ldg(p1 + 2) - v0z;
  const float e2x = __ldg(p2) - v0x, e2y = __ldg(p2 + 1) - v0y, e2z = __ldg(p2 + 2) - v0z;
  // pv = d x e2; det = e1 . pv
  const float pvx = d[1] * e2z - d[2] * e2y;
  const float pvy = d[2] * e2x - d[0] * e2z;
  const float pvz = d[0] * e2y - d[1] * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
  // tv = o - v0; qv = tv x e1
  const float tvx = o[0] - v0x, tvy = o[1] - v0y, tvz = o[2] - v0z;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  t_out = t;
  u_out = u;
  v_out = v;
  return (u >= 0.0f) && (v >= 0.0f) && (1.0f - u - v >= 0.0f) && (t >= 0.0f) &&
         (t < t_best);
}

template <bool kAnyHit, bool kStats, int kStack>
__global__ void __launch_bounds__(kBlock) bvh2_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const bool* __restrict__ active, const float* __restrict__ t_max, Tree tr,
    int n, int max_leaf, int max_stack, float* __restrict__ out_t,
    int* __restrict__ out_tri, float* __restrict__ out_u, float* __restrict__ out_v,
    bool* __restrict__ out_occ, Stats stats) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = o_in[3 * i + a];
    d[a] = d_in[3 * i + a];
    inv[a] = 1.0f / d[a];
  }
  const float limit = kAnyHit ? t_max[i] : kInf;
  const bool seeded = kStats && stats.t_seed != nullptr;
  const float seed = seeded ? stats.t_seed[i] : kInf;
  float best_t = kInf, best_u = 0.f, best_v = 0.f;
  int best_tri = -1;
  bool occluded = false;
  int stack[kStack];
  int sp = 0;
  int n_inner = 0, n_tris = 0, sp_max = 0;
  const int last = tr.nn - 1;

  int node = active[i] ? 0 : -1;
  while (node > -1) {
    if (node > last) __trap();  // a child or stack entry past the table
    const int left = __ldg(tr.meta + 2 * static_cast<size_t>(node));
    const int rng = __ldg(tr.meta + 2 * static_cast<size_t>(node) + 1);
    if (kStats) stats.meta_seen[node] = 1;
    if (rng > 0) {  // leaf
      const int count = min(rng, max_leaf);
      for (int k = 0; k < count; ++k) {
        const int tri = left + k;
        if (kStats) {
          ++n_tris;
          stats.tri_seen[min(max(tri, 0), tr.nt - 1)] = 1;
        }
        float t, u, v;
        if (mt_test(tr, tri, o, d, kAnyHit ? limit : best_t, t, u, v,
                    kStats ? stats.vert_seen : nullptr)) {
          if (kAnyHit) {
            occluded = true;
            break;
          }
          best_t = t;
          best_u = u;
          best_v = v;
          best_tri = tri;
        }
      }
      if (kAnyHit && occluded) break;
    } else if (rng == 0) {  // inner
      if (kStats) ++n_inner;
      const int cl = static_cast<int>(min(max(static_cast<long long>(left), 0LL),
                                          static_cast<long long>(last)));
      const int cr = static_cast<int>(min(max(static_cast<long long>(left) + 1, 0LL),
                                          static_cast<long long>(last)));
      if (kStats) {
        stats.bounds_seen[cl] = 1;
        stats.bounds_seen[cr] = 1;
      }
      const float t_limit = kAnyHit ? limit : best_t;
      float near_l, near_r;
      const bool hit_l = child_hit(tr, cl, o, inv, t_limit, seeded, seed, near_l);
      const bool hit_r = child_hit(tr, cr, o, inv, t_limit, seeded, seed, near_r);
      const bool both = hit_l && hit_r;
      const bool right_first = both && (near_l > near_r);
      const int next = (hit_l && !right_first) ? left : (hit_r ? left + 1 : -1);
      if (both) {
        if (sp >= max_stack) __trap();  // deeper than the stack given
        stack[sp++] = right_first ? left : left + 1;
        if (kStats) sp_max = max(sp_max, sp);
      }
      if (next >= 0) {
        node = next;
        continue;
      }
    }
    node = sp > 0 ? stack[--sp] : -1;  // pop
  }

  if (kStats) {
    int* c = stats.counts + i * kStatCount;
    c[0] = n_inner;
    c[1] = n_tris;
    c[2] = sp_max;
  }
  if (kAnyHit) {
    out_occ[i] = occluded;
  } else {
    out_t[i] = best_t;
    out_tri[i] = best_t >= kInf ? -1 : best_tri;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

template <bool kAnyHit, bool kStats>
int launch(cudaStream_t s, const float* o, const float* d, const bool* active,
           const float* t_max, const Tree& tr, int n, int max_leaf, int max_stack,
           float* out_t, int* out_tri, float* out_u, float* out_v, bool* out_occ,
           Stats stats) {
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(n) + kBlock - 1) / kBlock);
#define BVH2_LAUNCH(S)                                                            \
  bvh2_kernel<kAnyHit, kStats, S><<<grid, kBlock, 0, s>>>(                        \
      o, d, active, t_max, tr, n, max_leaf, max_stack, out_t, out_tri, out_u,     \
      out_v, out_occ, stats)
  if (max_stack < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (max_stack <= 32) {
    BVH2_LAUNCH(32);
  } else if (max_stack <= 64) {
    BVH2_LAUNCH(64);
  } else if (max_stack <= 128) {
    BVH2_LAUNCH(128);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BVH2_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.  Every
// output is written for every ray.  max_stack: 1 to 128 entries.  stats:
// null for the plain kernel, else the stats variant's buffers, zeroed by the
// caller (see Stats).
extern "C" int bvh_closest(const float* o, const float* d, const bool* active,
                           const float* bounds, const int* meta, const float* verts,
                           const int* tri_v, int n, int nn, int nv, int nt, int max_leaf,
                           int max_stack, float* out_t, int* out_tri, float* out_u,
                           float* out_v, const Stats* stats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tree tr{bounds, meta, verts, tri_v, nn, nv, nt};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr)
    return launch<false, true>(s, o, d, active, nullptr, tr, n, max_leaf, max_stack, out_t,
                               out_tri, out_u, out_v, nullptr, *stats);
  return launch<false, false>(s, o, d, active, nullptr, tr, n, max_leaf, max_stack, out_t,
                              out_tri, out_u, out_v, nullptr, Stats{});
}

extern "C" int bvh_anyhit(const float* o, const float* d, const float* t_max,
                          const bool* active, const float* bounds, const int* meta,
                          const float* verts, const int* tri_v, int n, int nn, int nv,
                          int nt, int max_leaf, int max_stack, bool* out_occ,
                          const Stats* stats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tree tr{bounds, meta, verts, tri_v, nn, nv, nt};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr)
    return launch<true, true>(s, o, d, active, t_max, tr, n, max_leaf, max_stack, nullptr,
                              nullptr, nullptr, nullptr, out_occ, *stats);
  return launch<true, false>(s, o, d, active, t_max, tr, n, max_leaf, max_stack, nullptr,
                             nullptr, nullptr, nullptr, out_occ, Stats{});
}

extern "C" const char* bvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
