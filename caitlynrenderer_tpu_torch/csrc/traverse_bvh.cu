// Binary-BVH closest-hit and any-hit walk for Hopper (sm_90a): kernel B4, v2.
//
// Replaces caitlynrenderer_tpu/ops/traverse_xla.py:traverse_closest (:52)
// and :traverse_anyhit (:160), the reference's XLA stack machine (a
// lax.while_loop over the whole batch, not a Pallas kernel), for the "bvh2"
// and "sbvh" accelerators.  Inputs: the FlatBVH of accel/bvh.py packed by
// ops/traverse_bvh.pack_bvh_pairs into child-pair records, and the
// leaf-ordered triangles as the (T, 9) v0 | e1 | e2 slab (scene.DeviceScene
// .tris9).  A record is 64 bytes, four float4: both children's boxes (min |
// max, 12 f32) and both children's meta (left child or first triangle, and
// the triangle count, 0 at an inner node; 4 i32 stored as their bits).
// Record k holds nodes 2k - 1 and 2k of the FlatBVH's BFS order, so the
// children (left, left + 1) of an inner node are record (left + 1) / 2; record
// 0 holds the root in its second slot.
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
//     (closest: the best t so far; any-hit: t_max);
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
// math, every multiply and add is rounded as the twin rounds it.  The
// records are copies of the FlatBVH's floats and tris9's e1 = p1 - p0 is the
// subtraction v1 made in the kernel, so t, tri, u, v and occlusion equal the
// twin's bit for bit.
//
// The stack holds max_stack entries of (left, count), 8 bytes each
// (scene.required_stack: tree depth + 1, at least 32) in local memory; the
// kernel is instantiated for 32, 64 and 128 entries and the wrapper raises
// above that (render/integrator._check_stack names the limit for a deeper
// tree).  A push past max_stack, or a record index past the table, traps:
// never clamped, never read back (the twin raises ValueError there).  The
// packer refuses, at upload, a tree whose pairs do not start at odd ids.
//
// What bounds it on an H100.  The needed work (chip_smoke.py bvh_bound, from
// the stats variant's oracle walk) is a few MB and ~0.002-0.006 ms; the
// walk takes ~24 inner nodes and ~5 triangles a primary ray, each step a
// load the next one depends on, and a warp runs to its longest ray (p99 54
// nodes, max ~100).  At the main path's 65,536 rays every warp is resident
// at once (~15.5 an SM), so the time is the slowest warps' chains: per step
// a load latency plus the instructions of ~4 warps a scheduler, the
// divergent loads (32 lanes, 32 lines) among them.  v1 paid two
// dependent loads a node (meta, then the children's boxes) and two a
// triangle (tri_v, then the vertices), all as 4-byte scalar loads.  v2:
//   - child-pair records: one 64-byte record a level, four float4
//     ld.global.nc issued together; the node stood on already carries its
//     children's meta, and a stack entry carries the popped node's, so a
//     descent or a pop needs no second load;
//   - triangles from tris9: one set of nine independent loads a triangle
//     (before: tri_v, then the vertices), a leaf's triangles loaded four at
//     a time; a closest query computes the four tests together and accepts
//     them in the leaf's order, an any-hit query tests them one by one and
//     stops at the first hit;
//   - the walk as two loops, inner nodes, then a leaf ("while-while",
//     Aila and Laine, HPG 2009), so lanes at leaves and lanes at inner
//     nodes do not alternate step by step;
//   - min.NaN / max.NaN, one instruction each in place of a NaN test and a
//     select.
// Measured and left out (times in PERF.md; the builds are under the git
// tag b4-design-builds): persistent warps fetching 32 rays
// from a counter (with every warp resident there is nothing to balance,
// and beside the while-while walk they ran ~2x slower), the top of the
// tree in shared memory through cp.async.bulk (slower with every walk it
// was paired with), and loading both children's records ahead of the slab
// test (twice the loads).  No ray sorting and no wide nodes (B3 is the wide
// design): every ray's sequence of tests stays v1's.
//
// The stats variant (kStats) runs the same walk and also counts, per ray,
// the inner nodes visited, the leaf triangles tested and the stack's
// high-water mark, and flags by FlatBVH node id what some ray read in the
// FlatBVH's own layout: a node's meta (the walk stood on it), a node's bounds
// (slab-tested as a child), a tri_v row and a vertex.  So the bound read
// from them does not follow the records' layout.  Given t_seed (a known
// closest t per ray) it also rejects a child whose t_near exceeds the seed
// (with a relative margin of 1e-5, so that a hit on a flat box's face is
// kept), acceptance otherwise unchanged: the oracle walk, whose counts are
// the work the query needs.

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
constexpr int kBatch = 4;    // a leaf's triangles loaded together
constexpr float kInf = 1e9f;
constexpr float kSeedMargin = 1e-5f;  // relative margin of the oracle's seed cull
constexpr int kStatCount = 3;  // inner nodes, leaf triangles, stack high-water

// min and max that return NaN where either input is NaN.  min.NaN gives
// the canonical NaN, another payload than a select would: t_near and t_far
// only meet comparisons, where every NaN is false.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Query {
  const float* o;       // (n, 3)
  const float* d;       // (n, 3)
  const bool* active;   // (n,)
  const float* t_max;   // (n,), any-hit
  int n, max_leaf, max_stack;
  float* out_t;
  int* out_tri;
  float* out_u;
  float* out_v;
  bool* out_occ;
};

struct Tree {
  const float4* recs;  // (n_recs, 4): child-pair records
  const float* tris9;  // (nt, 9): v0 | e1 | e2
  const int* tri_v;    // (nt, 4): the stats variant's vertex flags
  int n_recs, nt;
};

// The twin's slab test of a child box b (min | max): returns whether the
// child is accepted against t_limit (and, seeded, the oracle's cull), its
// t_near in `near`.
__device__ __forceinline__ bool child_hit(const float b[6], const float o[3],
                                          const float inv[3], float t_limit, bool seeded,
                                          float seed, float& near) {
  float tn = 0.f, tf = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (b[a] - o[a]) * inv[a];
    const float t1 = (b[3 + a] - o[a]) * inv[a];
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

// Triangle kc (already clamped) as v0 | e1 | e2: nine independent loads.
__device__ __forceinline__ void load_tri(const Tree& tr, int kc, float (&w)[9]) {
  const float* r = tr.tris9 + static_cast<size_t>(kc) * 9;
#pragma unroll
  for (int j = 0; j < 9; ++j) w[j] = __ldg(r + j);
}

// Moller-Trumbore of triangle w = v0 | e1 | e2 in mt_uvt's order: its t, u,
// v, and whether it passes every acceptance test but t < t_best, which the
// caller applies in the leaf's order.
__device__ __forceinline__ bool mt_test(const float (&w)[9], const float o[3],
                                        const float d[3], float& t_out, float& u_out,
                                        float& v_out) {
  const float v0x = w[0], v0y = w[1], v0z = w[2];
  const float e1x = w[3], e1y = w[4], e1z = w[5];
  const float e2x = w[6], e2y = w[7], e2z = w[8];
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
  return (u >= 0.0f) && (v >= 0.0f) && (1.0f - u - v >= 0.0f) && (t >= 0.0f);
}

// Record k, as four float4 loads issued together.
__device__ __forceinline__ void fetch(const Tree& tr, int k, float4 (&r)[4]) {
  if (k >= tr.n_recs) __trap();  // a child past the table
  const float4* g = tr.recs + 4 * static_cast<size_t>(k);
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = __ldg(g + j);
}

// One ray's walk.
template <bool kAnyHit, bool kStats, int kStack>
__device__ __forceinline__ void trace(const Query& q, const Tree& tr, int i,
                                      const Stats& stats) {
  float o[3], d[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = q.o[3 * static_cast<size_t>(i) + a];
    d[a] = q.d[3 * static_cast<size_t>(i) + a];
    inv[a] = 1.0f / d[a];
  }
  const float limit = kAnyHit ? q.t_max[i] : kInf;
  const bool seeded = kStats && stats.t_seed != nullptr;
  const float seed = seeded ? stats.t_seed[i] : kInf;
  float best_t = kInf, best_u = 0.f, best_v = 0.f;
  int best_tri = -1;
  bool occluded = false;
  int2 stack[kStack];               // (left, count) of each pushed node
  int ids[kStats ? kStack : 1];     // their FlatBVH ids, for the stats' flags
  int sp = 0;
  int n_inner = 0, n_tris = 0, sp_max = 0;

  int2 cur = make_int2(0, 0);  // the node stood on: (left, count)
  int id = 0;                  // its FlatBVH id (stats only)
  bool live = q.active[i];
  if (live) {
    float4 r[4];
    fetch(tr, 0, r);  // the root: record 0's second slot
    cur = make_int2(__float_as_int(r[3].z), __float_as_int(r[3].w));
  }

  auto stand = [&]() {
    if (kStats) stats.meta_seen[id] = 1;
  };
  // Pops into cur; false when the stack is empty.
  auto pop = [&]() -> bool {
    if (sp == 0) return false;
    --sp;
    cur = stack[sp];
    if (kStats) id = ids[sp];
    return true;
  };
  // The inner node cur: slab-tests both children, pushes the farther when
  // both are accepted; true when it moved to a child, false to pop.
  auto inner = [&]() -> bool {
    const int left = cur.x;
    if (kStats) {
      ++n_inner;
      stats.bounds_seen[left] = 1;
      stats.bounds_seen[left + 1] = 1;
    }
    float4 r[4];
    fetch(tr, (left + 1) >> 1, r);
    const float box_l[6] = {r[0].x, r[0].y, r[0].z, r[0].w, r[1].x, r[1].y};
    const float box_r[6] = {r[1].z, r[1].w, r[2].x, r[2].y, r[2].z, r[2].w};
    const int2 meta_l = make_int2(__float_as_int(r[3].x), __float_as_int(r[3].y));
    const int2 meta_r = make_int2(__float_as_int(r[3].z), __float_as_int(r[3].w));
    const float t_limit = kAnyHit ? limit : best_t;
    float near_l, near_r;
    const bool hit_l = child_hit(box_l, o, inv, t_limit, seeded, seed, near_l);
    const bool hit_r = child_hit(box_r, o, inv, t_limit, seeded, seed, near_r);
    const bool both = hit_l && hit_r;
    const bool right_first = both && (near_l > near_r);
    if (both) {
      if (sp >= q.max_stack) __trap();  // deeper than the stack given
      stack[sp] = right_first ? meta_l : meta_r;
      if (kStats) ids[sp] = right_first ? left : left + 1;
      ++sp;
      if (kStats) sp_max = max(sp_max, sp);
    }
    if (hit_l && !right_first) {
      cur = meta_l;
      id = left;
      return true;
    }
    if (hit_r) {
      cur = meta_r;
      id = left + 1;
      return true;
    }
    return false;
  };
  // The leaf cur; true when an any-hit query is answered.
  auto leaf = [&]() -> bool {
    const int count = min(cur.y, q.max_leaf);
    for (int k0 = 0; k0 < count; k0 += kBatch) {
      // Up to kBatch triangles loaded together; a closest query tests them
      // together too, then accepts them in the leaf's order against the
      // best t so far.
      float w[kBatch][9], t[kBatch], u[kBatch], v[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (k0 + j < count) load_tri(tr, min(max(cur.x + k0 + j, 0), tr.nt - 1), w[j]);
      if constexpr (!kAnyHit) {  // any-hit tests one at a time: the first hit ends it
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          ok[j] = k0 + j < count && mt_test(w[j], o, d, t[j], u[j], v[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (k0 + j >= count) break;
        if constexpr (kAnyHit) ok[j] = mt_test(w[j], o, d, t[j], u[j], v[j]);
        const int tri = cur.x + k0 + j;
        if (kStats) {
          const int kc = min(max(tri, 0), tr.nt - 1);
          ++n_tris;
          stats.tri_seen[kc] = 1;
          const int* tv = tr.tri_v + static_cast<size_t>(kc) * 4;
          stats.vert_seen[tv[0]] = stats.vert_seen[tv[1]] = stats.vert_seen[tv[2]] = 1;
        }
        if (ok[j] && t[j] < (kAnyHit ? limit : best_t)) {
          if (kAnyHit) {
            occluded = true;
            return true;
          }
          best_t = t[j];
          best_u = u[j];
          best_v = v[j];
          best_tri = tri;
        }
      }
    }
    return false;
  };

  if (live) stand();
  while (live) {
    while (cur.y == 0) {  // inner nodes
      if (!inner() && !(live = pop())) break;
      stand();
    }
    if (!live) break;
    if (cur.y > 0 && leaf()) break;  // a count < 0 is no node: pop
    if ((live = pop())) stand();
  }

  if (kStats) {
    int* c = stats.counts + static_cast<size_t>(i) * kStatCount;
    c[0] = n_inner;
    c[1] = n_tris;
    c[2] = sp_max;
  }
  if (kAnyHit) {
    q.out_occ[i] = occluded;
  } else {
    q.out_t[i] = best_t;
    q.out_tri[i] = best_t >= kInf ? -1 : best_tri;
    q.out_u[i] = best_u;
    q.out_v[i] = best_v;
  }
}

template <bool kAnyHit, bool kStats, int kStack>
__global__ void __launch_bounds__(kBlock) bvh2_kernel(Query q, Tree tr, Stats stats) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i < q.n) trace<kAnyHit, kStats, kStack>(q, tr, static_cast<int>(i), stats);
}

template <bool kAnyHit, bool kStats, int kStack>
int launch_one(cudaStream_t s, const Query& q, const Tree& tr, const Stats& stats) {
  const unsigned grid = static_cast<unsigned>((static_cast<long long>(q.n) + kBlock - 1) / kBlock);
  bvh2_kernel<kAnyHit, kStats, kStack><<<grid, kBlock, 0, s>>>(q, tr, stats);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAnyHit, bool kStats>
int launch(cudaStream_t s, const Query& q, const Tree& tr, const Stats& stats) {
  if (q.max_stack < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q.max_stack <= 32) return launch_one<kAnyHit, kStats, 32>(s, q, tr, stats);
  if (q.max_stack <= 64) return launch_one<kAnyHit, kStats, 64>(s, q, tr, stats);
  if (q.max_stack <= 128) return launch_one<kAnyHit, kStats, 128>(s, q, tr, stats);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.  Every
// output is written for every ray.
// pairs: (n_recs, 16) f32 records; tris9: (nt, 9) f32; tri_v: (nt, 4) i32,
// read only by the stats variant's vertex flags.
// max_stack: 1 to 128 entries.  stats: null for the plain kernel, else the
// stats variant's buffers, zeroed by the caller (see Stats).
extern "C" int bvh_closest(const float* o, const float* d, const bool* active,
                           const float* pairs, const float* tris9, const int* tri_v, int n,
                           int n_recs, int nt, int max_leaf, int max_stack, float* out_t,
                           int* out_tri, float* out_u, float* out_v, const Stats* stats,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tree tr{reinterpret_cast<const float4*>(pairs), tris9, tri_v, n_recs, nt};
  const Query q{o, d, active, nullptr, n, max_leaf, max_stack,
                out_t, out_tri, out_u, out_v, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr) return launch<false, true>(s, q, tr, *stats);
  return launch<false, false>(s, q, tr, Stats{});
}

extern "C" int bvh_anyhit(const float* o, const float* d, const float* t_max,
                          const bool* active, const float* pairs, const float* tris9,
                          const int* tri_v, int n, int n_recs, int nt, int max_leaf,
                          int max_stack, bool* out_occ, const Stats* stats, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tree tr{reinterpret_cast<const float4*>(pairs), tris9, tri_v, n_recs, nt};
  const Query q{o, d, active, t_max, n, max_leaf, max_stack,
                nullptr, nullptr, nullptr, nullptr, out_occ};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr) return launch<true, true>(s, q, tr, *stats);
  return launch<true, false>(s, q, tr, Stats{});
}

extern "C" const char* bvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
