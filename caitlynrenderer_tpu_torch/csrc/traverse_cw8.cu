// CWBVH (8-wide compressed BVH) closest-hit and any-hit walk for Hopper
// (sm_90a).
//
// Replaces caitlynrenderer_tpu/ops/traverse_cw8.py:_make_kernel (entry
// points cw8_closest / cw8_anyhit).  Inputs: the node8 table of
// accel/cwbvh.py, 20 uint32 words per node (p.xyz as f32 bits; exponent
// bytes e_x e_y e_z and the inner mask; child_base; tri_base; 8 meta bytes;
// the children's quantized boxes, one byte per bound); the Baldwin-Weber
// planes of the cwbvh-ordered triangles in windows of 32 (pack_cw8:
// (W, 4, 128) f32, rows 0-2 plane vector, row 3 offset, columns n 0:32 |
// u 32:64 | v 64:96); the scene box.
//
// Eight lanes per ray (four rays per warp), one lane per child slot of a
// node: lane j of a ray's group tests slot j ^ front, where front is the
// ray's octant (build_cwbvh puts a child in the slot whose octant points
// from the parent's centre towards it, so the slot facing against the ray
// has key 0 and is visited first).  The ray clamps its bound to the scene
// box exit (_scene_exit_bound, term for term, with its inf and NaN).  A
// group visits one node per step: its eight lanes read the node's 80 bytes
// (five 16-byte words; the lanes share one request), each decodes its
// child's box (bound = p + q * 2^(e-127)), pads it by 1e-5 (1 + |bound|) and
// skips it only when the ray misses it or enters it strictly after best t
// (1 + 1e-5): without the padding, f32 rounding on a flat box (the cornell
// walls) would lose hits.  A ballot over the group gives, in key order, the
// inner children to enter: they become the next node group, visited in the
// ray's octant order.  A lane whose child is a leaf tests that child's <= 3
// triangles (triangle k = window k / 32, column k % 32) in place:
//   t = -(((o.x n.x + o.y n.y) + o.z n.z) + dn) / ((d.x n.x + d.y n.y) + d.z n.z)
//   u = (((o.x u.x + o.y u.y) + o.z u.z) + du) + t ((d.x u.x + d.y u.y) + d.z u.z)
//   v likewise,
// accepting u >= 0, v >= 0, u + v <= 1, t >= 0, t < t_lim.  These are the
// plain twin's expressions in its order (ops/traverse_cw8.py); built with
// --fmad=false and without fast math, kernel and twin agree bit for bit, and
// the twin, which sweeps every window, is the proof that the culling never
// drops a hit.  Closest merges the lanes' candidates by a butterfly of
// shuffles under the lexicographic minimum of (t, tri), so the result does
// not depend on the visiting order, and every lane holds the group's best t
// before the next node's cull; any-hit stops the group at its first
// accepted triangle (a ballot).
//
// A stack entry is a node group: the first index of a node's inner
// children, its inner mask, and the children still to visit.  A tree of D
// levels needs D - 1 entries.  The stack lives in registers spread over the
// group's lanes (entry e in lane e % 8, register e / 8): a push is one
// lane's store, a pop one shuffle.  The wrapper instantiates it from the
// depth the packer computed (8, 16 or 24 entries) and raises for a tree
// deeper than 22 levels; the stack is never clamped.  A malformed table (a
// child or triangle index out of range, or a tree deeper than the depth it
// was given) traps instead of reading out of bounds.
//
// What bounds it on an H100: each level of the walk is a dependent load -
// the node's address comes from its parent's words - and the leaf planes are
// a second one, so the walk is bound by latency; the work the query needs
// (chip_smoke.py cw8_bound, from the stats variant's oracle walk) is far
// below the card's rates.  Eight lanes per ray test a node's children and a
// leaf's triangles at once (v1 tested them one after another in one
// thread), keep the stack out of local memory, and put eight times the
// threads in flight at the main path's 65,536 rays.  Every lane stays in
// the loop until its whole warp is done, so every shuffle and ballot sees
// the whole warp: a finished group steps idle.  Not carried over from the
// TPU kernel: the coherence sort, the 128-ray consensus walk, the DMA ring,
// SMEM cursors, window queue and CHUNK cap.
//
// The stats variant (kStats) runs the same walk and also counts, per ray,
// the nodes visited, the child boxes tested, the leaf triangles tested and
// the stack's high-water mark, and flags the nodes and plane columns some
// ray touched (2 for a column whose u/v were evaluated).  Given t_seed (a
// known closest t per ray), its boxes are culled against min(best t,
// t_seed), acceptance unchanged: the oracle walk, whose counts are the work
// the query needs.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // threads per block
constexpr int kGroup = 8;  // lanes per ray, one per child slot
constexpr int kRaysPerBlock = kBlock / kGroup;
constexpr int kWinCols = 128;  // columns of a plane window row
constexpr float kInf = 1e9f;
constexpr float kPad = 1e-5f;  // box padding, relative and absolute
constexpr float kCullMargin = 1e-5f;  // relative margin of the entry-t cull
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kStatCount = 4;  // nodes, child boxes, leaf triangles, stack high-water

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// _scene_exit_bound: min(t_lim, exit t of the scene box), where a ray that
// misses the box (or meets 0 * inf = NaN) gets -INF.
__device__ float exit_clamp(float t_lim, const float o[3], const float d[3],
                            const float* __restrict__ box) {
  float tn = 0.f, tf = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float inv = 1.0f / d[a];
    const float t0 = (box[a] - o[a]) * inv;
    const float t1 = (box[3 + a] - o[a]) * inv;
    const float lo = nan_min(t0, t1);
    const float hi = nan_max(t0, t1);
    tn = a == 0 ? lo : nan_max(tn, lo);
    tf = a == 0 ? hi : nan_min(tf, hi);
  }
  const bool hit = (tf > 0.f) && (tf >= tn);
  const float exit_t =
      hit ? tf * static_cast<float>(1.0 + 1e-5) + 1e-5f : -kInf;
  return fminf(t_lim, exit_t);
}

__device__ __forceinline__ unsigned byte_of(unsigned w, int i) {
  return (w >> (8 * i)) & 0xFFu;
}

// Baldwin-Weber test of triangle k against the ray.  Closest: keeps the
// lexicographic minimum of (t, tri) in best_t / best_tri.  Any-hit: returns
// true at an accepted triangle.  col_seen (stats only): 1 where t was
// evaluated, 2 where u/v were too.
template <bool kAnyHit, bool kStats>
__device__ __forceinline__ bool test_triangle(const float* __restrict__ planes,
                                              int k, const float o[3],
                                              const float d[3], float t_lim,
                                              float& best_t, int& best_tri,
                                              int* __restrict__ col_seen) {
  const float* p =
      planes + static_cast<size_t>(k >> 5) * 4 * kWinCols + (k & 31);
  const float nx = __ldg(p), ny = __ldg(p + kWinCols);
  const float nz = __ldg(p + 2 * kWinCols), dn = __ldg(p + 3 * kWinCols);
  const float an = ((o[0] * nx + o[1] * ny) + o[2] * nz) + dn;
  const float bn = (d[0] * nx + d[1] * ny) + d[2] * nz;
  const float t = -an / bn;
  // Cannot be accepted or cannot win (NaN fails too).
  const bool go_on = t >= 0.f && t < t_lim && t <= best_t;
  if (kStats) atomicMax(col_seen + k, go_on ? 2 : 1);
  if (!go_on) return false;
  const float* pu = p + 32;
  const float ux = __ldg(pu), uy = __ldg(pu + kWinCols);
  const float uz = __ldg(pu + 2 * kWinCols), du = __ldg(pu + 3 * kWinCols);
  const float u = (((o[0] * ux + o[1] * uy) + o[2] * uz) + du) +
                  t * ((d[0] * ux + d[1] * uy) + d[2] * uz);
  const float* pv = p + 64;
  const float vx = __ldg(pv), vy = __ldg(pv + kWinCols);
  const float vz = __ldg(pv + 2 * kWinCols), dv = __ldg(pv + 3 * kWinCols);
  const float v = (((o[0] * vx + o[1] * vy) + o[2] * vz) + dv) +
                  t * ((d[0] * vx + d[1] * vy) + d[2] * vz);
  if (!(u >= 0.f && v >= 0.f && u + v <= 1.0f)) return false;
  if (kAnyHit) {
    best_tri = k;
    return true;
  }
  // t <= best_t here; with no hit yet, best_t = t_lim > t.
  if (t < best_t || k < best_tri) {
    best_t = t;
    best_tri = k;
  }
  return false;
}

// Conservative slab test of a padded box: true unless the ray misses it or
// enters it after `best` (with the relative margin).  inv = 1 / d with |d|
// clamped to at least 1e-12, so every term is finite.
__device__ __forceinline__ bool box_visit(const float lo_in[3],
                                          const float hi_in[3],
                                          const float o[3], const float inv[3],
                                          float best) {
  float tn = 0.f, tf = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float lo = lo_in[a], hi = hi_in[a];
    const float t0 = (lo - kPad * (1.f + fabsf(lo)) - o[a]) * inv[a];
    const float t1 = (hi + kPad * (1.f + fabsf(hi)) - o[a]) * inv[a];
    tn = a == 0 ? fminf(t0, t1) : fmaxf(tn, fminf(t0, t1));
    tf = a == 0 ? fmaxf(t0, t1) : fminf(tf, fmaxf(t0, t1));
  }
  return tf >= tn && tf >= 0.f && fmaxf(tn, 0.f) <= best + kCullMargin * best;
}

struct Stats {
  const float* t_seed;  // (n,) or null
  int* counts;          // (n, kStatCount)
  int* node_seen;       // (n8,)
  int* col_seen;        // (32 * nwin,)
};

template <bool kAnyHit, bool kStats, int kStack>
__global__ void __launch_bounds__(kBlock) cw8_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const bool* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ box, const uint4* __restrict__ nodes,
    const float* __restrict__ planes, int n, int n8, int n_cols,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    int* __restrict__ out_win, bool* __restrict__ out_occ, Stats stats) {
  constexpr int kPer = kStack / kGroup;  // stack entries held by each lane
  const int lane = threadIdx.x & 31;
  const int j = lane & (kGroup - 1);  // this lane's key
  const int gbase = lane & ~(kGroup - 1);
  const long long i =
      static_cast<long long>(blockIdx.x) * kRaysPerBlock + threadIdx.x / kGroup;
  const bool in_range = i < n;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {1.f, 1.f, 1.f};
  float t_lim = -kInf;
  float seed = kInf;
  if (in_range) {
    for (int a = 0; a < 3; ++a) {
      o[a] = o_in[3 * i + a];
      d[a] = d_in[3 * i + a];
    }
    if (active[i]) t_lim = kAnyHit ? t_max[i] : kInf;
    t_lim = exit_clamp(t_lim, o, d, box);
    if (kStats && stats.t_seed != nullptr) seed = stats.t_seed[i];
  }
  float best_t = t_lim;
  int best_tri = -1;
  // Nothing is accepted unless 0 <= t < t_lim: dead lanes are done at once.
  bool done = !(t_lim > 0.f);
  float inv[3];
  for (int a = 0; a < 3; ++a) {
    const float da =
        fabsf(d[a]) < 1e-12f ? (d[a] < 0.f ? -1e-12f : 1e-12f) : d[a];
    inv[a] = 1.0f / da;
  }
  // Slot s points towards -x, -y, -z where its bits 4, 2, 1 are set.  Key
  // k = slot ^ front orders a group's children: key 0 is the slot facing
  // against the ray, visited first.
  const int front =
      7 ^ (((d[0] < 0.f) << 2) | ((d[1] < 0.f) << 1) | (d[2] < 0.f));
  const int my_slot = j ^ front;
  int st_base[kPer];
  unsigned st_mask[kPer];  // inner mask | pending keys << 8
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    st_base[k] = 0;
    st_mask[k] = 0u;
  }
  int sp = 0;
  // The current group; the virtual root holds node 0 in slot 0.
  int base = 0;
  unsigned imask = 1u;
  unsigned pend = 1u << front;
  int n_nodes = 0, n_boxes = 0, n_tris = 0, sp_max = 0;

  while (true) {
    // An exhausted group pops the next; one pop suffices, since an entry is
    // pushed only with children pending.
    const bool pop = !done && pend == 0u;
    if (pop && sp == 0) done = true;
    const int e = (pop && sp > 0) ? sp - 1 : 0;
    int sb = 0;
    unsigned sm = 0u;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k == (e >> 3)) {
        sb = st_base[k];
        sm = st_mask[k];
      }
    }
    sb = __shfl_sync(kFull, sb, gbase + (e & 7));
    sm = __shfl_sync(kFull, sm, gbase + (e & 7));
    if (!done && pop) {
      --sp;
      base = sb;
      imask = sm & 0xFFu;
      pend = sm >> 8;
    }
    if (__all_sync(kFull, done)) break;

    // The next child of the current group; push the rest.
    int child = 0;
    if (!done) {
      const int slot = (__ffs(pend) - 1) ^ front;
      pend &= pend - 1u;
      child = base + __popc(imask & ((1u << slot) - 1u));
      if (pend != 0u) {
        if (sp == kStack) __trap();  // deeper than the depth given
        if (j == (sp & 7)) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            if (k == (sp >> 3)) {
              st_base[k] = base;
              st_mask[k] = imask | (pend << 8);
            }
          }
        }
        ++sp;
        if (kStats) sp_max = max(sp_max, sp);
      }
      if (child < 0 || child >= n8) __trap();
    }

    // Visit the node: lane j tests child slot j ^ front.
    bool enter = false, tested = false, lane_hit = false;
    float c_t = best_t;
    int c_tri = best_tri;
    unsigned next_base = 0u, next_imask = 0u;
    if (!done) {
      const uint4* np = nodes + static_cast<size_t>(child) * 5;
      const uint4 q0 = __ldg(np), q1 = __ldg(np + 1), q2 = __ldg(np + 2);
      const uint4 q3 = __ldg(np + 3), q4 = __ldg(np + 4);
      next_base = q1.x;
      next_imask = q0.w >> 24;
      if (kStats && j == 0) {
        ++n_nodes;
        stats.node_seen[child] = 1;
      }
      const int h = my_slot >> 2, b = my_slot & 3;
      const unsigned m = byte_of(h ? q1.w : q1.z, b);
      if (m != 0u) {
        tested = true;
        const float p[3] = {__uint_as_float(q0.x), __uint_as_float(q0.y),
                            __uint_as_float(q0.z)};
        const float scale[3] = {__uint_as_float(byte_of(q0.w, 0) << 23),
                                __uint_as_float(byte_of(q0.w, 1) << 23),
                                __uint_as_float(byte_of(q0.w, 2) << 23)};
        // q_lo / q_hi words of children 0-3 (x, z) and 4-7 (y, w), per axis.
        const unsigned q_lo[3] = {h ? q2.y : q2.x, h ? q3.y : q3.x, h ? q4.y : q4.x};
        const unsigned q_hi[3] = {h ? q2.w : q2.z, h ? q3.w : q3.z, h ? q4.w : q4.z};
        float lo[3], hi[3];
        for (int a = 0; a < 3; ++a) {
          lo[a] = p[a] + static_cast<float>(byte_of(q_lo[a], b)) * scale[a];
          hi[a] = p[a] + static_cast<float>(byte_of(q_hi[a], b)) * scale[a];
        }
        const float cull = kStats ? fminf(best_t, seed) : best_t;
        if (box_visit(lo, hi, o, inv, cull)) {
          if ((m & 0x18u) == 0x18u) {  // inner child
            enter = true;
          } else {
            // Leaf: unary count in bits 5-7, first-triangle offset in bits 0-4.
            const int first = static_cast<int>(q1.y) + static_cast<int>(m & 0x1Fu);
            const int count = __popc(m >> 5);
            for (int c = 0; c < count; ++c) {
              const int k = first + c;
              if (k < 0 || k >= n_cols) __trap();
              if (kStats) ++n_tris;
              if (test_triangle<kAnyHit, kStats>(planes, k, o, d, t_lim, c_t,
                                                 c_tri, stats.col_seen)) {
                lane_hit = true;
                break;
              }
            }
          }
        }
      }
    }
    if (kStats) n_boxes += tested;
    const unsigned next = (__ballot_sync(kFull, enter) >> gbase) & 0xFFu;
    if (kAnyHit) {
      if ((__ballot_sync(kFull, lane_hit) >> gbase) & 0xFFu) {
        done = true;
        best_tri = 0;  // occluded
      }
    } else {
      // The group's best: the lexicographic minimum of the lanes' (t, tri).
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kFull, c_t, off);
        const int otr = __shfl_xor_sync(kFull, c_tri, off);
        if (otr >= 0 && (c_tri < 0 || ot < c_t || (ot == c_t && otr < c_tri))) {
          c_t = ot;
          c_tri = otr;
        }
      }
      best_t = c_t;
      best_tri = c_tri;
    }
    if (!done) {
      base = static_cast<int>(next_base);
      imask = next_imask;
      pend = next;
    }
  }

  if (kStats) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      n_boxes += __shfl_xor_sync(kFull, n_boxes, off);
      n_tris += __shfl_xor_sync(kFull, n_tris, off);
    }
  }
  if (!in_range || j != 0) return;
  if (kStats) {
    int* c = stats.counts + i * kStatCount;
    c[0] = n_nodes;
    c[1] = n_boxes;
    c[2] = n_tris;
    c[3] = sp_max;
  }
  if (kAnyHit) {
    out_occ[i] = best_tri >= 0;
  } else {
    const bool miss = best_tri < 0;
    out_t[i] = miss ? kInf : best_t;
    out_tri[i] = best_tri;
    out_win[i] = miss ? -1 : best_tri >> 5;
  }
}

template <bool kAnyHit, bool kStats>
int launch(int stack, cudaStream_t s, const float* o, const float* d,
           const bool* active, const float* t_max, const float* box,
           const void* nodes, const float* planes, int n, int n8, int nwin,
           float* out_t, int* out_tri, int* out_win, bool* out_occ,
           Stats stats) {
  const uint4* nd = static_cast<const uint4*>(nodes);
  const int n_cols = 32 * nwin;
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(n) + kRaysPerBlock - 1) / kRaysPerBlock);
#define CW8_LAUNCH(S)                                                        \
  cw8_kernel<kAnyHit, kStats, S><<<grid, kBlock, 0, s>>>(                    \
      o, d, active, t_max, box, nd, planes, n, n8, n_cols, out_t, out_tri,   \
      out_win, out_occ, stats)
  switch (stack) {
    case 8: CW8_LAUNCH(8); break;
    case 16: CW8_LAUNCH(16); break;
    case 24: CW8_LAUNCH(24); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CW8_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.
// box: (6,) scene bbox min | max; nodes: (n8, 20) 32-bit words, 16-byte
// aligned; planes: (nwin, 4, 128); stack: 8, 16 or 24 entries.  The _stats
// entry points add t_seed ((n,) f32 or null), counts ((n, 4) i32),
// node_seen ((n8,) i32) and col_seen ((32 nwin,) i32), zeroed by the caller.
extern "C" int cw8_closest(const float* o, const float* d, const bool* active,
                           const float* box, const void* nodes,
                           const float* planes, int n, int n8, int nwin,
                           int stack, float* out_t, int* out_tri, int* out_win,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<false, false>(stack, static_cast<cudaStream_t>(stream), o, d,
                              active, nullptr, box, nodes, planes, n, n8, nwin,
                              out_t, out_tri, out_win, nullptr, Stats{});
}

extern "C" int cw8_anyhit(const float* o, const float* d, const float* t_max,
                          const bool* active, const float* box,
                          const void* nodes, const float* planes, int n, int n8,
                          int nwin, int stack, bool* out_occ, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<true, false>(stack, static_cast<cudaStream_t>(stream), o, d,
                             active, t_max, box, nodes, planes, n, n8, nwin,
                             nullptr, nullptr, nullptr, out_occ, Stats{});
}

extern "C" int cw8_closest_stats(const float* o, const float* d,
                                 const bool* active, const float* box,
                                 const void* nodes, const float* planes, int n,
                                 int n8, int nwin, int stack, float* out_t,
                                 int* out_tri, int* out_win,
                                 const float* t_seed, int* counts,
                                 int* node_seen, int* col_seen, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<false, true>(stack, static_cast<cudaStream_t>(stream), o, d,
                             active, nullptr, box, nodes, planes, n, n8, nwin,
                             out_t, out_tri, out_win, nullptr,
                             Stats{t_seed, counts, node_seen, col_seen});
}

extern "C" int cw8_anyhit_stats(const float* o, const float* d,
                                const float* t_max, const bool* active,
                                const float* box, const void* nodes,
                                const float* planes, int n, int n8, int nwin,
                                int stack, bool* out_occ, const float* t_seed,
                                int* counts, int* node_seen, int* col_seen,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<true, true>(stack, static_cast<cudaStream_t>(stream), o, d,
                            active, t_max, box, nodes, planes, n, n8, nwin,
                            nullptr, nullptr, nullptr, out_occ,
                            Stats{t_seed, counts, node_seen, col_seen});
}

extern "C" const char* cw8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
