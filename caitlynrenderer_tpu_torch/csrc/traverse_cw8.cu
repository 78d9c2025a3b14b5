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
// One thread per ray, each with its own stack, as in Ylitie et al. 2017 and
// the reference's per-fragment walk.  The ray clamps its bound to the scene
// box exit (_scene_exit_bound, term for term, with its inf and NaN).  A
// stack entry is a node group: the first index of a node's inner children,
// its inner mask, and the children still to visit.  A visit fetches the
// node's 80 bytes in five 16-byte loads and decodes its 8 children's boxes
// (bound = p + q * 2^(e-127)).  Each box is padded by 1e-5 (1 + |bound|)
// and a child is skipped only when the ray misses it or enters it strictly
// after best t (1 + 1e-5): without the padding, f32 rounding on a flat box
// (the cornell walls) would lose hits.  The inner children that remain
// become the next group, visited in the ray's octant order (build_cwbvh
// puts a child in the slot whose octant points from the parent's centre
// towards it, so the slot facing against the ray comes first); a leaf
// child's <= 3 triangles (triangle k = window k / 32, column k % 32) are
// tested at once:
//   t = -(((o.x n.x + o.y n.y) + o.z n.z) + dn) / ((d.x n.x + d.y n.y) + d.z n.z)
//   u = (((o.x u.x + o.y u.y) + o.z u.z) + du) + t ((d.x u.x + d.y u.y) + d.z u.z)
//   v likewise,
// accepting u >= 0, v >= 0, u + v <= 1, t >= 0, t < t_lim.  These are the
// plain twin's expressions in its order (ops/traverse_cw8.py); built with
// --fmad=false and without fast math, kernel and twin agree bit for bit, and
// the twin, which sweeps every window, is the proof that the culling never
// drops a hit.  Closest keeps the lexicographic minimum of (t, tri), so the
// result does not depend on the visiting order; any-hit returns at its
// first accepted triangle.
//
// A tree of D levels needs D - 1 stack entries.  The wrapper instantiates
// the stack from the depth the packer computed (8, 16 or 24 entries) and
// raises for a tree deeper than 22 levels; the stack is never clamped.  A
// malformed table (a child or triangle index out of range, or a tree deeper
// than the depth it was given) traps instead of reading out of bounds.
//
// What bounds it on an H100: each level of the walk is a dependent load -
// the node's address comes from its parent's words - so a ray pays one
// L2/HBM round trip per visited node, and the leaf planes are a second
// dependent load.  Bounce rays (random directions) diverge: SIMT serialises
// a warp's different paths and the warp waits for its longest ray.  The
// design keeps per-ray state small (registers, plus 8 bytes per stack level
// in local memory) so that many warps per SM hide the load latency, issues a
// node's five loads together, and tests a leaf's triangles where it finds
// them (no deferred triangle groups).  Not carried over from the TPU kernel:
// the coherence sort, the 128-ray consensus walk, the DMA ring, SMEM cursors,
// window queue and CHUNK cap.  Staging the top levels in shared memory,
// warp-cooperative traversal and sorting rays by octant are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // rays per block, one per thread
constexpr int kWinCols = 128;  // columns of a plane window row
constexpr float kInf = 1e9f;
constexpr float kPad = 1e-5f;  // box padding, relative and absolute
constexpr float kCullMargin = 1e-5f;  // relative margin of the entry-t cull

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
// true at an accepted triangle.
template <bool kAnyHit>
__device__ __forceinline__ bool test_triangle(const float* __restrict__ planes,
                                              int k, const float o[3],
                                              const float d[3], float t_lim,
                                              float& best_t, int& best_tri) {
  const float* p =
      planes + static_cast<size_t>(k >> 5) * 4 * kWinCols + (k & 31);
  const float nx = __ldg(p), ny = __ldg(p + kWinCols);
  const float nz = __ldg(p + 2 * kWinCols), dn = __ldg(p + 3 * kWinCols);
  const float an = ((o[0] * nx + o[1] * ny) + o[2] * nz) + dn;
  const float bn = (d[0] * nx + d[1] * ny) + d[2] * nz;
  const float t = -an / bn;
  // Cannot be accepted or cannot win (NaN fails too).
  if (!(t >= 0.f && t < t_lim && t <= best_t)) return false;
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

template <bool kAnyHit, int kStack>
__global__ void __launch_bounds__(kBlock) cw8_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const bool* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ box, const uint4* __restrict__ nodes,
    const float* __restrict__ planes, int n, int n8, int n_cols,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    int* __restrict__ out_win, bool* __restrict__ out_occ) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float o[3] = {o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]};
  const float d[3] = {d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]};
  float t_lim = -kInf;
  if (active[i]) t_lim = kAnyHit ? t_max[i] : kInf;
  t_lim = exit_clamp(t_lim, o, d, box);

  float best_t = t_lim;
  int best_tri = -1;
  // Nothing is accepted unless 0 <= t < t_lim: dead lanes stop here.
  if (t_lim > 0.f) {
    float inv[3];
    for (int a = 0; a < 3; ++a) {
      const float da =
          fabsf(d[a]) < 1e-12f ? (d[a] < 0.f ? -1e-12f : 1e-12f) : d[a];
      inv[a] = 1.0f / da;
    }
    // Slot s points towards -x, -y, -z where its bits 4, 2, 1 are set.  Key
    // k = slot ^ front orders a group's children: key 0 is the slot facing
    // against the ray, visited first.
    const int front = 7 ^ (((d[0] < 0.f) << 2) | ((d[1] < 0.f) << 1) |
                           (d[2] < 0.f));
    int st_base[kStack];
    unsigned st_mask[kStack];  // inner mask | pending keys << 8
    int sp = 0;
    // The current group; the virtual root holds node 0 in slot 0.
    int base = 0;
    unsigned imask = 1u;
    unsigned pend = 1u << front;
    bool done = false;
    while (!done) {
      if (pend == 0u) {
        if (sp == 0) break;
        --sp;
        base = st_base[sp];
        imask = st_mask[sp] & 0xFFu;
        pend = st_mask[sp] >> 8;
        continue;
      }
      const int slot = (__ffs(pend) - 1) ^ front;
      pend &= pend - 1u;
      const int child = base + __popc(imask & ((1u << slot) - 1u));
      if (pend != 0u) {
        if (sp == kStack) __trap();  // deeper than the depth given
        st_base[sp] = base;
        st_mask[sp] = imask | (pend << 8);
        ++sp;
      }
      if (child < 0 || child >= n8) __trap();
      const uint4* np = nodes + static_cast<size_t>(child) * 5;
      const uint4 q0 = __ldg(np), q1 = __ldg(np + 1), q2 = __ldg(np + 2);
      const uint4 q3 = __ldg(np + 3), q4 = __ldg(np + 4);
      const float p[3] = {__uint_as_float(q0.x), __uint_as_float(q0.y),
                          __uint_as_float(q0.z)};
      const float scale[3] = {__uint_as_float(byte_of(q0.w, 0) << 23),
                              __uint_as_float(byte_of(q0.w, 1) << 23),
                              __uint_as_float(byte_of(q0.w, 2) << 23)};
      const unsigned meta[2] = {q1.z, q1.w};
      // q_lo / q_hi words of children 0-3 and 4-7, per axis.
      const unsigned q_lo[3][2] = {{q2.x, q2.y}, {q3.x, q3.y}, {q4.x, q4.y}};
      const unsigned q_hi[3][2] = {{q2.z, q2.w}, {q3.z, q3.w}, {q4.z, q4.w}};
      const int tri_base = static_cast<int>(q1.y);
      unsigned next = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int h = j >> 2, b = j & 3;
        const unsigned m = byte_of(meta[h], b);
        if (m == 0u) continue;
        float lo[3], hi[3];
        for (int a = 0; a < 3; ++a) {
          lo[a] = p[a] + static_cast<float>(byte_of(q_lo[a][h], b)) * scale[a];
          hi[a] = p[a] + static_cast<float>(byte_of(q_hi[a][h], b)) * scale[a];
        }
        if (!box_visit(lo, hi, o, inv, best_t)) continue;
        if ((m & 0x18u) == 0x18u) {  // inner child
          next |= 1u << (j ^ front);
          continue;
        }
        // Leaf: unary count in bits 5-7, first-triangle offset in bits 0-4.
        const int first = tri_base + static_cast<int>(m & 0x1Fu);
        const int count = __popc(m >> 5);
        for (int c = 0; c < count && !done; ++c) {
          const int k = first + c;
          if (k < 0 || k >= n_cols) __trap();
          done = test_triangle<kAnyHit>(planes, k, o, d, t_lim, best_t,
                                        best_tri);
        }
        if (done) break;
      }
      base = static_cast<int>(q1.x);
      imask = q0.w >> 24;
      pend = next;
    }
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

int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

template <bool kAnyHit>
int launch(int stack, cudaStream_t s, const float* o, const float* d,
           const bool* active, const float* t_max, const float* box,
           const void* nodes, const float* planes, int n, int n8, int nwin,
           float* out_t, int* out_tri, int* out_win, bool* out_occ) {
  const uint4* nd = static_cast<const uint4*>(nodes);
  const int n_cols = 32 * nwin;
  switch (stack) {
    case 8:
      cw8_kernel<kAnyHit, 8><<<grid_for(n), kBlock, 0, s>>>(
          o, d, active, t_max, box, nd, planes, n, n8, n_cols, out_t, out_tri,
          out_win, out_occ);
      break;
    case 16:
      cw8_kernel<kAnyHit, 16><<<grid_for(n), kBlock, 0, s>>>(
          o, d, active, t_max, box, nd, planes, n, n8, n_cols, out_t, out_tri,
          out_win, out_occ);
      break;
    case 24:
      cw8_kernel<kAnyHit, 24><<<grid_for(n), kBlock, 0, s>>>(
          o, d, active, t_max, box, nd, planes, n, n8, n_cols, out_t, out_tri,
          out_win, out_occ);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.
// box: (6,) scene bbox min | max; nodes: (n8, 20) 32-bit words, 16-byte
// aligned; planes: (nwin, 4, 128); stack: 8, 16 or 24 entries.
extern "C" int cw8_closest(const float* o, const float* d, const bool* active,
                           const float* box, const void* nodes,
                           const float* planes, int n, int n8, int nwin,
                           int stack, float* out_t, int* out_tri, int* out_win,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<false>(stack, static_cast<cudaStream_t>(stream), o, d, active,
                       nullptr, box, nodes, planes, n, n8, nwin, out_t, out_tri,
                       out_win, nullptr);
}

extern "C" int cw8_anyhit(const float* o, const float* d, const float* t_max,
                          const bool* active, const float* box,
                          const void* nodes, const float* planes, int n, int n8,
                          int nwin, int stack, bool* out_occ, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<true>(stack, static_cast<cudaStream_t>(stream), o, d, active,
                      t_max, box, nodes, planes, n, n8, nwin, nullptr, nullptr,
                      nullptr, out_occ);
}

extern "C" const char* cw8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
