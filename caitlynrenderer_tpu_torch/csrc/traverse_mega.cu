// Wide-BVH closest-hit and any-hit walk for Hopper (sm_90a).
//
// Replaces caitlynrenderer_tpu/ops/traverse_mega.py:_make_kernel (entry
// points mega_closest / mega_anyhit).  The scene is cut into G groups of up
// to Kp triangles; each group is a block of Baldwin-Weber planes
// (pack_mega: rows 0-2 plane vector, row 3 offset; columns n | u | v), and
// each direction octant has a static front-to-back worklist of the groups
// with their bounds, plus the union bounds of every 128 entries
// (pack_octants).
//
// One thread per ray.  The ray clamps its bound to the scene-box exit
// (_scene_exit_bound, term for term, with its inf and NaN), takes its
// octant's worklist, skips 128-entry blocks and then single entries whose
// box it misses or enters beyond its current best t, and evaluates every
// plane column of the groups that remain:
//   t = -(((o.x n.x + o.y n.y) + o.z n.z) + dn) / ((d.x n.x + d.y n.y) + d.z n.z)
//   u = (((o.x u.x + o.y u.y) + o.z u.z) + du) + t ((d.x u.x + d.y u.y) + d.z u.z)
//   v likewise,
// accepting u >= 0, v >= 0, u + v <= 1, t >= 0, t < t_lim.  Closest keeps
// the lexicographic minimum of (t, tri); any-hit returns at its first
// accepted triangle.  These are the plain twin's expressions in its order
// (ops/traverse_mega.py); built with --fmad=false and without fast math,
// kernel and twin agree bit for bit, and the twin, which sweeps every group,
// is the proof that the culling never drops a hit.
//
// The culling is conservative.  Boxes are padded by 1e-5 (1 + |bound|) and
// a box is skipped only when the ray misses it or enters it strictly after
// best t (1 + 1e-5).  Without the padding, f32 rounding on a flat box (the
// cornell walls are axis-aligned, so their boxes have zero thickness) would
// cull real hits.
//
// What bounds it on an H100: per visited group, Kp columns of 12 plane loads
// and ~30 FP32 operations with one IEEE division per ray.  Rays of one warp
// that share an octant read the same worklist entries and, when coherent,
// the same plane columns, which the L1 broadcasts; rays of mixed octants
// diverge and the warp pays the union of their groups.  The TPU kernel's
// coherence sort, ray packets, banded MXU matmul and DMA ring are not
// carried over: ordering rays, staging planes in shared memory and
// warp-cooperative packets are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // rays per block, one per thread
constexpr int kEntriesPerBlk = 128;  // worklist entries per oct_blk box
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

// Conservative slab test of a padded box: true unless the ray misses it or
// enters it after `best` (with the relative margin).  inv = 1 / d with |d|
// clamped to at least 1e-12, so every term is finite.
__device__ __forceinline__ bool box_visit(const float* __restrict__ b,
                                          const float o[3], const float inv[3],
                                          float best) {
  float tn = 0.f, tf = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float lo = b[a], hi = b[3 + a];
    const float t0 = (lo - kPad * (1.f + fabsf(lo)) - o[a]) * inv[a];
    const float t1 = (hi + kPad * (1.f + fabsf(hi)) - o[a]) * inv[a];
    tn = a == 0 ? fminf(t0, t1) : fmaxf(tn, fminf(t0, t1));
    tf = a == 0 ? fmaxf(t0, t1) : fminf(tf, fmaxf(t0, t1));
  }
  return tf >= tn && tf >= 0.f && fmaxf(tn, 0.f) <= best + kCullMargin * best;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) mega_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const bool* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ box, const float* __restrict__ planes,
    const float* __restrict__ oct_bounds, const int* __restrict__ oct_gid,
    const int* __restrict__ oct_start, const float* __restrict__ oct_blk,
    int n, int g, int kp, int gpad, int nblk, float* __restrict__ out_t,
    int* __restrict__ out_tri, int* __restrict__ out_grp,
    bool* __restrict__ out_occ) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float o[3] = {o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]};
  const float d[3] = {d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]};
  float t_lim = -kInf;
  if (active[i]) t_lim = kAnyHit ? t_max[i] : kInf;
  t_lim = exit_clamp(t_lim, o, d, box);

  float best_t = t_lim;
  int best_tri = -1, best_grp = -1;
  // Nothing is accepted unless 0 <= t < t_lim: dead lanes stop here.
  if (t_lim > 0.f) {
    float inv[3];
    for (int a = 0; a < 3; ++a) {
      const float da =
          fabsf(d[a]) < 1e-12f ? (d[a] < 0.f ? -1e-12f : 1e-12f) : d[a];
      inv[a] = 1.0f / da;
    }
    const int oct = ((d[0] < 0.f) << 2) | ((d[1] < 0.f) << 1) | (d[2] < 0.f);
    const float* wl_bounds = oct_bounds + static_cast<size_t>(oct) * gpad * 16;
    const int* wl_gid = oct_gid + static_cast<size_t>(oct) * gpad;
    const int* wl_start = oct_start + static_cast<size_t>(oct) * gpad;
    const float* wl_blk = oct_blk + static_cast<size_t>(oct) * nblk * 16;
    const size_t kp3 = 3 * static_cast<size_t>(kp);
    bool done = false;
    for (int b = 0; b < nblk && !done; ++b) {
      if (!box_visit(wl_blk + 16 * b, o, inv, best_t)) continue;
      const int k_end = min(g, (b + 1) * kEntriesPerBlk);
      for (int k = b * kEntriesPerBlk; k < k_end && !done; ++k) {
        if (!box_visit(wl_bounds + 16 * static_cast<size_t>(k), o, inv, best_t))
          continue;
        const int gid = wl_gid[k];
        const int start = wl_start[k];
        const float* p = planes + static_cast<size_t>(gid) * 8 * kp3;
        for (int j = 0; j < kp; ++j) {
          const float nx = __ldg(p + j), ny = __ldg(p + kp3 + j);
          const float nz = __ldg(p + 2 * kp3 + j), dn = __ldg(p + 3 * kp3 + j);
          const float an = ((o[0] * nx + o[1] * ny) + o[2] * nz) + dn;
          const float bn = (d[0] * nx + d[1] * ny) + d[2] * nz;
          const float t = -an / bn;
          // Cannot be accepted or cannot win (NaN fails too).
          if (!(t >= 0.f && t < t_lim && t <= best_t)) continue;
          const float* pu = p + kp + j;
          const float ux = __ldg(pu), uy = __ldg(pu + kp3);
          const float uz = __ldg(pu + 2 * kp3), du = __ldg(pu + 3 * kp3);
          const float u = (((o[0] * ux + o[1] * uy) + o[2] * uz) + du) +
                          t * ((d[0] * ux + d[1] * uy) + d[2] * uz);
          const float* pv = p + 2 * kp + j;
          const float vx = __ldg(pv), vy = __ldg(pv + kp3);
          const float vz = __ldg(pv + 2 * kp3), dv = __ldg(pv + 3 * kp3);
          const float v = (((o[0] * vx + o[1] * vy) + o[2] * vz) + dv) +
                          t * ((d[0] * vx + d[1] * vy) + d[2] * vz);
          if (!(u >= 0.f && v >= 0.f && u + v <= 1.0f)) continue;
          const int tri = start + j;
          if (kAnyHit) {
            best_tri = tri;
            done = true;
            break;
          }
          // t <= best_t here; with no hit yet, best_t = t_lim > t.
          if (t < best_t || tri < best_tri) {
            best_t = t;
            best_tri = tri;
            best_grp = gid;
          }
        }
      }
    }
  }

  if (kAnyHit) {
    out_occ[i] = best_tri >= 0;
  } else {
    const bool miss = best_tri < 0;
    out_t[i] = miss ? kInf : best_t;
    out_tri[i] = best_tri;
    out_grp[i] = best_grp;
  }
}

int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.
// box: (6,) scene bbox min | max; planes: (g, 8, 3 kp); oct_bounds:
// (8, gpad, 16); oct_gid, oct_start: (8, gpad); oct_blk: (8, nblk, 16).
extern "C" int mega_closest(const float* o, const float* d, const bool* active,
                            const float* box, const float* planes,
                            const float* oct_bounds, const int* oct_gid,
                            const int* oct_start, const float* oct_blk, int n,
                            int g, int kp, int gpad, int nblk, float* out_t,
                            int* out_tri, int* out_grp, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mega_kernel<false>
      <<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          o, d, active, nullptr, box, planes, oct_bounds, oct_gid, oct_start,
          oct_blk, n, g, kp, gpad, nblk, out_t, out_tri, out_grp, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mega_anyhit(const float* o, const float* d, const float* t_max,
                           const bool* active, const float* box,
                           const float* planes, const float* oct_bounds,
                           const int* oct_gid, const int* oct_start,
                           const float* oct_blk, int n, int g, int kp, int gpad,
                           int nblk, bool* out_occ, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mega_kernel<true>
      <<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          o, d, active, t_max, box, planes, oct_bounds, oct_gid, oct_start,
          oct_blk, n, g, kp, gpad, nblk, nullptr, nullptr, nullptr, out_occ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
