// Wide-BVH closest-hit and any-hit walk for Hopper (sm_90a), one warp per
// ray (B2 v2).
//
// Replaces caitlynrenderer_tpu/ops/traverse_mega.py:205 _make_kernel (entry
// points mega_closest / mega_anyhit).  The scene is cut into G groups of up
// to Kp triangles; each group is a block of Baldwin-Weber planes
// (pack_mega: rows 0-2 plane vector, row 3 offset; columns n | u | v), and
// each direction octant has a static front-to-back worklist of the groups
// with their bounds, plus the union bounds of every 128 entries
// (pack_octants).
//
// The contract.  A ray clamps its bound to the scene-box exit
// (_scene_exit_bound, term for term, with its inf and NaN), takes its
// octant's worklist, skips 128-entry blocks and then single entries whose
// padded box it misses or enters beyond its current best t, and evaluates
// every plane column of the groups that remain:
//   t = -(((o.x n.x + o.y n.y) + o.z n.z) + dn) / ((d.x n.x + d.y n.y) + d.z n.z)
//   u = (((o.x u.x + o.y u.y) + o.z u.z) + du) + t ((d.x u.x + d.y u.y) + d.z u.z)
//   v likewise,
// accepting u >= 0, v >= 0, u + v <= 1, t >= 0, t < t_lim.  Closest keeps
// the lexicographic minimum of (t, tri); any-hit stops at the first accepted
// triangle.  These are the plain twin's expressions in its order
// (ops/traverse_mega.py); built with --fmad=false and without fast math,
// kernel and twin agree bit for bit.  Boxes are padded by 1e-5 (1 + |bound|)
// and skipped only when missed or entered strictly after best t
// (1 + 1e-5): without the padding, f32 rounding on a flat box (cornell's
// axis-aligned walls) would cull real hits.
//
// The design: a warp owns one ray, its 32 lanes spread over the worklist
// and the plane columns.
//   - Block cull: lane b tests block b's union box (in chunks of 32 blocks)
//     and keeps its entry t; __ballot_sync gives the blocks that survive,
//     taken in worklist order.
//   - Entry cull: inside a surviving block, four passes of 32 lanes each
//     test one entry's box and keep its entry t.
//   - Before each block and each group is visited, its entry t is re-tested
//     against the warp's current best t (the reference's "cull against the
//     live bound"), with box_visit's margin.
//   - Columns: for a visited group, lane j evaluates columns j, j + 32, ...
//     of the n-plane rows 0-3: four coalesced 128-byte loads per step.  Only
//     lanes whose t can still win (t >= 0, t < t_lim, t <= their best) load
//     the u and v columns.  Each lane keeps its own lexicographic (t, tri)
//     candidate; after the group an __shfl_xor_sync butterfly reduces
//     (t, tri, group) and every lane holds the new best t.  The minimum of a
//     set does not depend on the order it is taken in, and culled boxes and
//     columns cannot hold it (the culls keep ties), so the result equals
//     the twin's, which sweeps every group.
//   - Any-hit: __any_sync after each 32-column step; the warp leaves the ray
//     at the first accepted triangle.
//
// What the design does about v1's three costs (one thread walked one ray's
// whole worklist serially): (1) the serial scan of block boxes, entry boxes
// and plane columns is now 32 lanes wide, and the column loads coalesce;
// (2) a warp per ray gives 65,536 warps for a 256x256 frame, where v1 had
// 2,048, so latency is hidden by many resident warps; (3) no lane ever
// follows another ray, so mixed octants and scattered bounce rays cost no
// divergence, and no ray sort is needed.  Bounce rays
// still cost more per launch than primary rays: each does as much work,
// but together they touch more distinct worklist entries, so warps share
// less of L2.
//
// What bounds it on an H100: issue and latency, not FLOPs or bytes.  Per
// visited group a warp issues Kp / 32 steps of four independent loads,
// ~11 FP32 operations and one IEEE division per lane; the distinct plane
// rows the rays touch fit the 50 MB L2, so the bound of the work the query
// needs (chip_smoke.py phase 11) is 1-2 % of the measured time, and the
// walk does 3-24x that work.  The stats variant shows where the issue
// slots go: at 1M triangles a bench-camera ray
// makes ~1,700 entry-box tests for ~2 groups visited, because a 128-entry
// block of the diagonal worklist is a band most rays cross; the entry
// cull, not the columns, is the next thing to shrink.
//
// Tensor cores are not used: each column is three 4-term dot products
// (K = 4), the reference itself ran its matmuls at Precision.HIGHEST
// because reduced precision loses real hits (traverse_mega.py:787-791),
// and TF32 wgmma would break both the contract and bit equality with the
// twin.
//
// The stats variant (kStats) walks exactly the same path and also writes
// per-ray counts and which groups, entries and blocks any ray touched.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per block, one ray each
constexpr int kBlock = 32 * kWarps;
// At least 8 blocks (32 warps) per SM, to hide the walk's load latency
// with more resident warps: caps the closest walk at 64 registers (72
// without the cap, 28 warps per SM) with no spills (ptxas -v, printed by
// chip_smoke.py phase 2).
constexpr int kMinBlocksPerSM = 8;
constexpr int kEntriesPerBlk = 128;  // worklist entries per oct_blk box
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1e9f;
constexpr float kPad = 1e-5f;  // box padding, relative and absolute
constexpr float kCullMargin = 1e-5f;  // relative margin of the entry-t cull
constexpr int kNumStats = 5;  // block tests, entry tests, groups, columns, u/v columns

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

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

// Entry t of a padded box (16-float row, bmin | bmax in columns 0-5):
// max(tn, 0) when the ray meets it ahead of its origin, else +inf.  inv =
// 1 / d with |d| clamped to at least 1e-12, so every term is finite; NaN
// padding rows fail tf >= tn.
__device__ __forceinline__ float box_entry(const float* __restrict__ b,
                                           const float o[3], const float inv[3]) {
  const float4 r0 = __ldg(reinterpret_cast<const float4*>(b));
  const float2 r1 = __ldg(reinterpret_cast<const float2*>(b + 4));
  const float lo3[3] = {r0.x, r0.y, r0.z};
  const float hi3[3] = {r0.w, r1.x, r1.y};
  float tn = 0.f, tf = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = lo3[a], hi = hi3[a];
    const float t0 = (lo - kPad * (1.f + fabsf(lo)) - o[a]) * inv[a];
    const float t1 = (hi + kPad * (1.f + fabsf(hi)) - o[a]) * inv[a];
    tn = a == 0 ? fminf(t0, t1) : fmaxf(tn, fminf(t0, t1));
    tf = a == 0 ? fmaxf(t0, t1) : fminf(tf, fmaxf(t0, t1));
  }
  return (tf >= tn && tf >= 0.f) ? fmaxf(tn, 0.f) : pos_inf();
}

// A box entered at `entry` may hold a hit that beats `best` (ties kept).
__device__ __forceinline__ bool ahead(float entry, float best) {
  return entry <= best + kCullMargin * best;
}

struct Outputs {
  float* t;
  int* tri;
  int* grp;
  bool* occ;
  int* stats;     // (n, kNumStats), kStats only
  int* grp_seen;  // (g,): 1 where some ray visited the group
  int* ent_seen;  // (8, gpad): 1 where some ray tested the entry's box
  int* blk_seen;  // (8, nblk): 1 where some ray tested the block's box
};

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kBlock, kMinBlocksPerSM) mega_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const bool* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ box, const float* __restrict__ planes,
    const float* __restrict__ oct_bounds, const int* __restrict__ oct_gid,
    const int* __restrict__ oct_start, const float* __restrict__ oct_blk,
    int n, int g, int kp, int gpad, int nblk, Outputs out) {
  const int lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (ray >= n) return;  // the whole warp
  const int i = static_cast<int>(ray);
  // Every lane holds the ray (the loads broadcast).
  const float o[3] = {o_in[3 * i], o_in[3 * i + 1], o_in[3 * i + 2]};
  const float d[3] = {d_in[3 * i], d_in[3 * i + 1], d_in[3 * i + 2]};
  float t_lim = -kInf;
  if (active[i]) t_lim = kAnyHit ? t_max[i] : kInf;
  t_lim = exit_clamp(t_lim, o, d, box);

  float best_t = t_lim;  // warp-uniform
  int best_tri = -1, best_grp = -1;
  bool done = false;  // any-hit: occluded
  int n_blk = 0, n_ent = 0, n_grp = 0, n_col = 0, n_uv = 0;  // kStats
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

    for (int c = 0; c < nblk && !done; c += 32) {
      const int bl = c + lane;
      const float blk_in = bl < nblk ? box_entry(wl_blk + 16 * bl, o, inv) : pos_inf();
      if (kStats) {
        n_blk += min(32, nblk - c);
        if (bl < nblk) out.blk_seen[oct * nblk + bl] = 1;
      }
      unsigned blk_mask = __ballot_sync(kFull, ahead(blk_in, best_t));
      while (blk_mask != 0 && !done) {
        const int jb = __ffs(blk_mask) - 1;
        blk_mask &= blk_mask - 1;
        if (!ahead(__shfl_sync(kFull, blk_in, jb), best_t)) continue;
        const int k0 = (c + jb) * kEntriesPerBlk;
        float ent[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int k = k0 + 32 * p + lane;
          ent[p] = k < g ? box_entry(wl_bounds + 16 * static_cast<size_t>(k), o, inv)
                         : pos_inf();
          if (kStats && k < g) out.ent_seen[static_cast<size_t>(oct) * gpad + k] = 1;
        }
        if (kStats) n_ent += min(kEntriesPerBlk, g - k0);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          unsigned m = __ballot_sync(kFull, ahead(ent[p], best_t));
          while (m != 0 && !done) {
            const int je = __ffs(m) - 1;
            m &= m - 1;
            if (!ahead(__shfl_sync(kFull, ent[p], je), best_t)) continue;
            const int k = k0 + 32 * p + je;
            const int gid = __ldg(wl_gid + k);
            const int start = __ldg(wl_start + k);
            const float* pg = planes + static_cast<size_t>(gid) * 8 * kp3;
            if (kStats) {
              ++n_grp;
              if (lane == 0) out.grp_seen[gid] = 1;
            }
            // This lane's candidate, starting from the warp's best.
            float lt = best_t;
            int ltri = best_tri;
            bool found = false;
            for (int j0 = 0; j0 < kp; j0 += 32) {
              const int j = j0 + lane;
              const float nx = __ldg(pg + j), ny = __ldg(pg + kp3 + j);
              const float nz = __ldg(pg + 2 * kp3 + j), dn = __ldg(pg + 3 * kp3 + j);
              const float an = ((o[0] * nx + o[1] * ny) + o[2] * nz) + dn;
              const float bn = (d[0] * nx + d[1] * ny) + d[2] * nz;
              const float t = -an / bn;
              bool acc = false;
              // Only a t that can be accepted and can win reaches u, v
              // (NaN fails too).
              if (t >= 0.f && t < t_lim && t <= lt) {
                const float* pu = pg + kp + j;
                const float ux = __ldg(pu), uy = __ldg(pu + kp3);
                const float uz = __ldg(pu + 2 * kp3), du = __ldg(pu + 3 * kp3);
                const float u = (((o[0] * ux + o[1] * uy) + o[2] * uz) + du) +
                                t * ((d[0] * ux + d[1] * uy) + d[2] * uz);
                const float* pv = pg + 2 * kp + j;
                const float vx = __ldg(pv), vy = __ldg(pv + kp3);
                const float vz = __ldg(pv + 2 * kp3), dv = __ldg(pv + 3 * kp3);
                const float v = (((o[0] * vx + o[1] * vy) + o[2] * vz) + dv) +
                                t * ((d[0] * vx + d[1] * vy) + d[2] * vz);
                acc = u >= 0.f && v >= 0.f && u + v <= 1.0f;
                if (kStats) ++n_uv;
              }
              if (kStats) n_col += 32;
              if (kAnyHit) {
                if (__any_sync(kFull, acc)) {
                  done = true;
                  break;
                }
              } else if (acc) {
                // t <= lt here; with no hit yet, lt = t_lim > t.
                const int tri = start + j;
                if (t < lt || tri < ltri) {
                  lt = t;
                  ltri = tri;
                  found = true;
                }
              }
            }
            if (!kAnyHit && __any_sync(kFull, found)) {
              // Lexicographic minimum of (t, tri) over the lanes; the
              // group rides along (a lane that found nothing holds the
              // warp's previous best).
              int lgrp = found ? gid : best_grp;
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) {
                const float ot = __shfl_xor_sync(kFull, lt, off);
                const int otri = __shfl_xor_sync(kFull, ltri, off);
                const int ogrp = __shfl_xor_sync(kFull, lgrp, off);
                if (ot < lt || (ot == lt && otri < ltri)) {
                  lt = ot;
                  ltri = otri;
                  lgrp = ogrp;
                }
              }
              best_t = lt;
              best_tri = ltri;
              best_grp = lgrp;
            }
          }
        }
      }
    }
  }

  if (kStats) n_uv = __reduce_add_sync(kFull, n_uv);
  if (lane != 0) return;
  if (kAnyHit) {
    out.occ[i] = done;
  } else {
    const bool miss = best_tri < 0;
    out.t[i] = miss ? kInf : best_t;
    out.tri[i] = best_tri;
    out.grp[i] = best_grp;
  }
  if (kStats) {
    int* s = out.stats + static_cast<size_t>(i) * kNumStats;
    s[0] = n_blk;
    s[1] = n_ent;
    s[2] = n_grp;
    s[3] = n_col;
    s[4] = n_uv;
  }
}

template <bool kAnyHit, bool kStats>
int launch(const float* o, const float* d, const bool* active, const float* t_max,
           const float* box, const float* planes, const float* oct_bounds,
           const int* oct_gid, const int* oct_start, const float* oct_blk, int n,
           int g, int kp, int gpad, int nblk, Outputs out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (static_cast<long long>(n) + kWarps - 1) / kWarps;
  mega_kernel<kAnyHit, kStats>
      <<<static_cast<unsigned>(blocks), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          o, d, active, t_max, box, planes, oct_bounds, oct_gid, oct_start, oct_blk, n, g,
          kp, gpad, nblk, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.
// box: (6,) scene bbox min | max; planes: (g, 8, 3 kp); oct_bounds:
// (8, gpad, 16), 16-byte aligned; oct_gid, oct_start: (8, gpad); oct_blk:
// (8, nblk, 16), 16-byte aligned.
extern "C" int mega_closest(const float* o, const float* d, const bool* active,
                            const float* box, const float* planes,
                            const float* oct_bounds, const int* oct_gid,
                            const int* oct_start, const float* oct_blk, int n,
                            int g, int kp, int gpad, int nblk, float* out_t,
                            int* out_tri, int* out_grp, int device,
                            void* stream) {
  const Outputs out{out_t, out_tri, out_grp, nullptr, nullptr, nullptr, nullptr, nullptr};
  return launch<false, false>(o, d, active, nullptr, box, planes, oct_bounds, oct_gid,
                              oct_start, oct_blk, n, g, kp, gpad, nblk, out, device, stream);
}

extern "C" int mega_anyhit(const float* o, const float* d, const float* t_max,
                           const bool* active, const float* box,
                           const float* planes, const float* oct_bounds,
                           const int* oct_gid, const int* oct_start,
                           const float* oct_blk, int n, int g, int kp, int gpad,
                           int nblk, bool* out_occ, int device, void* stream) {
  const Outputs out{nullptr, nullptr, nullptr, out_occ, nullptr, nullptr, nullptr, nullptr};
  return launch<true, false>(o, d, active, t_max, box, planes, oct_bounds, oct_gid,
                             oct_start, oct_blk, n, g, kp, gpad, nblk, out, device, stream);
}

// The stats variants: the same walk, plus stats (n, 5) i32 per ray (block
// tests, entry tests, groups visited, columns evaluated, columns that
// reached u/v) and the zero-initialised flags grp_seen (g,), ent_seen
// (8, gpad) and blk_seen (8, nblk), set to 1 where any ray touched them.
extern "C" int mega_closest_stats(const float* o, const float* d, const bool* active,
                                  const float* box, const float* planes,
                                  const float* oct_bounds, const int* oct_gid,
                                  const int* oct_start, const float* oct_blk, int n,
                                  int g, int kp, int gpad, int nblk, float* out_t,
                                  int* out_tri, int* out_grp, int* stats, int* grp_seen,
                                  int* ent_seen, int* blk_seen, int device, void* stream) {
  const Outputs out{out_t, out_tri, out_grp, nullptr, stats, grp_seen, ent_seen, blk_seen};
  return launch<false, true>(o, d, active, nullptr, box, planes, oct_bounds, oct_gid,
                             oct_start, oct_blk, n, g, kp, gpad, nblk, out, device, stream);
}

extern "C" int mega_anyhit_stats(const float* o, const float* d, const float* t_max,
                                 const bool* active, const float* box,
                                 const float* planes, const float* oct_bounds,
                                 const int* oct_gid, const int* oct_start,
                                 const float* oct_blk, int n, int g, int kp, int gpad,
                                 int nblk, bool* out_occ, int* stats, int* grp_seen,
                                 int* ent_seen, int* blk_seen, int device, void* stream) {
  const Outputs out{nullptr, nullptr, nullptr, out_occ, stats, grp_seen, ent_seen, blk_seen};
  return launch<true, true>(o, d, active, t_max, box, planes, oct_bounds, oct_gid,
                            oct_start, oct_blk, n, g, kp, gpad, nblk, out, device, stream);
}

extern "C" const char* mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
