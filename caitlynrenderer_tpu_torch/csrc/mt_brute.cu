// Dense ray x triangle Moller-Trumbore for Hopper (sm_90a).
//
// Replaces caitlynrenderer_tpu/ops/pallas_mt.py:_kernel (entry points
// brute_closest_pallas / brute_anyhit_pallas): for every ray, test every row
// of a (T, 9) v0|e1|e2 slab in scene order and keep the nearest accepted
// (t, slot, u, v).  Acceptance is the Pallas kernel's, term for term:
//   u >= 0, v >= 0, (1 - u) - v >= 0, t >= 0, t < t_best, det != 0,
//   inv_det = 1 / (|det| < 1e-20 ? 1e-20 : det).
// Ties go to the first-indexed triangle.  Inactive rays enter with
// t_best = -INF and so accept nothing.
//
// What bounds it on an H100: instruction issue and shared-memory reads.  The
// exact test costs 41 separately rounded multiplies and adds before its
// first decision, and nearly every pair is rejected.  The design:
//
// 1. Cull cheaply, confirm exactly.  Each chunk of the slab is staged with
//    per-triangle constants (Pluecker form): n = e2 x e1, p1 = v0 x e1,
//    p2 = v0 x e2, c2 = e2 . p1, positions taken relative to c, the chunk's
//    first v0, so that the margins below scale with the scene's extent, not
//    its offset from the origin; each ray carries m = (o - c) x d.  Then
//    Moller-Trumbore's determinant and numerators are four short dot
//    products, 18 fused multiply-adds in all:
//      det = d . n        unum = e2 . m + d . p2
//      vnum = -(e1 . m + d . p1)      tnum = -((o - c) . n + c2)
//    the same real numbers as the exact test's, rounded differently.  The
//    exact test's values (det_t, ...) lie within about 6 units of rounding
//    (u = 2^-24) of the real ones, and these (det_p, ...), the shift to c
//    included, within about 10, in units of
//      E_det = |d|_1 P,  E_u = s |d|_1 |e2|_1,  E_v = s |d|_1 |e1|_1,
//      E_t = s P,  s = |o - c|_inf + |v0 - c|_inf,  P = |e1|_1 |e2|_1
//    (each dot product's error is bounded by its terms' magnitudes, and
//    every term here by these products), where the triangle's norms are
//    replaced by their maxima over the chunk, so that every margin is one
//    number per ray and chunk.  The pre-test charges K = 32 u per unit,
//    twice the sum of both, and rejects a pair only where the exact test
//    must reject it:
//      - the sign of det_t is det_p's, and |det_t| lies in [1e-20, 1e30],
//        only where |det_p| > K E_det + 1e-20 and |det_p| < 1e29 ("valid");
//        elsewhere it decides nothing (det = 0 padding rows, tiny, huge and
//        NaN determinants go to the exact test);
//      - with sg = sign(det_p): u < 0 where sg unum_p < -(K E_u + 1e-14),
//        and v, t likewise.  The 1e-14 keeps the product with inv_det (at
//        least 5e-30 in magnitude) from underflowing to -0.0, which passes
//        >= 0;
//      - (1 - u) - v < 0 where sg (unum_p + vnum_p) exceeds
//        1.0001 (|det_p| + K E_det) + K (E_u + E_v): then u + v > 1.0001,
//        far beyond the rounding of u, v and (1 - u) - v;
//      - NaN anywhere fails every comparison, so the pair goes on; and where
//        a term could reach 1e37 (|o - c| |d|, s |d| |e|, s P, |d| P, or the
//        staged terms), so that a sum might overflow to an infinity that
//        would pass as beyond every margin, the pre-test decides nothing
//        for the ray and chunk.
//    ops/mt_brute.py:mt_cull_plain is the same pre-test in torch, and the
//    CPU tests hold it against the twin's acceptance.
// 2. Confirm in bulk.  A lane pre-tests a window of up to 32 of its rows,
//    noting the survivors in a bit mask, then runs the exact test on them
//    in row order (the plain twin's expressions and order, so the result is
//    the twin's bit for bit).  A warp thus pays for the most survivors one
//    of its rays has in the window, not for every row some ray kept.
// 3. Rows staged in shared memory as four float4 (n | c2, e1 | p1.x,
//    e2 | p2.x, p1.yz p2.yz) and v0, which only the exact test reads; each
//    thread tests kRays rays against each row it reads, so the rows' bytes
//    are shared by its rays.
// 4. Several lanes per ray when rays are few (kLanes, picked by the wrapper
//    so that about the card's thread slots are filled): lane g of a ray
//    takes rows g, g + kLanes, ... of each chunk in order and keeps its own
//    running (t, slot, u, v); the partials are merged by a butterfly of
//    shuffles under the lexicographic (t, slot) minimum, which is the
//    twin's first index of the minimum.  Any-hit lanes of a ray stop once
//    any of them hit (a ballot after each window); a warp leaves the row
//    loop once all its lanes have stopped, and a block its chunk loop once
//    all its rays have.  Where a ballot follows, every lane stays in the
//    loop, so every shuffle and ballot sees the whole warp.
//
// Built with --fmad=false and without fast math: the exact test's multiplies
// and adds stay separately rounded, as in the plain PyTorch twin
// (ops/mt_brute.py); the pre-test fuses its own with __fmaf_rn.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // threads per block
constexpr int kChunk = 256;  // triangle rows staged in shared memory per pass
constexpr int kRays = 2;  // rays per thread
// Rows a lane pre-tests before confirming: closest, the most a bit mask
// holds; any-hit, fewer, since its first accepted row ends the ray.
template <bool kAnyHit>
constexpr int kWindow = kAnyHit ? 16 : 32;
constexpr float kInf = 1e9f;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kErr = 1.9073486328125e-06f;  // K = 32 u = 2^-19 per unit of E
constexpr float kNumEps = 1e-14f;   // numerators this close to 0 decide no sign
constexpr float kDetTiny = 1e-20f;  // |det| below this: inv_det = 1e20
constexpr float kDetHuge = 1e29f;   // |det| above this decides no sign
constexpr float kSumMargin = 1.0001f;  // u + v > 1 only beyond this margin
constexpr float kMagMax = 1e37f;  // terms up to this: sums of six stay finite

// One ray: as given (the exact test), and its pre-test terms for the chunk.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float px, py, pz;      // o - c
  float mx, my, mz;      // (o - c) x d
  float eu, ev, et, ed;  // K E_u + 1e-14, ..., K E_det + 1e-20
  float euv;             // eu + ev
};

// The pre-test: false only where the exact test rejects the pair, whatever
// t_best (see the header).  a = (n, c2), b = (e1, p1.x), c = (e2, p2.x),
// q = (p1.y, p1.z, p2.y, p2.z).
__device__ __forceinline__ bool cull_keeps(const Ray& r, const float4 a,
                                           const float4 b, const float4 c,
                                           const float4 q) {
  const float det = __fmaf_rn(r.dz, a.z, __fmaf_rn(r.dy, a.y, __fmul_rn(r.dx, a.x)));
  const float tneg = __fmaf_rn(r.pz, a.z, __fmaf_rn(r.py, a.y, __fmaf_rn(r.px, a.x, a.w)));
  const float unum = __fmaf_rn(r.dz, q.w, __fmaf_rn(r.dy, q.z, __fmaf_rn(r.dx, c.w,
      __fmaf_rn(c.z, r.mz, __fmaf_rn(c.y, r.my, __fmul_rn(c.x, r.mx))))));
  const float vneg = __fmaf_rn(r.dz, q.y, __fmaf_rn(r.dy, q.x, __fmaf_rn(r.dx, b.w,
      __fmaf_rn(b.z, r.mz, __fmaf_rn(b.y, r.my, __fmul_rn(b.x, r.mx))))));
  const float adet = fabsf(det);
  const float sg = copysignf(1.0f, det);
  const float su = __fmul_rn(unum, sg);
  const float sv = __fmul_rn(vneg, -sg);
  const float st = __fmul_rn(tneg, -sg);
  const bool valid = (adet > r.ed) & (adet < kDetHuge);
  const bool out = (su < -r.eu) | (sv < -r.ev) | (st < -r.et) |
                   (__fadd_rn(su, sv) > __fmaf_rn(__fadd_rn(adet, r.ed), kSumMargin, r.euv));
  return !(valid & out);
}

// The exact test, in the plain twin's expressions and order.  Returns true
// when it accepts the pair against best_t, with its (t, u, v).
__device__ __forceinline__ bool mt_exact(const Ray& r, const float4 a,
                                         const float4 b, const float4 c,
                                         float best_t, float& t_out,
                                         float& u_out, float& v_out) {
  const float pvx = r.dy * c.z - r.dz * c.y;
  const float pvy = r.dz * c.x - r.dx * c.z;
  const float pvz = r.dx * c.y - r.dy * c.x;
  const float det = b.x * pvx + b.y * pvy + b.z * pvz;
  const float inv_det = 1.0f / (fabsf(det) < kDetTiny ? kDetTiny : det);
  const float tvx = r.ox - a.x;
  const float tvy = r.oy - a.y;
  const float tvz = r.oz - a.z;
  const float qvx = tvy * b.z - tvz * b.y;
  const float qvy = tvz * b.x - tvx * b.z;
  const float qvz = tvx * b.y - tvy * b.x;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float t = (c.x * qvx + c.y * qvy + c.z * qvz) * inv_det;
  t_out = t;
  u_out = u;
  v_out = v;
  return (u >= 0.0f) && (v >= 0.0f) && (1.0f - u - v >= 0.0f) && (t >= 0.0f) &&
         (t < best_t) && (det != 0.0f);
}

template <bool kAnyHit, int kLanes>
__global__ void __launch_bounds__(kBlock) mt_brute_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const bool* __restrict__ active, const float* __restrict__ ray_t_max,
    float t_max, const float* __restrict__ tris, int n, int t_count,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v,
    bool* __restrict__ out_occ) {
  // Rows: [0] n | c2, [1] e1 | p1.x, [2] e2 | p2.x, [3] p1.yz p2.yz, [4] v0.
  __shared__ float4 s_rows[5][kChunk];
  // Chunk maxima of |v0 - c|_inf, |e1|_1, |e2|_1 and |e1|_1 |e2|_1, as the
  // bits of non-negative floats (ordered as unsigned integers; NaN above).
  __shared__ unsigned s_max[4];

  constexpr int kGroups = kBlock / kLanes;  // ray slots per block and ray
  const int g = threadIdx.x % kLanes;  // this lane's share of the slab
  const int lane = threadIdx.x & 31;
  const unsigned gmask =
      kLanes == 32 ? kFull : ((1u << kLanes) - 1u) << (lane & ~(kLanes - 1));
  long long idx[kRays];
  Ray ray[kRays];
  float best_t[kRays], best_u[kRays], best_v[kRays], nd[kRays];
  int best_slot[kRays];
  bool live[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    idx[j] = (static_cast<long long>(blockIdx.x) * kRays + j) * kGroups + threadIdx.x / kLanes;
    Ray& r = ray[j];
    r = Ray{};
    best_t[j] = -kInf;
    live[j] = false;
    if (idx[j] < n) {
      const long long i = idx[j];
      r.ox = o[3 * i + 0];
      r.oy = o[3 * i + 1];
      r.oz = o[3 * i + 2];
      r.dx = d[3 * i + 0];
      r.dy = d[3 * i + 1];
      r.dz = d[3 * i + 2];
      live[j] = active[i];
      if (live[j]) best_t[j] = kAnyHit ? ray_t_max[i] : t_max;
    }
    nd[j] = fabsf(r.dx) + fabsf(r.dy) + fabsf(r.dz);
    best_slot[j] = -1;
    best_u[j] = 0.f;
    best_v[j] = 0.f;
  }

  for (int base = 0; base < t_count; base += kChunk) {
    bool any_live = false;
#pragma unroll
    for (int j = 0; j < kRays; ++j) any_live |= live[j];
    // Barrier before the slab is overwritten; a block whose rays have all
    // stopped (inactive, or any-hit found) leaves together.
    if (!__syncthreads_or(any_live)) break;
    if (threadIdx.x < 4) s_max[threadIdx.x] = 0u;
    __syncthreads();
    const int rows = min(kChunk, t_count - base);
    // Each lane takes `steps` rows; the rows past the slab's end are zeros,
    // which the pre-test passes and det = 0 rejects.
    const int steps = (rows + kLanes - 1) / kLanes;
    const float* c0 = tris + static_cast<size_t>(base) * 9;
    const float cx = c0[0], cy = c0[1], cz = c0[2];
    for (int k = threadIdx.x; k < steps * kLanes; k += kBlock) {
      float w[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k < rows) {
        const float* src = tris + static_cast<size_t>(base + k) * 9;
        for (int c = 0; c < 9; ++c) w[c] = src[c];
      }
      const float vx = w[0] - cx, vy = w[1] - cy, vz = w[2] - cz;
      const float ax = w[3], ay = w[4], az = w[5];  // e1
      const float bx = w[6], by = w[7], bz = w[8];  // e2
      const float p1x = vy * az - vz * ay, p1y = vz * ax - vx * az, p1z = vx * ay - vy * ax;
      const float p2x = vy * bz - vz * by, p2y = vz * bx - vx * bz, p2z = vx * by - vy * bx;
      s_rows[0][k] = make_float4(by * az - bz * ay, bz * ax - bx * az, bx * ay - by * ax,
                                 bx * p1x + by * p1y + bz * p1z);
      s_rows[1][k] = make_float4(ax, ay, az, p1x);
      s_rows[2][k] = make_float4(bx, by, bz, p2x);
      s_rows[3][k] = make_float4(p1y, p1z, p2y, p2z);
      s_rows[4][k] = make_float4(w[0], w[1], w[2], 0.f);
      if (k < rows) {
        const float ne1 = fabsf(ax) + fabsf(ay) + fabsf(az);
        const float ne2 = fabsf(bx) + fabsf(by) + fabsf(bz);
        atomicMax(&s_max[0], __float_as_uint(fmaxf(fmaxf(fabsf(vx), fabsf(vy)), fabsf(vz))));
        atomicMax(&s_max[1], __float_as_uint(ne1));
        atomicMax(&s_max[2], __float_as_uint(ne2));
        atomicMax(&s_max[3], __float_as_uint(ne1 * ne2));
      }
    }
    __syncthreads();
    {
      const float nv0 = __uint_as_float(s_max[0]), ne1 = __uint_as_float(s_max[1]);
      const float ne2 = __uint_as_float(s_max[2]), pmax = __uint_as_float(s_max[3]);
      const float pk = kErr * pmax, ne = fmaxf(ne1, ne2);
      // The staged terms' magnitudes: p1, p2 up to nv0 ne, n up to P, c2
      // up to nv0 P.
      const float tri_mag = fmaxf(fmaxf(nv0 * ne, nv0 * pmax), pmax);
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        Ray& r = ray[j];
        r.px = r.ox - cx;
        r.py = r.oy - cy;
        r.pz = r.oz - cz;
        r.mx = r.py * r.dz - r.pz * r.dy;
        r.my = r.pz * r.dx - r.px * r.dz;
        r.mz = r.px * r.dy - r.py * r.dx;
        const float no = fmaxf(fmaxf(fabsf(r.px), fabsf(r.py)), fabsf(r.pz));
        const float s = no + nv0;
        const float a = s * (nd[j] * kErr);
        r.eu = __fmaf_rn(a, ne2, kNumEps);
        r.ev = __fmaf_rn(a, ne1, kNumEps);
        r.et = __fmaf_rn(s, pk, kNumEps);
        r.ed = __fmaf_rn(nd[j], pk, kDetTiny);
        r.euv = r.eu + r.ev;
        // Where a term could overflow (an inf numerator would pass as
        // beyond every margin), the pre-test decides nothing.
        const float mag = fmaxf(fmaxf(fmaxf(no * nd[j], s * nd[j] * ne), s * pmax),
                                fmaxf(nd[j] * pmax, tri_mag));
        if (!(mag < kMagMax)) r.ed = __int_as_float(0x7f800000);
      }
    }
    for (int w0 = 0; w0 < steps; w0 += kWindow<kAnyHit>) {
      bool go = false;
#pragma unroll
      for (int j = 0; j < kRays; ++j) go |= live[j];
      // A thread with no live ray leaves (closest: no shuffle follows in
      // the loop); any-hit with several lanes, a warp with none, since the
      // ballot below needs every lane and the vote is the warp's.
      if (kAnyHit && kLanes > 1) {
        if (!__any_sync(kFull, go)) break;
      } else if (!go) {
        break;
      }
      const int wsteps = min(kWindow<kAnyHit>, steps - w0);
      unsigned keep[kRays];
#pragma unroll
      for (int j = 0; j < kRays; ++j) keep[j] = 0u;
#pragma unroll 4
      for (int s = 0; s < wsteps; ++s) {
        const int r = (w0 + s) * kLanes + g;
        const float4 ra = s_rows[0][r], rb = s_rows[1][r];
        const float4 rc = s_rows[2][r], rq = s_rows[3][r];
#pragma unroll
        for (int j = 0; j < kRays; ++j) {
          if (cull_keeps(ray[j], ra, rb, rc, rq)) keep[j] |= 1u << s;
        }
      }
      // Confirm the survivors in row order.
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        unsigned m = live[j] ? keep[j] : 0u;
        while (m != 0u) {
          const int s = __ffs(m) - 1;
          m &= m - 1u;
          const int r = (w0 + s) * kLanes + g;
          float t, u, v;
          if (mt_exact(ray[j], s_rows[4][r], s_rows[1][r], s_rows[2][r], best_t[j], t, u,
                       v)) {
            best_t[j] = t;
            best_slot[j] = base + r;
            best_u[j] = u;
            best_v[j] = v;
            if (kAnyHit) {
              live[j] = false;
              break;
            }
          }
        }
      }
      if (kAnyHit) {
        bool alive = false;
        if (kLanes > 1) {
          // A ray's lanes stop together; the warp leaves once all have.
#pragma unroll
          for (int j = 0; j < kRays; ++j) {
            if (__ballot_sync(kFull, !live[j]) & gmask) live[j] = false;
            alive |= live[j];
          }
          if (!__any_sync(kFull, alive)) break;
        } else {
#pragma unroll
          for (int j = 0; j < kRays; ++j) alive |= live[j];
          if (!alive) break;  // no shuffle or ballot inside: a lane may leave alone
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    // Merge the ray's partials: lexicographic (t, slot) minimum; for
    // any-hit, whether any lane hit.
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, best_t[j], off);
      const int os = __shfl_xor_sync(kFull, best_slot[j], off);
      const float ou = __shfl_xor_sync(kFull, best_u[j], off);
      const float ov = __shfl_xor_sync(kFull, best_v[j], off);
      if (os >= 0 &&
          (best_slot[j] < 0 || ot < best_t[j] || (ot == best_t[j] && os < best_slot[j]))) {
        best_t[j] = ot;
        best_slot[j] = os;
        best_u[j] = ou;
        best_v[j] = ov;
      }
    }
    const long long i = idx[j];
    if (i >= n || g != 0) continue;
    if (kAnyHit) {
      out_occ[i] = best_slot[j] >= 0;
    } else {
      const bool miss = best_slot[j] < 0;
      out_t[i] = miss ? kInf : best_t[j];
      out_tri[i] = best_slot[j];
      out_u[i] = best_u[j];
      out_v[i] = best_v[j];
    }
  }
}

template <bool kAnyHit>
int launch(int lanes, cudaStream_t s, const float* o, const float* d,
           const bool* active, const float* ray_t_max, float t_max,
           const float* tris, int n, int t_count, float* out_t, int* out_tri,
           float* out_u, float* out_v, bool* out_occ) {
  const long long rays_per_block = static_cast<long long>(kBlock) * kRays / lanes;
  const unsigned grid = static_cast<unsigned>((n + rays_per_block - 1) / rays_per_block);
#define MT_LAUNCH(L)                                                           \
  mt_brute_kernel<kAnyHit, L><<<grid, kBlock, 0, s>>>(                         \
      o, d, active, ray_t_max, t_max, tris, n, t_count, out_t, out_tri, out_u, \
      out_v, out_occ)
  switch (lanes) {
    case 1: MT_LAUNCH(1); break;
    case 2: MT_LAUNCH(2); break;
    case 4: MT_LAUNCH(4); break;
    case 8: MT_LAUNCH(8); break;
    case 16: MT_LAUNCH(16); break;
    case 32: MT_LAUNCH(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.  lanes:
// lanes per ray, 1, 2, 4, 8, 16 or 32.
extern "C" int mt_brute_closest(const float* o, const float* d,
                                const bool* active, const float* tris,
                                float t_max, int n, int t_count, int lanes,
                                float* out_t, int* out_tri, float* out_u,
                                float* out_v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<false>(lanes, static_cast<cudaStream_t>(stream), o, d, active,
                       nullptr, t_max, tris, n, t_count, out_t, out_tri, out_u,
                       out_v, nullptr);
}

extern "C" int mt_brute_anyhit(const float* o, const float* d,
                               const float* t_max, const bool* active,
                               const float* tris, int n, int t_count, int lanes,
                               bool* out_occ, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<true>(lanes, static_cast<cudaStream_t>(stream), o, d, active,
                      t_max, 0.0f, tris, n, t_count, nullptr, nullptr, nullptr,
                      nullptr, out_occ);
}

extern "C" const char* mt_brute_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
