// One bounce's Lambert shading for Hopper (sm_90a): kernel B6.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the bounce
// body that XLA fuses in caitlynrenderer_tpu/render/integrator.py:336-694
// (hit frame, emissive MIS, NEE set-up and contribution, cosine-weighted
// continuation), on the no-grad render path of a scene whose families are
// Lambert alone, with no texture and no environment.  The torch code of
// render/integrator.py (`hit_frame`, `surface`, `light_sample`,
// `continuation`; `shade_bounce_plain`, `shade_finish_plain`) is its plain
// twin, which the CPU and autograd paths still run.
//
// shade_bounce_kernel, one thread a lane, one launch a bounce between the
// closest-hit and the any-hit query:
//   1. the previous bounce's NEE, now that its any-hit has answered:
//      L += pending where cand & ~shadowed;
//   2. for a lane alive on entry whose query hit: the hit refined from its
//      shading row (Moller-Trumbore's t, u, v), the shading normal
//      (interpolated or geometric), n_flip and the offset hit point;
//   3. an emissive hit adds T * emission * w_mis (power heuristic against
//      prev_pdf, 1 on the first bounce) and ends the path;
//   4. NEE set-up: the light row picked by u_lp, the point on it, the unit
//      direction and distance, `cand` and `t_max` for the any-hit query,
//      and the contribution T * Le * f * w / pdf_light kept as `pending`;
//   5. the continuation: a cosine-weighted direction about n_flip, the hit
//      point as origin, T *= albedo, prev_pdf = the direction's pdf.
// A lane dead on entry, or whose query missed, writes cand = false,
// t_max = 0 and a unit placeholder direction, keeps T, and adds nothing.
// shade_finish_kernel is step 1 alone, after the last bounce's any-hit.
//
// Every expression is evaluated in the torch code's order with one
// rounding per torch op (--fmad=false, IEEE sqrtf, division, cosf, sinf),
// and each constant is the float the torch op rounds its Python scalar to
// (double first, then float: static_cast<float> of the double literal).
// A division by the Python scalar pi is a product with its float
// reciprocal, as PyTorch's CUDA division by a host scalar computes it.
// clamp propagates NaN as torch.clamp does.
//
// What bounds it on an H100: device memory.  A live lane reads its state
// (o, d, T, L, prev_pdf, the flags, five uniforms, the previous NEE's
// pending, ~100 B) and a shading row (~120 B of 200, once per lane; rows
// repeat across lanes and stay in L1/L2 on small scenes) and writes ~70 B;
// a dead lane reads 1-2 B and writes 18 B.  The arithmetic (~250 FP32
// operations a live lane, two of them trig) is far below the memory's
// rate.  So the design keeps a lane's whole bounce in registers, reads
// each input once, writes each output once, and lets a dead lane leave
// after its few stores; the outputs are (N, 3) rows, so a warp's stores
// cover consecutive bytes.

#include <cuda_runtime.h>

// The C entry's arguments; ops/shade.py's _Args mirrors this struct.  Outside
// the anonymous namespace: the C entry that takes it has external linkage.
struct ShadeArgs {
  long long n;             // lanes
  int n_u;                 // uniforms a lane (4 + 7 * max_depth)
  int u_base;              // this bounce's first uniform: 4 + 7 * bounce
  int first;               // bounce 0: every lane arrives specularly (w_mis 1)
  int exact_nee;           // RenderOptions.exact_reference_nee
  int num_lights;          // rows of light_tab, >= 1
  float pdf_select;        // float(1 / num_lights)
  const float* o_in;       // (n, 3) ray origins of this bounce's query
  const float* d_in;       // (n, 3) ray directions
  const int* tri;          // (n,) the closest hit's triangle, -1 on a miss
  const float* uniforms;   // (n, n_u)
  const float* shade_tab;  // (T, 50)
  const float* light_tab;  // (num_lights, 17)
  const bool* prev_cand;   // (n,) the previous bounce's any-hit candidates, or null
  const bool* prev_shadowed;  // (n,) its answer, or null
  const float* prev_pending;  // (n, 3) its contribution, or null
  bool* alive;             // (n,) in place: alive entering, alive leaving
  float* T;                // (n, 3) throughput, in place
  float* L;                // (n, 3) radiance, in place
  float* prev_pdf;         // (n,) the continuation's pdf, in place
  float* o_out;            // (n, 3) next origins (the hit point); may be o_in
  float* d_out;            // (n, 3) next directions; may be d_in
  float* ldir;             // (n, 3) the any-hit query's directions
  float* t_max;            // (n,) the any-hit query's t_max (0 where not cand)
  bool* cand;              // (n,) the any-hit query's lanes
  float* pending;          // (n, 3) the NEE contribution where cand
};

namespace {

constexpr int kBlock = 256;
constexpr int kRow = 50;       // columns of the shading table
constexpr int kLightRow = 17;  // columns of the light table

// The floats the torch code's Python scalars round to.
constexpr float kEps = static_cast<float>(1e-4);          // integrator.EPS
constexpr float kRayOffset = static_cast<float>(2e-4);    // integrator.RAY_OFFSET
constexpr float kTiny = static_cast<float>(1e-20);        // clamps and normalize
constexpr float kCosFloor = static_cast<float>(1e-8);     // light cosine, pdf floor
constexpr float kOnbFloor = static_cast<float>(1e-7);     // core/math.onb
constexpr float kPole = static_cast<float>(-0.9999999);   // core/math.onb
constexpr float kPdfCap = static_cast<float>(1e12);       // _power_heuristic
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kInvPi = 1.0f / static_cast<float>(3.141592653589793);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ V3 ldg3(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): NaN passes through
// (v != v only for NaN: fast math is never on).
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// core/math.normalize: v * (1 / sqrt(max(dot(v, v), 1e-20))).
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, 1.0f / sqrtf(clamp_min(dot(v, v), kTiny)));
}

// integrator._power_heuristic.
__device__ __forceinline__ float power_heuristic(float a, float b) {
  a = clamp(a, 0.0f, kPdfCap);
  b = clamp(b, 0.0f, kPdfCap);
  const float t = a * a;
  return t / clamp_min(b * b + t, kTiny);
}

// integrator._light_pdf: dist^2 / (area * cos), times the selection pdf.
__device__ __forceinline__ float light_pdf(float dist, float area, float cos_light,
                                           float pdf_select) {
  return dist * dist / clamp_min(area * clamp_min(cos_light, kCosFloor), kTiny) * pdf_select;
}

// What a lane that shades nothing more writes: no any-hit query, and the
// next query's ray unchanged where it is written to a buffer of its own.
__device__ __forceinline__ void leave(const ShadeArgs& a, long long i) {
  a.cand[i] = false;
  a.t_max[i] = 0.0f;
  store3(a.ldir + 3 * i, {0.0f, 0.0f, 1.0f});
  if (a.o_out != a.o_in) {
    store3(a.o_out + 3 * i, load3(a.o_in + 3 * i));
    store3(a.d_out + 3 * i, load3(a.d_in + 3 * i));
  }
}

__global__ void __launch_bounds__(kBlock) shade_bounce_kernel(const ShadeArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= a.n) return;

  // 1. The previous bounce's NEE.
  V3 L{0.0f, 0.0f, 0.0f};
  bool l_read = false;
  if (a.prev_pending != nullptr && a.prev_cand[i] && !a.prev_shadowed[i]) {
    const V3 p = load3(a.prev_pending + 3 * i);
    L = load3(a.L + 3 * i);
    L = {L.x + p.x, L.y + p.y, L.z + p.z};
    l_read = true;
  }
  const bool live = a.alive[i];
  const int tri = live ? a.tri[i] : -1;
  if (tri < 0) {
    if (live) a.alive[i] = false;
    if (l_read) store3(a.L + 3 * i, L);
    leave(a, i);
    return;
  }

  // 2. The hit frame (integrator.hit_frame, ops/intersect.mt_uvt).
  const V3 o = load3(a.o_in + 3 * i);
  const V3 d = load3(a.d_in + 3 * i);
  const float* row = a.shade_tab + static_cast<long long>(tri) * kRow;
  const V3 v0 = ldg3(row), e1 = ldg3(row + 3), e2 = ldg3(row + 6);
  const V3 pv = cross(d, e2);
  const float det = dot(e1, pv);
  const float inv_det = 1.0f / (fabsf(det) < kTiny ? kTiny : det);
  const V3 tv = sub(o, v0);
  const V3 qv = cross(tv, e1);
  const float u = dot(tv, pv) * inv_det;
  const float v = dot(d, qv) * inv_det;
  const float t = dot(e2, qv) * inv_det;
  V3 n;
  if (__ldg(row + 18) > 0.5f) {
    const float w = (1.0f - u) - v;
    const V3 n0 = ldg3(row + 9), n1 = ldg3(row + 12), n2 = ldg3(row + 15);
    n = normalize({(n0.x * w + n1.x * u) + n2.x * v, (n0.y * w + n1.y * u) + n2.y * v,
                   (n0.z * w + n1.z * u) + n2.z * v});
  } else {
    n = normalize(cross(e1, e2));
  }
  const V3 nf = dot(d, n) > 0.0f ? V3{-n.x, -n.y, -n.z} : n;
  const V3 hp = {(o.x + d.x * t) + nf.x * kRayOffset, (o.y + d.y * t) + nf.y * kRayOffset,
                 (o.z + d.z * t) + nf.z * kRayOffset};

  // 3. An emissive hit, weighted against the NEE that could have sampled it.
  const V3 T = load3(a.T + 3 * i);
  if (__ldg(row + 33) != -1.0f) {
    if (!l_read) L = load3(a.L + 3 * i);
    const int last = a.num_lights - 1;
    const int li_hit = min(max(static_cast<int>(rintf(__ldg(row + 25))), 0), last);
    const float area = __ldg(a.light_tab + static_cast<long long>(li_hit) * kLightRow + 15);
    const float pdf = light_pdf(t, area, -dot(d, nf), a.pdf_select);
    const float w = a.first ? 1.0f : power_heuristic(a.prev_pdf[i], pdf);
    const V3 e = ldg3(row + 30);
    L = {L.x + (T.x * e.x) * w, L.y + (T.y * e.y) * w, L.z + (T.z * e.z) * w};
    store3(a.L + 3 * i, L);
    a.alive[i] = false;
    leave(a, i);
    return;
  }

  // 4. NEE set-up (integrator.light_sample) and the pending contribution.
  const float* ur = a.uniforms + i * a.n_u + a.u_base;
  const float u_lp = ur[0], u_l1 = ur[1], u_l2 = ur[2], u_b1 = ur[3], u_b2 = ur[4];
  const long long li = min(static_cast<long long>(u_lp * static_cast<float>(a.num_lights)),
                           static_cast<long long>(a.num_lights - 1));
  const float* lr = a.light_tab + li * kLightRow;
  const float s = sqrtf(u_l1);
  const float b0 = 1.0f - s;
  const float b1 = u_l2 * s;
  const V3 lp = ldg3(lr), le1 = ldg3(lr + 3), le2 = ldg3(lr + 6);
  const V3 lpos = {(lp.x + b0 * le1.x) + b1 * le2.x, (lp.y + b0 * le1.y) + b1 * le2.y,
                   (lp.z + b0 * le1.z) + b1 * le2.z};
  V3 ld = sub(lpos, hp);
  const float dist = sqrtf(clamp_min(dot(ld, ld), 0.0f));
  const float div = clamp_min(dist, kTiny);
  ld = {ld.x / div, ld.y / div, ld.z / div};
  const float cos_mtl = dot(ld, nf);
  const float cos_light = dot(ld, ldg3(lr + 9));
  const bool c = cos_mtl > 0.0f && cos_light < 0.0f;
  a.cand[i] = c;
  a.t_max[i] = c ? dist - kEps : 0.0f;
  store3(a.ldir + 3 * i, ld);
  const V3 alb = ldg3(row + 26);
  if (c) {
    const float pdf = light_pdf(dist, __ldg(lr + 15), -cos_light, a.pdf_select);
    const float cos_pos = clamp_min(cos_mtl, 0.0f);
    const float f_scale = cos_pos * kInvPi;
    const V3 f = a.exact_nee ? alb : scale(alb, f_scale);
    const float w = power_heuristic(pdf, cos_pos * kInvPi);
    const float k = w / clamp_min(pdf, kTiny);
    const V3 le = ldg3(lr + 12);
    store3(a.pending + 3 * i,
           {((T.x * le.x) * f.x) * k, ((T.y * le.y) * f.y) * k, ((T.z * le.z) * f.z) * k});
  }

  // 5. The continuation (core/math.cosine_hemisphere_dir, onb,
  // local_to_world; integrator.continuation's Lambert lobe).
  const float r = sqrtf(u_b1);
  const float phi = u_b2 * kTwoPi;
  const float lx = r * cosf(phi), ly = r * sinf(phi);
  const float lz = sqrtf(clamp_min(1.0f - u_b1, 0.0f));
  V3 ub, vb;
  if (nf.z < kPole) {
    ub = {0.0f, -1.0f, 0.0f};
    vb = {-1.0f, 0.0f, 0.0f};
  } else {
    const float inv = 1.0f / clamp_min(nf.z + 1.0f, kOnbFloor);
    const float b = (-nf.x * nf.y) * inv;
    ub = {1.0f - (nf.x * nf.x) * inv, b, -nf.x};
    vb = {b, 1.0f - (nf.y * nf.y) * inv, -nf.y};
  }
  const V3 dir = {(ub.x * lx + vb.x * ly) + nf.x * lz, (ub.y * lx + vb.y * ly) + nf.y * lz,
                  (ub.z * lx + vb.z * ly) + nf.z * lz};
  a.prev_pdf[i] = clamp_min(lz, kCosFloor) * kInvPi;
  store3(a.T + 3 * i, {T.x * alb.x, T.y * alb.y, T.z * alb.z});
  store3(a.o_out + 3 * i, hp);
  store3(a.d_out + 3 * i, normalize(dir));
  if (l_read) store3(a.L + 3 * i, L);
}

__global__ void __launch_bounds__(kBlock)
    shade_finish_kernel(long long n, const bool* __restrict__ cand,
                        const bool* __restrict__ shadowed, const float* __restrict__ pending,
                        float* __restrict__ L) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n || !cand[i] || shadowed[i]) return;
  const V3 p = load3(pending + 3 * i);
  const V3 l = load3(L + 3 * i);
  store3(L + 3 * i, {l.x + p.x, l.y + p.y, l.z + p.z});
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + kBlock - 1) / kBlock); }

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.

extern "C" int shade_bounce(const ShadeArgs* args, int device, void* stream) {
  if (args->n < 0 || args->num_lights < 1 || args->u_base < 0 || args->u_base + 7 > args->n_u)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  shade_bounce_kernel<<<blocks(args->n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shade_finish(long long n, const bool* cand, const bool* shadowed,
                            const float* pending, float* L, int device, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  shade_finish_kernel<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      n, cand, shadowed, pending, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
