// One bounce's shading for Hopper (sm_90a): kernel B6.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the bounce
// body that XLA fuses in caitlynrenderer_tpu/render/integrator.py:336-694
// (hit frame, emissive MIS, NEE set-up and contribution, continuation, the
// Disney branch at :534-622, the mirror and glass lobes), on the no-grad
// render path of a scene whose families are Lambert with any of Disney,
// mirror and glass, with no texture and no environment.  The torch code of
// render/integrator.py (`hit_frame`, `surface`, `light_sample`,
// `bsdf_toward`, `continuation`, `_emitted`; `shade_bounce_plain`,
// `shade_finish_plain`) and ops/bsdf.py is its plain twin, which the CPU
// and autograd paths still run.
//
// shade_bounce_kernel, one thread a lane, one launch a bounce between the
// closest-hit and the any-hit query:
//   1. the previous bounce's NEE, now that its any-hit has answered:
//      L += pending where cand & ~shadowed;
//   2. for a lane alive on entry whose query hit: the hit refined from its
//      shading row (Moller-Trumbore's t, u, v), the shading normal
//      (interpolated or geometric), n_flip and the offset hit point;
//   3. an emissive hit adds T * emission * w_mis (power heuristic against
//      prev_pdf; 1 on the first bounce and after a delta lobe) and ends the
//      path;
//   4. NEE set-up: the light row picked by u_lp, the point on it, the unit
//      direction and distance, `cand` and `t_max` for the any-hit query,
//      and the contribution T * Le * f * w / pdf_light kept as `pending`;
//   5. the continuation: a cosine-weighted direction about n_flip, the hit
//      point as origin, T *= albedo, prev_pdf = the direction's pdf.
// A lane dead on entry, or whose query missed, writes cand = false,
// t_max = 0 and a unit placeholder direction, keeps T, and adds nothing.
// shade_finish_kernel is step 1 alone, after the last bounce's any-hit.
//
// The kernel is a template on kDisney and kDelta.  shade_bounce_kernel
// <false, false> shades every lane as Lambert (a scene of the Lambert
// family alone).  With kDisney a lane whose material is neither a Lambert
// nor a specular type takes the Disney BRDF (ops/bsdf.py) instead, from
// its row's columns 37-44: in 4, f and the pdf toward the light from
// `eval_pdf`; in 5, a direction from `sample` (the lobe picked by u_lobe),
// T *= f / pdf and prev_pdf = max(pdf, 1e-9), and the path ends where
// pdf <= 1e-9.  Every lobe is evaluated for every Disney lane (diffuse
// with subsurface, sheen, GGX, clearcoat), as the torch code evaluates
// them.  With kDelta (the families hold mirror or glass) a lane of a
// specular type (core/types.SPECULAR_TYPES, CONDUCTOR included) takes no
// NEE in 4; in 5 a MIRROR lane, where the families hold "mirror", reflects
// about n_flip, and a glass lane, where they hold "glass", reflects or
// refracts by Fresnel (total internal reflection included) against u_lobe,
// a refracted ray leaving 2 RAY_OFFSET through the surface; both keep
// T *= albedo, set prev_pdf = 1 and the `specular` flag that step 3 of the
// next bounce reads.  A specular lane with neither lobe (CONDUCTOR)
// scatters as Lambert.  The two instantiations without kDelta keep the
// code and registers of a kernel without the delta branch.
//
// Every expression is evaluated in the torch code's order with one
// rounding per torch op (--fmad=false, IEEE sqrtf and division, cosf, sinf,
// logf, powf: the functions torch's CUDA ops call), and each constant is
// the float the torch op rounds its Python scalar to (double first, then
// float: static_cast<float> of the double literal, or of the Python
// expression the code folds).  A division by the Python scalar pi is a
// product with its float reciprocal, as PyTorch's CUDA division by a host
// scalar computes it; `1.0 / x` is torch's reciprocal, an IEEE division.
// clamp propagates NaN as torch.clamp does.
//
// What bounds it on an H100: device memory.  A live lane reads its state
// (o, d, T, L, prev_pdf, the flags, five uniforms, the previous NEE's
// pending, ~100 B) and a shading row (~120 B of 200, once per lane; rows
// repeat across lanes and stay in L1/L2 on small scenes) and writes ~70 B;
// a dead lane reads 1-2 B and writes 18 B.  A Disney lane reads 36 B more
// (eight row columns and a sixth uniform); a delta lane its type and a
// glass lane its ior and sixth uniform, and every lane that goes on under
// kDelta writes its specular flag.  The arithmetic (~250 FP32 operations a
// live Lambert lane, two of them trig; ~600 more a Disney lane, ~60 a
// glass lane) is far below the memory's rate.  So the design keeps a
// lane's whole bounce in registers, reads each input once, writes each
// output once, and lets a dead lane leave after its few stores; the
// outputs are (N, 3) rows, so a warp's stores cover consecutive bytes.

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
  bool* specular;          // (n,) in place: the continuation was a delta lobe (kDelta), else null
  int mirror;              // the families hold "mirror": a MIRROR lane reflects (kDelta)
  int glass;               // the families hold "glass": a glass lane reflects or refracts (kDelta)
};

namespace {

constexpr int kBlock = 256;
constexpr int kRow = 50;       // columns of the shading table
constexpr int kLightRow = 17;  // columns of the light table

// The floats the torch code's Python scalars round to.
constexpr float kEps = static_cast<float>(1e-4);          // integrator.EPS
constexpr float kRayOffset = static_cast<float>(2e-4);    // integrator.RAY_OFFSET
constexpr float kTiny = static_cast<float>(1e-20);        // clamps and normalize
constexpr float kCosFloor = static_cast<float>(1e-8);     // light cosine, pdf, bsdf floors
constexpr float kOnbFloor = static_cast<float>(1e-7);     // core/math.onb
constexpr float kPole = static_cast<float>(-0.9999999);   // core/math.onb
constexpr float kPdfCap = static_cast<float>(1e12);       // _power_heuristic
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kInvPi = 1.0f / static_cast<float>(3.141592653589793);

// core/types.LAMBERT_TYPES (DIFFUSE 0, LIGHT_DIFFUSE 16) as a bit mask of
// material type ids: a row of another type is shaded by the Disney BRDF.
constexpr unsigned long long kLambertTypes = (1ull << 0) | (1ull << 16);

// The delta lobes (integrator.surface, continuation): core/types.
// SPECULAR_TYPES (MIRROR 1, the glass types, CONDUCTOR 6) and the
// integrator's _GLASS_IDS as bit masks, MIRROR's id, and the Python scalars
// of the glass lobe as its torch ops round them.
constexpr unsigned long long kSpecularTypes = (1ull << 1) | (1ull << 2) | (1ull << 3) |
                                              (1ull << 4) | (1ull << 5) | (1ull << 6) |
                                              (1ull << 13) | (1ull << 14);
constexpr unsigned long long kGlassTypes = (1ull << 2) | (1ull << 3) | (1ull << 4) | (1ull << 5) |
                                           (1ull << 13) | (1ull << 14);
constexpr int kMirrorType = 1;
constexpr float kIorFloor = static_cast<float>(1e-6);               // eta's ior clamp
constexpr float kFresnelFloor = static_cast<float>(1e-12);          // cos_t, r_par, r_perp
constexpr float kRefractOffset = static_cast<float>(-2.0 * 2e-4);   // -2.0 * RAY_OFFSET

// ops/bsdf.py's Python scalars, as its torch ops round them.
constexpr float kPi = static_cast<float>(3.141592653589793);       // math.pi
constexpr float kRoughMin = static_cast<float>(0.02);              // roughness clamp
constexpr float kIorMin = static_cast<float>(1.01);                // ior clamp
constexpr float kAlphaMin = static_cast<float>(1e-4);              // alpha, GTR1 a2
constexpr float kGtr1Max = static_cast<float>(0.9999);             // GTR1 a2
constexpr float kCosMin = static_cast<float>(1e-6);                // ndv, ndl
constexpr float kBsdfTiny = static_cast<float>(1e-12);             // GTR, sampling
constexpr float kGtr1Neg = static_cast<float>(-1e-12);             // GTR1's denominator
constexpr float kBelowOne = static_cast<float>(1.0 - 1e-12);       // sampling's cos
constexpr float kPdfMin = static_cast<float>(1e-9);                // continuation
constexpr float kLumR = static_cast<float>(0.2126);                // core/math.luminance
constexpr float kLumG = static_cast<float>(0.7152);
constexpr float kLumB = static_cast<float>(0.0722);
constexpr float kSpecBias = static_cast<float>(0.08);              // specular lobe weight
constexpr float kCcSlope = static_cast<float>(0.001 - 0.1);        // lerp(0.1, 0.001, gloss)
constexpr float kCcBase = static_cast<float>(0.1);
constexpr float kCcF0 = static_cast<float>(0.04);                  // clearcoat Fresnel
constexpr float kCcF1 = static_cast<float>(0.96);
constexpr float kSsScale = static_cast<float>(1.25);               // subsurface

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

// torch.clamp(v, min=lo), (v, max=hi) and (v, lo, hi): NaN passes through
// (v != v only for NaN: fast math is never on).
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
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

// ---- The Disney BRDF (ops/bsdf.py), one lane ----------------------------

// bsdf.DisneyParams, from a row by bsdf.params_from_rows (scene.py's column
// map: 37 ior, 38:42 disney, 42:46 disney2).
struct Disney {
  V3 base;
  float roughness, metallic, spec_tint, sheen, clearcoat, clearcoat_gloss, subsurface, ior;
};

__device__ __forceinline__ Disney disney_params(const float* row, V3 base) {
  return {base,
          clamp(__ldg(row + 38), kRoughMin, 1.0f),
          __ldg(row + 39),
          __ldg(row + 40),
          __ldg(row + 41),
          __ldg(row + 42),
          __ldg(row + 43),
          __ldg(row + 44),
          clamp_min(__ldg(row + 37), kIorMin)};
}

__device__ __forceinline__ float luminance(V3 c) {
  return (c.x * kLumR + c.y * kLumG) + c.z * kLumB;
}

__device__ __forceinline__ float schlick(float m) {
  m = clamp(1.0f - m, 0.0f, 1.0f);
  const float m2 = m * m;
  return m * (m2 * m2);
}

__device__ __forceinline__ float gtr2(float ndh, float a) {
  const float a2 = a * a;
  const float t = ((a2 - 1.0f) * ndh) * ndh + 1.0f;
  return a2 / clamp_min((t * kPi) * t, kBsdfTiny);
}

__device__ __forceinline__ float gtr1(float ndh, float a) {
  const float a2 = clamp(a * a, kAlphaMin, kGtr1Max);
  const float t = ((a2 - 1.0f) * ndh) * ndh + 1.0f;
  return (a2 - 1.0f) / clamp_max((logf(a2) * kPi) * t, kGtr1Neg);
}

__device__ __forceinline__ float smith_g_ggx(float ndv, float a) {
  const float a2 = a * a;
  const float b = ndv * ndv;
  return 1.0f / clamp_min(ndv + sqrtf((a2 + b) - a2 * b), kCosFloor);
}

// bsdf._tint: the base color over its luminance, white where that is 0.
__device__ __forceinline__ V3 tint(V3 c) {
  const float lum = luminance(c);
  if (!(lum > 0.0f)) return {1.0f, 1.0f, 1.0f};
  const float den = clamp_min(lum, kCosFloor);
  return {c.x / den, c.y / den, c.z / den};
}

// bsdf._spec_f0, one channel: f0 of the dielectric, tinted, blended with
// the base color by metallic.
__device__ __forceinline__ float spec_f0(float f0s, float spec_tint, float tint_c,
                                         float metallic, float base_c) {
  const float dielectric = f0s * ((1.0f - spec_tint) + spec_tint * tint_c);
  return dielectric * (1.0f - metallic) + base_c * metallic;
}

__device__ __forceinline__ V3 spec_f0(const Disney& p) {
  const float q = (p.ior - 1.0f) / (p.ior + 1.0f);
  const float f0s = q * q;
  const V3 t = tint(p.base);
  return {spec_f0(f0s, p.spec_tint, t.x, p.metallic, p.base.x),
          spec_f0(f0s, p.spec_tint, t.y, p.metallic, p.base.y),
          spec_f0(f0s, p.spec_tint, t.z, p.metallic, p.base.z)};
}

// bsdf._lobe_weights: the (diffuse, specular, clearcoat) sampling weights.
__device__ __forceinline__ V3 lobe_weights(const Disney& p) {
  const float w_diff = (1.0f - p.metallic) * luminance(p.base);
  const float w_spec = luminance(spec_f0(p)) + kSpecBias;
  const float w_cc = p.clearcoat * 0.25f;
  const float total = clamp_min((w_diff + w_spec) + w_cc, kCosFloor);
  return {w_diff / total, w_spec / total, w_cc / total};
}

// bsdf.eval_pdf: the cos-premultiplied BRDF toward l and its sampling pdf,
// both 0 where l lies under the surface.
__device__ __forceinline__ float eval_pdf(const Disney& p, V3 n, V3 v, V3 l, V3& f) {
  const float ndv = clamp_min(dot(n, v), kCosMin);
  const float ndl = dot(n, l);
  const bool valid = ndl > kCosMin;
  const float ndl_c = clamp_min(ndl, kCosMin);
  const V3 h = normalize({v.x + l.x, v.y + l.y, v.z + l.z});
  const float ndh = clamp(dot(n, h), 0.0f, 1.0f);
  const float ldh = clamp(dot(l, h), 0.0f, 1.0f);
  const float a = clamp_min(p.roughness * p.roughness, kAlphaMin);

  // Diffuse (Burley retro-reflection) and the subsurface approximation.
  const float fl = schlick(ndl_c);
  const float fv = schlick(ndv);
  const float fd90 = ((ldh * 2.0f) * ldh) * p.roughness + 0.5f;
  const float fd = ((fd90 - 1.0f) * fl + 1.0f) * ((fd90 - 1.0f) * fv + 1.0f);
  const float fss90 = (ldh * ldh) * p.roughness;
  const float fss = ((fss90 - 1.0f) * fl + 1.0f) * ((fss90 - 1.0f) * fv + 1.0f);
  const float ss = (fss * (1.0f / clamp_min(ndl_c + ndv, kCosMin) - 0.5f) + 0.5f) * kSsScale;
  const float diff_mix = fd * (1.0f - p.subsurface) + ss * p.subsurface;

  // Sheen, GGX specular (metallic workflow), clearcoat (GTR1).
  const float s_ldh = schlick(ldh);
  const V3 t = tint(p.base);
  const float d_spec = gtr2(ndh, a);
  const V3 f0 = spec_f0(p);
  const float g_spec = smith_g_ggx(ndl_c, a) * smith_g_ggx(ndv, a);
  const float a_cc = p.clearcoat_gloss * kCcSlope + kCcBase;
  const float d_cc = gtr1(ndh, a_cc);
  const float f_cc = s_ldh * kCcF1 + kCcF0;
  const float g_cc = smith_g_ggx(ndl_c, 0.25f) * smith_g_ggx(ndv, 0.25f);
  const float f_clearcoat = ((((p.clearcoat * 0.25f) * d_cc) * f_cc) * g_cc) * 0.25f;
  const float dielectric = 1.0f - p.metallic;
  const float base[3] = {p.base.x, p.base.y, p.base.z};
  const float tints[3] = {t.x, t.y, t.z};
  const float f0s[3] = {f0.x, f0.y, f0.z};
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f_diffuse = (base[c] * kInvPi) * diff_mix;
    const float f_sheen = (p.sheen * ((1.0f - p.spec_tint) + p.spec_tint * tints[c])) * s_ldh;
    const float fresnel = f0s[c] + (1.0f - f0s[c]) * s_ldh;
    const float f_specular = ((d_spec * fresnel) * g_spec) * 0.25f;
    out[c] = (((f_diffuse + f_sheen) * dielectric + f_specular) + f_clearcoat) * ndl_c;
  }

  // The pdf: the lobe mixture.
  const V3 w = lobe_weights(p);
  const float pdf_diff = ndl_c * kInvPi;
  const float pdf_spec = (d_spec * ndh) / clamp_min(ldh * 4.0f, kCosFloor);
  const float pdf_cc = (d_cc * ndh) / clamp_min(ldh * 4.0f, kCosFloor);
  const float pdf = (w.x * pdf_diff + w.y * pdf_spec) + w.z * pdf_cc;
  f = valid ? V3{out[0], out[1], out[2]} : V3{0.0f, 0.0f, 0.0f};
  return valid ? pdf : 0.0f;
}

// core/math.local_to_world of a local direction in the basis (ub, vb, n).
__device__ __forceinline__ V3 to_world(V3 ub, V3 vb, V3 n, float lx, float ly, float lz) {
  return {(ub.x * lx + vb.x * ly) + n.x * lz, (ub.y * lx + vb.y * ly) + n.y * lz,
          (ub.z * lx + vb.z * ly) + n.z * lz};
}

// core/math.reflect(d, h): d - 2 (d . h) h.
__device__ __forceinline__ V3 reflect(V3 d, V3 h) {
  const float k = dot(d, h) * 2.0f;
  return {d.x - k * h.x, d.y - k * h.y, d.z - k * h.z};
}

// A half-vector about n with cos^2 theta = ct2 and azimuth 2 pi u1
// (bsdf._sample_ggx_h and _sample_gtr1_h after ct2), reflected: the
// outgoing direction of incident d.
__device__ __forceinline__ V3 reflect_about_half(V3 d, V3 ub, V3 vb, V3 n, float ct2, float u1) {
  const float phi = u1 * kTwoPi;
  const float ct = sqrtf(clamp(ct2, kBsdfTiny, kBelowOne));
  const float st = sqrtf(clamp(1.0f - ct2, kBsdfTiny, kBelowOne));
  return reflect(d, to_world(ub, vb, n, st * cosf(phi), st * sinf(phi), ct));
}

// bsdf.sample: the lobe picked by u_lobe against the lobe weights, a
// direction sampled within it (l_diff: the cosine-weighted one, already
// made), normalized; f and the pdf toward it from eval_pdf.
__device__ __forceinline__ V3 disney_sample(const Disney& p, V3 n, V3 ub, V3 vb, V3 d,
                                            V3 l_diff, float u_lobe, float u1, float u2,
                                            V3& f, float& pdf) {
  const V3 w = lobe_weights(p);
  const float a = clamp_min(p.roughness * p.roughness, kAlphaMin);
  const float a_cc = p.clearcoat_gloss * kCcSlope + kCcBase;
  const float ct2_spec = (1.0f - u2) / clamp_min(((a * a) - 1.0f) * u2 + 1.0f, kBsdfTiny);
  const V3 l_spec = reflect_about_half(d, ub, vb, n, ct2_spec, u1);
  const float a2 = clamp(a_cc * a_cc, kAlphaMin, kGtr1Max);
  const float ct2_cc = (1.0f - powf(a2, 1.0f - u2)) / clamp_min(1.0f - a2, kCosFloor);
  const V3 l_cc = reflect_about_half(d, ub, vb, n, ct2_cc, u1);
  const float w_ds = w.x + w.y;
  const bool pick_spec = u_lobe >= w.x && u_lobe < w_ds;
  const bool pick_cc = u_lobe >= w_ds;
  const V3 l = normalize(pick_cc ? l_cc : (pick_spec ? l_spec : l_diff));
  pdf = eval_pdf(p, n, {-d.x, -d.y, -d.z}, l, f);
  return l;
}

// A material type id among the types of bit mask `mask` (integrator._type_is).
__device__ __forceinline__ bool has_type(int type, unsigned long long mask) {
  return type >= 0 && type <= 63 && ((mask >> type) & 1ull);
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

template <bool kDisney, bool kDelta>
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
    // w_mis is 1 after a delta lobe (integrator._emitted's is_specular).
    const float w = a.first || (kDelta && a.specular[i]) ? 1.0f
                                                         : power_heuristic(a.prev_pdf[i], pdf);
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
  // The specular lanes (integrator.surface, light_sample): no NEE.
  int type = 0;
  bool specular = false;
  if constexpr (kDelta) {
    type = static_cast<int>(rintf(__ldg(row + 29)));
    specular = has_type(type, kSpecularTypes);
  }
  const bool c = cos_mtl > 0.0f && cos_light < 0.0f && !specular;
  a.cand[i] = c;
  a.t_max[i] = c ? dist - kEps : 0.0f;
  store3(a.ldir + 3 * i, ld);
  const V3 alb = ldg3(row + 26);
  // The Disney BRDF's lanes (integrator.surface): a type that is neither
  // Lambert nor specular.
  bool disney = false;
  Disney p;
  if constexpr (kDisney) {
    const int t = kDelta ? type : static_cast<int>(rintf(__ldg(row + 29)));
    disney = !specular && (t < 0 || t > 63 || !((kLambertTypes >> t) & 1ull));
    if (disney) p = disney_params(row, alb);
  }
  if (c) {
    const float pdf = light_pdf(dist, __ldg(lr + 15), -cos_light, a.pdf_select);
    const float cos_pos = clamp_min(cos_mtl, 0.0f);
    const float f_scale = cos_pos * kInvPi;
    V3 f = a.exact_nee ? alb : scale(alb, f_scale);
    float bsdf_pdf = cos_pos * kInvPi;
    if constexpr (kDisney) {
      if (disney) bsdf_pdf = eval_pdf(p, nf, {-d.x, -d.y, -d.z}, ld, f);
    }
    const float w = power_heuristic(pdf, bsdf_pdf);
    const float k = w / clamp_min(pdf, kTiny);
    const V3 le = ldg3(lr + 12);
    store3(a.pending + 3 * i,
           {((T.x * le.x) * f.x) * k, ((T.y * le.y) * f.y) * k, ((T.z * le.z) * f.z) * k});
  }

  // 5. The continuation (core/math.cosine_hemisphere_dir, onb,
  // local_to_world; integrator.continuation's Lambert lobe, its Disney
  // sample, whose diffuse lobe is that direction, and its delta lobes).
  V3 origin = hp;
  if constexpr (kDelta) {
    const bool mirror = a.mirror && type == kMirrorType;
    if (mirror || (a.glass && has_type(type, kGlassTypes))) {
      V3 dir = reflect(d, nf);
      bool refracted = false;
      if (!mirror) {
        // Glass: Fresnel, or total internal reflection, against u_lobe.
        const float ior = __ldg(row + 37);
        const float eta = dot(d, n) <= 0.0f ? 1.0f / clamp_min(ior, kIorFloor) : ior;
        const float ci = fabsf(dot(d, nf));
        const float sin2_t = (eta * eta) * clamp_min(1.0f - ci * ci, 0.0f);
        const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, kFresnelFloor));
        const float r_par = (ci - eta * cos_t) / clamp_min(ci + eta * cos_t, kFresnelFloor);
        const float r_perp = (eta * ci - cos_t) / clamp_min(eta * ci + cos_t, kFresnelFloor);
        const bool tir = sin2_t >= 1.0f;
        const float fres = tir ? 1.0f : 0.5f * (r_par * r_par + r_perp * r_perp);
        refracted = !(ur[5] < fres || tir);
        if (refracted) {
          const float k = eta * ci - cos_t;
          dir = normalize({eta * d.x + k * nf.x, eta * d.y + k * nf.y, eta * d.z + k * nf.z});
        }
      }
      // Where the families hold glass the twin adds to every origin: the
      // refracted ray leaves from the other side of the surface, the
      // others get 0.
      if (a.glass) {
        origin = refracted ? V3{hp.x + kRefractOffset * nf.x, hp.y + kRefractOffset * nf.y,
                                hp.z + kRefractOffset * nf.z}
                           : V3{hp.x + 0.0f, hp.y + 0.0f, hp.z + 0.0f};
      }
      a.prev_pdf[i] = 1.0f;
      a.specular[i] = true;
      store3(a.T + 3 * i, {T.x * alb.x, T.y * alb.y, T.z * alb.z});
      store3(a.o_out + 3 * i, origin);
      store3(a.d_out + 3 * i, normalize(dir));
      if (l_read) store3(a.L + 3 * i, L);
      return;
    }
    if (a.glass) origin = {hp.x + 0.0f, hp.y + 0.0f, hp.z + 0.0f};
    a.specular[i] = false;
  }
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
  if constexpr (kDisney) {
    if (disney) {
      V3 f;
      float pdf;
      const V3 l = disney_sample(p, nf, ub, vb, d, dir, ur[5], u_b1, u_b2, f, pdf);
      const float pdf_c = clamp_min(pdf, kPdfMin);
      a.prev_pdf[i] = pdf_c;
      if (pdf > kPdfMin) {
        store3(a.T + 3 * i, {T.x * (f.x / pdf_c), T.y * (f.y / pdf_c), T.z * (f.z / pdf_c)});
      } else {
        a.alive[i] = false;  // no pdf: the path ends, T kept
      }
      store3(a.o_out + 3 * i, origin);
      store3(a.d_out + 3 * i, normalize(l));
      if (l_read) store3(a.L + 3 * i, L);
      return;
    }
  }
  a.prev_pdf[i] = clamp_min(lz, kCosFloor) * kInvPi;
  store3(a.T + 3 * i, {T.x * alb.x, T.y * alb.y, T.z * alb.z});
  store3(a.o_out + 3 * i, origin);
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

// The scene's families pick the instantiation: kDisney where `disney` (the
// families hold "disney"), kDelta where args->mirror or args->glass (they
// hold "mirror" or "glass"; args->specular must then be the flag).
extern "C" int shade_bounce(const ShadeArgs* args, int disney, int device, void* stream) {
  const bool delta = args->mirror || args->glass;
  if (args->n < 0 || args->num_lights < 1 || args->u_base < 0 || args->u_base + 7 > args->n_u ||
      (delta && args->specular == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = blocks(args->n);
  if (disney && delta)
    shade_bounce_kernel<true, true><<<g, kBlock, 0, s>>>(*args);
  else if (disney)
    shade_bounce_kernel<true, false><<<g, kBlock, 0, s>>>(*args);
  else if (delta)
    shade_bounce_kernel<false, true><<<g, kBlock, 0, s>>>(*args);
  else
    shade_bounce_kernel<false, false><<<g, kBlock, 0, s>>>(*args);
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
