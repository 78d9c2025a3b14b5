// Dense ray x triangle Moller-Trumbore for Hopper (sm_90a).
//
// Replaces caitlynrenderer_tpu/ops/pallas_mt.py:_kernel (entry points
// brute_closest_pallas / brute_anyhit_pallas): for every ray, test every row
// of a (T, 9) v0|e1|e2 slab in scene order and keep the nearest accepted
// (t, slot, u, v).  Acceptance is the Pallas kernel's, term for term:
//   u >= 0, v >= 0, (1 - u) - v >= 0, t >= 0, t < t_best, det != 0,
//   inv_det = 1 / (|det| < 1e-20 ? 1e-20 : det).
// The strict `<` in scene order makes the first-indexed triangle win ties.
// Inactive lanes enter with t_best = -INF and so accept nothing.
//
// What bounds it on an H100: at 36 triangles (the cornell box) the kernel
// is bound by launch cost and ray I/O (28 B in, 16 B out per ray); at 2048
// triangles by FP32 issue (~30 flops per ray-triangle pair).  Design for
// the second case: one thread per ray, the block stages the slab through
// shared memory in chunks of kChunk rows (a 2048-row slab is 72 KB), and
// every thread of a warp reads the same row, which shared memory
// broadcasts.  The any-hit variant stops a ray at its first accepted hit
// (the answer is the same boolean) and a block stops once all its rays have
// stopped.
//
// Built with --fmad=false and without fast math: the plain PyTorch twin
// (ops/mt_brute.py) evaluates the same expressions in the same order, so
// the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // rays per block, one per thread
constexpr int kChunk = 256;  // triangle rows staged in shared memory per pass
constexpr float kInf = 1e9f;

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) mt_brute_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const bool* __restrict__ active, const float* __restrict__ ray_t_max,
    float t_max, const float* __restrict__ tris, int n, int t_count,
    float* __restrict__ out_t, int* __restrict__ out_tri,
    float* __restrict__ out_u, float* __restrict__ out_v,
    bool* __restrict__ out_occ) {
  __shared__ float s_tris[kChunk * 9];

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in_range = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float best_t = -kInf;
  bool live = false;
  if (in_range) {
    ox = o[3 * i + 0];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i + 0];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    live = active[i];
    if (live) best_t = kAnyHit ? ray_t_max[i] : t_max;
  }
  int best_slot = -1;
  float best_u = 0.f, best_v = 0.f;

  for (int base = 0; base < t_count; base += kChunk) {
    // Barrier before the slab is overwritten; a block whose rays have all
    // stopped (inactive, or any-hit found) leaves together.
    if (!__syncthreads_or(live)) break;
    const int rows = min(kChunk, t_count - base);
    for (int k = threadIdx.x; k < rows * 9; k += kBlock) {
      s_tris[k] = tris[base * 9 + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < rows; ++r) {
      const float* tr = s_tris + 9 * r;
      const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
      const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
      const float e2x = tr[6], e2y = tr[7], e2z = tr[8];

      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
      const float tvx = ox - v0x;
      const float tvy = oy - v0y;
      const float tvz = oz - v0z;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      const bool ok = (u >= 0.0f) && (v >= 0.0f) && (1.0f - u - v >= 0.0f) &&
                      (t >= 0.0f) && (t < best_t) && (det != 0.0f);
      if (ok) {
        best_t = t;
        best_slot = base + r;
        best_u = u;
        best_v = v;
        if (kAnyHit) {
          live = false;
          break;
        }
      }
    }
  }

  if (!in_range) return;
  if (kAnyHit) {
    out_occ[i] = best_slot >= 0;
  } else {
    const bool miss = best_slot < 0;
    out_t[i] = miss ? kInf : best_t;
    out_tri[i] = best_slot;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int mt_brute_closest(const float* o, const float* d,
                                const bool* active, const float* tris,
                                float t_max, int n, int t_count, float* out_t,
                                int* out_tri, float* out_u, float* out_v,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mt_brute_kernel<false>
      <<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          o, d, active, nullptr, t_max, tris, n, t_count, out_t, out_tri,
          out_u, out_v, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mt_brute_anyhit(const float* o, const float* d,
                               const float* t_max, const bool* active,
                               const float* tris, int n, int t_count,
                               bool* out_occ, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mt_brute_kernel<true>
      <<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          o, d, active, t_max, 0.0f, tris, n, t_count, nullptr, nullptr,
          nullptr, nullptr, out_occ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mt_brute_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
