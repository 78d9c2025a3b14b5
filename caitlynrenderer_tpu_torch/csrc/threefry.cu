// Threefry-2x32 uniforms for Hopper (sm_90a): the renderer's sampler.
//
// Replaces caitlynrenderer_tpu/render/sampling.py:pixel_uniforms (:46,
// `vmap(uniform(fold_in(key, pid), (n_u,)))`) and draw_uniforms (:34,
// `uniform(key, (N, n_u))`), which XLA compiles to one fused computation
// each.  Bit for bit the plain twins of render/sampling.py
// (pixel_uniforms_plain, draw_uniforms_plain) and so jax.random under its
// default jax_threefry_partitionable=True:
//   threefry_pixel: element (i, j) of the (N, n_u) output is
//     (pk1, pk2) = threefry2x32(k1, k2, 0, uint32(ids[i]))
//     (b0, b1)   = threefry2x32(pk1, pk2, 0, j)
//     out        = float with mantissa (b0 ^ b1) >> 9 and exponent 0, - 1
//   threefry_lane: element e of the N * n_u output is
//     (b0, b1) = threefry2x32(k1, k2, 0, uint32(e)), out as above.
// The arithmetic is uint32 adds, rotations (funnel shifts) and xors, plus
// one float subtraction that is exact (the operand lies in [1, 2)), so the
// kernel and the twins agree on every bit.
//
// What bounds it on an H100: the integer ALU pipe.  A threefry is 20 rounds
// of add, rotate and xor and five key injections; the rotations and xors
// run on the ALU pipe only, the adds there or as IMAD on the FMA pipe, and
// 4 B of float32 out per element leaves the memory system far from its
// rate.  The design keeps every instruction on the element's own
// threefry: a block takes a tile of kTile consecutive elements, first folds
// the keys of the pixels the tile touches into shared memory (one threefry
// a pixel, not one an element), then each thread writes every kBlock-th
// element of the tile, so a warp's stores are 128 consecutive bytes.  A
// thread steps its (pixel, counter) pair along the tile without a
// division.  Element indices are 64-bit (a 1920x1080 frame at 8 bounces
// has 124 M elements).
//
// The pixel kernel takes the key's words either by value or, where they
// are tensors on the card (a CUDA graph's per-replay key), as pointers to
// int64 words read by the kernel, so a graph replays with whatever key was
// written before it.  The lane kernel's callers all hold the key on the
// host, so it takes the words by value.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kParity = 0x1BD11BDAu;  // Threefry's key-schedule constant
constexpr unsigned kOne = 0x3F800000u;     // the bits of 1.0f
constexpr int kMantissaShift = 9;          // 32 random bits -> 23 of mantissa
constexpr int kBlock = 256;
constexpr int kTile = kBlock * 8;  // elements a block writes per tile
constexpr int kMinUniforms = 4;    // n_u = 4 + 7 * max_depth
// Pixels a tile can touch: kTile elements at kMinUniforms a pixel, plus a
// partial pixel at each end.
constexpr int kTilePixels = (kTile - 1) / kMinUniforms + 2;

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(unsigned& x0, unsigned& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3) ^ x0;
}

// Threefry-2x32, 20 rounds, of the counter pair (0, x1) under (k1, k2).
__device__ __forceinline__ uint2 threefry2x32(unsigned k1, unsigned k2, unsigned x1) {
  const unsigned ks[3] = {k1, k2, k1 ^ k2 ^ kParity};
  unsigned x0 = ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      four_rounds<13, 15, 26, 6>(x0, x1);
    } else {
      four_rounds<17, 29, 16, 24>(x0, x1);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ float to_uniform(uint2 b) {
  return __uint_as_float(((b.x ^ b.y) >> kMantissaShift) | kOne) - 1.0f;
}

// A key word: the low 32 bits of *word where it is given, else value.
__device__ __forceinline__ unsigned key_word(const long long* word, unsigned value) {
  return word != nullptr ? static_cast<unsigned>(*word) : value;
}

__global__ void __launch_bounds__(kBlock)
    threefry_pixel_kernel(const long long* k1_word, const long long* k2_word, unsigned k1,
                          unsigned k2, const int* __restrict__ ids, long long n, int n_u,
                          float* __restrict__ out) {
  __shared__ uint2 keys[kTilePixels];
  k1 = key_word(k1_word, k1);
  k2 = key_word(k2_word, k2);
  const long long total = n * n_u;
  const long long tiles = (total + kTile - 1) / kTile;
  // A thread's next element lies kBlock further on: step_p pixels and
  // step_j counters, carrying once past n_u.
  const int step_p = kBlock / n_u, step_j = kBlock % n_u;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long e0 = t * kTile;
    const long long e1 = min(e0 + kTile, total);
    const long long p0 = e0 / n_u;
    const int pixels = static_cast<int>((e1 - 1) / n_u - p0) + 1;
    __syncthreads();  // the previous tile's keys are no longer read
    for (int q = threadIdx.x; q < pixels; q += kBlock) {
      keys[q] = threefry2x32(k1, k2, static_cast<unsigned>(ids[p0 + q]));
    }
    __syncthreads();
    const int l = static_cast<int>(e0 - p0 * n_u) + static_cast<int>(threadIdx.x);
    int p = l / n_u, j = l - p * n_u;
    for (long long e = e0 + threadIdx.x; e < e1; e += kBlock) {
      const uint2 k = keys[p];
      out[e] = to_uniform(threefry2x32(k.x, k.y, static_cast<unsigned>(j)));
      p += step_p;
      j += step_j;
      if (j >= n_u) {
        j -= n_u;
        ++p;
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    threefry_lane_kernel(unsigned k1, unsigned k2, long long total, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long e = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; e < total;
       e += stride) {
    out[e] = to_uniform(threefry2x32(k1, k2, static_cast<unsigned>(e)));
  }
}

// Blocks for `work` blocks' worth of elements: all of them, up to 16 a SM
// (the rest come round in the grid-stride loop).
int grid_for(long long work, int device, unsigned* grid) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = 16LL * sms;
  *grid = static_cast<unsigned>(work < cap ? work : cap);
  return 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each call launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.  In
// threefry_pixel a key word is read on the card from k*_word (an int64
// holding a uint32) where that is not null, else taken from k*.  ids: n
// int32 values; out: n * n_u floats; n_u >= 4.

extern "C" int threefry_pixel(const long long* k1_word, const long long* k2_word,
                              unsigned k1, unsigned k2, const int* ids, long long n, int n_u,
                              float* out, int device, void* stream) {
  if (n_u < kMinUniforms || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  const int rc = grid_for((n * n_u + kTile - 1) / kTile, device, &grid);
  if (rc != 0) return rc;
  threefry_pixel_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      k1_word, k2_word, k1, k2, ids, n, n_u, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_lane(unsigned k1, unsigned k2, long long total, float* out, int device,
                             void* stream) {
  if (total < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  const int rc = grid_for((total + kBlock - 1) / kBlock, device, &grid);
  if (rc != 0) return rc;
  threefry_lane_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(k1, k2, total,
                                                                              out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
