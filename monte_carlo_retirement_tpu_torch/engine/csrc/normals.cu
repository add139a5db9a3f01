// The port's draws computed on the card, for checks only: holds the device
// streams bit-equal to the torch ones: Philox (philox.cuh, what the Philox
// kernels draw; ops/shocks.py), one thread per (seed, block, month, lane),
// and JAX's threefry (threefry.cuh, what the scan kernels draw;
// ops/threefry.py), one thread per (key, flat index).
//
// Interface: a plain C entry loaded with ctypes; it launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

// in rows: seed, block, month, lane. words rows: the month draw's four
// words, the crash normal's word, the longevity word. vals rows: z_eq,
// z_ind, z_prem, crash u (word 3), crash z_j, longevity u.
__global__ void normals_kernel(const uint32_t* __restrict__ in, int n,
                               uint32_t* __restrict__ words,
                               float* __restrict__ vals) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t seed = in[p], block = in[n + p], lane = in[3 * n + p];
  const int month = static_cast<int>(in[2 * n + p]);
  const uint4 w = mcrt::month_words(seed, block, month, lane);
  const uint32_t wj = mcrt::crash_word(seed, block, month, lane);
  const uint32_t wm = mcrt::mortality_word(seed, block, lane);
  const uint32_t out[6] = {w.x, w.y, w.z, w.w, wj, wm};
#pragma unroll
  for (int i = 0; i < 6; ++i) words[static_cast<size_t>(i) * n + p] = out[i];
  vals[p] = mcrt::bits_to_normal(w.x);
  vals[n + p] = mcrt::bits_to_normal(w.y);
  vals[2 * static_cast<size_t>(n) + p] = mcrt::bits_to_normal(w.z);
  vals[3 * static_cast<size_t>(n) + p] = mcrt::bits_to_uniform(w.w);
  vals[4 * static_cast<size_t>(n) + p] = mcrt::bits_to_normal(wj);
  vals[5 * static_cast<size_t>(n) + p] = mcrt::bits_to_uniform(wm);
}

// in rows: key word 0, key word 1, the flat index's hi and lo words. words
// rows: y0, y1. f32 / f64 rows: the uniform and the normal in that type.
__global__ void threefry_kernel(const uint32_t* __restrict__ in, int n,
                                uint32_t* __restrict__ words,
                                float* __restrict__ f32,
                                double* __restrict__ f64) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint2 y = mcrt::threefry2x32(in[p], in[n + p], in[2 * n + p],
                                     in[3 * static_cast<size_t>(n) + p]);
  words[p] = y.x;
  words[n + p] = y.y;
  f32[p] = mcrt::tf_uniform(y, 0.0f);
  f32[n + p] = mcrt::tf_normal(y, 0.0f);
  f64[p] = mcrt::tf_uniform(y, 0.0);
  f64[n + p] = mcrt::tf_normal(y, 0.0);
}

}  // namespace

extern "C" {

int mcrt_normals(const void* in, int n, void* words, void* vals, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier, unrelated error
  normals_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), n, static_cast<uint32_t*>(words),
      static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}

int mcrt_threefry(const void* in, int n, void* words, void* f32, void* f64,
                  void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  threefry_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), n, static_cast<uint32_t*>(words),
      static_cast<float*>(f32), static_cast<double*>(f64));
  return static_cast<int>(cudaGetLastError());
}

const char* mcrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
