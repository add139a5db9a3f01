// Counter-based draws of the port (Philox4x32-10), shared by the month-loop
// kernels (month_loop.cu) and the stream check (normals.cu). The torch
// twin, operation for operation, is ops/shocks.py; the layout:
//   * key (stream seed, global 4096-path block), counter (month, lane, 0, 0):
//     words 0..2 -> z_eq, z_ind, z_prem; word 3 -> the crash uniform u;
//   * counter (month, lane, 1, 0), same key: word 0 -> the crash normal z_j;
//   * key (stream seed ^ kMortSalt, block), counter (0, lane, 2, 0): word 0
//     -> the longevity uniform (months start at 1, so no month draw uses it).
// Base normals are the same words whether crashes or longevity are on.
#pragma once

#include <stdint.h>

namespace mcrt {

constexpr uint32_t kMortSalt = 668265261u;  // pallas_kernel.py:544
constexpr uint32_t kCrashCounter = 1u;
constexpr uint32_t kMortCounter = 2u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The Pallas `_normal` transform (pallas_kernel.py:283-300) in the same f32
// operation order as ops/shocks.bits_to_normal: __fmul_rn/__fadd_rn keep the
// compiler from fusing multiply-adds, so the bits match torch's separately
// rounded ops. Constants are written as doubles and rounded once to float,
// the way torch rounds a Python float.
__device__ __forceinline__ float bits_to_normal(uint32_t bits) {
  const float r = static_cast<float>(bits >> 9);
  const float x = __fadd_rn(__fmul_rn(r, static_cast<float>(1.0 / 4194304.0)),
                            static_cast<float>(1.0 / 8388608.0 - 1.0));
  const float s = sqrtf(-log1pf(-__fmul_rn(x, x)));
  float acc = static_cast<float>(0.0001782477551054519);
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(-0.0028148533007281555));
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(0.016944312865490738));
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(-0.04569300513968381));
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(0.04307398034973402));
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(0.014180894039555763));
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(-0.028215645346410155));
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(0.3470778790734455));
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(-0.003963483920460122));
  acc = __fadd_rn(__fmul_rn(acc, s), static_cast<float>(1.2534926535177795));
  return __fmul_rn(acc, x);
}

// The Pallas `_uniform` (pallas_kernel.py:303-309): 23 bits -> [0, 1 - 2^-23],
// exact in f32.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __fmul_rn(static_cast<float>(bits >> 9),
                   static_cast<float>(1.0 / 8388608.0));
}

__device__ __forceinline__ uint4 month_words(uint32_t seed, uint32_t block,
                                             int m, uint32_t lane) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(m), lane, 0u, 0u),
                       seed, block);
}

__device__ __forceinline__ uint32_t crash_word(uint32_t seed, uint32_t block,
                                               int m, uint32_t lane) {
  return philox4x32_10(
             make_uint4(static_cast<uint32_t>(m), lane, kCrashCounter, 0u),
             seed, block)
      .x;
}

__device__ __forceinline__ uint32_t mortality_word(uint32_t seed,
                                                   uint32_t block,
                                                   uint32_t lane) {
  return philox4x32_10(make_uint4(0u, lane, kMortCounter, 0u),
                       seed ^ kMortSalt, block)
      .x;
}

}  // namespace mcrt
