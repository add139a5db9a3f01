// JAX's threefry draws computed inside a kernel: the scan engine's stream
// (ops/threefry.py and the scan draws of ops/shocks.py, which are bit for bit
// those of jax.random with partitionable threefry), for the scan kernels of
// month_loop.cu and the stream check of normals.cu.
//
//   * Threefry-2x32, 20 rounds (jax/_src/prng.py): a key is two words; the
//     words (y0, y1) of an element hash the (hi, lo) words of its 64-bit flat
//     row-major index under the key;
//   * unit floats keep the top bits of the draw under the exponent of 1.0:
//     float32 ((y0 ^ y1) >> 9) | 0x3F800000, float64 (y0 << 20 | y1 >> 12) |
//     0x3FF0000000000000; a uniform is the unit float minus 1 (exact);
//   * normal = sqrt(2) * erfinv(u), u uniform on (nextafter(-1, 0), 1) as
//     max(lo, f * 2 + lo); erfinv is XLA's polynomial in w = -log1p(-u^2)
//     (float32 in two bands, float64 in three). Every multiply and add is
//     rounded on its own (__fmul_rn / __dadd_rn ...), in the order of the
//     torch version's separate ops, so only log1p and sqrt could part the two.
//     The band is chosen by w; a unit that defines MCRT_ERFINV_BAND (the
//     op-count unit, which prices a draw by the band nearly every draw
//     takes) runs that band for every draw instead.
//
// The scan's layout (ops/shocks.py monthly_normals, monthly_jump_draws,
// threefry_mortality_uniform): the path at global row g draws row r = g, or
// with antithetic pairing r = g / 2, an odd g negating its normals and
// reflecting its uniforms (1 - u). Plane j of month m hashes the flat index
// 3r + j under fold_in(key, m); a crash hashes index r under the two halves
// of split(fold_in(key, JUMP_FOLD_OFFSET + m)) (u, then z); longevity index
// r under fold_in(key, MORT_FOLD_OFFSET). The host computes those keys
// (engine/cuda_kernel.scan_keys): a (T + 1, 6) table of uint32, row m =
// [month key, crash u key, crash z key], row 0 = [longevity key, 0 ...].
#pragma once

#include <stdint.h>

#ifndef MCRT_ERFINV_BAND
#define MCRT_ERFINV_BAND -1  // the band that w selects, as XLA's erf_inv
#endif

namespace mcrt {

constexpr int kScanKeyWords = 6;  // words per row of the key table

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// (y0, y1) = Threefry-2x32(key (k0, k1), counter (x0, x1)).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = tf_rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

// The words of flat index idx under key (k0, k1).
__device__ __forceinline__ uint2 tf_words(uint32_t k0, uint32_t k1,
                                          uint64_t idx) {
  return threefry2x32(k0, k1, static_cast<uint32_t>(idx >> 32),
                      static_cast<uint32_t>(idx));
}

// Uniform on [0, 1) from a draw's words (exact: unit float - 1).
__device__ __forceinline__ float tf_uniform(uint2 y, float) {
  return __uint_as_float(((y.x ^ y.y) >> 9) | 0x3F800000u) - 1.0f;
}
__device__ __forceinline__ double tf_uniform(uint2 y, double) {
  const uint64_t mant = (static_cast<uint64_t>(y.x) << 20) | (y.y >> 12);
  return __longlong_as_double(
             static_cast<long long>(mant | 0x3FF0000000000000ull)) - 1.0;
}

// XLA's erf_inv, float32: Giles' single-precision polynomial in two bands
// (w < 5, else), coefficients rounded once from the doubles of
// ops/threefry._ERFINV32. The polynomial of band B at w:
template <int B>
__device__ __forceinline__ float tf_erfinv_band(float w) {
  float p;
  if constexpr (B == 0) {
    const float v = __fsub_rn(w, 2.5f);
    p = static_cast<float>(2.81022636e-08);
    p = __fadd_rn(static_cast<float>(3.43273939e-07), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(-3.5233877e-06), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(-4.39150654e-06), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(0.00021858087), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(-0.00125372503), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(-0.00417768164), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(0.246640727), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(1.50140941), __fmul_rn(p, v));
  } else {
    const float v = __fsub_rn(sqrtf(w), 3.0f);
    p = static_cast<float>(-0.000200214257);
    p = __fadd_rn(static_cast<float>(0.000100950558), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(0.00134934322), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(-0.00367342844), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(0.00573950773), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(-0.0076224613), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(0.00943887047), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(1.00167406), __fmul_rn(p, v));
    p = __fadd_rn(static_cast<float>(2.83297682), __fmul_rn(p, v));
  }
  return p;
}

// erf_inv(x) through band kBand, or (kBand < 0) the band w selects.
template <int kBand = MCRT_ERFINV_BAND>
__device__ __forceinline__ float tf_erfinv(float x) {
  const float w = -log1pf(-__fmul_rn(x, x));
  float p;
  if constexpr (kBand >= 0) {
    p = tf_erfinv_band<kBand>(w);
  } else if (w < 5.0f) {
    p = tf_erfinv_band<0>(w);
  } else {
    p = tf_erfinv_band<1>(w);
  }
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7f800000) : __fmul_rn(p, x);
}

template <int N>
__device__ __forceinline__ double tf_horner(const double (&c)[N], double v) {
  double p = c[0];
#pragma unroll
  for (int i = 1; i < N; ++i) p = __dadd_rn(c[i], __dmul_rn(p, v));
  return p;
}

// XLA's erf_inv, float64: three bands of w (6.25, 16),
// ops/threefry._ERFINV64. The polynomial of band B at w:
template <int B>
__device__ __forceinline__ double tf_erfinv_band(double w) {
  constexpr double kC0[23] = {
      -3.6444120640178196996e-21, -1.685059138182016589e-19,
      1.2858480715256400167e-18,  1.115787767802518096e-17,
      -1.333171662854620906e-16,  2.0972767875968561637e-17,
      6.6376381343583238325e-15,  -4.0545662729752068639e-14,
      -8.1519341976054721522e-14, 2.6335093153082322977e-12,
      -1.2975133253453532498e-11, -5.4154120542946279317e-11,
      1.051212273321532285e-09,   -4.1126339803469836976e-09,
      -2.9070369957882005086e-08, 4.2347877827932403518e-07,
      -1.3654692000834678645e-06, -1.3882523362786468719e-05,
      0.0001867342080340571352,   -0.00074070253416626697512,
      -0.0060336708714301490533,  0.24015818242558961693,
      1.6536545626831027356};
  constexpr double kC1[19] = {
      2.2137376921775787049e-09,  9.0756561938885390979e-08,
      -2.7517406297064545428e-07, 1.8239629214389227755e-08,
      1.5027403968909827627e-06,  -4.013867526981545969e-06,
      2.9234449089955446044e-06,  1.2475304481671778723e-05,
      -4.7318229009055733981e-05, 6.8284851459573175448e-05,
      2.4031110387097893999e-05,  -0.0003550375203628474796,
      0.00095328937973738049703,  -0.0016882755560235047313,
      0.0024914420961078508066,   -0.0037512085075692412107,
      0.005370914553590063617,    1.0052589676941592334,
      3.0838856104922207635};
  constexpr double kC2[17] = {
      -2.7109920616438573243e-11, -2.5556418169965252055e-10,
      1.5076572693500548083e-09,  -3.7894654401267369937e-09,
      7.6157012080783393804e-09,  -1.4960026627149240478e-08,
      2.9147953450901080826e-08,  -6.7711997758452339498e-08,
      2.2900482228026654717e-07,  -9.9298272942317002539e-07,
      4.5260625972231537039e-06,  -1.9681778105531670567e-05,
      7.5995277030017761139e-05,  -0.00021503011930044477347,
      -0.00013871931833623122026, 1.0103004648645343977,
      4.8499064014085844221};
  if constexpr (B == 0) {
    return tf_horner(kC0, __dsub_rn(w, 3.125));
  } else if constexpr (B == 1) {
    return tf_horner(kC1, __dsub_rn(sqrt(w), 3.25));
  } else {
    return tf_horner(kC2, __dsub_rn(sqrt(w), 5.0));
  }
}

template <int kBand = MCRT_ERFINV_BAND>
__device__ __forceinline__ double tf_erfinv(double x) {
  const double w = -log1p(-__dmul_rn(x, x));
  double p;
  if constexpr (kBand >= 0) {
    p = tf_erfinv_band<kBand>(w);
  } else if (w < 6.25) {
    p = tf_erfinv_band<0>(w);
  } else if (w < 16.0) {
    p = tf_erfinv_band<1>(w);
  } else {
    p = tf_erfinv_band<2>(w);
  }
  return fabs(x) == 1.0 ? x * __longlong_as_double(0x7ff0000000000000ll)
                        : __dmul_rn(p, x);
}

// Standard normal from a draw's words (jax.random.normal).
template <int kBand = MCRT_ERFINV_BAND>
__device__ __forceinline__ float tf_normal(uint2 y, float) {
  const float lo = __int_as_float(0xBF7FFFFF);  // nextafter(-1, 0); 1 - lo rounds to 2
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(tf_uniform(y, 0.0f), 2.0f), lo));
  return __fmul_rn(tf_erfinv<kBand>(u), 1.41421354f);  // float32(sqrt(2))
}
template <int kBand = MCRT_ERFINV_BAND>
__device__ __forceinline__ double tf_normal(uint2 y, double) {
  const double lo = __longlong_as_double(static_cast<long long>(
      0xBFEFFFFFFFFFFFFFull));  // nextafter(-1, 0)
  const double u = fmax(lo, __dadd_rn(__dmul_rn(tf_uniform(y, 0.0), 2.0), lo));
  return __dmul_rn(tf_erfinv<kBand>(u), 1.4142135623730951);
}

// One path's draws of the scan stream at global row g (see the top).
template <class T, bool ANTITHETIC>
struct ScanPath {
  const uint32_t* keys;
  uint64_t row;
  bool odd;

  __device__ __forceinline__ ScanPath(const uint32_t* table, long long g)
      : keys(table),
        row(ANTITHETIC ? static_cast<uint64_t>(g) >> 1
                       : static_cast<uint64_t>(g)),
        odd(ANTITHETIC && (g & 1)) {}

  // The month's unmixed normals (z_eq, z_ind, z_prem).
  __device__ __forceinline__ void normals(int m, T& z0, T& z1, T& z2) const {
    const uint32_t* k = keys + static_cast<size_t>(m) * kScanKeyWords;
    const uint32_t k0 = k[0], k1 = k[1];
    const uint64_t base = 3 * row;
    z0 = tf_normal(tf_words(k0, k1, base), T(0));
    z1 = tf_normal(tf_words(k0, k1, base + 1), T(0));
    z2 = tf_normal(tf_words(k0, k1, base + 2), T(0));
    if (odd) {
      z0 = -z0;
      z1 = -z1;
      z2 = -z2;
    }
  }

  // The month's crash uniform and normal.
  __device__ __forceinline__ void crash(int m, T& u, T& z) const {
    const uint32_t* k = keys + static_cast<size_t>(m) * kScanKeyWords;
    u = tf_uniform(tf_words(k[2], k[3], row), T(0));
    z = tf_normal(tf_words(k[4], k[5], row), T(0));
    if (odd) {
      u = T(1) - u;
      z = -z;
    }
  }

  // The longevity uniform.
  __device__ __forceinline__ T mortality() const {
    T u = tf_uniform(tf_words(keys[0], keys[1], row), T(0));
    return odd ? T(1) - u : u;
  }
};

}  // namespace mcrt
