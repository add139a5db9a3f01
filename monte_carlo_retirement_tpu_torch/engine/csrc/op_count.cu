// One-step kernels that price the month loop's parts for the bound
// (engine/bound.py); never launched. Each runs one draw, one parameter
// application or one month step of month_loop.cu on values it reads from
// memory, so nothing folds away. As in the kernels, what differs per thread
// (the lane of the key, the carry, the draws) is read per thread, and what a
// warp shares (the month, W, t_end, the seed and block, the parameters) from
// one address, so the compiler keeps the same values on the uniform
// datapath as there. The SASS of each (cuobjdump -sass of the cubin that
// engine/_build.py builds per Statics) is that part's instructions plus the
// loads, stores and per-thread addresses around them; bound.py counts none
// of the loads and stores.
//
//   count_draw_probe   one path-month's draw as the probe tile holds it:
//                      Philox, normals (crashes: second Philox), growth
//                      factors; also the full kernel's in-thread draw
//   count_draw_grid    the same draw as the grid tile holds it: normals only
//   count_growth       a grid row's parameters applied to one draw
//   count_accum        one accumulation month (runtime m: every branch)
//   count_accum_plain  one accumulation month off the year boundary
//   count_retire       one retirement month (runtime m, W, t_end)
//   count_retire_plain one retirement month off every yearly branch
//   count_retire_track / count_retire_track_plain: the same, full mode
//
// In a scan unit (MCRT_THREEFRY; MCRT_REAL_DOUBLE for float64) the draws are
// the JAX scan's threefry (three hashes and XLA's erfinv per path-month, plus
// the crash's two with crashes) and every part runs in the unit's scalar
// type, so the same names price the scan kernels. XLA's erfinv branches on
// w = -log1p(-u^2) into two bands (float32) or three (float64), and all but
// a few draws in a thousand take the first: here every normal runs band 0
// (MCRT_ERFINV_BAND), and
//
//   count_normal_band0/1/2  one normal through each band (band 2 in float64)
//
// price the colder bands, which bound.py adds at the share of the normals
// that take them.
//
// A JVP unit (MCRT_JVP_TK) holds the JVP kernel's parts instead, every
// value a Dual of MCRT_JVP_TK tangents (the draws excepted):
//
//   count_jvp_draw          one path-month's draw and its growth factors
//   count_jvp_accum / count_jvp_accum_plain    one accumulation month
//   count_jvp_retire / count_jvp_retire_plain  one retirement month

#define MCRT_ERFINV_BAND 0
#include "month_loop.cu"

namespace {

constexpr int kCarryFloats = 19 + 2 * kSlots;  // values of the scalar type

template <class T>
__device__ __forceinline__ Carry<T> load_carry(const T* __restrict__ v) {
  using P = typename Primal<T>::type;
  Carry<T> c;
  c.b1 = v[0];
  c.c1 = v[1];
  c.b2 = v[2];
  c.c2 = v[3];
  c.infl = v[4];
  c.alive_f = v[5];
  c.g1a = v[6];
  c.g2a = v[7];
  c.preret = v[8] > P(0.5);
  c.smult = v[9];
  c.d_mort = v[10];
  c.glide_scale = v[11];
  c.ytr = v[12];
  c.yg = v[13];
  c.yr = v[14];
  c.fyg = v[15];
  c.fyr = v[16];
  c.start = v[17];
  c.infl_ret = v[18];
#pragma unroll
  for (int s = 0; s < kNS; ++s) {
    c.stream_start[s] = v[19 + s];
    c.fixed[s] = v[19 + kSlots + s];
  }
  return c;
}

template <class T>
__device__ __forceinline__ void store_carry(T* __restrict__ v,
                                            const Carry<T>& c) {
  using P = typename Primal<T>::type;
  v[0] = c.b1;
  v[1] = c.c1;
  v[2] = c.b2;
  v[3] = c.c2;
  v[4] = c.infl;
  v[5] = c.alive_f;
  v[6] = c.g1a;
  v[7] = c.g2a;
  v[8] = c.preret ? P(1) : P(0);
  v[9] = c.smult;
  v[12] = c.ytr;
  v[13] = c.yg;
  v[14] = c.yr;
  v[15] = c.fyg;
  v[16] = c.fyr;
#pragma unroll
  for (int s = 0; s < kNS; ++s) v[19 + kSlots + s] = c.fixed[s];
}

#if MCRT_THREEFRY
// The scan's path: key table after the four ints, global row ip[3] + thread.
__device__ __forceinline__ ScanPath<Real> key_at(const int* __restrict__ ip) {
  return ScanPath<Real>(reinterpret_cast<const uint32_t*>(ip + 4),
                        static_cast<long long>(ip[3]) + threadIdx.x);
}
#else
__device__ __forceinline__ PathKey key_at(const int* __restrict__ ip) {
  return path_key(static_cast<uint32_t>(ip[1]), static_cast<uint32_t>(ip[2]),
                  static_cast<uint32_t>(ip[3]) + threadIdx.x);
}
#endif

// This thread's carry in, and where its carry goes.
template <class T>
__device__ __forceinline__ const T* carry_in(const T* v) {
  return v + threadIdx.x * kCarryFloats;
}
template <class T>
__device__ __forceinline__ T* carry_out(T* v) {
  return v + (blockDim.x + threadIdx.x) * kCarryFloats;
}

#if MCRT_THREEFRY
template <int B>
__device__ __forceinline__ void normal_band(const uint2* __restrict__ y,
                                            Real* __restrict__ out) {
  out[threadIdx.x] = mcrt::tf_normal<B>(y[threadIdx.x], Real(0));
}
#endif

#if !MCRT_JVP_TK
template <bool TRACK>
__device__ __forceinline__ void one_retire(const Real* __restrict__ fp,
                                           const Real* __restrict__ g,
                                           int m, int w, int t_end,
                                           const Records<Real>& rec,
                                           Real* __restrict__ v) {
  const Scenario<Real> sc(fp);
  Carry<Real> c = load_carry(carry_in(v));
  g += 3 * threadIdx.x;
  retire_month<TRACK>(sc, c, m, w, t_end, g[0], g[1], g[2], rec);
  store_carry(carry_out(v), c);
}
#endif

}  // namespace

extern "C" {

#if MCRT_JVP_TK
__global__ void count_jvp_draw(const DReal* __restrict__ fp,
                               const int* __restrict__ ip,
                               DReal* __restrict__ out) {
  const Scenario<DReal> sc(fp);
  DReal g1, gi, g2;
  growth(sc, real_shock(month_shock(ip[0], key_at(ip))), g1, gi, g2);
  out += 3 * threadIdx.x;
  out[0] = g1;
  out[1] = gi;
  out[2] = g2;
}

__global__ void count_jvp_accum(const DReal* __restrict__ fp,
                                const DReal* __restrict__ g,
                                const int* __restrict__ ip,
                                DReal* __restrict__ v) {
  const Scenario<DReal> sc(fp);
  Carry<DReal> c = load_carry(carry_in(v));
  g += 3 * threadIdx.x;
  accum_month(sc, c, ip[0], g[0], g[1], g[2]);
  store_carry(carry_out(v), c);
}

__global__ void count_jvp_accum_plain(const DReal* __restrict__ fp,
                                      const DReal* __restrict__ g,
                                      DReal* __restrict__ v) {
  const Scenario<DReal> sc(fp);
  Carry<DReal> c = load_carry(carry_in(v));
  g += 3 * threadIdx.x;
  accum_month(sc, c, 5, g[0], g[1], g[2]);
  store_carry(carry_out(v), c);
}

__global__ void count_jvp_retire(const DReal* __restrict__ fp,
                                 const DReal* __restrict__ g,
                                 const int* __restrict__ ip,
                                 DReal* __restrict__ v) {
  const Scenario<DReal> sc(fp);
  Carry<DReal> c = load_carry(carry_in(v));
  g += 3 * threadIdx.x;
  retire_month<false>(sc, c, ip[0], ip[1], ip[2], g[0], g[1], g[2],
                      Records<DReal>{});
  store_carry(carry_out(v), c);
}

// m = 14, W = 12, as count_retire_plain.
__global__ void count_jvp_retire_plain(const DReal* __restrict__ fp,
                                       const DReal* __restrict__ g,
                                       const int* __restrict__ ip,
                                       DReal* __restrict__ v) {
  const Scenario<DReal> sc(fp);
  Carry<DReal> c = load_carry(carry_in(v));
  g += 3 * threadIdx.x;
  retire_month<false>(sc, c, 14, 12, ip[2], g[0], g[1], g[2],
                      Records<DReal>{});
  store_carry(carry_out(v), c);
}
#else

__global__ void count_draw_probe(const Real* __restrict__ fp,
                                 const int* __restrict__ ip,
                                 Real* __restrict__ out) {
  const Scenario<Real> sc(fp);
  Real g1, gi, g2;
  growth(sc, month_shock(ip[0], key_at(ip)), g1, gi, g2);
  out += 3 * threadIdx.x;
  out[0] = g1;
  out[1] = gi;
  out[2] = g2;
}

__global__ void count_draw_grid(const int* __restrict__ ip,
                                Real* __restrict__ out) {
  const Shock<Real> s = month_shock(ip[0], key_at(ip));
  out += 5 * threadIdx.x;
  out[0] = s.z_eq;
  out[1] = s.z_ind;
  out[2] = s.z_prem;
  if constexpr (kJumps) {
    out[3] = s.u;
    out[4] = s.z_j;
  }
}

__global__ void count_growth(const Real* __restrict__ fp,
                             const Real* __restrict__ z,
                             Real* __restrict__ out) {
  const Scenario<Real> sc(fp);
  z += 5 * threadIdx.x;
  out += 3 * threadIdx.x;
  Shock<Real> s;
  s.z_eq = z[0];
  s.z_ind = z[1];
  s.z_prem = z[2];
  s.u = z[3];
  s.z_j = z[4];
  Real g1, gi, g2;
  growth(sc, s, g1, gi, g2);
  out[0] = g1;
  out[1] = gi;
  out[2] = g2;
}

__global__ void count_accum(const Real* __restrict__ fp,
                            const Real* __restrict__ g,
                            const int* __restrict__ ip,
                            Real* __restrict__ v) {
  const Scenario<Real> sc(fp);
  Carry<Real> c = load_carry(carry_in(v));
  g += 3 * threadIdx.x;
  accum_month(sc, c, ip[0], g[0], g[1], g[2]);
  store_carry(carry_out(v), c);
}

__global__ void count_accum_plain(const Real* __restrict__ fp,
                                  const Real* __restrict__ g,
                                  Real* __restrict__ v) {
  const Scenario<Real> sc(fp);
  Carry<Real> c = load_carry(carry_in(v));
  g += 3 * threadIdx.x;
  accum_month(sc, c, 5, g[0], g[1], g[2]);
  store_carry(carry_out(v), c);
}

__global__ void count_retire(const Real* __restrict__ fp,
                             const Real* __restrict__ g,
                             const int* __restrict__ ip,
                             Real* __restrict__ v) {
  one_retire<false>(fp, g, ip[0], ip[1], ip[2], Records<Real>{}, v);
}

// m = 14, W = 12: retirement month 2, off the year boundary, the guardrails'
// year start and the terminal settle.
__global__ void count_retire_plain(const Real* __restrict__ fp,
                                   const Real* __restrict__ g,
                                   const int* __restrict__ ip,
                                   Real* __restrict__ v) {
  one_retire<false>(fp, g, 14, 12, ip[2], Records<Real>{}, v);
}

__global__ void count_retire_track(const Real* __restrict__ fp,
                                   const Real* __restrict__ g,
                                   const int* __restrict__ ip,
                                   Real* __restrict__ series,
                                   Real* __restrict__ v) {
  const Records<Real> rec{series, series + 1, series + 2, ip[3], ip[4],
                    ip[5],  ip[6],      ip[7],      ip[8]};
  one_retire<true>(fp, g, ip[0], ip[1], ip[2], rec, v);
}

__global__ void count_retire_track_plain(const Real* __restrict__ fp,
                                         const Real* __restrict__ g,
                                         const int* __restrict__ ip,
                                         Real* __restrict__ series,
                                         Real* __restrict__ v) {
  const Records<Real> rec{series, series + 1, series + 2, ip[3], ip[4],
                    ip[5],  ip[6],      ip[7],      ip[8]};
  one_retire<true>(fp, g, 14, 12, ip[2], rec, v);
}

#endif  // MCRT_JVP_TK

#if MCRT_THREEFRY
__global__ void count_normal_band0(const uint2* __restrict__ y,
                                   Real* __restrict__ out) {
  normal_band<0>(y, out);
}

__global__ void count_normal_band1(const uint2* __restrict__ y,
                                   Real* __restrict__ out) {
  normal_band<1>(y, out);
}

#if MCRT_REAL_DOUBLE
__global__ void count_normal_band2(const uint2* __restrict__ y,
                                   Real* __restrict__ out) {
  normal_band<2>(y, out);
}
#endif
#endif

}  // extern "C"
