// Month-loop kernels of the retirement Monte Carlo port, for Hopper (sm_90a).
//
// What they replace: the Pallas TPU kernels, all forms of the month-loop
// body built by `_make_kernel` in
// monte_carlo_retirement_tpu/engine/pallas_kernel.py:
//   * probe_kernel  <- pallas_probe (pallas_kernel.py:1325, call at :1387):
//     candidate working-month counts x paths -> per-path alive flag and
//     final balance, plus the exact success count per candidate;
//   * grid_kernel   <- _scenario_grid_call (pallas_kernel.py:1567, call at
//     :1640): the probe body with one parameter row per scenario (the
//     scenario grid); its one-row launch replaces pallas_simulate
//     (pallas_kernel.py:1247, call at :1309);
//   * full_kernel   <- pallas_simulate_full (pallas_kernel.py:1405, call at
//     :1500): the tracked body -> seven per-path vectors and the yearly
//     trajectory, price-level and withdrawal-rate series.
//
// What bounds them here: per path-month about 60 f32 ops of tax algebra,
// 3 expf, and the Philox4x32-10 draw (10 rounds of 2 32-bit multiplies) with
// 3 log1pf + sqrtf + degree-9 polynomials for the normals (crashes add one
// more Philox draw and normal). Nothing is read or written to device memory
// inside the loop except the year-end records of full mode (1 month in 12),
// so the kernels are compute- and latency-bound.
//
// What the design does about it: one thread per path keeps the whole carry
// (b1, c1, b2, c2, infl, alive; the gain accumulators, fixed-nominal slots
// and spending multiplier where the Statics need them; ytr, yg, yr, fy_g,
// fy_r in full mode) in registers for all months -- what the TPU kernel
// bought with VMEM residency. No shared memory in the loop; occupancy comes
// from a modest register count per thread (256-thread blocks).
//
// Compile-time structure: one library per Statics. engine/_build.py passes
// every flag of `Statics` (tax system and annual bill per asset, the kind of
// each income stream, antithetic pairing, glide, guardrails, crashes,
// longevity) as a -D constant, so every disabled branch compiles out, as on
// the TPU, and a library holds exactly one instance of each kernel.
//
// Probe candidates run on blockIdx.y and each thread recomputes its Philox
// words from (path, month): candidates never enter the key, so they share
// their shocks exactly. Grid scenarios ride blockIdx.y the same way; each
// thread reads its row of the (K, F.NUM + 5*S) parameter block once, into
// registers (the TPU kernel measured per-use parameter reads in the loop at
// ~25x, docs/NOTES.md), and the row never enters the key either, so CRN
// holds across the whole grid. The annual-tax boundary and settle predicates
// depend only on (m, W, t_end), which a block shares, so those branches do
// not diverge. Division is IEEE `/` (no fast math), where Pallas used an
// approximate reciprocal plus a Newton step.
//
// Interface: plain C entries loaded with ctypes; each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#if !defined(MCRT_USE_REAL1) || !defined(MCRT_USE_REAL2) ||            \
    !defined(MCRT_BILL1) || !defined(MCRT_BILL2) ||                    \
    !defined(MCRT_ANTITHETIC) || !defined(MCRT_GLIDE) ||               \
    !defined(MCRT_GUARDRAILS) || !defined(MCRT_JUMPS) ||               \
    !defined(MCRT_MORTALITY) || !defined(MCRT_NS) ||                   \
    !defined(MCRT_STREAM_KINDS)
#error "the Statics are -D flags: build through engine/_build.py"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kBlockPaths = 4096;  // paths per Philox key (global block)
constexpr int kMonths = 12;
constexpr float kEps = 1e-6f;
constexpr float kFailRtol = 2e-5f;  // fail_rtol(float32)

// ---------------------------------------------------------------------------
// This library's Statics (pallas_kernel.Statics)
// ---------------------------------------------------------------------------
constexpr bool kUseReal1 = MCRT_USE_REAL1 != 0;
constexpr bool kUseReal2 = MCRT_USE_REAL2 != 0;
constexpr bool kBill1 = MCRT_BILL1 != 0;
constexpr bool kBill2 = MCRT_BILL2 != 0;
constexpr bool kBills = kBill1 || kBill2;
constexpr bool kAntithetic = MCRT_ANTITHETIC != 0;
constexpr bool kGlide = MCRT_GLIDE != 0;
constexpr bool kGuardrails = MCRT_GUARDRAILS != 0;
constexpr bool kJumps = MCRT_JUMPS != 0;
constexpr bool kMortality = MCRT_MORTALITY != 0;
constexpr int kNS = MCRT_NS;
constexpr int kSlots = kNS > 0 ? kNS : 1;

// Per-stream kinds, one int each: bit 0 CPI-indexed, bit 1 duration-capped.
template <int... K>
struct KindList {
  static constexpr int size = sizeof...(K);
};
template <int S, class L>
struct KindAt;
template <int S, int K0, int... Ks>
struct KindAt<S, KindList<K0, Ks...>> : KindAt<S - 1, KindList<Ks...>> {};
template <int K0, int... Ks>
struct KindAt<0, KindList<K0, Ks...>> {
  static constexpr int value = K0;
};
using StreamKinds = KindList<MCRT_STREAM_KINDS>;
static_assert(StreamKinds::size == kNS, "one kind per income stream");

template <int S>
struct StreamKind {
  static constexpr int kind = KindAt<S, StreamKinds>::value;
  static constexpr bool indexed = (kind & 1) != 0;
  static constexpr bool capped = (kind & 2) != 0;
};

// fparams layout (engine/cuda_kernel.py F, = pallas_kernel.py:97-108),
// followed by the stream table rows [amount, from_t0, duration, indexed,
// tax], each of length n_streams.
enum {
  F_MU1_M = 0, F_S1_M, F_MUI_M, F_SI_M, F_MUP_M, F_SP_M, F_RHO, F_RHO_C,
  F_ALLOC1, F_INIT_BAL, F_CONTRIB0, F_LOG1P_GROWTH, F_EXPENSES,
  F_R_REAL1, F_R_ANN1, F_R_REAL2, F_R_ANN2,
  F_ALLOC1_F,
  F_GR_UP, F_GR_LO, F_GR_ADJ, F_GR_FLOOR, F_GR_CAP,
  F_JP, F_JMU, F_JSIG, F_JBETA, F_JC1, F_JC2,
  F_MORT_G0, F_MORT_B12, F_MORT_CAP,
  NUM_FPARAMS
};
static_assert(NUM_FPARAMS == 32, "cuda_kernel.F.NUM");
// iparams rows: [W, t_end, seed, block_offset]
enum { I_W = 0, I_T_END, I_SEED, I_BLOCK_OFF, NUM_IPARAMS };

// ---------------------------------------------------------------------------
// Scenario parameters, read once per thread; a disabled feature reads none.
// ---------------------------------------------------------------------------
struct Scenario {
  float mu1, s1, mui, si, mup, sp, rho, rho_c;
  float alloc1, init_bal, contrib0, log1p_growth, expenses, r1, r2;
  float ann1, ann2, alloc1_f;
  float gr_up, gr_lo, gr_adj, gr_floor, gr_cap;
  float jp, jmu, jsig, jbeta, jc1, jc2;
  float mort_g0, mort_b12, mort_cap;
  float amount[kSlots], from_t0[kSlots], duration[kSlots], net[kSlots];

  __device__ __forceinline__ explicit Scenario(const float* __restrict__ fp) {
    mu1 = fp[F_MU1_M];
    s1 = fp[F_S1_M];
    mui = fp[F_MUI_M];
    si = fp[F_SI_M];
    mup = fp[F_MUP_M];
    sp = fp[F_SP_M];
    rho = fp[F_RHO];
    rho_c = fp[F_RHO_C];
    alloc1 = fp[F_ALLOC1];
    init_bal = fp[F_INIT_BAL];
    contrib0 = fp[F_CONTRIB0];
    log1p_growth = fp[F_LOG1P_GROWTH];
    expenses = fp[F_EXPENSES];
    r1 = fp[F_R_REAL1];
    r2 = fp[F_R_REAL2];
    if constexpr (kBill1) ann1 = fp[F_R_ANN1];
    if constexpr (kBill2) ann2 = fp[F_R_ANN2];
    alloc1_f = kGlide ? fp[F_ALLOC1_F] : alloc1;
    if constexpr (kGuardrails) {
      gr_up = fp[F_GR_UP];
      gr_lo = fp[F_GR_LO];
      gr_adj = fp[F_GR_ADJ];
      gr_floor = fp[F_GR_FLOOR];
      gr_cap = fp[F_GR_CAP];
    }
    if constexpr (kJumps) {
      jp = fp[F_JP];
      jmu = fp[F_JMU];
      jsig = fp[F_JSIG];
      jbeta = fp[F_JBETA];
      jc1 = fp[F_JC1];
      jc2 = fp[F_JC2];
    }
    if constexpr (kMortality) {
      mort_g0 = fp[F_MORT_G0];
      mort_b12 = fp[F_MORT_B12];
      mort_cap = fp[F_MORT_CAP];
    }
#pragma unroll
    for (int s = 0; s < kNS; ++s) {
      amount[s] = fp[NUM_FPARAMS + s];
      from_t0[s] = fp[NUM_FPARAMS + kNS + s];
      duration[s] = fp[NUM_FPARAMS + 2 * kNS + s];
      net[s] = 1.0f - fp[NUM_FPARAMS + 4 * kNS + s];
    }
  }
};

// A path's Philox key. Antithetic pairing (pallas_kernel.py:475-482): global
// blocks 2k and 2k+1 share key block k; the odd one negates every normal
// and reflects every uniform.
struct PathKey {
  uint32_t seed, block, lane;
  float sign;
};

__device__ __forceinline__ PathKey path_key(uint32_t seed, uint32_t gblock,
                                            uint32_t lane) {
  PathKey key{seed, gblock, lane, 1.0f};
  if constexpr (kAntithetic) {
    key.sign = (gblock & 1u) ? -1.0f : 1.0f;
    key.block = gblock >> 1;
  }
  return key;
}

// Monthly gross factors (g1, gi, g2) of one path from its Philox draw
// (pallas_kernel.py:745-771); with crashes, the compensated jump folds into
// the exponents (draw_jump, :507-528).
__device__ __forceinline__ void draw(const Scenario& sc, int m,
                                     const PathKey& key, float& g1, float& gi,
                                     float& g2) {
  const uint4 w = mcrt::month_words(key.seed, key.block, m, key.lane);
  float z_eq = mcrt::bits_to_normal(w.x);
  float z_ind = mcrt::bits_to_normal(w.y);
  float z_prem = mcrt::bits_to_normal(w.z);
  if constexpr (kAntithetic) {
    z_eq *= key.sign;
    z_ind *= key.sign;
    z_prem *= key.sign;
  }
  const float z_inf = sc.rho * z_eq + sc.rho_c * z_ind;
  if constexpr (kJumps) {
    float u = mcrt::bits_to_uniform(w.w);
    float z_j = mcrt::bits_to_normal(
        mcrt::crash_word(key.seed, key.block, m, key.lane));
    if constexpr (kAntithetic) {
      if (key.sign < 0.0f) u = 1.0f - u;
      z_j *= key.sign;
    }
    const float jl = u < sc.jp ? sc.jmu + sc.jsig * z_j : 0.0f;
    g1 = expf(sc.mu1 + sc.s1 * z_eq + (jl - sc.jc1));
    gi = expf(sc.mui + sc.si * z_inf);
    g2 = gi * expf(sc.mup + sc.sp * z_prem + (sc.jbeta * jl - sc.jc2));
  } else {
    g1 = expf(sc.mu1 + sc.s1 * z_eq);
    gi = expf(sc.mui + sc.si * z_inf);
    g2 = gi * expf(sc.mup + sc.sp * z_prem);
  }
}

// Remaining lifetime in retirement months (ops/shocks.py
// gompertz_remaining_months, the overflow-stable two-branch form): u = 0 is
// +inf, absorbed by the max-age cap; b12 = 0 (no rule) never expires.
__device__ __forceinline__ float gompertz_remaining_months(float u, float g0,
                                                           float b12,
                                                           float cap,
                                                           float wf) {
  const float g_ret = g0 - wf / b12;
  const float log_u = logf(u);
  const float t = b12 * (g_ret > 0.0f ? g_ret + logf(expf(-g_ret) - log_u)
                                      : log1pf(-log_u * expf(g_ret)));
  const float d = fminf(t, fmaxf(0.0f, cap - wf));
  return b12 > 0.0f ? d : __int_as_float(0x7f800000);
}

// Sale profile (pallas_kernel.py:587-598): tax per gross dollar, net per
// gross dollar, full-liquidation net capacity.
template <bool USE>
__device__ __forceinline__ void profile(float b, float c, float rate,
                                        float& eff, float& nf, float& nc) {
  if (!USE) {
    eff = 0.0f;
    nf = 1.0f;
    nc = b > kEps ? b : 0.0f;
    return;
  }
  const float safe = b > kEps ? b : 1.0f;
  const float gf = fmaxf(0.0f, b - c) / safe;
  eff = gf * rate;
  nf = 1.0f - eff;
  nc = b > kEps ? b * nf : 0.0f;
}

// Tax-aware exact-post-tax rebalance toward a1 (pallas_kernel.py:600-638).
__device__ __forceinline__ void rebalance_lite(float& b1, float& c1, float& b2,
                                               float& c2, float eff1,
                                               float eff2, float a1,
                                               bool extra_noop) {
  const float total = b1 + b2;
  const float drift1 = b1 - total * a1;
  const float adrift = fabsf(drift1);
  if (extra_noop || total <= kEps || adrift <= kEps) return;
  const bool sell1 = drift1 > 0.0f;
  const float bal_s = sell1 ? b1 : b2;
  const float basis_s = sell1 ? c1 : c2;
  const float eff_s = sell1 ? eff1 : eff2;
  const float alloc_s = sell1 ? a1 : 1.0f - a1;
  const float denom = fmaxf(kEps, 1.0f - alloc_s * eff_s);
  const float gross_s = fminf(bal_s, adrift / denom);
  const float frac_s = gross_s / (bal_s > kEps ? bal_s : 1.0f);
  const float net_p = gross_s * (1.0f - eff_s);
  const float new_sb = bal_s - gross_s;
  const float new_sc = basis_s - basis_s * frac_s;
  const float bal_b = (sell1 ? b2 : b1) + net_p;
  const float basis_b = (sell1 ? c2 : c1) + net_p;
  float ob1 = sell1 ? new_sb : bal_b;
  float oc1 = sell1 ? new_sc : basis_b;
  float ob2 = sell1 ? bal_b : new_sb;
  float oc2 = sell1 ? basis_b : new_sc;
  if (ob1 <= kEps) { ob1 = 0.0f; oc1 = 0.0f; }
  if (ob2 <= kEps) { ob2 = 0.0f; oc2 = 0.0f; }
  b1 = ob1; c1 = oc1; b2 = ob2; c2 = oc2;
}

// Capacity-limited sale of net ``target`` split pro-rata by net capacity --
// the withdrawal (pallas_kernel.py:975-999) and the tax bill's payment
// (:657-687): one sale fraction for both assets, snapped to 1 when the
// target reaches the capacity, zero where ``on`` is false. Returns the net
// delivered; gross1 + gross2 is what was sold.
__device__ __forceinline__ float sell_pro_rata(float& b1, float& c1,
                                               float& b2, float& c2,
                                               float target, float nc1,
                                               float nc2, float nf1,
                                               float nf2, bool on,
                                               float& gross1, float& gross2) {
  const float tnc = nc1 + nc2;
  const float frac =
      fminf(1.0f, target >= tnc ? 1.0f : target / fmaxf(tnc, kEps)) *
      (on ? 1.0f : 0.0f);
  const float keep = 1.0f - frac;
  gross1 = nc1 > 0.0f ? b1 * frac : 0.0f;
  gross2 = nc2 > 0.0f ? b2 * frac : 0.0f;
  const float nw = gross1 * nf1 + gross2 * nf2;
  if (nc1 > 0.0f) c1 *= keep;
  if (nc2 > 0.0f) c2 *= keep;
  b1 -= gross1;
  b2 -= gross2;
  if (b1 <= kEps) { b1 = 0.0f; c1 = 0.0f; }
  if (b2 <= kEps) { b2 = 0.0f; c2 = 0.0f; }
  return nw;
}

// Mark-to-market settlement of one completed tax period (annual_tax,
// pallas_kernel.py:645-690): the bill on the period's positive market gains,
// paid pro-rata by net capacity, then an exact-post-tax rebalance toward a1.
// Returns true when the capacity could not cover the bill.
__device__ __forceinline__ bool annual_tax(const Scenario& sc, float& b1,
                                           float& c1, float& b2, float& c2,
                                           float g1a, float g2a, float a1) {
  float due1 = 0.0f, due2 = 0.0f;
  if constexpr (kBill1) due1 = fmaxf(0.0f, g1a) * sc.ann1;
  if constexpr (kBill2) due2 = fmaxf(0.0f, g2a) * sc.ann2;
  const float total_due = due1 + due2;
  float eff1, nf1, nc1, eff2, nf2, nc2;
  profile<kUseReal1>(b1, c1, sc.r1, eff1, nf1, nc1);
  profile<kUseReal2>(b2, c2, sc.r2, eff2, nf2, nc2);
  const float tnc = nc1 + nc2;
  const float payment = fminf(total_due, tnc);
  const float tol = kEps + kFailRtol * (total_due + tnc);
  float gross1, gross2;
  sell_pro_rata(b1, c1, b2, c2, total_due, nc1, nc2, nf1, nf2,
                tnc > kEps && payment > 0.0f, gross1, gross2);
  profile<kUseReal1>(b1, c1, sc.r1, eff1, nf1, nc1);
  profile<kUseReal2>(b2, c2, sc.r2, eff2, nf2, nc2);
  rebalance_lite(b1, c1, b2, c2, eff1, eff2, a1, false);
  return payment < total_due - tol;
}

// Net income of the streams paying in retirement month ret_idx
// (pallas_kernel.py:914-937), stream S onwards: CPI-indexed streams pay
// amount x price level; a fixed-nominal stream freezes amount x price level
// in its slot (initialised to -1) on its first paying month; a capped
// stream pays while ret_idx < start + duration.
template <int S>
__device__ __forceinline__ void stream_income(const Scenario& sc,
                                              const float* start,
                                              float* fixed, float ret_idx_f,
                                              float price0,
                                              float& net_income) {
  if constexpr (S < kNS) {
    using K = StreamKind<S>;
    bool active = ret_idx_f >= start[S];
    if constexpr (K::capped) active = active && ret_idx_f < start[S] + sc.duration[S];
    float nominal;
    if constexpr (K::indexed) {
      nominal = sc.amount[S] * price0;
    } else {
      if (active && ret_idx_f == start[S] && fixed[S] < 0.0f)
        fixed[S] = sc.amount[S] * price0;
      nominal = fixed[S];
    }
    const float inc = active ? nominal * sc.net[S] : 0.0f;
    net_income = S == 0 ? inc : net_income + inc;
    stream_income<S + 1>(sc, start, fixed, ret_idx_f, price0, net_income);
  }
}

// Per-path results the kernels store.
struct PathOut {
  float alive, final_bal, start, ytr, fyg, fyr, infl_ret;
};

// The month loop of one path (pallas_kernel.py:718-1171). TRACK adds the
// full-mode records, stored straight to the (L, n) / (R, n) series at year
// ends.
template <bool TRACK>
__device__ __forceinline__ PathOut run_path(
    const Scenario& sc, int w, int t_end, const PathKey& key, int n, int p,
    int R, int L, float* __restrict__ traj, float* __restrict__ price,
    float* __restrict__ wr) {
  const float wf = static_cast<float>(w);
  float stream_start[kSlots], fixed[kSlots];
#pragma unroll
  for (int s = 0; s < kNS; ++s) {
    stream_start[s] =
        fmaxf(0.0f, ceilf(fmaxf(0.0f, sc.from_t0[s] - wf) - kEps));
    fixed[s] = -1.0f;
  }
  // Longevity (pallas_kernel.py:530-556): one uniform per path from the
  // salted key -> remaining months at this row's own retirement date.
  float d_mort = 0.0f;
  if constexpr (kMortality) {
    float u = mcrt::bits_to_uniform(
        mcrt::mortality_word(key.seed, key.block, key.lane));
    if constexpr (kAntithetic) {
      if (key.sign < 0.0f) u = 1.0f - u;
    }
    d_mort = gompertz_remaining_months(u, sc.mort_g0, sc.mort_b12,
                                       sc.mort_cap, wf);
  }
  // Glide (pallas_kernel.py:559-566): the target moves linearly to alloc1_f
  // over the W working months; retirement holds alloc1_f.
  float glide_scale = 0.0f;
  if constexpr (kGlide) glide_scale = (sc.alloc1_f - sc.alloc1) / fmaxf(wf, 1.0f);

  float b1 = sc.init_bal * sc.alloc1;
  float b2 = sc.init_bal - b1;
  float c1 = b1, c2 = b2, infl = 1.0f, alive_f = 1.0f;
  float g1a = 0.0f, g2a = 0.0f;  // period market gains (annual bills)
  bool preret = false;           // a bill failed before retirement
  float smult = 1.0f;            // guardrails' spending multiplier
  float ytr = 0.0f, yg = 0.0f, yr = 0.0f, fyg = 0.0f, fyr = 0.0f;
  float start = 0.0f, infl_ret = 1.0f;
  const int full_wy = w / kMonths;
  const int partial_wy = (w % kMonths) != 0;

  if (TRACK) {
    traj[p] = sc.init_bal;
    price[p] = 1.0f;
    for (int j = 1; j < L; ++j) {
      traj[static_cast<size_t>(j) * n + p] = 0.0f;
      price[static_cast<size_t>(j) * n + p] = 1.0f;
    }
    for (int y = 0; y < R; ++y) wr[static_cast<size_t>(y) * n + p] = __int_as_float(0x7fc00000);
  }

  // --- accumulation months 1..W: no deaths, no masks
  for (int m = 1; m <= w; ++m) {
    float g1, gi, g2;
    draw(sc, m, key, g1, gi, g2);
    if constexpr (kBills) {
      g1a += b1 * (g1 - 1.0f);
      g2a += b2 * (g2 - 1.0f);
    }
    b1 *= g1;
    b2 *= g2;
    infl *= gi;
    const float contrib =
        sc.contrib0 * expf(sc.log1p_growth * static_cast<float>((m - 1) / kMonths));
    float al = sc.alloc1;
    if constexpr (kGlide) al = sc.alloc1 + glide_scale * static_cast<float>(m);
    const float ca1 = contrib * al;
    const float ca2 = contrib - ca1;
    b1 += ca1;
    c1 += ca1;
    b2 += ca2;
    c2 += ca2;
    float eff1, nf1, nc1, eff2, nf2, nc2;
    profile<kUseReal1>(b1, c1, sc.r1, eff1, nf1, nc1);
    profile<kUseReal2>(b2, c2, sc.r2, eff2, nf2, nc2);
    rebalance_lite(b1, c1, b2, c2, eff1, eff2, al, false);
    if constexpr (kBills) {
      if (m % kMonths == 0) {  // absolute year boundary (pallas :802-819)
        if (annual_tax(sc, b1, c1, b2, c2, g1a, g2a, al)) preret = true;
        g1a = 0.0f;
        g2a = 0.0f;
      }
    }
    if (TRACK && m % kMonths == 0) {
      const size_t slot = static_cast<size_t>(min(m / kMonths, L - 1));
      traj[slot * n + p] = b1 + b2;
      price[slot * n + p] = infl;
    }
  }

  // --- retirement snapshot: a bill that failed before retirement kills the
  // path at its own W (pallas :839-841)
  if constexpr (kBills) {
    if (preret) alive_f = 0.0f;
  }
  if (TRACK) {
    start = b1 + b2;
    infl_ret = infl;
    if (partial_wy) {
      const size_t slot = static_cast<size_t>(min(full_wy + 1, L - 1));
      traj[slot * n + p] = start;
      price[slot * n + p] = infl_ret;
    }
  }

  // --- retirement months W+1..t_end
  for (int m = w + 1; m <= t_end; ++m) {
    const bool alive = alive_f > 0.5f;
    const float alive0_f = alive_f;
    const int k = m - w;
    const int ret_idx = k - 1;
    const float ret_idx_f = static_cast<float>(ret_idx);
    if (TRACK && k % kMonths == 1) {
      yg = 0.0f;
      yr = 0.0f;
    }

    // income waterfall & net spending need
    const float price0 = infl;
    float expenses = sc.expenses;
    if constexpr (kGuardrails) {  // pallas :887-912
      // Year starts (years 1+) of a living path only; the predicate on
      // ret_idx is uniform across the block (one W per block).
      if (ret_idx % kMonths == 0 && ret_idx > 0 && alive) {
        const float planned = 12.0f * sc.expenses * smult * price0;
        const float wr_now = planned / fmaxf(b1 + b2, kEps);
        float s_new = wr_now > sc.gr_up ? smult * (1.0f - sc.gr_adj) : smult;
        s_new = wr_now < sc.gr_lo ? smult * (1.0f + sc.gr_adj) : s_new;
        smult = fminf(fmaxf(s_new, sc.gr_floor), sc.gr_cap);
      }
      expenses = sc.expenses * smult;
    }
    float need = expenses * price0;
    if constexpr (kNS > 0) {
      float net_income = 0.0f;
      stream_income<0>(sc, stream_start, fixed, ret_idx_f, price0, net_income);
      need = fmaxf(0.0f, need - net_income);
    }
    bool living = true;
    if constexpr (kMortality) {  // spending ends with the owner (:942-948)
      living = ret_idx_f < d_mort;
      if (!living) need = 0.0f;
    }

    // ruin check A, then growth (dead/ruined paths freeze)
    const bool dies_a = alive && (b1 + b2 <= kEps) && (need > kEps);
    float g1, gi, g2;
    draw(sc, m, key, g1, gi, g2);
    const bool gmask = alive && !dies_a;
    if (gmask) {
      if constexpr (kBills) {
        g1a += b1 * (g1 - 1.0f);
        g2a += b2 * (g2 - 1.0f);
      }
      b1 *= g1;
      b2 *= g2;
      infl *= gi;
    }

    // ruin check B, then the capacity-limited withdrawal split pro-rata by
    // net capacity: one sale fraction for both assets
    const float total1 = b1 + b2;
    const bool dies_b = gmask && (total1 <= kEps) && (need > kEps);
    const bool wmask = gmask && !dies_b;
    float eff1, nf1, nc1, eff2, nf2, nc2;
    profile<kUseReal1>(b1, c1, sc.r1, eff1, nf1, nc1);
    profile<kUseReal2>(b2, c2, sc.r2, eff2, nf2, nc2);
    const float ftol = kEps + kFailRtol * (need + total1);
    float gross1, gross2;
    const float nw = sell_pro_rata(b1, c1, b2, c2, need, nc1, nc2, nf1, nf2,
                                   wmask, gross1, gross2);
    const bool fail_net = wmask && (need > kEps) && (nw < need - ftol);
    if (TRACK) {
      const float gw = gross1 + gross2;
      yg += gw;
      yr += gw / fmaxf(price0, kEps);
    }

    // monthly rebalance (the proportional sale left the profiles valid)
    rebalance_lite(b1, c1, b2, c2, eff1, eff2, sc.alloc1_f, !wmask);

    // annual taxes at absolute year boundaries and the terminal settle of a
    // partial last year (pallas :1015-1054); a settle failure is not a ruin
    // for the records
    const bool dies_pre = dies_a || dies_b || fail_net;
    bool dies = dies_pre, dies_regular = dies_pre;
    if constexpr (kBills) {
      const bool is_boundary = m % kMonths == 0;
      const bool is_settle = m == t_end && w % kMonths != 0;
      if (is_boundary || is_settle) {
        const bool apply = is_boundary ? wmask && !fail_net : alive && !dies_pre;
        if (apply) {
          const bool tfail =
              annual_tax(sc, b1, c1, b2, c2, g1a, g2a, sc.alloc1_f);
          if (is_boundary) {
            g1a = 0.0f;
            g2a = 0.0f;
          }
          dies = dies_pre || tfail;
          dies_regular = dies && !(is_settle && tfail);
        }
      }
    }
    if (dies) alive_f = 0.0f;
    if (TRACK) {
      ytr += alive0_f;  // alive-months counter
      if (k <= kMonths) {  // first retirement year: capture at death / year end
        const bool cap_fy = (alive0_f > 0.5f) && (dies_regular || k % kMonths == 0);
        if (cap_fy) {
          fyg = yg;
          fyr = yr * infl_ret;
        }
      }
      if (k % kMonths == 0) {  // year-end records with death padding
        const size_t slot = static_cast<size_t>(
            min(full_wy + partial_wy + (k + kMonths - 1) / kMonths, L - 1));
        const size_t yslot =
            static_cast<size_t>(min(max(k / kMonths - 1, 0), R - 1));
        const float total2 = b1 + b2;
        const bool died_this_year =
            (ytr > static_cast<float>((k / kMonths - 1) * kMonths) + 0.5f) &&
            (ytr < static_cast<float>(k) + 0.5f);
        const bool alive_now = alive_f > 0.5f;
        if (alive_now || died_this_year)
          traj[slot * n + p] = alive_now ? total2 : fmaxf(0.0f, total2);
        price[slot * n + p] = infl;
        // withdrawal-rate observations only for fully-lived years
        if ((alive0_f > 0.5f) && !dies_regular && living)
          wr[yslot * n + p] =
              start > kEps ? yr * infl_ret / fmaxf(start, kEps) * 100.0f : 0.0f;
      }
    }
  }

  PathOut out;
  out.alive = alive_f;
  out.final_bal = fmaxf(0.0f, b1 + b2);
  out.start = start;
  out.ytr = alive_f > 0.5f ? __int_as_float(0x7fc00000) : ytr / static_cast<float>(kMonths);
  out.fyg = fyg;
  out.fyr = fyr;
  out.infl_ret = infl_ret;
  return out;
}

// One candidate row (blockIdx.y) of a probe or grid launch: the loop for
// this thread's path with the scenario at ``fp_row``, then the row's
// survivor count over exactly n paths: padding lanes vote 0, one atomic per
// block.
__device__ __forceinline__ void probe_row(const float* __restrict__ fp_row,
                                          const int* __restrict__ ip, int n,
                                          int R, float* __restrict__ success,
                                          float* __restrict__ final_bal,
                                          int* __restrict__ counts) {
  const int cand = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int alive_i = 0;
  if (p < n) {
    const Scenario sc(fp_row);
    const int* row = ip + cand * NUM_IPARAMS;
    const PathKey key = path_key(
        static_cast<uint32_t>(row[I_SEED]),
        static_cast<uint32_t>(p / kBlockPaths + row[I_BLOCK_OFF]),
        static_cast<uint32_t>(p % kBlockPaths));
    const PathOut o = run_path<false>(sc, row[I_W], row[I_T_END], key, n, p,
                                      R, 0, nullptr, nullptr, nullptr);
    const size_t idx = static_cast<size_t>(cand) * n + p;
    success[idx] = o.alive;
    final_bal[idx] = o.final_bal;
    alive_i = o.alive > 0.5f;
  }
  __shared__ int warp_counts[kThreads / 32];
  const unsigned ballot = __ballot_sync(0xffffffffu, alive_i);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += warp_counts[i];
    atomicAdd(counts + cand, total);
  }
}

// Candidates share one parameter block (fp: F.NUM + 5*S floats).
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                 int n, int R, float* __restrict__ success,
                 float* __restrict__ final_bal, int* __restrict__ counts) {
  probe_row(fp, ip, n, R, success, final_bal, counts);
}

// One parameter row per scenario (fp: K rows of F.NUM + 5*S floats).
__global__ void __launch_bounds__(kThreads)
    grid_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                int n, int R, float* __restrict__ success,
                float* __restrict__ final_bal, int* __restrict__ counts) {
  constexpr int kRow = NUM_FPARAMS + 5 * kNS;
  probe_row(fp + static_cast<size_t>(blockIdx.y) * kRow, ip, n, R, success,
            final_bal, counts);
}

__global__ void __launch_bounds__(kThreads)
    full_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                int n, int R, int L, float* __restrict__ vecs,
                float* __restrict__ traj, float* __restrict__ price,
                float* __restrict__ wr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Scenario sc(fp);
  const PathKey key = path_key(
      static_cast<uint32_t>(ip[I_SEED]),
      static_cast<uint32_t>(p / kBlockPaths + ip[I_BLOCK_OFF]),
      static_cast<uint32_t>(p % kBlockPaths));
  const PathOut o = run_path<true>(sc, ip[I_W], ip[I_T_END], key, n, p, R, L,
                                   traj, price, wr);
  // vecs rows: success, final, start, ytr, fy_g, fy_r, infl_ret
  vecs[p] = o.alive;
  vecs[static_cast<size_t>(n) + p] = o.final_bal;
  vecs[2 * static_cast<size_t>(n) + p] = o.start;
  vecs[3 * static_cast<size_t>(n) + p] = o.ytr;
  vecs[4 * static_cast<size_t>(n) + p] = o.fyg;
  vecs[5 * static_cast<size_t>(n) + p] = o.fyr;
  vecs[6 * static_cast<size_t>(n) + p] = o.infl_ret;
}

inline unsigned blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int mcrt_probe(const void* fp, const void* ip, int n_cand, int n_paths,
               int retirement_years, int n_streams, void* success,
               void* final_bal, void* counts, void* stream) {
  if (n_cand < 1 || n_cand > 65535 || n_paths < 1 || n_streams != kNS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier, unrelated error
  probe_kernel<<<dim3(blocks_for(n_paths), n_cand), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fp), static_cast<const int*>(ip), n_paths,
      retirement_years, static_cast<float*>(success),
      static_cast<float*>(final_bal), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Rows ride gridDim.y, so 1 <= n_rows <= 65535.
int mcrt_grid(const void* fp, const void* ip, int n_rows, int n_paths,
              int retirement_years, int n_streams, void* success,
              void* final_bal, void* counts, void* stream) {
  if (n_rows < 1 || n_rows > 65535 || n_paths < 1 || n_streams != kNS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  grid_kernel<<<dim3(blocks_for(n_paths), n_rows), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fp), static_cast<const int*>(ip), n_paths,
      retirement_years, static_cast<float*>(success),
      static_cast<float*>(final_bal), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

int mcrt_full(const void* fp, const void* ip, int n_paths,
              int retirement_years, int traj_len, int n_streams, void* vecs,
              void* traj, void* price, void* wr, void* stream) {
  if (n_paths < 1 || traj_len < 1 || retirement_years < 1 || n_streams != kNS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  full_kernel<<<blocks_for(n_paths), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fp), static_cast<const int*>(ip), n_paths,
      retirement_years, traj_len, static_cast<float*>(vecs),
      static_cast<float*>(traj), static_cast<float*>(price),
      static_cast<float*>(wr));
  return static_cast<int>(cudaGetLastError());
}

const char* mcrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
