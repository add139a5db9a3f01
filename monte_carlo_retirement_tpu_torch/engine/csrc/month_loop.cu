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
// normals_kernel writes the Philox words and normals for given (seed, block,
// month, lane); it exists only so a check can hold the device stream
// bit-equal to the torch one (ops/shocks.py).
//
// What bounds them here: per path-month about 60 f32 ops of tax algebra,
// 3 expf, and the Philox4x32-10 draw (10 rounds of 2 32-bit multiplies) with
// 3 log1pf + sqrtf + degree-9 polynomials for the normals. Nothing is read
// or written to device memory inside the loop except the year-end records of
// full mode (1 month in 12), so the kernels are compute- and latency-bound.
//
// What the design does about it: one thread per path keeps the whole carry
// (b1, c1, b2, c2, infl, alive; plus ytr, yg, yr, fy_g, fy_r in full mode) in
// registers for all months -- what the TPU kernel bought with VMEM
// residency. No shared memory in the loop; occupancy comes from a modest
// register count per thread (256-thread blocks). The compile-time Statics
// (tax system per asset, number of CPI-indexed income streams) are template
// parameters, so disabled branches compile out. Probe candidates run on
// blockIdx.y and each thread recomputes its Philox words from (path, month):
// candidates never enter the key, so they share their shocks exactly. Grid
// scenarios ride blockIdx.y the same way; each thread reads its row of the
// (K, F.NUM + 5*S) parameter block once, into registers (the TPU kernel
// measured per-use parameter reads in the loop at ~25x, docs/NOTES.md), and
// the row never enters the key either, so CRN holds across the whole grid.
// Division is IEEE `/` (no fast math), where Pallas used an approximate
// reciprocal plus a Newton step.
//
// Interface: plain C entries loaded with ctypes; each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockPaths = 4096;  // paths per Philox key (global block)
constexpr int kMonths = 12;
constexpr int kMaxStreams = 4;
constexpr float kEps = 1e-6f;
constexpr float kFailRtol = 2e-5f;  // fail_rtol(float32)

// fparams layout (engine/cuda_kernel.py F, = pallas_kernel.py:97-108),
// followed by the stream table rows [amount, from_t0, duration, indexed,
// tax], each of length n_streams.
enum {
  F_MU1_M = 0, F_S1_M, F_MUI_M, F_SI_M, F_MUP_M, F_SP_M, F_RHO, F_RHO_C,
  F_ALLOC1, F_INIT_BAL, F_CONTRIB0, F_LOG1P_GROWTH, F_EXPENSES,
  F_R_REAL1, F_R_ANN1, F_R_REAL2, F_R_ANN2,
  NUM_FPARAMS = 32
};
// iparams rows: [W, t_end, seed, block_offset]
enum { I_W = 0, I_T_END, I_SEED, I_BLOCK_OFF, NUM_IPARAMS };

// ---------------------------------------------------------------------------
// Counter-based normals: Philox4x32-10, key (seed, global block), counter
// (month, lane, 0, 0); words 0..2 -> z_eq, z_ind, z_prem.
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// Scenario parameters, read once per thread.
// ---------------------------------------------------------------------------
template <int NS>
struct Scenario {
  float mu1, s1, mui, si, mup, sp, rho, rho_c;
  float alloc1, init_bal, contrib0, log1p_growth, expenses, r1, r2;
  float amount[NS > 0 ? NS : 1], from_t0[NS > 0 ? NS : 1],
      net[NS > 0 ? NS : 1];

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
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      amount[s] = fp[NUM_FPARAMS + s];
      from_t0[s] = fp[NUM_FPARAMS + NS + s];
      net[s] = 1.0f - fp[NUM_FPARAMS + 4 * NS + s];
    }
  }
};

// Monthly gross factors (g1, gi, g2) of one path from its Philox draw.
template <int NS>
__device__ __forceinline__ void draw(const Scenario<NS>& sc, int m,
                                     uint32_t lane, uint32_t seed,
                                     uint32_t gblock, float& g1, float& gi,
                                     float& g2) {
  const uint4 w = philox4x32_10(make_uint4(static_cast<uint32_t>(m), lane, 0u, 0u),
                                seed, gblock);
  const float z_eq = bits_to_normal(w.x);
  const float z_ind = bits_to_normal(w.y);
  const float z_prem = bits_to_normal(w.z);
  const float z_inf = sc.rho * z_eq + sc.rho_c * z_ind;
  g1 = expf(sc.mu1 + sc.s1 * z_eq);
  gi = expf(sc.mui + sc.si * z_inf);
  g2 = gi * expf(sc.mup + sc.sp * z_prem);
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

// Per-path results the two kernels store.
struct PathOut {
  float alive, final_bal, start, ytr, fyg, fyr, infl_ret;
};

// The month loop of one path (pallas_kernel.py:776-1171, slice Statics:
// no annual bills, CPI-indexed uncapped streams, no glide, guardrails,
// crashes, longevity or antithetic pairing). TRACK adds the full-mode
// records, stored straight to the (L, n) / (R, n) series at year ends.
template <bool U1, bool U2, int NS, bool TRACK>
__device__ __forceinline__ PathOut run_path(
    const Scenario<NS>& sc, int w, int t_end, uint32_t seed, uint32_t gblock,
    uint32_t lane, int n, int p, int R, int L, float* __restrict__ traj,
    float* __restrict__ price, float* __restrict__ wr) {
  const float wf = static_cast<float>(w);
  float stream_start[NS > 0 ? NS : 1];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    stream_start[s] =
        fmaxf(0.0f, ceilf(fmaxf(0.0f, sc.from_t0[s] - wf) - kEps));

  float b1 = sc.init_bal * sc.alloc1;
  float b2 = sc.init_bal - b1;
  float c1 = b1, c2 = b2, infl = 1.0f, alive_f = 1.0f;
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
    draw<NS>(sc, m, lane, seed, gblock, g1, gi, g2);
    b1 *= g1;
    b2 *= g2;
    infl *= gi;
    const float contrib =
        sc.contrib0 * expf(sc.log1p_growth * static_cast<float>((m - 1) / kMonths));
    const float ca1 = contrib * sc.alloc1;
    const float ca2 = contrib - ca1;
    b1 += ca1;
    c1 += ca1;
    b2 += ca2;
    c2 += ca2;
    float eff1, nf1, nc1, eff2, nf2, nc2;
    profile<U1>(b1, c1, sc.r1, eff1, nf1, nc1);
    profile<U2>(b2, c2, sc.r2, eff2, nf2, nc2);
    rebalance_lite(b1, c1, b2, c2, eff1, eff2, sc.alloc1, false);
    if (TRACK && m % kMonths == 0) {
      const size_t slot = static_cast<size_t>(min(m / kMonths, L - 1));
      traj[slot * n + p] = b1 + b2;
      price[slot * n + p] = infl;
    }
  }

  // --- retirement snapshot
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
    const float ret_idx_f = static_cast<float>(k - 1);
    if (TRACK && k % kMonths == 1) {
      yg = 0.0f;
      yr = 0.0f;
    }

    // income waterfall & net spending need
    const float price0 = infl;
    float need = sc.expenses * price0;
    if (NS > 0) {
      float net_income = 0.0f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float inc =
            ret_idx_f >= stream_start[s] ? sc.amount[s] * price0 * sc.net[s] : 0.0f;
        net_income = s == 0 ? inc : net_income + inc;
      }
      need = fmaxf(0.0f, need - net_income);
    }

    // ruin check A, then growth (dead/ruined paths freeze)
    const bool dies_a = alive && (b1 + b2 <= kEps) && (need > kEps);
    float g1, gi, g2;
    draw<NS>(sc, m, lane, seed, gblock, g1, gi, g2);
    const bool gmask = alive && !dies_a;
    if (gmask) {
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
    profile<U1>(b1, c1, sc.r1, eff1, nf1, nc1);
    profile<U2>(b2, c2, sc.r2, eff2, nf2, nc2);
    const float tnc = nc1 + nc2;
    const float ftol = kEps + kFailRtol * (need + total1);
    const float frac_w =
        fminf(1.0f, need >= tnc ? 1.0f : need / fmaxf(tnc, kEps)) *
        (wmask ? 1.0f : 0.0f);
    const float keep_w = 1.0f - frac_w;
    const float gross1 = nc1 > 0.0f ? b1 * frac_w : 0.0f;
    const float gross2 = nc2 > 0.0f ? b2 * frac_w : 0.0f;
    const float nw = gross1 * nf1 + gross2 * nf2;
    if (nc1 > 0.0f) c1 *= keep_w;
    if (nc2 > 0.0f) c2 *= keep_w;
    b1 -= gross1;
    b2 -= gross2;
    if (b1 <= kEps) { b1 = 0.0f; c1 = 0.0f; }
    if (b2 <= kEps) { b2 = 0.0f; c2 = 0.0f; }
    const bool fail_net = wmask && (need > kEps) && (nw < need - ftol);
    if (TRACK) {
      const float gw = gross1 + gross2;
      yg += gw;
      yr += gw / fmaxf(price0, kEps);
    }

    // monthly rebalance (the proportional sale left the profiles valid)
    rebalance_lite(b1, c1, b2, c2, eff1, eff2, sc.alloc1, !wmask);

    const bool dies = dies_a || dies_b || fail_net;
    if (dies) alive_f = 0.0f;
    if (TRACK) {
      ytr += alive0_f;  // alive-months counter
      if (k <= kMonths) {  // first retirement year: capture at death / year end
        const bool cap_fy = (alive0_f > 0.5f) && (dies || k % kMonths == 0);
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
        if ((alive0_f > 0.5f) && !dies)
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
template <bool U1, bool U2, int NS>
__device__ __forceinline__ void probe_row(const float* __restrict__ fp_row,
                                          const int* __restrict__ ip, int n,
                                          int R, float* __restrict__ success,
                                          float* __restrict__ final_bal,
                                          int* __restrict__ counts) {
  const int cand = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int alive_i = 0;
  if (p < n) {
    const Scenario<NS> sc(fp_row);
    const int* row = ip + cand * NUM_IPARAMS;
    const uint32_t gblock =
        static_cast<uint32_t>(p / kBlockPaths + row[I_BLOCK_OFF]);
    const PathOut o = run_path<U1, U2, NS, false>(
        sc, row[I_W], row[I_T_END], static_cast<uint32_t>(row[I_SEED]),
        gblock, static_cast<uint32_t>(p % kBlockPaths), n, p, R, 0, nullptr,
        nullptr, nullptr);
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
template <bool U1, bool U2, int NS>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                 int n, int R, float* __restrict__ success,
                 float* __restrict__ final_bal, int* __restrict__ counts) {
  probe_row<U1, U2, NS>(fp, ip, n, R, success, final_bal, counts);
}

// One parameter row per scenario (fp: K rows of F.NUM + 5*S floats).
template <bool U1, bool U2, int NS>
__global__ void __launch_bounds__(kThreads)
    grid_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                int n, int R, float* __restrict__ success,
                float* __restrict__ final_bal, int* __restrict__ counts) {
  constexpr int kRow = NUM_FPARAMS + 5 * NS;
  probe_row<U1, U2, NS>(fp + static_cast<size_t>(blockIdx.y) * kRow, ip, n,
                        R, success, final_bal, counts);
}

template <bool U1, bool U2, int NS>
__global__ void __launch_bounds__(kThreads)
    full_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                int n, int R, int L, float* __restrict__ vecs,
                float* __restrict__ traj, float* __restrict__ price,
                float* __restrict__ wr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Scenario<NS> sc(fp);
  const uint32_t gblock = static_cast<uint32_t>(p / kBlockPaths + ip[I_BLOCK_OFF]);
  const PathOut o = run_path<U1, U2, NS, true>(
      sc, ip[I_W], ip[I_T_END], static_cast<uint32_t>(ip[I_SEED]), gblock,
      static_cast<uint32_t>(p % kBlockPaths), n, p, R, L, traj, price, wr);
  // vecs rows: success, final, start, ytr, fy_g, fy_r, infl_ret
  vecs[p] = o.alive;
  vecs[static_cast<size_t>(n) + p] = o.final_bal;
  vecs[2 * static_cast<size_t>(n) + p] = o.start;
  vecs[3 * static_cast<size_t>(n) + p] = o.ytr;
  vecs[4 * static_cast<size_t>(n) + p] = o.fyg;
  vecs[5 * static_cast<size_t>(n) + p] = o.fyr;
  vecs[6 * static_cast<size_t>(n) + p] = o.infl_ret;
}

__global__ void normals_kernel(const uint32_t* __restrict__ in, int n,
                               uint32_t* __restrict__ words,
                               float* __restrict__ z) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  // in rows: seed, block, month, lane
  const uint4 w = philox4x32_10(make_uint4(in[2 * n + p], in[3 * n + p], 0u, 0u),
                                in[p], in[n + p]);
  words[p] = w.x;
  words[n + p] = w.y;
  words[2 * n + p] = w.z;
  words[3 * n + p] = w.w;
  z[p] = bits_to_normal(w.x);
  z[n + p] = bits_to_normal(w.y);
  z[2 * n + p] = bits_to_normal(w.z);
}

inline unsigned blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <bool U1, bool U2, int NS>
void launch_probe(const float* fp, const int* ip, int k, int n, int R,
                  float* success, float* final_bal, int* counts,
                  cudaStream_t stream) {
  probe_kernel<U1, U2, NS><<<dim3(blocks_for(n), k), kThreads, 0, stream>>>(
      fp, ip, n, R, success, final_bal, counts);
}

template <bool U1, bool U2, int NS>
void launch_grid(const float* fp, const int* ip, int k, int n, int R,
                 float* success, float* final_bal, int* counts,
                 cudaStream_t stream) {
  grid_kernel<U1, U2, NS><<<dim3(blocks_for(n), k), kThreads, 0, stream>>>(
      fp, ip, n, R, success, final_bal, counts);
}

template <bool U1, bool U2, int NS>
void launch_full(const float* fp, const int* ip, int n, int R, int L,
                 float* vecs, float* traj, float* price, float* wr,
                 cudaStream_t stream) {
  full_kernel<U1, U2, NS><<<blocks_for(n), kThreads, 0, stream>>>(
      fp, ip, n, R, L, vecs, traj, price, wr);
}

// Statics -> template instance. Returns false for an unsupported shape.
template <template <bool, bool, int> class Op, typename... Args>
bool dispatch(int use1, int use2, int ns, Args... args) {
#define MCRT_NS(U1, U2)                                   \
  switch (ns) {                                           \
    case 0: Op<U1, U2, 0>::run(args...); return true;     \
    case 1: Op<U1, U2, 1>::run(args...); return true;     \
    case 2: Op<U1, U2, 2>::run(args...); return true;     \
    case 3: Op<U1, U2, 3>::run(args...); return true;     \
    case 4: Op<U1, U2, 4>::run(args...); return true;     \
    default: return false;                                \
  }
  if (use1 && use2) { MCRT_NS(true, true) }
  if (use1) { MCRT_NS(true, false) }
  if (use2) { MCRT_NS(false, true) }
  MCRT_NS(false, false)
#undef MCRT_NS
  return false;
}

template <bool U1, bool U2, int NS>
struct ProbeOp {
  template <typename... A>
  static void run(A... a) { launch_probe<U1, U2, NS>(a...); }
};

template <bool U1, bool U2, int NS>
struct GridOp {
  template <typename... A>
  static void run(A... a) { launch_grid<U1, U2, NS>(a...); }
};

template <bool U1, bool U2, int NS>
struct FullOp {
  template <typename... A>
  static void run(A... a) { launch_full<U1, U2, NS>(a...); }
};

}  // namespace

extern "C" {

int mcrt_probe(const void* fp, const void* ip, int n_cand, int n_paths,
               int retirement_years, int use_real1, int use_real2,
               int n_streams, void* success, void* final_bal, void* counts,
               void* stream) {
  if (n_cand < 1 || n_cand > 65535 || n_paths < 1 || n_streams < 0 ||
      n_streams > kMaxStreams)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier, unrelated error
  if (!dispatch<ProbeOp>(use_real1, use_real2, n_streams,
                         static_cast<const float*>(fp),
                         static_cast<const int*>(ip), n_cand, n_paths,
                         retirement_years, static_cast<float*>(success),
                         static_cast<float*>(final_bal),
                         static_cast<int*>(counts),
                         static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Rows ride gridDim.y, so 1 <= n_rows <= 65535.
int mcrt_grid(const void* fp, const void* ip, int n_rows, int n_paths,
              int retirement_years, int use_real1, int use_real2,
              int n_streams, void* success, void* final_bal, void* counts,
              void* stream) {
  if (n_rows < 1 || n_rows > 65535 || n_paths < 1 || n_streams < 0 ||
      n_streams > kMaxStreams)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (!dispatch<GridOp>(use_real1, use_real2, n_streams,
                        static_cast<const float*>(fp),
                        static_cast<const int*>(ip), n_rows, n_paths,
                        retirement_years, static_cast<float*>(success),
                        static_cast<float*>(final_bal),
                        static_cast<int*>(counts),
                        static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int mcrt_full(const void* fp, const void* ip, int n_paths,
              int retirement_years, int traj_len, int use_real1,
              int use_real2, int n_streams, void* vecs, void* traj,
              void* price, void* wr, void* stream) {
  if (n_paths < 1 || traj_len < 1 || retirement_years < 1 || n_streams < 0 ||
      n_streams > kMaxStreams)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  if (!dispatch<FullOp>(use_real1, use_real2, n_streams,
                        static_cast<const float*>(fp),
                        static_cast<const int*>(ip), n_paths,
                        retirement_years, traj_len,
                        static_cast<float*>(vecs), static_cast<float*>(traj),
                        static_cast<float*>(price), static_cast<float*>(wr),
                        static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int mcrt_normals(const void* in, int n, void* words, void* z, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  normals_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), n, static_cast<uint32_t*>(words),
      static_cast<float*>(z));
  return static_cast<int>(cudaGetLastError());
}

const char* mcrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
