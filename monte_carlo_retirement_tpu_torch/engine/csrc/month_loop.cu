// Month-loop kernels of the retirement Monte Carlo port, for Hopper (sm_90a).
//
// What they replace: the Pallas TPU kernels, all forms of the month-loop
// body built by `_make_kernel` in
// monte_carlo_retirement_tpu/engine/pallas_kernel.py:
//   * probe_kernel  <- pallas_probe (pallas_kernel.py:1325, call at :1387):
//     candidate working-month counts x paths -> per-path alive flag and
//     final balance, plus the exact success count per candidate; without a
//     glide path its rows start from the carry that accum_kernel (no TPU
//     counterpart: the Pallas probe accumulates per candidate) hands them;
//   * grid_kernel   <- _scenario_grid_call (pallas_kernel.py:1567, call at
//     :1640): the probe body with one parameter row per scenario (the
//     scenario grid); its one-row launch replaces pallas_simulate
//     (pallas_kernel.py:1247, call at :1309);
//   * full_kernel   <- pallas_simulate_full (pallas_kernel.py:1405, call at
//     :1500): the tracked body -> seven per-path vectors and the yearly
//     trajectory, price-level and withdrawal-rate series.
//
// What bounds them here: issue slots. Per path-month the Philox4x32-10 draw
// (10 rounds of 2 32-bit multiplies) and its three normals (log1pf, sqrtf,
// degree-9 polynomials; crashes add a second Philox and a normal), then 3
// expf, then about 60 f32 operations of tax algebra. Nothing is read or
// written to device memory inside the loop except the year-end records of
// full mode (1 month in 12). The draw depends only on (seed, block, month,
// lane): candidates and grid rows never enter the key, so every row of a
// probe or grid launch draws the same words, and the draw is the larger part
// of a path-month.
//
// What the design does about it:
//   * probe_kernel and grid_kernel are tiled: a block holds C rows x 32
//     paths, one warp per row, so the month predicates on (m, W, t_end) and
//     the survivor ballot stay warp-uniform. Months go in chunks of M: the
//     block's warps first draw the chunk's 32 x M path-months together into
//     a shared-memory tile laid out [month][field][path] (consecutive lanes
//     read consecutive words: no bank conflict), each draw once for all C
//     rows (the probe stores the growth factors g1, gi, g2, its rows sharing
//     one parameter block; the grid stores the normals, and with crashes
//     the crash uniform and normal, and each row applies its own
//     parameters); then each warp runs its row's months of the chunk from
//     the tile, its accumulation months, then its retirement months.
//     engine/cuda_kernel.py (tile_plan) chooses C and M and the launch;
//     the C entries check them.
//   * Work stops where every path it serves is ruined. Most probes of the
//     search hold rows whose paths are all ruined long before their t_end
//     (W = 0 rows, and every W below the answer). A ruined path's carry is
//     a fixed point of the retirement month (no growth, no sale, no
//     rebalance, no tax, and the <= eps clamps already ran in the month it
//     died), so its outputs are final. At the end of each retirement year
//     and of each chunk a warp votes on its lanes' alive flags, and once
//     none of its real paths lives it runs no further month of its row; at
//     each chunk boundary the block votes over its warps, and once none has
//     a month left it leaves the loop, draws included. A warp that is done,
//     or has no row, still draws its share of each chunk the block runs,
//     meets every barrier, and votes in the survivor ballot. The months
//     each warp ran are counted (the `steps` buffer beside `counts`); under
//     longevity the probe also counts those it ran once every path of the
//     warp was decided (ruined, or solvent past its owner's death, when it
//     spends no more), work its success count does not need. On
//     launches whose paths all live, a vote after every month cost 3-5%,
//     a yearly one 1-2%, and one at chunk ends nothing, but that one runs
//     a row ruined within two years for a whole chunk of 64 months
//     (PERF.md §6): the warps vote yearly and at chunk ends.
//     `__launch_bounds__(512, 2)` holds a 16-row block to 64 registers, two
//     blocks per SM: the heaviest Statics (all-on, six streams) spill a few
//     bytes and still run 11-17% faster than at their free 92-97 registers
//     (PERF.md).
//   * One thread per (row, path) keeps the whole carry (b1, c1, b2, c2,
//     infl, alive; the gain accumulators, fixed-nominal slots and spending
//     multiplier where the Statics need them) in registers for all months --
//     what the TPU kernel bought with VMEM residency.
//   * The probe's rows share their working years. Its candidates differ
//     only in W, and an accumulation month reads the carry, the month, the
//     growth factors and the shared parameter block, not W (the glide path
//     excepted: its target moves with each row's own W). So without a glide
//     path a row's carry at its month W is the carry of any row with a
//     larger W at that month, bit for bit. accum_kernel runs those months
//     once per path, one thread per path drawing in-thread (a sequential
//     chain of 32 paths cannot fill a 16-warp block), to the launch's
//     largest W, and stores the carry at each row's W; each probe warp
//     loads its row's carry and starts at its first retirement month, and
//     the block's month loop starts at the chunk that holds its rows'
//     smallest W + 1, drawing nothing below it. Chunks keep their
//     boundaries, so the warps vote where they did and count the same
//     months. A library with a glide path keeps the per-row accumulation.
//   * full_kernel has one row, so nothing to share: one thread per path draws
//     in-thread through the same helpers and runs the same month steps
//     (start_path, accum_month, snapshot, retire_month), plus the records.
//
// The scan kernels (a library built with MCRT_THREEFRY, in float64 with
// MCRT_REAL_DOUBLE too) replace the compiled form of JAX's threefry scan,
// simulate_paths (monte_carlo_retirement_tpu/engine/kernel.py:124: a
// lax.scan that XLA fuses into one device loop with the carry in registers
// and the draws made where they are used, not a pallas_call):
//   * scan_rows_kernel: tile_body on the scan's draws -- K rows x n paths,
//     one shared parameter block (the probe, runner.py _probe_impl) or one
//     per row (the batch, scenario_batch.py _batch_impl) -> per-path alive
//     flag and final balance;
//   * scan_full_kernel: full_kernel's one thread per path -> the tracked
//     fields of simulate_paths(traj_len > 0).
// The JVP kernel (a library built with MCRT_JVP_TK, the tangents it carries;
// float32 or float64, Philox or threefry draws) replaces the compiled form
// of JAX's forward-mode AD through that scan, jit(jacfwd(metric))
// (monte_carlo_retirement_tpu/engine/sensitivity.py:476-495), which XLA
// fuses into one device loop carrying the tangents beside the carry:
//   * jvp_kernel: full_kernel's one thread per path over one row, every
//     value of the month step a Dual (dual.cuh) of MCRT_JVP_TK tangents ->
//     per-path success, final balance and its tangents along MCRT_JVP_TK
//     directions of the parameter block (sensitivity_ad's mean and
//     gradient, reduced on the host).
//   It is bound by issue slots too: a tangent costs about one more multiply
//   or add per primal operation (an IEEE division per quotient), so a month
//   costs about 1 + TK forward months. The carry's tangents stay in
//   registers; the Scenario's (TK per parameter) sit in shared memory and
//   are read where a month step uses them.
// Every month step is templated on its scalar type and takes its draws from
// a compile-time source: Philox (float32) for the four kernels above, JAX's
// threefry (threefry.cuh; float32 or float64) for the scan. The scan adds
// its accumulation cap, acc_months = t_scan - 12 R: a row whose W is above
// it accumulates no further, and still retires after month W. Its tile holds
// each path-month's three threefry normals (three 20-round hashes and XLA's
// erfinv) once for the block's rows. What bounds it is the same as above:
// issue slots, and in float64 the FP64 pipe (64 lanes per SM per clock,
// half the FP32 rate; exp and log1p are software sequences there, not MUFU).
//
// Compile-time structure: one library per Statics, scalar type and draw
// source. engine/_build.py passes every flag of `Statics` (tax system and
// annual bill per asset, the kind of each income stream, antithetic pairing,
// glide, guardrails, crashes, longevity) as a -D constant, so every disabled
// branch compiles out, as on the TPU, and a library holds exactly one
// instance of each kernel: the Philox kernels in float32, or the scan's in
// float32 (MCRT_THREEFRY) or float64 (MCRT_THREEFRY and MCRT_REAL_DOUBLE),
// or (MCRT_JVP_TK) the JVP kernel alone, on either draw source and type.
//
// Grid scenarios read their row of the (K, F.NUM + 5*S) parameter block once,
// into registers (the TPU kernel measured per-use parameter reads in the loop
// at ~25x, docs/NOTES.md). The rows of one launch share their seed and block
// offset (row 0's are read), as the plain loop requires, so CRN holds across
// the whole grid. Division is IEEE `/` (no fast math), where Pallas used an
// approximate reciprocal plus a Newton step.
//
// Interface: plain C entries loaded with ctypes; each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "threefry.cuh"

#if !defined(MCRT_USE_REAL1) || !defined(MCRT_USE_REAL2) ||            \
    !defined(MCRT_BILL1) || !defined(MCRT_BILL2) ||                    \
    !defined(MCRT_ANTITHETIC) || !defined(MCRT_GLIDE) ||               \
    !defined(MCRT_GUARDRAILS) || !defined(MCRT_JUMPS) ||               \
    !defined(MCRT_MORTALITY) || !defined(MCRT_NS) ||                   \
    !defined(MCRT_STREAM_KINDS)
#error "the Statics are -D flags: build through engine/_build.py"
#endif
#ifndef MCRT_THREEFRY
#define MCRT_THREEFRY 0
#endif
#ifndef MCRT_REAL_DOUBLE
#define MCRT_REAL_DOUBLE 0
#endif
#ifndef MCRT_JVP_TK
#define MCRT_JVP_TK 0
#endif
#if MCRT_REAL_DOUBLE && !MCRT_THREEFRY && !MCRT_JVP_TK
#error "the Philox kernels run in float32; float64 is the scan's and the JVP's"
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kTileThreads = 512;  // most threads of a tiled block
constexpr int kTileBlocks = 2;     // tiled blocks per SM the registers allow
constexpr int kFullThreads = 256;
constexpr int kBlockPaths = 4096;  // paths per Philox key (global block)
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kDefaultSmem = 49152;
constexpr int kMonths = 12;

// ---------------------------------------------------------------------------
// The scalar type: float32 or float64 arithmetic of one month step
// ---------------------------------------------------------------------------
template <class T>
struct Num;
template <>
struct Num<float> {
  static constexpr float eps = 1e-6f;
  static constexpr float fail_rtol = 2e-5f;  // fail_rtol(float32)
};
template <>
struct Num<double> {
  static constexpr double eps = 1e-6;
  static constexpr double fail_rtol = 0.0;  // fail_rtol(float64)
};

__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_log(float x) { return logf(x); }
__device__ __forceinline__ double r_log(double x) { return log(x); }
__device__ __forceinline__ float r_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double r_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float r_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double r_ceil(double x) { return ceil(x); }
__device__ __forceinline__ float r_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double r_abs(double x) { return fabs(x); }
// The clamps and extrema, one helper per torch op of the plain chain, so
// that the Dual overloads (dual.cuh) can follow each op's tie rule: the
// scalar forms are one fmin/fmax.
//   r_clamp_min(x, lo)  torch.clamp(x, min=lo), lo a constant of the
//                       primal type (a Dual bound does not compile)
//   r_clamp_max(x, hi)  torch.clamp(x, max=hi), the same
//   r_maximum(a, b)     torch.maximum(a, b)
//   r_minimum(a, b)     torch.minimum(a, b)
__device__ __forceinline__ float r_clamp_min(float x, float lo) { return fmaxf(x, lo); }
__device__ __forceinline__ double r_clamp_min(double x, double lo) { return fmax(x, lo); }
__device__ __forceinline__ float r_clamp_max(float x, float hi) { return fminf(x, hi); }
__device__ __forceinline__ double r_clamp_max(double x, double hi) { return fmin(x, hi); }
__device__ __forceinline__ float r_maximum(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_maximum(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float r_minimum(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_minimum(double a, double b) { return fmin(a, b); }
// Rounded on their own: never contracted into a multiply-add.
__device__ __forceinline__ float r_mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double r_mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float r_sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double r_sub_rn(double a, double b) { return __dsub_rn(a, b); }
#include "dual.cuh"  // Dual<R, K> and its overloads of the helpers above

template <class T>
__device__ __forceinline__ T r_inf();
template <>
__device__ __forceinline__ float r_inf<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double r_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000ll);
}
template <class T>
__device__ __forceinline__ T r_nan();
template <>
__device__ __forceinline__ float r_nan<float>() { return __int_as_float(0x7fc00000); }
template <>
__device__ __forceinline__ double r_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);
}

// ---------------------------------------------------------------------------
// This library's Statics (pallas_kernel.Statics) and draw source
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
constexpr bool kThreefry = MCRT_THREEFRY != 0;
#if MCRT_REAL_DOUBLE
using Real = double;  // the scan kernels' scalar type
#else
using Real = float;
#endif
// A float64 thread holds twice the registers: one 16-row block per SM.
constexpr int kScanTileBlocks = sizeof(Real) == 8 ? 1 : kTileBlocks;

// Values per path-month in a draw tile: the probe's growth factors, or the
// grid's normals (plus the crash uniform and normal).
constexpr int kProbeFields = 3;
constexpr int kGridFields = kJumps ? 5 : 3;

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
constexpr int kRow = NUM_FPARAMS + 5 * kNS;
// iparams rows: [W, t_end, seed, block_offset]
enum { I_W = 0, I_T_END, I_SEED, I_BLOCK_OFF, NUM_IPARAMS };

// ---------------------------------------------------------------------------
// Scenario parameters, read once per thread; a disabled feature reads none.
// ---------------------------------------------------------------------------
template <class T>
struct Scenario {
  T mu1, s1, mui, si, mup, sp, rho, rho_c;
  T alloc1, init_bal, contrib0, log1p_growth, expenses, r1, r2;
  T ann1, ann2, alloc1_f;
  T gr_up, gr_lo, gr_adj, gr_floor, gr_cap;
  T jp, jmu, jsig, jbeta, jc1, jc2;
  T mort_g0, mort_b12, mort_cap;
  T amount[kSlots], from_t0[kSlots], duration[kSlots], net[kSlots];

  __device__ __forceinline__ explicit Scenario(const T* __restrict__ fp) {
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
      net[s] = T(1) - fp[NUM_FPARAMS + 4 * kNS + s];
    }
  }
};

// One path-month's draw: the three normals and, with crashes, the crash
// uniform and normal, antithetic sign and reflection applied.
template <class T>
struct Shock {
  T z_eq, z_ind, z_prem, u, z_j;
};

// ---------------------------------------------------------------------------
// Draw source 1: the port's Philox stream (float32)
// ---------------------------------------------------------------------------
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

__device__ __forceinline__ Shock<float> month_shock(int m, const PathKey& key) {
  const uint4 w = mcrt::month_words(key.seed, key.block, m, key.lane);
  Shock<float> s;
  s.z_eq = mcrt::bits_to_normal(w.x);
  s.z_ind = mcrt::bits_to_normal(w.y);
  s.z_prem = mcrt::bits_to_normal(w.z);
  if constexpr (kAntithetic) {
    s.z_eq *= key.sign;
    s.z_ind *= key.sign;
    s.z_prem *= key.sign;
  }
  if constexpr (kJumps) {
    s.u = mcrt::bits_to_uniform(w.w);
    s.z_j = mcrt::bits_to_normal(
        mcrt::crash_word(key.seed, key.block, m, key.lane));
    if constexpr (kAntithetic) {
      if (key.sign < 0.0f) s.u = 1.0f - s.u;
      s.z_j *= key.sign;
    }
  }
  return s;
}

// Longevity (pallas_kernel.py:530-556): one uniform per path from the
// salted key.
__device__ __forceinline__ float mortality_uniform(const PathKey& key) {
  float u = mcrt::bits_to_uniform(
      mcrt::mortality_word(key.seed, key.block, key.lane));
  if constexpr (kAntithetic) {
    if (key.sign < 0.0f) u = 1.0f - u;
  }
  return u;
}

// The launch's Philox paths: global block p / 4096 + the dispatch's offset.
struct PhiloxPaths {
  uint32_t seed;
  int block_offset;
  __device__ __forceinline__ PathKey path(int p) const {
    return path_key(seed, static_cast<uint32_t>(p / kBlockPaths + block_offset),
                    static_cast<uint32_t>(p % kBlockPaths));
  }
};

// ---------------------------------------------------------------------------
// Draw source 2: the JAX scan's threefry stream (threefry.cuh)
// ---------------------------------------------------------------------------
template <class T>
using ScanPath = mcrt::ScanPath<T, kAntithetic>;

template <class T>
__device__ __forceinline__ Shock<T> month_shock(int m, const ScanPath<T>& path) {
  Shock<T> s;
  path.normals(m, s.z_eq, s.z_ind, s.z_prem);
  if constexpr (kJumps) path.crash(m, s.u, s.z_j);
  return s;
}

template <class T>
__device__ __forceinline__ T mortality_uniform(const ScanPath<T>& path) {
  return path.mortality();
}

// The launch's scan paths: global row row_offset + p (a shard's offset).
template <class T>
struct ScanPaths {
  const uint32_t* keys;
  long long row_offset;
  __device__ __forceinline__ ScanPath<T> path(int p) const {
    return ScanPath<T>(keys, row_offset + p);
  }
};

// ---------------------------------------------------------------------------
// The month step's arithmetic (pallas_kernel.py:587-1171)
// ---------------------------------------------------------------------------
// Monthly gross factors (g1, gi, g2) of one path from its draw
// (pallas_kernel.py:745-771); with crashes, the compensated jump folds into
// the exponents (draw_jump, :507-528). The draw is of the scalar type (Z =
// T), or of its primal type under a Dual T (a draw carries no tangent).
template <class T, class Z>
__device__ __forceinline__ void growth(const Scenario<T>& sc, const Shock<Z>& s,
                                       T& g1, T& gi, T& g2) {
  const T z_inf = sc.rho * s.z_eq + sc.rho_c * s.z_ind;
  if constexpr (kJumps) {
    const T jl = s.u < sc.jp ? sc.jmu + sc.jsig * s.z_j : T(0);
    g1 = r_exp(sc.mu1 + sc.s1 * s.z_eq + (jl - sc.jc1));
    gi = r_exp(sc.mui + sc.si * z_inf);
    g2 = gi * r_exp(sc.mup + sc.sp * s.z_prem + (sc.jbeta * jl - sc.jc2));
  } else {
    g1 = r_exp(sc.mu1 + sc.s1 * s.z_eq);
    gi = r_exp(sc.mui + sc.si * z_inf);
    g2 = gi * r_exp(sc.mup + sc.sp * s.z_prem);
  }
}

// Remaining lifetime in retirement months (ops/shocks.py
// gompertz_remaining_months, the overflow-stable two-branch form): u = 0 is
// +inf, absorbed by the max-age cap; b12 = 0 (no rule) never expires.
template <class T>
__device__ __forceinline__ T gompertz_remaining_months(T u, T g0, T b12, T cap,
                                                       T wf) {
  const T g_ret = g0 - wf / b12;
  const T log_u = r_log(u);
  const T t = b12 * (g_ret > T(0) ? g_ret + r_log(r_exp(-g_ret) - log_u)
                                  : r_log1p(-log_u * r_exp(g_ret)));
  const T d = r_minimum(t, r_clamp_min(cap - wf, 0));
  return b12 > T(0) ? d : r_inf<T>();
}

// Sale profile (pallas_kernel.py:587-598): tax per gross dollar, net per
// gross dollar, full-liquidation net capacity.
template <bool USE, class T>
__device__ __forceinline__ void profile(T b, T c, T rate, T& eff, T& nf,
                                        T& nc) {
  constexpr auto kEps = Num<T>::eps;
  if (!USE) {
    eff = T(0);
    nf = T(1);
    nc = b > kEps ? b : T(0);
    return;
  }
  const T safe = b > kEps ? b : T(1);
  const T gf = r_clamp_min(b - c, 0) / safe;
  eff = gf * rate;
  nf = T(1) - eff;
  nc = b > kEps ? b * nf : T(0);
}

// Tax-aware exact-post-tax rebalance toward a1 (pallas_kernel.py:600-638).
template <class T>
__device__ __forceinline__ void rebalance_lite(T& b1, T& c1, T& b2, T& c2,
                                               T eff1, T eff2, T a1,
                                               bool extra_noop) {
  constexpr auto kEps = Num<T>::eps;
  const T total = b1 + b2;
  const T drift1 = b1 - total * a1;
  const T adrift = r_abs(drift1);
  if (extra_noop || total <= kEps || adrift <= kEps) return;
  const bool sell1 = drift1 > T(0);
  const T bal_s = sell1 ? b1 : b2;
  const T basis_s = sell1 ? c1 : c2;
  const T eff_s = sell1 ? eff1 : eff2;
  const T alloc_s = sell1 ? a1 : T(1) - a1;
  const T denom = r_clamp_min(T(1) - alloc_s * eff_s, kEps);
  const T gross_s = r_minimum(bal_s, adrift / denom);
  const T frac_s = gross_s / (bal_s > kEps ? bal_s : T(1));
  const T net_p = gross_s * (T(1) - eff_s);
  const T new_sb = bal_s - gross_s;
  const T new_sc = basis_s - basis_s * frac_s;
  const T bal_b = (sell1 ? b2 : b1) + net_p;
  const T basis_b = (sell1 ? c2 : c1) + net_p;
  T ob1 = sell1 ? new_sb : bal_b;
  T oc1 = sell1 ? new_sc : basis_b;
  T ob2 = sell1 ? bal_b : new_sb;
  T oc2 = sell1 ? basis_b : new_sc;
  if (ob1 <= kEps) { ob1 = T(0); oc1 = T(0); }
  if (ob2 <= kEps) { ob2 = T(0); oc2 = T(0); }
  b1 = ob1; c1 = oc1; b2 = ob2; c2 = oc2;
}

// Capacity-limited sale of net ``target`` split pro-rata by net capacity --
// the withdrawal (pallas_kernel.py:975-999) and the tax bill's payment
// (:657-687): one sale fraction for both assets, snapped to 1 when the
// target reaches the capacity, zero where ``on`` is false. Returns the net
// delivered; gross1 + gross2 is what was sold.
template <class T>
__device__ __forceinline__ T sell_pro_rata(T& b1, T& c1, T& b2, T& c2,
                                           T target, T nc1, T nc2, T nf1,
                                           T nf2, bool on, T& gross1,
                                           T& gross2) {
  constexpr auto kEps = Num<T>::eps;
  const T tnc = nc1 + nc2;
  const T frac =
      r_clamp_max(target >= tnc ? T(1) : target / r_clamp_min(tnc, kEps), 1) *
      (on ? T(1) : T(0));
  const T keep = T(1) - frac;
  gross1 = nc1 > T(0) ? b1 * frac : T(0);
  gross2 = nc2 > T(0) ? b2 * frac : T(0);
  const T nw = gross1 * nf1 + gross2 * nf2;
  if (nc1 > T(0)) c1 *= keep;
  if (nc2 > T(0)) c2 *= keep;
  b1 -= gross1;
  b2 -= gross2;
  if (b1 <= kEps) { b1 = T(0); c1 = T(0); }
  if (b2 <= kEps) { b2 = T(0); c2 = T(0); }
  return nw;
}

// Mark-to-market settlement of one completed tax period (annual_tax,
// pallas_kernel.py:645-690): the bill on the period's positive market gains,
// paid pro-rata by net capacity, then an exact-post-tax rebalance toward a1.
// Returns true when the capacity could not cover the bill.
template <class T>
__device__ __forceinline__ bool annual_tax(const Scenario<T>& sc, T& b1, T& c1,
                                           T& b2, T& c2, T g1a, T g2a, T a1) {
  T due1 = T(0), due2 = T(0);
  if constexpr (kBill1) due1 = r_clamp_min(g1a, 0) * sc.ann1;
  if constexpr (kBill2) due2 = r_clamp_min(g2a, 0) * sc.ann2;
  const T total_due = due1 + due2;
  T eff1, nf1, nc1, eff2, nf2, nc2;
  profile<kUseReal1>(b1, c1, sc.r1, eff1, nf1, nc1);
  profile<kUseReal2>(b2, c2, sc.r2, eff2, nf2, nc2);
  const T tnc = nc1 + nc2;
  const T payment = r_minimum(total_due, tnc);
  const T tol = Num<T>::eps + Num<T>::fail_rtol * (total_due + tnc);
  T gross1, gross2;
  sell_pro_rata(b1, c1, b2, c2, total_due, nc1, nc2, nf1, nf2,
                tnc > Num<T>::eps && payment > T(0), gross1, gross2);
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
template <int S, class T>
__device__ __forceinline__ void stream_income(const Scenario<T>& sc,
                                              const T* start, T* fixed,
                                              T ret_idx_f, T price0,
                                              T& net_income) {
  if constexpr (S < kNS) {
    using K = StreamKind<S>;
    bool active = ret_idx_f >= start[S];
    if constexpr (K::capped) active = active && ret_idx_f < start[S] + sc.duration[S];
    T nominal;
    if constexpr (K::indexed) {
      nominal = sc.amount[S] * price0;
    } else {
      if (active && ret_idx_f == start[S] && fixed[S] < T(0))
        fixed[S] = sc.amount[S] * price0;
      nominal = fixed[S];
    }
    // r_mul_rn: the rounded income, never fused into the sum below.
    const T inc = active ? r_mul_rn(nominal, sc.net[S]) : T(0);
    net_income = S == 0 ? inc : net_income + inc;
    stream_income<S + 1>(sc, start, fixed, ret_idx_f, price0, net_income);
  }
}

// ---------------------------------------------------------------------------
// The month steps (pallas_kernel.py:718-1171), shared by every kernel
// ---------------------------------------------------------------------------
// One path's carry. The tracked fields (ytr .. infl_ret) live only in the
// full kernels; elsewhere they are never read and compile out.
template <class T>
struct Carry {
  T b1, c1, b2, c2, infl, alive_f;
  T g1a, g2a;    // period market gains (annual bills)
  bool preret;   // a bill failed before retirement
  T smult;       // guardrails' spending multiplier
  T stream_start[kSlots], fixed[kSlots];
  T d_mort, glide_scale;
  T ytr, yg, yr, fyg, fyr, start, infl_ret;
};

// The full kernels' year-end records: (L, n) trajectory and price series and
// the (R, n) withdrawal-rate series of path p.
template <class T>
struct Records {
  T* traj;
  T* price;
  T* wr;
  int n, p, R, L, full_wy, partial_wy;
};

// Path = PathKey (Philox) or ScanPath<T> (threefry): its longevity draw.
template <class T, class Path>
__device__ __forceinline__ Carry<T> start_path(const Scenario<T>& sc, int w,
                                               const Path& key) {
  Carry<T> c;
  const T wf = static_cast<T>(w);
#pragma unroll
  for (int s = 0; s < kNS; ++s) {
    c.stream_start[s] =
        r_clamp_min(r_ceil(r_clamp_min(sc.from_t0[s] - wf, 0) - Num<T>::eps), 0);
    c.fixed[s] = T(-1);
  }
  // Longevity: one uniform per path -> remaining months at this row's own
  // retirement date. Only ever compared, so a Dual T takes the primal alone.
  c.d_mort = T(0);
  if constexpr (kMortality) {
    using P = typename Primal<T>::type;
    c.d_mort = T(gompertz_remaining_months(
        static_cast<P>(mortality_uniform(key)), primal(sc.mort_g0),
        primal(sc.mort_b12), primal(sc.mort_cap), primal(wf)));
  }
  // Glide (pallas_kernel.py:559-566): the target moves linearly to alloc1_f
  // over the W working months; retirement holds alloc1_f.
  c.glide_scale = T(0);
  if constexpr (kGlide) c.glide_scale = (sc.alloc1_f - sc.alloc1) / r_clamp_min(wf, 1);

  c.b1 = sc.init_bal * sc.alloc1;
  c.b2 = sc.init_bal - c.b1;
  c.c1 = c.b1;
  c.c2 = c.b2;
  c.infl = T(1);
  c.alive_f = T(1);
  c.g1a = T(0);
  c.g2a = T(0);
  c.preret = false;
  c.smult = T(1);
  c.ytr = c.yg = c.yr = c.fyg = c.fyr = T(0);
  c.start = T(0);
  c.infl_ret = T(1);
  return c;
}

// Accumulation month m (1..W): no deaths, no masks.
template <class T>
__device__ __forceinline__ void accum_month(const Scenario<T>& sc, Carry<T>& c,
                                            int m, T g1, T gi, T g2) {
  if constexpr (kBills) {
    c.g1a += c.b1 * (g1 - T(1));
    c.g2a += c.b2 * (g2 - T(1));
  }
  c.b1 *= g1;
  c.b2 *= g2;
  c.infl *= gi;
  const T contrib =
      sc.contrib0 * r_exp(sc.log1p_growth * static_cast<T>((m - 1) / kMonths));
  T al = sc.alloc1;
  if constexpr (kGlide) al = sc.alloc1 + c.glide_scale * static_cast<T>(m);
  const T ca1 = contrib * al;
  const T ca2 = contrib - ca1;
  c.b1 += ca1;
  c.c1 += ca1;
  c.b2 += ca2;
  c.c2 += ca2;
  T eff1, nf1, nc1, eff2, nf2, nc2;
  profile<kUseReal1>(c.b1, c.c1, sc.r1, eff1, nf1, nc1);
  profile<kUseReal2>(c.b2, c.c2, sc.r2, eff2, nf2, nc2);
  rebalance_lite(c.b1, c.c1, c.b2, c.c2, eff1, eff2, al, false);
  if constexpr (kBills) {
    if (m % kMonths == 0) {  // absolute year boundary (pallas :802-819)
      if (annual_tax(sc, c.b1, c.c1, c.b2, c.c2, c.g1a, c.g2a, al))
        c.preret = true;
      c.g1a = T(0);
      c.g2a = T(0);
    }
  }
}

// The retirement snapshot: a bill that failed before retirement kills the
// path at its own W (pallas :839-841).
template <class T>
__device__ __forceinline__ void snapshot(Carry<T>& c) {
  if constexpr (kBills) {
    if (c.preret) c.alive_f = T(0);
  }
}

// Retirement month m (W+1..t_end). TRACK adds the full-mode records,
// stored straight to the (L, n) / (R, n) series at year ends.
template <bool TRACK, class T>
__device__ __forceinline__ void retire_month(const Scenario<T>& sc, Carry<T>& c,
                                             int m, int w, int t_end,
                                             T g1, T gi, T g2,
                                             const Records<T>& rec) {
  constexpr auto kEps = Num<T>::eps;
  const bool alive = c.alive_f > T(0.5);
  const T alive0_f = c.alive_f;
  const int k = m - w;
  const int ret_idx = k - 1;
  const T ret_idx_f = static_cast<T>(ret_idx);
  if (TRACK && k % kMonths == 1) {
    c.yg = T(0);
    c.yr = T(0);
  }

  // income waterfall & net spending need
  const T price0 = c.infl;
  T expenses = sc.expenses;
  if constexpr (kGuardrails) {  // pallas :887-912
    // Year starts (years 1+) of a living path only; the predicate on
    // ret_idx is uniform across the warp (one row per warp).
    if (ret_idx % kMonths == 0 && ret_idx > 0 && alive) {
      const T planned = T(12) * sc.expenses * c.smult * price0;
      const T wr_now = planned / r_clamp_min(c.b1 + c.b2, kEps);
      T s_new = wr_now > sc.gr_up ? c.smult * (T(1) - sc.gr_adj) : c.smult;
      s_new = wr_now < sc.gr_lo ? c.smult * (T(1) + sc.gr_adj) : s_new;
      c.smult = r_minimum(r_maximum(s_new, sc.gr_floor), sc.gr_cap);
    }
    expenses = sc.expenses * c.smult;
  }
  T need = expenses * price0;
  if constexpr (kNS > 0) {
    T net_income = T(0);
    stream_income<0>(sc, c.stream_start, c.fixed, ret_idx_f, price0,
                     net_income);
    // The rounded income from the rounded expenses, as the JAX loop takes
    // it (r_sub_rn is never contracted): income that covers the expenses
    // exactly leaves a need of exactly 0, so a path with no balance lives
    // on. nvcc's fmaf(expenses, price0, -income) left the product's
    // round-off, up to half an ulp of expenses x price (> kEps), and ruined
    // every such path (the edge sweep's zero-balance, pension-funded case).
    need = r_clamp_min(r_sub_rn(need, net_income), 0);
  }
  bool living = true;
  if constexpr (kMortality) {  // spending ends with the owner (:942-948)
    living = ret_idx_f < c.d_mort;
    if (!living) need = T(0);
  }

  // ruin check A, then growth (dead/ruined paths freeze)
  const bool dies_a = alive && (c.b1 + c.b2 <= kEps) && (need > kEps);
  const bool gmask = alive && !dies_a;
  if (gmask) {
    if constexpr (kBills) {
      c.g1a += c.b1 * (g1 - T(1));
      c.g2a += c.b2 * (g2 - T(1));
    }
    c.b1 *= g1;
    c.b2 *= g2;
    c.infl *= gi;
  }

  // ruin check B, then the capacity-limited withdrawal split pro-rata by
  // net capacity: one sale fraction for both assets
  const T total1 = c.b1 + c.b2;
  const bool dies_b = gmask && (total1 <= kEps) && (need > kEps);
  const bool wmask = gmask && !dies_b;
  T eff1, nf1, nc1, eff2, nf2, nc2;
  profile<kUseReal1>(c.b1, c.c1, sc.r1, eff1, nf1, nc1);
  profile<kUseReal2>(c.b2, c.c2, sc.r2, eff2, nf2, nc2);
  const T ftol = kEps + Num<T>::fail_rtol * (need + total1);
  T gross1, gross2;
  const T nw = sell_pro_rata(c.b1, c.c1, c.b2, c.c2, need, nc1, nc2, nf1,
                             nf2, wmask, gross1, gross2);
  const bool fail_net = wmask && (need > kEps) && (nw < need - ftol);
  if (TRACK) {
    const T gw = gross1 + gross2;
    c.yg += gw;
    c.yr += gw / r_clamp_min(price0, kEps);
  }

  // monthly rebalance (the proportional sale left the profiles valid)
  rebalance_lite(c.b1, c.c1, c.b2, c.c2, eff1, eff2, sc.alloc1_f, !wmask);

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
            annual_tax(sc, c.b1, c.c1, c.b2, c.c2, c.g1a, c.g2a, sc.alloc1_f);
        if (is_boundary) {
          c.g1a = T(0);
          c.g2a = T(0);
        }
        dies = dies_pre || tfail;
        dies_regular = dies && !(is_settle && tfail);
      }
    }
  }
  if (dies) c.alive_f = T(0);
  if (TRACK) {
    const int n = rec.n, p = rec.p;
    c.ytr += alive0_f;  // alive-months counter
    if (k <= kMonths) {  // first retirement year: capture at death / year end
      const bool cap_fy = (alive0_f > T(0.5)) && (dies_regular || k % kMonths == 0);
      if (cap_fy) {
        c.fyg = c.yg;
        c.fyr = c.yr * c.infl_ret;
      }
    }
    if (k % kMonths == 0) {  // year-end records with death padding
      const size_t slot = static_cast<size_t>(min(
          rec.full_wy + rec.partial_wy + (k + kMonths - 1) / kMonths, rec.L - 1));
      const size_t yslot =
          static_cast<size_t>(min(max(k / kMonths - 1, 0), rec.R - 1));
      const T total2 = c.b1 + c.b2;
      const bool died_this_year =
          (c.ytr > static_cast<T>((k / kMonths - 1) * kMonths) + T(0.5)) &&
          (c.ytr < static_cast<T>(k) + T(0.5));
      const bool alive_now = c.alive_f > T(0.5);
      if (alive_now || died_this_year)
        rec.traj[slot * n + p] = alive_now ? total2 : r_clamp_min(total2, 0);
      rec.price[slot * n + p] = c.infl;
      // withdrawal-rate observations only for fully-lived years
      if ((alive0_f > T(0.5)) && !dies_regular && living)
        rec.wr[yslot * n + p] = c.start > kEps
            ? c.yr * c.infl_ret / r_clamp_min(c.start, kEps) * T(100) : T(0);
    }
  }
}

// ---------------------------------------------------------------------------
// The tiled month loop (probe_kernel, grid_kernel, scan_rows_kernel)
// ---------------------------------------------------------------------------
// One path-month's growth factors from the draw tile (t: this lane's entry
// of the month): the probe's tile holds them; a grid row applies its own
// parameters to the tile's normals.
template <bool GRID, class T>
__device__ __forceinline__ void tile_growth(const Scenario<T>& sc, const T* t,
                                            T& g1, T& gi, T& g2) {
  constexpr int P = kWarp;
  if constexpr (GRID) {
    Shock<T> s;
    s.z_eq = t[0];
    s.z_ind = t[P];
    s.z_prem = t[2 * P];
    if constexpr (kJumps) {
      s.u = t[3 * P];
      s.z_j = t[4 * P];
    }
    growth(sc, s, g1, gi, g2);
  } else {
    g1 = t[0];
    gi = t[P];
    g2 = t[2 * P];
  }
}

// The carry a probe row takes over at its month W from accum_kernel, in a
// (rows, kCarryFields, n) buffer: the balances, their bases and the price
// level; with annual bills also the period's market gains and the flag of
// a bill that failed before retirement (the snapshot reads it).
constexpr int kCarryFields = kBills ? 8 : 5;

template <class T>
__device__ __forceinline__ void store_row_carry(const Carry<T>& c, T* out,
                                                size_t n) {
  out[0] = c.b1;
  out[n] = c.c1;
  out[2 * n] = c.b2;
  out[3 * n] = c.c2;
  out[4 * n] = c.infl;
  if constexpr (kBills) {
    out[5 * n] = c.g1a;
    out[6 * n] = c.g2a;
    out[7 * n] = c.preret ? T(1) : T(0);
  }
}

template <class T>
__device__ __forceinline__ void load_row_carry(Carry<T>& c, const T* in,
                                               size_t n) {
  c.b1 = in[0];
  c.c1 = in[n];
  c.b2 = in[2 * n];
  c.c2 = in[3 * n];
  c.infl = in[4 * n];
  if constexpr (kBills) {
    c.g1a = in[5 * n];
    c.g2a = in[6 * n];
    c.preret = in[7 * n] > T(0.5);
  }
}

// The smallest W of the block's rows (each warp's lane 0 votes for its
// row); every thread of the block calls it.
__device__ __forceinline__ int block_min_w(int w, bool votes) {
  __shared__ int lo;
  if (threadIdx.x == 0) lo = 0x7fffffff;
  __syncthreads();
  if (votes) atomicMin(&lo, w);
  __syncthreads();
  return lo;
}

// Block (bx, by) holds rows by*C .. by*C+C-1 and paths bx*32 .. bx*32+31;
// warp v of the block serves row by*C + v (cuda_kernel.TilePlan.cell mirrors
// this). Dynamic shared memory: the draw tile [M][FIELDS][32] of T, then
// the block's largest t_end, the last month it may draw. A warp beyond the
// last row reads the last row's parameters, runs no month and writes
// nothing. ``paths`` gives each path its draws; a row accumulates months
// 1..min(W, acc_cap) (the scan's cap; the Philox kernels have none) and
// retires months W+1..t_end, until its warp finds none of its paths alive
// at the end of a retirement year or of a chunk (a retirement month always
// runs before the first vote: it settles a path that the snapshot killed).
// counts[row] gets the row's survivors, steps[row] the retirement months
// its warps ran. DECIDED (the probe under MCRT_MORTALITY) also counts, in
// steps[n_rows + row], the retirement months its warps ran after every
// path of the warp was decided: ruined, or solvent past its owner's death
// (no spending is left to fail). The warps look where they vote, so a
// warp counts the months after the first vote that finds it decided.
// SHARED_ACCUM (the probe without a glide path): a row with W > 0 runs no
// accumulation month; it loads its carry at W from ``carry`` (n_rows,
// kCarryFields, n), written by accum_kernel, and the block's loop starts at
// the chunk that holds its smallest W + 1, drawing no month below it.
template <bool GRID, bool DECIDED = false, bool SHARED_ACCUM = false, class T,
          class Paths>
__device__ __forceinline__ void tile_body(
    const T* __restrict__ fp, const int* __restrict__ ip, int n_rows,
    int n, int rows_per_block, int months_per_chunk, const Paths& paths,
    int acc_cap, T* __restrict__ success, T* __restrict__ final_bal,
    int* __restrict__ counts, int* __restrict__ steps,
    const T* __restrict__ carry = nullptr) {
  constexpr int FIELDS = GRID ? kGridFields : kProbeFields;
  constexpr int P = kWarp;  // paths per block
  extern __shared__ __align__(8) unsigned char smem_raw[];
  const int M = months_per_chunk;
  T* tile = reinterpret_cast<T*>(smem_raw);
  int* block_t_end = reinterpret_cast<int*>(tile + M * FIELDS * P);

  const int row_in_block = threadIdx.x / kWarp;
  const int j = threadIdx.x % kWarp;
  const int row = blockIdx.y * rows_per_block + row_in_block;
  const bool has_row = row < n_rows;
  const int my_row = has_row ? row : n_rows - 1;
  const int p0 = blockIdx.x * P;  // 32 divides 4096: one key block per tile
  const int p = p0 + j;

  const int* irow = ip + my_row * NUM_IPARAMS;
  const int w = irow[I_W];
  const int w_acc = kThreefry ? min(w, acc_cap) : w;
  const int t_end = has_row ? irow[I_T_END] : 0;
  const auto key = paths.path(p);

  if (threadIdx.x == 0) *block_t_end = 0;
  __syncthreads();
  if (j == 0 && has_row) atomicMax(block_t_end, t_end);
  __syncthreads();
  const int t_max = *block_t_end;

  const Scenario<T> sc(GRID ? fp + static_cast<size_t>(my_row) * kRow : fp);
  Carry<T> c = start_path(sc, w, key);
  // The first month the block draws: month 1, or (SHARED_ACCUM) the first
  // of the chunk that holds its rows' smallest W + 1.
  int m_first = 1, w_lo = 0;
  if constexpr (SHARED_ACCUM) {
    w_lo = block_min_w(w, j == 0 && has_row);
    m_first = 1 + (w_lo / M) * M;
    if (has_row && w > 0 && p < n)
      load_row_carry(c, carry + static_cast<size_t>(row) * kCarryFields * n + p,
                     static_cast<size_t>(n));
  }
  // The last month this warp runs (warp-uniform): its row's t_end, or the
  // month of the vote that found none of its paths alive.
  int end = t_end;
  // The month of the first vote that found every path of the warp decided
  // (0: none yet); warp-uniform.
  int decided_at = 0;

  for (int m0 = m_first; m0 <= t_max; m0 += M) {
    const int mc = min(M, t_max - m0 + 1);
    // Draw phase: every warp of the block, each path-month once (warp v
    // draws months v, v + C, ... of the chunk for its 32 paths), from the
    // block's first retirement month on where accum_kernel drew the rest.
    const int mm0 = SHARED_ACCUM ? max(0, w_lo + 1 - m0) : 0;
    for (int mm = mm0 + row_in_block; mm < mc; mm += rows_per_block) {
      const Shock<T> s = month_shock(m0 + mm, key);
      T* t = tile + mm * FIELDS * P + j;
      if constexpr (GRID) {
        t[0] = s.z_eq;
        t[P] = s.z_ind;
        t[2 * P] = s.z_prem;
        if constexpr (kJumps) {
          t[3 * P] = s.u;
          t[4 * P] = s.z_j;
        }
      } else {
        T g1, gi, g2;
        growth(sc, s, g1, gi, g2);  // the probe's rows share sc
        t[0] = g1;
        t[P] = gi;
        t[2 * P] = g2;
      }
    }
    __syncthreads();
    // Body phase: each warp runs its row's months of the chunk up to its
    // end: its accumulation months, the snapshot, then its retirement
    // months, a year or the rest of the chunk at a time.
    const int m_last = min(m0 + mc - 1, end);
    T g1, gi, g2;
    if constexpr (!SHARED_ACCUM) {
      for (int m = m0; m <= min(m_last, w_acc); ++m) {
        tile_growth<GRID>(sc, tile + (m - m0) * FIELDS * P + j, g1, gi, g2);
        accum_month(sc, c, m, g1, gi, g2);
      }
    }
    if (m0 <= w + 1 && w + 1 <= m_last) snapshot(c);
    for (int m = max(m0, w + 1); m <= m_last;) {
      // To the end of this retirement year or of the chunk; then the warp
      // votes on its paths.
      const int m_vote = min(m_last, m + kMonths - 1 - (m - w - 1) % kMonths);
      for (; m <= m_vote; ++m) {
        tile_growth<GRID>(sc, tile + (m - m0) * FIELDS * P + j, g1, gi, g2);
        retire_month<false>(sc, c, m, w, t_end, g1, gi, g2, Records<T>{});
      }
      if constexpr (kMortality && DECIDED) {
        // Undecided: alive, and its owner lives in month m_vote + 1.
        if (decided_at == 0 &&
            !__any_sync(0xffffffffu, p < n && c.alive_f > T(0.5) &&
                                         static_cast<T>(m_vote - w) < c.d_mort))
          decided_at = m_vote;
      }
      if (!__any_sync(0xffffffffu, p < n && c.alive_f > T(0.5))) {
        end = m_vote;
        break;
      }
    }
    // The tile is read before the next chunk's draws; the block draws on
    // while one of its warps has a month left.
    if (!__syncthreads_or(end >= m0 + mc)) break;
  }
  if (t_end <= w) snapshot(c);  // a row without retirement months

  int alive_i = 0;
  if (has_row && p < n) {
    const size_t idx = static_cast<size_t>(row) * n + p;
    success[idx] = c.alive_f;
    final_bal[idx] = r_clamp_min(c.b1 + c.b2, 0);
    alive_i = c.alive_f > T(0.5);
  }
  // Survivors: one ballot per warp (= per row of the block), one atomic per
  // (block, row); padding lanes and rowless warps vote 0.
  const unsigned ballot = __ballot_sync(0xffffffffu, alive_i);
  if (j == 0 && has_row) {
    atomicAdd(counts + row, __popc(ballot));
    atomicAdd(steps + row, max(end - w, 0));  // the retirement months run
    if constexpr (kMortality && DECIDED)
      atomicAdd(steps + n_rows + row, decided_at > 0 ? end - decided_at : 0);
  }
}

// ---------------------------------------------------------------------------
// The tracked month loop (full_kernel, scan_full_kernel): one thread per
// path, draws in-thread; months 1..min(W, acc_cap) accumulate
// ---------------------------------------------------------------------------
template <class T, class Path>
__device__ __forceinline__ void full_body(const T* __restrict__ fp,
                                          const int* __restrict__ ip, int n,
                                          int R, int L, int p, const Path& key,
                                          int acc_cap, T* __restrict__ vecs,
                                          T* __restrict__ traj,
                                          T* __restrict__ price,
                                          T* __restrict__ wr) {
  const Scenario<T> sc(fp);
  const int w = ip[I_W], t_end = ip[I_T_END];
  const int w_acc = kThreefry ? min(w, acc_cap) : w;
  const Records<T> rec{traj, price, wr, n, p, R, L, w / kMonths,
                       (w % kMonths) != 0};
  Carry<T> c = start_path(sc, w, key);

  traj[p] = sc.init_bal;
  price[p] = T(1);
  for (int j = 1; j < L; ++j) {
    traj[static_cast<size_t>(j) * n + p] = T(0);
    price[static_cast<size_t>(j) * n + p] = T(1);
  }
  for (int y = 0; y < R; ++y) wr[static_cast<size_t>(y) * n + p] = r_nan<T>();

  T g1, gi, g2;
  for (int m = 1; m <= w_acc; ++m) {
    growth(sc, month_shock(m, key), g1, gi, g2);
    accum_month(sc, c, m, g1, gi, g2);
    if (m % kMonths == 0) {
      const size_t slot = static_cast<size_t>(min(m / kMonths, L - 1));
      traj[slot * n + p] = c.b1 + c.b2;
      price[slot * n + p] = c.infl;
    }
  }
  snapshot(c);
  c.start = c.b1 + c.b2;
  c.infl_ret = c.infl;
  if (rec.partial_wy) {
    const size_t slot = static_cast<size_t>(min(rec.full_wy + 1, L - 1));
    traj[slot * n + p] = c.start;
    price[slot * n + p] = c.infl_ret;
  }
  for (int m = w + 1; m <= t_end; ++m) {
    growth(sc, month_shock(m, key), g1, gi, g2);
    retire_month<true>(sc, c, m, w, t_end, g1, gi, g2, rec);
  }

  // vecs rows: success, final, start, ytr, fy_g, fy_r, infl_ret
  vecs[p] = c.alive_f;
  vecs[static_cast<size_t>(n) + p] = r_clamp_min(c.b1 + c.b2, 0);
  vecs[2 * static_cast<size_t>(n) + p] = c.start;
  vecs[3 * static_cast<size_t>(n) + p] =
      c.alive_f > T(0.5) ? r_nan<T>() : c.ytr / static_cast<T>(kMonths);
  vecs[4 * static_cast<size_t>(n) + p] = c.fyg;
  vecs[5 * static_cast<size_t>(n) + p] = c.fyr;
  vecs[6 * static_cast<size_t>(n) + p] = c.infl_ret;
}

#if MCRT_JVP_TK
// ---------------------------------------------------------------------------
// The JVP kernel (Real: float32 or float64; Philox or threefry draws)
// ---------------------------------------------------------------------------
// One row's month loop carrying kTK tangents of every value with respect to
// its parameter block fp (F.NUM + 5*S values): the compiled form of JAX's
// jit(jacfwd(metric)) through simulate_paths (monte_carlo_retirement_tpu/
// engine/sensitivity.py:476-495), which the port's sensitivity_ad reduces to
// the mean final balance and its gradient. One thread per path, as
// full_kernel: the carry and its tangents in registers, the draws made in
// the thread. The block stages the parameters and their kTK tangent
// directions (fp_dot, kTK x P) in shared memory as Duals, and each month
// step reads the fields it uses from there, never holding the Scenario's
// tangents in registers.
constexpr int kTK = MCRT_JVP_TK;
constexpr int kJvpThreads = 128;
using DReal = Dual<Real, kTK>;

// Loads after this point are made after it: the month loop rereads the
// Scenario from shared memory each month instead of hoisting it out.
__device__ __forceinline__ void reread_memory() { asm volatile("" ::: "memory"); }

// A path-month's draw in the primal type: the Philox stream's float32
// values widened, as the plain chain takes them (engine/kernel.py draw:
// ``.to(dtype)``), or the scan's own.
template <class Z>
__device__ __forceinline__ Shock<Real> real_shock(const Shock<Z>& z) {
  Shock<Real> s;
  s.z_eq = static_cast<Real>(z.z_eq);
  s.z_ind = static_cast<Real>(z.z_ind);
  s.z_prem = static_cast<Real>(z.z_prem);
  if constexpr (kJumps) {
    s.u = static_cast<Real>(z.u);
    s.z_j = static_cast<Real>(z.z_j);
  }
  return s;
}

template <class Paths>
__device__ __forceinline__ void jvp_body(const Real* __restrict__ fp,
                                         const Real* __restrict__ fp_dot,
                                         const int* __restrict__ ip, int n,
                                         const Paths& paths, int acc_cap,
                                         Real* __restrict__ success,
                                         Real* __restrict__ final_bal,
                                         Real* __restrict__ tangents) {
  __shared__ DReal params[kRow];
  for (int i = threadIdx.x; i < kRow; i += blockDim.x) {
    DReal d(fp[i]);
#pragma unroll
    for (int k = 0; k < kTK; ++k) d.t[k] = fp_dot[k * kRow + i];
    params[i] = d;
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int w = ip[I_W], t_end = ip[I_T_END];
  const int w_acc = kThreefry ? min(w, acc_cap) : w;
  const auto key = paths.path(p);
  Carry<DReal> c = start_path(Scenario<DReal>(params), w, key);
  DReal g1, gi, g2;
  for (int m = 1; m <= w_acc; ++m) {
    reread_memory();
    const Scenario<DReal> sc(params);
    growth(sc, real_shock(month_shock(m, key)), g1, gi, g2);
    accum_month(sc, c, m, g1, gi, g2);
  }
  snapshot(c);
  for (int m = w + 1; m <= t_end; ++m) {
    reread_memory();
    const Scenario<DReal> sc(params);
    growth(sc, real_shock(month_shock(m, key)), g1, gi, g2);
    retire_month<false>(sc, c, m, w, t_end, g1, gi, g2, Records<DReal>{});
  }
  const DReal fin = r_clamp_min(c.b1 + c.b2, 0);
  success[p] = c.alive_f.v;
  final_bal[p] = fin.v;
#pragma unroll
  for (int k = 0; k < kTK; ++k) tangents[static_cast<size_t>(k) * n + p] = fin.t[k];
}

// ip: one row [W, t_end, seed, block_offset]; keys: the scan's (T + 1, 6)
// key table (threefry draws) or unused (Philox); acc_cap: the scan's
// accumulation cap (threefry only).
__global__ void __launch_bounds__(kJvpThreads)
    jvp_kernel(const Real* __restrict__ fp, const Real* __restrict__ fp_dot,
               const int* __restrict__ ip, const uint32_t* __restrict__ keys,
               int n, int acc_cap, long long row_offset,
               Real* __restrict__ success, Real* __restrict__ final_bal,
               Real* __restrict__ tangents) {
#if MCRT_THREEFRY
  const ScanPaths<Real> paths{keys, row_offset};
#else
  const PhiloxPaths paths{static_cast<uint32_t>(ip[I_SEED]), ip[I_BLOCK_OFF]};
#endif
  jvp_body(fp, fp_dot, ip, n, paths, acc_cap, success, final_bal, tangents);
}
#elif !MCRT_THREEFRY
// ---------------------------------------------------------------------------
// The Philox kernels (float32)
// ---------------------------------------------------------------------------
#if !MCRT_GLIDE
// A value the compiler may not look through: the tiled loop reads each
// growth factor back from shared memory, so no operation of growth()
// contracts into an accumulation month's there, and none does here.
__device__ __forceinline__ float opaque(float x) {
  asm("" : "+f"(x));
  return x;
}

// The smallest row W above month m (0x7fffffff: none); the same for every
// thread.
__device__ __forceinline__ int next_row_w(const int* __restrict__ ip,
                                          int n_rows, int m) {
  int next = 0x7fffffff;
  for (int r = 0; r < n_rows; ++r) {
    const int w = ip[r * NUM_IPARAMS + I_W];
    if (w > m) next = min(next, w);
  }
  return next;
}

// The probe's shared working years: months 1..w_max (the launch's largest
// W) of each path, one thread per path, drawn in-thread as full_kernel
// draws; after month W of each row, that row's slice of carry (n_rows,
// kCarryFields, n) gets the path's carry. A row with W = 0 gets none: its
// carry is start_path's.
__global__ void __launch_bounds__(kFullThreads)
    accum_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                 int n_rows, int n, int w_max, float* __restrict__ carry) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const PhiloxPaths paths{static_cast<uint32_t>(ip[I_SEED]), ip[I_BLOCK_OFF]};
  const PathKey key = paths.path(p);
  const Scenario<float> sc(fp);
  Carry<float> c = start_path(sc, 0, key);
  int next = next_row_w(ip, n_rows, 0);
  for (int m = 1; m <= w_max; ++m) {
    float g1, gi, g2;
    growth(sc, month_shock(m, key), g1, gi, g2);
    accum_month(sc, c, m, opaque(g1), opaque(gi), opaque(g2));
    if (m == next) {
      for (int r = 0; r < n_rows; ++r)
        if (ip[r * NUM_IPARAMS + I_W] == m)
          store_row_carry(c, carry + static_cast<size_t>(r) * kCarryFields * n + p,
                          static_cast<size_t>(n));
      next = next_row_w(ip, n_rows, m);
    }
  }
}
#endif

// Candidates share one parameter block (fp: F.NUM + 5*S floats). Without a
// glide path each row starts from its carry at W (accum_kernel's).
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    probe_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                 int n_rows, int n, int rows_per_block, int months_per_chunk,
                 const float* __restrict__ carry, float* __restrict__ success,
                 float* __restrict__ final_bal, int* __restrict__ counts,
                 int* __restrict__ steps) {
  const PhiloxPaths paths{static_cast<uint32_t>(ip[I_SEED]), ip[I_BLOCK_OFF]};
  tile_body<false, true, !kGlide>(fp, ip, n_rows, n, rows_per_block,
                                  months_per_chunk, paths, 0, success,
                                  final_bal, counts, steps, carry);
}

// One parameter row per scenario (fp: K rows of F.NUM + 5*S floats).
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    grid_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                int n_rows, int n, int rows_per_block, int months_per_chunk,
                float* __restrict__ success, float* __restrict__ final_bal,
                int* __restrict__ counts, int* __restrict__ steps) {
  const PhiloxPaths paths{static_cast<uint32_t>(ip[I_SEED]), ip[I_BLOCK_OFF]};
  tile_body<true>(fp, ip, n_rows, n, rows_per_block, months_per_chunk, paths,
                  0, success, final_bal, counts, steps);
}

__global__ void __launch_bounds__(kFullThreads)
    full_kernel(const float* __restrict__ fp, const int* __restrict__ ip,
                int n, int R, int L, float* __restrict__ vecs,
                float* __restrict__ traj, float* __restrict__ price,
                float* __restrict__ wr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const PhiloxPaths paths{static_cast<uint32_t>(ip[I_SEED]), ip[I_BLOCK_OFF]};
  full_body(fp, ip, n, R, L, p, paths.path(p), 0, vecs, traj, price, wr);
}
#else
// ---------------------------------------------------------------------------
// The scan kernels (Real: float32 or float64), on the JAX scan's draws
// ---------------------------------------------------------------------------
// K rows x n paths; SHARED: one parameter block for every row (the probe
// form), else one per row (the batch form). keys: the (T + 1, 6) key table.
template <bool SHARED>
__global__ void __launch_bounds__(kTileThreads, kScanTileBlocks)
    scan_rows_kernel(const Real* __restrict__ fp, const int* __restrict__ ip,
                     const uint32_t* __restrict__ keys, int n_rows, int n,
                     int rows_per_block, int months_per_chunk, int acc_cap,
                     long long row_offset, Real* __restrict__ success,
                     Real* __restrict__ final_bal, int* __restrict__ counts,
                     int* __restrict__ steps) {
  const ScanPaths<Real> paths{keys, row_offset};
  tile_body<!SHARED>(fp, ip, n_rows, n, rows_per_block, months_per_chunk,
                     paths, acc_cap, success, final_bal, counts, steps);
}

__global__ void __launch_bounds__(kFullThreads)
    scan_full_kernel(const Real* __restrict__ fp, const int* __restrict__ ip,
                     const uint32_t* __restrict__ keys, int n, int R, int L,
                     int acc_cap, long long row_offset,
                     Real* __restrict__ vecs, Real* __restrict__ traj,
                     Real* __restrict__ price, Real* __restrict__ wr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const ScanPaths<Real> paths{keys, row_offset};
  full_body(fp, ip, n, R, L, p, paths.path(p), acc_cap, vecs, traj, price, wr);
}
#endif

// A tiled launch as engine/cuda_kernel.py's tile_plan describes it, checked
// against the kernel's own limits and the shared-memory formula.
inline bool tile_plan_ok(int n_rows, int n_paths, int n_streams,
                         int rows_per_block, int months_per_chunk, int fields,
                         int want_fields, int smem_bytes, int elem_bytes) {
  const long long want_smem =
      static_cast<long long>(elem_bytes) * months_per_chunk * fields * kWarp + 4;
  return n_rows >= 1 && n_paths >= 1 && n_streams == kNS &&
         rows_per_block >= 1 && rows_per_block * kWarp <= kTileThreads &&
         months_per_chunk >= 1 && fields == want_fields &&
         smem_bytes == want_smem && smem_bytes <= kMaxSmem &&
         (n_rows + rows_per_block - 1) / rows_per_block <= 65535;
}

template <class Kernel>
int set_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

#if !MCRT_THREEFRY && !MCRT_JVP_TK
// A tiled launch of probe_kernel (with its carry, null under a glide path)
// or grid_kernel.
template <bool GRID>
int launch_tiles(const void* fp, const void* ip, int n_rows, int n_paths,
                 int n_streams, int rows_per_block, int months_per_chunk,
                 int fields, int smem_bytes, const void* carry, void* success,
                 void* final_bal, void* counts, void* steps, void* stream) {
  if (!tile_plan_ok(n_rows, n_paths, n_streams, rows_per_block,
                    months_per_chunk, fields,
                    GRID ? kGridFields : kProbeFields, smem_bytes, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier, unrelated error
  const dim3 grid((n_paths + kWarp - 1) / kWarp,
                  (n_rows + rows_per_block - 1) / rows_per_block);
  const dim3 block(rows_per_block * kWarp);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(fp);
  const auto* i = static_cast<const int*>(ip);
  auto* ok = static_cast<float*>(success);
  auto* fin = static_cast<float*>(final_bal);
  auto* cnt = static_cast<int*>(counts);
  auto* st = static_cast<int*>(steps);
  if constexpr (GRID) {
    if (const int err = set_smem(grid_kernel, smem_bytes)) return err;
    grid_kernel<<<grid, block, smem_bytes, s>>>(
        f, i, n_rows, n_paths, rows_per_block, months_per_chunk, ok, fin, cnt,
        st);
  } else {
    if (const int err = set_smem(probe_kernel, smem_bytes)) return err;
    probe_kernel<<<grid, block, smem_bytes, s>>>(
        f, i, n_rows, n_paths, rows_per_block, months_per_chunk,
        static_cast<const float*>(carry), ok, fin, cnt, st);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace

extern "C" {

#if MCRT_JVP_TK
// One launch of jvp_kernel: the row's per-path success and final balance
// (n) and kTK tangent rows (kTK x n) of the final balance along the kTK rows
// of fp_dot. n_params, n_streams, tangents and elem_bytes are the caller's
// view of the block, checked against this library's.
int mcrt_jvp(const void* fp, const void* fp_dot, const void* ip,
             const void* keys, int n_paths, int n_params, int n_streams,
             int tangents, int elem_bytes, int acc_cap, long long row_offset,
             void* success, void* final_bal, void* tangent_rows,
             void* stream) {
  if (n_paths < 1 || n_params != kRow || n_streams != kNS ||
      tangents != kTK || elem_bytes != static_cast<int>(sizeof(Real)) ||
      row_offset < 0 || (kThreefry && keys == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  jvp_kernel<<<(n_paths + kJvpThreads - 1) / kJvpThreads, kJvpThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Real*>(fp), static_cast<const Real*>(fp_dot),
      static_cast<const int*>(ip), static_cast<const uint32_t*>(keys),
      n_paths, acc_cap, row_offset, static_cast<Real*>(success),
      static_cast<Real*>(final_bal), static_cast<Real*>(tangent_rows));
  return static_cast<int>(cudaGetLastError());
}
#elif !MCRT_THREEFRY
// counts and steps: (K,) int32, zeroed by the caller; each row gets its
// survivors and the retirement months its warps ran. Under MCRT_MORTALITY
// the probe's steps are (2, K): row 1 gets the months its warps ran once
// decided (tile_body). Without a glide path (carry_fields == kCarryFields;
// 0 under one) and with w_max, the rows' largest W, above 0, accum_kernel
// first runs months 1..w_max into carry, (K, carry_fields, n_paths) floats
// (null where w_max is 0), on the same stream.
int mcrt_probe(const void* fp, const void* ip, int n_cand, int n_paths,
               int n_streams, int rows_per_block, int months_per_chunk,
               int fields, int smem_bytes, int carry_fields, int w_max,
               void* carry, void* success, void* final_bal, void* counts,
               void* steps, void* stream) {
  const bool shared = !kGlide && w_max > 0;
  if (carry_fields != (kGlide ? 0 : kCarryFields) || w_max < 0 ||
      (carry != nullptr) != shared ||
      !tile_plan_ok(n_cand, n_paths, n_streams, rows_per_block,
                    months_per_chunk, fields, kProbeFields, smem_bytes, 4))
    return static_cast<int>(cudaErrorInvalidValue);
#if !MCRT_GLIDE
  if (shared) {
    cudaGetLastError();  // clear any earlier, unrelated error
    accum_kernel<<<(n_paths + kFullThreads - 1) / kFullThreads, kFullThreads,
                   0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(fp), static_cast<const int*>(ip), n_cand,
        n_paths, w_max, static_cast<float*>(carry));
    if (const int err = static_cast<int>(cudaGetLastError())) return err;
  }
#endif
  return launch_tiles<false>(fp, ip, n_cand, n_paths, n_streams,
                             rows_per_block, months_per_chunk, fields,
                             smem_bytes, carry, success, final_bal, counts,
                             steps, stream);
}

int mcrt_grid(const void* fp, const void* ip, int n_rows, int n_paths,
              int n_streams, int rows_per_block, int months_per_chunk,
              int fields, int smem_bytes, void* success, void* final_bal,
              void* counts, void* steps, void* stream) {
  return launch_tiles<true>(fp, ip, n_rows, n_paths, n_streams,
                            rows_per_block, months_per_chunk, fields,
                            smem_bytes, nullptr, success, final_bal, counts,
                            steps, stream);
}

int mcrt_full(const void* fp, const void* ip, int n_paths,
              int retirement_years, int traj_len, int n_streams, void* vecs,
              void* traj, void* price, void* wr, void* stream) {
  if (n_paths < 1 || traj_len < 1 || retirement_years < 1 || n_streams != kNS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  full_kernel<<<(n_paths + kFullThreads - 1) / kFullThreads, kFullThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fp), static_cast<const int*>(ip), n_paths,
      retirement_years, traj_len, static_cast<float*>(vecs),
      static_cast<float*>(traj), static_cast<float*>(price),
      static_cast<float*>(wr));
  return static_cast<int>(cudaGetLastError());
}
#else
// elem_bytes: the caller's sizeof(Real), checked against this library's.
int mcrt_scan_rows(const void* fp, const void* ip, const void* keys,
                   int n_rows, int n_paths, int n_streams, int shared_params,
                   int rows_per_block, int months_per_chunk, int fields,
                   int smem_bytes, int elem_bytes, int acc_cap,
                   long long row_offset, void* success, void* final_bal,
                   void* counts, void* steps, void* stream) {
  if (elem_bytes != static_cast<int>(sizeof(Real)) || row_offset < 0 ||
      !tile_plan_ok(n_rows, n_paths, n_streams, rows_per_block,
                    months_per_chunk, fields,
                    shared_params ? kProbeFields : kGridFields, smem_bytes,
                    elem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier, unrelated error
  auto* kernel = shared_params ? &scan_rows_kernel<true> : &scan_rows_kernel<false>;
  if (const int err = set_smem(kernel, smem_bytes)) return err;
  const dim3 grid((n_paths + kWarp - 1) / kWarp,
                  (n_rows + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, rows_per_block * kWarp, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Real*>(fp), static_cast<const int*>(ip),
      static_cast<const uint32_t*>(keys), n_rows, n_paths, rows_per_block,
      months_per_chunk, acc_cap, row_offset, static_cast<Real*>(success),
      static_cast<Real*>(final_bal), static_cast<int*>(counts),
      static_cast<int*>(steps));
  return static_cast<int>(cudaGetLastError());
}

int mcrt_scan_full(const void* fp, const void* ip, const void* keys,
                   int n_paths, int retirement_years, int traj_len,
                   int n_streams, int elem_bytes, int acc_cap,
                   long long row_offset, void* vecs, void* traj, void* price,
                   void* wr, void* stream) {
  if (n_paths < 1 || traj_len < 1 || retirement_years < 1 ||
      n_streams != kNS || elem_bytes != static_cast<int>(sizeof(Real)) ||
      row_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  scan_full_kernel<<<(n_paths + kFullThreads - 1) / kFullThreads,
                     kFullThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Real*>(fp), static_cast<const int*>(ip),
      static_cast<const uint32_t*>(keys), n_paths, retirement_years, traj_len,
      acc_cap, row_offset, static_cast<Real*>(vecs), static_cast<Real*>(traj),
      static_cast<Real*>(price), static_cast<Real*>(wr));
  return static_cast<int>(cudaGetLastError());
}
#endif

const char* mcrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
