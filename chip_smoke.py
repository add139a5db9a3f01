#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card, phase by phase.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result):
  1. the card (nvidia-smi name and power limit), and the kernels built with
     nvcc from engine/csrc into build/torch_kernels/: one month-loop library
     per Statics the run uses (config.json's, each extension alone, all
     extensions together), one scan library per scan structure and dtype
     (float32, float64: config.json's, the all-on config's, jorge.json's and
     phase 15's batch groups), one JVP library per Statics, dtype and draw
     source that phases 8f, 10d, 15b and 16 launch (JVP_TK tangents a
     launch) and config.json's at 8 tangents (never launched: its ptxas
     lines record the choice of JVP_TK), the stream check and the op-count
     cubins of config.json's and the all-on Statics, of config.json's scan
     in both dtypes and of its JVP units at 8 tangents (both dtypes, both
     draw sources), one nvcc each, all started together; each
     library's registers and spills per kernel (ptxas), the dynamic shared
     memory of phase 6's tiled launches, and the SASS pipe loads of a draw
     and a month step (engine/bound.py) behind every bound;
  2. the device draws vs ops/shocks.py in torch on the card: the month,
     crash and longevity Philox words equal, the crash and longevity
     uniforms equal, the normals within 2e-6 relative; then the scan
     kernels' threefry (csrc/threefry.cuh) vs ops/threefry.py on the card
     for 1M random keys and flat indices up to 3 * 2**33: words and
     float32/float64 uniforms bit-equal, the normals' largest ulp gap;
  3. probe_kernel vs probe_plain on the card (config.json, 16 candidates
     over 0-480 months, 65,536 paths, one seed so one stream): per-candidate
     success within 0.3 points, per-path flags mismatching below 3e-3, and
     the kernel's survivor counts equal to its own flags;
  4. full_kernel vs simulate_full_plain at W=234, 65,536 paths, with the
     bounds the JAX suite holds Pallas to (tests/test_pallas_parity.py);
  5. the main path through RetirementMonteCarloSimulator(device="cuda"):
     search, final seeds, final run — at config.json's own sizes, at 1M
     search and 1M final paths, and at 1M/1M with every extension on (the
     all-on config below) — with the launch counters checked and the
     success at the found month >= target - 150/sqrt(n); after each run,
     the checks of phases 3 and 4 again at that run's shapes (16
     candidates around the found month at the search's path count, the
     full kernel at the found month at the final path count), so partial
     4096-path blocks and padding lanes are held to the plain versions;
  6. card times at 1M paths x 600 months (bench.py's scenario), CUDA
     events, warm, min of 5: one 16-candidate probe, the full kernel
     alone, and the full kernel plus summarize — kernel and plain version;
     simulate (the grid kernel's one-row launch) and simulate_plain there;
     the probe and the full kernel again under the all-on Statics beside
     their plain versions (one cold call each), and the probe with each
     extension alone (min of 2); the probe at the search's later ladder
     (W = 204-384), whose rows share their working years; one 16-row chunk
     of the 16 x 16
     scenario grid (config.json, expenses 4,000-14,000 x equity mean
     0.06-0.14, W=231, R=50, 1M paths): the grid kernel alone, its plain
     version, the chunk's statistics; and the wall time of the whole
     256-variant x 1M grid through run_scenario_grid. Each kernel's time
     beside its bound (engine/bound.py: the least time for this launch's
     work on this card), and the per-row survivor counts and float64
     final-balance sums of the slice and all-on probe and the grid chunk;
     the body steps each tiled launch ran against all it had (a warp stops
     once its paths are all ruined): none skipped in the slice, whose rows
     live, or it fails; beside it config.json's own household at W 0-15
     (a served search's first probe, ruined within ~30 months), timed;
  7. grid_kernel vs grid_plain on the card: that 16-row chunk at 1M paths,
     a ragged 3 rows x 1,000 paths and 11 rows whose W spread over 0-480
     at 65,536 paths (a block's rows end at different months; 11 rows is
     no multiple of a block's rows) — per-row success within
     max(0.3, 100/n) points, flags mismatching below 3e-3, the kernel's
     counts equal to its own flags, dust-aware final balances — and each
     row equal, flag for flag, to the probe kernel on that row's own block;
  8. the analysis modes at full width through the port's host functions
     on the card, launch counters reset before and read after each: the
     256-variant x 1M grid (16 grid launches, no plain call; success never
     rises with expenses in any equity-mean column), sensitivity of the 8
     default parameters at 1M paths and W=231 (d success < 0 for expenses,
     > 0 for the initial balance), a 1-D optimize of allocation_inv1_pct
     over 0.3-0.9 (17 points x 3 rounds: 51 evaluations, best inside its
     bracket), the all-on sensitivity at 1M paths and phase 5's all-on
     month over the crash frequency, the longevity mode age, the upper
     guardrail and the annual tax rate (d success < 0 for the first two
     and the tax rate); then bench.py's workload through simulate (one
     launch, held to simulate_plain and to the probe kernel's flags at W=0);
     then the AD cross-check (sensitivity_ad on jvp_kernel: launched, no
     plain AD pass) at 1,048,576 paths, config.json, W=231, the 8 default
     parameters, twice (the process's first AD call, after importing
     torch._dynamo, which torch's forward AD loads on first use, timed
     apart; then a warm call): every gradient finite, d/d expenses < 0 and
     d/d equity mean > 0, both within 5% of a CRN central difference of the
     mean final balance on the grid kernel; both walls and the kernel's
     time alone;
  9. the extensions on the card, each alone and all together (config.json
     plus EXTENSIONS below, R = 20): probe_kernel, grid_kernel (3 ragged
     rows) and full_kernel against their plain versions at 65,536 paths with the
     bounds of phases 3, 4 and 7 (with guardrails, fewer than 1e-3 of the
     withdrawal-rate entries may differ: a path at a band edge takes the
     other branch in one version); rule-off bit-identity (the parameters of
     every disabled feature poisoned: probe and full kernel outputs
     bit-equal); antithetic pairing (the even blocks of an antithetic
     probe bit-equal to an iid probe's blocks, the odd ones not);
 10. the port's HTTP server (hosts/server.py, create_app(device="cuda"))
     in this process behind aiohttp's TestServer on 127.0.0.1, launch
     counters reset before each step, no plain call allowed: (a) POST
     /api/simulate with phase 5b's config (1M search + 1M final paths, so
     the response is capped and the final run reduced on the card): the
     search month and the successful paths equal 5b's, and every integer
     field equals, every float agrees within PAYLOAD_RTOL x |value| +
     PAYLOAD_ATOL with, the pandas payload of the same run (raw vectors to
     the host, binned there); (b) the same on /api/simulate/stream: events
     phase(search), search_iter..., search_complete, phase(final_sim),
     result equal to (a)'s; (c) four seeds at once, each answer equal to
     the same request alone, the concurrent launch counts exact; (d)
     /api/grid (16 variants x 1M), /api/sensitivity and /api/optimize
     (65,536 paths) valid and on the grid kernel, /api/sensitivity with
     include_ad (ad_num_paths 65,536) 200 with an AD slope on every row,
     its FD rows on the grid kernel and its AD on jvp_kernel; (e) times: warm
     /api/simulate wall (min and median of 5) split into search, final
     run, payload assembly and JSON encoding, the response's bytes, the
     same with include_raw_paths, and the first request of a fresh server
     process with an empty kernel build directory, without and with its
     warmup;
 11. the chunked full-statistics run (Engine.run above
     MCRT_MAX_DEVICE_PATHS): first the card memory per path of an
     unchunked run at phase 5b's month and at the longest horizon (4M
     paths, torch.cuda.max_memory_allocated) and the default budget
     against it (four concurrent runs at the budget fit the card); (a)
     phase 5b's config and month at 4,195,304 paths, unchunked and in 5
     chunks of 1,048,576, raw and reduced: every RunResult and HostBins
     field equal (values; NaN equal); (b) the same under ALL_ON at phase
     5c's month, 1,001,000 paths in 4 chunks of 63 blocks (an odd count:
     antithetic pairs straddle the chunk boundaries); (c) 48 x 2**20 paths
     at the default budget, raw (more than an unchunked run fits on the
     card): its first 1,048,576 entries of every per-path vector bit-equal
     to a 1M unchunked run's, success within 4 sigma of it, peak memory
     beside the card's, wall time split into simulation and count passes.
     Each chunked run: chunks, band passes and full-kernel launches.
 12. the paths mesh, four shards on cuda:0 (make_mesh(["cuda:0"] * 4)),
     counters reset before each counted call, no plain call allowed: (a)
     probe_sharded (16 x 2**20 x 600 and at 1M, where it counts the
     padding: equal to a single probe at 4 x local_pad), simulate_sharded,
     simulate_full_sharded, grid_sharded and grid_raw_sharded (phase 6's
     chunk) each equal to the single launch, their times beside it, one
     trace_to trace; (b) Engine(mesh) on phase 5b's request (its month and
     successful paths; the runs equal to the mesh-less engine's), 11a's
     4,195,304 paths at 2**20 per shard in 2 mesh chunks equal to the
     unchunked run, run_scenario_grid(mesh) equal to the mesh-less chunk;
     (c) two gloo processes of hosts/dist_worker.py (two shards each) and a
     one-rank NCCL group (four shards), all on cuda:0, every answer equal
     to (b)'s and each shard's final balances to the single-device run's;
     (d) run_scenario_batch over three Statics in 3 grid launches, each row
     equal to the row alone. Walls through utils.profiling.device_timer.
 13. the tools of hosts/ on the card: the month-loop libraries of the
     edge sweep's and the campaign's Statics built together (count and
     wall); (a) hosts/edge_sweep.py: each of its 14 edge scenarios through
     Engine (probe [0, 7, 24] and run(7) at 4096 paths, counted: finite
     and in range), then its probe, grid and full kernels against their
     float64 plain versions at its month (hosts/fuzz.check_kernels:
     gate (b) per run, paths beyond the $1e9 conditioning bound skipped
     and counted; the $1e12 balance against the float32 plain versions);
     (b) hosts/fuzz.py's campaign, 48 random scenarios at seed 0, each
     kernel against its float64 plain version at 4096 paths: clean, every
     extension in at least 3 trials, the worst flag mismatch and q999
     final-balance error per kernel and the paths skipped; (c)
     hosts/bench.py in its own process: its JSON line's keys, its
     simulate time within 10% of phase 6's, its success rate in [0, 100];
     (d) hosts/scenario_grid_demo.py at seed 2026 and 1M paths: its
     success grid equal to phase 6's run_scenario_grid bit for bit and to
     phase 8a's payload at its two decimals; hosts/correlation_sweep.py:
     its 9 rows in one grid launch, each equal to the row alone; (e) the
     README's library snippet on the card. Launches of (a), (d) and (e)
     are counted; the campaign's and the checks' are comparisons.
 14. the scan engine on the card (engine/kernel.simulate_paths: the JAX
     scan's threefry stream, ops/threefry.py, run by the scan kernels,
     scan_rows_kernel and scan_full_kernel of month_loop.cu): (a) threefry
     words and float32/float64 uniforms of (1,000,003, 3) draws bit-equal
     card vs CPU, for main seeds 0, 7, 2026 and 2**40 + 3 at months 1, 600,
     JUMP_FOLD_OFFSET + 5 and MORT_FOLD_OFFSET; the normals' largest
     difference card vs CPU; (b) both scan kernels vs their plain chain of
     torch ops on the card (config.json from global row 0; the all-on
     config, antithetic, from the odd global row 4,097; R = 10; rows at W
     138-174, the tracked run at W = 150): float64 at 4,113 paths, flags
     equal and final balances and every tracked field within relative
     1e-12 (paths beyond $1e9 skipped and counted), float32 at 2**20 paths
     by gate (b) (hosts/fuzz.compare_rows / compare_full); (c) the main
     path through Engine(dtype=float64, device="cuda"), which picks the
     scan: at config.json's own sizes equal to the JAX engine's CPU answer,
     then at 1M search + 1M final paths (month, success, both walls), scan
     kernel launched and no plain chain; the scan kernels' times at phase
     6's shapes (16 x 1M x 600 and 1M x 600), float32 and float64, beside
     their bounds and one call of the plain chain; (d)
     hosts/cross_backend_check.py: its three cases within max(3 sigma, 0.5)
     points, one scan launch each; (e) hosts/scaling_demo.py's lines.
 15. the scan routes of the analyses (JAX's own routes): (a)
     run_scenario_batch(backend="scan") over six rows that share
     retirement_years and one pension stream (config.json; inv1 on the
     annual mark-to-market system at 0.25; the pension fixed-nominal; the
     pension capped; + crashes; + longevity), at W spread around the
     working month: float64 at 4,113 paths, R = 10, the card's scan kernel
     against the CPU's plain chain (every row's survivors equal, every
     statistic within 1e-12 relative), then float32 at 1,048,576 paths,
     R = 50: each row within max(3 sigma, 0.5) points of the same row on
     the grid-kernel route (one launch per Statics), both walls, one scan
     launch per group and no plain chain; (b)
     sensitivity_ad(backend="scan") of the 8 default parameters on
     jvp_kernel (launched, no plain AD pass): float64 at 4,113 paths on the
     card against the CPU's plain version (the value and every gradient
     within 1e-10 relative), then float32 at 1,048,576 paths, config.json,
     W=231: every gradient finite, d/d expenses < 0 < d/d equity mean, both
     within 5% of the central difference of sensitivity_fd(backend="scan")
     (the scan kernel) at the same paths; its wall beside phase 8f's and
     the kernel's time alone.
 16. jvp_kernel (the JVP of one row's month loop, sensitivity_ad's kernel)
     against its plain version (torch.func.jvp of the chain) on the card:
     (a) float64 at 4,113 paths, R = 10, W = 150, on the grid kernel's
     Philox draws and on the scan's threefry draws from the odd global row
     4,097, under config.json's and the all-on Statics (8 directions, two
     launches each): success flags equal, per-path finals and tangents
     within 1e-10 of each direction's largest; (b) the same where real
     paths meet the chain's tie rules (ruined paths at exactly 0, a pension
     paying the expenses exactly, a guardrail cut onto its floor or raised
     onto its cap), along two parameters and the guardrails' adjustment,
     floor and cap slots (5 directions: the last launch zero-padded); (c)
     float32 at 2**16 paths at phase 8f's scenario on both draw sources,
     gate (b): flags mismatching below 3e-3, the mean final and every
     gradient within 5e-3 relative; (d) its times at phase 8f's shape,
     float32 and float64 on both draw sources (CUDA events, min of 3),
     beside their bounds (engine/bound.py: the draws and the primal once,
     each of the 8 directions once, from op-count units of 8 tangents),
     and in float32 one call of the plain version at that shape per draw
     source, timed, the kernel held to it by (c)'s gate.

The kernels' line comes before the last two: {"kernels": [...]}, one row
per kernel with its launches on the main path (phase 5), the grid path
(phase 8), the server's routes (phase 10a-d), the chunked runs (phase
11), the paths mesh (phase 12) and the tools (phase 13a, d, e), its
time, bound and plain version's time, the scan kernels' row with
their launches on the float64 main path (14c) and the scan's other
routes (14d, 14e, 15a, 15b), and jvp_kernel's row with its launches on
the AD routes (8f, 10d, 15b) and its times (16d); then the card's
name and power limit on their own line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "monte_carlo_retirement_tpu_torch"
CU_SOURCE = f"{PKG}/engine/csrc/month_loop.cu"
SEED = 2026
N_CHECK = 65_536
# Phase 9's retirement length: the plain versions on the card are
# launch-bound, one month at a time, so 20 years (every rule still binds;
# the all-on config runs 50 years at 1M paths in phase 5) keeps the phase
# short.
EXT_R = 20
N_FULL = 1_000_000
GRID_W = 231
GRID_SIDE = 16  # the 16 x 16 grid of scripts/scenario_grid_demo.py
GRID_CHUNK_ROW = 10  # the chunk of the grid checked and timed (expenses ~10.7k)
NORMAL_RTOL = 2e-6
SERVER_REPEATS = 5  # warm /api/simulate requests timed in phase 10e
# Phase 10a's float fields: the card interpolates percentiles and means in
# float32, pandas in float64 (relative), and the wire rounds to cents.
PAYLOAD_RTOL = 2e-6
PAYLOAD_ATOL = 0.01
CRASHES = {"frequency_per_year": 0.2, "mean_drop_pct": 25.0,
           "size_volatility": 0.1, "inv2_beta": 0.3}
LONGEVITY = {"mode_age": 88.0, "dispersion_years": 10.0, "max_age": 110.0}
GUARDRAILS = {"upper_wr_pct": 6.0, "lower_wr_pct": 3.0}
# config.json plus one extension each (config.json's rental stream, given a
# rent: fixed-nominal, capped at 35 years, or both), and all together.
EXTENSIONS = {
    "bills": dict(inv1_use_realized_gains_tax_system=False,
                  inv1_annual_tax_on_gains_rate=0.15),
    "fixed": dict(rental=dict(inflation_indexed=False, duration_years=None)),
    "capped": dict(rental=dict(inflation_indexed=True, duration_years=35)),
    "antithetic": dict(antithetic=True),
    "glide": dict(allocation_inv1_final_pct=0.4),
    "guardrails": dict(spending_guardrails=GUARDRAILS),
    "jumps": dict(market_crashes=CRASHES),
    "mortality": dict(longevity=LONGEVITY),
    # six streams of all four kinds, beyond the first slice's cap of four
    "streams": dict(rental=dict(inflation_indexed=False, duration_years=35),
                    more_streams=[
                        {"name": "Annuity", "monthly_amount_today": 800.0,
                         "start_at_age": 60.0, "duration_years": None,
                         "inflation_indexed": False, "tax_rate": 0.15},
                        {"name": "Consulting", "monthly_amount_today": 2000.0,
                         "start_at_age": 58.0, "duration_years": 5,
                         "inflation_indexed": True, "tax_rate": 0.3},
                        {"name": "Royalties", "monthly_amount_today": 300.0,
                         "start_at_age": 50.0, "duration_years": None,
                         "inflation_indexed": True, "tax_rate": 0.2},
                        {"name": "Loan repaid", "monthly_amount_today": 500.0,
                         "start_at_age": 55.0, "duration_years": 10,
                         "inflation_indexed": False, "tax_rate": 0.0}]),
}
ALL_ON = dict(
    inv1_use_realized_gains_tax_system=False, inv1_annual_tax_on_gains_rate=0.15,
    rental=dict(inflation_indexed=False, duration_years=35),
    antithetic=True, allocation_inv1_final_pct=0.4,
    spending_guardrails=GUARDRAILS, market_crashes=CRASHES, longevity=LONGEVITY,
)
AD_PATHS = 2**20  # /api/sensitivity's largest ad_num_paths
N_FULL_15 = 2**20  # phase 15a's float32 batch
N_11A = 4 * 2**20 + 1_000  # the last chunk of 2**20 holds a partial block
N_11B = N_FULL + 1_000
BLOCKS_11B = 63  # 4 chunks of an odd number of 4096-path blocks
N_11C = 48 * 2**20
UNCHUNKED = 10**12  # a budget no run here reaches
ALL_ON_SENSITIVITY = ("market_crashes.frequency_per_year", "longevity.mode_age",
                      "spending_guardrails.upper_wr_pct",
                      "inv1_annual_tax_on_gains_rate")
MESH_SHARDS = 4  # phase 12's mesh: four shards on cuda:0
N_12A = 2**20  # bench.py's paths
# Phase 12's chunked runs (b, c): two mesh-sized chunks of 4 x 2**16.
N_12_CHUNKED = 2 * MESH_SHARDS * 2**16
BUDGET_12_CHUNKED = 2**16
CHILD_TIMEOUT_S = 300  # each process of phase 12c
FUZZ_SEED = 0  # phase 13b's campaign
FUZZ_TRIALS = 48
FUZZ_MIN_EACH = 3  # trials per extension the campaign must reach
BENCH_SIM_RTOL = 0.10  # hosts/bench.py's simulate time vs phase 6's
BENCH_KEYS = {"metric", "value", "unit", "success_rate_pct", "full_stats_ms",
              "card_name", "power_limit"}
# Phase 14: the scan engine (threefry, plain torch) on the card.
KEYS_14A = (0, 7, 2026, 2**40 + 3)  # main seeds of the threefry checks
SHAPE_14A = (1_000_003, 3)  # an odd row count: the counters' last pair
N_14B = 4096 + 17
R_14B = 10
W_14B = 150  # a partial working year: the terminal settle runs
PARITY_14B = 1e-12  # card vs CPU, float64 final balances (relative)
BIG_14B = 1e9  # the conditioning bound of ROADMAP C
# The JAX engine's answer on the CPU in float64 (its scan backend) for
# config.json at its own sizes and seed 2026: months, search %, final %
# (tests/test_torch_scan_search.py holds the port's CPU scan to it).
JAX_CPU_ANSWER = (234, 97.667, 98.1)
MONTHS_14C = 6  # the scan's month at 1M paths vs the kernels' (phase 5b)
# Phase 14b: the scan kernels against their plain chain on the card.
ROWS_14B = (138, 150, 162, 174)  # scan_rows' rows; scan_full runs W_14B
OFFSET_14B = 4097  # the all-on runs' shard: an odd first global row
N_14B_F32 = 2**20
# 14c's float64 check of scan_rows_kernel at the main path's block (16 rows
# per block, the double tile): fewer paths than the main path's 1M keep the
# plain chain's one float64 call short; the block is the same.
N_14C_F64 = 2**18
SCAN_REPLACES = "monte_carlo_retirement_tpu/engine/kernel.py:124"
# Phase 2: the scan kernels' threefry draws vs ops/threefry on the card.
ULPS_2 = 64  # normals: log1p and sqrt on either side (measured in the log)
# Phase 15: the scan routes of run_scenario_batch and sensitivity_ad. Six
# rows with config.json's one pension stream (the rent pruned); "pension"
# updates that stream.
ROWS_15 = (
    ("config.json", {}),
    ("inv1 annual 0.25", dict(inv1_use_realized_gains_tax_system=False,
                              inv1_annual_tax_on_gains_rate=0.25)),
    ("fixed-nominal pension", dict(pension=dict(inflation_indexed=False))),
    ("capped pension", dict(pension=dict(duration_years=3))),
    ("+ crashes", dict(market_crashes=CRASHES)),
    ("+ longevity", dict(longevity=LONGEVITY)),
)
OFFSETS_15 = (0, -6, 6, 0, -12, 12)  # each row's W around the phase's month
# R = 10 from age 59 at W = 228: the pension starts at 65 and its capped
# form ends at 68, inside the horizon; expenses at which rows fail and
# succeed (success 0.4-92% over the rows on the CPU).
W_15_PARITY = 228
EXPENSES_15_PARITY = 20_000.0
PARITY_15A = 1e-12  # card vs CPU, float64 batch statistics (relative)
PARITY_15B = 1e-10  # card vs CPU, float64 AD value and gradients
# Phase 16: jvp_kernel against its plain version (torch.func.jvp of the
# chain) on the card. float64 per-path finals and tangents within
# PARITY_15B of each direction's largest |tangent|; float32 gate (b): flags
# mismatching below FLAGS_16 and the mean final and each gradient within
# MEANS_16 relative.
FLAGS_16 = 3e-3
MEANS_16 = 5e-3
N_16_F32 = 2**16
JVP_REPLACES = "monte_carlo_retirement_tpu/engine/sensitivity.py:476"
# Where real paths meet the chain's tie rules (tests/test_torch_jvp_kernel.py
# (c)): config.json's rates and taxes, 15% equity volatility, W = 12 (the
# ruin case W = 0), and per case (R, overrides).
TIE_BASE = dict(inv1_returns_volatility=0.15, monthly_contribution=0.0)
TIES_16 = {
    "ruined paths (final exactly 0)": (6, dict(
        initial_balance=100_000.0, monthly_expenses=1_500.0)),
    "pension pays the expenses (need exactly 0)": (4, dict(
        initial_balance=200_000.0, monthly_expenses=3_000.0,
        other_income_streams=[dict(
            name="pension", monthly_amount_today=3_000.0, start_at_age=40.0,
            duration_years=None, inflation_indexed=True, tax_rate=0.0)])),
    "guardrail cut onto its floor": (2, dict(spending_guardrails=dict(
        upper_wr_pct=0.5, lower_wr_pct=0.0, adjustment_pct=10.0,
        floor_pct=90.0))),
    "guardrail raise onto its cap": (2, dict(spending_guardrails=dict(
        upper_wr_pct=100.0, lower_wr_pct=99.0, adjustment_pct=10.0,
        cap_pct=110.0))),
}
TIE_PARAMS = ["monthly_expenses", "initial_balance"]


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _raw_config(**overrides):
    """config.json (seed 2026) with ``overrides``; ``rental`` gives the
    rental stream a rent of 1,500/month and the stream fields it holds,
    ``more_streams`` appends streams."""
    with open(os.path.join(REPO, "config.json"), encoding="utf-8") as fh:
        raw = json.load(fh)
    raw["seed"] = SEED
    rental = overrides.pop("rental", None)
    if rental is not None:
        raw["other_income_streams"][1].update(monthly_amount_today=1500.0,
                                              **rental)
    raw["other_income_streams"] += overrides.pop("more_streams", [])
    raw.update(overrides)
    return raw


def _config(**overrides):
    from monte_carlo_retirement_tpu_torch.config import Config

    return Config(**_raw_config(**overrides))


def _run_statics():
    """Every Statics this run launches: config.json's, each extension
    alone, all together."""
    from monte_carlo_retirement_tpu_torch.engine.cuda_kernel import (
        statics_from_config,
    )

    configs = [_config()] + [_config(**dict(over)) for over in EXTENSIONS.values()]
    configs.append(_config(**dict(ALL_ON)))
    return list(dict.fromkeys(statics_from_config(c) for c in configs))


def _scan_flags(cfg) -> dict:
    return dict(antithetic=bool(cfg.antithetic),
                jumps=cfg.market_crashes is not None,
                mortality=cfg.longevity is not None)


def _scan_statics(cfg):
    """The structure the scan runs a config under (engine/kernel.py
    scan_statics of its parameters)."""
    from monte_carlo_retirement_tpu_torch.engine.kernel import scan_statics
    from monte_carlo_retirement_tpu_torch.models.retirement import SimParams

    return scan_statics(SimParams.from_config(cfg), **_scan_flags(cfg))


def _scan_units():
    """Every scan library this run launches: the scan structure of
    config.json, the all-on config, jorge.json (hosts/cross_backend_check)
    and each group of phase 15's batch, in float32 and float64."""
    from monte_carlo_retirement_tpu_torch.config import (
        Config,
        load_config_from_json,
    )
    from monte_carlo_retirement_tpu_torch.engine import _build
    from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (
        scan_batch_statics,
    )

    jorge = Config(**load_config_from_json(os.path.join(REPO, "jorge.json")))
    statics = [_scan_statics(c) for c in (_config(), _config(**dict(ALL_ON)),
                                          jorge)]
    statics += scan_batch_statics([_row_15(over) for _, over in ROWS_15])
    return [_build.Unit(st, real, "threefry")
            for st in dict.fromkeys(statics) for real in ("float", "double")]


def _jvp_cases():
    """(label, config, W, R, parameters) of every JVP launch phases 8f,
    10d, 15b and 16 make, for their libraries."""
    from monte_carlo_retirement_tpu_torch.engine.sensitivity import DEFAULT_PARAMS

    names = list(DEFAULT_PARAMS)
    cases = [("config.json", _config(), GRID_W, names),
             ("15b", _config(retirement_years=R_14B,
                             monthly_expenses=EXPENSES_15_PARITY),
              W_15_PARITY, names),
             ("all-on", _config(retirement_years=R_14B, **dict(ALL_ON)),
              W_14B, names)]
    for label, (R, over) in TIES_16.items():
        cases.append((label, _config(retirement_years=R, **TIE_BASE, **over),
                      0 if label.startswith("ruined") else 12, TIE_PARAMS))
    return cases


def _jvp_unit(cfg, names, real, draws, tk=None):
    """The JVP library sensitivity_ad launches for ``cfg`` on ``draws``
    (its op-count unit at ``tk`` tangents)."""
    from monte_carlo_retirement_tpu_torch.engine import _build
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.sensitivity import (
        _scan_statics_ad,
    )

    st = (_scan_statics_ad(cfg, names, "cpu") if draws == "threefry"
          else ck.statics_from_config(cfg))
    return _build.Unit(st, real, draws, tk or ck.JVP_TK)


def _jvp_units():
    return list(dict.fromkeys(
        _jvp_unit(cfg, names, real, draws) for _, cfg, _, names in _jvp_cases()
        for real in ("float", "double") for draws in ("philox", "threefry")))


def _jvp_wide_units():
    """config.json's JVP libraries at one tangent per direction: never
    launched, built for phase 1's ptxas lines beside JVP_TK's, the record
    of that choice (registers, spills)."""
    names = _jvp_cases()[0][3]
    return [_jvp_unit(_config(), names, real, draws, tk=len(names))
            for real in ("float", "double") for draws in ("philox", "threefry")]


def _counted_units():
    """{label: the library or unit whose op-count cubin prices a bound}.
    The JVP units carry as many tangents as 8f's directions, so one pass
    prices what sensitivity_ad needs: the draws and the primal once, each
    direction's tangents once (the kernel's launches of JVP_TK directions
    each redo the draws and the primal: its cost, not the function's work)."""
    from monte_carlo_retirement_tpu_torch.engine import _build
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck

    scan_slice = _scan_statics(_config())
    counted = {"slice": ck.statics_from_config(_config()),
               "all-on": ck.statics_from_config(_config(**dict(ALL_ON))),
               "scan f32": _build.Unit(scan_slice, "float", "threefry"),
               "scan f64": _build.Unit(scan_slice, "double", "threefry")}
    names = _jvp_cases()[0][3]
    for real, tag in (("float", "f32"), ("double", "f64")):
        for draws in ("philox", "threefry"):
            counted[f"jvp {draws} {tag}"] = _jvp_unit(_config(), names, real,
                                                      draws, tk=len(names))
    return counted


def _grid_raw():
    with open(os.path.join(REPO, "config.json"), encoding="utf-8") as fh:
        raw = json.load(fh)
    raw["seed"] = SEED
    return raw


def _grid_overrides():
    """The 256 variants, expenses-major: row i * 16 + j has expenses[i] and
    equity mean[j]."""
    import numpy as np

    expenses = np.linspace(4_000, 14_000, GRID_SIDE)
    eq_means = np.linspace(0.06, 0.14, GRID_SIDE)
    return [{"monthly_expenses": float(e), "inv1_returns_mean": float(m)}
            for e in expenses for m in eq_means]


def _grid_chunk_configs():
    from monte_carlo_retirement_tpu_torch.config import Config

    raw = _grid_raw()
    start = GRID_CHUNK_ROW * GRID_SIDE
    return [Config(**{**raw, **over})
            for over in _grid_overrides()[start:start + GRID_SIDE]]


def _time_ms(fn, repeats=5, warm=True):
    """Warm once (unless ``warm`` is False), then the min over ``repeats``
    CUDA-event-timed calls."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _once_ms(fn):
    """(fn()'s result, its CUDA-event ms): one call, not warmed."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _ptxas_summary(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from a
    build log of nvcc -Xptxas -v."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in ("probe_kernel", "accum_kernel", "grid_kernel",
                                     "scan_full_kernel", "full_kernel",
                                     "normals_kernel", "threefry_kernel",
                                     "scan_rows_kernel", "jvp_kernel")
                         if k in m.group(1)), m.group(1))
            if name == "scan_rows_kernel":  # one instance per parameter form
                name += "<shared>" if "ILb1E" in m.group(1) else "<per-row>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def _statics_label(st) -> str:
    st = getattr(st, "statics", st)  # a scan library's Unit
    on = [f for f in ("antithetic", "glide", "guardrails", "jumps", "mortality")
          if getattr(st, f)]
    on += ["bill1"] * st.bill1 + ["bill2"] * st.bill2
    kinds = "".join("i" if i else "f" for i in st.stream_indexed)
    caps = "".join("c" if c else "-" for c in st.stream_capped)
    return (f"real=({int(st.use_real1)},{int(st.use_real2)}) streams={kinds or '-'}"
            f"/{caps or '-'} {'+'.join(on) or 'no extensions'}")


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _bound(report, kind, work, out_bytes, label="slice"):
    """(bound ms, bound_by) of one launch from this run's SASS loads."""
    from monte_carlo_retirement_tpu_torch.engine import bound

    return bound.bound_ms(kind, work, report["parts"][label], out_bytes,
                          report["sm_count"], report["clock_hz"])


def phase_build(report):
    import torch
    from monte_carlo_retirement_tpu_torch.engine import _build, bound
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck

    report["card"] = _card_line()
    print(f"[1] card: {report['card']} | torch: {torch.cuda.get_device_name(0)}"
          f" | torch {torch.__version__} cuda {torch.version.cuda}")
    statics = _run_statics() + _scan_units() + _jvp_units() + _jvp_wide_units()
    counted = _counted_units()
    t0 = time.perf_counter()
    paths, built = _build.build_many(statics + [None], list(counted.values()))
    for st in statics:
        _build.load(st)
    _build.load()
    took = time.perf_counter() - t0
    print(f"[1] {built} of {len(paths)} libraries and op-count cubins built from "
          f"{os.path.dirname(CU_SOURCE)} (one nvcc each, started together) into "
          f"{os.path.relpath(os.path.dirname(paths[0]), REPO)} in {took:.1f} s")
    report["ptxas"] = {}
    for st, so in zip(statics + [None], paths):
        label = "stream check" if st is None else _statics_label(st)
        if isinstance(st, _build.Unit) and st.tk:
            label += f" | jvp, {st.draws}, {st.real}, TK {st.tk}"
            if st.tk != ck.JVP_TK:
                label += f" (never launched: beside JVP_TK = {ck.JVP_TK})"
        elif isinstance(st, _build.Unit):
            label += f" | scan, {st.real}"
        summary = _ptxas_summary(_build.build_log(st))
        report["ptxas"][label] = summary
        print(f"[1] {os.path.basename(so)}: {label}: " + ", ".join(
            f"{k} {r} regs, spills {a}/{b} B" for k, (r, a, b) in summary.items()))
    st = counted["slice"]
    print("[1] dynamic shared memory of phase 6's tiled launches: " + ", ".join(
        f"{what} {plan.rows_per_block} rows x {ck.WARP} paths x "
        f"{plan.months_per_chunk} months, {plan.threads} threads, "
        f"{plan.smem_bytes} B" for what, plan in (
            ("probe", ck.tile_plan(16, N_FULL, st, "probe")),
            ("grid chunk", ck.tile_plan(GRID_SIDE, N_FULL, st, "grid")),
            ("simulate", ck.tile_plan(1, N_FULL, st, "grid")))))
    report["sm_count"] = torch.cuda.get_device_properties(0).multi_processor_count
    report["clock_hz"] = _max_sm_clock_hz()
    report["parts"] = {}
    for label, st in counted.items():
        sass = _build.count_sass(st)
        pipes = bound.sass_pipes(sass)
        unit = st if isinstance(st, _build.Unit) else _build.Unit(st)
        scan = unit.draws == "threefry"
        normals = 3 + int(unit.statics.jumps) if scan else 0
        if unit.tk:
            parts = bound.jvp_part_loads(sass, normals, unit.real)
            names = bound.JVP_PARTS
        else:
            parts = bound.part_loads(sass, normals, unit.real)
            names = bound.PARTS
        report["parts"][label] = parts
        tangents = f", {unit.tk} tangents" if unit.tk else ""
        print(f"[1] SASS of one step ({label}{tangents}; main body, by "
              f"pipe): " + "; ".join(f"{name[6:]} {pipes[name]}"
                                     for name in names))
        if scan:
            shares = bound.band_shares(unit.real)
            print(f"[1]   {label}: the draw runs erfinv band 0 for each of its "
                  f"{normals} normals; one normal through each band (SASS, by "
                  f"pipe), at its share of the normals: " + "; ".join(
                      f"band {b} {pipes[name]} x {share:.6g}" for b, (name, share)
                      in enumerate(zip(bound.BANDS, shares))))
        print(f"[1]   SM-cycles per thread (busiest pipe or issue; yearly code "
              f"/12): " + ", ".join(f"{k} {max(v.values()):.4f}"
                                     for k, v in parts.items()))
    print(f"[1] bound rates: {report['sm_count']} SMs at "
          f"{report['clock_hz'] / 1e6:.0f} MHz (nvidia-smi clocks.max.sm), "
          f"{bound.MEMORY_BYTES_PER_S / 1e12:.2f} TB/s")


def phase_normals(report):
    import torch
    from monte_carlo_retirement_tpu_torch.engine.cuda_kernel import device_draws
    from monte_carlo_retirement_tpu_torch.ops import shocks

    g = torch.Generator(device="cuda").manual_seed(SEED)
    n = 1 << 20
    dev = torch.device("cuda")
    seed = torch.randint(0, 2**31, (n,), generator=g, device=dev)
    block = torch.randint(0, 2**32, (n,), generator=g, device=dev)
    month = torch.randint(1, 1441, (n,), generator=g, device=dev)
    lane = torch.randint(0, 4096, (n,), generator=g, device=dev)
    edges = torch.tensor(
        [[0, 0, 1, 0], [2**31 - 1, 2**32 - 1, 1440, 4095], [SEED, 3, 600, 17]],
        device=dev,
    ).t()
    seed, block, month, lane = (
        torch.cat([a, e]) for a, e in zip((seed, block, month, lane), edges)
    )
    words_d, vals_d = device_draws(seed, block, month, lane)
    main = shocks.philox4x32_10(month, lane, 0, 0, seed, block)
    crash = shocks.philox4x32_10(month, lane, shocks.CRASH_COUNTER, 0, seed,
                                 block)[0]
    mort = shocks.philox4x32_10(0, lane, shocks.MORT_COUNTER, 0,
                                seed ^ shocks.MORT_SALT, block)[0]
    words_t = torch.stack(list(main) + [crash, mort])
    normals_t = torch.stack([shocks.bits_to_normal(w) for w in
                             (main[0], main[1], main[2], crash)])
    uniforms_t = torch.stack([shocks.bits_to_uniform(w) for w in (main[3], mort)])
    torch.cuda.synchronize()
    if not torch.equal(words_d, words_t):
        bad = int((words_d != words_t).sum())
        raise AssertionError(f"device Philox words differ from torch in {bad} places")
    if not torch.equal(vals_d[[3, 5]], uniforms_t):
        raise AssertionError("device crash/longevity uniforms differ from torch")
    z_d = vals_d[[0, 1, 2, 4]]
    rel = ((z_d - normals_t).abs() / normals_t.abs().clamp_min(1e-30)).max().item()
    exact = float((z_d == normals_t).float().mean())
    print(f"[2] Philox words equal on {words_d.numel():,} words (month draw, "
          f"crash normal, longevity); crash and longevity uniforms bit-equal; "
          f"normals max rel err {rel:.3e} (bound {NORMAL_RTOL:g}), bit-equal "
          f"share {exact:.6f}")
    if not rel <= NORMAL_RTOL:
        raise AssertionError(f"normals differ by {rel:.3e} relative")
    report["normals_max_rel"] = rel

    # The scan kernels' draws (csrc/threefry.cuh) vs ops/threefry on the card:
    # random keys and flat indices below 3 * 2**33 (the counter's high word
    # in use), plus the edges of the 32-bit counter.
    import numpy as np
    from monte_carlo_retirement_tpu_torch.engine.cuda_kernel import (
        device_threefry,
    )
    from monte_carlo_retirement_tpu_torch.ops import threefry

    k0 = torch.randint(0, 2**32, (n,), generator=g, device=dev)
    k1 = torch.randint(0, 2**32, (n,), generator=g, device=dev)
    idx = torch.randint(0, 3 * 2**33, (n,), generator=g, device=dev)
    idx[:4] = torch.tensor([0, 2**32 - 1, 2**32, 3 * (2**31 + 11)], device=dev)
    hi, lo = idx >> 32, idx & 0xFFFFFFFF
    words_d, f32_d, f64_d = device_threefry(k0, k1, hi, lo)
    y0, y1 = threefry.threefry2x32((k0, k1), hi, lo)
    torch.cuda.synchronize()
    if not torch.equal(words_d, torch.stack([y0, y1])):
        raise AssertionError("[2] device threefry words differ from ops/threefry")
    ulps = {}
    for dt, vals in ((torch.float32, f32_d), (torch.float64, f64_d)):
        u = threefry.uniform_from_words(y0, y1, dt)
        if not torch.equal(vals[0], u):
            raise AssertionError(f"[2] device threefry uniforms differ ({dt})")
        z = threefry.normal_from_words(y0, y1, dt).cpu().numpy()
        zd = vals[1].cpu().numpy()
        if not np.isfinite(zd).all():
            raise AssertionError(f"[2] device threefry normals not finite ({dt})")
        ulps[str(dt)] = (float(np.max(np.abs(zd - z) / np.spacing(np.abs(z)))),
                         float(np.mean(zd == z)))
    print(f"[2] threefry (the scan kernels' draws): words (y0, y1) equal on "
          f"{2 * n:,} words (random keys, flat indices up to 3 * 2**33); "
          f"float32 and float64 uniforms bit-equal; normals vs ops/threefry on "
          f"the card (largest ulp gap, bit-equal share): " + ", ".join(
              f"{k} {v[0]:.0f} / {v[1]:.6f}" for k, v in ulps.items()))
    if not all(v[0] <= ULPS_2 for v in ulps.values()):
        raise AssertionError(f"[2] threefry normals beyond {ULPS_2} ulps: {ulps}")
    report["threefry_normal_ulps"] = ulps


def _gate(stats) -> str:
    """Gate (b)'s stats (``hosts/fuzz.compare_rows`` or ``compare_full``)
    on one line."""
    def shown(v):
        if isinstance(v, dict):
            return "{" + ", ".join(f"{k} {shown(x)}" for k, x in v.items()) + "}"
        return f"{v:.2e}" if isinstance(v, float) else str(v)

    return ", ".join(f"{k} {shown(v)}" for k, v in stats.items())


def _compare_rows(tag, what, out_k, out_p, n, label):
    """A probe or grid kernel's (K, n) outputs vs its plain version's on the
    same block, by gate (b) on every path (``fuzz.compare_rows``: counts =
    the kernel's own flags, i.e. the ballot and atomic saw exactly the n
    real paths); returns the largest |success % difference|."""
    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.hosts import fuzz

    stats = fuzz.compare_rows(out_k, out_p, torch.ones(n, dtype=torch.bool,
                                                       device=out_k.success.device))
    pk = out_k.counts.double().cpu().numpy() / n * 100
    pp = out_p.counts.double().cpu().numpy() / n * 100
    print(f"[{tag}] {what} vs plain, {n:,} paths, {label}:")
    print(f"[{tag}]   kernel success % {np.round(pk, 3).tolist()}")
    print(f"[{tag}]   plain  success % {np.round(pp, 3).tolist()}")
    print(f"[{tag}]   gate (b), worst row (bounds: d_success "
          f"{max(fuzz.PROBE_TOL_PTS, 100.0 / n):.3f} pts, flags < "
          f"{fuzz.FLAG_MISMATCH:g}, finals off >0.5% and >$5 < "
          f"{fuzz.PATH_SHARE:g}): {_gate(stats)}")
    if not stats["ok"]:
        raise AssertionError(f"[{tag}] {what} disagrees with its plain version")
    return stats["d_success"]


def check_probe(report, tag, eng, months, n):
    """probe_kernel vs probe_plain on one parameter block, ``n`` paths."""
    import torch
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck

    packed = eng._pack(months, "search")
    out_k = ck.probe(packed, eng.statics, eng.retirement_years, n)
    out_p = ck.probe_plain(packed, eng.statics, eng.retirement_years, n)
    torch.cuda.synchronize()
    err = _compare_rows(tag, "probe kernel", out_k, out_p, n, f"months {months}")
    report["probe_err"] = max(report.get("probe_err", 0.0), err)


def check_grid(report, tag, configs, months, n):
    """grid_kernel vs grid_plain on one (K, F.NUM + 5S) block, ``n`` paths;
    then every row against the probe kernel on that row's own block."""
    import torch
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (
        _grid_stream_seed,
        grid_statics,
    )
    from monte_carlo_retirement_tpu_torch.models.retirement import (
        SimParams,
        stack_params,
    )

    statics = grid_statics(configs)
    R = configs[0].retirement_years
    seed = _grid_stream_seed(SEED)
    packed = ck.pack_grid(stack_params(configs), seed, months, R, device="cuda")
    out_k = ck.grid(packed, statics, R, n)
    out_p = ck.grid_plain(packed, statics, R, n)
    torch.cuda.synchronize()
    err = _compare_rows(tag, "grid kernel", out_k, out_p, n,
                        f"{len(configs)} rows, months {months}")
    report["grid_err"] = max(report.get("grid_err", 0.0), err)
    worst = 0.0
    for k, (cfg, w) in enumerate(zip(configs, months)):
        # Packed where pack_grid packs (on the host), so the floats are the
        # grid row's own, bit for bit.
        row = ck.pack_params(SimParams.from_config(cfg), seed, [w], R,
                             device="cuda")
        if not torch.equal(row.fp, packed.fp[k]):
            raise AssertionError(f"[{tag}] row {k} packs differently alone")
        one = ck.probe(row, statics, R, n)
        if not torch.equal(one.success[0], out_k.success[k]):
            bad = int((one.success[0] != out_k.success[k]).sum())
            raise AssertionError(
                f"[{tag}] grid row {k} differs from the probe of its own block "
                f"in {bad} flags")
        worst = max(worst, float((one.final_balance[0]
                                  - out_k.final_balance[k]).abs().max()))
    print(f"[{tag}]   every row equals the probe kernel on its own block, flag "
          f"for flag; max |final difference| {worst:.3e}")


def check_full(report, tag, eng, W, n):
    """full_kernel vs simulate_full_plain at working months ``W``, ``n``
    paths, with the series as wide as Engine.run makes them, by gate (b)
    on every path without its $5 dust allowance (``fuzz.compare_full``)."""
    import torch
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.hosts import fuzz

    L = 1 + eng._t_scan(W) // 12
    R = eng.retirement_years
    packed = eng._pack(W, "final")
    k = ck.simulate_full(packed, eng.statics, R, n, L)
    p = ck.simulate_full_plain(packed, eng.statics, R, n, L)
    torch.cuda.synchronize()
    every = torch.ones(n, dtype=torch.bool, device=k["success"].device)
    stats = fuzz.compare_full(k, p, every, eng.statics.guardrails, dust=False)
    print(f"[{tag}] full kernel vs plain at W={W}, {n:,} paths, L={L}, R={R}, gate "
          f"(b) (bounds: shares < {fuzz.PATH_SHARE:g}, ruin months within 1/12 y + "
          f"1e-5, WR beyond 1e-4 + {fuzz.FIELD_RTOL:g} relative on "
          f"{'< 1e-3 of the entries' if eng.statics.guardrails else 'none'}): "
          f"{_gate(stats)}")
    if not stats["ok"]:
        raise AssertionError(f"[{tag}] full kernel disagrees with its plain version")
    report["full_err"] = max(report.get("full_err", 0.0), stats["wr_err"])


def phase_probe(report):
    import numpy as np
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine

    months = [int(m) for m in np.linspace(0, 480, 16).round()]
    check_probe(report, "3", Engine(_config(), device="cuda"), months, N_CHECK)


def phase_full(report):
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine

    check_full(report, "4", Engine(_config(), device="cuda"), 234, N_CHECK)


def phase_main_path(report):
    import numpy as np
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.simulator import (
        RetirementMonteCarloSimulator,
        median_first_year_withdrawal_rate,
    )
    from monte_carlo_retirement_tpu_torch.timing import expected_trajectory_length

    launches = {"probe": 0, "full": 0}
    for label, n_search, n_final, extensions in (
            ("a", None, None, {}),
            ("b", 1_000_000, 1_000_000, {}),
            ("c", 1_000_000, 1_000_000, ALL_ON)):
        over = dict(extensions)
        if n_search:
            over.update(num_simulations_search=n_search,
                        num_simulations_main=n_final)
        cfg = _config(**over)
        ck.reset_counts()
        t0 = time.perf_counter()
        sim = RetirementMonteCarloSimulator(cfg, device="cuda")
        months, prob, curve = sim.find_minimum_working_months(verbose=False)
        t_search = time.perf_counter() - t0
        if months < 0:
            raise AssertionError(f"({label}) search found no month (best {prob})")
        sim.use_final_seeds()
        t1 = time.perf_counter()
        res = sim.run_monte_carlo_simulations(months, cfg.num_simulations_main)
        t_final = time.perf_counter() - t1
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if not (ran["probe"] and ran["full"]):
            raise AssertionError(f"({label}) a kernel was not launched: {ran}")
        if any(plain.values()):
            raise AssertionError(f"({label}) plain versions ran: {plain}")
        for name in launches:
            launches[name] += ran[name]
        summary_df, traj_df, samples, wr_df, real_df, samples_real, counts = res
        success = sim._success_probability(summary_df)
        swr = median_first_year_withdrawal_rate(summary_df)
        n = cfg.num_simulations_main
        margin = 150.0 / math.sqrt(n)
        L = expected_trajectory_length(months, cfg.retirement_years)
        if extensions:
            report["all_on_months"] = months
        if label == "b":  # phase 10a serves the same request
            report["5b"] = {"months": months,
                            "successes": int(summary_df["Success"].sum())}
        print(f"[5{label}] {'all extensions on, ' if extensions else ''}"
              f"search {cfg.num_simulations_search:,} paths -> "
              f"{months} months ({len(curve)} candidates, {prob:.2f}%) in "
              f"{t_search:.2f} s; final {n:,} paths: success {success:.3f}%, SWR "
              f"{swr:.3f}%, in {t_final:.2f} s (wall, incl. host copies); "
              f"launches {ran}, plain calls {plain}")
        if success < cfg.target_probability - margin:
            raise AssertionError(
                f"({label}) success {success:.3f}% below target "
                f"{cfg.target_probability} - {margin:.3f}")
        if len(summary_df) != n or traj_df.shape != (L, 7) or wr_df.shape != (
                cfg.retirement_years, 5) or len(samples) != 5 or len(counts) != (
                cfg.retirement_years):
            raise AssertionError(f"({label}) result shapes are wrong")
        if not (np.isfinite(traj_df.to_numpy()).all()
                and np.isfinite(real_df.to_numpy()).all()
                and np.isfinite(summary_df["Final Balance"]).all()
                and np.isfinite(swr)):
            raise AssertionError(f"({label}) non-finite results")
        # The kernels against their plain versions at this run's shapes
        # (after the counts were read: these launches are not counted).
        lo = max(0, months - 8)
        check_probe(report, f"5{label}", sim.engine, list(range(lo, lo + 16)),
                    cfg.num_simulations_search)
        check_full(report, f"5{label}", sim.engine, months, n)
    report["launches"] = dict(launches)
    report["launches_main"] = dict(launches)
    print(f"[5] launches over the three main-path runs: {launches}")


def _print_bounds(times, bounds, names):
    for name in names:
        ms, by = bounds[name]
        print(f"[6]   {name}: bound {ms:.3f} ms ({by}); kernel {times[name]:.3f} ms "
              f"is {times[name] / ms:.2f}x the bound ({ms / times[name]:.1%} of it)")


def _print_rows(what, out):
    """Per-row survivor counts and float64 final-balance sums (the
    parent-tree comparison reads these)."""
    print(f"[6]   {what}: survivors per row {out.counts.tolist()}")
    sums = out.final_balance.double().sum(dim=1).tolist()
    print(f"[6]   {what}: float64 final-balance sum per row "
          f"[{', '.join(f'{v:.17g}' for v in sums)}]")


def _body_steps(out, n, R):
    """(steps run, steps in range) of a tiled launch, in warp-months."""
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck

    return int(out.steps.sum()), ck.body_steps_all(len(out.steps), n, R)


def _steps_line(steps) -> str:
    run, every = steps
    return f"{run:,} / {every:,} (skipped {(1 - run / every) * 100:.2f}%)"


def phase_timings(report):
    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.engine import bound
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine
    from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (
        _grid_stats,
        _grid_stream_seed,
        grid_statics,
        run_scenario_grid,
    )
    from monte_carlo_retirement_tpu_torch.models.retirement import stack_params
    from monte_carlo_retirement_tpu_torch.ops.stats import summarize

    n = N_FULL
    eng = Engine(_config(retirement_years=50, initial_balance=1_500_000.0,
                         monthly_expenses=4_000.0), device="cuda")
    R = eng.retirement_years
    L = 1 + eng._t_scan(0) // 12
    sample_idx = torch.arange(5, device="cuda")
    probe_packed = eng._pack(list(range(16)), "search")
    full_packed = eng._pack(0, "final")

    def full(fn):
        return lambda: fn(full_packed, eng.statics, R, n, L)

    def full_and_summary(fn):
        return lambda: summarize(fn(full_packed, eng.statics, R, n, L), sample_idx)

    times = {
        "probe": _time_ms(lambda: ck.probe(probe_packed, eng.statics, R, n)),
        "full": _time_ms(full(ck.simulate_full)),
        "full_summarize": _time_ms(full_and_summary(ck.simulate_full)),
        "simulate": _time_ms(
            lambda: ck.simulate(full_packed, eng.statics, R, n)),
        "probe_plain": _time_ms(
            lambda: ck.probe_plain(probe_packed, eng.statics, R, n)),
        "full_plain": _time_ms(full(ck.simulate_full_plain)),
        "full_plain_summarize": _time_ms(full_and_summary(ck.simulate_full_plain)),
        "simulate_plain": _time_ms(
            lambda: ck.simulate_plain(full_packed, eng.statics, R, n), repeats=2),
    }
    probe_out = ck.probe(probe_packed, eng.statics, R, n)
    succ = probe_out.counts[0].item() / n * 100
    card = report["card"]
    T = 12 * R  # months of a W=0 row
    months16 = list(range(16))
    bounds = {
        "probe": _bound(report, "probe", ck.tile_work(
            ck.probe_plan(16, n, eng.statics), months16,
            [w + T for w in months16]), 16 * n * 8),
        "full": _bound(report, "full", bound.full_work(n, 0, T),
                       4 * n * (7 + 2 * L + R)),
        "simulate": _bound(report, "grid", ck.tile_work(
            ck.tile_plan(1, n, eng.statics, "grid"), [0], [T]), n * 8),
    }
    print(f"[6] 1M paths x 600 months, W=0 (probe: 16 candidates, months 0-15), "
          f"CUDA events, warm, min of 5 (plain simulate: min of 2), on {card}:")
    print(f"[6]   probe kernel {times['probe']:.3f} ms | plain "
          f"{times['probe_plain']:.3f} ms")
    print(f"[6]   full kernel {times['full']:.3f} ms | plain "
          f"{times['full_plain']:.3f} ms")
    print(f"[6]   full kernel + summarize {times['full_summarize']:.3f} ms | "
          f"plain + summarize {times['full_plain_summarize']:.3f} ms")
    print(f"[6]   simulate (grid kernel, one row) {times['simulate']:.3f} ms | "
          f"plain {times['simulate_plain']:.3f} ms")
    print(f"[6]   success at W=0: {succ:.3f}%")
    _print_bounds(times, bounds, ("probe", "full", "simulate"))
    _print_rows("slice probe", probe_out)
    # The search's later ladder, W = 204-384: its rows share 204 working
    # years, which accum_kernel runs once per path, then each row retires.
    ladder = list(range(204, 385, 12))
    ladder_packed = eng._pack(ladder, "search")
    ladder_plan = ck.probe_plan(16, n, eng.statics)
    times["probe_ladder"] = _time_ms(
        lambda: ck.probe(ladder_packed, eng.statics, R, n))
    bounds["probe_ladder"] = _bound(report, "probe", ck.tile_work(
        ladder_plan, ladder, [w + T for w in ladder]), 16 * n * 8)
    acc = ck.accum_counts(ladder_plan, ladder)
    print(f"[6]   probe at W=204-384 (accumulation path-months run / per row: "
          f"{acc['accum_run']:,} / {acc['accum_rows']:,}): kernel "
          f"{times['probe_ladder']:.3f} ms")
    _print_bounds(times, bounds, ("probe_ladder",))
    # The tiled kernels stop a warp whose paths are all ruined. The slice's
    # rows live through their 600 months, so it times the full work of its
    # bound: its skip share must read 0. config.json's own household at the
    # same W (a served search's first probe) is ruined within ~30 months.
    house = Engine(_config(), device="cuda")
    house_packed = house._pack(months16, "search")
    times["probe_ruined"] = _time_ms(lambda: ck.probe(
        house_packed, house.statics, house.retirement_years, n))
    ruined_out = ck.probe(house_packed, house.statics, house.retirement_years, n)
    steps = {"slice": _body_steps(probe_out, n, R),
             "ruined": _body_steps(ruined_out, n, house.retirement_years)}
    print(f"[6]   body steps run / in range (warp-months): slice "
          f"{_steps_line(steps['slice'])}; config.json's own household at "
          f"W=0-15 (success {ruined_out.counts.max().item() / n * 100:.3f}%): "
          f"probe kernel {times['probe_ruined']:.3f} ms, "
          f"{_steps_line(steps['ruined'])}")
    if steps["slice"][0] != steps["slice"][1]:
        raise AssertionError("[6] a warp of the slice stopped: it no longer "
                             "times the full work of its bound")

    # The same scenario with every extension on (ALL_ON).
    eng_on = Engine(_config(retirement_years=50, initial_balance=1_500_000.0,
                            monthly_expenses=4_000.0, **ALL_ON), device="cuda")
    st_on = eng_on.statics
    probe_on = eng_on._pack(list(range(16)), "search")
    full_on = eng_on._pack(0, "final")
    times["probe_all_on"] = _time_ms(lambda: ck.probe(probe_on, st_on, R, n))
    times["full_all_on"] = _time_ms(
        lambda: ck.simulate_full(full_on, st_on, R, n, L))
    # One cold call each: the plain versions are host-bound launch streams
    # whose allocations the slice's timings above have already made.
    times["probe_plain_all_on"] = _time_ms(
        lambda: ck.probe_plain(probe_on, st_on, R, n), repeats=1, warm=False)
    times["full_plain_all_on"] = _time_ms(
        lambda: ck.simulate_full_plain(full_on, st_on, R, n, L), repeats=1,
        warm=False)
    probe_on_out = ck.probe(probe_on, st_on, R, n)
    succ_on = probe_on_out.counts[0].item() / n * 100
    bounds["probe_all_on"] = _bound(report, "probe", ck.tile_work(
        ck.probe_plan(16, n, st_on), months16,
        [w + T for w in months16]), 16 * n * 8, "all-on")
    bounds["full_all_on"] = _bound(report, "full", bound.full_work(n, 0, T),
                                   4 * n * (7 + 2 * L + R), "all-on")
    print(f"[6] the same with every extension on ({_statics_label(st_on)}; "
          f"plain: one cold call):")
    print(f"[6]   probe kernel {times['probe_all_on']:.3f} ms | plain "
          f"{times['probe_plain_all_on']:.3f} ms")
    print(f"[6]   full kernel {times['full_all_on']:.3f} ms | plain "
          f"{times['full_plain_all_on']:.3f} ms")
    print(f"[6]   success at W=0: {succ_on:.3f}%; body steps "
          f"{_steps_line(_body_steps(probe_on_out, n, R))}")
    _print_bounds(times, bounds, ("probe_all_on", "full_all_on"))
    _print_rows("all-on probe", probe_on_out)
    # Each extension alone: what it adds to the probe (min of 2).
    by_ext = {}
    for name, over in EXTENSIONS.items():
        eng_x = Engine(_config(retirement_years=50, initial_balance=1_500_000.0,
                               monthly_expenses=4_000.0, **dict(over)),
                       device="cuda")
        packed_x = eng_x._pack(list(range(16)), "search")
        by_ext[name] = _time_ms(
            lambda: ck.probe(packed_x, eng_x.statics, R, n), repeats=2)
    times["probe_by_extension"] = by_ext
    print("[6]   probe kernel with one extension on (min of 2): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in by_ext.items()))

    # One 16-row chunk of the 16 x 16 grid, and the whole grid's wall time.
    configs = _grid_chunk_configs()
    statics = grid_statics(configs)
    GR = configs[0].retirement_years
    months = [GRID_W] * len(configs)
    packed = ck.pack_grid(stack_params(configs), _grid_stream_seed(SEED), months,
                          GR, device="cuda")
    out = ck.grid(packed, statics, GR, n)
    times["grid"] = _time_ms(lambda: ck.grid(packed, statics, GR, n))
    bounds["grid"] = _bound(report, "grid", ck.tile_work(
        ck.tile_plan(len(configs), n, statics, "grid"), months,
        [w + 12 * GR for w in months]), len(configs) * n * 8)
    times["grid_stats"] = _time_ms(
        lambda: _grid_stats(out.success, out.final_balance, n))
    times["grid_plain"] = _time_ms(
        lambda: ck.grid_plain(packed, statics, GR, n), repeats=1)
    from monte_carlo_retirement_tpu_torch.config import Config

    raw = _grid_raw()
    all_configs = [Config(**{**raw, **over}) for over in _grid_overrides()]
    walls = []
    for _ in range(2):  # the first run warms the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_scenario_grid(all_configs, [GRID_W] * len(all_configs), n,
                                seed=SEED, device="cuda")
        walls.append((time.perf_counter() - t0) * 1e3)
    times["grid_256_wall"] = walls[-1]
    report["grid_256"] = res.success_probability
    per_chunk = times["grid"] + times["grid_stats"]
    print(f"[6] scenario grid, config.json x 16 rows (expenses "
          f"{configs[0].monthly_expenses:,.0f}), W={GRID_W}, R={GR}, 1M paths "
          f"(CUDA events; plain: min of 1):")
    print(f"[6]   grid kernel {times['grid']:.3f} ms | plain "
          f"{times['grid_plain']:.3f} ms | chunk statistics (sorts) "
          f"{times['grid_stats']:.3f} ms")
    print(f"[6]   256 x 1M grid through run_scenario_grid: wall "
          f"{walls[-1]:.1f} ms (first run {walls[0]:.1f} ms); 16 chunks x "
          f"(kernel + statistics) = {16 * per_chunk:.1f} ms, the rest "
          f"{walls[-1] - 16 * per_chunk:.1f} ms host and copies")
    _print_bounds(times, bounds, ("grid",))
    _print_rows("grid chunk", out)
    steps["grid"] = _body_steps(out, n, GR)
    print(f"[6]   grid chunk body steps {_steps_line(steps['grid'])}")
    report["body_steps"] = steps
    if not (np.isfinite(res.success_probability).all()
            and res.final_balance_percentiles.shape == (len(all_configs), 5)):
        raise AssertionError("[6] the 256-variant grid's results are malformed")
    report["times"] = times
    report["bounds"] = bounds


def phase_grid(report):
    configs = _grid_chunk_configs()
    check_grid(report, "7a", configs, [GRID_W] * len(configs), N_FULL)
    from monte_carlo_retirement_tpu_torch.config import Config

    raw = _grid_raw()
    ragged = [Config(**{**raw, **over}) for over in (
        {"monthly_expenses": 6_000.0, "allocation_inv1_pct": 0.8},
        {"monthly_expenses": 11_000.0, "inv1_returns_mean": 0.09},
        {"monthly_expenses": 9_000.0, "inv1_realized_gains_tax_rate": 0.2},
    )]
    check_grid(report, "7b", ragged, [0, 120, GRID_W], 1_000)
    # 11 rows (no multiple of a block's rows) whose W spread over 0-480, so
    # the rows of a block end at different months.
    import numpy as np

    spread = [Config(**{**raw, **over}) for over in _grid_overrides()[5::24]]
    check_grid(report, "7c", spread,
               [int(m) for m in np.linspace(0, 480, len(spread)).round()], N_CHECK)


def phase_modes(report):
    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.hosts.grid import (
        GridRequest,
        prepare_grid,
        run_prepared_grid,
    )
    from monte_carlo_retirement_tpu_torch.hosts.optimize import (
        OptimizeRequest,
        run_optimize_request,
    )
    from monte_carlo_retirement_tpu_torch.hosts.sensitivity import (
        SensitivityRequest,
        run_sensitivity_request,
    )

    raw = _grid_raw()
    launches = report["launches"]
    grid_path = report["launches_grid"] = {}

    def counted(label, fn):
        ck.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if any(plain.values()):
            raise AssertionError(f"[{label}] plain versions ran: {plain}")
        for name, count in ran.items():
            launches[name] = launches.get(name, 0) + count
            grid_path[name] = grid_path.get(name, 0) + count
        print(f"[{label}] wall {wall:.2f} s; launches {ran}")
        return out, ran

    request = GridRequest(config=raw, variants=[
        {"overrides": over} for over in _grid_overrides()],
        working_months=GRID_W, num_paths=N_FULL, chunk_size=16)
    payload, ran = counted("8a", lambda: run_prepared_grid(
        prepare_grid(request), request.chunk_size, device="cuda"))
    if ran["grid"] != 16 or payload["total_scenarios"] != 256:
        raise AssertionError(f"[8a] expected 16 grid launches, got {ran}")
    succ = np.array([r["success_probability"] for r in payload["rows"]])
    table = succ.reshape(GRID_SIDE, GRID_SIDE)  # rows: expenses, cols: eq mean
    report["grid_8a"] = table
    if not (np.diff(table, axis=0) <= 0).all():
        raise AssertionError("[8a] success rose with expenses in some column")
    print("[8a] 256 x 1M grid, success % (rows: expenses 4,000 -> 14,000; "
          "columns: equity mean 0.06 -> 0.14):")
    for row in table:
        print("[8a]   " + " ".join(f"{v:6.2f}" for v in row))

    sens_req = SensitivityRequest(config=raw, working_months=GRID_W,
                                  num_paths=N_FULL)
    sens, ran = counted("8b", lambda: run_sensitivity_request(sens_req,
                                                              device="cuda"))
    rows = {r["param"]: r for r in sens["rows"]}
    for r in sens["rows"]:
        print(f"[8b]   {r['param']:<32} d success/unit {r['d_success']:>12.4g}"
              f"  per step {r['success_per_step']:>+8.3f}%  base "
              f"{r['success_base']:.3f}%")
    if not (ran["grid"] >= 2 and len(rows) == 8
            and rows["monthly_expenses"]["d_success"] < 0
            and rows["initial_balance"]["d_success"] > 0):
        raise AssertionError("[8b] sensitivity signs or launches are wrong")

    opt_req = OptimizeRequest(config=raw, working_months=GRID_W,
                              param="allocation_inv1_pct", lo=0.3, hi=0.9,
                              num_paths=N_FULL)
    best, ran = counted("8c", lambda: run_optimize_request(opt_req,
                                                           device="cuda"))
    lo, hi = best["interval"]
    print(f"[8c]   best allocation_inv1_pct {best['best']['value']:.6f} in "
          f"[{lo:.6f}, {hi:.6f}]: success {best['best']['success_probability']:.3f}%"
          f" ± {best['success_sigma']:.3f}; {best['evaluations']} evaluations")
    if not (best["evaluations"] == 51 and ran["grid"] == 3
            and lo <= best["best"]["value"] <= hi):
        raise AssertionError("[8c] optimize result or launches are wrong")

    # The all-on config's sensitivity at phase 5's all-on month.
    on_req = SensitivityRequest(config=_raw_config(**dict(ALL_ON)),
                                working_months=report["all_on_months"],
                                params=list(ALL_ON_SENSITIVITY), num_paths=N_FULL)
    on_sens, ran = counted("8d", lambda: run_sensitivity_request(on_req,
                                                                 device="cuda"))
    on_rows = {r["param"]: r for r in on_sens["rows"]}
    for r in on_sens["rows"]:
        print(f"[8d]   {r['param']:<36} d success/unit {r['d_success']:>12.4g}"
              f"  per step {r['success_per_step']:>+8.3f}%  base "
              f"{r['success_base']:.3f}%")
    if not (ran["grid"] >= 1 and len(on_rows) == len(ALL_ON_SENSITIVITY)
            and all(on_rows[p]["d_success"] < 0 for p in (
                "market_crashes.frequency_per_year", "longevity.mode_age",
                "inv1_annual_tax_on_gains_rate"))):
        raise AssertionError("[8d] all-on sensitivity signs or launches are wrong")

    # bench.py's workload through simulate (what ROADMAP A5's bench calls).
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine

    eng = Engine(_config(retirement_years=50, initial_balance=1_500_000.0,
                         monthly_expenses=4_000.0), device="cuda")
    R, n = eng.retirement_years, N_FULL
    packed = eng._pack(0, "search")
    sim, ran = counted("8e", lambda: ck.simulate(packed, eng.statics, R, n))
    if ran["simulate"] != 1:
        raise AssertionError(f"[8e] simulate launches {ran}")
    plain = ck.simulate_plain(packed, eng.statics, R, n)
    probe = ck.probe(eng._pack([0, 1], "search"), eng.statics, R, n)
    torch.cuda.synchronize()
    err = _compare_rows(
        "8e", "simulate (grid kernel, one row)",
        ck.ProbeOut((sim.success > 0.5).sum()[None], sim.success[None],
                    sim.final_balance[None]),
        ck.ProbeOut((plain.success > 0.5).sum()[None], plain.success[None],
                    plain.final_balance[None]),
        n, "W=0, 1M x 600 months")
    if not torch.equal(sim.success, probe.success[0]):
        raise AssertionError("[8e] simulate's flags differ from the probe's at W=0")
    print("[8e]   simulate's flags equal the probe kernel's at W=0")
    report["sim_err"] = err

    # The AD cross-check at the route's largest ad_num_paths, held to a CRN
    # central difference of the same metric on the grid kernel: the JVP
    # kernel, no plain AD pass.
    from monte_carlo_retirement_tpu_torch.config import Config
    from monte_carlo_retirement_tpu_torch.engine.sensitivity import (
        DEFAULT_PARAMS,
        ad_inputs,
        sensitivity_ad,
        sensitivity_fd,
    )

    cfg = Config(**raw)
    # torch's forward AD imports torch._dynamo on its first use in a
    # process (ad_inputs' jacfwd): timed apart, before the first AD call.
    t0 = time.perf_counter()
    import torch._dynamo  # noqa: F401

    t_import = time.perf_counter() - t0
    walls = []
    report["ad_launches"] = {"grid": 0}
    for _ in range(2):  # the process's first AD call, then a warm one
        ck.reset_counts()
        t0 = time.perf_counter()
        ad = sensitivity_ad(cfg, GRID_W, num_paths=AD_PATHS, seed=SEED,
                            device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if ran.pop("ad") < 1 or any(plain.values()) or any(ran.values()):
            raise AssertionError(f"[8f] AD pass: launches "
                                 f"{dict(ck.LAUNCHES)}, plain {plain}")
        for name, count in ck.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + count
            grid_path[name] = grid_path.get(name, 0) + count
        report["ad_launches"]["grid"] += ck.LAUNCHES["ad"]
    t_ad = walls[-1]
    packed, fp_dot, st, draws = ad_inputs(cfg, GRID_W, DEFAULT_PARAMS, SEED,
                                          torch.device("cuda"), "auto",
                                          torch.float32)
    kernel_ms = _time_ms(lambda: ck.simulate_jvp(packed, fp_dot, st,
                                                 cfg.retirement_years, AD_PATHS),
                         repeats=3)
    fd, ran = counted("8f", lambda: sensitivity_fd(
        cfg, GRID_W, num_paths=AD_PATHS, seed=SEED, rel_step=0.002,
        abs_step=0.0005, device="cuda"))
    fd = {r.param: r.d_mean_final for r in fd}
    grads = ad["d_mean_final"]
    print(f"[8f] sensitivity_ad, twice (jvp_kernel: "
          f"{report['ad_launches']['grid']} launches of {ck.JVP_TK} "
          f"tangents, no plain AD pass) at "
          f"{AD_PATHS:,} paths, W={GRID_W}: wall {t_ad:.3f} s (the process's "
          f"first AD call {walls[0]:.3f} s, after importing torch._dynamo in "
          f"{t_import:.3f} s), the kernel alone {kernel_ms:.3f} ms (CUDA "
          f"events, min of 3); mean final balance "
          f"{ad['mean_final_balance']:.2f}")
    for name, g in grads.items():
        print(f"[8f]   {name:<32} AD {g:>16.6g}  CRN FD {fd[name]:>16.6g}  "
              f"AD/FD {g / fd[name]:.6f}")
    close = all(abs(grads[p] / fd[p] - 1.0) <= 0.05
                for p in ("monthly_expenses", "inv1_returns_mean"))
    if not (all(math.isfinite(g) for g in grads.values()) and close
            and grads["monthly_expenses"] < 0 < grads["inv1_returns_mean"]):
        raise AssertionError("[8f] AD gradients are not finite, signed or "
                             "within 5% of the finite difference")
    report["ad_wall_s"] = t_ad


def phase_extensions(report):
    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine
    from monte_carlo_retirement_tpu_torch.ops.shocks import BLOCK_PATHS as B

    months = [int(m) for m in np.linspace(0, 240, 16).round()]
    for name, over in list(EXTENSIONS.items()) + [("all", ALL_ON)]:
        eng = Engine(_config(retirement_years=EXT_R, **dict(over)), device="cuda")
        print(f"[9 {name}] {_statics_label(eng.statics)}, R={EXT_R}")
        check_probe(report, f"9 {name}", eng, months, N_CHECK)
        # W=160: between 5% and 97% of paths succeed under most extensions
        check_full(report, f"9 {name}", eng, 160, N_CHECK)
        rows = [_config(retirement_years=EXT_R, **dict(over), monthly_expenses=e,
                        allocation_inv1_pct=a)
                for e, a in ((8_000.0, 0.6), (10_000.0, 0.8), (12_000.0, 0.45))]
        check_grid(report, f"9 {name}", rows, [0, 120, GRID_W], N_CHECK)

    # Rule-off bit-identity: every parameter a disabled feature would read,
    # poisoned, changes no bit of the probe or full kernel's outputs.
    eng = Engine(_config(), device="cuda")
    st, R, F = eng.statics, eng.retirement_years, ck.F
    if any(st[6:]) or st.bill1 or st.bill2:
        raise AssertionError("[9] config.json's Statics have an extension on")
    poison = {F.R_ANN1: 0.9, F.R_ANN2: 0.9, F.ALLOC1_F: 0.0, F.GR_UP: 1e-4,
              F.GR_LO: 10.0, F.GR_ADJ: 0.5, F.GR_FLOOR: 0.1, F.GR_CAP: 3.0,
              F.JP: 1.0, F.JMU: -2.0, F.JSIG: 1.0, F.JBETA: 1.0, F.JC1: 0.5,
              F.JC2: 0.5, F.MORT_G0: 0.1, F.MORT_B12: 1.0, F.MORT_CAP: 1.0,
              F.NUM + 2 * len(st.stream_indexed): 1.0}  # uncapped duration

    def poisoned(packed):
        fp = packed.fp.clone()
        for i, v in poison.items():
            fp[i] = v
        return ck.Packed(fp=fp, ip=packed.ip, n_streams=packed.n_streams)

    probe_packed = eng._pack(months, "search")
    outs = [ck.probe(p, st, R, N_CHECK) for p in (probe_packed, poisoned(probe_packed))]
    full_packed = eng._pack(234, "final")
    L = 1 + eng._t_scan(234) // 12
    fulls = [ck.simulate_full(p, st, R, N_CHECK, L)
             for p in (full_packed, poisoned(full_packed))]
    torch.cuda.synchronize()
    same = torch.equal(outs[0].success, outs[1].success) and torch.equal(
        outs[0].final_balance, outs[1].final_balance) and all(
        torch.equal(fulls[0][k].nan_to_num(-7.0), fulls[1][k].nan_to_num(-7.0))
        for k in fulls[0])
    print(f"[9] rule-off: {len(poison)} parameters of disabled features "
          f"poisoned; probe and full kernel outputs bit-equal: {same}")
    if not same:
        raise AssertionError("[9] a disabled feature's parameters changed the bits")

    # Antithetic pairing: blocks 2k and 2k+1 share key block k. At W=231
    # most paths survive, so the twins' final balances are not all zero.
    anti = Engine(_config(antithetic=True), device="cuda").statics
    packed = eng._pack([GRID_W], "search")
    a = ck.probe(packed, anti, R, 4 * B)
    i = ck.probe(packed, st, R, 2 * B)
    torch.cuda.synchronize()
    fa, fi = a.final_balance[0], i.final_balance[0]
    paired = (torch.equal(fa[:B], fi[:B]) and torch.equal(fa[2 * B:3 * B], fi[B:])
              and torch.equal(a.success[0][2 * B:3 * B], i.success[0][B:]))
    twins = not torch.equal(fa[B:2 * B], fa[:B])
    print(f"[9] antithetic: even blocks bit-equal to the iid probe's blocks: "
          f"{paired}; odd blocks differ from their pairs: {twins}")
    if not (paired and twins):
        raise AssertionError("[9] antithetic pairing is wrong on the card")


def _leaves(node, path=""):
    if isinstance(node, dict):
        for key, value in node.items():
            yield from _leaves(value, f"{path}.{key}")
    elif isinstance(node, list):
        for i, value in enumerate(node):
            yield from _leaves(value, f"{path}[{i}]")
    else:
        yield path, node


def _compare_payloads(tag, got, want):
    """Two JSON payloads: the same keys and list lengths, every integer,
    string, bool and null leaf equal, every float within PAYLOAD_RTOL of
    its value plus PAYLOAD_ATOL (the card interpolates percentiles in
    float32, pandas in float64; the wire rounds to cents). Returns (integer
    leaves, float leaves, (worst float difference, its path, its relative
    size))."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    if g.keys() != w.keys():
        raise AssertionError(f"[{tag}] payload structure differs at "
                             f"{sorted(g.keys() ^ w.keys())[:8]}")
    ints, floats, worst = 0, 0, (0.0, "", 0.0)
    for path, b in w.items():
        a = g[path]
        if isinstance(b, float) and isinstance(a, float):
            floats += 1
            diff = abs(a - b)
            if not diff <= PAYLOAD_RTOL * abs(b) + PAYLOAD_ATOL + 1e-9:
                raise AssertionError(f"[{tag}] {path}: {a!r} vs {b!r}")
            worst = max(worst, (diff, path, diff / max(abs(b), 1e-30)))
        else:
            ints += isinstance(b, int) and not isinstance(b, bool)
            if a != b or type(a) is not type(b):
                raise AssertionError(f"[{tag}] {path}: {a!r} != {b!r}")
    return ints, floats, worst


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_for(what, ready, timeout_s):
    t0 = time.perf_counter()
    while not ready():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"[10e] {what} not reached in {timeout_s} s")
        time.sleep(0.05)


def _cold_server(body, warmup):
    """A fresh server process on the card (python -m ...hosts.server) with
    an empty kernel build directory: seconds from its start to its first
    answer, to the end of its warmup (or None), of its first
    /api/simulate, and that answer."""
    import tempfile
    import urllib.error
    import urllib.request

    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        url = f"http://127.0.0.1:{port}"
        env = dict(os.environ, PYTHONPATH=REPO, MCRT_HOST="127.0.0.1",
                   MCRT_PORT=str(port), MCRT_WARMUP="1" if warmup else "0",
                   MCRT_TORCH_BUILD_DIR=os.path.join(tmp, "build"))
        log_path = os.path.join(tmp, "server.log")  # the server's own log
        with open(os.path.join(tmp, "stderr"), "w") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen([sys.executable, "-m", f"{PKG}.hosts.server"],
                                    cwd=tmp, env=env, stdout=subprocess.DEVNULL,
                                    stderr=err)
            try:
                def answers():
                    if proc.poll() is not None:
                        raise AssertionError(f"[10e] server exited {proc.returncode}")
                    try:
                        with urllib.request.urlopen(url + "/api/health", timeout=5):
                            return True
                    except (urllib.error.URLError, ConnectionError):
                        return False

                _wait_for("server start", answers, 120)
                t_up = time.perf_counter() - t0
                t_warm = None
                if warmup:
                    def warmed():
                        text = open(log_path).read() if os.path.exists(log_path) else ""
                        if "Warmup failed" in text:
                            raise AssertionError("[10e] server warmup failed")
                        return "Warmup complete" in text

                    _wait_for("warmup", warmed, 600)
                    t_warm = time.perf_counter() - t0
                request = urllib.request.Request(
                    url + "/api/simulate", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                t1 = time.perf_counter()
                with urllib.request.urlopen(request, timeout=900) as resp:
                    blob = resp.read()
                t_first = time.perf_counter() - t1
            except BaseException:
                err.flush()
                print(open(err.name).read()[-3000:], file=sys.stderr)
                raise
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    return t_up, t_warm, t_first, json.loads(blob)


def phase_server(report):
    """10: the port's HTTP server on the card."""
    import asyncio
    import statistics

    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer
    from monte_carlo_retirement_tpu_torch.config import Config
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.simulator import (
        RetirementMonteCarloSimulator,
    )
    from monte_carlo_retirement_tpu_torch.hosts import payload, server
    from monte_carlo_retirement_tpu_torch.hosts.grid import GridResponse
    from monte_carlo_retirement_tpu_torch.hosts.optimize import OptimizeResponse
    from monte_carlo_retirement_tpu_torch.hosts.schemas import SimulationResponse
    from monte_carlo_retirement_tpu_torch.hosts.sensitivity import (
        SensitivityResponse,
    )

    raw = _raw_config(num_simulations_search=N_FULL, num_simulations_main=N_FULL)
    body = {"config": raw}
    launches = report["launches"]
    served = report["launches_server"] = {}
    print(f"[10] HTTP exercised: aiohttp {aiohttp.__version__}; the port's app "
          f"(create_app(device='cuda')) in this process behind "
          f"aiohttp.test_utils.TestServer on 127.0.0.1, requests from its "
          f"TestClient")

    def counted(tag, need):
        """The launches since the last reset: no plain call, each kernel of
        ``need`` launched; they count as the server path's."""
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if any(plain.values()):
            raise AssertionError(f"[{tag}] plain versions ran: {plain}")
        if not all(ran[k] for k in need):
            raise AssertionError(f"[{tag}] a kernel was not launched: {ran}")
        for name, count in ran.items():
            launches[name] = launches.get(name, 0) + count
            served[name] = served.get(name, 0) + count
        return ran

    async def post(client, path, data):
        t0 = time.perf_counter()
        resp = await client.post(path, json=data)
        blob = await resp.read()
        wall = time.perf_counter() - t0
        if resp.status != 200:
            raise AssertionError(f"{path}: {resp.status} {blob[:500]!r}")
        return blob, wall

    async def scenario(client):
        out = {}
        # 10a: phase 5b's request, capped, so the final run is reduced.
        ck.reset_counts()
        blob, wall = await post(client, "/api/simulate", body)
        ran = counted("10a", ("probe", "full"))
        res = out["10a"] = json.loads(blob)
        SimulationResponse.model_validate(res)
        binned = res["histogram"]["binned"]
        months = res["summary"]["required_working_months"]
        print(f"[10a] /api/simulate, 1M search + 1M final paths: {months} months, "
              f"success {res['summary']['success_probability']}%, SWR "
              f"{res['summary']['swr']}%, {binned['success_count']:,} successful "
              f"paths; {len(blob):,} bytes in {wall:.3f} s; launches {ran}")
        if ran["full"] != 1 or res["histogram"]["final_balances"]:
            raise AssertionError("[10a] the final run was not one reduced run")
        if (months, binned["success_count"]) != (report["5b"]["months"],
                                                 report["5b"]["successes"]):
            raise AssertionError(f"[10a] differs from phase 5b {report['5b']}")
        print("[10a]   search month and successful paths equal phase 5b's")

        # 10b: the same request on the stream.
        ck.reset_counts()
        resp = await client.post("/api/simulate/stream", json=body)
        events = [json.loads(line[len("data: "):])
                  for line in (await resp.text()).splitlines()
                  if line.startswith("data: ")]
        ran = counted("10b", ("probe", "full"))
        kinds = [e["type"] for e in events]
        done = kinds.index("search_complete") if "search_complete" in kinds else 0
        if not (resp.status == 200 and kinds[0] == "phase"
                and events[0]["phase"] == "search" and done > 1
                and set(kinds[1:done]) <= {"search_iter", "search_refining"}
                and kinds[done + 1:] == ["phase", "result"]
                and events[done + 1]["phase"] == "final_sim"):
            raise AssertionError(f"[10b] event order {kinds}")
        if events[-1]["data"] != res:
            raise AssertionError("[10b] the stream's result differs from 10a's")
        print(f"[10b] /api/simulate/stream: {len(events)} events, phase(search), "
              f"{done - 1} search_iter/refining, search_complete, "
              f"phase(final_sim), result equal to 10a's; launches {ran}")

        # 10c: four seeds at once, then each alone.
        bodies = [{"config": {**raw, "seed": SEED + k}} for k in range(1, 5)]
        ck.reset_counts()
        together = await asyncio.gather(*(post(client, "/api/simulate", b)
                                          for b in bodies))
        ran_together = counted("10c", ("probe", "full"))
        alone, probes = [], 0
        for b in bodies:
            ck.reset_counts()
            alone.append(await post(client, "/api/simulate", b))
            probes += counted("10c", ("probe", "full"))["probe"]
        if [json.loads(t[0]) for t in together] != [json.loads(a[0]) for a in alone]:
            raise AssertionError("[10c] concurrent answers differ from serial ones")
        if ran_together["full"] != 4 or ran_together["probe"] != probes:
            raise AssertionError(f"[10c] concurrent counts {ran_together} vs "
                                 f"{probes} probes alone")
        print(f"[10c] 4 seeds concurrently (wall {max(t[1] for t in together):.3f} "
              f"s) == each alone (walls "
              f"{', '.join(f'{a[1]:.3f}' for a in alone)} s); launches "
              f"together {ran_together}, probes alone {probes}")

        # 10d: the analysis routes on the grid kernel.
        grid_raw = _grid_raw()
        start = GRID_CHUNK_ROW * GRID_SIDE
        checks = (
            ("/api/grid", GridResponse, {
                "config": grid_raw, "working_months": GRID_W, "num_paths": N_FULL,
                "chunk_size": GRID_SIDE, "variants": [
                    {"overrides": o}
                    for o in _grid_overrides()[start:start + GRID_SIDE]]}),
            ("/api/sensitivity", SensitivityResponse, {
                "config": grid_raw, "working_months": GRID_W,
                "num_paths": N_CHECK}),
            ("/api/optimize", OptimizeResponse, {
                "config": grid_raw, "working_months": GRID_W, "num_paths": N_CHECK,
                "param": "allocation_inv1_pct", "lo": 0.3, "hi": 0.9,
                "points": 5, "rounds": 2}),
        )
        for path, model, data in checks:
            ck.reset_counts()
            blob, wall = await post(client, path, data)
            ran = counted("10d", ("grid",))
            model.model_validate(json.loads(blob))
            print(f"[10d] {path}: 200, valid {model.__name__}, {wall:.3f} s, "
                  f"launches {ran}")
        if ran["grid"] != 2:
            raise AssertionError(f"[10d] optimize launched {ran}")
        ck.reset_counts()
        blob, wall = await post(client, "/api/sensitivity", {
            **checks[1][2], "include_ad": True, "ad_num_paths": N_CHECK})
        ran = counted("10d", ("grid", "ad"))
        report["ad_launches"]["server"] = ran["ad"]
        sens = json.loads(blob)
        SensitivityResponse.model_validate(sens)
        slopes = [r.get("ad_d_mean_final") for r in sens["rows"]]
        if not (all(v is not None and math.isfinite(v) for v in slopes)
                and sens.get("mean_final_balance_ad") is not None):
            raise AssertionError(f"[10d] include_ad answered {sens}")
        print(f"[10d] /api/sensitivity include_ad, ad_num_paths {N_CHECK:,}: "
              f"200, ad_d_mean_final on all {len(slopes)} rows, "
              f"mean_final_balance_ad {sens['mean_final_balance_ad']}, "
              f"{wall:.3f} s; launches {ran} (jvp_kernel, no plain AD pass)")

        # 10e: warm times over HTTP, capped and raw.
        walls = []
        for _ in range(SERVER_REPEATS):
            blob, wall = await post(client, "/api/simulate", body)
            walls.append(wall)
            if json.loads(blob) != res:
                raise AssertionError("[10e] a warm answer differs from 10a's")
        out["walls"], out["bytes"] = walls, len(blob)
        raw_walls = []
        for _ in range(3):
            raw_blob, wall = await post(client, "/api/simulate",
                                        {**body, "include_raw_paths": True})
            raw_walls.append(wall)
        out["raw_walls"], out["raw_bytes"] = raw_walls, len(raw_blob)
        return out

    async def serve():
        client = TestClient(TestServer(server.create_app(device="cuda"),
                                       host="127.0.0.1"))
        await client.start_server()
        try:
            return await scenario(client)
        finally:
            await client.close()

    warm_env = os.environ.get("MCRT_WARMUP")
    os.environ["MCRT_WARMUP"] = "0"  # phases 1-9 built and launched it all
    try:
        out = asyncio.run(serve())
    finally:
        if warm_env is None:
            os.environ.pop("MCRT_WARMUP")
        else:
            os.environ["MCRT_WARMUP"] = warm_env
    res = out["10a"]

    # 10a, second half: the pandas payload of the same run (raw per-path
    # arrays to the host, binned there by bin_successful_finals).
    cfg = Config(**raw)
    sim = RetirementMonteCarloSimulator(cfg, device="cuda")
    sim.use_final_seeds()
    months = res["summary"]["required_working_months"]
    want = payload._build_result_pandas(cfg, sim, months,
                                        res["search_curve"]["points"], capped=True)
    want = json.loads(json.dumps(
        SimulationResponse.model_validate(want).model_dump(mode="json")))
    ints, floats, (worst, where, rel) = _compare_payloads("10a", res, want)
    print(f"[10a]   vs the pandas payload of the same run: {ints} integer "
          f"fields equal (histogram, ruin and WR counts), {floats} floats within "
          f"{PAYLOAD_RTOL:g} x |value| + {PAYLOAD_ATOL} (worst {worst:.4g} at "
          f"{where}, {rel:.3g} of its value)")

    # 10e: the warm request split, in this process, through the same
    # functions the handler calls.
    def split_once():
        t0 = time.perf_counter()
        sim = RetirementMonteCarloSimulator(cfg, device="cuda")
        months, _prob, curve = sim.find_minimum_working_months(verbose=False)
        t1 = time.perf_counter()
        sim.use_final_seeds()
        final = {}

        class Timed:
            def run_result_reduced(self, w, n):
                s = time.perf_counter()
                out = sim.run_result_reduced(w, n)
                final["s"] = time.perf_counter() - s
                return out

        result = payload.build_result(cfg, Timed(), months, search_curve=curve)
        t2 = time.perf_counter()
        text = json.dumps(SimulationResponse.model_validate(result).model_dump(
            mode="json"))
        t3 = time.perf_counter()
        if json.loads(text) != res:
            raise AssertionError("[10e] the split run's payload differs from 10a's")
        return {"search": t1 - t0, "final run": final["s"],
                "payload assembly": t2 - t1 - final["s"], "JSON encoding": t3 - t2}

    splits = [split_once() for _ in range(SERVER_REPEATS)]
    card = report["card"]
    walls = out["walls"]
    times = {
        "wall_min": min(walls), "wall_median": statistics.median(walls),
        "split_median": {k: statistics.median(s[k] for s in splits)
                         for k in splits[0]},
        "split_min": {k: min(s[k] for s in splits) for k in splits[0]},
        "bytes": out["bytes"], "raw_wall_min": min(out["raw_walls"]),
        "raw_wall_median": statistics.median(out["raw_walls"]),
        "raw_bytes": out["raw_bytes"],
    }
    rest = times["wall_median"] - sum(times["split_median"].values())
    print(f"[10e] warm /api/simulate, 1M/1M, over HTTP on {card}: wall min "
          f"{times['wall_min']:.4f} s, median {times['wall_median']:.4f} s of "
          f"{SERVER_REPEATS}; response {times['bytes']:,} bytes")
    print("[10e]   split (same functions in this process, min / median of "
          f"{SERVER_REPEATS}): " + ", ".join(
              f"{k} {times['split_min'][k]:.4f} / {times['split_median'][k]:.4f} s"
              for k in times["split_median"])
          + f"; the rest of the median wall (HTTP, pydantic of the request, "
            f"threads) {rest:.4f} s")
    print(f"[10e]   include_raw_paths=true: wall min {times['raw_wall_min']:.4f} "
          f"s, median {times['raw_wall_median']:.4f} s of 3; "
          f"{times['raw_bytes']:,} bytes")
    for warmup in (False, True):
        t_up, t_warm, t_first, answer = _cold_server(body, warmup)
        if answer != res:
            raise AssertionError("[10e] the fresh server's answer differs from 10a's")
        key = "cold_warmup" if warmup else "cold_no_warmup"
        times[key] = {"up_s": t_up, "warmup_done_s": t_warm, "first_s": t_first}
        print(f"[10e] fresh server process, empty kernel build directory, "
              f"MCRT_WARMUP={int(warmup)}: answers /api/health {t_up:.2f} s after "
              f"start" + (f", warmup done {t_warm:.2f} s after start" if warmup
                          else "") + f"; first /api/simulate {t_first:.3f} s "
              f"(answer equal to 10a's)")
    report["server_times"] = times


class _ChunkLog(logging.Handler):
    """Keeps the statistics of each chunked run (the ``chunked`` attribute
    of the engine's phase=final_run record)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stats = []

    def emit(self, record):
        if hasattr(record, "chunked"):
            self.stats.append(record.chunked)


def _differing_fields(got, want):
    """The RunResult and HostBins fields of two runs that differ as values
    (-0.0 == +0.0: a sort and a compare-count may pick different zeros;
    NaN == NaN)."""
    import dataclasses

    import numpy as np

    bad = []
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if field.name == "bins" and b is not None:
            bad += [f"bins.{f.name}" for f in dataclasses.fields(b)
                    if not np.array_equal(np.asarray(getattr(a, f.name)),
                                          np.asarray(getattr(b, f.name)),
                                          equal_nan=True)]
        elif (a is None) != (b is None) or (b is not None and not np.array_equal(
                np.asarray(a), np.asarray(b), equal_nan=True)):
            bad.append(field.name)
    return bad


def phase_chunked(report):
    """11: the chunked full-statistics run on the card."""
    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.constants import (
        MAX_SEARCH_YEARS,
        MONTHS_PER_YEAR,
    )
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine import runner
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine

    total = torch.cuda.get_device_properties(0).total_memory
    months = report["5b"]["months"]
    launches = report["launches"]
    chunked = report["launches_chunked"] = {"full": 0}
    chunk_log = _ChunkLog()
    eng_log = logging.getLogger("mcrt.engine")
    old_level, old_env = eng_log.level, os.environ.get("MCRT_MAX_DEVICE_PATHS")

    def run(eng, w, n, budget, reduced=False):
        if budget is None:
            os.environ.pop("MCRT_MAX_DEVICE_PATHS", None)
        else:
            os.environ["MCRT_MAX_DEVICE_PATHS"] = str(budget)
        return eng.run(w, n, reduced=reduced)

    def run_chunked(tag, eng, w, n, budget, reduced=False):
        """One chunked run, its launches counted as the chunked path's."""
        ck.reset_counts()
        res = run(eng, w, n, budget, reduced)
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        stats = chunk_log.stats[-1] if chunk_log.stats else None
        chunk_log.stats.clear()
        if stats is None or any(plain.values()) or (
                ran["full"] != stats["full_launches"]):
            raise AssertionError(f"[{tag}] not one chunked run on the full "
                                 f"kernel: {stats}, launches {ran}, plain {plain}")
        launches["full"] += ran["full"]
        chunked["full"] += ran["full"]
        return res, stats

    def line(stats):
        return (f"{stats['chunks']} chunks, {stats['band_passes']} band passes, "
                f"{stats['full_launches']} full-kernel launches, wall "
                f"{stats['wall_s']:.3f} s (simulation {stats['simulation_s']:.3f} "
                f"s, counts and merges {stats['count_s']:.3f} s)")

    eng_log.addHandler(chunk_log)
    eng_log.setLevel(logging.INFO)
    try:
        eng = Engine(_config(), device="cuda")
        # Card memory per path of an unchunked run, and the default budget.
        bpp = {}
        n_mem = 4 * 2**20
        for label, w in (("5b month", months),
                         ("longest horizon", MAX_SEARCH_YEARS * MONTHS_PER_YEAR)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run(eng, w, n_mem, UNCHUNKED)
            torch.cuda.synchronize()
            bpp[label] = (torch.cuda.max_memory_allocated() - base) / n_mem
            print(f"[11] unchunked run at W={w} (L={1 + eng._t_scan(w) // 12}, "
                  f"R={eng.retirement_years}), {n_mem:,} paths: peak "
                  f"{bpp[label] * n_mem:,.0f} B above the baseline, "
                  f"{bpp[label]:.1f} B per path")
        os.environ.pop("MCRT_MAX_DEVICE_PATHS", None)
        budget = runner.max_device_paths()
        four = 4 * budget * bpp["longest horizon"]
        print(f"[11] default budget {budget:,} paths: 4 concurrent runs at the "
              f"longest horizon hold {four:,.0f} B of the card's {total:,} B "
              f"({four / total:.1%}); the 1M main path stays unchunked")
        if not (N_FULL <= budget and four < total):
            raise AssertionError("[11] the default budget does not fit the card")
        report["bytes_per_path"] = bpp
        report["budget"] = budget

        # 11a: unchunked vs 5 chunks, raw and reduced.
        for reduced in (False, True):
            want = run(eng, months, N_11A, UNCHUNKED, reduced)
            got, stats = run_chunked("11a", eng, months, N_11A, 2**20, reduced)
            bad = _differing_fields(got, want)
            print(f"[11a] {N_11A:,} paths at W={months}, "
                  f"{'reduced' if reduced else 'raw'}: {line(stats)}; fields "
                  f"differing from the unchunked run: {bad or 'none'}")
            if bad or stats["chunks"] != 5:
                raise AssertionError("[11a] the chunked run differs")

        # 11b: every extension on, antithetic pairs across chunk boundaries.
        eng_on = Engine(_config(**dict(ALL_ON)), device="cuda")
        w_on = report["all_on_months"]
        want = run(eng_on, w_on, N_11B, UNCHUNKED)
        got, stats = run_chunked("11b", eng_on, w_on, N_11B, BLOCKS_11B * 4096)
        bad = _differing_fields(got, want)
        print(f"[11b] all extensions on, {N_11B:,} paths at W={w_on}: "
              f"{line(stats)}; fields differing: {bad or 'none'}")
        if bad or stats["chunks"] != 4:
            raise AssertionError("[11b] the all-on chunked run differs")

        # 11c: beyond the card, at the default budget.
        need = N_11C * bpp["5b month"]
        print(f"[11c] {N_11C:,} paths unchunked would need ~{need:,.0f} B "
              f"(> the card's {total:,} B: {need > total})")
        if need <= total:
            raise AssertionError("[11c] the run would fit unchunked")
        ref = run(eng, months, 2**20, UNCHUNKED)
        del want, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        big, stats = run_chunked("11c", eng, months, N_11C, None)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        same = [name for name in ck.VECTOR_FIELDS
                if getattr(big, name)[:2**20].tobytes() == getattr(ref, name).tobytes()]
        p1, pn = ref.success_probability, big.success_probability
        sigma = math.sqrt(max(p1 * (100.0 - p1), 1e-9) / 2**20)
        print(f"[11c] {N_11C:,} paths at W={months}, raw, default budget: "
              f"{line(stats)}; Engine.run wall {wall:.3f} s; peak "
              f"{peak:,} B allocated of the card's {total:,} B")
        print(f"[11c]   first {2**20:,} entries bit-equal to the 1M unchunked "
              f"run in {len(same)}/{len(ck.VECTOR_FIELDS)} vectors; success "
              f"{pn:.4f}% vs {p1:.4f}% (4 sigma = {4 * sigma:.4f} pts)")
        if not (len(same) == len(ck.VECTOR_FIELDS) and abs(pn - p1) <= 4 * sigma
                and np.isfinite(big.trajectory_percentiles).all()
                and big.final_balance.shape == (N_11C,)):
            raise AssertionError("[11c] the run beyond the card is wrong")
        report["chunked_11c"] = dict(stats, engine_wall_s=wall, peak_bytes=peak)
    finally:
        eng_log.removeHandler(chunk_log)
        eng_log.setLevel(old_level)
        if old_env is None:
            os.environ.pop("MCRT_MAX_DEVICE_PATHS", None)
        else:
            os.environ["MCRT_MAX_DEVICE_PATHS"] = old_env


def _mesh_children(args, n_procs, backend, shards):
    """``n_procs`` processes of hosts/dist_worker.py in one group on cuda:0,
    started at once; returns them (the caller collects and reaps)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ, MCRT_COORDINATOR=f"127.0.0.1:{port}",
                   MCRT_NUM_PROCESSES=str(n_procs), MCRT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.hosts.dist_worker", "--device", "cuda",
             "--shards", str(shards), "--backend", backend, *args],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _collect_children(tag, procs):
    results = []
    for p in procs:
        out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"[{tag}] a worker failed (rc {p.returncode}):\n"
                                 f"{err[-3000:]}")
        results.append(json.loads(lines[0][len("RESULT "):]))
    return sorted(results, key=lambda r: r["process"])


def phase_mesh(report):
    """12: the paths mesh on the card (four shards on cuda:0)."""
    import tempfile

    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine import sharded
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine
    from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (
        _grid_stream_seed,
        run_scenario_batch,
        run_scenario_grid,
    )
    from monte_carlo_retirement_tpu_torch.hosts import dist_worker
    from monte_carlo_retirement_tpu_torch.models.retirement import stack_params
    from monte_carlo_retirement_tpu_torch.parallel.mesh import make_mesh
    from monte_carlo_retirement_tpu_torch.utils.profiling import (
        device_timer,
        phase_timings,
        trace_to,
    )

    mesh = make_mesh(["cuda:0"] * MESH_SHARDS)
    launches = report["launches"]
    mesh_path = report["launches_mesh"] = {}
    times = report["mesh_times"] = {}

    def counted(tag, fn):
        """One call on the mesh path: counters reset before, read after, no
        plain version allowed."""
        ck.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if any(plain.values()):
            raise AssertionError(f"[{tag}] plain versions ran: {plain}")
        for name, count in ran.items():
            launches[name] = launches.get(name, 0) + count
            mesh_path[name] = mesh_path.get(name, 0) + count
        return out, ran

    def same(tag, what, a, b):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"[{tag}] {what} differs from the single launch")

    print(f"[12] mesh: {mesh.size} shards on {mesh.device} (they run in turn: "
          f"the times below are no yardstick for {mesh.size} cards)")
    # 12a: the five sharded launches == the single-device launch.
    with device_timer("12a"):
        eng = Engine(_config(retirement_years=50, initial_balance=1_500_000.0,
                             monthly_expenses=4_000.0), device="cuda")
        R, st, params = eng.retirement_years, eng.statics, eng.params
        L = 1 + eng._t_scan(0) // 12
        s_search, s_final = eng._stream_seed("search"), eng._stream_seed("final")
        m16 = list(range(16))
        pad = mesh.plan(N_FULL).simulated
        for n in (N_12A, N_FULL):
            got, ran = counted("12a", lambda: sharded.probe_sharded(
                params, s_search, m16, R, n, st, mesh=mesh))
            want = ck.probe(eng._pack(m16, "search"), st, R, got.simulated)
            same("12a", f"probe at {n:,}", torch.as_tensor(got.counts), want.counts)
            exact = ck.probe(eng._pack(m16, "search"), st, R, n).counts
            print(f"[12a] probe_sharded 16 x {n:,} x 600: {ran['probe']} launches; "
                  f"survivors equal a single probe at {got.simulated:,} paths "
                  f"(W=0: {got.percent[0]:.4f}% over them, {exact[0].item() / n * 100:.4f}% "
                  f"over exactly {n:,})")
        got, ran = counted("12a", lambda: sharded.simulate_sharded(
            params, s_final, 0, R, N_FULL, st, mesh=mesh))
        packed = eng._pack(0, "final")
        for a, b, c in zip(got, ck.simulate(packed, st, R, pad),
                           ck.simulate(packed, st, R, N_FULL)):
            same("12a", "simulate", a, b)
            same("12a", "simulate (first n)", a[:N_FULL], c)
        print(f"[12a] simulate_sharded 1M x 600: {ran['simulate']} launches; "
              f"{pad:,} entries equal a single launch at {pad:,}, the first "
              f"{N_FULL:,} one at {N_FULL:,}")
        got, ran = counted("12a", lambda: sharded.simulate_full_sharded(
            params, s_final, 0, R, N_FULL, L, st, mesh=mesh))
        single = ck.simulate_full(packed, st, R, pad, L)
        for name in single:
            same("12a", f"full {name}", got[name], single[name])
        first = ck.simulate_full(packed, st, R, N_FULL, L)
        for name in first:
            same("12a", f"full {name} (first n)", got[name][:N_FULL], first[name])
        print(f"[12a] simulate_full_sharded 1M x 600: {ran['full']} launches; all "
              f"10 outputs equal a single launch at {pad:,} and at {N_FULL:,}")
        del got, single, first
        configs = _grid_chunk_configs()
        GR = configs[0].retirement_years
        gmonths = [GRID_W] * len(configs)
        batch = stack_params(configs)
        gseed = _grid_stream_seed(SEED)
        gst = ck.statics_from_config(configs[0])
        got, ran = counted("12a", lambda: sharded.grid_sharded(
            batch, gseed, gmonths, GR, N_FULL, gst, mesh=mesh))
        gpacked = ck.pack_grid(batch, gseed, gmonths, GR, device="cuda")
        single = ck.grid(gpacked, gst, GR, pad)
        same("12a", "grid counts", torch.as_tensor(got.counts), single.counts)
        raw_out, ran_raw = counted("12a", lambda: sharded.grid_raw_sharded(
            batch, gseed, gmonths, GR, N_FULL, gst, mesh=mesh))
        first = ck.grid(gpacked, gst, GR, N_FULL)
        for a, b, c in zip(raw_out, single, first):
            if a is None:  # the probe's decided steps: no grid launch counts them
                continue
            same("12a", "grid_raw", a, b)
            if a.ndim == 2:
                same("12a", "grid_raw (first n)", a[:, :N_FULL], c)
        print(f"[12a] grid_sharded and grid_raw_sharded, the 16-row chunk (W="
              f"{GRID_W}, R={GR}) at 1M: {ran['grid']} + {ran_raw['grid']} "
              f"launches; counts and (16, {pad:,}) tables equal a single launch")
        del raw_out, single, first
        # Four shards on one card vs one launch (CUDA events, min of 3).
        tm = {
            "probe_sharded": _time_ms(lambda: sharded.probe_sharded(
                params, s_search, m16, R, N_12A, st, mesh=mesh), repeats=3),
            "probe": _time_ms(lambda: ck.probe(
                eng._pack(m16, "search"), st, R, N_12A), repeats=3),
            "simulate_sharded": _time_ms(lambda: sharded.simulate_sharded(
                params, s_final, 0, R, N_FULL, st, mesh=mesh), repeats=3),
            "simulate": _time_ms(lambda: ck.simulate(packed, st, R, N_FULL),
                                 repeats=3),
            "full_sharded": _time_ms(lambda: sharded.simulate_full_sharded(
                params, s_final, 0, R, N_FULL, L, st, mesh=mesh), repeats=3),
            "full": _time_ms(lambda: ck.simulate_full(packed, st, R, N_FULL, L),
                             repeats=3),
            "grid_sharded": _time_ms(lambda: sharded.grid_sharded(
                batch, gseed, gmonths, GR, N_FULL, gst, mesh=mesh), repeats=3),
            "grid": _time_ms(lambda: ck.grid(gpacked, gst, GR, N_FULL), repeats=3),
        }
        times.update(tm)
        print(f"[12a] card times (CUDA events, warm, min of 3) on {report['card']}, "
              f"{mesh.size} shards on one card vs one launch: " + ", ".join(
                  f"{k} {tm[k + '_sharded']:.3f} ms vs {tm[k]:.3f} ms"
                  for k in ("probe", "simulate", "full", "grid")))
        with tempfile.TemporaryDirectory() as tdir:
            with trace_to(tdir):
                sharded.probe_sharded(params, s_search, m16, R, N_12A, st,
                                      mesh=mesh)
            (name,) = os.listdir(tdir)
            with open(os.path.join(tdir, name)) as fh:
                events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
        print(f"[12a] trace_to: {len(events)} events, {len(kernels)} card kernels "
              f"({busy_ms:.3f} ms busy) in one probe_sharded call")
        if not kernels:
            raise AssertionError("[12a] the trace holds no card kernel")

    # 12b: Engine(mesh=) on phase 5b's request, then chunked, then a grid.
    months = report["5b"]["months"]
    with device_timer("12b"):
        cfg = _config(num_simulations_search=N_FULL, num_simulations_main=N_FULL)
        kw = dict(search_paths=N_FULL, paths=N_FULL, device="cuda",
                  chunked_paths=N_12_CHUNKED, chunk_budget=BUDGET_12_CHUNKED)
        got, ran = counted("12b", lambda: dist_worker.run_workload(
            cfg, mesh=mesh, **kw))
        want = dist_worker.run_workload(cfg, **kw)
        report["12b"] = got
        search_month, successes = got["search"]["months"], got["raw"]["successes"]
        # The sharded probe counts the padding of the last shard (trap 1):
        # 1,015,808 paths for 1M, so the curve moves a little, the answer
        # should not; the runs take the first 1M paths and must be equal.
        bad = [k for k in ("raw", "reduced", "chunked") if got[k] != want[k]]
        curve = {pt["working_months"]: pt["probability"]
                 for pt in want["search"]["curve"]}
        moved = max(abs(pt["probability"] - curve[pt["working_months"]])
                    for pt in got["search"]["curve"]
                    if pt["working_months"] in curve)
        print(f"[12b] Engine(mesh) on 5b's request: search {search_month} months "
              f"({got['search']['probability']:.4f}% over "
              f"{mesh.plan(N_FULL).simulated:,} simulated paths; mesh-less "
              f"{want['search']['months']} months, {want['search']['probability']:.4f}%"
              f" over {N_FULL:,}; curve points moved by at most {moved:.2f} pts), "
              f"final {successes:,} successful paths (5b: {months}, "
              f"{report['5b']['successes']:,}); launches {ran}; runs differing from "
              f"the mesh-less engine: {bad or 'none'} (raw, reduced, chunked run "
              f"of {N_12_CHUNKED:,} at {BUDGET_12_CHUNKED:,} per shard)")
        if ((search_month, successes) != (months, report["5b"]["successes"])
                or want["search"]["months"] != months or bad):
            raise AssertionError("[12b] the meshed engine differs")
        old_env = os.environ.get("MCRT_MAX_DEVICE_PATHS")
        eng_log = logging.getLogger("mcrt.engine")
        old_level = eng_log.level
        eng5 = Engine(cfg, device="cuda")
        eng_m = Engine(cfg, device="cuda", mesh=mesh)
        try:
            for reduced in (False, True):
                os.environ["MCRT_MAX_DEVICE_PATHS"] = str(UNCHUNKED)
                ref = eng5.run(months, N_11A, reduced=reduced)
                os.environ["MCRT_MAX_DEVICE_PATHS"] = str(2**20)
                chunk_log = _ChunkLog()
                eng_log.addHandler(chunk_log)
                eng_log.setLevel(logging.INFO)
                try:
                    res, ran = counted("12b", lambda: eng_m.run(
                        months, N_11A, reduced=reduced))
                finally:
                    eng_log.removeHandler(chunk_log)
                    eng_log.setLevel(old_level)
                stats = chunk_log.stats[-1]
                diff = _differing_fields(res, ref)
                print(f"[12b] {N_11A:,} paths, {'reduced' if reduced else 'raw'}, "
                      f"mesh of {mesh.size} at 2**20 per shard: {stats['chunks']} "
                      f"chunks, {stats['band_passes']} band passes, "
                      f"{ran['full']} full launches, wall {stats['wall_s']:.3f} s; "
                      f"fields differing from the unchunked single-device run: "
                      f"{diff or 'none'}")
                if diff or stats["chunks"] != 2 or stats["resident"]:
                    raise AssertionError("[12b] the chunked meshed run differs")
                del res, ref
        finally:
            if old_env is None:
                os.environ.pop("MCRT_MAX_DEVICE_PATHS", None)
            else:
                os.environ["MCRT_MAX_DEVICE_PATHS"] = old_env
        got_g, ran = counted("12b", lambda: run_scenario_grid(
            configs, gmonths, N_FULL, seed=SEED, device="cuda", mesh=mesh))
        want_g = run_scenario_grid(configs, gmonths, N_FULL, seed=SEED,
                                   device="cuda")
        bad = [k for k, a, b in zip(want_g._fields, got_g, want_g)
               if not np.array_equal(a, b)]
        print(f"[12b] run_scenario_grid(mesh) on the 16-row chunk: {ran['grid']} "
              f"launches; fields differing from phase 6's chunk statistics: "
              f"{bad or 'none'}")
        if bad:
            raise AssertionError("[12b] the meshed grid differs")

    # 12c: process groups on the card.
    with device_timer("12c"):
        args = ["--search-paths", str(N_FULL), "--paths", str(N_FULL),
                "--chunked-paths", str(N_12_CHUNKED),
                "--chunk-budget", str(BUDGET_12_CHUNKED),
                "--overrides", json.dumps({"seed": SEED})]
        t0 = time.perf_counter()
        pair = _mesh_children(args, 2, "gloo", MESH_SHARDS // 2)
        nccl = _mesh_children(args, 1, "nccl", MESH_SHARDS)
        try:
            pair_res = _collect_children("12c", pair)
            nccl_res = _collect_children("12c", nccl)
        finally:
            for p in pair + nccl:
                if p.poll() is None:
                    p.kill()
                    p.communicate(timeout=60)
        wall = time.perf_counter() - t0
        single = Engine(cfg, device="cuda").run(months, N_FULL)
        for r in pair_res + nccl_res:
            answers = {k: r[k] for k in ("search", "raw", "reduced", "chunked")}
            bad = [k for k in answers if answers[k] != report["12b"][k]]
            shards_ok = all(
                s["final_balance"] == dist_worker.digest(
                    single.final_balance[s["start"]:s["start"] + s["paths"]])
                for s in r["shards"])
            print(f"[12c] {r['backend']} process {r['process']}/"
                  f"{r['num_processes']} ({len(r['shards'])} of {r['global_shards']} "
                  f"shards, first paths {[s['start'] for s in r['shards']]}): "
                  f"search {r['search']['months']} months, "
                  f"{r['raw']['successes']:,} successful paths; answers "
                  f"differing from the single-process run: {bad or 'none'}; its "
                  f"shards' final balances bit-equal to the single-device run: "
                  f"{shards_ok}")
            if bad or not shards_ok:
                raise AssertionError("[12c] a process group's run differs")
        if [r["coordinator"] for r in pair_res] != [True, False]:
            raise AssertionError("[12c] the pair has no single coordinator")
        print(f"[12c] 2 gloo processes x {MESH_SHARDS // 2} shards and 1 nccl "
              f"process x {MESH_SHARDS} shards, all on cuda:0 at once: wall "
              f"{wall:.1f} s")
        times["12c_children_wall_s"] = wall

    # 12d: a mixed-Statics batch (three Statics, mixed W).
    with device_timer("12d"):
        base = {}
        rows = [(base, 231), (dict(market_crashes=CRASHES), 231), (base, 200),
                (dict(longevity=LONGEVITY), 180), (dict(market_crashes=CRASHES), 250),
                (dict(longevity=LONGEVITY), 231)]
        bconfigs = [_config(**dict(over)) for over, _ in rows]
        bmonths = [w for _, w in rows]
        got_b, ran = counted("12d", lambda: run_scenario_batch(
            bconfigs, bmonths, N_FULL, seed=SEED, device="cuda"))
        bad = []
        for i, (c, w) in enumerate(zip(bconfigs, bmonths)):
            alone = run_scenario_grid([c], [w], N_FULL, seed=SEED, device="cuda")
            bad += [f"row {i} {k}" for k, a, b in zip(alone._fields, got_b, alone)
                    if not np.array_equal(a[i], b[0])]
        print(f"[12d] run_scenario_batch, {len(rows)} rows (config.json, + crashes, "
              f"+ longevity; W {bmonths}) at 1M: {ran['grid']} grid launches; "
              f"success % {np.round(got_b.success_probability, 3).tolist()}; "
              f"fields differing from each row alone: {bad or 'none'}")
        if ran["grid"] != 3 or bad:
            raise AssertionError("[12d] the mixed batch differs")
    walls = phase_timings()
    times["walls_s"] = {k: v["total_s"] for k, v in walls.items()}
    print("[12] phase walls (utils.profiling.device_timer): " + ", ".join(
        f"{k} {v['total_s']:.2f} s" for k, v in walls.items()))
    print(f"[12] launches on the mesh path: {mesh_path}")


def phase_tools(report):
    """13: the tools of hosts/ on the card."""
    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (
        run_scenario_grid,
    )
    from monte_carlo_retirement_tpu_torch.hosts import (
        correlation_sweep,
        edge_sweep,
        fuzz,
        scenario_grid_demo,
    )

    launches = report["launches"]
    tools = report["launches_tools"] = {}
    walls = report["tool_walls"] = {}

    def counted(tag, fn, need):
        """One drive: counters reset before, read after, no plain version
        allowed, each kernel of ``need`` launched."""
        ck.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if any(plain.values()) or not all(ran[k] for k in need):
            raise AssertionError(f"[{tag}] launches {ran}, plain calls {plain}")
        for name, count in ran.items():
            launches[name] = launches.get(name, 0) + count
            tools[name] = tools.get(name, 0) + count
        return out, ran

    edges = edge_sweep.edge_configs()
    cases = [fuzz.trial_case(fuzz.case_seed(FUZZ_SEED, i)) for i in range(FUZZ_TRIALS)]
    statics = [ck.statics_from_config(cfg)
               for cfg in [c for _, c, _ in edges] + [c for c, _ in cases]]
    built, walls["nvcc"] = fuzz.build_libraries(statics)
    print(f"[13] {built} month-loop libraries built for the {len(set(statics))} "
          f"Statics of the edge sweep and the campaign in {walls['nvcc']:.1f} s "
          f"(one nvcc each, started together)")

    # 13a: the edge sweep.
    t0 = time.perf_counter()
    for name, cfg, w in edges:
        out, ran = counted("13a", lambda: edge_sweep.sweep_edge(cfg, device="cuda"),
                           ("probe", "full"))
        check = edge_sweep.check_edge(cfg, w, device="cuda")
        print(f"[13a] {name:34s} probes {[round(p, 1) for p in out['probes']]} "
              f"success {out['run'].success_probability:.1f}%; launches {ran}; "
              f"kernels at W={w} vs {check['reference']} plain: "
              f"{fuzz.describe(check)}")
        if out["failed"] or not check["ok"]:
            raise AssertionError(f"[13a] {name}: {out['failed']} {check}")
    walls["edges"] = time.perf_counter() - t0
    print(f"[13a] {len(edges)} edge scenarios finite and in range, every kernel "
          f"agreeing with its plain version, in {walls['edges']:.1f} s")

    # 13b: the campaign (its launches are comparisons: uncounted).
    ck.reset_counts()
    camp = fuzz.run_campaign(FUZZ_TRIALS, FUZZ_SEED, device="cuda",
                             log=lambda line: print(f"[13b] {line}"))
    if camp["failed_seed"] is not None:
        raise AssertionError(f"[13b] the trial of seed {camp['failed_seed']} failed")
    walls["fuzz"] = camp["wall_s"]
    rate = camp["clean"] / camp["wall_s"]
    print(f"[13b] CLEAN: {camp['clean']} trials x {camp['paths']:,} paths in "
          f"{camp['wall_s']:.1f} s ({rate:.3f} trials/s; comparison launches "
          f"{dict(ck.LAUNCHES)}); worst per kernel: " + ", ".join(
              f"{k} flag mismatch {v['flags']:.2e}, q999 final-balance error "
              f"{v['q999']:.2e}" for k, v in camp["worst"].items())
          + f"; paths skipped beyond $1e9: {camp['skipped']} of "
          f"{camp['clean'] * camp['paths']:,}; extension mix {camp['mix']}")
    if min(camp["mix"].values()) < FUZZ_MIN_EACH:
        raise AssertionError(f"[13b] an extension ran in fewer than "
                             f"{FUZZ_MIN_EACH} trials: {camp['mix']}")
    report["fuzz"] = camp

    # 13c: hosts/bench.py in its own process.
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.hosts.bench"], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=600)
    walls["bench"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[13c] hosts/bench.py exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    sim_ms, full_ms = report["times"]["simulate"], report["times"]["full_summarize"]
    print(f"[13c] hosts/bench.py ({walls['bench']:.1f} s with its start): {json.dumps(bench)}")
    print(f"[13c]   simulate + success mean {bench['value']:.3f} ms vs phase 6's "
          f"simulate {sim_ms:.3f} ms; full + reductions {bench['full_stats_ms']:.3f} "
          f"ms vs phase 6's full + summarize {full_ms:.3f} ms")
    if not (set(bench) == BENCH_KEYS
            and abs(bench["value"] - sim_ms) <= BENCH_SIM_RTOL * sim_ms
            and 0.0 <= bench["success_rate_pct"] <= 100.0):
        raise AssertionError("[13c] the bench line is malformed or off phase 6")
    report["bench"] = bench

    # 13d: the two sweeps.
    t0 = time.perf_counter()
    (grid, demo_s), ran = counted("13d", lambda: scenario_grid_demo.run_demo(
        N_FULL, GRID_SIDE, SEED, "cuda"), ("grid",))
    exact = np.array_equal(grid.ravel(), report["grid_256"])
    printed = [round(float(v), 2) for v in grid.ravel()] == report["grid_8a"].ravel().tolist()
    print(f"[13d] scenario_grid_demo, 256 x {N_FULL:,} paths at seed {SEED}: "
          f"{demo_s:.2f} s, launches {ran}; success grid equal to phase 6's "
          f"run_scenario_grid: {exact}, to phase 8a's payload (2 decimals): {printed}")
    if not (exact and printed and ran["grid"] == GRID_SIDE):
        raise AssertionError("[13d] the demo's grid differs from phases 6 and 8a")
    sweep, ran = counted("13d", lambda: correlation_sweep.run_sweep(device="cuda"),
                         ("grid",))
    bad = []
    for i, cfg in enumerate(correlation_sweep.sweep_configs()):
        alone = run_scenario_grid([cfg], [correlation_sweep.W],
                                  correlation_sweep.N_PATHS,
                                  seed=correlation_sweep.SEED, device="cuda")
        bad += [f"row {i} {k}" for k, a, b in zip(alone._fields, sweep, alone)
                if not np.array_equal(a[i], b[0])]
    print(f"[13d] correlation_sweep, rho {correlation_sweep.RHOS.tolist()} at W="
          f"{correlation_sweep.W}: launches {ran}; success % "
          f"{np.round(sweep.success_probability, 2).tolist()}; fields differing "
          f"from each row alone: {bad or 'none'}")
    if bad or ran["grid"] != 1:
        raise AssertionError("[13d] the correlation sweep differs")
    walls["sweeps"] = time.perf_counter() - t0

    # 13e: the README's library snippet, on the card.
    import monte_carlo_retirement_tpu_torch as mcrt

    def snippet():
        config = mcrt.Config(**mcrt.load_config_from_json(
            os.path.join(REPO, "config.json")))
        sim = mcrt.RetirementMonteCarloSimulator(config, device="cuda")
        months, prob, _curve = sim.find_minimum_working_months(verbose=False)
        sim.use_final_seeds()
        summary_df, *_ = sim.run_monte_carlo_simulations(
            months, config.num_simulations_main)
        return months, prob, sim._success_probability(summary_df)

    (months, prob, success), ran = counted("13e", snippet, ("probe", "full"))
    print(f"[13e] the README's library snippet (device='cuda'): {months} months "
          f"at {prob:.2f}%, final success {success:.2f}%; launches {ran}")
    if not (months >= 0 and 0.0 <= success <= 100.0):
        raise AssertionError("[13e] the snippet's answer is out of range")
    print("[13] walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f"; launches on the tools' path: {tools}")


def phase_scan(report):
    """14: the scan engine on the card: JAX's threefry scan as its kernels."""
    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.simulator import (
        RetirementMonteCarloSimulator,
    )
    from monte_carlo_retirement_tpu_torch.hosts import (
        cross_backend_check,
        scaling_demo,
    )
    from monte_carlo_retirement_tpu_torch.models.retirement import SimParams
    from monte_carlo_retirement_tpu_torch.ops import shocks, threefry

    scan = report["scan"] = {}

    # 14a: threefry words and uniforms bit-equal card vs CPU; normals.
    t0 = time.perf_counter()
    months = (1, 600, shocks.JUMP_FOLD_OFFSET + 5, shocks.MORT_FOLD_OFFSET)
    compared = 0
    for seed in KEYS_14A:
        stream = shocks.stream_keys(seed)[1]
        for m in months:
            key = threefry.fold_in(stream, m)
            for a, b in zip(threefry.random_words(key, SHAPE_14A, device="cuda"),
                            threefry.random_words(key, SHAPE_14A)):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"[14a] words differ: seed {seed} month {m}")
            for dt in (torch.float32, torch.float64):
                u = threefry.uniform(key, SHAPE_14A, dt, device="cuda")
                if not torch.equal(u.cpu(), threefry.uniform(key, SHAPE_14A, dt)):
                    raise AssertionError(f"[14a] uniforms differ: seed {seed} "
                                         f"month {m} {dt}")
            compared += 1
    normal_err = {}
    key = threefry.fold_in(shocks.stream_keys(SEED)[1], 1)
    for dt in (torch.float32, torch.float64):
        a = threefry.normal(key, SHAPE_14A, dt, device="cuda").cpu()
        b = threefry.normal(key, SHAPE_14A, dt)
        ulps = ((a - b).abs() / torch.from_numpy(np.spacing(b.abs().numpy()))).max()
        normal_err[str(dt)] = ((a - b).abs().max().item(), ulps.item())
        if not (torch.isfinite(a).all() and ulps <= 64):
            raise AssertionError(f"[14a] normals {dt}: {normal_err[str(dt)]}")
    scan["normals_card_vs_cpu"] = normal_err
    print(f"[14a] threefry words (y0, y1) and float32/float64 uniforms of "
          f"{SHAPE_14A} draws bit-equal card vs CPU for {compared} keys (main "
          f"seeds {list(KEYS_14A)} x months {list(months)}); normals card vs "
          f"CPU (max abs, max ulps): " + ", ".join(
              f"{k} {v[0]:.3e} / {v[1]:.0f}" for k, v in normal_err.items())
          + f"; {time.perf_counter() - t0:.1f} s")

    # 14b: the scan kernels vs their plain chain on the card.
    from monte_carlo_retirement_tpu_torch.engine import kernel
    from monte_carlo_retirement_tpu_torch.hosts import fuzz

    t_scan = ((max(ROWS_14B) + 12 * R_14B + 59) // 60) * 60
    L = 1 + t_scan // 12
    key = shocks.stream_keys(SEED)[1]
    scan_err = 0.0
    tracked = ("start_balance", "years_to_ruin", "first_year_gross",
               "first_year_real_gross", "inflation_at_retirement",
               "trajectory", "price_levels", "withdrawal_rates")
    for label, over, offset in (("config.json", {}, 0),
                                ("all-on", ALL_ON, OFFSET_14B)):
        cfg = _config(retirement_years=R_14B, **dict(over))
        params = SimParams.from_config(cfg, device="cuda")
        for dtype, n in ((torch.float64, N_14B), (torch.float32, N_14B_F32)):
            rows, st = kernel.scan_block(params, ROWS_14B, R_14B, dtype,
                                         **_scan_flags(cfg))
            one, _ = kernel.scan_block(params, [W_14B], R_14B, dtype, statics=st)
            args = (R_14B, n)
            kw = dict(t_scan=t_scan, row_offset=offset)
            k, p = (f(rows, st, *args, key, **kw)
                    for f in (ck.scan_rows, ck.scan_rows_plain))
            kf, pf = (f(one, st, *args, L, key, **kw)
                      for f in (ck.scan_full, ck.scan_full_plain))
            torch.cuda.synchronize()
            every = torch.ones(n, dtype=torch.bool, device="cuda")
            d_pts = float(((k.counts - p.counts).abs().max()).item()) / n * 100
            scan_err = max(scan_err, d_pts)
            what = (f"[14b] {label}{' (antithetic)' if st.antithetic else ''}, "
                    f"{str(dtype)[6:]}, {n:,} paths from global row {offset}, "
                    f"R={R_14B}")
            if dtype == torch.float64:
                same = (torch.equal(k.success, p.success)
                        and torch.equal(kf["success"], pf["success"]))
                a = torch.cat([k.final_balance.reshape(-1), kf["final_balance"]])
                b = torch.cat([p.final_balance.reshape(-1), pf["final_balance"]])
                ok = b < BIG_14B
                rel = float(((a - b).abs() / b.abs().clamp_min(1.0))[ok].max())
                worst = 0.0
                for name in tracked:
                    x, y = kf[name], pf[name]
                    if not torch.equal(x.isnan(), y.isnan()):
                        raise AssertionError(f"{what}: NaN pattern of {name}")
                    rows_ok = (pf["final_balance"] < BIG_14B).reshape(
                        (-1,) + (1,) * (y.ndim - 1))
                    sel = rows_ok.expand_as(y) & ~y.isnan()
                    worst = max(worst, float(((x - y).abs() / y.abs().clamp_min(
                        1.0))[sel].max()) if bool(sel.any()) else 0.0)
                bits = float((a == b).double().mean())
                scan[f"parity_{label}_f64"] = {
                    "flags_equal": same, "final_rel": rel, "tracked_rel": worst,
                    "bit_equal_finals": bits, "skipped": int((~ok).sum())}
                print(f"{what}: scan_rows_kernel (W {list(ROWS_14B)}) and "
                      f"scan_full_kernel (W={W_14B}, L={L}) vs their plain chain: "
                      f"success flags equal {same}, final balances max rel "
                      f"{rel:.2e} (bit-equal share {bits:.6f}; beyond $1e9 "
                      f"skipped: {int((~ok).sum())}), tracked fields max rel "
                      f"{worst:.2e} (bound {PARITY_14B:.0e}); success % "
                      f"{(p.counts.double() / n * 100).round(decimals=3).tolist()}")
                if not (same and rel <= PARITY_14B and worst <= PARITY_14B):
                    raise AssertionError(f"{what}: the scan kernels differ")
            else:
                rows_gate = fuzz.compare_rows(k, p, every)
                full_gate = fuzz.compare_full(kf, pf, every, st.guardrails,
                                              dust=False)
                scan[f"gate_{label}_f32"] = {"rows": rows_gate, "full": full_gate}
                print(f"{what}: scan_rows_kernel vs plain chain, gate (b): "
                      f"{_gate(rows_gate)}")
                print(f"{what}: scan_full_kernel vs plain chain, gate (b) "
                      f"without the $5 allowance: {_gate(full_gate)}")
                if not (rows_gate["ok"] and full_gate["ok"]):
                    raise AssertionError(f"{what}: the scan kernels fail gate (b)")
    report["scan_err"] = scan_err

    # 14c: the main path through the scan kernel: a float64 engine on the card.
    def float64_main_path(n_search, n_final):
        over = {} if n_search is None else dict(
            num_simulations_search=n_search, num_simulations_main=n_final)
        cfg = _config(**over)
        ck.reset_counts()
        t0 = time.perf_counter()
        sim = RetirementMonteCarloSimulator(cfg, dtype=torch.float64, device="cuda")
        backend = sim.engine._resolve_backend(None, "probe")
        months, prob, curve = sim.find_minimum_working_months(verbose=False)
        t_search = time.perf_counter() - t0
        sim.use_final_seeds()
        t1 = time.perf_counter()
        summary_df, traj_df, *_ = sim.run_monte_carlo_simulations(
            months, cfg.num_simulations_main)
        t_final = time.perf_counter() - t1
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if (backend != "scan" or ran["scan"] < 1 or any(plain.values())
                or any(v for k, v in ran.items() if k != "scan")):
            raise AssertionError(f"[14c] not the scan kernel: {backend} {ran} "
                                 f"{plain}")
        success = sim._success_probability(summary_df)
        if not (np.isfinite(traj_df.to_numpy()).all()
                and np.isfinite(summary_df["Final Balance"]).all()):
            raise AssertionError("[14c] non-finite results")
        return (cfg, months, prob, len(curve), success, t_search, t_final,
                ran["scan"])

    cfg, months, prob, cands, success, t_s, t_f, ran_a = float64_main_path(
        None, None)
    got = (months, round(prob, 3), round(success, 1))
    print(f"[14c] Engine(dtype=float64, device='cuda') picks the scan; "
          f"config.json at its own sizes ({cfg.num_simulations_search} search, "
          f"{cfg.num_simulations_main} final paths): {months} months at "
          f"{prob:.3f}% ({cands} candidates), final success {success:.1f}% "
          f"(the JAX engine on the CPU, x64: {JAX_CPU_ANSWER}); search "
          f"{t_s:.2f} s, final {t_f:.2f} s; scan kernel launches {ran_a}, "
          f"plain calls 0")
    if got != JAX_CPU_ANSWER:
        raise AssertionError(f"[14c] {got} != the JAX answer {JAX_CPU_ANSWER}")
    cfg, months, prob, cands, success, t_s, t_f, ran_b = float64_main_path(
        N_FULL, N_FULL)
    margin = 150.0 / math.sqrt(N_FULL)
    kernel_months = report["5b"]["months"]
    scan.update(months=months, search_pct=prob, success_pct=success,
                search_s=t_s, final_s=t_f, paths=N_FULL)
    report["scan_launches"] = {"main": ran_a + ran_b}
    print(f"[14c] the main path through the scan kernel, float64 on the card, "
          f"{N_FULL:,} search + {N_FULL:,} final paths: {months} months at "
          f"{prob:.3f}% ({cands} candidates), final success {success:.3f}%; "
          f"search wall {t_s:.2f} s, final-run wall {t_f:.2f} s; scan kernel "
          f"launches {ran_b}, plain calls 0 (the kernels' float32 search, "
          f"phase 5b: {kernel_months} months)")
    if not (success >= cfg.target_probability - margin
            and abs(months - kernel_months) <= MONTHS_14C):
        raise AssertionError("[14c] the scan's answer is off")
    phase_scan_times(report)

    # 14d: hosts/cross_backend_check.py on the card.
    t0 = time.perf_counter()
    ck.reset_counts()
    rows = cross_backend_check.check(device="cuda")
    report["scan_launches"]["cross_backend"] = ck.LAUNCHES["scan"]
    if ck.LAUNCHES["scan"] != len(rows) or ck.PLAIN_CALLS["scan"]:
        raise AssertionError(f"[14d] the scan did not run its kernel: "
                             f"{ck.LAUNCHES} {ck.PLAIN_CALLS}")
    scan["cross_backend"] = [r._asdict() for r in rows]
    for r in rows:
        print(f"[14d] {r.name:24s} scan {r.scan_pct:8.3f}%  kernel "
              f"{r.kernel_pct:8.3f}%  diff {r.diff:7.3f}  3 sigma "
              f"{r.three_sigma:6.3f}  {'ok' if r.ok else 'MISMATCH'}")
    print(f"[14d] {cross_backend_check.N_PATHS:,} paths per engine, "
          f"{time.perf_counter() - t0:.1f} s")
    if not all(r.ok for r in rows):
        raise AssertionError("[14d] a case is beyond max(3 sigma, 0.5) points")

    # 14e: hosts/scaling_demo.py on the card.
    t0 = time.perf_counter()
    ck.reset_counts()
    lines = scaling_demo.demo(device="cuda")
    report["scan_launches"]["scaling"] = ck.LAUNCHES["scan"]
    if not ck.LAUNCHES["scan"] or ck.PLAIN_CALLS["scan"]:
        raise AssertionError(f"[14e] the scan did not run its kernel: "
                             f"{ck.LAUNCHES} {ck.PLAIN_CALLS}")
    print("[14e] shards are cuda:0 repeated: they run in turn on one card, so "
          "the speed-up is not scaling across cards")
    for ln in lines:
        print(f"[14e] {ln.engine:6s} {ln.shards} shard(s): {ln.best_ms:8.1f} ms"
              f"   speedup {ln.speedup:4.2f}x   success {ln.success_pct:.2f}%")
    scan["scaling"] = [ln._asdict() for ln in lines]
    for engine in ("scan", "kernel"):
        if len({ln.success_pct for ln in lines if ln.engine == engine}) != 1:
            raise AssertionError(f"[14e] the {engine}'s success moved with shards")
    print(f"[14e] {time.perf_counter() - t0:.1f} s")


def phase_scan_times(report):
    """14c's times: the scan kernels at the probe kernel's shape (16 x 1M x
    600, phase 6's workload) and the full kernel's (1M x 600), float32 and
    float64, CUDA events, beside their bounds and one call of the plain
    chain in float32, whose outputs the kernels' are held to by gate (b);
    then the float64 scan_rows_kernel at 16 rows against one plain-chain
    call (flags equal, finals within PARITY_14B)."""
    import torch
    from monte_carlo_retirement_tpu_torch.engine import bound
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine import kernel
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine
    from monte_carlo_retirement_tpu_torch.hosts import fuzz

    cfg = _config(retirement_years=50, initial_balance=1_500_000.0,
                  monthly_expenses=4_000.0)
    eng = Engine(cfg, device="cuda")
    n, R = N_FULL, eng.retirement_years
    months16 = list(range(16))
    T = 12 * R
    t_probe, t_full = eng._t_scan(max(months16)), eng._t_scan(0)
    L = 1 + t_full // 12
    search, final = eng._key("search"), eng._key("final")
    times, bounds, blocks = {}, {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        rows, st = kernel.scan_block(eng.params, months16, R, dtype,
                                     **_scan_flags(cfg))
        one, _ = kernel.scan_block(eng.params, [0], R, dtype, statics=st)
        blocks[tag] = rows, st
        elem = rows.fp.element_size()
        reps = 5 if dtype == torch.float32 else 3
        times[f"probe_{tag}"] = _time_ms(lambda: ck.scan_rows(
            rows, st, R, n, search, t_scan=t_probe), repeats=reps)
        times[f"full_{tag}"] = _time_ms(lambda: ck.scan_full(
            one, st, R, n, L, final, t_scan=t_full), repeats=reps)
        plan = ck.tile_plan(16, n, st, "probe", elem)
        bounds[f"probe_{tag}"] = _bound(report, "probe", ck.tile_work(
            plan, months16, [w + T for w in months16], t_probe - T),
            2 * 16 * n * elem, f"scan {tag}")
        bounds[f"full_{tag}"] = _bound(report, "full", bound.full_work(
            n, 0, T, t_full - T), elem * n * (7 + 2 * L + R), f"scan {tag}")
        if dtype == torch.float32:
            # One call each: the chain is a host-bound stream of torch ops.
            plain = {}
            times["probe_plain"] = _time_ms(lambda: plain.update(
                rows=ck.scan_rows_plain(rows, st, R, n, search, t_scan=t_probe)),
                repeats=1, warm=False)
            times["full_plain"] = _time_ms(lambda: plain.update(
                full=ck.scan_full_plain(one, st, R, n, L, final, t_scan=t_full)),
                repeats=1, warm=False)
            out = ck.scan_rows(rows, st, R, n, search, t_scan=t_probe)
            out_full = ck.scan_full(one, st, R, n, L, final, t_scan=t_full)
            every = torch.ones(n, dtype=torch.bool, device="cuda")
            rows_gate = fuzz.compare_rows(out, plain["rows"], every)
            full_gate = fuzz.compare_full(out_full, plain["full"], every,
                                          st.guardrails, dust=False)
            report["scan"]["gate_main_f32"] = {"rows": rows_gate,
                                               "full": full_gate}
            print(f"[14c] scan kernels at phase 6's shapes ({_statics_label(st)}; "
                  f"probe: 16 rows, months 0-15, t_scan {t_probe}; full: W=0, "
                  f"L={L}; CUDA events, min of {reps}; plain chain: one call), "
                  f"float32 success at W=0 {out.counts[0].item() / n * 100:.3f}%, "
                  f"on {report['card']}:")
            print(f"[14c]   float32 scan_rows_kernel, 16 x {n:,}, vs the plain "
                  f"chain's call, gate (b): {_gate(rows_gate)}")
            print(f"[14c]   float32 scan_full_kernel, {n:,}, vs the plain chain's "
                  f"call, gate (b) without the $5 allowance: {_gate(full_gate)}")
            if not (rows_gate["ok"] and full_gate["ok"]):
                raise AssertionError("[14c] the float32 scan kernels at the main "
                                     "path's shapes fail gate (b)")
            del plain, out, out_full
    for what, shape in (("probe", f"16 x {n:,} x 600"), ("full", f"{n:,} x 600")):
        print(f"[14c]   scan {what} {shape}: float32 {times[f'{what}_f32']:.3f} ms "
              f"(bound {bounds[f'{what}_f32'][0]:.3f} ms, "
              f"{bounds[f'{what}_f32'][1]}, share "
              f"{bounds[f'{what}_f32'][0] / times[f'{what}_f32'] * 100:.1f}%) | "
              f"float64 {times[f'{what}_f64']:.3f} ms (bound "
              f"{bounds[f'{what}_f64'][0]:.3f} ms, share "
              f"{bounds[f'{what}_f64'][0] / times[f'{what}_f64'] * 100:.1f}%) | "
              f"plain chain float32 {times[f'{what}_plain']:.1f} ms "
              f"(the {what} kernel: {report['times'][what]:.3f} ms)")
    report["scan_times"], report["scan_bounds"] = times, bounds

    # The float64 probe's block (16 rows per block) against its plain chain.
    rows, st = blocks["f64"]
    m = N_14C_F64
    plan = ck.tile_plan(16, m, st, "probe", 8)
    k = ck.scan_rows(rows, st, R, m, search, t_scan=t_probe)
    p = ck.scan_rows_plain(rows, st, R, m, search, t_scan=t_probe)
    same = torch.equal(k.success, p.success) and torch.equal(k.counts, p.counts)
    ok = p.final_balance < BIG_14B
    rel = float(((k.final_balance - p.final_balance).abs()
                 / p.final_balance.abs().clamp_min(1.0))[ok].max())
    bits = float((k.final_balance == p.final_balance).double().mean())
    report["scan"]["parity_main_f64"] = {
        "paths": m, "rows_per_block": plan.rows_per_block,
        "flags_equal": same, "final_rel": rel, "bit_equal_finals": bits,
        "skipped": int((~ok).sum())}
    print(f"[14c]   float64 scan_rows_kernel, 16 x {m:,} (the main path's block: "
          f"{plan.rows_per_block} rows x {ck.WARP} paths, {plan.months_per_chunk} "
          f"months, {plan.smem_bytes} B) vs one plain-chain call: success flags "
          f"equal {same}, final balances max rel {rel:.2e} (bit-equal share "
          f"{bits:.6f}; beyond $1e9 skipped: {int((~ok).sum())}; bound "
          f"{PARITY_14B:.0e})")
    if not (same and rel <= PARITY_14B):
        raise AssertionError("[14c] the float64 scan_rows_kernel differs from its "
                             "plain chain at the main path's block")


def _row_15(over, **extra):
    from monte_carlo_retirement_tpu_torch.config import Config

    over = dict(over)
    pension = over.pop("pension", {})
    raw = _raw_config(**over, **extra)
    raw["other_income_streams"][0].update(pension)
    return Config(**raw)


def _rel(a, b):
    """|a - b| relative to |b|, or to $1 / 1 where |b| is smaller."""
    import numpy as np

    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def phase_scan_routes(report):
    """15: run_scenario_batch and sensitivity_ad on the scan (JAX's routes):
    the batch and the finite difference through the scan kernel, the AD pass
    through the JVP kernel on the scan's draws."""
    import numpy as np
    import torch
    from monte_carlo_retirement_tpu_torch.engine import _build
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.scenario_batch import (
        run_scenario_batch,
    )
    from monte_carlo_retirement_tpu_torch.engine.sensitivity import (
        DEFAULT_PARAMS,
        ad_inputs,
        sensitivity_ad,
        sensitivity_fd,
    )

    out = report["scan_routes"] = {}

    def scan_kernel_only(tag):
        """The scan ran its kernel and nothing else; its launches."""
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if (not ran["scan"] or any(plain.values())
                or any(v for k, v in ran.items() if k != "scan")):
            raise AssertionError(f"[{tag}] not the scan kernel: {ran} {plain}")
        return ran["scan"]

    def ad_kernel_only(tag):
        """The AD pass ran the JVP kernel and nothing else; its launches."""
        ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
        if (ran["ad"] < 1 or any(plain.values())
                or any(v for k, v in ran.items() if k != "ad")):
            raise AssertionError(f"[{tag}] not the JVP kernel: {ran} {plain}")
        return ran["ad"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # 15a: the batch's scan route.
    cfgs = [_row_15(over, retirement_years=R_14B,
                    monthly_expenses=EXPENSES_15_PARITY)
            for _, over in ROWS_15]
    months = [W_15_PARITY + d for d in OFFSETS_15]
    ck.reset_counts()
    card, t_card = timed(lambda: run_scenario_batch(
        cfgs, months, N_14B, seed=SEED, device="cuda", backend="scan",
        dtype=torch.float64))
    scan_kernel_only("15a")
    cpu, t_cpu = timed(lambda: run_scenario_batch(
        cfgs, months, N_14B, seed=SEED, device="cpu", backend="scan",
        dtype=torch.float64))
    # Survivor counts: the card divides by n as a product with 1 / n, so a
    # percentage may differ from the CPU's in its last bit.
    survivors = [np.rint(r.success_probability * N_14B / 100.0).astype(int)
                 for r in (card, cpu)]
    same = np.array_equal(*survivors)
    worst = max(_rel(a, b) for a, b in zip(card, cpu))
    out["batch_f64"] = {"survivors_equal": same, "stats_rel": worst,
                        "survivors": survivors[1].tolist()}
    print(f"[15a] run_scenario_batch(backend='scan') float64, {len(cfgs)} rows "
          f"(" + "; ".join(label for label, _ in ROWS_15) + f"), {N_14B:,} "
          f"paths, R={R_14B}, W={months}: card (scan kernel) vs CPU (plain "
          f"chain) survivors equal {same} "
          f"({survivors[1].tolist()}), statistics (success % and sigma too) "
          f"max rel {worst:.2e} (bound {PARITY_15A:.0e}); card {t_card:.1f} s, "
          f"CPU {t_cpu:.1f} s")
    if not (same and worst <= PARITY_15A):
        raise AssertionError("[15a] the card's scan batch differs from the CPU's")

    cfgs = [_row_15(over) for _, over in ROWS_15]
    months = [GRID_W + d for d in OFFSETS_15]
    groups = len({ck.statics_from_config(c) for c in cfgs})
    t0 = time.perf_counter()
    _, built = _build.build_many(list({ck.statics_from_config(c): 0
                                       for c in cfgs}))
    print(f"[15a] {built} more month-loop libraries for the rows' {groups} "
          f"Statics in {time.perf_counter() - t0:.1f} s")
    ck.reset_counts()
    scan, t_scan = timed(lambda: run_scenario_batch(
        cfgs, months, N_FULL_15, seed=SEED, device="cuda", backend="scan"))
    report["scan_launches"]["batch"] = scan_kernel_only("15a")
    ck.reset_counts()
    kern, t_kern = timed(lambda: run_scenario_batch(
        cfgs, months, N_FULL_15, seed=SEED, device="cuda"))
    ran, plain = dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS)
    if ran.get("grid") != groups or any(plain.values()):
        raise AssertionError(f"[15a] the grid-kernel route: {ran} {plain}")
    out["batch_f32"] = rows = []
    ok = True
    for (label, _), w, a, b in zip(ROWS_15, months, scan.success_probability,
                                   kern.success_probability):
        p = (a + b) / 200.0
        se3 = 3.0 * math.sqrt(2.0 * p * (1.0 - p) / N_FULL_15) * 100.0
        row_ok = abs(a - b) <= max(se3, 0.5)
        ok &= row_ok
        rows.append({"row": label, "W": w, "scan_pct": a, "kernel_pct": b,
                     "three_sigma": se3})
        print(f"[15a]   {label:22s} W={w}  scan {a:8.3f}%  kernel {b:8.3f}%  "
              f"diff {a - b:7.3f}  3 sigma {se3:6.3f}  "
              f"{'ok' if row_ok else 'MISMATCH'}")
    out.update(batch_scan_s=t_scan, batch_kernel_s=t_kern)
    print(f"[15a] float32, {N_FULL_15:,} paths, R=50: scan route wall "
          f"{t_scan:.2f} s ({report['scan_launches']['batch']} scan kernel "
          f"launches, one per group), grid-kernel route wall {t_kern:.2f} s "
          f"({groups} grid launches)")
    if not ok:
        raise AssertionError("[15a] a row is beyond max(3 sigma, 0.5) points")

    # 15b: sensitivity_ad's scan route, on the JVP kernel.
    cfg = _config(retirement_years=R_14B, monthly_expenses=EXPENSES_15_PARITY)
    parity = lambda dev: sensitivity_ad(
        cfg, W_15_PARITY, num_paths=N_14B, seed=SEED, device=dev,
        backend="scan", dtype=torch.float64)
    ck.reset_counts()
    card, t_card = timed(lambda: parity("cuda"))
    ad_launches = [ad_kernel_only("15b")]
    cpu, t_cpu = timed(lambda: parity("cpu"))
    names = list(cpu["d_mean_final"])
    worst = max(_rel(card["mean_final_balance"], cpu["mean_final_balance"]),
                _rel([card["d_mean_final"][k] for k in names],
                     [cpu["d_mean_final"][k] for k in names]))
    out["ad_f64_rel"] = worst
    print(f"[15b] sensitivity_ad(backend='scan') float64, {N_14B:,} paths, "
          f"R={R_14B}, W={W_15_PARITY}, {len(names)} parameters: card (jvp_kernel,"
          f" {ad_launches[0]} launches) vs CPU (its plain version) value and "
          f"gradients max rel {worst:.2e} (bound {PARITY_15B:.0e}); card "
          f"{t_card:.2f} s, CPU {t_cpu:.1f} s")
    if not worst <= PARITY_15B:
        raise AssertionError("[15b] the card's scan AD differs from the CPU's")

    cfg = _config()
    ck.reset_counts()
    ad, t_ad = timed(lambda: sensitivity_ad(cfg, GRID_W, num_paths=AD_PATHS,
                                            seed=SEED, device="cuda",
                                            backend="scan"))
    ad_launches.append(ad_kernel_only("15b"))
    report["ad_launches"]["scan"] = sum(ad_launches)
    packed, fp_dot, st, draws = ad_inputs(cfg, GRID_W, DEFAULT_PARAMS, SEED,
                                          torch.device("cuda"), "scan",
                                          torch.float32)
    kernel_ms = _time_ms(lambda: ck.simulate_jvp(
        packed, fp_dot, st, cfg.retirement_years, AD_PATHS, **draws), repeats=3)
    checked = ("monthly_expenses", "inv1_returns_mean")
    ck.reset_counts()
    fd, t_fd = timed(lambda: sensitivity_fd(
        cfg, GRID_W, num_paths=AD_PATHS, seed=SEED, params=list(checked),
        rel_step=0.002, abs_step=0.0005, device="cuda", backend="scan"))
    report["scan_launches"]["fd"] = scan_kernel_only("15b")
    fd = {r.param: r.d_mean_final for r in fd}
    grads = ad["d_mean_final"]
    out.update(ad_scan_s=t_ad, fd_scan_s=t_fd, ad_kernel_ms=kernel_ms,
               ad_over_fd={k: grads[k] / fd[k] for k in checked})
    print(f"[15b] sensitivity_ad(backend='scan') float32 at {AD_PATHS:,} paths, "
          f"W={GRID_W} (jvp_kernel, {ad_launches[1]} launches): wall "
          f"{t_ad:.3f} s, the kernel alone {kernel_ms:.3f} ms (CUDA events, "
          f"min of 3; phase 8f's pass on the grid kernel's stream: wall "
          f"{report.get('ad_wall_s', float('nan')):.3f} s); mean final "
          f"balance {ad['mean_final_balance']:.2f}; the scan's CRN central "
          f"difference of {len(checked)} parameters {t_fd:.2f} s")
    for name, g in grads.items():
        extra = (f"  scan FD {fd[name]:>16.6g}  AD/FD {g / fd[name]:.6f}"
                 if name in fd else "")
        print(f"[15b]   {name:<32} AD {g:>16.6g}{extra}")
    close = all(abs(grads[k] / fd[k] - 1.0) <= 0.05 for k in checked)
    if not (all(math.isfinite(g) for g in grads.values()) and close
            and grads["monthly_expenses"] < 0 < grads["inv1_returns_mean"]):
        raise AssertionError("[15b] scan AD gradients are not finite, signed "
                             "or within 5% of the scan's finite difference")


def _rel_rows(got, want) -> float:
    """Each row's largest |got - want| over that row's largest |want|, for
    the worst row."""
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    return float(((got - want).abs() / scale).max())


def phase_jvp(report):
    """16: jvp_kernel against its plain version on the card (float64 to
    round-off on both draw sources, config.json's and the all-on Statics and
    the tie cases; float32 by gate (b)), then its times at phase 8f's shape
    beside its bound, and in float32 one call of the plain version at that
    shape, timed, the kernel held to it by gate (b)."""
    import torch
    from monte_carlo_retirement_tpu_torch.engine import bound
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.cuda_kernel import F
    from monte_carlo_retirement_tpu_torch.engine.sensitivity import (
        DEFAULT_PARAMS,
        ad_inputs,
    )

    dev = torch.device("cuda")
    names = list(DEFAULT_PARAMS)
    out = report["jvp"] = {"float64": [], "float32": []}
    worst_abs = 0.0

    def pair(cfg, w, params, backend, dtype, n, extra=(), row_offset=0):
        """Kernel and plain version on the same block and directions."""
        packed, fp_dot, st, draws = ad_inputs(cfg, w, params, SEED, dev,
                                              backend, dtype)
        if extra:
            onehot = torch.zeros((len(extra), fp_dot.shape[1]), dtype=dtype,
                                 device=dev)
            onehot[range(len(extra)), list(extra)] = 1.0
            fp_dot = torch.cat([fp_dot, onehot])
        if draws:
            draws = dict(draws, row_offset=row_offset)
        R = cfg.retirement_years
        k = ck.simulate_jvp(packed, fp_dot, st, R, n, **draws)
        p = ck.simulate_jvp_plain(packed, fp_dot, st, R, n, **draws)
        torch.cuda.synchronize()
        return k, p, fp_dot.shape[0]

    # 16a-b: float64, the scan's paths from an odd global row.
    parity = [("config.json", _config(retirement_years=R_14B), W_14B, names,
               ()),
              ("all-on", _config(retirement_years=R_14B, **dict(ALL_ON)),
               W_14B, names, ())]
    parity += [(label, cfg, w, params, (F.GR_ADJ, F.GR_FLOOR, F.GR_CAP))
               for label, cfg, w, params in _jvp_cases()[3:]]
    t0 = time.perf_counter()
    for label, cfg, w, params, extra in parity:
        for backend, draws in (("auto", "philox"), ("scan", "threefry")):
            offset = OFFSET_14B if backend == "scan" else 0
            k, p, K = pair(cfg, w, params, backend, torch.float64, N_14B,
                           extra, offset)
            flags = torch.equal(k.success, p.success)
            rel = max(_rel_rows(k.final_balance[None], p.final_balance[None]),
                      _rel_rows(k.tangents, p.tangents))
            worst_abs = max(worst_abs,
                            float((k.final_balance - p.final_balance).abs().max()),
                            float((k.tangents - p.tangents).abs().max()))
            bits = float((k.tangents == p.tangents).double().mean())
            ruined = k.success < 0.5
            zero = bool(torch.all(k.tangents[:, ruined] == 0.0))
            out["float64"].append({"case": label, "draws": draws, "K": K,
                                   "flags_equal": flags, "rel": rel,
                                   "bit_equal_tangents": bits,
                                   "ruined": int(ruined.sum())})
            print(f"[16a] float64 {label}, {draws} (W={w}, R="
                  f"{cfg.retirement_years}, {N_14B:,} paths from global row "
                  f"{offset}, {K} directions = {-(-K // ck.JVP_TK)} "
                  f"launches): flags equal {flags}, finals and tangents max "
                  f"rel {rel:.2e} of each direction's largest (bound "
                  f"{PARITY_15B:.0e}), tangents bit-equal share {bits:.6f}; "
                  f"{int(ruined.sum())} ruined paths, their tangents all 0: "
                  f"{zero}")
            if not (flags and rel <= PARITY_15B and zero):
                raise AssertionError(f"[16a] jvp_kernel differs from its plain "
                                     f"version: {label}, {draws}")
    print(f"[16a] {2 * len(parity)} float64 checks in "
          f"{time.perf_counter() - t0:.1f} s")

    # 16c: float32 at 2**16 paths, phase 8f's scenario, gate (b).
    cfg = _config()

    def gate_b(tag, what, k, p, n):
        mismatch = float((k.success != p.success).double().mean())
        means = [(k.final_balance.double().mean(), p.final_balance.double().mean())]
        means += list(zip(k.tangents.double().mean(dim=1),
                          p.tangents.double().mean(dim=1)))
        rel = max(float((a - b).abs() / b.abs()) for a, b in means)
        out["float32"].append({"draws": what, "paths": n,
                               "flags_mismatch": mismatch, "means_rel": rel})
        print(f"[{tag}] float32 {what}, config.json W={GRID_W}, {n:,} paths, "
              f"{k.tangents.shape[0]} directions: flags mismatch "
              f"{mismatch:.2e} (bound {FLAGS_16:.0e}), mean final and "
              f"gradients max rel {rel:.2e} (bound {MEANS_16:.0e})")
        if not (mismatch < FLAGS_16 and rel <= MEANS_16):
            raise AssertionError(f"[{tag}] float32 jvp_kernel fails gate (b) "
                                 f"on {what} at {n} paths")

    for backend, draws in (("auto", "philox"), ("scan", "threefry")):
        k, p, K = pair(cfg, GRID_W, names, backend, torch.float32, N_16_F32)
        gate_b("16c", draws, k, p, N_16_F32)
    report["jvp_err"] = worst_abs

    # 16d: times at phase 8f's shape, beside the bound; in float32 the plain
    # version once at that shape, the kernel held to it by gate (b).
    times, bounds = report["jvp_times"], report["jvp_bounds"] = {}, {}
    R, w = cfg.retirement_years, GRID_W
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        for backend, draws in (("auto", "philox"), ("scan", "threefry")):
            packed, fp_dot, st, kw = ad_inputs(cfg, w, names, SEED, dev,
                                               backend, dtype)
            K, elem = fp_dot.shape[0], fp_dot.element_size()
            run = lambda: ck.simulate_jvp(packed, fp_dot, st, R, AD_PATHS, **kw)
            times[f"{draws}_{tag}"] = _time_ms(run, repeats=3)
            work = bound.full_work(AD_PATHS, w, w + 12 * R,
                                   acc_cap=w if kw else None)
            bounds[f"{draws}_{tag}"] = _bound(
                report, "jvp", work, elem * (AD_PATHS * (2 + K) + (K + 1)
                                             * fp_dot.shape[1]),
                f"jvp {draws} {tag}")
            if tag == "f32":
                k = run()
                p, times[f"plain_{draws}_f32"] = _once_ms(
                    lambda: ck.simulate_jvp_plain(packed, fp_dot, st, R,
                                                  AD_PATHS, **kw))
                gate_b("16d", draws, k, p, AD_PATHS)
                del k, p
                torch.cuda.empty_cache()
    print(f"[16d] jvp_kernel at phase 8f's shape (config.json, W={w}, R={R}, "
          f"{AD_PATHS:,} paths, {len(names)} directions; CUDA events, min of "
          f"3) on {report['card']}; bound: the draws and the primal once, "
          f"each direction once (op-count units of {len(names)} tangents):")
    for draws in ("philox", "threefry"):
        line = []
        for tag in ("f32", "f64"):
            ms, (b_ms, by) = times[f"{draws}_{tag}"], bounds[f"{draws}_{tag}"]
            line.append(f"{tag} {ms:.3f} ms ({-(-len(names) // ck.JVP_TK)}"
                        f" launches; bound {b_ms:.3f} ms, {by}, share "
                        f"{b_ms / ms * 100:.1f}%)")
        print(f"[16d]   {draws}: " + " | ".join(line) + f" | plain version, "
              f"float32, one call at {AD_PATHS:,} paths: "
              f"{times[f'plain_{draws}_f32']:.1f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import importlib

    importlib.import_module(PKG)  # fails outside a checkout of the repo

    # config.json's soft warning (equity volatility below 5%) would repeat
    # for each of the grid's 256 variants.
    logging.getLogger("mcrt.config").setLevel(logging.ERROR)
    report = {}
    for phase in (phase_build, phase_normals, phase_probe, phase_full,
                  phase_main_path, phase_timings, phase_grid, phase_modes,
                  phase_extensions, phase_server, phase_chunked, phase_mesh,
                  phase_tools, phase_scan, phase_scan_routes, phase_jvp):
        t0 = time.perf_counter()
        phase(report)
        print(f"--- {phase.__name__}: {time.perf_counter() - t0:.1f} s wall")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    times, launches = report["times"], report["launches"]
    main, grid_path, bounds = (report["launches_main"], report["launches_grid"],
                               report["bounds"])
    served, chunked = report["launches_server"], report["launches_chunked"]
    mesh_path, tools = report["launches_mesh"], report["launches_tools"]
    pallas = "monte_carlo_retirement_tpu/engine/pallas_kernel.py"

    def row(name, key, replaces, err, ms, plain, bound_key, **extra):
        return {"name": name, "route": "cuda", "source": CU_SOURCE,
                "replaces": f"{pallas}:{replaces}", "launches": launches[key],
                "launches_main_path": main.get(key, 0),
                "launches_grid_path": grid_path.get(key, 0),
                "launches_server_path": served.get(key, 0),
                "launches_chunked_path": chunked.get(key, 0),
                "launches_mesh_path": mesh_path.get(key, 0),
                "launches_tools_path": tools.get(key, 0),
                "max_abs_err": report[err], "ms": times[ms],
                "plain_ms": times[plain], "bound_ms": bounds[bound_key][0],
                "bound_by": bounds[bound_key][1], "library_ms": None, **extra}

    kernels = [
        row("probe_kernel", "probe", 1325, "probe_err", "probe", "probe_plain",
            "probe", ms_all_on=times["probe_all_on"],
            plain_ms_all_on=times["probe_plain_all_on"],
            bound_ms_all_on=bounds["probe_all_on"][0]),
        row("full_kernel", "full", 1405, "full_err", "full", "full_plain", "full",
            ms_all_on=times["full_all_on"],
            plain_ms_all_on=times["full_plain_all_on"],
            bound_ms_all_on=bounds["full_all_on"][0]),
        row("grid_kernel", "grid", 1567, "grid_err", "grid", "grid_plain", "grid"),
        row("grid_kernel (simulate: one row)", "simulate", 1247, "sim_err",
            "simulate", "simulate_plain", "simulate"),
    ]
    st, sb = report["scan_times"], report["scan_bounds"]
    by_path = report["scan_launches"]
    kernels.append({
        "name": "scan_rows_kernel + scan_full_kernel", "route": "cuda",
        "source": CU_SOURCE, "replaces": SCAN_REPLACES,
        "launches": sum(by_path.values()),
        "launches_main_path": by_path["main"],
        "launches_cross_backend_path": by_path["cross_backend"],
        "launches_scaling_path": by_path["scaling"],
        "launches_batch_path": by_path["batch"],
        "launches_fd_path": by_path["fd"],
        "max_abs_err": report["scan_err"],
        "ms": st["probe_f32"], "ms_float64": st["probe_f64"],
        "plain_ms": st["probe_plain"],
        "bound_ms": sb["probe_f32"][0], "bound_by": sb["probe_f32"][1],
        "bound_ms_float64": sb["probe_f64"][0],
        "ms_full": st["full_f32"], "ms_full_float64": st["full_f64"],
        "plain_ms_full": st["full_plain"], "bound_ms_full": sb["full_f32"][0],
        "bound_ms_full_float64": sb["full_f64"][0],
        "library_ms": None})
    jt, jb, al = report["jvp_times"], report["jvp_bounds"], report["ad_launches"]
    kernels.append({
        "name": "jvp_kernel", "route": "cuda", "source": CU_SOURCE,
        "replaces": JVP_REPLACES, "launches": sum(al.values()),
        "launches_grid_path": al["grid"], "launches_server_path": al["server"],
        "launches_scan_path": al["scan"],
        "max_abs_err": report["jvp_err"],
        "paths": AD_PATHS, "ms": jt["philox_f32"],
        "ms_float64": jt["philox_f64"], "ms_scan": jt["threefry_f32"],
        "ms_scan_float64": jt["threefry_f64"],
        "plain_paths": AD_PATHS, "plain_ms": jt["plain_philox_f32"],
        "plain_ms_scan": jt["plain_threefry_f32"],
        "bound_ms": jb["philox_f32"][0], "bound_by": jb["philox_f32"][1],
        "bound_ms_float64": jb["philox_f64"][0],
        "bound_ms_scan": jb["threefry_f32"][0],
        "bound_ms_scan_float64": jb["threefry_f64"][0],
        "library_ms": None})
    print("max_abs_err: probe, grid and simulate = largest |success % "
          "difference| over every check of that kernel; full = largest "
          "|withdrawal-rate difference| (points) over every full check; "
          "ms = the kernel alone (phase 6); bound_ms = the least time of that "
          "launch's work on this card (engine/bound.py, phase 6's shapes); "
          "library_ms = null: no single PyTorch call computes a month loop; "
          "launches = the main path (phase 5: launches_main_path) plus the "
          "analysis modes (8a-d, f) and bench.py's workload (8e: "
          "launches_grid_path) plus the server's routes (10a-d: "
          "launches_server_path) plus the chunked runs (11a-c: "
          "launches_chunked_path) plus the paths mesh (12a-d: "
          "launches_mesh_path; the process groups of 12c launch in their own "
          "processes, uncounted) plus the tools (13a edge sweep, 13d sweeps, "
          "13e snippet: launches_tools_path; the campaign's and the checks' "
          "launches are comparisons and bench.py's run in its own process, "
          "uncounted); *_all_on = the same under the all-on Statics. The scan "
          "row (JAX's threefry scan, a lax.scan, as two kernels): ms / "
          "ms_float64 = scan_rows_kernel at the probe's shape (16 x 1M x 600), "
          "*_full = scan_full_kernel at 1M x 600 (phase 14c), plain = the "
          "chain of torch ops in float32 (one call), max_abs_err = largest "
          "|success % difference| vs the plain chain (14b), launches = the "
          "float64 main path (14c: launches_main_path) plus "
          "cross_backend_check (14d), scaling_demo (14e), the scan batch (15a) "
          "and the scan's finite difference (15b). The jvp row (JAX's "
          "jit(jacfwd) through the scan, as one kernel): ms = float32 on the "
          "grid kernel's Philox draws at phase 8f's shape (2^20 paths, 8 "
          "directions), *_float64 and *_scan the other types and the scan's "
          "draws (16d), plain_ms = its plain version (torch.func.jvp of the "
          "chain), float32, one call at plain_paths, max_abs_err = largest "
          "|final or tangent difference| of the float64 checks (16a-b), "
          "launches = sensitivity_ad at 8f (launches_grid_path), the server's "
          "include_ad (10d) and the scan route (15b)")
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
