"""The port's chunked full-statistics run and its exact chunked quantiles.

``Engine.run`` splits a float32 run above ``MCRT_MAX_DEVICE_PATHS`` into
chunks of whole 4096-path blocks that simulate the unchunked run's global
blocks, and must return every field of the unchunked run, in raw and in
reduced mode (the JAX ``tests/test_chunked.py:55,91``). The band search of
``ops/chunked_quantiles.py`` must give ``quantiles_percol``'s tables
whether or not its brackets are seeded (``:300,368,409``), and pick the
same keys as the JAX package's copy, whose key fold it shares.
"""

import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu.ops import chunked_quantiles as jax_cq  # noqa: E402
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import runner  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops import chunked_quantiles as cq  # noqa: E402
from monte_carlo_retirement_tpu_torch.ops.quantiles import (  # noqa: E402
    ceil_stats,
    count_le,
    floor_values,
    quantiles_percol,
)
from monte_carlo_retirement_tpu_torch.ops.shocks import BLOCK_PATHS  # noqa: E402
from tests.conftest import base_config_dict  # noqa: E402

torch.set_num_threads(2)

# Three chunks of one block budget, the last one ragged.
N = 2 * BLOCK_PATHS + 1_000
W = 6
# 24 months of $5.5k indexed spending against $120k: a visible share of
# paths fail, so the ruin bins and the withdrawal-rate NaN masks are real.
SPENDY = dict(initial_balance=120_000.0, monthly_expenses=5_500.0)
CONFIGS = {
    "iid": dict(SPENDY),
    # Blocks 2k and 2k+1 share their key block: with one block per chunk
    # every antithetic pair straddles a chunk boundary.
    "antithetic": dict(SPENDY, antithetic=True),
}


def _engine(**overrides):
    cfg = Config(**base_config_dict(retirement_years=2, seed=11, **overrides))
    return Engine(cfg, dtype=torch.float32, device="cpu")


def _assert_equal_results(got, want):
    """Every RunResult field and every HostBins field equal as values
    (-0.0 == +0.0, NaN == NaN)."""
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if field.name == "bins" and b is not None:
            for bf in dataclasses.fields(b):
                assert np.array_equal(np.asarray(getattr(a, bf.name)),
                                      np.asarray(getattr(b, bf.name)),
                                      equal_nan=True), f"bins.{bf.name}"
        elif b is None:
            assert a is None, field.name
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b),
                                  equal_nan=True), field.name


def _chunked_stats(caplog):
    records = [r for r in caplog.records if hasattr(r, "chunked")]
    assert len(records) == 1, "the run did not take the chunked path"
    return records[0].chunked


@pytest.mark.parametrize("reduced", [False, True], ids=["raw", "reduced"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_chunked_run_equals_unchunked(monkeypatch, caplog, kind, reduced):
    eng = _engine(**CONFIGS[kind])
    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(10 * N))
    want = eng.run(W, N, reduced=reduced)
    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(BLOCK_PATHS))
    ck.reset_counts()
    with caplog.at_level(logging.INFO, logger="mcrt.engine"):
        got = eng.run(W, N, reduced=reduced)
    stats = _chunked_stats(caplog)
    assert stats["chunks"] == 3 and stats["band_passes"] >= 1
    # The first pass, each band round and the ceil pass simulate every chunk.
    assert ck.PLAIN_CALLS["full"] == stats["full_launches"] == (
        3 * (1 + stats["band_passes"]))
    _assert_equal_results(got, want)
    assert 0.0 < got.success_probability < 100.0
    assert got.wr_observation_counts.min() < N  # failed paths mask rates
    if reduced:
        assert 0 < got.bins.failure_count and got.success is None


def test_sample_rows_come_from_several_chunks(monkeypatch):
    """The dashboard's sample paths are gathered from the chunk that holds
    each: this seed's five rows lie in at least two chunks."""
    eng = _engine(**SPENDY)
    idx = np.random.default_rng(eng.main_seed).choice(N, size=5, replace=False)
    assert len(set(idx // BLOCK_PATHS)) >= 2
    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(BLOCK_PATHS))
    got = eng.run(W, N)
    L = got.sample_trajectories.shape[1]
    full = ck.simulate_full_plain(eng._pack(W, "final"), eng.statics,
                                  eng.retirement_years, N,
                                  1 + eng._t_scan(W) // 12)
    np.testing.assert_array_equal(got.sample_trajectories,
                                  full["trajectory"][idx].numpy()[:, :L])


def test_float64_runs_and_runs_within_the_budget_stay_unchunked(monkeypatch,
                                                               caplog):
    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(BLOCK_PATHS))
    cfg = Config(**base_config_dict(retirement_years=1, seed=3))
    with caplog.at_level(logging.INFO, logger="mcrt.engine"):
        Engine(cfg, device="cpu").run(0, BLOCK_PATHS + 1)  # float64
        Engine(cfg, dtype=torch.float32, device="cpu").run(0, BLOCK_PATHS)
    assert not any(hasattr(r, "chunked") for r in caplog.records)


@pytest.mark.parametrize("env,want", [
    (None, runner.DEFAULT_MAX_DEVICE_PATHS), ("5000", BLOCK_PATHS),
    ("100", BLOCK_PATHS), (str(3 * BLOCK_PATHS + 7), 3 * BLOCK_PATHS)])
def test_max_device_paths_is_whole_blocks(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("MCRT_MAX_DEVICE_PATHS", raising=False)
    else:
        monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", env)
    assert runner.max_device_paths() == want
    assert runner.DEFAULT_MAX_DEVICE_PATHS % BLOCK_PATHS == 0


def _random_chunks(rng, trial):
    """Chunked data with heavy duplicates, signed zeros, extreme and
    subnormal magnitudes, constant columns and masks (a column empty in
    every chunk on every third trial)."""
    n_chunks = int(rng.integers(2, 6))
    C = int(rng.integers(1, 9))
    chunks, valids = [], []
    for s in rng.integers(3, 400, size=n_chunks):
        x = np.empty((s, C), np.float32)
        for c in range(C):
            kind = rng.integers(0, 5)
            if kind == 0:
                x[:, c] = rng.choice(np.asarray([0.0, -0.0, 1.0, 2.5],
                                                np.float32), size=s)
            elif kind == 1:
                x[:, c] = rng.choice([1e-38, 1e30, -1e30, 3e-39], size=s)
            elif kind == 2:
                x[:, c] = np.float32(trial - 2)
            else:
                x[:, c] = rng.normal(scale=10.0 ** rng.integers(-3, 6), size=s)
        v = rng.random((s, C)) < rng.random()
        if trial % 3 == 0:
            v[:, 0] = False
        chunks.append(x)
        valids.append(v)
    return chunks, valids


@pytest.mark.parametrize("trial", range(10))
def test_band_search_equals_quantiles_percol(trial):
    """Seeded and unseeded, the search's tables equal quantiles_percol of
    the concatenated chunks (masked entries as +inf, NaN for an empty
    column), value for value."""
    rng = np.random.default_rng(20260820 + trial)
    qs = np.asarray([0.05, 0.25, 0.5, 0.75, 0.95], np.float32)
    chunks, valids = _random_chunks(rng, trial)
    plain = cq.exact_quantiles_chunked(chunks, qs, valids)
    seeded = cq.exact_quantiles_chunked(chunks, qs, valids, seed_brackets=True)
    x = torch.from_numpy(np.concatenate(chunks))
    v = torch.from_numpy(np.concatenate(valids))
    qmat = torch.from_numpy(np.broadcast_to(qs, (x.shape[1], len(qs))).copy())
    want = quantiles_percol(x, qmat, valid=v).t().numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(seeded, want)


def _drive(module, chunks, qs, seed):
    """Run ``module``'s BandSearch over ``chunks`` (optionally seeded);
    returns (rounds, floor values)."""
    n_valid = np.full((chunks[0].shape[1],), sum(c.shape[0] for c in chunks),
                      dtype=np.int64)
    search = module.BandSearch([qs], [n_valid])
    if seed:
        lo_acc = hi_acc = None
        for x in chunks:
            nv_c = np.full(x.shape[1], x.shape[0], dtype=np.int64)
            lo_r, hi_r = module.bracket_ranks(qs, nv_c, len(chunks) + 8)
            srt = np.sort(x, axis=0)
            cols = np.arange(x.shape[1])[:, None]
            lo_v, hi_v = srt[lo_r, cols], srt[hi_r, cols]
            lo_acc = lo_v if lo_acc is None else np.minimum(lo_acc, lo_v)
            hi_acc = hi_v if hi_acc is None else np.maximum(hi_acc, hi_v)
        search.seed_intervals([lo_acc], [hi_acc])
    while not search.resolved:
        edges = search.edges()[0]
        total = np.zeros(edges.shape, dtype=np.int64)
        for x in chunks:
            total += (x[:, :, None] <= edges[None, :, :]).sum(axis=0)
        search.update([total])
    return search.rounds, search.floor_values()[0]


def _homogeneous_chunks():
    rng = np.random.default_rng(7)
    return [rng.normal(loc=100.0, size=(50_000, 3)).astype(np.float32)
            for _ in range(4)]


def test_band_search_seeded_rounds_shrink():
    """On homogeneous chunk data the seed collapses the search to a handful
    of rounds with the same answer."""
    chunks = _homogeneous_chunks()
    qs = np.asarray([0.05, 0.5, 0.95], np.float32)
    rounds_plain, v_plain = _drive(cq, chunks, qs, False)
    rounds_seeded, v_seeded = _drive(cq, chunks, qs, True)
    np.testing.assert_array_equal(v_seeded, v_plain)
    assert rounds_seeded <= 4 < rounds_plain


@pytest.mark.parametrize("seed", [False, True], ids=["unseeded", "seeded"])
def test_band_search_picks_the_jax_packages_keys(seed):
    """The key fold and the search are shared with the JAX package: on the
    same data both pick the same floor keys in the same rounds."""
    chunks = _homogeneous_chunks()
    qs = np.asarray([0.05, 0.5, 0.95], np.float32)
    got_rounds, got = _drive(cq, chunks, qs, seed)
    want_rounds, want = _drive(jax_cq, chunks, qs, seed)
    assert got_rounds == want_rounds
    np.testing.assert_array_equal(cq.encode_keys(got), jax_cq.encode_keys(want))
    keys = np.random.default_rng(1).integers(0, 2**32, 4096, dtype=np.uint64)
    keys = np.clip(keys, cq.KEY_NEG_INF, cq.KEY_POS_INF).astype(np.uint32)
    np.testing.assert_array_equal(cq.decode_keys(keys).view(np.uint32),
                                  jax_cq.decode_keys(keys).view(np.uint32))


def test_band_search_seed_misuse_raises():
    qs = np.asarray([0.5], np.float32)
    search = cq.BandSearch([qs], [np.asarray([8], np.int64)])
    with pytest.raises(ValueError):
        search.seed_intervals([np.zeros((2, 2), np.float32)],
                              [np.ones((2, 2), np.float32)])
    with pytest.raises(RuntimeError):
        search.floor_values()
    edges = search.edges()[0]
    search.update([np.full(edges.shape, 8, dtype=np.int64)])
    with pytest.raises(RuntimeError):
        search.seed_intervals([np.zeros((1, 1), np.float32)],
                              [np.ones((1, 1), np.float32)])
    with pytest.raises(ValueError):
        cq.BandSearch([qs], [np.asarray([8], np.int64)], edges_per_rank=1)


@pytest.mark.parametrize("masked", [False, True])
def test_chunk_count_helpers_equal_brute_force(masked):
    """count_le, ceil_stats and floor_values (one sort each) against the
    broadcast compare they replace, with ties, signed zeros and masks."""
    rng = np.random.default_rng(5)
    x = rng.choice(np.asarray([-1.5, -0.0, 0.0, 0.25, 3.0, 7.0], np.float32),
                   size=(301, 4))
    x[:, 3] = rng.normal(size=301)
    valid = rng.random(x.shape) < 0.7 if masked else None
    xm = np.where(valid, x, np.float32(np.inf)) if masked else x
    tv = None if valid is None else torch.from_numpy(valid)
    edges = rng.choice(np.concatenate([x.ravel(), [np.inf, -np.inf, 0.1]]),
                       size=(4, 9)).astype(np.float32)
    got = count_le(torch.from_numpy(x), torch.from_numpy(edges), tv).numpy()
    np.testing.assert_array_equal(
        got, (xm[:, :, None] <= edges[None, :, :]).sum(axis=0))
    cnt, gt_min = ceil_stats(torch.from_numpy(x), torch.from_numpy(edges), tv)
    le = xm[:, :, None] <= edges[None, :, :]
    np.testing.assert_array_equal(cnt.numpy(), le.sum(axis=0))
    np.testing.assert_array_equal(
        gt_min.numpy(),
        np.where(le, np.float32(np.inf), xm[:, :, None]).min(axis=0))
    ranks = rng.integers(0, 301, size=(4, 5))
    got = floor_values(torch.from_numpy(x), torch.from_numpy(ranks), tv)
    srt = np.sort(xm, axis=0)
    np.testing.assert_array_equal(got.numpy(),
                                  srt[ranks, np.arange(4)[:, None]])
