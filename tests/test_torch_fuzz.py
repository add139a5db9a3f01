"""The kernels' oracle campaign (``hosts/fuzz.py``) on the CPU.

The port's scenario generator is a copy of the JAX suite's
``tests/test_fuzz_parity.py::_random_config``: the same rng state must give
the same scenario. On the CPU the campaign holds the float32 plain versions
(what the wrappers run on a CPU tensor) to the float64 ones with the card's
bounds, so the comparison and its skip rule are exercised here; a planted
1% error in one path's final balance must fail it, and asking for the card
without one must raise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.kernel import drawn_shocks  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import fuzz  # noqa: E402
from monte_carlo_retirement_tpu_torch.models.retirement import SimParams  # noqa: E402
from tests.conftest import base_config_dict  # noqa: E402
from tests.test_fuzz_parity import _random_config  # noqa: E402

torch.set_num_threads(2)
SEEDS_PER_CASE = 20


def _dump(cfg) -> dict:
    dump = cfg.model_dump()
    dump.pop("allocation_inv2_pct", None)  # a derived property
    return dump


CRASHES = {"frequency_per_year": 0.5, "mean_drop_pct": 20.0,
           "size_volatility": 0.2, "inv2_beta": 0.5}
LONGEVITY = {"mode_age": 45.0, "dispersion_years": 5.0, "max_age": 70.0}


@pytest.mark.parametrize("over", [
    {}, dict(market_crashes=CRASHES), dict(longevity=LONGEVITY),
    dict(antithetic=True, market_crashes=CRASHES, longevity=LONGEVITY)],
    ids=["plain", "crashes", "longevity", "antithetic+crashes+longevity"])
def test_drawn_shocks_are_the_loops_own_draws(over):
    """The campaign's references run on kernel.drawn_shocks: every month's
    draws at once must give the run that draws month by month, bit for
    bit (the antithetic pairing included)."""
    cfg = fuzz.make_config(retirement_years=2, **over)
    st = ck.statics_from_config(cfg)
    packed = ck.pack_params(SimParams.from_config(cfg), 123, [3, 9], 2,
                            dtype=torch.float64)
    n = 4096 + 100  # a block and a partial one: an antithetic pair
    own = ck.probe_plain(packed, st, 2, n)
    drawn = ck.probe_plain(packed, st, 2, n, drawn_shocks(st, 123, n, 9 + 24))
    assert torch.equal(own.success, drawn.success)
    assert torch.equal(own.final_balance, drawn.final_balance)


def test_base_config_is_the_suites():
    assert fuzz.base_config_dict() == base_config_dict()
    assert fuzz.base_config_dict(seed=7) == base_config_dict(seed=7)


@pytest.mark.parametrize("case", range(10))
def test_generator_matches_the_jax_suite(case):
    """200 seeds: the same Config and then the same W draw."""
    for seed in range(case * SEEDS_PER_CASE, (case + 1) * SEEDS_PER_CASE):
        mine, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
        assert _dump(fuzz.random_config(mine)) == _dump(_random_config(theirs)), seed
        assert mine.integers(0, 40) == theirs.integers(0, 40)
    cfg, w = fuzz.trial_case(fuzz.case_seed(0, case))
    rng = np.random.default_rng(fuzz.case_seed(0, case))
    assert _dump(cfg) == _dump(_random_config(rng)) and w == rng.integers(0, 40)


def test_campaign_on_cpu_is_clean():
    lines = []
    s = fuzz.run_campaign(trials=8, seed=0, n_paths=256, device="cpu",
                          log=lines.append)
    assert s["failed_seed"] is None and s["clean"] == 8, lines[-1]
    assert len(lines) == 8 and s["skipped"] == 0
    assert all(count > 0 for count in s["mix"].values()), s["mix"]
    for worst in s["worst"].values():
        assert worst["flags"] < fuzz.FLAG_MISMATCH
        assert worst["q999"] < fuzz.FIELD_RTOL


def test_cli_on_cpu_prints_clean(capsys):
    assert fuzz.main(["--device", "cpu", "--trials", "1", "--paths", "64"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("CLEAN: 1 trials x 64")


def _planted(real, kernel):
    """``real`` with 1% added to the largest final balance of its output."""
    def wrapper(*args):
        out = real(*args)
        final = out["final_balance"] if kernel == "simulate_full" else out.final_balance[0]
        j = int(final.argmax())
        assert float(final[j]) > 1_000.0  # 1% of it is beyond the $5 dust
        final[j] *= 1.01
        return out
    return wrapper


@pytest.mark.parametrize("kernel,report", [
    ("probe", "probe"), ("grid", "grid"), ("simulate_full", "full")])
def test_a_planted_one_percent_error_is_caught(monkeypatch, kernel, report):
    cfg, w = fuzz.trial_case(fuzz.case_seed(0, 0))  # clean in the campaign test
    monkeypatch.setattr(ck, kernel, _planted(getattr(ck, kernel), kernel))
    check = fuzz.check_kernels(cfg, w, 256, "cpu")
    assert not check["ok"] and not check[report]["ok"]
    assert all(check[k]["ok"] for k in ("probe", "grid", "full") if k != report)


def test_paths_beyond_the_conditioning_bound_are_skipped_and_counted():
    cfg = fuzz.make_config(initial_balance=2e9, retirement_years=2)
    check = fuzz.check_kernels(cfg, 3, 64, "cpu")
    assert check["skipped"] == 64 and check["ok"]
    check = fuzz.check_kernels(cfg, 3, 64, "cpu", ref_dtype=torch.float32)
    assert check["skipped"] == 0 and check["ok"]


def test_asking_for_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the campaign would run on it")
    with pytest.raises(RuntimeError, match="is_available"):
        fuzz.run_campaign(trials=1, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        fuzz.main(["--trials", "1"])
