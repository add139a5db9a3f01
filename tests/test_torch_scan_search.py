"""config.json at its own sizes (300 search and 1,000 final paths, seed
2026) through the port's scan and the JAX engine on the CPU in float64:
the same search curve, month and final success, which ``chip_smoke.py``
phase 14c then holds the card's float64 engine to
(``chip_smoke.JAX_CPU_ANSWER``)."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine.simulator import (  # noqa: E402
    RetirementMonteCarloSimulator as JaxSimulator,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.simulator import (  # noqa: E402
    RetirementMonteCarloSimulator,
)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _answer(sim):
    months, prob, curve = sim.find_minimum_working_months(verbose=False)
    sim.use_final_seeds()
    summary_df, *_ = sim.run_monte_carlo_simulations(
        months, sim.params_model.num_simulations_main)
    return months, prob, curve, sim._success_probability(summary_df)


def test_config_json_answer_equals_jax_and_the_pinned_one(monkeypatch):
    with open(os.path.join(REPO, "config.json"), encoding="utf-8") as fh:
        raw = json.load(fh)
    raw["seed"] = chip_smoke.SEED
    for knob in ("MCRT_PROBE_BACKEND", "MCRT_RUN_BACKEND"):
        monkeypatch.setenv(knob, "scan")
    got = _answer(RetirementMonteCarloSimulator(Config(**raw), device="cpu"))
    want = _answer(JaxSimulator(JaxConfig(**raw)))
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1e-4 and abs(got[3] - want[3]) <= 1e-9
    assert [(p["working_months"], p["probability"]) for p in got[2]] == [
        (p["working_months"], p["probability"]) for p in want[2]]
    assert (got[0], round(got[1], 3), round(got[3], 1)) == chip_smoke.JAX_CPU_ANSWER
