"""The port's parameters, kernel structure and copied modules vs the JAX package.

The port cannot import the JAX package's pure-Python modules (its
``__init__`` imports ``jax.numpy``), so it carries copies; these tests keep
the copies equal to the originals and the port's parameter packing equal to
the Pallas kernels' (``pallas_kernel.py:133-203, 1176-1239``).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import pydantic  # noqa: E402

import monte_carlo_retirement_tpu.config as jax_config  # noqa: E402
import monte_carlo_retirement_tpu.constants as jax_constants  # noqa: E402
import monte_carlo_retirement_tpu.hosts.schemas as jax_schemas  # noqa: E402
import monte_carlo_retirement_tpu.timing as jax_timing  # noqa: E402
from monte_carlo_retirement_tpu.engine import pallas_kernel as pk  # noqa: E402
from monte_carlo_retirement_tpu.models.retirement import (  # noqa: E402
    SimParams as JaxParams,
)
from monte_carlo_retirement_tpu_torch import config as port_config  # noqa: E402
from monte_carlo_retirement_tpu_torch import constants as port_constants  # noqa: E402
from monte_carlo_retirement_tpu_torch import timing as port_timing  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import (  # noqa: E402
    schemas as port_schemas,
)
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.models.retirement import SimParams  # noqa: E402
from tests.conftest import base_config_dict  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raw(name):
    if name in ("config.json", "jorge.json"):
        with open(os.path.join(REPO, name), encoding="utf-8") as fh:
            return json.load(fh)
    if name == "variant-a":
        return base_config_dict(
            inv1_use_realized_gains_tax_system=True,
            inv1_realized_gains_tax_rate=0.2,
            inv1_expense_ratio_annual=0.004,
            equity_inflation_correlation=-0.3,
            other_income_streams=[
                {"name": "A", "monthly_amount_today": 700.0, "start_at_age": 62.5,
                 "duration_years": None, "inflation_indexed": True, "tax_rate": 0.1},
                {"name": "B", "monthly_amount_today": 300.0, "start_at_age": 70.0,
                 "duration_years": None, "inflation_indexed": True, "tax_rate": 0.0},
            ],
        )
    return base_config_dict(  # variant-b: every extension's parameters set
        allocation_inv1_final_pct=0.4,
        spending_guardrails={"upper_wr_pct": 6.0, "lower_wr_pct": 3.0},
        market_crashes={"frequency_per_year": 0.3, "mean_drop_pct": 25.0,
                        "size_volatility": 0.1, "inv2_beta": 0.2},
        longevity={"mode_age": 88.0, "dispersion_years": 9.0},
        other_income_streams=[
            {"name": "C", "monthly_amount_today": 500.0, "start_at_age": 50.0,
             "duration_years": 10, "inflation_indexed": False, "tax_rate": 0.2},
        ],
    )


NAMES = ["config.json", "jorge.json", "variant-a", "variant-b"]


def _leaves_equal(port: SimParams, ref) -> None:
    for name in SimParams.field_names():
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        if want.dtype == np.bool_:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_array_equal(
                got.astype(np.float64), want.astype(np.float64), err_msg=name
            )


@pytest.mark.parametrize("name", NAMES)
def test_sim_params_equal_jax_host_leaves(name):
    raw = _raw(name)
    ref = JaxParams.host_leaves(jax_config.Config(**raw), dtype=np.float64)
    assert SimParams.field_names() == JaxParams._fields
    _leaves_equal(SimParams.from_config(port_config.Config(**raw)), ref)
    _leaves_equal(SimParams.from_jax(ref), ref)
    _leaves_equal(SimParams.from_jax(list(ref)), ref)


@pytest.mark.parametrize("name", NAMES)
def test_statics_and_packing_equal_pallas(name):
    raw = _raw(name)
    jcfg, pcfg = jax_config.Config(**raw), port_config.Config(**raw)
    assert tuple(ck.statics_from_config(pcfg)) == tuple(pk.statics_from_config(jcfg))
    assert ck.F.NUM == pk.NUM_FPARAMS and ck.NUM_IPARAMS == pk.NUM_IPARAMS

    jparams = JaxParams.from_config(jcfg, dtype=jnp.float32)
    months = [0, 13, 240]
    ip, fp = pk._pack_params(jparams, 12345, jnp.asarray(months), 7, block_offset=9)
    inputs = []
    if jparams.n_streams:
        pk._stream_inputs(jparams, [], inputs)
    packed = ck.pack_params(SimParams.from_config(pcfg), 12345, months, 7,
                            block_offset=9, dtype=torch.float32)
    np.testing.assert_array_equal(packed.ip.numpy(), np.asarray(ip))
    assert packed.ip.dtype == torch.int32 and packed.fp.dtype == torch.float32
    np.testing.assert_allclose(packed.fp[: ck.F.NUM].numpy(), np.asarray(fp),
                               rtol=1.2e-7, atol=0)
    streams = packed.fp[ck.F.NUM:].reshape(5, packed.n_streams).tolist()
    assert len(streams) == 5 and len(inputs) in (0, 5)
    for got, want in zip(streams, inputs):
        np.testing.assert_array_equal(np.float32(got), np.asarray(want))


def test_config_copy_equals_original():
    for model in ("Config", "OtherIncomeStreamConfig", "SpendingGuardrailsConfig",
                  "MarketCrashConfig", "LongevityConfig"):
        a = getattr(port_config, model).model_fields
        b = getattr(jax_config, model).model_fields
        assert list(a) == list(b), model
        for field in a:
            assert repr(a[field].default) == repr(b[field].default), (model, field)
            assert a[field].alias == b[field].alias, (model, field)
            assert repr(a[field].metadata) == repr(b[field].metadata), (model, field)
    bad = [
        dict(initial_balance=-1.0),
        dict(retirement_years=0),
        dict(allocation_inv1_pct=1.5),
        dict(inv1_returns_mean=-1.0),
        dict(target_probability=101.0),
        dict(seed=-3),
        dict(spending_guardrails={"upper_wr_pct": 3.0, "lower_wr_pct": 4.0}),
        dict(longevity={"mode_age": 90.0, "max_age": 85.0}),
        dict(other_income_streams=[{"name": "x", "monthly_amount_today": 1.0,
                                    "start_at_age": 130.0, "tax_rate": 0.1}]),
    ]
    for overrides in bad:
        for mod in (port_config, jax_config):
            with pytest.raises(pydantic.ValidationError):
                mod.Config(**base_config_dict(**overrides))
    good = base_config_dict(scenario="aliased")
    assert (port_config.Config(**good).model_dump()
            == jax_config.Config(**good).model_dump())


def test_schemas_copy_equals_original():
    def models(mod):
        return {name: obj for name, obj in vars(mod).items()
                if isinstance(obj, type) and issubclass(obj, pydantic.BaseModel)
                and obj.__module__ == mod.__name__}

    port, ref = models(port_schemas), models(jax_schemas)
    assert list(port) == list(ref) and "SimulationResponse" in port
    for name in ref:
        assert port[name].model_json_schema() == ref[name].model_json_schema(), name


def test_constants_copy_equals_original():
    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names and names == [n for n in dir(port_constants) if n.isupper()]
    for n in names:
        assert getattr(port_constants, n) == getattr(jax_constants, n), n


def test_timing_copy_equals_original():
    ages = [0.0, 30.0, 40.0, 45.5, 64.99, 65.0, 80.25]
    months = [0, 1, 11, 12, 13, 234, 600]
    for a in ages:
        for w in months:
            assert port_timing.retirement_age(a, w) == jax_timing.retirement_age(a, w)
            for s in ages:
                for fn in ("stream_payment_start_age",
                           "stream_payment_start_month_index"):
                    assert getattr(port_timing, fn)(a, w, s) == getattr(
                        jax_timing, fn)(a, w, s), (fn, a, w, s)
            for y in (0, 1, 7):
                assert port_timing.age_at_retirement_year(
                    a, w, y) == jax_timing.age_at_retirement_year(a, w, y)
        for b in ages:
            assert port_timing.years_from_t0_to_age(
                a, b) == jax_timing.years_from_t0_to_age(a, b)
    for w in months:
        assert port_timing.num_working_years(w) == jax_timing.num_working_years(w)
        for r in (1, 4, 50):
            assert port_timing.trajectory_time_points(
                w, r) == jax_timing.trajectory_time_points(w, r)
            assert port_timing.expected_trajectory_length(
                w, r) == jax_timing.expected_trajectory_length(w, r)
