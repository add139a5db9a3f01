"""The port's HTTP server against the JAX package's, route by route.

Both apps start in one process (``aiohttp.test_utils``): the JAX
``create_app()`` on its CPU engines and the port's
``create_app(device="cpu")`` on its plain versions. Every route answers
with the same status code and the same payload structure (key sets and
list lengths; lists whose length depends on the draws excepted), SSE
streams carry the same event sequence, and the statistics agree within 4σ
(the two packages draw from different generators). Port-only checks: the
``include_ad`` answer against the port's own AD, the OpenAPI path set
against the running router, the card default, concurrent answers equal to serial ones, and the
launch counters under threads.
"""

import asyncio
import json
import math
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from monte_carlo_retirement_tpu.hosts import server as jax_server  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import server  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts.grid import GridResponse  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts.optimize import (  # noqa: E402
    OptimizeResponse,
)
from monte_carlo_retirement_tpu_torch.hosts.schemas import (  # noqa: E402
    SimulationResponse,
)
from monte_carlo_retirement_tpu_torch.hosts.sensitivity import (  # noqa: E402
    SensitivityResponse,
)
from tests.conftest import base_config_dict, binomial_sigma_pct  # noqa: E402

torch.set_num_threads(2)


def _cfg(**overrides):
    return base_config_dict(retirement_years=4, **overrides)


# ~60-80% success at W = 24 over 4 years: the statistics discriminate.
STAT = _cfg(initial_balance=90_000.0, monthly_expenses=2_300.0,
            num_simulations_main=400, seed=8)
# Zero expenses: every candidate succeeds, so both searches take the same
# steps and every list has the same length in both packages.
SURE = _cfg(monthly_expenses=0.0, num_simulations_search=32,
            num_simulations_main=32, seed=3)
SMALL = _cfg(num_simulations_main=48, seed=5)
UNREACHABLE = _cfg(initial_balance=1_000.0, monthly_expenses=60_000.0,
                   target_probability=99.0, num_simulations_search=16,
                   num_simulations_main=16)
GRID = {"config": SMALL, "working_months": [12, 12, 18], "num_paths": 64,
        "chunk_size": 2, "variants": [
            {"name": "lean", "overrides": {"monthly_expenses": 1_800.0}},
            {"overrides": {"monthly_expenses": 2_400.0}},
            {"overrides": {"monthly_expenses": 3_200.0, "inv1_returns_mean": 0.05}},
        ]}
SENS = {"config": SMALL, "working_months": 12, "num_paths": 64,
        "params": ["monthly_expenses", "initial_balance"]}
SENS_AD = {**SENS, "include_ad": True, "ad_num_paths": 256}
OPT = {"config": SMALL, "working_months": 12, "num_paths": 64,
       "param": "allocation_inv1_pct", "lo": 0.3, "hi": 0.9, "points": 3,
       "rounds": 1}

CASES = {
    "health": ("GET", "/api/health", None),
    "meta": ("GET", "/api/analysis/meta", None),
    "default_config": ("GET", "/api/config/default", None),
    "validate": ("POST", "/api/validate", {"config": SMALL}),
    "validate_422": ("POST", "/api/validate", {"config": {"scenario": "broken"}}),
    "simulate_override": ("POST", "/api/simulate",
                          {"config": STAT, "working_months_override": 24}),
    "simulate_binned": ("POST", "/api/simulate",
                        {"config": STAT, "working_months_override": 24,
                         "include_raw_paths": False}),
    "simulate_search": ("POST", "/api/simulate", {"config": SURE}),
    "simulate_unreachable_400": ("POST", "/api/simulate", {"config": UNREACHABLE}),
    "simulate_bad_override_422": ("POST", "/api/simulate",
                                  {"config": SMALL, "working_months_override": -3}),
    "stream_override": ("POST", "/api/simulate/stream",
                        {"config": SMALL, "working_months_override": 13}),
    "stream_search": ("POST", "/api/simulate/stream", {"config": SURE}),
    "grid": ("POST", "/api/grid", GRID),
    "grid_stream": ("POST", "/api/grid/stream", GRID),
    "grid_422": ("POST", "/api/grid",
                 {"config": SMALL, "variants": [], "working_months": 0}),
    "sensitivity": ("POST", "/api/sensitivity", SENS),
    "sensitivity_stream": ("POST", "/api/sensitivity/stream", SENS),
    "sensitivity_422": ("POST", "/api/sensitivity", {**SENS, "params": ["nope"]}),
    "sensitivity_ad": ("POST", "/api/sensitivity", SENS_AD),
    "sensitivity_ad_stream": ("POST", "/api/sensitivity/stream", SENS_AD),
    "sensitivity_ad_dotted_400": ("POST", "/api/sensitivity", {
        **SENS_AD, "config": {**SMALL, "spending_guardrails": {
            "upper_wr_pct": 6.0, "lower_wr_pct": 2.0}},
        "params": ["spending_guardrails.upper_wr_pct"]}),
    "optimize": ("POST", "/api/optimize", OPT),
    "optimize_stream": ("POST", "/api/optimize/stream", OPT),
    "optimize_422": ("POST", "/api/optimize", {**OPT, "param": "no_such_field"}),
    "non_object_422": ("POST", "/api/simulate", b"[]"),
    "malformed_400": ("POST", "/api/simulate", b"{not json"),
    "unknown_404": ("GET", "/api/no-such-endpoint", None),
    "method_405": ("GET", "/api/simulate", None),
    "index": ("GET", "/", None),
}

# Lists whose length depends on the draws (failed paths, the ruin years
# they reach).
LOOSE = {"years_to_ruin", "year_counts"}


def _shape(node, key=None):
    """Key sets and list lengths of a payload; numbers (and null, which is
    what NaN serialises to) are one kind of leaf."""
    if isinstance(node, dict):
        return {k: _shape(v, k) for k, v in node.items()}
    if isinstance(node, list):
        return "list" if key in LOOSE else [_shape(v) for v in node]
    if isinstance(node, (bool, str)):
        return type(node).__name__
    return "number"


async def _ask(client, method, path, body):
    kwargs = {}
    if isinstance(body, bytes):
        kwargs = {"data": body, "headers": {"Content-Type": "application/json"}}
    elif body is not None:
        kwargs = {"json": body}
    resp = await client.request(method, path, **kwargs)
    text = await resp.text()
    if resp.content_type == "text/event-stream":
        body = [json.loads(line.removeprefix("data: "))
                for line in text.splitlines() if line.startswith("data: ")]
    elif resp.content_type == "application/json":
        body = json.loads(text)
    else:
        body = text
    return resp.status, resp.content_type, body


async def _all_cases(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return {name: await _ask(client, *case) for name, case in CASES.items()}
    finally:
        await client.close()


@pytest.fixture(scope="module")
def answers():
    return {
        "port": asyncio.run(_all_cases(server.create_app(device="cpu"))),
        "jax": asyncio.run(_all_cases(jax_server.create_app())),
    }


@pytest.mark.parametrize("case", list(CASES))
def test_route_answers_like_the_jax_server(answers, case):
    status, ctype, got = answers["port"][case]
    want_status, want_ctype, want = answers["jax"][case]
    assert (status, ctype) == (want_status, want_ctype)
    if ctype == "text/event-stream":
        assert [e["type"] for e in got] == [e["type"] for e in want]
        assert got[-1]["type"] == "result"
        assert _shape(got[-1]["data"]) == _shape(want[-1]["data"])
    elif ctype == "application/json":
        assert _shape(got) == _shape(want)
    else:
        assert got == want
    if case in ("meta", "default_config", "health"):
        assert got == want
    if status >= 400:
        assert got["detail"]


@pytest.mark.parametrize("case", ["simulate_override", "simulate_binned"])
def test_simulate_statistics_agree_within_4_sigma(answers, case):
    got = SimulationResponse.model_validate(answers["port"][case][2]).summary
    want = SimulationResponse.model_validate(answers["jax"][case][2]).summary
    n = STAT["num_simulations_main"]
    assert 20.0 < want.success_probability < 95.0  # a month that discriminates
    sigma = math.hypot(binomial_sigma_pct(got.success_probability, n),
                       binomial_sigma_pct(want.success_probability, n))
    assert abs(got.success_probability - want.success_probability) <= 4 * sigma
    assert got.success_probability_sigma == pytest.approx(
        binomial_sigma_pct(got.success_probability, n), abs=1e-3)
    assert got.required_working_months == want.required_working_months == 24
    assert abs(got.median_start_balance - want.median_start_balance) <= (
        0.1 * want.median_start_balance)


def test_analysis_routes_validate_against_their_schemas(answers):
    port = answers["port"]
    grid = GridResponse.model_validate(port["grid"][2])
    assert [r.name for r in grid.rows][0] == "lean" and grid.total_scenarios == 3
    assert grid.rows[0].success_probability >= grid.rows[1].success_probability
    sens = SensitivityResponse.model_validate(port["sensitivity"][2])
    assert {r.param for r in sens.rows} == set(SENS["params"])
    opt = OptimizeResponse.model_validate(port["optimize"][2])
    assert opt.evaluations == 3 and len(opt.curve) == 3
    binned = SimulationResponse.model_validate(port["simulate_binned"][2])
    assert binned.histogram.final_balances == []
    assert len(binned.histogram.binned.counts) == 60
    assert binned.ruin_histogram.year_counts is not None
    search = port["stream_search"][2]
    kinds = [e["type"] for e in search]
    assert kinds[0] == "phase" and "search_complete" in kinds
    assert kinds.index("search_complete") < len(kinds) - 2


def _run(coro):
    return asyncio.run(coro)


def test_include_ad_answers_a_json_error_naming_a9(answers):
    """``include_ad`` answers 200 on the route and its stream (it answered a
    JSON 400 before the AD pass was ported): every row carries the port's
    own AD slope and the result its mean final balance, the stream says
    ``sensitivity_ad`` before the result, and no answer names A9."""
    from monte_carlo_retirement_tpu_torch.config import Config
    from monte_carlo_retirement_tpu_torch.engine.sensitivity import sensitivity_ad

    status, ctype, got = answers["port"]["sensitivity_ad"]
    assert (status, ctype) == (200, "application/json")
    ad = sensitivity_ad(Config(**SMALL), SENS_AD["working_months"],
                        num_paths=SENS_AD["ad_num_paths"], seed=SMALL["seed"],
                        params=SENS_AD["params"], device="cpu")
    assert got["mean_final_balance_ad"] == round(ad["mean_final_balance"], 2)
    for row in got["rows"]:
        want = ad["d_mean_final"][row["param"]]
        assert row["ad_d_mean_final"] == pytest.approx(want, rel=1e-5)
    events = answers["port"]["sensitivity_ad_stream"][2]
    phases = [e["phase"] for e in events if e["type"] == "phase"]
    assert phases == ["sensitivity", "sensitivity_ad"]
    assert events[-1]["data"] == got
    refused = answers["port"]["sensitivity_ad_dotted_400"]
    assert refused[0] == 400 and "FD-only" in refused[2]["detail"]
    assert not any("A9" in json.dumps(answers["port"][case][2]) for case in (
        "sensitivity_ad", "sensitivity_ad_stream", "sensitivity_ad_dotted_400"))


def test_openapi_paths_equal_the_running_router():
    async def scenario():
        app = server.create_app(device="cpu")
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            spec = await (await client.get("/openapi.json")).json()
            docs = await client.get("/docs")
            html = await docs.text()
        finally:
            await client.close()
        registered = {r.resource.canonical for r in app.router.routes()
                      if r.method in ("GET", "POST") and r.resource is not None
                      and r.resource.canonical.startswith("/api/")}
        return spec, registered, docs.content_type, html

    spec, registered, ctype, html = _run(scenario())
    assert set(spec["paths"]) == registered
    assert "PyTorch" in spec["info"]["title"]
    description = spec["paths"]["/api/sensitivity"]["post"]["description"]
    assert "include_ad" in description and "A9" not in description
    for name in ("SimulationRequest", "SimulationResponse", "GridRequest",
                 "SensitivityResponse", "OptimizeJointResponse", "Config"):
        assert name in spec["components"]["schemas"], name
    assert ctype == "text/html"
    assert all(path in html for path in spec["paths"])


def test_server_defaults_to_the_card(monkeypatch):
    """Without a card the default app refuses to start; it never serves
    from the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        server.create_app()
    started = []
    monkeypatch.setattr(server.web, "run_app",
                        lambda app, **kw: started.append((app, kw)))
    monkeypatch.setattr(server, "configure_logging", lambda **kw: None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        server.main([])
    monkeypatch.setenv("MCRT_PORT", "8123")
    server.main(["--device", "cpu"])
    (app, kw), = started
    assert app[server.DEVICE] == "cpu" and kw["port"] == 8123


BIND_CASES = {
    "arguments": (dict(host="127.0.0.1", port=9001),
                  {"MCRT_HOST": "10.0.0.1", "MCRT_PORT": "9002"}),
    "MCRT_HOST/MCRT_PORT": ({}, {"MCRT_HOST": "10.0.0.1", "MCRT_PORT": "9002"}),
    "PORT": ({}, {"PORT": "9003"}),
    "MCRT_PORT over PORT": ({}, {"MCRT_PORT": "9004", "PORT": "9003"}),
    "defaults": ({}, {}),
    "port 0": (dict(port=0), {"MCRT_PORT": "9002"}),
}


@pytest.mark.parametrize("case", list(BIND_CASES))
def test_main_binds_where_the_jax_main_binds(monkeypatch, case):
    """``main(argv, host=, port=)`` takes the bind address as JAX's
    ``main(host, port)`` does: the argument, else MCRT_HOST / MCRT_PORT,
    else PORT, else 0.0.0.0:8080."""
    kwargs, env = BIND_CASES[case]
    for name in ("MCRT_HOST", "MCRT_PORT", "PORT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    binds = []
    for mod in (server, jax_server):
        monkeypatch.setattr(mod.web, "run_app",
                            lambda app, **kw: binds.append(kw))
        monkeypatch.setattr(mod, "configure_logging", lambda **kw: None)
    server.main(["--device", "cpu"], **kwargs)
    jax_server.main(**kwargs)
    got, want = binds
    assert got == want and set(got) == {"host", "port"}, (case, got, want)


def test_concurrent_requests_equal_serial_ones():
    """Four requests with different seeds sent together answer what each
    answers alone (per-request engines, no shared state but the counters)."""
    bodies = [{"config": _cfg(num_simulations_main=48, seed=seed,
                              monthly_expenses=2_600.0),
               "working_months_override": 12, "include_raw_paths": False}
              for seed in (11, 12, 13, 14)]

    async def scenario():
        client = TestClient(TestServer(server.create_app(device="cpu")))
        await client.start_server()
        try:
            together = await asyncio.gather(*(
                _ask(client, "POST", "/api/simulate", b) for b in bodies))
            alone = [await _ask(client, "POST", "/api/simulate", b) for b in bodies]
        finally:
            await client.close()
        return together, alone

    ck.reset_counts()
    together, alone = _run(scenario())
    assert [a[0] for a in together] == [200] * 4
    assert together == alone
    assert len({json.dumps(a[2]) for a in alone}) == 4
    assert ck.PLAIN_CALLS["full"] == 8 and ck.LAUNCHES["full"] == 0


def test_launch_counts_are_exact_under_threads():
    threads, per = 16, 2_000
    ck.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [ck._count(ck.LAUNCHES, "probe") for _ in range(per)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert ck.LAUNCHES["probe"] == threads * per
    ck.reset_counts()
    assert ck.LAUNCHES["probe"] == 0
