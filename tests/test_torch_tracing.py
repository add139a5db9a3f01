"""The port's span recorder (``utils/profiling.py``) and the spans of the
served path: off it records nothing and hands out one shared no-op; on, a
span's parent and request follow the task or thread that opened it (across
``asyncio.to_thread`` and the engine pool), its times are ``time.time_ns``
and its thread the native id; one ``/api/simulate`` and one ``/api/grid``
on the CPU leave every span of the served path, nested, under one request
id each."""

import asyncio
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from monte_carlo_retirement_tpu_torch.hosts import server  # noqa: E402
from monte_carlo_retirement_tpu_torch.utils import profiling  # noqa: E402
from tests.conftest import base_config_dict  # noqa: E402

torch.set_num_threads(2)

# A few thousand paths, four years: the search probes and the final run
# both reach the host through one device-to-host read each.
PLAN = base_config_dict(retirement_years=4, initial_balance=90_000.0,
                        monthly_expenses=2_300.0, num_simulations_search=2048,
                        num_simulations_main=2048, seed=11)
GRID = {"config": PLAN, "working_months": 12, "num_paths": 2048, "chunk_size": 2,
        "variants": [{"overrides": {"monthly_expenses": e}}
                     for e in (1_800.0, 2_300.0, 2_800.0)]}


@pytest.fixture
def recording():
    profiling.clear()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.clear()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def ancestors(span, spans):
    ids = {s["id"]: s for s in spans}
    out = []
    while span["parent"] is not None:
        span = ids[span["parent"]]
        out.append(span["name"])
    return out


def test_off_records_nothing_and_hands_out_one_no_op():
    profiling.disable()
    profiling.clear()
    a, b = profiling.span("x", k=1), profiling.request_span("y")
    assert a is b
    with a as opened:
        opened.set(status=200)
        with profiling.span("z"):
            pass
    assert profiling.stamp() is None
    profiling.record("w", time.time_ns())

    @profiling.traced("f")
    def f(v):
        return v + 1

    assert f(1) == 2
    assert profiling.drain() == []


def test_nesting_inside_one_thread(recording):
    with profiling.request_span("root", seed=3) as root:
        with profiling.span("a"):
            with profiling.span("b", what="probe"):
                pass
        root.set(status=200)
    with profiling.span("orphan"):
        pass
    spans = by_name(profiling.drain())
    (r,), (a,), (b,), (o,) = spans["root"], spans["a"], spans["b"], spans["orphan"]
    assert r["parent"] is None and r["request"] == r["id"]
    assert r["attrs"] == {"seed": 3, "status": 200}
    assert a["parent"] == r["id"] and b["parent"] == a["id"]
    assert a["request"] == b["request"] == r["id"]
    assert b["attrs"] == {"what": "probe"}
    assert o["parent"] is None and o["request"] is None
    assert r["t0"] <= a["t0"] <= b["t0"] <= b["t1"] <= a["t1"] <= r["t1"]


def test_times_are_time_ns_and_the_thread_is_the_native_id(recording):
    before = time.time_ns()
    with profiling.span("s"):
        time.sleep(0.002)
    after = time.time_ns()
    seen = []

    def other():
        seen.append(threading.get_native_id())
        with profiling.span("t"):
            pass

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    spans = by_name(profiling.drain())
    (s,), (t,) = spans["s"], spans["t"]
    assert before <= s["t0"] and s["t1"] <= after
    assert s["t1"] - s["t0"] >= 2_000_000
    assert s["tid"] == threading.get_native_id()
    assert t["tid"] == seen[0] != s["tid"]


def test_a_span_closed_on_another_thread_keeps_its_start(recording):
    t0 = profiling.stamp()
    assert isinstance(t0, int)
    with profiling.request_span("root"):
        profiling.record("waited", t0, what="x")
    spans = by_name(profiling.drain())
    (w,), (r,) = spans["waited"], spans["root"]
    assert w["t0"] == t0 <= w["t1"] and w["parent"] == r["id"]
    assert w["request"] == r["id"] and w["attrs"] == {"what": "x"}


def test_clear_and_drain(recording):
    with profiling.span("a"):
        pass
    profiling.clear()
    assert profiling.drain() == []
    with profiling.span("open"):
        with profiling.span("closed"):
            pass
        assert [s["name"] for s in profiling.drain()] == ["closed"]
    assert [s["name"] for s in profiling.drain()] == ["open"]
    assert profiling.drain() == []


def test_threads_lose_no_span_and_share_no_id(recording):
    threads, per = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(per):
                with profiling.request_span("outer", k=k):
                    with profiling.span("inner", k=k):
                        pass

        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    spans = profiling.drain()
    assert len(spans) == 2 * threads * per
    ids = {s["id"]: s for s in spans}
    assert len(ids) == len(spans)
    for s in spans:
        if s["name"] == "inner":
            parent = ids[s["parent"]]
            assert parent["name"] == "outer" and parent["attrs"] == s["attrs"]
            assert s["request"] == parent["id"] and s["tid"] == parent["tid"]


def test_traced_records_each_call_and_lets_errors_through(recording):
    @profiling.traced("f")
    def f(v):
        if v < 0:
            raise ValueError("negative")
        return v * 2

    assert f(2) == 4
    with pytest.raises(ValueError):
        f(-1)
    spans = profiling.drain()
    assert [s["name"] for s in spans] == ["f", "f"]
    assert f.__name__ == "f" and f.__wrapped__(3) == 6


def test_parents_cross_tasks_to_thread_and_the_engine_pool(recording):
    def work(tag):
        with profiling.span("work", tag=tag):
            time.sleep(0.01)
        return tag

    async def one(tag):
        with profiling.request_span("req", tag=tag):
            await asyncio.sleep(0.005)
            await asyncio.to_thread(work, tag)
            return await server._run_engine(work, tag)

    async def both():
        return await asyncio.gather(one("a"), one("b"))

    assert asyncio.run(both()) == ["a", "b"]
    spans = profiling.drain()
    roots = {s["attrs"]["tag"]: s for s in spans if s["name"] == "req"}
    assert len(roots) == 2
    for s in spans:
        if s["name"] == "work":
            root = roots[s["attrs"]["tag"]]
            assert s["parent"] == root["id"] and s["request"] == root["id"]
            assert s["tid"] != root["tid"]
    waits = [s for s in spans if s["name"] == "pool.wait"]
    assert sorted(w["request"] for w in waits) == sorted(r["id"] for r in roots.values())
    for w in waits:
        assert w["parent"] == w["request"]
        pooled = [s for s in spans if s["name"] == "work" and s["request"] == w["request"]
                  and s["tid"] == w["tid"]]
        assert pooled and w["t1"] <= pooled[-1]["t0"]


def _post(route, body):
    async def go():
        client = TestClient(TestServer(server.create_app(device="cpu")))
        await client.start_server()
        try:
            resp = await client.post(route, json=body)
            return resp.status, await resp.json()
        finally:
            await client.close()

    return asyncio.run(go())


def _one_request(spans, root_name):
    (root,) = [s for s in spans if s["name"] == root_name]
    mine = [s for s in spans if s["request"] == root["id"]]
    return root, mine, by_name(mine)


def _inside(inner, outer):
    return outer["t0"] <= inner["t0"] and inner["t1"] <= outer["t1"]


def test_simulate_leaves_every_span_of_the_plan_path(recording):
    status, body = _post("/api/simulate", {"config": PLAN})
    assert status == 200, body
    spans = profiling.drain()
    root, mine, names = _one_request(spans, "http.simulate")
    assert root["attrs"] == {"seed": PLAN["seed"], "status": 200}
    # Every span of the request carries its id; none is left out of it.
    assert {s["request"] for s in spans} == {root["id"]}
    for name in ("http.parse", "pool.wait", "http.respond", "plan.search",
                 "plan.payload", "plan.final", "card.sync", "kernel.probe",
                 "kernel.full"):
        assert name in names, name
    for name in ("http.parse", "pool.wait", "http.respond"):
        (s,) = names[name]
        assert s["parent"] == root["id"] and _inside(s, root)
    (wait,), (search,), (final,) = names["pool.wait"], names["plan.search"], names["plan.final"]
    assert wait["t1"] <= search["t0"] and wait["tid"] == search["tid"] != root["tid"]
    assert "plan.payload" in ancestors(final, spans)
    syncs = {s["attrs"]["what"]: s for s in names["card.sync"]}
    assert set(syncs) == {"probe", "final"}
    probe_syncs = [s for s in names["card.sync"] if s["attrs"]["what"] == "probe"]
    assert len(probe_syncs) == len(names["kernel.probe"]) >= 1
    for s in probe_syncs:
        assert "plan.search" in ancestors(s, spans) and _inside(s, search)
    assert "plan.final" in ancestors(syncs["final"], spans)
    (full,) = names["kernel.full"]
    assert ancestors(full, spans)[0] == "plan.final"
    assert names["http.respond"][0]["t0"] >= final["t1"]


def test_grid_leaves_every_span_of_the_grid_path(recording):
    status, body = _post("/api/grid", GRID)
    assert status == 200, body
    spans = profiling.drain()
    root, mine, names = _one_request(spans, "http.grid")
    assert root["attrs"] == {"seed": PLAN["seed"], "variants": 3, "status": 200}
    assert {s["request"] for s in spans} == {root["id"]}
    for name in ("http.parse", "pool.wait", "http.respond"):
        (s,) = names[name]
        assert s["parent"] == root["id"] and _inside(s, root)
    (run,) = names["grid.run"]
    assert names["pool.wait"][0]["t1"] <= run["t0"]
    # Three variants in chunks of two: two launches, two reads.
    assert len(names["kernel.grid"]) == len(names["card.sync"]) == 2
    for s in names["card.sync"] + names["kernel.grid"]:
        assert "grid.run" in ancestors(s, spans) and _inside(s, run)
    assert {s["attrs"]["what"] for s in names["card.sync"]} == {"grid"}


def test_a_refused_request_records_its_status(recording):
    status, _ = _post("/api/simulate", {"config": PLAN, "working_months_override": -3})
    assert status == 422
    spans = profiling.drain()
    root, mine, names = _one_request(spans, "http.simulate")
    assert root["attrs"] == {"status": 422}
    assert set(names) == {"http.simulate", "http.parse"}


def test_kernel_spans_name_the_extensions_of_their_statics(recording):
    from monte_carlo_retirement_tpu_torch.config import Config
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck
    from monte_carlo_retirement_tpu_torch.engine.runner import Engine

    longevity = {"mode_age": 88.0, "dispersion_years": 10.0, "max_age": 110.0}
    for over, tag in (({}, ""), ({"longevity": longevity, "antithetic": True},
                                 "mortality+antithetic")):
        eng = Engine(Config(**dict(PLAN, **over)), device="cpu")
        R, n = eng.retirement_years, 64
        ck.probe(eng._pack([0, 12], "search"), eng.statics, R, n)
        one = eng._pack([12], "final")
        ck.simulate_full(one, eng.statics, R, n, 3)
        ck.grid(ck.Packed(fp=one.fp[None], ip=one.ip, n_streams=one.n_streams),
                eng.statics, R, n)
        kernels = [s for s in profiling.drain() if s["name"].startswith("kernel.")]
        assert [s["name"] for s in kernels] == ["kernel.probe", "kernel.full", "kernel.grid"]
        assert all(s["attrs"] == {"statics": tag} for s in kernels), kernels


def test_kernel_load_opens_once_per_library_and_says_whether_nvcc_ran(
        recording, monkeypatch):
    from pathlib import Path

    from monte_carlo_retirement_tpu_torch.engine import _build
    from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck

    built = []
    base = ck.Statics(True, True, False, False, (True,), (False,))
    on = base._replace(bill1=True, jumps=True, mortality=True)
    on_disk = {_build.Unit(on)}  # the all-on library is in the build directory

    class LibraryPath:
        def __init__(self, unit):
            self.unit = unit

        def exists(self):
            return self.unit in on_disk

    def build(unit):
        built.append(unit)
        on_disk.add(unit)
        return Path("month_loop.so")

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path", LibraryPath)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_bind", lambda lib, unit: None)
    for statics in (base, on, base, _build.Unit(on), on):
        _build.load(statics)
    loads = [s for s in profiling.drain() if s["name"] == "kernel.load"]
    assert [s["attrs"] for s in loads] == [
        {"statics": "", "built": True}, {"statics": "bill1+jumps+mortality", "built": False}]
    assert built == [_build.Unit(base), _build.Unit(on)]
