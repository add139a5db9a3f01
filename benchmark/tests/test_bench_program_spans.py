"""The program's own spans in a traced run (``benchmark/program.py``): a
traced run of a plan cell and of the grid cell, at the sizes
``test_bench_harness.py`` uses, reads every program metric of its cell as a
number, stays correct, and still reports the launcher's metrics; the
recomputed span metrics agree with the launcher's; without the
launcher's spans the program's are still read; the benchmark's own
launcher, traced or not, leaves the recorder off."""

import subprocess
import sys

import pytest

from benchmark import program, spec
from benchmark.tests.test_bench_harness import GRID, SMALL

SEED = 2**31 + 11
WINDOW_S = 12
PROGRAM = {"jorge.plan": {"pool.wait_ms.plan", "server.respond_ms.plan", "search.host_ms",
                          "final.card_wait_ms"},
           "macunaima.grid": {"server.respond_ms.grid", "grid.parse_ms"}}
# The launcher's metrics a CPU run reads (the rooflines need the card's
# kernels).
ON_CPU = {"jorge.plan": {"server.self_ms.plan", "search.ms", "search.probes",
                         "payload.self_ms", "final.ms", "reductions.card_ms",
                         "device.idle_pct.plan"},
          "macunaima.grid": {"server.self_ms.grid", "grid.host_gap_ms",
                             "device.idle_pct.grid"}}
# Recomputed from program spans, which nest inside the launcher's.
SAME = ("server.self_ms.plan", "server.self_ms.grid", "search.ms", "payload.self_ms",
        "final.ms")


@pytest.fixture(autouse=True)
def capped(monkeypatch):
    monkeypatch.setenv("MCRT_MAX_RAW_PATHS", "256")


def traced(cell, launcher_spans=True):
    sizes = dict(SMALL, **(GRID if "grid" in cell else {}))
    return program.traced_run(cell, SEED, WINDOW_S, device="cpu", sizes=sizes,
                              launcher_spans=launcher_spans)


@pytest.mark.parametrize("cell,launcher_spans", [("jorge.plan", True),
                                                 ("macunaima.grid", True),
                                                 ("jorge.plan", False)])
def test_a_traced_run_reads_the_program_spans(cell, launcher_spans):
    result, tr = traced(cell, launcher_spans)
    assert result["correct"] is True, result["checks"]
    rep = program.report(tr)
    assert set(rep["metrics"]) == PROGRAM[cell]
    assert all(v >= 0 for v in rep["metrics"].values()), rep["metrics"]
    assert rep["copy_wait_ms"] and all(v == 0 for v in rep["copy_wait_ms"].values())
    if not launcher_spans:
        # Only the device's metrics: the launcher's spans are left out.
        assert not tr.spans and set(result["metrics"]) == {"device.idle_pct.plan"}
        assert set(rep["recomputed"]) >= {"server.self_ms.plan", "search.ms", "final.ms"}
        return
    assert ON_CPU[cell] <= set(result["metrics"])
    for name in SAME:
        if name in result["metrics"]:
            launched = result["metrics"][name]["value"]
            assert rep["recomputed"][name] == pytest.approx(launched, rel=0.05, abs=5.0)
    root = "http.grid" if "grid" in cell else "http.simulate"
    assert rep["spans_per_request"][root] >= 5
    assert {root, "http.parse", "pool.wait", "http.respond"} <= set(rep["self_ms"][root])
    assert len(rep["stretch_ms"]) == 2 and all(v >= 0 for v in rep["stretch_ms"].values())
    assert rep["idle_gaps"] and rep["clock"]["month_loop_kernels"] == 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["jorge.plan", "macunaima.grid"])
def test_on_the_card_every_metric_and_the_clock(card, cell):
    # The cell's own sizes: the limits of correct are set for its 1M paths.
    result, tr = program.traced_run(cell, SEED, WINDOW_S, device=card)
    assert result["correct"] is True, result["checks"]
    rep = program.report(tr)
    assert set(rep["metrics"]) == PROGRAM[cell]
    assert set(result["metrics"]) == {m["name"] for m in spec.Cell(cell).per_layer}
    clock = rep["clock"]
    assert clock["month_loop_kernels"] > 0
    assert clock["inside_kernel_span"] >= 0.99 * clock["month_loop_kernels"]


def test_the_benchmark_launcher_leaves_the_recorder_off():
    code = (
        "import asyncio, json\n"
        "from aiohttp.test_utils import TestClient, TestServer\n"
        "from benchmark import launcher, traffic, spec\n"
        "from monte_carlo_retirement_tpu_torch.utils import profiling\n"
        "cell = spec.Cell('jorge.plan')\n"
        "mix = dict(cell.mix, search_paths=512, final_paths=512)\n"
        "body = next(traffic.requests(cell.config, mix, 5))\n"
        "async def go(trace):\n"
        "    app, _ = launcher.build_app('cpu', trace, None)\n"
        "    client = TestClient(TestServer(app))\n"
        "    await client.start_server()\n"
        "    try:\n"
        "        resp = await client.post('/api/simulate', data=traffic.wire(body),\n"
        "                                 headers={'Content-Type': 'application/json'})\n"
        "        return resp.status\n"
        "    finally:\n"
        "        await client.close()\n"
        "for trace in (False, True):\n"
        "    print(trace, asyncio.run(go(trace)), len(profiling.drain()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:-1] == ["False 200 0", "True 200 0"]
