"""The port across processes: real OS processes on gloo collectives.

``tests/test_torch_mesh.py`` holds the mesh within one process; these tests
hold it across processes, as the JAX ``tests/test_distributed.py`` does for
the JAX package. Two processes of ``hosts/dist_worker.py`` form a gloo
group, each with two CPU shards (a global mesh of four), and run the
search, the final run raw and reduced, and a chunked reduced run; a
one-process group runs the same workload over its two shards. Pinned:

  * the global mesh of four has disjoint shards, two per process;
  * both processes return the same answers;
  * the union of the processes' shards is the single-process run path for
    path, and every answer equals the single-process, mesh-less run's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import dist_worker  # noqa: E402
from monte_carlo_retirement_tpu_torch.parallel import distributed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180

# config.json's scenario over two years, a spend that fails on some paths.
OVERRIDES = {"retirement_years": 2, "seed": 1234, "initial_balance": 120_000.0,
             "monthly_expenses": 6_600.0, "target_probability": 90.0,
             "starting_working_months_search": 0}
SEARCH_PATHS = 4 * 4096  # whole shards: the sharded probe pads nothing
PATHS = 4 * 4096 - 1_384  # the last shard ragged
CHUNKED_PATHS = 2 * 4 * 4096  # two mesh-sized chunks at 4096 per shard
WORKLOAD = dict(search_paths=SEARCH_PATHS, paths=PATHS,
                chunked_paths=CHUNKED_PATHS, chunk_budget=4096)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_args():
    return ["--device", "cpu", "--shards", "2", "--backend", "gloo",
            "--search-paths", str(SEARCH_PATHS), "--paths", str(PATHS),
            "--chunked-paths", str(CHUNKED_PATHS), "--chunk-budget", "4096",
            "--overrides", json.dumps(OVERRIDES)]


def _launch(n_procs: int, port: int):
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ, MCRT_COORDINATOR=f"127.0.0.1:{port}",
                   MCRT_NUM_PROCESSES=str(n_procs), MCRT_PROCESS_ID=str(pid),
                   MCRT_WARMUP="0", OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "monte_carlo_retirement_tpu_torch.hosts.dist_worker",
             *_worker_args()],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _collect(procs):
    results = []
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line:\n{out[-1000:]}\n{err[-2000:]}"
        results.append(json.loads(lines[0][len("RESULT "):]))
    return sorted(results, key=lambda r: r["process"])


@pytest.fixture(scope="module")
def runs():
    """The two-process group and the one-process group, run at once."""
    pair = _launch(2, _free_port())
    single = _launch(1, _free_port())
    try:
        return {"pair": _collect(pair), "one": _collect(single)}
    finally:
        # One worker failing must not strand its peer on a collective.
        for p in pair + single:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=60)


@pytest.fixture(scope="module")
def reference():
    """The same workload in this process, mesh-less."""
    torch.set_num_threads(2)
    cfg = dist_worker.load_config(os.path.join(REPO, "config.json"), OVERRIDES)
    answers = dist_worker.run_workload(cfg, device="cpu", **WORKLOAD)
    raw = Engine(cfg, dtype=torch.float32, device="cpu").run(
        answers["search"]["months"], PATHS)
    return answers, raw


def _answers(result):
    return {k: result[k] for k in ("search", "raw", "reduced", "chunked")}


def test_two_process_global_mesh_formed(runs):
    r0, r1 = runs["pair"]
    assert r0["num_processes"] == r1["num_processes"] == 2
    assert r0["global_shards"] == r1["global_shards"] == 4
    assert r0["coordinator"] and not r1["coordinator"]
    assert r0["backend"] == r1["backend"] == "gloo"
    # Each process holds its half of the global paths, and the halves are
    # disjoint: the work was split across processes.
    assert [s["start"] for s in r0["shards"]] == [0, 4096]
    assert [s["start"] for s in r1["shards"]] == [8192, 12288]
    assert [s["paths"] for s in r0["shards"] + r1["shards"]] == [
        4096, 4096, 4096, PATHS - 3 * 4096]
    (one,) = runs["one"]
    assert one["num_processes"] == 1 and one["global_shards"] == 2
    assert [s["start"] for s in one["shards"]] == [0, 8192]


def test_answers_identical_across_processes(runs):
    r0, r1 = runs["pair"]
    assert json.dumps(_answers(r0), sort_keys=True) == json.dumps(
        _answers(r1), sort_keys=True)


def test_cross_process_shards_match_single_process(runs, reference):
    """(2 processes x 2 shards) == 1 process, bit for bit per path."""
    _, raw = reference
    for r in runs["pair"] + runs["one"]:
        for s in r["shards"]:
            part = raw.final_balance[s["start"]:s["start"] + s["paths"]]
            assert s["final_balance"] == dist_worker.digest(part), s["start"]


def test_cross_process_run_matches_single_process(runs, reference):
    """The raw run's every field: the seven per-path vectors (digests) and
    every table and scalar, equal to the mesh-less run's."""
    answers, raw = reference
    assert answers["raw"] == dist_worker.describe(raw)
    assert 0.0 < answers["raw"]["success_probability"] < 100.0
    for r in runs["pair"] + runs["one"]:
        assert r["raw"] == answers["raw"]


def test_multiprocess_reduced_serving_matches_single_process(runs, reference):
    answers, _ = reference
    assert answers["reduced"]["bins"]["failure_count"] > 0
    for r in runs["pair"] + runs["one"]:
        assert r["reduced"] == answers["reduced"]


def test_multiprocess_chunked_run_matches_single_process(runs, reference):
    """Chunking composed with the cross-process mesh: two mesh-sized chunks
    whose block offsets stay contiguous across the process and the chunk
    boundaries, equal to the unchunked single-process run."""
    answers, _ = reference
    for r in runs["pair"] + runs["one"]:
        assert r["chunked"] == answers["chunked"]
    eng = Engine(dist_worker.load_config(os.path.join(REPO, "config.json"),
                                         OVERRIDES), dtype=torch.float32,
                 device="cpu")
    full = eng.run(answers["search"]["months"], CHUNKED_PATHS, reduced=True)
    assert answers["chunked"] == dict(dist_worker.describe(full),
                                      n_paths=CHUNKED_PATHS)


def test_cross_process_search_matches_single_process(runs, reference):
    """The search driven across processes walks the same curve to the same
    answer: every probe batch's counts are reduced over the group before
    the search reads them."""
    answers, _ = reference
    got = answers["search"]
    for r in runs["pair"] + runs["one"]:
        assert r["search"] == got
    assert 0.0 < got["probability"] < 100.0
    probed = [pt["working_months"] for pt in got["curve"]]
    assert any(m % 12 for m in probed), "verification sweep never ran"


def test_initialize_from_env_requires_complete_triplet(monkeypatch):
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.delenv(distributed.ENV_NUM_PROCESSES, raising=False)
    monkeypatch.delenv(distributed.ENV_PROCESS_ID, raising=False)
    with pytest.raises(ValueError, match="all three are required"):
        distributed.initialize_from_env()


def test_initialize_from_env_noop_when_unset(monkeypatch):
    monkeypatch.delenv(distributed.ENV_COORDINATOR, raising=False)
    assert distributed.initialize_from_env() is False
    assert distributed.initialize() is False
    assert not distributed.group_active()


def test_initialize_needs_the_whole_address():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed.initialize("127.0.0.1:1", num_processes=2)


def test_coordinator_helpers_single_process():
    assert distributed.is_distributed() is False
    assert distributed.is_coordinator() is True
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    # Without a group the collectives return their input.
    t = torch.arange(3)
    assert distributed.all_reduce(t) is t
    assert distributed.all_gather(t) == [t]
    assert np.array_equal(distributed.all_gather(t)[0].numpy(), [0, 1, 2])
