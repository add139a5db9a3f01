"""The port's profiling utilities (the JAX ``tests/test_utils_and_frontend.py``
lines 24-49): phases accumulate, a trace is written only when asked for, and
the CPU mesh's ``shard_paths`` places the leading axis."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from monte_carlo_retirement_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh,
    pad_to_devices,
    shard_paths,
)
from monte_carlo_retirement_tpu_torch.utils import profiling  # noqa: E402
from monte_carlo_retirement_tpu_torch.utils.profiling import (  # noqa: E402
    device_timer,
    phase_timings,
    trace_to,
)


def test_device_timer_accumulates_phases():
    x = torch.ones(64)
    # Canonical pattern: assign the block's OUTPUT to the handle so the
    # timer waits for the timed computation, not an input.
    with device_timer("unit-phase") as t:
        t.result = x * 2
    with device_timer("unit-phase") as t:
        t.result = {"a": (x + 1, [x - 1])}
    stats = phase_timings()["unit-phase"]
    assert stats["calls"] >= 2
    assert stats["total_s"] >= 0.0
    assert stats["mean_ms"] == pytest.approx(
        stats["total_s"] / stats["calls"] * 1000.0)


def test_device_timer_finds_every_tensor_of_a_result():
    """The exit wait reaches tensors inside containers and dataclasses
    (the engine's RunResult-like outputs); CPU tensors need none."""
    import dataclasses

    @dataclasses.dataclass
    class Out:
        a: object
        b: object

    tree = Out(torch.zeros(2), {"x": (torch.ones(1), [torch.ones(3)])})
    assert profiling._cuda_devices(tree, set()) == set()
    with device_timer("tree-phase") as t:
        t.result = tree
    assert phase_timings()["tree-phase"]["calls"] == 1


def test_trace_to_noop_without_dir(tmp_path):
    with trace_to(None):
        pass  # must not start the profiler
    with trace_to(""):
        pass
    assert os.listdir(tmp_path) == []


def test_trace_to_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    with trace_to(str(out)):
        torch.ones(256).cumsum(0)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as fh:
        trace = json.load(fh)
    assert trace["traceEvents"]


def test_shard_paths_places_leading_axis():
    mesh = make_mesh(["cpu"] * 4)
    n = pad_to_devices(100, mesh.size)
    parts = shard_paths(mesh, torch.arange(n, dtype=torch.float32))
    assert len(parts) == 4 and all(p.device.type == "cpu" for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                  np.arange(n, dtype=np.float32))
    with pytest.raises(ValueError, match="evenly"):
        shard_paths(mesh, torch.arange(101))
