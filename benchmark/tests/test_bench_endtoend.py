"""The end-to-end arithmetic: p90 over every request sent in the window,
rates over the window's seconds."""

import numpy as np
import pytest

from benchmark import endtoend


def rec(t_send, t_done, status=200):
    return {"t_send": t_send, "t_done": t_done, "status": status, "raw": b"", "body": {}}


def test_p90_and_rates_over_every_answer_in_the_window():
    start = 100.0
    lat = np.arange(1, 21) * 0.1  # 0.1 .. 2.0 s
    records = [rec(start + i, start + i + lat[i]) for i in range(20)]
    records.append(rec(start + 1, start + 2, status=500))  # failed
    records.append(rec(start + 1, start + 2, status=400))  # target not met: an answer
    w = endtoend.Window(records, start, 40.0)
    assert w.attempted == 22 and w.failed == 1 and len(w.answered) == 21
    m = w.metrics(12.5)
    every = list(lat * 1e3) + [1000.0]
    assert m["plan_ms.p90"] == pytest.approx(np.percentile(every, 90))
    assert m["plans_per_s"] == pytest.approx(21 / 40.0)
    assert m["analysis_s"] == pytest.approx(40.0 / 21)
    assert m["setup_s"] == 12.5


def test_a_request_that_straddles_the_close_is_in_the_tail_and_counts_its_share():
    start = 0.0
    records = [rec(i * 1.0, i * 1.0 + 1.0) for i in range(9)]  # nine 1 s answers
    records.append(rec(9.0, 19.0))  # sent at 9 s, answered 9 s after the 10 s close
    w = endtoend.Window(records, start, 10.0)
    m = w.metrics(0.0)
    every = [1000.0] * 9 + [10000.0]
    assert m["plan_ms.p90"] == pytest.approx(np.percentile(every, 90))
    assert m["plan_ms.p90"] > 1000.0
    assert w.work() == pytest.approx(9.1)  # a tenth of its time lay in the window
    assert m["plans_per_s"] == pytest.approx(9.1 / 10.0)
    assert m["analysis_s"] == pytest.approx(10.0 / 9.1)


def test_a_stall_at_the_end_of_the_window_lowers_the_rate():
    steady = [rec(i * 1.0, i * 1.0 + 1.0) for i in range(10)]
    stalled = steady[:8] + [rec(8.0, 30.0)]  # the ninth request hangs past the close
    a = endtoend.Window(steady, 0.0, 10.0).metrics(0.0)
    b = endtoend.Window(stalled, 0.0, 10.0).metrics(0.0)
    assert a["plans_per_s"] == pytest.approx(1.0)
    assert b["plans_per_s"] == pytest.approx((8 + 2 / 22) / 10.0)
    assert b["plan_ms.p90"] > a["plan_ms.p90"]


def test_p90_is_numpy_linear_rule():
    records = [rec(0.0, v) for v in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)]
    w = endtoend.Window(records, 0.0, 10.0)
    assert w.metrics(0.0)["plan_ms.p90"] == pytest.approx(910.0)
