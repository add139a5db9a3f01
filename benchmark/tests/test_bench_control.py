"""The control on the card: the reference in bfloat16 in the program's
place, at each cell's own size, on three seeds, must fail one of the
cell's limits on every seed (the readings behind the limits: PERF.md)."""

import pytest

from benchmark import control, spec


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_control_is_not_correct(card, cell):
    c = spec.Cell(cell)
    for seed in (101, 102, 103):
        numbers = control.readings(c, seed, 1, card)
        print(cell, seed, numbers)  # the upper readings (PERF.md), with -s
        assert any(numbers[k] > lim for k, lim in c.limits.items()), (seed, numbers)
