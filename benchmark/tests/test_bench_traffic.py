"""The traffic generator: one seed, one sequence; seeds differ only in the
engine seeds; every request is the configuration's own household."""

import itertools

from benchmark import spec, traffic


def take(cell, seed, k):
    c = spec.Cell(cell)
    return list(itertools.islice(traffic.requests(c.config, c.mix, seed), k))


def test_same_seed_same_requests():
    for cell in ("macunaima.plan", "jorge.plan", "macunaima.grid"):
        a, b = take(cell, 2**31 + 7, 40), take(cell, 2**31 + 7, 40)
        assert [traffic.wire(x) for x in a] == [traffic.wire(x) for x in b]


def test_seeds_differ_only_in_the_engine_seeds():
    a, b = take("macunaima.plan", 1, 32), take("macunaima.plan", 2, 32)
    assert {x["config"]["seed"] for x in a}.isdisjoint({x["config"]["seed"] for x in b})
    assert len({x["config"]["seed"] for x in a}) == 32
    strip = lambda r: {**r["config"], "seed": None}
    assert all(strip(x) == strip(a[0]) for x in a + b)
    g1, g2 = take("macunaima.grid", 1, 2), take("macunaima.grid", 2, 2)
    assert g1[0]["config"]["seed"] != g2[0]["config"]["seed"]
    assert g1[0]["variants"] == g2[0]["variants"]


def test_every_request_is_the_upstream_household_at_the_mix_sizes():
    for cell in ("macunaima.plan", "jorge.plan"):
        c = spec.Cell(cell)
        for body in take(cell, 2**31 + 5, 8):
            assert set(body) == {"config"}
            cfg = body["config"]
            assert cfg["num_simulations_main"] == cfg["num_simulations_search"] == 1_000_000
            for key, value in c.config.items():
                if key not in ("seed", "num_simulations_main", "num_simulations_search"):
                    assert cfg[key] == value, key


def test_grid_is_the_16_by_16_product():
    c = spec.Cell("macunaima.grid")
    v = traffic.grid_variants(c.mix)
    assert len(v) == 256
    exp = sorted({x["overrides"]["monthly_expenses"] for x in v})
    mean = sorted({x["overrides"]["inv1_returns_mean"] for x in v})
    assert exp[0] == 4000 and exp[-1] == 14000 and len(exp) == 16
    assert abs(mean[0] - 0.06) < 1e-12 and abs(mean[-1] - 0.14) < 1e-12 and len(mean) == 16
