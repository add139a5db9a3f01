"""The one traffic generator: a mix file of parameters -> request bodies.

A mix (``traffic/<mix>.json``) names its route and closed-loop clients and
the sizes of every request. A plan mix (``/api/simulate``) sends the
configuration's own upstream household at the mix's path counts; a grid
mix (``/api/grid``) sends one fixed product of two config fields. Only the
engine seed changes from request to request, and it comes from ``--seed``:
every seed sends the same work.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List

import numpy as np


def engine_seed(seed: int, index: int) -> int:
    """The engine seed of request ``index`` of a run with ``--seed``."""
    state = np.random.SeedSequence([int(seed), 7, int(index)]).generate_state(1)
    return int(state[0] % (2**31))


def plan_requests(config: dict, mix: dict, seed: int) -> Iterator[dict]:
    """The run's requests, in order, without end."""
    index = 0
    while True:
        cfg = dict(config, seed=engine_seed(seed, index),
                   num_simulations_search=int(mix["search_paths"]),
                   num_simulations_main=int(mix["final_paths"]))
        yield {"config": json.loads(json.dumps(cfg))}
        index += 1


def grid_variants(mix: dict) -> List[dict]:
    """The product of the mix's two (or more) ranges, first key slowest."""
    axes = []
    for key, spec in mix["variants"].items():
        vals = np.linspace(spec["from"], spec["to"], int(spec["count"]))
        axes.append([(key, round(float(v), 10)) for v in vals])
    out = [{}]
    for axis in axes:
        out = [{**o, k: v} for o in out for k, v in axis]
    return [{"name": ", ".join(f"{k}={v}" for k, v in o.items()), "overrides": o}
            for o in out]


def grid_requests(config: dict, mix: dict, seed: int) -> Iterator[dict]:
    variants = grid_variants(mix)
    index = 0
    while True:
        cfg = dict(config, seed=engine_seed(seed, index),
                   num_simulations_main=int(mix["paths"]))
        yield {"config": cfg, "variants": variants,
               "working_months": int(mix["working_months"]),
               "num_paths": int(mix["paths"])}
        index += 1


def requests(config: dict, mix: dict, seed: int) -> Iterator[dict]:
    """The request bodies of a cell, by route."""
    if mix["route"] == "/api/grid":
        return grid_requests(config, mix, seed)
    return plan_requests(config, mix, seed)


def wire(body: Dict) -> bytes:
    """The bytes sent for a body."""
    return json.dumps(body).encode()
