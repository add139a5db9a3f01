"""One process of a multi-process run of the port (the JAX package's
``scripts/dist_worker.py``).

Every process of the job runs this same program::

    MCRT_COORDINATOR=host0:PORT MCRT_NUM_PROCESSES=H MCRT_PROCESS_ID=h \\
        python -m monte_carlo_retirement_tpu_torch.hosts.dist_worker \\
        --device cuda --shards 1 [--backend nccl]

It joins the process group (``parallel.distributed.initialize_from_env``),
builds the global paths mesh of ``--shards`` shards of ``--device`` per
process, and runs the workload of :func:`run_workload` over it: the
working-months search, the final run raw and reduced, and a chunked reduced
run. It prints one ``RESULT {json}`` line: the answers, the same on every
process, and this process's shards (global first path, real paths and a
SHA-256 of each shard's final balances), so the caller can hold the union
of the processes' shards and every answer to a single-process run
(``tests/test_torch_distributed.py``, ``chip_smoke.py`` phase 12c).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..config import Config, load_config_from_json
from ..constants import MAX_SEARCH_YEARS, MONTHS_PER_YEAR
from ..engine.cuda_kernel import VECTOR_FIELDS
from ..engine.runner import Engine
from ..engine.sharded import full_shards
from ..parallel import distributed
from ..parallel.mesh import PathMesh, local_device_count, make_mesh
from ..search.driver import find_minimum_working_months

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _plain(value):
    """A JSON-safe copy: arrays as nested lists, NaN as None."""
    if isinstance(value, np.ndarray):
        return _plain(value.tolist())
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, (np.generic,)):
        value = value.item()
    if isinstance(value, float) and math.isnan(value):
        return None
    return value


def digest(values: np.ndarray) -> str:
    """SHA-256 of an array's bytes: equal digests, equal bits."""
    return hashlib.sha256(np.ascontiguousarray(values).tobytes()).hexdigest()


def describe(res) -> dict:
    """Every field of a ``RunResult``: the per-path vectors as digests (and
    the successful paths), the rest as JSON values."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if f.name in VECTOR_FIELDS:
            out[f.name] = None if v is None else digest(v)
        elif f.name == "bins":
            out[f.name] = None if v is None else {
                g.name: _plain(getattr(v, g.name)) for g in dataclasses.fields(v)}
        else:
            out[f.name] = _plain(v)
    if res.success is not None:
        out["successes"] = int(res.success.sum())
    return out


def run_workload(config: Config, *, search_paths: int, paths: int,
                 chunked_paths: int = 0, chunk_budget: int = 4096,
                 device="cuda", mesh: Optional[PathMesh] = None) -> dict:
    """The search, the final run (raw and reduced) and, with
    ``chunked_paths``, a reduced run chunked at ``chunk_budget`` paths per
    shard — in float32 (the kernels' type, and the band search's) over
    ``mesh``, or mesh-less for the single-process answer, on ``device``
    (the card unless the caller passes ``"cpu"``)."""
    eng = Engine(config, dtype=torch.float32, device=device, mesh=mesh)
    start = int(config.starting_working_months_search)
    horizon = start + MAX_SEARCH_YEARS * MONTHS_PER_YEAR
    months, prob, curve = find_minimum_working_months(
        lambda ms: eng.probe(list(ms), search_paths, stream="search",
                             horizon_months=horizon),
        starting_working_months=start,
        target_probability_pct=float(config.target_probability),
        sim_count=search_paths,
        scenario_name=config.Nickname,
        verbose=False,
    )
    if months < 0:
        raise RuntimeError(f"the search found no month (best {prob})")
    out = {
        "search": {"months": months, "probability": prob, "curve": curve},
        "raw": describe(eng.run(months, paths)),
        "reduced": describe(eng.run(months, paths, reduced=True)),
    }
    if chunked_paths:
        old = os.environ.get("MCRT_MAX_DEVICE_PATHS")
        os.environ["MCRT_MAX_DEVICE_PATHS"] = str(chunk_budget)
        try:
            out["chunked"] = describe(eng.run(months, chunked_paths,
                                              reduced=True))
        finally:
            if old is None:
                del os.environ["MCRT_MAX_DEVICE_PATHS"]
            else:
                os.environ["MCRT_MAX_DEVICE_PATHS"] = old
        out["chunked"]["n_paths"] = chunked_paths
    return out


def shard_digests(config: Config, months: int, paths: int,
                  mesh: PathMesh) -> list:
    """This process's shards of the final run's full launch: global first
    path, real paths and the digest of their final balances."""
    eng = Engine(config, dtype=torch.float32, device=mesh.device.type,
                 mesh=mesh)
    traj_len = 1 + eng._t_scan(months) // MONTHS_PER_YEAR
    _, outs = full_shards(eng.params, eng._stream_seed("final"), months,
                          eng.retirement_years, paths, traj_len, eng.statics,
                          mesh=mesh, dtype=torch.float32)
    return [{"start": s.start, "paths": s.paths,
             "final_balance": digest(full["final_balance"][:s.paths].cpu().numpy())}
            for s, full in outs]


def load_config(path: str, overrides: dict) -> Config:
    raw = load_config_from_json(path)
    raw.update(overrides)
    return Config(**raw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "config.json"))
    ap.add_argument("--overrides", default="{}",
                    help="JSON object of config fields to replace")
    ap.add_argument("--search-paths", type=int, required=True)
    ap.add_argument("--paths", type=int, required=True)
    ap.add_argument("--chunked-paths", type=int, default=0)
    ap.add_argument("--chunk-budget", type=int, default=4096)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shards", type=int, default=None,
                    help="shards per process (default MCRT_LOCAL_DEVICE_COUNT)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)

    distributed.initialize_from_env(backend=args.backend)
    if not distributed.group_active():
        print("RESULT " + json.dumps({"error": "MCRT_COORDINATOR not set"}))
        return 2
    try:
        shards = args.shards or local_device_count()
        mesh = make_mesh([args.device] * shards)
        config = load_config(args.config, json.loads(args.overrides))
        answers = run_workload(
            config, search_paths=args.search_paths, paths=args.paths,
            chunked_paths=args.chunked_paths, chunk_budget=args.chunk_budget,
            device=args.device, mesh=mesh)
        result = {
            "process": distributed.process_index(),
            "num_processes": distributed.process_count(),
            "coordinator": distributed.is_coordinator(),
            "backend": torch.distributed.get_backend(),
            "global_shards": mesh.size,
            "shards": shard_digests(config, answers["search"]["months"],
                                    args.paths, mesh),
            **answers,
        }
        print("RESULT " + json.dumps(result, allow_nan=False), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
