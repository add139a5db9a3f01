"""The port's paths mesh on CPU shards: the five sharded launches, the
Engine's mesh and the analyses over it.

An n-shard launch of the port must equal its single-device launch bit for
bit, as the JAX package pins for itself (``test_pallas_parity.py:326-382,
423-463``, ``test_scenario_batch.py:164-206``): the Philox stream is a pure
function of (seed, global block, month, lane). The probe and grid count
every simulated path, padding included, so a sharded launch at n paths
equals a single launch at ``n_dev * local_pad`` paths (JAX's semantics,
held here against JAX's own interpret-mode kernels); the raw and full
launches return ``n_dev * local_pad`` entries whose first n are the
single-device run's. ``Engine(mesh=)`` and the analyses with ``mesh=`` must
return every field of their mesh-less results, in float32 (the band-search
reductions) and float64 (gathered shards).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config as JaxConfig  # noqa: E402
from monte_carlo_retirement_tpu.engine import pallas_kernel as pk  # noqa: E402
from monte_carlo_retirement_tpu.engine.runner import Engine as JaxEngine  # noqa: E402
from monte_carlo_retirement_tpu.models.retirement import (  # noqa: E402
    SimParams as JaxParams,
)
from monte_carlo_retirement_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jax_make_mesh,
)
from monte_carlo_retirement_tpu_torch.config import Config  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import cuda_kernel as ck  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import optimize as opt  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import scenario_batch as sb  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import sensitivity as sens  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine import sharded  # noqa: E402
from monte_carlo_retirement_tpu_torch.engine.runner import Engine  # noqa: E402
from monte_carlo_retirement_tpu_torch.hosts import dist_worker  # noqa: E402
from monte_carlo_retirement_tpu_torch.models.retirement import (  # noqa: E402
    SimParams,
    stack_params,
)
from monte_carlo_retirement_tpu_torch.ops.shocks import BLOCK_PATHS  # noqa: E402
from monte_carlo_retirement_tpu_torch.parallel import mesh as pm  # noqa: E402
from tests.conftest import base_config_dict, binomial_sigma_pct  # noqa: E402

torch.set_num_threads(2)

F64 = torch.float64  # a CPU mesh's default, and the single launches'
R = 2
W = 6
SEED = 11
# Two blocks and a partial one: ragged for every shard count below.
N = 2 * BLOCK_PATHS + 1_000
# Mixed outcomes over two years, so ruin bins and WR NaNs are real.
SPENDY = dict(retirement_years=R, seed=SEED, initial_balance=120_000.0,
              monthly_expenses=5_500.0)


def _config(**overrides):
    return Config(**base_config_dict(**{**SPENDY, **overrides}))


def _mesh(n_dev):
    return pm.make_mesh(["cpu"] * n_dev)


def _assert_equal_results(got, want):
    """Every RunResult and HostBins field equal as values (-0.0 == +0.0,
    NaN == NaN)."""
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if field.name == "bins" and b is not None:
            for f in dataclasses.fields(b):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, f.name)),
                    np.asarray(getattr(b, f.name)), err_msg=f"bins.{f.name}")
        elif b is None:
            assert a is None, field.name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field.name)


@pytest.fixture(scope="module")
def setup():
    cfg = _config()
    return cfg, SimParams.from_config(cfg), ck.statics_from_config(cfg)


# ----------------------------------------------------------------------
# the mesh's bookkeeping
# ----------------------------------------------------------------------
def test_local_blocks_matches_jax():
    for n in (1, 100, 4095, 4096, 4097, 8191, 12_288, 40_000, 1_000_000):
        for n_dev in (1, 2, 3, 4, 7, 8):
            assert pm.local_blocks(n, n_dev, BLOCK_PATHS) == pk._local_blocks(
                n, n_dev, pk.BLOCK_PATHS), (n, n_dev)
    assert pm.pad_to_devices(100, 8) == 104


def test_plan_shards_are_contiguous_global_blocks():
    mesh = _mesh(3)
    plan = mesh.plan(N, block_offset=5, start=10)
    assert plan.local_blocks == 1 and plan.local_pad == BLOCK_PATHS
    assert plan.simulated == 3 * BLOCK_PATHS
    assert [s.block_offset for s in plan.shards] == [5, 6, 7]
    assert [s.start for s in plan.shards] == [10, 10 + 4096, 10 + 8192]
    assert [s.paths for s in plan.shards] == [4096, 4096, 1000]
    # A shard wholly beyond n still launches; it holds no real path.
    assert [s.paths for s in _mesh(8).plan(N).shards][3:] == [0] * 5


def test_mesh_refuses_a_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pm.make_mesh(["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Engine(_config(), device="cuda", mesh=_mesh(2))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sb.run_scenario_grid([_config()], [W], 64, device="cuda", mesh=_mesh(2))
    # The mesh's kind and the engine's must agree: nothing moves silently.
    card_mesh = pm.PathMesh((torch.device("cuda", 0),) * 2)
    with pytest.raises(ValueError, match="kind of device"):
        pm.mesh_device(card_mesh, "cpu")
    with pytest.raises(ValueError, match="kind of device"):
        Engine(_config(), device="cpu", mesh=card_mesh)


# ----------------------------------------------------------------------
# the five sharded launches == the single-device launch
# ----------------------------------------------------------------------
LAUNCHES = ("probe", "simulate", "grid", "grid_raw", "full")


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("launch", LAUNCHES)
def test_sharded_launch_equals_single_device(setup, launch, n_dev):
    cfg, params, statics = setup
    mesh = _mesh(n_dev)
    padded = mesh.plan(N).simulated
    seed = 7
    if launch == "probe":
        months = [0, W, 13]
        got = sharded.probe_sharded(params, seed, months, R, N, statics,
                                    mesh=mesh)
        want = ck.probe(ck.pack_params(params, seed, months, R, dtype=F64), statics, R,
                        padded)
        assert got.simulated == padded
        np.testing.assert_array_equal(got.counts, want.counts.numpy())
        assert 0 < got.counts.min() and got.counts.max() < padded
        return
    if launch in ("grid", "grid_raw"):
        cfgs = [_config(monthly_expenses=e) for e in (3_000.0, 5_500.0, 9_000.0)]
        batch = stack_params(cfgs)
        months = [0, W, 12]
        single = ck.grid(ck.pack_grid(batch, seed, months, R, dtype=F64), statics, R, padded)
        if launch == "grid":
            got = sharded.grid_sharded(batch, seed, months, R, N, statics,
                                       mesh=mesh)
            np.testing.assert_array_equal(got.counts, single.counts.numpy())
            assert got.simulated == padded
            return
        got = sharded.grid_raw_sharded(batch, seed, months, R, N, statics,
                                       mesh=mesh)
        first = ck.grid(ck.pack_grid(batch, seed, months, R, dtype=F64), statics, R, N)
        for a, b, c in zip(got, single, first):
            if a is None:  # the probe's decided steps: no grid launch counts them
                assert b is None and c is None
                continue
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            if a.ndim == 2:
                np.testing.assert_array_equal(a[:, :N].numpy(), c.numpy())
        return
    if launch == "simulate":
        got = sharded.simulate_sharded(params, seed, W, R, N, statics, mesh=mesh)
        packed = ck.pack_params(params, seed, W, R, dtype=F64)
        single = ck.simulate(packed, statics, R, padded)
        first = ck.simulate(packed, statics, R, N)
        for a, b, c in zip(got, single, first):
            assert a.shape == (padded,)
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a[:N].numpy(), c.numpy())
        return
    L = 1 + Engine(cfg, device="cpu")._t_scan(W) // 12
    got = sharded.simulate_full_sharded(params, seed, W, R, N, L, statics,
                                        mesh=mesh)
    packed = ck.pack_params(params, seed, W, R, dtype=F64)
    single = ck.simulate_full(packed, statics, R, padded, L)
    first = ck.simulate_full(packed, statics, R, N, L)
    assert sorted(got) == sorted(single)
    for name in single:
        assert got[name].shape[0] == padded
        np.testing.assert_array_equal(got[name].numpy(), single[name].numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(got[name][:N].numpy(),
                                      first[name].numpy(), err_msg=name)


def test_sharded_probe_counts_padding_like_jax(setup):
    """Trap 1: a sharded probe at a ragged n equals a single probe at
    ``n_dev * local_pad`` paths — in the port (exact counts) and in JAX
    (interpret mode, a 2-device mesh of the conftest's CPU devices)."""
    cfg, params, statics = setup
    n = BLOCK_PATHS + 1_000  # 2 shards of one block: 8192 simulated
    months = [1, W]
    mesh = _mesh(2)
    got = sharded.probe_sharded(params, 5, months, R, n, statics, mesh=mesh)
    assert got.simulated == 2 * BLOCK_PATHS
    exact = ck.probe(ck.pack_params(params, 5, months, R, dtype=F64), statics, R, n)
    padded = ck.probe(ck.pack_params(params, 5, months, R, dtype=F64), statics, R,
                      got.simulated)
    np.testing.assert_array_equal(got.counts, padded.counts.numpy())
    assert not np.array_equal(got.percent,
                              exact.counts.numpy() / n * 100.0)

    jcfg = JaxConfig(**base_config_dict(**SPENDY))
    jparams = JaxParams.from_config(jcfg, dtype=jnp.float32)
    jstatics = pk.statics_from_config(jcfg)
    jmesh = jax_make_mesh(jax.devices()[:2])
    kw = dict(n_candidates=2, retirement_years=R, n_streams=0,
              statics=jstatics, interpret=True)
    jm = jnp.asarray(months, jnp.int32)
    sharded_p = pk.pallas_probe_sharded(jparams, jm, 5, mesh=jmesh, n_paths=n,
                                        **kw)
    single_p = pk.pallas_probe(jparams, jm, 5, n_paths=2 * pk.BLOCK_PATHS, **kw)
    np.testing.assert_allclose(np.asarray(sharded_p), np.asarray(single_p),
                               rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# Engine(mesh=)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_dev", [2, 3])
def test_engine_mesh_equals_meshless(dtype, n_dev):
    cfg = _config()
    meshed = Engine(cfg, dtype=dtype, device="cpu", mesh=_mesh(n_dev))
    plain = Engine(cfg, dtype=dtype, device="cpu")
    assert meshed.mesh.size == n_dev and plain.mesh is None
    months = [0, 3, W, 12, 20]
    # Whole shards: the padded count is the path count itself.
    n_probe = n_dev * BLOCK_PATHS
    assert meshed.probe(months, n_probe) == plain.probe(months, n_probe)
    for reduced in (False, True):
        _assert_equal_results(meshed.run(W, N, reduced=reduced),
                              plain.run(W, N, reduced=reduced))


def test_engine_mesh_search_equals_meshless():
    """The whole search over a mesh (every probe batch sharded) walks the
    same curve to the same answer; then the final runs, raw and reduced."""
    cfg = _config(retirement_years=1, initial_balance=60_000.0,
                  monthly_contribution=2_000.0, monthly_expenses=9_000.0,
                  target_probability=90.0)
    kw = dict(search_paths=2 * BLOCK_PATHS, paths=N, device="cpu")
    got = dist_worker.run_workload(cfg, mesh=_mesh(2), **kw)
    want = dist_worker.run_workload(cfg, **kw)
    assert got == want
    assert 0.0 < want["search"]["probability"] < 100.0
    assert any(pt["working_months"] % 12 for pt in want["search"]["curve"])


def test_chunked_sharded_run_and_probe_equal_unsharded(monkeypatch):
    """Chunking composed with the mesh: 4096-path budgets per shard split
    the run into mesh-sized chunks (multiples of n_dev * 4096 paths) and
    the probe into mesh-sized launches; every field equals the mesh-less
    unchunked run (the JAX ``test_chunked.py:136-270``)."""
    cfg = _config()
    mesh = _mesh(2)
    n = 2 * 2 * BLOCK_PATHS + 1_000  # 3 chunks of 8192, the last ragged
    want = {r: Engine(cfg, dtype=torch.float32, device="cpu").run(W, n, reduced=r)
            for r in (False, True)}
    months = [0, W, 12]
    want_p = Engine(cfg, dtype=torch.float32, device="cpu").probe(
        months, mesh.plan(n).simulated)
    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(BLOCK_PATHS))
    monkeypatch.setenv("MCRT_MAX_PROBE_PATHS", str(BLOCK_PATHS))
    eng = Engine(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    ck.reset_counts()
    for reduced in (False, True):
        _assert_equal_results(eng.run(W, n, reduced=reduced), want[reduced])
    assert ck.PLAIN_CALLS["full"] > 2 * 3 * 2  # re-simulated per pass
    # n spans 3 mesh launches of 8192; the last one pads to 2 whole blocks.
    ck.reset_counts()
    assert eng.probe(months, n) == want_p
    assert ck.PLAIN_CALLS["probe"] == 3 * 2


def test_meshed_engine_agrees_with_jax_meshed_scan_within_4_sigma():
    raw = base_config_dict(**SPENDY)
    n = 2_000
    got = Engine(Config(**raw), device="cpu", mesh=_mesh(4)).run(W, n)
    want = JaxEngine(JaxConfig(**raw), dtype=jnp.float64,
                     mesh=jax_make_mesh(jax.devices()[:4])).run(W, n)
    p, q = got.success_probability, want.success_probability
    sigma = math.hypot(binomial_sigma_pct(p, n), binomial_sigma_pct(q, n))
    assert 0.0 < p < 100.0 and abs(p - q) <= 4 * sigma, (p, q, sigma)


# ----------------------------------------------------------------------
# analyses with mesh=
# ----------------------------------------------------------------------
def test_analyses_with_mesh_equal_meshless():
    cfg = _config()
    mesh = _mesh(3)
    cfgs = [_config(monthly_expenses=e) for e in (3_000.0, 5_000.0, 7_000.0)]
    for chunk in (None, 2):
        got = sb.run_scenario_grid(cfgs, [W, 0, 12], N, seed=3, device="cpu",
                                   mesh=mesh, chunk_size=chunk)
        want = sb.run_scenario_grid(cfgs, [W, 0, 12], N, seed=3, device="cpu",
                                    chunk_size=chunk)
        for name, a, b in zip(want._fields, got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    names = ["monthly_expenses", "allocation_inv1_pct"]
    got = sens.sensitivity_fd(cfg, W, num_paths=N, seed=3, params=names,
                              device="cpu", mesh=mesh)
    want = sens.sensitivity_fd(cfg, W, num_paths=N, seed=3, params=names,
                               device="cpu")
    assert got == want
    kw = dict(num_paths=N, seed=3, points=3, rounds=2, device="cpu")
    got = opt.optimize_param(cfg, W, "allocation_inv1_pct", mesh=mesh, **kw)
    want = opt.optimize_param(cfg, W, "allocation_inv1_pct", **kw)
    assert got == want


# ----------------------------------------------------------------------
# MCRT_MESH=auto
# ----------------------------------------------------------------------
def test_engine_mesh_auto_env(monkeypatch):
    monkeypatch.setenv("MCRT_MESH", "auto")
    monkeypatch.setenv("MCRT_LOCAL_DEVICE_COUNT", "4")
    eng = Engine(_config(), device="cpu")
    assert eng.mesh is not None and eng.mesh.size == 4
    out = eng.run(W, 64)
    assert np.isfinite(out.final_balance).all()
    monkeypatch.setenv("MCRT_LOCAL_DEVICE_COUNT", "1")
    assert Engine(_config(), device="cpu").mesh is None  # one device: none
    monkeypatch.delenv("MCRT_MESH")
    monkeypatch.setenv("MCRT_LOCAL_DEVICE_COUNT", "4")
    assert Engine(_config(), device="cpu").mesh is None


def test_mesh_auto_serving_payload_matches_meshless(monkeypatch):
    """The full API payload must not change when MCRT_MESH=auto shards the
    served engine (the JAX ``test_distributed.py:395-418``)."""
    from monte_carlo_retirement_tpu_torch.engine.simulator import (
        RetirementMonteCarloSimulator,
    )
    from monte_carlo_retirement_tpu_torch.hosts.payload import build_result
    from monte_carlo_retirement_tpu_torch.hosts.schemas import (
        SimulationResponse,
    )

    config = Config(**base_config_dict(num_simulations_main=48,
                                       retirement_years=3, seed=77))

    def payload():
        sim = RetirementMonteCarloSimulator(config, device="cpu")
        assert (sim.engine.mesh is not None) == bool(
            __import__("os").environ.get("MCRT_MESH"))
        return build_result(config, sim, required_w_months=24, search_curve=[])

    monkeypatch.setenv("MCRT_LOCAL_DEVICE_COUNT", "4")
    monkeypatch.delenv("MCRT_MESH", raising=False)
    base = payload()
    monkeypatch.setenv("MCRT_MESH", "auto")
    meshed = payload()
    SimulationResponse.model_validate(meshed)
    assert meshed == base
