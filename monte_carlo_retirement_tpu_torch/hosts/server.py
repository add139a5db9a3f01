"""HTTP API host of the port (aiohttp): REST + Server-Sent-Events progress.

A copy of the JAX package's ``hosts/server.py`` on the port's engines: the
same endpoint surface, request/response schemas, SSE event protocol, error
taxonomy and port, so the dashboard frontend works unchanged:

  GET  /api/health
  GET  /api/config/default
  POST /api/validate
  POST /api/simulate            (full JSON result)
  POST /api/simulate/stream     (SSE: phase / search_iter / search_refining /
                                 search_complete / result / error)
  GET  /                        (static dashboard from frontend/)

Beyond the reference surface:

  POST /api/grid                (scenario grid; + /api/grid/stream SSE)
  POST /api/sensitivity         (per-parameter derivatives of success
                                 probability / final-balance stats)
  POST /api/optimize            (maximize a metric over one config field,
                                 or two jointly via a product grid, by
                                 batched grid refinement;
                                 + /api/optimize/stream SSE)

The simulation itself runs in a worker thread; SSE progress events cross the
thread boundary via ``loop.call_soon_threadsafe`` into an asyncio queue.

Every route runs on one torch device, chosen as the port's CLI chooses it:
``create_app(device="cuda")`` (the default) serves from the card's kernels
and raises at startup when there is none, never falling back to the CPU;
``device="cpu"`` serves from the plain versions in float64.

  python -m monte_carlo_retirement_tpu_torch.hosts.server [--device {cuda,cpu}]

``MCRT_HOST`` / ``MCRT_PORT`` (default 0.0.0.0:8080) bind it. A capped
``/api/simulate`` (above ``MCRT_MAX_RAW_PATHS`` final paths) runs the
final batch in reduced mode: the reductions run on the device and only
kilobytes of tables cross to the host. A final run above
``MCRT_MAX_DEVICE_PATHS`` paths runs in chunks (``engine/runner.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextvars
import functools
import json
import logging
import os
from typing import List, Optional

from aiohttp import web
from pydantic import ValidationError

from ..config import Config
from ..constants import MAX_SEARCH_YEARS, MONTHS_PER_YEAR
from ..engine.cuda_kernel import require_device
from ..engine.simulator import RetirementMonteCarloSimulator
from ..logging_utils import configure_logging
from ..utils import profiling
from .grid import GridRequest, GridResponse, prepare_grid, run_prepared_grid
from .payload import build_result
from .schemas import SimulationRequest, SimulationResponse
from .optimize import (
    OptimizeRequest,
    default_points,
    prepare_optimize,
    request_target,
    response_model,
    run_optimize_request,
)
from .sensitivity import (
    SensitivityRequest,
    SensitivityResponse,
    prepare_sensitivity,
    run_sensitivity_request,
)

log = logging.getLogger("mcrt.server")

# Bound the engine work running concurrently across requests. The card
# runs every thread's launches on its one default stream, but each run
# allocates its outputs when it launches (a 1M-path full-statistics run
# holds ~1 GB of series; grid chunks ~130 MB of flags and finals), so an
# unbounded burst of clients can exhaust device memory while their launches
# queue. The bound is the size of a DEDICATED executor — excess engine
# work waits in its queue without consuming the default pool's threads,
# so request validation (and fast 422s) never stall behind running
# simulations. Validation stays on the default pool; only engine work
# (payload shaping included) lands here.
# MCRT_MAX_CONCURRENT_RUNS tunes it (read at import).
_ENGINE_POOL = concurrent.futures.ThreadPoolExecutor(
    max_workers=max(1, int(os.environ.get("MCRT_MAX_CONCURRENT_RUNS", "4"))),
    thread_name_prefix="mcrt-engine",
)


def _pooled(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` for the engine executor, in a copy of the
    caller's context (``run_in_executor`` passes none, so the spans it
    opens would lose their request); its first line records the wait for
    a worker since this call as the ``pool.wait`` span."""
    submitted = profiling.stamp()
    context = contextvars.copy_context()

    def start():
        profiling.record("pool.wait", submitted)
        return fn(*args, **kwargs)

    return functools.partial(context.run, start)


async def _run_engine(fn, *args, **kwargs):
    """Await ``fn(*args, **kwargs)`` on the bounded engine executor."""
    loop = asyncio.get_event_loop()
    return await loop.run_in_executor(_ENGINE_POOL, _pooled(fn, *args, **kwargs))

# The torch device every route of an app runs on.
DEVICE = web.AppKey("device", str)

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROJECT_ROOT = os.path.dirname(_PACKAGE_ROOT)
# Repo-checkout defaults; pip-installed deployments point these at their own
# copies (the wheel ships the package only, not the dashboard assets).
FRONTEND_DIR = os.environ.get(
    "MCRT_FRONTEND_DIR", os.path.join(_PROJECT_ROOT, "frontend")
)
DEFAULT_CONFIG_PATH = os.environ.get(
    "MCRT_DEFAULT_CONFIG", os.path.join(_PROJECT_ROOT, "config.json")
)


# ---------------------------------------------------------------------------
# Core request handling
# ---------------------------------------------------------------------------

def _parse_request(body: dict) -> tuple[SimulationRequest, Config]:
    if not isinstance(body, dict):
        # Valid JSON that isn't an object ('[]', '"x"', '5') must be a 422
        # like the reference server, not a TypeError-driven 500.
        raise ValueError(
            f"request body must be a JSON object, got {type(body).__name__}"
        )
    request = SimulationRequest(**body)
    config = Config(**request.config)
    return request, config


def _run_simulation(
    config: Config,
    working_months_override: Optional[int],
    include_raw: Optional[bool] = None,
    device: str = "cuda",
) -> dict:
    """Heavy synchronous work — executed on a worker thread."""
    simulator = RetirementMonteCarloSimulator(config, device=device)
    search_curve: List[dict] = []
    if working_months_override is not None:
        required = working_months_override
        log.info(
            "Using working-months override: %d (%.1f yrs)",
            required,
            required / MONTHS_PER_YEAR,
        )
    else:
        log.info("Estimating required working months for '%s'", config.Nickname)
        required, achieved, search_curve = simulator.find_minimum_working_months(
            verbose=True
        )
        if required == -1:
            raise ValueError(
                f"Target probability of {config.target_probability:.2f}% could "
                f"not be met. Highest achieved: {achieved:.2f}%"
            )
    simulator.use_final_seeds()
    return build_result(
        config, simulator, required, search_curve=search_curve,
        include_raw=include_raw,
    )


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

async def health(_request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def analysis_meta(_request: web.Request) -> web.Response:
    """GET /api/analysis/meta — discovery for the analysis surfaces: the
    config fields the sensitivity/optimize endpoints accept (with their
    hard bounds; an unbounded `hi` is null and needs an explicit search
    interval), the optimizer's objectives, and the default tornado set.
    Lets clients populate pickers instead of hardcoding field names."""
    from ..engine.optimize import MAX_JOINT_ROWS, OBJECTIVES
    from ..engine.sensitivity import DEFAULT_PARAMS, SENSITIVITY_PARAMS

    params = [
        {
            "name": name,
            "lo": spec.lo,
            "hi": None if spec.hi == float("inf") else spec.hi,
            "kind": spec.kind,
        }
        for name, spec in sorted(SENSITIVITY_PARAMS.items())
    ]
    return web.json_response({
        "parameters": params,
        "objectives": sorted(OBJECTIVES),
        "default_sensitivity_params": list(DEFAULT_PARAMS),
        "max_joint_rows": MAX_JOINT_ROWS,
    })


async def default_config(_request: web.Request) -> web.Response:
    if not os.path.exists(DEFAULT_CONFIG_PATH):
        raise web.HTTPNotFound(text="Default config.json not found.")
    try:
        with open(DEFAULT_CONFIG_PATH, "r", encoding="utf-8") as fh:
            return web.json_response(json.load(fh))
    except json.JSONDecodeError as exc:
        # A corrupt SERVER-side file is a 500, not the middleware's 400
        # "malformed request body".
        log.error("Server default config.json is invalid JSON: %s", exc)
        raise web.HTTPInternalServerError(
            text="Server default config.json is invalid JSON."
        )


async def validate(request: web.Request) -> web.Response:
    body = await request.json()
    try:
        _, config = _parse_request(body)
    except (ValidationError, ValueError) as exc:
        raise web.HTTPUnprocessableEntity(text=f"Invalid configuration: {exc}")
    return web.json_response({"valid": True, "scenario": config.Nickname})


async def _answer(name: str, handle, request: web.Request) -> web.Response:
    """``await handle(request, span)`` inside the request span ``name``,
    whose ``status`` attribute is the answer's HTTP status."""
    with profiling.request_span(name) as span:
        try:
            response = await handle(request, span)
        except web.HTTPException as exc:
            span.set(status=exc.status)
            raise
        span.set(status=response.status)
        return response


async def simulate(request: web.Request) -> web.Response:
    return await _answer("http.simulate", _simulate, request)


async def _simulate(request: web.Request, span) -> web.Response:
    with profiling.span("http.parse"):
        body = await request.json()
        try:
            req, config = _parse_request(body)
        except (ValidationError, ValueError) as exc:
            raise web.HTTPUnprocessableEntity(
                text=f"Invalid configuration: {exc}")
    span.set(seed=config.seed)

    log.info("Received simulation request for scenario '%s'", config.Nickname)
    try:
        result = await _run_engine(
            _run_simulation, config,
            req.working_months_override, req.include_raw_paths,
            request.app[DEVICE],
        )
    except ValueError as exc:
        raise web.HTTPBadRequest(text=str(exc))
    except Exception as exc:  # pragma: no cover - unexpected engine failure
        log.exception("Simulation failed")
        raise web.HTTPInternalServerError(text=f"Simulation error: {exc}")

    with profiling.span("http.respond"):
        validated = SimulationResponse.model_validate(result).model_dump(
            mode="json")
        response = web.json_response(validated)
    log.info("Simulation complete for '%s'", config.Nickname)
    return response


async def _run_sse(
    request: web.Request, worker_body, preamble: Optional[dict] = None
) -> web.StreamResponse:
    """Shared SSE transport (the reference's stream protocol shape,
    backend/server.py:322-413): run ``worker_body(emit)`` on the bounded
    engine executor, bridge thread→async via ``loop.call_soon_threadsafe``
    into a queue, frame each event as ``data: {json}\\n\\n`` until the
    ``None`` sentinel. Exceptions out of the worker become one ``error``
    event; the sentinel always fires. ``preamble`` is emitted from the
    async side BEFORE the worker is dispatched, so a stream queued behind
    busy engine slots still shows its phase immediately."""
    response = web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        },
    )
    await response.prepare(request)

    loop = asyncio.get_event_loop()
    queue: asyncio.Queue = asyncio.Queue()

    def emit(event: Optional[dict]) -> None:
        loop.call_soon_threadsafe(queue.put_nowait, event)

    def worker() -> None:
        try:
            worker_body(emit)
        except Exception as exc:
            emit({"type": "error", "message": str(exc)})
        finally:
            emit(None)

    if preamble is not None:
        queue.put_nowait(preamble)
    loop.run_in_executor(_ENGINE_POOL, _pooled(worker))

    while True:
        event = await queue.get()
        if event is None:
            break
        frame = f"data: {json.dumps(event, allow_nan=False)}\n\n"
        await response.write(frame.encode("utf-8"))
    await response.write_eof()
    return response


async def simulate_stream(request: web.Request) -> web.StreamResponse:
    body = await request.json()
    try:
        req, config = _parse_request(body)
    except (ValidationError, ValueError) as exc:
        raise web.HTTPUnprocessableEntity(text=f"Invalid configuration: {exc}")

    log.info("Received streaming simulation request for '%s'", config.Nickname)

    if req.working_months_override is not None:
        preamble = {
            "type": "phase",
            "phase": "final_sim",
            "message": f"Using override: {req.working_months_override} months",
        }
    else:
        preamble = {
            "type": "phase",
            "phase": "search",
            "message": "Estimating required working months…",
        }

    device = request.app[DEVICE]

    def worker_body(emit) -> None:
        simulator = RetirementMonteCarloSimulator(config, device=device)
        search_curve: List[dict] = []
        if req.working_months_override is not None:
            required = req.working_months_override
        else:
            required, achieved, search_curve = (
                simulator.find_minimum_working_months(
                    verbose=True, progress_callback=emit
                )
            )
            if required == -1:
                emit({
                    "type": "error",
                    "message": (
                        f"Target {config.target_probability:.1f}% not met. "
                        f"Highest: {achieved:.1f}%"
                    ),
                })
                return
            emit({
                "type": "search_complete",
                "working_months": required,
                "working_years": round(required / MONTHS_PER_YEAR, 1),
                "probability": round(achieved, 2),
            })

        emit({
            "type": "phase",
            "phase": "final_sim",
            "message": (
                f"Running {config.num_simulations_main} final simulations "
                f"with {required} working months…"
            ),
        })
        simulator.use_final_seeds()
        result = build_result(
            config, simulator, required, search_curve=search_curve,
            include_raw=req.include_raw_paths,
        )
        validated = SimulationResponse.model_validate(result).model_dump(
            mode="json"
        )
        emit({"type": "result", "data": validated})

    return await _run_sse(request, worker_body, preamble=preamble)


async def grid(request: web.Request) -> web.Response:
    """POST /api/grid — a scenario grid (config deltas x working months) in
    chunked batched device dispatches; the non-streaming variant."""
    return await _answer("http.grid", _grid, request)


async def _grid(request: web.Request, span) -> web.Response:
    with profiling.span("http.parse"):
        body = await request.json()
        try:
            if not isinstance(body, dict):
                raise ValueError(
                    "request body must be a JSON object, got "
                    f"{type(body).__name__}"
                )
            req = GridRequest(**body)
            # Worker thread: a 4096-variant request validates thousands of
            # pydantic configs — never on the event loop. Still a 422.
            prepared = await asyncio.to_thread(prepare_grid, req)
        except (ValidationError, ValueError) as exc:
            raise web.HTTPUnprocessableEntity(
                text=f"Invalid grid request: {exc}")
    span.set(seed=prepared[0][0].seed, variants=len(req.variants))

    log.info(
        "Received grid request: %d variants", len(req.variants)
    )
    try:
        result = await _run_engine(
            run_prepared_grid, prepared, req.chunk_size,
            device=request.app[DEVICE],
        )
    except ValueError as exc:
        # Valid request the engine cannot serve (mixed statics, bad months).
        raise web.HTTPBadRequest(text=str(exc))
    except Exception as exc:  # pragma: no cover - unexpected engine failure
        log.exception("Grid simulation failed")
        raise web.HTTPInternalServerError(text=f"Grid error: {exc}")

    with profiling.span("http.respond"):
        validated = GridResponse.model_validate(result).model_dump(mode="json")
        response = web.json_response(validated)
    log.info("Grid complete: %d rows", len(validated["rows"]))
    return response


async def sensitivity(request: web.Request) -> web.Response:
    """POST /api/sensitivity — per-parameter derivatives of success
    probability and final-balance statistics (finite differences over a
    common-random-numbers scenario grid, plus the optional ``include_ad``
    cross-check). Same 422/400 taxonomy as the grid surface."""
    body = await request.json()
    try:
        if not isinstance(body, dict):
            raise ValueError(
                f"request body must be a JSON object, got {type(body).__name__}"
            )
        req = SensitivityRequest(**body)
        prepared = await asyncio.to_thread(prepare_sensitivity, req)
    except (ValidationError, ValueError) as exc:
        raise web.HTTPUnprocessableEntity(
            text=f"Invalid sensitivity request: {exc}"
        )

    log.info(
        "Received sensitivity request: %d parameters", len(prepared[1])
    )
    try:
        result = await _run_engine(run_sensitivity_request, req, prepared,
                                   device=request.app[DEVICE])
    except ValueError as exc:
        raise web.HTTPBadRequest(text=str(exc))
    except Exception as exc:  # pragma: no cover - unexpected engine failure
        log.exception("Sensitivity analysis failed")
        raise web.HTTPInternalServerError(text=f"Sensitivity error: {exc}")

    validated = SensitivityResponse.model_validate(result).model_dump(
        mode="json"
    )
    log.info("Sensitivity complete: %d rows", len(validated["rows"]))
    return web.json_response(validated)


async def sensitivity_stream(request: web.Request) -> web.StreamResponse:
    """POST /api/sensitivity/stream — SSE variant: ``phase`` /
    ``grid_chunk`` per device dispatch of the 1+2K probe rows (plus a
    ``phase`` before the optional AD pass) / ``result`` / ``error``. A
    1M-path tornado dispatches thousands of row-chunks; without this the
    client blocks silently (the grid/optimize surfaces already stream)."""
    body = await request.json()
    try:
        if not isinstance(body, dict):
            raise ValueError(
                f"request body must be a JSON object, got {type(body).__name__}"
            )
        req = SensitivityRequest(**body)
        prepared = await asyncio.to_thread(prepare_sensitivity, req)
    except (ValidationError, ValueError) as exc:
        raise web.HTTPUnprocessableEntity(
            text=f"Invalid sensitivity request: {exc}"
        )

    preamble = {
        "type": "phase",
        "phase": "sensitivity",
        "message": (
            f"Probing {len(prepared[1])} parameters "
            f"({1 + 2 * len(prepared[1])} CRN scenario rows max)…"
        ),
    }

    device = request.app[DEVICE]

    def worker_body(emit) -> None:
        result = run_sensitivity_request(req, prepared, progress_callback=emit,
                                         device=device)
        validated = SensitivityResponse.model_validate(result).model_dump(
            mode="json"
        )
        emit({"type": "result", "data": validated})

    return await _run_sse(request, worker_body, preamble=preamble)


async def optimize(request: web.Request) -> web.Response:
    """POST /api/optimize — maximize a metric over one config field by
    batched grid refinement (one CRN scenario-grid dispatch per round).
    No reference analog; same 422/400 taxonomy as the grid surface."""
    body = await request.json()
    try:
        if not isinstance(body, dict):
            raise ValueError(
                f"request body must be a JSON object, got {type(body).__name__}"
            )
        req = OptimizeRequest(**body)
        prepared = await asyncio.to_thread(prepare_optimize, req)
    except (ValidationError, ValueError) as exc:
        raise web.HTTPUnprocessableEntity(
            text=f"Invalid optimize request: {exc}"
        )

    log.info(
        "Received optimize request: %s over '%s'",
        req.objective, request_target(req),
    )
    try:
        result = await _run_engine(run_optimize_request, req, prepared,
                                   device=request.app[DEVICE])
    except ValueError as exc:
        raise web.HTTPBadRequest(text=str(exc))
    except Exception as exc:  # pragma: no cover - unexpected engine failure
        log.exception("Optimization failed")
        raise web.HTTPInternalServerError(text=f"Optimize error: {exc}")

    validated = response_model(req).model_validate(result).model_dump(
        mode="json"
    )
    if "params" in validated:
        log.info(
            "Optimize complete: best %s=%s (%s=%.4g)",
            " x ".join(validated["params"]),
            validated["best"]["values"],
            validated["objective"], validated["best"]["objective_value"],
        )
    else:
        log.info(
            "Optimize complete: best %s=%.6g (%s=%.4g)",
            validated["param"], validated["best"]["value"],
            validated["objective"], validated["best"]["objective_value"],
        )
    return web.json_response(validated)


async def optimize_stream(request: web.Request) -> web.StreamResponse:
    """POST /api/optimize/stream — SSE variant: ``phase`` / ``grid_chunk``
    per device dispatch / ``optimize_round`` per refinement round /
    ``result`` / ``error``."""
    body = await request.json()
    try:
        if not isinstance(body, dict):
            raise ValueError(
                f"request body must be a JSON object, got {type(body).__name__}"
            )
        req = OptimizeRequest(**body)
        prepared = await asyncio.to_thread(prepare_optimize, req)
    except (ValidationError, ValueError) as exc:
        raise web.HTTPUnprocessableEntity(
            text=f"Invalid optimize request: {exc}"
        )

    points = req.points if req.points is not None \
        else default_points(1 if req.params is None else len(req.params))
    preamble = {
        "type": "phase",
        "phase": "optimize",
        "message": (
            f"Optimizing {request_target(req)} "
            f"({points} points/axis x {req.rounds} rounds)…"
        ),
    }

    device = request.app[DEVICE]

    def worker_body(emit) -> None:
        result = run_optimize_request(req, prepared, progress_callback=emit,
                                      device=device)
        validated = response_model(req).model_validate(result).model_dump(
            mode="json"
        )
        emit({"type": "result", "data": validated})

    return await _run_sse(request, worker_body, preamble=preamble)


async def grid_stream(request: web.Request) -> web.StreamResponse:
    """POST /api/grid/stream — the SSE variant: ``phase`` / ``grid_chunk``
    per device dispatch / ``result`` / ``error`` events (the reference's
    stream protocol shape, backend/server.py:322-413)."""
    body = await request.json()
    try:
        if not isinstance(body, dict):
            raise ValueError(
                f"request body must be a JSON object, got {type(body).__name__}"
            )
        req = GridRequest(**body)
        # Worker thread: a 4096-variant request validates thousands of
        # pydantic configs — never on the event loop. Still a 422.
        prepared = await asyncio.to_thread(prepare_grid, req)
    except (ValidationError, ValueError) as exc:
        raise web.HTTPUnprocessableEntity(text=f"Invalid grid request: {exc}")

    preamble = {
        "type": "phase",
        "phase": "grid",
        "message": f"Running {len(req.variants)} scenario variants…",
    }

    device = request.app[DEVICE]

    def worker_body(emit) -> None:
        result = run_prepared_grid(
            prepared, req.chunk_size, progress_callback=emit, device=device
        )
        validated = GridResponse.model_validate(result).model_dump(
            mode="json"
        )
        emit({"type": "result", "data": validated})

    return await _run_sse(request, worker_body, preamble=preamble)


# ---------------------------------------------------------------------------
# App assembly
# ---------------------------------------------------------------------------

@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        response = web.Response()
    else:
        try:
            response = await handler(request)
        except web.HTTPException as exc:
            if exc.status >= 400 and request.path.startswith("/api"):
                # Reference wire shape: FastAPI serializes every HTTP error
                # as JSON {"detail": ...} (its clients read `err.detail`,
                # reference frontend/src/api.js:30-31); the handlers raise
                # plain-text aiohttp exceptions, reshaped here once.
                response = web.json_response(
                    {"detail": exc.text or exc.reason}, status=exc.status
                )
                if "Allow" in exc.headers:  # 405 carries its method list
                    response.headers["Allow"] = exc.headers["Allow"]
            else:
                exc.headers.update(_cors_headers(request))
                raise
        except json.JSONDecodeError:
            # A malformed request body raises before the handler's own error
            # handling; answer 400 (with CORS headers below) rather than an
            # opaque header-less 500.
            response = web.json_response(
                {"detail": "Malformed JSON request body."}, status=400
            )
        except Exception:
            log.exception("Unhandled error serving %s", request.path)
            response = web.json_response(
                {"detail": "Internal server error."}, status=500
            )
        if (
            request.path.startswith("/api")
            and response.status >= 400
            and response.content_type != "application/json"
        ):
            # Errors RETURNED rather than raised (e.g. the frontend static
            # fallback answers GET /api/unknown with a plain 404) get the
            # same JSON shape.
            response = web.json_response(
                {"detail": response.reason or "error"},
                status=response.status,
            )
    response.headers.update(_cors_headers(request))
    return response


def _cors_headers(request: web.Request) -> dict:
    # Browsers reject the wildcard origin on credentialed requests, so
    # reflect the caller's Origin when one is sent — the same behavior the
    # reference gets from Starlette's CORSMiddleware with allow_origins=["*"]
    # plus allow_credentials=True. Reflect-any is the parity default because
    # this server carries no cookies or auth; a deployment that adds either
    # must set MCRT_ALLOWED_ORIGINS to a comma-separated allowlist — origins
    # outside it get the wildcard WITHOUT Allow-Credentials, so a cross-site
    # page can never make a credentialed read.
    origin = request.headers.get("Origin", "*")
    allowlist = os.environ.get("MCRT_ALLOWED_ORIGINS", "").strip()
    allowed = allowlist == "" or origin in {
        o.strip() for o in allowlist.split(",") if o.strip()
    }
    headers = {
        "Access-Control-Allow-Origin": origin if allowed else "*",
        "Access-Control-Allow-Methods": "*",
        "Access-Control-Allow-Headers": "*",
        "Vary": "Origin",
    }
    if allowed:
        headers["Access-Control-Allow-Credentials"] = "true"
    return headers


async def index(_request: web.Request) -> web.Response:
    index_path = os.path.join(FRONTEND_DIR, "index.html")
    if not os.path.exists(index_path):
        raise web.HTTPNotFound(text="Frontend not built.")
    return web.FileResponse(index_path)


def _warmup(device: str) -> None:
    """Build the month-loop library of the default scenario's Statics (one
    nvcc run) and run one probe and one reduced final run at its sizes, so
    the first user request pays neither the build nor a cold launch
    (disable: MCRT_WARMUP=0)."""
    try:
        if not os.path.exists(DEFAULT_CONFIG_PATH):
            return
        with open(DEFAULT_CONFIG_PATH, encoding="utf-8") as fh:
            config = Config(**json.load(fh))
        simulator = RetirementMonteCarloSimulator(config, device=device)
        # The serving probe's horizon (engine/simulator.py::_probe_batch).
        simulator.engine.probe(
            [config.starting_working_months_search],
            config.num_simulations_search,
            horizon_months=config.starting_working_months_search
            + MAX_SEARCH_YEARS * MONTHS_PER_YEAR,
        )
        simulator.engine.run(
            config.starting_working_months_search,
            config.num_simulations_main,
            reduced=True,
        )
        log.info("Warmup complete: default-scenario kernels built and launched.")
    except Exception:  # pragma: no cover - warmup is best-effort
        log.exception("Warmup failed (serving continues)")


async def _start_warmup(app: web.Application):
    # On the CPU there is nothing to build: the plain versions start cold
    # at no cost worth paying at startup.
    if os.environ.get("MCRT_WARMUP", "1") != "0" and app[DEVICE] != "cpu":
        # On the bounded engine pool: warmup is full-scale device work, so
        # it counts against the device-memory concurrency budget.
        asyncio.get_event_loop().run_in_executor(
            _ENGINE_POOL, _warmup, app[DEVICE]
        )


async def api_fallback(request: web.Request) -> web.Response:
    """Unmatched /api path (or wrong method on a real one): the FastAPI
    taxonomy — 405 with Allow when the path exists, else 404."""
    def methods_for(path: str):
        return sorted(
            r.method
            for r in request.app.router.routes()
            if r.resource is not None
            and r.resource.canonical == path
            and r.method not in ("*", "HEAD")
        )

    allowed = methods_for(request.path)
    if allowed:
        raise web.HTTPMethodNotAllowed(
            request.method, allowed, text="Method Not Allowed"
        )
    # FastAPI redirects trailing-slash variants of real routes (307 keeps
    # the method and body).
    stripped = request.path.rstrip("/")
    if stripped != request.path and request.method in methods_for(stripped):
        raise web.HTTPTemporaryRedirect(stripped)
    raise web.HTTPNotFound(text="Not Found")


def create_app(device: str = "cuda") -> web.Application:
    """The app serving every route on ``device``: "cuda" (the default)
    raises here when there is no card, "cpu" runs the plain versions."""
    require_device(device)
    # aiohttp caps request bodies at 1 MiB by default; the reference's
    # FastAPI host has no such cap, and a MAX_GRID_VARIANTS-sized grid
    # request with per-variant overrides can legitimately exceed 1 MiB.
    # 32 MiB clears any valid request by a wide margin while still
    # bounding memory (MCRT_MAX_BODY_MB to tune).
    max_body = int(os.environ.get("MCRT_MAX_BODY_MB", "32")) * 1024 * 1024
    app = web.Application(
        middlewares=[cors_middleware], client_max_size=max_body
    )
    app[DEVICE] = str(device)
    from .openapi import docs_page, openapi_json

    app.router.add_get("/api/health", health)
    # API docs — the reference's FastAPI host exposes these two routes by
    # default (reference: backend/server.py:170); parity for aiohttp.
    app.router.add_get("/openapi.json", openapi_json)
    app.router.add_get("/docs", docs_page)
    app.router.add_get("/redoc", docs_page)  # FastAPI's second default UI
    app.router.add_get("/api/analysis/meta", analysis_meta)
    app.router.add_get("/api/config/default", default_config)
    app.router.add_post("/api/validate", validate)
    app.router.add_post("/api/simulate", simulate)
    app.router.add_post("/api/simulate/stream", simulate_stream)
    app.router.add_post("/api/grid", grid)
    app.router.add_post("/api/grid/stream", grid_stream)
    app.router.add_post("/api/sensitivity", sensitivity)
    app.router.add_post("/api/sensitivity/stream", sensitivity_stream)
    app.router.add_post("/api/optimize", optimize)
    app.router.add_post("/api/optimize/stream", optimize_stream)
    # Unmatched /api requests must answer as API errors (FastAPI shape),
    # not fall through to the frontend static root — whose FileResponse
    # decides its 404 only at prepare time, after the middleware ran.
    app.router.add_route("*", "/api/{tail:.*}", api_fallback)
    if os.path.isdir(FRONTEND_DIR):
        app.router.add_get("/", index)
        app.router.add_static("/", FRONTEND_DIR)
    else:

        async def _no_frontend(_request: web.Request) -> web.Response:
            return web.json_response(
                {
                    "detail": "Dashboard assets not found. The API is live; "
                    "set MCRT_FRONTEND_DIR to a checkout's frontend/ "
                    "directory to serve the SPA."
                },
                status=404,
            )

        app.router.add_get("/", _no_frontend)
        log.warning(
            "frontend directory %s not found — serving API only "
            "(set MCRT_FRONTEND_DIR)", FRONTEND_DIR,
        )
    app.on_startup.append(_start_warmup)
    return app


def main(argv=None, host: Optional[str] = None,
         port: Optional[int] = None) -> None:
    """Serve the API on ``host``:``port`` (as the JAX ``main``: the
    argument, else ``MCRT_HOST`` / ``MCRT_PORT``, else ``PORT``, else
    0.0.0.0:8080); ``argv`` takes ``--device``."""
    parser = argparse.ArgumentParser(
        prog="mcrt-torch-server",
        description="PyTorch/CUDA retirement Monte Carlo HTTP API",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    host = host or os.environ.get("MCRT_HOST", "0.0.0.0")
    if port is None:
        port = int(os.environ.get("MCRT_PORT", os.environ.get("PORT", "8080")))
    configure_logging(logfile="server.log")
    log.info("Monte Carlo Retirement API (PyTorch, %s) starting on %s:%d",
             args.device, host, port)
    web.run_app(create_app(args.device), host=host, port=port)


if __name__ == "__main__":
    main()
