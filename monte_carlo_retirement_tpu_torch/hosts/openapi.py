"""OpenAPI spec (`GET /openapi.json`) + server-rendered docs (`GET /docs`).

A copy of the JAX package's ``hosts/openapi.py`` built from the port's own
pydantic request/response models (the ones its handlers validate with), so
the documented schemas cannot drift from the wire behaviour; a test pins
the documented path set to the running router
(``tests/test_torch_server.py``). The ``/docs`` page is rendered on the
server from the spec: no client JavaScript, no CDN.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from aiohttp import web

from ..config import Config, OtherIncomeStreamConfig  # noqa: F401 (nested)
from .grid import GridRequest, GridResponse
from .optimize import OptimizeJointResponse, OptimizeRequest, OptimizeResponse
from .schemas import SimulationRequest, SimulationResponse
from .sensitivity import SensitivityRequest, SensitivityResponse

_REF_TEMPLATE = "#/components/schemas/{model}"

# Every /api error is serialized by the middleware as JSON
# ``{"detail": ...}`` — FastAPI's wire shape, which the reference SPA reads
# (`err.detail`). `detail` is a string for engine/HTTP errors and a list of
# pydantic error objects for 422s, exactly like FastAPI's generated spec.
_ERROR_DETAIL_SCHEMA = {
    "type": "object",
    "properties": {
        "detail": {
            "anyOf": [
                {"type": "string"},
                {"type": "array", "items": {"type": "object"}},
            ],
            "description": "Human-readable message, or the pydantic "
            "validation error list for 422 responses.",
        }
    },
    "required": ["detail"],
}


def _json_error(description: str) -> Dict[str, Any]:
    return {
        "description": description,
        "content": {"application/json": {"schema": _ERROR_DETAIL_SCHEMA}},
    }


_ERROR_RESPONSES = {
    "400": _json_error(
        "Valid request the engine cannot serve (e.g. the search target is "
        "unreachable, mixed grid statics)."
    ),
    "422": _json_error("Request failed validation (schema, bounds)."),
    "500": _json_error("Unexpected engine failure."),
}


def _collect(model, components: Dict[str, Any]) -> Dict[str, Any]:
    """Register ``model`` (and its nested models) under components/schemas;
    return a $ref to it."""
    schema = model.model_json_schema(ref_template=_REF_TEMPLATE)
    for name, sub in schema.pop("$defs", {}).items():
        components.setdefault(name, sub)
    components.setdefault(model.__name__, schema)
    return {"$ref": _REF_TEMPLATE.format(model=model.__name__)}


def _json_body(ref: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "required": True,
        "content": {"application/json": {"schema": ref}},
    }


def _json_ok(ref_or_schema: Dict[str, Any], description: str) -> Dict[str, Any]:
    return {
        "200": {
            "description": description,
            "content": {"application/json": {"schema": ref_or_schema}},
        },
        **_ERROR_RESPONSES,
    }


def _sse_ok(events: str) -> Dict[str, Any]:
    return {
        "200": {
            "description": (
                "Server-sent events, framed `data: <json>\\n\\n`. "
                f"Event types (field `type`): {events}. The stream "
                "terminates after the `result` or `error` event."
            ),
            "content": {"text/event-stream": {"schema": {"type": "string"}}},
        },
        **_ERROR_RESPONSES,
    }


def build_spec() -> Dict[str, Any]:
    """The OpenAPI 3.1 document for every API route the server registers."""
    components: Dict[str, Any] = {}
    sim_req = _collect(SimulationRequest, components)
    sim_resp = _collect(SimulationResponse, components)
    grid_req = _collect(GridRequest, components)
    grid_resp = _collect(GridResponse, components)
    sens_req = _collect(SensitivityRequest, components)
    sens_resp = _collect(SensitivityResponse, components)
    opt_req = _collect(OptimizeRequest, components)
    opt_resp = _collect(OptimizeResponse, components)
    opt_joint_resp = _collect(OptimizeJointResponse, components)
    config_ref = _collect(Config, components)

    paths: Dict[str, Any] = {
        "/api/health": {
            "get": {
                "summary": "Liveness probe",
                "responses": _json_ok(
                    {"type": "object",
                     "properties": {"status": {"type": "string"}}},
                    "Server is up.",
                ),
            }
        },
        "/api/config/default": {
            "get": {
                "summary": "The bundled default scenario",
                "description": "Contents of the server's default config.json "
                "(override with MCRT_DEFAULT_CONFIG).",
                "responses": _json_ok(config_ref, "The default scenario."),
            }
        },
        "/api/analysis/meta": {
            "get": {
                "summary": "Discovery for the analysis surfaces",
                "description": "Config fields the sensitivity/optimize "
                "endpoints accept (with hard bounds; an unbounded `hi` is "
                "null and needs an explicit search interval), the optimizer "
                "objectives, the default tornado set, and the joint-grid "
                "row cap.",
                "responses": _json_ok(
                    {
                        "type": "object",
                        "properties": {
                            "parameters": {"type": "array", "items": {
                                "type": "object",
                                "properties": {
                                    "name": {"type": "string"},
                                    "lo": {"type": "number"},
                                    "hi": {"type": ["number", "null"]},
                                    "kind": {"type": "string"},
                                },
                            }},
                            "objectives": {"type": "array",
                                           "items": {"type": "string"}},
                            "default_sensitivity_params": {
                                "type": "array", "items": {"type": "string"}},
                            "max_joint_rows": {"type": "integer"},
                        },
                    },
                    "Analysis metadata.",
                ),
            }
        },
        "/api/validate": {
            "post": {
                "summary": "Validate a configuration without running it",
                "requestBody": _json_body(sim_req),
                "responses": _json_ok(
                    {"type": "object", "properties": {
                        "valid": {"type": "boolean"},
                        "scenario": {"type": "string"}}},
                    "The configuration is valid.",
                ),
            }
        },
        "/api/simulate": {
            "post": {
                "summary": "Full simulation (search unless overridden) — "
                "plot-ready results",
                "description": "Runs the working-months search (skipped when "
                "`working_months_override` is set) and the final batch; "
                "returns every table and histogram the dashboard renders. "
                "Above MCRT_MAX_RAW_PATHS the histograms arrive pre-binned "
                "unless `include_raw_paths` forces the reference's raw "
                "per-path arrays.",
                "requestBody": _json_body(sim_req),
                "responses": _json_ok(sim_resp, "Simulation results."),
            }
        },
        "/api/simulate/stream": {
            "post": {
                "summary": "Simulation with SSE progress",
                "requestBody": _json_body(sim_req),
                "responses": _sse_ok(
                    "`phase`, `search_iter`, `search_refining`, "
                    "`search_complete`, `result` (payload in `data`), "
                    "`error`"
                ),
            }
        },
        "/api/grid": {
            "post": {
                "summary": "Scenario grid: config variants x working months",
                "description": "Batched on device in chunked dispatches with "
                "grid-wide common random numbers; per-variant success ± "
                "binomial sigma, mean/median and p5-p95 final-balance bands.",
                "requestBody": _json_body(grid_req),
                "responses": _json_ok(grid_resp, "Per-variant statistics."),
            }
        },
        "/api/grid/stream": {
            "post": {
                "summary": "Scenario grid with SSE progress",
                "requestBody": _json_body(grid_req),
                "responses": _sse_ok(
                    "`phase`, `grid_chunk` (per device dispatch), "
                    "`result`, `error`"
                ),
            }
        },
        "/api/sensitivity": {
            "post": {
                "summary": "Per-parameter derivatives (tornado rows)",
                "description": "Central finite differences over a "
                "common-random-numbers scenario grid (one batched dispatch "
                "of 1+2K rows), with an optional torch.func.jacfwd "
                "cross-check of the mean-final-balance slope (`include_ad`).",
                "requestBody": _json_body(sens_req),
                "responses": _json_ok(
                    sens_resp, "Rows in tornado order "
                    "(|success change per practical step| descending).",
                ),
            }
        },
        "/api/sensitivity/stream": {
            "post": {
                "summary": "Sensitivity analysis with SSE progress",
                "requestBody": _json_body(sens_req),
                "responses": _sse_ok(
                    "`phase`, `grid_chunk` (per device dispatch of the "
                    "probe rows), `result`, `error`"
                ),
            }
        },
        "/api/optimize": {
            "post": {
                "summary": "Maximize an objective over one or two config "
                "fields",
                "description": "Batched grid refinement: each round "
                "evaluates a K (or K x K) grid as ONE CRN scenario-grid "
                "dispatch and zooms every axis into the argmax "
                "neighborhood. Single-field requests (`param`) return the "
                "scalar shape; joint requests (`params`) the joint shape.",
                "requestBody": _json_body(opt_req),
                "responses": _json_ok(
                    {"oneOf": [opt_resp, opt_joint_resp]},
                    "The optimum, its refined bracket, and the round-1 "
                    "curve/surface.",
                ),
            }
        },
        "/api/optimize/stream": {
            "post": {
                "summary": "Optimization with SSE progress",
                "requestBody": _json_body(opt_req),
                "responses": _sse_ok(
                    "`phase`, `grid_chunk`, `optimize_round` (per "
                    "refinement round), `result`, `error`"
                ),
            }
        },
    }

    return {
        "openapi": "3.1.0",
        "info": {
            "title": "Retirement Monte Carlo — PyTorch/CUDA",
            "summary": "Retirement Monte Carlo simulation, search, scenario "
            "grids, sensitivity and optimization on CUDA kernels.",
            "version": "3.0.0",
        },
        "paths": paths,
        "components": {"schemas": components},
    }


# ----------------------------------------------------------------------
# /docs — server-rendered HTML (no client JS, no CDN)
# ----------------------------------------------------------------------

_DOCS_CSS = """
body{font:15px/1.5 system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1d2433}
main{max-width:960px;margin:0 auto;padding:24px 16px 64px}
h1{font-size:26px}h2{font-size:17px;margin:28px 0 6px}
.ep{background:#fff;border:1px solid #dfe3ea;border-radius:8px;padding:14px 16px;margin:14px 0}
.m{display:inline-block;font:700 12px/1 monospace;padding:4px 7px;border-radius:4px;color:#fff;margin-right:8px}
.m.get{background:#2a7d4f}.m.post{background:#2456a6}
code,.path{font-family:ui-monospace,monospace}
.path{font-weight:600}
table{border-collapse:collapse;width:100%;margin:8px 0;font-size:13.5px}
th,td{border:1px solid #e3e7ee;padding:4px 8px;text-align:left;vertical-align:top}
th{background:#eef1f6;font-weight:600}
.req{color:#a33;font-weight:600}
.muted{color:#5a6478}
details{margin:6px 0}summary{cursor:pointer;font-weight:600}
@media (prefers-color-scheme: dark){
body{background:#14171d;color:#dbe1ec}.ep{background:#1b2027;border-color:#2a313c}
th{background:#232a34}th,td{border-color:#2a313c}.muted{color:#93a0b4}}
"""


def _type_str(sch: Dict[str, Any]) -> str:
    """Human-readable type for a (possibly $ref / anyOf) schema node."""
    if "$ref" in sch:
        return sch["$ref"].rsplit("/", 1)[-1]
    if "anyOf" in sch:
        return " | ".join(_type_str(s) for s in sch["anyOf"])
    if "oneOf" in sch:
        return " | ".join(_type_str(s) for s in sch["oneOf"])
    t = sch.get("type", "any")
    if isinstance(t, list):
        return " | ".join(str(x) for x in t)
    if t == "array":
        return f"array[{_type_str(sch.get('items', {}))}]"
    if "enum" in sch:
        return " | ".join(json.dumps(v) for v in sch["enum"])
    return str(t)


def _esc(s: Any) -> str:
    return (
        str(s)
        .replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
    )


def _prop_table(schema: Dict[str, Any]) -> str:
    props = schema.get("properties")
    if not props:
        return ""
    required = set(schema.get("required", []))
    rows = []
    for name, sub in props.items():
        star = ' <span class="req">*</span>' if name in required else ""
        desc = sub.get("description", "")
        if "default" in sub and sub["default"] is not None:
            desc = f"{desc} (default {json.dumps(sub['default'])})".strip()
        rows.append(
            f"<tr><td><code>{_esc(name)}</code>{star}</td>"
            f"<td><code>{_esc(_type_str(sub))}</code></td>"
            f"<td>{_esc(desc)}</td></tr>"
        )
    return (
        "<table><tr><th>field</th><th>type</th><th>description</th></tr>"
        + "".join(rows)
        + "</table>"
    )


def render_docs_html(spec: Dict[str, Any]) -> str:
    schemas = spec["components"]["schemas"]

    def deref(node: Dict[str, Any]) -> Dict[str, Any]:
        if "$ref" in node:
            return schemas.get(node["$ref"].rsplit("/", 1)[-1], {})
        return node

    out = [
        "<!DOCTYPE html><html lang=\"en\"><head><meta charset=\"utf-8\">",
        "<meta name=\"viewport\" content=\"width=device-width,initial-scale=1\">",
        f"<title>{_esc(spec['info']['title'])} — API</title>",
        f"<style>{_DOCS_CSS}</style></head><body><main>",
        f"<h1>{_esc(spec['info']['title'])} — API reference</h1>",
        f"<p class=\"muted\">{_esc(spec['info'].get('summary', ''))} "
        "Machine-readable spec: <a href=\"/openapi.json\">"
        "<code>/openapi.json</code></a> "
        f"(OpenAPI {_esc(spec['openapi'])}).</p>",
    ]
    for path, methods in spec["paths"].items():
        for method, op in methods.items():
            out.append('<section class="ep">')
            out.append(
                f'<div><span class="m {method}">{method.upper()}</span>'
                f'<span class="path">{_esc(path)}</span></div>'
            )
            out.append(f"<p><strong>{_esc(op['summary'])}</strong></p>")
            if op.get("description"):
                out.append(f"<p class=\"muted\">{_esc(op['description'])}</p>")
            body = op.get("requestBody")
            if body:
                sch = deref(body["content"]["application/json"]["schema"])
                out.append(f"<h2>Request body — "
                           f"<code>{_esc(sch.get('title', 'object'))}</code></h2>")
                out.append(_prop_table(sch))
            ok = op["responses"]["200"]
            ctypes = ", ".join(ok.get("content", {}))
            out.append(f"<h2>200 response — <code>{_esc(ctypes)}</code></h2>")
            out.append(f"<p class=\"muted\">{_esc(ok['description'])}</p>")
            for ctype, media in ok.get("content", {}).items():
                if ctype != "application/json":
                    continue
                sch = media["schema"]
                variants = sch.get("oneOf", [sch])
                for v in variants:
                    dv = deref(v)
                    table = _prop_table(dv)
                    if table:
                        title = dv.get("title") or _type_str(v)
                        out.append(
                            f"<details><summary><code>{_esc(title)}"
                            "</code></summary>" + table + "</details>"
                        )
            out.append("</section>")

    out.append("<h1>Schemas</h1>")
    for name in sorted(schemas):
        table = _prop_table(schemas[name])
        if not table:
            continue
        out.append(
            f'<section class="ep"><details><summary><code>{_esc(name)}'
            "</code></summary>" + table + "</details></section>"
        )
    out.append("</main></body></html>")
    return "".join(out)


async def openapi_json(_request: web.Request) -> web.Response:
    return web.json_response(build_spec())


async def docs_page(_request: web.Request) -> web.Response:
    return web.Response(
        text=render_docs_html(build_spec()), content_type="text/html"
    )
