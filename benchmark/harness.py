"""What every cell shares: the cell as the run sees it, a driver's result,
and the assembly of the result's line from ``BENCHMARK.json``.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``), which runs the set-up, the window and the
comparison with the plain reference.  Each per-layer metric is read by
``metrics/<name>.py`` from what the driver gathered; the limits of the
numbers compared are ``limits/<cell>.json``.  A later cell, mix or metric
is new files and new entries, found here by name."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# what no process of the benchmark may hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "catgrasp_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # time.monotonic() when the process started


@dataclass
class Result:
    setup_s: float
    e2e: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    readings: dict  # compared number -> value
    layer: dict = field(default_factory=dict)  # what the per-layer readers read
    device: dict = field(default_factory=dict)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def make_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
              device: torch.device, t_start: float) -> Cell:
    w = find(spec["workloads"], name, "workload")
    cfg = find(spec["configs"], w["config"], "configuration")
    return Cell(name=name, config=load_json(ROOT, cfg["file"]),
                mix=load_json(HERE, "traffic", f"{w['traffic']}.json"),
                limits=load_json(HERE, "limits", f"{name}.json"), seed=seed, seconds=seconds,
                trace=trace, device=device, t_start=t_start)


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}")


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_of(spec: dict, cell: str, result: Result, trace: bool) -> dict:
    """The result's ``metrics``: the cell's end-to-end metrics, or with
    ``trace`` its per-layer metrics.  A per-layer metric that lists the cell
    and whose reader finds nothing fails the run: its layer was not read."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell)]
    if not trace:
        values = {"setup_s": result.setup_s, **result.e2e}
        missing = [m["name"] for m in e2e if m["name"] not in values]
        if missing:
            raise RuntimeError(f"{cell}: the driver reported no {missing}")
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    moved = {m["name"] for m in e2e}
    out, missing = {}, []
    for m in spec["per_layer"]:
        if ("workloads" in m and cell not in m["workloads"]) or m["moves"] not in moved:
            continue
        value = reader(m["name"])(result.layer)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        elif "workloads" in m:
            missing.append(m["name"])
    if missing:
        raise RuntimeError(f"{cell}: the traced run read nothing for {missing}")
    return out


def check(readings: dict, limits: dict) -> tuple[bool, list[str]]:
    """``correct`` and one line a number: its name, value and limit."""
    lines, ok = [], True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and value <= limit
        ok &= good
        lines.append(f"{name} {value!r} limit {limit!r}{'' if good else ' FAILED'}")
    return ok, lines


def forbidden_modules() -> list[str]:
    """The top-level names in ``sys.modules`` that are ``FORBIDDEN``,
    compared whole (``catgrasp_tpu_torch`` is not ``catgrasp_tpu``)."""
    return sorted({n.partition(".")[0] for n in sys.modules} & set(FORBIDDEN))
