"""Structured metrics logging (``catgrasp_tpu/utils/metrics.py``): an
append-only JSONL event stream (the eval loop writes ``filter``,
``plan_fail``, ``place``, ``attempt`` and ``tally`` events).  The JAX
logger's in-memory counters are not ported: the eval sets none."""
from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from ..device import sync


class MetricsLogger:
    """Append-only JSONL event log.

    >>> log = MetricsLogger("run/metrics.jsonl", run="eval0")
    >>> log.event("attempt", round=0, picked=True)
    >>> log.close()   # writes a final "summary" event, as the JAX logger does
    """

    def __init__(self, path: str | None = None, **run_fields):
        self.path = path
        self.run_fields = run_fields
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def event(self, kind: str, **fields: Any):
        rec = {"t": round(time.time(), 3), "kind": kind, **self.run_fields,
               **{k: _jsonable(v) for k, v in fields.items()}}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self._fh:
            self.event("summary")
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StageClock:
    """Wall seconds by stage, summed into ``timings`` (synchronising the
    device at each stage's end), or nothing when ``timings`` is None."""

    def __init__(self, timings: dict | None, dev: torch.device):
        self.timings, self.dev = timings, dev
        self.t0 = time.perf_counter()

    def add(self, parts: dict | None):
        """Add stage times measured elsewhere, and restart the clock."""
        for k, v in (parts or {}).items():
            self.timings[k] = self.timings.get(k, 0.0) + v
        self.t0 = time.perf_counter()

    def lap(self, key: str):
        if self.timings is None:
            return
        sync(self.dev)
        t = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + t - self.t0
        self.t0 = t


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if hasattr(v, "item") and getattr(v, "size", 2) == 1:
            return v.item()
        if isinstance(v, np.ndarray):
            return v.tolist()
        return str(v)
