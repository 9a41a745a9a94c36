"""Tracing and profiling (``catgrasp_tpu/utils/profiling.py`` in PyTorch).

  * ``trace(logdir)``  — a device and host trace of the enclosed block
                         through ``torch.profiler`` (a TensorBoard/Perfetto
                         trace file under ``logdir``).
  * ``annotate(name)`` — a named, nestable region in that trace
                         (``record_function``).
  * ``Stopwatch``      — a host wall-time accumulator by section; it waits
                         for the device only where ``section(..., block=)``
                         asks.

All are no-ops unless enabled, so they stay in production call sites.
``trace`` is enabled by ``CATGRASP_TRACE_DIR`` (or its argument).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a device and host profile of the enclosed block into
    ``logdir``, else ``CATGRASP_TRACE_DIR``; without either a no-op."""
    logdir = logdir or os.environ.get("CATGRASP_TRACE_DIR")
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the trace, nestable."""
    with torch.profiler.record_function(name):
        yield


class Stopwatch:
    """Accumulating section timer: ``with sw.section("render"): ...``.

    Host time by default (queued device work is not waited for); with
    ``block=device`` the section ends by waiting for that device's work."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, block=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None and torch.device(block).type == "cuda":
                torch.cuda.synchronize(block)
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> dict:
        return {k: {"total_s": round(self.total[k], 4),
                    "calls": self.count[k],
                    "mean_ms": round(1e3 * self.total[k] / max(self.count[k], 1), 3)}
                for k in sorted(self.total)}

    def __str__(self):
        return json.dumps(self.report(), indent=None)
