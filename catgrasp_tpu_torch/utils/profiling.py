"""Spans, their counters and traces (``catgrasp_tpu/utils/profiling.py`` in
PyTorch).

  * ``span(name)``  — a named, nestable region of the host's work.  Every
                      span adds to a process registry kept by its path from
                      the root span (``input.next/input.read``): host
                      seconds, self seconds (less its children's) and
                      calls.  The cost is two ``perf_counter_ns`` reads and
                      a dict update, so spans stay on in production.  While
                      a ``torch.profiler`` runs, a span is also a
                      ``record_function`` range on the profiler's clock,
                      unless it is a ``device_work`` span: one in which the
                      host launches kernels or copies, which the profiler
                      would report as a CUDA-typed annotation beside the
                      device's own operations.
  * ``last_fit()``  — the registry's growth over the last completed
                      ``Trainer.fit`` call (``begin_fit``/``end_fit``):
                      ``{path: {"seconds", "self_seconds", "calls"}}``;
                      ``fit`` also writes it as its ``timing`` event in
                      ``metrics.jsonl``.
  * ``trace(logdir)`` — a device and host trace of the enclosed block
                      through ``torch.profiler`` (a TensorBoard/Perfetto
                      trace file under ``logdir``), enabled by its argument
                      or ``CATGRASP_TRACE_DIR``; without either a no-op.

The ``timing`` event and ``trace`` are the operator's exports.  Span names
are fixed strings.  Spans are opened from one thread (the training loop's)
and never stay open across a ``yield``: the path is the spans open at
entry.  A profiler that starts or stops while a span is open is harmless:
a range opened under one profiler that another has replaced by the span's
end is closed only once none runs (closing it under the new one would
write into the old one's freed records).
"""
from __future__ import annotations

import contextlib
import os
from time import perf_counter_ns

import torch
import torch.autograd.profiler as _autograd_profiler

_NS = 1e-9
_registry: dict[str, list[int]] = {}  # path -> [ns, self ns, calls]
_paths: dict[tuple, str] = {}  # (parent path, name) -> path
_open: list[list] = []  # the open spans: [path, t0 ns, children's ns]
_last_fit: dict | None = None
_starts = 0  # profilers started in this process
_parked: list = []  # ranges whose profiler another replaced before they closed


def _count_starts(start):
    def run_on_profiler_start():
        global _starts
        _starts += 1
        start()
    return run_on_profiler_start


# every torch.profiler or autograd profiler start calls this function; its
# count tells a span whether the profiler running at its end is the one it
# opened its range under
_autograd_profiler._run_on_profiler_start = _count_starts(
    _autograd_profiler._run_on_profiler_start)


class span:
    """``with span("input.read"): ...`` — see the module docstring.
    ``device_work=True`` for a span in which the host launches device work:
    it is counted but never a profiler range."""

    __slots__ = ("name", "device_work", "_frame", "_range", "_start")

    def __init__(self, name: str, device_work: bool = False):
        self.name = name
        self.device_work = device_work

    def __enter__(self):
        parent = _open[-1][0] if _open else None
        path = _paths.get((parent, self.name))
        if path is None:
            path = _paths[(parent, self.name)] = (
                self.name if parent is None else f"{parent}/{self.name}")
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            if not self.device_work:
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
                self._start = _starts
        else:
            while _parked:
                _parked.pop().__exit__(None, None, None)
        self._frame = frame = [path, 0, 0]
        _open.append(frame)
        frame[1] = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = perf_counter_ns()
        frame = self._frame
        _open.pop()
        ns = t - frame[1]
        if _open:
            _open[-1][2] += ns
        entry = _registry.get(frame[0])
        if entry is None:
            entry = _registry[frame[0]] = [0, 0, 0]
        entry[0] += ns
        entry[1] += ns - frame[2]
        entry[2] += 1
        if self._range is not None:
            if _autograd_profiler._is_profiler_enabled and _starts != self._start:
                _parked.append(self._range)
            else:
                self._range.__exit__(None, None, None)
            self._range = None
        return False


def _as_dict(reg: dict) -> dict:
    return {path: {"seconds": ns * _NS, "self_seconds": self_ns * _NS, "calls": calls}
            for path, (ns, self_ns, calls) in sorted(reg.items())}


def last_fit() -> dict | None:
    """The registry's growth over the last completed ``Trainer.fit``, or
    None before one has completed."""
    return _last_fit


def begin_fit() -> dict:
    """The registry as a ``Trainer.fit`` call starts, for ``end_fit``."""
    return {path: tuple(entry) for path, entry in _registry.items()}


def end_fit(start: dict) -> dict:
    """The registry's growth since ``begin_fit`` returned ``start``, kept as
    ``last_fit()`` and returned."""
    global _last_fit
    grown = {}
    for path, entry in _registry.items():
        old = start.get(path, (0, 0, 0))
        if entry[2] != old[2]:
            grown[path] = [a - b for a, b in zip(entry, old)]
    _last_fit = _as_dict(grown)
    return _last_fit


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
