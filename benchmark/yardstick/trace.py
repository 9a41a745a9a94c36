"""A bounded traced part of a run, and its reduction to what the per-layer
metrics and the result's ``breakdown`` read.

``Window`` runs ``torch.profiler`` from ``start()`` to ``stop()``;
``stop()`` waits for the device first, so the traced part ends when its
last operation has.  ``summarize`` reduces the trace: the device operations (every CUDA event the trace holds, as
``chip_smoke.py:device_profile`` counts launches), the union of their
intervals (busy time), the traced wall (first to last event of either
side), the device time by operation name, and the gaps between busy
intervals labelled by the outermost host operation in flight when each
began."""
from __future__ import annotations

import bisect
import subprocess

import torch

TOP = 10  # entries of each breakdown list


class Window:
    """``torch.profiler`` from ``start()`` to ``stop()``; the trace is
    reduced only when ``summary`` is first read, after the timed part.
    ``host=False`` traces the device and the CUDA runtime alone, which
    slows the host least: the busy share and the launches come from such
    a window; ``host=True`` adds the host's operators, which name the
    idle gaps."""

    def __init__(self, host: bool = False):
        self.host = host
        self._prof = None
        self._done = None
        self._counts = {}
        self._summary = None

    @property
    def running(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available()
        acts = ([ProfilerActivity.CUDA] if cuda else []) + (
            [ProfilerActivity.CPU] if self.host or not cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self, **counts) -> None:
        """End the traced part; ``counts`` (steps and the like) are kept
        beside the summary."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._done, self._prof, self._counts = self._prof, None, counts

    @property
    def summary(self) -> dict | None:
        if self._summary is None and self._done is not None:
            self._summary = {**summarize(self._done.events()), **self._counts}
            self._done = None
        return self._summary


def traced_summary(measure: Window, label: Window) -> dict | None:
    """The busy share, launches and device operations of ``measure``, the
    idle gaps named by the host operations of ``label``."""
    m = measure.summary
    if m is None:
        return None
    named = label.summary
    return {**m, "idle_gaps": named["idle_gaps"] if named else m["idle_gaps"]}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict:
    """Launches, busy and wall seconds, device ops by time and idle gaps by
    host operation, from a profiler's ``events()``."""
    from torch.autograd import DeviceType
    dev_ops, host_top, by_name = [], [], {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev_ops.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
        elif e.cpu_parent is None:
            host_top.append((s, t, e.name))
    if not dev_ops:
        return {"launches": 0, "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    lo = min([s for s, _ in dev_ops] + [s for s, _, _ in host_top])
    hi = max([t for _, t in dev_ops] + [t for _, t, _ in host_top])
    busy = _merge(dev_ops)
    host_top.sort()
    starts = [s for s, _, _ in host_top]
    gaps, edge = {}, lo
    for s, t in busy:
        if s > edge:
            i = bisect.bisect_right(starts, edge) - 1
            label = host_top[i][2] if i >= 0 and host_top[i][1] >= edge else "(host between operators)"
            gaps[label] = gaps.get(label, 0.0) + (s - edge)
        edge = max(edge, t)
    us = 1e-6
    return {
        "launches": len(dev_ops),
        "busy_s": sum(t - s for s, t in busy) * us,
        "window_s": (hi - lo) * us,
        "device_ops": [[n, v * us] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n, v * us] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def device_record(count: int) -> dict:
    """The card the run used: ``platform``, ``kind`` (``get_device_name``),
    ``count``, its power limit as ``nvidia-smi`` reads it, and the peak of
    the allocator's memory."""
    limit = None
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        limit = smi.stdout.strip().splitlines()[torch.cuda.current_device()].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "power_limit": limit}
