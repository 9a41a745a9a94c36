"""The program's spans over the window: the totals that the port's
``utils/profiling.py`` keeps for the last completed ``Trainer.fit``
(``last_fit()``: seconds, self seconds and calls by span path), as the
per-layer readers read them.  A program without that registry, or a run
whose last fit recorded no training batch, reads nothing."""
from __future__ import annotations


def _window() -> dict | None:
    try:
        from catgrasp_tpu_torch.utils import profiling
    except ImportError:
        return None
    last_fit = getattr(profiling, "last_fit", None)
    spans = last_fit() if last_fit is not None else None
    return spans if spans and "input.next" in spans else None


def seconds(path: str) -> float | None:
    """Host seconds inside the span at ``path`` over the window's fit (0
    where that fit never entered it)."""
    spans = _window()
    if spans is None:
        return None
    entry = spans.get(path)
    return entry["seconds"] if entry else 0.0


def ms_per_step(layer: dict, path: str) -> float | None:
    if not layer.get("steps"):
        return None
    s = seconds(path)
    return None if s is None else 1e3 * s / layer["steps"]


def share_of_window(layer: dict, path: str) -> float | None:
    """The span's seconds as a share of the window's wall, in %."""
    if not layer.get("steps") or not layer.get("wall_s"):
        return None
    s = seconds(path)
    return None if s is None else 100.0 * s / layer["wall_s"]
