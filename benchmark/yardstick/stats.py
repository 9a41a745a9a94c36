"""Statistics of a run's samples."""
from __future__ import annotations

import statistics


def p90(values: list[float]) -> float:
    """The 90th percentile (``statistics.quantiles``, inclusive method)."""
    if len(values) < 2:
        raise ValueError(f"a 90th percentile needs 2 or more samples, got {len(values)}")
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def beyond(values: list[float], threshold: float) -> int:
    """How many samples lie above ``threshold``."""
    return sum(v > threshold for v in values)

