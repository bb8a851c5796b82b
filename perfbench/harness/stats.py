"""The statistics the benchmark reports and its bounds are set from."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, interpolated
    linearly between the two nearest ranks (numpy's default method)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q / 100.0
    low = int(pos)
    high = min(low + 1, len(ordered) - 1)
    return ordered[low] + (ordered[high] - ordered[low]) * (pos - low)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of the
    median, the quartiles as ``statistics.quantiles(values, n=4)`` gives
    them: how a bound is set from repeated runs."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))
