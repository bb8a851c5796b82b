"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet; dense bf16 tensor cores, HBM3), and the least time of a piece of
work on it."""

from __future__ import annotations

from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, "operations" or "bytes"): the larger of ``flops`` at
    the bf16 peak and ``nbytes`` at the memory's."""
    ops_s = flops / PEAK_BF16_FLOPS
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
