"""The arithmetic of the end-to-end metrics, the published peaks, and the
spread used to set bounds.

A rate is all the work completed in the window over the window's seconds;
a tail is over every request of the window; nothing here takes medians of
chunks."""

from __future__ import annotations

import statistics

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 multiply-adds
# per second outside the tensor cores (67 TFLOP/s counts one as two)
HBM_BYTES_PER_S = 3.35e12
F32_MULTIPLY_ADDS_PER_S = 33.5e12


def rate(work: float, seconds: float) -> float:
    return float(work) / float(seconds)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        raise ValueError("no samples")
    return float(np.percentile(v, q))


def median(values) -> float:
    return percentile(values, 50.0)


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles``' default method)."""
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def least_seconds(nbytes: float, multiply_adds: float) -> float:
    """The least time the card could take: the larger of the bytes over
    its bandwidth and the multiply-adds over its float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S,
               multiply_adds / F32_MULTIPLY_ADDS_PER_S)
