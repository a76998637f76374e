"""Counters, gauges, and log-bucketed latency histograms.

The reference exposes exactly one numeric metric — index size in bytes,
``GET /worker/index-size`` (``Worker.java:147-172``) — consumed by the upload
balancer (``Leader.java:170-185``). We keep that metric (as shard ``nnz`` and
byte size) and add the counters the reference never had (§5.5 of SURVEY.md):
docs indexed, queries served, collective timings, per-phase latencies.

``observe()`` feeds BOTH a cheap (count, sum, min, max) summary and a
fixed-boundary log-bucketed histogram, so :meth:`Metrics.quantile` and
the ``_p50_ms``/``_p95_ms``/``_p99_ms`` snapshot keys report LIVE tail
latency — the number the overload/admission story is about — instead of
means. Bucket boundaries are global and geometric (``_BUCKET_RATIO``
apart, 0.1 ms … ~120 s), so a quantile estimate is within one bucket
ratio of the true value by construction; estimates additionally clamp
to the observed [min, max] (a single-sample quantile is exact).

Counters and gauges are DISTINCT namespaces, enforced loudly: a name
registered as one kind raises if emitted as the other (the old code let
``snapshot()`` silently overwrite a counter with a same-named gauge and
``get()`` documented "counters win" — both hid the bug instead of
failing it). The Prometheus exposition keeps them distinct too:
counters render as ``tfidf_<name>_total``, gauges as ``tfidf_<name>``,
histograms as ``tfidf_<name>_seconds{_bucket,_sum,_count}``.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from collections import defaultdict
from typing import Any

# geometric histogram boundaries (seconds): 0.1 ms .. ~119 s, ratio 1.2
# per bucket. A quantile read off these buckets is within one ratio of
# the true value; README "Observability" documents the contract. Bounds
# are rounded to 4 significant digits so Prometheus ``le`` labels stay
# short and stable (the <0.05% rounding is noise next to the 20% ratio).
_BUCKET_RATIO = 1.2
_BUCKET_LO_S = 1e-4
_N_BUCKETS = 78   # _BUCKET_LO_S * 1.2**77 ≈ 125 s; beyond -> +Inf bucket
BUCKET_BOUNDS_S: tuple[float, ...] = tuple(
    float(f"{_BUCKET_LO_S * _BUCKET_RATIO ** i:.4g}")
    for i in range(_N_BUCKETS))


def bucket_quantile(counts: list[int], n: int, q: float,
                    mn: float | None = None,
                    mx: float | None = None) -> float | None:
    """Quantile estimate in SECONDS from raw histogram bucket counts
    (``len == len(BUCKET_BOUNDS_S) + 1``; last is +Inf): geometric
    interpolation inside the covering bucket. The ONE implementation
    shared by the cumulative-histogram quantiles below and the SLO
    autopilot's windowed deltas (cluster/autopilot.py) — a change to
    the bucket geometry or the interpolation cannot diverge between
    them. ``mn``/``mx`` clamp to observed extremes when the caller has
    them (the cumulative path); a window delta has none, so the +Inf
    bucket falls back to the last finite bound."""
    if n <= 0:
        return None
    target = min(max(1, math.ceil(q * n)), n)
    cum = 0
    idx = len(counts) - 1
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            idx = i
            cum -= c   # cumulative BEFORE this bucket
            break
    if idx >= len(BUCKET_BOUNDS_S):       # +Inf bucket
        return mx if mx is not None else BUCKET_BOUNDS_S[-1]
    hi = BUCKET_BOUNDS_S[idx]
    lo = (BUCKET_BOUNDS_S[idx - 1] if idx > 0
          else hi / _BUCKET_RATIO)
    frac = (target - cum) / counts[idx]
    est = lo * (hi / lo) ** frac
    if mn is not None and mx is not None:
        est = min(max(est, mn), mx)
    return est


class MetricKindError(ValueError):
    """A metric name was emitted as both a counter and a gauge — the
    silent-shadowing bug class this guard exists to fail loudly."""


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        # per-name summary [count, sum, min, max] + histogram bucket
        # counts (len == len(BUCKET_BOUNDS_S) + 1; last is +Inf)
        self._timings: dict[str, list[float]] = defaultdict(
            lambda: [0, 0.0, float("inf"), 0.0])
        self._hist: dict[str, list[int]] = defaultdict(
            lambda: [0] * (len(BUCKET_BOUNDS_S) + 1))

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            if name in self._gauges:
                raise MetricKindError(
                    f"metric {name!r} is a gauge; inc() would shadow it")
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            if name in self._counters:
                raise MetricKindError(
                    f"metric {name!r} is a counter; set_gauge() would "
                    f"shadow it")
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timings[name]
            t[0] += 1
            t[1] += seconds
            t[2] = min(t[2], seconds)
            t[3] = max(t[3], seconds)
            self._hist[name][bisect.bisect_left(BUCKET_BOUNDS_S,
                                                seconds)] += 1

    def get(self, name: str, default: float = 0.0) -> float:
        """Read one counter/gauge (the namespaces are disjoint — see
        the emit-side guards) — the resilience paths and tests branch
        on live values without paying for a full snapshot."""
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, default)

    def _quantile_locked(self, name: str, q: float) -> float | None:
        """Histogram quantile estimate in SECONDS; caller holds the
        lock. Geometric interpolation inside the covering bucket,
        clamped to the observed [min, max] (single-sample exactness;
        q=0/q=1 return the true extremes)."""
        t = self._timings.get(name)
        if t is None or not t[0]:
            return None
        n, _total, mn, mx = t
        if q <= 0.0:
            return mn
        if q >= 1.0:
            return mx
        return bucket_quantile(self._hist[name], n, q, mn=mn, mx=mx)

    def hist_snapshot(self, name: str) -> tuple[list[int], int] | None:
        """Copy of one histogram's raw bucket counts plus its total
        observation count, or None when nothing was observed. The SLO
        autopilot (cluster/autopilot.py) diffs two snapshots to get a
        WINDOWED distribution — the cumulative histogram alone would
        let hours-old samples outvote the last control interval."""
        with self._lock:
            if name not in self._timings or not self._timings[name][0]:
                return None
            return list(self._hist[name]), self._timings[name][0]

    def quantile(self, name: str, q: float) -> float | None:
        """Live latency quantile in seconds (e.g. ``quantile("scatter_rpc",
        0.99)``), or None when nothing was observed. Within one bucket
        ratio (``_BUCKET_RATIO``) of the true value by construction."""
        with self._lock:
            return self._quantile_locked(name, q)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            out: dict[str, Any] = dict(self._counters)
            out.update(self._gauges)
            for name, (n, total, mn, mx) in self._timings.items():
                if n:
                    out[f"{name}_count"] = n
                    out[f"{name}_mean_ms"] = round(total / n * 1e3, 3)
                    out[f"{name}_min_ms"] = round(mn * 1e3, 3)
                    out[f"{name}_max_ms"] = round(mx * 1e3, 3)
                    # running sum: lets a scraper compute the mean over a
                    # WINDOW from two snapshots (delta sum / delta count)
                    out[f"{name}_sum_ms"] = round(total * 1e3, 3)
                    for label, q in (("p50", 0.5), ("p95", 0.95),
                                     ("p99", 0.99)):
                        v = self._quantile_locked(name, q)
                        out[f"{name}_{label}_ms"] = round(v * 1e3, 3)
            return out

    def render_prometheus(self,
                          extra_gauges: dict[str, float] | None = None
                          ) -> str:
        """Prometheus text exposition (format 0.0.4) of everything this
        registry holds: counters as ``tfidf_<name>_total``, gauges as
        ``tfidf_<name>`` (``extra_gauges`` lets the handler add derived
        values, e.g. breaker states), histograms as
        ``tfidf_<name>_seconds`` with cumulative ``_bucket`` series,
        ``_sum``, and ``_count``. Names are sanitized to the metric
        grammar; the two counter/gauge namespaces stay distinct in the
        output by construction (different rendered names)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (list(v), list(self._timings[k]))
                     for k, v in self._hist.items()
                     if self._timings[k][0]}
        lines: list[str] = []
        for name, val in sorted(counters.items()):
            m = f"tfidf_{_sanitize(name)}_total"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {_fmt(val)}")
        all_gauges = dict(gauges)
        all_gauges.update(extra_gauges or {})
        for name, val in sorted(all_gauges.items()):
            m = f"tfidf_{_sanitize(name)}"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(val)}")
        for name, (counts, (n, total, _mn, _mx)) in sorted(
                hists.items()):
            m = f"tfidf_{_sanitize(name)}_seconds"
            lines.append(f"# TYPE {m} histogram")
            cum = 0
            for bound, c in zip(BUCKET_BOUNDS_S, counts):
                cum += c
                lines.append(
                    f'{m}_bucket{{le="{_fmt(bound)}"}} {cum}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {n}')
            lines.append(f"{m}_sum {_fmt(total)}")
            lines.append(f"{m}_count {n}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timings.clear()
            self._hist.clear()


_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    s = _NAME_BAD.sub("_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _fmt(v: float) -> str:
    """Prometheus value formatting: integral floats without the
    trailing ``.0`` noise, everything else as repr (full precision)."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


global_metrics = Metrics()
