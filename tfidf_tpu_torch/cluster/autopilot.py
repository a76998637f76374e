"""Closed-loop SLO autopilot: the cluster tunes its own knobs from its
live percentiles, with a full decision audit trail.

The observability plane made tail latency observable (78-bucket live histograms,
per-request traces, Prometheus exposition); until now every knob those
signals should drive was hand-tuned static config — ``deploy/k8s.yaml``
shipped a guessed ``TFIDF_SCATTER_HEDGE_MS=250``, the admission
watermarks were fixed counts, the adaptive-linger ceiling and the
gray-failure ``breaker_slow_threshold_ms`` were constants someone
typed. This module closes the loop: a leader-side control pass riding
the reconcile-sweep cadence (like the rebalancer) that each interval

- sets ``scatter_hedge_ms`` to the WINDOWED scatter-leg p95 plus an
  epsilon (hedges fire on genuine outliers, never on the body of the
  distribution, whatever that body currently is);
- scales the admission queue high/critical watermarks from the
  measured queue-depth -> ``leader_search`` p99 relationship: p99 over
  the SLO shrinks the depth the front door may queue (shed earlier),
  p99 comfortably under the SLO *while sheds happened* grows it (stop
  refusing work the cluster could absorb) — multiplicative ratio
  steering toward ``autopilot_p99_slo_ms``, the one number the
  operator still owns;
- widens/narrows the adaptive-linger ceiling from measured
  batch-formation gain vs added wait: unfilled batches while queries
  queue -> more linger buys fill; full batches -> the wait buys
  nothing, narrow it back;
- derives ``breaker_slow_threshold_ms`` from the cross-worker
  successful-call latency-EWMA spread (median x a spread multiple), so
  "slow" means *slow relative to this cluster right now*, not a
  constant guessed for some other hardware.

Every controller shares the same discipline, because a control loop
that flaps is worse than a constant:

- **clamped bounds** — each knob has a floor and a ceiling
  (``autopilot_*_floor/ceiling``); the controller can never leave
  them, no matter what the sensors claim.
- **hysteresis** — a relative dead band (``autopilot_hysteresis``):
  targets within the band of the current value cause no movement.
- **direction confirmation** — a move needs ``autopilot_confirm``
  CONSECUTIVE sweeps proposing the same direction; one noisy window
  cannot reverse a trend.
- **damping** — only ``autopilot_step`` of the remaining error is
  applied per adjustment (geometric approach, no overshoot).
- **a global kill switch** — ``autopilot_enabled`` off (statically, or
  live via ``POST /api/autopilot``) reverts every managed knob to its
  static config value INSTANTLY and stops the loop.

Because this is the observability archetype, the autopilot is itself
fully observable: a ``tfidf_autopilot_*`` gauge per managed knob
(current value, floor, ceiling, last adjustment direction), a bounded
ring of decision records — the sensor inputs read, the decision made,
the knob written — exported via ``GET /api/autopilot`` and the CLI
``autopilot`` subcommand, every applied change logged with the sensor
values that justified it, and a span (``autopilot.sweep``) with one
``knob_adjusted`` event per change on any sweep that moved a knob.

Sensors are WINDOWED: the cumulative histograms in
:mod:`tfidf_tpu_torch.utils.metrics` are diffed between sweeps
(:class:`HistWindow`), so the controller reacts to the last control
interval, not to hours of history.
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Callable

from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import (BUCKET_BOUNDS_S, bucket_quantile,
                                           global_metrics)
from tfidf_tpu_torch.utils.tracing import epoch_now, global_tracer

if TYPE_CHECKING:   # circular at runtime: node.py constructs Autopilot
    from tfidf_tpu_torch.cluster.node import SearchNode

log = get_logger("cluster.autopilot")


def delta_quantile(counts: list[int], q: float) -> float | None:
    """Quantile estimate in SECONDS over a *delta* histogram (bucket
    counts from one window, ``len == len(BUCKET_BOUNDS_S) + 1``): the
    shared :func:`~tfidf_tpu_torch.utils.metrics.bucket_quantile` math,
    without the observed-min/max clamp (a window has no summary
    extremes) — still within one bucket ratio of truth by
    construction."""
    return bucket_quantile(counts, sum(counts), q)


class HistWindow:
    """Windowed view over one cumulative ``global_metrics`` histogram:
    ``advance()`` returns the bucket-count DELTA since the previous
    call (the first call returns everything observed so far)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._prev: tuple[list[int], int] | None = None

    def advance(self) -> tuple[list[int], int]:
        snap = global_metrics.hist_snapshot(self.name)
        prev, self._prev = self._prev, snap
        if snap is None:
            return [0] * (len(BUCKET_BOUNDS_S) + 1), 0
        counts, n = snap
        if prev is None:
            return counts, n
        pc, pn = prev
        return [c - p for c, p in zip(counts, pc)], n - pn


class CounterWindow:
    """Delta of one cumulative counter between sweeps."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._prev = 0.0

    def advance(self) -> float:
        cur = global_metrics.get(self.name, 0.0)
        d, self._prev = cur - self._prev, cur
        return d


class KnobController:
    """One managed knob: a sensor law (``sense``) plus live read/write
    accessors and the static (config) value the kill switch restores.
    The shared hysteresis/confirmation/damping discipline lives in
    :meth:`Autopilot._decide`, so every controller oscillates (or
    rather, provably does not) the same way."""

    def __init__(self, knob: str, floor: float, ceiling: float,
                 read: Callable[[], float],
                 write: Callable[[float], None],
                 static: float, integral: bool = False) -> None:
        self.knob = knob
        self.floor = float(floor)
        self.ceiling = float(max(ceiling, floor))
        self.read = read
        self.write = write
        self.static = float(static)
        self.integral = integral
        # decision state for the shared discipline
        self.pending_dir = 0     # direction awaiting confirmation
        self.confirms = 0        # consecutive sweeps proposing it
        self.last_dir = 0        # direction of the last APPLIED change
        self.smoothed: float | None = None   # EWMA-filtered target
        self.last_adjust_mono = 0.0
        self.adjustments = 0

    def quantize(self, v: float) -> float:
        return float(int(round(v))) if self.integral else round(v, 2)

    def reset(self) -> None:
        self.pending_dir = 0
        self.confirms = 0
        self.smoothed = None

    def clear_sensor_state(self) -> None:
        """Drop subclass-held sensor memory (peak-holds, calm
        counters). Called on kill-switch RE-ENABLE, where the
        documented contract is fresh windows with no stale trend —
        NOT on per-sweep reset(), where that memory is the point."""

    def revert(self) -> None:
        """Kill-switch restore. The base write path is exact for a
        single-valued knob; controllers that derive SECONDARY values
        from a write (the watermark pair) override this to restore
        every static value verbatim."""
        self.write(self.static)

    # subclasses: (target, inputs) or None when the window carries no
    # actionable signal (too few samples, no pressure, ...)
    def sense(self, frame: dict, current: float
              ) -> tuple[float, dict] | None:
        raise NotImplementedError


class HedgeController(KnobController):
    """``scatter_hedge_ms`` = windowed scatter-leg p95 + epsilon. A
    hedge should race only genuine laggards: pinned at the body of the
    distribution it would duplicate most batches' slices (roughly
    doubling steady-state load); parked far above it (the hand-tuned
    250 ms) it never fires before the tail has already happened.

    Saturation guard (The Tail at Scale's own caveat): a hedge is a
    DUPLICATE read, worth paying only while spare capacity exists to
    absorb it — under overload it amplifies the very queueing that
    made the laggard slow. While queries are queueing (the scatter
    backlog/depth signal is nonzero) the controller PARKS the hedge at
    its ceiling: in-budget tail-trimming stops, only true stalls far
    past the ceiling still get raced. The park/unpark transitions ride
    the same smoothing/hysteresis/confirmation discipline as every
    other move."""

    # unpark only after this many CONSECUTIVE pressure-free windows.
    # Parking enters through the same confirmation discipline as any
    # move (two pressure windows + damped steps toward the ceiling —
    # one noisy depth reading cannot park a healthy hedge); unparking
    # is ADDITIONALLY sticky: intermittent pressure at the saturation
    # edge still means no spare capacity for duplicates, and a
    # park/unpark cycle per pressure blip would read as flapping.
    CALM_SWEEPS = 3

    def __init__(self, cfg, read, write) -> None:
        super().__init__("scatter_hedge_ms",
                         cfg.autopilot_hedge_floor_ms,
                         cfg.autopilot_hedge_ceiling_ms,
                         read, write, cfg.scatter_hedge_ms)
        self.epsilon_ms = cfg.autopilot_hedge_epsilon_ms
        self.min_window = cfg.autopilot_min_window
        # starts satisfied: a cluster that was never under pressure
        # tracks the tail from its first window
        self._calm = self.CALM_SWEEPS

    def clear_sensor_state(self) -> None:
        self._calm = self.CALM_SWEEPS

    def sense(self, frame, current):
        if frame["depth"] > 0:
            self._calm = 0
            return self.ceiling, {
                "parked": 1, "depth": frame["depth"],
                "scatter_p95_ms": round(frame["scatter_p95_ms"], 2)}
        if self._calm < self.CALM_SWEEPS:
            self._calm += 1
            if self._calm < self.CALM_SWEEPS:
                return None   # recent pressure: stay parked, hold
        if frame["scatter_n"] < self.min_window:
            return None
        p95 = frame["scatter_p95_ms"]
        return p95 + self.epsilon_ms, {
            "scatter_p95_ms": round(p95, 2),
            "scatter_n": frame["scatter_n"],
            "epsilon_ms": self.epsilon_ms}


class WatermarkController(KnobController):
    """``admission_queue_high_water`` steered by the measured
    queue-depth -> ``leader_search`` p99 relationship: admitted p99
    over the SLO means the queue the front door tolerates is too deep
    (shrink by the p99/SLO ratio); p99 comfortably under the SLO while
    sheds happened means work was refused that would have met the SLO
    (grow by the same ratio). No sheds and p99 in budget = nothing to
    learn, hold. The critical watermark keeps the static
    critical/high ratio throughout."""

    GROW_GUARD = 0.7   # grow only when peak p99 < GROW_GUARD * slo
    PEAK_WINDOWS = 3   # peak-hold depth over recent sensor windows

    def __init__(self, cfg, read, write, revert=None) -> None:
        super().__init__("admission_queue_high_water",
                         cfg.autopilot_queue_floor,
                         cfg.autopilot_queue_ceiling,
                         read, write, cfg.admission_queue_high_water,
                         integral=True)
        self.slo_ms = cfg.autopilot_p99_slo_ms
        self.min_window = cfg.autopilot_min_window
        # peak-hold over the last few windowed p99s: an SLO is about
        # the WORST windows — under zipfian traffic most windows are
        # cache-hit-dominated and calm, and a single calm window must
        # not regrow the watermark mid-overload (that re-opens the
        # queue exactly while the tail is burning)
        self._recent_p99: deque[float] = deque(maxlen=self.PEAK_WINDOWS)
        if revert is not None:
            self.revert = revert   # exact two-value static restore

    def clear_sensor_state(self) -> None:
        self._recent_p99.clear()

    def sense(self, frame, current):
        if frame["leader_n"] < self.min_window:
            return None
        p99 = frame["leader_p99_ms"]
        if p99 <= 0:
            return None
        self._recent_p99.append(p99)
        peak = max(self._recent_p99)
        inputs = {"leader_p99_ms": round(p99, 2),
                  "peak_p99_ms": round(peak, 2),
                  "leader_n": frame["leader_n"],
                  "sheds": frame["sheds"],
                  "depth": frame["depth"], "slo_ms": self.slo_ms}
        ratio = self.slo_ms / peak
        if peak > self.slo_ms:
            # over SLO (in ANY recent window): shrink the tolerated
            # queue (ratio < 1, floored so one horrible window cannot
            # collapse the watermark)
            return current * max(ratio, 0.5), inputs
        if frame["sheds"] > 0 and peak < self.GROW_GUARD * self.slo_ms:
            # sheds while even the PEAK window comfortably met the
            # SLO: work was refused that the cluster could absorb
            return current * min(ratio, 2.0), inputs
        return None


class LingerController(KnobController):
    """Adaptive scatter-linger CEILING (``scatter_linger_max_ms``)
    from measured batch-formation gain vs added wait: batches forming
    unfilled while queries queue -> a longer linger buys fill (one RPC
    per worker serves more queries); batches already ~full -> the
    linger never actually waits (the saturation skip) and a narrower
    ceiling bounds the worst-case added latency. The linger FLOOR
    stays static — a lone query's latency tax is not this
    controller's to spend."""

    NARROW_FILL = 0.9
    WIDEN_FILL = 0.6
    TARGET_FILL = 0.75

    def __init__(self, cfg, read, write) -> None:
        # the floor can never drop the CEILING to (or below) the
        # static linger minimum: hi <= lo would flip the coalescer
        # into fixed-linger mode while this controller kept reporting
        # a steered ceiling — keep a real adaptive range above lo
        floor = max(cfg.autopilot_linger_floor_ms,
                    cfg.scatter_linger_min_ms * 1.5)
        super().__init__("scatter_linger_max_ms", floor,
                         max(cfg.autopilot_linger_ceiling_ms, floor),
                         read, write, cfg.scatter_linger_max_ms)
        self.min_window = cfg.autopilot_min_window

    def sense(self, frame, current):
        batches, items = frame["batches"], frame["items"]
        if batches < 4 or items < self.min_window:
            return None
        fill = items / (batches * max(frame["max_batch"], 1))
        inputs = {"fill": round(fill, 3), "batches": int(batches),
                  "items": int(items), "depth": frame["depth"]}
        if fill >= self.NARROW_FILL:
            return current * self.NARROW_FILL * (
                self.TARGET_FILL / fill), inputs
        if fill < self.WIDEN_FILL and frame["depth"] > 0:
            return current * min(self.TARGET_FILL / max(fill, 0.05),
                                 2.0), inputs
        return None


class SlowTripController(KnobController):
    """``breaker_slow_threshold_ms`` from the cross-worker latency-EWMA
    spread: the gray-failure trip should mean "this worker is an
    outlier against its peers right now", so the threshold tracks
    median(per-worker EWMA) x a spread multiple. Needs at least two
    workers with enough successful samples — one worker has no peers
    to be an outlier against."""

    def __init__(self, cfg, read, write) -> None:
        super().__init__("breaker_slow_threshold_ms",
                         cfg.autopilot_slow_floor_ms,
                         cfg.autopilot_slow_ceiling_ms,
                         read, write, cfg.breaker_slow_threshold_ms)
        self.mult = cfg.autopilot_slow_spread_mult
        self.min_samples = max(1, cfg.breaker_slow_min_samples)

    def sense(self, frame, current):
        ewmas = [e * 1e3 for e, n in frame["worker_ewmas"].values()
                 if n >= self.min_samples]
        if len(ewmas) < 2:
            return None
        med = statistics.median(ewmas)
        return med * self.mult, {
            "median_ewma_ms": round(med, 2),
            "workers": len(ewmas), "spread_mult": self.mult}


class TierBudgetController(KnobController):
    """``tier_hot_budget_mb`` steered toward the configured
    tier hit-rate target: a window whose hot-tier hit rate falls short
    of ``tier_hit_target`` grows the HBM budget proportionally to the
    shortfall (more segments stay resident, fewer searches stall on the
    upload ring); a window comfortably over it shrinks the budget and
    returns HBM to whatever else wants it (the dense carve-out, larger
    query batches). Skipped segments count as neither hit nor fault —
    a skip costs nothing, so it must not dilute the pressure signal.
    Needs real tier traffic: a window with too few lookups (everything
    skipped, or no queries) carries no signal."""

    def __init__(self, cfg, read, write) -> None:
        super().__init__("tier_hot_budget_mb",
                         cfg.autopilot_tier_floor_mb,
                         cfg.autopilot_tier_ceiling_mb,
                         read, write, cfg.tier_hot_budget_mb,
                         integral=True)
        self.target = min(max(cfg.tier_hit_target, 0.0), 1.0)
        self.min_window = cfg.autopilot_min_window

    def sense(self, frame, current):
        lookups = frame["tier_hits"] + frame["tier_faults"]
        if lookups < self.min_window:
            return None
        rate = frame["tier_hits"] / lookups
        inputs = {"tier_hit_rate": round(rate, 3),
                  "tier_lookups": int(lookups),
                  "hit_target": self.target}
        return current * (1.0 + (self.target - rate)), inputs


class Autopilot:
    """The leader-side control loop. Constructed on every node (like
    the rebalancer); ``maybe_run`` is called from the reconcile sweep
    loop and does work only while this node is leader and the loop is
    enabled, self-paced by ``autopilot_interval_ms``.

    Thread model: ``run_once`` executes only on the sweep thread (or a
    test's thread) — controller state needs no lock. The decision ring
    is a bounded deque (GIL-atomic appends; readers copy). Knob writes
    are plain attribute stores on the live objects (admission
    controller, coalescer, resilience bundle) — the same GIL-atomic
    contract their hot-path readers already rely on. ``set_enabled``
    (the kill switch) takes a small lock only against a concurrent
    sweep deciding from pre-revert reads."""

    def __init__(self, node: SearchNode) -> None:
        self.node = node
        cfg = node.config
        self.cfg = cfg
        self.enabled = bool(cfg.autopilot_enabled)
        self.interval_s = cfg.autopilot_interval_ms / 1e3
        self.hysteresis = max(0.0, cfg.autopilot_hysteresis)
        self.step = min(max(cfg.autopilot_step, 0.05), 1.0)
        self.confirm = max(1, cfg.autopilot_confirm)
        self._ring: deque[dict] = deque(maxlen=max(16,
                                                   cfg.autopilot_ring))
        self._seq = 0
        self._last_decision_mono = 0.0
        self._last_run = time.monotonic()
        self._lock = threading.Lock()   # kill switch vs in-flight sweep

        self.controllers: list[KnobController] = [
            HedgeController(
                cfg,
                read=lambda: float(node.hedge_ms),
                write=lambda v: setattr(node, "hedge_ms", float(v))),
            SlowTripController(
                cfg,
                read=lambda: node.resilience.slow_threshold_s * 1e3,
                write=lambda v: setattr(node.resilience,
                                        "slow_threshold_s", v / 1e3)),
        ]
        # the watermark controller only exists where backpressure is
        # armed: with the high-water mark statically 0 the operator
        # turned queue shedding off, and a multiplicative controller
        # has no lever to scale (0 x anything = 0)
        if cfg.admission_enabled and cfg.admission_queue_high_water > 0:
            self.controllers.append(WatermarkController(
                cfg,
                read=lambda: float(node.admission.high_water),
                write=self._write_watermarks,
                revert=self._revert_watermarks))
        # the linger controller only exists where there is an adaptive
        # scatter coalescer to steer (micro-batching on, adaptation
        # armed — hi > lo; with bounds disabled the operator chose a
        # fixed linger, which is theirs to keep)
        b = node.scatter_batcher
        if b is not None:
            lo_s, hi_s = b.linger_bounds()
            if hi_s > lo_s:
                self.controllers.append(LingerController(
                    cfg,
                    read=lambda: b.linger_bounds()[1] * 1e3,
                    write=lambda v: b.set_linger_bounds(hi_s=v / 1e3)))
        # the tier-budget controller only exists where a tiered
        # segmented index is serving (engine.tier) — it steers this
        # node's hot-set HBM budget toward the tier hit-rate target.
        # Not every autopilot host HAS an engine: the stateless router
        # tier runs an autopilot too (hedge/linger knobs) and serves
        # no index at all
        tier = getattr(getattr(node, "engine", None), "tier", None)
        if tier is not None:
            self.controllers.append(TierBudgetController(
                cfg,
                read=lambda: float(tier.budget_bytes >> 20),
                write=lambda v: tier.set_budget(int(v) << 20)))
        # the critical/high ratio the watermark controller preserves
        hw = max(1, cfg.admission_queue_high_water)
        self._critical_ratio = (cfg.admission_queue_critical / hw
                                if cfg.admission_queue_critical > 0
                                else 0.0)

        # sensor windows (shared across controllers; advanced once per
        # sweep so every controller sees the same frame)
        self._w_scatter = HistWindow("scatter_rpc")
        self._w_leader = HistWindow("leader_search")
        self._c_batches = CounterWindow("scatter_batches")
        self._c_items = CounterWindow("scatter_items")
        self._c_sheds = CounterWindow("admission_shed_total")
        self._c_tier_hits = CounterWindow("tier_hot_hits")
        self._c_tier_faults = CounterWindow("tier_cold_faults")

        # windows start NOW: the first control pass must see only what
        # happened since this autopilot existed, not the process's
        # whole metric history (an in-process test cluster shares
        # global_metrics across nodes)
        self._reset_windows()
        if self.enabled:
            self._bootstrap()
        self._publish_gauges()

    # ---- knob write helpers ----

    def _write_watermarks(self, v: float) -> None:
        adm = self.node.admission
        adm.high_water = int(v)
        if self._critical_ratio > 0:
            adm.critical = max(round(v * self._critical_ratio),
                               adm.high_water + 1)

    def _revert_watermarks(self) -> None:
        """Kill-switch path: BOTH watermarks restored verbatim from
        config — re-deriving critical through the float ratio could be
        off by one (int truncation of c/h*h), and the revert contract
        is exact static values, not a reconstruction."""
        adm = self.node.admission
        adm.high_water = self.cfg.admission_queue_high_water
        adm.critical = self.cfg.admission_queue_critical

    def _bootstrap(self) -> None:
        """Arm sensors that static config leaves off: with
        ``breaker_slow_threshold_ms=0`` the per-worker latency EWMA is
        never collected, so the slow-trip controller would starve
        forever. Seed the threshold at its ceiling — collection turns
        on, no trip can fire before the controller has derived a real
        value from the spread."""
        res = self.node.resilience
        if res.slow_threshold_s <= 0:
            ceiling_ms = self.cfg.autopilot_slow_ceiling_ms
            res.slow_threshold_s = ceiling_ms / 1e3
            self._record(knob="breaker_slow_threshold_ms",
                         current=0.0, target=ceiling_ms,
                         new=ceiling_ms, direction=1, applied=True,
                         reason="bootstrap:arm_ewma_collection",
                         inputs={})

    # ---- the control loop ----

    def maybe_run(self) -> None:
        """Self-paced pass inside the leader's sweep loop (mirrors
        ``Rebalancer.maybe_run``)."""
        if not self.enabled or self.cfg.autopilot_interval_ms < 0:
            return
        now = time.monotonic()
        if now - self._last_run < self.interval_s:
            return
        self._last_run = now
        self.run_once()

    def _frame(self) -> dict:
        sc_counts, sc_n = self._w_scatter.advance()
        ld_counts, ld_n = self._w_leader.advance()
        sp95 = delta_quantile(sc_counts, 0.95)
        lp99 = delta_quantile(ld_counts, 0.99)
        b = self.node.scatter_batcher
        depth = global_metrics.get("last_scatter_queue_depth", 0.0)
        if b is not None:
            depth = max(depth, float(b.backlog()))
        return {
            "scatter_p95_ms": (sp95 or 0.0) * 1e3, "scatter_n": sc_n,
            "leader_p99_ms": (lp99 or 0.0) * 1e3, "leader_n": ld_n,
            "batches": self._c_batches.advance(),
            "items": self._c_items.advance(),
            "sheds": self._c_sheds.advance(),
            "tier_hits": self._c_tier_hits.advance(),
            "tier_faults": self._c_tier_faults.advance(),
            "depth": depth,
            "max_batch": b.max_batch if b is not None else 0,
            "worker_ewmas": self.node.resilience.latency_snapshot(),
        }

    def run_once(self) -> list[dict]:
        """One control pass: advance the sensor windows, decide every
        knob, apply confirmed moves (inside an ``autopilot.sweep``
        span when any knob changed), record every decision. Public so
        tests and operators can force a pass. Returns the applied
        decisions."""
        if not self.enabled:
            return []
        # the fault point AND the sensor reads run OUTSIDE the lock:
        # an armed delay rule sleeps, and the frame takes the metrics/
        # EWMA locks — the kill switch must never queue behind either
        # (run_once itself is single-threaded: the sweep thread). A
        # kill switch racing this frame is re-checked under the lock
        # before anything is decided or written.
        global_injector.check("leader.autopilot")
        frame = self._frame()
        with self._lock:
            if not self.enabled:
                return []
            global_metrics.inc("autopilot_sweeps")
            decisions = [self._decide(c, frame)
                         for c in self.controllers]
            applied = [d for d in decisions if d is not None
                       and d["applied"]]
            if applied:
                # the sweep that changes a knob gets a trace of its
                # own: one span, one knob_adjusted event per change,
                # carrying the sensor inputs that justified it
                with global_tracer.span(
                        "autopilot.sweep",
                        attrs={"adjusted": len(applied)}) as sp:
                    for d in applied:
                        ctl = next(c for c in self.controllers
                                   if c.knob == d["knob"])
                        ctl.write(d["new"])
                        ctl.last_dir = d["direction"]
                        ctl.last_adjust_mono = time.monotonic()
                        ctl.adjustments += 1
                        global_metrics.inc("autopilot_adjustments")
                        sp.event("knob_adjusted", knob=d["knob"],
                                 old=d["current"], new=d["new"],
                                 direction=d["direction"],
                                 **d["inputs"])
                        log.info("autopilot adjusted knob",
                                 knob=d["knob"], old=d["current"],
                                 new=d["new"],
                                 direction=d["direction"],
                                 **d["inputs"])
            self._publish_gauges()
            return applied

    # EWMA weight of the NEW raw target in the smoothed target: the
    # band/step act on the filtered value, so a single outlier window
    # moves the effective target only halfway toward itself
    TARGET_SMOOTHING = 0.5

    def _decide(self, ctl: KnobController, frame: dict) -> dict | None:
        """The shared discipline: clamp -> target smoothing ->
        hysteresis dead band -> raw-agreement + reversal guard ->
        direction confirmation -> damped step. Returns the decision
        record (also appended to the ring), or None when the window
        carried no signal for this knob (not recorded — a ring full
        of idle-cluster no-ops would bury the decisions that
        matter)."""
        current = ctl.read()
        sensed = ctl.sense(frame, current)
        if sensed is None:
            # a no-signal sweep breaks any confirmation streak: the
            # "consecutive sweeps" contract means consecutive — one
            # stale proposal from before a traffic gap must not let a
            # single noisy window move the knob hours later
            ctl.reset()
            return None
        raw, inputs = sensed
        raw = min(max(raw, ctl.floor), ctl.ceiling)
        # target smoothing: the band and the step see an EWMA of the
        # sensed targets, not each window's raw sample (a convex
        # combination of clamped values stays clamped)
        target = (raw if ctl.smoothed is None else
                  self.TARGET_SMOOTHING * raw
                  + (1.0 - self.TARGET_SMOOTHING) * ctl.smoothed)
        ctl.smoothed = target
        band = self.hysteresis * max(abs(current), 1e-9)
        err = target - current
        if abs(err) <= band:
            ctl.reset()
            return self._record(
                knob=ctl.knob, current=current, target=target,
                new=None, direction=0, applied=False,
                reason="hold:in_band", inputs=inputs)
        direction = 1 if err > 0 else -1
        # raw agreement: this sweep's UNSMOOTHED sample must point the
        # same way (beyond the band) before it may confirm — a sensor
        # alternating hard around the knob never accumulates
        # confirmations, however far its smoothed mean drifts
        raw_dir = (1 if raw > current + band
                   else -1 if raw < current - band else 0)
        if raw_dir != direction:
            ctl.reset()
            return self._record(
                knob=ctl.knob, current=current, target=target,
                new=None, direction=direction, applied=False,
                reason="hold:noisy", inputs=inputs)
        # reversal guard: undoing the LAST applied adjustment demands
        # an error beyond TWICE the band — noise that barely clears
        # the band cannot walk the knob back and forth, while a
        # genuine load step (error >> band) reverses immediately
        if (ctl.last_dir != 0 and direction != ctl.last_dir
                and abs(err) <= 2.0 * band):
            ctl.pending_dir = 0
            ctl.confirms = 0
            return self._record(
                knob=ctl.knob, current=current, target=target,
                new=None, direction=direction, applied=False,
                reason="hold:reversal_guard", inputs=inputs)
        if direction != ctl.pending_dir:
            ctl.pending_dir = direction
            ctl.confirms = 1
        else:
            ctl.confirms += 1
        if ctl.confirms < self.confirm:
            return self._record(
                knob=ctl.knob, current=current, target=target,
                new=None, direction=direction, applied=False,
                reason=f"hold:confirm_{ctl.confirms}"
                       f"_of_{self.confirm}", inputs=inputs)
        new = ctl.quantize(min(max(current + self.step * err,
                                   ctl.floor), ctl.ceiling))
        if new == ctl.quantize(current) and ctl.integral:
            # minimum-step rule for integer knobs: at small values the
            # damped fraction rounds back onto the current value and
            # the controller deadlocks (a watermark of 4 with a 0.83
            # shrink ratio proposes 3.67 -> rounds to 4, forever) —
            # an out-of-band error always moves an integral knob by
            # at least one unit toward the target
            new = ctl.quantize(min(max(current + direction,
                                       ctl.floor), ctl.ceiling))
        if new == ctl.quantize(current):
            return self._record(
                knob=ctl.knob, current=current, target=target,
                new=None, direction=direction, applied=False,
                reason="hold:quantized", inputs=inputs)
        return self._record(
            knob=ctl.knob, current=current, target=target, new=new,
            direction=direction, applied=True, reason="adjusted",
            inputs=inputs)

    # ---- kill switch ----

    def set_enabled(self, on: bool) -> dict:
        """The global kill switch. Disabling reverts EVERY managed
        knob to its static config value before returning — by the
        time the caller sees the reply, the cluster behaves exactly
        as if the autopilot had never run. Re-enabling restarts from
        static values with fresh sensor windows (no stale trend may
        carry over)."""
        with self._lock:
            if on == self.enabled:
                return self.snapshot()
            self.enabled = on
            if on:
                self._reset_windows()
                for ctl in self.controllers:
                    ctl.reset()
                    ctl.clear_sensor_state()
                self._bootstrap()
                self._last_run = time.monotonic()
                log.info("autopilot enabled")
            else:
                for ctl in self.controllers:
                    current = ctl.read()
                    ctl.revert()
                    ctl.reset()
                    ctl.last_dir = 0
                    self._record(
                        knob=ctl.knob, current=current,
                        target=ctl.static, new=ctl.static,
                        direction=0, applied=True,
                        reason="revert:kill_switch", inputs={})
                global_metrics.inc("autopilot_reverts")
                log.info("autopilot disabled; all knobs reverted to "
                         "static config")
            self._publish_gauges()
            return self.snapshot()

    def _reset_windows(self) -> None:
        for w in (self._w_scatter, self._w_leader):
            w.advance()
        for c in (self._c_batches, self._c_items, self._c_sheds,
                  self._c_tier_hits, self._c_tier_faults):
            c.advance()

    # ---- audit trail ----

    def _record(self, **kw) -> dict:
        self._seq += 1
        rec = {"seq": self._seq, "ts": round(epoch_now(), 3), **kw}
        self._ring.append(rec)
        self._last_decision_mono = time.monotonic()
        return rec

    def decisions(self, n: int = 50) -> list[dict]:
        """The newest ``n`` decision records, oldest first."""
        if n <= 0:
            return []
        recs = list(self._ring)
        return recs[-n:]

    def snapshot(self) -> dict:
        """Operator view for ``GET /api/autopilot``, ``/api/health``
        consumers, and the CLI summary blocks."""
        now = time.monotonic()
        knobs = {}
        for ctl in self.controllers:
            knobs[ctl.knob] = {
                "current": round(ctl.read(), 2),
                "static": round(ctl.static, 2),
                "floor": ctl.floor, "ceiling": ctl.ceiling,
                "last_direction": ctl.last_dir,
                "adjustments": ctl.adjustments,
                "last_adjust_age_s":
                    round(now - ctl.last_adjust_mono, 1)
                    if ctl.last_adjust_mono else None,
            }
        return {"enabled": self.enabled,
                "interval_ms": self.cfg.autopilot_interval_ms,
                "hysteresis": self.hysteresis, "step": self.step,
                "confirm": self.confirm,
                "p99_slo_ms": self.cfg.autopilot_p99_slo_ms,
                "knobs": knobs,
                "decisions_recorded": len(self._ring),
                "last_decision_age_s":
                    round(now - self._last_decision_mono, 1)
                    if self._last_decision_mono else None}

    def _publish_gauges(self) -> None:
        global_metrics.set_gauge("autopilot_active",
                                 1.0 if self.enabled else 0.0)
        for ctl in self.controllers:
            k = ctl.knob
            global_metrics.set_gauge(f"autopilot_{k}", ctl.read())
            global_metrics.set_gauge(f"autopilot_{k}_floor", ctl.floor)
            global_metrics.set_gauge(f"autopilot_{k}_ceiling",
                                     ctl.ceiling)
            global_metrics.set_gauge(f"autopilot_{k}_direction",
                                     ctl.last_dir)
