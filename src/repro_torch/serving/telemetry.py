"""Swallow §IV made first-class: the instrumentation plane.

The paper's contribution is not the 480 cores but the *measurement* of
them — per-core power rails, instruction counters, and the §V/§VI
models that make performance attributable to communication and energy.
This module is that plane for the serving stack: one metrics
implementation, one event tracer, and the predicted-vs-measured hooks
that let every dispatch answer "did the cost model price you right?".

Three pieces, all pure host-side (no jax imports — unit-testable
anywhere, importable from CI scripts):

* :class:`HistogramDigest` — a streaming percentile digest.  Up to
  ``exact_max`` observations it keeps the raw samples and computes
  percentiles exactly (``numpy.percentile`` semantics, so values are
  bit-equal to the hand-rolled call sites it replaces); past that it
  spills to log-spaced buckets with bounded relative error
  (``rel_err``), keeping memory O(log range) no matter how long the
  server runs.

* :class:`MetricsRegistry` — counters, gauges (stored or computed), and
  named digests behind one snapshot/reset surface.  The
  :func:`counter_attr` / :func:`gauge_attr` descriptors expose registry
  slots as plain attributes, so ``self.h2d_syncs += 1`` in the engine
  and ``eng.h2d_syncs == 10`` in tests keep working verbatim while the
  storage moves into the registry ("same external names, one
  implementation").

* :class:`StepTracer` — a bounded ring-buffer flight recorder of spans
  on the *step clock* (plus wall stamps for rendering).  Two span
  categories: request-lifecycle states
  (queued→prefilling→running→preempted/recovered→finished/shed), one
  lane per request under a per-tenant track group; and dispatch spans
  (scan / draft_verify / chunk_prefill / cow_copy / prefill), each
  carrying the cost engine's predicted seconds and §VI energy next to
  measured wall time.  Exports Chrome trace-event JSON (loads in
  Perfetto), dumps the last N spans to a timestamped post-mortem file
  on invariant violation, and rolls dispatch spans into a per-phase
  model-error report.

Scheduling never reads the tracer and the tracer never touches the step
clock, so tokens are bit-identical tracing on or off — the property
``BENCH_obs.json`` pins.  See docs/OBSERVABILITY.md for the span
taxonomy and metrics schema.
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "HistogramDigest", "MetricsRegistry", "counter_attr", "gauge_attr",
    "Span", "StepTracer", "validate_chrome_trace", "rollup_dispatch_events",
    "format_model_error",
]


# ---------------------------------------------------------------------------
# streaming percentiles
# ---------------------------------------------------------------------------
class HistogramDigest:
    """Streaming p50/p95/p99 with an exact regime and a bounded spill.

    Observations up to ``exact_max`` are kept verbatim and percentiles
    use ``numpy.percentile`` (linear interpolation) — identical to the
    scattered call sites this class replaces, so committed benchmark
    gate values do not move.  Beyond that the digest folds into
    log-spaced buckets: value ``v`` lands in bucket
    ``ceil(log_gamma v)`` with ``gamma = (1+rel_err)/(1-rel_err)``, and
    a bucket's representative value is the geometric midpoint, so any
    reported percentile is within ``rel_err`` of the true sample
    (DDSketch's guarantee).  Non-positive observations share one
    underflow bucket (measured durations and step counts are >= 0).
    """

    def __init__(self, exact_max: int = 4096, rel_err: float = 0.01):
        assert exact_max >= 1 and 0.0 < rel_err < 1.0
        self.exact_max = exact_max
        self.rel_err = rel_err
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._lg = math.log(self._gamma)
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._exact: Optional[List[float]] = []
        self._buckets: Dict[int, int] = {}   # key -> count (spilled regime)
        self._zeros = 0                      # v <= 0 underflow bucket

    # -- ingest ------------------------------------------------------------
    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if self._exact is not None:
            self._exact.append(v)
            if len(self._exact) > self.exact_max:
                self._spill()
        else:
            self._bucket_add(v)

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    @classmethod
    def of(cls, values: Iterable[float], **kw) -> "HistogramDigest":
        d = cls(**kw)
        d.observe_many(values)
        return d

    # -- spill machinery ---------------------------------------------------
    def _key(self, v: float) -> int:
        return int(math.ceil(math.log(v) / self._lg))

    def _rep(self, key: int) -> float:
        # geometric midpoint of (gamma^(k-1), gamma^k]
        return 2.0 * self._gamma ** key / (self._gamma + 1.0)

    def _bucket_add(self, v: float) -> None:
        if v <= 0.0:
            self._zeros += 1
        else:
            k = self._key(v)
            self._buckets[k] = self._buckets.get(k, 0) + 1

    def _spill(self) -> None:
        samples, self._exact = self._exact, None
        for v in samples:
            self._bucket_add(v)

    @property
    def exact(self) -> bool:
        """True while percentiles are still computed on raw samples."""
        return self._exact is not None

    # -- read --------------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if self._exact is not None:
            return float(np.percentile(np.asarray(self._exact, np.float64), q))
        # nearest-rank over the spilled buckets (rel_err-bounded values)
        target = q / 100.0 * (self.count - 1)
        cum = 0
        if self._zeros:
            cum += self._zeros
            if cum - 1 >= target:
                return max(self.vmin, 0.0) if self.vmin < math.inf else 0.0
        for k in sorted(self._buckets):
            cum += self._buckets[k]
            if cum - 1 >= target:
                return min(max(self._rep(k), self.vmin), self.vmax)
        return self.vmax

    def percentiles(self, qs: Sequence[float]) -> List[float]:
        return [self.percentile(q) for q in qs]

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": self.count, "mean": self.mean,
            "min": self.vmin, "max": self.vmax,
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
class MetricsRegistry:
    """Counters, gauges, and digests behind one snapshot/reset surface.

    Counters are monotonic-ish numbers owned by the instrumented code
    (the descriptors below let ``self.x += 1`` write straight through).
    Gauges are either stored values (:meth:`set_gauge`) or zero-argument
    callables (:meth:`register_gauge`) sampled at snapshot time — the
    allocator registers ``pages_in_use`` etc. as callables so the
    registry never caches stale occupancy.  Histograms are
    :class:`HistogramDigest` instances created on first
    :meth:`observe`.
    """

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._gauge_fns: Dict[str, Callable[[], float]] = {}
        self.hists: Dict[str, HistogramDigest] = {}

    # -- counters ----------------------------------------------------------
    def counter(self, name: str) -> float:
        return self.counters.get(name, 0)

    def inc(self, name: str, amount: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + amount

    def set_counter(self, name: str, value: float) -> None:
        self.counters[name] = value

    # -- gauges ------------------------------------------------------------
    def gauge(self, name: str, default: float = 0.0) -> float:
        fn = self._gauge_fns.get(name)
        if fn is not None:
            return fn()
        return self.gauges.get(name, default)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        self._gauge_fns[name] = fn

    # -- histograms --------------------------------------------------------
    def hist(self, name: str, **kw) -> HistogramDigest:
        d = self.hists.get(name)
        if d is None:
            d = self.hists[name] = HistogramDigest(**kw)
        return d

    def observe(self, name: str, value: float) -> None:
        self.hist(name).observe(value)

    def percentile(self, name: str, q: float, default: float = 0.0) -> float:
        d = self.hists.get(name)
        if d is None or d.count == 0:
            return default
        return d.percentile(q)

    # -- lifecycle ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        gauges = {n: fn() for n, fn in self._gauge_fns.items()}
        gauges.update(self.gauges)
        return {
            "counters": dict(self.counters),
            "gauges": gauges,
            "histograms": {n: d.snapshot() for n, d in self.hists.items()},
        }

    def reset(self) -> None:
        """Zero counters and stored gauges, reset digests; registered
        gauge callables (live views) are untouched.  Keys persist so
        the snapshot schema is stable across a warmup reset."""
        for n in self.counters:
            self.counters[n] = 0
        for n in self.gauges:
            self.gauges[n] = 0
        for d in self.hists.values():
            d.reset()


class counter_attr:
    """Data descriptor exposing a registry counter as a plain attribute.

    ``class Eng: h2d_syncs = counter_attr()`` makes ``self.h2d_syncs``
    read/write ``self.registry.counters["h2d_syncs"]`` — existing
    increment sites and tests that poke the attribute keep working
    while the registry becomes the single storage.
    """

    def __init__(self, name: Optional[str] = None, registry: str = "registry"):
        self.name = name
        self.registry = registry

    def __set_name__(self, owner, attr):
        if self.name is None:
            self.name = attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self.registry).counters.get(self.name, 0)

    def __set__(self, obj, value):
        getattr(obj, self.registry).counters[self.name] = value


class gauge_attr:
    """Like :func:`counter_attr` but over the registry's stored gauges
    (point-in-time values: occupancy, rates, percentiles-at-report)."""

    def __init__(self, name: Optional[str] = None, registry: str = "registry",
                 default: float = 0.0):
        self.name = name
        self.registry = registry
        self.default = default

    def __set_name__(self, owner, attr):
        if self.name is None:
            self.name = attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self.registry).gauges.get(self.name, self.default)

    def __set__(self, obj, value):
        getattr(obj, self.registry).gauges[self.name] = value


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------
@dataclass
class Span:
    """One closed interval on a track.

    ``group``/``track`` name the Perfetto process/thread lanes;
    ``start_step``/``end_step`` are deterministic step-clock stamps;
    ``t0``/``t1`` are wall (perf_counter) stamps used only for
    rendering.  ``args`` carries per-span payload — for dispatch spans
    the predicted/measured attribution triple."""
    name: str
    cat: str              # "dispatch" | "request" | "marker"
    group: str            # process lane, e.g. "dispatch" or "tenant:acme"
    track: str            # thread lane, e.g. "scan" or the request id
    start_step: int
    end_step: int
    t0: float
    t1: float
    args: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "cat": self.cat, "group": self.group,
            "track": self.track, "start_step": self.start_step,
            "end_step": self.end_step, "t0": self.t0, "t1": self.t1,
            "args": dict(self.args),
        }


# terminal request states close the lane instead of opening a new span
_TERMINAL = ("finished", "shed")


class StepTracer:
    """Bounded ring-buffer flight recorder on the step clock.

    The engine/scheduler call :meth:`request_event` at every lifecycle
    transition and wrap device dispatches in :meth:`dispatch`; the ring
    (``capacity`` spans, FIFO eviction) always holds the most recent
    history, which :meth:`flight_dump` writes out on an invariant
    violation and :meth:`chrome_trace` exports for Perfetto.
    """

    def __init__(self, capacity: int = 4096, dump_dir: str = "."):
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.reset()

    def reset(self) -> None:
        self.spans: deque = deque(maxlen=self.capacity)
        self.recorded = 0                     # total ever recorded
        self.samples: deque = deque(maxlen=self.capacity)  # (step, wall, [per-node])
        self._open: Dict[str, Span] = {}      # rid -> open lifecycle span
        self._origin = time.perf_counter()

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring (recorded - retained)."""
        return self.recorded - len(self.spans)

    @property
    def open_spans(self) -> Dict[str, Span]:
        return dict(self._open)

    def _record(self, span: Span) -> None:
        self.spans.append(span)
        self.recorded += 1

    # -- dispatch spans ----------------------------------------------------
    @contextmanager
    def dispatch(self, phase: str, step: int, *, predicted_s: float = 0.0,
                 predicted_j: float = 0.0, **extra):
        """Wrap one device dispatch; measured wall time is the context
        body's duration, recorded next to the cost engine's prediction."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            args = {"predicted_s": float(predicted_s),
                    "predicted_j": float(predicted_j),
                    "measured_s": t1 - t0}
            args.update(extra)
            self._record(Span(phase, "dispatch", "dispatch", phase,
                              step, step, t0, t1, args))

    # -- request lifecycle spans ------------------------------------------
    def request_event(self, rid: str, state: str, step: int, *,
                      tenant: str = "default", **args) -> None:
        """Close the request's current state span (if any) and open the
        next — or record a zero-length terminal marker for
        finished/shed.  One lane per request id under a per-tenant
        group, so spans on a lane never overlap by construction."""
        now = time.perf_counter()
        group = f"tenant:{tenant}"
        prev = self._open.pop(rid, None)
        if prev is not None:
            prev.end_step = step
            prev.t1 = now
            self._record(prev)
        if state in _TERMINAL:
            self._record(Span(state, "marker", group, rid, step, step,
                              now, now, dict(args)))
        else:
            self._open[rid] = Span(state, "request", group, rid, step, step,
                                   now, now, dict(args))

    def finalize(self, step: int) -> None:
        """Close every still-open lifecycle span (end of run)."""
        for rid in list(self._open):
            span = self._open.pop(rid)
            span.end_step = step
            span.t1 = time.perf_counter()
            self._record(span)

    # -- counter tracks ----------------------------------------------------
    def counter_sample(self, step: int, values: Sequence[int]) -> None:
        """Per-node page occupancy sample (rendered as a stacked
        Perfetto counter track)."""
        self.samples.append((int(step), time.perf_counter(), list(values)))

    # -- model error -------------------------------------------------------
    def model_error_report(self) -> Dict[str, Dict[str, float]]:
        """Per-phase predicted-vs-measured rollup over the dispatch
        spans still in the ring."""
        return rollup_dispatch_events(
            {"cat": s.cat, "name": s.name, "args": s.args}
            for s in self.spans)

    # -- exports -----------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (dict).  ``ph:"X"`` complete events
        on integer pid/tid lanes named by metadata events; counter
        samples become ``ph:"C"`` events.  Load the written file in
        Perfetto (ui.perfetto.dev) or chrome://tracing."""
        events: List[Dict[str, Any]] = []
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}

        def pid_of(group: str) -> int:
            if group not in pids:
                pid = pids[group] = len(pids) + 1
                events.append({"name": "process_name", "ph": "M", "pid": pid,
                               "tid": 0, "args": {"name": group}})
            return pids[group]

        def tid_of(group: str, track: str) -> int:
            key = (group, track)
            if key not in tids:
                tid = tids[key] = sum(g == group for g, _ in tids) + 1
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid_of(group), "tid": tid,
                               "args": {"name": track}})
            return tids[key]

        def us(t: float) -> float:
            return round((t - self._origin) * 1e6, 3)

        for s in self.spans:
            pid = pid_of(s.group)
            tid = tid_of(s.group, s.track)
            args = {"start_step": s.start_step, "end_step": s.end_step}
            args.update(s.args)
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "pid": pid, "tid": tid,
                "ts": us(s.t0), "dur": max(round((s.t1 - s.t0) * 1e6, 3), 0.0),
                "args": args,
            })
        for step, wall, values in self.samples:
            events.append({
                "name": "pages_in_use", "cat": "occupancy", "ph": "C",
                "pid": pid_of("nodes"), "tid": 0, "ts": us(wall),
                "args": {f"node{i}": v for i, v in enumerate(values)},
            })
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"clock": "perf_counter_us",
                              "spans_recorded": self.recorded,
                              "spans_dropped": self.dropped}}

    def write_chrome(self, path: str) -> str:
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def flight_dump(self, reason: str,
                    registry: Optional[MetricsRegistry] = None,
                    directory: Optional[str] = None) -> str:
        """Post-mortem: write the last N spans (+ a registry snapshot)
        to ``flight-<reason>-<stamp>.json`` and return the path.  Wall
        clock is fine here — dump naming is telemetry, not
        scheduling."""
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(directory or self.dump_dir,
                            f"flight-{reason}-{stamp}.json")
        doc = {
            "reason": reason,
            "dumped_at": stamp,
            "spans": [s.to_dict() for s in self.spans],
            "open_spans": [s.to_dict() for s in self._open.values()],
            "counter_samples": [list(s) for s in self.samples],
            "spans_recorded": self.recorded,
            "spans_dropped": self.dropped,
        }
        if registry is not None:
            doc["metrics"] = registry.snapshot()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path


# ---------------------------------------------------------------------------
# model-error rollup + trace validation (shared by bench, CI, report tool)
# ---------------------------------------------------------------------------
def rollup_dispatch_events(events: Iterable[Dict[str, Any]]
                           ) -> Dict[str, Dict[str, float]]:
    """Aggregate dispatch events (Span dicts or Chrome events — anything
    with ``cat == "dispatch"`` and the attribution triple in ``args``)
    into a per-phase model-error table."""
    acc: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("cat") != "dispatch":
            continue
        args = ev.get("args", {})
        if "measured_s" not in args:
            continue
        row = acc.setdefault(ev["name"], {
            "count": 0, "predicted_s": 0.0, "measured_s": 0.0,
            "predicted_j": 0.0, "predicted_comms_s": 0.0,
            "comms_bytes": 0.0})
        row["count"] += 1
        row["predicted_s"] += float(args.get("predicted_s", 0.0))
        row["measured_s"] += float(args.get("measured_s", 0.0))
        row["predicted_j"] += float(args.get("predicted_j", 0.0))
        # striped-serving interconnect attribution (§V link model): spans
        # dispatched under a mesh carry the window's predicted stripe
        # traffic; single-device spans simply contribute 0
        row["predicted_comms_s"] += float(args.get("predicted_comms_s", 0.0))
        row["comms_bytes"] += float(args.get("comms_bytes", 0.0))
    for row in acc.values():
        row["err_ratio"] = (row["measured_s"] / row["predicted_s"]
                            if row["predicted_s"] > 0 else float("inf"))
    return acc


def format_model_error(report: Dict[str, Dict[str, float]]) -> str:
    """Fixed-width per-phase attribution table (the §IV 'measured vs
    modeled' view)."""
    hdr = (f"{'phase':<14} {'count':>6} {'pred_s':>10} {'meas_s':>10} "
           f"{'meas/pred':>9} {'pred_J':>10} {'comm_s':>9}")
    lines = [hdr, "-" * len(hdr)]
    for phase in sorted(report):
        r = report[phase]
        ratio = r["err_ratio"]
        lines.append(
            f"{phase:<14} {int(r['count']):>6} {r['predicted_s']:>10.4f} "
            f"{r['measured_s']:>10.4f} "
            f"{ratio if math.isfinite(ratio) else float('nan'):>9.2f} "
            f"{r['predicted_j']:>10.3f} "
            f"{r.get('predicted_comms_s', 0.0):>9.4f}")
    return "\n".join(lines)


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema check for an exported trace; returns a list of problems
    (empty == valid).  Used by tests and ``check_bench.py::check_obs``."""
    errs: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with a traceEvents array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents must be an array"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "C"):
            errs.append(f"event {i}: unexpected ph {ph!r}")
            continue
        for k in ("name", "pid", "tid"):
            if k not in ev:
                errs.append(f"event {i}: missing {k}")
        if not isinstance(ev.get("name"), str):
            errs.append(f"event {i}: name must be a string")
        if ph in ("X", "C"):
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i}: ts must be a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: dur must be a number >= 0")
            if not isinstance(ev.get("args"), dict):
                errs.append(f"event {i}: args must be an object")
        if ph == "M" and ev.get("name") not in ("process_name", "thread_name"):
            errs.append(f"event {i}: metadata name {ev.get('name')!r}")
        if len(errs) > 20:
            errs.append("... (truncated)")
            break
    return errs
