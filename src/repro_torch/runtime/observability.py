"""Unified observability layer for the serving stack.

One process-local :class:`MetricsRegistry` absorbs every ad-hoc accounting
structure the engine grew over time (counters, bounded log deques, per-mode
latency windows, page-pool stats) behind three primitives — ``Counter``,
``Gauge``, ``Histogram`` — plus a bounded structured ``EventStream`` that
replaces the old free-form deques with one schema and one accessor. The
registry exports as JSON or Prometheus exposition text.

A :class:`TraceRecorder` captures per-launch spans (site, compile key,
depth/width/bucket, batch occupancy, tokens committed, wall time) and
per-request lifecycle spans (submit -> admit/prefill -> first token ->
decode ticks -> complete/expire, with failover replays marked) in Chrome
trace-event format, directly loadable in Perfetto / chrome://tracing.
Disabled (the default) every record method returns before touching any
state, so the tick path pays one attribute check; the ``--obs-smoke`` CI
shard gates the enabled path at <3% p50 decode-step overhead.

Both share an injectable ``clock`` so the supervisor's virtual-time
``run_trace`` and the chaos tests stay deterministic under tracing.
"""
from __future__ import annotations

import bisect
import json
import math
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "EventStream",
    "MetricsRegistry",
    "TraceRecorder",
    "Observability",
    "DEFAULT_LATENCY_BUCKETS_MS",
]

# Fixed histogram buckets (milliseconds) spanning sub-ms kernel launches to
# multi-second recovery replays; exact percentiles come from the bounded
# sample window, the buckets only feed the Prometheus export.
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


class Counter:
    """Monotonic (by convention) scalar. Stays int while fed ints so counter
    deltas in snapshots/tests compare exactly."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0):
        self.name = name
        self.value = value

    def add(self, v: float = 1) -> None:
        self.value += v

    def set(self, v: float) -> None:
        self.value = v


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0.0):
        self.name = name
        self.value = value

    def set(self, v: float) -> None:
        self.value = v

    def add(self, v: float = 1) -> None:
        self.value += v


class Histogram:
    """Fixed cumulative buckets for export plus a bounded sorted sample
    window for exact percentile readout (same mechanism as the controller's
    ModeTelemetry window: insort + FIFO eviction)."""

    __slots__ = ("name", "buckets", "bucket_counts", "count", "sum",
                 "window", "_sorted", "_fifo")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                 window: int = 512):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self.window = window
        self._sorted: List[float] = []
        self._fifo: Deque[float] = deque()

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
        self._fifo.append(v)
        bisect.insort(self._sorted, v)
        if len(self._fifo) > self.window:
            old = self._fifo.popleft()
            del self._sorted[bisect.bisect_left(self._sorted, old)]

    def quantile(self, q: float) -> float:
        """Exact order statistic over the sample window: the inverted-CDF
        convention, sorted[max(ceil(q*n)-1, 0)] (numpy method='inverted_cdf')."""
        n = len(self._sorted)
        if n == 0:
            return 0.0
        return self._sorted[max(math.ceil(q * n) - 1, 0)]

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def state_dict(self) -> Dict[str, Any]:
        return dict(buckets=list(self.buckets),
                    bucket_counts=list(self.bucket_counts),
                    count=self.count, sum=self.sum,
                    window=list(self._fifo))

    def load_state(self, st: Dict[str, Any]) -> None:
        self.buckets = tuple(st["buckets"])
        self.bucket_counts = list(st["bucket_counts"])
        self.count = st["count"]
        self.sum = st["sum"]
        self._fifo = deque(st["window"])
        self._sorted = sorted(self._fifo)


class EventStream:
    """Bounded stream of structured events sharing one field schema.

    Replaces the ad-hoc log deques: same bounded-memory behavior
    (``deque(maxlen=...)``), but every row is a dict with a declared field
    tuple, so exports and cross-stream tooling see one shape. ``append``
    stores the caller's dict *by reference* — the supervisor patches
    ``first_token_s`` into its failover entry after the fact, and that
    in-place mutation must stay visible through the stream."""

    __slots__ = ("name", "fields", "rows")

    def __init__(self, name: str, fields: Sequence[str], maxlen: int = 4096):
        self.name = name
        self.fields = tuple(fields)
        self.rows: Deque[Dict[str, Any]] = deque(maxlen=maxlen)

    def emit(self, **fields: Any) -> Dict[str, Any]:
        self.rows.append(fields)
        return fields

    def append(self, row: Dict[str, Any]) -> None:
        self.rows.append(row)

    def clear(self) -> None:
        self.rows.clear()

    def __len__(self) -> int:
        return len(self.rows)

    def __bool__(self) -> bool:
        return bool(self.rows)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return iter(self.rows)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self.rows)[i]
        return self.rows[i]

    def state_dict(self) -> Dict[str, Any]:
        # Shallow-copy each row: snapshots must not alias live entries the
        # supervisor may still mutate (first_token_s).
        return dict(fields=list(self.fields),
                    maxlen=self.rows.maxlen,
                    rows=[dict(r) for r in self.rows])

    def load_state(self, st: Dict[str, Any]) -> None:
        self.fields = tuple(st["fields"])
        self.rows = deque((dict(r) for r in st["rows"]), maxlen=st["maxlen"])


class _TupleView:
    """Read-only tuple-shaped view over an EventStream, so legacy accessors
    that unpack rows positionally (``step, frm, to, qi, qb = log[-1]``) keep
    working against the structured stream."""

    __slots__ = ("_stream", "_fields")

    def __init__(self, stream: EventStream, fields: Optional[Sequence[str]] = None):
        self._stream = stream
        self._fields = tuple(fields) if fields is not None else stream.fields

    def _tup(self, row: Dict[str, Any]) -> Tuple[Any, ...]:
        return tuple(row[f] for f in self._fields)

    def __len__(self) -> int:
        return len(self._stream)

    def __bool__(self) -> bool:
        return bool(self._stream)

    def __iter__(self):
        return (self._tup(r) for r in self._stream)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._tup(r) for r in self._stream[i]]
        return self._tup(self._stream[i])


class MetricsRegistry:
    """Get-or-create home for all metrics + event streams in one process.

    ``register_callback`` hooks lazy producers (page-pool occupancy, spec
    telemetry, per-mode percentiles): each callback returns a flat
    ``{name: value}`` dict merged into the gauges at export time, so hot
    paths never push values they already track elsewhere."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.streams: Dict[str, EventStream] = {}
        self._callbacks: Dict[Any, Callable[[], Dict[str, float]]] = {}

    # -- get-or-create accessors ------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  window: int = 512) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, buckets, window)
        return h

    def events(self, name: str, fields: Sequence[str],
               maxlen: int = 4096) -> EventStream:
        s = self.streams.get(name)
        if s is None:
            s = self.streams[name] = EventStream(name, fields, maxlen)
        return s

    def attach_events(self, stream: EventStream) -> EventStream:
        """Adopt an externally constructed stream (e.g. the controller's
        switch log, built before the engine hands over its registry)."""
        self.streams[stream.name] = stream
        return stream

    def register_callback(self, fn: Callable[[], Dict[str, float]],
                          key: Any = None) -> None:
        """Hook a lazy gauge producer. Registering under the same ``key``
        replaces the previous producer — a restored engine re-binds its
        callback so a retired standby's stale closure stops exporting."""
        self._callbacks[key if key is not None else fn] = fn

    def _callback_gauges(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for fn in self._callbacks.values():
            try:
                out.update(fn())
            except Exception:  # producer died (e.g. torn-down engine): skip
                continue
        return out

    # -- export -----------------------------------------------------------
    def to_json(self, events: bool = False) -> Dict[str, Any]:
        gauges = {n: g.value for n, g in self.gauges.items()}
        gauges.update(self._callback_gauges())
        out: Dict[str, Any] = {
            "counters": {n: c.value for n, c in self.counters.items()},
            "gauges": gauges,
            "histograms": {
                n: dict(count=h.count, sum=h.sum,
                        p50=h.p50, p95=h.p95, p99=h.p99,
                        buckets=dict(zip([str(b) for b in h.buckets] + ["+Inf"],
                                         h.bucket_counts)))
                for n, h in self.histograms.items()
            },
            "events": {n: len(s) for n, s in self.streams.items()},
        }
        if events:
            out["events"] = {n: [dict(r) for r in s] for n, s in self.streams.items()}
        return out

    def prometheus_text(self) -> str:
        lines: List[str] = []
        for n, c in sorted(self.counters.items()):
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {c.value}")
        gauges = {n: g.value for n, g in self.gauges.items()}
        gauges.update(self._callback_gauges())
        for n in sorted(gauges):
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {gauges[n]}")
        for n, h in sorted(self.histograms.items()):
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for b, cnt in zip(h.buckets, h.bucket_counts):
                cum += cnt
                lines.append(f'{n}_bucket{{le="{b}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {h.sum}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"

    # -- snapshot/restore --------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return dict(
            counters={n: c.value for n, c in self.counters.items()},
            gauges={n: g.value for n, g in self.gauges.items()},
            histograms={n: h.state_dict() for n, h in self.histograms.items()},
            streams={n: s.state_dict() for n, s in self.streams.items()},
        )

    def load_state(self, st: Dict[str, Any]) -> None:
        for n, v in st["counters"].items():
            self.counter(n).set(v)
        for n, v in st["gauges"].items():
            self.gauge(n).set(v)
        for n, hs in st["histograms"].items():
            self.histogram(n, buckets=hs["buckets"]).load_state(hs)
        for n, ss in st["streams"].items():
            self.events(n, ss["fields"], maxlen=ss["maxlen"]).load_state(ss)


class TraceRecorder:
    """Chrome trace-event recorder (Perfetto / chrome://tracing format).

    Launch spans land as matched duration B/E pairs on one synthetic
    pid/tid (the engine tick loop is single-threaded, so spans never
    overlap); request lifecycles are async spans (``ph`` b/n/e) keyed by
    rid, so Perfetto renders a lane per request with instants for admit,
    first token, and failover replays. Every record method bails on the
    first line when disabled — the hot path pays one predictable branch."""

    def __init__(self, enabled: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 max_events: int = 200_000):
        self.enabled = enabled
        self.clock = clock
        self.max_events = max_events
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    # -- launch spans ------------------------------------------------------
    def launch(self, site: str, t0: float, t1: float, **args: Any) -> None:
        """Record a completed launch as a duration span [t0, t1)."""
        if not self.enabled:
            return
        self._push(dict(ph="B", name=site, cat="launch", pid=0, tid=0,
                        ts=t0 * 1e6, args=args))
        self._push(dict(ph="E", name=site, cat="launch", pid=0, tid=0,
                        ts=t1 * 1e6))

    # -- request lifecycle spans ------------------------------------------
    def request_begin(self, rid: int, t: Optional[float] = None, **args: Any) -> None:
        if not self.enabled:
            return
        ts = (self.clock() if t is None else t) * 1e6
        self._push(dict(ph="b", name=f"req {rid}", cat="request", id=rid,
                        pid=0, tid=0, ts=ts, args=args))

    def request_event(self, rid: int, name: str,
                      t: Optional[float] = None, **args: Any) -> None:
        if not self.enabled:
            return
        ts = (self.clock() if t is None else t) * 1e6
        self._push(dict(ph="n", name=f"req {rid}", cat="request", id=rid,
                        pid=0, tid=0, ts=ts,
                        args=dict(event=name, **args)))

    def request_end(self, rid: int, status: str,
                    t: Optional[float] = None, **args: Any) -> None:
        if not self.enabled:
            return
        ts = (self.clock() if t is None else t) * 1e6
        self._push(dict(ph="e", name=f"req {rid}", cat="request", id=rid,
                        pid=0, tid=0, ts=ts,
                        args=dict(status=status, **args)))

    # -- export / snapshot -------------------------------------------------
    def export_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export_chrome_trace(), f)

    def state_dict(self) -> Dict[str, Any]:
        return dict(enabled=self.enabled, dropped=self.dropped,
                    events=[dict(e) for e in self.events])

    def load_state(self, st: Dict[str, Any]) -> None:
        self.enabled = st["enabled"]
        self.dropped = st["dropped"]
        self.events = [dict(e) for e in st["events"]]


class Observability:
    """Facade bundling one registry + one recorder + one clock, passed down
    through engine -> controller -> executor -> supervisor so the whole
    stack shares a single export surface."""

    def __init__(self, trace: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 registry: Optional[MetricsRegistry] = None,
                 max_trace_events: int = 200_000):
        self.clock = clock
        self.registry = registry if registry is not None else MetricsRegistry()
        self.recorder = TraceRecorder(enabled=trace, clock=clock,
                                      max_events=max_trace_events)

    def state_dict(self) -> Dict[str, Any]:
        return dict(registry=self.registry.state_dict(),
                    recorder=self.recorder.state_dict())

    def load_state(self, st: Dict[str, Any]) -> None:
        self.registry.load_state(st["registry"])
        self.recorder.load_state(st["recorder"])


# -- autoscaler observability ------------------------------------------------

# One row per autoscaler action: a MOGA generation completing ("generation"),
# a frontier executable published from the background compiler ("publish"),
# or a cold executable retired under the compile-table budget ("retire").
# ``unit`` names the executable group (e.g. "linear_k4", "bucket_2"),
# ``detail`` is free-form (front size, coldness, ...).
AUTOSCALE_EVENT_FIELDS = ("step", "event", "unit", "generation", "detail")

# Gauges the autoscaler's registry callback exports (registered under
# key="autoscale" so a rebind after failover replaces the stale closure):
#   autoscale_generation        completed MOGA generations
#   autoscale_front_size        design points on the current Pareto front
#   autoscale_compile_table     live compiled executables (modes + aux)
#   autoscale_pending_compiles  units queued or compiling in the background
#   autoscale_published / autoscale_retired   lifetime unit counts


def autoscale_events(registry: MetricsRegistry) -> EventStream:
    """The canonical autoscaler event stream on ``registry`` (get-or-create,
    shared schema between the live autoscaler, benches and tests)."""
    return registry.events("autoscale_events", AUTOSCALE_EVENT_FIELDS)
