"""Process-wide metrics registry: counters, gauges, histograms, uniques.

The fleet merge path needs always-on accounting (pad waste, jit-shape
cardinality, launch counts, epoch wall times) the way loro's hot paths
carry `tracing` spans — but aggregated, not evented.  This registry is
the aggregation side: pure-stdlib, thread-safe, cheap enough to leave
on unconditionally (one dict lookup + lock per update; the hot callers
are chunky merge/ingest calls, never per-op loops).

Four metric kinds, all label-aware:

- ``Counter``   — monotone float, ``inc(n, **labels)``
- ``Gauge``     — last-write-wins float, ``set/inc/dec``
- ``Histogram`` — bucketed observations, ``observe(v, **labels)`` and a
  ``time()`` context manager; cumulative Prometheus-style buckets
- ``Unique``    — cardinality of a key set (the jit-cache-size proxy:
  ``add(shape_tuple)`` and the exported value is ``len(set)``)

Use through the module-level default registry::

    from loro_tpu_torch.obs import metrics
    metrics.counter("fleet.ops_merged_total").inc(1024, family="text")
    with metrics.histogram("server.epoch_seconds").time(family="text"):
        ...

Naming convention: dotted ``layer.metric_total`` names (Prometheus
exposition maps dots to underscores).  ``snapshot()`` returns a
JSON-able dict; ``reset()`` clears all values (tests).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# default histogram buckets: wide exponential range (seconds-ish scale,
# 100us .. 100s) — epoch wall times, span durations, RTTs all fit
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Common shell: name, help text, per-label-set values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._values: Dict[LabelKey, object] = {}

    # -- snapshot helpers ---------------------------------------------
    def _value_rows(self) -> List[dict]:
        with self._lock:
            items = list(self._values.items())
        return [{"labels": dict(k), "value": v} for k, v in items]

    def snapshot(self) -> dict:
        return {"type": self.kind, "help": self.help, "values": self._value_rows()}

    def total(self) -> float:
        """Sum across label sets (counters/gauges; Unique overrides)."""
        with self._lock:
            return float(sum(self._values.values())) if self._values else 0.0


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + n

    def get(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def get(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class _HistState:
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        # per-bucket exemplar trace ids (lazily allocated: observations
        # without exemplars pay nothing — the common case)
        self.exemplars: Optional[list] = None


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, lock)
        bs = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        if not bs:
            raise ValueError(f"histogram {name}: empty bucket list")
        self.buckets = bs  # upper bounds; +Inf is implicit

    def observe(self, v: float, exemplar: Optional[str] = None,
                **labels) -> None:
        """Record one observation.  ``exemplar`` (a trace id) is
        retained per BUCKET (last-writer-wins, one string slot per
        bucket — bounded memory), so a p99 bucket in a dashboard is
        explorable: ``exemplars()`` hands back a concrete request id
        that landed there."""
        k = _label_key(labels)
        with self._lock:
            st = self._values.get(k)
            if st is None:
                st = self._values[k] = _HistState(len(self.buckets) + 1)
            i = 0
            n = len(self.buckets)
            while i < n and v > self.buckets[i]:
                i += 1
            st.counts[i] += 1
            st.sum += v
            st.count += 1
            if exemplar is not None:
                if st.exemplars is None:
                    st.exemplars = [None] * (n + 1)
                st.exemplars[i] = str(exemplar)

    @contextmanager
    def time(self, **labels):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, **labels)

    # -- reads ---------------------------------------------------------
    def _merged_state(self) -> _HistState:
        out = _HistState(len(self.buckets) + 1)
        with self._lock:
            for st in self._values.values():
                for i, c in enumerate(st.counts):
                    out.counts[i] += c
                out.sum += st.sum
                out.count += st.count
        return out

    def total(self) -> float:
        return float(self._merged_state().count)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile over all label sets (p50/p99
        summaries for the bench sidecar).  None when empty."""
        st = self._merged_state()
        return _hist_quantile(self.buckets, st.counts, st.count, q)

    def summary(self) -> dict:
        """Compact cross-label summary: count/sum/mean/p50/p99."""
        st = self._merged_state()
        mean = (st.sum / st.count) if st.count else 0.0
        return {
            "count": st.count,
            "sum": round(st.sum, 6),
            "mean": round(mean, 6),
            "p50": _hist_quantile(self.buckets, st.counts, st.count, 0.50),
            "p99": _hist_quantile(self.buckets, st.counts, st.count, 0.99),
        }

    def exemplars(self, **labels) -> Dict[str, str]:
        """Per-bucket exemplar trace ids for one label set:
        ``{"le_0.05": "t1a2f-3", ..., "le_+Inf": ...}`` (only buckets
        that retained one).  Empty when no observation ever carried an
        exemplar."""
        with self._lock:
            st = self._values.get(_label_key(labels))
            if st is None or st.exemplars is None:
                return {}
            out = {}
            for i, ex in enumerate(st.exemplars):
                if ex is not None:
                    le = self.buckets[i] if i < len(self.buckets) else "+Inf"
                    out[f"le_{le}"] = ex
            return out

    def _value_rows(self) -> List[dict]:
        rows = []
        with self._lock:
            items = list(self._values.items())
        for k, st in items:
            cum = 0
            buckets = []
            for i, le in enumerate(self.buckets):
                cum += st.counts[i]
                buckets.append([le, cum])
            buckets.append(["+Inf", cum + st.counts[-1]])
            row = {
                "labels": dict(k),
                "count": st.count,
                "sum": st.sum,
                "buckets": buckets,
            }
            if st.exemplars is not None:
                row["exemplars"] = {
                    str(self.buckets[i] if i < len(self.buckets) else "+Inf"): ex
                    for i, ex in enumerate(st.exemplars) if ex is not None
                }
            rows.append(row)
        return rows


def _hist_quantile(bounds: Sequence[float], counts: Sequence[int],
                   total: int, q: float) -> Optional[float]:
    if not total:
        return None
    rank = q * total
    cum = 0
    for i, le in enumerate(bounds):
        prev = cum
        cum += counts[i]
        if cum >= rank:
            lo = bounds[i - 1] if i else 0.0
            frac = (rank - prev) / max(counts[i], 1)
            return round(lo + (le - lo) * frac, 6)
    return bounds[-1]  # overflow bucket: clamp to the last bound


class Unique(_Metric):
    """Cardinality metric: value = number of distinct keys seen.  The
    jit-cache-size proxy — every padded device shape adds a key; the
    exported number approximates the jit cache entry count."""

    kind = "unique"

    def add(self, key, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            s = self._values.get(k)
            if s is None:
                s = self._values[k] = set()
            s.add(key)

    def get(self, **labels) -> int:
        with self._lock:
            s = self._values.get(_label_key(labels))
            return len(s) if s else 0

    def total(self) -> float:
        with self._lock:
            return float(sum(len(s) for s in self._values.values()))

    def _value_rows(self) -> List[dict]:
        with self._lock:
            items = [(k, len(s)) for k, s in self._values.items()]
        return [{"labels": dict(k), "value": n} for k, n in items]


class Registry:
    """Get-or-create metric registry.  Metric identity is the name; a
    second registration with a different kind raises (catches typo'd
    wiring at the call site, not in the dashboard)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, threading.Lock(), **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def unique(self, name: str, help: str = "") -> Unique:
        return self._get(Unique, name, help)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """JSON-able snapshot of every metric (exposition.snapshot_json
        round-trips this through json)."""
        return {m.name: m.snapshot() for m in self.metrics()}

    def reset(self) -> None:
        """Drop all metrics AND their values (tests; a live process
        keeps its registry for life)."""
        with self._lock:
            self._metrics.clear()


# -- module-level default registry ------------------------------------
_default = Registry()


def registry() -> Registry:
    return _default


def counter(name: str, help: str = "") -> Counter:
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _default.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _default.histogram(name, help, buckets)


def unique(name: str, help: str = "") -> Unique:
    return _default.unique(name, help)


def snapshot() -> dict:
    return _default.snapshot()


def reset() -> None:
    _default.reset()
