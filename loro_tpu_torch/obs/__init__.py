"""loro_tpu_torch.obs: metrics and profiling (the port of loro_tpu/obs/).

Always-on process-wide registry (metrics.py), Prometheus/JSON/sidecar
exposition (exposition.py), a one-screen report (report.py; also
``python -m loro_tpu_torch.obs.report``), EWMA heat accounting
(heat.py), the windowed health plane (health.py, lazily imported;
rendered by ``python -m loro_tpu_torch.obs.top``), trace and flight
artifact tooling (trace.py) and the flight recorder (flight.py).

Quick use::

    from loro_tpu_torch import obs
    obs.counter("fleet.ops_merged_total").inc(1024, family="text")
    print(obs.prometheus_text())       # /metrics text
    print(obs.sidecar())               # compact dict for JSON records
    obs.enable_span_metrics()          # tracing.span -> histograms
"""
from __future__ import annotations

from . import flight
from . import heat
from .exposition import prometheus_text, serve, sidecar, snapshot_json
from .metrics import (
    Counter,
    Registry,
    counter,
    gauge,
    histogram,
    registry,
    reset,
    snapshot,
    unique,
)

__all__ = [
    "Registry",
    "counter",
    "gauge",
    "histogram",
    "registry",
    "reset",
    "snapshot",
    "unique",
    "prometheus_text",
    "snapshot_json",
    "sidecar",
    "serve",
    "enable_span_metrics",
    "disable_span_metrics",
    "flight",
    "heat",
]

# NOTE: loro_tpu_torch.obs.health is imported lazily (`from
# loro_tpu_torch.obs import health`): it registers the `health_tick`
# fault site, and pulling resilience.faultinject into every bare
# `import loro_tpu_torch.obs` would be needless weight on the metrics
# hot path.

# -- tracing bridge ----------------------------------------------------
# One instrumentation point, two sinks: a tracing.span() on a hot path
# feeds the chrome-trace event list when tracing is enabled AND (when
# this bridge is on) a duration histogram per span name.  The bridge is
# opt-in so tracing.span keeps its zero-cost-when-off contract.
_span_observer = None


def _observe_span(name: str, dur_s: float) -> None:
    histogram("trace.span_seconds").observe(dur_s, span=name)


def enable_span_metrics() -> None:
    """Feed every tracing.span duration into the
    ``trace.span_seconds{span=...}`` histogram (works with chrome-trace
    collection on or off)."""
    global _span_observer
    from ..utils import tracing

    if _span_observer is None:
        _span_observer = _observe_span
        tracing.add_span_observer(_span_observer)


def disable_span_metrics() -> None:
    global _span_observer
    from ..utils import tracing

    if _span_observer is not None:
        tracing.remove_span_observer(_span_observer)
        _span_observer = None


class _DroppedDeviceSpans(Counter):
    """trace.device_spans_dropped_total: utils/tracing's module integer
    device_spans_dropped (tracing sits below obs and imports none of it,
    so the registry reads the integer)."""

    def get(self, **labels) -> float:
        from ..utils import tracing

        return 0.0 if labels else float(tracing.device_spans_dropped)

    def total(self) -> float:
        return self.get()

    def _value_rows(self):
        return [{"labels": {}, "value": self.get()}]


registry()._get(_DroppedDeviceSpans, "trace.device_spans_dropped_total",
                "device spans that utils/tracing dropped or could not record")
