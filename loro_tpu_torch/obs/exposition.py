"""Exposition formats for the obs registry: Prometheus text, JSON
snapshot, the sidecar object, and an optional scrape server (the port
of loro_tpu/obs/exposition.py).

- ``prometheus_text()`` — the classic ``/metrics`` text format
  (text/plain; version=0.0.4): dotted metric names map to underscores,
  histograms expose cumulative ``_bucket{le=...}`` / ``_sum`` /
  ``_count`` series, uniques export as gauges.
- ``snapshot_json()`` — the registry snapshot as a JSON string (the
  same dict ``metrics.snapshot()`` returns; report.py renders either).
- ``sidecar()`` — the compact flat dict bench.py embeds in its one
  JSON output line: counters/gauges/uniques as plain numbers (bare
  name = cross-label total, ``name{k=v}`` per label set), histograms
  as ``{count, sum, mean, p50, p99}`` summaries.
- ``serve(port)`` — a daemon-thread HTTP server exposing ``/metrics``
  (Prometheus), ``/metrics.json`` and ``/status.json`` (the active
  health plane's aggregated verdict) for live scrapes of a long-lived fleet server process.
"""
from __future__ import annotations

import json
import re
import threading
from typing import Optional

from . import metrics as _m

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (_LABEL_RE.sub("_", k), str(v).replace("\\", r"\\").replace('"', r"\""))
        for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def _fmt(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def prometheus_text(registry: Optional[_m.Registry] = None) -> str:
    reg = registry or _m.registry()
    lines = []
    for m in reg.metrics():
        pname = _prom_name(m.name)
        if m.help:
            lines.append(f"# HELP {pname} {m.help}")
        ptype = {"unique": "gauge"}.get(m.kind, m.kind)
        lines.append(f"# TYPE {pname} {ptype}")
        snap = m.snapshot()
        if m.kind == "histogram":
            for row in snap["values"]:
                for le, cum in row["buckets"]:
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels(row['labels'], {'le': le})} {cum}"
                    )
                lines.append(f"{pname}_sum{_prom_labels(row['labels'])} {_fmt(row['sum'])}")
                lines.append(f"{pname}_count{_prom_labels(row['labels'])} {row['count']}")
        else:
            rows = snap["values"] or [{"labels": {}, "value": 0}]
            for row in rows:
                lines.append(f"{pname}{_prom_labels(row['labels'])} {_fmt(row['value'])}")
    return "\n".join(lines) + "\n"


def snapshot_json(registry: Optional[_m.Registry] = None, indent: Optional[int] = None) -> str:
    reg = registry or _m.registry()
    return json.dumps(reg.snapshot(), indent=indent, sort_keys=True)


def sidecar(registry: Optional[_m.Registry] = None) -> dict:
    """Flat metrics object for one-line JSON records (bench.py).  Keys
    are metric names; labeled counters additionally emit per-label-set
    entries so BENCH_r*.json trajectories can diff e.g. pad waste per
    family across rounds."""
    reg = registry or _m.registry()
    out: dict = {}
    for m in reg.metrics():
        if m.kind == "histogram":
            out[m.name] = m.summary()
            continue
        out[m.name] = _num(m.total())
        rows = m.snapshot()["values"]
        if len(rows) == 1 and not rows[0]["labels"]:
            continue
        for row in rows:
            if not row["labels"]:
                continue
            key = m.name + "{" + ",".join(
                f"{k}={v}" for k, v in sorted(row["labels"].items())
            ) + "}"
            out[key] = _num(row["value"])
    return out


def _num(v: float):
    f = float(v)
    return int(f) if f == int(f) else round(f, 6)


def serve(port: int = 9464, addr: str = "127.0.0.1",
          registry: Optional[_m.Registry] = None):
    """Start a daemon-thread scrape endpoint; returns the HTTPServer
    (``.shutdown()`` to stop).  ``GET /metrics`` -> Prometheus text,
    ``GET /metrics.json`` -> JSON snapshot, ``GET /status.json`` ->
    the active health plane's verdict (``health.status_payload()``)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    reg = registry or _m.registry()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib naming)
            if self.path.startswith("/status.json"):
                from . import health as _health

                body = json.dumps(_health.status_payload()).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics.json"):
                body = snapshot_json(reg).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = prometheus_text(reg).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes are not stderr news
            pass

    srv = HTTPServer((addr, port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True, name="loro-obs-serve")
    t.start()
    return srv
