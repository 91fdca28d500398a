"""``python -m loro_tpu_torch.obs.top`` — one-screen fleet health view
(the port of loro_tpu/obs/top.py).

Renders the aggregated status payload (``health.status_payload()`` —
the same object ``/status.json`` and the net STATUS frame serve):
verdict banner, open alerts, windowed rates, the heat top-K with the
per-shard skew ratio, follower lag and the net edge.  Three sources:

- no argument: the LIVE in-process health plane, refreshed every
  ``--interval`` seconds (``--once`` renders a single screen — the
  in-process mode is what a calling script or test embeds);
- a file path: a SAVED ``/status.json`` snapshot (post-mortems,
  scraped payloads); ``-`` reads the snapshot from stdin;
- an ``http(s)://...`` URL: scrape a serving process's
  ``/status.json`` each refresh (stdlib urllib, no new deps).

The payload's keys are ``health.HealthPlane.status()``'s.
"""
from __future__ import annotations

import json
import sys
import time
from typing import List, Optional

_WIDTH = 78

_VERDICT_MARK = {"ok": "OK", "degraded": "DEGRADED",
                 "critical": "CRITICAL", "unknown": "UNKNOWN"}


def _bar(ch: str = "=") -> str:
    return ch * _WIDTH


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:,.3f}".rstrip("0").rstrip(".") or "0"
    return str(v)


def render_status(payload: dict) -> str:
    """One screen of text for a status payload dict."""
    lines: List[str] = []
    verdict = payload.get("verdict", "unknown")
    mark = _VERDICT_MARK.get(verdict, verdict.upper())
    lines.append(_bar())
    lines.append(f"loro_tpu fleet health — {mark}".center(_WIDTH))
    lines.append(_bar())
    ticks = payload.get("ticks")
    if ticks is not None:
        lines.append(
            f"  ticks={ticks}  skipped={payload.get('skipped_ticks', 0)}"
            f"  window={_fmt(payload.get('window_s'))}s")
    for r in payload.get("reasons", []):
        lines.append(f"  ! {r}")
    alerts = payload.get("alerts") or []
    if alerts:
        lines.append(_bar("-"))
        lines.append("[alerts]")
        for a in alerts:
            lines.append(f"  {a.get('severity', '?'):<9} "
                         f"{a.get('kind', '?'):<20} {a.get('detail', '')}")
    rates = payload.get("rates") or {}
    if rates:
        lines.append(_bar("-"))
        lines.append("[windowed rates]")
        for name in sorted(rates):
            lines.append(f"  {name:<52} {rates[name]:>12,.2f}/s")
    heat = payload.get("heat") or {}
    docs_top = heat.get("docs_top") or []
    shards = heat.get("shards") or {}
    if docs_top or shards:
        lines.append(_bar("-"))
        skew = heat.get("skew_ratio")
        lines.append(
            f"[heat]  tracked_docs={_fmt(heat.get('tracked_docs'))}"
            f"  n_shards={_fmt(heat.get('n_shards'))}"
            f"  skew_ratio={_fmt(skew)}"
            f"  revive/s={_fmt(heat.get('revive_per_s'))}")
        if docs_top:
            lines.append(f"  {'doc':>6} {'heat':>10} {'per_s':>10} "
                         f"{'push':>8} {'pull':>8} {'touch':>8}")
            for d in docs_top:
                lines.append(
                    f"  {d.get('doc'):>6} {d.get('heat', 0):>10,.2f} "
                    f"{d.get('per_s', 0):>10,.3f} {d.get('push', 0):>8,.1f} "
                    f"{d.get('pull', 0):>8,.1f} {d.get('touch', 0):>8,.1f}")
        for s in sorted(shards):
            row = shards[s]
            lines.append(
                f"  shard {s}: ingest={row.get('ingest', 0):,.2f} "
                f"launch={row.get('launch', 0):,.2f} "
                f"degradation={row.get('degradation', 0):,.2f}")
    sh = payload.get("shards")
    persist = payload.get("persist")
    repl = payload.get("repl")
    net = payload.get("net")
    if sh or persist or repl or net:
        lines.append(_bar("-"))
        if sh:
            lines.append(
                f"[shards]  n={_fmt(sh.get('n_shards'))}"
                f"  degraded={sh.get('degraded') or 'none'}")
        if persist:
            lines.append(
                f"[persist]  durable_epoch={_fmt(persist.get('durable_epoch'))}")
        if repl:
            for f in repl.get("followers", []):
                if "unavailable" in f:
                    lines.append(f"[repl]  follower: {f['unavailable']}")
                else:
                    lines.append(
                        f"[repl]  follower {f.get('id')}: "
                        f"lag={_fmt(f.get('lag_epochs'))} epochs  "
                        f"applied={_fmt(f.get('applied_epoch'))}")
        if net:
            lines.append(
                f"[net]  {net.get('addr', '?')}  "
                f"connections={_fmt(net.get('connections'))}  "
                f"frame_errors={_fmt(net.get('frame_errors'))}")
    serving = payload.get("serving")
    if isinstance(serving, dict) and serving:
        lines.append(_bar("-"))
        parts = []
        for k in ("family", "sessions", "pushes", "pulls", "epoch",
                  "unavailable"):
            if k in serving:
                parts.append(f"{k}={_fmt(serving[k])}")
        if not parts:  # unknown report shape: show a stable prefix
            parts = [f"{k}={_fmt(serving[k])}"
                     for k in sorted(serving)[:6]]
        lines.append("[serving]  " + "  ".join(parts))
    lines.append(_bar())
    return "\n".join(lines)


def _load(source: Optional[str]) -> dict:
    if source is None:
        from . import health as _health

        return _health.status_payload()
    if source == "-":
        return json.loads(sys.stdin.read())
    if source.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(source, timeout=10.0) as resp:
            return json.loads(resp.read().decode("utf-8"))
    with open(source) as fh:
        return json.loads(fh.read())


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    interval = 2.0
    once = False
    source: Optional[str] = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--interval":
            i += 1
            interval = float(argv[i])
        elif a.startswith("--interval="):
            interval = float(a.split("=", 1)[1])
        elif a == "--once":
            once = True
        else:
            source = a
        i += 1
    if source is not None and source != "-" and not source.startswith(
            ("http://", "https://")):
        once = True  # a saved snapshot never changes: one screen
    if source == "-":
        once = True
    while True:
        print(render_status(_load(source)))
        if once:
            return 0
        try:
            time.sleep(interval)  # interactive refresh-loop CLI, not a serving path — the render itself is clock-free
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    raise SystemExit(main())
