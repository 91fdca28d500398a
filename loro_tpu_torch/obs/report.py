"""One-screen human summary of the obs registry (the port of
loro_tpu/obs/report.py).

``python -m loro_tpu_torch.obs.report`` renders the live process registry
(useful at the end of a calling script, or from code via ``render()``);
``python -m loro_tpu_torch.obs.report snap.json`` renders a saved snapshot
(the dict ``metrics.snapshot()`` / ``exposition.snapshot_json()``
produce — e.g. scraped from a serving process's ``/metrics.json``);
``-`` reads the snapshot from stdin.

The report groups metrics by layer prefix (``fleet.``, ``server.``,
``doc.``, ...) and derives the two numbers nobody should have to
compute by hand: the pad-waste ratio (padded-but-dead rows as a share
of all padded rows shipped to the device) and the distinct-padded-shape
count (the jit-cache-size proxy).
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Optional

from . import metrics as _m

_WIDTH = 78


def _hist_summary_from_rows(rows) -> dict:
    count = sum(r["count"] for r in rows)
    total = sum(r["sum"] for r in rows)
    return {"count": count, "sum": total, "mean": (total / count) if count else 0.0}


def _fmt_num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        n = int(f)
        return f"{n:,}"
    return f"{f:,.4g}"


def _metric_total(snap_entry: dict) -> float:
    if snap_entry["type"] == "histogram":
        return float(sum(r["count"] for r in snap_entry["values"]))
    return float(sum(r["value"] for r in snap_entry["values"]))


def _labeled_rows(snap_entry: dict):
    return [r for r in snap_entry["values"] if r["labels"]]


def _windowed_rates_lines() -> list:
    """The "windowed rates" section (live render only): the active
    health plane's per-second rates + open alerts.  Empty when no
    plane is installed or it has too few samples."""
    from . import health as _health

    plane = _health.active()
    if plane is None:
        return []
    rates = plane.rates_report()
    alerts = plane.alerts()
    if not rates and not alerts:
        return []
    lines = ["[windowed rates]  (health plane, last "
             f"{plane.window_s:g}s window)"]
    for name in sorted(rates):
        lines.append(f"  {name:<44} {rates[name]:>10,.2f}/s")
    for a in alerts:
        lines.append(
            f"  ALERT {a['kind']} ({a['severity']}): {a['detail']}")
    return lines


def render(snapshot: Optional[dict] = None) -> str:
    """Format a snapshot (default: the live default registry) as a
    one-screen text report.  The live render appends a "windowed
    rates" section when a health plane is active."""
    live = snapshot is None
    snap = snapshot if snapshot is not None else _m.snapshot()
    lines = []
    bar = "=" * _WIDTH
    lines.append(bar)
    lines.append("loro_tpu_torch.obs — metrics summary".center(_WIDTH))
    lines.append(bar)
    if not snap:
        lines.append("(no metrics recorded)")
        return "\n".join(lines)

    # -- derived headline numbers -------------------------------------
    head = []
    ops = snap.get("fleet.ops_merged_total")
    resident = snap.get("fleet.resident_rows_total")
    waste = snap.get("fleet.pad_waste_rows_total")
    if ops or resident or waste:
        # real device rows = one-shot merge rows + resident ingest rows
        # (the resident scatter's waste counter has its real-row twin
        # in resident_rows_total, not ops_merged_total)
        real = (_metric_total(ops) if ops else 0.0) + (
            _metric_total(resident) if resident else 0.0
        )
        dead = _metric_total(waste) if waste else 0.0
        shipped = real + dead
        if shipped:
            head.append(
                f"pad waste: {dead / shipped:6.1%} of device rows are padding "
                f"({_fmt_num(dead)} / {_fmt_num(shipped)})"
            )
    shapes = snap.get("fleet.padded_shapes_distinct")
    if shapes:
        head.append(
            f"distinct padded shapes (jit-cache proxy): "
            f"{_fmt_num(_metric_total(shapes))}"
        )
    for h in head:
        lines.append("  * " + h)
    if head:
        lines.append("-" * _WIDTH)

    # -- per-layer sections -------------------------------------------
    groups: Dict[str, list] = {}
    for name in sorted(snap):
        layer = name.split(".", 1)[0] if "." in name else "misc"
        groups.setdefault(layer, []).append(name)
    for layer in sorted(groups):
        lines.append(f"[{layer}]")
        for name in groups[layer]:
            e = snap[name]
            if e["type"] == "histogram":
                s = _hist_summary_from_rows(e["values"])
                lines.append(
                    f"  {name:<44} n={_fmt_num(s['count']):>8}  "
                    f"mean={s['mean'] * 1e3:,.2f}ms  sum={s['sum']:,.3f}s"
                )
            else:
                lines.append(
                    f"  {name:<44} {_fmt_num(_metric_total(e)):>12}"
                )
            for row in _labeled_rows(e)[:8]:
                lbl = ",".join(f"{k}={v}" for k, v in sorted(row["labels"].items()))
                if e["type"] == "histogram":
                    mean = (row["sum"] / row["count"]) if row["count"] else 0.0
                    lines.append(
                        f"    {{{lbl}}}".ljust(46)
                        + f"n={row['count']:>8,}  mean={mean * 1e3:,.2f}ms"
                    )
                else:
                    lines.append(
                        f"    {{{lbl}}}".ljust(46)
                        + f"{_fmt_num(row['value']):>12}"
                    )
    if live:
        rl = _windowed_rates_lines()
        if rl:
            lines.append("-" * _WIDTH)
            lines.extend(rl)
    lines.append(bar)
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if argv:
        raw = sys.stdin.read() if argv[0] == "-" else open(argv[0]).read()
        snap = json.loads(raw)
    else:
        snap = None  # live registry of this process
    print(render(snap))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
