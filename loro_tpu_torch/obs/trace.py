"""Trace/flight artifact tooling: ``python -m loro_tpu_torch.obs.trace``
(the port of loro_tpu/obs/trace.py).

Works on the two artifact formats the observability plane writes:

- **chrome traces** — ``utils/tracing.dump()`` output
  (``{"traceEvents": [...]}``, load in chrome://tracing or Perfetto);
- **flight snapshots** — ``obs.flight.dump()`` output (``{"flight": 1,
  "events": [...]}``), the always-on black-box ring.

Subcommands::

    python -m loro_tpu_torch.obs.trace dump [path]
        Write this process's flight snapshot (mostly useful from a
        calling script at a breakpoint); prints the path.

    python -m loro_tpu_torch.obs.trace inspect <artifact.json>
        One-screen summary: event counts by kind/name, span time by
        name (chrome traces), the tail of the ring (flight).

    python -m loro_tpu_torch.obs.trace merge <leader.json> <follower.json>
        Replication-lag attribution: match the leader's epoch-stamped
        commit events (``server.epoch`` / ``sync.commit``) against the
        follower's ``repl.apply`` events on the shipped epoch stamps
        and print per-epoch measured lag (count / p50 / max).  With
        ``-o out.json`` also writes a merged chrome trace (one
        process row per input) for side-by-side timeline viewing.

Exit codes: 0 ok, 2 unreadable/malformed artifact (typed ObsError
message on stderr, never a stack trace).
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional

from ..errors import ObsError


def load_artifact(path: str) -> dict:
    """Read + classify one artifact; raises typed ObsError."""
    try:
        with open(path) as f:
            art = json.load(f)
    except (OSError, ValueError) as e:
        raise ObsError(f"unreadable trace artifact {path}: {e}") from e
    if not isinstance(art, dict):
        raise ObsError(f"{path}: not a trace artifact (top level is "
                       f"{type(art).__name__}, want object)")
    if "traceEvents" in art:
        art["_kind"] = "chrome"
    elif art.get("flight") == 1 and isinstance(art.get("events"), list):
        art["_kind"] = "flight"
    elif isinstance(art.get("flight"), list):
        # a chaos violation artifact: its embedded flight tail is
        # inspectable directly (the common post-mortem handoff)
        art = {"_kind": "flight", "flight": 1, "pid": None,
               "capacity": None, "recorded_total": len(art["flight"]),
               "events": art["flight"]}
    else:
        raise ObsError(
            f"{path}: neither a chrome trace (traceEvents), a flight "
            "snapshot (flight=1 + events), nor a chaos artifact with "
            "an embedded flight tail"
        )
    return art


# -- inspect ------------------------------------------------------------
def render_inspect(art: dict, path: str = "?") -> str:
    lines = [f"== {path} ({art['_kind']}) =="]
    if art["_kind"] == "chrome":
        evs = art["traceEvents"]
        by_name: dict = {}
        for e in evs:
            st = by_name.setdefault(e.get("name", "?"), [0, 0.0])
            st[0] += 1
            st[1] += float(e.get("dur", 0.0))
        lines.append(f"events: {len(evs)}")
        for name in sorted(by_name, key=lambda n: -by_name[n][1])[:20]:
            n, us = by_name[name]
            lines.append(f"  {name:<40} n={n:<8} total={us / 1e3:,.2f}ms")
    else:
        evs = art["events"]
        lines.append(
            f"pid={art.get('pid')} capacity={art.get('capacity')} "
            f"recorded_total={art.get('recorded_total')} "
            f"retained={len(evs)}"
        )
        by_kind: dict = {}
        for e in evs:
            by_kind[e.get("kind", "?")] = by_kind.get(e.get("kind", "?"), 0) + 1
        for kind in sorted(by_kind):
            lines.append(f"  {kind:<32} n={by_kind[kind]}")
        lines.append("tail:")
        for e in evs[-10:]:
            extra = {k: v for k, v in e.items()
                     if k not in ("i", "t", "wall", "kind")}
            lines.append(f"  [{e.get('i')}] {e.get('kind')} {extra}")
    return "\n".join(lines)


# -- merge (replication-lag attribution) --------------------------------
_LEADER_COMMIT_KINDS = ("server.epoch", "sync.commit")


def merge_lag(leader: dict, follower: dict) -> dict:
    """Match leader commit events to follower ``repl.apply`` events on
    the epoch stamps; returns ``{"epochs": [...], "lag_ms_p50": ...,
    "lag_ms_max": ..., "count": N}``.  Two lag figures per epoch:

    - ``shipped_lag_ms`` — the follower's own measurement (its wall
      clock minus the WAL stamp, recorded at apply time) when present;
    - ``observed_lag_ms`` — follower apply wall time minus leader
      commit wall time from the two flight streams (the cross-check).
    """
    if leader["_kind"] != "flight" or follower["_kind"] != "flight":
        raise ObsError("merge needs two FLIGHT snapshots (the chrome "
                       "trace has no epoch-stamped commit events)")
    commits = {}
    for e in leader["events"]:
        if e.get("kind") in _LEADER_COMMIT_KINDS and "epoch" in e:
            # keep the FIRST commit sighting per epoch (server.epoch
            # fires before sync.commit for the same epoch)
            commits.setdefault(int(e["epoch"]), e)
    applies = [e for e in follower["events"]
               if e.get("kind") == "repl.apply" and "epoch" in e]
    if not commits or not applies:
        raise ObsError(
            "no matching epoch stamps: leader has "
            f"{len(commits)} stamped commits, follower has "
            f"{len(applies)} repl.apply events — are the roles swapped?"
        )
    rows: List[dict] = []
    lags: List[float] = []
    for a in applies:
        ep = int(a["epoch"])
        c = commits.get(ep)
        if c is None:
            continue  # commit scrolled out of the leader's ring
        row = {"epoch": ep, "trace": a.get("trace")}
        if a.get("lag_ms") is not None:
            row["shipped_lag_ms"] = float(a["lag_ms"])
        if a.get("wall") is not None and c.get("wall") is not None:
            row["observed_lag_ms"] = round(
                max(0.0, (float(a["wall"]) - float(c["wall"])) * 1e3), 3
            )
        rows.append(row)
        lag = row.get("shipped_lag_ms", row.get("observed_lag_ms"))
        if lag is not None:
            lags.append(lag)
    if not rows:
        raise ObsError(
            "no epoch overlap between the two snapshots (the rings are "
            "bounded — dump closer to the window you care about)"
        )
    lags.sort()
    return {
        "count": len(rows),
        "lag_ms_p50": round(lags[len(lags) // 2], 3) if lags else None,
        "lag_ms_max": round(lags[-1], 3) if lags else None,
        "epochs": rows,
    }


def merged_chrome(leader: dict, follower: dict) -> dict:
    """Both flight streams as one chrome trace: instants on two
    process rows, ts normalized to the earlier wall-clock origin."""
    origin = min(
        [e["wall"] for e in leader["events"] if "wall" in e] +
        [e["wall"] for e in follower["events"] if "wall" in e]
    )
    out = []
    for pid, art in ((1, leader), (2, follower)):
        for e in art["events"]:
            if "wall" not in e:
                continue
            out.append({
                "name": e.get("kind", "?"),
                "ph": "i",
                "s": "t",
                "ts": (float(e["wall"]) - origin) * 1e6,
                "pid": pid,
                "tid": 0,
                "args": {k: v for k, v in e.items()
                         if k not in ("t", "wall", "kind")},
            })
    return {
        "traceEvents": out,
        "metadata": {"pids": {"1": "leader", "2": "follower"}},
    }


def render_merge(report: dict) -> str:
    lines = [
        f"replication-lag attribution: {report['count']} applies matched",
        f"  lag p50 {report['lag_ms_p50']}ms  max {report['lag_ms_max']}ms",
    ]
    for row in report["epochs"][:20]:
        bits = [f"epoch {row['epoch']:<6}"]
        if row.get("trace"):
            bits.append(f"trace {row['trace']:<14}")
        if "shipped_lag_ms" in row:
            bits.append(f"shipped {row['shipped_lag_ms']:.3f}ms")
        if "observed_lag_ms" in row:
            bits.append(f"observed {row['observed_lag_ms']:.3f}ms")
        lines.append("  " + "  ".join(bits))
    if len(report["epochs"]) > 20:
        lines.append(f"  ... {len(report['epochs']) - 20} more")
    return "\n".join(lines)


# -- CLI ----------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        if not argv or argv[0] in ("-h", "--help"):
            print(__doc__)
            return 0
        cmd, rest = argv[0], argv[1:]
        if cmd == "dump":
            from . import flight

            print(flight.dump(rest[0] if rest else None))
            return 0
        if cmd == "inspect":
            if not rest:
                raise ObsError("inspect needs an artifact path")
            for path in rest:
                print(render_inspect(load_artifact(path), path))
            return 0
        if cmd == "merge":
            out_path = None
            if "-o" in rest:
                i = rest.index("-o")
                if i + 1 >= len(rest):
                    raise ObsError("-o needs an output path")
                out_path = rest[i + 1]
                rest = rest[:i] + rest[i + 2:]
            if len(rest) != 2:
                raise ObsError(
                    "merge needs exactly <leader.json> <follower.json>"
                )
            leader, follower = (load_artifact(p) for p in rest)
            report = merge_lag(leader, follower)
            print(render_merge(report))
            if out_path is not None:
                with open(out_path, "w") as f:
                    json.dump(merged_chrome(leader, follower), f)
                print(f"merged chrome trace -> {out_path}")
            return 0
        raise ObsError(
            f"unknown subcommand {cmd!r}: use dump | inspect | merge"
        )
    except ObsError as e:
        print(f"obs.trace: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
