"""Fleet health plane: windowed rates, detectors, one status verdict
(the port of loro_tpu/obs/health.py).

``HealthPlane`` turns the always-on registry (metrics.py) into
*windowed* telemetry: ``tick()`` appends one bounded sample (flattened
counter/gauge totals + merged histogram bucket counts + follower lag +
a heat snapshot) to a ring, and ``rate(name, window)`` /
``window_quantile(hist, q, window)`` difference two ring samples — the
"how fast *right now*" the lifetime counters cannot answer.  The clock
is injected (LT-TIME): fake-clock tests drive windows deterministically
and a live process runs ``start(period_s)``'s daemon sampler.

**Detectors** are pure predicates over the windows, evaluated at each
tick with fire/clear hysteresis (``fire_after``/``clear_after``
consecutive breaching/clean ticks).  Firing records a flight event and
ticks ``health.alerts_total{kind}`` — never an exception into serving
code.  Kinds:

- ``shard_saturation``   heat skew ratio above ``shard_skew_max`` with
  real ingest traffic (the rebalancer trigger)
- ``tier_hit_collapse``  windowed tier hit rate below ``tier_hit_min``
  (the hot set no longer fits)
- ``repl_lag``           a follower's ``lag_epochs`` at/above
  ``repl_lag_epochs_max`` and not shrinking
- ``p2v_slo``            windowed push-to-visible p99 above
  ``p2v_slo_ms`` (SLO burn)
- ``degradation_spike``  ``resilience.degradations_total`` grew by
  ``degradation_burst`` within one window

**Status surface**: ``status()`` composes serving reports (sync,
resident/shards, followers, net), persist/repl watermarks, heat and
the open alerts into one JSON verdict ``ok|degraded|critical`` +
reasons.  It is served at ``/status.json`` (exposition.serve), answered
over the wire by the STATUS frame (net/wire.py) and rendered by
``python -m loro_tpu_torch.obs.top``.

Fault site ``health_tick``: an armed raise/delay hits ONE sampler tick
— the window is skipped and counted (``health.ticks_skipped_total``),
serving never sees it (the blast-radius regression in
tests/test_health.py).

Lock contract: ``obs.health`` is a near-leaf (analysis/lockorder.py) —
attachment ``report()`` calls and registry reads happen with the plane
lock RELEASED; only ring/alert state mutates under it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..analysis.lockwitness import named_lock
from ..resilience import faultinject
from . import flight
from . import heat as heat_mod
from . import metrics as _m

faultinject.register_site(
    "health_tick", "HealthPlane.tick: raise/delay one sampler tick — "
    "the window is skipped (counted), serving never sees it")

SEVERITIES = ("ok", "degraded", "critical")

#: detector kind -> verdict severity while its alert is open
DETECTOR_SEVERITY = {
    "shard_saturation": "degraded",
    "tier_hit_collapse": "degraded",
    "repl_lag": "critical",
    "p2v_slo": "degraded",
    "degradation_spike": "critical",
}


def _worse(a: str, b: str) -> str:
    return a if SEVERITIES.index(a) >= SEVERITIES.index(b) else b


class HealthPlane:
    """Bounded snapshot ring + detectors + the status verdict."""

    def __init__(self, *, clock=time.monotonic,
                 registry: Optional[_m.Registry] = None,
                 heat: Optional[heat_mod.HeatAccountant] = None,
                 window_s: float = 60.0, capacity: int = 64,
                 p2v_slo_ms: float = 1000.0,
                 shard_skew_max: float = 4.0,
                 shard_min_ingest_heat: float = 4.0,
                 tier_hit_min: float = 0.5,
                 tier_min_touches: int = 8,
                 p2v_min_samples: int = 4,
                 repl_lag_epochs_max: int = 3,
                 degradation_burst: int = 3,
                 fire_after: int = 2, clear_after: int = 2):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self._clock = clock
        self._reg = registry or _m.registry()
        self.heat = heat or heat_mod.accountant()
        self.window_s = float(window_s)
        self.p2v_slo_ms = float(p2v_slo_ms)
        self.shard_skew_max = float(shard_skew_max)
        self.shard_min_ingest_heat = float(shard_min_ingest_heat)
        self.tier_hit_min = float(tier_hit_min)
        self.tier_min_touches = int(tier_min_touches)
        self.p2v_min_samples = int(p2v_min_samples)
        self.repl_lag_epochs_max = int(repl_lag_epochs_max)
        self.degradation_burst = int(degradation_burst)
        self.fire_after = max(1, int(fire_after))
        self.clear_after = max(1, int(clear_after))
        self._lock = named_lock("obs.health")
        self._ring: deque = deque(maxlen=max(2, int(capacity)))
        self._ticks = 0
        self._skipped = 0
        self._alerts: Dict[str, dict] = {}   # kind -> open alert
        self._breach: Dict[str, int] = {}    # kind -> breach streak
        self._clean: Dict[str, int] = {}     # kind -> clean streak
        # attachments (reports are read lock-free at tick/status time)
        self._sync = None
        self._resident = None
        self._net = None
        self._followers: List = []
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- attachments ----------------------------------------------------
    def attach_sync(self, srv) -> "HealthPlane":
        self._sync = srv
        if self._resident is None:
            self._resident = getattr(srv, "resident", None)
        return self

    def attach_resident(self, srv) -> "HealthPlane":
        self._resident = srv
        return self

    def attach_follower(self, fol) -> "HealthPlane":
        self._followers.append(fol)
        return self

    def set_followers(self, fols) -> "HealthPlane":
        """Replace the follower set (topology churn: promote/reopen
        retire old follower generations)."""
        self._followers = list(fols)
        return self

    def attach_net(self, netsrv) -> "HealthPlane":
        self._net = netsrv
        return self

    # -- sampling -------------------------------------------------------
    def _build_sample(self, now: float) -> dict:
        """One flattened registry snapshot + attachment gauges.  Runs
        WITHOUT the plane lock (registry metrics have their own leaf
        locks; attachment reads take serving locks)."""
        num: Dict[str, float] = {}
        hist: Dict[str, tuple] = {}
        for m in self._reg.metrics():
            snap = m.snapshot()
            if m.kind == "histogram":
                counts = [0] * (len(m.buckets) + 1)
                count = 0
                total = 0.0
                for r in snap["values"]:
                    prev = 0
                    for i, (_le, cum) in enumerate(r["buckets"]):
                        counts[i] += cum - prev
                        prev = cum
                    count += r["count"]
                    total += r["sum"]
                hist[m.name] = (m.buckets, counts, count, total)
                num[m.name] = float(count)
                continue
            rows = snap["values"]
            num[m.name] = float(sum(r["value"] for r in rows))
            for r in rows:
                if not r["labels"]:
                    continue
                key = m.name + "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(r["labels"].items())
                ) + "}"
                num[key] = num.get(key, 0.0) + float(r["value"])
                # outcome-level rollups the detectors difference without
                # caring which family produced them
                out = r["labels"].get("outcome")
                if out is not None:
                    rkey = f"{m.name}{{outcome={out}}}"
                    if rkey != key:
                        num[rkey] = num.get(rkey, 0.0) + float(r["value"])
        lag_max = 0
        fols = []
        for fol in list(self._followers):
            try:
                lag = int(getattr(fol, "lag_epochs", 0))
                fols.append({
                    "id": getattr(fol, "follower_id", None),
                    "lag_epochs": lag,
                    "applied_epoch": getattr(fol, "applied_epoch", None),
                })
                lag_max = max(lag_max, lag)
            except Exception:  # a mid-teardown follower is not a sample; the tick must survive it
                continue
        num["health.fol_lag_max"] = float(lag_max)
        return {"t": now, "num": num, "hist": hist,
                "heat": self.heat.report(), "followers": fols}

    def tick(self):
        """Take one sample + evaluate detectors.  NEVER raises into the
        caller: a failing tick (the ``health_tick`` fault site, or any
        sampling surprise) skips this window, counted."""
        now = self._clock()
        try:
            faultinject.check("health_tick")
            sample = self._build_sample(now)
        except Exception as e:  # the tick contract: ANY sampling failure skips the window, counted — never raises into serving
            with self._lock:
                self._skipped += 1
            _m.counter(
                "health.ticks_skipped_total",
                "sampler ticks that failed and skipped their window "
                "(serving never sees the failure)",
            ).inc(error=type(e).__name__)
            flight.record("health.tick_skipped", error=type(e).__name__)
            return []
        with self._lock:
            self._ring.append(sample)
            self._ticks += 1
        _m.counter("health.ticks_total", "health sampler ticks").inc()
        fired = self._evaluate(sample)
        rep = sample["heat"]
        _m.gauge("heat.skew_ratio",
                 "per-shard ingest skew vs uniform (1.0 = balanced)").set(
            rep["skew_ratio"] if rep["skew_ratio"] is not None else 1.0)
        _m.gauge("heat.tracked_docs", "docs with live heat state").set(
            rep["tracked_docs"])
        _m.gauge("health.open_alerts", "currently-open health alerts").set(
            len(self._alerts))
        return fired

    # -- windowed reads -------------------------------------------------
    def _edges(self, window: Optional[float]):
        """(base, latest) ring samples spanning ~the window (caller
        picks apart); None when fewer than 2 samples exist."""
        w = self.window_s if window is None else float(window)
        with self._lock:
            samples = list(self._ring)
        if len(samples) < 2:
            return None
        latest = samples[-1]
        cutoff = latest["t"] - w
        base = samples[0]
        for s in samples[:-1]:
            if s["t"] <= cutoff:
                base = s
            else:
                break
        if base is latest:
            return None
        return base, latest

    def delta(self, name: str, window: Optional[float] = None):
        """Windowed increase of a flattened series (bare metric name or
        ``name{k=v}``); None without two samples."""
        edges = self._edges(window)
        if edges is None:
            return None
        base, latest = edges
        return latest["num"].get(name, 0.0) - base["num"].get(name, 0.0)

    def rate(self, name: str, window: Optional[float] = None):
        """Windowed per-second rate of a flattened series."""
        edges = self._edges(window)
        if edges is None:
            return None
        base, latest = edges
        dt = latest["t"] - base["t"]
        if dt <= 0:
            return None
        dv = latest["num"].get(name, 0.0) - base["num"].get(name, 0.0)
        return dv / dt

    def window_quantile(self, name: str, q: float,
                        window: Optional[float] = None):
        """Quantile of a histogram's observations WITHIN the window
        (bucket-count differencing); None when the window holds no
        observations."""
        edges = self._edges(window)
        if edges is None:
            return None
        base, latest = edges
        cur = latest["hist"].get(name)
        if cur is None:
            return None
        bounds, counts, count, _total = cur
        old = base["hist"].get(name)
        if old is not None and old[0] == bounds:
            counts = [c - o for c, o in zip(counts, old[1])]
            count = count - old[2]
        if count <= 0:
            return None
        return _m._hist_quantile(bounds, counts, count, q)

    def window_count(self, name: str, window: Optional[float] = None):
        """Observations a histogram took within the window."""
        d = self.delta(name, window)
        return None if d is None else int(d)

    def rates_report(self, per_label: bool = False) -> dict:
        """The headline windowed rates (the ``obs.report`` "windowed
        rates" section): every ``*_total`` series with a nonzero rate."""
        edges = self._edges(None)
        if edges is None:
            return {}
        base, latest = edges
        dt = latest["t"] - base["t"]
        if dt <= 0:
            return {}
        out = {}
        for name, v in latest["num"].items():
            if not per_label and "{" in name:
                continue
            if not name.endswith("_total"):
                continue
            dv = v - base["num"].get(name, 0.0)
            if dv > 0:
                out[name] = round(dv / dt, 4)
        return out

    # -- detectors ------------------------------------------------------
    def _predicates(self, sample: dict) -> Dict[str, Optional[str]]:
        """kind -> breach detail (None = clean) — pure reads over the
        ring + the tick's sample."""
        out: Dict[str, Optional[str]] = {}
        rep = sample["heat"]

        skew = rep["skew_ratio"]
        ingest = sum(s["ingest"] for s in rep["shards"].values())
        if (skew is not None and skew > self.shard_skew_max
                and ingest >= self.shard_min_ingest_heat):
            out["shard_saturation"] = (
                f"shard ingest skew {skew}x vs uniform "
                f"(max {self.shard_skew_max}x, ingest heat {ingest:.1f})")
        else:
            out["shard_saturation"] = None

        hits = self.delta("residency.touch_total{outcome=hit}")
        misses = self.delta("residency.touch_total{outcome=miss}")
        detail = None
        if hits is not None and misses is not None:
            touches = hits + misses
            if touches >= self.tier_min_touches:
                hr = hits / touches
                if hr < self.tier_hit_min:
                    detail = (f"windowed tier hit rate {hr:.2f} < "
                              f"{self.tier_hit_min} over {int(touches)} "
                              "touches")
        out["tier_hit_collapse"] = detail

        lag = sample["num"].get("health.fol_lag_max", 0.0)
        prev_lag = None
        edges = self._edges(None)
        if edges is not None:
            prev_lag = edges[0]["num"].get("health.fol_lag_max")
        if lag >= self.repl_lag_epochs_max and (
                prev_lag is None or lag >= prev_lag):
            out["repl_lag"] = (
                f"follower lag {int(lag)} epochs >= "
                f"{self.repl_lag_epochs_max} and not shrinking")
        else:
            out["repl_lag"] = None

        detail = None
        n = self.window_count("sync.push_to_visible_seconds")
        if n is not None and n >= self.p2v_min_samples:
            p99 = self.window_quantile("sync.push_to_visible_seconds", 0.99)
            if p99 is not None and p99 * 1e3 > self.p2v_slo_ms:
                detail = (f"windowed push-to-visible p99 "
                          f"{p99 * 1e3:.1f}ms > SLO {self.p2v_slo_ms}ms "
                          f"({n} pushes)")
        out["p2v_slo"] = detail

        dg = self.delta("resilience.degradations_total")
        if dg is not None and dg >= self.degradation_burst:
            out["degradation_spike"] = (
                f"{int(dg)} degradations within the window "
                f"(burst threshold {self.degradation_burst})")
        else:
            out["degradation_spike"] = None
        return out

    def _evaluate(self, sample: dict) -> List[str]:
        verdicts = self._predicates(sample)
        fired: List[str] = []
        cleared: List[str] = []
        with self._lock:
            for kind, detail in verdicts.items():
                if detail is not None:
                    self._breach[kind] = self._breach.get(kind, 0) + 1
                    self._clean[kind] = 0
                    if (kind not in self._alerts
                            and self._breach[kind] >= self.fire_after):
                        self._alerts[kind] = {
                            "kind": kind,
                            "severity": DETECTOR_SEVERITY[kind],
                            "since": sample["t"],
                            "detail": detail,
                        }
                        fired.append(kind)
                    elif kind in self._alerts:
                        self._alerts[kind]["detail"] = detail
                else:
                    self._clean[kind] = self._clean.get(kind, 0) + 1
                    self._breach[kind] = 0
                    if (kind in self._alerts
                            and self._clean[kind] >= self.clear_after):
                        self._alerts.pop(kind)
                        cleared.append(kind)
        for kind in fired:
            _m.counter("health.alerts_total",
                       "health detector alerts fired").inc(kind=kind)
            flight.record("health.alert", alert=kind,
                          detail=verdicts[kind])
        for kind in cleared:
            _m.counter("health.alerts_cleared_total",
                       "health detector alerts cleared").inc(kind=kind)
            flight.record("health.alert_cleared", alert=kind)
        return fired

    def alerts(self) -> List[dict]:
        """Open alerts (copies), most severe first."""
        with self._lock:
            out = [dict(a) for a in self._alerts.values()]
        out.sort(key=lambda a: SEVERITIES.index(a["severity"]), reverse=True)
        return out

    # -- the status surface ---------------------------------------------
    def _safe_report(self, obj) -> Optional[dict]:
        if obj is None:
            return None
        try:
            return obj.report()
        except Exception as e:  # status must render whatever a wedged layer throws
            return {"unavailable": f"{type(e).__name__}: {e}"}

    def status(self) -> dict:
        """The aggregated JSON verdict: ``ok|degraded|critical`` +
        reasons, composed from open alerts, serving reports, shard
        occupancy/degradation, persist/repl watermarks, follower lag
        and net connections."""
        now = self._clock()
        alerts = self.alerts()
        verdict = "ok"
        reasons: List[str] = []
        for a in alerts:
            verdict = _worse(verdict, a["severity"])
            reasons.append(f"alert {a['kind']}: {a['detail']}")
        resident = self._resident
        shards_sec: Optional[dict] = None
        persist_sec: Optional[dict] = None
        if resident is not None:
            try:
                degraded = list(resident.degraded_shards())
            except AttributeError:
                degraded = None
            if degraded is None:
                flat = bool(getattr(resident, "degraded", False))
                if flat:
                    verdict = _worse(verdict, "critical")
                    reasons.append("resident server degraded to host mirror")
            else:
                n_sh = getattr(resident, "n_shards", len(degraded) or 1)
                shards_sec = {"n_shards": n_sh, "degraded": degraded}
                if degraded:
                    verdict = _worse(verdict, "degraded")
                    reasons.append(
                        f"shards degraded to host mirror: {degraded}")
            de = getattr(resident, "durable_epoch", None)
            if de is not None:
                persist_sec = {"durable_epoch": de}
        fol_sec: List[dict] = []
        for fol in list(self._followers):
            try:
                fol_sec.append({
                    "id": getattr(fol, "follower_id", None),
                    "applied_epoch": getattr(fol, "applied_epoch", None),
                    "lag_epochs": int(getattr(fol, "lag_epochs", 0)),
                })
            except Exception as e:  # status must render a mid-teardown follower, not raise
                fol_sec.append(
                    {"unavailable": f"{type(e).__name__}: {e}"})
        net_rep = self._safe_report(self._net)
        with self._lock:
            ticks, skipped = self._ticks, self._skipped
        return {
            "t": round(now, 6),
            "verdict": verdict,
            "reasons": reasons,
            "alerts": alerts,
            "ticks": ticks,
            "skipped_ticks": skipped,
            "window_s": self.window_s,
            "rates": self.rates_report(),
            "heat": self.heat.report(),
            "serving": self._safe_report(self._sync),
            "shards": shards_sec,
            "persist": persist_sec,
            "repl": {"followers": fol_sec} if fol_sec else None,
            "net": ({"connections": net_rep.get("connections"),
                     "addr": net_rep.get("addr"),
                     "frame_errors": net_rep.get("frame_errors")}
                    if isinstance(net_rep, dict) else None),
        }

    # -- background sampler ---------------------------------------------
    def start(self, period_s: float = 5.0) -> "HealthPlane":
        """Daemon sampler: one ``tick()`` per period until ``stop()``."""
        if self._thread is not None:
            return self
        stop = self._stop = threading.Event()

        def _run():
            while not stop.wait(period_s):
                self.tick()

        self._thread = threading.Thread(
            target=_run, daemon=True, name="loro-health-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self._stop = None


# -- process-global active plane ---------------------------------------
_active: Optional[HealthPlane] = None


def install(plane: Optional[HealthPlane]) -> Optional[HealthPlane]:
    """Make ``plane`` the process's active health plane (``/status.json``,
    the STATUS frame and ``obs.top`` resolve it); returns the previous
    one.  Pass None to uninstall."""
    global _active
    prev, _active = _active, plane
    return prev


def active() -> Optional[HealthPlane]:
    return _active


def status_payload() -> dict:
    """The dict ``/status.json`` and the STATUS frame serve: the active
    plane's ``status()``, or an 'unknown' verdict when none is
    installed."""
    plane = _active
    if plane is None:
        return {"verdict": "unknown",
                "reasons": ["no health plane active"], "alerts": []}
    return plane.status()
