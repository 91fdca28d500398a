"""The port's observability plane (loro_tpu_torch.obs: exposition, report,
trace, health and top) on the CPU against the JAX package's.

The same registry operations, artifacts, fake clocks and sync scenarios
go through both packages; outputs must be equal exactly (tolerance:
none): Prometheus text, sidecar, JSON snapshots, rendered screens, the
trace tools' reports, the health plane's fired alerts and status().
Left out, and said so where it happens: the report screen's banner
(it names its package), the heat section of status() over a live sync
scenario (the process-wide heat accountant runs on the wall clock), the
wall-clock timings of push and pull attribution (their stage names are
compared), and registry series that only one package has (the rates
are compared on the sync, read-plane and server series).

Port-only: /metrics and /status.json through serve(port=0) on
127.0.0.1.  The JAX package's measure_tunnel_rtt (a remote tunnel's round
trip) has no counterpart in the port.
"""
import importlib
import json
import time
import types
import urllib.request

import pytest


def _pkg(root: str):
    m = lambda n: importlib.import_module(f"{root}.{n}")  # noqa: E731
    return types.SimpleNamespace(
        name=root, obs=m("obs"), metrics=m("obs.metrics"), exposition=m("obs.exposition"),
        report=m("obs.report"), trace=m("obs.trace"), health=m("obs.health"), heat=m("obs.heat"),
        top=m("obs.top"), flight=m("obs.flight"), tracing=m("utils.tracing"), fi=m("resilience.faultinject"),
        res=m("resilience"), LoroDoc=m("doc").LoroDoc, SyncServer=m("sync").SyncServer,
        lockwitness=m("analysis.lockwitness"), errors=m("errors"),
        dev={} if root == "loro_tpu" else {"device": "cpu"},
    )


JX, PT = _pkg("loro_tpu"), _pkg("loro_tpu_torch")


@pytest.fixture(autouse=True)
def _quiet():
    for pk in (JX, PT):
        pk.res.set_supervisor(pk.res.DeviceSupervisor(sleep=lambda s: None))
    yield
    for pk in (JX, PT):
        pk.fi.clear()
        pk.res.set_supervisor(None)


def both(scenario, *args):
    rj = scenario(JX, *args)
    rp = scenario(PT, *args)
    assert rj == rp
    return rp


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


# -- exposition ---------------------------------------------------------------


def _ops_counters(reg):
    reg.counter("fleet.ops_merged_total", "rows merged").inc(10, family="text")
    reg.counter("fleet.ops_merged_total", "rows merged").inc(7, family="map")
    reg.counter("a.b_total").inc(3, k='v"q\\')
    reg.gauge("g.half").set(0.125, shard=1)


def _ops_histograms(reg):
    h = reg.histogram("server.epoch_seconds", buckets=[0.1, 1.0])
    for v, fam in ((0.05, "t"), (0.5, "t"), (2.5, "m")):
        h.observe(v, family=fam)
    reg.histogram("sync.push_to_visible_seconds").observe(0.003, family="text", exemplar="p1-1")
    reg.histogram("trace.span_seconds").observe(0.25)


def _ops_mixed(reg):
    _ops_counters(reg)
    _ops_histograms(reg)
    reg.unique("fleet.padded_shapes_distinct").add((64, 8))
    reg.unique("fleet.padded_shapes_distinct").add((64, 8))
    reg.unique("fleet.padded_shapes_distinct").add((128, 8))
    reg.counter("fleet.pad_waste_rows_total").inc(30, kind="dead")
    reg.counter("fleet.pad_waste_rows_total").inc(100, kind="shipped")


OPS = {"counters": _ops_counters, "histograms": _ops_histograms, "mixed": _ops_mixed, "empty": lambda reg: None}


def _exposition(pk, ops):
    reg = pk.metrics.Registry()
    OPS[ops](reg)
    ex = pk.exposition
    return ex.prometheus_text(reg), ex.sidecar(reg), ex.snapshot_json(reg), ex.snapshot_json(reg, indent=2)


@pytest.mark.parametrize("ops", list(OPS))
def test_exposition_formats_match_jax(ops):
    prom, side, snap, _ = both(_exposition, ops)
    if ops == "mixed":
        assert 'server_epoch_seconds_bucket{family="t",le="1.0"} 2' in prom
        assert "# TYPE fleet_padded_shapes_distinct gauge" in prom and "fleet_padded_shapes_distinct 2" in prom
        assert side["fleet.ops_merged_total{family=text}"] == 10 and side["server.epoch_seconds"]["count"] == 3
        assert json.loads(snap)["a.b_total"]["values"][0]["value"] == 3


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _serve(pk):
    clk, reg = FakeClock(), pk.metrics.Registry()
    _ops_mixed(reg)
    plane = pk.health.HealthPlane(clock=clk, registry=reg, heat=pk.heat.HeatAccountant(clock=clk))
    plane.tick()
    prev = pk.health.install(plane)
    srv = pk.exposition.serve(port=0, registry=reg)
    try:
        assert srv.server_address[0] == "127.0.0.1"
        port = srv.server_address[1]
        out = [_get(port, p) for p in ("/metrics", "/metrics.json", "/status.json")]
        with pytest.raises(urllib.error.HTTPError) as info:
            _get(port, "/nope")
        return out, info.value.code
    finally:
        pk.health.install(prev)
        srv.shutdown()
        srv.server_close()


def test_serve_metrics_and_status_json():
    """/metrics, /metrics.json and /status.json from a stdlib HTTP server
    on 127.0.0.1, port 0: the same bodies as the JAX package's."""
    out, missing = both(_serve)
    (s1, t1, prom), (s2, _t2, snap), (s3, t3, status) = out
    assert (s1, s2, s3, missing) == (200, 200, 200, 404)
    assert t1.startswith("text/plain; version=0.0.4") and t3 == "application/json"
    assert b"fleet_ops_merged_total" in prom and "a.b_total" in json.loads(snap)
    assert json.loads(status)["verdict"] == "ok" and json.loads(status)["ticks"] == 1


# -- report -------------------------------------------------------------------


def _strip_banner(screen: str, pk) -> str:
    banner = "loro_tpu.obs — metrics summary" if pk is JX else "loro_tpu_torch.obs — metrics summary"
    assert banner in screen
    return screen.replace(banner.center(78), "<banner>")


def _report(pk, tmp):
    reg = pk.metrics.Registry()
    _ops_mixed(reg)
    snap = json.loads(pk.exposition.snapshot_json(reg))
    screens = [_strip_banner(pk.report.render(snap), pk), _strip_banner(pk.report.render(reg.snapshot()), pk)]
    p = tmp / f"{pk.name}.json"
    p.write_text(pk.exposition.snapshot_json(reg))
    return screens, p


def test_report_render_matches_jax(tmp_path, capsys):
    """report.render on the same snapshot (and report.main over a saved
    file) gives the same screen, banner aside."""
    rj, pj = _report(JX, tmp_path)
    rp, pp = _report(PT, tmp_path)
    assert rj == rp
    assert "fleet.ops_merged_total" in rp[0] and "pad waste" in rp[0]
    outs = []
    for pk, p in ((JX, pj), (PT, pp)):
        assert pk.report.main([str(p)]) == 0
        outs.append(_strip_banner(capsys.readouterr().out, pk))
    assert outs[0] == outs[1]


def test_report_main_live_registry(capsys):
    PT.obs.counter("fleet.ops_merged_total").inc(5, family="text")
    assert PT.report.main([]) == 0
    out = capsys.readouterr().out
    assert "loro_tpu_torch.obs" in out and "fleet.ops_merged_total" in out


# -- trace tools --------------------------------------------------------------


def _flight_artifacts(pk, tmp):
    lead = pk.flight.FlightRecorder(capacity=16)
    fol = pk.flight.FlightRecorder(capacity=16)
    for ep in (3, 4, 5):
        lead.record("server.epoch", family="text", epoch=ep, trace=f"t-{ep}")
        lead.record("sync.commit", family="text", epoch=ep, rounds=1, pushes=2)
        fol.record("repl.apply", epoch=ep, trace=f"t-{ep}", lag_ms=1.5 * ep)
    lp = lead.dump(str(tmp / f"{pk.name}-lead.json"))
    fp = fol.dump(str(tmp / f"{pk.name}-fol.json"))
    return lp, fp


def _neutral_events(art):
    """The artifact's events with the recorder's wall and monotonic stamps
    dropped (each package's recorder stamped its own)."""
    drop = {"t", "ts", "wall", "mono", "t_wall", "t_mono"}
    return [{k: v for k, v in e.items() if k not in drop} for e in art.get("events", [])]


def _load(pk, tmp):
    lp, fp = _flight_artifacts(pk, tmp)
    lead, fol = pk.trace.load_artifact(lp), pk.trace.load_artifact(fp)
    bad = tmp / f"{pk.name}-bad.json"
    bad.write_text('{"neither": 1}')
    with pytest.raises(pk.errors.ObsError):
        pk.trace.load_artifact(str(bad))
    return lead, fol


def test_trace_tools_match_jax(tmp_path):
    """load_artifact gives the same events (stamps aside) from each
    package's recorder; merge_lag, merged_chrome, render_merge and
    render_inspect give the same results on the same artifacts."""
    arts = {pk.name: _load(pk, tmp_path) for pk in (JX, PT)}
    assert [_neutral_events(a) for a in arts["loro_tpu"]] == [_neutral_events(a) for a in arts["loro_tpu_torch"]]
    for lead, fol in arts.values():
        outs = []
        for pk in (JX, PT):
            t = pk.trace
            rep = t.merge_lag(lead, fol)
            outs.append((rep, t.render_merge(rep), t.merged_chrome(lead, fol), t.render_inspect(lead, "l.json"),
                         t.render_inspect(fol, "f.json")))
        assert outs[0] == outs[1]
        rep, screen, merged = outs[1][:3]
        assert rep["count"] == 3 and "replication-lag attribution" in screen and "epoch 3" in screen
        assert {e["pid"] for e in merged["traceEvents"]} == {1, 2}


def _chrome_inspect(pk, tmp):
    pk.tracing.enable()
    try:
        with pk.tracing.span("cli.probe"):
            pass
        p = pk.tracing.dump(str(tmp / f"{pk.name}-t.json"))
    finally:
        pk.tracing.disable()
        pk.tracing.clear()
    art = pk.trace.load_artifact(p)
    names = sorted(e.get("name") for e in art["traceEvents"])
    return names, "cli.probe" in pk.trace.render_inspect(art, p)


def test_trace_inspect_chrome(tmp_path):
    assert both(_chrome_inspect, tmp_path)[1]


def _trace_cli(pk, tmp, capsys):
    lp, fp = _flight_artifacts(pk, tmp)
    out_path = str(tmp / f"{pk.name}-merged.json")
    rcs = [pk.trace.main(["inspect", lp]), pk.trace.main(["merge", lp, fp, "-o", out_path])]
    out = capsys.readouterr().out
    bad = tmp / "bad.json"
    bad.write_text('{"neither": 1}')
    rcs += [pk.trace.main(["inspect", str(bad)]), pk.trace.main(["inspect", str(tmp / "missing.json")])]
    err = capsys.readouterr().err
    rcs += [pk.trace.main([]), pk.trace.main(["wat"])]
    helpout = capsys.readouterr().out
    dump = str(tmp / f"{pk.name}-proc.json")
    rcs.append(pk.trace.main(["dump", dump]))
    capsys.readouterr()
    return (rcs, "replication-lag attribution" in out, "obs.trace:" in err, "Subcommands" in helpout,
            json.load(open(dump))["flight"], sorted({e["pid"] for e in json.load(open(out_path))["traceEvents"]}))


def test_trace_cli_matches_jax(tmp_path, capsys):
    rec = both(_trace_cli, tmp_path, capsys)
    assert rec == ([0, 0, 2, 2, 0, 2, 0], True, True, True, 1, [1, 2])


# -- the health plane ---------------------------------------------------------


def _plane(pk, clk, reg, **kw):
    kw.setdefault("heat", pk.heat.HeatAccountant(clock=clk))
    return pk.health.HealthPlane(clock=clk, registry=reg, **kw)


def _tick_n(plane, clk, n, dt=1.0):
    fired = []
    for _ in range(n):
        clk.advance(dt)
        fired += plane.tick()
    return fired


def _detectors(pk, kind):
    clk, reg = FakeClock(), pk.metrics.Registry()
    trail = []
    if kind == "shard_saturation":
        acc = pk.heat.HeatAccountant(clock=clk)
        plane = _plane(pk, clk, reg, heat=acc, shard_skew_max=2.0, shard_min_ingest_heat=1.0)
        acc.tick_shard(0, "ingest", 8.0, of=4)
        trail += [_tick_n(plane, clk, 1), _tick_n(plane, clk, 1), plane.alerts(), plane.status()]
        for s in (1, 2, 3):
            acc.tick_shard(s, "ingest", 8.0, of=4)
        trail += [_tick_n(plane, clk, 2), plane.status()]
    elif kind == "tier_hit_collapse":
        plane = _plane(pk, clk, reg, tier_hit_min=0.5, tier_min_touches=8)
        touch = reg.counter("residency.touch_total")
        plane.tick()
        touch.inc(10, family="map", outcome="miss")
        trail += [_tick_n(plane, clk, 2), plane.status()]
        clk.advance(plane.window_s + 1.0)
        trail += [_tick_n(plane, clk, 2), plane.alerts()]
    elif kind == "repl_lag":
        fol = types.SimpleNamespace(follower_id="f0", applied_epoch=3, lag_epochs=4)
        plane = _plane(pk, clk, reg, repl_lag_epochs_max=3)
        plane.attach_follower(fol)
        trail += [_tick_n(plane, clk, 2), plane.status()]
        fol.lag_epochs = 0
        trail += [_tick_n(plane, clk, 2), plane.status()]
    elif kind == "p2v_slo":
        plane = _plane(pk, clk, reg, p2v_slo_ms=50.0, p2v_min_samples=4)
        h = reg.histogram("sync.push_to_visible_seconds")
        plane.tick()
        for _ in range(8):
            h.observe(0.5, family="text")
        trail += [_tick_n(plane, clk, 2), plane.status()]
        clk.advance(plane.window_s + 1.0)
        trail += [_tick_n(plane, clk, 2), plane.alerts()]
    else:  # degradation_spike
        plane = _plane(pk, clk, reg, degradation_burst=3)
        c = reg.counter("resilience.degradations_total")
        plane.tick()
        c.inc(3, label="x")
        trail += [_tick_n(plane, clk, 2), plane.status()]
        clk.advance(plane.window_s + 1.0)
        trail += [_tick_n(plane, clk, 3), plane.status()]
    trail += [plane.rates_report(), plane.rates_report(per_label=True), plane.delta("residency.touch_total"),
              plane.window_count("sync.push_to_visible_seconds")]
    return json.loads(json.dumps(trail))


@pytest.mark.parametrize("kind", ["shard_saturation", "tier_hit_collapse", "repl_lag", "p2v_slo",
                                  "degradation_spike"])
def test_health_detectors_match_jax(kind):
    """Each detector fires and clears at the same ticks, with the same
    alerts, rates and status(), under one fake clock in both packages."""
    trail = both(_detectors, kind)
    assert kind in json.dumps(trail)


def _windows(pk):
    clk, reg = FakeClock(), pk.metrics.Registry()
    plane = _plane(pk, clk, reg, window_s=10.0, capacity=8)
    c = reg.counter("x.ops_total")
    h = reg.histogram("x.lat_seconds", buckets=[0.01, 0.1, 1.0])
    out = []
    for i in range(12):
        c.inc(i, outcome="hit" if i % 2 else "miss")
        h.observe(0.005 * (i + 1), family="t")
        plane.tick()
        out.append((plane.rate("x.ops_total"), plane.delta("x.ops_total{outcome=hit}", 3.0),
                    plane.window_quantile("x.lat_seconds", 0.5), plane.window_count("x.lat_seconds", 5.0)))
        clk.advance(1.5)
    return out, len(plane._ring), plane.status()["ticks"]


def test_health_windowed_rates_match_jax():
    out, ring, ticks = both(_windows)
    assert ring == 8 and ticks == 12


def _tick_fault(pk):
    clk, reg = FakeClock(), pk.metrics.Registry()
    plane = _plane(pk, clk, reg)
    plane.tick()
    pk.fi.inject("health_tick", times=1)
    try:
        clk.advance(1.0)
        fired = plane.tick()
    finally:
        pk.fi.clear("health_tick")
    st1 = plane.status()
    clk.advance(1.0)
    plane.tick()
    return fired, st1["ticks"], st1["skipped_ticks"], plane.status()["ticks"]


def test_health_tick_fault_skips_one_window():
    assert both(_tick_fault) == ([], 1, 1, 2)
    assert "health_tick" in PT.fi.sites()


def _status_surface(pk):
    clk, reg = FakeClock(), pk.metrics.Registry()
    prev = pk.health.install(None)
    try:
        unknown = pk.health.status_payload()
        plane = _plane(pk, clk, reg)
        assert pk.health.install(plane) is None and pk.health.active() is plane
        plane.attach_follower(types.SimpleNamespace(follower_id="f0", applied_epoch=7, lag_epochs=1))
        plane.attach_resident(types.SimpleNamespace(degraded=True, durable_epoch=9))
        plane._sync = types.SimpleNamespace(report=lambda: 1 / 0)
        plane.tick()
        st = pk.health.status_payload()
        json.dumps(st)
        return unknown, json.loads(json.dumps(st))
    finally:
        pk.health.install(prev)


def test_health_status_surface_matches_jax():
    unknown, st = both(_status_surface)
    assert unknown["verdict"] == "unknown"
    assert st["verdict"] == "critical" and "unavailable" in st["serving"]
    assert st["repl"]["followers"][0]["lag_epochs"] == 1 and st["persist"] == {"durable_epoch": 9}


def _top_payload(pk):
    clk, reg = FakeClock(), pk.metrics.Registry()
    acc = pk.heat.HeatAccountant(clock=clk)
    plane = _plane(pk, clk, reg, heat=acc)
    acc.tick_doc(3, "push", 5.0)
    acc.tick_shard(0, "ingest", 4.0, of=2)
    reg.counter("r.ops_total").inc(2)
    plane.tick()
    reg.counter("r.ops_total").inc(8)
    clk.advance(4.0)
    plane.tick()
    return plane.status()


def _top(pk, tmp, capsys):
    st = _top_payload(pk)
    screen = pk.top.render_status(st)
    f = tmp / f"{pk.name}-status.json"
    f.write_text(json.dumps(st))
    assert pk.top.render_status(pk.top._load(str(f))) == pk.top.render_status(json.loads(json.dumps(st)))
    rc = pk.top.main([str(f)])
    out = capsys.readouterr().out
    prev = pk.health.install(None)
    try:
        rc2 = pk.top.main(["--once"])
        unknown = capsys.readouterr().out
    finally:
        pk.health.install(prev)
    return screen, rc, out, rc2, unknown


def test_top_render_matches_jax(tmp_path, capsys):
    screen, rc, out, rc2, unknown = both(_top, tmp_path, capsys)
    assert "OK" in screen and "r.ops_total" in screen and len(screen.splitlines()) < 60
    assert rc == rc2 == 0 and "OK" in out and "UNKNOWN" in unknown


def _health_over_sync(pk, capsys):
    """A HealthPlane on a fake clock over one SyncServer scenario: two
    pushes and three pulls between two ticks."""
    clk = FakeClock()
    d = pk.LoroDoc(peer=11)
    d.get_text("t").insert(0, "health")
    d.commit()
    srv = pk.SyncServer("text", 2, cid=d.get_text("t").id, capacity=1 << 10, **pk.dev)
    plane = pk.health.HealthPlane(clock=clk, window_s=30.0, p2v_slo_ms=60_000.0).attach_sync(srv)
    prev = pk.health.install(plane)
    try:
        s, r = srv.connect(), srv.connect()
        plane.tick()
        s.push(0, d.export_updates({})).epoch(60)
        vv = d.oplog_vv()
        d.get_text("t").insert(0, "more ")
        d.commit()
        s.push(0, d.export_updates(vv)).epoch(60)
        pulls = [r.pull(0), r.pull(0), s.pull(0)]
        clk.advance(2.0)
        fired = plane.tick()
        st = plane.status()
        keep = ("sync.", "readbatch.", "server.")
        rates = {k: v for k, v in st["rates"].items() if k.startswith(keep)}
        assert "sync.pushes_total" in rates and "sync.pulls_total" in rates
        # a health_tick fault skips one tick; pulls still serve
        pk.fi.inject("health_tick", times=1)
        try:
            clk.advance(1.0)
            plane.tick()
        finally:
            pk.fi.clear("health_tick")
        late = srv.connect().pull(0)
        st2 = plane.status()
        screen = pk.top.render_status({**st, "heat": pk.heat.HeatAccountant(clock=clk).report(), "rates": rates})
        core = {k: st[k] for k in ("verdict", "reasons", "alerts", "ticks", "skipped_ticks", "window_s",
                                   "serving", "shards", "persist", "repl", "net")}
        return pulls, fired, rates, core, st2["skipped_ticks"], st2["ticks"], late, screen
    finally:
        pk.health.install(prev)
        srv.close()


def test_health_plane_over_sync_matches_jax(capsys):
    """Equal rates (the sync, read-plane and server series), alerts and
    status() over the same sync scenario; the heat section is left out
    (the process-wide accountant runs on the wall clock)."""
    rec = both(_health_over_sync, capsys)
    assert rec[3]["verdict"] == "ok" and rec[4] == 1 and rec[5] == 2 and rec[6] == rec[0][0]


def _attribution(pk, tmp):
    d = pk.LoroDoc(peer=13)
    d.get_text("t").insert(0, "attribution")
    d.commit()
    out = []
    for kw in ({"durable_dir": str(tmp / f"{pk.name}-dur"), "durable_fsync": "group", "fsync_window": 4},
               {"pipeline": False}):
        srv = pk.SyncServer("text", 2, cid=d.get_text("t").id, capacity=1 << 12, **pk.dev, **kw)
        try:
            s = srv.connect()
            tk = s.push(0, d.export_updates({}))
            tk.epoch(60)
            bd = tk.breakdown()
            stages = sum(v for k, v in bd.items() if k.endswith("_ms") and k != "total_ms")
            assert stages == pytest.approx(bd["total_ms"], abs=1e-6)
            ex = pk.metrics.histogram("sync.push_to_visible_seconds").exemplars(family="text")
            assert tk.trace_id in ex.values()
            r = srv.connect()
            r.pull(0)
            lp = dict(r.last_pull)
            out.append((sorted(bd), lp["path"], sorted(lp), lp["trace_id"][0]))
        finally:
            srv.close()
    srv = pk.SyncServer("text", 1, cid=d.get_text("t").id, capacity=1 << 12, read_batch=False, **pk.dev)
    try:
        s = srv.connect()
        s.push(0, d.export_updates({})).epoch(60)
        s2 = srv.connect()
        s2.pull(0)
        out.append((s2.last_pull["path"], sorted(s2.last_pull)))
    finally:
        srv.close()
    return out


def test_push_and_pull_attribution_match_jax(tmp_path):
    """Push breakdowns telescope to their total and carry the same
    stages; pulls carry the same paths and stage names (timings left
    out)."""
    rec = both(_attribution, tmp_path)
    assert {"queue_wait_ms", "coalesce_wait_ms", "stage_ms", "commit_ms", "fsync_ms", "fanout_ms"} <= set(rec[0][0])
    assert "commit_ms" in rec[1][0] and "coalesce_wait_ms" not in rec[1][0]
    assert rec[0][1] == "device" and rec[2][0] == "oracle"


def test_span_metrics_bridge():
    PT.obs.enable_span_metrics()
    try:
        with PT.tracing.span("torch.obs.probe"):
            pass
    finally:
        PT.obs.disable_span_metrics()
    rows = PT.metrics.histogram("trace.span_seconds").snapshot()["values"]
    assert any(r["labels"].get("span") == "torch.obs.probe" and r["count"] >= 1 for r in rows)


def test_obs_exports_match_jax():
    """The port exports what the JAX package does, less measure_tunnel_rtt
    (the JAX package's remote-tunnel probe)."""
    want = sorted(set(JX.obs.__all__) - {"measure_tunnel_rtt"})
    assert sorted(PT.obs.__all__) == want
    for name in want:
        assert hasattr(PT.obs, name), name
    assert not hasattr(PT.obs, "measure_tunnel_rtt")


def test_health_lock_conformance():
    """obs.health is a near-leaf: heat ticks under the serving locks and
    a tick's detector path conform to the declared order."""
    lw = PT.lockwitness.witness()
    lw.reset()
    lw.enable(strict=True)
    try:
        clk = FakeClock()
        acc = PT.heat.HeatAccountant(clock=clk)
        with PT.lockwitness.named_rlock("sync.server"):
            acc.tick_doc(0, "push")
        with PT.lockwitness.named_rlock("residency.plan"):
            acc.tick_doc(0, "touch")
            acc.tick_revive()
        plane = PT.health.HealthPlane(clock=clk, registry=PT.metrics.Registry(), heat=acc)
        plane.tick()
        plane.status()
    finally:
        lw.disable()
    assert lw.check_declared() == []
    lw.assert_acyclic()
    lw.reset()


def test_health_sampler_thread_stops():
    plane = PT.health.HealthPlane(registry=PT.metrics.Registry())
    plane.start(period_s=0.01)
    time.sleep(0.05)
    plane.stop()
    assert plane._thread is None and plane.status()["ticks"] >= 1


def _fleet_counters(metrics):
    out = {}
    for m in metrics.registry().metrics():
        if m.name.startswith("fleet.") and m.kind == "counter":
            for row in m.snapshot()["values"]:
                out[(m.name, tuple(sorted(row["labels"].items())))] = row["value"]
    return out


@pytest.mark.parametrize("family", ["text", "richtext", "movable", "tree", "tree_children", "counter", "map"])
def test_fleet_merge_counters_match_jax(family):
    """The same one-shot merge through both packages' Fleet ticks the same
    fleet.* counters (calls, docs, real and pad-waste rows, launches) and
    the same distinct padded shape."""
    import jax

    from loro_tpu.codec.binary import decode_changes as jdecode
    from loro_tpu.core.ids import ContainerID as JCid
    from loro_tpu.ops.columnar import extract_map_ops as jextract_map
    from loro_tpu.parallel.fleet import Fleet as JFleet
    from loro_tpu.parallel.mesh import make_mesh
    from loro_tpu_torch import tracegen
    from loro_tpu_torch.codec.binary import decode_changes as pdecode
    from loro_tpu_torch.ops.columnar import extract_map_ops as pextract_map
    from loro_tpu_torch.parallel.fleet import Fleet as PFleet

    docs = tracegen.loro_fleet(31, 5, n_rounds=3, max_edits=6)
    payloads = [d.payload() for d in docs]
    cids = {"text": tracegen.TEXT_CID, "richtext": tracegen.RICH_CID, "movable": tracegen.MOVABLE_CID,
            "tree": tracegen.TREE_CID, "tree_children": tracegen.TREE_CID}
    jfl, pfl = JFleet(mesh=make_mesh(jax.devices()[:1])), PFleet(device="cpu")

    def run(fl, dec, cid_of, extract_map):
        chs = [dec(p) for p in payloads]
        if family == "map":
            return fl.merge_map_docs([extract_map(c) for c in chs])
        if family == "counter":
            return fl.merge_counter_changes(chs)
        name = {"text": "merge_text_changes", "richtext": "merge_richtext_changes",
                "movable": "merge_movable_changes", "tree": "merge_tree_changes",
                "tree_children": "merge_tree_children"}[family]
        return getattr(fl, name)(chs, cid_of(cids[family]))

    deltas = []
    for pk, fl, dec, cid_of, ex in ((JX, jfl, jdecode, lambda c: JCid.parse(str(c)), jextract_map),
                                    (PT, pfl, pdecode, lambda c: c, pextract_map)):
        c0 = _fleet_counters(pk.metrics)
        shapes = pk.metrics.unique("fleet.padded_shapes_distinct")._values
        s0 = set(shapes.get((), ()))
        run(fl, dec, cid_of, ex)
        c1 = _fleet_counters(pk.metrics)
        deltas.append(({k: v - c0.get(k, 0) for k, v in c1.items() if v != c0.get(k, 0)},
                       set(shapes.get((), ())) - s0))
    assert deltas[0] == deltas[1]
    deltas = [d for d, _ in deltas]
    fam = family
    assert deltas[1][("fleet.merge_calls_total", (("family", fam),))] == 1
    assert deltas[1][("fleet.docs_merged_total", (("family", fam),))] == len(docs)
