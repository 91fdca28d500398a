"""The port's WAL-shipping replication (loro_tpu_torch.replication:
enable, ReplicationManifest, WalShipper, Follower, ShardedFollower,
ReadOnlySyncServer) on the CPU against the JAX package's.

Every scenario runs once through each package (`both`) in a directory of
its own: the JAX leader and follower on a one-device mesh (two devices
for the sharded fleet), the port's on device="cpu" (["cpu", "cpu"]),
client LoroDocs of the same package edited by the same deterministic
script (tests/_persist_crash_child.py's edit stream), the WAL stamp clock
``_wall`` and the manifests' clock patched in both, and each package's
trace-id counter restarted.  A scenario returns a
record: epochs, follower reports (without the measured lag), the
follower's reads and pulled bytes, typed errors, and the bytes of every
file of the follower's directory; the two records must be equal exactly
(tolerance: none).  Every follower read is also held against the
leader's and the client's oracle, and every follower pull against the
leader's pull at the same frontier.

Port-only cases: a real device error in the follower's apply or
checkpoint reaches `catch_up()` typed (DeviceFailure, injected False)
with `applied_epoch` where it was and the follower not degraded, where
the JAX follower skips a failed checkpoint on any ResilienceError; a
leader process killed with SIGKILL (tests/_torch_repl_crash_child.py)
promoted with no round at or below its acked watermark lost; no CPU
fallback without a card.
"""
import importlib
import itertools
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import pytest
import torch

import _persist_crash_child as crash
import _torch_repl_crash_child as rcrash
from loro_tpu.parallel.mesh import make_mesh
from test_torch_doc import plain
from test_torch_server import _quiet  # noqa: F401  (autouse: sleepless supervisors, the WAL clock, faults cleared)

FAMILIES = crash.FAMILIES
CAPS = crash.CAPS
CPU2 = ["cpu", "cpu"]
T0 = 1_700_000_000.5  # the manifests' patched clock


def _pkg(root: str):
    m = lambda n: importlib.import_module(f"{root}.{n}")  # noqa: E731
    doc = m("doc")
    repl = m("replication")
    jax_pkg = root == "loro_tpu"
    return types.SimpleNamespace(
        name=root, LoroDoc=doc.LoroDoc, strip=doc.strip_envelope, repl=repl, Follower=repl.Follower,
        ShardedFollower=repl.ShardedFollower, Manifest=repl.ReplicationManifest,
        SyncServer=m("sync").SyncServer, ResidentServer=m("parallel.server").ResidentServer,
        Sharded=m("parallel.sharded").ShardedResidentServer, errors=m("errors"), fi=m("resilience.faultinject"),
        obs=m("obs.metrics"), inspect=m("persist.inspect"), wal=m("persist.wal"), tracing=m("utils.tracing"),
        dev=(lambda: {"mesh": make_mesh(jax.devices()[:1])}) if jax_pkg else (lambda: {"device": "cpu"}),
        devs=(lambda: {"mesh": make_mesh(jax.devices()[:2])}) if jax_pkg else (lambda: {"devices": CPU2}),
    )


JX, PT = _pkg("loro_tpu"), _pkg("loro_tpu_torch")
_PEER = {f: 9000 + i for i, f in enumerate(FAMILIES)}


def both(scenario, tmp_path, *args):
    """Run `scenario(pkg, dir, *args)` through the JAX package and the
    port at one path (the JAX run's directory is moved aside before the
    port's starts: paths appear in messages), each package's trace-id
    counter restarted (WAL round records carry the push's trace id);
    their records must be equal.  Returns the port's record."""
    run = tmp_path / "run"
    JX.tracing._trace_counter = itertools.count(1)
    rj = scenario(JX, run, *args)
    if run.exists():
        run.rename(tmp_path / "jax")
    PT.tracing._trace_counter = itertools.count(1)
    rp = scenario(PT, run, *args)
    assert rj == rp
    return rp


class Clock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


def make_doc(pk, family, idx=0):
    """tests/_persist_crash_child.make_doc in package `pk`."""
    d = pk.LoroDoc(peer=_PEER[family] + 100 * idx)
    if family == "text":
        d.get_text("t").insert(0, "crash base text")
    elif family == "map":
        d.get_map("m").set("k0", 0)
    elif family == "tree":
        d.get_tree("tr").create()
    elif family == "movable":
        d.get_movable_list("ml").push("a", "b", "c")
    elif family == "counter":
        d.get_counter("c").increment(1)
    d.commit()
    return d


def drive(srv, d, fam, rounds, start=1, mark=None, ckpt_at=None):
    """Deterministic ingest rounds (the persist crash child's stream)."""
    for r in range(start, start + rounds):
        if mark is None:
            chs = d.oplog.changes_in_causal_order()
        else:
            crash.apply_edit(d, fam, r)
            chs = d.oplog.changes_between(mark, d.oplog_vv())
        mark = d.oplog_vv()
        srv.ingest([chs], crash.container_id(fam, d))
        if ckpt_at is not None and r == ckpt_at:
            srv.checkpoint()
    return mark


def files(d):
    """Every file under `d` with its bytes."""
    d = Path(d)
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def report(fol):
    """A follower's report without the measured apply lag."""
    return {k: v for k, v in fol.report().items() if not k.startswith("apply_lag")}


def view(srv, fam):
    return plain(crash.read_server(srv, fam))


def oracle(d, fam):
    return plain(crash.read_oracle(d, fam))


def leader(pk, tmp, fam="text", clock=None, stale_after=None, **kw):
    d = make_doc(pk, fam)
    srv = pk.ResidentServer(fam, 1, durable_dir=str(tmp / "L"), **pk.dev(), **CAPS[fam], **kw)
    extra = {} if stale_after is None else {"stale_after": stale_after}
    pk.repl.enable(srv, "leader", clock=clock or Clock(), **extra)
    return d, srv


def follower(pk, tmp, lead, clock=None, **kw):
    return pk.Follower(str(tmp / "L"), str(tmp / "F"), leader=lead, clock=clock or Clock(), **pk.dev(), **kw)


# -- the manifest ----------------------------------------------------------------


def _manifest(pk, tmp):
    tmp.mkdir(parents=True)
    clk = Clock()
    man = pk.Manifest(str(tmp), clock=clk, stale_after=60)
    out = [man.claim_leader("a"), man.claim_leader("a")]
    with pytest.raises(pk.errors.NotLeader) as info:
        man.claim_leader("b")
    out += [str(info.value), info.value.leader, man.bump_token("b"), man.leader(), man.claim_leader("c", token=3)]
    (tmp / ".token-4.claim").write_bytes(b"")
    out += [man.bump_token("d"), man.leader(), man.bump_token("e"), sorted(os.listdir(tmp))]
    man.ack_follower("f1", 5)
    man.ack_follower("f2", 9)
    out.append(man.pinned_floor())
    man.ack_follower("f1", 3)
    clk.t += 30
    man.ack_follower("f2", 11)
    clk.t += 45
    out += [man.followers(), man.pinned_floor()]
    man.drop_follower("f2")
    out += [man.pinned_floor(), pk.repl.load_replication(str(tmp)), files(tmp)]
    return out


def test_manifest_tokens_acks_and_staleness_match_jax(tmp_path):
    """Claims, a refused steal, token bumps past a racing claim file,
    monotone acks, the staleness cutoff and the file's bytes."""
    rec = both(_manifest, tmp_path)
    assert rec[0] == rec[1] == 1 and rec[7] == 5 and rec[9] == 6


# -- ship visibility ------------------------------------------------------------


def _durable_watermark(pk, tmp):
    fam = "text"
    d, srv = leader(pk, tmp, fam, durable_fsync="group", fsync_window=64)
    try:
        mark = drive(srv, d, fam, 1)
        srv.flush_durable()
        fol = follower(pk, tmp, srv)
        try:
            mark = drive(srv, d, fam, 3, start=2, mark=mark)
            assert srv.durable_epoch < srv.epoch
            out = [fol.catch_up()["applied_epoch"], srv.durable_epoch, fol.lag_epochs]
            srv.flush_durable()
            out += [fol.catch_up()["applied_epoch"], srv.epoch, fol.lag_epochs, view(fol.resident, fam)]
            assert out[-1] == oracle(d, fam)
            return out, report(fol), files(tmp / "F")
        finally:
            fol.close()
    finally:
        srv.close()


def test_follower_never_applies_past_the_durable_watermark(tmp_path):
    rec = both(_durable_watermark, tmp_path)
    assert rec[0][0] == rec[0][1] < rec[0][4] and rec[0][3] == rec[0][4]


def _marker(pk, tmp):
    fam = "map"
    d, srv = leader(pk, tmp, fam, durable_fsync="group", fsync_window=64)
    try:
        mark = drive(srv, d, fam, 2)
        srv.flush_durable()
        fol = pk.Follower(str(tmp / "L"), str(tmp / "F"), leader=None, clock=Clock(), **pk.dev())
        try:
            out = [fol.applied_epoch]
            drive(srv, d, fam, 2, start=3, mark=mark)
            out.append(fol.catch_up()["applied_epoch"])
            srv.flush_durable()
            out.append(fol.catch_up()["applied_epoch"])
            out.append(view(fol.resident, fam))
            assert out[-1] == oracle(d, fam)
            return out, report(fol), files(tmp / "F")
        finally:
            fol.close()
    finally:
        srv.close()


def test_cross_process_marker_gates_the_tail(tmp_path):
    assert both(_marker, tmp_path)[0][:3] == [2, 2, 4]


# -- the five-family follower gate ------------------------------------------------


def _differential(pk, tmp, fam, pipelined):
    """A durable leader behind a SyncServer (serial, or pipelined with
    group commit) and its follower: after each catch_up the follower's
    reads equal the leader's and the client's, and its pulls equal the
    leader's at the same frontier."""
    d = make_doc(pk, fam)
    ldir = str(tmp / "L")
    kw = dict(pipeline=True, durable_fsync="group", fsync_window=4) if pipelined else dict(pipeline=False)
    lead = pk.SyncServer(fam, 1, cid=crash.container_id(fam, d), durable_dir=ldir, **pk.dev(), **CAPS[fam], **kw)
    fol = None
    try:
        pk.repl.enable(lead.resident, "leader", clock=Clock())
        ls = lead.connect()
        mark = d.oplog_vv()
        ls.push(0, bytes(d.export_updates({}))).epoch(30)
        if pipelined:
            lead.flush()
            lead.resident.flush_durable()
        fol = follower(pk, tmp, lead.resident)
        fs, ls2 = fol.sync.connect(), lead.connect()
        lc, fc = pk.LoroDoc(peer=71), pk.LoroDoc(peer=72)
        out = []

        def pulls():
            lb, fb = ls2.pull(0), fs.pull(0)
            assert lb == fb
            lc.import_(lb)
            fc.import_(fb)
            out.append(fb)

        pulls()
        for r in range(2, 10 if pipelined else 8):
            crash.apply_edit(d, fam, r)
            ls.push(0, bytes(d.export_updates(mark))).epoch(30)
            mark = d.oplog_vv()
            if not pipelined:
                if r == 4:
                    lead.resident.checkpoint()
                rep = fol.catch_up()
                assert rep["applied_epoch"] == lead.resident.epoch
                assert view(fol.resident, fam) == view(lead.resident, fam) == oracle(d, fam)
                out.append((rep["applied_epoch"], rep["rounds"], view(fol.resident, fam)))
                pulls()
        if pipelined:
            lead.flush()
            lead.resident.flush_durable()
            rep = fol.catch_up()
            assert rep["applied_epoch"] == lead.resident.durable_epoch
            assert view(fol.resident, fam) == view(lead.resident, fam) == oracle(d, fam)
            out.append((rep["applied_epoch"], rep["rounds"], view(fol.resident, fam)))
            pulls()
        assert oracle(fc, fam) == oracle(lc, fam) == oracle(d, fam)
        assert pipelined or fol.ckpts_applied >= 1
        return out, report(fol), files(tmp / "F"), fol.sync.report()["pushes"]
    finally:
        if fol is not None:
            fol.close()
        lead.close()


@pytest.mark.parametrize("pipelined", [False, True], ids=["serial", "pipelined"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_follower_reads_and_pulls_equal_leader_and_jax(tmp_path, fam, pipelined):
    both(_differential, tmp_path, fam, pipelined)


def _sharded(pk, tmp):
    """A two-shard durable leader with a live migration mid-stream: the
    ShardedFollower tracks sharding.json, merges reads equal to the
    leader's, and promotes into a writable fleet."""
    fam, n_docs = "text", 4
    docs = [make_doc(pk, fam, i) for i in range(n_docs)]
    lead = pk.Sharded(fam, n_docs, shards=2, durable_dir=str(tmp / "L"), **pk.devs(), **CAPS[fam])
    fol = None
    marks = [None] * n_docs
    cid = crash.container_id(fam, docs[0])

    def round_(r):
        di = r % n_docs
        d = docs[di]
        if marks[di] is None:
            chs = d.oplog.changes_in_causal_order()
        else:
            crash.apply_edit(d, fam, r)
            chs = d.oplog.changes_between(marks[di], d.oplog_vv())
        marks[di] = d.oplog_vv()
        ups = [None] * n_docs
        ups[di] = chs
        lead.ingest(ups, cid)

    try:
        pk.repl.enable(lead, "leader", clock=Clock())
        for r in range(8):
            round_(r)
        fol = pk.ShardedFollower(str(tmp / "L"), str(tmp / "F"), leader=lead, clock=Clock(), **pk.devs())
        out = [fol.catch_up()["applied_epoch"], fol.texts()]
        assert out[-1] == lead.texts()
        src, _ = lead.placement.place(0)
        lead.migrate(0, 1 - src)
        for r in range(8, 14):
            round_(r)
        lead.checkpoint()
        for r in range(14, 17):
            round_(r)
        rep = fol.catch_up()
        assert fol.applied_epoch == lead.durable_epoch and fol.lag_epochs == 0
        assert fol.texts() == lead.texts() == [crash.read_oracle(d, fam)[0] for d in docs]
        assert fol.placement.place(0)[0] == 1 - src
        out += [{k: v for k, v in rep.items() if k != "shards"}, [report(f) for f in fol.shards], fol.texts(),
                fol.richtexts(), fol.placement.place(0)]
        lead.close()
        fleet = fol.promote("f1")
        out += [fleet.epoch, fleet.texts(), fol.report()["promoted"]]
        crash.apply_edit(docs[1], fam, 40)
        ups = [None] * n_docs
        ups[1] = docs[1].oplog.changes_between(marks[1], docs[1].oplog_vv())
        out.append(fleet.ingest(ups, cid))
        assert fleet.texts()[1] == docs[1].get_text("t").to_string()
        assert fleet.durable_epoch == fleet.epoch
        out.append(fleet.texts())
        fleet.close()
        return out, {k: v for k, v in files(tmp / "F").items() if "wal" in k or "ckpt" in k}
    finally:
        if fol is not None:
            fol.close()
        lead.close()


def test_sharded_follower_with_migration_matches_jax(tmp_path):
    both(_sharded, tmp_path)


def _tiered(pk, tmp):
    fam, n_docs = "text", 3
    docs = [make_doc(pk, fam, i) for i in range(n_docs)]
    cid = crash.container_id(fam, docs[0])
    lead = pk.ResidentServer(fam, n_docs, hot_slots=1, durable_dir=str(tmp / "L"), **pk.dev(), **CAPS[fam])
    fol = None
    marks = [None] * n_docs

    def push(di, r=None):
        d = docs[di]
        if marks[di] is None:
            chs = d.oplog.changes_in_causal_order()
        else:
            crash.apply_edit(d, fam, r)
            chs = d.oplog.changes_between(marks[di], d.oplog_vv())
        marks[di] = d.oplog_vv()
        ups = [None] * n_docs
        ups[di] = chs
        lead.ingest(ups, cid)

    try:
        pk.repl.enable(lead, "leader", clock=Clock())
        for di in range(n_docs):
            push(di)
        lead.checkpoint()
        cold_di = lead.residency.tiers()["warm"][0]
        lead.batch.demote(cold_di)
        lead.checkpoint()
        before = pk.obs.counter("residency.cold_flattens_total").total()
        fol = follower(pk, tmp, lead)
        out = [pk.obs.counter("residency.cold_flattens_total").total() - before, fol.resident.residency.tiers(),
               fol.resident.texts()]
        for r in range(2, 6):
            push(r % n_docs, r)
        lead.checkpoint()
        fol.catch_up()
        out.append(report(fol))
        out.append(fol.resident.texts())
        assert out[-1] == [crash.read_oracle(d, fam)[0] for d in docs] and fol.ckpts_applied >= 1
        return out
    finally:
        if fol is not None:
            fol.close()
        lead.close()


def test_tiered_follower_flattens_cold_docs_at_bootstrap(tmp_path):
    rec = both(_tiered, tmp_path)
    assert rec[0] == 1 and rec[1]["cold"] == []


# -- read-only serving ------------------------------------------------------------


def _read_only(pk, tmp):
    """NotLeader with the leader's id, the min_epoch gate (ReplicaLag,
    then served), a poll woken by a replicated commit, and promotion
    flipping the same sessions writable."""
    import threading

    fam = "text"
    d = make_doc(pk, fam)
    lead = pk.SyncServer(fam, 1, cid=crash.container_id(fam, d), pipeline=False, durable_dir=str(tmp / "L"),
                         **pk.dev(), **CAPS[fam])
    pk.repl.enable(lead.resident, "leader", clock=Clock())
    ls = lead.connect()
    ls.push(0, bytes(d.export_updates({}))).epoch(30)
    mark = d.oplog_vv()
    fol = follower(pk, tmp, lead.resident)
    try:
        fs = fol.sync.connect()
        c = pk.LoroDoc(peer=91)
        c.import_(fs.pull(0))
        out = [c.get_text("t").to_string()]
        crash.apply_edit(d, fam, 2)
        with pytest.raises(pk.errors.NotLeader) as info:
            fs.push(0, bytes(d.export_updates(mark)))
        out += [str(info.value), info.value.leader]
        ep = ls.push(0, bytes(d.export_updates(mark))).epoch(30)
        mark = d.oplog_vv()
        with pytest.raises(pk.errors.ReplicaLag) as info:
            fs.pull(0, min_epoch=ep, wait_s=0.05)
        out.append(str(info.value))
        got = {}
        th = threading.Thread(target=lambda: got.update(ev=fs.poll(timeout=10)))
        th.start()
        time.sleep(0.1)
        fol.catch_up()
        th.join(30)
        assert not th.is_alive()
        out.append(got["ev"])
        c.import_(fs.pull(0, min_epoch=ep))
        out.append(c.get_text("t").to_string())
        assert out[-1] == d.get_text("t").to_string()
        lead.close()
        srv = fol.promote("f1")
        assert srv is fol.resident and fol.promoted
        crash.apply_edit(d, fam, 3)
        out.append(fs.push(0, bytes(d.export_updates(mark))).epoch(30))
        c.import_(fol.sync.connect().pull(0))
        out += [c.get_text("t").to_string(), srv.durable_epoch == srv.epoch, report(fol)]
        assert out[-3] == d.get_text("t").to_string()
        return out, files(tmp / "F"), pk.repl.load_replication(str(tmp / "L"))
    finally:
        fol.close()
        lead.close()


def test_read_only_serving_and_promotion_match_jax(tmp_path):
    rec = both(_read_only, tmp_path)
    assert rec[0][2] == "leader" and rec[0][-2]


# -- fencing and the fault sites ---------------------------------------------------


def _fenced(pk, tmp):
    d, srv = leader(pk, tmp)
    mark = drive(srv, d, "text", 3)
    fol = follower(pk, tmp, srv)
    try:
        fol.catch_up()
        fol.promote("f1")
        sizes = {n: len(b) for n, b in files(tmp / "L" / "wal").items()}
        n0 = pk.obs.counter("repl.fenced_appends_total").get()
        with pytest.raises(pk.errors.FencedLeader) as info:
            drive(srv, d, "text", 1, start=4, mark=mark)
        fenced = pk.obs.counter("repl.fenced_appends_total").get() - n0
        assert {n: len(b) for n, b in files(tmp / "L" / "wal").items()} == sizes
        with pytest.raises(pk.errors.PersistError) as info2:
            drive(srv, d, "text", 1, start=5, mark=mark)
        return str(info.value), fenced, str(info2.value), pk.repl.load_replication(str(tmp / "L")), files(tmp / "F")
    finally:
        fol.close()
        srv.close()


def test_fenced_zombie_leader_fail_stops_typed(tmp_path):
    assert both(_fenced, tmp_path)[1] == 1


def _fault(pk, tmp, site):
    d, srv = leader(pk, tmp)
    mark = drive(srv, d, "text", 3)
    fol = follower(pk, tmp, srv)
    try:
        out = []
        if site == "repl_promote":
            pk.fi.inject("repl_promote", times=1)
            try:
                with pytest.raises(pk.fi.InjectedFault):
                    fol.promote("f1")
            finally:
                pk.fi.clear()
            out += [fol.promoted, pk.Manifest(str(tmp / "L")).leader()]
            new = fol.promote("f1")
            out += [fol.promoted, view(new, "text")]
            assert out[-1] == oracle(d, "text")
            return out, files(tmp / "F")
        drive(srv, d, "text", 3, start=4, mark=mark)
        n0 = pk.obs.counter("repl.torn_shipped_tails_total").get()
        if site == "torn":
            pk.fi.inject("repl_ship", action="bitflip", times=1)
            try:
                out.append(fol.catch_up()["applied_epoch"])
            finally:
                pk.fi.clear()
            out += [pk.obs.counter("repl.torn_shipped_tails_total").get() > n0, fol.torn_tails]
        else:
            pk.fi.inject(site, times=1)
            try:
                with pytest.raises(pk.fi.InjectedFault) as info:
                    fol.catch_up()
            finally:
                pk.fi.clear()
            out += [str(info.value), fol.applied_epoch, fol.resident.degraded]
        out.append(fol.catch_up()["applied_epoch"])
        out.append(view(fol.resident, "text"))
        assert out[-2] == srv.epoch and out[-1] == oracle(d, "text")
        return out, report(fol), files(tmp / "F")
    finally:
        fol.close()
        srv.close()


@pytest.mark.parametrize("site", ["repl_ship", "torn", "repl_apply", "repl_promote"])
def test_fault_sites_fail_only_what_jax_fails(tmp_path, site):
    """A mid-ship crash and an armed apply fault fail the pass and the
    next one resumes; a torn shipped tail truncates like a WAL reopen; a
    promote fault fires before the token bump and the retry starts
    clean."""
    rec = both(_fault, tmp_path, site)
    if site in ("repl_ship", "repl_apply"):
        assert rec[0][1] < rec[0][3] and rec[0][2] is False
    if site == "torn":
        assert rec[0][1] and rec[0][2] >= 1


def _armed_launch(pk, tmp):
    """An armed launch fault in the follower's replay: catch_up raises
    the supervisor's DeviceFailure in both packages, nothing applied, and
    a clean pass resumes."""
    d, srv = leader(pk, tmp)
    mark = drive(srv, d, "text", 2)
    fol = follower(pk, tmp, srv)
    try:
        drive(srv, d, "text", 2, start=3, mark=mark)
        pk.fi.inject("launch", exc_factory=lambda: pk.fi.InjectedFault("armed replay fault"), times=1)
        try:
            with pytest.raises(pk.errors.DeviceFailure) as info:
                fol.catch_up()
        finally:
            pk.fi.clear()
        assert getattr(info.value, "injected", True)  # the JAX type has no such field
        out = [info.value.label, fol.applied_epoch, fol.resident.degraded]
        out += [fol.catch_up()["applied_epoch"], view(fol.resident, "text")]
        assert out[-1] == oracle(d, "text")
        return out
    finally:
        fol.close()
        srv.close()


def test_armed_launch_fault_in_the_apply_matches_jax(tmp_path):
    rec = both(_armed_launch, tmp_path)
    assert rec[1] < rec[3] and rec[2] is False


# -- retention ------------------------------------------------------------------


def _retention(pk, tmp, stale):
    fam = "text"
    clk = Clock()
    d, srv = leader(pk, tmp, fam, clock=clk, stale_after=60 if stale else None)
    fol = None
    try:
        mark = drive(srv, d, fam, 2)
        fol = pk.Follower(str(tmp / "L"), str(tmp / "F"), leader=srv, clock=clk, **pk.dev(),
                          **({"stale_after": 60} if stale else {}))
        fol.catch_up()
        if stale:
            clk.t += 120
        r = 3
        for _ in range(4):
            mark = drive(srv, d, fam, 3, start=r, mark=mark)
            r += 3
            srv.checkpoint()
        log = srv._durable
        out = [log.wal.pruned_below, [s.index for s in log.wal.segments()]]
        if stale:
            assert log.wal.pruned_below > 2
            drive(srv, d, fam, 1, start=r, mark=mark)
            with pytest.raises(pk.errors.StaleFollower) as info:
                fol.catch_up()
            return out + [str(info.value)]
        assert log.wal.pruned_below <= 2
        out.append(fol.catch_up()["applied_epoch"])
        assert out[-1] == srv.epoch and view(fol.resident, fam) == oracle(d, fam)
        return out, report(fol), files(tmp / "F")
    finally:
        if fol is not None:
            fol.close()
        srv.close()


@pytest.mark.parametrize("stale", [False, True], ids=["pinned", "stale"])
def test_follower_acks_pin_pruning_and_stale_followers_fail_typed(tmp_path, stale):
    both(_retention, tmp_path, stale)


def _stray_segment(pk, tmp):
    fam = "text"
    d, srv = leader(pk, tmp, fam)
    fol = None
    try:
        mark = drive(srv, d, fam, 2)
        r = 3
        for _ in range(4):
            mark = drive(srv, d, fam, 3, start=r, mark=mark)
            r += 3
            srv.checkpoint()
        live = {s.index for s in srv._durable.wal.segments()}
        assert 0 not in live
        (tmp / "F" / "wal").mkdir(parents=True)
        (tmp / "F" / "wal" / pk.wal._seg_name(0)).touch()
        fol = follower(pk, tmp, srv)
        fol.catch_up()
        assert not (tmp / "F" / "wal" / pk.wal._seg_name(0)).exists()
        assert fol.applied_epoch == srv.epoch and view(fol.resident, fam) == oracle(d, fam)
        return report(fol), files(tmp / "F")
    finally:
        if fol is not None:
            fol.close()
        srv.close()


def test_bootstrap_survives_a_stray_empty_segment(tmp_path):
    both(_stray_segment, tmp_path)


def _inspect(pk, tmp):
    import io

    fam = "text"
    d, srv = leader(pk, tmp, fam)
    fol = None
    try:
        mark = drive(srv, d, fam, 2)
        fol = follower(pk, tmp, srv)
        fol.catch_up()
        drive(srv, d, fam, 2, start=3, mark=mark)
        out = io.StringIO()
        rc = pk.inspect.inspect_dir(str(tmp / "L"), out=out)
        text = out.getvalue()
        assert "follower follower: acked e2" in text and "pinned prune floor: e2" in text
        return rc, [ln for ln in text.splitlines() if "repl" in ln or "follower" in ln or "leader" in ln]
    finally:
        if fol is not None:
            fol.close()
        srv.close()


def test_inspect_reports_followers_like_jax(tmp_path):
    assert both(_inspect, tmp_path)[0] == 0


# -- the port only: real device failures, a killed leader, the card ------------


def _port_follower(tmp):
    d, srv = leader(PT, tmp)
    mark = drive(srv, d, "text", 2)
    return d, srv, mark, follower(PT, tmp, srv)


@pytest.mark.parametrize("make", [
    lambda: PT.errors.KernelLaunchError("replay launch failed: cudaError 700 (an illegal memory access)"),
    lambda: torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    lambda: torch.OutOfMemoryError("CUDA out of memory"),
], ids=["kernel_launch", "accelerator", "oom"])
def test_real_apply_error_reaches_catch_up_typed(tmp_path, monkeypatch, make):
    """A real device error in the follower's replayed round reaches
    catch_up() as DeviceFailure(injected=False): applied_epoch stays,
    the follower is not degraded, nothing is served from the host, and a
    clean pass applies the round."""
    d, srv, mark, fol = _port_follower(tmp_path)
    try:
        drive(srv, d, "text", 2, start=3, mark=mark)
        sync0 = fol.sync.epoch
        real = fol.resident._replay_round

        def fail(*a, **k):
            raise make()

        monkeypatch.setattr(fol.resident, "_replay_round", fail)
        with pytest.raises(PT.errors.DeviceFailure) as info:
            fol.catch_up()
        assert not info.value.injected and info.value.label == "server.recover.text"
        assert fol.applied_epoch == 2 and fol.rounds_applied == 0 and not fol.resident.degraded
        assert fol.sync.epoch == sync0 and fol.report()["applied_epoch"] == 2
        monkeypatch.setattr(fol.resident, "_replay_round", real)
        assert fol.catch_up()["applied_epoch"] == srv.epoch > 2
        assert view(fol.resident, "text") == oracle(d, "text")
    finally:
        fol.close()
        srv.close()


@pytest.mark.parametrize("make", [
    lambda: PT.errors.DeviceFailure("server.checkpoint", cause="CUDA error: an illegal memory access"),
    lambda: torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
], ids=["device_failure", "accelerator"])
def test_real_checkpoint_error_reaches_catch_up_typed(tmp_path, monkeypatch, make):
    """A failure in the follower's replicated checkpoint is not skipped
    as a degraded follower's: it reaches catch_up() as raised.  Only a
    degraded follower skips the boundary."""
    d, srv, mark, fol = _port_follower(tmp_path)
    try:
        mark = drive(srv, d, "text", 1, start=3, mark=mark)
        srv.checkpoint()

        def fail():
            raise make()

        real = fol.resident.checkpoint
        monkeypatch.setattr(fol.resident, "checkpoint", fail)
        with pytest.raises(type(make())):
            fol.catch_up()
        assert fol.ckpts_applied == 0 and not fol.resident.degraded
        # a degraded follower (an armed fault's degradation) skips the
        # boundary: its checkpoint raises ResilienceError
        monkeypatch.setattr(fol.resident, "checkpoint", real)
        monkeypatch.setattr(fol.resident, "_degraded", True)
        fol.catch_up()
        assert fol.ckpts_applied == 0 and fol.applied_epoch == srv.epoch
    finally:
        fol.close()
        srv.close()


def test_sigkilled_leader_promotes_with_no_acked_round_lost(tmp_path):
    """A group-commit port leader (tests/_torch_repl_crash_child.py, on
    the CPU) is killed with SIGKILL mid-run; a cold follower of its
    directory promotes with every round at or below the last acked
    durable watermark, and journals new rounds."""
    rounds = 12
    child = Path(__file__).resolve().parent / "_torch_repl_crash_child.py"
    ldir = str(tmp_path / "leader")
    proc = subprocess.Popen([sys.executable, str(child), ldir, str(rounds), "4"],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    progress = tmp_path / "progress"
    deadline = time.time() + 120
    lines = []
    try:
        while True:
            if progress.exists():
                lines = progress.read_text().splitlines()
                if lines and int(lines[-1].split()[2]) >= 6:
                    break
            if proc.poll() is not None:
                raise AssertionError("crash child exited early: " + proc.stderr.read().decode()[-2000:])
            assert time.time() < deadline, "crash child never progressed"
            time.sleep(0.05)
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(30)
        proc.stderr.close()
    acked = int(lines[-1].split()[2])
    fol = PT.Follower(ldir, str(tmp_path / "F"), leader=None, device="cpu")
    try:
        srv = fol.promote("survivor")
        assert srv.epoch >= acked
        assert srv.texts()[0] == rcrash.oracle_text(srv.epoch)
        d = rcrash.make_doc()
        for r in range(2, srv.epoch + 1):
            rcrash.edit(d, r)
        mark = d.oplog_vv()
        rcrash.edit(d, srv.epoch + 1)
        srv.ingest([PT.strip(bytes(d.export_updates(mark)))], d.get_text("t").id)
        assert srv.texts()[0] == d.get_text("t").to_string() and srv.durable_epoch == srv.epoch
    finally:
        fol.close()


def test_followers_need_a_card_or_cpu(tmp_path, monkeypatch):
    """Follower and ShardedFollower run on the card by default: without
    one they raise DeviceUnavailable before a file is shipped, and run
    when asked for the CPU."""
    d, srv = leader(PT, tmp_path)
    drive(srv, d, "text", 2)
    sdir = tmp_path / "S"
    sh = PT.Sharded("text", 2, shards=2, durable_dir=str(sdir), devices=CPU2, **CAPS["text"])
    sh.ingest([d.oplog.changes_in_causal_order(), None], d.get_text("t").id)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(PT.errors.DeviceUnavailable):
            PT.Follower(str(tmp_path / "L"), str(tmp_path / "F0"), leader=srv)
        with pytest.raises(PT.errors.DeviceUnavailable):
            PT.ShardedFollower(str(sdir), str(tmp_path / "SF0"), leader=sh)
        assert not (tmp_path / "F0").exists() and not (tmp_path / "SF0").exists()
        with PT.Follower(str(tmp_path / "L"), str(tmp_path / "F"), leader=srv, device="cpu") as fol:
            assert fol.resident.batch.device == torch.device("cpu") and fol.applied_epoch == 2
        with PT.ShardedFollower(str(sdir), str(tmp_path / "SF"), leader=sh, devices=CPU2) as sf:
            sf.catch_up()
            assert sf.texts() == sh.texts()
    finally:
        sh.close()
        srv.close()
