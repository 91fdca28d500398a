"""The port's sync front end (loro_tpu_torch.sync: SyncServer, sessions,
the fan-in, presence and the batched ReadBatcher) on the CPU against the
JAX package's, on the same seeded client edits.

Every scenario runs once through each package (`both`): the JAX
SyncServer on its default device, the port's on device="cpu" (the plain
kernels).  Clients are LoroDocs of the same package, edited by the same
seeded script (their bytes are equal, test_torch_doc.py holds that), so
both servers take the same pushes.  A scenario returns a record of what
its sessions saw; the two records must be equal exactly (tolerance:
none): the pulled bytes, the epochs, the reads (through
test_torch_doc.plain), the presence blobs and report(), which holds
counts only.  Left out, because they are wall-clock timings: the
per-stage milliseconds of `Session.last_pull` and of a push ticket's
`breakdown()` (their keys are compared).  Every pulled blob is also held
against the server oracle's own `ExportMode.Updates` export from the
session's frontier.

Thread timing is taken out of the records: where pushes race, the
fan-in's commit is held on a gate until every push of the round is
queued (one batch a round); where pulls race, the read batcher's
gather beat waits until every pull is queued (one window).

Port-only cases: a real device error in the selection or in the ingest
reaches the puller or the pushers as a typed DeviceFailure, never as
host bytes (the JAX package serves a window off the oracle on any
DeviceFailure; the port only on an armed fault), a strict lock witness
over concurrent pushes and pulls, and no CPU fallback without a card.
"""
import importlib
import random
import threading
import time
import types

import pytest
import torch

from test_torch_doc import plain


def _pkg(root: str):
    m = lambda n: importlib.import_module(f"{root}.{n}")  # noqa: E731
    doc = m("doc")
    return types.SimpleNamespace(
        name=root, LoroDoc=doc.LoroDoc, ExportMode=doc.ExportMode, strip=doc.strip_envelope,
        SyncServer=m("sync").SyncServer, ResidentServer=m("parallel.server").ResidentServer,
        fi=m("resilience.faultinject"), res=m("resilience"), errors=m("errors"),
        VV=m("core.version").VersionVector, obs=m("obs.metrics"), persist=m("persist"),
        Awareness=m("awareness").Awareness, EphemeralStore=m("awareness").EphemeralStore,
        presence=m("sync.presence"), lockwitness=m("analysis.lockwitness"),
        dev={} if root == "loro_tpu" else {"device": "cpu"},
    )


JX, PT = _pkg("loro_tpu"), _pkg("loro_tpu_torch")

FAMILIES = ("text", "list", "map", "tree", "movable", "counter")
CAPS = {
    "text": dict(capacity=1 << 12),
    "list": dict(capacity=1 << 12),
    "map": dict(slot_capacity=64),
    "tree": dict(move_capacity=1 << 10, node_capacity=128),
    "movable": dict(capacity=1 << 10, elem_capacity=128),
    "counter": dict(slot_capacity=16),
}
PRESENCE_T0 = 1_700_000_000.5  # the patched presence wall clock


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    """A sleepless supervisor a package, the presence wall clock patched
    in both packages, every armed fault cleared after."""
    for pk in (JX, PT):
        pk.res.set_supervisor(pk.res.DeviceSupervisor(sleep=lambda s: None))
        monkeypatch.setattr(pk.presence, "time", types.SimpleNamespace(time=lambda: PRESENCE_T0))
    yield
    for pk in (JX, PT):
        pk.fi.clear()
        pk.res.set_supervisor(None)


def both(scenario, *args):
    """Run `scenario(pkg, *args)` through the JAX package and the port;
    their records must be equal.  Returns the port's record."""
    rj = scenario(JX, *args)
    rp = scenario(PT, *args)
    assert rj == rp
    return rp


def server(pk, family, n_docs, base=None, **kw):
    caps = dict(CAPS[family])
    caps.update(kw)
    cid = cid_of(family, base) if base is not None else None
    return pk.SyncServer(family, n_docs, cid=cid, **pk.dev, **caps)


def resident(pk, family, n_docs, **kw):
    caps = dict(CAPS[family])
    caps.update(kw)
    return pk.ResidentServer(family, n_docs, **pk.dev, **caps)


# -- client docs ------------------------------------------------------------


def edit(d, rng, tag):
    """One editing burst over the six container kinds."""
    t = d.get_text("t")
    n = len(t)
    if n > 6 and rng.random() < 0.3:
        t.delete(rng.randrange(n - 2), 2)
    else:
        t.insert(rng.randint(0, n), rng.choice(["xy", "q ", tag[:2]]))
    if rng.random() < 0.3 and len(t) >= 2:
        t.mark(0, min(4, len(t)), "bold", True)
    lst = d.get_list("l")
    if len(lst) >= 2 and rng.random() < 0.3:
        lst.delete(rng.randrange(len(lst)), 1)
    else:
        lst.insert(rng.randint(0, len(lst)), f"l{tag}")
    d.get_map("m").set(rng.choice(["k", "j"]), rng.randrange(50))
    tr = d.get_tree("tr")
    nodes = tr.nodes()
    tr.create(rng.choice(nodes) if nodes and rng.random() < 0.5 else None)
    d.get_counter("c").increment(rng.randint(-5, 9))
    ml = d.get_movable_list("ml")
    n = len(ml)
    if n >= 2 and rng.random() < 0.4:
        ml.move(rng.randrange(n), rng.randrange(n))
    else:
        ml.insert(rng.randint(0, n), f"v{tag}")
    d.commit()


def seed_doc(pk, peer, i):
    d = pk.LoroDoc(peer=peer)
    d.get_text("t").insert(0, f"sync base {i}")
    d.get_list("l").push("p", "q")
    d.get_map("m").set("k", i)
    d.get_tree("tr").create()
    d.get_counter("c").increment(i + 1)
    d.get_movable_list("ml").push("a", "b")
    d.commit()
    return d


def cid_of(family, doc):
    return {
        "text": lambda: doc.get_text("t").id,
        "list": lambda: doc.get_list("l").id,
        "tree": lambda: doc.get_tree("tr").id,
        "movable": lambda: doc.get_movable_list("ml").id,
        "map": lambda: None,
        "counter": lambda: None,
    }[family]()


READS = {
    "text": ("texts", "richtexts"),
    "list": ("values",),
    "map": ("value_maps",),
    "tree": ("parent_maps", "children_maps"),
    "movable": ("value_lists",),
    "counter": ("value_maps",),
}


def reads(srv, family):
    return plain([getattr(srv, n)() for n in READS[family]])


def oracle_pull(pk, srv, session, di):
    """Pull `di` and hold the bytes against the oracle's Updates export
    from the session's frontier before the pull."""
    want = srv.oracle_doc(di).export(pk.ExportMode.Updates(session.frontier(di)))
    got = session.pull(di)
    assert got == want
    return got


class Gate:
    """Holds the fan-in's commit on its next batch until released, so
    every push queued meanwhile drains as ONE batch after it."""

    def __init__(self, srv):
        self.fanin = srv._fanin
        self.real = self.fanin._commit
        self.entered = threading.Event()
        self.go = threading.Event()
        self.fanin._commit = self._commit

    def _commit(self, items):
        if not self.go.is_set():
            self.entered.set()
            assert self.go.wait(60)
        self.real(items)

    def pushes(self, push_fns):
        """Submit the first push, wait for its batch to reach the gate,
        queue the rest, release; returns the tickets."""
        tks = [push_fns[0]()]
        assert self.entered.wait(60)
        tks += [f() for f in push_fns[1:]]
        self.go.set()
        self.fanin._commit = self.real
        return tks


def gather_until(srv, n):
    """Make the read batcher's gather beat wait until `n` pulls are
    queued, so they drain as one window."""
    rb = srv._readbatch

    def sleep(_s):
        deadline = time.monotonic() + 60
        while len(rb._q) < n and time.monotonic() < deadline:
            time.sleep(0.001)

    rb._sleep = sleep


# -- basics -------------------------------------------------------------------


def _round_trip(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a)
    try:
        s1, s2 = srv.connect(), srv.connect()
        tk = s1.push(0, a.export_updates({}))
        ep = tk.epoch(30)
        ev = s2.poll(timeout=5)
        c = pk.LoroDoc(peer=50)
        got = oracle_pull(pk, srv, s2, 0)
        c.import_(got)
        own = s1.pull(0)
        c2 = pk.LoroDoc(peer=51)
        c2.import_(own)
        assert c2.oplog_vv() == pk.VV()
        empty = s2.poll(timeout=0.05)
        stages = sorted(k for k in tk.breakdown() if k.endswith("_ms"))
        return (ep, ev, got, own, c.get_text("t").to_string(), srv.texts(), empty, stages,
                sorted(s2.last_pull), srv.report())
    finally:
        srv.close()


def test_push_pull_poll_round_trip():
    rec = both(_round_trip)
    assert rec[4] == "sync base 0" and rec[5] == ["sync base 0"]


def _closed_session(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a)
    try:
        s = srv.connect()
        s.close()
        out = []
        for call in (lambda: s.pull(0), lambda: s.push(0, a.export_updates({}))):
            with pytest.raises(pk.errors.SessionClosed) as info:
                call()
            out.append(str(info.value))
        return out
    finally:
        srv.close()


def test_closed_session_raises_typed():
    both(_closed_session)


def _ack_floors(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a)
    try:
        s1, s2 = srv.connect(), srv.connect()
        eps = [s1.push(0, a.export_updates({})).epoch(30)]
        vv = a.oplog_vv()
        a.get_text("t").delete(0, 7)
        a.commit()
        eps.append(s1.push(0, a.export_updates(vv)).epoch(30))
        srv.flush()
        before = srv.resident.compact()
        pulls = [oracle_pull(pk, srv, s1, 0), oracle_pull(pk, srv, s2, 0)]
        after = srv.resident.compact()
        return eps, before, pulls, after, srv.texts(), srv.report()
    finally:
        srv.close()


def test_push_ack_drives_compaction_floors():
    rec = both(_ack_floors)
    assert rec[1] == 0 and rec[3] > 0


def _bad_envelope(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a)
    try:
        s = srv.connect()
        blob = bytearray(a.export_updates({}))
        blob[len(blob) // 2] ^= 0x5A
        with pytest.raises(pk.errors.PushRejected):
            s.push(0, bytes(blob))
        ep = s.push(0, a.export_updates({})).epoch(30)
        return ep, srv.texts(), srv.report()
    finally:
        srv.close()


def test_bad_envelope_rejected_typed_at_push():
    both(_bad_envelope)


def _needs_host_fallback(pk):
    res = resident(pk, "counter", 1, host_fallback=False)
    with pytest.raises(pk.errors.SyncError) as info:
        pk.SyncServer.over(res)
    return str(info.value)


def test_requires_host_fallback_resident():
    both(_needs_host_fallback)


def _causality_gap(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a)
    try:
        s = srv.connect()
        s.push(0, a.export_updates({})).epoch(30)
        mark1 = a.oplog_vv()
        a.get_text("t").insert(0, "skipped ")
        a.commit()
        mark2 = a.oplog_vv()
        a.get_text("t").insert(0, "gap ")
        a.commit()
        tk = s.push(0, a.export_updates(mark2))
        with pytest.raises(pk.errors.PushRejected) as info:
            tk.epoch(30)
        mid = (srv.texts(), srv.oracle_doc(0).get_text("t").to_string())
        ep = s.push(0, a.export_updates(mark1)).epoch(30)
        return str(info.value), mid, ep, srv.texts(), srv.oracle_doc(0).get_text("t").to_string()
    finally:
        srv.close()


def test_causality_gap_push_rejected_typed():
    rec = both(_causality_gap)
    assert rec[1] == (["sync base 0"], "sync base 0") and rec[3] == [rec[4]]


def _bounded_pull(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a)
    try:
        w, r = srv.connect(), srv.connect()
        w.push(0, a.export_updates({})).epoch(30)
        stable_f = srv.oracle_doc(0).oplog_frontiers()
        vv = a.oplog_vv()
        a.get_text("t").delete(0, 7)
        a.commit()
        w.push(0, a.export_updates(vv)).epoch(30)
        w.pull(0)
        c = pk.LoroDoc(peer=90)
        bounded = r.pull(0, to_frontiers=stable_f)
        c.import_(bounded)
        mid = (c.get_text("t").to_string(), srv.resident.compact(), r.dirty_docs())
        c.import_(oracle_pull(pk, srv, r, 0))
        return bounded, mid, c.get_text("t").to_string(), srv.resident.compact(), srv.report()
    finally:
        srv.close()


def test_bounded_pull_does_not_ack():
    rec = both(_bounded_pull)
    assert rec[1][:2] == ("sync base 0", 0) and rec[1][2] and rec[3] > 0


def _flush_reads(pk):
    docs = [seed_doc(pk, 2 * i + 1, i) for i in range(2)]
    srv = server(pk, "map", 2)
    try:
        s = srv.connect()
        marks = [{} for _ in docs]
        tks = []
        for r in range(3):
            for i, d in enumerate(docs):
                d.get_map("m").set("k", 10 * r + i)
                d.commit()
                tks.append(s.push(i, d.export_updates(marks[i])))
                marks[i] = d.oplog_vv()
        srv.flush()
        assert all(tk.done for tk in tks)
        got = srv.root_value_maps("m")
        assert got == [d.get_map("m").get_value() for d in docs]
        return plain(got)
    finally:
        srv.close()


def test_read_after_flush_sees_all_pushes():
    both(_flush_reads)


# -- the six families: fan-in against serial ingest, pulls against the oracle --


def _family_sync(pk, family, pipeline):
    """Two writers a doc and a reader a doc over 2 docs, 3 epochs: every
    epoch's pushes race through the fan-in as one gated batch, then
    every session pulls every doc it follows (held against the oracle).
    Then the same pushes through a ResidentServer one at a time."""
    rng = random.Random(sum(map(ord, family)) * 7 + pipeline)
    n_docs, writers, epochs = 2, 2, 3
    clients = []
    for i in range(n_docs):
        base = seed_doc(pk, 100 + 10 * i, i)
        reps = [base]
        for w in range(1, writers):
            r = pk.LoroDoc(peer=100 + 10 * i + w)
            r.import_(base.export_snapshot())
            reps.append(r)
        clients.append(reps)
    cid = cid_of(family, clients[0][0])
    srv = pk.SyncServer(family, n_docs, cid=cid, pipeline=pipeline, **pk.dev, **CAPS[family])
    serial = resident(pk, family, n_docs)
    pushed, pulled, eps_all = [], [], []
    try:
        sess = [srv.connect() for _ in range(writers)]
        readers = [srv.connect() for _ in range(n_docs)]
        marks = [[None] * writers for _ in range(n_docs)]
        for i in range(n_docs):
            pl = clients[i][0].export_updates({})
            eps_all.append(sess[0].push(i, pl).epoch(60))
            pushed.append((i, pl))
            for w in range(writers):
                marks[i][w] = clients[i][w].oplog_vv()
                if w:
                    sess[w]._vv[i] = clients[i][w].oplog_vv()
        for e in range(epochs):
            fns = []
            for w in range(writers):
                for i in range(n_docs):
                    d = clients[i][w]
                    edit(d, rng, f"{e}{w}")
                    pl = d.export_updates(marks[i][w])
                    marks[i][w] = d.oplog_vv()
                    fns.append(lambda w=w, i=i, pl=pl: sess[w].push(i, pl))
                    pushed.append((i, pl))
            eps_all.append([tk.epoch(60) for tk in Gate(srv).pushes(fns)])
            for w in range(writers):
                for i in range(n_docs):
                    delta = oracle_pull(pk, srv, sess[w], i)
                    pulled.append(delta)
                    clients[i][w].import_(delta)
                    marks[i][w] = clients[i][w].oplog_vv()
            for i, r in enumerate(readers):
                pulled.append(oracle_pull(pk, srv, r, i))
            pulled.append(oracle_pull(pk, srv, sess[0], 0))  # the empty delta
            for i in range(n_docs):
                v0 = plain(clients[i][0].get_deep_value())
                assert all(plain(clients[i][w].get_deep_value()) == v0 for w in range(1, writers))
        srv.flush()
        for di, pl in pushed:
            ups = [None] * n_docs
            ups[di] = pk.strip(pl)
            serial.ingest(ups, cid)
        got = reads(srv, family)
        assert got == reads(serial, family)
        for i in range(n_docs):
            assert plain(srv.oracle_doc(i).get_deep_value()) == plain(clients[i][0].get_deep_value())
        rep = srv.report()
        assert rep["readbatch"]["degraded_windows"] == 0
        assert 0 < rep["readbatch"]["launches"] <= rep["readbatch"]["windows"]
        return eps_all, pulled, got, rep, srv.epoch
    finally:
        srv.close()


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipeline", "coalesced"])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_sync_matches_jax_and_serial_ingest(family, pipeline):
    both(_family_sync, family, pipeline)


# -- backpressure and faults --------------------------------------------------


def _backpressure(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a, max_queue=4, pipeline=False)
    try:
        s = srv.connect()
        mark = {}
        fns = []
        for r in range(12):
            a.get_text("t").insert(0, f"r{r} ")
            a.commit()
            pl = a.export_updates(mark)
            fns.append(lambda pl=pl: s.push(0, pl))
            mark = a.oplog_vv()
        gate = Gate(srv)
        tks = [fns[0]()]
        assert gate.entered.wait(60)
        tks += [f() for f in fns[1:5]]  # fills the bound of 4
        late = []
        th = threading.Thread(target=lambda: late.extend(f() for f in fns[5:]))
        th.start()
        deadline = time.monotonic() + 60
        while srv._fanin.report()["backpressure_waits"] < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        gate.go.set()
        gate.fanin._commit = gate.real
        th.join(60)
        eps = [t.epoch(60) for t in tks + late]
        assert len(eps) == 12 and eps == sorted(eps)
        rep = srv.report()
        assert rep["pushes"] == 12 and rep["max_queue_seen"] <= rep["queue_bound"] == 4
        assert rep["backpressure_waits"] >= 1
        assert srv.texts()[0] == a.get_text("t").to_string()
        return srv.texts(), eps[-1], rep["pushes"], rep["queue_bound"], rep["max_queue_seen"]
    finally:
        srv.close()


def test_bounded_queue_no_drops():
    both(_backpressure)


def _push_raise(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a)
    try:
        s = srv.connect()
        pk.fi.inject("sync_push", exc=pk.fi.InjectedFault("injected"), times=1)
        with pytest.raises(pk.fi.InjectedFault):
            s.push(0, a.export_updates({}))
        ep = s.push(0, a.export_updates({})).epoch(30)
        return ep, srv.texts(), srv.report()
    finally:
        pk.fi.clear()
        srv.close()


def test_sync_push_raise_surfaces_then_recovers():
    both(_push_raise)


def _push_mangle(pk):
    docs = [seed_doc(pk, 1, 0), seed_doc(pk, 3, 1)]
    srv = server(pk, "text", 2, docs[0])
    try:
        s1, s2 = srv.connect(), srv.connect()
        pk.fi.inject("sync_push", action="bitflip", docs=[0], times=1)
        with pytest.raises(pk.errors.PushRejected) as info:
            s1.push(0, docs[0].export_updates({}))
        e1 = s2.push(1, docs[1].export_updates({})).epoch(30)
        mid = srv.texts()
        e0 = s1.push(0, docs[0].export_updates({})).epoch(30)
        return str(info.value), e1, mid, e0, srv.texts(), srv.report()
    finally:
        pk.fi.clear()
        srv.close()


def test_sync_push_mangle_rejects_only_that_push():
    both(_push_mangle)


def _pull_raise(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a)
    try:
        s = srv.connect()
        s.push(0, a.export_updates({})).epoch(30)
        pk.fi.inject("sync_pull", exc=pk.fi.InjectedFault("pull down"), times=1)
        with pytest.raises(pk.fi.InjectedFault):
            s.pull(0)
        reader = srv.connect()
        got = oracle_pull(pk, srv, reader, 0)
        again = s.pull(0)  # healthy again
        return got, again, srv.report()
    finally:
        pk.fi.clear()
        srv.close()


def test_sync_pull_raise_typed():
    both(_pull_raise)


def _armed_ingest_fault(pk):
    """An ARMED device fault in the resident ingest degrades the epoch
    to the host mirror in both packages; sessions keep converging."""
    a = seed_doc(pk, 1, 0)
    cid = cid_of("text", a)
    res = resident(pk, "text", 1)
    srv = pk.SyncServer.over(res, cid=cid, pipeline=False)
    try:
        s = srv.connect()
        e1 = s.push(0, a.export_updates({})).epoch(30)
        pk.fi.inject("launch", exc=RuntimeError("INTERNAL: injected"), times=1)
        vv = a.oplog_vv()
        a.get_text("t").insert(0, "degraded ")
        a.commit()
        e2 = s.push(0, a.export_updates(vv)).epoch(30)
        assert res.degraded
        reader = srv.connect()
        got = oracle_pull(pk, srv, reader, 0)
        return e1, e2, res.degraded, srv.texts(), got
    finally:
        pk.fi.clear()
        srv.close()


def test_armed_device_fault_degrades_transparently():
    rec = both(_armed_ingest_fault)
    assert rec[2] and rec[3] == ["degraded sync base 0"]


# -- first sync, durability ---------------------------------------------------


def _first_sync(pk, tmp):
    a = seed_doc(pk, 1, 0)
    ddir = str(tmp / pk.name)
    srv = server(pk, "text", 1, a, durable_dir=ddir)
    s = srv.connect()
    mark = {}
    for r in range(3):
        a.get_text("t").insert(0, f"r{r} ")
        a.commit()
        s.push(0, a.export_updates(mark)).epoch(60)
        mark = a.oplog_vv()
    srv.flush()
    srv.resident.checkpoint()
    want = srv.texts()[0]
    srv.close()
    rec = pk.persist.recover_server(ddir, **pk.dev)
    back = pk.SyncServer.over(rec)
    try:
        assert back.oracle_doc(0).is_shallow()
        n0 = pk.obs.counter("sync.first_sync_snapshots_total").get(family="text")
        writer, reader = back.connect(), back.connect()
        c = pk.LoroDoc(peer=70)
        snap = reader.pull(0)
        c.import_(snap)
        assert c.get_text("t").to_string() == want
        n1 = pk.obs.counter("sync.first_sync_snapshots_total").get(family="text") - n0
        vv = a.oplog_vv()
        a.get_text("t").insert(0, "tail ")
        a.commit()
        writer.push(0, a.export_updates(vv)).epoch(60)
        c.import_(oracle_pull(pk, back, reader, 0))
        stale = back.connect()
        stale._vv[0] = pk.VV({1: 1})
        with pytest.raises(pk.errors.StaleFrontier):
            stale.pull(0)
        return snap, n1, c.get_text("t").to_string(), a.get_text("t").to_string()
    finally:
        back.close()
        rec.close()


def test_shallow_oracle_first_pull_is_snapshot(tmp_path):
    rec = both(_first_sync, tmp_path)
    assert rec[1] == 1 and rec[2] == rec[3]


def _group_commit(pk, tmp):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a, durable_dir=str(tmp / pk.name), durable_fsync="group", fsync_window=16)
    try:
        s = srv.connect()
        mark = {}
        out = []
        for r in range(5):
            a.get_text("t").insert(0, f"r{r} ")
            a.commit()
            ep = s.push(0, a.export_updates(mark)).epoch(60)
            mark = a.oplog_vv()
            assert srv.resident.durable_epoch >= ep
            out.append(ep)
        return out
    finally:
        srv.close()


def test_group_commit_watermark_covers_resolved_tickets(tmp_path):
    both(_group_commit, tmp_path)


def _reopen(pk, tmp):
    a = seed_doc(pk, 1, 0)
    ddir = str(tmp / pk.name)
    srv = server(pk, "text", 1, a, durable_dir=ddir)
    s = srv.connect()
    mark = {}
    for r in range(3):
        a.get_text("t").insert(0, f"pre{r} ")
        a.commit()
        s.push(0, a.export_updates(mark)).epoch(60)
        mark = a.oplog_vv()
    r0 = srv.connect()
    c = pk.LoroDoc(peer=80)
    first = oracle_pull(pk, srv, r0, 0)
    c.import_(first)
    client_vv = r0.frontier(0)
    srv.flush()
    srv.resident.checkpoint()
    srv.close()
    rec = pk.persist.recover_server(ddir, **pk.dev)
    back = pk.SyncServer.over(rec)
    try:
        writer, s2 = back.connect(), back.connect()
        s2._vv[0] = client_vv
        for r in range(2):
            vv = a.oplog_vv()
            a.get_text("t").insert(0, f"post{r} ")
            a.commit()
            writer.push(0, a.export_updates(vv)).epoch(60)
        delta = oracle_pull(pk, back, s2, 0)
        c.import_(delta)
        assert c.get_text("t").to_string() == a.get_text("t").to_string() == back.texts()[0]
        return first, delta, back.texts(), back.epoch
    finally:
        back.close()
        rec.close()


def test_mid_run_reopen_convergence(tmp_path):
    both(_reopen, tmp_path)


# -- presence -----------------------------------------------------------------


def _presence_fan_out(pk):
    srv = server(pk, "counter", 1)
    try:
        s1, s2, s3 = (srv.connect() for _ in range(3))
        s1.set_presence({"name": "a", "cursor": 1})
        s2.set_presence({"name": "b"})
        ev3 = s3.poll(timeout=5)
        aw = pk.Awareness(peer=999)
        for b in ev3["presence"]:
            aw.apply(b)
        states = aw.get_all_states()
        assert states[s1.peer] == {"name": "a", "cursor": 1} and states[s2.peer] == {"name": "b"}
        ev1 = s1.poll(timeout=1)
        assert len(ev1["presence"]) == 1
        return ev3, ev1, plain(srv.presence.states())
    finally:
        srv.close()


def test_presence_fan_out_and_view():
    both(_presence_fan_out)


def _ephemeral_round_trip(pk):
    srv = server(pk, "counter", 1)
    try:
        s1, s2 = srv.connect(), srv.connect()
        st = pk.EphemeralStore(clock=lambda: PRESENCE_T0)
        st.set("cursor", [3, 7])
        blob = st.encode()
        s1.broadcast_presence(blob)
        ev = s2.poll(timeout=5)
        dst = pk.EphemeralStore(clock=lambda: PRESENCE_T0)
        for b in ev["presence"]:
            dst.apply(b)
        assert dst.get("cursor") == [3, 7]
        with pytest.raises(ValueError):
            s1.broadcast_presence(b"XXXXjunk")
        return blob, ev, plain(srv.presence.ephemeral_states())
    finally:
        srv.close()


def test_ephemeral_broadcast_round_trip():
    both(_ephemeral_round_trip)


def _ttl_expiry(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a, session_ttl=30.0)
    try:
        idle, live = srv.connect(), srv.connect()
        idle.set_presence({"name": "ghost"})
        ev0 = live.poll(timeout=5)
        live.push(0, a.export_updates({})).epoch(30)
        vv = a.oplog_vv()
        a.get_text("t").delete(0, 5)
        a.commit()
        live.push(0, a.export_updates(vv)).epoch(30)
        live.pull(0)
        pinned = srv.resident.compact()
        idle.last_seen -= 10_000.0
        expired = srv.expire_sessions()
        freed = srv.resident.compact()
        ev = live.poll(timeout=5)
        view = pk.Awareness(peer=999)
        for b in ev0["presence"] + ev["presence"]:
            view.apply(b)
        with pytest.raises(pk.errors.SessionClosed):
            idle.pull(0)
        return ev0, pinned, expired, idle.closed, freed, ev, plain(view.get_all_states())
    finally:
        srv.close()


def test_ttl_expiry_drops_departed_session():
    rec = both(_ttl_expiry)
    assert rec[1] == 0 and rec[2] == ["s1"] and rec[3] and rec[4] > 0
    assert rec[6] == plain({1: None})  # the departure blob: the idle peer's state is gone


def _blocked_poller(pk):
    a = seed_doc(pk, 1, 0)
    srv = server(pk, "text", 1, a, session_ttl=30.0)
    try:
        s = srv.connect()
        s.last_seen -= 10_000.0
        s._polling = 1
        first = srv.expire_sessions()
        s._polling = 0
        return first, srv.expire_sessions(), s.closed
    finally:
        srv.close()


def test_blocked_poller_is_not_ttl_idle():
    assert both(_blocked_poller) == ([], ["s1"], True)


def _presence_no_oplog(pk):
    srv = server(pk, "counter", 1)
    try:
        s1, s2 = srv.connect(), srv.connect()
        vv0, ep0 = srv.oracle_doc(0).oplog_vv(), srv.epoch
        for i in range(5):
            s1.set_presence({"i": i})
        ev = s2.poll(timeout=2)
        assert srv.oracle_doc(0).oplog_vv() == vv0 and srv.epoch == ep0
        return ev
    finally:
        srv.close()


def test_presence_never_touches_the_oplog():
    both(_presence_no_oplog)


# -- the read plane -----------------------------------------------------------


def _straddle(pk):
    d = pk.LoroDoc(peer=7)
    d.get_text("t").insert(0, "0123456789")
    d.commit()
    srv = pk.SyncServer("text", 1, cid=d.get_text("t").id, capacity=1 << 10, **pk.dev)
    try:
        s = srv.connect()
        s.push(0, d.export_updates({})).epoch(60)
        r = srv.connect()
        r._vv[0] = pk.VV({7: 3})
        got = oracle_pull(pk, srv, r, 0)
        c = pk.LoroDoc(peer=9)
        c.import_(d.export(pk.ExportMode.UpdatesInRange(pk.VV(), pk.VV({7: 3}))))
        c.import_(got)
        assert c.get_text("t").to_string() == "0123456789"
        return got, srv.report()["readbatch"]
    finally:
        srv.close()


def test_mid_change_frontier_trims_straddle():
    assert both(_straddle)[1]["pulls"] == 1


def _tombstones(pk):
    rng = random.Random(5)
    d = pk.LoroDoc(peer=11)
    t = d.get_text("t")
    t.insert(0, "x" * 64)
    d.commit()
    srv = pk.SyncServer("text", 1, cid=t.id, capacity=1 << 12, **pk.dev)
    try:
        s = srv.connect()
        s.push(0, d.export_updates({})).epoch(60)
        mark = d.oplog_vv()
        s._vv[0] = d.oplog_vv()
        r = srv.connect()
        out = []
        for _ in range(6):
            for _ in range(10):
                n = len(t)
                if n > 2:
                    t.delete(rng.randrange(n - 1), 1)
                else:
                    t.insert(0, "ab")
            d.commit()
            s.push(0, d.export_updates(mark)).epoch(60)
            mark = d.oplog_vv()
            out.append(oracle_pull(pk, srv, r, 0))
        return out, srv.report()
    finally:
        srv.close()


def test_tombstone_heavy():
    both(_tombstones)


def _coalesce_window(pk):
    base = seed_doc(pk, 50, 0)
    srv = server(pk, "text", 1, base)
    try:
        w = srv.connect()
        w.push(0, base.export_updates({})).epoch(60)
        readers = [srv.connect() for _ in range(16)]
        want = srv.oracle_doc(0).export(pk.ExportMode.Updates(pk.VV()))
        gather_until(srv, 16)
        outs = [None] * 16
        ts = [threading.Thread(target=lambda k=k: outs.__setitem__(k, readers[k].pull(0))) for k in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert all(o == want for o in outs)
        return want, srv.report()["readbatch"]
    finally:
        srv.close()


def test_concurrent_pulls_coalesce_one_launch():
    """One window, one selection launch and one frame for 16 pulls."""
    rep = both(_coalesce_window)[1]
    assert rep["pulls"] == 16 and rep["windows"] == 1 and rep["launches"] == 1
    assert rep["frames"] == 1 and rep["frames_shared"] == 15 and rep["max_window"] == 16


def _bounded_stays_oracle(pk):
    base = seed_doc(pk, 51, 0)
    srv = server(pk, "text", 1, base)
    try:
        s = srv.connect()
        s.push(0, base.export_updates({})).epoch(60)
        r = srv.connect()
        bounded = r.pull(0, to_frontiers=srv.oracle_doc(0).oplog_frontiers())
        n0 = srv.report()["readbatch"]["pulls"]
        r.pull(0)
        return bounded, n0, srv.report()["readbatch"]["pulls"]
    finally:
        srv.close()


def test_bounded_pull_stays_oracle():
    assert both(_bounded_stays_oracle)[1:] == (0, 1)


def _below_floor(pk):
    base = seed_doc(pk, 52, 0)
    res = resident(pk, "text", 1)
    res.ingest([pk.strip(bytes(base.export_updates({})))], base.get_text("t").id)
    srv = pk.SyncServer.over(res, cid=base.get_text("t").id)
    try:
        r = srv.connect()
        got = oracle_pull(pk, srv, r, 0)
        n0 = srv.report()["readbatch"]["pulls"]
        d = pk.LoroDoc(peer=77)
        d.import_(got)
        mark = d.oplog_vv()
        d.get_text("t").insert(0, "more")
        d.commit()
        r.push(0, d.export_updates(mark)).epoch(60)
        delta = oracle_pull(pk, srv, r, 0)
        return got, n0, delta, srv.report()["readbatch"]["pulls"]
    finally:
        srv.close()


def test_below_floor_routes_oracle_then_device():
    rec = both(_below_floor)
    assert rec[1] == 0 and rec[3] == 1


def _warm(pk):
    base = seed_doc(pk, 53, 0)
    srv = server(pk, "text", 1, base)
    try:
        w = srv.connect()
        w.push(0, base.export_updates({})).epoch(60)
        done = srv.warm_read_plane(64)
        rep0 = srv.report()["readbatch"]
        r = srv.connect()
        got = oracle_pull(pk, srv, r, 0)
        wide = srv.warm_read_plane(8, max_peers=8)
        off = server(pk, "text", 1, base, read_batch=False)
        disabled = off.warm_read_plane(64)
        off.close()
        return done, rep0, got, wide, disabled, srv.report()["readbatch"]
    finally:
        srv.close()
        assert srv.warm_read_plane(64) == 0  # closed


def test_warm_read_plane_ladder():
    rec = both(_warm)
    assert rec[0] == 5 and rec[1]["launches"] == 0 and rec[1]["windows"] == 0 and rec[4] == 0


def _tiered(pk):
    n_docs, hot = 4, 2
    base = [seed_doc(pk, 60 + i, i) for i in range(n_docs)]
    srv = pk.SyncServer("text", n_docs, cid=base[0].get_text("t").id, capacity=1 << 10, hot_slots=hot, **pk.dev)
    try:
        for i in range(n_docs):
            srv.connect().push(i, base[i].export_updates({})).epoch(60)
        srv.flush()
        mgr = srv.resident.residency
        warm0 = mgr.tiers()["warm"]
        assert warm0
        rep0 = mgr.report()
        pulls = [oracle_pull(pk, srv, srv.connect(), di) for di in range(n_docs)]
        rep1 = mgr.report()
        assert mgr.tiers()["warm"] == warm0
        for k in ("promotions", "misses", "evictions", "cold_revives"):
            assert rep1[k] == rep0[k], k
        assert srv.warm_read_plane(16) > 0 and mgr.report() == rep1
        return sorted(warm0), pulls, srv.report()["readbatch"]
    finally:
        srv.close()


def test_tiered_warm_docs_pull_without_revive():
    both(_tiered)


def _abandoned_ticket(pk):
    base = seed_doc(pk, 95, 0)
    srv = server(pk, "text", 1, base)
    try:
        s = srv.connect()
        s.push(0, base.export_updates({})).epoch(60)
        tk = srv._readbatch.submit(0, pk.VV())  # never driven
        t0 = time.perf_counter()
    finally:
        srv.close()
    assert time.perf_counter() - t0 < 10.0
    data, vv, ep = tk.result(timeout=1.0)
    return data, plain(vv), ep


def test_close_drains_abandoned_ticket():
    both(_abandoned_ticket)


def _read_batch_fault(pk):
    base = seed_doc(pk, 70, 0)
    srv = server(pk, "text", 1, base)
    try:
        w = srv.connect()
        w.push(0, base.export_updates({})).epoch(60)
        r = srv.connect()
        pk.fi.inject("read_batch", exc_factory=lambda: pk.fi.InjectedFault("fatal read window"), times=1)
        try:
            got = oracle_pull(pk, srv, r, 0)
        finally:
            pk.fi.clear()
        rep0 = srv.report()["readbatch"]
        again = oracle_pull(pk, srv, srv.connect(), 0)
        return got, rep0, again, srv.report()["readbatch"], r.last_pull["path"]
    finally:
        srv.close()


def test_read_batch_fault_degrades_window_only():
    rec = both(_read_batch_fault)
    assert rec[1]["degraded_windows"] == rec[1]["degraded_pulls"] == 1 and rec[1]["launches"] == 0
    assert rec[3]["launches"] == 1 and rec[3]["degraded_windows"] == 1 and rec[4] == "oracle_degraded"


def _export_launch_fault(pk, transient):
    base = seed_doc(pk, 71, 0)
    srv = server(pk, "text", 1, base)
    try:
        w = srv.connect()
        w.push(0, base.export_updates({})).epoch(60)
        r = srv.connect()
        if transient:
            pk.fi.inject("export_launch", times=1)  # UNAVAILABLE: retried by the supervisor
        else:
            pk.fi.inject("export_launch", exc_factory=lambda: pk.fi.InjectedFault("fatal export launch"), times=1)
        try:
            got = oracle_pull(pk, srv, r, 0)
        finally:
            pk.fi.clear()
        return got, srv.report()["readbatch"], r.last_pull["path"]
    finally:
        srv.close()


@pytest.mark.parametrize("transient", [False, True], ids=["fatal", "transient"])
def test_export_launch_fault(transient):
    """A fatal armed fault degrades its window; a transient one retries
    through the supervisor and the window launches."""
    got, rep, path = both(_export_launch_fault, transient)
    if transient:
        assert rep["degraded_windows"] == 0 and rep["launches"] == 1 and path == "device"
    else:
        assert rep["degraded_windows"] == 1 and path == "oracle_degraded"


# -- the port only: real device failures, the lock witness, the card ----------


def _window_errors():
    return PT.obs.counter("readbatch.window_errors_total").get(family="text")


@pytest.mark.parametrize("make", [
    lambda: PT.errors.KernelLaunchError("export select launch failed: cudaError 700 (an illegal memory access)"),
    lambda: torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
], ids=["kernel_launch", "accelerator"])
def test_real_select_error_reaches_the_puller_typed(monkeypatch, make):
    """A real device error raised by the selection inside the batch's
    export_select reaches the puller as DeviceFailure (injected False):
    no degraded window, no host bytes, one window error; the next window
    serves again."""
    base = seed_doc(PT, 70, 0)
    srv = server(PT, "text", 1, base)
    try:
        srv.connect().push(0, base.export_updates({})).epoch(60)
        r = srv.connect()
        index = srv._readbatch.plane.index
        real = index.select

        def fail(requests):
            raise make()

        monkeypatch.setattr(index, "select", fail)
        e0 = _window_errors()
        with pytest.raises(PT.errors.DeviceFailure) as info:
            r.pull(0)
        assert not info.value.injected
        rep = srv.report()["readbatch"]
        assert rep["degraded_windows"] == 0 and rep["degraded_pulls"] == 0
        assert _window_errors() == e0 + 1
        assert r.frontier(0) == PT.VV()  # nothing was served
        monkeypatch.setattr(index, "select", real)
        assert oracle_pull(PT, srv, r, 0)
    finally:
        srv.close()


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipeline", "coalesced"])
def test_real_ingest_error_reaches_every_pusher_typed(monkeypatch, pipeline):
    """A real device error in the resident ingest fails every ticket of
    its batch with DeviceFailure (injected False), the resident not
    degraded; the fan-in then refuses pushes, as in the JAX package."""
    docs = [seed_doc(PT, 1 + 2 * i, i) for i in range(2)]
    srv = server(PT, "text", 2, docs[0], pipeline=pipeline)
    s = srv.connect()
    s.push(0, docs[0].export_updates({})).epoch(60)

    def fail(*a, **k):
        raise PT.errors.KernelLaunchError("append launch failed: cudaError 700 (an illegal memory access)")

    # the device launch of each path: the pipeline's group commit, or the
    # serial append of a one-round batch (both docs share one round)
    monkeypatch.setattr(srv.resident.batch, "commit_detached" if pipeline else "append_payloads", fail)
    vv = docs[0].oplog_vv()
    docs[0].get_text("t").insert(0, "lost ")
    docs[0].commit()
    fns = [lambda: s.push(0, docs[0].export_updates(vv)), lambda: s.push(1, docs[1].export_updates({}))]
    tks = Gate(srv).pushes(fns)
    for tk in tks:
        with pytest.raises(PT.errors.DeviceFailure) as info:
            tk.epoch(60)
        assert not info.value.injected
    assert not srv.resident.degraded
    assert srv.oracle_doc(1).get_text("t").to_string() == ""  # nothing applied
    with pytest.raises(RuntimeError):
        s.push(1, docs[1].export_updates({}))
    with pytest.raises(RuntimeError):
        srv.close()


def test_strict_lock_witness_sees_only_declared_edges():
    """Concurrent pushers and pullers under a strict lock witness: every
    acquisition follows the declared order (a violation raises at the
    acquisition), and the read plane's edges are the declared ones."""
    lw = PT.lockwitness.witness()
    lw.reset()
    lw.enable(strict=True)
    errors = []
    try:
        docs = [seed_doc(PT, 90 + i, i) for i in range(2)]
        srv = server(PT, "text", 2, docs[0])
        try:
            s = srv.connect()
            for di in range(2):
                s.push(di, docs[di].export_updates({})).epoch(60)
            readers = [srv.connect() for _ in range(8)]

            def push(di):
                try:
                    vv = docs[di].oplog_vv()
                    docs[di].get_text("t").insert(0, f"w{di} ")
                    docs[di].commit()
                    s.push(di, docs[di].export_updates(vv)).epoch(60)
                except BaseException as e:  # noqa: BLE001 — collected for the assert
                    errors.append(e)

            def pull(k):
                try:
                    readers[k].pull(k % 2)
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

            ths = [threading.Thread(target=push, args=(di,)) for di in range(2)]
            ths += [threading.Thread(target=pull, args=(k,)) for k in range(8)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(60)
            srv.compact()
        finally:
            srv.close()
    finally:
        lw.disable()
    assert errors == []
    edges = lw.edges()
    assert ("sync.server", "sync.readplane") in edges
    assert ("sync.readplane", "fleet.dev") in edges
    assert lw.check_declared() == [] and lw.violations() == []
    lw.assert_acyclic()
    lw.reset()


def test_sync_server_needs_a_card_or_cpu(monkeypatch):
    """SyncServer runs on the card by default: without one it raises
    DeviceUnavailable and builds nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PT.errors.DeviceUnavailable):
        PT.SyncServer("counter", 1)
    srv = PT.SyncServer("counter", 1, device="cpu")
    try:
        assert srv.resident.batch.device == torch.device("cpu")
        assert srv._readbatch.plane.index.device == torch.device("cpu")
    finally:
        srv.close()
