"""The port's PipelinedIngest (loro_tpu_torch.parallel.pipeline) on the
CPU against the JAX package's, and against serial ingest.

Inputs: test_torch_server's seeded tracegen.loro_fleet rounds (idle docs
included) and live LoroDoc change lists.  Both packages' servers run
their pipelines over the same rounds (JAX on a one-device mesh, the
port on device="cpu"); every comparison is exact: per-round epochs in
submit order, reads, checkpoint bytes, the durable watermark, and the
counted block scatters (a coalesced group ships one).  The stage thread
launches nothing: every block scatter, tombstone launch and fold runs on
the commit thread.  A real device error in a commit fails every waiter
typed and degrades nothing.
"""
import threading

import pytest

from loro_tpu.parallel.server import ResidentServer as JServer
from loro_tpu_torch import LoroDoc
from loro_tpu_torch.doc import strip_envelope
from loro_tpu_torch.analysis.lockwitness import witness
from loro_tpu_torch.errors import DeviceFailure, KernelLaunchError
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.parallel.server import ResidentServer as PServer
from loro_tpu_torch.persist import recover_server
from test_torch_server import FAMILIES, _quiet, fleet, jcid_of, mesh, reads, rounds_of, twins  # noqa: F401


def _run_pipeline(srv, rounds, cid, coalesce=3, depth=2):
    ex = srv.pipeline(cid=cid, coalesce=coalesce, depth=depth)
    futs = [ex.submit(list(r)) for r in rounds]
    ex.flush()
    eps = [f.epoch(timeout=30) for f in futs]
    rep = ex.report()
    ex.close()
    return eps, rep


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pipeline_equals_serial_and_jax(fleet, family):
    """Submitted rounds resolve to the serial epochs in submit order; the
    piped servers' reads and checkpoint bytes equal serial ingest's and
    the JAX pipeline's."""
    cid = FAMILIES[family][0]
    rounds = rounds_of(fleet)
    _, serial = twins(family)
    want = [serial.ingest(r, cid) for r in rounds]
    j, p = twins(family)
    got_p, rep = _run_pipeline(p, rounds, cid)
    got_j, jrep = _run_pipeline(j, rounds, jcid_of(cid))
    assert got_p == got_j == want
    assert reads(p, family) == reads(serial, family) == reads(j, family)
    assert p.checkpoint() == serial.checkpoint() == j.checkpoint()
    # how rounds fall into groups depends on the threads' timing: only the
    # counts fixed by the configuration are compared
    for k in ("rounds", "coalesce_limit", "queue_bound"):
        assert rep[k] == jrep[k], k
    assert rep["max_group"] <= 3 and rep["max_depth_seen"] <= rep["queue_bound"]
    assert rep["groups"] <= len(rounds)


@pytest.mark.parametrize("family", ["text", "tree", "movable", "map", "counter"])
def test_stage_thread_launches_nothing(fleet, monkeypatch, family):
    """Every block scatter, tombstone launch and fold of a piped run is
    made on the commit thread; the stage thread stages host state only
    (the batches are wide enough that no grow runs)."""
    cid = FAMILIES[family][0]
    calls = []

    def spy(name):
        real = getattr(pfleet, name)

        def f(*a, **k):
            calls.append((name, threading.current_thread().name))
            return real(*a, **k)

        monkeypatch.setattr(pfleet, name, f)

    for name in ("_scatter_rows", "_set_deleted", "lww_update_resident", "_fold_counter_rows"):
        spy(name)
    caps = {"text": dict(capacity=1 << 12), "tree": dict(move_capacity=1 << 12, node_capacity=1 << 10),
            "movable": dict(capacity=1 << 12, elem_capacity=1 << 10), "map": dict(slot_capacity=256),
            "counter": dict(slot_capacity=16)}[family]
    srv = PServer(family, len(fleet), device="cpu", auto_checkpoint=False, **caps)
    _run_pipeline(srv, rounds_of(fleet), cid, coalesce=2)
    threads = {t for _, t in calls}
    assert calls and threads == {"loro-pipeline-commit"}, threads


def test_coalescing_cuts_block_scatters(fleet, monkeypatch):
    """A pipeline ships one block scatter a group, where serial ingest
    ships one a round (how the four rounds group depends on the
    threads' timing; ingest_coalesced's one scatter for four rounds is
    test_torch_server's)."""
    cid = FAMILIES["text"][0]
    n = {"scatter": 0}
    real = pfleet._scatter_rows

    def scatter(*a):
        n["scatter"] += 1
        return real(*a)

    monkeypatch.setattr(pfleet, "_scatter_rows", scatter)
    rounds = rounds_of(fleet, idle=False)[:4]
    serial = PServer("text", len(fleet), device="cpu", capacity=1 << 12, auto_checkpoint=False)
    for r in rounds:
        serial.ingest(r, cid)
    n_serial, n["scatter"] = n["scatter"], 0
    piped = PServer("text", len(fleet), device="cpu", capacity=1 << 12, auto_checkpoint=False)
    _, rep = _run_pipeline(piped, rounds, cid, coalesce=4, depth=1)
    assert n_serial == 4 and n["scatter"] == rep["groups"] <= 4
    assert piped.checkpoint() == serial.checkpoint()


def _text_rounds(n, peer=31):
    d = LoroDoc(peer=peer)
    t = d.get_text("t")
    out = []
    for i in range(n):
        vv = d.oplog_vv()
        t.insert(len(t) // 2, f"r{i}-" * 3)
        if i % 3 == 2:
            t.delete(1, 2)
        d.commit()
        out.append([strip_envelope(d.export_updates(vv))])
    return d, out


def test_live_change_lists_freeze_at_submit():
    """A queued live change list is frozen at submit: the producing
    doc's later commits (which extend the same Change in place) do not
    leak into the queued round."""
    d = LoroDoc(peer=44)
    t = d.get_text("t")
    t.insert(0, "frozen")
    d.commit()
    srv = PServer("text", 1, device="cpu", capacity=1 << 12)
    ex = srv.pipeline(cid=t.id, coalesce=8)
    mark = d.oplog_vv()
    ex.submit([d.oplog.changes_in_causal_order()])
    t.insert(len(t), " more")
    d.commit()
    ex.submit([list(d.oplog.changes_between(mark, d.oplog_vv()))])
    ex.flush()
    assert srv.texts() == [t.to_string()]
    ex.close()


def test_close_checkpoint_and_submit_after_close(tmp_path):
    """checkpoint() drains the pipeline; close() drains it and fsyncs the
    group tail, so recover_server sees every round; a closed pipeline
    refuses rounds and a fresh one may attach."""
    d, rounds = _text_rounds(7)
    cid = d.get_text("t").id
    srv = PServer("text", 1, device="cpu", capacity=1 << 12, durable_dir=str(tmp_path),
                  durable_fsync="group", fsync_window=4)
    ex = srv.pipeline(cid=cid, coalesce=3)
    futs = [ex.submit(list(r)) for r in rounds[:5]]
    srv.checkpoint()
    assert all(f.done for f in futs)
    ex.submit(list(rounds[5]))
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        ex.submit(list(rounds[6]))
    assert srv.durable_epoch == srv.epoch
    back = recover_server(str(tmp_path), device="cpu")
    assert back.epoch == srv.epoch
    ex2 = back.pipeline(cid=cid)
    ex2.submit(list(rounds[6]))
    ex2.flush()
    assert back.texts() == [d.get_text("t").to_string()]
    back.close()


def test_group_commit_watermark_matches_jax(fleet, tmp_path):
    """durable_epoch under group commit: mid-window rounds are not
    durable, a flush covers them, a coalesced group ends durable, a
    piped group resolves only durable epochs: the same watermarks as the
    JAX server's at every step."""
    cid = FAMILIES["text"][0]
    rounds = rounds_of(fleet, idle=False)
    kw = dict(durable_fsync="group", fsync_window=100, auto_checkpoint=False, capacity=1 << 12)
    j = JServer("text", len(fleet), mesh=mesh(), durable_dir=str(tmp_path / "j"), **kw)
    p = PServer("text", len(fleet), device="cpu", durable_dir=str(tmp_path / "p"), **kw)
    marks = []
    for srv, c in ((j, jcid_of(cid)), (p, cid)):
        m = []
        for r in rounds[:2]:
            srv.ingest(r, c)
        m.append((srv.durable_epoch, srv.epoch))
        m.append(srv.flush_durable())
        m.append(srv.ingest_coalesced(rounds[2:4], c) + [srv.durable_epoch])
        eps, _ = _run_pipeline(srv, rounds[4:], c, coalesce=2)
        m.append(eps + [srv.durable_epoch])
        srv.close()
        marks.append(m)
    assert marks[0] == marks[1]
    assert marks[1][0][0] < marks[1][0][1]


def test_real_device_error_fails_every_waiter(fleet, monkeypatch):
    """A real device error in a group's commit (a failed kernel launch)
    fails that group's futures and every queued one typed, the pipeline
    refuses further rounds, and the server is not degraded."""
    cid = FAMILIES["text"][0]
    srv = PServer("text", len(fleet), device="cpu", capacity=1 << 12)
    rounds = rounds_of(fleet, idle=False)
    srv.ingest(rounds[0], cid)

    def fail(*a, **k):
        raise KernelLaunchError("cudaErrorLaunchFailure (test)")

    monkeypatch.setattr(srv.batch, "commit_detached", fail)
    ex = srv.pipeline(cid=cid, coalesce=2, depth=2)
    futs = []
    for r in rounds[1:]:
        try:
            futs.append(ex.submit(r))
        except RuntimeError:  # the first group already failed
            break
    with pytest.raises(RuntimeError, match="pipeline failed") as info:
        ex.flush()
    assert isinstance(info.value.__cause__, DeviceFailure) and not info.value.__cause__.injected
    for f in futs:
        with pytest.raises(DeviceFailure):
            f.epoch(timeout=30)
    with pytest.raises(RuntimeError):
        ex.submit(rounds[1])
    assert not srv.degraded
    with pytest.raises(RuntimeError):
        ex.close()


def test_lock_order_holds_under_a_tiered_pipeline(fleet):
    """A piped tiered server (evictions and revives under residency.plan
    while the commit thread holds fleet.dev) takes its named locks only
    in the declared order: strict witness, no violation, no cycle."""
    cid = FAMILIES["text"][0]
    w = witness()
    w.reset()
    w.enable(strict=True)
    try:
        srv = PServer("text", len(fleet), device="cpu", capacity=1 << 12, hot_slots=3)
        _run_pipeline(srv, rounds_of(fleet), cid, coalesce=2)
        srv.checkpoint()
        assert w.violations() == [] and w.check_declared() == []
        w.assert_acyclic()
        names = {n for e in w.edges() for n in e}
        assert {"pipeline.queue", "residency.plan", "fleet.dev"} & names
    finally:
        w.disable()
        w.reset()
