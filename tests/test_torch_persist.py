"""The port's persist/ (the segmented WAL, the checkpoint ladder, the
mirror anchor, recover_server / open_server and persist.inspect) on the
CPU against the JAX package's.

Inputs: test_torch_server's seeded tracegen.loro_fleet rounds.  Durable
servers of both packages (JAX on a one-device mesh, the port on
device="cpu") take the same rounds into two directories with the WAL
stamp clock ``_wall`` patched in both: every file they write (WAL
segments, checkpoint rungs) is byte-equal.  Recovery of either directory
by either package gives the same epochs, durable watermark, reads and
recovery report, also past a torn WAL tail and a corrupt newest rung;
persist.inspect prints the same dump.  A child process (this file run as
a script) is killed with SIGKILL mid-stream and its directory recovers
to every round it journaled.  Tolerance: exact.
"""
import io
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from loro_tpu.persist import open_server as jopen_server
from loro_tpu.persist import recover_server as jrecover_server
from loro_tpu.persist.inspect import inspect_dir as jinspect_dir
from loro_tpu.parallel.server import ResidentServer as JServer
from loro_tpu_torch.errors import PersistError
from loro_tpu_torch.parallel.server import ResidentServer as PServer
from loro_tpu_torch.persist import open_server, recover_server
from loro_tpu_torch.persist.inspect import inspect_dir, main as inspect_main
from loro_tpu_torch.resilience import faultinject as pfi
from test_torch_server import FAMILIES, _quiet, fleet, jcid_of, mesh, reads, rounds_of  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _files(d):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*") if p.is_file())


def _durable_pair(tmp_path, family, fleet, fsync=True, ckpt_after=2, n_rounds=None):
    """JAX and port durable servers fed the same rounds (a checkpoint
    after `ckpt_after` rounds), then closed.  Returns (jax dir, port dir,
    rounds, the JAX server, the port server)."""
    cid = FAMILIES[family][0]
    rounds = rounds_of(fleet)[:n_rounds]
    jd, pd = tmp_path / "jax", tmp_path / "port"
    kw = dict(durable_fsync=fsync, fsync_window=3, **FAMILIES[family][1])
    j = JServer(family, len(fleet), mesh=mesh(), durable_dir=str(jd), **kw)
    p = PServer(family, len(fleet), device="cpu", durable_dir=str(pd), **kw)
    for i, r in enumerate(rounds):
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
        if i + 1 == ckpt_after:
            assert j.checkpoint() == p.checkpoint()
    j.close()
    p.close()
    return jd, pd, rounds, j, p


@pytest.mark.parametrize("fsync", [True, "group"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_wal_segments_and_rungs_byte_equal(tmp_path, fleet, family, fsync):
    """Every file of the two durable directories (WAL segments with their
    round records, meta and checkpoint markers; the checkpoint rungs) is
    byte-equal, per-round fsync and group commit alike."""
    jd, pd, _, j, p = _durable_pair(tmp_path, family, fleet, fsync=fsync)
    assert _files(jd) == _files(pd) and _files(pd)
    for name in _files(pd):
        assert (jd / name).read_bytes() == (pd / name).read_bytes(), name
    assert j.durable_epoch == p.durable_epoch == p.epoch


def _report(srv):
    r = srv.last_recovery
    return (r.checkpoint_epoch, r.checkpoint_name, r.checkpoints_skipped, r.rounds_replayed, r.recovered_epoch, r.cold)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_recover_server_matches_jax_both_ways(tmp_path, fleet, family):
    """recover_server of the JAX directory and of the port's, by the port,
    equal the JAX package's recovery: epoch, durable watermark, report,
    reads; the recovered servers keep serving equal (one more round,
    checkpoint bytes)."""
    cid = FAMILIES[family][0]
    jd, pd, rounds, _, live = _durable_pair(tmp_path, family, fleet, n_rounds=5)
    jsrv = jrecover_server(str(jd), mesh=mesh())
    got = [recover_server(str(d), device="cpu") for d in (jd, pd)]
    for srv in got:
        assert (srv.epoch, srv.durable_epoch) == (jsrv.epoch, jsrv.durable_epoch) == (live.epoch, live.epoch)
        assert _report(srv) == _report(jsrv)
        assert reads(srv, family) == reads(jsrv, family) == reads(live, family)
    rest = rounds_of(fleet)[5]
    jsrv.ingest(rest, jcid_of(cid))
    for srv in got:
        srv.ingest(rest, cid)
        assert reads(srv, family) == reads(jsrv, family)
    blobs = [s.checkpoint() for s in (jsrv, *got)]
    assert blobs[0] == blobs[1] == blobs[2]
    for s in (jsrv, *got):
        s.close()


def test_open_server_creates_then_recovers(tmp_path, fleet):
    """open_server builds a fresh durable server over an empty directory
    (family and n_docs required) and recovers a used one, as JAX's."""
    cid = FAMILIES["text"][0]
    d = tmp_path / "d"
    with pytest.raises(PersistError):
        open_server(str(d), device="cpu")
    srv = open_server(str(d), "text", len(fleet), device="cpu", capacity=64)
    rounds = rounds_of(fleet)
    for r in rounds[:3]:
        srv.ingest(r, cid)
    srv.close()
    with pytest.raises(PersistError):
        PServer("text", len(fleet), device="cpu", durable_dir=str(d))
    back = open_server(str(d), device="cpu")
    jback = jopen_server(str(d), mesh=mesh())
    assert back.epoch == jback.epoch == srv.epoch and back.texts() == jback.texts() == srv.texts()
    assert back.last_recovery.cold == jback.last_recovery.cold
    back.close()
    jback.close()


@pytest.mark.parametrize("cut", [1, 9, 40])
def test_torn_tail_recovers_the_prefix_like_jax(tmp_path, fleet, cut):
    """The active WAL segment cut `cut` bytes short (a torn last record):
    both packages recover the same prefix of rounds, reads equal."""
    jd, pd, _, _, _ = _durable_pair(tmp_path, "text", fleet, ckpt_after=1)
    for d in (jd, pd):
        seg = sorted(p for p in _files(d) if p.endswith(".log"))[-1]
        path = d / seg
        path.write_bytes(path.read_bytes()[:-cut])
    jsrv = jrecover_server(str(jd), mesh=mesh())
    psrv = recover_server(str(pd), device="cpu")
    assert psrv.epoch == jsrv.epoch and _report(psrv) == _report(jsrv)
    assert psrv.texts() == jsrv.texts()
    psrv.close()
    jsrv.close()


def test_corrupt_rung_falls_down_the_ladder_like_jax(tmp_path, fleet):
    """Two checkpoints; the newest rung bit-flipped in both directories:
    both packages skip it, restore the older rung, replay the longer WAL
    tail and reach the same state; inspect_dir reports the corrupt rung
    in both."""
    cid = FAMILIES["text"][0]
    rounds = rounds_of(fleet)
    dirs = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        if pkg == "jax":
            srv, c = JServer("text", len(fleet), mesh=mesh(), durable_dir=str(d), capacity=64), jcid_of(cid)
        else:
            srv, c = PServer("text", len(fleet), device="cpu", durable_dir=str(d), capacity=64), cid
        for i, r in enumerate(rounds):
            srv.ingest(r, c)
            if i in (1, 4):
                srv.checkpoint()
        srv.close()
        rungs = sorted(p for p in _files(d) if p.endswith(".ltck"))
        newest = d / rungs[-1]
        data = bytearray(newest.read_bytes())
        data[len(data) // 2] ^= 0x5A
        newest.write_bytes(bytes(data))
        dirs.append(d)
    jsrv = jrecover_server(str(dirs[0]), mesh=mesh())
    psrv = recover_server(str(dirs[1]), device="cpu")
    assert _report(psrv) == _report(jsrv) and psrv.last_recovery.checkpoints_skipped == 1
    assert psrv.epoch == jsrv.epoch and psrv.texts() == jsrv.texts()
    outs = []
    for fn, d in ((jinspect_dir, dirs[0]), (inspect_dir, dirs[1])):
        buf = io.StringIO()
        assert fn(str(d), out=buf) == 1
        outs.append(buf.getvalue().replace(str(d), "<dir>"))
    assert outs[0] == outs[1] and "CORRUPT" in outs[1]
    psrv.close()
    jsrv.close()


@pytest.mark.parametrize("family", ["text", "tree"])
def test_inspect_prints_the_jax_dump(tmp_path, fleet, family):
    """persist.inspect on byte-equal directories prints the JAX tool's
    dump (paths aside); the command line refuses a missing directory."""
    jd, pd, _, _, _ = _durable_pair(tmp_path, family, fleet)
    outs = []
    for fn, d in ((jinspect_dir, jd), (inspect_dir, pd)):
        buf = io.StringIO()
        assert fn(str(d), out=buf) == 0
        outs.append(buf.getvalue().replace(str(d), "<dir>"))
    assert outs[0] == outs[1] and "family=" + family in outs[1]
    assert inspect_main([str(tmp_path / "nope")]) == 2
    assert inspect_main([]) == 2


def test_wal_write_fault_fail_stops_typed(tmp_path, fleet):
    """An armed wal_write fault: the round is applied but its journal
    append fails, so the server detaches the WAL and raises PersistError;
    later ingests raise PersistError too (as JAX's)."""
    cid = FAMILIES["text"][0]
    rounds = rounds_of(fleet)
    srv = PServer("text", len(fleet), device="cpu", durable_dir=str(tmp_path / "d"), capacity=64)
    srv.ingest(rounds[0], cid)
    pfi.inject("wal_write", exc=OSError("disk gone"), times=1)
    with pytest.raises(PersistError):
        srv.ingest(rounds[1], cid)
    with pytest.raises(PersistError):
        srv.ingest(rounds[2], cid)


CHILD_ROUNDS, CHILD_CKPT = 6, 3


def _child(base: str) -> None:
    """The crash child: a durable port server on the CPU fed CHILD_ROUNDS
    rounds (per-round fsync), checkpointed after CHILD_CKPT; READY is
    written, then it sleeps until it is killed."""
    sys.path.insert(0, str(REPO / "tests"))
    sys.path.insert(0, str(REPO))
    from loro_tpu_torch import tracegen as tg

    fleet_ = tg.loro_fleet(5, 4, n_rounds=5)
    rounds = _plain_rounds(fleet_)
    srv = PServer("text", 4, device="cpu", durable_dir=os.path.join(base, "d"), capacity=64)
    for i, r in enumerate(rounds[:CHILD_ROUNDS]):
        srv.ingest(r, tg.TEXT_CID)
        if i + 1 == CHILD_CKPT:
            srv.checkpoint()
    with open(os.path.join(base, "READY"), "w") as f:
        f.write(str(srv.epoch))
    while True:
        time.sleep(1)


def _plain_rounds(fleet_):
    """test_torch_server.rounds_of without importing it (the child runs
    without the JAX package's test imports)."""
    nxt, out, r = [0] * len(fleet_), [], 0
    while any(n < 5 for n in nxt):
        round_ = [None] * len(fleet_)
        for i, d in enumerate(fleet_):
            if (r + i) % 3 and nxt[i] < 5:
                round_[i] = d.epochs[nxt[i]]
                nxt[i] += 1
        out.append(round_)
        r += 1
    return out


def test_sigkill_mid_stream_recovers_every_journaled_round(tmp_path, fleet):
    """A child process (this file as a script) journals CHILD_ROUNDS
    rounds with per-round fsync and is SIGKILLed: recover_server gets
    every one, with the texts of a server fed the same rounds here."""
    assert _plain_rounds(fleet) == rounds_of(fleet)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    child = subprocess.Popen([sys.executable, __file__, str(tmp_path)], env=env,
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 90
        while not (tmp_path / "READY").exists():
            assert child.poll() is None, child.stderr.read().decode()[-2000:]
            assert time.time() < deadline, "the crash child never got ready"
            time.sleep(0.1)
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    child.stderr.close()
    epoch = int((tmp_path / "READY").read_text())
    back = recover_server(str(tmp_path / "d"), device="cpu")
    want = PServer("text", len(fleet), device="cpu", capacity=64)
    for r in rounds_of(fleet)[:CHILD_ROUNDS]:
        want.ingest(r, FAMILIES["text"][0])
    assert back.epoch == back.durable_epoch == epoch == want.epoch
    assert back.texts() == want.texts()
    assert back.last_recovery.checkpoint_epoch > 0 and back.last_recovery.rounds_replayed > 0
    back.close()


if __name__ == "__main__":
    _child(sys.argv[1])
