"""Replication crash child of the port (not collected: no test_ prefix).

Runs a durable, replication-enabled text leader of loro_tpu_torch on the
CPU::

    python tests/_torch_repl_crash_child.py <leader_dir> <rounds> [fsync_window]

Group-commit WAL, ``replication.enable`` (so the fsync-visibility marker
publishes for a follower in another process), one deterministic insert a
round (``round == epoch``), one flushed progress line a round (``round
epoch durable_epoch``) in ``<leader_dir>/../progress``, then
``<leader_dir>/../READY`` and a long sleep where the parent kills it with
SIGKILL, between launches.

As a module: ``make_doc`` / ``edit`` regenerate the client's edits and
``oracle_text(n)`` the text after ``n`` rounds, for the parent's checks.
"""
import os
import os.path as _p
import sys
import time

sys.path.insert(0, _p.dirname(_p.dirname(_p.abspath(__file__))))  # the repo root

BASE = "repl base"


def make_doc():
    from loro_tpu_torch import LoroDoc

    d = LoroDoc(peer=4242)
    d.get_text("t").insert(0, BASE)
    d.commit()
    return d


def edit(d, r):
    d.get_text("t").insert(0, f"r{r} ")
    d.commit()


def oracle_text(rounds: int) -> str:
    """The text after ``rounds`` ingest rounds (round 1 pushes the base
    history; rounds 2.. prepend their tag)."""
    out = BASE
    for r in range(2, rounds + 1):
        out = f"r{r} " + out
    return out


def main(leader_dir: str, rounds: int, fsync_window: int = 4) -> None:
    from loro_tpu_torch import replication
    from loro_tpu_torch.doc import strip_envelope
    from loro_tpu_torch.parallel.server import ResidentServer

    d = make_doc()
    srv = ResidentServer("text", 1, device="cpu", durable_dir=leader_dir, capacity=1 << 12,
                         durable_fsync="group", fsync_window=fsync_window)
    replication.enable(srv, "leader")
    cid = d.get_text("t").id
    mark = {}
    progress = _p.join(_p.dirname(leader_dir), "progress")
    for r in range(1, rounds + 1):
        if r > 1:
            edit(d, r)
        payload = bytes(d.export_updates(mark))
        mark = d.oplog_vv()
        srv.ingest([strip_envelope(payload)], cid)
        if r == rounds // 2:
            srv.checkpoint()
        with open(progress, "a") as f:
            f.write(f"{r} {srv.epoch} {srv.durable_epoch}\n")
            f.flush()
    with open(_p.join(_p.dirname(leader_dir), "READY"), "w") as f:
        f.write("ready")
    time.sleep(300.0)  # the parent kills this process here


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]) if len(sys.argv) > 3 else 4)
