"""``replication.json``: the durable control record of one replicated
directory (next to ``sharding.json`` / ``residency.json``).

Two things live here, both tiny and both load-bearing:

- the **leader token** — a monotone integer stamped with the holder's
  identity.  ``promote()`` bumps it; the (possibly zombie) old leader
  checks it at every WAL append through the installed fence hook and
  fail-stops typed ``FencedLeader`` when a newer token exists.  The
  highest token wins promotion races: whichever follower bumps last
  fences every earlier holder at its next append.
- the **follower ack table** — per registered follower, the newest
  applied epoch and a wall-clock last-seen stamp.  The minimum acked
  epoch over FRESH followers is the retention pin the WAL prune path
  honors (``WriteAheadLog.retention_floor``); followers staler than
  the cutoff stop pinning (counted) so a dead follower can never pin
  the log forever — when such a follower later resumes past pruned
  history it fails typed ``StaleFollower`` at the ship scan instead.

Writes are atomic (tmp + ``os.replace`` + directory fsync, the
``sharding.json`` idiom); reads are mtime/size-cached so the fence
check on the WAL append hot path costs one ``os.stat`` per append.
The clock is injectable (``clock=``) and defaults to wall time —
last-seen stamps must compare across processes.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

from ..errors import NotLeader, ReplicationError
from ..obs import metrics as obs
from ..persist.wal import fsync_dir

MANIFEST_NAME = "replication.json"
MANIFEST_VERSION = 1

# a follower silent for this long stops pinning WAL retention (the
# typed staleness cutoff; override per-manifest with stale_after=)
DEFAULT_STALE_AFTER_S = 600.0


class ReplicationManifest:
    """One ``replication.json`` under ``dir`` (a durable server
    directory, or a ``shard-NN/`` sub-directory of a sharded fleet)."""

    def __init__(self, dir: str, clock=None,
                 stale_after: float = DEFAULT_STALE_AFTER_S):
        self.dir = dir
        self.path = os.path.join(dir, MANIFEST_NAME)
        self._clock = time.time if clock is None else clock
        self.stale_after = float(stale_after)
        self._cache: Optional[dict] = None
        self._cache_stat: Optional[Tuple[int, float]] = None

    # -- raw I/O -------------------------------------------------------
    def read(self) -> dict:
        """Current manifest (mtime/size-cached; fresh skeleton when the
        file does not exist yet)."""
        try:
            st = os.stat(self.path)
            key = (st.st_size, st.st_mtime_ns)
        except OSError:
            self._cache, self._cache_stat = None, None
            return {"version": MANIFEST_VERSION, "leader_token": 0,
                    "leader_id": None, "followers": {}}
        if self._cache is not None and self._cache_stat == key:
            return self._cache
        with open(self.path, "r") as f:
            data = json.load(f)
        if data.get("version", 0) > MANIFEST_VERSION:
            raise ReplicationError(
                f"{self.path}: replication manifest v{data.get('version')} "
                "newer than supported"
            )
        self._cache, self._cache_stat = data, key
        return data

    def _write(self, data: dict) -> None:
        data["version"] = MANIFEST_VERSION
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        fsync_dir(self.dir)
        self._cache = None  # next read restats (mtime granularity)

    # -- leader token --------------------------------------------------
    def leader(self) -> Tuple[int, Optional[str]]:
        """``(token, holder_id)`` — the fence hook's view (one stat on
        the cached path)."""
        d = self.read()
        return int(d.get("leader_token", 0)), d.get("leader_id")

    def claim_leader(self, leader_id: str,
                     token: Optional[int] = None) -> int:
        """Record ``leader_id`` as the token holder and return the
        token.  A fresh directory starts at token 1; re-claiming a
        token this id already holds is idempotent; claiming over a
        DIFFERENT holder without an explicit (promotion-granted)
        ``token=`` raises typed ``NotLeader`` — enable() must never
        silently steal leadership."""
        d = self.read()
        cur, holder = int(d.get("leader_token", 0)), d.get("leader_id")
        if token is not None:
            new = max(cur, int(token))
        elif cur == 0 or holder == leader_id:
            new = max(cur, 1)
        else:
            raise NotLeader(
                f"{self.dir}: leader token {cur} is held by "
                f"{holder!r} — promote() a follower to take over",
                leader=holder,
            )
        d["leader_token"] = new
        d["leader_id"] = leader_id
        self._write(d)
        return new

    def bump_token(self, new_leader_id: str) -> int:
        """Fence the current holder: token+1 stamped with the new
        leader's identity.  Returns the granted token.

        Two promoters may race from SEPARATE processes (the designed
        deployment), so the read-modify-write is not enough: both
        would mint EQUAL tokens and neither would fence the other
        (the fence only fires on ``cur > token``) — split brain.  The
        token grant is therefore a filesystem CAS: each candidate
        token is claimed by ``O_EXCL``-creating ``.token-N.claim``
        (exactly one process can win each N), so racing promoters
        always hold DISTINCT tokens and the highest fences every
        lower holder, exactly the documented race semantic.  The
        manifest write then converges to the max over claimants
        (re-read after write; rewrite while a smaller token overwrote
        ours) — the token record can lag but never move backward."""
        d = self.read()
        new = int(d.get("leader_token", 0)) + 1
        while True:
            claim = os.path.join(self.dir, f".token-{new}.claim")
            try:
                fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                new += 1  # lost this token to a racing promoter
                continue
            try:
                os.write(fd, new_leader_id.encode())
                os.fsync(fd)
            finally:
                os.close(fd)
            fsync_dir(self.dir)
            break
        while True:
            d = self.read()
            cur = int(d.get("leader_token", 0))
            if cur >= new:
                break  # ours landed, or a higher claimant won — done
            d["leader_token"] = new
            d["leader_id"] = new_leader_id
            self._write(d)
        # retired claims (<= the recorded token) can never be granted
        # again — every future bump starts above it
        for name in os.listdir(self.dir):
            if name.startswith(".token-") and name.endswith(".claim"):
                try:
                    if int(name[len(".token-"):-len(".claim")]) < new:
                        os.unlink(os.path.join(self.dir, name))
                except (ValueError, OSError):
                    pass
        obs.counter(
            "repl.promotions_total", "leader-token bumps (promotions)"
        ).inc()
        return new

    # -- follower acks / retention pin ---------------------------------
    def ack_follower(self, fid: str, applied_epoch: int) -> None:
        """Record a follower's applied watermark (monotone) + freshness
        stamp.  The ack is what pins WAL retention."""
        d = self.read()
        f = d.setdefault("followers", {}).setdefault(fid, {})
        f["acked_epoch"] = max(int(f.get("acked_epoch", 0)),
                               int(applied_epoch))
        f["last_seen"] = self._clock()
        self._write(d)

    def drop_follower(self, fid: str) -> None:
        d = self.read()
        if fid in d.get("followers", {}):
            del d["followers"][fid]
            self._write(d)

    def followers(self) -> Dict[str, dict]:
        return dict(self.read().get("followers", {}))

    def pinned_floor(self) -> Optional[int]:
        """The retention pin: min acked epoch over FRESH followers
        (None = no fresh follower, nothing pinned).  Stale followers
        are skipped and counted — the typed cutoff that keeps a dead
        follower from pinning the WAL forever (it fails
        ``StaleFollower`` on resume instead)."""
        now = self._clock()
        floors = []
        for fid, f in self.read().get("followers", {}).items():
            if now - float(f.get("last_seen", 0.0)) > self.stale_after:
                obs.counter(
                    "repl.stale_followers_dropped_total",
                    "follower retention pins skipped by the staleness "
                    "cutoff",
                ).inc()
                continue
            floors.append(int(f.get("acked_epoch", 0)))
        return min(floors) if floors else None


def load_replication(dir: str) -> Optional[dict]:
    """The raw ``replication.json`` of a durable dir, or None (the
    torch-free read ``persist.inspect`` uses)."""
    path = os.path.join(dir, MANIFEST_NAME)
    if not os.path.isfile(path):
        return None
    with open(path, "r") as f:
        return json.load(f)
