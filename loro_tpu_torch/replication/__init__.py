"""loro_tpu_torch.replication: WAL-shipping hot standby, follower reads and
fault-injected failover (the port of loro_tpu/replication/).

The segmented WAL (loro_tpu_torch/persist/) is a durable total order of
ingest rounds with an acked fsync watermark; this package streams it:

- ``enable(leader)``       — claim the leader token, install the
  append fence, publish the fsync-visibility marker, pin WAL pruning
  at follower acks (``manifest.ReplicationManifest``);
- ``WalShipper``           — visibility-gated per-segment byte streams
  (sealed segments whole, the open segment up to the durable
  watermark — the tail protocol);
- ``Follower``             — a rolling ``recover_server``: a live
  ResidentServer continuously applying shipped rounds, reporting
  ``applied_epoch``/``lag_epochs``, serving read-only sessions;
- ``ShardedFollower``      — one stream per shard, placement tracked
  from ``sharding.json`` (mid-stream migrations included);
- ``ReadOnlySyncServer``   — the full session surface over a follower;
  ``push()`` raises typed ``NotLeader``; ``pull(min_epoch=)`` is the
  read-your-writes gate (typed ``ReplicaLag`` on timeout);
- ``Follower.promote()``   — fence the old leader (token bump checked
  at its every WAL append → typed ``FencedLeader``), drain the shipped
  tail, reopen the WAL copy for append and flip writable.

Fault sites (``LORO_FAULT``/faultinject): ``repl_ship``,
``repl_apply``, ``repl_promote``.  Metrics: ``repl.*``.
"""
from __future__ import annotations

from .follower import Follower, ShardedFollower, enable
from .manifest import ReplicationManifest, load_replication
from .readonly import ReadOnlySyncServer
from .shipper import WalShipper

__all__ = [
    "Follower",
    "ReadOnlySyncServer",
    "ReplicationManifest",
    "ShardedFollower",
    "WalShipper",
    "enable",
    "load_replication",
]
