"""persist: durable WAL + checkpoint ladder + bounded-replay
recovery for the resident fleet path (the reproduction's L1 storage
layer; docs/PERSISTENCE.md has the full design).

Four pieces:

- ``wal``         — segmented, crc32-framed, torn-tail-tolerant
  write-ahead log of ingest rounds (+ ``DurableLog``, the per-server
  directory coordinating WAL and checkpoints);
- ``checkpoints`` — CheckpointManager: retention ladder of
  ``ResidentServer.checkpoint()`` blobs (newest K + geometrically
  thinned older rungs), typed DecodeError on corrupt rungs;
- ``anchor``      — ``MirrorAnchor`` (per-doc shallow-snapshot anchors
  so the host-mirror degradation oracle no longer needs history since
  birth) and ``recover_server``/``open_server`` (restore the newest
  valid checkpoint, replay only WAL rounds after its epoch, falling
  down the ladder past corrupt blobs);
- ``inspect``     — ``python -m loro_tpu_torch.persist.inspect <dir>``
  one-screen dump of segments, records, checkpoint epochs and crc
  status.

Fault sites (``LORO_FAULT``/faultinject): ``wal_write``,
``wal_torn_tail``, ``ckpt_corrupt``.  Metrics: ``persist.*``
(docs/OBSERVABILITY.md).
"""
from __future__ import annotations

from .anchor import MirrorAnchor, RecoveryReport, open_server, recover_server
from .checkpoints import CheckpointInfo, CheckpointManager
from .wal import DurableLog, WalMeta, WalRecord, WriteAheadLog

__all__ = [
    "CheckpointInfo",
    "CheckpointManager",
    "DurableLog",
    "MirrorAnchor",
    "RecoveryReport",
    "WalMeta",
    "WalRecord",
    "WriteAheadLog",
    "open_server",
    "recover_server",
    "recover_sharded_server",
]


def recover_sharded_server(durable_dir: str, devices=None, fsync: bool = True):
    """Reopen a sharded fleet directory (``sharding.json`` manifest +
    per-shard WAL/ladder sub-dirs) — see
    ``parallel.sharded.recover_sharded_server`` (lazy import: the
    sharded module pulls in torch and the resident batches)."""
    from ..parallel.sharded import recover_sharded_server as _impl

    return _impl(durable_dir, devices=devices, fsync=fsync)
