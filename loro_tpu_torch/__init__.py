"""loro_tpu_torch — the PyTorch/CUDA port of loro_tpu.

The JAX package ``loro_tpu`` stays the reference; this package imports
nothing of it (and never imports jax).  It covers the host engine (the
LoroDoc and its layers, pure Python copied from the JAX package), the
fleet text merge, element-level and chain-contracted, from payload
bytes, the LWW-map, counter, movable-tree, rich-text and MovableList
merges, their resident batches and the read plane:

    core              ids, the op/change model, versions, values
    config, errors    Configure; the exception types
    utils             the order-statistic treap, fractional indexes,
                      tracing spans
    obs.metrics       the process-wide metrics registry
    event             diffs and events
    models            container states (FugueSeq text/list/movable list,
                      LWW map, counter, movable tree, unknown) and the
                      user-facing handlers
    oplog             the OpLog: DAG, pending queue, cold change store
    state, txn        the document state and transactions
    doc               LoroDoc: edits, commits, import/export, checkout,
                      diff, fork, the envelope helpers
                      (frame_columnar_updates, parse_envelope_header,
                      strip_envelope)
    history_cache, cursor, jsonpath
                      checkout's state cache, stable cursors, JSONPath
    undo, awareness   UndoManager; Awareness and EphemeralStore
    resilience        DeviceSupervisor (every one-shot Fleet merge's
                      upload, device call and fetch, and the read
                      plane's selection, run through it: device errors
                      become DeviceFailure and reach the caller; under
                      an armed fault the one-shot merges degrade to the
                      host engine), faultinject, the backend
                      probe; resilience.hostpath: HostEngine (per-doc
                      LoroDoc replicas with the resident batches' read
                      names) and host_merge_changes, the host oracle of
                      every device merge and the degraded merges'
                      engine
    analysis, obs.flight
                      the named locks and their declared order; the
                      flight recorder of supervisor and fault events
    codec.binary      the payload decoder (decode_changes) and encoder
    codec.snapshot, codec.json_schema
                      the state snapshot codec; the JSON updates schema
                      and redact_json_updates
    native            the native payload explodes (seq_codec.cpp: seq,
                      delta, map, tree and movable), order engine and id
                      map (order_idmap.cpp)
    ops.columnar      host numpy element tables -> SeqColumns / ChainColumns
    ops.fugue_batch   Euler-tour ring, list-rank dispatch, placement,
                      batch entry points (explicit leading doc axis), the
                      resident path's device ops on SeqColumnsU
    parallel.fleet    Fleet: one-shot batched text, map, counter, tree,
                      rich-text and MovableList merges of docs, change
                      lists or payloads; the resident batches
                      DeviceDocBatch (text), DeviceMapBatch,
                      DeviceCounterBatch, DeviceTreeBatch and
                      DeviceMovableBatch (appends, reads, checkpoints)
    parallel.order_maintenance, parallel.idmap
                      the resident batch's host order engine and id maps
    storage           the LTKV key-value store of its checkpoints
    ops.list_rank     hand-written Hopper list-ranking kernels
                      (csrc/list_rank.cu) + their plain torch versions
    ops.lww           the LWW-map and counter merges (torch scatters)
    ops.tree_batch    the movable-tree merge: the hand-written replay
                      kernel (csrc/tree_replay.cu) + its plain version
    ops.richtext_batch, ops.movable_batch
                      the rich-text and MovableList merges
    ops.export_batch  the read plane's batched export selection
    parallel.server   ResidentServer: the serving entry point over one
                      resident batch (ingest, poison isolation,
                      coalesced and staged rounds, the round journal,
                      acks and compaction floors, checkpoint / restore,
                      armed-fault degradation and recover(), reads)
    parallel.pipeline PipelinedIngest: a stage and a commit thread over a
                      server, coalesced groups, bounded depth
    parallel.residency
                      TieredBatch, ResidencyManager and
                      TieredResidentServer (hot_slots=): a device hot
                      set over host-warm and disk-cold docs
    parallel.placement, parallel.mesh, parallel.sharded
                      rendezvous placement; the device mesh (a grid
                      of torch.devices, op_parallel, doc_sharding,
                      shard_meshes); ShardedResidentServer over a
                      mesh's rows or a device list,
                      ShardedPipeline, migrate, recover_sharded_server
    persist           the segmented WAL, the checkpoint ladder, the
                      mirror anchor, recover_server / open_server and
                      ``python -m loro_tpu_torch.persist.inspect <dir>``
    obs.heat          per-doc and per-shard decayed heat
    sync              SyncServer: client sessions over a resident server
                      (push fan-in, delta pulls, presence), the batched
                      ReadBatcher over the read plane
    obs               the registry's exposition (Prometheus text,
                      /metrics and /status.json), the health plane and
                      its top view, the report and trace tools, the
                      device round-trip probe
    net               NetServer (asyncio TCP front over a SyncServer, one
                      session a connection), NetClient, the wire codec
    replication       enable() (leader token, append fence, visibility
                      marker, retention pin), WalShipper, Follower and
                      ShardedFollower (rolling recovery of shipped WAL on
                      the card, promote()), ReadOnlySyncServer
    entry             entry(): the element merge of an example batch
    tracegen          seeded traces (automerge-perf-shaped text, map,
                      counter, tree, rich-text and movable histories,
                      LoroDoc-made fleets) + host oracles

Host-only classes (LoroDoc, HostEngine) take no ``device=``.  Public
device entry points take ``device=`` (default ``"cuda"``) and raise
DeviceUnavailable without a card unless given ``device="cpu"``.
"""
from .codec.json_schema import RedactError, redact_json_updates
from .core.change import Change, Op, Side
from .core.ids import ContainerID, ContainerType, ID, IdSpan, TreeID
from .core.version import Frontiers, VersionRange, VersionVector
from .cursor import AbsolutePosition, Cursor, CursorSide, get_cursor, get_cursor_pos
from .device import resolve_device
from .doc import EncodeMode, ExportMode, ImportStatus, LoroDoc
from .errors import (BackendUnavailable, ConfigError, DeadlineExceeded, DecodeError, DeviceFailure,
                     DeviceUnavailable, FencedLeader, KernelBuildError, KernelLaunchError, LoroError, NetError,
                     NetProtocolError, NotLeader, PersistError, PushRejected, ReplicaLag, ReplicationError,
                     ResidencyError, ResilienceError, SessionClosed, ShardingError, StaleFollower, StaleFrontier,
                     SyncError)
from .event import (
    ContainerDiff,
    CounterDiff,
    Delete,
    Delta,
    DocDiff,
    EventTriggerKind,
    Insert,
    MapDiff,
    Retain,
    TreeDiff,
    TreeDiffAction,
    TreeDiffItem,
)
from .models.handlers import (
    CounterHandler,
    Handler,
    ListHandler,
    MapHandler,
    MovableListHandler,
    TextHandler,
    TreeHandler,
)
from . import resilience
from .awareness import Awareness, EphemeralStore
from .resilience import DeviceSupervisor, get_supervisor, set_supervisor
from .undo import UndoManager
from . import persist
from .parallel.pipeline import PipelinedIngest
from .parallel.residency import TieredResidentServer
from .parallel.server import ResidentServer
from .parallel.sharded import ShardedResidentServer
from .persist import open_server, recover_server, recover_sharded_server
from . import obs
from . import sync
from .sync import FanIn, PresencePlane, ReadBatcher, Session, SyncServer
from . import net
from . import replication
from .net import NetClient, NetServer
from .replication import Follower, ReadOnlySyncServer, ShardedFollower

__all__ = [
    "resolve_device",
    "ConfigError",
    "DeviceUnavailable",
    "DeviceFailure",
    "BackendUnavailable",
    "DeadlineExceeded",
    "ResilienceError",
    "KernelBuildError",
    "KernelLaunchError",
    "DeviceSupervisor",
    "get_supervisor",
    "set_supervisor",
    "resilience",
    "persist",
    "PersistError",
    "ResidencyError",
    "ShardingError",
    "ResidentServer",
    "TieredResidentServer",
    "ShardedResidentServer",
    "PipelinedIngest",
    "recover_server",
    "open_server",
    "recover_sharded_server",
    "obs",
    "sync",
    "SyncServer",
    "Session",
    "FanIn",
    "ReadBatcher",
    "PresencePlane",
    "SyncError",
    "PushRejected",
    "StaleFrontier",
    "SessionClosed",
    "net",
    "NetServer",
    "NetClient",
    "NetError",
    "NetProtocolError",
    "replication",
    "Follower",
    "ShardedFollower",
    "ReadOnlySyncServer",
    "ReplicationError",
    "NotLeader",
    "FencedLeader",
    "StaleFollower",
    "ReplicaLag",
    "LoroDoc",
    "LoroError",
    "DecodeError",
    "RedactError",
    "redact_json_updates",
    "ExportMode",
    "EncodeMode",
    "ImportStatus",
    "ContainerID",
    "ContainerType",
    "ID",
    "IdSpan",
    "TreeID",
    "Frontiers",
    "VersionVector",
    "VersionRange",
    "Change",
    "Op",
    "Side",
    "Delta",
    "Retain",
    "Insert",
    "Delete",
    "MapDiff",
    "TreeDiff",
    "TreeDiffAction",
    "TreeDiffItem",
    "CounterDiff",
    "DocDiff",
    "ContainerDiff",
    "EventTriggerKind",
    "TextHandler",
    "ListHandler",
    "MapHandler",
    "MovableListHandler",
    "TreeHandler",
    "CounterHandler",
    "Handler",
    "UndoManager",
    "Cursor",
    "CursorSide",
    "AbsolutePosition",
    "get_cursor",
    "get_cursor_pos",
    "Awareness",
    "EphemeralStore",
]
