"""LoroDoc: the document runtime.

reference: crates/loro-internal/src/loro.rs (import/export dispatch,
checkout, fork) + crates/loro/src/lib.rs (public API).  A doc owns an
OpLog (history), a DocState (materialized state), an Observer, and the
single active transaction slot (reference lib.rs:142-172).
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .codec import json_schema as jcodec
from .config import Configure
from .core.change import Change
from .core.ids import ContainerID, ContainerType, ID, IdSpan, PeerID
from .core.version import Frontiers, VersionRange, VersionVector
from .event import (
    ContainerDiff,
    DocDiff,
    EventTriggerKind,
    MapDiff,
    Observer,
)
from .models.handlers import (
    CounterHandler,
    Handler,
    ListHandler,
    MapHandler,
    MovableListHandler,
    TextHandler,
    TreeHandler,
    make_handler,
)
from .obs import metrics as obs
from .oplog.oplog import OpLog
from .state import DocState, compose_many
from .txn import Transaction
from .utils import tracing

MAGIC = b"LTPU"
# v2: snapshot history section became BlockStore blocks; snapshot state
# sections zlib-compressed (change_store.py).  Update payloads are
# layout-identical across v1/v2, so update blobs are stamped with the
# lowest version that can read them (mixed-version interop).
FORMAT_VERSION = 2
ENVELOPE_LEN = 10  # MAGIC + version + mode + crc32


def _min_version_for_mode(mode: "EncodeMode") -> int:
    if mode in (
        EncodeMode.FastSnapshot,
        EncodeMode.ShallowSnapshot,
        EncodeMode.StateOnly,
    ):
        return 2
    return 1


class EncodeMode(Enum):
    JsonUpdates = 1
    JsonSnapshot = 2
    ColumnarUpdates = 3
    ColumnarSnapshot = 4
    ShallowSnapshot = 5
    FastSnapshot = 6
    StateOnly = 7


def frame_columnar_updates(changes) -> bytes:
    """Frame an export-ordered change list as the columnar-updates wire
    envelope — the exact bytes ``export(ExportMode.Updates)`` ships.
    Module-level so the read plane (rows selected by
    ``ops/export_batch.py``) frames device-selected changes through the
    SAME code path the per-doc export uses: byte-identity by
    construction, not by parallel implementation."""
    from .codec import binary as bcodec

    payload = bcodec.encode_changes(changes)
    crc = zlib.crc32(payload)
    mode = EncodeMode.ColumnarUpdates
    return (
        MAGIC
        + bytes([_min_version_for_mode(mode), mode.value])
        + crc.to_bytes(4, "little")
        + payload
    )


class ExportMode:
    """reference: encoding.rs ExportMode."""

    class Snapshot:
        pass

    @dataclass
    class Updates:
        from_vv: Optional[VersionVector] = None

    @dataclass
    class UpdatesInRange:
        from_vv: VersionVector
        to_vv: VersionVector

    @dataclass
    class ShallowSnapshot:
        frontiers: Frontiers

    @dataclass
    class SnapshotAt:
        frontiers: Frontiers

    class StateOnly:
        pass


@dataclass
class ImportStatus:
    """reference: encoding.rs:227 ImportStatus."""

    success: VersionRange
    pending: Optional[VersionRange]


from .errors import DecodeError, LoroError  # noqa: E402  (re-export; defined in errors.py to avoid import cycles)


class LoroDoc:
    def __init__(self, peer: Optional[PeerID] = None):
        self.peer: PeerID = peer if peer is not None else random.getrandbits(63)
        self.oplog = OpLog()
        self.state = DocState()
        self.observer = Observer()
        self.config = Configure()
        self.oplog.config = self.config
        self._txn: Optional[Transaction] = None
        self._detached = False
        # (state bytes, vv, frontiers) of the frozen shallow-history root
        # (reference: GcStore, container_store.rs:58) — replay floor for
        # checkout/diff on shallow docs
        self._shallow_base: Optional[Tuple[bytes, VersionVector, Frontiers]] = None
        from .history_cache import StateCheckpointCache

        self._state_cache = StateCheckpointCache()
        self._local_update_subs: List[Callable[[bytes], None]] = []
        self._peer_id_change_subs: List[Callable[[PeerID], None]] = []
        self._pre_commit_subs: List[Callable[["Transaction"], None]] = []
        self._first_commit_from_peer_subs: List[Callable[[PeerID], None]] = []
        self._seen_peers: set = set()

    # ------------------------------------------------------------------
    # identity & mode
    # ------------------------------------------------------------------
    def set_peer_id(self, peer: PeerID) -> None:
        if self._txn is not None and not self._txn.is_empty():
            raise LoroError("cannot change peer id with uncommitted ops")
        self.peer = peer
        for cb in self._peer_id_change_subs:
            cb(peer)

    @property
    def peer_id(self) -> PeerID:
        """reference: LoroDoc::peer_id."""
        return self.peer

    def is_detached(self) -> bool:
        return self._detached

    def set_detached_editing(self, enable: bool) -> None:
        """Allow edits while detached: commits extend the checked-out
        branch instead of raising (reference:
        LoroDoc::set_detached_editing; new branch gets a fresh peer id
        in the reference — here the peer id is kept, which is safe
        because counters continue from the branch head)."""
        self.config.editable_detached_mode = enable

    def is_detached_editing_enabled(self) -> bool:
        return self.config.editable_detached_mode

    def detach(self) -> None:
        self._barrier()
        self._detached = True

    def attach(self) -> None:
        self.checkout_to_latest()

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------
    def get_text(self, name: str) -> TextHandler:
        return TextHandler(self, ContainerID.root(name, ContainerType.Text))

    def get_list(self, name: str) -> ListHandler:
        return ListHandler(self, ContainerID.root(name, ContainerType.List))

    def get_map(self, name: str) -> MapHandler:
        return MapHandler(self, ContainerID.root(name, ContainerType.Map))

    def get_movable_list(self, name: str) -> MovableListHandler:
        return MovableListHandler(self, ContainerID.root(name, ContainerType.MovableList))

    def get_tree(self, name: str) -> TreeHandler:
        return TreeHandler(self, ContainerID.root(name, ContainerType.Tree))

    def get_counter(self, name: str) -> CounterHandler:
        return CounterHandler(self, ContainerID.root(name, ContainerType.Counter))

    def get_container(self, cid: Union[ContainerID, str]) -> Handler:
        if isinstance(cid, str):
            cid = ContainerID.parse(cid)
        return make_handler(self, cid)

    def _try_get(self, name: str, ctype: ContainerType) -> Optional[Handler]:
        """Handler for an EXISTING container of the right type, else
        None (reference: LoroDoc::try_get_text & co — the safe variants
        that neither create roots nor assert the type)."""
        cid = ContainerID.root(name, ctype) if isinstance(name, str) else name
        if cid.ctype != ctype or cid not in self.state.states:
            return None
        return make_handler(self, cid)

    def try_get_text(self, name: str) -> Optional[TextHandler]:
        return self._try_get(name, ContainerType.Text)  # type: ignore[return-value]

    def try_get_list(self, name: str) -> Optional[ListHandler]:
        return self._try_get(name, ContainerType.List)  # type: ignore[return-value]

    def try_get_map(self, name: str) -> Optional[MapHandler]:
        return self._try_get(name, ContainerType.Map)  # type: ignore[return-value]

    def try_get_movable_list(self, name: str) -> Optional[MovableListHandler]:
        return self._try_get(name, ContainerType.MovableList)  # type: ignore[return-value]

    def try_get_tree(self, name: str) -> Optional[TreeHandler]:
        return self._try_get(name, ContainerType.Tree)  # type: ignore[return-value]

    def try_get_counter(self, name: str) -> Optional[CounterHandler]:
        return self._try_get(name, ContainerType.Counter)  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # transactions
    # ------------------------------------------------------------------
    def _txn_apply(self, cid: ContainerID, content) -> int:
        if self._detached and not self.config.editable_detached_mode:
            raise LoroError("doc is detached; checkout_to_latest() or enable editable_detached_mode")
        if self._txn is None:
            self._txn = Transaction(self)
        return self._txn.apply(cid, content)

    def _barrier(self) -> None:
        """Implicit commit (reference: with_barrier): finalize pending
        work, but an EMPTY implicit commit preserves next-commit options
        for the next real commit — unlike an explicit empty commit(),
        which swallows them."""
        txn = self._txn
        if txn is None or txn.is_empty():
            self._txn = None
            return
        self.commit()

    def commit(self, origin: str = "", message: Optional[str] = None) -> None:
        """Commit the implicit transaction (reference: txn.rs:426).
        An explicit empty commit swallows pending next-commit options
        (reference: explicit_empty_commit_swallow_options)."""
        txn = self._txn
        if txn is None or txn.is_empty():
            self._txn = None
            self.clear_next_commit_options()
            return
        pend_msg = getattr(self, "_next_commit_message", None)
        pend_origin = getattr(self, "_next_commit_origin", None)
        pend_ts = getattr(self, "_next_commit_timestamp", None)
        self._next_commit_message = None
        self._next_commit_origin = None
        self._next_commit_timestamp = None
        if message is not None:
            txn.message = message
        elif pend_msg is not None and txn.message is None:
            txn.message = pend_msg
        if not origin and pend_origin:
            origin = pend_origin
        if pend_ts is not None and txn.timestamp_override is None:
            txn.timestamp_override = pend_ts
        for cb in self._pre_commit_subs:
            cb(txn)
        change = txn.build_change()
        assert change is not None
        self._txn = None
        self.oplog.import_local_change(change)
        self.state.vv.extend_to_include(change.id_span())
        if self._detached:
            # stay on the branch: state head is this change, not the
            # merged oplog frontiers
            self.state.frontiers = Frontiers([change.last_id()])
        else:
            self.state.frontiers = self.oplog.frontiers
        if change.peer not in self._seen_peers:
            self._seen_peers.add(change.peer)
            for cb in self._first_commit_from_peer_subs:
                cb(change.peer)
        # events
        if self.observer.has_subscribers() and txn.diffs:
            self._emit(txn.diffs, origin or txn.origin, EventTriggerKind.Local, txn.start_frontiers)
        # local update push (reference: txn.rs:78-90 subscribe_local_update)
        if self._local_update_subs:
            payload = self._encode_changes([change], EncodeMode.ColumnarUpdates)
            for cb in self._local_update_subs:
                cb(payload)

    # ------------------------------------------------------------------
    # events
    # ------------------------------------------------------------------
    def _emit(
        self,
        diffs: Dict[ContainerID, List],
        origin: str,
        by: EventTriggerKind,
        from_frontiers: Frontiers,
    ) -> None:
        cds: List[ContainerDiff] = []
        for cid, lst in diffs.items():
            if not lst:
                continue
            d = compose_many(lst)
            if hasattr(d, "is_empty") and d.is_empty():
                continue
            cds.append(ContainerDiff(cid, self.state.path_of(cid), d))
        if not cds:
            return
        cds.sort(key=lambda cd: (self.state.depth_of(cd.id), cd.path))
        self.observer.emit(DocDiff(origin, by, from_frontiers, self.state.frontiers, cds))

    def subscribe(self, cid: ContainerID, cb) -> Callable[[], None]:
        return self.observer.subscribe(cid, cb)

    def subscribe_root(self, cb) -> Callable[[], None]:
        return self.observer.subscribe_root(cb)

    def subscribe_local_update(self, cb: Callable[[bytes], None]) -> Callable[[], None]:
        self._local_update_subs.append(cb)
        return lambda: self._local_update_subs.remove(cb)

    def subscribe_peer_id_change(self, cb: Callable[[PeerID], None]) -> Callable[[], None]:
        self._peer_id_change_subs.append(cb)
        return lambda: self._peer_id_change_subs.remove(cb)

    def subscribe_pre_commit(self, cb) -> Callable[[], None]:
        self._pre_commit_subs.append(cb)
        return lambda: self._pre_commit_subs.remove(cb)

    def subscribe_first_commit_from_peer(self, cb) -> Callable[[], None]:
        self._first_commit_from_peer_subs.append(cb)
        return lambda: self._first_commit_from_peer_subs.remove(cb)

    # ------------------------------------------------------------------
    # import / export
    # ------------------------------------------------------------------
    def export(self, mode=None) -> bytes:
        """Export per ExportMode (reference: loro.rs:2096 dispatch)."""
        mode_name = (
            getattr(mode, "__name__", None)
            or (type(mode).__name__ if mode is not None else "Snapshot")
        )
        tracing.instant("doc.export", mode=mode_name)
        data = self._export_dispatch(mode)
        obs.counter("doc.export_calls_total").inc(mode=mode_name)
        obs.counter("doc.export_bytes_total").inc(len(data), mode=mode_name)
        return data

    def _export_dispatch(self, mode) -> bytes:
        self._barrier()
        if mode is None or isinstance(mode, ExportMode.Snapshot) or mode is ExportMode.Snapshot:
            return self._export_fast_snapshot()
        if isinstance(mode, ExportMode.Updates):
            vv = mode.from_vv or VersionVector()
            return self._encode_changes(
                self.oplog.changes_since(vv), EncodeMode.ColumnarUpdates, vv
            )
        if isinstance(mode, ExportMode.UpdatesInRange):
            chs = self.oplog.changes_between(mode.from_vv, mode.to_vv)
            return self._encode_changes(chs, EncodeMode.ColumnarUpdates, mode.from_vv)
        if isinstance(mode, ExportMode.SnapshotAt):
            if self._shallow_base is not None:
                # history below the root is gone: ship base + ops <= f
                return self._export_shallow(
                    self.oplog.dag.shallow_since_frontiers, with_updates=True, to_f=mode.frontiers
                )
            to_vv = self.oplog.dag.frontiers_to_vv(mode.frontiers)
            chs = self.oplog.changes_between(self.oplog.dag.shallow_since_vv, to_vv)
            return self._encode_changes(chs, EncodeMode.ColumnarSnapshot)
        if isinstance(mode, ExportMode.ShallowSnapshot):
            return self._export_shallow(mode.frontiers, with_updates=True)
        if mode is ExportMode.StateOnly or isinstance(mode, ExportMode.StateOnly):
            return self._export_shallow(self.oplog.frontiers, with_updates=False)
        raise LoroError(f"unsupported export mode {mode}")

    def _export_fast_snapshot(self) -> bytes:
        """[varint oplog_len][oplog changes][varint state_len][doc state]
        (reference layout: fast_snapshot.rs:1-15).  The encoded state is
        always the state at the oplog head — detached docs materialize
        it by replay from the floor (so shallow bases are never lost)."""
        import json as _json

        from .codec import binary as bcodec
        from .codec import snapshot as scodec
        from .codec.binary import Writer

        if self.state.frontiers == self.oplog.frontiers:
            head_state = self.state
        else:
            head_state = self._state_at(self.oplog.frontiers)
        w = Writer()
        # history ships as compressed change blocks (clean cold peers
        # pass through without decode or re-encode — change_store.py)
        oplog_bytes = self.oplog.export_block_store().encode()
        state_bytes = zlib.compress(
            scodec.encode_doc_state(head_state, head_state.parents), 6
        )
        w.bytes_(oplog_bytes)
        w.bytes_(state_bytes)
        # shallow-root carry-over so a fast snapshot of a shallow doc
        # keeps its replay floor
        if self._shallow_base is not None:
            base_bytes, base_vv, base_f = self._shallow_base
            w.u8(1)
            w.bytes_(base_bytes)
            w.str_(_json.dumps(base_vv.to_json()))
            w.str_(_json.dumps(base_f.to_json()))
        else:
            w.u8(0)
        payload = bytes(w.buf)
        crc = zlib.crc32(payload)
        return (
            MAGIC
            + bytes([_min_version_for_mode(EncodeMode.FastSnapshot), EncodeMode.FastSnapshot.value])
            + crc.to_bytes(4, "little")
            + payload
        )

    def _export_shallow(
        self, frontiers: Frontiers, with_updates: bool, to_f: Optional[Frontiers] = None
    ) -> bytes:
        """Frozen state at `frontiers` + (optionally) the ops after it,
        up to `to_f` (default: everything).
        reference: shallow_snapshot.rs:22."""
        import json as _json

        from .codec import binary as bcodec
        from .codec import snapshot as scodec
        from .codec.binary import Writer

        base_vv = self.oplog.dag.frontiers_to_vv(frontiers)
        if not (self.oplog.dag.shallow_since_vv <= base_vv):
            raise LoroError("shallow snapshot frontiers below this doc's shallow root")
        if frontiers == self.state.frontiers:
            base_state = self.state  # export() committed; live state reusable
        else:
            base_state = self._state_at(frontiers)
        state_bytes = zlib.compress(
            scodec.encode_doc_state(base_state, base_state.parents), 6
        )
        w = Writer()
        w.bytes_(state_bytes)
        w.str_(_json.dumps(base_vv.to_json()))
        w.str_(_json.dumps(frontiers.to_json()))
        if with_updates:
            to_vv = self.oplog.vv if to_f is None else self.oplog.dag.frontiers_to_vv(to_f)
            chs = self.oplog.changes_between(base_vv, to_vv)
            w.bytes_(bcodec.encode_changes(chs))
        else:
            w.bytes_(b"")
        payload = bytes(w.buf)
        crc = zlib.crc32(payload)
        mode = EncodeMode.ShallowSnapshot if with_updates else EncodeMode.StateOnly
        return MAGIC + bytes([_min_version_for_mode(mode), mode.value]) + crc.to_bytes(4, "little") + payload

    def export_snapshot(self) -> bytes:
        return self.export(ExportMode.Snapshot)

    def export_updates(self, from_vv: Optional[VersionVector] = None) -> bytes:
        return self.export(ExportMode.Updates(from_vv))

    def _encode_changes(
        self, changes: List[Change], mode: EncodeMode, start_vv: Optional[VersionVector] = None
    ) -> bytes:
        if mode is EncodeMode.ColumnarUpdates:
            return frame_columnar_updates(changes)
        if mode is EncodeMode.ColumnarSnapshot:
            from .codec import binary as bcodec

            payload = bcodec.encode_changes(changes)
        else:
            payload = jcodec.dumps(
                jcodec.export_json_updates(
                    changes, start_vv or VersionVector(), self.oplog.vv.copy()
                )
            )
        crc = zlib.crc32(payload)
        header = MAGIC + bytes([_min_version_for_mode(mode), mode.value]) + crc.to_bytes(4, "little")
        return header + payload

    @classmethod
    def from_snapshot(cls, data: bytes) -> "LoroDoc":
        """Construct a fresh doc from snapshot bytes (reference:
        LoroDoc::from_snapshot)."""
        doc = cls()
        doc.import_(data, origin="from_snapshot")
        return doc

    def import_with(self, data: bytes, origin: str = "import") -> ImportStatus:
        """reference: LoroDoc::import_with (origin-tagged import)."""
        return self.import_(data, origin)

    def import_(self, data: bytes, origin: str = "import") -> ImportStatus:
        """reference: loro.rs:568 LoroDoc::import (header parse + mode
        dispatch, loro.rs:584-649)."""
        obs.counter("doc.import_calls_total").inc()
        obs.counter("doc.import_bytes_total").inc(len(data))
        with tracing.span("doc.import", bytes=len(data)):
            self._barrier()
            mode, payload = self._parse_envelope(data)
            if mode == EncodeMode.FastSnapshot:
                return self._import_fast_snapshot(payload, origin)
            if mode in (EncodeMode.ShallowSnapshot, EncodeMode.StateOnly):
                return self._import_shallow(payload, origin)
            with tracing.span("decode", mode=mode.name):
                changes = self._decode_changes(mode, payload)
            return self._import_changes(changes, origin)

    import_bytes = import_

    def import_batch(self, blobs: Sequence[bytes], origin: str = "import") -> ImportStatus:
        """Import several update blobs atomically-ish (reference:
        loro.rs import_batch): decode everything first, then apply as
        one causally-sorted set so cross-blob dependencies resolve in
        one pass."""
        self._barrier()
        all_changes: List[Change] = []
        snapshots: List[bytes] = []
        for blob in blobs:
            mode, payload = self._parse_envelope(blob)
            if mode in (
                EncodeMode.FastSnapshot,
                EncodeMode.ShallowSnapshot,
                EncodeMode.StateOnly,
            ):
                snapshots.append(blob)
            else:
                all_changes.extend(self._decode_changes(mode, payload))
        success = VersionRange()
        pending: Optional[VersionRange] = None

        def fold(st: ImportStatus) -> None:
            nonlocal pending
            for p, (s, e) in st.success.items():
                success.extend_to_include(IdSpan(p, s, e))
            if st.pending is not None:
                if pending is None:
                    pending = VersionRange()
                for p, (s, e) in st.pending.items():
                    pending.extend_to_include(IdSpan(p, s, e))

        for blob in snapshots:
            fold(self.import_(blob, origin))
        if all_changes or (not snapshots):
            fold(self._import_changes(all_changes, origin))
        return ImportStatus(success, pending)

    def _parse_envelope(self, data: bytes) -> Tuple[EncodeMode, bytes]:
        _version, mode, payload = parse_envelope_header(data)
        return mode, payload

    def _decode_changes(self, mode: EncodeMode, payload: bytes) -> List[Change]:
        if mode in (EncodeMode.JsonUpdates, EncodeMode.JsonSnapshot):
            try:
                return jcodec.import_json_updates(jcodec.loads(payload))
            except (KeyError, ValueError, TypeError) as e:
                raise DecodeError(f"malformed payload: {e}") from e
        if mode in (EncodeMode.ColumnarUpdates, EncodeMode.ColumnarSnapshot):
            from .codec import binary as bcodec

            try:
                return bcodec.decode_changes(payload)
            except Exception as e:
                raise DecodeError(f"malformed columnar payload: {e}") from e
        raise DecodeError(f"unsupported mode {mode}")

    def _import_fast_snapshot(self, payload: bytes, origin: str) -> ImportStatus:
        """Empty doc: install oplog + state bytes directly (no replay —
        the point of the fast format, fast_snapshot.rs:27).  Non-empty
        doc: fall back to importing the embedded changes."""
        from .codec import binary as bcodec
        from .codec import snapshot as scodec
        from .codec.binary import Reader

        import json as _json

        from .oplog.change_store import BlockStore

        try:
            r = Reader(payload)
            oplog_bytes = r.bytes_()
            state_bytes = zlib.decompress(r.bytes_())
            has_base = bool(r.u8())
            base = None
            if has_base:
                bb = r.bytes_()
                bvv = VersionVector.from_json(_json.loads(r.str_()))
                bf = Frontiers.from_json(_json.loads(r.str_()))
                base = (bb, bvv, bf)
            store = BlockStore.decode(oplog_bytes)
        except DecodeError:
            raise
        except Exception as e:
            raise DecodeError(f"malformed fast snapshot: {e}") from e
        if not self.oplog.is_empty() or self.state.states:
            if base is not None:
                # retained changes alone are useless without the base
                raise LoroError(
                    "snapshot carries a shallow base; import it into an empty doc"
                )
            changes = [
                ch for p in store.peers() for ch in store.changes_for_peer(p)
            ]
            return self._import_changes(changes, origin)
        try:
            if base is not None:
                self._install_shallow_base(*base)
            try:
                states, parents = scodec.decode_doc_state(state_bytes)
            except Exception as e:
                raise DecodeError(f"malformed snapshot state: {e}") from e
            # lazy attach: dag/vv come from block metas; op payloads
            # decode per peer only when replay/diff/export needs them
            self.oplog.attach_cold_store(store)
        except DecodeError:
            self._reset_to_empty()
            raise
        self.state.states = states
        self.state.parents.update(parents)
        self.state.vv = self.oplog.vv.copy()
        self.state.frontiers = self.oplog.frontiers
        self._emit_state_install_event(origin)
        status = VersionRange()
        for peer in self.oplog.vv:
            lo = 0
            if base is not None:
                lo = base[1].get(peer)
            hi = self.oplog.vv.get(peer)
            if hi > lo:
                status.extend_to_include(IdSpan(peer, lo, hi))
        return ImportStatus(status, None)

    def _validate_planned(self, inserts: List[Change]) -> None:
        """Semantic integrity gate between decode and commit: every
        sequence/movable op reference must resolve against the known
        element ids (state tables keep tombstones, so an attached
        state's by_id is the full element history) or ids created
        earlier in this batch; delete spans must be sane.  A corrupt
        payload whose deps lie fails HERE, typed, with nothing mutated
        (reference: the random_import fuzz contract + oplog rollback)."""
        from .core.change import (
            CounterIncr,
            MapSet,
            MovableMove,
            MovableSet,
            SeqDelete,
            SeqInsert,
            StyleAnchor,
            TreeMove,
        )

        allowed_kinds = {
            ContainerType.Map: (MapSet,),
            ContainerType.Text: (SeqInsert, SeqDelete),
            ContainerType.List: (SeqInsert, SeqDelete),
            ContainerType.MovableList: (SeqInsert, SeqDelete, MovableSet, MovableMove),
            ContainerType.Tree: (TreeMove,),
            ContainerType.Counter: (CounterIncr,),
        }
        attached = not self._detached
        # ids created by THIS batch, per container (small); existing ids
        # are probed directly against the live state dicts — no O(doc)
        # set materialization on the import hot path
        batch_ids: Dict[ContainerID, set] = {}
        detached_extra: Dict[ContainerID, set] = {}

        def known_ids(cid: ContainerID) -> set:
            s_ = batch_ids.get(cid)
            if s_ is None:
                s_ = batch_ids[cid] = set()
            return s_

        def detached_ids(cid: ContainerID) -> set:
            """Element ids for `cid` over the FULL history — only built
            when the doc is detached (state lags the oplog) and a probe
            missed; cached per import."""
            s_ = detached_extra.get(cid)
            if s_ is None:
                s_ = set()
                for ch in self.oplog.changes_in_causal_order():
                    for op in ch.ops:
                        if op.container != cid:
                            continue
                        c = op.content
                        if isinstance(c, SeqInsert):
                            n_b = 1 if isinstance(c.content, StyleAnchor) else len(c.content)
                            for j in range(n_b):
                                s_.add((ch.peer, op.counter + j))
                        elif isinstance(c, MovableMove):
                            s_.add((ch.peer, op.counter))
                detached_extra[cid] = s_
            return s_

        def resolvable(cid: ContainerID, key: Tuple[int, int]) -> bool:
            if key in known_ids(cid):
                return True
            st = self.state.states.get(cid)
            if st is not None:
                seq = getattr(st, "seq", None)
                if seq is not None and key in seq.by_id:
                    return True
                elems = getattr(st, "elems", None)
                if elems is not None and ID(key[0], key[1]) in elems:
                    return True
            if not attached:
                # detached state lags the oplog: check the history
                # itself, per container (precise; built lazily)
                return key in detached_ids(cid)
            return False

        total_atoms = self.oplog.total_ops() + sum(ch.atom_len() for ch in inserts)
        for ch in inserts:
            for op in ch.ops:
                c = op.content
                ok_kinds = allowed_kinds.get(op.container.ctype)
                if ok_kinds is not None and not isinstance(c, ok_kinds):
                    # UnknownContent is only legal on Unknown containers
                    raise DecodeError(
                        f"op kind {type(c).__name__} not valid for "
                        f"{op.container.ctype.name} container (corrupt payload?)"
                    )
                if (
                    isinstance(c, SeqInsert)
                    and isinstance(c.content, StyleAnchor)
                    and op.container.ctype != ContainerType.Text
                ):
                    raise DecodeError(
                        "style anchor outside a Text container (corrupt payload?)"
                    )
                if isinstance(c, SeqInsert):
                    self._check_placement(op.container, ch.peer, op.counter, c.parent, c.side, resolvable)
                    if op.container.ctype == ContainerType.Text:
                        body_ok = isinstance(c.content, StyleAnchor) or (
                            isinstance(c.content, str)
                        )
                        if not body_ok:
                            raise DecodeError(
                                "non-text content in a Text container "
                                "(corrupt payload?)"
                            )
                    n_body = 1 if isinstance(c.content, StyleAnchor) else len(c.content)
                    ids = known_ids(op.container)
                    for j in range(n_body):
                        ids.add((ch.peer, op.counter + j))
                elif isinstance(c, SeqDelete):
                    for sp in c.spans:
                        if sp.end - sp.start > total_atoms or sp.end < sp.start:
                            raise DecodeError(
                                f"delete span of {sp.end - sp.start} atoms exceeds "
                                f"total history ({total_atoms}) — corrupt payload?"
                            )
                elif isinstance(c, (MovableSet, MovableMove)):
                    e = c.elem
                    if not resolvable(op.container, (e.peer, e.counter)):
                        raise DecodeError(
                            f"movable op references unknown element {e} "
                            "(corrupt payload?)"
                        )
                    if isinstance(c, MovableMove):
                        # a move creates a new position slot placed like
                        # an insert: validate its Fugue parent too
                        self._check_placement(
                            op.container, ch.peer, op.counter, c.parent, c.side, resolvable
                        )
                        known_ids(op.container).add((ch.peer, op.counter))

    @staticmethod
    def _check_placement(cid, peer, counter, parent, side, resolvable) -> None:
        from .core.change import Side
        from .oplog.oplog import _RunCont

        if isinstance(parent, _RunCont):
            if not resolvable(cid, (peer, counter - 1)):
                raise DecodeError(
                    f"run continuation at {peer}:{counter} has no preceding "
                    "element (corrupt payload?)"
                )
        elif parent is not None:
            if not resolvable(cid, (parent.peer, parent.counter)):
                raise DecodeError(
                    f"placement parent {parent} not a known element "
                    "(corrupt payload?)"
                )
        elif side == Side.Left:
            raise DecodeError("root placement must be right-side (corrupt payload?)")

    def _emit_state_install_event(self, origin: str) -> None:
        """Subscribers registered before a snapshot import still need to
        see the content: emit empty->state diffs for every container."""
        if not self.observer.has_subscribers():
            return
        diffs = {}
        for cid, st in self.state.states.items():
            d = st.to_diff()
            if not (hasattr(d, "is_empty") and d.is_empty()):
                diffs[cid] = [d]
        if diffs:
            self._emit(diffs, origin, EventTriggerKind.Import, Frontiers())

    def _import_shallow(self, payload: bytes, origin: str) -> ImportStatus:
        """Install a frozen base state + retained ops into an empty doc.
        reference: shallow snapshot import semantics."""
        import json as _json

        from .codec import binary as bcodec
        from .codec import snapshot as scodec
        from .codec.binary import Reader

        try:
            r = Reader(payload)
            state_bytes = r.bytes_()
            base_vv = VersionVector.from_json(_json.loads(r.str_()))
            base_f = Frontiers.from_json(_json.loads(r.str_()))
            updates = r.bytes_()
            changes = bcodec.decode_changes(updates) if updates else []
        except Exception as e:
            raise DecodeError(f"malformed shallow snapshot: {e}") from e
        if not self.oplog.is_empty() or self.state.states:
            # non-empty doc: usable iff our history already covers the
            # frozen base — then the retained ops import as plain
            # updates and the base is redundant (reference:
            # should_import_snapshot_before_shallow semantics)
            if base_vv <= self.oplog.vv:
                return self._import_changes(changes, origin)
            raise LoroError(
                "shallow snapshot into a non-empty doc requires the doc "
                "to already contain the history below the shallow root"
            )
        try:
            self._install_shallow_base(state_bytes, base_vv, base_f)
            try:
                states, parents = _decode_state_z(state_bytes)
            except Exception as e:
                raise DecodeError(f"malformed snapshot state: {e}") from e
            self.state.states = states
            self.state.parents.update(parents)
            self.state.vv = base_vv.copy()
            self.state.frontiers = base_f
            if changes:
                # validate BEFORE announcing anything to subscribers so
                # a corrupt retained-changes section leaves no trace
                plan = self.oplog.plan_import(changes)
                self._validate_planned(plan.inserts)
        except DecodeError:
            self._reset_to_empty()
            raise
        self._emit_state_install_event(origin)
        if changes:
            return self._import_changes(changes, origin)
        return ImportStatus(VersionRange(), None)

    def _reset_to_empty(self) -> None:
        """Roll a failed snapshot install back to the pristine empty
        doc (the import paths that install state require emptiness, so
        a full reset IS the rollback)."""
        self.oplog = OpLog()
        self.oplog.config = self.config
        self.state = DocState()
        self._shallow_base = None
        self._detached = False
        self._state_cache.clear()

    def _install_shallow_base(self, state_bytes: bytes, vv: VersionVector, f: Frontiers) -> None:
        self._shallow_base = (state_bytes, vv.copy(), f)
        self.oplog.dag.set_shallow_root(vv, f)

    def _import_changes(self, changes: List[Change], origin: str) -> ImportStatus:
        backfill = (
            self.oplog.plan_backfill(changes) if self._shallow_base is not None else None
        )
        with tracing.span("oplog.import", n_changes=len(changes)):
            plan = self.oplog.plan_import(changes)
            self._validate_planned(plan.inserts)
            # everything validated: commit the shallow upgrade first
            # (pre-floor splice), then the regular inserts — a failure
            # above leaves oplog, dag, and shallow root untouched
            if backfill is not None:
                self.oplog.commit_backfill(backfill)
                self._shallow_base = None
            applied, pending = self.oplog.commit_import(plan)
        obs.counter("oplog.changes_applied_total").inc(len(applied))
        obs.counter("oplog.ops_applied_total").inc(
            sum(len(ch.ops) for ch in applied)
        )
        # gauge, not counter: the parked backlog is cumulative state
        # carried across imports — a counter would re-add the whole
        # backlog every round and grow without any new parks
        obs.gauge("oplog.changes_pending").set(
            sum(len(v) for v in self.oplog.pending.by_missing.values())
        )
        success = VersionRange()
        for ch in applied:
            success.extend_to_include(ch.id_span())
        if applied and not self._detached:
            record = self.observer.has_subscribers()
            from_f = self.state.frontiers
            with tracing.span("state.apply", n_changes=len(applied)):
                diffs = self.state.apply_changes(applied, record=record)
            self.state.frontiers = self.oplog.frontiers
            if record and diffs:
                self._emit(diffs, origin, EventTriggerKind.Import, from_f)
            else:
                self.state.frontiers = self.oplog.frontiers
        return ImportStatus(success, pending if not pending.is_empty() else None)

    def import_json_updates(self, json_obj) -> ImportStatus:
        """reference: loro.rs:873 import_json_updates."""
        if isinstance(json_obj, (str, bytes)):
            import json as _json

            json_obj = _json.loads(json_obj)
        return self._import_changes(jcodec.import_json_updates(json_obj), "import")

    def export_json_updates(
        self, start_vv: Optional[VersionVector] = None, end_vv: Optional[VersionVector] = None
    ):
        self._barrier()
        start_vv = start_vv or VersionVector()
        end_vv = end_vv or self.oplog.vv.copy()
        chs = self.oplog.changes_between(start_vv, end_vv)
        return jcodec.export_json_updates(chs, start_vv, end_vv)

    def export_json_updates_without_peer_compression(
        self, start_vv: Optional[VersionVector] = None, end_vv: Optional[VersionVector] = None
    ):
        """reference: loro.rs export_json_updates_without_peer_compression.
        This JSON codec never peer-compresses (ids are spelled out per
        change), so both exports coincide."""
        return self.export_json_updates(start_vv, end_vv)

    # ------------------------------------------------------------------
    # versions
    # ------------------------------------------------------------------
    def oplog_vv(self) -> VersionVector:
        return self.oplog.vv.copy()

    def oplog_frontiers(self) -> Frontiers:
        return self.oplog.frontiers

    def state_vv(self) -> VersionVector:
        return self.state.vv.copy()

    def state_frontiers(self) -> Frontiers:
        return self.state.frontiers

    def vv_to_frontiers(self, vv: VersionVector) -> Frontiers:
        return self.oplog.dag.vv_to_frontiers(vv)

    def frontiers_to_vv(self, f: Frontiers) -> VersionVector:
        return self.oplog.dag.frontiers_to_vv(f)

    # ------------------------------------------------------------------
    # time travel
    # ------------------------------------------------------------------
    def checkout_to_latest(self) -> None:
        self._barrier()
        if not self._detached and self.state.frontiers == self.oplog.frontiers:
            return  # already attached at head (reference loro.rs:1543
            # early-returns and must not renew the peer id)
        self.checkout(self.oplog.frontiers)
        self._detached = False

    def checkout(self, frontiers: Frontiers) -> None:
        """reference: loro.rs:1625.  Sets detached mode unless the target
        is the latest version."""
        self._barrier()
        try:
            target_vv = self.oplog.dag.frontiers_to_vv(frontiers)
        except KeyError as e:
            raise LoroError(f"checkout target not in history (shallow/trimmed?): {e}") from e
        if self._shallow_base is not None and not (self.oplog.dag.shallow_since_vv <= target_vv):
            raise LoroError("cannot checkout below the shallow root")
        cur_vv = self.state.vv.copy()
        record = self.observer.has_subscribers()
        old_values = self._container_values() if record else None
        from_f = self.state.frontiers
        pre_state = self.state
        if cur_vv <= target_vv:
            chs = self.oplog.changes_between(cur_vv, target_vv)
            self.state.apply_changes(chs, record=False)
        else:
            # retreat: rebuild from the replay floor (empty or the
            # frozen shallow base) up to target_vv
            self.state = self._state_at(frontiers)
        self.state.vv = target_vv.copy()
        self.state.frontiers = frontiers
        # checkout always detaches (reference loro.rs:1625); only
        # checkout_to_latest re-attaches
        self._detached = True
        if self.config.editable_detached_mode:
            # a peer's ops must stay a counter prefix (VersionVector
            # representability); branch edits therefore need a fresh
            # peer id — same behavior as the reference's editable
            # detached mode
            self.set_peer_id(random.getrandbits(63))
        if record:
            diffs = self._value_level_diffs(old_values)
            for cid, d in self._seq_diff_batch(cur_vv, target_vv, (self.state, pre_state)).items():
                diffs[cid] = [d]
            if diffs:
                self._emit(diffs, "checkout", EventTriggerKind.Checkout, from_f)

    def _container_values(self) -> Dict[ContainerID, Any]:
        return {cid: st.get_value() for cid, st in self.state.states.items()}

    def _value_level_diffs(
        self, old_values: Dict[ContainerID, Any]
    ) -> Dict[ContainerID, List]:
        """Value-level diffs for map/counter; identity-bearing
        containers (sequences + tree) are handled by _seq_diff_batch."""
        new_values = self._container_values()
        batch = _diff_values(old_values, new_values, self.state)
        return {cid: [d] for cid, d in batch.items()}

    # ------------------------------------------------------------------
    # version diff / apply (reference: loro.rs:1244 diff, loro.rs:1302
    # apply_diff, loro.rs:1232 revert_to)
    # ------------------------------------------------------------------
    def _state_at(self, frontiers: Frontiers) -> DocState:
        return self._state_at_vv(self.oplog.dag.frontiers_to_vv(frontiers), frontiers)

    def _state_at_vv(self, vv: VersionVector, frontiers: Optional[Frontiers] = None) -> DocState:
        """Materialize a throwaway DocState at an arbitrary version by
        causal replay from the nearest floor: a cached checkpoint
        (history_cache.py — the reference's history_cache.rs analog),
        the frozen shallow base, or empty.  Shallow docs never replay
        below the base."""
        if self._shallow_base is not None:
            base_vv = self._shallow_base[1]
            if not (base_vv <= vv):
                raise LoroError("cannot materialize a version below the shallow root")
        cached = self._state_cache.best_floor(vv)
        if cached is not None:
            st, from_vv, _f = cached
        else:
            st = DocState()
            from_vv = VersionVector()
            if self._shallow_base is not None:
                base_bytes, base_vv, _ = self._shallow_base
                states, parents = _decode_state_z(base_bytes)
                st.states = states
                st.parents.update(parents)
                from_vv = base_vv
        chs = self.oplog.changes_between(from_vv, vv)
        m = len(chs)
        if m > 32:
            # long cold replay: drop a checkpoint ladder at halving gaps
            # approaching the target, so *receding* time travel (undo's
            # access pattern walks backwards step by step) always finds
            # a nearby floor on the next call
            marks = sorted({m - (m >> i) for i in range(1, 6) if (m >> i) >= 8})
            cur_vv = from_vv.copy()
            done = 0
            for mk in marks:
                st.apply_changes(chs[done:mk], record=False)
                for ch in chs[done:mk]:
                    if ch.ctr_end > cur_vv.get(ch.peer):
                        cur_vv.set_end(ch.peer, ch.ctr_end)
                done = mk
                self._state_cache.put(
                    cur_vv, self.oplog.dag.vv_to_frontiers(cur_vv), st
                )
            st.apply_changes(chs[done:], record=False)
        else:
            st.apply_changes(chs, record=False)
        st.vv = vv.copy()
        st.frontiers = frontiers if frontiers is not None else self.oplog.dag.vv_to_frontiers(vv)
        self._state_cache.put(st.vv, st.frontiers, st)
        return st

    def diff(self, a: Frontiers, b: Frontiers) -> Dict[ContainerID, Any]:
        """DiffBatch turning state(a) into state(b).  Sequence containers
        get EXACT deltas via element-identity visibility at each version
        (per-element deletion records); other containers diff by value.
        Endpoints equal to the live state reuse it instead of replaying
        the full history."""
        self._barrier()  # uncommitted ops would desync state vs frontiers
        va = self.oplog.dag.frontiers_to_vv(a)
        vb = self.oplog.dag.frontiers_to_vv(b)
        sa = self.state if a == self.state.frontiers else self._state_at(a)
        sb = self.state if b == self.state.frontiers else self._state_at(b)
        batch = _state_diff(sa, sb)
        batch.update(self._seq_diff_batch(va, vb, (self.state, sb, sa)))
        return batch

    def _seq_diff_batch(
        self, va: VersionVector, vb: VersionVector, candidates
    ) -> Dict[ContainerID, Any]:
        """Exact element-identity deltas for every sequence container,
        computed on whichever candidate state covers both versions (a
        union replay as the last resort).  Scans ALL sequence containers
        — identity changes with equal values still produce deltas."""
        union = va.join(vb)
        u_state = next((s for s in candidates if s is not None and union <= s.vv), None)
        if u_state is None:
            u_state = self._state_at_vv(union)
        out: Dict[ContainerID, Any] = {}
        for cid, st in u_state.states.items():
            if cid.ctype == ContainerType.Tree:
                d = st.delta_between(va, vb)
            elif cid.ctype == ContainerType.MovableList:
                d = st.delta_between(va, vb)
            elif cid.ctype == ContainerType.Text:
                # style-aware when the container ever carried anchors
                if getattr(st, "n_anchors", 0):
                    d = st.styled_delta_between(va, vb)
                else:
                    d = st.seq.delta_between(va, vb, as_text=True, vc=u_state.vv)
            elif cid.ctype == ContainerType.List:
                d = st.seq.delta_between(va, vb, as_text=False, vc=u_state.vv)
            else:
                continue
            if not d.is_empty():
                out[cid] = d
        return out

    def apply_diff(self, batch: Dict[ContainerID, Any], origin: str = "apply_diff") -> None:
        """Apply a DiffBatch as new local ops."""
        from .core.change import TreeMove
        from .event import CounterDiff as _CD
        from .event import Delta as _Delta
        from .event import MapDiff as _MD
        from .event import TreeDiff as _TD
        from .event import TreeDiffAction as _TDA
        from .event import Insert as _Ins
        from .event import Retain as _Ret

        for cid, d in batch.items():
            h = self.get_container(cid)
            if isinstance(d, _MD):
                for k, v in d.updated.items():
                    h.set(k, v)  # type: ignore[attr-defined]
                for k in d.deleted:
                    h.delete(k)  # type: ignore[attr-defined]
            elif isinstance(d, _CD):
                if d.delta:
                    h.increment(d.delta)  # type: ignore[attr-defined]
            elif isinstance(d, _Delta):
                pos = 0
                for it in d.items:
                    if isinstance(it, _Ret):
                        if it.attributes and hasattr(h, "mark"):
                            for k, v in it.attributes.items():
                                if v is None:
                                    h.unmark(pos, pos + it.n, k)
                                else:
                                    h.mark(pos, pos + it.n, k, v)
                        pos += it.n
                    elif isinstance(it, _Ins):
                        if isinstance(it.value, str):
                            h.insert(pos, it.value)  # type: ignore[call-arg]
                        else:
                            h.insert(pos, *it.value)  # type: ignore[call-arg]
                        if hasattr(h, "mark"):
                            # the diff's attributes are authoritative for
                            # the new text: neutralize styles inherited
                            # from surrounding live anchor pairs too
                            st = h._state
                            elem = st.seq.elem_at(pos)
                            inherited = (
                                st._styles_at_elem(elem)
                                if (st.n_anchors and elem is not None)
                                else {}
                            )
                            target = {
                                k: v
                                for k, v in (it.attributes or {}).items()
                                if v is not None
                            }
                            end = pos + len(it.value)
                            for k in set(inherited) | set(target):
                                tv = target.get(k)
                                if tv is None:
                                    h.unmark(pos, end, k)
                                elif inherited.get(k) != tv:
                                    h.mark(pos, end, k, tv)
                        pos += len(it.value)
                    else:
                        h.delete(pos, it.n)  # type: ignore[attr-defined]
            elif isinstance(d, _TD):
                for item in d.items:
                    try:
                        if item.action == _TDA.Delete:
                            h.delete(item.target)  # type: ignore[attr-defined]
                        elif item.action == _TDA.Create:
                            if not h.contains(item.target):  # type: ignore[attr-defined]
                                # re-creating a node keeps its identity: a
                                # move op revives it under the same TreeID
                                self._txn_apply(
                                    cid, TreeMove(item.target, item.parent, item.position)
                                )
                        else:
                            h.move(item.target, item.parent, item.index)  # type: ignore[attr-defined]
                    except (ValueError, LoroError):
                        continue  # target vanished concurrently
        # commit only what this batch produced: an empty batch must not
        # swallow pending next-commit options (it is an internal commit)
        if self._txn is not None and not self._txn.is_empty():
            self.commit(origin=origin)

    def revert_to(self, frontiers: Frontiers) -> None:
        """Generate new ops returning the doc to `frontiers`' state."""
        self._barrier()
        batch = self.diff(self.oplog.frontiers, frontiers)
        self.apply_diff(batch, origin="revert")

    # ------------------------------------------------------------------
    # fork
    # ------------------------------------------------------------------
    def fork(self) -> "LoroDoc":
        """Deep copy at the CURRENT version: a detached doc forks its
        checked-out state, not the latest history (reference: fork.rs +
        test_fork_when_detached)."""
        if self._detached:
            return self.fork_at(self.state_frontiers())
        new = LoroDoc()
        new.import_(self.export(ExportMode.Snapshot), origin="fork")
        return new

    def fork_at(self, frontiers: Frontiers) -> "LoroDoc":
        # typed validation: vv membership is not enough on shallow docs
        # (ids below the floor are in the vv but have no dag node); the
        # floor frontiers themselves are the one representable exception
        if frontiers != self.oplog.dag.shallow_since_frontiers:
            if self.is_shallow() and frontiers.is_empty():
                raise LoroError("fork_at below the shallow root")
            for id_ in frontiers:
                if self.oplog.dag.node_at(id_) is None:
                    raise LoroError(f"fork_at frontiers not in history: {id_}")
        new = LoroDoc()
        new.import_(self.export(ExportMode.SnapshotAt(frontiers)), origin="fork")
        return new

    # ------------------------------------------------------------------
    # values
    # ------------------------------------------------------------------
    def _hide_empty_filter(self, v: Dict[str, Any]) -> Dict[str, Any]:
        """Per-container-type emptiness, matching the reference
        (state.rs visible_container_value_is_empty): hide only empty
        Text/Map/List/MovableList/Tree roots; Counter and Unknown roots
        are never hidden regardless of value."""
        from .core.ids import ContainerType

        hideable = {
            ContainerType.Text: "",
            ContainerType.Map: {},
            ContainerType.List: [],
            ContainerType.MovableList: [],
            ContainerType.Tree: [],
        }
        empty_by_name: Dict[str, Any] = {}
        for cid in self.state.states:
            if cid.is_root and cid.ctype in hideable:
                empty_by_name[cid.name] = hideable[cid.ctype]
        return {
            k: x
            for k, x in v.items()
            if not (k in empty_by_name and x == empty_by_name[k])
        }

    def get_value(self) -> Dict[str, Any]:
        v = self.state.get_value()
        if self.config.hide_empty_root_containers:
            v = self._hide_empty_filter(v)
        return v

    def get_deep_value(self) -> Dict[str, Any]:
        v = self.state.get_deep_value()
        if self.config.hide_empty_root_containers:
            v = self._hide_empty_filter(v)
        return v

    def get_deep_value_with_id(self) -> Dict[str, Any]:
        """Like get_deep_value, but every container value is wrapped as
        {"cid": str, "value": ...} (reference:
        LoroDoc::get_deep_value_with_id)."""

        def deep(x):
            if isinstance(x, ContainerID):
                return wrap(x)
            if isinstance(x, dict):
                return {k: deep(v) for k, v in x.items()}
            if isinstance(x, list):
                return [deep(v) for v in x]
            return x

        def wrap(cid: ContainerID):
            st = self.state.states.get(cid)
            if st is None:
                return {"cid": str(cid), "value": None}
            return {"cid": str(cid), "value": deep(st.get_value())}

        from .core.ids import is_internal_root_name

        out: Dict[str, Any] = {}
        for cid in list(self.state.states):
            st = self.state.states.get(cid)
            if (
                cid.is_root
                and not is_internal_root_name(cid.name)
                and st is not None
                and st.materialized
            ):
                out[cid.name] = wrap(cid)
        return out

    def get_by_str_path(self, path: str):
        """Navigate "container/key/index/..." to a handler or value
        (reference: loro.rs get_by_str_path)."""
        parts = [p for p in path.split("/") if p]
        return self._navigate_parts(parts)

    def _navigate_parts(self, parts) -> Any:
        """Segment-by-segment navigation shared by get_by_str_path and
        get_by_path — lazy (touches only the containers on the path)
        and returns live handlers for sub-containers."""
        if not parts:
            raise LoroError("empty path")
        cur: Any = None
        for i, part in enumerate(parts):
            if i == 0:
                candidates = [
                    cid for cid in self.state.states if cid.is_root and cid.name == part
                ]
                if not candidates:
                    return None
                cur = self.get_container(candidates[0])
                continue
            from .models.handlers import ListHandler, MovableListHandler

            if isinstance(cur, (ListHandler, MovableListHandler)) or isinstance(
                cur, list
            ):
                try:
                    idx = int(part)
                except (TypeError, ValueError):
                    return None  # list segments must be numeric
                if idx < 0 or idx >= len(cur):
                    return None
                cur = cur[idx] if isinstance(cur, list) else cur.get(idx)
            elif hasattr(cur, "get"):
                # map handler or plain dict: string keys
                cur = cur.get(part)
            else:
                return None
            if cur is None:
                return None
        return cur

    # -- history inspection (reference: change meta APIs) --------------
    def len_changes(self) -> int:
        return self.oplog.total_changes()

    def get_change(self, id: ID) -> Optional[Dict[str, Any]]:
        """Change metadata covering `id` (reference: ChangeMeta)."""
        ch = self.oplog.change_at(id)
        if ch is None:
            return None
        return {
            "id": ch.id,
            "peer": ch.peer,
            "lamport": ch.lamport,
            "timestamp": ch.timestamp,
            "deps": ch.deps,
            "len": ch.atom_len(),
            "message": ch.message,
        }

    def travel_change_ancestors(self, ids: List[ID], cb) -> None:
        """Walk the causal ancestors of the given change ids in reverse
        lamport order, calling cb(change_meta); cb returning False stops
        the walk (reference: loro.rs travel_change_ancestors)."""
        import heapq

        seen = set()
        heap = []
        for i in ids:
            ch = self.oplog.change_at(i)
            if ch is None:
                raise LoroError(f"change not found: {i}")
            if ch.id not in seen:
                seen.add(ch.id)
                heapq.heappush(heap, (-ch.lamport, ch.peer, ch.id))
        while heap:
            _, _, cid = heapq.heappop(heap)
            ch = self.oplog.change_at(cid)
            if ch is None:
                continue
            if cb(self.get_change(ch.id)) is False:
                return
            for dep in ch.deps:
                dch = self.oplog.change_at(dep)
                if dch is not None and dch.id not in seen:
                    seen.add(dch.id)
                    heapq.heappush(heap, (-dch.lamport, dch.peer, dch.id))

    def get_changed_containers_in(self, id: ID, length: int) -> set:
        """Container ids touched by ops in [id, id+len)."""
        out = set()
        ch = self.oplog.change_at(id)
        while ch is not None and ch.ctr_start < id.counter + length:
            for op in ch.ops:
                if op.ctr_end > id.counter and op.counter < id.counter + length:
                    out.add(op.container)
            nxt = ID(id.peer, ch.ctr_end)
            if nxt.counter >= id.counter + length:
                break
            ch = self.oplog.change_at(nxt)
        return out

    def len_ops(self) -> int:
        return self.oplog.total_ops()

    def has_container(self, cid: Union[ContainerID, str]) -> bool:
        if isinstance(cid, str):
            cid = ContainerID.parse(cid)
        return cid in self.state.states

    def get_pending_txn_len(self) -> int:
        return 0 if self._txn is None else self._txn.atom_len()

    def delete_root_container(self, cid: Union[ContainerID, str]) -> None:
        """Clear a root container's content so it reads as empty
        (reference: LoroDoc::delete_root_container)."""
        if isinstance(cid, str):
            cid = ContainerID.parse(cid)
        h = self.get_container(cid)
        if cid.ctype == ContainerType.Tree:
            for root in list(h.roots()):
                h.delete(root)
        elif cid.ctype == ContainerType.Counter:
            v = h.get_value()
            if v:
                h.decrement(v)
        elif hasattr(h, "clear"):
            h.clear()
        elif hasattr(h, "delete") and hasattr(h, "__len__"):
            h.delete(0, len(h))
        self._barrier()

    # -- shallow introspection (reference: is_shallow / shallow_since) -
    def is_shallow(self) -> bool:
        return self._shallow_base is not None

    def shallow_since_vv(self) -> VersionVector:
        return self.oplog.dag.shallow_since_vv.copy()

    def shallow_since_frontiers(self) -> Frontiers:
        return self.oplog.dag.shallow_since_frontiers

    # -- version algebra (reference: cmp/minimize frontiers) -----------
    def cmp_with_frontiers(self, f: Frontiers) -> int:
        """Compare the doc version with `f`: -1 behind, 0 equal, 1
        ahead (raises on concurrent — reference returns Ordering)."""
        va = self.oplog.vv
        vb = self.oplog.dag.frontiers_to_vv(f)
        if va == vb:
            return 0
        if va <= vb:
            return -1
        if vb <= va:
            return 1
        raise LoroError("versions are concurrent")

    def cmp_frontiers(self, a: Frontiers, b: Frontiers) -> Optional[int]:
        """Partial compare of two frontiers: -1/0/1 or None when
        concurrent (reference: LoroDoc::cmp_frontiers)."""
        va = self.oplog.dag.frontiers_to_vv(a)
        vb = self.oplog.dag.frontiers_to_vv(b)
        if va == vb:
            return 0
        if va <= vb:
            return -1
        if vb <= va:
            return 1
        return None

    def minimize_frontiers(self, f: Frontiers) -> Frontiers:
        """Drop heads dominated by other heads' closures."""
        return self.oplog.dag.vv_to_frontiers(self.oplog.dag.frontiers_to_vv(f))

    def find_id_spans_between(self, from_f: Frontiers, to_f: Frontiers) -> VersionRange:
        """Per-peer id spans in to_f's closure but not from_f's
        (reference: LoroDoc::find_id_spans_between)."""
        va = self.oplog.dag.frontiers_to_vv(from_f)
        vb = self.oplog.dag.frontiers_to_vv(to_f)
        out = VersionRange()
        for p in vb:
            lo, hi = va.get(p), vb.get(p)
            if hi > lo:
                out.extend_to_include(IdSpan(p, lo, hi))
        return out

    # -- commit options / config sugar ---------------------------------
    def set_next_commit_message(self, message: str) -> None:
        """Message for the NEXT non-empty commit (stored on the doc, not
        an eager empty transaction — empty txns are discarded by any
        implicit commit and would go stale across set_peer_id)."""
        self._next_commit_message = message

    def set_next_commit_origin(self, origin: str) -> None:
        self._next_commit_origin = origin

    def set_next_commit_timestamp(self, timestamp: int) -> None:
        """Unix-seconds timestamp for the NEXT commit, overriding both
        the clock and record_timestamp (reference:
        LoroDoc::set_next_commit_timestamp)."""
        self._next_commit_timestamp = timestamp

    def set_next_commit_options(
        self,
        origin: Optional[str] = None,
        message: Optional[str] = None,
        timestamp: Optional[int] = None,
    ) -> None:
        """reference: LoroDoc::set_next_commit_options (CommitOptions)."""
        if origin is not None:
            self._next_commit_origin = origin
        if message is not None:
            self._next_commit_message = message
        if timestamp is not None:
            self._next_commit_timestamp = timestamp

    def clear_next_commit_options(self) -> None:
        """reference: LoroDoc::clear_next_commit_options."""
        self._next_commit_message = None
        self._next_commit_origin = None
        self._next_commit_timestamp = None

    def commit_with(
        self,
        origin: str = "",
        message: Optional[str] = None,
        timestamp: Optional[int] = None,
    ) -> None:
        """Commit with explicit options (reference: LoroDoc::commit_with).
        Options apply to THIS commit only — with nothing pending they are
        dropped, unlike set_next_commit_* which persists to the next
        non-empty commit."""
        if timestamp is not None and self._txn is not None and not self._txn.is_empty():
            self._next_commit_timestamp = timestamp
        self.commit(origin=origin, message=message)

    def set_record_timestamp(self, record: bool) -> None:
        self.config.record_timestamp = record

    def set_hide_empty_root_containers(self, hide: bool) -> None:
        """reference: LoroDoc::set_hide_empty_root_containers."""
        self.config.hide_empty_root_containers = hide

    def config_text_style(self, styles: Dict[str, str]) -> None:
        """Set per-key mark expand behavior: "after" (default), "before",
        "both", "none" (reference: LoroDoc::config_text_style /
        StyleConfigMap)."""
        for key, expand in styles.items():
            if expand not in ("after", "before", "both", "none"):
                raise LoroError(f"invalid expand behavior {expand!r} for style {key!r}")
            self.config.text_style_config[key] = expand

    def config_default_text_style(self, expand: Optional[str]) -> None:
        """Default expand behavior for keys not in text_style_config
        (reference: LoroDoc::config_default_text_style; None resets to
        the built-in "after")."""
        if expand is None:
            self.config.default_text_style = "after"
            return
        if expand not in ("after", "before", "both", "none"):
            raise LoroError(f"invalid expand behavior {expand!r}")
        self.config.default_text_style = expand

    def set_change_merge_interval(self, interval_s: int) -> None:
        self.config.merge_interval_s = interval_s

    set_merge_interval = set_change_merge_interval

    def has_history_cache(self) -> bool:
        """Whether checkout/diff checkpoint floors are materialized
        (reference: LoroDoc::has_history_cache)."""
        return len(self._state_cache) > 0

    def free_history_cache(self) -> None:
        """Drop checkout checkpoint floors; time travel re-replays from
        scratch until re-warmed (reference: LoroDoc::free_history_cache)."""
        self._state_cache.clear()

    def free_diff_calculator(self) -> None:
        """reference: LoroDoc::free_diff_calculator.  The merge engine
        here is stateless between imports (structure-holding states, no
        persistent tracker), so there is nothing to free beyond the
        checkout checkpoints."""
        self.free_history_cache()

    def check_state_correctness_slow(self) -> None:
        """Deep self-check (reference: LoroDoc::check_state_correctness_slow):
        replay full history into a fresh doc and require identical deep
        values + identical frontiers; run structural invariant checkers
        on every sequence CRDT."""
        self._barrier()
        if self.is_shallow():
            # replay floor is the frozen base; rebuild via snapshot
            fresh = LoroDoc.from_snapshot(self.export(ExportMode.Snapshot))
        else:
            fresh = LoroDoc()
            fresh.import_(self.export_updates())
        if not self._detached:
            a, b = self.get_deep_value(), fresh.get_deep_value()
            if a != b:
                raise LoroError(f"state mismatch vs replay: {a!r} != {b!r}")
        for cid, st in self.state.states.items():
            seq = getattr(st, "seq", None)
            if seq is not None and hasattr(seq, "check_invariants"):
                seq.check_invariants()

    def log_internal_state(self) -> str:
        """Dump sizes + per-container analysis (reference:
        LoroDoc::log_internal_state); returns the dump and logs it
        through the tracing layer."""
        import json as _json

        dump = _json.dumps(
            {
                "peer": self.peer,
                "detached": self._detached,
                "oplog": self.diagnose_size(),
                "frontiers": str(self.oplog.frontiers),
                "containers": self.analyze(),
            },
            indent=2,
            default=str,
        )
        tracing.instant("doc.internal_state", dump=dump)
        return dump

    def compact_change_store(self) -> None:
        """Push hot decoded history back into sealed compressed blocks
        and free the Change objects (reference:
        LoroDoc::compact_change_store)."""
        self._barrier()
        self.oplog.compact()

    @staticmethod
    def decode_import_blob_meta(blob: bytes) -> Dict[str, Any]:
        """Inspect a blob without importing it (reference:
        LoroDoc::decode_import_blob_meta): mode, format version, and for
        update payloads the per-peer span range + change count."""
        from .codec import binary as bcodec

        version, mode, payload = parse_envelope_header(blob)
        meta: Dict[str, Any] = {"mode": mode.name, "version": version}
        if mode in (EncodeMode.ColumnarUpdates, EncodeMode.ColumnarSnapshot):
            start = VersionRange()
            changes = bcodec.decode_changes(payload)
            end_vv = VersionVector()
            n = 0
            for ch in changes:
                start.extend_to_include(IdSpan(ch.peer, ch.ctr_start, ch.ctr_end))
                end_vv.set_end(ch.peer, max(end_vv.get(ch.peer), ch.ctr_end))
                n += 1
            meta["change_num"] = n
            meta["partial_start_vv"] = {p: s for p, (s, _e) in start.items()}
            meta["partial_end_vv"] = dict(end_vv.items())
        return meta

    # -- cursor / jsonpath / path sugar (reference exposes these as doc
    # methods; the implementations live in their modules) --------------
    def get_cursor(self, container, pos: int, side=None):
        from .cursor import CursorSide, get_cursor

        return get_cursor(self, container, pos, side if side is not None else CursorSide.Middle)

    def get_cursor_pos(self, cursor):
        from .cursor import get_cursor_pos

        return get_cursor_pos(self, cursor)

    def jsonpath(self, path: str) -> List[Any]:
        from .jsonpath import query

        return query(self, path)

    def subscribe_jsonpath(self, path: str, cb):
        from .jsonpath import subscribe_jsonpath

        return subscribe_jsonpath(self, path, cb)

    def get_path_to_container(self, cid: Union[ContainerID, str]):
        if isinstance(cid, str):
            cid = ContainerID.parse(cid)
        if cid not in self.state.states:
            return None
        return self.state.path_of(cid)

    def get_by_path(self, parts) -> Any:
        """Navigate a path given as a sequence of keys/indexes,
        segment-by-segment (reference: get_by_path) — lazy, returns
        live handlers for sub-containers, and keys containing "/" keep
        their meaning (unlike the string form)."""
        return self._navigate_parts(list(parts))

    def export_json_in_id_span(self, span: IdSpan) -> List[Dict[str, Any]]:
        """JSON form of the changes covering one peer's id span
        (reference: LoroDoc::export_json_in_id_span)."""
        self._barrier()
        chs = self.oplog.changes_between(
            VersionVector({span.peer: span.start}),
            VersionVector({span.peer: span.end}),
        )
        return [jcodec.change_to_json(ch) for ch in chs]

    def diagnose_size(self) -> Dict[str, int]:
        return self.oplog.diagnose_size()

    def analyze(self) -> Dict[str, Dict[str, Any]]:
        """Per-container size introspection (reference: state/analyzer.rs
        DocAnalysis)."""
        out: Dict[str, Dict[str, Any]] = {}
        for cid, st in self.state.states.items():
            info: Dict[str, Any] = {"type": cid.ctype.name, "depth": self.state.depth_of(cid)}
            seq = getattr(st, "seq", None)
            if seq is not None:
                n_deleted = 0
                n_anchors = 0
                for e in seq.all_elems():
                    if e.deleted:
                        n_deleted += 1
                    elif getattr(e, "is_anchor", False):
                        n_anchors += 1
                info["elements"] = seq.total_len
                info["visible"] = seq.visible_len
                info["tombstones"] = n_deleted  # live anchors are not garbage
                if n_anchors:
                    info["anchors"] = n_anchors
            elif hasattr(st, "entries"):
                info["entries"] = len(st.entries)
            elif hasattr(st, "nodes"):
                info["nodes"] = len(st.nodes)
                info["moves"] = len(st.moves)
            out[str(cid)] = info
        return out

    def __len__(self) -> int:
        return len(self.state.states)


def _state_diff(sa: DocState, sb: DocState) -> Dict[ContainerID, Any]:
    """Value-level DiffBatch turning sa's values into sb's (map/counter
    only — identity containers come from _seq_diff_batch)."""
    va = {cid: st.get_value() for cid, st in sa.states.items()}
    vb = {cid: st.get_value() for cid, st in sb.states.items()}
    return _diff_values(va, vb, sb)


def _diff_values(
    va: Dict[ContainerID, Any],
    vb: Dict[ContainerID, Any],
    target_state: DocState,
) -> Dict[ContainerID, Any]:
    from .event import CounterDiff

    out: Dict[ContainerID, Any] = {}
    for cid in set(va) | set(vb):
        if cid.ctype in (
            ContainerType.Text,
            ContainerType.List,
            ContainerType.MovableList,
            ContainerType.Tree,
        ):
            continue  # exact identity deltas computed separately
        old_v = va.get(cid)
        new_v = vb.get(cid)
        if old_v == new_v:
            continue
        if cid.ctype == ContainerType.Map:
            d = MapDiff()
            old_m = old_v or {}
            new_m = new_v or {}
            for k in new_m:
                if k not in old_m or old_m[k] != new_m[k]:
                    d.updated[k] = new_m[k]
            for k in old_m:
                if k not in new_m:
                    d.deleted.add(k)
            if not d.is_empty():
                out[cid] = d
        elif cid.ctype == ContainerType.Counter:
            out[cid] = CounterDiff((new_v or 0.0) - (old_v or 0.0))
    return out


def parse_envelope_header(data: bytes) -> Tuple[int, "EncodeMode", bytes]:
    """The single LTPU envelope validator: magic, version gate, mode,
    crc.  Returns (version, mode, payload)."""
    if len(data) < ENVELOPE_LEN or data[:4] != MAGIC:
        raise DecodeError("bad magic")
    version, mode_b = data[4], data[5]
    if version > FORMAT_VERSION:
        raise DecodeError(f"unsupported format version {version}")
    crc = int.from_bytes(data[6:10], "little")
    payload = data[ENVELOPE_LEN:]
    if zlib.crc32(payload) != crc:
        raise DecodeError("checksum mismatch")
    try:
        mode = EncodeMode(mode_b)
    except ValueError as e:
        raise DecodeError(f"unknown encode mode {mode_b}") from e
    # v1 snapshot layouts (pre-BlockStore, uncompressed state) are not
    # decodable by this version — fail with a version error, not a
    # confusing zlib/malformed one.
    if version < _min_version_for_mode(mode):
        raise DecodeError(
            f"{mode.name} blob written by format v{version}; this build reads "
            f"v{_min_version_for_mode(mode)}+"
        )
    return version, mode, payload


def strip_envelope(blob: bytes) -> bytes:
    """Validate the LTPU envelope and return the bare payload (the form
    the native SoA decoder and device-batch ingest paths consume)."""
    return parse_envelope_header(blob)[2]


def _decode_state_z(state_bytes: bytes):
    """Decode a (zlib-compressed) doc-state section.  All shallow-base
    and snapshot state sections ship compressed (reference compresses
    change blocks with LZ4; we extend the same treatment to state)."""
    import zlib as _z

    from .codec import snapshot as scodec

    return scodec.decode_doc_state(_z.decompress(state_bytes))
