"""OpLog: append-only causal op history, the port's copy of
loro_tpu/oplog/oplog.py.

reference: crates/loro-internal/src/oplog.rs + oplog/pending_changes.rs +
oplog/change_store.rs.  Host-side store: per-peer sorted change lists
(the columnar block encoding lives in codec/; the device-facing SoA
extraction lives in ops/columnar.py).

trim_known_prefix is the one known-prefix trim rule: remote import
(plan_import), ranged export (changes_since / changes_between) and the
read plane (ops/export_batch.ExportIndex.note_changes) all apply it, so
the read plane's rows are the changes an OpLog would store.

_RunCont / _RUN_CONT (the run-continuation parent) live in
core/change.py, beside the decoder that needs them; they are re-exported
here, so every isinstance check sees the one class.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ..core.change import _RUN_CONT, Change, Op, SeqInsert, Side, _RunCont  # noqa: F401  (_RunCont re-exported)
from ..core.ids import ID, Counter, Lamport, PeerID
from ..core.version import Frontiers, VersionRange, VersionVector
from .dag import AppDag


@dataclass
class PendingChanges:
    """Changes whose deps aren't satisfied yet, keyed by a missing dep id.
    reference: oplog/pending_changes.rs."""

    by_missing: Dict[ID, List[Change]] = field(default_factory=dict)

    def park(self, missing: ID, change: Change) -> None:
        self.by_missing.setdefault(missing, []).append(change)

    def take_unlocked(self, vv: VersionVector) -> List[Change]:
        """Pop every parked change whose trigger dep is now satisfied."""
        out: List[Change] = []
        for key in [k for k in self.by_missing if vv.includes(k)]:
            out.extend(self.by_missing.pop(key))
        return out

    def pending_range(self) -> VersionRange:
        vr = VersionRange()
        for lst in self.by_missing.values():
            for ch in lst:
                vr.extend_to_include(ch.id_span())
        return vr

    def __len__(self) -> int:
        return sum(len(v) for v in self.by_missing.values())


@dataclass
class ImportPlan:
    """Outcome of OpLog.plan_import: inserts in causal order + the
    pending store as it would look after commit."""

    inserts: List[Change]
    pending: Dict[ID, List[Change]]


class OpLog:
    """Append-only causal history: changes + DAG + pending queue."""

    def __init__(self) -> None:
        self.dag = AppDag()
        self.changes: Dict[PeerID, List[Change]] = {}
        self._starts: Dict[PeerID, List[Counter]] = {}
        self.pending = PendingChanges()
        self.next_lamport: Lamport = 0
        # the owning doc's Configure (None for bare oplogs in tests);
        # governs the local-commit RLE-merge window (reference:
        # configure.rs merge_interval)
        self.config = None
        # block-chunked cold history (attached on fast-snapshot import;
        # reference: change_store.rs lazy blocks).  Peers hydrate into
        # self.changes on first op access; dag/vv come from block metas.
        self.cold = None  # Optional[BlockStore]
        self._cold_peers: set = set()
        # peers whose in-memory history diverges from the cold blocks
        # (snapshot export re-encodes these; clean peers reuse raw)
        self._dirty_peers: set = set()

    # -- cold store (lazy blocks) --------------------------------------
    def attach_cold_store(self, store) -> None:
        """Adopt a decoded BlockStore as this (empty) oplog's history:
        register dag spans from block metas WITHOUT decoding any op
        payload.  reference: fast_snapshot.rs installs oplog bytes
        directly; change blocks parse lazily."""
        from ..errors import DecodeError

        assert not self.changes and self.cold is None, "attach requires empty oplog"
        metas = sorted(store.iter_metas(), key=lambda m: (m[3], m[0], m[1]))
        # dep-closure check before touching the dag: every dep must be
        # covered by the blocks themselves or the shallow floor (the
        # replaced import_changes path parked dep-missing changes; a
        # snapshot with dangling deps is malformed, not pending)
        full_vv = self.dag.shallow_since_vv.copy()
        for peer, cs, ce, _lam, _deps in metas:
            if ce > full_vv.get(peer):
                full_vv.set_end(peer, ce)
        for peer, cs, ce, _lam, deps in metas:
            for d in deps:
                if d.counter >= full_vv.get(d.peer):
                    raise DecodeError(
                        f"snapshot change (peer={peer}, ctr={cs}) depends on "
                        f"{d} which no block covers"
                    )
        for peer in store.peers():
            bl = store.blocks[peer]
            first = bl[0].ctr_start
            floor = self.dag.shallow_since_vv.get(peer)
            if first != floor:
                raise DecodeError(
                    f"peer {peer} history starts at {first}, expected {floor}"
                )
            # no intra-peer gaps (BlockStore.decode also checks; this
            # covers hand-built stores so the dag never gets a hole)
            for a, b in zip(bl, bl[1:]):
                if a.ctr_end != b.ctr_start:
                    raise DecodeError(f"peer {peer} history has a gap at {a.ctr_end}")
        for peer, cs, ce, lam, deps in metas:
            self.dag.add_node(peer, cs, ce, lam, tuple(deps))
            lam_end = lam + (ce - cs)
            if lam_end > self.next_lamport:
                self.next_lamport = lam_end
        self.cold = store
        self._cold_peers = set(store.peers())

    def _hydrate_peer(self, peer: PeerID) -> None:
        if peer not in self._cold_peers:
            return
        self._cold_peers.discard(peer)
        decoded = self.cold.changes_for_peer(peer)
        hot = self.changes.get(peer, [])
        assert not hot, "hot changes appeared before hydration"
        self.changes[peer] = decoded
        self._starts[peer] = [ch.ctr_start for ch in decoded]

    def _hydrate_all(self) -> None:
        for peer in list(self._cold_peers):
            self._hydrate_peer(peer)

    def _history_peers(self):
        return set(self.changes) | self._cold_peers

    # -- queries ------------------------------------------------------
    @property
    def vv(self) -> VersionVector:
        return self.dag.vv

    @property
    def frontiers(self) -> Frontiers:
        return self.dag.frontiers

    def is_empty(self) -> bool:
        return not self.changes and not self._cold_peers and len(self.pending) == 0

    def change_at(self, id: ID) -> Optional[Change]:
        self._hydrate_peer(id.peer)
        starts = self._starts.get(id.peer)
        if not starts:
            return None
        i = bisect.bisect_right(starts, id.counter) - 1
        if i < 0:
            return None
        ch = self.changes[id.peer][i]
        return ch if ch.ctr_start <= id.counter < ch.ctr_end else None

    def total_ops(self) -> int:
        return self.vv.total_ops()

    def total_changes(self) -> int:
        hot = sum(len(v) for v in self.changes.values())
        cold = sum(
            len(b.metas)
            for p in self._cold_peers
            for b in self.cold.blocks.get(p, [])
        )
        return hot + cold

    # -- local commit -------------------------------------------------
    def next_counter(self, peer: PeerID) -> Counter:
        return self.vv.get(peer)

    def import_local_change(self, change: Change) -> None:
        """Single mutation point for local commits
        (reference: oplog.rs:191-220 insert_new_change).  Consecutive
        small commits RLE-merge into one stored Change when they form a
        linear extension within the merge interval."""
        assert change.ctr_start == self.vv.get(change.peer), "non-contiguous local change"
        for d in change.deps:
            assert self.dag.contains(d), f"local change dep missing: {d}"
        interval = self.config.merge_interval_s if self.config is not None else 1000
        self._hydrate_peer(change.peer)
        self._dirty_peers.add(change.peer)
        lst = self.changes.get(change.peer)
        if lst and lst[-1].can_merge_right(change, interval):
            lst[-1].ops.extend(change.ops)
            self._register_span(change)
            return
        self._insert_change(change)

    def plan_backfill(self, changes: Iterable[Change]) -> Optional[Dict[PeerID, List[Change]]]:
        """Shallow-history upgrade, planning half (pure — no mutation):
        when the incoming batch fully covers every peer's trimmed range
        [0, floor_p) with structurally-valid changes, return the spliced
        plan; else None (reference semantics:
        should_import_snapshot_before_shallow — a full snapshot arriving
        after a shallow one un-shallows the doc).  All-or-nothing."""
        floor = self.dag.shallow_since_vv
        if not len(floor):
            return None
        # collect pre-floor slices per peer
        pieces: Dict[PeerID, Dict[Counter, Change]] = {}
        for ch in changes:
            fp = floor.get(ch.peer)
            if fp <= 0 or ch.ctr_start >= fp:
                continue
            piece = _slice_change_end(ch, fp) if ch.ctr_end > fp else ch
            pieces.setdefault(ch.peer, {})[piece.ctr_start] = piece
        # coverage: every floor peer's [0, floor_p) must tile exactly
        plan: Dict[PeerID, List[Change]] = {}
        for p, fp in floor.items():
            if fp <= 0:
                continue
            have = sorted(pieces.get(p, {}).values(), key=lambda c: c.ctr_start)
            at = 0
            for ch in have:
                if ch.ctr_start != at:
                    return None
                at = ch.ctr_end
            if at != fp:
                return None
            plan[p] = have
        # structural validation — these changes bypass plan_import (the
        # floor vv marks their span as known), so vet them here: deps
        # inside the covered history, lamports monotone per peer and
        # >= every dep's lamport end, and consistent with the existing
        # floor nodes.  A violation means a malformed blob: no upgrade.
        full_vv = self.vv.copy()

        def lamport_end_of(d: ID) -> Optional[int]:
            node = self.dag.node_at(d)
            if node is not None:
                return node.lamport_of(d.counter) + 1
            lst = plan.get(d.peer)
            if lst is None:
                return None
            for c in lst:
                if c.ctr_start <= d.counter < c.ctr_end:
                    return c.lamport + (d.counter - c.ctr_start) + 1
            return None

        for p, lst in plan.items():
            prev_end = 0
            for ch in lst:
                if ch.lamport < prev_end:
                    return None
                prev_end = ch.lamport_end
                for d in ch.deps:
                    if not full_vv.includes(d):
                        return None
                    dl = lamport_end_of(d)
                    if dl is None or ch.lamport < dl:
                        return None
            # the first retained (post-floor) node must sit at/after the
            # backfilled lamport range
            floor_node = self.dag.node_at(ID(p, floor.get(p)))
            if floor_node is not None and floor_node.lamport < prev_end:
                return None
        return plan

    def commit_backfill(self, plan: Dict[PeerID, List[Change]]) -> None:
        """Commit a plan_backfill result: splice the pre-floor changes
        below the per-peer lists, rebuild dag nodes, drop the shallow
        root.  Call only after the rest of the import batch has been
        validated (leave-untouched-on-failure contract)."""
        for p, lst in plan.items():
            self._hydrate_peer(p)
            self._dirty_peers.add(p)
            cur = self.changes.get(p, [])
            self.changes[p] = lst + cur
            self._starts[p] = [c.ctr_start for c in self.changes[p]]
            for ch in lst:
                if ch.lamport_end > self.next_lamport:
                    self.next_lamport = ch.lamport_end
        self.dag.backfill_and_unshallow(
            {p: [(c.ctr_start, c.ctr_end, c.lamport, tuple(c.deps)) for c in lst] for p, lst in plan.items()}
        )

    def _register_span(self, ch: Change) -> None:
        """DAG/lamport bookkeeping shared by fresh inserts and RLE-merges."""
        self.dag.add_node(ch.peer, ch.ctr_start, ch.ctr_end, ch.lamport, tuple(ch.deps))
        if ch.lamport_end > self.next_lamport:
            self.next_lamport = ch.lamport_end

    # -- remote import ------------------------------------------------
    def plan_import(self, changes: Iterable[Change]) -> "ImportPlan":
        """Pure planning pass: decide which changes would insert (in
        causal order, trimmed), which would park, and what the pending
        store would become — WITHOUT mutating anything.  The doc layer
        validates the planned inserts against known element ids before
        committing (a corrupt payload whose deps lie must fail typed,
        leaving oplog AND state untouched — reference: import rollback,
        oplog.rs)."""
        vv = self.vv.copy()
        pending = PendingChanges(
            by_missing={k: list(v) for k, v in self.pending.by_missing.items()}
        )
        queue: List[Change] = list(changes)
        inserts: List[Change] = []
        progress = True
        while progress:
            progress = False
            next_queue: List[Change] = []
            # causal linearization attempt: sort by (lamport, peer, ctr)
            queue.sort(key=lambda c: (c.lamport, c.peer, c.ctr_start))
            for ch in queue:
                known_end = vv.get(ch.peer)
                if ch.ctr_end <= known_end:
                    continue  # fully known — dedup (trim_the_known_part)
                if ch.ctr_start > known_end:
                    # a gap within the same peer: park on the previous op
                    pending.park(ID(ch.peer, ch.ctr_start - 1), ch)
                    continue
                if ch.ctr_start < known_end:
                    ch = self._trim_known_prefix(ch, known_end)
                missing = next((d for d in ch.deps if not vv.includes(d)), None)
                if missing is not None:
                    pending.park(missing, ch)
                    continue
                inserts.append(ch)
                vv.set_end(ch.peer, max(vv.get(ch.peer), ch.ctr_end))
                progress = True
                # unlock parked changes whose trigger is now satisfied
                next_queue.extend(pending.take_unlocked(vv))
            queue = next_queue
        return ImportPlan(inserts=inserts, pending=pending.by_missing)

    def commit_import(self, plan: "ImportPlan") -> Tuple[List[Change], VersionRange]:
        for ch in plan.inserts:
            self._insert_change(ch)
        self.pending.by_missing = plan.pending
        return plan.inserts, self.pending.pending_range()

    def import_changes(self, changes: Iterable[Change]) -> Tuple[List[Change], VersionRange]:
        """Import remote changes: dedup known spans, park dep-missing ones,
        apply the rest in causal order.  Returns (applied changes in causal
        order, still-pending version range).
        reference: oplog.rs apply_decoded_changes_to_oplog + pending loop."""
        return self.commit_import(self.plan_import(changes))

    def _trim_known_prefix(self, ch: Change, known_end: Counter) -> Change:
        return trim_known_prefix(ch, known_end)

    def _insert_change(self, ch: Change) -> None:
        self._hydrate_peer(ch.peer)
        self._dirty_peers.add(ch.peer)
        self.changes.setdefault(ch.peer, []).append(ch)
        self._starts.setdefault(ch.peer, []).append(ch.ctr_start)
        self._register_span(ch)

    # -- export -------------------------------------------------------
    def changes_since(self, vv: VersionVector) -> List[Change]:
        """All changes (sliced) not included in `vv`, in causal order.
        reference: ChangeStore.export_blocks_from."""
        out: List[Change] = []
        for peer in list(self._history_peers()):
            start = vv.get(peer)
            if start >= self.vv.get(peer):
                continue  # fully known: no need to hydrate
            self._hydrate_peer(peer)
            lst = self.changes.get(peer, [])
            if not lst:
                continue
            i = bisect.bisect_right(self._starts[peer], start) - 1
            i = max(i, 0)
            for ch in lst[i:]:
                if ch.ctr_end <= start:
                    continue
                out.append(ch if ch.ctr_start >= start else self._trim_known_prefix_view(ch, start))
        out.sort(key=lambda c: (c.lamport, c.peer, c.ctr_start))
        return out

    def _trim_known_prefix_view(self, ch: Change, start: Counter) -> Change:
        return self._trim_known_prefix(ch, start)

    def changes_between(self, from_vv: VersionVector, to_vv: VersionVector) -> List[Change]:
        """Changes (sliced) with counters in [from_vv, to_vv) per peer, in
        causal order.  `to_vv` must be causally closed (a valid version)."""
        out: List[Change] = []
        for peer in list(self._history_peers()):
            lo = from_vv.get(peer)
            hi = to_vv.get(peer)
            if hi <= lo:
                continue  # cold peers outside the range stay cold
            self._hydrate_peer(peer)
            lst = self.changes.get(peer, [])
            if not lst:
                continue
            i = bisect.bisect_right(self._starts[peer], lo) - 1
            i = max(i, 0)
            for ch in lst[i:]:
                if ch.ctr_end <= lo:
                    continue
                if ch.ctr_start >= hi:
                    break
                if ch.ctr_start < lo:
                    ch = self._trim_known_prefix(ch, lo)
                if ch.ctr_end > hi:
                    ch = _slice_change_end(ch, hi)
                out.append(ch)
        out.sort(key=lambda c: (c.lamport, c.peer, c.ctr_start))
        return out

    def changes_in_causal_order(self) -> List[Change]:
        self._hydrate_all()
        out = [ch for lst in self.changes.values() for ch in lst]
        out.sort(key=lambda c: (c.lamport, c.peer, c.ctr_start))
        return out

    def iter_ops_causal(self, since: Optional[VersionVector] = None):
        """Yield (change, op) pairs in a causal linear extension."""
        chs = self.changes_in_causal_order() if since is None else self.changes_since(since)
        for ch in chs:
            for op in ch.ops:
                yield ch, op

    def export_block_store(self):
        """Sealed blocks covering the full history.  Peers untouched
        since cold-attach reuse their raw compressed blocks (no decode,
        no re-encode); dirty/hot peers seal fresh blocks."""
        from .change_store import BlockStore, blocks_from_changes

        st = BlockStore()
        for peer in self._history_peers():
            if (
                self.cold is not None
                and peer in self.cold.blocks
                and peer not in self._dirty_peers
            ):
                st.blocks[peer] = self.cold.blocks[peer]
            else:
                self._hydrate_peer(peer)
                chs = self.changes.get(peer, [])
                if chs:
                    st.blocks[peer] = blocks_from_changes(chs)
        return st

    def compact(self) -> None:
        """Seal all hot history into compressed blocks and free the
        decoded Change objects (reference: compact_change_store).  The
        next access hydrates from the blocks."""
        store = self.export_block_store()
        # drop decoded caches inside reused blocks so memory actually
        # shrinks (they were populated for dirty/hot peers)
        for bl in store.blocks.values():
            for b in bl:
                b._changes = None
        self.cold = store
        self.cold.decoded_blocks = 0
        self._cold_peers = set(store.peers())
        self._dirty_peers = set()
        self.changes = {}
        self._starts = {}

    def diagnose_size(self) -> Dict[str, int]:
        """reference: oplog.rs:675 diagnose_size."""
        self._hydrate_all()
        return {
            "changes": self.total_changes(),
            "ops": sum(len(c.ops) for lst in self.changes.values() for c in lst),
            "atoms": self.total_ops(),
            "dag_nodes": self.dag.total_changes(),
            "pending": len(self.pending),
        }


def trim_known_prefix(ch: Change, known_end: Counter) -> Change:
    """`ch` without its ops at or below `known_end`: the straddling run
    sliced, and the id, lamport and deps rewritten to the trim point."""
    ops: List[Op] = []
    for op in ch.ops:
        if op.ctr_end <= known_end:
            continue
        if op.counter < known_end:
            assert isinstance(op.content, SeqInsert)
            op = _slice_run(op, known_end)
        ops.append(op)
    off = known_end - ch.ctr_start
    return Change(
        id=ID(ch.peer, known_end),
        lamport=ch.lamport + off,
        deps=Frontiers([ID(ch.peer, known_end - 1)]),
        ops=ops,
        timestamp=ch.timestamp,
        message=ch.message,
    )


def _slice_change_end(ch: Change, end: Counter) -> Change:
    """Restrict a change to counters < end (for ranged export/checkout)."""
    ops: List[Op] = []
    for op in ch.ops:
        if op.counter >= end:
            break
        if op.ctr_end > end:
            c = op.content
            assert isinstance(c, SeqInsert)
            keep = end - op.counter
            op = Op(op.counter, op.container, SeqInsert(c.parent, c.side, c.content[:keep]))
        ops.append(op)
    return Change(ch.id, ch.lamport, ch.deps, ops, ch.timestamp, ch.message)


def _slice_run(op: Op, new_start: Counter) -> Op:
    """A SeqInsert run sliced to start at `new_start`: its first element's
    parent becomes the previous element of the run (_RUN_CONT, on the
    right)."""
    c: SeqInsert = op.content  # type: ignore[assignment]
    off = new_start - op.counter
    return Op(new_start, op.container, SeqInsert(_RUN_CONT, Side.Right, c.content[off:]))
