"""AppDag: the causal DAG over change spans.

reference: crates/loro-internal/src/{dag.rs,oplog/loro_dag.rs}.

Key simplification vs the reference: because each peer's ops are
causally totally ordered, a causally-closed op set is exactly a
VersionVector, so the common ancestor of two versions is the pointwise
meet of their VVs (the reference reaches the same result via a
lamport-ordered heap walk, dag.rs:318-517, because it avoids
materializing VVs; we cache VVs per node instead — small host data).
"""
from __future__ import annotations

import bisect
import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.ids import ID, Counter, Lamport, PeerID
from ..core.version import Frontiers, VersionVector


class DiffMode(enum.IntEnum):
    """Fast-path ladder for the merge engine (reference diff_calc.rs:72-103).

    Checkout: arbitrary version jump (may retreat).
    Import:   merge of concurrent history (forward only, from LCA).
    Linear:   imported ops are a causal linear extension of the current
              version — no concurrency, direct state apply.
    """

    Checkout = 0
    Import = 1
    ImportGreaterUpdates = 2
    Linear = 3


@dataclass
class DagNode:
    """One change span in the DAG (reference AppDagNode, loro_dag.rs:99)."""

    peer: PeerID
    ctr_start: Counter
    ctr_end: Counter
    lamport: Lamport
    deps: Tuple[ID, ...]
    _vv: Optional[VersionVector] = field(default=None, repr=False)  # closure cache

    @property
    def id(self) -> ID:
        return ID(self.peer, self.ctr_start)

    @property
    def last_id(self) -> ID:
        return ID(self.peer, self.ctr_end - 1)

    @property
    def lamport_end(self) -> Lamport:
        return self.lamport + (self.ctr_end - self.ctr_start)

    def lamport_of(self, counter: Counter) -> Lamport:
        return self.lamport + (counter - self.ctr_start)


class AppDag:
    """Per-peer sorted lists of DagNodes + frontier/VV tracking."""

    def __init__(self) -> None:
        self._nodes: Dict[PeerID, List[DagNode]] = {}
        self._starts: Dict[PeerID, List[Counter]] = {}  # parallel ctr_start arrays
        self.vv = VersionVector()
        self.frontiers = Frontiers()
        # shallow-history root (set when importing a shallow snapshot):
        # ops before this version are not present in the log.
        self.shallow_since_vv = VersionVector()
        self.shallow_since_frontiers = Frontiers()

    # -- lookup -------------------------------------------------------
    def node_at(self, id: ID) -> Optional[DagNode]:
        starts = self._starts.get(id.peer)
        if not starts:
            return None
        i = bisect.bisect_right(starts, id.counter) - 1
        if i < 0:
            return None
        n = self._nodes[id.peer][i]
        return n if n.ctr_start <= id.counter < n.ctr_end else None

    def lamport_of(self, id: ID) -> Lamport:
        n = self.node_at(id)
        if n is None:
            raise KeyError(f"id not in dag: {id}")
        return n.lamport_of(id.counter)

    def contains(self, id: ID) -> bool:
        return self.vv.includes(id)

    # -- mutation -----------------------------------------------------
    def add_node(
        self, peer: PeerID, ctr_start: Counter, ctr_end: Counter, lamport: Lamport, deps: Tuple[ID, ...]
    ) -> None:
        """Append a change span.  Caller guarantees deps are satisfied and
        counters are contiguous per peer (OpLog enforces)."""
        lst = self._nodes.setdefault(peer, [])
        starts = self._starts.setdefault(peer, [])
        # RLE-merge with previous node when it's a simple linear extension
        if (
            lst
            and lst[-1].ctr_end == ctr_start
            and lst[-1].lamport_end == lamport
            and len(deps) == 1
            and deps[0] == lst[-1].last_id
        ):
            lst[-1].ctr_end = ctr_end
            lst[-1]._vv = None
        else:
            lst.append(DagNode(peer, ctr_start, ctr_end, lamport, tuple(deps)))
            starts.append(ctr_start)
        # update version + frontiers
        self.vv.set_end(peer, max(self.vv.get(peer), ctr_end))
        new_heads = [i for i in self.frontiers if not (i in deps)]
        new_heads.append(ID(peer, ctr_end - 1))
        self.frontiers = Frontiers(new_heads)

    def backfill_and_unshallow(
        self,
        spans_by_peer: Dict[PeerID, List[Tuple[Counter, Counter, Lamport, Tuple[ID, ...]]]],
    ) -> None:
        """Shallow-history upgrade (OpLog.backfill_below_floor commits
        through here): splice pre-floor spans below the existing
        per-peer node lists, drop the shallow root, and invalidate every
        memoized closure — cached node VVs were computed with the old
        floor folded in and would over-approximate real causality."""
        for p, spans in spans_by_peer.items():
            new = [DagNode(p, cs, ce, lam, deps) for cs, ce, lam, deps in spans]
            cur = self._nodes.get(p, [])
            self._nodes[p] = new + cur
            self._starts[p] = [n.ctr_start for n in self._nodes[p]]
        self.shallow_since_vv = VersionVector()
        self.shallow_since_frontiers = Frontiers()
        for lst in self._nodes.values():
            for n in lst:
                n._vv = None
        cache = getattr(self, "_f2vv_cache", None)
        if cache:
            cache.clear()

    def update_frontiers_on_new_change(self, change_last_id: ID, deps: Frontiers) -> None:
        heads = [i for i in self.frontiers if i not in set(deps)]
        heads.append(change_last_id)
        self.frontiers = Frontiers(heads)

    # -- closures -----------------------------------------------------
    def node_vv(self, node: DagNode) -> VersionVector:
        """Causal closure of node's *full span* as a VV (cached).
        Iterative DFS to avoid Python recursion limits on long chains."""
        if node._vv is not None:
            return node._vv
        stack = [node]
        while stack:
            n = stack[-1]
            if n._vv is not None:
                stack.pop()
                continue
            pending = []
            for d in n.deps:
                dn = self.node_at(d)
                if dn is None:
                    # dep below the shallow root: treat its closure as the
                    # shallow root vv (already folded into shallow_since_vv)
                    continue
                if dn._vv is None:
                    pending.append(dn)
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            vv = VersionVector()
            vv.merge(self.shallow_since_vv)
            for d in n.deps:
                dn = self.node_at(d)
                if dn is None:
                    continue
                dvv = dn._vv.copy()
                # dep points at a counter inside dn's span: clamp
                dvv.set_end(dn.peer, d.counter + 1)
                # note: clamping below dn's own closure start is safe only
                # because within a peer counters are causally ordered and
                # dn._vv already includes full closures of dn's deps.
                vv.merge(dvv)
                vv.set_end(d.peer, max(vv.get(d.peer), d.counter + 1))
            vv.set_end(n.peer, max(vv.get(n.peer), n.ctr_end))
            n._vv = vv
        return node._vv

    def id_vv(self, id: ID) -> VersionVector:
        """Closure of a single id (inclusive)."""
        n = self.node_at(id)
        if n is None:
            raise KeyError(f"id not in dag: {id}")
        vv = self.node_vv(n).copy()
        vv.set_end(id.peer, id.counter + 1)
        return vv

    def frontiers_to_vv(self, f: Frontiers) -> VersionVector:
        """reference: loro_dag.rs:1192.  Memoized: the dag is
        append-only, so a frontier's closure never changes once all its
        heads exist."""
        if f == self.shallow_since_frontiers and not f.is_empty():
            return self.shallow_since_vv.copy()
        cache = getattr(self, "_f2vv_cache", None)
        if cache is None:
            cache = self._f2vv_cache = {}
        hit = cache.get(f)
        if hit is not None:
            return hit.copy()
        vv = VersionVector()
        vv.merge(self.shallow_since_vv)
        for id in f:
            vv.merge(self.id_vv(id))
        if len(cache) >= 64:
            cache.pop(next(iter(cache)))
        cache[f] = vv.copy()
        return vv

    def set_shallow_root(self, vv: VersionVector, f: Frontiers) -> None:
        """Install the shallow replay floor.  Clears the frontier-
        closure memo — cached closures were computed against the old
        floor."""
        self.shallow_since_vv = vv.copy()
        self.shallow_since_frontiers = f
        self.vv = vv.copy()
        self.frontiers = f
        cache = getattr(self, "_f2vv_cache", None)
        if cache:
            cache.clear()

    def vv_to_frontiers(self, vv: VersionVector) -> Frontiers:
        """reference: loro_dag.rs:1269.  Heads = last id per peer that is
        not dominated by another head's closure.

        Dominance probes the CACHED node closures directly (no per-pair
        VV copies): a mid-span id's cross-peer closure equals its
        node's — RLE merge only absorbs dep-on-self extensions, so a
        merged node's deps all hang off its first change."""
        if len(self.shallow_since_vv) and vv <= self.shallow_since_vv:
            # at/below the replay floor: the floor's own frontiers are
            # the only representable heads (per-peer last ids would
            # reference ids outside the dag)
            return self.shallow_since_frontiers
        cands: List[ID] = []
        for p, c in vv.items():
            if c > 0:
                cands.append(ID(p, c - 1))
        if len(cands) <= 1:
            return Frontiers(cands)
        nodes = [self.node_at(i) for i in cands]
        heads = []
        for i, id in enumerate(cands):
            dominated = False
            for j, other in enumerate(cands):
                if i == j:
                    continue
                n = nodes[j]
                if n is None:
                    # other is at/below the shallow root: its closure is
                    # within shallow_since_vv, which every candidate vv
                    # already includes — cannot dominate a live head
                    continue
                closure = self.node_vv(n)
                cover = closure.get(id.peer)
                if id.counter < cover:
                    dominated = True
                    break
            if not dominated:
                heads.append(id)
        return Frontiers(heads)

    # -- ancestry -----------------------------------------------------
    def find_common_ancestor(
        self, a: Frontiers, b: Frontiers
    ) -> Tuple[Frontiers, VersionVector, DiffMode]:
        """Common-ancestor version of two frontiers + the fast-path mode.
        reference: dag.rs:318-517 (heap walk); here: VV meet."""
        va = self.frontiers_to_vv(a)
        vb = self.frontiers_to_vv(b)
        meet = va.meet(vb)
        if va <= vb:
            # a is an ancestor of b: forward-only linear extension
            return a, meet, DiffMode.Linear
        if vb <= va:
            return b, meet, DiffMode.Checkout  # b behind a: retreat needed
        return self.vv_to_frontiers(meet), meet, DiffMode.Import

    # -- iteration ----------------------------------------------------
    def iter_causal_nodes(self) -> List[DagNode]:
        """All nodes in a causal linear extension ((lamport, peer, ctr))."""
        all_nodes = [n for lst in self._nodes.values() for n in lst]
        all_nodes.sort(key=lambda n: (n.lamport, n.peer, n.ctr_start))
        return all_nodes

    def total_changes(self) -> int:
        return sum(len(v) for v in self._nodes.values())
