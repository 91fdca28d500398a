"""Movable tree container state (Kleppmann-style movable tree).

reference: crates/loro-internal/src/state/tree_state.rs +
diff_calc/tree.rs.  Semantics: all moves are applied in global
(lamport, peer, counter) order; a move whose new parent lies inside the
target's own subtree at that moment is a no-op (`effected = false`,
tree.rs:499-508).  Deletion is a move under the TRASH sentinel.
Sibling order is (fractional_index, (lamport, peer)) — tree.rs:592-595.

Out-of-(lamport)-order arrivals trigger a replay of the move log — the
same sorted-replay the batched device kernel performs with a
pointer-doubling ancestor check (ops/tree_batch.py).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from ..core.change import Op, TreeMove
from ..core.ids import ContainerID, ContainerType, TreeID
from ..event import Diff, TreeDiff, TreeDiffAction, TreeDiffItem
from .base import ContainerState

TRASH = TreeID(0xFFFF_FFFF_FFFF_FFFF, -1)  # deleted-subtree sentinel parent


# -- helpers over a bare node table (shared by live state + version
#    reconstructions in delta_between) ---------------------------------
def _deleted_in(nodes: Dict[TreeID, "TreeNode"], t: TreeID) -> bool:
    cur: Optional[TreeID] = t
    while cur is not None:
        if cur == TRASH:
            return True
        node = nodes.get(cur)
        if node is None:
            return False
        cur = node.parent
    return False


def _cycle_in(nodes: Dict[TreeID, "TreeNode"], target: TreeID, new_parent: TreeID) -> bool:
    cur: Optional[TreeID] = new_parent
    seen = 0
    while cur is not None and cur != TRASH:
        if cur == target:
            return True
        node = nodes.get(cur)
        cur = node.parent if node else None
        seen += 1
        if seen > len(nodes) + 1:
            return True
    return False


def _depth_in(nodes: Dict[TreeID, "TreeNode"], t: TreeID) -> int:
    d = 0
    node = nodes.get(t)
    while node is not None and node.parent is not None and node.parent != TRASH:
        d += 1
        node = nodes.get(node.parent)
    return d


def _children_in(nodes: Dict[TreeID, "TreeNode"], parent: Optional[TreeID]) -> List[TreeID]:
    kids = [
        (n.position or b"", n.move_key, t)
        for t, n in nodes.items()
        if n.parent == parent and not _deleted_in(nodes, t)
    ]
    kids.sort(key=lambda x: (x[0], x[1]))
    return [t for _, _, t in kids]


def _index_in(nodes: Dict[TreeID, "TreeNode"], t: TreeID) -> int:
    n = nodes.get(t)
    if n is None or _deleted_in(nodes, t):
        return -1
    sibs = _children_in(nodes, n.parent)
    return sibs.index(t)


def _table_views(nodes: Dict[TreeID, "TreeNode"]):
    """One-pass (alive set, children-by-parent, index-by-node) views so
    version diffs don't pay per-item sibling sorts."""
    alive = {t for t in nodes if not _deleted_in(nodes, t)}
    kids: Dict[Optional[TreeID], List[TreeID]] = {}
    for t in alive:
        kids.setdefault(nodes[t].parent, []).append(t)
    for lst in kids.values():
        lst.sort(key=lambda t: (nodes[t].position or b"", nodes[t].move_key))
    index = {t: i for lst in kids.values() for i, t in enumerate(lst)}
    return alive, kids, index


class TreeNode:
    __slots__ = ("parent", "position", "move_key")

    def __init__(self, parent: Optional[TreeID], position: Optional[bytes], move_key: Tuple):
        self.parent = parent  # None = root child, TRASH = deleted
        self.position = position
        self.move_key = move_key  # (lamport, peer, counter) of effective move


class TreeState(ContainerState):
    def __init__(self, cid: ContainerID):
        super().__init__(cid)
        self.nodes: Dict[TreeID, TreeNode] = {}
        # full move log sorted by (lamport, peer, counter); replayed on
        # out-of-order arrivals (rare) and by the device kernel (always)
        self.moves: List[Tuple[Tuple[int, int, int], TreeMove]] = []

    # ------------------------------------------------------------------
    def apply_op(self, op: Op, peer: int, lamport: int, record: bool = True) -> Optional[Diff]:
        c = op.content
        assert isinstance(c, TreeMove)
        key = (lamport, peer, op.counter)
        entry = (key, c)
        if not self.moves or self.moves[-1][0] < key:
            self.moves.append(entry)
            return self._apply_move(key, c, record)
        # out-of-order in lamport: insert into log and replay
        i = bisect.bisect_left(self.moves, key, key=lambda e: e[0])
        if i < len(self.moves) and self.moves[i][0] == key:
            return None  # duplicate
        self.moves.insert(i, entry)
        return self._replay_all(record)

    def _apply_move(self, key: Tuple, c: TreeMove, record: bool = True) -> Optional[Diff]:
        target = c.target
        parent = TRASH if c.is_delete else c.parent
        if parent is not None and parent != TRASH and self._creates_cycle(target, parent):
            return None  # not effected
        was = self.nodes.get(target)
        was_alive = record and was is not None and not self._is_deleted(target)
        old_spot = (
            (was.parent, _index_in(self.nodes, target)) if was_alive else (None, None)
        )
        # the target is about to die if its new parent chain is trashed;
        # only then collect the live subtree (delete events are emitted
        # per node, children first — see the Delete branch below)
        will_die = parent == TRASH or (parent is not None and self._is_deleted(parent))
        doomed: List[TreeID] = []
        old_spots = {}
        if was_alive and will_die:
            _alive, kids, index = _table_views(self.nodes)
            queue = [target]
            while queue:
                p = queue.pop(0)
                doomed.append(p)
                queue.extend(kids.get(p, ()))
            old_spots = {
                t: (self.nodes[t].parent, index.get(t, -1)) for t in doomed
            }
        self.nodes[target] = TreeNode(parent, c.position, key)
        if not record:
            return None
        now_alive = not self._is_deleted(target)
        d = TreeDiff()
        if was_alive and not now_alive:
            # per-node deletes, children first: the event contract is
            # by-id (every consumer removal is explicit; no implicit
            # subtree semantics), matching delta_between
            for t in reversed(doomed):
                op, oi = old_spots[t]
                d.items.append(
                    TreeDiffItem(t, TreeDiffAction.Delete, old_parent=op, old_index=oi)
                )
        elif now_alive and not was_alive:
            d.items.append(
                TreeDiffItem(target, TreeDiffAction.Create, parent, self.index_of(target), c.position)
            )
            # recursive revival: undeleting target (e.g. moving it out
            # of a trashed subtree) brings its whole live subtree back;
            # consumers saw those nodes deleted with the subtree root,
            # so they must be re-created parents-first (reference:
            # diff_calc/tree.rs subtree revival)
            queue = [target]
            while queue:
                p = queue.pop(0)
                for ch in self.children_of(p):
                    if ch == target:
                        continue
                    n = self.nodes[ch]
                    d.items.append(
                        TreeDiffItem(
                            ch, TreeDiffAction.Create, n.parent, self.index_of(ch), n.position
                        )
                    )
                    queue.append(ch)
        elif was_alive and now_alive:
            d.items.append(
                TreeDiffItem(
                    target,
                    TreeDiffAction.Move,
                    parent,
                    self.index_of(target),
                    c.position,
                    old_parent=old_spot[0],
                    old_index=old_spot[1],
                )
            )
        else:
            return None  # dead -> dead: invisible
        return d

    def _replay_all(self, record: bool = True) -> Optional[Diff]:
        """Rebuild node table by replaying the sorted move log, then diff
        old vs new tables (reference retreat/forward, tree.rs:230-396)."""
        old_nodes = dict(self.nodes) if record else {}
        if record:
            old_alive, _old_kids, old_index = _table_views(old_nodes)
            old = {t: (old_nodes[t].parent, old_nodes[t].position) for t in old_alive}
        else:
            old = {}
        self.nodes = {}
        for key, c in self.moves:
            target = c.target
            parent = TRASH if c.is_delete else c.parent
            if parent is not None and parent != TRASH and self._creates_cycle(target, parent):
                continue
            self.nodes[target] = TreeNode(parent, c.position, key)
        if not record:
            return None
        d = TreeDiff()
        new_alive, _new_kids, new_index = _table_views(self.nodes)
        gone = [t for t in old if t not in new_alive]
        for t in sorted(gone, key=lambda t: -_depth_in(old_nodes, t)):
            d.items.append(
                TreeDiffItem(
                    t,
                    TreeDiffAction.Delete,
                    old_parent=old[t][0],
                    old_index=old_index.get(t, -1),
                )
            )
        for t in sorted(new_alive, key=self._depth):
            n = self.nodes[t]
            if t not in old:
                d.items.append(
                    TreeDiffItem(t, TreeDiffAction.Create, n.parent, new_index.get(t, -1), n.position)
                )
            elif old[t] != (n.parent, n.position):
                d.items.append(
                    TreeDiffItem(
                        t,
                        TreeDiffAction.Move,
                        n.parent,
                        new_index.get(t, -1),
                        n.position,
                        old_parent=old[t][0],
                        old_index=old_index.get(t, -1),
                    )
                )
        return d if d.items else None

    # ------------------------------------------------------------------
    def _creates_cycle(self, target: TreeID, new_parent: TreeID) -> bool:
        """True if target is an ancestor of new_parent (or equal)."""
        return _cycle_in(self.nodes, target, new_parent)

    def _is_deleted_parent(self, parent: Optional[TreeID]) -> bool:
        return parent == TRASH or (parent is not None and self._is_deleted(parent))

    def _is_deleted(self, t: TreeID) -> bool:
        return _deleted_in(self.nodes, t)

    def _depth(self, t: TreeID) -> int:
        return _depth_in(self.nodes, t)

    # -- exact version diffs (element identity over the move log) ------
    def _nodes_at(self, vv) -> Dict[TreeID, TreeNode]:
        """Node table at an arbitrary version: replay the move log
        filtered to ops included in `vv` (reference: diff_calc/tree.rs
        :230-396 reaches the same states via retreat/forward on its
        per-container history cache).  Small memo keyed on (version,
        log length) so checkout scrubs / repeated diffs near the same
        versions don't re-replay."""
        from ..core.ids import ID

        memo_key = (tuple(sorted(vv.items())), len(self.moves))
        cache = getattr(self, "_nodes_at_memo", None)
        if cache is None:
            cache = self._nodes_at_memo = {}
        if memo_key in cache:
            return cache[memo_key]
        nodes: Dict[TreeID, TreeNode] = {}
        for key, c in self.moves:
            lam, peer, ctr = key
            if not vv.includes(ID(peer, ctr)):
                continue
            target = c.target
            parent = TRASH if c.is_delete else c.parent
            if parent is not None and parent != TRASH and _cycle_in(nodes, target, parent):
                continue
            nodes[target] = TreeNode(parent, c.position, key)
        if len(cache) >= 8:
            cache.pop(next(iter(cache)))
        cache[memo_key] = nodes
        return nodes

    def delta_between(self, va, vb) -> TreeDiff:
        """Exact TreeDiff turning state(va) into state(vb), by move-op
        identity: per-node Create (incl. every node of a revived
        subtree, parents first), Move (with old_parent/old_index), and
        Delete (children first).  reference: tree.rs:230-396."""
        old = self._nodes_at(va)
        new = self._nodes_at(vb)
        alive_old, _kids_old, idx_old = _table_views(old)
        alive_new, kids_new, idx_new = _table_views(new)
        d = TreeDiff()
        # deletes children-first so consumers never orphan a live child
        gone = alive_old - alive_new
        for t in sorted(gone, key=lambda t: -_depth_in(old, t)):
            d.items.append(
                TreeDiffItem(
                    t,
                    TreeDiffAction.Delete,
                    old_parent=old[t].parent,
                    old_index=idx_old.get(t, -1),
                )
            )
        # creates + moves parents-first in the NEW tree (BFS): a parent
        # is always placed before its children, which also makes the
        # item sequence safe to apply move-by-move (no transient cycles)
        order: List[TreeID] = []
        queue: List[Optional[TreeID]] = [None]
        while queue:
            p = queue.pop(0)
            for t in kids_new.get(p, ()):
                order.append(t)
                queue.append(t)
        for t in order:
            n = new[t]
            if t not in alive_old:
                d.items.append(
                    TreeDiffItem(
                        t,
                        TreeDiffAction.Create,
                        n.parent,
                        idx_new.get(t, -1),
                        n.position,
                    )
                )
            else:
                o = old[t]
                if (o.parent, o.position) != (n.parent, n.position):
                    d.items.append(
                        TreeDiffItem(
                            t,
                            TreeDiffAction.Move,
                            n.parent,
                            idx_new.get(t, -1),
                            n.position,
                            old_parent=o.parent,
                            old_index=idx_old.get(t, -1),
                        )
                    )
        return d

    # -- queries ------------------------------------------------------
    def children_of(self, parent: Optional[TreeID]) -> List[TreeID]:
        return _children_in(self.nodes, parent)

    def index_of(self, t: TreeID) -> int:
        return _index_in(self.nodes, t)

    def parent_of(self, t: TreeID) -> Optional[TreeID]:
        n = self.nodes.get(t)
        return n.parent if n else None

    def contains(self, t: TreeID) -> bool:
        return t in self.nodes and not self._is_deleted(t)

    def roots(self) -> List[TreeID]:
        return self.children_of(None)

    def meta_cid(self, t: TreeID) -> ContainerID:
        """Every tree node owns a meta map container keyed by its id
        (reference: tree node `meta` handler)."""
        return ContainerID.normal(t.peer, t.counter, ContainerType.Map)

    def get_value(self) -> List[dict]:
        """Flat node list (id, parent, index, fractional_index, meta cid),
        matching the reference's tree value shape."""
        out = []
        queue: List[Optional[TreeID]] = [None]
        while queue:
            parent = queue.pop(0)
            for i, t in enumerate(self.children_of(parent)):
                n = self.nodes[t]
                out.append(
                    {
                        "id": str(t),
                        "parent": str(parent) if parent is not None else None,
                        "index": i,
                        "fractional_index": (n.position or b"").hex(),
                        "meta": self.meta_cid(t),
                    }
                )
                queue.append(t)
        return out

    def to_diff(self) -> Diff:
        d = TreeDiff()
        stack = [(None, t) for t in reversed(self.roots())]
        while stack:
            parent, t = stack.pop()
            n = self.nodes[t]
            d.items.append(
                TreeDiffItem(t, TreeDiffAction.Create, parent, self.index_of(t), n.position)
            )
            for c in reversed(self.children_of(t)):
                stack.append((t, c))
        return d
