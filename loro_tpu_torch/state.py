"""DocState: the materialized document state.

reference: crates/loro-internal/src/state.rs (DocState, apply_diff,
get_value/get_deep_value).  Routes causally-ordered ops into per-
container states, tracks container parenthood for event paths and deep
values, and assembles DocDiff events (parent-first, reference
state.rs:621).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

from .core.change import Change, MapSet, MovableSet, Op, SeqInsert
from .core.ids import ContainerID, ContainerType, ID, PeerID
from .core.version import Frontiers, VersionVector
from .event import Diff
from .models.base import ContainerState
from .models.counter_state import CounterState
from .models.list_state import ListState
from .models.map_state import MapState
from .models.movable_list_state import MovableListState
from .models.text_state import TextState
from .models.tree_state import TreeState
from .models.unknown_state import UnknownState

_STATE_BY_TYPE = {
    ContainerType.Map: MapState,
    ContainerType.List: ListState,
    ContainerType.Text: TextState,
    ContainerType.Tree: TreeState,
    ContainerType.MovableList: MovableListState,
    ContainerType.Counter: CounterState,
    ContainerType.Unknown: UnknownState,
}


class StateTable(dict):
    """Container states with lazy per-container hydration (reference:
    container_store.rs — states decode from their kv entries on first
    access).  Keys are always present (iteration/`in` never hydrates);
    values decode on first read.  `hydrated` counts decodes — tests
    assert laziness with it."""

    def __init__(self) -> None:
        super().__init__()
        self._thunks: Dict[ContainerID, Any] = {}
        self.hydrated = 0

    def put_cold(self, cid: ContainerID, thunk) -> None:
        super().__setitem__(cid, None)
        self._thunks[cid] = thunk

    def _hydrate(self, cid: ContainerID):
        from .errors import DecodeError

        th = self._thunks[cid]
        try:
            st = th()
        except DecodeError:
            raise  # keep the thunk: the error repeats, data never drops
        except Exception as e:
            raise DecodeError(f"malformed container state for {cid}: {e}") from e
        self._thunks.pop(cid, None)
        self.hydrated += 1
        st.materialized = True  # snapshot-backed states carry content
        super().__setitem__(cid, st)
        return st

    def __getitem__(self, cid):
        v = super().__getitem__(cid)
        if v is None and cid in self._thunks:
            v = self._hydrate(cid)
        return v

    def get(self, cid, default=None):
        if cid not in self:
            return default
        return self[cid]

    def __setitem__(self, cid, st) -> None:
        self._thunks.pop(cid, None)
        super().__setitem__(cid, st)

    def values(self):
        return [self[c] for c in self]

    def items(self):
        return [(c, self[c]) for c in self]

    def pop(self, cid, *a):
        self._thunks.pop(cid, None)
        return super().pop(cid, *a)

    # dict C fast paths would leak the None placeholders: route the
    # remaining mutation/copy surface through hydration
    def copy(self):
        return {c: self[c] for c in self}

    def setdefault(self, cid, default=None):
        if cid in self:
            return self[cid]
        self[cid] = default
        return default

    def update(self, other=(), **kw):
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v
        for k, v in kw.items():
            self[k] = v


class DocState:
    def __init__(self) -> None:
        self.states: Dict[ContainerID, ContainerState] = {}
        # child cid -> (parent cid, key-or-elem-id) for paths/deep values
        self.parents: Dict[ContainerID, Tuple[ContainerID, Union[str, ID, None]]] = {}
        self.vv = VersionVector()
        self.frontiers = Frontiers()

    # ------------------------------------------------------------------
    def get_or_create(self, cid: ContainerID) -> ContainerState:
        st = self.states.get(cid)
        if st is None:
            st = _STATE_BY_TYPE[cid.ctype](cid)
            self.states[cid] = st
        return st

    def get(self, cid: ContainerID) -> Optional[ContainerState]:
        return self.states.get(cid)

    # ------------------------------------------------------------------
    def apply_changes(
        self, changes: List[Change], record: bool = True
    ) -> Dict[ContainerID, List[Diff]]:
        """Apply causally-ordered changes.  Returns per-container diff
        lists when `record` (compose with compose_many for events)."""
        diffs: Dict[ContainerID, List[Diff]] = {}
        for ch in changes:
            for op in ch.ops:
                lamport = ch.lamport + (op.counter - ch.ctr_start)
                self._register_children(op, ch.peer)
                st = self.get_or_create(op.container)
                st.materialized = True
                d = st.apply_op(op, ch.peer, lamport, record=record)
                if record and d is not None:
                    diffs.setdefault(op.container, []).append(d)
            self.vv.extend_to_include(ch.id_span())
        return diffs

    def _register_children(self, op: Op, peer: PeerID) -> None:
        c = op.content
        if isinstance(c, MapSet):
            if isinstance(c.value, ContainerID):
                self.parents.setdefault(c.value, (op.container, c.key))
        elif isinstance(c, SeqInsert):
            if isinstance(c.content, (tuple, list)):
                for j, v in enumerate(c.content):
                    if isinstance(v, ContainerID):
                        self.parents.setdefault(v, (op.container, ID(peer, op.counter + j)))
        elif isinstance(c, MovableSet):
            if isinstance(c.value, ContainerID):
                self.parents.setdefault(c.value, (op.container, c.elem))
        # tree node meta containers register lazily via path_of

    # ------------------------------------------------------------------
    def path_of(self, cid: ContainerID) -> Tuple[Union[str, int], ...]:
        """Event path from root (keys for maps, indexes for sequences).
        reference: subscription.rs path resolution via arena parents."""
        from .core.ids import parse_mergeable_root_name

        parts: List[Union[str, int]] = []
        cur = cid
        seen = 0
        while not cur.is_root or parse_mergeable_root_name(cur.name or "") is not None:
            if cur.is_root:
                # mergeable child root: the path runs through its
                # parent map at the encoded key
                parent_cid, key = parse_mergeable_root_name(cur.name)
                parts.append(key)
                cur = parent_cid
                seen += 1
                if seen > 1000:
                    break
                continue
            link = self.parents.get(cur)
            if link is None:
                # maybe a tree-node meta map: cid == (peer,counter,Map) of a node
                owner = self._find_tree_owner(cur)
                if owner is None:
                    parts.append(repr(cur))
                    break
                tree_cid, node = owner
                parts.append(str(node))
                cur = tree_cid
                continue
            parent, key = link
            if isinstance(key, str):
                parts.append(key)
            elif isinstance(key, ID):
                st = self.states.get(parent)
                idx = None
                if isinstance(st, (ListState,)):
                    idx = st.seq.visible_index_of(key)
                elif isinstance(st, MovableListState):
                    entry = st.elems.get(key)
                    if entry is not None and not entry.deleted:
                        idx = st.seq.visible_index_of(entry.slot)
                parts.append(idx if idx is not None else -1)
            cur = parent
            seen += 1
            if seen > 1000:  # corrupt-parent guard
                break
        if cur.is_root:
            parts.append(cur.name)  # type: ignore[arg-type]
        return tuple(reversed(parts))

    def _find_tree_owner(self, cid: ContainerID) -> Optional[Tuple[ContainerID, Any]]:
        if cid.ctype != ContainerType.Map or cid.is_root:
            return None
        from .models.tree_state import TreeState as _TS

        for tcid, st in self.states.items():
            if isinstance(st, _TS):
                from .core.ids import TreeID

                node = TreeID(cid.peer, cid.counter)  # type: ignore[arg-type]
                if node in st.nodes:
                    return tcid, node
        return None

    def is_alive(self, cid: ContainerID) -> bool:
        """Reachability from a root: each hop's parent must still hold
        this child (map entry not overwritten/deleted, sequence element
        visible, tree node not trashed); reference: DocState
        dead-containers cache semantics (state.rs)."""
        from .core.ids import parse_mergeable_root_name

        cur = cid
        for _ in range(1000):
            if cur.is_root:
                pm = parse_mergeable_root_name(cur.name or "")
                if pm is None:
                    return True
                parent_cid, key = pm  # mergeable child root: key in parent map
                pst = self.states.get(parent_cid)
                if pst is None or pst.get_value().get(key) is None:
                    return False
                cur = parent_cid
                continue
            link = self.parents.get(cur)
            if link is None:
                owner = self._find_tree_owner(cur)
                if owner is None:
                    return cur in self.states  # unknown linkage: best effort
                tcid, node = owner
                tst = self.states.get(tcid)
                if tst is None or not tst.contains(node):
                    return False
                cur = tcid
                continue
            parent_cid, key = link
            pst = self.states.get(parent_cid)
            if pst is None:
                return False
            if isinstance(key, str) and hasattr(pst, "get_entry"):
                e = pst.get_entry(key)  # O(1) map lookup
                if e is None or e.value != cur:
                    return False
            elif isinstance(key, ID) and hasattr(pst, "elems"):
                # movable list: key is the element id; the element must
                # be live and its winning (set-rebindable) value == cur
                entry = pst.elems.get(key)
                if entry is None or entry.deleted or entry.value != cur:
                    return False
            elif isinstance(key, ID) and hasattr(pst, "seq"):
                e = pst.seq.by_id.get((key.peer, key.counter))
                if e is None or e.deleted or e.content != cur:
                    return False
            else:
                v = pst.get_value()
                if isinstance(v, dict):
                    if not (isinstance(key, str) and v.get(key) == cur):
                        return False
                elif isinstance(v, list) and cur not in v:
                    return False
            cur = parent_cid
        return False

    def depth_of(self, cid: ContainerID) -> int:
        d = 0
        cur = cid
        while not cur.is_root:
            link = self.parents.get(cur)
            if link is None:
                owner = self._find_tree_owner(cur)
                if owner is None:
                    return d
                cur = owner[0]
                d += 1
                continue
            cur = link[0]
            d += 1
            if d > 1000:
                break
        return d

    # ------------------------------------------------------------------
    def get_value(self) -> Dict[str, Any]:
        """Shallow doc value: root containers only (internal mergeable-
        child roots resolve through their parent maps, not here)."""
        from .core.ids import is_internal_root_name

        out: Dict[str, Any] = {}
        for cid, st in self.states.items():
            if cid.is_root and not is_internal_root_name(cid.name) and st.materialized:
                out[cid.name] = st.get_value()  # type: ignore[index]
        return out

    def get_deep_value(self) -> Dict[str, Any]:
        from .core.ids import is_internal_root_name

        out: Dict[str, Any] = {}
        for cid, st in sorted(self.states.items(), key=lambda kv: kv[0]._key()):
            if cid.is_root and not is_internal_root_name(cid.name) and st.materialized:
                out[cid.name] = self._deep(st)  # type: ignore[index]
        return out

    def _deep(self, st: ContainerState) -> Any:
        v = st.get_value()
        if isinstance(st, TreeState):
            return self._deep_tree(st)
        return self._resolve(v)

    def _resolve(self, v: Any) -> Any:
        if isinstance(v, ContainerID):
            child = self.states.get(v)
            return self._deep(child) if child is not None else None
        if isinstance(v, list):
            return [self._resolve(x) for x in v]
        if isinstance(v, dict):
            return {k: self._resolve(x) for k, x in v.items()}
        return v

    def _deep_tree(self, st: TreeState) -> List[dict]:
        def node_json(t) -> dict:
            meta_st = self.states.get(st.meta_cid(t))
            return {
                "id": str(t),
                "meta": self._deep(meta_st) if meta_st else {},
                "children": [node_json(c) for c in st.children_of(t)],
            }

        return [node_json(t) for t in st.roots()]

    def fork(self) -> "DocState":
        """Deep copy via op replay is handled at doc level; DocState itself
        is not directly copyable (treap nodes are intrusive)."""
        raise NotImplementedError


def compose_many(diffs: List[Diff]) -> Diff:
    """Balanced fold so composing n single-op diffs costs O(n log n)
    (the reference gets the same via its B-tree DeltaRope)."""
    assert diffs
    items = list(diffs)
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(items[i].compose(items[i + 1]))  # type: ignore[union-attr]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]
