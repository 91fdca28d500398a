"""Checkout/diff history cache.

reference: crates/loro-internal/src/history_cache.rs:36-54 — the
reference builds per-container BTree indexes keyed
(container, key, lamport, peer) so its DiffCalculators can find the
ops between two versions in O(changed).

Design: this framework's container states are
structure-holding (elements + tombstones), so a materialized state at
any version is itself the perfect "index" — replaying forward from the
nearest cached state costs O(ops between the versions).  The cache
therefore keeps a small LRU of compressed state snapshots at recently
visited versions; checkout / diff / undo (all of which funnel through
LoroDoc._state_at_vv) replay from the best cached floor instead of the
empty/shallow floor.  Repeated time travel in a region of history is
O(changed), not O(history).
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

from .core.version import Frontiers, VersionVector


class StateCheckpointCache:
    """LRU of (vv, frontiers, compressed state bytes).

    States are cached by value (encoded + compressed) so cache entries
    can never alias the live mutable DocState.  History is append-only
    and states are version-determined, so entries never invalidate.
    """

    def __init__(self, capacity: int = 12):
        self.capacity = capacity
        # most-recently-used last
        self._entries: List[Tuple[VersionVector, Frontiers, bytes]] = []
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, vv: VersionVector, frontiers: Frontiers, state) -> None:
        from .codec.snapshot import encode_doc_state

        for i, (evv, _f, _b) in enumerate(self._entries):
            if evv == vv:
                self._entries.append(self._entries.pop(i))
                return
        z = zlib.compress(encode_doc_state(state, state.parents), 1)
        self._entries.append((vv.copy(), frontiers, z))
        if len(self._entries) > self.capacity:
            self._entries.pop(0)

    def best_floor(self, target_vv: VersionVector):
        """Decoded state at the largest cached version <= target_vv, or
        None.  Returns (state, vv, frontiers)."""
        from .codec.snapshot import decode_doc_state
        from .state import DocState

        best_i = -1
        best_ops = -1
        for i, (evv, _f, _b) in enumerate(self._entries):
            if evv <= target_vv:
                ops = evv.total_ops()
                if ops > best_ops:
                    best_ops, best_i = ops, i
        if best_i < 0:
            self.misses += 1
            return None
        self.hits += 1
        vv, f, z = self._entries.pop(best_i)
        self._entries.append((vv, f, z))  # LRU touch
        states, parents = decode_doc_state(zlib.decompress(z))
        st = DocState()
        st.states = states
        st.parents.update(parents)
        st.vv = vv.copy()
        st.frontiers = f
        return st, vv, f

    def clear(self) -> None:
        self._entries.clear()
