"""Presence: Awareness + EphemeralStore.

reference: crates/loro-internal/src/awareness.rs — non-persistent
peer-presence state outside the CRDT history: `Awareness` maps peer ->
(state value, counter, timestamp); `EphemeralStore` is a key->value LWW
store by wall-clock timestamp with inactivity expiry and its own little
wire format + local/remote subscriptions.
"""
from __future__ import annotations

import json
import struct
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .core.ids import PeerID


@dataclass
class PeerInfo:
    state: Any
    counter: int
    timestamp: float


class Awareness:
    """``clock`` is injectable (fake-clock tests drive TTL expiry the
    way DeviceSupervisor retry tests do); the produced wall-clock
    timestamps are presence metadata, never CRDT history."""

    def __init__(self, peer: PeerID, timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.time):
        self.peer = peer
        self.timeout_s = timeout_s
        self.clock = clock
        self.peers: Dict[PeerID, PeerInfo] = {}

    def set_local_state(self, state: Any) -> None:
        cur = self.peers.get(self.peer)
        counter = (cur.counter + 1) if cur else 1
        self.peers[self.peer] = PeerInfo(state, counter, self.clock())

    def get_local_state(self) -> Any:
        info = self.peers.get(self.peer)
        return info.state if info else None

    def encode(self, peers: Optional[List[PeerID]] = None) -> bytes:
        """Compact binary presence blob: magic 'LTAW' + varint count +
        per entry (u64 peer, varint counter, len-prefixed json state)."""
        from .codec.binary import Writer

        w = Writer()
        w.buf += b"LTAW"
        entries = [
            (p, info)
            for p, info in self.peers.items()
            if peers is None or p in peers
        ]
        w.varint(len(entries))
        for p, info in entries:
            w.u64le(p)
            w.varint(info.counter)
            w.bytes_(json.dumps(info.state).encode())
        return bytes(w.buf)

    def encode_all(self) -> bytes:
        return self.encode()

    def apply(self, data: bytes) -> Tuple[List[PeerID], List[PeerID]]:
        """Returns (updated peers, added peers).  Raises ValueError on
        malformed blobs."""
        from .codec.binary import Reader

        if data[:4] != b"LTAW":
            raise ValueError("bad awareness blob")
        try:
            r = Reader(data[4:])
            entries = []
            for _ in range(r.varint()):
                p = r.u64le()
                counter = r.varint()
                state = json.loads(r.bytes_().decode())
                entries.append((p, counter, state))
        except (IndexError, ValueError, struct.error) as e:
            raise ValueError(f"malformed awareness blob: {e}") from e
        updated, added = [], []
        now = self.clock()
        for p, counter, state in entries:
            cur = self.peers.get(p)
            if cur is None:
                self.peers[p] = PeerInfo(state, counter, now)
                added.append(p)
            elif counter > cur.counter:
                self.peers[p] = PeerInfo(state, counter, now)
                updated.append(p)
        return updated, added

    def remove_outdated(self) -> List[PeerID]:
        now = self.clock()
        dead = [p for p, i in self.peers.items() if now - i.timestamp > self.timeout_s]
        for p in dead:
            del self.peers[p]
        return dead

    def get_all_states(self) -> Dict[PeerID, Any]:
        return {p: i.state for p, i in self.peers.items()}


@dataclass
class _Entry:
    value: Any
    timestamp: float
    deleted: bool = False


class EphemeralStore:
    """key -> LWW-by-timestamp value with inactivity expiry.
    reference: awareness.rs:250+ EphemeralStore."""

    def __init__(self, timeout_ms: int = 30_000,
                 clock: Callable[[], float] = time.time):
        self.timeout_ms = timeout_ms
        self.clock = clock  # injectable (fake-clock expiry tests)
        self._data: Dict[str, _Entry] = {}
        self._local_subs: List[Callable[[bytes], None]] = []
        self._subs: List[Callable[[dict], None]] = []

    # -- local mutation -----------------------------------------------
    def set(self, key: str, value: Any) -> None:
        self._data[key] = _Entry(value, self.clock() * 1000)
        self._emit_local([key])
        self._emit({"by": "local", "added": [], "updated": [key], "removed": []})

    def delete(self, key: str) -> None:
        if key in self._data:
            self._data[key] = _Entry(None, self.clock() * 1000, deleted=True)
            self._emit_local([key])
            self._emit({"by": "local", "added": [], "updated": [], "removed": [key]})

    def get(self, key: str) -> Any:
        e = self._data.get(key)
        return None if e is None or e.deleted else e.value

    def keys(self) -> List[str]:
        self.remove_outdated()
        return sorted(k for k, e in self._data.items() if not e.deleted)

    def get_all_states(self) -> Dict[str, Any]:
        self.remove_outdated()
        return {k: e.value for k, e in self._data.items() if not e.deleted}

    # -- wire ---------------------------------------------------------
    def encode(self, key: Optional[str] = None) -> bytes:
        """Compact binary: magic 'LTEP' + varint count + per entry
        (len-prefixed key, f64 timestamp, u8 deleted, json value)."""
        from .codec.binary import Writer

        w = Writer()
        w.buf += b"LTEP"
        items = [
            (k, e) for k, e in self._data.items() if key is None or k == key
        ]
        w.varint(len(items))
        for k, e in items:
            w.str_(k)
            w.f64(e.timestamp)
            w.u8(1 if e.deleted else 0)
            w.bytes_(json.dumps(e.value).encode())
        return bytes(w.buf)

    def encode_all(self) -> bytes:
        return self.encode()

    def apply(self, data: bytes) -> None:
        from .codec.binary import Reader

        if data[:4] != b"LTEP":
            raise ValueError("bad ephemeral blob")
        try:
            r = Reader(data[4:])
            decoded = []
            for _ in range(r.varint()):
                k = r.str_()
                t = r.f64()
                d = bool(r.u8())
                v = json.loads(r.bytes_().decode())
                decoded.append({"k": k, "v": v, "t": t, "d": d})
        except (IndexError, ValueError, struct.error) as e:
            raise ValueError(f"malformed ephemeral blob: {e}") from e
        added, updated, removed = [], [], []
        for it in decoded:
            k = it["k"]
            cur = self._data.get(k)
            if cur is None or it["t"] > cur.timestamp:
                existed = cur is not None and not cur.deleted
                self._data[k] = _Entry(it["v"], it["t"], it.get("d", False))
                if it.get("d", False):
                    if existed:
                        removed.append(k)
                elif existed:
                    updated.append(k)
                else:
                    added.append(k)
        if added or updated or removed:
            self._emit({"by": "import", "added": added, "updated": updated, "removed": removed})

    def remove_outdated(self) -> List[str]:
        now = self.clock() * 1000
        dead = [k for k, e in self._data.items() if now - e.timestamp > self.timeout_ms]
        removed = []
        for k in dead:
            if not self._data[k].deleted:
                removed.append(k)
            del self._data[k]
        if removed:
            self._emit({"by": "timeout", "added": [], "updated": [], "removed": removed})
        return removed

    # -- subscriptions ------------------------------------------------
    def subscribe_local_update(self, cb: Callable[[bytes], None]) -> Callable[[], None]:
        self._local_subs.append(cb)
        return lambda: self._local_subs.remove(cb)

    def subscribe(self, cb: Callable[[dict], None]) -> Callable[[], None]:
        self._subs.append(cb)
        return lambda: self._subs.remove(cb)

    def _emit_local(self, keys: List[str]) -> None:
        if self._local_subs:
            from .codec.binary import Writer

            w = Writer()
            w.buf += b"LTEP"
            w.varint(len(keys))
            for k in keys:
                e = self._data[k]
                w.str_(k)
                w.f64(e.timestamp)
                w.u8(1 if e.deleted else 0)
                w.bytes_(json.dumps(e.value).encode())
            payload = bytes(w.buf)
            for cb in self._local_subs:
                cb(payload)

    def _emit(self, ev: dict) -> None:
        for cb in list(self._subs):
            cb(ev)
