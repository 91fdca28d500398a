"""Presence plane: Awareness/EphemeralStore served over session fan-out
(the port of loro_tpu/sync/presence.py).

`awareness.py` holds the reference's presence types (peer -> LWW state
outside the CRDT history); this module is the serving side, riding the same session fan-out as delta
notifications while never touching the oplog or the device fleet:

- the server keeps ONE aggregated ``Awareness`` (every session's
  latest state) and ONE ``EphemeralStore`` (shared key->LWW values);
- a session publishes via ``set_state`` (server-encoded) or relays a
  client-encoded blob via ``broadcast``; either way the blob lands in
  every OTHER subscribed session's presence inbox verbatim — apply
  order does not matter (counter/timestamp LWW, the apply-order
  independence tests in tests/test_sync.py);
- **TTL expiry**: a departed session (closed, or idle past
  ``session_ttl``) has its peer dropped from the aggregated view and a
  departure blob (bumped counter, ``None`` state) fanned out so client
  views converge on the departure without waiting out their own local
  Awareness timeout.

Blob wire formats are `awareness.py`'s (magic ``LTAW`` / ``LTEP``);
a malformed relay raises the ValueError to the RELAYING session and is
never fanned out.
"""
from __future__ import annotations

import time
from typing import List, Optional

from ..awareness import Awareness, EphemeralStore
from ..obs import metrics as obs
from ..resilience import faultinject

faultinject.register_site(
    "session_stall", "presence fan-out delivery: delay one session's "
    "presence slot (shared with the delta fan-out site)")


class PresencePlane:
    """Owned by a SyncServer; all methods take the server lock.
    ``clock`` is the injectable presence wall clock, threaded into the
    Awareness/EphemeralStore LWW timestamps and TTL expiry (fake-clock
    tests drive expiry without sleeping)."""

    def __init__(self, server, ttl_s: float = 30.0, clock=None):
        self._server = server
        self.ttl_s = ttl_s
        self.clock = clock if clock is not None else time.time
        # the aggregated view: peer 0 is the server itself (it never
        # publishes state, so it never appears in the peers map)
        self.awareness = Awareness(peer=0, timeout_s=ttl_s, clock=self.clock)
        self.ephemeral = EphemeralStore(timeout_ms=int(ttl_s * 1000),
                                        clock=self.clock)

    # -- publishing ----------------------------------------------------
    def set_state(self, session, state) -> None:
        """Record ``state`` for the session's presence peer and fan the
        encoded single-peer blob out to the other subscribed sessions."""
        srv = self._server
        with srv._lock:
            session._touch()
            aw = self.awareness
            cur = aw.peers.get(session.peer)
            counter = (cur.counter + 1) if cur else 1
            from ..awareness import PeerInfo

            aw.peers[session.peer] = PeerInfo(state, counter, self.clock())
            blob = aw.encode([session.peer])
        self._fan_out(blob, origin=session)

    def broadcast(self, session, blob: bytes) -> None:
        """Relay a client-encoded blob: validate + apply it to the
        aggregated view (malformed -> ValueError to the relayer, no
        fan-out), then deliver verbatim to the other sessions."""
        srv = self._server
        with srv._lock:
            session._touch()
            if blob[:4] == b"LTEP":
                self.ephemeral.apply(bytes(blob))
            else:
                self.awareness.apply(bytes(blob))  # raises on bad magic
        self._fan_out(blob, origin=session)

    def _fan_out(self, blob: bytes, origin=None,
                 sessions: Optional[list] = None) -> None:
        srv = self._server
        with srv._lock:
            targets = sessions if sessions is not None else [
                s for s in srv._sessions.values()
                if s.subscribed and s is not origin and not s.closed
            ]
        n = 0
        for s in targets:
            # a stalled session delays only its own delivery slot
            faultinject.check("session_stall")
            with srv._lock:
                if not s.closed:
                    s._push_presence(blob)
                    n += 1
        with srv._lock:
            srv._wakeup.notify_all()
        obs.counter(
            "sync.presence_broadcasts_total",
            "presence blobs fanned out (per receiving session)",
        ).inc(n, family=srv.family)

    # -- departure / expiry --------------------------------------------
    def drop_peer(self, peer: int) -> None:
        """Forget a departed session's presence and fan out a departure
        blob (bumped counter, None state) so remote views converge."""
        srv = self._server
        with srv._lock:
            aw = self.awareness
            cur = aw.peers.pop(peer, None)
            if cur is None:
                return
            from ..awareness import PeerInfo

            # transient re-insert at a bumped counter so the encoded
            # departure wins LWW against the peer's last real state
            aw.peers[peer] = PeerInfo(None, cur.counter + 1, self.clock())
            blob = aw.encode([peer])
            del aw.peers[peer]
        self._fan_out(blob)

    def expire(self) -> List[int]:
        """Drop aggregated entries older than the TTL (sessions that
        died without disconnecting keep their last blob forever
        otherwise).  Returns the dropped peers.  Session-level expiry
        (replica floors etc.) is ``SyncServer.expire_sessions``."""
        with self._server._lock:
            dead = self.awareness.remove_outdated()
            self.ephemeral.remove_outdated()
        for p in dead:
            obs.counter(
                "sync.presence_expired_total",
                "presence peers dropped by TTL expiry",
            ).inc(family=self._server.family)
        return dead

    # -- reads ---------------------------------------------------------
    def states(self) -> dict:
        with self._server._lock:
            return self.awareness.get_all_states()

    def ephemeral_states(self) -> dict:
        with self._server._lock:
            return self.ephemeral.get_all_states()
