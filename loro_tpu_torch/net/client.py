"""NetClient: blocking TCP client for the net edge.

Single-threaded and synchronous on purpose — it is the test/bench/
soak-side half of the wire contract, one thread per simulated client
replica.  The client's ``frontiers`` (doc -> VersionVector) are its
COMPLETE resume token: ``connect()`` ships them in HELLO, so after any
disconnect — graceful ``close()``, an abrupt ``kill()`` (the simulated
SIGKILL), or a real process death — ``reconnect()`` is just a new
socket + the same HELLO, and the first ``pull()`` per doc is exactly
the delta since what this client already holds (eg-walker updates-
since-frontier; the server keeps NO session state across disconnects).

Keep ``frontiers`` honest and resume loses nothing: ``pull()`` merges
the DELTA frontier in automatically; after importing your own pushes
into your local doc, call ``set_frontier(di, doc.oplog_vv())`` (or
just pull once) so the server does not re-serve your own ops — though
re-serving is SAFE (CRDT import is idempotent), it is wasted bytes.

Typed errors cross the wire: an ERROR frame re-raises the same
exception types the in-process ``Session`` raises (``PushRejected``,
``StaleFrontier``, ``NotLeader`` carrying the leader address for
redirect, ``ReplicaLag``, ...); transport failures raise ``NetError``;
damaged frames raise ``CodecDecodeError``.
"""
from __future__ import annotations

import socket
from typing import Dict, Optional

from ..core.version import VersionVector
from ..errors import CodecDecodeError, NetError
from . import config as netcfg
from . import wire


class NetClient:
    def __init__(self, host: str, port: int, family: str,
                 client_id: str = "", *, max_frame: Optional[int] = None,
                 timeout: float = 30.0):
        self.host = host
        self.port = port
        self.family = family
        self.client_id = client_id
        self.max_frame = netcfg.resolve_max_frame(max_frame)
        self.timeout = timeout
        self.frontiers: Dict[int, VersionVector] = {}
        self.hello_info: Optional[dict] = None
        self.last_push: Optional[dict] = None
        self.last_pull: Optional[dict] = None
        self._sock: Optional[socket.socket] = None
        self._rid = 0
        self._events = []  # unsolicited EVENT payloads between rpcs

    # -- connection lifecycle -------------------------------------------
    def connect(self) -> dict:
        """Dial + HELLO (with the current frontiers as the resume
        token).  Returns the HELLO_OK info dict."""
        if self._sock is not None:
            raise NetError("already connected; close() or kill() first")
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send(wire.encode_hello(
            self.family, self.client_id, self.frontiers))
        t, fields = self._expect(wire.HELLO_OK)
        self.hello_info = fields
        return fields

    def reconnect(self) -> dict:
        """Resume: fresh socket, HELLO with the frontiers this client
        already holds.  Safe after ``kill()`` or a server-side close."""
        if self._sock is not None:
            self.kill()
        return self.connect()

    def close(self) -> None:
        """Graceful: BYE, then close."""
        if self._sock is None:
            return
        try:
            self._send(wire.encode_bye())
        except (NetError, OSError):
            pass
        self.kill()

    def kill(self) -> None:
        """Abrupt close — the in-process stand-in for a SIGKILLed
        client process: no BYE, no drain, the server finds out from
        the dead socket."""
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    @property
    def connected(self) -> bool:
        return self._sock is not None

    # -- operations -----------------------------------------------------
    def push(self, di: int, data: bytes,
             timeout: Optional[float] = None) -> dict:
        """Push one updates blob; blocks for PUSH_ACK.  Returns
        ``{"epoch", "durable_epoch", "trace_id"}`` — ``durable_epoch``
        is the server's acked-fsync watermark (None on a non-durable
        server): everything at or below it survives a server crash."""
        rid = self._next_rid()
        self._send(wire.encode_push(rid, di, bytes(data)))
        t, fields = self._expect(wire.PUSH_ACK, rid=rid, timeout=timeout)
        self.last_push = fields
        return fields

    def pull(self, di: int, min_epoch: Optional[int] = None) -> bytes:
        """Delta since this client's frontier (byte-identical to the
        in-process ``Session.pull``).  Merges the served frontier into
        ``self.frontiers[di]``; ``self.last_pull["first_sync"]`` tells
        a fresh doc to import a snapshot."""
        rid = self._next_rid()
        self._send(wire.encode_pull(rid, di, min_epoch))
        t, fields = self._expect(wire.DELTA, rid=rid)
        vv = self.frontiers.get(di)
        if vv is None:
            self.frontiers[di] = fields["new_vv"].copy()
        else:
            vv.merge(fields["new_vv"])
        self.last_pull = {"di": di, "first_sync": fields["first_sync"],
                          "bytes": len(fields["payload"])}
        return fields["payload"]

    def poll(self, timeout_s: float = 0.0) -> dict:
        """Long-poll for activity: ``{"docs": {di: epoch}, "presence":
        [blobs]}`` (empty members = nothing before the deadline).
        Pending unsolicited events drained between rpcs merge in."""
        rid = self._next_rid()
        self._send(wire.encode_poll(rid, int(timeout_s * 1000)))
        t, fields = self._expect(
            wire.EVENT, rid=rid, timeout=self.timeout + timeout_s)
        out = {"docs": dict(fields["docs"]),
               "presence": list(fields["presence"])}
        for ev in self._events:
            for di, ep in ev["docs"].items():
                if out["docs"].get(di, -1) < ep:
                    out["docs"][di] = ep
            out["presence"].extend(ev["presence"])
        self._events.clear()
        return out

    def broadcast_presence(self, blob: bytes) -> None:
        """Fire-and-forget presence relay (no acknowledgement)."""
        self._send(wire.encode_presence(bytes(blob)))

    def status(self, timeout: Optional[float] = None) -> dict:
        """Admin probe: the server's aggregated health verdict (the
        ``/status.json`` object plus the server's ``net`` section).  A
        server with no health plane installed answers ``{"verdict":
        "unknown", ...}`` rather than an error."""
        import json

        rid = self._next_rid()
        self._send(wire.encode_status(rid))
        t, fields = self._expect(wire.STATUS_OK, rid=rid, timeout=timeout)
        return json.loads(fields["payload"].decode("utf-8"))

    def set_frontier(self, di: int, vv: VersionVector) -> None:
        """Install/advance the resume frontier for one doc (merge —
        never regresses)."""
        cur = self.frontiers.get(di)
        if cur is None:
            self.frontiers[di] = vv.copy()
        else:
            cur.merge(vv)

    # -- wire plumbing --------------------------------------------------
    def _next_rid(self) -> int:
        self._rid += 1
        return self._rid

    def _require_sock(self) -> socket.socket:
        if self._sock is None:
            raise NetError("not connected (connect()/reconnect() first)")
        return self._sock

    def _send(self, body: bytes) -> None:
        s = self._require_sock()
        try:
            s.sendall(wire.frame(body, self.max_frame))
        except OSError as e:
            self.kill()
            raise NetError(f"send failed: {e}") from e

    def _recv_exact(self, n: int) -> bytes:
        s = self._require_sock()
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = s.recv(n - len(buf))
            except socket.timeout as e:
                raise NetError(
                    f"timed out waiting for {n - len(buf)} more bytes "
                    f"after {self.timeout}s") from e
            except OSError as e:
                self.kill()
                raise NetError(f"recv failed: {e}") from e
            if not chunk:
                self.kill()
                raise NetError("connection closed by the server")
            buf += chunk
        return bytes(buf)

    def _recv_frame(self):
        header = self._recv_exact(wire.HEADER_LEN)
        body_len, crc = wire.parse_header(header, self.max_frame)
        body = wire.check_body(self._recv_exact(body_len), crc)
        return wire.decode(body)

    def _expect(self, want_type: int, rid: Optional[int] = None,
                timeout: Optional[float] = None):
        """Read frames until the wanted (type, rid) answer.  ERROR
        frames for this rid (or connection-level rid 0) re-raise
        typed; unsolicited EVENTs stash for the next ``poll()``."""
        s = self._require_sock()
        if timeout is not None:
            s.settimeout(timeout)
        try:
            while True:
                t, fields = self._recv_frame()
                if t == wire.ERROR:
                    if rid is None or fields["rid"] in (0, rid):
                        wire.raise_error(fields)
                    continue  # a stale request's error: not ours
                if t == wire.BYE:
                    self.kill()
                    raise NetError("server said BYE (shutting down)")
                if t == wire.EVENT and (rid is None
                                        or fields.get("rid") != rid):
                    self._events.append(fields)
                    continue
                if t == want_type and (rid is None
                                       or fields.get("rid") == rid):
                    return t, fields
                raise CodecDecodeError(
                    f"unexpected {wire.TYPE_NAMES.get(t, t)} frame "
                    f"(wanted {wire.TYPE_NAMES.get(want_type)})")
        finally:
            if timeout is not None and self._sock is not None:
                self._sock.settimeout(self.timeout)

    def __enter__(self) -> "NetClient":
        if self._sock is None:
            self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
