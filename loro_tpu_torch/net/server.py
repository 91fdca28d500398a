"""NetServer: asyncio TCP front over a SyncServer (the port of
loro_tpu/net/server.py, imports changed).

One accepted connection = one ``sync.Session``.  The event loop runs
in a dedicated thread ("loro-net-loop") beside the threaded resident
planes; blocking session calls (push backpressure, pulls, presence)
run on a small thread pool so the loop never blocks, and the per-
connection dispatch is SERIAL — a push stalled on the bounded FanIn
suspends that connection's reader, which stops draining its socket,
which is TCP backpressure to exactly the client that caused it.
Pushes are never dropped.

Fan-out maps onto the existing ``poll()`` coalescing: a connection
holds at most ONE pending long-poll; a newer POLL answers the
superseded one empty (drop-oldest, like the presence inbox), and the
notifier thread waits on the SyncServer wakeup condition to answer
polls the moment commits land.  The per-connection send queue is
bounded: a reader too slow to drain even the coalesced stream fails
typed (``NetError``, counted) instead of growing an unbounded buffer.

Acks ride a dedicated acker thread: it blocks on each ``PushTicket``
in the connection's FIFO order, appends the ``net.ack`` / ``net.send``
stage marks (the breakdown keeps telescoping to the total — the chaos
``attribution`` invariant), and enqueues PUSH_ACK carrying the visible
epoch, the durable watermark, and the server trace id.

Failure contract: a damaged frame (crc / truncation / the ``net_frame``
fault) fails ONLY that connection, typed; an armed ``net_accept``
fault refuses new connections while live sessions keep serving;
``conn_stall`` delays one connection's writer (a slow reader socket)
or tears it down typed.  Sync-layer outcomes (``PushRejected``,
``StaleFrontier``, ``NotLeader`` with the leader address, ...) cross
the wire as ERROR frames and the connection keeps serving.

Fault sites: ``net_accept`` / ``net_frame`` / ``conn_stall``.
"""
from __future__ import annotations

import asyncio
import functools
import queue as _queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from ..analysis.lockwitness import named_lock
from ..errors import (
    CodecDecodeError, NetError, NetProtocolError, NotLeader, PushRejected,
    ReplicaLag, SessionClosed, StaleFrontier, SyncError,
)
from ..obs import flight
from ..obs import metrics as obs
from ..resilience import faultinject
from . import config as netcfg
from . import wire

faultinject.register_site(
    "net_accept", "net.NetServer accept path: refuse the next accepted "
    "connection(s) typed — live connections and sessions unaffected")
faultinject.register_site(
    "net_frame", "net.NetServer frame reader: mangle one received "
    "frame's bytes on their way to the crc gate (truncate/bitflip -> "
    "typed CodecDecodeError failing ONLY that connection)")
faultinject.register_site(
    "conn_stall", "net.NetServer per-connection writer: delay = a "
    "stalled/slow reader socket (bounded send-queue backpressure); "
    "raise = typed teardown of that one connection")

_ACK_TIMEOUT_S = 120.0
_SEND_QUEUE_CAP = 256
_NOTIFY_TICK_S = 0.05


class _Conn:
    """Per-connection state (owned by the loop thread; ``pending_poll``
    and registry membership are shared under the ``net.accept`` lock)."""

    __slots__ = (
        "cid", "reader", "writer", "session", "sendq", "writer_task",
        "reader_task", "last_activity", "client_id", "closing",
        "pending_poll", "peer",
    )

    def __init__(self, cid: int, reader, writer):
        self.cid = cid
        self.reader = reader
        self.writer = writer
        self.session = None
        self.sendq: Optional[asyncio.Queue] = None
        self.writer_task = None
        self.reader_task = None
        self.last_activity = 0.0
        self.client_id = ""
        self.closing = False
        self.pending_poll = None  # (rid, deadline) under the net lock
        self.peer = ""


class NetServer:
    """TCP front for one ``SyncServer`` (or ``ReadOnlySyncServer`` on a
    follower — pushes then answer typed NOT_LEADER carrying the leader
    address so clients redirect instead of guessing).

    ``NetServer(sync)`` binds ``127.0.0.1`` on an ephemeral port (see
    ``server.port``); knobs default from the environment with typed
    first-use validation (``net/config.py``).  ``clock=`` injects the
    idle/deadline clock (tests); stage marks use ``time.perf_counter``
    like the tickets they extend.  The server does NOT own the
    SyncServer's lifecycle — ``close()`` drains and detaches only the
    network edge.
    """

    def __init__(self, sync, host: str = "127.0.0.1",
                 port: Optional[int] = None, *,
                 max_frame: Optional[int] = None,
                 backlog: Optional[int] = None,
                 max_connections: Optional[int] = None,
                 idle_timeout: Optional[float] = None,
                 leader_addr: Optional[str] = None,
                 clock=None, health=None):
        self._sync = sync
        self._health = health  # explicit plane beats health.active()
        self.host = host
        self.max_frame = netcfg.resolve_max_frame(max_frame)
        self._backlog = netcfg.resolve_backlog(backlog)
        self.max_connections = netcfg.resolve_max_conns(max_connections)
        self.idle_timeout = netcfg.resolve_idle_s(idle_timeout)
        self.leader_addr = leader_addr
        self._clock = clock if clock is not None else time.monotonic
        self._lock = named_lock("net.accept")
        self._conns: Dict[int, _Conn] = {}
        self._next_cid = 1
        self._next_sid = 1
        self._closed = False
        self._stopping = False
        # counters mirrored into report() (obs counters are process-
        # global; these are THIS server's numbers for the net sidecar)
        self._accepted = 0
        self._refused = 0
        self._frame_errors = 0
        self._resumes = 0
        self._pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="loro-net-io")
        self._ackq: _queue.SimpleQueue = _queue.SimpleQueue()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run_loop, name="loro-net-loop", daemon=True)
        self._thread.start()
        want_port = netcfg.resolve_port(port)
        try:
            self.port = asyncio.run_coroutine_threadsafe(
                self._start(want_port), self._loop).result(timeout=30.0)
        except BaseException:
            self._stop_loop()
            raise
        self._acker = threading.Thread(
            target=self._ack_loop, name="loro-net-acker", daemon=True)
        self._acker.start()
        self._notifier = threading.Thread(
            target=self._notify_loop, name="loro-net-notify", daemon=True)
        self._notifier.start()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- loop lifecycle -------------------------------------------------
    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def _stop_loop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10.0)

    async def _start(self, port: int) -> int:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, port, backlog=self._backlog)
        if self.idle_timeout > 0:
            self._idle_task = asyncio.ensure_future(self._idle_loop())
        else:
            self._idle_task = None
        return self._server.sockets[0].getsockname()[1]

    # -- accept path ----------------------------------------------------
    async def _handle_conn(self, reader, writer) -> None:
        with self._lock:
            n_live = len(self._conns)
        refuse = None
        if self._stopping:
            refuse = "closing"
        elif n_live >= self.max_connections:
            refuse = f"at the {self.max_connections}-connection cap"
        else:
            try:
                await self._loop.run_in_executor(
                    self._pool,
                    functools.partial(faultinject.check, "net_accept"))
            except Exception as e:  # noqa: BLE001 — any armed net_accept fault refuses exactly this connection; the accept loop itself keeps serving
                refuse = f"injected accept fault: {type(e).__name__}: {e}"
        if refuse is not None:
            with self._lock:
                self._refused += 1
            obs.counter(
                "net.accept_refusals_total",
                "connections refused at accept (cap / fault / closing)",
            ).inc(family=self._sync.family)
            flight.record("net.error", family=self._sync.family,
                          err="accept_refused", detail=refuse)
            try:
                writer.close()
            except OSError:
                pass
            return
        with self._lock:
            cid = self._next_cid
            self._next_cid += 1
            conn = _Conn(cid, reader, writer)
            conn.last_activity = self._clock()
            try:
                conn.peer = "%s:%s" % writer.get_extra_info(
                    "peername", ("?", "?"))[:2]
            except (TypeError, IndexError):
                conn.peer = "?"
            self._conns[cid] = conn
            self._accepted += 1
            n_live = len(self._conns)
        conn.sendq = asyncio.Queue(maxsize=_SEND_QUEUE_CAP)
        conn.writer_task = asyncio.ensure_future(self._writer_loop(conn))
        conn.reader_task = asyncio.current_task()
        obs.counter("net.connections_total",
                    "connections accepted").inc(family=self._sync.family)
        obs.gauge("net.connections", "live net connections").set(
            n_live, family=self._sync.family)
        flight.record("net.accept", family=self._sync.family, conn=cid,
                      peer=conn.peer)
        try:
            await self._serve(conn)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # peer went away (incl. SIGKILLed clients): clean close
        except (NetError, CodecDecodeError) as e:
            # frame-layer violation: fail ONLY this connection, typed
            with self._lock:
                self._frame_errors += 1
            obs.counter(
                "net.frame_errors_total",
                "connections failed on a damaged/protocol-violating frame",
            ).inc(family=self._sync.family)
            flight.record("net.error", family=self._sync.family, conn=cid,
                          err=type(e).__name__, detail=str(e)[:200])
            code = (wire.E_BAD_VERSION if isinstance(e, NetProtocolError)
                    else wire.E_BAD_FRAME)
            await self._try_send_error(conn, 0, code, str(e))
        except Exception as e:  # noqa: BLE001 — last-resort isolation: an unexpected dispatch error must fail one connection typed, never the accept loop
            obs.counter(
                "net.internal_errors_total",
                "connections failed on an unexpected server-side error",
            ).inc(family=self._sync.family)
            flight.record("net.error", family=self._sync.family, conn=cid,
                          err=type(e).__name__, detail=str(e)[:200])
            await self._try_send_error(conn, 0, wire.E_INTERNAL, str(e))
        finally:
            await self._close_conn(conn)

    async def _serve(self, conn: _Conn) -> None:
        body = await self._read_frame(conn)
        t, fields = wire.decode(body)
        if t != wire.HELLO:
            raise NetProtocolError(
                f"first frame must be HELLO, got {wire.TYPE_NAMES.get(t, t)}")
        await self._handle_hello(conn, fields)
        while not conn.closing:
            body = await self._read_frame(conn)
            t, fields = wire.decode(body)
            if t == wire.BYE:
                return
            await self._dispatch(conn, t, fields)

    async def _read_frame(self, conn: _Conn) -> bytes:
        header = await conn.reader.readexactly(wire.HEADER_LEN)
        body_len, crc = wire.parse_header(header, self.max_frame)
        body = await conn.reader.readexactly(body_len)
        conn.last_activity = self._clock()
        obs.counter("net.frames_total", "frames on the wire").inc(
            family=self._sync.family, dir="in")
        obs.counter("net.bytes_total", "bytes on the wire").inc(
            body_len + wire.HEADER_LEN, family=self._sync.family, dir="in")
        body = faultinject.mangle("net_frame", body)
        return wire.check_body(body, crc)

    async def _handle_hello(self, conn: _Conn, fields: dict) -> None:
        sync = self._sync
        if fields["version"] != wire.PROTO_VERSION:
            await self._try_send_error(
                conn, 0, wire.E_BAD_VERSION,
                f"protocol version {fields['version']} unsupported "
                f"(server speaks {wire.PROTO_VERSION})")
            raise NetProtocolError(
                f"client protocol version {fields['version']} != "
                f"{wire.PROTO_VERSION}")
        if fields["family"] != sync.family:
            await self._try_send_error(
                conn, 0, wire.E_BAD_VERSION,
                f"server serves family {sync.family!r}, "
                f"not {fields['family']!r}")
            raise NetProtocolError(
                f"family mismatch: client {fields['family']!r}, "
                f"server {sync.family!r}")
        conn.client_id = fields["client_id"]
        with self._lock:
            sid = f"net-{conn.client_id or 'anon'}-{self._next_sid}"
            self._next_sid += 1
        frontiers = fields["frontiers"]

        def _connect():
            s = sync.connect(sid=sid)
            resumed = 0
            # the HELLO frontiers ARE the session state a disconnect
            # dropped: install them so the first pull is exactly a
            # delta-since-frontier (eg-walker resume)
            with sync._lock:
                for di, vv in frontiers.items():
                    if 0 <= di < sync.n_docs and len(vv):
                        s._vv[di] = vv.copy()
                        resumed += 1
            return s, resumed

        conn.session, resumed = await self._loop.run_in_executor(
            self._pool, _connect)
        if conn.closing:
            return
        if resumed:
            with self._lock:
                self._resumes += 1
            obs.counter(
                "net.resumes_total",
                "connections that resumed with a non-empty HELLO frontier",
            ).inc(family=sync.family)
            flight.record("net.resume", family=sync.family, conn=conn.cid,
                          client=conn.client_id, docs=resumed)
        self._enqueue(conn, wire.encode_hello_ok(
            sync.family, sync.n_docs, sync.epoch, sid, resumed))

    # -- dispatch -------------------------------------------------------
    async def _dispatch(self, conn: _Conn, t: int, fields: dict) -> None:
        if conn.session is None or conn.session.closed:
            raise SessionClosed("connection has no live session")
        rid = fields.get("rid", 0)
        try:
            if t == wire.PUSH:
                await self._handle_push(conn, fields)
            elif t == wire.PULL:
                await self._handle_pull(conn, fields)
            elif t == wire.POLL:
                await self._handle_poll(conn, fields)
            elif t == wire.PRESENCE:
                await self._loop.run_in_executor(
                    self._pool, conn.session.broadcast_presence,
                    fields["blob"])
            elif t == wire.STATUS:
                body = await self._loop.run_in_executor(
                    self._pool, self._status_payload)
                self._enqueue(conn, wire.encode_status_ok(rid, body))
            elif t == wire.HELLO:
                raise NetProtocolError("HELLO after the handshake")
            else:
                raise NetProtocolError(
                    f"unexpected {wire.TYPE_NAMES.get(t, t)} frame "
                    "from a client")
        except (PushRejected, StaleFrontier, NotLeader, ReplicaLag,
                SessionClosed, SyncError, ValueError) as e:
            # sync-layer outcome: typed over the wire, connection LIVES
            code, leader = wire.error_code_for(e)
            if code == wire.E_NOT_LEADER and not leader:
                leader = self.leader_addr or ""
            obs.counter(
                "net.request_errors_total",
                "requests answered with a typed ERROR frame",
            ).inc(family=self._sync.family, code=wire.CODE_NAMES.get(
                code, str(code)))
            self._enqueue(conn, wire.encode_error(
                rid, code, str(e), leader))

    async def _handle_push(self, conn: _Conn, fields: dict) -> None:
        # session.push blocks on FanIn backpressure: running it on the
        # pool and awaiting suspends THIS connection's reader only —
        # its socket fills, TCP pushes back on the client (never drop)
        tk = await self._loop.run_in_executor(
            self._pool, conn.session.push, fields["di"], fields["payload"])
        self._ackq.put((conn, fields["rid"], tk))

    async def _handle_pull(self, conn: _Conn, fields: dict) -> None:
        di = fields["di"]
        sess = conn.session

        def _pull():
            data = sess.pull(di, min_epoch=fields["min_epoch"])
            lp = sess.last_pull or {}
            return data, sess.frontier(di), lp.get("path") == "snapshot"

        data, new_vv, first_sync = await self._loop.run_in_executor(
            self._pool, _pull)
        self._enqueue(conn, wire.encode_delta(
            fields["rid"], di, data, new_vv, first_sync))

    async def _handle_poll(self, conn: _Conn, fields: dict) -> None:
        rid = fields["rid"]
        timeout_ms = fields["timeout_ms"]
        deadline = self._clock() + timeout_ms / 1000.0
        with self._lock:
            old = conn.pending_poll
            conn.pending_poll = (rid, deadline)
        if old is not None:
            # drop-oldest: the superseded long-poll answers empty (the
            # newer one owns whatever activity lands), mirroring the
            # session poll()'s self-coalescing contract
            self._enqueue(conn, wire.encode_event(old[0], {}, []))
        if timeout_ms == 0:
            # non-blocking drain: answer inline instead of waiting for
            # the notifier tick
            out = await self._loop.run_in_executor(
                self._pool, functools.partial(
                    conn.session.poll, timeout=0))
            self._answer_poll(conn, out, force=True)

    # -- send path ------------------------------------------------------
    def _enqueue(self, conn: _Conn, data: bytes) -> None:
        """Queue one frame on the connection's bounded send queue (loop
        thread only — threads go through ``_send_from_thread``)."""
        if conn.closing or conn.sendq is None:
            return
        try:
            conn.sendq.put_nowait(data)
        except asyncio.QueueFull:
            obs.counter(
                "net.send_overflows_total",
                "connections failed typed: reader too slow for even the "
                "coalesced stream (bounded send queue)",
            ).inc(family=self._sync.family)
            flight.record("net.error", family=self._sync.family,
                          conn=conn.cid, err="send_overflow")
            self._fail_conn(conn, NetError(
                f"connection {conn.cid}: send queue overflow "
                f"({_SEND_QUEUE_CAP} frames queued) — the reader is not "
                "draining its socket"))

    def _send_from_thread(self, conn: _Conn, data: bytes) -> None:
        if self._closed:
            return
        try:
            self._loop.call_soon_threadsafe(self._enqueue, conn, data)
        except RuntimeError:
            pass  # loop already stopped: the connection is gone anyway

    async def _writer_loop(self, conn: _Conn) -> None:
        sync = self._sync
        try:
            while True:
                data = await conn.sendq.get()
                if data is None:
                    return
                # armed-only fast path: the stall fault runs on the
                # pool (a delay must stall THIS writer, not the loop).
                # active() is registry state; the reader's per-frame
                # mangle() already forced the LORO_FAULT env parse.
                if faultinject.active().get("conn_stall"):
                    await self._loop.run_in_executor(
                        self._pool,
                        functools.partial(faultinject.check, "conn_stall"))
                conn.writer.write(wire.frame(data, self.max_frame))
                await conn.writer.drain()
                obs.counter("net.frames_total", "frames on the wire").inc(
                    family=sync.family, dir="out")
                obs.counter("net.bytes_total", "bytes on the wire").inc(
                    len(data) + wire.HEADER_LEN, family=sync.family,
                    dir="out")
        except (ConnectionError, OSError):
            self._fail_conn(conn, None)
        except Exception as e:  # noqa: BLE001 — an injected conn_stall raise or writer failure tears down exactly this connection, typed and counted
            flight.record("net.error", family=sync.family, conn=conn.cid,
                          err=type(e).__name__, detail=str(e)[:200])
            self._fail_conn(conn, NetError(
                f"connection {conn.cid}: writer failed: "
                f"{type(e).__name__}: {e}"))

    def _fail_conn(self, conn: _Conn, _exc) -> None:
        """Tear one connection down from the loop thread (typed —
        the accept loop and every other connection keep serving)."""
        if not conn.closing:
            asyncio.ensure_future(self._close_conn(conn))

    async def _try_send_error(self, conn: _Conn, rid: int, code: int,
                              msg: str) -> None:
        """Best-effort direct ERROR write (bypasses the queue: used on
        paths that close the connection right after)."""
        try:
            conn.writer.write(wire.frame(
                wire.encode_error(rid, code, msg[:512]), self.max_frame))
            await asyncio.wait_for(conn.writer.drain(), timeout=1.0)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass

    async def _close_conn(self, conn: _Conn) -> None:
        with self._lock:
            if conn.closing:
                return
            conn.closing = True
            self._conns.pop(conn.cid, None)
            conn.pending_poll = None
            n_live = len(self._conns)
        if conn.writer_task is not None:
            try:
                conn.sendq.put_nowait(None)
            except asyncio.QueueFull:
                conn.writer_task.cancel()
            try:
                await asyncio.wait_for(conn.writer_task, timeout=5.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                pass
        try:
            conn.writer.close()
        except OSError:
            pass
        sess = conn.session
        if sess is not None and not sess.closed:
            # disconnect drops replica floors + presence; it takes the
            # sync lock, so keep it off the loop thread
            await self._loop.run_in_executor(self._pool, sess.close)
        obs.gauge("net.connections", "live net connections").set(
            n_live, family=self._sync.family)
        flight.record("net.close", family=self._sync.family, conn=conn.cid)

    # -- acker thread (PUSH_ACK + net.* stage attribution) --------------
    def _ack_loop(self) -> None:
        sync = self._sync
        resident = sync.resident
        stage_h = obs.histogram(
            "trace.push_stage_seconds",
            "per-stage push latency attribution (stages telescope to "
            "sync.push_to_visible_seconds)")
        ack_h = obs.histogram(
            "net.push_to_ack_seconds",
            "push submit -> PUSH_ACK enqueued on the wire")
        while True:
            item = self._ackq.get()
            if item is None:
                return
            conn, rid, tk = item
            try:
                ep = tk.epoch(timeout=_ACK_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001 — every ticket failure maps to ONE typed ERROR frame for its request; the acker itself must outlive any of them
                code, leader = wire.error_code_for(e)
                if isinstance(e, TimeoutError):
                    code = wire.E_UNAVAILABLE
                if code == wire.E_NOT_LEADER and not leader:
                    leader = self.leader_addr or ""
                self._send_from_thread(conn, wire.encode_error(
                    rid, code, str(e), leader))
                continue
            # net.* stage marks EXTEND the ticket's breakdown: net.ack
            # closes fanout -> acker dequeue, net.send closes the ack's
            # hop onto the send queue; sum(stages) == total still holds
            prev = tk.marks[-1][1] if tk.marks else tk.t0
            tk.mark("net.ack")
            t_ack = tk.marks[-1][1]
            stage_h.observe(t_ack - prev, family=sync.family,
                            stage="net.ack", exemplar=tk.trace_id)
            dur = (resident.durable_epoch
                   if getattr(resident, "_durable", None) is not None
                   else None)
            self._send_from_thread(conn, wire.encode_push_ack(
                rid, ep, dur, tk.trace_id or ""))
            tk.mark("net.send")
            t_send = tk.marks[-1][1]
            stage_h.observe(t_send - t_ack, family=sync.family,
                            stage="net.send", exemplar=tk.trace_id)
            ack_h.observe(t_send - tk.t0, family=sync.family,
                          exemplar=tk.trace_id)
            obs.counter("net.push_acks_total", "PUSH_ACK frames sent").inc(
                family=sync.family)

    # -- notifier thread (long-poll fan-out) ----------------------------
    def _notify_loop(self) -> None:
        sync = self._sync
        while not self._stopping:
            with sync._lock:
                sync._wakeup.wait(_NOTIFY_TICK_S)
            if self._stopping:
                return
            now = self._clock()
            with self._lock:
                conns = [c for c in self._conns.values()
                         if c.pending_poll is not None and not c.closing]
            for c in conns:
                with self._lock:
                    pp = c.pending_poll
                if pp is None:
                    continue
                sess = c.session
                if sess is None or sess.closed:
                    continue
                try:
                    out = sess.poll(timeout=0)
                except SessionClosed:
                    continue
                if out["docs"] or out["presence"]:
                    self._answer_poll(c, out)
                elif now >= pp[1]:
                    self._answer_poll(c, out)  # deadline: answer empty

    def _answer_poll(self, conn: _Conn, out: dict,
                     force: bool = False) -> None:
        """Answer the connection's CURRENT pending poll with a drained
        activity set (drained events always ride the newest rid — a
        replace between drain and answer can never lose them)."""
        with self._lock:
            pp = conn.pending_poll
            if pp is None:
                if not (force or out["docs"] or out["presence"]):
                    return
                rid = 0  # unsolicited (answered-then-drained races)
            else:
                rid = pp[0]
                conn.pending_poll = None
        obs.counter("net.events_total", "EVENT frames fanned out").inc(
            family=self._sync.family)
        self._send_from_thread(conn, wire.encode_event(
            rid, out["docs"], out["presence"]))

    # -- idle housekeeping ----------------------------------------------
    async def _idle_loop(self) -> None:
        tick = max(0.25, self.idle_timeout / 4.0)
        while not self._stopping:
            await asyncio.sleep(tick)
            cutoff = self._clock() - self.idle_timeout
            with self._lock:
                stale = [c for c in self._conns.values()
                         if c.last_activity < cutoff
                         and c.pending_poll is None and not c.closing]
            for c in stale:
                obs.counter(
                    "net.idle_closes_total",
                    "connections closed by the idle timeout",
                ).inc(family=self._sync.family)
                flight.record("net.close", family=self._sync.family,
                              conn=c.cid, reason="idle")
                await self._close_conn(c)

    # -- lifecycle ------------------------------------------------------
    def report(self) -> dict:
        """This server's connection-plane numbers (the bench ``net``
        sidecar core)."""
        with self._lock:
            return {
                "addr": self.addr,
                "connections": len(self._conns),
                "accepted": self._accepted,
                "refused": self._refused,
                "frame_errors": self._frame_errors,
                "resumes": self._resumes,
                "max_frame": self.max_frame,
                "max_connections": self.max_connections,
            }

    def _status_payload(self) -> bytes:
        """JSON bytes for a STATUS_OK frame: the aggregated health
        verdict (explicit ``health=`` plane, else the process-installed
        one, else the typed "unknown" stub) with THIS server's ``net``
        section merged in — the same object ``/status.json`` serves."""
        import json

        from ..obs import health as _health

        plane = self._health if self._health is not None else _health.active()
        payload = (plane.status() if plane is not None
                   else _health.status_payload())
        payload["net"] = self.report()
        return json.dumps(payload).encode()

    async def _shutdown(self) -> None:
        self._server.close()
        await self._server.wait_closed()
        if self._idle_task is not None:
            self._idle_task.cancel()
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            self._enqueue(c, wire.encode_bye())
            await self._close_conn(c)

    def close(self) -> None:
        """Graceful drain: stop accepting, BYE + close every
        connection (their sessions disconnect), stop the worker
        threads and the loop.  Idempotent; never touches the
        SyncServer's own lifecycle."""
        if self._closed:
            return
        self._closed = True
        self._stopping = True
        try:
            asyncio.run_coroutine_threadsafe(
                self._shutdown(), self._loop).result(timeout=30.0)
        except (RuntimeError, TimeoutError):
            pass
        self._ackq.put(None)
        self._acker.join(timeout=10.0)
        self._notifier.join(timeout=10.0)
        self._stop_loop()
        self._pool.shutdown(wait=False)
        obs.gauge("net.connections", "live net connections").set(
            0, family=self._sync.family)

    def __enter__(self) -> "NetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
