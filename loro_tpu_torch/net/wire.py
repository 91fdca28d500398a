"""Binary wire protocol for the network edge (the port of
loro_tpu/net/wire.py: its bytes are the JAX package's for every message).

Every frame on the wire is::

    u32le body_len | u32le crc32(body) | body
    body = u8 msg_type | type-specific fields

— the codec-harden envelope pattern (persist/wal.py frames, codec
``strip_envelope``): the length prefix bounds the read, the crc32
rejects truncation and bit-flips BEFORE any field decoding, and a
declared length above the negotiated maximum is refused without
reading the body.  Violations raise typed ``errors.CodecDecodeError``
(damaged bytes) or ``errors.NetProtocolError`` (oversized frame,
unknown type, wrong HELLO magic/version) — never a silent skip, never
an untyped crash of the connection loop.

Field primitives: ``uvarint`` (LEB128, the codec/binary idiom),
length-prefixed UTF-8 strings, length-prefixed byte blobs, and
``VersionVector.encode()`` for frontiers.  The PUSH/DELTA payloads are
the existing columnar-updates bytes VERBATIM — the wire layer never
re-encodes CRDT data, so a pulled delta is byte-identical to the
in-process ``Session.pull`` (the differential gate in
tests/test_net_wire.py).

Message catalogue (client → server unless noted):

- ``HELLO``     magic ``LTNT`` + protocol version + family + client id
                + per-doc frontier VVs (the RESUME TOKEN: the server
                holds no session state across disconnects — a
                reconnect IS a pull-since-frontier)
- ``HELLO_OK``  (server) version + family + n_docs + committed epoch +
                session id + how many frontier docs resumed
- ``PUSH``      request id + doc + updates blob (verbatim)
- ``PUSH_ACK``  (server) request id + visible epoch + durable
                watermark + the server-side trace id
- ``PULL``      request id + doc + optional min_epoch (read-your-
                writes gate)
- ``DELTA``     (server) request id + doc + payload (byte-identical to
                ``Session.pull``) + the new client frontier + a
                first-sync flag
- ``POLL``      request id + timeout_ms (long-poll registration)
- ``EVENT``     (server) request id + dirty ``{doc: epoch}`` map +
                presence blobs (drop-oldest coalesced like ``poll()``)
- ``PRESENCE``  a client Awareness/EphemeralStore blob to broadcast
- ``ERROR``     (server) request id (0 = connection-level) + typed
                code + message + leader address (NOT_LEADER redirect)
- ``BYE``       graceful close (either side)
- ``STATUS``    request id — admin probe for the aggregated health
                verdict
- ``STATUS_OK`` (server) request id + JSON status payload blob (the
                same object ``/status.json`` serves, plus the server's
                own ``net`` section)
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

from ..core.version import VersionVector
from ..errors import CodecDecodeError, NetProtocolError

PROTO_MAGIC = b"LTNT"
PROTO_VERSION = 1

HEADER_LEN = 8  # u32le body_len | u32le crc32

# message types (u8)
HELLO = 0x01
HELLO_OK = 0x02
PUSH = 0x03
PUSH_ACK = 0x04
PULL = 0x05
DELTA = 0x06
POLL = 0x07
EVENT = 0x08
PRESENCE = 0x09
ERROR = 0x0A
BYE = 0x0B
STATUS = 0x0C
STATUS_OK = 0x0D

TYPE_NAMES = {
    HELLO: "HELLO", HELLO_OK: "HELLO_OK", PUSH: "PUSH",
    PUSH_ACK: "PUSH_ACK", PULL: "PULL", DELTA: "DELTA", POLL: "POLL",
    EVENT: "EVENT", PRESENCE: "PRESENCE", ERROR: "ERROR", BYE: "BYE",
    STATUS: "STATUS", STATUS_OK: "STATUS_OK",
}

# typed error codes carried by ERROR frames; the client re-raises the
# matching loro_tpu_torch.errors type (map_error / raise_error below)
E_BAD_FRAME = 1
E_BAD_VERSION = 2
E_PUSH_REJECTED = 3
E_STALE_FRONTIER = 4
E_NOT_LEADER = 5
E_REPLICA_LAG = 6
E_SESSION_CLOSED = 7
E_UNAVAILABLE = 8
E_INTERNAL = 9

CODE_NAMES = {
    E_BAD_FRAME: "BAD_FRAME", E_BAD_VERSION: "BAD_VERSION",
    E_PUSH_REJECTED: "PUSH_REJECTED", E_STALE_FRONTIER: "STALE_FRONTIER",
    E_NOT_LEADER: "NOT_LEADER", E_REPLICA_LAG: "REPLICA_LAG",
    E_SESSION_CLOSED: "SESSION_CLOSED", E_UNAVAILABLE: "UNAVAILABLE",
    E_INTERNAL: "INTERNAL",
}


# -- primitives --------------------------------------------------------
def _uvarint(out: bytearray, v: int) -> None:
    if v < 0:
        raise ValueError(f"uvarint cannot encode negative {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_uvarint(data: bytes, pos: list) -> int:
    shift = 0
    result = 0
    while True:
        if pos[0] >= len(data):
            raise CodecDecodeError("net frame truncated inside a varint")
        b = data[pos[0]]
        pos[0] += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result
        shift += 7
        if shift > 63:
            raise CodecDecodeError("net frame varint overruns 64 bits")


def _put_bytes(out: bytearray, b: bytes) -> None:
    _uvarint(out, len(b))
    out += b


def _read_bytes(data: bytes, pos: list) -> bytes:
    n = _read_uvarint(data, pos)
    if pos[0] + n > len(data):
        raise CodecDecodeError(
            f"net frame truncated: field wants {n} bytes, "
            f"{len(data) - pos[0]} remain")
    b = data[pos[0]:pos[0] + n]
    pos[0] += n
    return b


def _put_str(out: bytearray, s: str) -> None:
    _put_bytes(out, s.encode("utf-8"))


def _read_str(data: bytes, pos: list) -> str:
    try:
        return _read_bytes(data, pos).decode("utf-8")
    except UnicodeDecodeError as e:
        raise CodecDecodeError(f"net frame string is not UTF-8: {e}") from e


# -- framing -----------------------------------------------------------
def frame(body: bytes, max_frame: Optional[int] = None) -> bytes:
    """Wrap one message body in the length+crc envelope."""
    if max_frame is not None and len(body) > max_frame:
        raise NetProtocolError(
            f"frame body {len(body)}B exceeds the {max_frame}B maximum "
            "— split the payload or raise LORO_NET_MAX_FRAME")
    return struct.pack("<II", len(body), zlib.crc32(body)) + body


def parse_header(header: bytes, max_frame: int) -> Tuple[int, int]:
    """``(body_len, crc)`` from the 8-byte header; typed refusal of
    oversized declarations BEFORE any body byte is read."""
    if len(header) != HEADER_LEN:
        raise CodecDecodeError(
            f"net frame header truncated: {len(header)}/{HEADER_LEN} bytes")
    body_len, crc = struct.unpack("<II", header)
    if body_len > max_frame:
        raise NetProtocolError(
            f"peer declared a {body_len}B frame; the negotiated maximum "
            f"is {max_frame}B — refusing before the body is read")
    if body_len == 0:
        raise CodecDecodeError("net frame with empty body")
    return body_len, crc


def check_body(body: bytes, crc: int) -> bytes:
    """crc32 gate — truncation and bit-flips fail here, typed, before
    any field decodes."""
    if zlib.crc32(body) != crc:
        raise CodecDecodeError(
            f"net frame crc mismatch over {len(body)} body bytes "
            "(truncated or bit-flipped on the wire)")
    return body


# -- encoders ----------------------------------------------------------
def encode_hello(family: str, client_id: str,
                 frontiers: Optional[Dict[int, VersionVector]] = None,
                 version: int = PROTO_VERSION) -> bytes:
    out = bytearray()
    out.append(HELLO)
    out += PROTO_MAGIC
    out.append(version)
    _put_str(out, family)
    _put_str(out, client_id)
    frontiers = frontiers or {}
    _uvarint(out, len(frontiers))
    for di in sorted(frontiers):
        _uvarint(out, di)
        _put_bytes(out, frontiers[di].encode())
    return bytes(out)


def encode_hello_ok(family: str, n_docs: int, epoch: int, sid: str,
                    resumed: int, version: int = PROTO_VERSION) -> bytes:
    out = bytearray()
    out.append(HELLO_OK)
    out.append(version)
    _put_str(out, family)
    _uvarint(out, n_docs)
    _uvarint(out, epoch)
    _put_str(out, sid)
    _uvarint(out, resumed)
    return bytes(out)


def encode_push(rid: int, di: int, payload: bytes) -> bytes:
    out = bytearray()
    out.append(PUSH)
    _uvarint(out, rid)
    _uvarint(out, di)
    _put_bytes(out, payload)
    return bytes(out)


def encode_push_ack(rid: int, epoch: int, durable_epoch: Optional[int],
                    trace_id: str) -> bytes:
    out = bytearray()
    out.append(PUSH_ACK)
    _uvarint(out, rid)
    _uvarint(out, epoch)
    # durable watermark: 0 = not a durable server; else epoch + 1
    _uvarint(out, 0 if durable_epoch is None else durable_epoch + 1)
    _put_str(out, trace_id or "")
    return bytes(out)


def encode_pull(rid: int, di: int, min_epoch: Optional[int] = None) -> bytes:
    out = bytearray()
    out.append(PULL)
    _uvarint(out, rid)
    _uvarint(out, di)
    _uvarint(out, 0 if min_epoch is None else min_epoch + 1)
    return bytes(out)


def encode_delta(rid: int, di: int, payload: bytes, new_vv: VersionVector,
                 first_sync: bool) -> bytes:
    out = bytearray()
    out.append(DELTA)
    _uvarint(out, rid)
    _uvarint(out, di)
    _put_bytes(out, payload)
    _put_bytes(out, new_vv.encode())
    out.append(1 if first_sync else 0)
    return bytes(out)


def encode_poll(rid: int, timeout_ms: int) -> bytes:
    out = bytearray()
    out.append(POLL)
    _uvarint(out, rid)
    _uvarint(out, max(0, int(timeout_ms)))
    return bytes(out)


def encode_event(rid: int, docs: Dict[int, int], presence) -> bytes:
    out = bytearray()
    out.append(EVENT)
    _uvarint(out, rid)
    _uvarint(out, len(docs))
    for di in sorted(docs):
        _uvarint(out, di)
        _uvarint(out, docs[di])
    presence = list(presence or ())
    _uvarint(out, len(presence))
    for blob in presence:
        _put_bytes(out, bytes(blob))
    return bytes(out)


def encode_presence(blob: bytes) -> bytes:
    out = bytearray()
    out.append(PRESENCE)
    _put_bytes(out, bytes(blob))
    return bytes(out)


def encode_error(rid: int, code: int, message: str,
                 leader: str = "") -> bytes:
    out = bytearray()
    out.append(ERROR)
    _uvarint(out, rid)
    _uvarint(out, code)
    _put_str(out, message)
    _put_str(out, leader or "")
    return bytes(out)


def encode_bye() -> bytes:
    return bytes([BYE])


def encode_status(rid: int) -> bytes:
    out = bytearray()
    out.append(STATUS)
    _uvarint(out, rid)
    return bytes(out)


def encode_status_ok(rid: int, payload: bytes) -> bytes:
    out = bytearray()
    out.append(STATUS_OK)
    _uvarint(out, rid)
    _put_bytes(out, bytes(payload))
    return bytes(out)


# -- decoder -----------------------------------------------------------
def decode(body: bytes) -> Tuple[int, dict]:
    """``(msg_type, fields)`` for one crc-checked body.  Unknown types
    raise ``NetProtocolError``; short/damaged bodies raise
    ``CodecDecodeError`` (both typed — the connection loop maps them to
    an ERROR frame, never dies silently)."""
    if not body:
        raise CodecDecodeError("net frame with empty body")
    t = body[0]
    pos = [1]
    if t == HELLO:
        if body[1:5] != PROTO_MAGIC:
            raise NetProtocolError(
                f"HELLO magic {body[1:5]!r} is not {PROTO_MAGIC!r} — "
                "the peer is not speaking the loro-tpu net protocol")
        pos = [5]
        if pos[0] >= len(body):
            raise CodecDecodeError("HELLO truncated before the version")
        version = body[pos[0]]
        pos[0] += 1
        family = _read_str(body, pos)
        client_id = _read_str(body, pos)
        n = _read_uvarint(body, pos)
        frontiers: Dict[int, VersionVector] = {}
        for _ in range(n):
            di = _read_uvarint(body, pos)
            frontiers[di] = VersionVector.decode(_read_bytes(body, pos))
        return t, {"version": version, "family": family,
                   "client_id": client_id, "frontiers": frontiers}
    if t == HELLO_OK:
        if pos[0] >= len(body):
            raise CodecDecodeError("HELLO_OK truncated before the version")
        version = body[pos[0]]
        pos[0] += 1
        return t, {
            "version": version,
            "family": _read_str(body, pos),
            "n_docs": _read_uvarint(body, pos),
            "epoch": _read_uvarint(body, pos),
            "sid": _read_str(body, pos),
            "resumed": _read_uvarint(body, pos),
        }
    if t == PUSH:
        return t, {"rid": _read_uvarint(body, pos),
                   "di": _read_uvarint(body, pos),
                   "payload": _read_bytes(body, pos)}
    if t == PUSH_ACK:
        rid = _read_uvarint(body, pos)
        epoch = _read_uvarint(body, pos)
        dur = _read_uvarint(body, pos)
        return t, {"rid": rid, "epoch": epoch,
                   "durable_epoch": None if dur == 0 else dur - 1,
                   "trace_id": _read_str(body, pos)}
    if t == PULL:
        rid = _read_uvarint(body, pos)
        di = _read_uvarint(body, pos)
        me = _read_uvarint(body, pos)
        return t, {"rid": rid, "di": di,
                   "min_epoch": None if me == 0 else me - 1}
    if t == DELTA:
        rid = _read_uvarint(body, pos)
        di = _read_uvarint(body, pos)
        payload = _read_bytes(body, pos)
        vv = VersionVector.decode(_read_bytes(body, pos))
        if pos[0] >= len(body):
            raise CodecDecodeError("DELTA truncated before the sync flag")
        return t, {"rid": rid, "di": di, "payload": payload,
                   "new_vv": vv, "first_sync": bool(body[pos[0]])}
    if t == POLL:
        return t, {"rid": _read_uvarint(body, pos),
                   "timeout_ms": _read_uvarint(body, pos)}
    if t == EVENT:
        rid = _read_uvarint(body, pos)
        n = _read_uvarint(body, pos)
        docs = {}
        for _ in range(n):
            di = _read_uvarint(body, pos)
            docs[di] = _read_uvarint(body, pos)
        np = _read_uvarint(body, pos)
        presence = [_read_bytes(body, pos) for _ in range(np)]
        return t, {"rid": rid, "docs": docs, "presence": presence}
    if t == PRESENCE:
        return t, {"blob": _read_bytes(body, pos)}
    if t == ERROR:
        return t, {"rid": _read_uvarint(body, pos),
                   "code": _read_uvarint(body, pos),
                   "message": _read_str(body, pos),
                   "leader": _read_str(body, pos) or None}
    if t == BYE:
        return t, {}
    if t == STATUS:
        return t, {"rid": _read_uvarint(body, pos)}
    if t == STATUS_OK:
        return t, {"rid": _read_uvarint(body, pos),
                   "payload": _read_bytes(body, pos)}
    raise NetProtocolError(f"unknown net message type 0x{t:02x}")


# -- ERROR code <-> typed exception mapping ----------------------------
def error_code_for(exc: BaseException) -> Tuple[int, str]:
    """``(code, leader)`` an ERROR frame should carry for a sync-layer
    exception crossing the wire."""
    from ..errors import (
        NotLeader, PushRejected, ReplicaLag, SessionClosed, StaleFrontier,
    )

    if isinstance(exc, PushRejected):
        return E_PUSH_REJECTED, ""
    if isinstance(exc, StaleFrontier):
        return E_STALE_FRONTIER, ""
    if isinstance(exc, NotLeader):
        return E_NOT_LEADER, str(exc.leader or "")
    if isinstance(exc, ReplicaLag):
        return E_REPLICA_LAG, ""
    if isinstance(exc, SessionClosed):
        return E_SESSION_CLOSED, ""
    if isinstance(exc, (CodecDecodeError, NetProtocolError)):
        return E_BAD_FRAME, ""
    return E_INTERNAL, ""


def raise_error(fields: dict) -> None:
    """Re-raise a received ERROR frame as its typed exception — the
    client sees the SAME error types the in-process Session raises."""
    from ..errors import (
        NetError, NotLeader, PushRejected, ReplicaLag, SessionClosed,
        StaleFrontier,
    )

    code = fields.get("code")
    msg = fields.get("message", "")
    if code == E_PUSH_REJECTED:
        raise PushRejected(msg)
    if code == E_STALE_FRONTIER:
        raise StaleFrontier(msg)
    if code == E_NOT_LEADER:
        raise NotLeader(msg, leader=fields.get("leader"))
    if code == E_REPLICA_LAG:
        raise ReplicaLag(msg)
    if code == E_SESSION_CLOSED:
        raise SessionClosed(msg)
    if code == E_BAD_VERSION:
        raise NetProtocolError(msg)
    if code == E_BAD_FRAME:
        raise CodecDecodeError(msg)
    raise NetError(f"{CODE_NAMES.get(code, code)}: {msg}")
