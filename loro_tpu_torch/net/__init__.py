"""Network edge: binary wire protocol + TCP session transport (the
port of loro_tpu/net/, imports changed).

``NetServer`` fronts a ``sync.SyncServer`` (or a follower's
``ReadOnlySyncServer``) over real TCP sockets — one connection = one
``Session``, length-prefixed crc32-enveloped frames carrying the
existing columnar-updates bytes VERBATIM (a socket pull is
byte-identical to the in-process ``Session.pull``), bounded
backpressure mapped onto the FanIn bound, and typed errors crossing
the wire as ERROR frames.

``NetClient`` is the blocking test/bench client; its per-doc version
vectors are a complete resume token — reconnect = HELLO with your
frontiers, first pull = delta-since-frontier (the server holds no
session state across disconnects).

Typed errors live in ``loro_tpu_torch.errors``: ``NetError``,
``NetProtocolError`` (plus the sync/replication types the wire
re-raises).  Knobs: ``LORO_NET_PORT`` / ``LORO_NET_MAX_FRAME`` /
``LORO_NET_BACKLOG`` / ``LORO_NET_MAX_CONNS`` / ``LORO_NET_IDLE_S``
(typed ``ConfigError`` at first use, ``net/config.py``).
"""
from ..errors import NetError, NetProtocolError
from . import wire
from .client import NetClient
from .server import NetServer

__all__ = [
    "NetServer",
    "NetClient",
    "NetError",
    "NetProtocolError",
    "wire",
]
