"""Net-edge tuning knobs with typed first-use validation.

Every knob resolves explicit-argument-first, then the environment,
then the documented default — and a malformed environment value raises
``errors.ConfigError`` AT FIRST USE with the accepted range spelled
out (the ``LORO_SHARDS`` pattern: never a silent fall-back to the
default you were not actually running with).

- ``LORO_NET_PORT``      listen port (0 = ephemeral, the test/bench
                         default; the bound port is ``server.port``)
- ``LORO_NET_MAX_FRAME`` maximum frame body bytes either side will
                         send or accept (default 8 MiB; a declared
                         length above it is refused typed BEFORE the
                         body is read)
- ``LORO_NET_BACKLOG``   listen(2) backlog (default 128)
- ``LORO_NET_MAX_CONNS`` concurrent-connection cap — the accept loop
                         refuses (counted, typed) above it instead of
                         queueing unbounded sessions (default 1024)
- ``LORO_NET_IDLE_S``    idle-connection timeout seconds (0 = never;
                         default 0 — the SyncServer session TTL is the
                         authoritative idleness policy, this one just
                         reclaims dead sockets sooner)
"""
from __future__ import annotations

import os
from typing import Optional

from ..errors import ConfigError

DEFAULT_MAX_FRAME = 8 * 1024 * 1024
DEFAULT_BACKLOG = 128
DEFAULT_MAX_CONNS = 1024
DEFAULT_IDLE_S = 0.0


def _env_int(knob: str, default: int, lo: int, hi: int,
             accepted: str) -> int:
    env = os.environ.get(knob)
    if env is None:
        return default
    try:
        v = int(env)
    except ValueError:
        raise ConfigError(knob, env, accepted) from None
    if not (lo <= v <= hi):
        raise ConfigError(knob, env, accepted)
    return v


def resolve_port(port: Optional[int] = None) -> int:
    if port is None:
        return _env_int("LORO_NET_PORT", 0, 0, 65535,
                        "TCP port 0..65535 (0 = ephemeral)")
    if not (0 <= int(port) <= 65535):
        raise ConfigError("LORO_NET_PORT", port,
                          "TCP port 0..65535 (0 = ephemeral)")
    return int(port)


def resolve_max_frame(max_frame: Optional[int] = None) -> int:
    if max_frame is None:
        return _env_int(
            "LORO_NET_MAX_FRAME", DEFAULT_MAX_FRAME, 1024, 1 << 31,
            "frame byte cap 1024..2**31")
    if not (1024 <= int(max_frame) <= 1 << 31):
        raise ConfigError("LORO_NET_MAX_FRAME", max_frame,
                          "frame byte cap 1024..2**31")
    return int(max_frame)


def resolve_backlog(backlog: Optional[int] = None) -> int:
    if backlog is None:
        return _env_int("LORO_NET_BACKLOG", DEFAULT_BACKLOG, 1, 65535,
                        "listen backlog 1..65535")
    if not (1 <= int(backlog) <= 65535):
        raise ConfigError("LORO_NET_BACKLOG", backlog,
                          "listen backlog 1..65535")
    return int(backlog)


def resolve_max_conns(max_connections: Optional[int] = None) -> int:
    if max_connections is None:
        return _env_int(
            "LORO_NET_MAX_CONNS", DEFAULT_MAX_CONNS, 1, 1 << 20,
            "concurrent-connection cap 1..2**20")
    if not (1 <= int(max_connections) <= 1 << 20):
        raise ConfigError("LORO_NET_MAX_CONNS", max_connections,
                          "concurrent-connection cap 1..2**20")
    return int(max_connections)


def resolve_idle_s(idle_timeout: Optional[float] = None) -> float:
    if idle_timeout is None:
        env = os.environ.get("LORO_NET_IDLE_S")
        if env is None:
            return DEFAULT_IDLE_S
        try:
            v = float(env)
        except ValueError:
            raise ConfigError(
                "LORO_NET_IDLE_S", env,
                "idle seconds >= 0 (0 = never)") from None
        if v < 0:
            raise ConfigError("LORO_NET_IDLE_S", env,
                              "idle seconds >= 0 (0 = never)")
        return v
    if float(idle_timeout) < 0:
        raise ConfigError("LORO_NET_IDLE_S", idle_timeout,
                          "idle seconds >= 0 (0 = never)")
    return float(idle_timeout)
