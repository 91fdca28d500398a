"""Declared partial lock order (the port's copy of
loro_tpu/analysis/lockorder.py, levels and all).

The runtime witness (``lockwitness.py``) checks every observed
acquisition against it.  Levels are OUTERMOST-FIRST: a thread holding
lock A may acquire lock B iff ``level(A) < level(B)`` (or the pair is
explicitly allowed).  Same-name reentrant acquisition (RLocks) is always
allowed.  Locks not named here (the obs registry, the fault table,
tracing: strict leaves that call nothing while held) are outside the
witness on purpose.

The table is the JAX package's whole order.  The port's locks today,
outermost first:

- ``repl.follower``    — a replication Follower's catch_up / promote
  RLock (replication/follower.py), the outermost level of the standby
  plane: one pass holds it across the shipped-round replay (->
  ``fleet.dev`` / ``supervisor.state`` through the resident) and the
  read-only sync feed (-> ``sync.server`` -> ``sync.readplane``);
  nothing acquires it while holding anything below;
- ``net.accept``       — the NetServer's connection registry and
  pending-poll slots (net/server.py): taken on the asyncio loop thread
  (accept, teardown), the notifier thread (claim a pending poll, then
  release it before ``session.poll`` -> ``sync.server``) and the acker
  thread; every session call under it is made after release, so the
  declared edge ``net.accept`` -> ``sync.server`` serves only the
  teardown path that snapshots the registry before disconnecting
  sessions;
- ``sync.server``      — SyncServer's session / oracle RLock; the commit
  path feeds the read plane under it (server -> readplane), and a
  degraded read window takes it only with the queue and plane locks
  released;
- ``sync.readbatch``   — the ReadBatcher's pull queue; sessions submit
  under ``sync.server``, the window leader releases it before the plane;
- ``sync.readplane``   — the read plane's index and frame cache; the
  window leader holds it across the selection launch (-> ``fleet.dev``);
- ``fanin.queue``      — the sync fan-in's intake; its worker runs the
  commit with it released;
- ``sharded.route``, ``sharded.collect``, ``pipeline.queue``,
  ``residency.plan`` — the sharded server, its collector, the pipeline
  and the tiered batch (each releases before calling the server);
- ``fleet.dev``        — a resident batch's device RLock: serializes a
  grow against an in-flight commit and wraps the read plane's
  supervised selection launch;
- ``sharded.epoch``    — the sharded fleet's global epoch map;
- ``supervisor.state`` — DeviceSupervisor's counters; a strict leaf
  under every launch (dev -> supervisor);
- ``obs.health``       — the heat accountant and the health plane's
  ring and alerts; heat ticks run under serving locks, and attachment
  reports and registry reads run with it released;
- ``obs.flight``       — the flight-recorder ring (obs/flight.py); the
  innermost level by construction: ``flight.record()`` is called while
  other locks are held, and the recorder calls nothing while holding
  it (a thread-local reentrancy guard drops nested records, so even the
  lock witness observing this lock cannot re-enter it).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple

LEVELS: Dict[str, int] = {
    "repl.follower": 5,
    "net.accept": 8,
    "sync.server": 10,
    "sync.readbatch": 14,
    "sync.readplane": 16,
    "fanin.queue": 20,
    "sharded.route": 30,
    "sharded.collect": 40,
    "pipeline.queue": 50,
    "residency.plan": 55,
    "fleet.dev": 60,
    "sharded.epoch": 70,
    "supervisor.state": 80,
    "obs.health": 85,
    "obs.flight": 90,
}

# explicitly-allowed extra edges that the pure level order forbids —
# each entry carries its justification in a comment.  Empty today:
# keep it that way unless a post-mortem proves an edge safe.
ALLOWED_EXTRA: Set[Tuple[str, str]] = set()

# attribute-name -> lock-name map of the JAX package's static lock rule
# (kept with the table; the port has no linter).  Only attributes whose
# name is unambiguous across the codebase belong here; generic
# `_lock`/`_cv` attributes are witnessed at runtime instead.
STATIC_ATTR_LOCKS: Dict[str, str] = {
    "_dev_lock": "fleet.dev",
    "_route_lock": "sharded.route",
    "_epoch_lock": "sharded.epoch",
    "_plan_lock": "residency.plan",
}


def level(name: str):
    return LEVELS.get(name)


def allowed(outer: str, inner: str) -> bool:
    """May a thread holding ``outer`` acquire ``inner``?  Unknown lock
    names are permitted (the witness records them; the declaration
    only constrains the names it knows)."""
    if outer == inner:
        return True  # reentrant
    if (outer, inner) in ALLOWED_EXTRA:
        return True
    lo, li = LEVELS.get(outer), LEVELS.get(inner)
    if lo is None or li is None:
        return True
    return lo < li


def check_edges(edges: Iterable[Tuple[str, str]]) -> List[str]:
    """Violation strings for every witnessed edge the declaration
    forbids (empty = conformant)."""
    out = []
    for a, b in edges:
        if not allowed(a, b):
            out.append(
                f"{a!r} (level {LEVELS.get(a)}) held while acquiring "
                f"{b!r} (level {LEVELS.get(b)}) — declared order forbids it"
            )
    return out


def find_cycle(edges: Iterable[Tuple[str, str]]):
    """A witnessed-lock-graph cycle as a node list (closed: first ==
    last), or None.  Any cycle — declared locks or not — is a latent
    deadlock."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        if a != b:
            adj.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in set(adj) | {b for bs in adj.values() for b in bs}}
    stack: List[str] = []

    def dfs(n: str):
        color[n] = GREY
        stack.append(n)
        for m in adj.get(n, ()):
            if color[m] == GREY:
                return stack[stack.index(m):] + [m]
            if color[m] == WHITE:
                cyc = dfs(m)
                if cyc:
                    return cyc
        color[n] = BLACK
        stack.pop()
        return None

    for n in sorted(color):
        if color[n] == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None
