"""Fault-injection harness for the port's device path (the port's copy
of loro_tpu/resilience/faultinject.py).

Every degradation path is exercisable on the CPU by arming faults at
named *sites*, the instrumented choke points of the device pipeline.
The port's sites:

- ``launch``       — DeviceSupervisor.launch: raise before the device
                     call (transient ``UNAVAILABLE`` or fatal)
- ``fetch``        — DeviceSupervisor.fetch/drain: slow or failing
                     host fetch
- ``decode``       — native explode entries: truncate / bit-flip the
                     wire bytes before the C++ parser sees them
- ``backend_init`` — resilience.probe subprocesses: hang or raise
                     during backend init
- ``export_launch``— the batched delta-export selection launch (fleet
                     export_select thunk, inside the supervisor): the
                     armed error is classified as a raised one would
                     be: a transient UNAVAILABLE retries like any
                     launch, a device error becomes DeviceFailure

The server, persistence and residency planes register ``poison_doc``,
``wal_write``, ``wal_torn_tail``, ``ckpt_corrupt``, ``evict_flush`` and
``revive_replay``; the sync front end ``sync_push``, ``sync_pull``,
``session_stall`` and ``read_batch`` (an armed ``read_batch`` fault
degrades its read window to the oracle); the health plane
``health_tick``; replication ``repl_ship`` (every shipped byte: raise /
delay = a mid-ship crash, truncate / bitflip = a torn shipped tail),
``repl_apply`` (before each shipped round applies) and ``repl_promote``
(promotion entry, before the fencing token bump); the network edge
``net_accept`` (refuse the next accepted connection), ``net_frame``
(mangle one received frame before its crc gate) and ``conn_stall`` (a
connection's writer: delay = a slow reader, raise = that connection
torn down typed).  Each registers with its module.

Arm programmatically::

    from loro_tpu_torch.resilience import faultinject as fi
    fi.inject("launch", exc=RuntimeError("UNAVAILABLE: injected"), times=2)
    try:
        ...  # exercised path
    finally:
        fi.clear()

or from the environment (processes you can't reach, e.g. probe
subprocesses): ``LORO_FAULT="launch:raise:times=2;decode:truncate=16"``.
Entries are ``;``-separated ``site:action[:k=v]*`` specs; actions are
``raise`` (optional ``msg=``, default transient ``UNAVAILABLE``),
``delay`` (``s=`` seconds), ``hang`` (delay with a 60s safety clamp),
``truncate`` (``=N`` bytes to keep, default half), ``bitflip``
(``=OFFSET``, default middle byte), and ``poison`` (``docs=1+3``).

Every fire ticks ``faultinject.fired_total{site=...}`` in the obs
registry and records a ``fault.fired`` flight event.  Tests arming
faults clear them afterwards (the port's resilience tests carry their
own guard).

**Site registry.**  Every instrumented module declares its sites at
import time (``register_site(name, help)`` next to the ``check()``/
``mangle()`` call sites); ``sites()`` returns the full catalogue
(importing the instrumented modules first, so the answer does not
depend on what the caller happened to import).  ``inject()`` and
``LORO_FAULT`` entries naming an unknown site raise a typed
``errors.ConfigError`` at first use (a misspelled fault that can never
fire would let the test it guards pass vacuously); malformed entries
(unknown action, bad ``k=v``) raise typed the same way.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..errors import ConfigError
from ..obs import flight as _flight
from ..obs import metrics as _obs

# -- fault-site registry ----------------------------------------------
# modules that own check()/mangle() call sites; sites() imports them so
# the catalogue is complete even before the stack is built.  A module
# added here registers its sites at import.
_SITE_MODULES = (
    "loro_tpu_torch.resilience.supervisor",
    "loro_tpu_torch.resilience.probe",
    "loro_tpu_torch.native",
    "loro_tpu_torch.parallel.fleet",
    "loro_tpu_torch.parallel.server",
    "loro_tpu_torch.parallel.residency",
    "loro_tpu_torch.persist.wal",
    "loro_tpu_torch.persist.checkpoints",
    "loro_tpu_torch.sync.server",
    "loro_tpu_torch.sync.session",
    "loro_tpu_torch.sync.presence",
    "loro_tpu_torch.sync.readbatch",
    "loro_tpu_torch.replication.shipper",
    "loro_tpu_torch.replication.follower",
    "loro_tpu_torch.obs.health",
    "loro_tpu_torch.net.server",
)

_ACTIONS = ("raise", "delay", "hang", "truncate", "bitflip", "poison")

_registry: Dict[str, dict] = {}


def register_site(name: str, help: str = "") -> str:
    """Declare a fault site (call at module import, next to the
    ``check()``/``mangle()`` call sites it covers).  Idempotent — a
    site instrumented at several choke points registers once per
    module, first help text wins.  Returns the name so call sites can
    bind it."""
    import sys

    mod = sys._getframe(1).f_globals.get("__name__", "?")
    with _lock:
        info = _registry.get(name)
        if info is None:
            _registry[name] = {"help": help, "modules": [mod]}
        elif mod not in info["modules"]:
            info["modules"].append(mod)
    return name


def _load_site_modules() -> None:
    """Complete the registry by importing every instrumented module
    (idempotent; already-imported modules are sys.modules hits)."""
    import importlib

    for m in _SITE_MODULES:
        importlib.import_module(m)


def sites() -> Dict[str, dict]:
    """The full site catalogue: ``{name: {"help": ..., "modules":
    [...]}}``.  Imports the instrumented modules first so the answer
    is complete regardless of what the caller loaded."""
    _load_site_modules()
    with _lock:
        return {k: dict(v) for k, v in sorted(_registry.items())}


def _require_site(site: str, knob: str) -> None:
    """Typed rejection of unknown site names.  Cheap when the site is
    already registered (no imports); the full module sweep runs only
    to prove a name genuinely unknown (and name the accepted set)."""
    with _lock:
        if site in _registry:
            return
    _load_site_modules()
    with _lock:
        if site in _registry:
            return
        known = ", ".join(sorted(_registry))
    raise ConfigError(knob, site, f"registered fault sites: {known}")


class InjectedFault(Exception):
    """Default exception for ``raise`` faults.  The message decides
    transience the same way real backend errors do (the supervisor
    greps for ``UNAVAILABLE``-class markers)."""


@dataclass
class Fault:
    site: str
    action: str = "raise"          # raise | delay | hang | truncate | bitflip | poison
    exc: Optional[BaseException] = None   # for raise: exception instance to throw
    exc_factory: Optional[Callable[[], BaseException]] = None
    delay_s: float = 0.0           # for delay/hang
    keep_bytes: Optional[int] = None      # for truncate: prefix length to keep
    flip_at: Optional[int] = None  # for bitflip: byte offset (None = middle)
    docs: Optional[frozenset] = None      # for poison: doc indexes to hit
    times: Optional[int] = None    # fire at most N times (None = unlimited)
    fired: int = 0


_lock = threading.Lock()
_faults: Dict[str, List[Fault]] = {}
_sleep: Callable[[float], None] = None  # injectable for tests (None = time.sleep)
_env_loaded = False


def set_sleep(fn: Optional[Callable[[float], None]]) -> None:
    """Replace the sleeper delay/hang faults use (fake clocks in tests;
    None restores time.sleep)."""
    global _sleep
    _sleep = fn


def _do_sleep(s: float) -> None:
    if s <= 0:
        return
    if _sleep is not None:
        _sleep(s)
    else:
        import time

        time.sleep(s)


def inject(site: str, *, action: str = "raise", exc: Optional[BaseException] = None,
           exc_factory: Optional[Callable[[], BaseException]] = None,
           delay_s: float = 0.0, keep_bytes: Optional[int] = None,
           flip_at: Optional[int] = None, docs=None,
           times: Optional[int] = None) -> Fault:
    """Arm one fault.  Returns the Fault (its ``fired`` counter is
    live).  Unknown site names and actions raise typed ConfigError —
    an armed-but-misspelled fault that can never fire is worse than a
    crash (the test it was guarding passes vacuously)."""
    _require_site(site, "faultinject.inject site")
    if action not in _ACTIONS:
        raise ConfigError(
            "faultinject.inject action", action,
            "one of: " + ", ".join(_ACTIONS),
        )
    f = Fault(
        site=site, action=action, exc=exc, exc_factory=exc_factory,
        delay_s=delay_s, keep_bytes=keep_bytes, flip_at=flip_at,
        docs=frozenset(docs) if docs is not None else None, times=times,
    )
    with _lock:
        _faults.setdefault(site, []).append(f)
    return f


def clear(site: Optional[str] = None) -> None:
    with _lock:
        if site is None:
            _faults.clear()
        else:
            _faults.pop(site, None)


def active() -> Dict[str, int]:
    """Armed (non-exhausted) fault counts per site — the tests' leak
    guard's view."""
    with _lock:
        out = {}
        for site, fs in _faults.items():
            n = sum(1 for f in fs if f.times is None or f.fired < f.times)
            if n:
                out[site] = n
        return out


def fired(site: str) -> int:
    with _lock:
        return sum(f.fired for f in _faults.get(site, ()))


# actions that only have an effect where bytes flow (mangle); check()
# must leave them armed so a site instrumented with BOTH calls (check
# before a read, mangle on the streamed bytes) delivers them to the
# mangle that can apply them
_MANGLE_ACTIONS = ("truncate", "bitflip", "poison")


def _take(site: str, doc: Optional[int] = None,
          skip_mangle: bool = False) -> Optional[Fault]:
    """First armed fault at `site` that matches `doc`; ticks counters.

    Disarmed fast path: with the env parsed and no faults in the
    table, return without touching the lock — ingest calls mangle()
    once per payload and must pay ~nothing when LORO_FAULT is unset
    (reading a dict's truthiness is atomic in CPython)."""
    if _env_loaded and not _faults:
        return None
    _load_env()
    with _lock:
        for f in _faults.get(site, ()):
            if f.times is not None and f.fired >= f.times:
                continue
            if f.docs is not None and (doc is None or doc not in f.docs):
                continue
            if skip_mangle and f.action in _MANGLE_ACTIONS:
                continue
            f.fired += 1
            _obs.counter("faultinject.fired_total").inc(site=site, action=f.action)
            _flight.record("fault.fired", site=site, action=f.action,
                           doc=doc)
            return f
    return None


def _hang_delay(f: Fault) -> float:
    """A 'hang' with no explicit delay must actually hang (clamped to
    the 60s safety cap), not no-op — a vacuous hang fault would let
    every init-hang degradation test pass without exercising anything."""
    return min(f.delay_s, 60.0) if f.delay_s > 0 else 60.0


def check(site: str, doc: Optional[int] = None, **ctx) -> bool:
    """Called at instrumented sites.  Raises / sleeps per the armed
    fault; returns True iff a fault fired (False = clean pass).
    Mangle-class faults (truncate/bitflip/poison) are left armed for
    the site's ``mangle()`` call — check can't apply them."""
    f = _take(site, doc, skip_mangle=True)
    if f is None:
        return False
    if f.action in ("delay", "hang"):
        _do_sleep(_hang_delay(f) if f.action == "hang" else f.delay_s)
        return True
    if f.action == "raise":
        if f.exc_factory is not None:
            raise f.exc_factory()
        raise (f.exc if f.exc is not None else InjectedFault(
            f"UNAVAILABLE: injected fault at {site}"))
    return True  # truncate/bitflip/poison fire through mangle()


def mangle(site: str, payload, doc: Optional[int] = None):
    """Corrupt wire bytes at an instrumented decode site.  Non-bytes
    payloads and clean passes come back unchanged."""
    if not isinstance(payload, (bytes, bytearray)):
        return payload
    f = _take(site, doc)
    if f is None:
        return payload
    b = bytes(payload)
    if f.action == "truncate":
        keep = f.keep_bytes if f.keep_bytes is not None else len(b) // 2
        return b[: max(0, min(keep, len(b)))]
    if f.action in ("bitflip", "poison"):
        if not b:
            return b
        at = f.flip_at if f.flip_at is not None else len(b) // 2
        at = max(0, min(at, len(b) - 1))
        return b[:at] + bytes([b[at] ^ 0x5A]) + b[at + 1:]
    if f.action == "raise":
        if f.exc_factory is not None:
            raise f.exc_factory()
        raise (f.exc if f.exc is not None else InjectedFault(
            f"UNAVAILABLE: injected fault at {site}"))
    if f.action in ("delay", "hang"):
        _do_sleep(_hang_delay(f) if f.action == "hang" else f.delay_s)
    return b


# -- env wiring (LORO_FAULT) -------------------------------------------
def _load_env() -> None:
    """Parse LORO_FAULT once per process (probe subprocesses and test
    runs arm faults without touching Python)."""
    global _env_loaded
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        _env_loaded = True
    spec = os.environ.get("LORO_FAULT", "").strip()
    if spec:
        for entry in spec.replace(",", ";").split(";"):
            entry = entry.strip()
            if entry:
                # a typo'd site/action/k=v raises typed ConfigError at
                # the FIRST instrumented call — the old behavior
                # (silently skip the entry) meant the fault you thought
                # you were testing under never existed
                _install_env_entry(entry)


def _install_env_entry(entry: str) -> None:
    parts = entry.split(":")
    site = parts[0]
    action = parts[1] if len(parts) > 1 else "raise"
    kw: dict = {}
    base, _, val = action.partition("=")
    try:
        if base == "truncate":
            kw["keep_bytes"] = int(val) if val else None
        elif base == "bitflip":
            kw["flip_at"] = int(val) if val else None
        elif val:
            raise ValueError(f"action {base!r} takes no =value")
        for p in parts[2:]:
            k, _, v = p.partition("=")
            if k == "times":
                kw["times"] = int(v)
            elif k in ("s", "delay"):
                kw["delay_s"] = float(v)
            elif k == "msg":
                kw["exc"] = InjectedFault(v)
            elif k == "docs":
                kw["docs"] = frozenset(int(x) for x in v.split("+") if x)
            else:
                raise ValueError(f"unknown key {k!r}")
    except ValueError as e:
        if isinstance(e, ConfigError):
            raise
        raise ConfigError(
            "LORO_FAULT", entry,
            "site:action[:k=v]* with action in "
            f"{'/'.join(_ACTIONS)} and keys times=/s=/delay=/msg=/docs= "
            f"({e})",
        ) from e
    inject(site, action=base, **kw)


def _reset_env_cache_for_tests() -> None:
    global _env_loaded
    _env_loaded = False
