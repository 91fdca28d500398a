"""The program's own spans of the import path, for the span readers.

Imported, it registers one observer through the program's public API
(``tracing.add_span_observer``), which makes the program's spans live for
the rest of the process.  Only the traced run loads the readers that
import it, so the untraced run's spans stay off.

The spans are grouped by their enclosing ``fleet.text.payloads`` (one
merge call): every span that closes or is delivered before an entry span
closes belongs to that call (a merge's device spans are delivered as its
fetch span closes, the fetch having waited for the card).  As each entry
span closes, the program's ``rank.ring_tokens`` counter is read too, so
the tokens the window's calls ranked are the counter's rise over them.
The window's calls are the last ``len(probe.step_ms)`` entry spans, since
the set-up's warm call comes before them and nothing merges after them.
A program without these spans gives no calls, and every reader then
returns None.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from loro_tpu_torch import obs
from loro_tpu_torch.utils import tracing

ENTRY = "fleet.text.payloads"

Span = Tuple[str, float]  # name, seconds
_lock = threading.Lock()
_open: List[Span] = []  # spans since the last entry span closed
calls: List[List[Span]] = []  # one list a closed entry span, the entry span last
ring_tokens: List[float] = []  # rank.ring_tokens as each entry span closed


def _ring_tokens() -> float:
    return obs.counter("rank.ring_tokens").total()


_ring_tokens_at_import = _ring_tokens()


def observe(name: str, seconds: float) -> None:
    with _lock:
        _open.append((name, seconds))
        if name == ENTRY:
            calls.append(_open[:])
            ring_tokens.append(_ring_tokens())
            _open.clear()


def clear() -> None:
    global _ring_tokens_at_import
    with _lock:
        _open.clear()
        calls.clear()
        ring_tokens.clear()
        _ring_tokens_at_import = _ring_tokens()


tracing.add_span_observer(observe)


def window(probe) -> Optional[List[List[Span]]]:
    """The spans of each of the window's calls, or None if fewer entry
    spans were seen than there were timed steps."""
    n = len(probe.step_ms)
    with _lock:
        if n == 0 or len(calls) < n:
            return None
        return [list(c) for c in calls[-n:]]


def window_ring_tokens(probe) -> Optional[float]:
    """The ring tokens (D x m of every ranking) of the window's calls, by
    the program's rank.ring_tokens counter, or None without a window."""
    n = len(probe.step_ms)
    with _lock:
        if n == 0 or len(calls) < n:
            return None
        before = ring_tokens[-n - 1] if len(calls) > n else _ring_tokens_at_import
        return ring_tokens[-1] - before


def seconds(probe, *names: str) -> Optional[List[float]]:
    """The times of every span of the window's calls with one of `names`,
    or None if the window has none."""
    w = window(probe)
    if w is None:
        return None
    found = [s for c in w for n, s in c if n in names]
    return found or None


def ms_per_call(probe, *names: str) -> Optional[float]:
    """ms of the named spans a window call, summed over the names."""
    found = seconds(probe, *names)
    if found is None:
        return None
    return sum(found) * 1e3 / len(probe.step_ms)
