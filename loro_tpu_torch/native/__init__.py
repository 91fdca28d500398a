"""ctypes binding of the port's native payload codec (seq_codec.cpp).

The library is built with g++ at its first use (``_build.library``:
``build/torch_kernels/``, keyed by the source hash) and loaded with
``ctypes.CDLL``, which releases the interpreter lock for the length of
each call, so decode threads explode payloads in parallel.  There is no
Python fallback: a codec that cannot be built raises, and a malformed
payload raises CodecDecodeError.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..errors import CodecDecodeError

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from .._build import library

        lib = library("seq_codec")
        lib.loro_count_seq_elements.restype = ctypes.c_longlong
        lib.loro_count_seq_elements.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int]
        lib.loro_set_rowtable_budget.restype = None
        lib.loro_set_rowtable_budget.argtypes = [ctypes.c_longlong]
        lib.loro_explode_seq.restype = ctypes.c_longlong
        lib.loro_explode_seq.argtypes = (
            [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
        )
        _lib_handle = lib
    return _lib_handle


def set_rowtable_budget(entries: int) -> None:
    """Caps the direct (peer, counter) -> row table at `entries` entries
    (0 restores the default: 8 entries an element, plus 2^20); past the cap the
    explode redoes the payload with the hash map.  Process-wide: for
    tests that drive the hash-map path."""
    _lib().loro_set_rowtable_budget(int(entries))


def explode_seq_payload(
    payload: bytes, target_cid_index: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The element table of one sequence container of a binary updates
    payload, in payload order: (parent row int32 (-1 = root), side
    int32, peer index int32 (into the payload's peer table), counter
    int32, deleted bool, content int32 (codepoint, or a value index for
    list inserts)).  Raises CodecDecodeError on malformed payloads and
    unresolvable parent references."""
    lib = _lib()
    payload = bytes(payload)
    n = lib.loro_count_seq_elements(payload, len(payload), target_cid_index)
    if n < 0:
        raise CodecDecodeError("native decode failed (malformed payload)")
    parent = np.empty(n, np.int32)
    side = np.empty(n, np.int32)
    peer = np.empty(n, np.int32)
    counter = np.empty(n, np.int32)
    deleted = np.zeros(n, np.uint8)
    content = np.empty(n, np.int32)
    wrote = lib.loro_explode_seq(
        payload, len(payload), target_cid_index,
        *[a.ctypes.data_as(ctypes.c_void_p) for a in (parent, side, peer, counter, deleted, content)], n,
    )
    if wrote != n:
        raise CodecDecodeError("native decode failed (unresolvable references or count mismatch)")
    return parent, side, peer, counter, deleted.astype(bool), content
