"""Byte-string fractional indexes for tree sibling ordering.

reference: crates/fractional_index (FractionalIndex over Vec<u8>,
TERMINATOR=128).  Keys sort lexicographically as bytes; `key_between`
produces a key strictly between its arguments (None = ±infinity) by
base-256 midpointing, growing one byte only when digits are adjacent.
"""
from __future__ import annotations

from typing import List, Optional

DEFAULT = bytes([128])


def key_between(a: Optional[bytes], b: Optional[bytes]) -> bytes:
    """A key x with a < x < b (lexicographic bytes; None = ±inf)."""
    if a is not None and b is not None:
        assert a < b, f"key_between requires a < b, got {a.hex()} >= {b.hex()}"
    av = a or b""
    out = bytearray()
    i = 0
    binf = b is None
    while True:
        da = av[i] if i < len(av) else 0
        db = 256 if binf else (b[i] if i < len(b) else 256)  # type: ignore[index]
        if db - da > 1:
            out.append((da + db) // 2)
            return bytes(out)
        out.append(da)
        if db == da + 1:
            binf = True  # b-side exhausted at this digit; remaining bound is +inf
        i += 1


def keys_between(a: Optional[bytes], b: Optional[bytes], n: int) -> List[bytes]:
    """n evenly-generated keys strictly between a and b, in order."""
    out: List[bytes] = []
    lo = a
    for _ in range(n):
        k = key_between(lo, b)
        out.append(k)
        lo = k
    return out
