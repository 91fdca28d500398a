"""LoroValue: the JSON-shaped value universe.

reference: crates/loro-common (LoroValue enum).  Host-side we use plain
Python values (None, bool, int, float, str, bytes, list, dict) plus
ContainerID for child-container references.  This module provides
validation, deep-equality helpers and canonical JSON conversion used by
tests and the JSON codec.
"""
from __future__ import annotations

import base64
from typing import Any, Dict, List, Union

from .ids import ContainerID

LoroValue = Union[None, bool, int, float, str, bytes, List["LoroValue"], Dict[str, "LoroValue"], ContainerID]


def validate_value(v: Any) -> Any:
    """Check v is within the LoroValue universe; returns v."""
    if v is None or isinstance(v, (bool, int, float, str, bytes, ContainerID)):
        return v
    if isinstance(v, (list, tuple)):
        for x in v:
            validate_value(x)
        return list(v)
    if isinstance(v, dict):
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k)}")
            validate_value(x)
        return v
    raise TypeError(f"not a LoroValue: {type(v)}")


def to_json(v: Any) -> Any:
    """Canonical JSON form: container refs and bytes are tagged objects so
    they round-trip unambiguously (plain strings/dicts pass through)."""
    if isinstance(v, ContainerID):
        return {"__cid__": str(v)}
    if isinstance(v, bytes):
        return {"__bytes__": base64.b64encode(v).decode()}
    if isinstance(v, list):
        return [to_json(x) for x in v]
    if isinstance(v, dict):
        return {k: to_json(x) for k, x in v.items()}
    return v


def from_json(v: Any) -> Any:
    if isinstance(v, dict):
        if set(v.keys()) == {"__cid__"}:
            return ContainerID.parse(v["__cid__"])
        if set(v.keys()) == {"__bytes__"}:
            return base64.b64decode(v["__bytes__"])
        return {k: from_json(x) for k, x in v.items()}
    if isinstance(v, list):
        return [from_json(x) for x in v]
    return v


def deep_eq(a: Any, b: Any) -> bool:
    """Deep equality with int/float care (1 == 1.0 but types kept loose,
    matching the reference's I64/Double distinction only where it matters)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(deep_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(deep_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b
