"""Lossless JSON op interchange format.

reference: crates/loro-internal/src/encoding/json_schema.rs
(JsonSchema{schema_version, start_version, changes}).  This is the
human-readable codec; the binary columnar codec (codec/binary.py) is the
wire-efficient one.  Both carry the same change model.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..core.change import (
    Change,
    CounterIncr,
    MapSet,
    MovableMove,
    MovableSet,
    Op,
    SeqDelete,
    SeqInsert,
    Side,
    StyleAnchor,
    TreeMove,
    UnknownContent,
)
from ..core.ids import ContainerID, ID, IdSpan, TreeID
from ..core.value import from_json, to_json
from ..errors import LoroError
from ..core.version import Frontiers, VersionVector

SCHEMA_VERSION = 1


def _id_str(id: Optional[ID]) -> Optional[str]:
    return None if id is None else str(id)


def _id_parse(s: Optional[str]) -> Optional[ID]:
    return None if s is None else ID.parse(s)


def op_to_json(op: Op) -> Dict[str, Any]:
    c = op.content
    d: Dict[str, Any] = {"container": str(op.container), "counter": op.counter}
    if isinstance(c, MapSet):
        d["type"] = "map_set"
        d["key"] = c.key
        if c.deleted:
            d["deleted"] = True
        else:
            d["value"] = to_json(c.value)
    elif isinstance(c, SeqInsert):
        d["type"] = "insert"
        from ..oplog.oplog import _RunCont

        d["parent"] = "run-cont" if isinstance(c.parent, _RunCont) else _id_str(c.parent)
        d["side"] = int(c.side)
        if isinstance(c.content, StyleAnchor):
            d["anchor"] = {
                "key": c.content.key,
                "value": to_json(c.content.value),
                "start": c.content.is_start,
                "info": c.content.info,
            }
        elif isinstance(c.content, str):
            d["text"] = c.content
        else:
            d["values"] = [to_json(v) for v in c.content]
    elif isinstance(c, SeqDelete):
        d["type"] = "delete"
        d["spans"] = [[s.peer, s.start, s.end] for s in c.spans]
    elif isinstance(c, TreeMove):
        d["type"] = "tree"
        d["target"] = str(c.target)
        d["parent"] = str(c.parent) if c.parent is not None else None
        d["position"] = c.position.hex() if c.position is not None else None
        if c.is_create:
            d["create"] = True
        if c.is_delete:
            d["del"] = True
    elif isinstance(c, CounterIncr):
        d["type"] = "counter"
        d["delta"] = c.delta
    elif isinstance(c, MovableSet):
        d["type"] = "mset"
        d["elem"] = str(c.elem)
        d["value"] = to_json(c.value)
    elif isinstance(c, MovableMove):
        d["type"] = "mmove"
        d["elem"] = str(c.elem)
        d["parent"] = _id_str(c.parent)
        d["side"] = int(c.side)
    elif isinstance(c, UnknownContent):
        d["type"] = "unknown"
        d["kind"] = c.kind
        d["data"] = c.data.hex()
    else:  # pragma: no cover
        raise TypeError(f"unknown op content {type(c)}")
    return d


def op_from_json(d: Dict[str, Any]) -> Op:
    cid = ContainerID.parse(d["container"])
    t = d["type"]
    if t == "map_set":
        if d.get("deleted"):
            content = MapSet(d["key"], None, True)
        else:
            content = MapSet(d["key"], from_json(d["value"]))
    elif t == "insert":
        if d["parent"] == "run-cont":
            from ..oplog.oplog import _RUN_CONT

            parent: Any = _RUN_CONT
        else:
            parent = _id_parse(d["parent"])
        if "anchor" in d:
            a = d["anchor"]
            body: Any = StyleAnchor(a["key"], from_json(a["value"]), a["start"], a.get("info", 0))
        elif "text" in d:
            body = d["text"]
        else:
            body = tuple(from_json(v) for v in d["values"])
        content = SeqInsert(parent, Side(d["side"]), body)
    elif t == "delete":
        content = SeqDelete(tuple(IdSpan(p, s, e) for p, s, e in d["spans"]))
    elif t == "tree":
        content = TreeMove(
            TreeID.parse(d["target"]),
            TreeID.parse(d["parent"]) if d["parent"] is not None else None,
            bytes.fromhex(d["position"]) if d["position"] is not None else None,
            d.get("create", False),
            d.get("del", False),
        )
    elif t == "counter":
        content = CounterIncr(d["delta"])
    elif t == "mset":
        content = MovableSet(ID.parse(d["elem"]), from_json(d["value"]))
    elif t == "mmove":
        content = MovableMove(ID.parse(d["elem"]), _id_parse(d["parent"]), Side(d["side"]))
    elif t == "unknown":
        content = UnknownContent(d["kind"], bytes.fromhex(d["data"]))
    else:
        raise ValueError(f"unknown op type {t!r}")
    return Op(d["counter"], cid, content)


def change_to_json(ch: Change) -> Dict[str, Any]:
    return {
        "id": str(ch.id),
        "lamport": ch.lamport,
        "deps": ch.deps.to_json(),
        "timestamp": ch.timestamp,
        "msg": ch.message,
        "ops": [op_to_json(op) for op in ch.ops],
    }


def change_from_json(d: Dict[str, Any]) -> Change:
    return Change(
        id=ID.parse(d["id"]),
        lamport=d["lamport"],
        deps=Frontiers.from_json(d["deps"]),
        ops=[op_from_json(o) for o in d["ops"]],
        timestamp=d.get("timestamp", 0),
        message=d.get("msg"),
    )


def export_json_updates(
    changes: List[Change], start_vv: VersionVector, end_vv: VersionVector
) -> Dict[str, Any]:
    return {
        "schema_version": SCHEMA_VERSION,
        "start_version": start_vv.to_json(),
        "end_version": end_vv.to_json(),
        "changes": [change_to_json(c) for c in changes],
    }


REDACTED_CHAR = "�"


class RedactError(LoroError, ValueError):
    """reference: json_schema.rs RedactError (InvalidSchema /
    UnknownOperationType).  Rooted in LoroError (the typed-error
    discipline) while keeping the historical ValueError base for
    pre-existing ``except ValueError`` callers."""


def _op_json_len(d: Dict[str, Any]) -> int:
    """Counter span of a JSON op (mirror of Op.atom_len)."""
    if d["type"] == "insert":
        if "text" in d:
            return max(1, len(d["text"]))
        if "values" in d:
            return max(1, len(d["values"]))
    return 1


def _redact_value(v: Any) -> Any:
    """Nulls a JSON value unless it is a child-container ref (child
    creation must survive redaction — reference json_schema.rs
    redact_value)."""
    if isinstance(v, dict) and set(v.keys()) == {"__cid__"}:
        return v
    return None


def redact_json_updates(doc_json: Dict[str, Any], rng) -> Dict[str, Any]:
    """Redact sensitive content of ops inside `rng` (a VersionRange) in
    place, preserving all CRDT structure so redacted and non-redacted
    docs keep converging (reference: loro::json::redact,
    json_schema.rs:1750-1880):

    - text inserts: covered chars become U+FFFD (lengths preserved)
    - list / movable-list insert values and movable set values: Null
      (child-container refs kept)
    - map insert values: Null (keys kept); deletes untouched
    - text mark (anchor) values: Null (keys kept)
    - counter increments: 0
    - tree / move / delete ops: unchanged
    - unknown future ops: RedactError (their counter span is opaque)
    """
    ranges = dict(rng.items())
    i32_max = (1 << 31) - 1
    errors: List[RedactError] = []
    for change in doc_json.get("changes", []):
        try:
            cid = ID.parse(change["id"])
        except (KeyError, ValueError) as e:
            raise RedactError(f"invalid change id: {e}") from None
        if cid.peer not in ranges:
            continue
        s, e = ranges[cid.peer]
        for op in change["ops"]:
            ctr = op.get("counter")
            if not isinstance(ctr, int) or ctr < 0 or ctr > i32_max:
                raise RedactError(f"op counter out of range: {ctr!r}")
            length = _op_json_len(op)
            if ctr + length > i32_max:
                raise RedactError("op counter overflow")
            if ctr >= e:
                break
            t = op["type"]
            if t == "unknown":
                # fail-closed: an unknown (future-format) op's counter
                # span is opaque, so any such op starting before the
                # range end may hold covered content
                errors.append(RedactError("cannot redact unknown op type"))
                continue
            lo = max(s - ctr, 0)
            hi = min(e - ctr, length)
            if hi <= lo:
                continue
            if t == "insert":
                if "text" in op:
                    chars = list(op["text"])
                    for i in range(lo, hi):
                        chars[i] = REDACTED_CHAR
                    op["text"] = "".join(chars)
                elif "values" in op:
                    vals = op["values"]
                    for i in range(lo, hi):
                        vals[i] = _redact_value(vals[i])
                elif "anchor" in op:
                    op["anchor"]["value"] = None
            elif t == "map_set":
                if not op.get("deleted"):
                    op["value"] = _redact_value(op["value"])
            elif t == "mset":
                op["value"] = _redact_value(op["value"])
            elif t == "counter":
                op["delta"] = 0
            elif t in ("delete", "tree", "mmove"):
                pass  # structure ops carry no redactable content
            else:
                errors.append(RedactError(f"unrecognized op type {t!r}"))
    if errors:
        raise errors[-1]
    return doc_json


def import_json_updates(doc_json: Dict[str, Any]) -> List[Change]:
    if doc_json.get("schema_version", 1) > SCHEMA_VERSION:
        raise ValueError(f"unsupported schema version {doc_json.get('schema_version')}")
    return [change_from_json(c) for c in doc_json["changes"]]


def dumps(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False).encode()


def loads(b: bytes) -> Dict[str, Any]:
    return json.loads(b.decode())
