"""The known-prefix trim of a change, the port of loro_tpu/oplog/oplog.py's
trim_known_prefix and _slice_run.

The JAX OpLog applies this one rule on remote import (plan_import), on
ranged export (changes_since / changes_between) and in the read plane;
the port's read plane (ops/export_batch.ExportIndex.note_changes) applies
it the same way, so its rows are the changes an OpLog would store.  The
rest of the OpLog comes with the host engine.
"""
from __future__ import annotations

from typing import List

from ..core.change import _RUN_CONT, Change, Op, SeqInsert, Side
from ..core.ids import ID, Counter
from ..core.version import Frontiers


def trim_known_prefix(ch: Change, known_end: Counter) -> Change:
    """`ch` without its ops at or below `known_end`: the straddling run
    sliced, and the id, lamport and deps rewritten to the trim point."""
    ops: List[Op] = []
    for op in ch.ops:
        if op.ctr_end <= known_end:
            continue
        if op.counter < known_end:
            assert isinstance(op.content, SeqInsert)
            op = _slice_run(op, known_end)
        ops.append(op)
    off = known_end - ch.ctr_start
    return Change(
        id=ID(ch.peer, known_end),
        lamport=ch.lamport + off,
        deps=Frontiers([ID(ch.peer, known_end - 1)]),
        ops=ops,
        timestamp=ch.timestamp,
        message=ch.message,
    )


def _slice_run(op: Op, new_start: Counter) -> Op:
    """A SeqInsert run sliced to start at `new_start`: its first element's
    parent becomes the previous element of the run (_RUN_CONT, on the
    right)."""
    c: SeqInsert = op.content  # type: ignore[assignment]
    off = new_start - op.counter
    return Op(new_start, op.container, SeqInsert(_RUN_CONT, Side.Right, c.content[off:]))
