"""The port's entry point: the element-level merge of a small example
batch, the counterpart of ``__graft_entry__.entry()``.

    fn, (cols,) = entry()
    codes, counts = fn(cols)                # on the card
    codes, counts = fn(cols, device="cpu")  # the plain torch versions
"""
from __future__ import annotations

import numpy as np

from .device import DeviceLike
from .ops.fugue_batch import SeqColumns, materialize_content_batch, seq_columns_to_torch


def example_cols(d: int = 8, n: int = 256) -> SeqColumns:
    """Synthetic but structurally real numpy element batch [d, n]: per
    doc, a root right spine of n elements (sequential typing) with every
    7th element tombstoned."""
    parent = np.broadcast_to(np.arange(-1, n - 1, dtype=np.int32), (d, n)).copy()
    counter = np.broadcast_to(np.arange(n, dtype=np.int32), (d, n)).copy()
    return SeqColumns(
        parent=parent,
        side=np.ones((d, n), np.int32),
        peer=np.zeros((d, n), np.int32),
        counter=counter,
        deleted=(counter % 7) == 6,
        content=(counter % 26 + 97).astype(np.int32),
        valid=np.ones((d, n), bool),
    )


def entry():
    """(fn, example_args): fn(cols, device="cuda") carries numpy
    SeqColumns to `device` and runs materialize_content_batch there,
    returning (codes int32 [D, N], counts int32 [D])."""

    def forward(cols: SeqColumns, device: DeviceLike = "cuda"):
        return materialize_content_batch(seq_columns_to_torch(cols, device), device=device)

    return forward, (example_cols(),)
