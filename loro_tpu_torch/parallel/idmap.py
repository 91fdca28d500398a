"""Per-doc (peer, counter) -> device-row id maps for resident batches:
the port's copy of loro_tpu/parallel/idmap.py.

Two interchangeable implementations of one contract:

- ``NativeIdMap`` (native/__init__.py): C++ hash map behind a ctypes
  handle, the default; batch stage/lookup/insert calls release the
  interpreter lock.
- ``PyIdMap`` (here): a plain dict subclass with the same batch/staging
  surface, picked by LORO_PY_IDMAP=1 (and the differential oracle in
  tests).

The staging contract (shared with DeviceDocBatch._commit_rows):
``stage_base`` makes rows visible to ``lookup``/``get`` WITHOUT
committing; ``commit`` publishes them; ``abort`` discards them, so a
capacity error or a per-payload Python fallback leaves the map
untouched.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class PyIdMap(dict):
    """Dict-backed fallback with the batch/staging API of NativeIdMap.

    Inherits dict for the committed view, so all dict-like uses
    (``get``, ``[]``, ``len``, truthiness, ``update``) work natively.
    """

    __slots__ = ("_staged",)

    def __init__(self):
        super().__init__()
        self._staged: Dict[Tuple[int, int], int] = {}

    # -- staged-aware reads -------------------------------------------
    def get(self, key, default=None):
        v = self._staged.get(key)
        if v is not None:
            return v
        return super().get(key, default)

    def __getitem__(self, key):
        v = self._staged.get(key)
        if v is not None:
            return v
        return super().__getitem__(key)

    def __contains__(self, key) -> bool:
        return key in self._staged or super().__contains__(key)

    # -- columnar API --------------------------------------------------
    def insert_arrays(self, peer, ctr, rows) -> None:
        self.update(zip(zip(peer.tolist(), ctr.tolist()), rows.tolist()))

    def stage_base(self, peer, ctr, base_row: int) -> None:
        n = len(peer)
        self._staged.update(
            zip(zip(peer.tolist(), ctr.tolist()), range(base_row, base_row + n))
        )

    def lookup(self, peer, ctr) -> np.ndarray:
        out = np.empty(len(peer), np.int32)
        for i, k in enumerate(zip(peer.tolist(), ctr.tolist())):
            out[i] = self.get(k, -1)
        return out

    def commit(self) -> None:
        if self._staged:
            self.update(self._staged)
            self._staged.clear()

    def abort(self) -> None:
        self._staged.clear()


def make_idmap():
    """The native map, or PyIdMap when LORO_PY_IDMAP=1 (the JAX package's
    switch); the Python pick is counted in fleet.FLEET_FALLBACKS["idmap"].
    A native library that cannot be built raises RuntimeError."""
    import os

    if os.environ.get("LORO_PY_IDMAP", "0") not in ("1", "true", "yes"):
        from ..native import native_idmap

        return native_idmap()
    from .fleet import FLEET_FALLBACKS

    FLEET_FALLBACKS["idmap"] += 1
    return PyIdMap()
