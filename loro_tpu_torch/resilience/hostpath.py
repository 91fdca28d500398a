"""Host-engine mirror of the resident batches: the port's copy of
loro_tpu/resilience/hostpath.py.

A per-doc ``LoroDoc`` replica set fed the same per-round updates as a
resident device batch.  The host ``models/`` engine and the device
kernels agree exactly (every kernel is held against the host state), so
the mirror is the oracle of a device merge and, once a server degrades
to it, its exact but slower stand-in.

The mirror exposes the SAME read-method names as the resident device
batches (``texts`` / ``richtexts`` / ``values`` / ``value_maps`` /
``root_value_maps`` / ``parent_maps`` / ``children_maps`` /
``value_lists``) so the server's read delegation is mechanical.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..core.ids import ContainerID, ContainerType


def normalize_updates(per_doc_updates: Sequence):
    """Bytes entries -> Change lists (what the mirror and the journal
    replay consume); Change lists pass through."""
    from ..codec.binary import decode_changes

    out = []
    for u in per_doc_updates:
        if isinstance(u, (bytes, bytearray)):
            out.append(decode_changes(bytes(u)))
        else:
            out.append(u)
    return out


class HostEngine:
    """Per-doc LoroDoc replica set driven by the same per-round update
    lists the device batch ingests."""

    def __init__(self, family: str, n_docs: int):
        from ..doc import LoroDoc

        self.family = family
        self.n_docs = n_docs
        # mirror peer ids live far above any realistic client peer so a
        # replica's own id never collides with replayed history
        self.docs = [LoroDoc(peer=(1 << 40) + i) for i in range(n_docs)]
        self.epoch = 0
        self._cid: Optional[ContainerID] = None
        # per-doc, first-seen-ordered container ids (the device batches
        # report map/counter values keyed by the cids IN that doc's
        # ops, so the mirror must scope them the same way)
        self._seen_cids: List[Dict[ContainerID, None]] = [
            {} for _ in range(n_docs)
        ]

    def apply(self, per_doc_updates: Sequence, cid=None) -> int:
        """Apply one sync round (None = no update for that doc)."""
        if cid is not None:
            self._cid = cid
        updates = normalize_updates(per_doc_updates)
        for di, changes in enumerate(updates):
            if not changes:
                continue
            for ch in changes:
                for op in ch.ops:
                    self._seen_cids[di].setdefault(op.container)
            self.docs[di]._import_changes(list(changes), origin="resilience")
        self.epoch += 1
        return self.epoch

    # -- read mirrors (same names as the device batches) ---------------
    def _handler(self, doc):
        if self._cid is None:
            raise ValueError(f"{self.family} host mirror has no container id yet")
        return doc.get_container(self._cid)

    def texts(self, use_solver: bool = False) -> List[str]:
        return [self._handler(d).to_string() for d in self.docs]

    def richtexts(self) -> List[list]:
        return [self._handler(d).get_richtext_value() for d in self.docs]

    def values(self, use_solver: bool = False) -> List[list]:
        return [self._handler(d).get_value() for d in self.docs]

    def value_lists(self) -> List[list]:
        return [self._handler(d).get_value() for d in self.docs]

    def _cids_of(self, di: int, ctype: ContainerType) -> List[ContainerID]:
        return [c for c in self._seen_cids[di] if c.ctype == ctype]

    def value_maps(self):
        if self.family == "counter":
            return [
                {c: float(d.get_container(c).get_value())
                 for c in self._cids_of(di, ContainerType.Counter)}
                for di, d in enumerate(self.docs)
            ]
        out = []
        for di, d in enumerate(self.docs):
            got: Dict = {}
            for c in self._cids_of(di, ContainerType.Map):
                for k, v in d.get_container(c).get_value().items():
                    got[(c, k)] = v
            out.append(got)
        return out

    def root_value_maps(self, name: str):
        return [d.get_map(name).get_value() for d in self.docs]

    def parent_maps(self) -> List[dict]:
        out = []
        for d in self.docs:
            tr = self._handler(d)
            out.append({x: tr.parent(x) for x in tr.nodes()})
        return out

    def children_maps(self) -> List[dict]:
        out = []
        for d in self.docs:
            tr = self._handler(d)
            kids = {}
            for x in [None] + tr.nodes():
                ch = tr.children(x)
                if ch:
                    kids[x] = ch
            out.append(kids)
        return out


def host_merge_changes(family: str, docs_changes: Sequence[Sequence], cid=None):
    """One-shot host fallback for the Fleet ``merge_*_changes`` APIs:
    replay each doc's change list into a fresh host replica and read
    the same result shape the device merge returns."""
    eng = HostEngine(family, len(docs_changes))
    eng.apply(list(docs_changes), cid)
    if family == "text":
        return eng.texts()
    if family == "richtext":
        return eng.richtexts()
    if family == "movable":
        return eng.value_lists()
    if family == "tree":
        return eng.parent_maps()
    if family == "tree_children":
        return eng.children_maps()
    if family == "counter":
        return eng.value_maps()
    raise ValueError(f"no host fallback for family {family!r}")
