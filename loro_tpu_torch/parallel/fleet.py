"""Fleet merge front end: a batch of documents merged in one device call
(the port of loro_tpu/parallel/fleet.py's one-shot merges:
Fleet.merge_text_docs / merge_text_changes / merge_text_payloads,
merge_richtext_changes, merge_movable_changes / merge_movable_payloads,
merge_map_docs, merge_map_docs_sharded, merge_counter_changes and
merge_tree_changes / merge_tree_payloads / merge_tree_children), and the
resident batches that
keep documents on the device between syncs (DeviceDocBatch for text and
lists, DeviceMapBatch for LWW maps, DeviceCounterBatch for counters,
DeviceTreeBatch for movable trees, DeviceMovableBatch for movable
lists).

One-shot, per call: every document's rows are padded to one bucketed
row count (pad_bucket), the doc axis with all-invalid filler docs to a
multiple of the Fleet's device mesh's rows (_mesh_pad; `pad_docs` where
the call takes one), the columns are written into one host array a
column, each mesh row's contiguous docs are uploaded to the row's lead
device (one copy a column), one device merge runs a row, the rows'
results are gathered on the mesh's first device, and one fetch brings
back the result.  On a one-device Fleet that is one upload, one merge
and one fetch.  merge_map_docs_sharded shards each doc's op rows over the
mesh's op axis as well (ops/lww.make_lww_sharded).

Resident: DeviceDocBatch holds each doc's element table on the device
([D, capacity] SeqColumnsU plus standing order keys); each append ships
only the new rows and tombstones, a host order engine a doc
(order_maintenance.ShadowOrder or its native twin) keeps the keys, and
texts() reads every doc in one sort by those keys.  DeviceMapBatch holds
each (doc, slot) LWW winner ([D, S] ops/lww.LwwResident) and folds each
append's block of map ops into it; the values stay on the host, and a
payload's values are decoded only when they win.  DeviceCounterBatch
holds the [D, S] float32 sums and adds each append's block to them.
DeviceTreeBatch holds each doc's move log ([D, capacity] TreeLogCols,
append order); each read sorts the logs by the move key on the device
and replays them in the replay kernel (ops/tree_batch).

The JAX package binds the resident batches to a device mesh and pads
their doc axis to a multiple of its doc dimension; here they are bound
to one device, where that multiple is 1 (a sharded server carves a
mesh's rows, one batch on each slice's lead device).
DeviceMovableBatch holds MovableList position slots in an inner
DeviceDocBatch and the element winners as two LWW folds; every resident batch answers the read plane's batched export
selection (export_select over ops/export_batch.ExportIndex).

Supervision (the JAX package's): every upload, device call and fetch of
a one-shot merge, and the read plane's selection, runs through the
process DeviceSupervisor (resilience/supervisor.py).  A device error (a
CUDA error, an out-of-memory, a failed kernel launch, an armed fault)
becomes a typed DeviceFailure, and a real one reaches the caller: no
host result hides a card or a kernel that failed.  Under an armed fault
(resilience.faultinject) the change-list and payload merges re-run on
the host engine (resilience.hostpath.host_merge_changes), counted in
fleet.degraded_merges_total{family} and the supervisor's report;
merge_text_docs and merge_map_docs, which take extracts, and
export_select let that one reach the caller too.  Every other error passes through
unchanged.  The resident batches' appends and reads are not supervised,
as in the JAX package.

Lifecycle (every resident batch): a coalesce group (begin_coalesce, then
detach_coalesce and commit_detached, or flush_coalesce) commits each
round's host state as it comes and ships the group's device work as one
merged scatter or fold; release_doc resets one doc's slot for reuse;
compact (text and list, tree and movable batches) reclaims causally
stable rows.  Counted in pipeline.coalesced_rounds_total{family} and
fleet.doc_releases_total{family}.  Each one-shot merge ticks the JAX
package's fleet.* merge counters (_obs_merge), each host fallback
fleet.host_fallback_total{kind} beside FLEET_FALLBACKS; the one-shot text
merges tick rank.* as ops/fugue_batch.merge_docs does.  Not ported yet:
the trace instants.

Spans (utils/tracing, whose docstring holds the catalogue): the text
merges' fleet.text.* spans and fleet.text.merge_device device span, and
each StageClock stage as a resident.<stage> span or device span.
"""
from __future__ import annotations

import os
import struct
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec.binary import Reader, Writer, _Dicts, _read_cid, _read_value, _write_cid, _write_value, decode_changes, read_tables
from ..core.change import (Change, CounterIncr, MapSet, MovableMove, MovableSet, SeqDelete, SeqInsert, StyleAnchor,
                           TreeMove, _RunCont)
from ..core.ids import ContainerID, TreeID
from ..device import DeviceLike, resolve_device
from ..analysis.lockwitness import named_rlock
from ..errors import ConfigError, DecodeError, DeviceFailure, LoroError
from ..obs import metrics as obs
from ..ops.columnar import MapExtract, SeqExtract, extract_seq_container, extract_seq_from_payload
from ..ops.fugue_batch import (
    SeqColumnsU,
    _on,
    _tick_rank_obs,
    chain_merge_docs_u,
    materialize_by_key,
    materialize_content_batch,
    pad_bucket,
    seq_columns_to_torch,
    stack_rows,
    stack_seq_columns,
)
from ..ops.lww import (NEG, LwwResident, MapOpCols, counter_merge_batch, counter_merge_doc, lww_merge_batch,
                       lww_update_resident, make_lww_sharded)
from ..ops.movable_batch import (
    LazyPayloadValue,
    MovableCols,
    extract_movable,
    extract_movable_from_payload,
    movable_by_key_batch,
    movable_merge_batch,
)
from ..ops.richtext_batch import (
    RichtextPairs,
    extract_richtext_chain,
    richtext_by_key_batch,
    richtext_chain_merge_batch,
    segments_from_device,
    stack_richtext_chain_cols,
)
from ..ops.tree_batch import (
    ABSENT,
    ROOT,
    TRASH,
    TreeLogCols,
    TreeOpCols,
    extract_tree_from_payload,
    extract_tree_ops,
    is_deleted_batch,
    positions_of,
    tree_merge_batch,
    tree_replay_log_batch,
)
from ..resilience import faultinject
from ..resilience.supervisor import get_supervisor
from ..storage import MemKvStore
from ..utils import tracing
from .idmap import make_idmap
from .mesh import DOC_AXIS, OP_AXIS, Mesh, MeshLike, doc_count, doc_sharding, docs_of, make_mesh
from .order_maintenance import ShadowOrder, split_keys

faultinject.register_site(
    "export_launch", "batched delta-export selection launch (fleet "
    "export_select thunk, inside the supervisor): transient retries, "
    "a device error -> DeviceFailure")

# Host fallbacks, incremented where each is taken: the counterpart of the
# JAX package's fleet.host_fallback_total{kind=...}.  payload_extract: a
# one-shot payload the native explode rejected, tried with the Python
# decode; payload_decode: the same for a resident append; order / idmap:
# a resident doc given the Python order engine or id map
# (LORO_PY_ORDER=1 / LORO_PY_IDMAP=1).
FLEET_FALLBACKS: Dict[str, int] = {"payload_extract": 0, "payload_decode": 0, "order": 0, "idmap": 0}


@dataclass
class TextMergeResult:
    texts: List[str]


class _CounterCols(NamedTuple):
    """[D, M] counter rows of a one-shot counter merge."""

    slot: np.ndarray  # int32 doc-local counter slot
    delta: np.ndarray  # float32
    valid: np.ndarray  # bool


def texts_of(codes: np.ndarray, counts: np.ndarray, d: int) -> List[str]:
    """The first d docs' texts: the codepoints codes[i, :counts[i]], one
    UTF-32 decode a doc.  surrogatepass takes lone surrogates as chr
    does; a codepoint past U+10FFFF raises ValueError, as chr does."""
    return [codes[i, : int(counts[i])].astype("<u4").tobytes().decode("utf-32-le", "surrogatepass") for i in range(d)]


def _obs_merge(family: str, docs: int, real_rows: int, padded_rows: int, shape: Tuple[int, ...]) -> None:
    """One accounting point per one-shot merge: real vs padded rows
    quantify pad_bucket waste; the distinct padded shapes (the JAX
    package's jit-cache proxy) count the shapes the port's merges ran."""
    obs.counter("fleet.merge_calls_total").inc(family=family)
    obs.counter("fleet.docs_merged_total").inc(docs, family=family)
    obs.counter("fleet.ops_merged_total").inc(real_rows, family=family)
    obs.counter("fleet.pad_waste_rows_total").inc(max(0, padded_rows - real_rows), family=family)
    obs.counter("fleet.device_launches_total").inc(family=family)
    obs.unique("fleet.padded_shapes_distinct").add((family,) + tuple(shape))


def _obs_fallback(kind: str) -> None:
    """Host-fallback hits: the forced Python order engine (LORO_PY_ORDER)
    and per-payload decode fallbacks, in fleet.host_fallback_total{kind}
    beside FLEET_FALLBACKS."""
    FLEET_FALLBACKS[kind] += 1
    obs.counter("fleet.host_fallback_total").inc(kind=kind)


def _sup_launch(label: str, thunk):
    """One merge launch (an upload or a device call) through the process
    DeviceSupervisor: bounded retry on transient errors, typed
    DeviceFailure on a device error, in-flight accounting.  The one-shot
    merges' thunks are pure (fresh uploads, no donated buffers), so a
    retry is safe."""
    return get_supervisor().launch(thunk, label=label)


def _sup_fetch(label: str, value) -> np.ndarray:
    """Supervised host fetch: the merge's sync point (drains the
    in-flight queue through it)."""
    return get_supervisor().fetch(value, label=label)


def _host_degrade(failure: DeviceFailure, family: str, cid=None, changes=None, payloads=None):
    """A one-shot merge that failed under an armed fault, re-run on the
    host engine over its change lists (or its payloads, decoded): the
    same result by the differential tests, noted in the supervisor's
    report and counted in fleet.degraded_merges_total{family}.  A real
    device failure (a kernel's failed launch or fault, a CUDA error, an
    out-of-memory) is raised to the caller as it is, typed: no host
    result hides a card or a kernel that failed."""
    if not failure.injected:
        raise failure
    from ..resilience import hostpath

    get_supervisor().note_degradation(f"fleet.{family}")
    obs.counter("fleet.degraded_merges_total").inc(family=family)
    if payloads is not None:
        changes = [decode_changes(p) for p in payloads]
    return hostpath.host_merge_changes(family, changes, cid)


def _mesh_pad(mesh: Mesh, d: int) -> int:
    """Doc count padded up to a multiple of the mesh's doc dimension."""
    dm = mesh.shape[DOC_AXIS]
    return ((d + dm - 1) // dm) * dm


def _gather_docs(outs: list, lead: torch.device):
    """The mesh rows' outputs (each a tensor or a tuple of tensors with a
    leading doc axis) concatenated in doc order on `lead`, the mesh's
    first device: the gather of the JAX package's P("docs") outputs.  One
    row's outputs come back as they are."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(lead) for o in outs])
    return type(outs[0])(torch.cat([o[k].to(lead) for o in outs]) for k in range(len(outs[0])))


class Fleet:
    """Batched merge front end bound to a device mesh (parallel/mesh.py)
    or one device (default "cuda"; DeviceUnavailable without a card
    unless "cpu" is asked for).  Give `device` or `mesh`, not both: a
    mesh's first device is the fleet's `device`, and one device is a 1 x
    1 mesh.  Every one-shot merge pads its doc axis to a multiple of the
    mesh's rows (_mesh_pad) and runs each row's contiguous docs on that
    row's lead device, the rows' results gathered in doc order on the
    first device (a one-row mesh: one device call).  Every merge's
    upload, device call and fetch run under the process
    DeviceSupervisor, one supervised step for all rows; a device failure
    reaches the caller as a typed DeviceFailure, and under an armed
    fault the change-list and payload merges degrade to the host engine
    (module docstring)."""

    def __init__(self, device: Optional[DeviceLike] = None, mesh: Optional[MeshLike] = None):
        if device is not None and mesh is not None:
            raise ConfigError("device", str(device), "None when a mesh is given (its first device is the fleet's)")
        if mesh is not None:
            self.mesh = make_mesh(mesh)
            self.device = self.mesh.lead
        else:
            self.device = resolve_device("cuda" if device is None else device)
            self.mesh = Mesh([[self.device]])

    def _sharded(self, label: str, batch, upload, merge):
        """A one-shot merge's device call over the mesh rows: the numpy
        column tuple `batch` ([D, ...], D a multiple of the rows) cut into
        each row's docs, `upload(part, dev)` of every row in one
        supervised launch, `merge(cols, dev)` of every row in a second,
        whose outputs (a tensor or a tuple of [docs, ...] tensors) come
        back gathered on the mesh's first device in doc order."""
        parts, cols = self._upload_rows(label, batch, upload)
        return self._merge_rows(label, parts, cols, merge)

    def _upload_rows(self, label: str, batch, upload):
        """_sharded's first launch: (the rows' (device, slice) parts, their
        uploaded columns)."""
        parts = doc_sharding(self.mesh, doc_count(batch))
        return parts, _sup_launch(label, lambda: [upload(docs_of(batch, sl), dev) for dev, sl in parts])

    def _merge_rows(self, label: str, parts, cols, merge):
        """_sharded's second launch."""
        return _sup_launch(label, lambda: _gather_docs([merge(c, dev) for c, (dev, _) in zip(cols, parts)],
                                                       self.mesh.lead))

    def merge_text_docs(self, extracts: Sequence[SeqExtract], pad_docs: Optional[int] = None) -> TextMergeResult:
        """Final text of every document of the batch, merged in one
        device call a mesh row.  Docs are padded to a common bucketed
        element count, the doc axis to `pad_docs` (default: a multiple of
        the mesh's rows).  It takes extracts, so it has nothing to degrade
        to: a DeviceFailure reaches the caller.  Ticks rank.* for the
        [d_pad, n] rings it ranks, as ops/fugue_batch.merge_docs does."""
        d = len(extracts)
        with tracing.span("fleet.text.stack", docs=d) as sp:
            n = pad_bucket(max(e.n for e in extracts))
            d_pad = pad_docs or _mesh_pad(self.mesh, d)
            _obs_merge("text", d, sum(e.n for e in extracts), n * d_pad, (n, d_pad))
            _tick_rank_obs(d_pad, n, None, self.device)
            batched = stack_seq_columns(extracts, n, d_pad)
            if sp is not None:
                sp["rows"] = n
        with tracing.span("fleet.text.upload"):
            parts, cols = self._upload_rows("fleet.text", batched, seq_columns_to_torch)
        with tracing.span("fleet.text.launch"), tracing.device_span("fleet.text.merge_device", self.mesh.lead):
            codes, counts = self._merge_rows("fleet.text", parts, cols,
                                             lambda c, dev: materialize_content_batch(c, device=dev))
        # the fetch waits for the merge's stream: its span, closing,
        # delivers the merge's device spans
        with tracing.span("fleet.text.fetch"):
            codes, counts = _sup_fetch("fleet.text", codes), _sup_fetch("fleet.text", counts)
        with tracing.span("fleet.text.decode", docs=d):
            return TextMergeResult(texts_of(codes, counts, d))

    def merge_text_changes(self, docs_changes: Sequence[Sequence[Change]], cid: ContainerID) -> TextMergeResult:
        """Texts of container `cid` from each doc's decoded change list;
        under an armed fault, the host engine's."""
        with tracing.span("fleet.text.changes", docs=len(docs_changes)):
            with tracing.span("fleet.text.extract", docs=len(docs_changes), fallbacks=0):
                extracts = [extract_seq_container(chs, cid) for chs in docs_changes]
            try:
                return self.merge_text_docs(extracts)
            except DeviceFailure as e:
                return TextMergeResult(_host_degrade(e, "text", cid, changes=docs_changes))

    def merge_text_payloads(self, payloads: Sequence[bytes], cid: ContainerID) -> TextMergeResult:
        """Texts of container `cid` from each doc's binary updates payload
        (envelope-stripped, full history): the native explode, and for a
        payload it rejects (ValueError, CodecDecodeError among them) the
        Python decode, counted in FLEET_FALLBACKS.  A payload whose
        inserts name elements outside it raises ValueError; a codec that
        cannot be built raises KernelBuildError.  Under an armed fault, the
        host engine's texts of the decoded payloads."""
        with tracing.span("fleet.text.payloads", docs=len(payloads), payload_bytes=sum(map(len, payloads))):
            with tracing.span("fleet.text.extract", docs=len(payloads)) as sp:
                extracts, fallbacks = [], 0
                for p in payloads:
                    try:
                        ex = extract_seq_from_payload(p, cid)
                    except ValueError:
                        _obs_fallback("payload_extract")
                        fallbacks += 1
                        try:
                            ex = extract_seq_container(decode_changes(p), cid)
                        except KeyError as e:
                            raise ValueError(
                                f"payload is not self-contained (references elements outside it: {e}); one-shot "
                                "fleet merges need full-history payloads"
                            ) from e
                    extracts.append(ex)
                if sp is not None:
                    sp["fallbacks"] = fallbacks
            try:
                return self.merge_text_docs(extracts)
            except DeviceFailure as e:
                return TextMergeResult(_host_degrade(e, "text", cid, payloads=payloads))

    def merge_richtext_changes(self, docs_changes: Sequence[Sequence[Change]], cid: ContainerID,
                               pad_docs: Optional[int] = None) -> List[List[dict]]:
        """Every doc's rich text `cid` from its change list, as Quill-style
        segments [{insert, attributes?}] with resolved styles, in one
        device call a mesh row: the chain-contracted columns of each doc
        padded to bucketed (N, C, P) rows and the doc axis to `pad_docs`
        (default: a multiple of the mesh's rows), one upload a column, the
        chain merge with its style resolution, one fetch of the outputs.
        Under an armed fault, the host engine's segments."""
        extracts = [extract_richtext_chain(chs, cid) for chs in docs_changes]
        d = len(extracts)
        d_pad = max(d, pad_docs) if pad_docs else _mesh_pad(self.mesh, d)
        batch, n_keys = _stack_richtext(extracts, d_pad)
        n = pad_bucket(max(1, max(c.chain.chain_id.shape[0] for c, _, _ in extracts)))
        cpad = pad_bucket(max(1, max(c.chain.c_parent.shape[0] for c, _, _ in extracts)))
        p = pad_bucket(max(1, max(c.pair_start.shape[0] for c, _, _ in extracts)), floor=16)
        _obs_merge("richtext", d, sum(c.chain.chain_id.shape[0] for c, _, _ in extracts), n * d_pad,
                   (n, cpad, p, n_keys, d_pad))
        try:
            out = self._sharded("fleet.richtext", batch, _on,
                                lambda c, dev: richtext_chain_merge_batch(c, n_keys, device=dev))
            out = [_sup_fetch("fleet.richtext", t) for t in out]
        except DeviceFailure as e:
            return _host_degrade(e, "richtext", cid, changes=docs_changes)
        return [segments_from_device(*(o[i] for o in out), keys, values) for i, (_, keys, values) in enumerate(extracts)]

    def merge_movable_changes(self, docs_changes: Sequence[Sequence[Change]], cid: ContainerID) -> List[list]:
        """Every doc's MovableList `cid` from its change list, as its value
        list, in one device call a mesh row; under an armed fault, the
        host engine's."""
        extracts = [extract_movable(chs, cid) for chs in docs_changes]
        try:
            return self._merge_movable_extracted(extracts)
        except DeviceFailure as e:
            return _host_degrade(e, "movable", cid, changes=docs_changes)

    def merge_movable_payloads(self, payloads: Sequence[bytes], cid: ContainerID) -> List[list]:
        """merge_movable_changes from each doc's binary updates payload
        (envelope-stripped, full history): the native movable explode,
        values decoded only where they win, and for a payload it rejects
        (ValueError, CodecDecodeError among them) the Python decode,
        counted in FLEET_FALLBACKS.  A payload whose ops name slots
        outside it raises ValueError.  Under an armed fault, the host
        engine's value lists of the decoded payloads."""
        extracts = []
        for p in payloads:
            try:
                ex = extract_movable_from_payload(p, cid)
            except ValueError:
                _obs_fallback("payload_extract")
                try:
                    ex = extract_movable(decode_changes(p), cid)
                except KeyError as e:
                    raise ValueError(
                        f"payload is not self-contained (references elements outside it: {e}); one-shot fleet "
                        "merges need full-history payloads"
                    ) from e
            extracts.append(ex)
        try:
            return self._merge_movable_extracted(extracts)
        except DeviceFailure as e:
            return _host_degrade(e, "movable", cid, payloads=payloads)

    def _merge_movable_extracted(self, extracts) -> List[list]:
        """The merge of (MovableCols, elems, values) extracts: stacked
        (_stack_movable) with the doc axis padded to the mesh, one upload
        a column, movable_merge_batch, one fetch, then each doc's
        winners' values (_movable_values)."""
        d = len(extracts)
        d_pad = _mesh_pad(self.mesh, d)
        batch, n_elems = _stack_movable(extracts, d_pad)
        s_, k = batch.seq.parent.shape[1], batch.set_elem.shape[1]
        _obs_merge("movable", d, sum(c.seq.parent.shape[0] + c.set_elem.shape[0] for c, _, _ in extracts),
                   (s_ + k) * d_pad, (s_, k, n_elems, d_pad))
        out, counts = self._sharded("fleet.movable", batch, _on,
                                    lambda c, dev: movable_merge_batch(c, n_elems, device=dev))
        return _movable_values(_sup_fetch("fleet.movable", out), _sup_fetch("fleet.movable", counts), extracts)

    def merge_counter_changes(self, docs_changes: Sequence[Sequence[Change]]) -> List[Dict[ContainerID, float]]:
        """Every doc's counters {container: sum} from its change list, in
        one device call a mesh row (order-independent segment sums;
        float32, the precision contract of DeviceCounterBatch); under an
        armed fault, the host engine's."""
        d = len(docs_changes)
        d_pad = _mesh_pad(self.mesh, d)
        slot, delta, valid, s, cids_per_doc = self._counter_cols(docs_changes, d_pad)
        m = slot.shape[1]
        _obs_merge("counter", d, int(valid.sum()), m * d_pad, (m, s, d_pad))
        try:
            sums = self._sharded("fleet.counter", _CounterCols(slot, delta, valid), _on,
                                 lambda c, dev: counter_merge_batch(*c, s, device=dev))
            sums = _sup_fetch("fleet.counter", sums)
        except DeviceFailure as e:
            return _host_degrade(e, "counter", changes=docs_changes)
        return [{cid: float(sums[di, j]) for j, cid in enumerate(cids)} for di, cids in enumerate(cids_per_doc)]

    def _counter_cols(self, docs_changes: Sequence[Sequence[Change]], d_pad: int = 0):
        """(slot, delta, valid [max(D, d_pad), M] numpy columns, slot
        count, each doc's counters in slot order): one row per increment,
        a doc's counters numbered by first use, filler docs all invalid."""
        rows_per_doc = []
        cids_per_doc = []
        for changes in docs_changes:
            rows = []
            cid_of: Dict[ContainerID, int] = {}
            cids: List[ContainerID] = []
            for ch in changes:
                for op in ch.ops:
                    if not isinstance(op.content, CounterIncr):
                        continue
                    if op.container not in cid_of:
                        cid_of[op.container] = len(cids)
                        cids.append(op.container)
                    rows.append((cid_of[op.container], op.content.delta))
            rows_per_doc.append(rows)
            cids_per_doc.append(cids)
        m = pad_bucket(max(1, max(len(r) for r in rows_per_doc)), floor=16)
        s = max(1, max(len(c) for c in cids_per_doc))
        d = max(len(docs_changes), d_pad)
        slot = np.zeros((d, m), np.int32)
        delta = np.zeros((d, m), np.float32)
        valid = np.zeros((d, m), bool)
        for di, rows in enumerate(rows_per_doc):
            if rows:
                slot[di, : len(rows)] = [r[0] for r in rows]
                delta[di, : len(rows)] = [r[1] for r in rows]
                valid[di, : len(rows)] = True
        return slot, delta, valid, s, cids_per_doc

    def _batch_map_cols(self, extracts: Sequence[MapExtract], m: int, d_pad: int = 0) -> MapOpCols:
        """Per-doc MapExtract rows stacked into padded [max(D, d_pad), M]
        numpy columns (filler docs all invalid)."""

        def col(rows_list, fill, dtype):
            out = np.full((max(len(extracts), d_pad), m), fill, dtype)
            for i, r in enumerate(rows_list):
                out[i, : len(r)] = r
            return out

        return MapOpCols(
            slot=col([e.slot for e in extracts], 0, np.int32),
            lamport=col([e.lamport for e in extracts], 0, np.int32),
            peer=col([e.peer for e in extracts], 0, np.int32),
            value_idx=col([e.value_idx for e in extracts], 0, np.int32),
            valid=col([e.valid for e in extracts], False, bool),
        )

    def merge_map_docs(self, extracts: Sequence[MapExtract]) -> List[Dict[str, object]]:
        """LWW winners of a batch of docs in one device call a mesh row;
        per doc {key: value} over every map container's keys (a key set in
        two containers keeps the later slot's winner, as in JAX).  It
        takes extracts, so it has nothing to degrade to: a DeviceFailure
        reaches the caller."""
        m = pad_bucket(max(1, max(len(e.slot) for e in extracts)))
        s = max(1, max(len(e.slots) for e in extracts))
        d_pad = _mesh_pad(self.mesh, len(extracts))
        _obs_merge("map", len(extracts), sum(len(e.slot) for e in extracts), m * d_pad, (m, s, d_pad))
        batched = self._batch_map_cols(extracts, m, d_pad)
        vi = self._sharded("fleet.map", batched, _on, lambda c, dev: lww_merge_batch(c, s, device=dev)[0])
        return self._map_winner_values(_sup_fetch("fleet.map", vi), extracts)

    def merge_map_docs_sharded(self, extracts: Sequence[MapExtract]) -> List[Dict[str, object]]:
        """merge_map_docs with each doc's op rows sharded over the mesh's
        op axis as well (ops/lww.make_lww_sharded), for very large
        imports: the op rows padded to a multiple of the op axis, uploaded
        to the mesh's first device in one supervised launch, the sharded
        merge in a second (each (row, column) block on its device, the
        partials combined on the row's lead device), one fetch.  On a
        mesh whose op axis is 1, merge_map_docs.  The same output
        contract, and nothing to degrade to."""
        op_dim = self.mesh.shape[OP_AXIS]
        if op_dim <= 1:
            return self.merge_map_docs(extracts)
        m = pad_bucket(max(1, max(len(e.slot) for e in extracts)))
        m = ((m + op_dim - 1) // op_dim) * op_dim  # divisible by the op axis
        s = max(1, max(len(e.slots) for e in extracts))
        d_pad = _mesh_pad(self.mesh, len(extracts))
        _obs_merge("map_sharded", len(extracts), sum(len(e.slot) for e in extracts), m * d_pad,
                   (m, s, d_pad, op_dim))
        batched = self._batch_map_cols(extracts, m, d_pad)
        lead = self.mesh.lead
        cols = _sup_launch("fleet.map_sharded", lambda: _on(batched, lead))
        fn = make_lww_sharded(self.mesh, s)
        vi, _, _ = _sup_launch("fleet.map_sharded", lambda: fn(cols))
        return self._map_winner_values(_sup_fetch("fleet.map_sharded", vi), extracts)

    def merge_tree_changes(self, docs_changes: Sequence[Sequence[Change]], cid: ContainerID) -> List[dict]:
        """Every doc's tree `cid` from its change list, in one replay
        launch a mesh row: {TreeID: parent TreeID | None} of the live
        nodes; under an armed fault, the host engine's."""
        extracted = [extract_tree_ops(chs, cid) for chs in docs_changes]
        try:
            return self._merge_tree_extracted(extracted, "tree")
        except DeviceFailure as e:
            return _host_degrade(e, "tree", cid, changes=docs_changes)

    def merge_tree_payloads(self, payloads: Sequence[bytes], cid: ContainerID) -> List[dict]:
        """merge_tree_changes from each doc's binary updates payload
        (envelope-stripped): the native tree explode, and for a payload it
        rejects (ValueError, CodecDecodeError among them) the Python
        decode, counted in FLEET_FALLBACKS.  Tree ops carry no references
        into other rows, so that fallback is total.  Under an armed fault,
        the host engine's maps of the decoded payloads."""
        extracted = []
        for p in payloads:
            try:
                ex = extract_tree_from_payload(p, cid)
            except ValueError:
                _obs_fallback("payload_extract")
                ex = extract_tree_ops(decode_changes(p), cid)
            extracted.append(ex)
        try:
            return self._merge_tree_extracted(extracted, "tree")
        except DeviceFailure as e:
            return _host_degrade(e, "tree", cid, payloads=payloads)

    def _stack_tree_cols(self, extracted, d_pad: int = 0) -> Tuple[TreeOpCols, int]:
        """(the extracts' move logs as [max(D, d_pad), M] numpy columns
        padded to M = pad_bucket(longest log, 16) rows (target 0, parent
        ROOT, invalid; filler docs likewise), n = max(1, most nodes))."""
        m = pad_bucket(max(1, max(c.target.shape[0] for c, _, _ in extracted)), floor=16)
        n = max(1, max(len(nodes) for _, nodes, _ in extracted))
        d = max(len(extracted), d_pad)
        cols = TreeOpCols(np.zeros((d, m), np.int32), np.full((d, m), ROOT, np.int32), np.zeros((d, m), bool))
        for i, (c, _, _) in enumerate(extracted):
            for dst, src in zip(cols, c):
                dst[i, : src.shape[0]] = src
        return cols, n

    def _tree_replay(self, extracted, family: str) -> List[np.ndarray]:
        """(parents [D, n], effected [D, M], deleted [D, n]) of the
        extracts: the stacked columns uploaded, the replay kernel a mesh
        row, is_deleted_batch on the gathered parents, the results
        fetched, each supervised under fleet.{family}."""
        d = len(extracted)
        d_pad = _mesh_pad(self.mesh, d)
        cols, n = self._stack_tree_cols(extracted, d_pad)
        m = cols.target.shape[1]
        # tree_children is a family of its own: its extra reads must not
        # alias the plain tree merge's shapes
        _obs_merge(family, d, sum(c.target.shape[0] for c, _, _ in extracted), m * d_pad, (m, n, d_pad))
        label = f"fleet.{family}"
        parents, eff = self._sharded(label, cols, _on, lambda c, dev: tree_merge_batch(c, n))
        deleted = _sup_fetch(label, _sup_launch(label, lambda: is_deleted_batch(parents)))
        return [_sup_fetch(label, parents), _sup_fetch(label, eff), deleted]

    def _merge_tree_extracted(self, extracted, family: str) -> List[dict]:
        parents, _eff, deleted = self._tree_replay(extracted, family)
        return [_parent_map(nodes, parents[i], deleted[i]) for i, (_c, nodes, _pos) in enumerate(extracted)]

    def merge_tree_children(self, docs_changes: Sequence[Sequence[Change]], cid: ContainerID) -> List[dict]:
        """Like merge_tree_changes, but ordered children maps {parent |
        None: [child TreeIDs by (fractional index, the winning move's
        key)]}: the materialized tree shape.  Under an armed fault, the
        host engine's."""
        extracted = [extract_tree_ops(chs, cid) for chs in docs_changes]
        try:
            parents, eff, deleted = self._tree_replay(extracted, "tree_children")
        except DeviceFailure as e:
            return _host_degrade(e, "tree_children", cid, changes=docs_changes)
        out = []
        for i, (c, nodes, row_pos) in enumerate(extracted):
            n_rows = c.target.shape[0]
            e_i = eff[i, :n_rows]
            pos = positions_of(c, row_pos, e_i)
            # the sibling tiebreak is the winning move's key; rows are
            # sorted by (lamport, peer, counter), so its row index
            last_eff_row: Dict[int, int] = {}
            for j in range(n_rows):
                if e_i[j]:
                    last_eff_row[int(c.target[j])] = j
            out.append(_children_map(nodes, parents[i], deleted[i], pos, last_eff_row))
        return out

    def _map_winner_values(self, vi: np.ndarray, extracts) -> List[Dict[str, object]]:
        out: List[Dict[str, object]] = []
        for i, e in enumerate(extracts):
            got: Dict[str, object] = {}
            for si, (cid, key) in enumerate(e.slots):
                idx = int(vi[i, si])
                if idx >= 0:
                    got[key] = e.values[idx]
            out.append(got)
        return out


# ---- resident text batch ------------------------------------------------------


def _stack_richtext(extracts, d_pad: int = 0):
    """(numpy RichtextChainCols [max(D, d_pad), ...], n_keys) of
    extract_richtext_chain outputs: rows padded to pad_bucket of the most
    elements and chains, pairs to pad_bucket(most pairs, 16), the style
    keys to pad_bucket(most keys, 4)."""
    cols = [c for c, _, _ in extracts]
    n = pad_bucket(max(1, max(c.chain.chain_id.shape[0] for c in cols)))
    c_pad = pad_bucket(max(1, max(c.chain.c_parent.shape[0] for c in cols)))
    p = pad_bucket(max(1, max(c.pair_start.shape[0] for c in cols)), floor=16)
    n_keys = pad_bucket(max(1, max(len(k) for _, k, _ in extracts)), floor=4)
    return stack_richtext_chain_cols(cols, n, c_pad, p, d_pad), n_keys


def _stack_movable(extracts, d_pad: int = 0):
    """(numpy MovableCols [max(D, d_pad), ...], n_elems) of movable
    extracts: slots padded to pad_bucket(most slots), sets to
    pad_bucket(most sets, 16), the element count to pad_bucket(most
    elements, 16), filler docs all invalid."""
    cols = [c for c, _, _ in extracts]
    s = pad_bucket(max(1, max(c.seq.parent.shape[0] for c in cols)))
    k = pad_bucket(max(1, max(c.set_elem.shape[0] for c in cols)), floor=16)

    def col(f, size, fill):
        return stack_rows([getattr(c, f) for c in cols], size, fill, d_pad,
                          dtype=bool if f == "set_valid" else np.int32)

    batch = MovableCols(stack_seq_columns([c.seq for c in cols], s, d_pad), col("lamport", s, 0),
                        *[col(f, k, False if f == "set_valid" else 0) for f in MovableCols._fields[2:]])
    return batch, pad_bucket(max(1, max(len(e) for _, e, _ in extracts)), floor=16)


def _movable_values(out: np.ndarray, counts: np.ndarray, extracts) -> List[list]:
    """Each doc's value list from the merge's value indexes: a lazy
    payload cell decodes here, so only winners ever decode."""
    results = []
    for i, (_, _, values) in enumerate(extracts):
        row = []
        for j in out[i, : counts[i]].tolist():
            v = values[j] if j >= 0 else None
            row.append(v.get() if isinstance(v, LazyPayloadValue) else v)
        results.append(row)
    return results


def _batch_export_select(batch, family: str, index, requests, sup=None) -> List[np.ndarray]:
    """The read plane's selection entry, shared by every resident batch:
    ONE supervised launch (under fleet.export.{family}, through `sup` or
    the process supervisor) answers a window of (doc, frontier) pull
    requests against the change-span index (ops/export_batch.
    ExportIndex.select), under the batch's device lock (the selection
    reads no batch state, but the supervisor's drain must not interleave
    with a grow on the same device).  The ``export_launch`` fault site
    fires inside the supervised thunk, so an armed error is classified
    exactly as the same error raised by the selection: a device error
    (or a transient one past the retries) reaches the caller as a
    DeviceFailure."""
    sup = sup if sup is not None else get_supervisor()

    def thunk():
        faultinject.check("export_launch")
        return index.select(requests)

    with batch._dev_lock:
        # the selection is a pure read of the index: retry-safe
        return sup.launch(thunk, label=f"fleet.export.{family}")


def _grow_target(required: int, current: int) -> int:
    """Next power-of-two bucket >= required, at least 2x current (avoids
    repeated small regrows)."""
    return pad_bucket(required, floor=max(16, 2 * current))


def _resolve_row(overlay, idmap, key, di, what):
    """Overlay-then-id-map row lookup that raises a typed, actionable
    error for unknown ids."""
    r = overlay.get(key)
    if r is not None:
        return r
    try:
        return idmap[key]
    except KeyError:
        raise LoroError(
            f"doc {di}: {what} references unknown element {key} — resident "
            "batches need every doc's FULL history from its first epoch "
            "(feed the base import before deltas)"
        ) from None


def _pad_axis1(arrays: Dict[str, torch.Tensor], new_n: int, fills: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """[d, n] tensors re-padded to [d, new_n] with per-field fills, on
    their device: the repack of the resident grow path."""
    out = {}
    for f, a in arrays.items():
        t = torch.full((a.shape[0], new_n), fills[f], dtype=a.dtype, device=a.device)
        t[:, : a.shape[1]] = a
        out[f] = t
    return out


def _windowed_scatter_field_(col: torch.Tensor, nbl: torch.Tensor, vbl: torch.Tensor, idx: torch.Tensor) -> None:
    """One field of the block scatter, in place: the window
    col[d, idx[d]] takes the block's values where the block row is valid
    and keeps its own elsewhere, so a short update does not clobber its
    neighbours.  Every index must be in range (the caller's capacity
    check): on a card an out-of-range gather is a device assert, where
    JAX's dynamic_update_slice would clamp."""
    window = col.gather(1, idx)
    col.scatter_(1, idx, torch.where(vbl, nbl, window))


def _scatter_rows(state: Dict[str, torch.Tensor], blk: Dict[str, torch.Tensor], offsets: torch.Tensor) -> None:
    """Write each doc's block of new rows [D, W] at its row offset into
    every [D, cap] tensor of `state` (the columns and key halves), in
    place: the windows are offsets[:, None] + arange(W)."""
    idx = offsets[:, None] + torch.arange(blk["valid"].shape[1], device=offsets.device)
    for f, col in state.items():
        _windowed_scatter_field_(col, blk[f], blk["valid"], idx)


def _set_key_rows(key_hi: torch.Tensor, key_lo: torch.Tensor, d_idx: torch.Tensor, kh_rows, kl_rows) -> None:
    """Replace whole key rows of the docs d_idx, in place (renumbered
    docs)."""
    key_hi.index_copy_(0, d_idx, kh_rows)
    key_lo.index_copy_(0, d_idx, kl_rows)


def _set_deleted(deleted: torch.Tensor, d_idx: torch.Tensor, r_idx: torch.Tensor) -> None:
    """Tombstone (doc, row) pairs in place, one launch."""
    deleted.index_put_((d_idx, r_idx), torch.ones((), dtype=torch.bool, device=deleted.device))


def _release_rows_(arrays: Sequence[torch.Tensor], di: int, fills: Sequence[object]) -> None:
    """Reset doc row `di` of every [D, cap] tensor to its construction
    fill, in place (the device half of release_doc): the recycled slot
    is indistinguishable from a never-used one."""
    for a, fill in zip(arrays, fills):
        a[di].fill_(fill)


class _DeferredSeqDevice:
    """The device work of one coalesce group over a DeviceDocBatch or
    DeviceTreeBatch: each round's host block (its host state already
    committed: epochs, order engines, id maps, counts), waiting for the
    one merged scatter of commit_detached.  Every stashed block is an
    array the group owns (built fresh by its round)."""

    __slots__ = ("base0", "rounds", "renumbered", "del_d", "del_r", "key_snap")

    def __init__(self, base0: np.ndarray):
        self.base0 = base0  # per-doc counts at the group's start
        self.rounds: List[tuple] = []
        self.renumbered: set = set()
        self.del_d: List[np.ndarray] = []
        self.del_r: List[np.ndarray] = []
        self.key_snap: Optional[Dict[int, np.ndarray]] = None  # detach-time key rows of renumbered docs


def _group_scatters(base0: np.ndarray, cap: int, rounds: Sequence[Tuple[Dict[str, np.ndarray], Sequence[int]]],
                    fills: Dict[str, object]) -> List[Tuple[Dict[str, np.ndarray], np.ndarray]]:
    """The scatters that commit a detached group's row blocks, as
    [(block, offsets)]: one merged block when every doc with rows in the
    group fits its window under the capacity, else each round's own block
    (each validated when it was staged).  A doc's segments across rounds
    are contiguous (appends only extend the tail), so the merged block is
    each doc's concatenated segments at its group-start offset.  A doc
    with no rows in a block gets offset 0, as in a serial append: its
    window keeps its own values, and a doc idle near the capacity cannot
    push a window past the end (a device assert on a card).  Never grows:
    a grow here would race the next group's staging."""
    n_new = np.asarray([k for _, k in rounds], np.int64).reshape(len(rounds), -1)
    base0 = np.asarray(base0, np.int64)
    total = n_new.sum(axis=0)
    width = pad_bucket(int(total.max()), floor=16)
    if int((base0[total > 0] + width).max(initial=0)) > cap:
        out, off = [], base0.copy()
        for (blk, _), k in zip(rounds, n_new):
            out.append((blk, np.where(k > 0, off, 0)))
            off += k
        return out
    merged = {f: np.full((len(base0), width), fills[f], a.dtype) for f, a in rounds[0][0].items()}
    pos = np.zeros(len(base0), np.int64)
    for (blk, _), k in zip(rounds, n_new):
        for di in np.flatnonzero(k):
            p, kd = int(pos[di]), int(k[di])
            for f, a in merged.items():
                a[di, p : p + kd] = blk[f][di, :kd]
            pos[di] += kd
    return [(merged, np.where(total > 0, base0, 0))]


class _FoldGroupMixin:
    """The coalesce group of a folded resident (DeviceMapBatch,
    DeviceCounterBatch): each round's fold rows accumulate in a
    _DeferredFold, and the commit lands them in one _device_fold (the
    epoch still ticks every round).  `_FAMILY` labels the counter."""

    _FAMILY = ""

    def begin_coalesce(self) -> None:
        if self._defer is not None:
            raise RuntimeError("coalesce group already open")
        self._defer = _DeferredFold(self.n_docs)

    def detach_coalesce(self) -> Optional[_DeferredFold]:
        d, self._defer = self._defer, None
        return d

    def commit_detached(self, d: Optional[_DeferredFold]) -> None:
        if d is None or not any(d.rows):
            return
        self._device_fold(d.rows)
        obs.counter("pipeline.coalesced_rounds_total").inc(d.n_rounds, family=self._FAMILY)

    def flush_coalesce(self) -> None:
        self.commit_detached(self.detach_coalesce())


class _DeferredFold:
    """The fold rows of one coalesce group over an LWW or counter
    resident: per-doc row lists concatenated across rounds.  The folds
    are associative (max by (lamport, peer), float add), so one merged
    fold lands the winners of one fold a round."""

    __slots__ = ("rows", "n_rounds")

    def __init__(self, n_docs: int):
        self.rows: List[list] = [[] for _ in range(n_docs)]
        self.n_rounds = 0  # non-empty rounds folded

    def extend(self, rows_per_doc) -> None:
        if any(rows_per_doc):
            self.n_rounds += 1
        for di, rows in enumerate(rows_per_doc):
            if rows:
                self.rows[di].extend(rows)


def _parent_map(nodes: list, parents: np.ndarray, deleted: np.ndarray) -> dict:
    """{TreeID: parent TreeID | None} of one doc's live nodes from its
    replayed parents row and trash reachability."""
    res = {}
    for j, tid in enumerate(nodes):
        p = int(parents[j])
        if p == ABSENT or deleted[j]:
            continue
        res[tid] = None if p == ROOT else nodes[p]
    return res


def _children_map(nodes: list, parents: np.ndarray, deleted: np.ndarray, pos: Dict[int, object],
                  key: Dict[int, int]) -> dict:
    """{parent TreeID | None: [live children]} of one doc, siblings by
    (position, tiebreak): `pos` and `key` give a node ordinal's winning
    position and the order of its winning move (b"" and 0 where none)."""
    kids: Dict = {}
    for j, tid in enumerate(nodes):
        p = int(parents[j])
        if p == ABSENT or deleted[j]:
            continue
        kids.setdefault(None if p == ROOT else nodes[p], []).append((pos.get(j) or b"", key.get(j, 0), tid))
    return {k: [t for _, _, t in sorted(v, key=lambda x: (x[0], x[1]))] for k, v in kids.items()}


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host block column on `dev`: uint32 as int64 holding the same
    values (the SeqColumnsU tensor convention), other dtypes as they are."""
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(dev).to(torch.int64) & 0xFFFFFFFF
    return torch.from_numpy(a).to(dev)


class StageClock:
    """Per-stage times, ms, of a resident batch's last public call: host
    stages by the host clock, device stages by CUDA events on a card (by
    the host clock on the CPU).  `read()` waits for the device stages.
    While spans are live, each stage is also a `resident.<stage>` span of
    utils/tracing with the clock's own times: a host span, or a device
    span over the stage's event pair."""

    def __init__(self, device: torch.device):
        self.device = device
        self._host: Dict[str, float] = {}
        self._events: List[Tuple[str, object, object]] = []

    def reset(self) -> None:
        self._host = {}
        self._events = []

    @contextmanager
    def host(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self._host[name] = self._host.get(name, 0.0) + (t1 - t0) / 1e6
            tracing.record("resident." + name, t0, t1)

    @contextmanager
    def device_stage(self, name: str):
        if self.device.type != "cuda":
            with self.host(name):
                yield
            return
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        a.record()
        try:
            yield
        finally:
            b.record()
            self._events.append((name, a, b))
            tracing.add_device_span("resident." + name, t0, a, b, self.device)

    def read(self) -> Dict[str, float]:
        out = dict(self._host)
        for name, a, b in self._events:
            b.synchronize()
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


class DeviceDocBatch:
    """Device-resident document batch with incremental ingest.

    The element tables stay on the device between syncs; each append
    ships only the new rows and tombstones, and texts() re-resolves
    order in one launch.  Rows are appended at each doc's tail, not in
    (peer, counter) order, so the tables are the row-order-free
    SeqColumnsU.  Bound to one device (default "cuda";
    DeviceUnavailable without a card unless "cpu" is asked for)."""

    def __init__(self, n_docs: int, capacity: int, device: DeviceLike = "cuda", as_text: bool = True,
                 auto_grow: bool = False):
        """as_text=False holds List containers: contents become per-doc
        value ordinals (the host keeps the value stores) and values() is
        the materializer instead of texts().  auto_grow=True repacks the
        batch to the next capacity bucket instead of raising when an
        append overflows (long-lived server lifecycle)."""
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.cap = capacity
        self.as_text = as_text
        self.auto_grow = auto_grow
        self._c_pad = 256  # chain budget of the solver (doubles on overflow)
        self.counts = np.zeros(n_docs, np.int64)  # used rows per doc
        # ingest epochs date rows and tombstones (compaction's input)
        self.epoch = 0
        self.tomb_epoch = np.full((n_docs, capacity), -1, np.int64)
        self.row_epoch = np.full((n_docs, capacity), -1, np.int64)
        # host-side id -> row resolution per doc (stage/lookup/commit
        # contract, parallel/idmap.py)
        self.id2row = [make_idmap() for _ in range(n_docs)]
        self.value_store: List[List] = [[] for _ in range(n_docs)]
        # style-anchor metadata ((peer, ctr) -> dict) and a row backmap,
        # so delete tombstones deactivate pairs
        self.anchor_meta: List[Dict[Tuple[int, int], dict]] = [dict() for _ in range(n_docs)]
        self.anchor_by_row: List[Dict[int, Tuple[int, int]]] = [dict() for _ in range(n_docs)]
        # a host order engine a doc assigns standing 64-bit order keys in
        # O(delta); texts() sorts by them instead of re-ranking the table
        self.order = [self._fresh_order() for _ in range(n_docs)]
        self.cols = SeqColumnsU(**{
            f: torch.full((n_docs, capacity), fill, dtype=self._COL_DTYPES[f], device=self.device)
            for f, fill in self._COL_FILLS.items()
        })
        self.key_hi = torch.full((n_docs, capacity), 0xFFFFFFFF, dtype=torch.int64, device=self.device)
        self.key_lo = torch.full((n_docs, capacity), 0xFFFFFFFF, dtype=torch.int64, device=self.device)
        # the open coalesce group (None: every append launches its own
        # scatter; see begin_coalesce)
        self._defer: Optional[_DeferredSeqDevice] = None
        # serializes writers of the device tensors: appends, a detached
        # commit on another thread, grow, release_doc, compact
        self._dev_lock = named_rlock("fleet.dev")
        self.clock = StageClock(self.device)

    # column fill values shared by __init__, grow() and the block: one
    # table so they cannot drift
    _COL_FILLS = dict(
        parent=-1, side=0, peer_hi=0, peer_lo=0, counter=0,
        deleted=True, content=-1, valid=False,
    )
    # each column's tensor dtype (peer halves: int64 holding the uint32
    # values) and host block dtype
    _COL_DTYPES = dict(
        parent=torch.int32, side=torch.int32, peer_hi=torch.int64, peer_lo=torch.int64, counter=torch.int32,
        deleted=torch.bool, content=torch.int32, valid=torch.bool,
    )
    _BLK_DTYPES = dict(
        parent=np.int32, side=np.int32, peer_hi=np.uint32, peer_lo=np.uint32, counter=np.int32,
        deleted=np.bool_, content=np.int32, valid=np.bool_,
    )

    def stage_ms(self) -> Dict[str, float]:
        """Per-stage ms of the last append_changes / append_payloads /
        texts / values / compact call (waits for its device stages).  Appends:
        explode (read_tables and the native explode, or the Python walk
        with its overlay), stage (id-map staging and the batch lookups of
        parents and deletes in earlier epochs), grow, commit (id maps,
        anchors, values), block (host block build), order (order-engine
        appends, threaded over docs), upload_scatter (block upload and
        scatter), renumber_keys (renumbered docs' whole key rows, built
        and uploaded), tombstone.  Reads: sort or solve, fetch, decode.
        compact: fetch, host, upload."""
        return self.clock.read()

    # -- round coalescing ----------------------------------------------
    # Between begin_coalesce() and flush_coalesce() every append commits
    # its host state round by round as before (epoch clock, row and
    # tombstone epochs, order engines, id maps, counts), so the final
    # state is byte for byte the serial one; only the device block
    # scatters and tombstone launches accumulate, and the commit ships
    # them as one scatter and one tombstone launch for the whole group.
    # Reads inside a group would see stale device columns: callers read
    # only after the commit.
    def begin_coalesce(self) -> None:
        if self._defer is not None:
            raise RuntimeError("coalesce group already open")
        self._defer = _DeferredSeqDevice(self.counts.copy())

    def detach_coalesce(self) -> Optional[_DeferredSeqDevice]:
        """Close the group and hand back its pending device work for a
        later commit_detached (which may run on another thread while the
        next group stages).  What the commit needs of the host state is
        snapshotted here (renumbered docs' key rows; the group-start
        offsets already are), so the commit never reads order engines the
        next group is changing."""
        d, self._defer = self._defer, None
        if d is not None and d.renumbered:
            d.key_snap = {di: np.asarray(self.order[di].all_keys(), np.int64).copy() for di in sorted(d.renumbered)}
        return d

    def commit_detached(self, d: Optional[_DeferredSeqDevice]) -> None:
        """Ship a detached group's blocks as one merged scatter (one a
        round when the merged window would pass the capacity;
        _group_scatters) and one tombstone launch."""
        if d is None:
            return
        with self._dev_lock:
            if d.rounds:
                fills = dict(self._COL_FILLS, key_hi=0xFFFFFFFF, key_lo=0xFFFFFFFF)
                rounds = [(dict(blk, key_hi=kh, key_lo=kl), n_new) for blk, kh, kl, n_new in d.rounds]
                scatters = _group_scatters(d.base0, self.cap, rounds, fills)
                for i, (b, off) in enumerate(scatters):
                    last = i == len(scatters) - 1
                    self._device_commit_block({f: b[f] for f in self._COL_FILLS}, b["key_hi"], b["key_lo"], off,
                                              sorted(d.renumbered) if last else (), d.key_snap)
                obs.counter("pipeline.coalesced_rounds_total").inc(len(d.rounds),
                                                                   family="text" if self.as_text else "list")
            elif d.renumbered:
                # delete-only or empty rounds can renumber docs too
                self._upload_renumbered_keys(sorted(d.renumbered), d.key_snap)
            if d.del_d:
                self._device_mark_deleted(np.concatenate(d.del_d), np.concatenate(d.del_r))

    def flush_coalesce(self) -> None:
        """Close the open group and commit it, on this thread."""
        self.commit_detached(self.detach_coalesce())

    def _device_commit_block(self, blk, key_blk_hi, key_blk_lo, offsets, renumbered, key_snap=None) -> None:
        """The device tail of an append (and of a group's commit): upload
        the block, scatter it at each doc's offset, and re-upload whole
        key rows of renumbered docs (from `key_snap` when a detached
        group's commit gives it)."""
        with self._dev_lock:
            with self.clock.device_stage("upload_scatter"):
                dev = self.device
                blk_dev = {f: _to_device(v, dev) for f, v in blk.items()}
                blk_dev["key_hi"] = _to_device(key_blk_hi, dev)
                blk_dev["key_lo"] = _to_device(key_blk_lo, dev)
                state = {f: getattr(self.cols, f) for f in SeqColumnsU._fields}
                state["key_hi"], state["key_lo"] = self.key_hi, self.key_lo
                _scatter_rows(state, blk_dev, torch.from_numpy(np.asarray(offsets, np.int64)).to(dev))
            if renumbered:
                with self.clock.device_stage("renumber_keys"):
                    self._upload_renumbered_keys(renumbered, key_snap)

    def _upload_renumbered_keys(self, renumbered: Sequence[int], key_snap: Optional[Dict[int, np.ndarray]] = None
                                ) -> None:
        """Renumbered docs: whole [cap] key rows, uploaded and written in
        one index copy a half.  `key_snap` (doc -> keys) is a detached
        group's snapshot: the live engines belong to the group staging."""
        kh_rows = np.full((len(renumbered), self.cap), 0xFFFFFFFF, np.uint32)
        kl_rows = np.full((len(renumbered), self.cap), 0xFFFFFFFF, np.uint32)
        for i, di in enumerate(renumbered):
            keys = key_snap[di] if key_snap is not None else self.order[di].all_keys()
            kh, kl = split_keys(np.asarray(keys, np.int64))
            kh_rows[i, : len(kh)] = kh
            kl_rows[i, : len(kl)] = kl
        dev = self.device
        with self._dev_lock:
            d_idx = torch.as_tensor(list(renumbered), dtype=torch.int64).to(dev)
            _set_key_rows(self.key_hi, self.key_lo, d_idx, _to_device(kh_rows, dev), _to_device(kl_rows, dev))

    def _device_mark_deleted(self, d_all: np.ndarray, r_all: np.ndarray) -> None:
        """The device tail of mark_deleted: one tombstone scatter."""
        with self._dev_lock, self.clock.device_stage("tombstone"):
            dev = self.device
            _set_deleted(self.cols.deleted, torch.from_numpy(d_all.astype(np.int64)).to(dev),
                         torch.from_numpy(r_all.astype(np.int64)).to(dev))

    def grow(self, new_capacity: int) -> None:
        """Repack the resident columns to a larger row capacity (on the
        device; order engines, id maps, counts and host metadata do not
        depend on the capacity)."""
        if new_capacity <= self.cap:
            return
        with self._dev_lock:
            cols = _pad_axis1({f: getattr(self.cols, f) for f in SeqColumnsU._fields}, new_capacity, self._COL_FILLS)
            self.cols = SeqColumnsU(**cols)
            keys = _pad_axis1({"key_hi": self.key_hi, "key_lo": self.key_lo}, new_capacity,
                              {"key_hi": 0xFFFFFFFF, "key_lo": 0xFFFFFFFF})
            self.key_hi, self.key_lo = keys["key_hi"], keys["key_lo"]
            for name in ("tomb_epoch", "row_epoch"):
                ne = np.full((self.n_docs, new_capacity), -1, np.int64)
                ne[:, : self.cap] = getattr(self, name)
                setattr(self, name, ne)
            self.cap = new_capacity

    def release_doc(self, di: int) -> None:
        """Reset doc `di` to a never-used slot (the tiered-residency
        eviction): every host structure back to its construction value,
        every device row back to its fill.  The caller owns the safety
        argument: the doc's state is kept elsewhere, and no staged or
        in-flight device work references the doc.  Inside an open
        coalesce group the doc's group-start offset resets too, so a later
        round of the group can land a new doc at row 0."""
        self.counts[di] = 0
        self.tomb_epoch[di, :] = -1
        self.row_epoch[di, :] = -1
        self.id2row[di] = make_idmap()
        self.value_store[di] = []
        self.anchor_meta[di] = {}
        self.anchor_by_row[di] = {}
        self.order[di] = self._fresh_order()
        if self._defer is not None:
            self._defer.base0[di] = 0
            self._defer.renumbered.discard(di)
        with self._dev_lock:
            fields = SeqColumnsU._fields
            _release_rows_([getattr(self.cols, f) for f in fields] + [self.key_hi, self.key_lo], di,
                           [self._COL_FILLS[f] for f in fields] + [0xFFFFFFFF, 0xFFFFFFFF])
        obs.counter("fleet.doc_releases_total").inc(family="text" if self.as_text else "list")

    def compact(self, stable_epochs: Sequence[Optional[int]],
                extra_protect: Optional[Sequence[Optional[np.ndarray]]] = None,
                extra_dead: Optional[Sequence[Optional[np.ndarray]]] = None, return_remaps: bool = False):
        """Reclaim causally stable tombstones (the reference's analog is
        the shallow-snapshot floor, encoding/shallow_snapshot.rs:16-40).

        `stable_epochs[di]` is the newest ingest epoch (self.epoch after
        an append) that every replica of doc di has integrated; None skips
        the doc.  A tombstone whose delete was ingested at or before it is
        invisible at every replica.  Three keep-rules still hold, because
        Fugue ops can reference invisible rows:

        - attach targets: a future insert after a visible row with
          R-children parents on that row's total-order successor, a
          position-0 insert on the first row, and (text only) the
          anchor-aware expand walk can end on the last tombstone of an
          invisible window, so every tombstone followed by a live row and
          the last row stay;
        - live subtrees: a row with a surviving child stays, except a
          run-interior tombstone whose one live R-child is its run
          continuation, which drops by promoting that child into its
          place;
        - undated tombstones (from a checkpoint older than the epochs)
          never drop.

        `extra_protect[di]` marks rows a caller keeps external references
        to (DeviceMovableBatch's winning slot rows); `extra_dead[di]`
        marks rows the caller asserts are invisible and stably so
        (superseded movable slots): they join the droppable set under the
        same rules.  `return_remaps=True` also returns {di: old row -> new
        row, -1 = dropped}.  Anchor rows never drop.

        Rebuilds the order engine, id map, anchors and device columns of
        the compacted docs; returns the rows reclaimed.  The host pass
        fetches the whole grid, walks each compacted doc's rows in Python
        and uploads the whole grid again; stage_ms() gives fetch, host and
        upload."""
        if len(stable_epochs) > self.n_docs:
            raise ValueError(f"compact: {len(stable_epochs)} stable_epochs for a {self.n_docs}-doc batch")
        self.clock.reset()
        stable_epochs = list(stable_epochs) + [None] * (self.n_docs - len(stable_epochs))
        host = None  # fetched on the first doc that compacts
        key_hi = key_lo = None
        reclaimed = 0
        remaps: Dict[int, np.ndarray] = {}
        with self._dev_lock:
            for di, stable_e in enumerate(stable_epochs):
                if stable_e is None or not int(self.counts[di]):
                    continue
                if host is None:
                    with self.clock.host("fetch"):
                        host = {f: getattr(self.cols, f).to("cpu", copy=True).numpy() for f in SeqColumnsU._fields}
                        key_hi = self.key_hi.to("cpu", copy=True).numpy()
                        key_lo = self.key_lo.to("cpu", copy=True).numpy()
                with self.clock.host("host"):
                    n = self._compact_doc(di, int(stable_e), host, key_hi, key_lo, extra_protect, extra_dead, remaps)
                reclaimed += n
            if host is not None and reclaimed:
                with self.clock.host("upload"):
                    dev = self.device
                    # in place: the fetched arrays keep the tensors' dtypes,
                    # and no second grid is resident on the card
                    for f, v in host.items():
                        getattr(self.cols, f).copy_(torch.from_numpy(v))
                    self.key_hi.copy_(torch.from_numpy(key_hi))
                    self.key_lo.copy_(torch.from_numpy(key_lo))
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
        return (reclaimed, remaps) if return_remaps else reclaimed

    def _compact_doc(self, di, stable_e, host, key_hi, key_lo, extra_protect, extra_dead, remaps) -> int:
        """compact()'s pass over one doc, on the fetched columns: the rows
        reclaimed (0 leaves the doc as it was)."""
        k = int(self.counts[di])
        # the peer columns hold uint32 values in int64: the 64-bit peer
        # is rebuilt unsigned before the shift
        peer = (host["peer_hi"][di, :k].astype(np.uint64) << np.uint64(32)) | host["peer_lo"][di, :k].astype(np.uint64)
        ctr = host["counter"][di, :k].astype(np.int64)
        parent = host["parent"][di, :k].astype(np.int64)
        deleted = host["deleted"][di, :k]
        side = host["side"][di, :k].astype(np.int64)
        te = self.tomb_epoch[di, :k]
        dead = deleted.copy()  # invisible rows: tombstones and the caller's
        if extra_dead is not None and extra_dead[di] is not None:
            rows_d = np.asarray(extra_dead[di], np.int64)
            dead[rows_d[rows_d < k]] = True
        # attach-target protection from the standing total order
        order = np.lexsort((key_lo[di, :k], key_hi[di, :k]))
        protected = np.zeros(k, bool)
        protected[order[0]] = True  # the first row (position-0 inserts)
        succ_of = np.full(k, -1, np.int64)
        succ_of[order[:-1]] = order[1:]
        has_r = np.zeros(k, bool)
        rmask = side == 1
        has_r[parent[rmask][parent[rmask] >= 0]] = True
        tgt = np.flatnonzero((~dead) & has_r & (succ_of >= 0))
        protected[succ_of[tgt]] = True
        if self.as_text:
            # expand-walk targets (text only: style anchors can come at
            # any time, and the anchor-aware walk ends on the last
            # tombstone of an invisible window; lists never grow
            # anchors): the last tombstone before a live row, and the
            # document's last row
            nd_succ = np.flatnonzero((succ_of >= 0) & dead & ~dead[np.clip(succ_of, 0, k - 1)])
            protected[nd_succ] = True
            protected[order[-1]] = True
        # anchor rows never drop, live or dead: a dead end anchor with a
        # live start is a style that runs to the end of the document
        if self.anchor_by_row[di]:
            rows_a = np.fromiter(self.anchor_by_row[di], np.int64, len(self.anchor_by_row[di]))
            protected[rows_a[rows_a < k]] = True
        if extra_protect is not None and extra_protect[di] is not None:
            rows_x = np.asarray(extra_protect[di], np.int64)
            protected[rows_x[rows_x < k]] = True
        stable_dead = deleted & (te >= 0) & (te <= stable_e)
        if extra_dead is not None and extra_dead[di] is not None:
            stable_dead |= dead & ~deleted  # the caller's stability, as it is
        stable_dead &= ~protected
        # reverse pass (children sit at higher rows than their parents): a
        # stable tombstone drops when it anchors no live subtree, or when
        # its one live child is its R-side run continuation, which then
        # takes its place (the child keeps its id; the only siblings it
        # could re-order against are the dropped chain's own rows)
        dparent = parent.copy()
        dside = side.copy()
        prom = ctr.copy()  # the promoted placement counter
        live_l = np.zeros(k, np.int64)
        live_r = np.zeros(k, np.int64)
        only_r = np.full(k, -1, np.int64)  # valid where live_r == 1
        keep = np.zeros(k, bool)

        def credit(child: int, p: int, s: int) -> None:
            if p < 0:
                return
            if s == 1:
                live_r[p] += 1
                only_r[p] = child if live_r[p] == 1 else -1
            else:
                live_l[p] += 1

        for r in range(k - 1, -1, -1):
            if stable_dead[r] and live_l[r] == 0:
                if live_r[r] == 0:
                    continue  # the whole subtree is dead: drop
                if live_r[r] == 1:
                    c = int(only_r[r])
                    if peer[c] == peer[r] and prom[c] == ctr[r] + 1:
                        dparent[c] = parent[r]
                        dside[c] = side[r]
                        prom[c] = ctr[r]
                        credit(c, int(parent[r]), int(side[r]))
                        continue  # r drops, c takes its place
            keep[r] = True
            credit(r, int(dparent[r]), int(dside[r]))
        n_keep = int(keep.sum())
        if n_keep == k:
            return 0
        old_rows = np.flatnonzero(keep)
        remap = np.full(k, -1, np.int64)
        remap[old_rows] = np.arange(n_keep)
        remaps[di] = remap
        new_parent = dparent[old_rows]
        pos = new_parent >= 0
        new_parent[pos] = remap[new_parent[pos]]
        new_side = dside[old_rows]
        for f in SeqColumnsU._fields:  # the doc's columns, the tail back to the fills
            row = host[f][di]
            vals = row[:k][old_rows].copy()
            row[:] = self._COL_FILLS[f]
            row[:n_keep] = vals
        # lists: drop stranded values and renumber the survivors' ordinals
        # (an empty store with content rows is the movable slots' external
        # numbering: not ours to rewrite)
        if not self.as_text and self.value_store[di]:
            cvals = host["content"][di, :n_keep].astype(np.int64)
            uniq = np.unique(cvals[cvals >= 0])
            vmap = np.full(len(self.value_store[di]), -1, np.int64)
            vmap[uniq] = np.arange(len(uniq))
            host["content"][di, :n_keep] = np.where(cvals >= 0, vmap[np.clip(cvals, 0, None)], cvals)
            self.value_store[di] = [self.value_store[di][int(o)] for o in uniq]
        host["parent"][di, :n_keep] = new_parent
        host["side"][di, :n_keep] = new_side  # promoted rows inherit
        te_new = te[old_rows].copy()
        self.tomb_epoch[di, :] = -1
        self.tomb_epoch[di, :n_keep] = te_new
        re_new = self.row_epoch[di, :k][old_rows]
        self.row_epoch[di, :] = -1
        self.row_epoch[di, :n_keep] = re_new
        # the order engine and the standing keys, rebuilt by replay
        self.order[di] = self._fresh_order()
        keys = self.order[di].append_arrays(new_parent.astype(np.int32), host["side"][di, :n_keep], peer[old_rows],
                                            ctr[old_rows], 0)
        if keys is None:
            keys = self.order[di].all_keys()
        kh, kl = split_keys(np.asarray(keys, np.int64))
        key_hi[di] = 0xFFFFFFFF
        key_lo[di] = 0xFFFFFFFF
        key_hi[di, :n_keep] = kh
        key_lo[di, :n_keep] = kl
        m = make_idmap()  # the id map over the survivors
        m.insert_arrays(peer[old_rows], ctr[old_rows], np.arange(n_keep, dtype=np.int32))
        self.id2row[di] = m
        if self.anchor_meta[di]:  # anchors: the survivors' rows renumbered
            new_meta = {}
            for pc, a in self.anchor_meta[di].items():
                nr = remap[a["row"]] if a["row"] < k else -1
                if nr >= 0:
                    new_meta[pc] = dict(a, row=int(nr))
            self.anchor_meta[di] = new_meta
            self.anchor_by_row[di] = {a["row"]: pc for pc, a in new_meta.items()}
        self.counts[di] = n_keep
        return k - n_keep

    def _fresh_order(self):
        """A new order engine: the native one, or the Python ShadowOrder
        when LORO_PY_ORDER=1 (the JAX package's switch; counted in
        FLEET_FALLBACKS["order"]).  A native library that cannot be
        built raises RuntimeError."""
        if os.environ.get("LORO_PY_ORDER", "0") not in ("1", "true", "yes"):
            from ..native import native_order

            return native_order()
        _obs_fallback("order")
        return ShadowOrder()

    def append_changes(self, per_doc_changes: Sequence[Optional[Sequence[Change]]], cid) -> None:
        """Incremental ingest: each doc's new causally-ordered changes
        (None = no update).  Inserts (chars and style anchors: anchors
        are real Fugue nodes other inserts may parent on) become new
        rows; deletes tombstone rows from any epoch.  All validation and
        id-map staging happens before any state mutates, so a capacity
        error leaves the batch untouched.  One device scatter per call."""
        self.clock.reset()
        per_doc_changes = list(per_doc_changes) + [None] * (self.n_docs - len(per_doc_changes))
        rows_per_doc: List[list] = []
        overlays: List[Dict[Tuple[int, int], int]] = []
        anchor_stages: List[Dict[Tuple[int, int], dict]] = []
        value_stages: List[list] = []
        del_pairs: List[Tuple[int, object]] = []
        with self.clock.host("explode"):
            for di, changes in enumerate(per_doc_changes):
                rows: list = []
                overlay: Dict[Tuple[int, int], int] = {}
                stage: Dict[Tuple[int, int], dict] = {}
                vstage: list = []
                rows_per_doc.append(rows)
                overlays.append(overlay)
                anchor_stages.append(stage)
                value_stages.append(vstage)
                if changes:
                    self._python_rows(di, changes, cid, rows, overlay, del_pairs, stage, vstage)
        self._commit_rows(rows_per_doc, overlays, del_pairs, anchor_stages, value_stages)

    def _python_rows(self, di, changes, cid, rows, overlay, del_pairs, anchor_stage, value_stage) -> None:
        """Python op walk producing (parent, side, counter, content, peer)
        rows, delete pairs and staged anchor metadata for one doc (also
        the per-payload fallback of the native delta path)."""
        base = int(self.counts[di])
        idmap = self.id2row[di]
        n_vals = len(self.value_store[di])

        def resolve(key):
            return _resolve_row(overlay, idmap, key, di, "op parent")

        for ch in changes:
            for op in ch.ops:
                if op.container != cid:
                    continue
                c = op.content
                if isinstance(c, SeqInsert):
                    body = [c.content] if isinstance(c.content, StyleAnchor) else c.content
                    for j in range(len(body)):
                        if j == 0:
                            if isinstance(c.parent, _RunCont):
                                prow = resolve((ch.peer, op.counter - 1))
                            elif c.parent is None:
                                prow = -1
                            else:
                                prow = resolve((c.parent.peer, c.parent.counter))
                            side = int(c.side)
                        else:
                            prow = base + len(rows) - 1
                            side = 1
                        row = base + len(rows)
                        overlay[(ch.peer, op.counter + j)] = row
                        if isinstance(body[j], StyleAnchor):
                            content = -1
                            a = body[j]
                            anchor_stage[(ch.peer, op.counter + j)] = {
                                "row": row,
                                "key": a.key,
                                "value": a.value,
                                "lamport": ch.lamport + (op.counter + j - ch.ctr_start),
                                "peer": ch.peer,
                                "start": a.is_start,
                                "deleted": False,
                            }
                        elif self.as_text:
                            content = ord(body[j])
                        else:
                            content = n_vals + len(value_stage)
                            value_stage.append(body[j])
                        rows.append((prow, side, op.counter + j, content, ch.peer))
                elif isinstance(c, SeqDelete):
                    # deletes tolerate unknown targets (as the native path
                    # does): a missing target means its insert is missing
                    # too, which the parent resolution flags
                    for sp in c.spans:
                        for ctr in range(sp.start, sp.end):
                            row_d = overlay.get((sp.peer, ctr))
                            if row_d is None:
                                row_d = idmap.get((sp.peer, ctr))
                            if row_d is not None:
                                del_pairs.append((di, row_d))

    def _commit_rows(self, rows_per_doc, overlays, del_pairs, anchor_stages=None, value_stages=None) -> None:
        """Shared tail of both appends: validate capacity, commit staged
        id maps and anchor metadata, build the block of new rows, append
        them to the order engines, scatter the block and tombstone
        deletes.  Per-doc entries are tuple lists (Python walks) or
        column dicts (the native path, ids staged in the id map:
        overlays[di] is None and commit/abort goes through the map's
        staging)."""

        def n_of(r) -> int:
            return len(r["parent"]) if isinstance(r, dict) else len(r)

        n_new = [n_of(r) for r in rows_per_doc]
        max_new = pad_bucket(max(n_new, default=0), floor=16) if any(n_new) else 0
        # validate BEFORE any device write: the scatter window is max_new
        # wide, so every updated doc needs base + max_new <= capacity (on
        # a card a window past it would be a device assert)
        required = max((int(self.counts[di]) + max_new for di, k in enumerate(n_new) if k), default=0)
        if required > self.cap:
            if self.auto_grow:
                with self.clock.host("grow"):
                    self.grow(_grow_target(required, self.cap))
            else:
                for dj, ov in enumerate(overlays):
                    if ov is None:
                        self.id2row[dj].abort()
                raise RuntimeError(
                    f"DeviceDocBatch capacity exceeded: a doc needs {required} rows > {self.cap} "
                    "(pass auto_grow=True or call grow())"
                )
        self.epoch += 1  # post-validation: dates this append's rows
        with self.clock.host("commit"):
            for di, overlay in enumerate(overlays):
                if overlay is None:
                    self.id2row[di].commit()
                elif overlay:
                    self.id2row[di].update(overlay)
            for di, stage in enumerate(anchor_stages or ()):
                if stage:
                    self.anchor_meta[di].update(stage)
                    self.anchor_by_row[di].update({a["row"]: pc for pc, a in stage.items()})
            for di, vs in enumerate(value_stages or ()):
                if vs:
                    self.value_store[di].extend(vs)
        if max_new:
            active = [di for di, k in enumerate(n_new) if k]
            blk_shape = (self.n_docs, max_new)
            with self.clock.host("block"):
                blk = {f: np.full(blk_shape, fill, self._BLK_DTYPES[f]) for f, fill in self._COL_FILLS.items()}
                key_blk_hi = np.full(blk_shape, 0xFFFFFFFF, np.uint32)
                key_blk_lo = np.full(blk_shape, 0xFFFFFFFF, np.uint32)
                offsets = np.zeros(self.n_docs, np.int64)
                doc_rows = {}
                for di in active:
                    rows = rows_per_doc[di]
                    base = int(self.counts[di])
                    if isinstance(rows, dict):
                        parent, side_a = rows["parent"], rows["side"]
                        ctr_a, content_a, pu = rows["counter"], rows["content"], rows["peer"]
                    else:
                        arr = np.asarray([r[:4] for r in rows], np.int64)
                        pu = np.asarray([r[4] for r in rows], np.uint64)
                        parent, side_a, ctr_a, content_a = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
                    k = len(parent)
                    blk["parent"][di, :k] = parent
                    blk["side"][di, :k] = side_a
                    blk["peer_hi"][di, :k] = (pu >> np.uint64(32)).astype(np.uint32)
                    blk["peer_lo"][di, :k] = (pu & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                    blk["counter"][di, :k] = ctr_a
                    blk["deleted"][di, :k] = False
                    blk["content"][di, :k] = content_a
                    blk["valid"][di, :k] = True
                    self.row_epoch[di, base : base + k] = self.epoch
                    offsets[di] = base
                    doc_rows[di] = (parent, side_a, pu, ctr_a, base)

            def _order_doc(di: int) -> bool:
                """One doc's order append and its keys in the block (doc-
                disjoint state; the native engine's ctypes call releases
                the interpreter lock, so docs run on threads).  True when
                the doc's keys were renumbered (its whole key row is
                uploaded)."""
                parent, side_a, pu, ctr_a, base = doc_rows[di]
                keys = self.order[di].append_arrays(parent, side_a, pu, ctr_a, base)
                if keys is None:
                    return True
                kh, kl = split_keys(np.asarray(keys, np.int64))
                key_blk_hi[di, : len(kh)] = kh
                key_blk_lo[di, : len(kl)] = kl
                return False

            # threads pay only for the native engine; the Python
            # ShadowOrder would serialize through the interpreter lock
            native_engine = not isinstance(self.order[0], ShadowOrder)
            n_threads = min(
                int(os.environ.get("LORO_ORDER_THREADS") or (os.cpu_count() or 1)) if native_engine else 1,
                max(1, len(active)),
            )
            with self.clock.host("order"):
                if n_threads > 1:
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(max_workers=n_threads) as pool:
                        renum = list(pool.map(_order_doc, active))
                else:
                    renum = [_order_doc(di) for di in active]
            renumbered = [di for di, r in zip(active, renum) if r]
            for di in active:
                self.counts[di] += n_new[di]
            if self._defer is not None:
                # an open group: stash the block for its merged scatter
                self._defer.rounds.append((blk, key_blk_hi, key_blk_lo, list(n_new)))
                self._defer.renumbered.update(renumbered)
            else:
                self._device_commit_block(blk, key_blk_hi, key_blk_lo, offsets, renumbered)
        self.mark_deleted(del_pairs)

    def append_payloads(self, per_doc_payloads: Sequence[Optional[bytes]], cid) -> None:
        """Incremental native ingest: envelope-stripped binary payloads ->
        the native delta explode (parents and deletes in earlier epochs
        resolved through the per-doc id maps) -> one block scatter.  A
        payload the native path rejects (KeyError, ValueError) goes
        through the Python decode instead, counted in
        FLEET_FALLBACKS["payload_decode"].  A value batch (as_text=False)
        takes the Python decode for every payload, as in JAX."""
        if not self.as_text:
            self.append_changes([decode_changes(p) if p else None for p in per_doc_payloads], cid)
            return
        self.clock.reset()
        per_doc_payloads = list(per_doc_payloads) + [None] * (self.n_docs - len(per_doc_payloads))
        try:
            self._append_payloads_staged(per_doc_payloads, cid)
        except BaseException:
            # any escaping error rolls back the native-staged ids: the
            # maps are long-lived, and a later commit would publish
            # mappings for rows that were never scattered
            for di in range(self.n_docs):
                self.id2row[di].abort()
            raise

    def _append_payloads_staged(self, per_doc_payloads, cid) -> None:
        from ..native import decode_value_at, explode_seq_anchor_meta, explode_seq_delta_payload

        clock = self.clock
        rows_per_doc: List[object] = []
        overlays: List[Optional[Dict[Tuple[int, int], int]]] = []
        anchor_stages: List[Dict[Tuple[int, int], dict]] = []
        value_stages: List[list] = []
        del_pairs: List[Tuple[int, object]] = []
        for di, payload in enumerate(per_doc_payloads):
            rows: list = []
            overlay: Dict[Tuple[int, int], int] = {}
            stage: Dict[Tuple[int, int], dict] = {}
            vstage: list = []
            rows_per_doc.append(rows)
            overlays.append(overlay)
            anchor_stages.append(stage)
            value_stages.append(vstage)
            if not payload:
                continue
            n_dels_start = len(del_pairs)
            try:
                with clock.host("explode"):
                    peers_wire, keys_wire, cids, _r = read_tables(payload)
                    if cid not in cids:
                        continue  # no ops for this container
                    target = cids.index(cid)
                    out = explode_seq_delta_payload(payload, target)
                    # style anchors: their metadata in the same row numbering
                    anchor_cols = explode_seq_anchor_meta(payload, target) if (out["content"] == -1).any() else None
                with clock.host("stage"):
                    base = int(self.counts[di])
                    idmap = self.id2row[di]
                    # the new ids ride the map's staging (committed in
                    # _commit_rows); parents in earlier payloads and delete
                    # spans resolve in two batch lookups
                    peers_np = np.asarray(peers_wire, np.uint64)
                    peer_u64 = peers_np[out["peer_idx"]]
                    idmap.stage_base(peer_u64, out["counter"].astype(np.int64), base)
                    prow_arr = np.where(out["parent"] >= 0, base + out["parent"], out["parent"]).astype(np.int32)
                    ext_rows = np.flatnonzero(out["parent"] == -2)
                    if len(ext_rows):
                        res = idmap.lookup(peers_np[out["ext_peer_idx"][ext_rows]], out["ext_counter"][ext_rows])
                        if (res < 0).any():
                            raise KeyError("unresolved cross-epoch parent")
                        prow_arr[ext_rows] = res
                    rows_per_doc[di] = {
                        "parent": prow_arr, "side": out["side"], "counter": out["counter"],
                        "content": out["content"], "peer": peer_u64,
                    }
                    overlays[di] = None  # marker: ids staged in the id map
                    if anchor_cols is not None:
                        for ai in range(len(anchor_cols["row"])):
                            rrow = int(anchor_cols["row"][ai])
                            a_peer = int(peer_u64[rrow])
                            stage[(a_peer, int(out["counter"][rrow]))] = {
                                "row": base + rrow,
                                "key": keys_wire[int(anchor_cols["key_idx"][ai])],
                                "value": decode_value_at(payload, int(anchor_cols["voffset"][ai]), cids),
                                "lamport": int(anchor_cols["lamport"][ai]),
                                "peer": a_peer,
                                "start": bool(anchor_cols["flags"][ai] & 1),
                                "deleted": False,
                            }
                    lens = (out["del_end"] - out["del_start"]).astype(np.int64)
                    tot = int(lens.sum())
                    if tot:
                        dp = np.repeat(peers_np[out["del_peer_idx"]], lens)
                        offs = np.repeat(np.cumsum(lens) - lens, lens)
                        dctr = np.arange(tot, dtype=np.int64) - offs + np.repeat(out["del_start"], lens)
                        drows = idmap.lookup(dp, dctr)
                        drows = drows[drows >= 0]  # deletes tolerate unknown targets
                        if len(drows):
                            del_pairs.append((di, drows))
            except (KeyError, ValueError):
                # unresolvable refs or malformed input for the native
                # path: the Python decode for this payload only
                _obs_fallback("payload_decode")
                self.id2row[di].abort()
                rows.clear()
                rows_per_doc[di] = rows
                overlay.clear()
                overlays[di] = overlay
                stage.clear()
                vstage.clear()
                del del_pairs[n_dels_start:]
                with clock.host("explode"):
                    self._python_rows(di, decode_changes(payload), cid, rows, overlay, del_pairs, stage, vstage)
        self._commit_rows(rows_per_doc, overlays, del_pairs, anchor_stages, value_stages)

    def mark_deleted(self, pairs) -> None:
        """Tombstone (doc, row) entries; an entry's row may be an int or an
        ndarray of rows.  Advances the epoch clock and dates the new
        tombstones with it, direct public calls included.  Runs after all
        ingest validation, so a failed append leaves the clock as it
        was."""
        if not pairs:
            return
        self.epoch += 1
        d_parts: List[np.ndarray] = []
        r_parts: List[np.ndarray] = []
        for di, row in pairs:  # deactivate style pairs whose anchor died
            abr = self.anchor_by_row[di]
            rows = np.atleast_1d(np.asarray(row, np.int64))
            if abr:
                for rr in rows.tolist():
                    pc = abr.get(rr)
                    if pc is not None:
                        self.anchor_meta[di][pc]["deleted"] = True
            d_parts.append(np.full(len(rows), di, np.int64))
            r_parts.append(rows)
        d_all = np.concatenate(d_parts)
        r_all = np.concatenate(r_parts)
        if not len(d_all):
            return
        self.tomb_epoch[d_all, r_all] = self.epoch
        if self._defer is not None:
            # an open group: the tombstones launch once at its commit,
            # after the merged scatter (which writes only new rows, so it
            # cannot revive a row an earlier round tombstoned)
            self._defer.del_d.append(d_all)
            self._defer.del_r.append(r_all)
            return
        self._device_mark_deleted(d_all, r_all)

    def resolve_row(self, doc: int, peer: int, counter: int) -> Optional[int]:
        return self.id2row[doc].get((peer, counter))

    def export_select(self, index, requests, sup=None) -> List[np.ndarray]:
        """The read plane's batched selection for the sync pull path: one
        launch under `sup` (default: the process supervisor)."""
        return _batch_export_select(self, "seq", index, requests, sup)

    def _materialize(self, use_solver: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """(codes, counts) of the whole batch on the host, from one launch.

        Default: sort by the standing order keys (materialize_by_key); the
        order work already happened on ingest.  use_solver=True runs the
        chain-contracted rank solve (chain_merge_docs_u) instead, from the
        batch's chain budget, doubled until every doc's chains fit (the
        bulk path, and the differential check).  The fetch brings back
        the counts, then codes[:, :max(counts)]."""
        dev = self.device
        if not use_solver:
            with self.clock.device_stage("sort"):
                codes, counts = materialize_by_key(self.cols, self.key_hi, self.key_lo, device=dev)
        else:
            with self.clock.device_stage("solve"):
                while True:
                    codes, counts, n_chains = chain_merge_docs_u(self.cols, self._c_pad, device=dev)
                    max_chains = int(n_chains.max()) if self.n_docs else 0
                    if max_chains <= self._c_pad:
                        break
                    while self._c_pad < max_chains:
                        self._c_pad *= 2
        with self.clock.host("fetch"):
            counts_h = counts.cpu().numpy()
            codes_h = codes[:, : int(counts_h.max(initial=0))].cpu().numpy()
        return codes_h, counts_h

    def texts(self, use_solver: bool = False) -> List[str]:
        """Every doc's text, from one launch."""
        self.clock.reset()
        codes, counts = self._materialize(use_solver)
        with self.clock.host("decode"):
            return texts_of(codes, counts, self.n_docs)

    def values(self, use_solver: bool = False) -> List[list]:
        """Every doc's value list (as_text=False batches)."""
        if self.as_text:
            raise LoroError("values() is for as_text=False batches; use texts()")
        self.clock.reset()
        codes, counts = self._materialize(use_solver)
        out = []
        with self.clock.host("decode"):
            for i in range(self.n_docs):
                store = self.value_store[i]
                row = []
                for j in codes[i, : counts[i]].tolist():
                    if not 0 <= j < len(store):
                        raise DecodeError(
                            "resident batch: content ordinal outside the value store (corrupt restored state?)"
                        )
                    row.append(store[j])
                out.append(row)
        return out

    def richtexts(self) -> List[List[dict]]:
        """Every doc as Quill-style segments [{insert, attributes?}] with
        styles resolved on the device, in one launch: the standing-key
        sort gives char-positions for every row (anchors are zero-width
        rows), then winners resolve on the segment forest
        (richtext_by_key_batch).  Pairs are built from the anchor
        metadata: a start (p, c) with its end (p, c + 1); a dead start or
        an unpaired anchor makes no pair, a dead end runs to EOF.  Keys
        are numbered batch-wide, values and peer ranks a doc.  The
        resident sibling of Fleet.merge_richtext_changes."""
        if not self.as_text:
            raise LoroError("richtexts() is for as_text=True batches")
        self.clock.reset()
        keys: List[str] = []
        key_idx: Dict[str, int] = {}
        doc_pairs: List[list] = []
        doc_values: List[list] = []
        with self.clock.host("pairs"):
            for di in range(self.n_docs):
                meta = self.anchor_meta[di]
                values: list = []
                pairs = []
                prank = {pr: i for i, pr in enumerate(sorted({a["peer"] for a in meta.values()}))}
                for (peer, ctr), a in meta.items():
                    if not a["start"]:
                        continue
                    end = meta.get((peer, ctr + 1))
                    if end is None or end["start"] or a["deleted"]:
                        continue  # unpaired (mid-transfer), or a dead start: inactive
                    ki = key_idx.setdefault(a["key"], len(keys))
                    if ki == len(keys):
                        keys.append(a["key"])
                    vi = -1
                    if a["value"] is not None:
                        vi = len(values)
                        values.append(a["value"])
                    pairs.append((a["row"], -1 if end["deleted"] else end["row"], ki, vi, a["lamport"], prank[a["peer"]]))
                doc_pairs.append(pairs)
                doc_values.append(values)
            n_keys = pad_bucket(max(1, len(keys)), floor=4)
            p = pad_bucket(max(1, max((len(x) for x in doc_pairs), default=0)), floor=16)
            arr = np.zeros((6, self.n_docs, p), np.int32)
            arr[3] = -1
            valid = np.zeros((self.n_docs, p), bool)
            for di, pairs in enumerate(doc_pairs):
                if pairs:
                    arr[:, di, : len(pairs)] = np.asarray(pairs, np.int64).T
                    valid[di, : len(pairs)] = True
            pairs_np = RichtextPairs(*arr, valid)
        with self.clock.device_stage("sort"):
            out = richtext_by_key_batch(self.cols, self.key_hi, self.key_lo, pairs_np, n_keys, device=self.device)
        with self.clock.host("fetch"):
            codes, counts, bounds, win = (t.cpu().numpy() for t in out)
        with self.clock.host("decode"):
            return [segments_from_device(codes[i], counts[i], bounds[i], win[i], keys, doc_values[i])
                    for i in range(self.n_docs)]

    # -- checkpoint and resume ------------------------------------------
    STATE_VERSION = 2  # v2: + ingest epoch in meta, tomb-epoch columns
    # serialized row columns (valid is derived from counts): one schema
    # shared by export and import so they cannot drift
    _STATE_SCHEMA = (
        ("parent", np.int32),
        ("side", np.int32),
        ("peer_hi", np.uint32),
        ("peer_lo", np.uint32),
        ("counter", np.int32),
        ("deleted", np.uint8),
        ("content", np.int32),
    )

    def export_state(self) -> bytes:
        """The batch as an LTKV store (storage.MemKvStore's SSTable
        bytes): per-doc committed row columns, row and tombstone epochs,
        value stores and anchor metadata; byte for byte what the JAX
        package's DeviceDocBatch exports after the same appends.  Id maps
        and order engines are not serialized: both rebuild from the row
        table on import (any valid key assignment orders identically)."""
        kmax = int(self.counts.max(initial=0))
        cols = {f: getattr(self.cols, f)[:, :kmax].cpu().numpy() for f, _ in self._STATE_SCHEMA}
        kv = MemKvStore()
        d = _Dicts()
        meta = Writer()
        meta.u8(self.STATE_VERSION)
        meta.varint(self.n_docs)
        meta.varint(self.n_docs)  # the exporter's doc width (JAX: mesh-padded)
        meta.varint(self.cap)
        meta.u8(1 if self.as_text else 0)
        meta.varint(self._c_pad)
        for di in range(self.n_docs):
            meta.varint(int(self.counts[di]))
        meta.varint(self.epoch)
        meta.u8(1 if self.auto_grow else 0)
        kv.set(b"meta", bytes(meta.buf))
        for di in range(self.n_docs):
            k = int(self.counts[di])
            w = Writer()
            for f, dt in self._STATE_SCHEMA:
                w.bytes_(cols[f][di, :k].astype(dt).tobytes())
            kv.set(b"doc/%08d/rows" % di, bytes(w.buf))
            if k:
                kv.set(b"doc/%08d/tombepoch" % di, self.tomb_epoch[di, :k].astype(np.int64).tobytes())
                kv.set(b"doc/%08d/rowepoch" % di, self.row_epoch[di, :k].astype(np.int64).tobytes())
            w = Writer()
            _state_write_values(w, d, self.value_store[di])
            kv.set(b"doc/%08d/values" % di, bytes(w.buf))
            w = Writer()
            w.varint(len(self.anchor_meta[di]))
            for (peer, ctr), a in self.anchor_meta[di].items():
                w.varint(d.peer(peer))
                w.zigzag(ctr)
                w.varint(a["row"])
                w.str_(a["key"])
                if a["value"] is None:
                    w.u8(0)
                else:
                    w.u8(1)
                    _write_value(w, d, a["value"])
                w.varint(a["lamport"])
                w.u8((1 if a["start"] else 0) | (2 if a["deleted"] else 0))
            kv.set(b"doc/%08d/anchors" % di, bytes(w.buf))
        kv.set(b"dicts", _state_dicts_blob(d))
        return kv.export_all()

    @classmethod
    def import_state(cls, data: bytes, device: DeviceLike = "cuda") -> "DeviceDocBatch":
        """Restore a resident batch from export_state bytes (the port's or
        the JAX package's): upload the row table, rebuild the id maps and
        order engines by replay, re-derive the standing keys.  Malformed
        or implausible state raises DecodeError before anything large is
        allocated."""
        kv = MemKvStore()
        kv.import_all(data)
        meta_b = kv.get(b"meta")
        if meta_b is None:
            raise DecodeError("DeviceDocBatch state: missing meta")
        try:
            r = Reader(meta_b)
            version = r.u8()
            if version > cls.STATE_VERSION:
                raise DecodeError(f"DeviceDocBatch state v{version} too new")
            n_docs = r.varint()
            d_saved = r.varint()
            cap = r.varint()
            as_text = r.u8() == 1
            c_pad = r.varint()
            if c_pad <= 0:  # the chain-budget doubling loop needs > 0
                raise DecodeError("DeviceDocBatch state: bad chain budget")
            counts = [r.varint() for _ in range(d_saved)]
            epoch = r.varint() if version >= 2 else 0
            auto_grow = (r.u8() == 1) if version >= 2 else False
        except (IndexError, ValueError, struct.error) as e:
            raise DecodeError(f"DeviceDocBatch state: malformed meta ({e})") from None
        _state_sane_sizes("DeviceDocBatch", d_saved, capacity=cap)
        if not 0 < n_docs <= d_saved:
            raise DecodeError("DeviceDocBatch state: implausible n_docs")
        batch = cls(n_docs, cap, device=device, as_text=as_text, auto_grow=auto_grow)
        batch._c_pad = c_pad
        batch.epoch = epoch
        # pad docs past the importer's width must be empty (an exporter's
        # mesh padding only ever receives None updates)
        for di in range(batch.n_docs, d_saved):
            if counts[di]:
                raise DecodeError("DeviceDocBatch state: exporter pad doc carries rows but importer is narrower")
        dicts_b = kv.get(b"dicts")
        if dicts_b is None:
            raise DecodeError("DeviceDocBatch state: missing dicts")
        peers, cids = _state_read_dicts(dicts_b)
        host = {f: np.full((batch.n_docs, cap), fill, cls._BLK_DTYPES[f]) for f, fill in cls._COL_FILLS.items()}
        key_hi = np.full((batch.n_docs, cap), 0xFFFFFFFF, np.uint32)
        key_lo = np.full((batch.n_docs, cap), 0xFFFFFFFF, np.uint32)
        for di in range(min(batch.n_docs, d_saved)):
            k = counts[di]
            if k > cap:
                raise DecodeError("DeviceDocBatch state: count exceeds capacity")
            rows_b = kv.get(b"doc/%08d/rows" % di)
            if k and rows_b is None:
                raise DecodeError(f"DeviceDocBatch state: missing rows for doc {di}")
            if rows_b is not None:
                r = Reader(rows_b)
                arrs = {}
                try:
                    for f, dt in cls._STATE_SCHEMA:
                        buf = np.frombuffer(r.bytes_(), dt)
                        if len(buf) != k:
                            raise DecodeError("DeviceDocBatch state: row column length")
                        arrs[f] = buf
                except (IndexError, ValueError) as e:
                    raise DecodeError(f"DeviceDocBatch state: malformed rows ({e})") from None
                for f, a in arrs.items():
                    host[f][di, :k] = a.astype(host[f].dtype)
                host["valid"][di, :k] = True
                batch.counts[di] = k
                for key, attr in ((b"doc/%08d/tombepoch" % di, "tomb_epoch"), (b"doc/%08d/rowepoch" % di, "row_epoch")):
                    e_b = kv.get(key)
                    if e_b is not None:
                        ecol = np.frombuffer(e_b, np.int64)
                        if len(ecol) != k:
                            raise DecodeError("DeviceDocBatch state: epoch column length")
                        getattr(batch, attr)[di, :k] = ecol
                peer_full = (arrs["peer_hi"].astype(np.uint64) << np.uint64(32)) | arrs["peer_lo"].astype(np.uint64)
                ctr = arrs["counter"].astype(np.int64)
                batch.id2row[di].insert_arrays(peer_full, ctr, np.arange(k, dtype=np.int32))
                # deterministic order-engine rebuild by replay
                if k:
                    keys = batch.order[di].append_arrays(arrs["parent"], arrs["side"], peer_full, ctr, 0)
                    if keys is None:
                        keys = batch.order[di].all_keys()
                    kh, kl = split_keys(np.asarray(keys, np.int64))
                    key_hi[di, :k] = kh
                    key_lo[di, :k] = kl
            try:
                vals_b = kv.get(b"doc/%08d/values" % di)
                if vals_b is not None:
                    batch.value_store[di] = _state_read_values(vals_b, cids)
                if k:
                    c_col = host["content"][di, :k].astype(np.int64)
                    if as_text:
                        if c_col.min() < -1 or c_col.max() >= 0x110000:
                            raise DecodeError("DeviceDocBatch state: content code")
                    elif batch.value_store[di] and (c_col.min() < -1 or c_col.max() >= len(batch.value_store[di])):
                        # an empty store with content rows is an externally
                        # indexed use; values() re-checks at read time
                        raise DecodeError("DeviceDocBatch state: value ordinal")
                anch_b = kv.get(b"doc/%08d/anchors" % di)
                if anch_b is not None:
                    r = Reader(anch_b)
                    meta_d: Dict[Tuple[int, int], dict] = {}
                    for _ in range(r.varint()):
                        pi = r.varint()
                        if pi >= len(peers):
                            raise DecodeError("DeviceDocBatch state: anchor peer index")
                        peer = peers[pi]
                        ctr_ = r.zigzag()
                        row = r.varint()
                        if row >= k:
                            raise DecodeError("DeviceDocBatch state: anchor row out of range")
                        key = r.str_()
                        val = _read_value(r, cids) if r.u8() == 1 else None
                        lam = r.varint()
                        flags = r.u8()
                        meta_d[(peer, ctr_)] = {
                            "row": row, "key": key, "value": val, "lamport": lam, "peer": peer,
                            "start": bool(flags & 1), "deleted": bool(flags & 2),
                        }
                    batch.anchor_meta[di] = meta_d
                    batch.anchor_by_row[di] = {a["row"]: pc for pc, a in meta_d.items()}
            except (IndexError, ValueError, struct.error, UnicodeDecodeError) as e:
                raise DecodeError(f"DeviceDocBatch state: malformed doc {di} ({e})") from None
        dev = batch.device
        batch.cols = SeqColumnsU(**{f: _to_device(v, dev) for f, v in host.items()})
        batch.key_hi, batch.key_lo = _to_device(key_hi, dev), _to_device(key_lo, dev)
        return batch


def _state_sane_sizes(cls_name: str, d_saved: int, **fields) -> None:
    """Reject implausible size fields BEFORE allocating host or device
    arrays from them: a few flipped meta bytes must give DecodeError,
    not a multi-GB allocation.  Bounds are generous (16M per axis, 128M
    grid entries)."""
    if not 0 < d_saved <= 1 << 20:
        raise DecodeError(f"{cls_name} state: implausible doc width {d_saved}")
    for name, v in fields.items():
        if not 0 < v <= 1 << 24:
            raise DecodeError(f"{cls_name} state: implausible {name} {v}")
        if d_saved * v > 1 << 27:
            raise DecodeError(f"{cls_name} state: implausible grid {d_saved}x{v} ({name})")


def _state_dicts_blob(d: _Dicts) -> bytes:
    """The peer and container dictionaries (the containers' peers
    registered first, so the peer table is complete)."""
    for c in d.cids:
        if not c.is_root:
            d.peer(c.peer)
    w = Writer()
    w.varint(len(d.peers))
    for p in d.peers:
        w.u64le(p)
    w.varint(len(d.cids))
    for c in d.cids:
        _write_cid(w, d.peer, c)
    return bytes(w.buf)


def _state_read_dicts(blob: bytes):
    try:
        r = Reader(blob)
        peers = [r.u64le() for _ in range(r.varint())]
        cids: List[ContainerID] = [_read_cid(r, peers) for _ in range(r.varint())]
        return peers, cids
    except (IndexError, ValueError, struct.error) as e:
        raise DecodeError(f"resident state: malformed dicts ({e})") from None


def _state_write_values(w: Writer, d: _Dicts, values) -> None:
    """A value store; lazy cells are decoded and the decoded value
    replaces the cell in `values`, so a later export decodes only the
    values added since."""
    w.varint(len(values))
    for i, v in enumerate(values):
        if isinstance(v, _LazyValue):
            v = v.decode()
            values[i] = v
        _write_value(w, d, v)


def _state_read_values(blob: bytes, cids) -> list:
    try:
        r = Reader(blob)
        return [_read_value(r, cids) for _ in range(r.varint())]
    except (IndexError, ValueError, struct.error, UnicodeDecodeError) as e:
        raise DecodeError(f"resident state: malformed values ({e})") from None


def _state_write_grid(kv: MemKvStore, key: bytes, arrays) -> None:
    """One [D, S] array set as raw little-endian buffers."""
    w = Writer()
    for a in arrays:
        w.bytes_(np.asarray(a).tobytes())
    kv.set(key, bytes(w.buf))


def _state_read_grid(blob: bytes, shapes_dtypes) -> List[np.ndarray]:
    try:
        r = Reader(blob)
        out = []
        for shape, dt in shapes_dtypes:
            buf = np.frombuffer(r.bytes_(), dt)
            if buf.size != int(np.prod(shape)):
                raise DecodeError("resident state: grid size mismatch")
            out.append(buf.reshape(shape).copy())
        return out
    except (IndexError, ValueError) as e:
        raise DecodeError(f"resident state: malformed grid ({e})") from None


# ---- resident map and counter batches ------------------------------------------


class _LazyValue:
    """An undecoded map value: the payload and the byte offset the native
    explode reported.  Decoded only if it wins the LWW (value_maps) or
    the batch is exported."""

    __slots__ = ("payload", "offset", "cids")

    def __init__(self, payload: bytes, offset: int, cids):
        self.payload = payload
        self.offset = offset
        self.cids = cids

    def decode(self):
        from ..native import decode_value_at

        return decode_value_at(self.payload, self.offset, self.cids)


def _stage_slot(slot_of: dict, staged: dict, key) -> int:
    """The slot of `key` in a doc: its committed one, else its staged
    one, else the next free one, staged in `staged` (insertion-ordered,
    committed after the append's capacity check)."""
    slot = slot_of.get(key)
    if slot is None:
        slot = staged.get(key)
    if slot is None:
        slot = staged[key] = len(slot_of) + len(staged)
    return slot


def _lww_fills(value_fill: int) -> Dict[str, int]:
    """Fill values of the LwwResident fields, one table for the batch's
    construction, grow and import (the value fill is the only per-use
    field)."""
    return dict(lamport=NEG, peer_hi=0, peer_lo=0, value=value_fill)


def _release_lww_(res: LwwResident, di: int, value_fill: int) -> None:
    """Doc row `di` of LWW winners back to the construction fills."""
    fills = _lww_fills(value_fill)
    _release_rows_([getattr(res, f) for f in fills], di, list(fills.values()))


# LwwResident tensor dtypes (peer halves: int64 holding uint32) and the
# checkpoint's grid dtypes, the JAX package's
_LWW_DTYPES = dict(lamport=torch.int32, peer_hi=torch.int64, peer_lo=torch.int64, value=torch.int32)
_LWW_GRID = dict(lamport=np.int32, peer_hi=np.uint32, peer_lo=np.uint32, value=np.int32)


def _require_slots(batch, required: int, error: type) -> None:
    """Grow a map or counter batch (auto_grow) or raise `error` (the JAX
    package's type for that batch) when a staged append needs more slots
    than its capacity; called before any state changes."""
    if required <= batch.s:
        return
    if not batch.auto_grow:
        raise error(f"{type(batch).__name__} slot capacity exceeded: a doc needs {required} slots > {batch.s}; "
                    "grow slot_capacity or pass auto_grow=True")
    batch.grow(_grow_target(required, batch.s))


# A resident batch's checkpoint meta after (version, n_docs, the
# exporter's doc width): (batch attribute, name, kind, first state
# version) a field.  "size" is a varint that _state_sane_sizes checks,
# "flag" a u8, "counts" one varint a saved doc.
_LWW_META = (("s", "slot_capacity", "size", 1), ("auto_grow", "auto_grow", "flag", 2), ("epoch", "epoch", "varint", 3))
_TREE_META = (("cap", "move_capacity", "size", 1), ("node_cap", "node_capacity", "size", 1),
              ("counts", "counts", "counts", 1), ("epoch", "epoch", "varint", 2), ("auto_grow", "auto_grow", "flag", 2))


def _read_meta(cls_name: str, meta_b: bytes, state_version: int, fields=_LWW_META) -> tuple:
    """(n_docs, exporter's doc width, *the values of `fields`) of a
    resident batch's checkpoint meta; a field newer than the state reads
    as False or 0."""
    try:
        r = Reader(meta_b)
        version = r.u8()
        if version > state_version:
            raise DecodeError(f"{cls_name} state v{version} too new")
        n_docs, d_saved = r.varint(), r.varint()
        vals = []
        for _attr, _name, kind, since in fields:
            if version < since:
                vals.append(False if kind == "flag" else 0)
            elif kind == "flag":
                vals.append(r.u8() == 1)
            elif kind == "counts":
                vals.append([r.varint() for _ in range(d_saved)])
            else:
                vals.append(r.varint())
    except (IndexError, ValueError) as e:
        raise DecodeError(f"{cls_name} state: malformed meta ({e})") from None
    _state_sane_sizes(cls_name, d_saved, **{name: v for (_a, name, kind, _s), v in zip(fields, vals) if kind == "size"})
    if not 0 < n_docs <= d_saved:
        raise DecodeError(f"{cls_name} state: implausible n_docs")
    return (n_docs, d_saved, *vals)


def _write_meta(kv: MemKvStore, batch, fields=_LWW_META) -> None:
    meta = Writer()
    meta.u8(batch.STATE_VERSION)
    meta.varint(batch.n_docs)
    meta.varint(batch.n_docs)  # the exporter's doc width (JAX: mesh-padded)
    for attr, _name, kind, _since in fields:
        v = getattr(batch, attr)
        if kind == "flag":
            meta.u8(1 if v else 0)
        elif kind == "counts":
            for c in v:
                meta.varint(int(c))
        else:
            meta.varint(v)
    kv.set(b"meta", bytes(meta.buf))


class DeviceMapBatch(_FoldGroupMixin):
    """Device-resident LWW-map winners for a doc batch: per (doc, slot)
    the winning (lamport, peer, value ordinal), [D, S] on the device.
    A slot is a (container, key) pair of one doc, numbered by first use.
    Each append folds its block of map ops into the winners in one
    device call; the values stay on the host as per-doc ordinal lists.
    Bound to one device (default "cuda"; DeviceUnavailable without a card
    unless "cpu" is asked for)."""

    _FAMILY = "map"  # coalesce groups: the LWW fold is associative

    def __init__(self, n_docs: int, slot_capacity: int, device: DeviceLike = "cuda", auto_grow: bool = False):
        """auto_grow=True repacks the winners to the next slot bucket
        instead of raising when an append needs more slots."""
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.s = slot_capacity
        self.auto_grow = auto_grow
        self.res = LwwResident(**{
            f: torch.full((n_docs, slot_capacity), fill, dtype=_LWW_DTYPES[f], device=self.device)
            for f, fill in _lww_fills(-2).items()
        })
        self.slot_of: List[Dict[Tuple[ContainerID, str], int]] = [dict() for _ in range(n_docs)]
        self.values: List[List] = [[] for _ in range(n_docs)]
        # ingest epochs (the JAX server journals rounds against them)
        self.epoch = 0
        self._defer: Optional[_DeferredFold] = None  # the open coalesce group
        self._dev_lock = named_rlock("fleet.dev")

    def grow(self, new_slot_capacity: int) -> None:
        """Repack the winners to a larger slot capacity, on the device."""
        if new_slot_capacity <= self.s:
            return
        with self._dev_lock:
            self.res = LwwResident(**_pad_axis1(self.res._asdict(), new_slot_capacity, _lww_fills(-2)))
            self.s = new_slot_capacity

    def release_doc(self, di: int) -> None:
        """Reset doc `di` to a never-used slot (the tiered-residency
        eviction; DeviceDocBatch.release_doc's contract)."""
        self.slot_of[di] = {}
        self.values[di] = []
        with self._dev_lock:
            _release_lww_(self.res, di, -2)
        obs.counter("fleet.doc_releases_total").inc(family="map")

    def append_changes(self, per_doc_changes: Sequence[Optional[Sequence[Change]]]) -> None:
        """Fold each doc's new changes (None = no update) into the
        winners.  Slots and values are staged and committed only after
        the capacity check, so a capacity error leaves the batch as it
        was."""
        per_doc_changes = list(per_doc_changes) + [None] * (self.n_docs - len(per_doc_changes))
        rows_per_doc, new_slots, new_vals = [], [], []
        for di, changes in enumerate(per_doc_changes):
            rows = []
            rows_per_doc.append(rows)
            staged_slots: Dict = {}
            staged_vals: List = []
            new_slots.append(staged_slots)
            new_vals.append(staged_vals)
            if not changes:
                continue
            slot_of = self.slot_of[di]
            n_vals0 = len(self.values[di])
            for ch in changes:
                for op in ch.ops:
                    c = op.content
                    if not isinstance(c, MapSet):
                        continue
                    slot = _stage_slot(slot_of, staged_slots, (op.container, c.key))
                    lam = ch.lamport + (op.counter - ch.ctr_start)
                    if c.deleted:
                        vi = -1
                    else:
                        vi = n_vals0 + len(staged_vals)
                        staged_vals.append(c.value)
                    rows.append((slot, lam, ch.peer, vi))
        self._commit_staged(rows_per_doc, new_slots, new_vals)

    def append_payloads(self, per_doc_payloads: Sequence[Optional[bytes]]) -> None:
        """Native ingest: each doc's envelope-stripped binary payload (None
        = no update) -> the native map explode -> one fold.  Values are not
        decoded here: each is a lazy cell (payload, byte offset) that
        value_maps() decodes only if it wins.  Staged like append_changes.
        A malformed payload raises CodecDecodeError and a codec that
        cannot be built RuntimeError, both before any state changes."""
        from ..native import explode_map_payload

        per_doc_payloads = list(per_doc_payloads) + [None] * (self.n_docs - len(per_doc_payloads))
        rows_per_doc, new_slots, new_vals = [], [], []
        for di, payload in enumerate(per_doc_payloads):
            rows = []
            rows_per_doc.append(rows)
            staged_slots: Dict = {}
            staged_vals: List = []
            new_slots.append(staged_slots)
            new_vals.append(staged_vals)
            if not payload:
                continue
            out = explode_map_payload(payload)
            slot_of = self.slot_of[di]
            n_vals0 = len(self.values[di])
            cids, keys = out["cids"], out["keys"]
            cid_idx, key_idx = out["cid_idx"].tolist(), out["key_idx"].tolist()
            lamport, peer, offset = out["lamport"].tolist(), out["peer_u64"].tolist(), out["value_offset"].tolist()
            for j in range(len(cid_idx)):
                slot = _stage_slot(slot_of, staged_slots, (cids[cid_idx[j]], keys[key_idx[j]]))
                off = offset[j]
                if off < 0:
                    vi = -1
                else:
                    vi = n_vals0 + len(staged_vals)
                    staged_vals.append(_LazyValue(payload, off, cids))
                rows.append((slot, lamport[j], peer[j], vi))
        self._commit_staged(rows_per_doc, new_slots, new_vals)

    def _commit_staged(self, rows_per_doc, new_slots, new_vals) -> None:
        """Shared tail of both appends: the capacity check (grow or
        raise), then the staged slots and values, the epoch and the fold."""
        _require_slots(self, max((len(self.slot_of[di]) + len(new_slots[di]) for di in range(self.n_docs)), default=0),
                       ValueError)
        for di in range(self.n_docs):
            self.slot_of[di].update(new_slots[di])
            self.values[di].extend(new_vals[di])
        self.epoch += 1  # post-validation: dates this append
        if not any(rows_per_doc):
            return
        if self._defer is not None:
            self._defer.extend(rows_per_doc)
            return
        self._device_fold(rows_per_doc)

    def _device_fold(self, rows_per_doc) -> None:
        """One block [D, M] of (slot, lamport, peer, value) rows, built on
        the host, uploaded and folded into the winners in place."""
        m = pad_bucket(max(len(r) for r in rows_per_doc), floor=16)
        shape = (self.n_docs, m)
        blk = dict(slot=np.zeros(shape, np.int32), lam=np.zeros(shape, np.int32), hi=np.zeros(shape, np.uint32),
                   lo=np.zeros(shape, np.uint32), valid=np.zeros(shape, bool), value=np.full(shape, -2, np.int32))
        for di, rows in enumerate(rows_per_doc):
            if not rows:
                continue
            k = len(rows)
            arr = np.asarray([(r[0], r[1], r[3]) for r in rows], np.int64)
            pu = np.asarray([r[2] for r in rows], np.uint64)
            blk["slot"][di, :k] = arr[:, 0]
            blk["lam"][di, :k] = arr[:, 1]
            blk["value"][di, :k] = arr[:, 2]
            blk["hi"][di, :k] = pu >> np.uint64(32)
            blk["lo"][di, :k] = pu & np.uint64(0xFFFFFFFF)
            blk["valid"][di, :k] = True
        with self._dev_lock:
            t = {f: _to_device(a, self.device) for f, a in blk.items()}
            lww_update_resident(self.res, t["slot"], t["lam"], t["hi"], t["lo"], t["valid"], self.s, value=t["value"])

    def value_maps(self) -> List[Dict[Tuple[ContainerID, str], object]]:
        """{(container, key): value} per doc (the container in the key, so
        one key name in two map containers cannot collide).  Lazy cells
        are decoded here, winners only, and replaced by their values."""
        win = self.res.value.cpu().numpy()
        out = []
        for di in range(self.n_docs):
            m: Dict[Tuple[ContainerID, str], object] = {}
            for (cid, key), s_ in self.slot_of[di].items():
                vi = int(win[di, s_])
                if vi >= 0:
                    v = self.values[di][vi]
                    if isinstance(v, _LazyValue):
                        v = v.decode()
                        self.values[di][vi] = v
                    m[(cid, key)] = v
            out.append(m)
        return out

    def export_select(self, index, requests, sup=None) -> List[np.ndarray]:
        """The read plane's batched selection (the fold keeps no op
        history: deltas come from the change-span index, as for every
        family)."""
        return _batch_export_select(self, "map", index, requests, sup)

    def root_value_maps(self, name: str) -> List[Dict[str, object]]:
        """Flat {key: value} per doc for the root map container `name`."""
        return [
            {key: v for (cid, key), v in full.items() if cid.is_root and cid.name == name}
            for full in self.value_maps()
        ]

    # -- checkpoint and resume ------------------------------------------
    STATE_VERSION = 3  # v3: + ingest epoch

    def export_state(self) -> bytes:
        """The batch as an LTKV store: meta, the [D, S] winner grids, each
        doc's slot dictionary and value store (lazy cells decoded); byte
        for byte what the JAX package's DeviceMapBatch exports after the
        same appends."""
        kv = MemKvStore()
        d = _Dicts()
        _write_meta(kv, self)
        _state_write_grid(kv, b"res", [getattr(self.res, f).cpu().numpy().astype(dt) for f, dt in _LWW_GRID.items()])
        for di in range(self.n_docs):
            w = Writer()
            w.varint(len(self.slot_of[di]))
            for (cid, key), s_ in self.slot_of[di].items():
                w.varint(d.cid(cid))
                w.str_(key)
                w.varint(s_)
            kv.set(b"doc/%08d/slots" % di, bytes(w.buf))
            w = Writer()
            _state_write_values(w, d, self.values[di])
            kv.set(b"doc/%08d/values" % di, bytes(w.buf))
        kv.set(b"dicts", _state_dicts_blob(d))
        return kv.export_all()

    @classmethod
    def import_state(cls, data: bytes, device: DeviceLike = "cuda") -> "DeviceMapBatch":
        """Restore a batch from export_state bytes (the port's or the JAX
        package's).  Malformed or implausible state raises DecodeError
        before anything large is allocated."""
        kv = MemKvStore()
        kv.import_all(data)
        meta_b, dicts_b = kv.get(b"meta"), kv.get(b"dicts")
        if meta_b is None or dicts_b is None:
            raise DecodeError("DeviceMapBatch state: missing meta/dicts")
        n_docs, d_saved, s, auto_grow, epoch = _read_meta("DeviceMapBatch", meta_b, cls.STATE_VERSION)
        _peers, cids = _state_read_dicts(dicts_b)
        res_b = kv.get(b"res")
        if res_b is None:
            raise DecodeError("DeviceMapBatch state: missing res")
        grids = _state_read_grid(res_b, [((d_saved, s), dt) for dt in _LWW_GRID.values()])
        batch = cls(n_docs, s, device=device, auto_grow=auto_grow)
        batch.epoch = epoch
        host = {f: g[:n_docs] for f, g in zip(_LWW_GRID, grids)}
        for di in range(n_docs):
            slots_b = kv.get(b"doc/%08d/slots" % di)
            if slots_b is not None:
                try:
                    r = Reader(slots_b)
                    so: Dict[Tuple[ContainerID, str], int] = {}
                    for _ in range(r.varint()):
                        ci = r.varint()
                        if ci >= len(cids):
                            raise DecodeError("DeviceMapBatch state: cid index")
                        key = r.str_()
                        s_ = r.varint()
                        if s_ >= s:
                            raise DecodeError("DeviceMapBatch state: slot index")
                        so[(cids[ci], key)] = s_
                    batch.slot_of[di] = so
                except (IndexError, ValueError, UnicodeDecodeError) as e:
                    raise DecodeError(f"DeviceMapBatch state: malformed slots ({e})") from None
            vals_b = kv.get(b"doc/%08d/values" % di)
            if vals_b is not None:
                batch.values[di] = _state_read_values(vals_b, cids)
            # registered slots must name value ordinals in range
            # (value_maps would raise IndexError otherwise)
            for s_ in batch.slot_of[di].values():
                if int(host["value"][di, s_]) >= len(batch.values[di]):
                    raise DecodeError("DeviceMapBatch state: value ordinal")
        for f, g in host.items():
            getattr(batch.res, f)[:] = _to_device(g, batch.device)
        return batch


def _fold_counter_rows(sums: torch.Tensor, slot: torch.Tensor, delta: torch.Tensor) -> None:
    """Add one block [D, M] of counter rows into the sums [D, S] in place:
    the block's own sums first (rows with slot >= S are the padding the
    dump slot swallows), then one add, as the JAX fold does."""
    s = sums.shape[1]
    sums.add_(counter_merge_doc(slot, delta, slot < s, s))


class DeviceCounterBatch(_FoldGroupMixin):
    """Device-resident counter sums for a doc batch (increments commute,
    so the resident state is the fold: one scatter add an append).  A
    slot is a counter container of one doc, numbered by first use.

    Precision contract: the sums are float32, as the JAX package's (its
    TPU path has no float64), so they equal the host's float64 sums
    exactly for deltas whose every partial sum is exact in float32
    (integers up to 2^24), and to float32 rounding otherwise.  On a card
    the additions of one append run in no fixed order.  Bound to one
    device (default "cuda"; DeviceUnavailable without a card unless
    "cpu" is asked for)."""

    # coalesce groups: float addition is associative under the precision
    # contract's integer deltas
    _FAMILY = "counter"

    def __init__(self, n_docs: int, slot_capacity: int, device: DeviceLike = "cuda", auto_grow: bool = False):
        """auto_grow=True repacks the sums to the next slot bucket instead
        of raising when an append needs more slots."""
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.s = slot_capacity
        self.auto_grow = auto_grow
        self.slot_of: List[Dict[ContainerID, int]] = [dict() for _ in range(n_docs)]
        self.sums = torch.zeros((n_docs, slot_capacity), dtype=torch.float32, device=self.device)
        # ingest epochs (the JAX server journals rounds against them)
        self.epoch = 0
        self._defer: Optional[_DeferredFold] = None  # the open coalesce group
        self._dev_lock = named_rlock("fleet.dev")

    def grow(self, new_slot_capacity: int) -> None:
        """Repack the sums to a larger slot capacity, on the device."""
        if new_slot_capacity <= self.s:
            return
        with self._dev_lock:
            self.sums = _pad_axis1({"sums": self.sums}, new_slot_capacity, {"sums": 0.0})["sums"]
            self.s = new_slot_capacity

    def release_doc(self, di: int) -> None:
        """Reset doc `di` to a never-used slot (the tiered-residency
        eviction; DeviceDocBatch.release_doc's contract)."""
        self.slot_of[di] = {}
        with self._dev_lock:
            _release_rows_([self.sums], di, [0.0])
        obs.counter("fleet.doc_releases_total").inc(family="counter")

    def append_changes(self, per_doc_changes: Sequence[Optional[Sequence[Change]]]) -> None:
        """Add each doc's new increments (None = no update).  New slots
        are staged and registered only after the capacity check, so a
        capacity error (RuntimeError) leaves the batch as it was."""
        per_doc_changes = list(per_doc_changes) + [None] * (self.n_docs - len(per_doc_changes))
        rows_per_doc: List[list] = []
        staged_slots: List[dict] = []
        for di, changes in enumerate(per_doc_changes):
            rows: list = []
            staged: Dict[ContainerID, int] = {}
            rows_per_doc.append(rows)
            staged_slots.append(staged)
            if not changes:
                continue
            slots = self.slot_of[di]
            for ch in changes:
                for op in ch.ops:
                    if isinstance(op.content, CounterIncr):
                        rows.append((_stage_slot(slots, staged, op.container), float(op.content.delta)))
        _require_slots(self, max((len(self.slot_of[di]) + len(staged_slots[di]) for di in range(self.n_docs)),
                                 default=0), RuntimeError)
        self.epoch += 1  # post-validation: dates this append
        if not any(rows_per_doc):
            return
        for di, staged in enumerate(staged_slots):
            self.slot_of[di].update(staged)
        if self._defer is not None:
            self._defer.extend(rows_per_doc)
            return
        self._device_fold(rows_per_doc)

    def _device_fold(self, rows_per_doc) -> None:
        """One block [D, M] of (slot, delta) rows, pads on the dump slot S,
        uploaded and added into the sums in place."""
        m = pad_bucket(max(len(r) for r in rows_per_doc), floor=16)
        slot = np.full((self.n_docs, m), self.s, np.int32)
        delta = np.zeros((self.n_docs, m), np.float32)
        for di, rows in enumerate(rows_per_doc):
            if rows:
                slot[di, : len(rows)] = [r[0] for r in rows]
                delta[di, : len(rows)] = [r[1] for r in rows]
        with self._dev_lock:
            _fold_counter_rows(self.sums, _to_device(slot, self.device), _to_device(delta, self.device))

    def export_select(self, index, requests, sup=None) -> List[np.ndarray]:
        """The read plane's batched selection (the sums keep no op
        history: deltas come from the change-span index, as for maps)."""
        return _batch_export_select(self, "counter", index, requests, sup)

    def value_maps(self) -> List[Dict[ContainerID, float]]:
        sums = self.sums.cpu().numpy()
        return [{cid: float(sums[di, s_]) for cid, s_ in self.slot_of[di].items()} for di in range(self.n_docs)]

    # -- checkpoint and resume ------------------------------------------
    STATE_VERSION = 3  # v3: + ingest epoch

    def export_state(self) -> bytes:
        """The batch as an LTKV store: meta, the [D, S] float32 sums and
        each doc's slot dictionary; byte for byte what the JAX package's
        DeviceCounterBatch exports after the same appends."""
        kv = MemKvStore()
        d = _Dicts()
        _write_meta(kv, self)
        _state_write_grid(kv, b"sums", [self.sums.cpu().numpy()])
        for di in range(self.n_docs):
            w = Writer()
            w.varint(len(self.slot_of[di]))
            for cid, s_ in self.slot_of[di].items():
                w.varint(d.cid(cid))
                w.varint(s_)
            kv.set(b"doc/%08d/slots" % di, bytes(w.buf))
        kv.set(b"dicts", _state_dicts_blob(d))
        return kv.export_all()

    @classmethod
    def import_state(cls, data: bytes, device: DeviceLike = "cuda") -> "DeviceCounterBatch":
        """Restore a batch from export_state bytes (the port's or the JAX
        package's).  Malformed or implausible state raises DecodeError
        before anything large is allocated."""
        kv = MemKvStore()
        kv.import_all(data)
        meta_b, dicts_b = kv.get(b"meta"), kv.get(b"dicts")
        if meta_b is None or dicts_b is None:
            raise DecodeError("DeviceCounterBatch state: missing meta/dicts")
        n_docs, d_saved, s, auto_grow, epoch = _read_meta("DeviceCounterBatch", meta_b, cls.STATE_VERSION)
        _peers, cids = _state_read_dicts(dicts_b)
        sums_b = kv.get(b"sums")
        if sums_b is None:
            raise DecodeError("DeviceCounterBatch state: missing sums")
        (grid,) = _state_read_grid(sums_b, [((d_saved, s), np.float32)])
        batch = cls(n_docs, s, device=device, auto_grow=auto_grow)
        batch.epoch = epoch
        for di in range(n_docs):
            slots_b = kv.get(b"doc/%08d/slots" % di)
            if slots_b is not None:
                try:
                    r = Reader(slots_b)
                    so: Dict[ContainerID, int] = {}
                    for _ in range(r.varint()):
                        ci = r.varint()
                        if ci >= len(cids):
                            raise DecodeError("DeviceCounterBatch state: cid index")
                        s_ = r.varint()
                        if s_ >= s:
                            raise DecodeError("DeviceCounterBatch state: slot index")
                        so[cids[ci]] = s_
                    batch.slot_of[di] = so
                except (IndexError, ValueError) as e:
                    raise DecodeError(f"DeviceCounterBatch state: malformed slots ({e})") from None
        batch.sums[:] = _to_device(grid[:n_docs], batch.device)
        return batch


# ---- resident tree batch -----------------------------------------------------------

# TreeLogCols tensor dtypes (peer halves: int64 holding uint32), their
# fills, and the checkpoint's log columns with their dtypes, the JAX
# package's
_TREE_DTYPES = dict(lamport=torch.int32, peer_hi=torch.int64, peer_lo=torch.int64, counter=torch.int32,
                    target=torch.int32, parent=torch.int32, valid=torch.bool)
_TREE_FILLS = dict(lamport=0, peer_hi=0, peer_lo=0, counter=0, target=0, parent=ROOT, valid=False)


class DeviceTreeBatch:
    """Device-resident movable-tree move logs for a doc batch (the tree
    member of the resident family).  Each append ships only the new moves
    (one block scatter); each read sorts every standing log by the global
    move key (lamport, peer, counter) on the device and replays it
    (ops/tree_batch.tree_replay_log_batch, the replay kernel).  Tree
    moves do not commute (a late concurrent move with a lower lamport
    replays before moves already applied), so the resident state is the
    log, not the folded parents; the reference's TreeCacheForDiff keeps
    the same per-node move sets and re-walks them
    (diff_calc/tree.rs:230-396).  Node dictionaries and each move's
    metadata (lamport, peer, counter, target ordinal, is_delete,
    position) stay on the host.  Bound to one device (default "cuda";
    DeviceUnavailable without a card unless "cpu" is asked for)."""

    def __init__(self, n_docs: int, move_capacity: int, node_capacity: int, device: DeviceLike = "cuda",
                 auto_grow: bool = False):
        """auto_grow=True grows the move log or the node ceiling to the
        next bucket instead of raising when an append needs more."""
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.cap = move_capacity
        self.node_cap = node_capacity
        self.auto_grow = auto_grow
        self.counts = np.zeros(self.n_docs, np.int64)
        # ingest epochs: every append ticks the clock, and each move row
        # keeps the epoch that appended it
        self.epoch = 0
        self.move_epoch = np.full((self.n_docs, move_capacity), -1, np.int64)
        # per-doc node dictionaries and host move metadata for sibling
        # positions: (lamport, peer, counter, target ordinal, is_delete, position)
        self.node_ids: List[Dict[TreeID, int]] = [dict() for _ in range(self.n_docs)]
        self.nodes: List[list] = [[] for _ in range(self.n_docs)]
        self.move_meta: List[list] = [[] for _ in range(self.n_docs)]
        self.cols = TreeLogCols(**{
            f: torch.full((self.n_docs, move_capacity), _TREE_FILLS[f], dtype=dt, device=self.device)
            for f, dt in _TREE_DTYPES.items()
        })
        self._defer: Optional[_DeferredSeqDevice] = None  # the open coalesce group
        self._dev_lock = named_rlock("fleet.dev")

    # -- round coalescing (DeviceDocBatch's contract) ----------------------
    def begin_coalesce(self) -> None:
        if self._defer is not None:
            raise RuntimeError("coalesce group already open")
        self._defer = _DeferredSeqDevice(self.counts.copy())

    def detach_coalesce(self) -> Optional[_DeferredSeqDevice]:
        d, self._defer = self._defer, None
        return d

    def commit_detached(self, d: Optional[_DeferredSeqDevice]) -> None:
        """One merged scatter of a detached group's move blocks (one a
        round when the merged window would pass the capacity;
        _group_scatters)."""
        if d is None or not d.rounds:
            return
        with self._dev_lock:
            for blk, off in _group_scatters(d.base0, self.cap, d.rounds, _TREE_FILLS):
                self._device_commit_moves(blk, off)
            obs.counter("pipeline.coalesced_rounds_total").inc(len(d.rounds), family="tree")

    def flush_coalesce(self) -> None:
        self.commit_detached(self.detach_coalesce())

    def _device_commit_moves(self, blk, offsets) -> None:
        """Upload a block of move rows and scatter it at each doc's
        offset, in place."""
        with self._dev_lock:
            _scatter_rows(self.cols._asdict(), {f: _to_device(a, self.device) for f, a in blk.items()},
                          _to_device(np.asarray(offsets, np.int64), self.device))

    def release_doc(self, di: int) -> None:
        """Reset doc `di` to a never-used slot (the tiered-residency
        eviction; DeviceDocBatch.release_doc's contract)."""
        self.counts[di] = 0
        self.move_epoch[di, :] = -1
        self.node_ids[di] = {}
        self.nodes[di] = []
        self.move_meta[di] = []
        if self._defer is not None:
            self._defer.base0[di] = 0
        with self._dev_lock:
            _release_rows_([getattr(self.cols, f) for f in _TREE_FILLS], di, list(_TREE_FILLS.values()))
        obs.counter("fleet.doc_releases_total").inc(family="tree")

    def append_changes(self, per_doc_changes: Sequence[Optional[Sequence[Change]]], cid: ContainerID) -> None:
        """Each doc's new causally ordered changes (None = no update): the
        TreeMove ops of `cid` become appended log rows.  Nodes and rows
        are staged and committed only after the capacity check, so a
        capacity error leaves the batch as it was."""
        per_doc_changes = list(per_doc_changes) + [None] * (self.n_docs - len(per_doc_changes))
        rows_per_doc: List[list] = []
        staged_nodes: List[list] = []
        for di, changes in enumerate(per_doc_changes):
            rows: list = []
            staged_order: list = []
            rows_per_doc.append(rows)
            staged_nodes.append(staged_order)
            if changes:
                self._explode_changes_into(di, changes, cid, rows, staged_order)
        self._commit_moves(rows_per_doc, staged_nodes)

    def append_payloads(self, per_doc_payloads: Sequence[Optional[bytes]], cid: ContainerID) -> None:
        """Each doc's envelope-stripped binary payload (None = no update)
        through the native tree explode (wire order: the replay sorts by
        the move key anyway), then one block scatter.  A payload the
        explode rejects (ValueError, CodecDecodeError among them) is
        walked in Python, counted in FLEET_FALLBACKS["payload_decode"]."""
        from ..native import explode_tree_payload

        per_doc_payloads = list(per_doc_payloads) + [None] * (self.n_docs - len(per_doc_payloads))
        rows_per_doc: List[list] = []
        staged_nodes: List[list] = []
        fallback: List[Tuple[int, bytes]] = []
        for di, payload in enumerate(per_doc_payloads):
            rows: list = []
            staged: Dict[TreeID, int] = {}
            staged_order: list = []
            rows_per_doc.append(rows)
            staged_nodes.append(staged_order)
            if not payload:
                continue
            node_idx = _tree_node_stager(self.node_ids[di], len(self.nodes[di]), staged, staged_order)
            try:
                peers_wire, _keys, cids, _r = read_tables(payload)
                if cid not in cids:
                    continue  # no ops for this container
                out = explode_tree_payload(payload, cids.index(cid))
                cols = {f: a.tolist() for f, a in out.items()}
                for i in range(len(cols["lamport"])):
                    t = node_idx(TreeID(int(peers_wire[cols["target_peer_idx"][i]]), cols["target_ctr"][i]))
                    fl = cols["flags"][i]
                    if fl & 2:  # delete
                        p = TRASH
                    elif fl & 4:  # has a parent
                        p = node_idx(TreeID(int(peers_wire[cols["parent_peer_idx"][i]]), cols["parent_ctr"][i]))
                    else:
                        p = ROOT
                    pos = None
                    if fl & 8:
                        o = cols["pos_off"][i]
                        pos = bytes(payload[o : o + cols["pos_len"][i]])
                    rows.append((cols["lamport"][i], int(peers_wire[cols["peer_idx"][i]]), cols["counter"][i], t, p,
                                 bool(fl & 2), pos))
            except ValueError:
                rows.clear()
                staged.clear()
                staged_order.clear()
                fallback.append((di, payload))
        for di, payload in fallback:  # the Python walk of each rejected payload
            FLEET_FALLBACKS["payload_decode"] += 1
            self._explode_changes_into(di, decode_changes(payload), cid, rows_per_doc[di], staged_nodes[di])
        self._commit_moves(rows_per_doc, staged_nodes)

    def _explode_changes_into(self, di: int, changes, cid: ContainerID, rows: list, staged_order: list) -> None:
        """The Python change walk, appending into pre-staged row and node
        lists (append_changes, and append_payloads' fallback)."""
        staged = {tid: len(self.nodes[di]) + i for i, tid in enumerate(staged_order)}
        node_idx = _tree_node_stager(self.node_ids[di], len(self.nodes[di]), staged, staged_order)
        for ch in changes:
            for op in ch.ops:
                if op.container != cid or not isinstance(op.content, TreeMove):
                    continue
                c = op.content
                lam = ch.lamport + (op.counter - ch.ctr_start)
                t = node_idx(c.target)
                if c.is_delete:
                    p = TRASH
                elif c.parent is None:
                    p = ROOT
                else:
                    p = node_idx(c.parent)
                rows.append((lam, ch.peer, op.counter, t, p, c.is_delete, c.position))

    def grow(self, move_capacity: Optional[int] = None, node_capacity: Optional[int] = None) -> None:
        """Repack the move log to a larger capacity, on the device, and/or
        raise the node ceiling (a launch parameter of the replay: a scalar
        bump)."""
        if move_capacity is not None and move_capacity > self.cap:
            with self._dev_lock:
                self.cols = TreeLogCols(**_pad_axis1(self.cols._asdict(), move_capacity, _TREE_FILLS))
            me = np.full((self.n_docs, move_capacity), -1, np.int64)
            me[:, : self.cap] = self.move_epoch
            self.move_epoch = me
            self.cap = move_capacity
        if node_capacity is not None and node_capacity > self.node_cap:
            self.node_cap = node_capacity

    def _commit_moves(self, rows_per_doc, staged_nodes) -> None:
        """Shared tail of both appends: the capacity checks (grow or raise
        RuntimeError) before any state changes, the epoch, then the staged
        nodes and the block scatter of the new rows."""
        max_new = pad_bucket(max(len(r) for r in rows_per_doc), floor=16) if any(rows_per_doc) else 0
        req_moves = max((int(self.counts[di]) + max_new for di, rows in enumerate(rows_per_doc) if rows), default=0)
        req_nodes = max((len(self.nodes[di]) + len(staged_nodes[di]) for di in range(self.n_docs)), default=0)
        if req_moves > self.cap:
            if not self.auto_grow:
                raise RuntimeError(f"DeviceTreeBatch move capacity exceeded: a doc needs {req_moves} rows > {self.cap}")
            self.grow(move_capacity=_grow_target(req_moves, self.cap))
        if req_nodes > self.node_cap:
            if not self.auto_grow:
                raise RuntimeError(
                    f"DeviceTreeBatch node capacity exceeded: a doc needs {req_nodes} nodes > {self.node_cap}")
            self.grow(node_capacity=_grow_target(req_nodes, self.node_cap))
        # every append ticks the clock, a round with no move rows too (the
        # JAX server journals rounds against strictly monotone epochs)
        self.epoch += 1
        if not max_new:
            return
        for di, staged_order in enumerate(staged_nodes):
            for tid in staged_order:
                self.node_ids[di][tid] = len(self.nodes[di])
                self.nodes[di].append(tid)
        shape = (self.n_docs, max_new)
        blk = {
            "lamport": np.zeros(shape, np.int32),
            "peer_hi": np.zeros(shape, np.uint32),
            "peer_lo": np.zeros(shape, np.uint32),
            "counter": np.zeros(shape, np.int32),
            "target": np.zeros(shape, np.int32),
            "parent": np.full(shape, ROOT, np.int32),
            "valid": np.zeros(shape, bool),
        }
        offsets = np.zeros(self.n_docs, np.int64)
        for di, rows in enumerate(rows_per_doc):
            if not rows:
                continue
            k = len(rows)
            arr = np.asarray([(r[0], r[2], r[3], r[4]) for r in rows], np.int64)
            pu = np.asarray([r[1] for r in rows], np.uint64)
            blk["lamport"][di, :k] = arr[:, 0]
            blk["peer_hi"][di, :k] = pu >> np.uint64(32)
            blk["peer_lo"][di, :k] = pu & np.uint64(0xFFFFFFFF)
            blk["counter"][di, :k] = arr[:, 1]
            blk["target"][di, :k] = arr[:, 2]
            blk["parent"][di, :k] = arr[:, 3]
            blk["valid"][di, :k] = True
            base = int(self.counts[di])
            offsets[di] = base
            self.move_epoch[di, base : base + k] = self.epoch
            self.counts[di] += k
            self.move_meta[di].extend((r[0], r[1], r[2], r[3], r[5], r[6]) for r in rows)
        if self._defer is not None:
            # an open group: stash the block for its merged scatter
            self._defer.rounds.append((blk, [len(r) for r in rows_per_doc]))
        else:
            self._device_commit_moves(blk, offsets)

    def export_select(self, index, requests, sup=None) -> List[np.ndarray]:
        """The read plane's batched selection for the sync pull path: one
        launch under `sup` (default: the process supervisor)."""
        return _batch_export_select(self, "tree", index, requests, sup)

    def _replay(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return tree_replay_log_batch(self.cols, self.node_cap)

    def compact(self, stable_epochs: Sequence[Optional[int]]) -> int:
        """Collapse each move log over its causally stable prefix: per
        node only the winning stable move (the last effected one in key
        order) stays; every superseded or cycle-rejected stable row drops.
        Rows newer than the doc's stable epoch all stay, and undated rows
        (from a checkpoint older than the epochs) too.

        Sound because every future move's lamport exceeds every stable
        move's (its author's frontier covers the stable set), so future
        rows sort after the stable prefix, and replaying only the winners
        gives the stable tree: at each winner the reduced state is, node
        by node, a sub-chain of the full one, and the cycle walk over
        sub-chains can only stop earlier, so no move accepted by the full
        replay is rejected by the reduced one.  move_meta stays row
        aligned (children_maps' tiebreak uses the relative key order,
        which filtering keeps); node dictionaries are not reclaimed.
        Returns the rows dropped.  One replay launch, then a fetch of the
        whole log, a host pass and one upload of it."""
        if len(stable_epochs) > self.n_docs:
            raise ValueError(f"compact: {len(stable_epochs)} stable_epochs for a {self.n_docs}-doc batch")
        stable_epochs = list(stable_epochs) + [None] * (self.n_docs - len(stable_epochs))
        host = None
        eff = None
        reclaimed = 0
        with self._dev_lock:
            for di, stable_e in enumerate(stable_epochs):
                if stable_e is None or not int(self.counts[di]):
                    continue
                if host is None:
                    _parents, eff_dev = self._replay()
                    eff = eff_dev.cpu().numpy()
                    host = {f: getattr(self.cols, f).to("cpu", copy=True).numpy() for f in _TREE_FILLS}
                k = int(self.counts[di])
                stable = (self.move_epoch[di, :k] <= int(stable_e)) & (self.move_epoch[di, :k] >= 0)
                if not stable.any():
                    continue
                tgt = host["target"][di, :k]
                # the peer halves hold uint32 values in int64: the same key order
                order = np.lexsort((host["counter"][di, :k], host["peer_lo"][di, :k], host["peer_hi"][di, :k],
                                    host["lamport"][di, :k]))
                winner: Dict[int, int] = {}
                for r in order:
                    if stable[r] and eff[di, r]:
                        winner[int(tgt[r])] = int(r)
                keep = ~stable  # unstable rows all stay
                keep[list(winner.values())] = True
                n_keep = int(keep.sum())
                if n_keep == k:
                    continue
                reclaimed += k - n_keep
                old_rows = np.flatnonzero(keep)  # append order kept
                for f in _TREE_FILLS:
                    row = host[f][di]
                    vals = row[:k][old_rows]
                    row[:] = _TREE_FILLS[f]
                    row[:n_keep] = vals
                me = self.move_epoch[di, :k][old_rows]
                self.move_epoch[di, :] = -1
                self.move_epoch[di, :n_keep] = me
                self.move_meta[di] = [self.move_meta[di][int(r)] for r in old_rows]
                self.counts[di] = n_keep
            if host is not None and reclaimed:
                for f in TreeLogCols._fields:
                    getattr(self.cols, f).copy_(torch.from_numpy(host[f]))  # in place, as DeviceDocBatch.compact
        return reclaimed

    def parent_maps(self) -> List[dict]:
        """{TreeID: parent TreeID | None} of the live nodes of every doc
        (one replay launch; Fleet.merge_tree_changes' contract)."""
        parents, _eff = self._replay()
        parents, deleted = parents.cpu().numpy(), is_deleted_batch(parents).cpu().numpy()
        return [_parent_map(self.nodes[di], parents[di], deleted[di]) for di in range(self.n_docs)]

    def children_maps(self) -> List[dict]:
        """{parent | None: [children by (fractional index, move key)]} of
        every doc: the materialized tree shape (Fleet.merge_tree_children'
        contract)."""
        parents, eff = self._replay()
        parents, eff, deleted = (t.cpu().numpy() for t in (parents, eff, is_deleted_batch(parents)))
        out = []
        for di in range(self.n_docs):
            nodes = self.nodes[di]
            # the winning position is the last effected non-delete move
            # of a node in key order, the sibling tiebreak that move's key
            # order (merge_tree_children's host walk)
            meta = self.move_meta[di]
            order = sorted(range(len(meta)), key=lambda i: meta[i][:3])
            pos: Dict[int, object] = {}
            last_eff: Dict[int, int] = {}
            for oi, i in enumerate(order):
                _lam, _peer, _ctr, t, is_del, p_ = meta[i]
                if eff[di, i]:
                    last_eff[t] = oi
                    if not is_del:
                        pos[t] = p_
            out.append(_children_map(nodes, parents[di], deleted[di], pos, last_eff))
        return out

    # -- checkpoint and resume ------------------------------------------
    STATE_VERSION = 2  # v2: + epoch clock, move-epoch columns
    _STATE_SCHEMA = (
        ("lamport", np.int32),
        ("peer_hi", np.uint32),
        ("peer_lo", np.uint32),
        ("counter", np.int32),
        ("target", np.int32),
        ("parent", np.int32),
    )

    def export_state(self) -> bytes:
        """The batch as an LTKV store: meta, each doc's move log, move
        epochs, node dictionary and move metadata (positions); byte for
        byte what the JAX package's DeviceTreeBatch exports after the same
        appends."""
        kv = MemKvStore()
        _write_meta(kv, self, _TREE_META)
        cols = {f: getattr(self.cols, f).cpu().numpy() for f, _ in self._STATE_SCHEMA}
        for di in range(self.n_docs):
            k = int(self.counts[di])
            w = Writer()
            for f, dt in self._STATE_SCHEMA:
                w.bytes_(cols[f][di, :k].astype(dt).tobytes())
            kv.set(b"doc/%08d/log" % di, bytes(w.buf))
            if k:
                kv.set(b"doc/%08d/moveepoch" % di, self.move_epoch[di, :k].astype(np.int64).tobytes())
            w = Writer()
            w.varint(len(self.nodes[di]))
            for tid in self.nodes[di]:
                w.u64le(tid.peer)
                w.zigzag(tid.counter)
            kv.set(b"doc/%08d/nodes" % di, bytes(w.buf))
            w = Writer()
            w.varint(len(self.move_meta[di]))
            for lam, peer, ctr, t, is_del, pos in self.move_meta[di]:
                w.varint(lam)
                w.u64le(peer)
                w.zigzag(ctr)
                w.varint(t)
                w.u8((1 if is_del else 0) | (2 if pos is not None else 0))
                if pos is not None:
                    w.bytes_(pos)
            kv.set(b"doc/%08d/meta" % di, bytes(w.buf))
        return kv.export_all()

    @classmethod
    def import_state(cls, data: bytes, device: DeviceLike = "cuda") -> "DeviceTreeBatch":
        """Restore a batch from export_state bytes (the port's or the JAX
        package's).  Malformed or implausible state raises DecodeError
        before anything large is allocated."""
        kv = MemKvStore()
        kv.import_all(data)
        meta_b = kv.get(b"meta")
        if meta_b is None:
            raise DecodeError("DeviceTreeBatch state: missing meta")
        n_docs, d_saved, cap, node_cap, counts, epoch, auto_grow = _read_meta(
            "DeviceTreeBatch", meta_b, cls.STATE_VERSION, _TREE_META)
        batch = cls(n_docs, cap, node_cap, device=device, auto_grow=auto_grow)
        batch.epoch = epoch
        for di in range(n_docs, d_saved):
            if counts[di]:
                raise DecodeError("DeviceTreeBatch state: importer mesh too narrow")
        host = {f: np.full((n_docs, cap), _TREE_FILLS[f], dt) for f, dt in
                dict(cls._STATE_SCHEMA, valid=np.bool_).items()}
        try:
            for di in range(n_docs):
                k = counts[di]
                if k > cap:
                    raise DecodeError("DeviceTreeBatch state: count exceeds capacity")
                log_b = kv.get(b"doc/%08d/log" % di)
                if k and log_b is None:
                    raise DecodeError(f"DeviceTreeBatch state: missing log for doc {di}")
                if log_b is not None:
                    r = Reader(log_b)
                    for f, dt in cls._STATE_SCHEMA:
                        buf = np.frombuffer(r.bytes_(), dt)
                        if len(buf) != k:
                            raise DecodeError("DeviceTreeBatch state: log column length")
                        host[f][di, :k] = buf
                    host["valid"][di, :k] = True
                    batch.counts[di] = k
                    me_b = kv.get(b"doc/%08d/moveepoch" % di)
                    if me_b is not None:
                        me = np.frombuffer(me_b, np.int64)
                        if len(me) != k:
                            raise DecodeError("DeviceTreeBatch state: move epoch column length")
                        batch.move_epoch[di, :k] = me
                nodes_b = kv.get(b"doc/%08d/nodes" % di)
                if nodes_b is not None:
                    r = Reader(nodes_b)
                    nodes = [TreeID(r.u64le(), r.zigzag()) for _ in range(r.varint())]
                    if len(nodes) > node_cap:
                        raise DecodeError("DeviceTreeBatch state: node overflow")
                    batch.nodes[di] = nodes
                    batch.node_ids[di] = {tid: i for i, tid in enumerate(nodes)}
                mm_b = kv.get(b"doc/%08d/meta" % di)
                if mm_b is not None:
                    r = Reader(mm_b)
                    mm = []
                    for _ in range(r.varint()):
                        lam = r.varint()
                        peer = r.u64le()
                        ctr = r.zigzag()
                        t = r.varint()
                        flags = r.u8()
                        pos = r.bytes_() if flags & 2 else None
                        mm.append((lam, peer, ctr, t, bool(flags & 1), pos))
                    batch.move_meta[di] = mm
                if k:
                    # node ordinals must stay inside the node dictionary
                    # (parent_maps would raise IndexError on nodes[p])
                    n_nodes = len(batch.nodes[di])
                    tgt = host["target"][di, :k].astype(np.int64)
                    par = host["parent"][di, :k].astype(np.int64)
                    if tgt.min() < 0 or tgt.max() >= n_nodes:
                        raise DecodeError("DeviceTreeBatch state: target ordinal")
                    if par.min() < -2 or par.max() >= n_nodes:
                        raise DecodeError("DeviceTreeBatch state: parent ordinal")
        except (IndexError, ValueError, struct.error) as e:
            raise DecodeError(f"DeviceTreeBatch state: malformed doc ({e})") from None
        batch.cols = TreeLogCols(**{f: _to_device(a, batch.device).to(_TREE_DTYPES[f]) for f, a in host.items()})
        return batch


def _tree_node_stager(ids: Dict[TreeID, int], n_committed: int, staged: Dict[TreeID, int], staged_order: list):
    """node_idx(tid) of one doc's append: its committed ordinal, else its
    staged one, else the next free ordinal, staged (first-seen order;
    committed after the append's capacity check)."""

    def node_idx(tid: TreeID) -> int:
        i = ids.get(tid)
        if i is None:
            i = staged.get(tid)
        if i is None:
            i = staged[tid] = n_committed + len(staged_order)
            staged_order.append(tid)
        return i

    return node_idx


# ---- resident MovableList batch ------------------------------------------------------

# the movable batch's checkpoint meta (the _read_meta / _write_meta form)
_MOVABLE_META = (("e_cap", "elem_capacity", "size", 1), ("auto_grow", "auto_grow", "flag", 2))


def _lww_resident(n_docs: int, n: int, value_fill: int, dev: torch.device) -> LwwResident:
    """Fresh [n_docs, n] LWW winners on `dev` (every slot untouched)."""
    return LwwResident(**{f: torch.full((n_docs, n), fill, dtype=_LWW_DTYPES[f], device=dev)
                          for f, fill in _lww_fills(value_fill).items()})


class DeviceMovableBatch:
    """Device-resident MovableList state for a doc batch (the movable-list
    member of the resident family).

    Position slots are sequence elements: they ride an inner
    DeviceDocBatch(as_text=False) (standing order keys, O(delta) ingest,
    tombstones), each slot row's content being its element's ordinal.  Per
    element the winning slot (the move of the largest (lamport, peer)) and
    the winning value (the set of the largest (lamport, peer); creation
    values count) are LWW folds kept on the device ([D, E] LwwResident:
    `moves` folds the slot row, `vals` the value ordinal).  A read is one
    sort of the elements by their winning slot's standing key
    (movable_by_key_batch): a tombstoned winner hides its element, a newer
    concurrent move revives it.  Element dictionaries and value stores stay
    on the host.  Bound to one device (default "cuda"; DeviceUnavailable
    without a card unless "cpu" is asked for)."""

    def __init__(self, n_docs: int, capacity: int, elem_capacity: int, device: DeviceLike = "cuda",
                 auto_grow: bool = False):
        """capacity: slot rows a doc; elem_capacity: elements a doc.
        auto_grow=True grows either to the next bucket instead of raising
        when an append needs more."""
        self._setup(DeviceDocBatch(n_docs, capacity, device=device, as_text=False, auto_grow=auto_grow),
                    n_docs, elem_capacity, auto_grow)

    def _setup(self, seq: DeviceDocBatch, n_docs: int, elem_capacity: int, auto_grow: bool) -> None:
        self.seq = seq
        self.device = seq.device
        self.n_docs = n_docs
        self.e_cap = elem_capacity
        self.auto_grow = auto_grow
        self.elem_ids: List[Dict[Tuple[int, int], int]] = [dict() for _ in range(n_docs)]
        self.values: List[list] = [[] for _ in range(n_docs)]
        self.moves = _lww_resident(n_docs, elem_capacity, 0, self.device)  # value: the winning slot row
        self.vals = _lww_resident(n_docs, elem_capacity, -2, self.device)  # value: the winning value ordinal
        self._defer_moves: Optional[_DeferredFold] = None  # the open coalesce group's two folds
        self._defer_vals: Optional[_DeferredFold] = None
        self._dev_lock = named_rlock("fleet.dev")
        self.clock = StageClock(self.device)

    # -- round coalescing: the slots ride the inner seq batch's group, the
    # two element folds accumulate here (both associative) ----------------
    def begin_coalesce(self) -> None:
        if self._defer_moves is not None:
            raise RuntimeError("coalesce group already open")
        self.seq.begin_coalesce()
        self._defer_moves = _DeferredFold(self.n_docs)
        self._defer_vals = _DeferredFold(self.n_docs)

    def detach_coalesce(self):
        dm, self._defer_moves = self._defer_moves, None
        dv, self._defer_vals = self._defer_vals, None
        return (self.seq.detach_coalesce(), dm, dv)

    def commit_detached(self, pending) -> None:
        if pending is None:
            return
        seq_d, dm, dv = pending
        self.seq.commit_detached(seq_d)
        if dm is not None and any(dm.rows):
            self._device_fold_elem(dm.rows, "moves")
        if dv is not None and any(dv.rows):
            self._device_fold_elem(dv.rows, "vals")
        if dm is not None and dm.n_rounds:
            obs.counter("pipeline.coalesced_rounds_total").inc(dm.n_rounds, family="movable")

    def flush_coalesce(self) -> None:
        self.commit_detached(self.detach_coalesce())

    def release_doc(self, di: int) -> None:
        """Reset doc `di` to a never-used slot (the tiered-residency
        eviction; DeviceDocBatch.release_doc's contract): the inner seq
        batch releases its slot rows, both element folds go back to their
        construction fills."""
        self.seq.release_doc(di)
        self.elem_ids[di] = {}
        self.values[di] = []
        with self._dev_lock:
            _release_lww_(self.moves, di, 0)
            _release_lww_(self.vals, di, -2)
        obs.counter("fleet.doc_releases_total").inc(family="movable")

    def compact(self, stable_epochs: Sequence[Optional[int]]) -> int:
        """Reclaim stable dead slot rows: tombstoned ones (deleted
        elements' history) and superseded ones (a move's losing slot is
        invisible for good, but droppable only once the winning slot's
        ingest epoch is acked everywhere).  Slots are sequence elements,
        so the seq batch's rules apply; every element's winning slot row
        (the moves fold holds rows) is protected, and the fold is
        rewritten through the row remap afterwards.  Element dictionaries
        and value stores keep their ordinals."""
        stable_list = list(stable_epochs) + [None] * (self.n_docs - len(stable_epochs))
        if all(e is None for e in stable_list):
            return 0  # nothing to do: no fetch
        mh = self.moves.value.to("cpu", copy=True).numpy()
        # untouched fold slots hold the value fill (0): only slots a move
        # folded into (lamport != NEG) name rows
        folded = self.moves.lamport.cpu().numpy() != NEG
        mh[~folded] = -1
        content = self.seq.cols.content.cpu().numpy()
        protect: List[Optional[np.ndarray]] = []
        extra_dead: List[Optional[np.ndarray]] = []
        for di in range(self.n_docs):
            wr = mh[di][mh[di] >= 0].astype(np.int64)
            protect.append(np.unique(wr) if len(wr) else None)
            stable_e = stable_list[di]
            k = int(self.seq.counts[di])
            if stable_e is None or not k or not len(wr):
                extra_dead.append(None)
                continue
            # a superseded slot r (element e = content[r], winner w != r) is
            # stable-dead once the winner's ingest epoch is acked
            e_arr = content[di, :k].astype(np.int64)
            valid_e = e_arr >= 0
            w_of_row = np.where(valid_e, mh[di][np.clip(e_arr, 0, None)], -1)
            w_epoch = np.where(w_of_row >= 0, self.seq.row_epoch[di][np.clip(w_of_row, 0, None)], -1)
            sup = valid_e & (w_of_row >= 0) & (w_of_row != np.arange(k)) & (w_epoch >= 0) & (w_epoch <= int(stable_e))
            rows_s = np.flatnonzero(sup)
            extra_dead.append(rows_s if len(rows_s) else None)
        reclaimed, remaps = self.seq.compact(stable_epochs, extra_protect=protect, extra_dead=extra_dead,
                                             return_remaps=True)
        if reclaimed and remaps:
            # rewritten on a fresh fetch: mh holds -1 for unfolded slots,
            # and writing it back would change their fill (0)
            out = self.moves.value.to("cpu", copy=True).numpy()
            for di, remap in remaps.items():
                row = out[di]
                mask = folded[di] & (row >= 0) & (row < len(remap))
                row[mask] = remap[row[mask]]
            with self._dev_lock:
                self.moves.value.copy_(torch.from_numpy(out))
        return reclaimed

    @property
    def epoch(self) -> int:
        """The ingest-epoch clock (the inner seq batch's)."""
        return self.seq.epoch

    def stage_ms(self) -> Dict[str, float]:
        """Per-stage ms of the last append (waits for its device stages):
        explode (read_tables and the native explode, or the Python walk),
        stage (the per-row staging of slots, sets and deletes), grow, the
        inner seq batch's commit, block, order, upload_scatter and
        tombstone (DeviceDocBatch.stage_ms), and fold (both element folds,
        built, uploaded and folded)."""
        out = self.seq.stage_ms()
        for k, v in self.clock.read().items():
            out[k] = out.get(k, 0.0) + v
        return out

    def _reset_clocks(self) -> None:
        self.clock.reset()
        self.seq.clock.reset()

    def append_changes(self, per_doc_changes: Sequence[Optional[Sequence[Change]]], cid: ContainerID) -> None:
        """Each doc's new causally ordered changes (None = no update): slots
        append into the inner seq batch (one block scatter), element
        winners fold (two in-place LWW updates).  Staged before the
        capacity checks, so a capacity error leaves the batch as it was."""
        self._reset_clocks()
        per_doc_changes = list(per_doc_changes) + [None] * (self.n_docs - len(per_doc_changes))
        staging = ([], [], [], [], [], [])
        del_pairs: List[Tuple[int, int]] = []
        with self.clock.host("explode"):
            for di, changes in enumerate(per_doc_changes):
                stage = self._stage_doc(*staging)
                if changes:
                    self._walk_movable_changes(di, changes, cid, *stage, del_pairs)
        self._commit_movable(*staging, del_pairs)

    @staticmethod
    def _stage_doc(rows_per_doc, overlays, move_rows, set_rows, staged_elems, staged_vals):
        """One doc's staging structures, appended to the per-doc lists
        (both appends commit the same shapes): (slot rows, id overlay,
        move fold rows, set fold rows, staged element ids, their order,
        staged values)."""
        rows: list = []
        overlay: Dict[Tuple[int, int], int] = {}
        mrows: list = []
        srows: list = []
        e_staged: Dict[Tuple[int, int], int] = {}
        e_order: list = []
        v_staged: list = []
        rows_per_doc.append(rows)
        overlays.append(overlay)
        move_rows.append(mrows)
        set_rows.append(srows)
        staged_elems.append(e_order)
        staged_vals.append(v_staged)
        return rows, overlay, mrows, srows, e_staged, e_order, v_staged

    def _elem_registrar(self, di: int, e_staged: dict, e_order: list):
        """eidx(eid): an element's committed ordinal, else its staged one,
        else the next free one, staged (both appends number elements this
        way, in lockstep with the commit)."""
        eids = self.elem_ids[di]

        def eidx(eid) -> int:
            i = eids.get(eid)
            if i is None:
                i = e_staged.get(eid)
            if i is None:
                i = len(eids) + len(e_order)
                e_staged[eid] = i
                e_order.append(eid)
            return i

        return eidx

    def _walk_movable_changes(self, di, changes, cid, rows, overlay, mrows, srows, e_staged, e_order, v_staged,
                              del_pairs) -> None:
        """One doc's Python change walk (append_changes, and append_payloads'
        fallback): slot rows (parent row, side, counter, element ordinal,
        peer), move and set fold rows (element, lamport, peer, slot row or
        value ordinal), staged elements and values, delete pairs.  An
        insert registers its element and its value op by op."""
        idmap = self.seq.id2row[di]
        base = int(self.seq.counts[di])
        n_vals = len(self.values[di])
        eidx = self._elem_registrar(di, e_staged, e_order)

        def vidx(v) -> int:
            v_staged.append(v)
            return n_vals + len(v_staged) - 1

        def resolve_parent(c, peer: int, counter: int) -> int:
            if isinstance(c.parent, _RunCont):
                key = (peer, counter - 1)
            elif c.parent is None:
                return -1
            else:
                key = (c.parent.peer, c.parent.counter)
            return _resolve_row(overlay, idmap, key, di, "movable op parent")

        for ch in changes:
            for op in ch.ops:
                if op.container != cid:
                    continue
                c = op.content
                lam = ch.lamport + (op.counter - ch.ctr_start)
                if isinstance(c, SeqInsert):
                    body = c.content
                    for j in range(len(body)):
                        if j == 0:
                            prow = resolve_parent(c, ch.peer, op.counter)
                            side = int(c.side)
                        else:
                            prow = base + len(rows) - 1
                            side = 1
                        row = base + len(rows)
                        eid = (ch.peer, op.counter + j)
                        ei = eidx(eid)
                        overlay[eid] = row
                        rows.append((prow, side, op.counter + j, ei, ch.peer))
                        mrows.append((ei, lam + j, ch.peer, row))
                        srows.append((ei, lam + j, ch.peer, vidx(body[j])))
                elif isinstance(c, MovableMove):
                    prow = resolve_parent(c, ch.peer, op.counter)
                    row = base + len(rows)
                    ei = eidx((c.elem.peer, c.elem.counter))
                    overlay[(ch.peer, op.counter)] = row
                    rows.append((prow, int(c.side), op.counter, ei, ch.peer))
                    mrows.append((ei, lam, ch.peer, row))
                elif isinstance(c, MovableSet):
                    ei = eidx((c.elem.peer, c.elem.counter))
                    srows.append((ei, lam, ch.peer, vidx(c.value)))
                elif isinstance(c, SeqDelete):
                    # deletes tolerate unknown targets (as the native path
                    # does): a missing target means its insert is missing
                    # too, which the parent resolution flags
                    for sp in c.spans:
                        for ctr in range(sp.start, sp.end):
                            row_d = overlay.get((sp.peer, ctr))
                            if row_d is None:
                                row_d = idmap.get((sp.peer, ctr))
                            if row_d is not None:
                                del_pairs.append((di, row_d))

    def append_payloads(self, per_doc_payloads: Sequence[Optional[bytes]], cid: ContainerID) -> None:
        """Each doc's envelope-stripped binary payload (None = no update)
        through the native movable delta explode: slot parents in earlier
        epochs resolve through the payload's overlay, then the inner seq
        batch's id map; every set's value is decoded.  Elements are
        registered slots first, then sets.  A payload the native path
        rejects (KeyError, ValueError) has its staging cleared and is
        walked in Python, counted in FLEET_FALLBACKS["payload_decode"].
        Then one block scatter and two folds, as append_changes."""
        from ..native import decode_value_at, explode_movable_delta_payload

        self._reset_clocks()
        clock = self.clock
        per_doc_payloads = list(per_doc_payloads) + [None] * (self.n_docs - len(per_doc_payloads))
        staging = ([], [], [], [], [], [])
        del_pairs: List[Tuple[int, int]] = []
        for di, payload in enumerate(per_doc_payloads):
            stage = self._stage_doc(*staging)
            rows, overlay, mrows, srows, e_staged, e_order, v_staged = stage
            if not payload:
                continue
            idmap = self.seq.id2row[di]
            base = int(self.seq.counts[di])
            n_vals = len(self.values[di])
            n_dels_start = len(del_pairs)
            eidx = self._elem_registrar(di, e_staged, e_order)
            try:
                with clock.host("explode"):
                    peers_wire, _keys, cids, _r = read_tables(payload)
                    if cid not in cids:
                        continue  # no ops for this container
                    out = explode_movable_delta_payload(payload, cids.index(cid))
                with clock.host("stage"):
                    sl = {f: a.tolist() for f, a in out["slots"].items()}
                    for i in range(len(sl["parent"])):
                        prow = sl["parent"][i]
                        if prow >= 0:
                            prow = base + prow
                        elif prow == -2:  # a parent in an earlier epoch: the id map
                            key = (peers_wire[sl["ext_peer_idx"][i]], sl["ext_counter"][i])
                            r_ = overlay.get(key)
                            prow = idmap[key] if r_ is None else r_
                        peer = peers_wire[sl["peer_idx"][i]]
                        ctr_v = sl["counter"][i]
                        ei = eidx((peers_wire[sl["elem_peer_idx"][i]], sl["elem_ctr"][i]))
                        row = base + i
                        overlay[(peer, ctr_v)] = row
                        rows.append((prow, sl["side"][i], ctr_v, ei, peer))
                        mrows.append((ei, sl["lamport"][i], peer, row))
                    st = {f: a.tolist() for f, a in out["sets"].items()}
                    for i in range(len(st["lamport"])):
                        ei = eidx((peers_wire[st["elem_peer_idx"][i]], st["elem_ctr"][i]))
                        v_staged.append(decode_value_at(payload, st["value_off"][i], cids))
                        srows.append((ei, st["lamport"][i], peers_wire[st["peer_idx"][i]], n_vals + len(v_staged) - 1))
                    dl = out["dels"]
                    for dpi, start, end in zip(dl["peer_idx"].tolist(), dl["start"].tolist(), dl["end"].tolist()):
                        dp = peers_wire[dpi]
                        for ctr_v in range(start, end):
                            row = overlay.get((dp, ctr_v))
                            if row is None:
                                row = idmap.get((dp, ctr_v))
                            if row is not None:
                                del_pairs.append((di, row))
            except (KeyError, ValueError):
                FLEET_FALLBACKS["payload_decode"] += 1
                for part in stage:
                    part.clear()
                del del_pairs[n_dels_start:]
                with clock.host("explode"):
                    self._walk_movable_changes(di, decode_changes(payload), cid, *stage, del_pairs)
        self._commit_movable(*staging, del_pairs)

    def grow(self, capacity: Optional[int] = None, elem_capacity: Optional[int] = None) -> None:
        """Repack: slot rows grow through the inner seq batch, the element
        folds re-pad here, on the device."""
        if capacity is not None:
            self.seq.grow(capacity)
        if elem_capacity is not None and elem_capacity > self.e_cap:
            with self._dev_lock:
                for name, vfill in (("moves", 0), ("vals", -2)):
                    res = getattr(self, name)
                    setattr(self, name, LwwResident(**_pad_axis1(res._asdict(), elem_capacity, _lww_fills(vfill))))
                self.e_cap = elem_capacity

    def _commit_movable(self, rows_per_doc, overlays, move_rows, set_rows, staged_elems, staged_vals,
                        del_pairs) -> None:
        """Shared tail of both appends: the element-capacity check (grow or
        raise RuntimeError) before the seq batch commits its rows (which
        checks its own capacity first), then the staged elements and
        values, then the move fold and the value fold."""
        req_elems = max((len(self.elem_ids[di]) + len(staged_elems[di]) for di in range(self.n_docs)), default=0)
        if req_elems > self.e_cap:
            if not self.auto_grow:
                raise RuntimeError(f"DeviceMovableBatch element capacity exceeded: a doc needs {req_elems} elements "
                                   f"> {self.e_cap}")
            with self.clock.host("grow"):
                self.grow(elem_capacity=_grow_target(req_elems, self.e_cap))
        self.seq._commit_rows(rows_per_doc, overlays, del_pairs)
        for di in range(self.n_docs):
            for eid in staged_elems[di]:
                self.elem_ids[di][eid] = len(self.elem_ids[di])
            self.values[di].extend(staged_vals[di])
        if self._defer_moves is not None:
            set_only = not any(move_rows) and any(set_rows)
            self._defer_moves.extend(move_rows)
            self._defer_vals.extend(set_rows)
            if set_only:
                # a set-only round shipped device work too: counted on the
                # moves accumulator (the group's round tally)
                self._defer_moves.n_rounds += 1
            return
        for rows_set, res_name in ((move_rows, "moves"), (set_rows, "vals")):
            if any(rows_set):
                self._device_fold_elem(rows_set, res_name)

    def _device_fold_elem(self, rows_set, res_name: str) -> None:
        """One block [D, M] of (element, lamport, peer, value) rows, pads on
        the dump element e_cap with value -2, uploaded and folded into the
        `res_name` winners in place."""
        with self._dev_lock, self.clock.device_stage("fold"):
            m = pad_bucket(max(len(r) for r in rows_set), floor=16)
            shape = (self.n_docs, m)
            blk = dict(elem=np.full(shape, self.e_cap, np.int32), lam=np.zeros(shape, np.int32),
                       hi=np.zeros(shape, np.uint32), lo=np.zeros(shape, np.uint32),
                       valid=np.zeros(shape, bool), value=np.full(shape, -2, np.int32))
            for di, rws in enumerate(rows_set):
                if not rws:
                    continue
                k = len(rws)
                arr = np.asarray([(r[0], r[1], r[3]) for r in rws], np.int64)
                pu = np.asarray([r[2] for r in rws], np.uint64)
                blk["elem"][di, :k] = arr[:, 0]
                blk["lam"][di, :k] = arr[:, 1]
                blk["value"][di, :k] = arr[:, 2]
                blk["hi"][di, :k] = pu >> np.uint64(32)
                blk["lo"][di, :k] = pu & np.uint64(0xFFFFFFFF)
                blk["valid"][di, :k] = True
            t = {f: _to_device(a, self.device) for f, a in blk.items()}
            lww_update_resident(getattr(self, res_name), t["elem"], t["lam"], t["hi"], t["lo"], t["valid"], self.e_cap,
                                value=t["value"])

    def value_lists(self) -> List[list]:
        """Every doc's element values in list order, from one sort
        (Fleet.merge_movable_changes' contract a doc)."""
        out_idx, counts = movable_by_key_batch(
            self.seq.cols.valid, self.seq.cols.deleted, self.seq.key_hi, self.seq.key_lo,
            self.moves.value, self.moves.lamport, self.vals.value, device=self.device,
        )
        counts = counts.cpu().numpy()
        out_idx = out_idx[:, : int(counts.max(initial=0))].cpu().numpy()
        return [[self.values[di][j] if j >= 0 else None for j in out_idx[di, : counts[di]].tolist()]
                for di in range(self.n_docs)]

    def export_select(self, index, requests, sup=None) -> List[np.ndarray]:
        """The read plane's batched selection for the sync pull path: one
        launch under `sup` (default: the process supervisor)."""
        return _batch_export_select(self, "movable", index, requests, sup)

    # -- checkpoint and resume ------------------------------------------
    STATE_VERSION = 2  # v2: + auto_grow flag

    def export_state(self) -> bytes:
        """The batch as an LTKV store: meta, the inner seq batch's own
        export, the two [D, E] fold grids, each doc's element dictionary
        and value store; byte for byte what the JAX package's
        DeviceMovableBatch exports after the same appends."""
        kv = MemKvStore()
        d = _Dicts()
        _write_meta(kv, self, _MOVABLE_META)
        kv.set(b"seq", self.seq.export_state())
        for name in ("moves", "vals"):
            res = getattr(self, name)
            _state_write_grid(kv, name.encode(), [getattr(res, f).cpu().numpy().astype(dt) for f, dt in _LWW_GRID.items()])
        for di in range(self.n_docs):
            w = Writer()
            w.varint(len(self.elem_ids[di]))
            for (peer, ctr), i in self.elem_ids[di].items():
                w.u64le(peer)
                w.zigzag(ctr)
                w.varint(i)
            kv.set(b"doc/%08d/elems" % di, bytes(w.buf))
            w = Writer()
            _state_write_values(w, d, self.values[di])
            kv.set(b"doc/%08d/values" % di, bytes(w.buf))
        kv.set(b"dicts", _state_dicts_blob(d))
        return kv.export_all()

    @classmethod
    def import_state(cls, data: bytes, device: DeviceLike = "cuda") -> "DeviceMovableBatch":
        """Restore a batch from export_state bytes (the port's or the JAX
        package's).  Malformed or implausible state raises DecodeError
        before anything large is allocated: a folded winner row outside
        the seq batch's capacity, a folded value ordinal outside its
        doc's value store and an element ordinal at or past the element
        capacity among them."""
        kv = MemKvStore()
        kv.import_all(data)
        meta_b, dicts_b, seq_b = kv.get(b"meta"), kv.get(b"dicts"), kv.get(b"seq")
        if meta_b is None or dicts_b is None or seq_b is None:
            raise DecodeError("DeviceMovableBatch state: missing sections")
        n_docs, d_saved, e_cap, auto_grow = _read_meta("DeviceMovableBatch", meta_b, cls.STATE_VERSION, _MOVABLE_META)
        _peers, cids = _state_read_dicts(dicts_b)
        seq = DeviceDocBatch.import_state(seq_b, device=device)
        if seq.n_docs != n_docs:
            raise DecodeError("DeviceMovableBatch state: seq batch width")
        batch = cls.__new__(cls)
        batch._setup(seq, n_docs, e_cap, auto_grow)
        host = {}
        for name in ("moves", "vals"):
            blob = kv.get(name.encode())
            if blob is None:
                raise DecodeError(f"DeviceMovableBatch state: missing {name}")
            grids = _state_read_grid(blob, [((d_saved, e_cap), dt) for dt in _LWW_GRID.values()])
            host[name] = {f: g[:n_docs] for f, g in zip(_LWW_GRID, grids)}
        # folded slot rows must stay inside the seq buffer (the read
        # gathers with them)
        folded = host["moves"]["lamport"] != NEG
        wrow = host["moves"]["value"][folded].astype(np.int64)
        if wrow.size and (wrow.min() < 0 or wrow.max() >= seq.cap):
            raise DecodeError("DeviceMovableBatch state: winner row")
        try:
            for di in range(n_docs):
                elems_b = kv.get(b"doc/%08d/elems" % di)
                if elems_b is not None:
                    r = Reader(elems_b)
                    eids: Dict[Tuple[int, int], int] = {}
                    for _ in range(r.varint()):
                        peer = r.u64le()
                        ctr = r.zigzag()
                        i = r.varint()
                        if i >= e_cap:
                            raise DecodeError("DeviceMovableBatch state: elem ordinal")
                        eids[(peer, ctr)] = i
                    batch.elem_ids[di] = eids
                vals_b = kv.get(b"doc/%08d/values" % di)
                if vals_b is not None:
                    batch.values[di] = _state_read_values(vals_b, cids)
                # folded value ordinals must stay inside the value store
                vv = host["vals"]["value"][di].astype(np.int64)
                vv = vv[vv >= 0]
                if vv.size and vv.max() >= len(batch.values[di]):
                    raise DecodeError("DeviceMovableBatch state: value ordinal")
        except (IndexError, ValueError, struct.error) as e:
            raise DecodeError(f"DeviceMovableBatch state: malformed doc ({e})") from None
        for name, grids in host.items():
            res = getattr(batch, name)
            for f, g in grids.items():
                getattr(res, f)[:] = _to_device(g, batch.device)
        return batch
