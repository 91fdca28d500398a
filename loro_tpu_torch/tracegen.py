"""Seeded editing traces of the automerge-perf shape, turned into Fugue
element tables, plus the host oracle that gives each document's text.

The automerge-perf trace (Kleppmann's LaTeX paper, as used by Loro's
``crates/loro-internal/benches``) has 259,778 single-character patches:
182,315 inserts and 77,463 deletes, for a final length of 104,852.
``automerge_like_patches`` draws a trace with exactly those counts from
a seed: typing runs at a cursor, backspace runs, and jumps that are
mostly local.  ``concurrent_doc`` then routes the patch stream over
several peers the way the JAX package's ``concurrent_trace_variants``
does (windows of 32-256 patches per peer, a full sync every 4000
patches and at the end): each peer applies its patches to its own view,
the state at the last sync plus its own edits since, and places each
insert with the Fugue rule against that view (after visible element a:
(a, Right) if a has no right children, else (successor(a), Left); at
position 0: (first element, Left), or (root, Right) in an empty view).
Concurrent siblings arise exactly as between real replicas.

``oracle_text`` is the host oracle: an iterative in-order walk of the
element tree, siblings in (peer, counter) order, left subtrees before
the node and right subtrees after it.

``concurrent_doc`` also keeps its event log in apply order, and
``trace_payload`` turns it into the binary updates payload a server
would receive for the document (one change a peer's window, encoded by
``codec.binary.encode_text_changes``), so the ingest path can start
from payload bytes; ``epoch_payloads`` splits the same changes into one
payload a sync epoch, the deltas a resident batch appends.
``seq_columns_u`` lays a document out as the row-order-free table of
the resident path, rows in apply order (as a resident batch appends
them) or in (peer, counter) order.

Generated tables and payloads are cached under ``build/tracegen/``,
tables keyed by the generator version and every parameter, payloads by
the version and the event log.

The LWW-map and counter traces are op histories of two peers with
random u64 ids, routed over the peers in windows of 32-256 ops (one
change a window), the peers syncing fully every epoch: ``map_doc``, puts
and deletes on one root map over a fixed key set (the shape of the JAX
bench's map trace), and ``counter_doc``, increments of per-item counters
that appear epoch by epoch.  ``map_payload`` / ``map_epoch_payloads``
encode a map history whole or one payload a sync epoch
(``codec.binary.encode_changes``); ``oracle_map`` and ``oracle_counter``
are their host oracles, plain walks over the changes.  ``tree_doc`` is
a 4-peer movable-tree history (creates, moves, deletes of one root tree,
each peer working on its own view between syncs, so concurrent moves
form cycles the merge rejects); ``tree_payload`` / ``tree_epoch_payloads``
encode it, and ``oracle_tree`` replays its moves in key order with the
cycle check.  These are not cached: a 65,536-op history takes about a
second to generate.

The rich-text and MovableList traces are seeded stand-ins for the JAX
package's bench_utils.richtext_bench_docs and for bench_movable's shape,
generated on a Fugue sequence that each peer edits in its own view
(_FugueSim): ``richtext_doc`` (3 peers inserting runs, deleting and
marking or unmarking spans of the text) with ``richtext_payload``,
``richtext_epoch_payloads`` and the host walk ``oracle_richtext``;
``movable_doc`` (4 peers inserting, moving, setting and deleting list
elements, moves meeting concurrently) with ``movable_payload``,
``movable_epoch_payloads`` and ``oracle_movable``.  Both are cached
under ``build/tracegen/`` as their payload bytes.

``oracle_export`` is the read plane's host reference: the changes a pull
from a version vector exports, in the OpLog's export order.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import os
import random
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .codec.binary import TextChange, TextDelete, TextInsert, decode_changes, encode_changes, encode_text_changes
from .core.change import (
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
    _RunCont,
)
from .core.ids import ID, ContainerID, ContainerType, IdSpan, TreeID
from .core.version import Frontiers
from .ops.columnar import SeqExtract
from .ops.fugue_batch import SeqColumnsU, pad_rows

AUTOMERGE_PERF_INSERTS = 182_315
AUTOMERGE_PERF_DELETES = 77_463
AUTOMERGE_PERF_PATCHES = AUTOMERGE_PERF_INSERTS + AUTOMERGE_PERF_DELETES  # 259,778
CACHE_DIR = Path(__file__).resolve().parent.parent / "build" / "tracegen"
GENERATOR_VERSION = 2  # 2: the event log (trace_payload)
# the container a generated document's text lives in
TEXT_CID = ContainerID.root("text", ContainerType.Text)
# event log columns, one row per applied patch in apply order: window and
# epoch (syncs before it), the peer's rank and the op's counter, insert
# or delete, then the insert's parent id or the deleted element's id
# (peer rank, counter; -1, -1 = the root), the insert's side and char
EVENT_FIELDS = ("window", "epoch", "peer", "counter", "insert", "ref_peer", "ref_counter", "side", "char")

_CHARS = "eeeeetttaaooiinnsshhrrddllu   cmfwypvbgkjqxz,.\n"
_BLOCK = 128  # view block size (elements, tombstones included)


def automerge_like_patches(seed: int, n_patches: int = AUTOMERGE_PERF_PATCHES):
    """(pos int64[n], is_insert bool[n], char int32[n]) for one author:
    positions are valid in that author's text at apply time, and the
    insert/delete counts keep the automerge-perf ratio exactly (the full
    size gives its 182,315 / 77,463)."""
    ins_left = round(n_patches * AUTOMERGE_PERF_INSERTS / AUTOMERGE_PERF_PATCHES)
    del_left = n_patches - ins_left
    rng = random.Random(seed)
    pos = np.empty(n_patches, np.int64)
    ins = np.empty(n_patches, bool)
    chars = np.empty(n_patches, np.int32)
    length = cursor = 0
    i = 0
    # mean run lengths; a run's kind is drawn so that patches of each
    # kind are used up in proportion to what is left of them
    mean_type, mean_erase = 30.5, 6.5
    while i < n_patches:
        u = rng.random()
        if u < 0.2:  # jump anywhere
            cursor = rng.randint(0, length)
        elif u < 0.55:  # move nearby; otherwise go on at the cursor
            cursor = min(max(cursor + rng.randint(-48, 48), 0), length)
        w_erase = del_left * mean_type
        erase = length > 0 and del_left > 0 and (
            ins_left == 0 or rng.random() * (w_erase + ins_left * mean_erase) < w_erase
        )
        run = rng.randint(1, 12) if erase else rng.randint(1, 60)
        for _ in range(run):
            if erase:
                if del_left == 0 or length == 0:
                    break
                if cursor > 0:  # backspace; forward delete at the start
                    cursor -= 1
                pos[i], ins[i], chars[i] = cursor, False, 0
                length -= 1
                del_left -= 1
            else:
                if ins_left == 0:
                    break
                pos[i], ins[i], chars[i] = cursor, True, ord(_CHARS[rng.randrange(len(_CHARS))])
                length += 1
                cursor += 1
                ins_left -= 1
            i += 1
    return pos, ins, chars


class _View:
    """One peer's view of the sequence: element ids in traversal order
    (tombstones included) in blocks of ~_BLOCK, with visible counts per
    block for the k-th-visible lookup and a cursor cache (edits are
    local)."""

    def __init__(self, order: Sequence[int], vis: bytearray, rcount: List[int]):
        self.vis = vis
        self.rcount = rcount
        self.blocks = [list(order[i : i + _BLOCK]) for i in range(0, len(order), _BLOCK)] or [[]]
        v = np.frombuffer(bytes(vis), np.uint8)
        self.bvis = [int(v[b].sum()) if b else 0 for b in self.blocks]
        self.nvis = sum(self.bvis)
        self.cache_bi = 0
        self.cache_before = 0

    def find(self, k: int) -> Tuple[int, int]:
        """(block, offset) of the k-th visible element (0-based)."""
        bi, before, bvis = self.cache_bi, self.cache_before, self.bvis
        while k < before:
            bi -= 1
            before -= bvis[bi]
        while before + bvis[bi] <= k:
            before += bvis[bi]
            bi += 1
        self.cache_bi, self.cache_before = bi, before
        r = k - before
        vis = self.vis
        for j, e in enumerate(self.blocks[bi]):
            if vis[e]:
                if r == 0:
                    return bi, j
                r -= 1
        raise AssertionError("view block counts out of sync")

    def successor(self, bi: int, j: int) -> int:
        blk = self.blocks[bi]
        return blk[j + 1] if j + 1 < len(blk) else self.blocks[bi + 1][0]

    def insert_at(self, bi: int, j: int, e: int, visible: bool = True) -> None:
        """Insert element e at offset j of block bi (visible, or not: a
        style anchor)."""
        blk = self.blocks[bi]
        blk.insert(j, e)
        if visible:
            self.vis[e] = 1
            self.bvis[bi] += 1
            self.nvis += 1
            if bi < self.cache_bi:
                self.cache_before += 1
        if len(blk) > 2 * _BLOCK:
            tail = blk[_BLOCK:]
            del blk[_BLOCK:]
            self.blocks.insert(bi + 1, tail)
            nt = sum(self.vis[x] for x in tail)
            self.bvis[bi] -= nt
            self.bvis.insert(bi + 1, nt)
            if bi < self.cache_bi:
                self.cache_bi += 1

    def delete_at(self, bi: int, j: int) -> int:
        e = self.blocks[bi][j]
        self.vis[e] = 0
        self.bvis[bi] -= 1
        self.nvis -= 1
        if bi < self.cache_bi:
            self.cache_before -= 1
        return e


def _walk(root_children: List[int], lch: List[Optional[list]], rch: List[Optional[list]]) -> List[int]:
    """In-order walk: left subtrees, node, right subtrees (iterative;
    ~e on the stack means "emit e")."""
    out: List[int] = []
    stack = list(reversed(root_children))
    while stack:
        x = stack.pop()
        if x < 0:
            out.append(~x)
            continue
        r, l = rch[x], lch[x]
        if r:
            stack.extend(reversed(r))
        stack.append(~x)
        if l:
            stack.extend(reversed(l))
    return out


@dataclass
class TraceDoc:
    """One generated document: its (peer, counter)-sorted element table,
    its text by the host oracle, the patches applied to produce it, and
    their event log (EVENT_FIELDS -> int32 [n_ops], apply order)."""

    extract: SeqExtract
    text: str
    n_ops: int
    n_peers: int
    events: Dict[str, np.ndarray]


def concurrent_doc(patches, n_peers: int = 4, sync_every: int = 4000, seed: int = 0,
                   peer_base: int = 1 << 8) -> TraceDoc:
    """Replay one author's patch stream over `n_peers` concurrent peers
    (peer ids peer_base + 1 + i).  A delete past a peer's visible length
    is dropped, as in the JAX package's concurrent_trace_variants."""
    pos_a, ins_a, ch_a = patches
    cap = int(ins_a.sum())
    rng = random.Random(seed)
    parent: List[int] = []
    side: List[int] = []
    peer: List[int] = []
    counter: List[int] = []
    content: List[int] = []
    key: List[int] = []
    lch: List[Optional[list]] = [None] * cap
    rch: List[Optional[list]] = [None] * cap
    root_ch: List[int] = []
    deleted = bytearray(cap)
    g_rcount = [0] * cap
    views = [_View([], bytearray(cap), [0] * cap) for _ in range(n_peers)]
    ctr = [0] * n_peers

    def add_child(lst: Optional[list], e: int) -> list:
        lst = lst if lst is not None else []
        bisect.insort(lst, e, key=key.__getitem__)
        return lst

    def sync() -> None:
        order = _walk(root_ch, lch, rch)
        vis = bytearray(cap)
        for e in order:
            vis[e] = 1 - deleted[e]
        for i in range(n_peers):
            views[i] = _View(order, bytearray(vis), list(g_rcount))

    cur = window_left = 0
    window = -1
    n_applied = 0
    log: List[Tuple[int, ...]] = []
    for i in range(len(pos_a)):
        if window_left == 0:
            cur = rng.randrange(n_peers)
            window_left = rng.randint(32, 256)
            window += 1
        window_left -= 1
        epoch = i // sync_every
        v = views[cur]
        p = min(int(pos_a[i]), v.nvis)
        if ins_a[i]:
            e = len(parent)
            if p == 0:
                if v.blocks[0]:
                    par, sd = v.blocks[0][0], 0
                else:
                    par, sd = -1, 1
                bi, j = 0, 0
            else:
                bi, j = v.find(p - 1)
                a = v.blocks[bi][j]
                if v.rcount[a] == 0:
                    par, sd = a, 1
                else:
                    par, sd = v.successor(bi, j), 0
                j += 1
            log.append((window, epoch, cur, ctr[cur], 1, peer[par] if par >= 0 else -1,
                        counter[par] if par >= 0 else -1, sd, int(ch_a[i])))
            parent.append(par)
            side.append(sd)
            peer.append(cur)
            counter.append(ctr[cur])
            content.append(int(ch_a[i]))
            key.append((cur << 32) | ctr[cur])
            ctr[cur] += 1
            if par < 0:
                bisect.insort(root_ch, e, key=key.__getitem__)
            elif sd == 1:
                rch[par] = add_child(rch[par], e)
                g_rcount[par] += 1
                v.rcount[par] += 1
            else:
                lch[par] = add_child(lch[par], e)
            v.insert_at(bi, j, e)
            n_applied += 1
        elif p < v.nvis:
            bi, j = v.find(p)
            e = v.delete_at(bi, j)
            deleted[e] = 1
            log.append((window, epoch, cur, ctr[cur], 0, peer[e], counter[e], 0, 0))
            ctr[cur] += 1
            n_applied += 1
        if (i + 1) % sync_every == 0:
            sync()
    order = _walk(root_ch, lch, rch)
    text = "".join(chr(content[e]) for e in order if not deleted[e])
    # peer ranks among the peers that applied a patch (a payload's peer
    # table holds those only); routing draws every peer on a long trace
    ev = np.asarray(log, np.int32).reshape(-1, len(EVENT_FIELDS))
    active = np.unique(ev[:, EVENT_FIELDS.index("peer")])
    rank = np.full(n_peers + 1, -1, np.int32)  # rank[-1] = -1: the root
    rank[active] = np.arange(len(active), dtype=np.int32)
    for f in ("peer", "ref_peer"):
        ev[:, EVENT_FIELDS.index(f)] = rank[ev[:, EVENT_FIELDS.index(f)]]
    events = {f: np.ascontiguousarray(ev[:, k]) for k, f in enumerate(EVENT_FIELDS)}
    ex = SeqExtract(
        parent=np.asarray(parent, np.int32),
        side=np.asarray(side, np.int32),
        peer=rank[np.asarray(peer, np.int64)],
        counter=np.asarray(counter, np.int32),
        deleted=np.frombuffer(bytes(deleted), np.uint8)[: len(parent)].astype(bool),
        content=np.asarray(content, np.int32),
        valid=np.ones(len(parent), bool),
        peers=[peer_base + 1 + int(i) for i in active],
    ).sort_by_peer_counter()
    return TraceDoc(extract=ex, text=text, n_ops=n_applied, n_peers=n_peers, events=events)


def trace_changes(doc: TraceDoc) -> List[TextChange]:
    """The document's event log as changes, in apply order (see
    _epoch_changes)."""
    return [ch for _, ch in _epoch_changes(doc)]


def _epoch_changes(doc: TraceDoc) -> List[Tuple[int, TextChange]]:
    """(sync epoch, change) of the document's event log, in apply order:
    a change is the run of one window's events within one sync epoch (so
    a change never spans a sync), and a same-peer right-spine typing run
    in it (an insert whose parent is the peer's previous insert, on the
    right) becomes one multi-character insert.  Deps are causally sound: the
    peer's own last op when it already changed in this epoch, else the
    last op of every peer before the epoch's sync (all the peer's view
    held).  Lamport = 1 + the largest lamport among the deps."""
    ev = {f: doc.events[f].tolist() for f in EVENT_FIELDS}
    ids = doc.extract.peers  # peer rank -> peer id
    n_peers = len(ids)
    last_ctr, last_lam = [-1] * n_peers, [-1] * n_peers
    snap_ctr, snap_lam = list(last_ctr), list(last_lam)
    snap_epoch = 0
    changed_in_epoch = [False] * n_peers
    out: List[Tuple[int, TextChange]] = []
    n = len(ev["window"])
    i = 0
    while i < n:
        w, epoch, p = ev["window"][i], ev["epoch"][i], ev["peer"][i]
        j = i + 1
        while j < n and ev["window"][j] == w and ev["epoch"][j] == epoch:
            j += 1
        if epoch != snap_epoch:  # every event so far came before this epoch's sync
            snap_ctr, snap_lam = list(last_ctr), list(last_lam)
            snap_epoch = epoch
            changed_in_epoch = [False] * n_peers
        if changed_in_epoch[p]:
            dep_ranks = [(p, last_ctr[p], last_lam[p])]
        else:
            dep_ranks = [(q, snap_ctr[q], snap_lam[q]) for q in range(n_peers) if snap_ctr[q] >= 0]
        deps = tuple(sorted((ids[q], c) for q, c, _ in dep_ranks))
        lamport = 1 + max((lam for _, _, lam in dep_ranks), default=-1)
        ops: List = []
        for k in range(i, j):
            ref = (ids[ev["ref_peer"][k]], ev["ref_counter"][k]) if ev["ref_peer"][k] >= 0 else None
            if not ev["insert"][k]:
                ops.append(TextDelete(((ref[0], ref[1], ref[1] + 1),)))
            elif (k > i and ev["insert"][k - 1] and ev["side"][k] == 1 and ev["ref_peer"][k] == p
                  and ev["ref_counter"][k] == ev["counter"][k - 1]):
                ops[-1] = ops[-1]._replace(text=ops[-1].text + chr(ev["char"][k]))
            else:
                ops.append(TextInsert(ref, ev["side"][k], chr(ev["char"][k])))
        ctr_start = ev["counter"][i]
        out.append((epoch, TextChange(ids[p], ctr_start, lamport, 0, deps, tuple(ops))))
        last_ctr[p] = ev["counter"][j - 1]
        last_lam[p] = lamport + last_ctr[p] - ctr_start
        changed_in_epoch[p] = True
        i = j
    return out


def trace_payload(doc: TraceDoc, use_cache: bool = True) -> bytes:
    """The binary updates payload of the document's history in container
    TEXT_CID (trace_changes encoded by encode_text_changes); decoded, its
    element table equals doc.extract column for column.  Cached under
    build/tracegen/ by the generator version and the event log."""
    h = hashlib.sha256(str(GENERATOR_VERSION).encode())
    for f in EVENT_FIELDS:
        h.update(doc.events[f].tobytes())
    h.update(np.asarray(doc.extract.peers, np.uint64).tobytes())
    path = CACHE_DIR / f"payload_{h.hexdigest()[:16]}.bin"
    if use_cache and path.exists():
        return path.read_bytes()
    payload = encode_text_changes(trace_changes(doc), TEXT_CID)
    if use_cache:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(payload)
        tmp.replace(path)
    return payload


def epoch_payloads(doc: TraceDoc, use_cache: bool = True) -> List[bytes]:
    """One binary updates payload a sync epoch of the document, in
    container TEXT_CID: the changes of trace_changes grouped by their
    epoch (a change never spans a sync), each group encoded by
    encode_text_changes: what a sync server receives from the document's
    replicas at each sync, the input of a resident batch's appends.
    Their concatenated changes are trace_changes(doc).  Cached under
    build/tracegen/ like trace_payload."""
    h = hashlib.sha256(f"epochs {GENERATOR_VERSION}".encode())
    for f in EVENT_FIELDS:
        h.update(doc.events[f].tobytes())
    h.update(np.asarray(doc.extract.peers, np.uint64).tobytes())
    path = CACHE_DIR / f"epochs_{h.hexdigest()[:16]}.npz"
    if use_cache and path.exists():
        try:
            z = np.load(path)
            data, offs = z["data"].tobytes(), z["offsets"].tolist()
            return [data[a:b] for a, b in zip(offs, offs[1:])]
        except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
            pass  # stale or truncated cache: regenerate
    tagged = _epoch_changes(doc)
    n_epochs = 1 + int(doc.events["epoch"].max(initial=0))
    groups: List[List[TextChange]] = [[] for _ in range(n_epochs)]
    for epoch, ch in tagged:
        groups[epoch].append(ch)
    payloads = [encode_text_changes(g, TEXT_CID) for g in groups]
    if use_cache:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
        offs = np.cumsum([0] + [len(b) for b in payloads]).astype(np.int64)
        np.savez(tmp, data=np.frombuffer(b"".join(payloads), np.uint8), offsets=offs)
        tmp.replace(path)
    return payloads


def seq_columns_u(doc: TraceDoc, order: str = "apply", pad_to: Optional[int] = None) -> SeqColumnsU:
    """Numpy SeqColumnsU of the document: rows in the event log's insert
    order (order="apply") or in (peer, counter) order ("peer"), parents
    remapped to those rows, peer ids split into uint32 halves, padded
    with invalid rows to `pad_to` rows when given."""
    ex = doc.extract
    if order == "peer":
        perm = np.arange(ex.n)
    elif order == "apply":
        ins = doc.events["insert"].astype(bool)
        want = (doc.events["peer"][ins].astype(np.int64) << 32) | doc.events["counter"][ins].astype(np.int64)
        have = (ex.peer.astype(np.int64) << 32) | ex.counter.astype(np.int64)  # ascending: the extract's order
        perm = np.searchsorted(have, want)
        if perm.shape[0] != ex.n or not np.array_equal(have[np.minimum(perm, ex.n - 1)], want):
            raise ValueError("the event log's inserts are not the extract's elements")
    else:
        raise ValueError(f"order must be 'apply' or 'peer', got {order!r}")
    inv = np.empty(ex.n, np.int64)
    inv[perm] = np.arange(ex.n)
    parent = ex.parent[perm].astype(np.int64)
    parent = np.where(parent >= 0, inv[np.maximum(parent, 0)], -1).astype(np.int32)
    peer_id = np.asarray(ex.peers, np.uint64)[ex.peer[perm]]
    n = ex.n if pad_to is None else pad_to
    if n < ex.n:
        raise ValueError(f"pad_to {pad_to} < {ex.n} rows")
    return SeqColumnsU(
        parent=pad_rows(parent, n, -1),
        side=pad_rows(ex.side[perm], n, 0),
        peer_hi=pad_rows((peer_id >> np.uint64(32)).astype(np.uint32), n, 0),
        peer_lo=pad_rows((peer_id & np.uint64(0xFFFFFFFF)).astype(np.uint32), n, 0),
        counter=pad_rows(ex.counter[perm], n, 0),
        deleted=pad_rows(ex.deleted[perm], n, True),
        content=pad_rows(ex.content[perm], n, -1),
        valid=pad_rows(ex.valid[perm], n, False),
    )


def oracle_text(ex: SeqExtract) -> str:
    """Host oracle: the document text of a (peer, counter)-sorted element
    table by an iterative in-order walk of its Fugue tree."""
    n = ex.n
    parent = ex.parent.astype(np.int64)
    lch: List[Optional[list]] = [None] * n
    rch: List[Optional[list]] = [None] * n
    root_ch: List[int] = []
    # rows are in (peer, counter) order, so appending in row order keeps
    # every sibling list sorted
    for e, (p, s, ok) in enumerate(zip(parent.tolist(), ex.side.tolist(), ex.valid.tolist())):
        if not ok:
            continue
        if p < 0:
            root_ch.append(e)
            continue
        kids = lch if s == 0 else rch
        if kids[p] is None:
            kids[p] = []
        kids[p].append(e)
    content = ex.content.tolist()
    deleted = ex.deleted.tolist()
    return "".join(chr(content[e]) for e in _walk(root_ch, lch, rch) if not deleted[e])


def _cache_path(params: dict) -> Path:
    h = hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]
    return CACHE_DIR / f"trace_{h}.npz"


def _load(path: Path, params: dict) -> Optional[TraceDoc]:
    if not path.exists():
        return None
    try:
        z = np.load(path)
        if json.loads(str(z["params"])) != params:
            return None
        ex = SeqExtract(
            parent=z["parent"], side=z["side"], peer=z["peer"], counter=z["counter"],
            deleted=z["deleted"], content=z["content"], valid=z["valid"],
            peers=[int(p) for p in z["peers"]],
        )
        text = "".join(map(chr, z["text"].tolist()))
        events = {f: z["ev_" + f] for f in EVENT_FIELDS}
        return TraceDoc(ex, text, int(z["n_ops"]), params["n_peers"], events)
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        return None  # stale or truncated cache: regenerate


def _save(path: Path, params: dict, doc: TraceDoc) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    ex = doc.extract
    np.savez(
        tmp, parent=ex.parent, side=ex.side, peer=ex.peer, counter=ex.counter,
        deleted=ex.deleted, content=ex.content, valid=ex.valid,
        peers=np.asarray(ex.peers, np.uint64), text=np.asarray([ord(c) for c in doc.text], np.int32),
        n_ops=np.int64(doc.n_ops), params=np.asarray(json.dumps(params, sort_keys=True)),
        **{"ev_" + f: a for f, a in doc.events.items()},
    )
    tmp.replace(path)


def fleet_docs(n_concurrent: int = 2, n_patches: int = AUTOMERGE_PERF_PATCHES, seed: int = 0,
               n_peers: int = 4, sync_every: int = 4000, use_cache: bool = True) -> List[TraceDoc]:
    """Distinct documents for a fleet chunk, all replaying one seeded
    author trace: the single-peer linear document first, then
    `n_concurrent` concurrent variants, each with its own window routing
    and peer ids."""
    patches = None
    out = []
    for v in range(n_concurrent + 1):
        params = {
            "version": GENERATOR_VERSION, "seed": seed, "variant": v, "n_patches": n_patches,
            "n_peers": 1 if v == 0 else n_peers, "sync_every": sync_every,
        }
        path = _cache_path(params)
        doc = _load(path, params) if use_cache else None
        if doc is None:
            if patches is None:
                patches = automerge_like_patches(seed, n_patches)
            doc = concurrent_doc(
                patches, n_peers=params["n_peers"], sync_every=sync_every,
                seed=seed * 1000 + v, peer_base=(v + 1) << 8,
            )
            if use_cache:
                _save(path, params, doc)
        out.append(doc)
    return out


# ---- LWW-map and counter traces ---------------------------------------------

MAP_CID = ContainerID.root("m", ContainerType.Map)  # the map a map trace writes
MAP_SYNC_EVERY = 4_096  # ops a sync epoch of a map trace
COUNTER_EPOCH = 512  # increments a sync epoch of a counter trace
_VALUE_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789 é"


@dataclass
class OpTrace:
    """A generated op history: its peers' u64 ids, its changes in apply
    order, and each change's sync epoch (the full syncs before it)."""

    peers: Tuple[int, ...]
    changes: List[Change]
    epochs: List[int]
    n_ops: int

    @property
    def n_epochs(self) -> int:
        return 1 + max(self.epochs, default=0)

    def epoch_changes(self) -> List[List[Change]]:
        """The changes grouped by sync epoch."""
        groups: List[List[Change]] = [[] for _ in range(self.n_epochs)]
        for ch, e in zip(self.changes, self.epochs):
            groups[e].append(ch)
        return groups


def _peer_ids(rng: random.Random, n_peers: int) -> Tuple[int, ...]:
    """Distinct random u64 peer ids, the first with bit 63 set (a peer id
    that an int32 or int64 view would take for negative)."""
    ids = [rng.getrandbits(64) | (1 << 63)]
    while len(ids) < n_peers:
        p = rng.getrandbits(64)
        if p and p not in ids:
            ids.append(p)
    return tuple(ids)


def _windowed_changes(rng: random.Random, peers: Sequence[int], n_ops: int, sync_every: int, make_op,
                      window: Tuple[int, int] = (32, 256), done=None):
    """(changes, epochs): a stream of n_ops draws, make_op(i, p, counter,
    lamport) -> (container, content) for draw i, made by peer index p at
    that counter and lamport (or a list of such ops, the later ones at
    the counters after it, or none), routed over the peers in windows of
    `window` draws, one change a window, a change never spanning a sync
    (one every sync_every draws).  The stream ends early once done()
    holds.  Deps are causally sound: the peer's own last op when it
    already changed in this epoch, else the last op of every peer before
    the epoch's sync.  Lamport = 1 + the largest lamport among the deps;
    an op takes one counter (and one lamport) an atom."""
    n_peers = len(peers)
    next_ctr = [0] * n_peers
    last_lam = [-1] * n_peers
    snap_ctr, snap_lam = list(next_ctr), list(last_lam)
    changed = [False] * n_peers
    changes: List[Change] = []
    epochs: List[int] = []
    snap_epoch = 0
    i = 0
    while i < n_ops and not (done and done()):
        epoch = i // sync_every
        if epoch != snap_epoch:  # a full sync: every peer has seen every op so far
            snap_ctr, snap_lam = list(next_ctr), list(last_lam)
            snap_epoch = epoch
            changed = [False] * n_peers
        p = rng.randrange(n_peers)
        w = min(rng.randint(*window), n_ops - i, (epoch + 1) * sync_every - i)
        if changed[p]:
            deps = [(p, next_ctr[p] - 1, last_lam[p])]
        else:
            deps = [(q, snap_ctr[q] - 1, snap_lam[q]) for q in range(n_peers) if snap_ctr[q] > 0]
        lamport = 1 + max((lam for _, _, lam in deps), default=-1)
        ctr0 = ctr = next_ctr[p]
        ops: List[Op] = []
        for k in range(w):
            if done and done():
                w = k
                break
            made = make_op(i + k, p, ctr, lamport + ctr - ctr0)
            for container, content in made if isinstance(made, list) else [made]:
                ops.append(Op(ctr, container, content))
                ctr = ops[-1].ctr_end
        i += w
        if not ops:
            continue
        changes.append(Change(ID(peers[p], ctr0), lamport, Frontiers(ID(peers[q], c) for q, c, _ in deps), ops))
        epochs.append(epoch)
        next_ctr[p] = ctr
        last_lam[p] = lamport + ctr - ctr0 - 1
        changed[p] = True
    return changes, epochs


def _random_value(rng: random.Random):
    """A value of every scalar tag: mostly ints (a few past 32 bits), then
    short strings, floats, bools and nulls."""
    u = rng.random()
    if u < 0.70:
        return rng.randrange(-(1 << 20), 1 << 20) if u < 0.68 else rng.randrange(1 << 40)
    if u < 0.82:
        return "".join(rng.choice(_VALUE_CHARS) for _ in range(rng.randint(0, 8)))
    if u < 0.92:
        return rng.uniform(-1e6, 1e6)
    if u < 0.97:
        return rng.random() < 0.5
    return None


def map_doc(seed: int, n_ops: int = 65_536, n_keys: int = 4_096, sync_every: int = MAP_SYNC_EVERY) -> OpTrace:
    """A 2-peer concurrent-put history on the root map MAP_CID: n_ops ops over
    the keys k0000.. drawn uniformly, 1 in 16 a delete; values mostly
    ints (a few past 32 bits), then short strings, floats, bools and
    nulls."""
    rng = random.Random(seed)
    peers = _peer_ids(rng, 2)
    keys = [f"k{i:04d}" for i in range(n_keys)]

    def op(_i, *_):
        key = keys[rng.randrange(n_keys)]
        if rng.random() < 1 / 16:
            return MAP_CID, MapSet(key, None, True)
        return MAP_CID, MapSet(key, _random_value(rng))

    changes, epochs = _windowed_changes(rng, peers, n_ops, sync_every, op)
    return OpTrace(peers, changes, epochs, n_ops)


def map_payload(doc: OpTrace) -> bytes:
    """The binary updates payload of the whole history."""
    return encode_changes(doc.changes)


def map_epoch_payloads(doc: OpTrace) -> List[bytes]:
    """One binary updates payload a sync epoch, the input of a resident
    batch's appends."""
    return [encode_changes(g) for g in doc.epoch_changes()]


def oracle_map(doc: OpTrace, n_epochs: Optional[int] = None) -> Dict[str, object]:
    """{key: value} of the root map MAP_CID after the first `n_epochs`
    sync epochs (default all): per key the op with the largest (lamport,
    peer u64); a winning delete leaves the key absent."""
    best: Dict[str, Tuple[Tuple[int, int], MapSet]] = {}
    for ch, e in zip(doc.changes, doc.epochs):
        if n_epochs is not None and e >= n_epochs:
            break
        for op in ch.ops:
            c = op.content
            if op.container != MAP_CID or not isinstance(c, MapSet):
                continue
            k = (ch.lamport + op.counter - ch.ctr_start, ch.peer)
            cur = best.get(c.key)
            if cur is None or k > cur[0]:
                best[c.key] = (k, c)
    return {key: c.value for key, (_, c) in best.items() if not c.deleted}


def counter_doc(seed: int, n_incr: int = 4_096, n_counters: int = 96, epoch_incr: int = COUNTER_EPOCH) -> OpTrace:
    """A 2-peer increment history over root counters item000..: in epoch e the
    first ceil(n_counters * (e + 1) / n_epochs) counters are live (items
    appear epoch by epoch), each increment picks a live counter
    uniformly; deltas are multiples of 1/4 in [-64, 64], so every partial
    sum is exact in float32 in any order."""
    rng = random.Random(seed)
    peers = _peer_ids(rng, 2)
    n_epochs = -(-n_incr // epoch_incr)
    cids = [ContainerID.root(f"item{i:03d}", ContainerType.Counter) for i in range(n_counters)]

    def op(i, *_):
        live = -(-n_counters * (i // epoch_incr + 1) // n_epochs)
        return cids[rng.randrange(live)], CounterIncr(rng.randint(-256, 256) / 4)

    changes, epochs = _windowed_changes(rng, peers, n_incr, epoch_incr, op)
    return OpTrace(peers, changes, epochs, n_incr)


def oracle_counter(doc: OpTrace, n_epochs: Optional[int] = None) -> Dict[ContainerID, float]:
    """{counter: float64 sum} after the first `n_epochs` sync epochs
    (default all)."""
    out: Dict[ContainerID, float] = {}
    for ch, e in zip(doc.changes, doc.epochs):
        if n_epochs is not None and e >= n_epochs:
            break
        for op in ch.ops:
            if isinstance(op.content, CounterIncr):
                out[op.container] = out.get(op.container, 0.0) + op.content.delta
    return out


# ---- movable-tree traces ---------------------------------------------------------

TREE_CID = ContainerID.root("tree", ContainerType.Tree)  # the tree a tree trace writes
TREE_SYNC_EVERY = 512  # moves a sync epoch of a tree trace
_TRASHED = TreeID(0xFFFF_FFFF_FFFF_FFFF, -1)  # the parent of a deleted node


def _tree_ops(changes: Sequence[Change], epochs: Sequence[int], n_epochs: Optional[int]):
    """((lamport, peer, counter), TreeMove) of every move of TREE_CID in
    the first n_epochs sync epochs (default all), sorted by that key."""
    out = []
    for ch, e in zip(changes, epochs):
        if n_epochs is not None and e >= n_epochs:
            break
        for op in ch.ops:
            if op.container == TREE_CID and isinstance(op.content, TreeMove):
                out.append(((ch.lamport + op.counter - ch.ctr_start, ch.peer, op.counter), op.content))
    out.sort(key=lambda r: r[0])
    return out


def _tree_apply(state: Dict[TreeID, tuple], key, c: TreeMove) -> bool:
    """Apply one move to {node: (parent | None | _TRASHED, position, move
    key)} unless its new parent lies in the target's subtree (or is the
    target): the walk up from the parent stops at the root, the trash or
    a node never created.  Returns whether it was applied."""
    parent = _TRASHED if c.is_delete else c.parent
    cur = parent
    while cur is not None and cur != _TRASHED:
        if cur == c.target:
            return False
        node = state.get(cur)
        cur = node[0] if node is not None else None
    state[c.target] = (parent, c.position, key)
    return True


def _up(parents: Dict[TreeID, object], x: TreeID, t: Optional[TreeID] = None) -> Tuple[bool, int, bool]:
    """(alive, depth, whether t is x or one of its ancestors) of node x in
    a {node: parent | None | _TRASHED} view."""
    depth, meets, cur = 0, False, x
    while cur is not None:
        if cur == _TRASHED:
            return False, depth, meets
        meets = meets or cur == t
        cur = parents.get(cur)
        depth += 1
    return True, depth, meets


def tree_doc(seed: int, n_moves: int = 2_048, n_nodes: int = 512, sync_every: int = TREE_SYNC_EVERY) -> OpTrace:
    """A 4-peer movable-tree history on the root tree TREE_CID: n_moves
    ops of which n_nodes are creates (about 1 in 4 at the defaults) spread
    at random, 1 in 16 of the rest deletes and the others moves.  Each
    peer works on its own view (the tree at the last sync, every peer's
    ops merged, plus its own ops since), where every op it makes is
    valid: a create or move goes under a live node that is not in the
    target's subtree, or under the root (1 in 16); a delete trashes a
    live leaf the peer created.  Concurrent peers' moves then form cycles
    that the merge rejects.  A parent is the deeper of the peer's
    last placed node and the deepest node at the last sync, where live
    and outside the target's subtree, else the deeper of two live nodes
    drawn at random, so the tree grows deep (to depths of 30-110 at the
    defaults); positions are random 1-4 byte fractional indexes."""
    rng = random.Random(seed)
    peers = _peer_ids(rng, 4)
    merged: Dict[TreeID, tuple] = {}
    views: List[Dict[TreeID, object]] = [{} for _ in peers]
    kids: List[Dict[object, int]] = [{} for _ in peers]  # children a node has in each view
    known: List[List[TreeID]] = [[] for _ in peers]  # every node a view holds
    tips: List[Optional[TreeID]] = [None] * len(peers)  # each peer's last placed node
    mine: List[List[TreeID]] = [[] for _ in peers]  # the nodes each peer created
    created: List[TreeID] = []
    pending: list = []  # this epoch's (key, TreeMove)
    st = {"epoch": 0, "creates_left": n_nodes, "deepest": None}

    def sync() -> None:
        for key, c in sorted(pending, key=lambda r: r[0]):
            _tree_apply(merged, key, c)
        pending.clear()
        counts: Dict[object, int] = {}
        for node in merged.values():
            counts[node[0]] = counts.get(node[0], 0) + 1
        for q in range(len(peers)):
            views[q] = {t: node[0] for t, node in merged.items()}
            kids[q] = dict(counts)
            known[q] = list(created)
        alive_depth = [(d, t) for t in created for alive, d, _ in [_up(views[0], t)] if alive]
        st["deepest"] = max(alive_depth)[1] if alive_depth else None

    def live(p: int):
        """(node, depth) of a live node of peer p's view drawn at random
        (16 tries), or None."""
        for _ in range(16 if known[p] else 0):
            x = known[p][rng.randrange(len(known[p]))]
            alive, depth, _ = _up(views[p], x)
            if alive:
                return x, depth
        return None

    def deep(p: int, t: Optional[TreeID] = None) -> Optional[TreeID]:
        """The deeper of p's last placed node and the deepest node at the
        last sync, where live and outside t's subtree, else the deeper of
        two live nodes drawn at random outside it; None (the root) if there
        is none."""
        best = None
        for x in (tips[p], st["deepest"]):
            if x is not None:
                alive, depth, meets = _up(views[p], x, t)
                if alive and not meets and (best is None or depth > best[1]):
                    best = (x, depth)
        for _ in range(0 if best else 2):
            got = live(p)
            if got is not None and not _up(views[p], got[0], t)[2] and (best is None or got[1] > best[1]):
                best = got
        return None if best is None else best[0]

    def leaf(p: int) -> Optional[TreeID]:
        """A live leaf of p's view among the nodes p created, or None."""
        for _ in range(8 if mine[p] else 0):
            x = mine[p][rng.randrange(len(mine[p]))]
            if not kids[p].get(x) and _up(views[p], x)[0]:
                return x
        return None

    def position() -> bytes:
        return bytes(rng.randrange(256) for _ in range(rng.randint(1, 4)))

    def op(i: int, p: int, ctr: int, lam: int):
        if i // sync_every != st["epoch"]:
            sync()
            st["epoch"] = i // sync_every
        view = views[p]
        target = live(p)
        if target is None or (st["creates_left"] and rng.random() * (n_moves - i) < st["creates_left"]):
            # a create (past n_nodes only when the view holds no live node)
            st["creates_left"] = max(0, st["creates_left"] - 1)
            t = TreeID(peers[p], ctr)
            c = TreeMove(t, deep(p) if rng.random() >= 1 / 16 else None, position(), is_create=True)
            known[p].append(t)
            mine[p].append(t)
            created.append(t)
        else:
            gone = leaf(p) if rng.random() < 1 / 16 else None
            if gone is not None:
                c = TreeMove(gone, None, None, is_delete=True)
            else:
                # the target: the shallower of two live nodes, redrawn (up
                # to 4 times) while it is an ancestor of p's last placed node
                for _ in range(4):
                    other = live(p)
                    t = other[0] if other is not None and other[1] < target[1] else target[0]
                    if tips[p] is None or not _up(view, tips[p], t)[2]:
                        break
                    target = live(p) or target
                c = TreeMove(t, deep(p, t) if rng.random() >= 1 / 16 else None, position())
        old = view.get(c.target, 0)
        if old != 0:
            kids[p][old] -= 1
        new = _TRASHED if c.is_delete else c.parent
        view[c.target] = new
        kids[p][new] = kids[p].get(new, 0) + 1
        if not c.is_delete:
            tips[p] = c.target
        pending.append(((lam, peers[p], ctr), c))
        return TREE_CID, c

    changes, epochs = _windowed_changes(rng, peers, n_moves, sync_every, op)
    return OpTrace(peers, changes, epochs, n_moves)


def tree_payload(doc: OpTrace) -> bytes:
    """The binary updates payload of the whole history."""
    return encode_changes(doc.changes)


def tree_epoch_payloads(doc: OpTrace) -> List[bytes]:
    """One binary updates payload a sync epoch, the input of a resident
    batch's appends."""
    return [encode_changes(g) for g in doc.epoch_changes()]


def oracle_tree(doc: OpTrace, n_epochs: Optional[int] = None):
    """(parents, children) of the tree TREE_CID after the first `n_epochs`
    sync epochs (default all), by a plain replay of the moves in
    (lamport, peer, counter) order with the cycle check: parents
    {node: parent | None} of the live nodes (not under the trash), and
    children {parent | None: [live children by (position, the key of the
    move that put them there)]}.  Also the count of moves the cycle check
    rejected, as a third item."""
    state: Dict[TreeID, tuple] = {}
    rejected = 0
    for key, c in _tree_ops(doc.changes, doc.epochs, n_epochs):
        rejected += not _tree_apply(state, key, c)
    parents = {t: node[0] for t, node in state.items()}
    live = {t for t in state if _up(parents, t)[0]}
    kids: Dict[Optional[TreeID], list] = {}
    for t in live:
        kids.setdefault(parents[t], []).append((state[t][1] or b"", state[t][2], t))
    children = {p: [t for _, _, t in sorted(v, key=lambda x: (x[0], x[1]))] for p, v in kids.items()}
    return {t: parents[t] for t in live}, children, rejected


# ---- rich-text and movable-list traces -------------------------------------------

RICHTEXT_KEYS = ("bold", "italic", "color", "link")
RICHTEXT_VALUES = (True, "red", "blue", 7)
RICHTEXT_SYNC_EVERY = 1_024  # draws a sync epoch of a rich-text trace
MOVABLE_CID = ContainerID.root("list", ContainerType.MovableList)  # the list a movable trace writes
MOVABLE_SYNC_EVERY = 512  # draws a sync epoch of a movable-list trace
_HOT = 16  # a movable trace's moves and deletes favour the first _HOT positions


class _FugueSim:
    """A Fugue sequence shared by peers that each edit their own view (the
    sequence at the last sync, plus their own inserts since): element e
    has id (peer index, counter), siblings sort by (peer id, counter),
    and each view places an insert by the Fugue rule for a visible
    position (the JAX package's placement_for_visible_pos)."""

    def __init__(self, peers: Sequence[int], cap: int):
        rank = {q: r for r, q in enumerate(sorted(peers))}
        self.peers = peers
        self.sib = [rank[q] for q in peers]
        self.ids: List[Tuple[int, int]] = []
        self.key: List[int] = []
        self.lch: List[Optional[list]] = [None] * cap
        self.rch: List[Optional[list]] = [None] * cap
        self.root: List[int] = []
        self.rcount = [0] * cap
        self.views = [_View([], bytearray(cap), [0] * cap) for _ in peers]

    def id_of(self, e: int) -> Optional[ID]:
        return None if e < 0 else ID(self.peers[self.ids[e][0]], self.ids[e][1])

    def after(self, p: int, bi: int, j: int) -> Tuple[int, int, int, int]:
        """(parent, side, block, offset) of an insert directly after the
        element at (bi, j) of view p: (a, Right) if a has no right child,
        else (its successor, Left)."""
        v = self.views[p]
        a = v.blocks[bi][j]
        if v.rcount[a] == 0:
            return a, 1, bi, j + 1
        return v.successor(bi, j), 0, bi, j + 1

    def place(self, p: int, pos: int) -> Tuple[int, int, int, int]:
        """after() the visible element pos - 1 of view p; at position 0,
        (first element, Left), or (the root, Right) in an empty view."""
        v = self.views[p]
        if pos == 0:
            return (v.blocks[0][0], 0, 0, 0) if v.blocks[0] else (-1, 1, 0, 0)
        return self.after(p, *v.find(pos - 1))

    def add(self, p: int, ctr: int, where: Tuple[int, int, int, int], visible: bool = True) -> int:
        """A new element (p, ctr) at a place() of view p."""
        parent, side, bi, j = where
        e = len(self.ids)
        self.ids.append((p, ctr))
        self.key.append((self.sib[p] << 32) | ctr)
        if parent < 0:
            bisect.insort(self.root, e, key=self.key.__getitem__)
        else:
            kids = self.rch if side else self.lch
            kids[parent] = kids[parent] or []
            bisect.insort(kids[parent], e, key=self.key.__getitem__)
            if side:
                self.rcount[parent] += 1
                self.views[p].rcount[parent] += 1
        self.views[p].insert_at(bi, j, e, visible)
        return e

    def sync(self, visible: bytearray) -> None:
        """Every view becomes the merged sequence, `visible` by element."""
        order = _walk(self.root, self.lch, self.rch)
        self.views = [_View(order, bytearray(visible), list(self.rcount)) for _ in self.peers]


def _spans(ids: Sequence[Tuple[int, int]]) -> Tuple[IdSpan, ...]:
    """(peer id, counter) ids as IdSpans, consecutive counters merged."""
    out: List[IdSpan] = []
    for peer, ctr in ids:
        if out and out[-1].peer == peer and out[-1].end == ctr:
            out[-1] = IdSpan(peer, out[-1].start, ctr + 1)
        else:
            out.append(IdSpan(peer, ctr, ctr + 1))
    return tuple(out)


def _cached_trace(kind: str, params: dict, make) -> OpTrace:
    """make() -> OpTrace, cached under build/tracegen/ as its payload,
    change epochs and peers (keyed by the generator version and every
    parameter); a cached trace's changes are the payload decoded."""
    params = {"kind": kind, "version": GENERATOR_VERSION, **params}
    path = CACHE_DIR / f"{kind}_{hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]}.npz"
    if path.exists():
        try:
            z = np.load(path)
            if json.loads(str(z["params"])) == params:
                return OpTrace(tuple(int(q) for q in z["peers"]), decode_changes(z["payload"].tobytes()),
                               z["epochs"].tolist(), int(z["n_ops"]))
        except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
            pass  # stale or truncated cache: regenerate
    doc = make()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, payload=np.frombuffer(encode_changes(doc.changes), np.uint8),
             epochs=np.asarray(doc.epochs, np.int64), peers=np.asarray(doc.peers, np.uint64),
             n_ops=np.int64(doc.n_ops), params=np.asarray(json.dumps(params, sort_keys=True)))
    tmp.replace(path)
    return doc


def richtext_doc(seed: int, n_chars: int = 12_288, n_marks: int = 768,
                 sync_every: int = RICHTEXT_SYNC_EVERY) -> OpTrace:
    """A concurrent rich-text history on the root text TEXT_CID, the shape
    of the JAX package's bench_utils.richtext_bench_docs: 3 peers
    (random u64 ids, one past 2^63) in windows of 16-128 draws each, a
    full sync every `sync_every` draws.  A draw is a mark when r < 0.12
    and the peer's text has 2 chars (always, once the chars are used
    up): [s, e) of up to 64 chars, a key of RICHTEXT_KEYS, 30 % unmarks
    (value None), else a value of RICHTEXT_VALUES; else a delete of 1-4
    chars when the text has more than 8 and r < 0.18; else an insert run
    of 1-8 chars of "abcdefgh " at a random position.  The draws go on
    until n_chars chars and n_marks marks are made.  Placement is the
    Fugue rule on the peer's view (anchors and tombstones included); a
    mark's start anchor goes where an insert at s would, its end anchor
    directly after the char at e - 1 (TextHandler.mark), at the next
    counter.  n_ops: chars + deleted chars + 2 a mark (the JAX bench's
    count).  Cached under build/tracegen/."""

    def make() -> OpTrace:
        rng = random.Random(seed)
        peers = _peer_ids(rng, 3)
        cap = n_chars + 2 * n_marks
        sim = _FugueSim(peers, cap)
        dead = bytearray(cap)  # deleted chars, and every anchor: invisible after a sync
        st = {"chars": n_chars, "marks": n_marks, "epoch": 0, "n_ops": 0}

        def op(i: int, p: int, ctr: int, _lam: int):
            if i // sync_every != st["epoch"]:
                sim.sync(bytearray(1 - x for x in dead))
                st["epoch"] = i // sync_every
            v = sim.views[p]
            n_vis = v.nvis
            r = rng.random()
            if st["marks"] and n_vis >= 2 and (st["chars"] == 0 or r < 0.12):
                s = rng.randrange(n_vis - 1)
                e = rng.randint(s + 1, min(n_vis, s + 1 + rng.randint(1, 64)))
                key = rng.choice(RICHTEXT_KEYS)
                value = None if rng.random() < 0.3 else rng.choice(RICHTEXT_VALUES)
                start = sim.place(p, s)
                dead[sim.add(p, ctr, start, visible=False)] = 1
                end = sim.after(p, *v.find(e - 1))
                dead[sim.add(p, ctr + 1, end, visible=False)] = 1
                st["marks"] -= 1
                st["n_ops"] += 2
                return [(TEXT_CID, SeqInsert(sim.id_of(start[0]), Side(start[1]), StyleAnchor(key, value, True))),
                        (TEXT_CID, SeqInsert(sim.id_of(end[0]), Side(end[1]), StyleAnchor(key, value, False)))]
            if n_vis > 8 and r < 0.18:
                q = rng.randrange(n_vis - 1)
                gone = [v.delete_at(*v.find(q)) for _ in range(min(rng.randint(1, 4), n_vis - q))]
                for x in gone:
                    dead[x] = 1
                st["n_ops"] += len(gone)
                return TEXT_CID, SeqDelete(_spans([(peers[sim.ids[x][0]], sim.ids[x][1]) for x in gone]))
            if st["chars"]:
                run = min(rng.randint(1, 8), st["chars"])
                pos = rng.randint(0, n_vis)
                text = "".join(rng.choice("abcdefgh ") for _ in range(run))
                first = sim.place(p, pos)
                sim.add(p, ctr, first)
                for k in range(1, run):  # the run's right spine: each char after the last
                    sim.add(p, ctr + k, sim.place(p, pos + k))
                st["chars"] -= run
                st["n_ops"] += run
                return TEXT_CID, SeqInsert(sim.id_of(first[0]), Side(first[1]), text)
            return []

        changes, epochs = _windowed_changes(rng, peers, 1 << 62, sync_every, op, window=(16, 128),
                                            done=lambda: not (st["chars"] or st["marks"]))
        return OpTrace(peers, changes, epochs, st["n_ops"])

    params = {"seed": seed, "n_chars": n_chars, "n_marks": n_marks, "sync_every": sync_every}
    return _cached_trace("richtext", params, make)


def richtext_payload(doc: OpTrace) -> bytes:
    """The binary updates payload of the whole history."""
    return encode_changes(doc.changes)


def richtext_epoch_payloads(doc: OpTrace) -> List[bytes]:
    """One binary updates payload a sync epoch, the input of a resident
    batch's appends."""
    return [encode_changes(g) for g in doc.epoch_changes()]


def _seq_nodes(doc: OpTrace, cid: ContainerID, n_epochs: Optional[int]):
    """The Fugue tree of sequence container `cid` after the first
    n_epochs sync epochs: (ids [(peer, counter)] by node, payload by node
    (a char, a value, a StyleAnchor or a MovableMove), lamport by node,
    the in-order walk, deleted ids, the container's other ops as (peer,
    lamport, content)).  Siblings sort by (peer id, counter)."""
    ids: List[Tuple[int, int]] = []
    node_of: Dict[Tuple[int, int], int] = {}
    links: List[Tuple[Optional[Tuple[int, int]], int]] = []  # (parent id, side) by node
    items: list = []
    lams: List[int] = []
    deleted = set()
    other = []
    for ch, ep in zip(doc.changes, doc.epochs):
        if n_epochs is not None and ep >= n_epochs:
            break
        for op in ch.ops:
            if op.container != cid:
                continue
            c = op.content
            lam = ch.lamport + op.counter - ch.ctr_start
            if isinstance(c, (SeqInsert, MovableMove)):  # a move makes a slot too
                body = list(c.content) if isinstance(c, SeqInsert) and not isinstance(c.content, StyleAnchor) else [
                    c.content if isinstance(c, SeqInsert) else c]
                if isinstance(c.parent, _RunCont):
                    parent = (ch.peer, op.counter - 1)
                else:
                    parent = None if c.parent is None else (c.parent.peer, c.parent.counter)
                for j, x in enumerate(body):
                    node_of[(ch.peer, op.counter + j)] = len(ids)
                    ids.append((ch.peer, op.counter + j))
                    links.append((parent, int(c.side)) if j == 0 else ((ch.peer, op.counter + j - 1), 1))
                    items.append(x)
                    lams.append(lam + j)
            elif isinstance(c, SeqDelete):
                deleted.update((sp.peer, k) for sp in c.spans for k in range(sp.start, sp.end))
            else:
                other.append((ch.peer, lam, c))
    lch: List[Optional[list]] = [None] * len(ids)
    rch: List[Optional[list]] = [None] * len(ids)
    root: List[int] = []
    for e in sorted(range(len(ids)), key=ids.__getitem__):  # siblings in (peer, counter) order
        parent, side = links[e]
        if parent is None:
            root.append(e)
            continue
        kids = rch if side else lch
        a = node_of[parent]
        kids[a] = kids[a] or []
        kids[a].append(e)
    return ids, items, lams, _walk(root, lch, rch), deleted, other


def oracle_richtext(doc: OpTrace, n_epochs: Optional[int] = None) -> List[dict]:
    """The Quill-style segments [{insert, attributes?}] of the text
    TEXT_CID after the first `n_epochs` sync epochs (default all), by a
    host walk of the element tree in order, the JAX package's
    TextState._iter_char_attrs / _resolve_attrs: a live start anchor
    opens its pair under its key, a live end anchor (p, c + 1) closes
    the open pair (p, c); each live char takes, per key, the open pair
    of the largest (lamport, peer id), unstyled where that pair's value
    is None; neighbouring chars of equal attributes merge."""
    ids, items, lams, order, deleted, _ = _seq_nodes(doc, TEXT_CID, n_epochs)
    active: Dict[str, list] = {}
    segs: List[dict] = []
    for e in order:
        x = items[e]
        peer, ctr = ids[e]
        if (peer, ctr) in deleted:
            continue
        if isinstance(x, StyleAnchor):
            if x.is_start:
                active.setdefault(x.key, []).append((lams[e], peer, x.value, ctr))
            else:
                lst = active.get(x.key, [])
                for k, ent in enumerate(lst):
                    if ent[1] == peer and ent[3] == ctr - 1:
                        del lst[k]
                        break
            continue
        attrs = {}
        for key, lst in active.items():
            if lst:
                win = max(lst, key=lambda t: (t[0], t[1]))
                if win[2] is not None:
                    attrs[key] = win[2]
        if segs and segs[-1].get("attributes") == (attrs or None):
            segs[-1]["insert"] += x
        else:
            segs.append({"insert": x, "attributes": attrs} if attrs else {"insert": x})
    return segs


def movable_doc(seed: int, n_elems: int = 4_096, n_moves: int = 2_048, n_sets: int = 1_024, n_deletes: int = 512,
                sync_every: int = MOVABLE_SYNC_EVERY) -> OpTrace:
    """A 4-peer MovableList history on the root list MOVABLE_CID: inserts
    of 1-4 values creating n_elems elements, n_moves moves, n_sets sets
    and n_deletes single-element deletes, drawn in proportion to what is
    left of each (inserts weighted by their mean run), in windows of
    16-128 draws a peer and a full sync every `sync_every` draws.  Each
    peer edits its own view, as the JAX MovableListHandler does: an
    insert or a move's new slot goes by the Fugue rule for its visible
    position, a delete tombstones the element's visible slot, a set
    names the element.  Half the moves, sets and deletes take one of the
    first _HOT positions, so peers move one element concurrently (the
    winning slot's LWW decides) and move an element another peer deletes
    (the move revives it).  Values are the map trace's tags."""

    def make() -> OpTrace:
        rng = random.Random(seed)
        peers = _peer_ids(rng, 4)
        cap = n_elems + n_moves
        sim = _FugueSim(peers, cap)
        elem_of: List[int] = []  # slot -> its element (the creating slot)
        slot_key: List[Tuple[int, int]] = []  # slot -> (lamport, peer id)
        win: Dict[int, int] = {}  # element -> winning slot, every op so far
        tomb = bytearray(cap)
        left = {"elems": n_elems, "moves": n_moves, "sets": n_sets, "deletes": n_deletes}
        st = {"epoch": 0}

        def new_slot(p: int, ctr: int, lam: int, where, elem: Optional[int]) -> int:
            slot = sim.add(p, ctr, where)
            elem = slot if elem is None else elem
            elem_of.append(elem)
            slot_key.append((lam, peers[p]))
            if elem not in win or slot_key[slot] > slot_key[win[elem]]:
                win[elem] = slot
            return slot

        def pick(n_vis: int) -> int:
            return rng.randrange(min(n_vis, _HOT)) if rng.random() < 0.5 else rng.randrange(n_vis)

        def op(i: int, p: int, ctr: int, lam: int):
            if i // sync_every != st["epoch"]:
                sim.sync(bytearray(int(win[elem_of[x]] == x and not tomb[x]) for x in range(len(elem_of)))
                             + bytearray(cap - len(elem_of)))
                st["epoch"] = i // sync_every
            v = sim.views[p]
            n_vis = v.nvis
            weights = [left["elems"] / 2.5, left["moves"] if n_vis >= 2 else 0,
                       left["sets"] if n_vis else 0, left["deletes"] if n_vis else 0]
            if not sum(weights):
                return []
            u = rng.random() * sum(weights)
            kind = max(k for k, w in enumerate(weights) if w)  # rounding past the sum
            for k, acc in enumerate(np.cumsum(weights).tolist()):
                if u < acc and weights[k]:
                    kind = k
                    break
            if kind == 0:
                run = min(rng.randint(1, 4), left["elems"])
                pos = rng.randint(0, n_vis)
                values = tuple(_random_value(rng) for _ in range(run))
                first = sim.place(p, pos)
                new_slot(p, ctr, lam, first, None)
                for k in range(1, run):  # the run's right spine
                    new_slot(p, ctr + k, lam + k, sim.place(p, pos + k), None)
                left["elems"] -= run
                return MOVABLE_CID, SeqInsert(sim.id_of(first[0]), Side(first[1]), values)
            a = pick(n_vis)
            bi, j = v.find(a)
            slot = v.blocks[bi][j]
            eid = sim.id_of(elem_of[slot])
            if kind == 2:
                left["sets"] -= 1
                return MOVABLE_CID, MovableSet(eid, _random_value(rng))
            if kind == 3:
                tomb[v.delete_at(bi, j)] = 1
                left["deletes"] -= 1
                return MOVABLE_CID, SeqDelete(_spans([(peers[sim.ids[slot][0]], sim.ids[slot][1])]))
            b = rng.randrange(n_vis - 1)
            b += b >= a  # a target position other than a
            where = sim.place(p, b if b < a else b + 1)  # placed as if the element stayed
            new_slot(p, ctr, lam, where, elem_of[slot])
            v.delete_at(*v.find(a + (b < a)))  # the old slot stops showing the element
            left["moves"] -= 1
            return MOVABLE_CID, MovableMove(eid, sim.id_of(where[0]), Side(where[1]))

        changes, epochs = _windowed_changes(rng, peers, 1 << 62, sync_every, op, window=(16, 128),
                                            done=lambda: not any(left.values()))
        return OpTrace(peers, changes, epochs, n_elems + n_moves + n_sets + n_deletes)

    params = {"seed": seed, "n_elems": n_elems, "n_moves": n_moves, "n_sets": n_sets, "n_deletes": n_deletes,
              "sync_every": sync_every}
    return _cached_trace("movable", params, make)


def movable_payload(doc: OpTrace) -> bytes:
    """The binary updates payload of the whole history."""
    return encode_changes(doc.changes)


def movable_epoch_payloads(doc: OpTrace) -> List[bytes]:
    """One binary updates payload a sync epoch, the input of a resident
    batch's appends."""
    return [encode_changes(g) for g in doc.epoch_changes()]


def oracle_movable(doc: OpTrace, n_epochs: Optional[int] = None) -> list:
    """The values of the list MOVABLE_CID after the first `n_epochs` sync
    epochs (default all), by a host walk: the slots (inserted elements
    and move destinations) in Fugue order; per element its winning slot,
    the one of the largest (lamport, peer id), and its winning value, the
    set (creation values included) of the largest (lamport, peer id); a
    slot shows its element iff it is the winner and not tombstoned."""
    ids, items, lams, order, deleted, other = _seq_nodes(doc, MOVABLE_CID, n_epochs)
    elem_of: List[Tuple[int, int]] = []
    best_slot: Dict[Tuple[int, int], Tuple[Tuple[int, int], int]] = {}
    best_value: Dict[Tuple[int, int], Tuple[Tuple[int, int], object]] = {}
    for e, (peer, ctr) in enumerate(ids):
        x = items[e]
        elem = (x.elem.peer, x.elem.counter) if isinstance(x, MovableMove) else (peer, ctr)
        elem_of.append(elem)
        k = (lams[e], peer)
        if elem not in best_slot or k > best_slot[elem][0]:
            best_slot[elem] = (k, e)
        if not isinstance(x, MovableMove) and (elem not in best_value or k > best_value[elem][0]):
            best_value[elem] = (k, x)
    for peer, lam, c in other:
        if isinstance(c, MovableSet):
            elem = (c.elem.peer, c.elem.counter)
            if elem not in best_value or (lam, peer) > best_value[elem][0]:
                best_value[elem] = ((lam, peer), c.value)
    return [best_value[elem_of[e]][1] for e in order
            if best_slot[elem_of[e]][1] == e and ids[e] not in deleted]


def oracle_export(changes, vv) -> List[int]:
    """What a pull from version vector `vv` (a VersionVector, or a dict
    peer -> end counter; an absent peer reads 0) exports of a document's
    stored changes: `changes` is their list, or their lists by epoch,
    concatenated in order.  Returns the positions in that concatenation of
    every change whose ctr_end is above vv[peer], ordered as
    OpLog.changes_since exports them, by (lamport + max(0, f - ctr_start),
    peer, max(ctr_start, f)) with f = vv[peer]: a change the pull half
    holds exports trimmed to its unknown tail.  A plain walk, for changes
    that never repeat a counter (what an index fed them stores as they
    are)."""
    flat = [ch for group in changes for ch in group] if changes and isinstance(changes[0], list) else list(changes)
    keyed = []
    for i, ch in enumerate(flat):
        f = vv.get(ch.peer) or 0
        if ch.ctr_end > f:
            keyed.append(((ch.lamport + max(0, f - ch.ctr_start), ch.peer, max(ch.ctr_start, f)), i))
    return [i for _, i in sorted(keyed)]


# -- LoroDoc-made fleets --------------------------------------------------------

RICH_CID = ContainerID.root("rich", ContainerType.Text)  # the rich text of a LoroDoc-made doc
LIST_CID = ContainerID.root("l", ContainerType.List)  # its list (scalars and nested texts)
COUNTER_CIDS = tuple(ContainerID.root(f"c{i}", ContainerType.Counter) for i in range(2))
LORO_FLEET_PEERS = 3
# counter steps: every sum of them is exact in float32, the device
# counter's precision
_COUNTER_STEPS = (1, 2, 3, -1, 0.5, -0.25)


@dataclass
class LoroFleetDoc:
    """One document of a LoroDoc-made fleet: `epochs`, one
    envelope-stripped updates payload a sync round (what peer 0 learnt
    that round, trimmed to what it did not know: the deltas a resident
    batch appends), and `doc`, peer 0 after the last round (it holds the
    whole history and is the host oracle)."""

    epochs: List[bytes]
    doc: object  # a LoroDoc

    def payload(self) -> bytes:
        """The whole history as one envelope-stripped updates payload."""
        from .doc import strip_envelope

        return strip_envelope(self.doc.export_updates())

    def changes(self) -> List[Change]:
        return decode_changes(self.payload())


def loro_fleet(seed: int, n_docs: int, n_rounds: int = 6, max_edits: int = 10) -> List[LoroFleetDoc]:
    """n_docs seeded random 3-peer LoroDoc histories over all six container
    kinds: each round every peer makes 1 to max_edits random edits on the
    text TEXT_CID, the rich text RICH_CID (inserts, deletes, marks and
    unmarks), the MovableList MOVABLE_CID (inserts, moves, sets,
    deletes), the tree TREE_CID (creates, moves that may form cycles,
    deletes; fractional indexes on), the counters COUNTER_CIDS, the map
    MAP_CID (sets of every scalar tag, deletes) and the list LIST_CID
    (scalars and nested texts), then commits; two random one-way syncs
    follow, and peer 0 pulls every other peer.  Concurrent edits between
    syncs make concurrent siblings, moves and sets as between real
    replicas."""
    from .core.version import VersionVector
    from .doc import LoroDoc, strip_envelope

    out = []
    for di in range(n_docs):
        rng = random.Random((seed << 24) ^ (di * 0x9E3779B1))
        peers = [LoroDoc(peer=p) for p in _peer_ids(rng, LORO_FLEET_PEERS)]
        for d in peers:
            d.get_tree(TREE_CID.name).enable_fractional_index(0)
        last = VersionVector()
        epochs = []
        for _ in range(n_rounds):
            for d in peers:
                for _ in range(rng.randint(1, max_edits)):
                    _loro_edit(rng, d)
                d.commit()
            for _ in range(2):
                a, b = rng.sample(range(LORO_FLEET_PEERS), 2)
                peers[b].import_(peers[a].export_updates(peers[b].oplog_vv()))
            for d in peers[1:]:
                peers[0].import_(d.export_updates(peers[0].oplog_vv()))
            epochs.append(strip_envelope(peers[0].export_updates(last)))
            last = peers[0].oplog_vv()
        out.append(LoroFleetDoc(epochs, peers[0]))
    return out


def _loro_edit(rng: random.Random, d) -> None:
    """One random edit of LoroDoc `d` on one of loro_fleet's containers."""
    u = rng.random()
    if u < 0.3:
        t = d.get_text(TEXT_CID.name if u < 0.18 else RICH_CID.name)
        n = len(t)
        v = rng.random()
        if u >= 0.18 and n > 2 and v < 0.25:
            a = rng.randrange(n - 1)
            b = rng.randint(a + 1, n)
            if v < 0.2:
                t.mark(a, b, rng.choice(RICHTEXT_KEYS), rng.choice(RICHTEXT_VALUES))
            else:
                t.unmark(a, b, rng.choice(RICHTEXT_KEYS))
        elif n and v < 0.5:
            pos = rng.randrange(n)
            t.delete(pos, min(rng.randint(1, 4), n - pos))
        else:
            t.insert(rng.randint(0, n), "".join(rng.choice(_CHARS) for _ in range(rng.randint(1, 6))))
    elif u < 0.46:
        ml = d.get_movable_list(MOVABLE_CID.name)
        n = len(ml)
        v = rng.random()
        if n < 2 or v < 0.4:
            ml.insert(rng.randint(0, n), _random_value(rng))
        elif v < 0.7:
            ml.move(rng.randrange(n), rng.randrange(n))
        elif v < 0.88:
            ml.set(rng.randrange(n), _random_value(rng))
        else:
            ml.delete(rng.randrange(n), 1)
    elif u < 0.64:
        tr = d.get_tree(TREE_CID.name)
        nodes = tr.nodes()
        v = rng.random()
        if len(nodes) < 3 or v < 0.4:
            tr.create(rng.choice(nodes) if nodes and rng.random() < 0.7 else None)
        elif v < 0.9:  # under its own subtree this is a cycle the merge rejects
            tr.move(rng.choice(nodes), rng.choice(nodes + [None]))
        else:
            tr.delete(rng.choice(nodes))
    elif u < 0.74:
        d.get_counter(rng.choice(COUNTER_CIDS).name).increment(rng.choice(_COUNTER_STEPS))
    elif u < 0.9:
        m = d.get_map(MAP_CID.name)
        key = f"k{rng.randrange(12)}"
        if rng.random() < 0.85:
            m.set(key, _random_value(rng))
        else:
            m.delete(key)
    else:
        ll = d.get_list(LIST_CID.name)
        n = len(ll)
        v = rng.random()
        if n and v < 0.25:
            ll.delete(rng.randrange(n), 1)
        elif v < 0.4:
            ll.insert_container(rng.randint(0, n), ContainerType.Text).insert(0, rng.choice(["nested", "x", "é"]))
        else:
            ll.insert(rng.randint(0, n), _random_value(rng))
