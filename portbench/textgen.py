"""Frozen copy of the port's automerge-perf-shaped text generator and of
the encoder it needs (``loro_tpu_torch/tracegen.py`` and the text part of
``loro_tpu_torch/codec/binary.py``), so that the benchmark's inputs do
not move when the program changes.  ``tests/test_portbench_textgen.py``
holds its payloads byte-equal to the port's at a small size.

``automerge_like_patches`` draws one author's patch stream with the
automerge-perf trace's counts (182,315 inserts and 77,463 deletes at full
length) and edit positions of its own drawing, not the trace's.
``concurrent_events`` replays a stream over concurrent peers (windows of
32-256 patches a peer, a full sync every ``sync_every`` patches), each
peer placing its inserts with the Fugue rule against its own view, and
returns the event log in apply order.  ``history_payload`` encodes the
whole log as one binary updates payload.

This module imports nothing of the program.
"""
from __future__ import annotations

import bisect
import random
import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

AUTOMERGE_PERF_INSERTS = 182_315
AUTOMERGE_PERF_DELETES = 77_463
AUTOMERGE_PERF_PATCHES = AUTOMERGE_PERF_INSERTS + AUTOMERGE_PERF_DELETES  # 259,778
TEXT_CID_NAME = "text"  # the root text container every payload writes
CONTAINER_TEXT = 2  # ContainerType.Text on the wire
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
    insert/delete counts keep the automerge-perf ratio exactly."""
    ins_left = round(n_patches * AUTOMERGE_PERF_INSERTS / AUTOMERGE_PERF_PATCHES)
    del_left = n_patches - ins_left
    rng = random.Random(seed)
    pos = np.empty(n_patches, np.int64)
    ins = np.empty(n_patches, bool)
    chars = np.empty(n_patches, np.int32)
    length = cursor = 0
    i = 0
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
    block for the k-th-visible lookup and a cursor cache."""

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

    def insert_at(self, bi: int, j: int, e: int) -> None:
        blk = self.blocks[bi]
        blk.insert(j, e)
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


class History(NamedTuple):
    """One generated document: its event log (EVENT_FIELDS -> int32
    [n_ops], apply order, peers as ranks), the peer id of each rank, the
    patches applied and the generator's own text of the final state."""

    events: Dict[str, np.ndarray]
    peers: List[int]
    n_ops: int
    text: str


def concurrent_events(patches, n_peers: int = 4, sync_every: int = 4000, seed: int = 0,
                      peer_base: int = 1 << 8) -> History:
    """Replay one author's patch stream over `n_peers` concurrent peers
    (peer ids peer_base + 1 + i).  A delete past a peer's visible length
    is dropped."""
    pos_a, ins_a, ch_a = patches
    cap = int(ins_a.sum())
    rng = random.Random(seed)
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
            e = len(peer)
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
    # table holds those only)
    ev = np.asarray(log, np.int32).reshape(-1, len(EVENT_FIELDS))
    active = np.unique(ev[:, EVENT_FIELDS.index("peer")])
    rank = np.full(n_peers + 1, -1, np.int32)  # rank[-1] = -1: the root
    rank[active] = np.arange(len(active), dtype=np.int32)
    for f in ("peer", "ref_peer"):
        ev[:, EVENT_FIELDS.index(f)] = rank[ev[:, EVENT_FIELDS.index(f)]]
    events = {f: np.ascontiguousarray(ev[:, k]) for k, f in enumerate(EVENT_FIELDS)}
    return History(events, [peer_base + 1 + int(i) for i in active], n_applied, text)


# ---- changes and their encoding ------------------------------------------------

Id = Tuple[int, int]  # (peer id, counter)


class TextInsert(NamedTuple):
    """Insert `text` as a right spine under `parent` (None = the root) on
    `side`; the op consumes len(text) counters."""

    parent: Optional[Id]
    side: int
    text: str


class TextDelete(NamedTuple):
    """Tombstone the elements of `spans`, (peer id, start, end) counter
    ranges; the op consumes one counter."""

    spans: Tuple[Tuple[int, int, int], ...]


class TextChange(NamedTuple):
    peer: int
    ctr_start: int
    lamport: int
    timestamp: int
    deps: Tuple[Id, ...]
    ops: Tuple[object, ...]


def epoch_changes(events: Dict[str, np.ndarray], peers: Sequence[int]) -> List[Tuple[int, TextChange]]:
    """(sync epoch, change) of the event log, in apply order: a change is
    the run of one window's events within one sync epoch, and a same-peer
    right-spine typing run in it becomes one multi-character insert.
    Deps: the peer's own last op when it already changed in this epoch,
    else the last op of every peer before the epoch's sync.  Lamport = 1
    + the largest lamport among the deps."""
    ev = {f: events[f].tolist() for f in EVENT_FIELDS}
    ids = list(peers)
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
        if epoch != snap_epoch:
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
        out.append((epoch, TextChange(ids[p], ev["counter"][i], lamport, 0, deps, tuple(ops))))
        last_ctr[p] = ev["counter"][j - 1]
        last_lam[p] = lamport + last_ctr[p] - ev["counter"][i]
        changed_in_epoch[p] = True
        i = j
    return out


class _Writer:
    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)

    def varint(self, v: int) -> None:
        """LEB128 unsigned."""
        if v < 0:
            raise ValueError(f"varint of a negative value {v}")
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.buf.append(b | 0x80)
            else:
                self.buf.append(b)
                return

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1)

    def str_(self, s: str) -> None:
        b = s.encode()
        self.varint(len(b))
        self.buf += b


K_INSERT_TEXT, K_DELETE = 2, 5  # op kinds on the wire
PT_NONE, PT_ID = 0, 1  # an insert's parent: the root, or an id


def encode_text_changes(changes: Sequence[TextChange]) -> bytes:
    """The binary updates payload of text changes on the root text
    container: peer table (first-use order: each change's peer and its
    deps' peers, then the peers its ops name), an empty key table, the
    one container, the change metadata, then the ops."""
    peer_idx: Dict[int, int] = {}

    def pi(p: int) -> int:
        i = peer_idx.get(p)
        if i is None:
            i = peer_idx[p] = len(peer_idx)
        return i

    for ch in changes:
        pi(ch.peer)
        for dep in ch.deps:
            pi(dep[0])
        for op in ch.ops:
            if isinstance(op, TextInsert):
                if op.parent is not None:
                    pi(op.parent[0])
            else:
                for sp in op.spans:
                    pi(sp[0])
    ops_w = _Writer()
    for ch in changes:
        for op in ch.ops:
            ops_w.varint(0)  # the one container
            if isinstance(op, TextInsert):
                ops_w.u8(K_INSERT_TEXT)
                if op.parent is None:
                    ops_w.u8(PT_NONE)
                else:
                    ops_w.u8(PT_ID)
                    ops_w.varint(peer_idx[op.parent[0]])
                    ops_w.zigzag(op.parent[1])
                ops_w.u8(op.side)
                ops_w.str_(op.text)
            else:
                ops_w.u8(K_DELETE)
                ops_w.varint(len(op.spans))
                for peer, start, end in op.spans:
                    ops_w.varint(peer_idx[peer])
                    ops_w.zigzag(start)
                    ops_w.varint(end - start)
    w = _Writer()
    w.varint(len(peer_idx))
    for p in peer_idx:
        w.buf += struct.pack("<Q", p)
    w.varint(0)  # no keys
    w.varint(1)
    w.u8(CONTAINER_TEXT | 0x80)  # a root container: its type and name
    w.str_(TEXT_CID_NAME)
    w.varint(len(changes))
    prev_ts = 0
    for ch in changes:
        w.varint(peer_idx[ch.peer])
        w.zigzag(ch.ctr_start)
        w.zigzag(ch.lamport)
        w.zigzag(ch.timestamp - prev_ts)
        prev_ts = ch.timestamp
        w.varint(len(ch.deps))
        for dep in ch.deps:
            w.varint(peer_idx[dep[0]])
            w.zigzag(dep[1])
        w.u8(0)  # no message
        w.varint(len(ch.ops))
    w.buf += ops_w.buf
    return bytes(w.buf)


def history_payload(h: History) -> bytes:
    """The whole history as one payload."""
    return encode_text_changes([ch for _, ch in epoch_changes(h.events, h.peers)])


def peer_table(payload: bytes) -> Tuple[List[int], int]:
    """(peer ids, offset of the first id) of a payload's peer table."""
    n, shift, i = 0, 0, 0
    while True:
        b = payload[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return [int(x) for x in struct.unpack_from(f"<{n}Q", payload, i)], i


def remap_peers(payload: bytes, new_id: Dict[int, int]) -> bytes:
    """The payload with every peer id of its table replaced by
    new_id[id]: ops name peers by their index in the table, so the rest
    of the bytes stays as it is."""
    ids, off = peer_table(payload)
    return payload[:off] + struct.pack(f"<{len(ids)}Q", *(new_id[p] for p in ids)) + payload[off + 8 * len(ids):]
