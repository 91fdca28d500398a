"""Block-chunked lazy change store.

reference: crates/loro-internal/src/oplog/change_store.rs:41-65 (change
blocks target ~4KB, keyed (peer, counter), lazily parsed) and
crates/kv-store (SSTable-style blocks, LZ4 + checksum per block).

Device-first design: history is cold data for the merge engine — the
device path consumes columnar extracts, not Change objects — so the
store's job is (a) cheap snapshot export (reuse already-compressed
blocks without re-encoding), (b) cheap import (attach block headers +
dag metadata without decoding op payloads), and (c) per-peer lazy
hydration when replay/diff actually needs ops.

Layout (BlockStore.encode):
  varint n_blocks
  per block:
    u64le peer, zigzag ctr_start, zigzag ctr_end
    varint n_changes
    change meta (relative to block): per change
      zigzag ctr_start delta, varint atom_len, varint lamport delta?
      -> see _encode_block_meta: explicit (ctr_start, ctr_end, lamport,
         deps) so the dag attaches without touching the payload
    u32le crc32 of compressed payload
    varint len + bytes: zlib(encode_changes(block changes))

Compression is zlib (the stdlib's LZ77; reference uses LZ4 — same
role, no extra dependency) with a per-block crc32 (reference:
xxhash32).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

from ..core.change import Change
from ..core.ids import ID
from ..core.version import Frontiers

# target uncompressed payload bytes per block (reference: 4KB;
# change_store.rs:41-44 — 128B in its tests)
BLOCK_TARGET = 4096


class Block:
    """One sealed change block: compressed payload + enough metadata
    (spans, lamports, deps) to register in the AppDag without decode."""

    __slots__ = (
        "peer",
        "ctr_start",
        "ctr_end",
        "metas",
        "raw",
        "crc",
        "_changes",
    )

    def __init__(
        self,
        peer: int,
        ctr_start: int,
        ctr_end: int,
        metas: List[Tuple[int, int, int, Tuple[ID, ...]]],
        raw: bytes,
        crc: int,
        changes: Optional[List[Change]] = None,
    ):
        self.peer = peer
        self.ctr_start = ctr_start
        self.ctr_end = ctr_end
        # per change: (ctr_start, ctr_end, lamport, deps)
        self.metas = metas
        self.raw = raw
        self.crc = crc
        self._changes = changes

    def changes(self) -> List[Change]:
        """Decode (and cache) this block's Change list.  Raises a typed
        DecodeError on corruption — lazy blocks surface decode failures
        at first access, not import time (same trade the reference's
        lazy on-disk blocks make); the per-block crc + meta cross-check
        below bound the blast radius to this block."""
        if self._changes is None:
            from ..codec.binary import decode_changes
            from ..errors import DecodeError

            if zlib.crc32(self.raw) != self.crc:
                raise DecodeError(
                    f"change block (peer={self.peer}, ctr={self.ctr_start}) "
                    "checksum mismatch"
                )
            try:
                decoded = decode_changes(zlib.decompress(self.raw))
            except DecodeError:
                raise
            except Exception as e:
                raise DecodeError(f"malformed change block: {e}") from e
            # decoded payload must agree with the metas the dag was
            # built from at attach time
            got = [(c.ctr_start, c.ctr_end, c.lamport) for c in decoded]
            want = [(cs, ce, lam) for (cs, ce, lam, _d) in self.metas]
            if got != want:
                raise DecodeError(
                    f"change block (peer={self.peer}) payload disagrees "
                    "with its header metas"
                )
            self._changes = decoded
        return self._changes

    @property
    def is_decoded(self) -> bool:
        return self._changes is not None


def _seal(changes: List[Change]) -> Block:
    from ..codec.binary import encode_changes

    payload = encode_changes(changes)
    raw = zlib.compress(payload, 6)
    metas = [
        (ch.ctr_start, ch.ctr_end, ch.lamport, tuple(ch.deps)) for ch in changes
    ]
    return Block(
        peer=changes[0].peer,
        ctr_start=changes[0].ctr_start,
        ctr_end=changes[-1].ctr_end,
        metas=metas,
        raw=raw,
        crc=zlib.crc32(raw),
        changes=list(changes),
    )


def blocks_from_changes(changes: Iterable[Change]) -> List[Block]:
    """Seal a peer-contiguous change list into ~BLOCK_TARGET blocks."""
    out: List[Block] = []
    cur: List[Change] = []
    cur_bytes = 0
    for ch in changes:
        # rough per-change size estimate: atoms dominate (1-4 bytes per
        # atom in the columnar codec); avoid encoding twice just to size
        est = 16 + ch.atom_len() * 2 + len(ch.deps) * 10
        if cur and cur_bytes + est > BLOCK_TARGET:
            out.append(_seal(cur))
            cur, cur_bytes = [], 0
        cur.append(ch)
        cur_bytes += est
    if cur:
        out.append(_seal(cur))
    return out


class BlockStore:
    """Per-peer sealed blocks, decoded lazily per peer.

    `decoded_blocks` counts payload decodes — tests assert laziness
    with it.
    """

    def __init__(self) -> None:
        self.blocks: Dict[int, List[Block]] = {}
        self.decoded_blocks = 0

    # -- build --------------------------------------------------------
    @staticmethod
    def from_changes_by_peer(changes_by_peer: Dict[int, List[Change]]) -> "BlockStore":
        st = BlockStore()
        for peer, chs in changes_by_peer.items():
            if chs:
                st.blocks[peer] = blocks_from_changes(chs)
        return st

    # -- queries ------------------------------------------------------
    def peers(self) -> List[int]:
        return list(self.blocks.keys())

    def cold_end(self, peer: int) -> int:
        bl = self.blocks.get(peer)
        return bl[-1].ctr_end if bl else 0

    def iter_metas(self):
        """(peer, ctr_start, ctr_end, lamport, deps) for every change,
        without decoding payloads."""
        for peer, bl in self.blocks.items():
            for b in bl:
                for (cs, ce, lam, deps) in b.metas:
                    yield peer, cs, ce, lam, deps

    def changes_for_peer(self, peer: int) -> List[Change]:
        out: List[Change] = []
        for b in self.blocks.get(peer, []):
            if not b.is_decoded:
                self.decoded_blocks += 1
            out.extend(b.changes())
        return out

    def total_changes(self) -> int:
        return sum(len(b.metas) for bl in self.blocks.values() for b in bl)

    # -- wire ---------------------------------------------------------
    def encode(self) -> bytes:
        from ..codec.binary import Writer

        w = Writer()
        all_blocks = [b for bl in self.blocks.values() for b in bl]
        w.varint(len(all_blocks))
        for b in all_blocks:
            w.u64le(b.peer)
            w.zigzag(b.ctr_start)
            w.zigzag(b.ctr_end)
            w.varint(len(b.metas))
            prev_end = b.ctr_start
            for (cs, ce, lam, deps) in b.metas:
                assert cs == prev_end, "non-contiguous changes in block"
                w.varint(ce - cs)
                w.varint(lam)
                w.varint(len(deps))
                for d in deps:
                    w.u64le(d.peer)
                    w.zigzag(d.counter)
                prev_end = ce
            w.u32le(b.crc)
            w.bytes_(b.raw)
        return bytes(w.buf)

    @staticmethod
    def decode(buf: bytes) -> "BlockStore":
        from ..codec.binary import Reader

        r = Reader(buf)
        st = BlockStore()
        n_blocks = r.varint()
        if n_blocks > 1 << 26:
            raise ValueError(f"implausible block count {n_blocks}")
        for _ in range(n_blocks):
            peer = r.u64le()
            cs0 = r.zigzag()
            ce0 = r.zigzag()
            n_changes = r.varint()
            if n_changes > 1 << 22:
                raise ValueError(f"implausible change count {n_changes}")
            metas = []
            cur = cs0
            for _ in range(n_changes):
                alen = r.varint()
                lam = r.varint()
                deps = tuple(
                    ID(r.u64le(), r.zigzag()) for _ in range(r.varint())
                )
                metas.append((cur, cur + alen, lam, deps))
                cur += alen
            if cur != ce0:
                raise ValueError("block span does not match change metas")
            crc = _read_u32le(r)
            raw = r.bytes_()
            st.blocks.setdefault(peer, []).append(
                Block(peer, cs0, ce0, metas, raw, crc)
            )
        for bl in st.blocks.values():
            bl.sort(key=lambda b: b.ctr_start)
            for a, b in zip(bl, bl[1:]):
                if a.ctr_end != b.ctr_start:
                    raise ValueError("non-contiguous blocks for peer")
        return st


def _read_u32le(r) -> int:
    """A little-endian u32 from a codec.binary.Reader (whose own
    methods cover the change payload's fields only)."""
    v = struct.unpack_from("<I", r.buf, r.i)[0]
    r.i += 4
    return v
