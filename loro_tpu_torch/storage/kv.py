"""General ordered key-value store with an SSTable wire format: the
port's copy of loro_tpu/storage/kv.py (the resident batch's checkpoint
is made of its bytes; export_all writes what the JAX package's writes).

Reference parity: crates/kv-store (MemKvStore, lib.rs:1-143;
mem_store.rs:39-298 get/set/compare_and_swap/remove/scan/export_all/
import_all; block.rs prefix-compressed blocks; sstable.rs block metas
with lazy hydration).  Re-designed for this codebase, not translated:

  * our own wire layout (magic "LTKV"), zlib for block compression
    (the image has no LZ4) and crc32 per block (no xxhash32) — the
    same envelope/checksum family as codec/binary.py;
  * imported SSTables hydrate per block on first touch, the same lazy
    pattern as oplog/change_store.py cold blocks and snapshot v4 state
    segments;
  * one memtable (dict + sorted-key cache) over at most one imported
    table — the store is a document-scale component, not an LSM tree;
    deletes write tombstones that shadow imported entries.

Wire layout:

  "LTKV" | u8 version | u8 compression | blocks... | meta | u32 meta_off

  normal block (compressed then checksummed):
      payload = count:varint, then per pair:
          prefix_len:varint  suffix:bytes_  value:bytes_
      block bytes = compress(payload) + crc32(compressed):u32le
  large block: payload = key:bytes_ value:bytes (rest) — one pair whose
      value exceeds the block size, never split across blocks.
  meta: count:varint, then per block:
      offset:varint  length:varint  flags:u8(1=large)  first_key:bytes_
      last_key:bytes_ (omitted for large blocks — first==last)
"""
from __future__ import annotations

import bisect
import struct
import zlib
from enum import IntEnum
from typing import Dict, Iterator, List, Optional, Tuple

from ..codec.binary import Reader, Writer
from ..errors import DecodeError

MAGIC = b"LTKV"
VERSION = 1
DEFAULT_BLOCK_SIZE = 4096


class CompressionType(IntEnum):
    NONE = 0
    ZLIB = 1


_TOMBSTONE = None  # memtable value for deletes shadowing imported keys


class _Block:
    """One SSTable block: raw bytes + lazily-decoded pairs."""

    __slots__ = ("raw", "large", "first_key", "last_key", "compression", "_pairs")

    def __init__(self, raw, large, first_key, last_key, compression):
        self.raw = raw
        self.large = large
        self.first_key = first_key
        self.last_key = last_key
        self.compression = compression
        self._pairs: Optional[List[Tuple[bytes, bytes]]] = None

    def pairs(self) -> List[Tuple[bytes, bytes]]:
        if self._pairs is None:
            self._pairs = self._decode()
        return self._pairs

    def _decode(self) -> List[Tuple[bytes, bytes]]:
        if len(self.raw) < 4:
            raise DecodeError("kv block truncated")
        body, crc = self.raw[:-4], struct.unpack("<I", self.raw[-4:])[0]
        if zlib.crc32(body) != crc:
            raise DecodeError("kv block checksum mismatch")
        if self.compression == CompressionType.ZLIB:
            try:
                body = zlib.decompress(body)
            except zlib.error as e:
                raise DecodeError(f"kv block decompress failed: {e}") from None
        r = Reader(bytes(body))
        try:
            if self.large:
                key = r.bytes_()
                return [(key, bytes(r.buf[r.i :]))]
            out: List[Tuple[bytes, bytes]] = []
            prev = b""
            for _ in range(r.varint()):
                plen = r.varint()
                if plen > len(prev):
                    raise DecodeError("kv block prefix overrun")
                key = prev[:plen] + r.bytes_()
                out.append((key, r.bytes_()))
                prev = key
            return out
        except (IndexError, ValueError) as e:
            raise DecodeError(f"kv block malformed: {e}") from None


class MemKvStore:
    """Ordered byte-key/byte-value store.  All keys/values are bytes;
    iteration is lexicographic.  `export_all` emits the SSTable bytes;
    `import_all` replaces the store's imported table (lazy blocks) and
    clears the memtable."""

    def __init__(
        self,
        block_size: int = DEFAULT_BLOCK_SIZE,
        compression: CompressionType = CompressionType.ZLIB,
    ):
        self.block_size = block_size
        self.compression = CompressionType(compression)
        self._mem: Dict[bytes, Optional[bytes]] = {}
        self._mem_keys: Optional[List[bytes]] = []  # sorted; None = dirty
        self._blocks: List[_Block] = []
        self._block_first: List[bytes] = []  # bisect index over blocks

    # -- point ops -----------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        if key in self._mem:
            return self._mem[key]
        return self._sstable_get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if not isinstance(key, (bytes, bytearray)) or not isinstance(
            value, (bytes, bytearray)
        ):
            raise TypeError("MemKvStore keys and values are bytes")
        key = bytes(key)
        if key not in self._mem:
            self._mem_keys = None
        self._mem[key] = bytes(value)

    def compare_and_swap(
        self, key: bytes, old: Optional[bytes], new: bytes
    ) -> bool:
        if self.get(key) != old:
            return False
        self.set(key, new)
        return True

    def remove(self, key: bytes) -> None:
        key = bytes(key)
        if self._sstable_get(key) is not None:
            if key not in self._mem:
                self._mem_keys = None
            self._mem[key] = _TOMBSTONE  # shadow the imported pair
        else:
            if key in self._mem:
                self._mem_keys = None
            self._mem.pop(key, None)

    def contains_key(self, key: bytes) -> bool:
        return self.get(key) is not None

    # -- iteration -----------------------------------------------------
    def scan(
        self,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Yield (key, value) with start <= key < end, ordered (or
        reversed) lexicographically, memtable entries shadowing
        imported ones."""
        mem_iter = self._mem_range(start, end, reverse)
        sst_iter = self._sstable_range(start, end, reverse)
        a = next(mem_iter, None)
        b = next(sst_iter, None)
        while a is not None or b is not None:
            if b is None:
                pick_mem = True
            elif a is None:
                pick_mem = False
            elif a[0] == b[0]:
                b = next(sst_iter, None)  # memtable shadows
                continue
            else:
                pick_mem = (a[0] < b[0]) != reverse
            if pick_mem:
                if a[1] is not _TOMBSTONE:
                    yield a
                a = next(mem_iter, None)
            else:
                yield b
                b = next(sst_iter, None)

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        return self.scan()

    def __len__(self) -> int:
        n = sum(1 for _ in self.scan())
        return n

    def len(self) -> int:
        return len(self)

    def is_empty(self) -> bool:
        return next(self.scan(), None) is None

    def size(self) -> int:
        """Approximate byte size of live pairs."""
        return sum(len(k) + len(v) for k, v in self.scan())

    # -- export / import ----------------------------------------------
    def export_all(self) -> bytes:
        w = Writer()
        w.buf += MAGIC
        w.u8(VERSION)
        w.u8(int(self.compression))
        metas: List[Tuple[int, int, bool, bytes, bytes]] = []

        def flush(pairs: List[Tuple[bytes, bytes]]) -> None:
            if not pairs:
                return
            body = Writer()
            body.varint(len(pairs))
            prev = b""
            for k, v in pairs:
                p = _common_prefix_len(prev, k)
                body.varint(p)
                body.bytes_(k[p:])
                body.bytes_(v)
                prev = k
            raw = self._compress(bytes(body.buf))
            metas.append((len(w.buf), len(raw) + 4, False, pairs[0][0], pairs[-1][0]))
            w.buf += raw
            w.u32le(zlib.crc32(raw))

        pending: List[Tuple[bytes, bytes]] = []
        pending_sz = 0
        for k, v in self.scan():
            if len(v) > self.block_size:
                flush(pending)
                pending, pending_sz = [], 0
                body = Writer()
                body.bytes_(k)
                body.buf += v
                raw = self._compress(bytes(body.buf))
                metas.append((len(w.buf), len(raw) + 4, True, k, k))
                w.buf += raw
                w.u32le(zlib.crc32(raw))
                continue
            pending.append((k, v))
            pending_sz += len(k) + len(v) + 4
            if pending_sz >= self.block_size:
                flush(pending)
                pending, pending_sz = [], 0
        flush(pending)

        meta_off = len(w.buf)
        if meta_off >= 2**32:
            # the v1 trailer is a fixed u32le; block metas are varints,
            # so only the trailer caps the format at 4 GiB of blocks
            raise ValueError(
                f"LTKV v1 store exceeds the 4 GiB trailer limit "
                f"(blocks span {meta_off} bytes); split the store"
            )
        w.varint(len(metas))
        for off, ln, large, first, last in metas:
            w.varint(off)
            w.varint(ln)
            w.u8(1 if large else 0)
            w.bytes_(first)
            if not large:
                w.bytes_(last)
        w.u32le(meta_off)
        return bytes(w.buf)

    def import_all(self, data: bytes) -> None:
        """Replace store contents with the SSTable (blocks stay encoded
        until first touch; metas and checking are eager)."""
        if len(data) < 10 or data[:4] != MAGIC:
            raise DecodeError("not an LTKV store")
        version = data[4]
        if version > VERSION:
            raise DecodeError(f"LTKV v{version} newer than supported v{VERSION}")
        try:
            compression = CompressionType(data[5])
        except ValueError:
            raise DecodeError(f"unknown LTKV compression {data[5]}") from None
        (meta_off,) = struct.unpack("<I", data[-4:])
        if not 6 <= meta_off <= len(data) - 4:
            raise DecodeError("LTKV meta offset out of range")
        r = Reader(data[meta_off : len(data) - 4])
        blocks: List[_Block] = []
        try:
            n = r.varint()
            for _ in range(n):
                off = r.varint()
                ln = r.varint()
                large = r.u8() == 1
                first = r.bytes_()
                last = first if large else r.bytes_()
                if not 6 <= off <= off + ln <= meta_off:
                    raise DecodeError("LTKV block span out of range")
                blocks.append(_Block(data[off : off + ln], large, first, last, compression))
            if not r.eof():
                raise DecodeError("LTKV trailing meta bytes")
        except (IndexError, ValueError) as e:
            raise DecodeError(f"LTKV meta malformed: {e}") from None
        for a, b in zip(blocks, blocks[1:]):
            if not a.last_key <= b.first_key:
                raise DecodeError("LTKV blocks out of order")
        self._mem.clear()
        self._mem_keys = []
        self._blocks = blocks
        self._block_first = [b.first_key for b in blocks]

    # -- internals -----------------------------------------------------
    def _compress(self, body: bytes) -> bytes:
        if self.compression == CompressionType.ZLIB:
            return zlib.compress(body, 6)
        return body

    def _mem_sorted(self) -> List[bytes]:
        if self._mem_keys is None:
            self._mem_keys = sorted(self._mem)
        return self._mem_keys

    def _mem_range(self, start, end, reverse) -> Iterator[Tuple[bytes, Optional[bytes]]]:
        ks = self._mem_sorted()
        lo = bisect.bisect_left(ks, start) if start is not None else 0
        hi = bisect.bisect_left(ks, end) if end is not None else len(ks)
        rng = range(hi - 1, lo - 1, -1) if reverse else range(lo, hi)
        for i in rng:
            yield ks[i], self._mem[ks[i]]

    def _block_idx_for(self, key: bytes) -> int:
        """Index of the block that may contain key, or -1."""
        i = bisect.bisect_right(self._block_first, key) - 1
        if i < 0 or key > self._blocks[i].last_key:
            return -1
        return i

    def _sstable_get(self, key: bytes) -> Optional[bytes]:
        i = self._block_idx_for(key)
        if i < 0:
            return None
        pairs = self._blocks[i].pairs()
        j = bisect.bisect_left(pairs, (key, b""))
        if j < len(pairs) and pairs[j][0] == key:
            return pairs[j][1]
        return None

    def _sstable_range(self, start, end, reverse) -> Iterator[Tuple[bytes, bytes]]:
        if not self._blocks:
            return
        lo_b = 0
        if start is not None:
            lo_b = max(0, bisect.bisect_right(self._block_first, start) - 1)
            if start > self._blocks[lo_b].last_key:
                lo_b += 1
        hi_b = len(self._blocks)
        if end is not None:
            hi_b = bisect.bisect_right(self._block_first, end)
        rng = range(hi_b - 1, lo_b - 1, -1) if reverse else range(lo_b, hi_b)
        for bi in rng:
            pairs = self._blocks[bi].pairs()
            it = reversed(pairs) if reverse else iter(pairs)
            for k, v in it:
                if start is not None and k < start:
                    continue
                if end is not None and k >= end:
                    continue
                yield k, v

    # test/diagnostic hook: how many imported blocks were ever decoded
    @property
    def decoded_blocks(self) -> int:
        return sum(1 for b in self._blocks if b._pairs is not None)

    @property
    def n_blocks(self) -> int:
        return len(self._blocks)


def _common_prefix_len(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i
