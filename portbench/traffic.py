"""The one general traffic generator: it makes every run's documents from
the cell's configuration (``configs/<name>.json``: the document's shape),
its mix (``mixes/<name>.json``: how the documents share and are sent) and
``--seed``.

The configuration gives a document's shape: ``patches_per_doc`` (with
``inserts_per_doc`` and ``deletes_per_doc``, which the author's stream
has to match exactly), ``peers_per_doc`` and ``sync_every``, and the
author's stream: a recorded trace (``trace_file``, a gzipped editing
trace in the editing-traces JSON form, ``{"txns": [{"patches": [[pos,
n_deleted, inserted], ...]}]}``) where it names one, else the frozen
generator's seeded stream with the automerge-perf trace's counts.

The mix names a pool of base histories (``pool``: how many, and
``pool_seed``) and ``orders_per_base``: how many orders of its peers'
ids a base's documents may have. Document i is base i mod ``pool`` with
its base's order (i // ``pool``) mod ``orders_per_base``, so every run,
whatever its seed, holds the same bases in the same orders in the same
numbers. The seed draws the peer ids themselves (random 64-bit ids in
the document's order, so no two documents' payloads are byte-equal) and,
in the drivers, the order of the work: not its amount. Documents that
share a base and an order share one reference walk. The pool is made
once in a checkout and cached under ``build/portbench/data/`` (a
full-length base takes ~13 s of pure Python), so a run's data costs a
load, not a generation.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from . import textgen

DATA_VERSION = 2  # bump when textgen's output or the cache layout changes
ROOT = Path(__file__).resolve().parent.parent  # the checkout: trace files are named from here


class Base(NamedTuple):
    """One generated history and its encoding."""

    events: Dict[str, np.ndarray]
    peers: List[int]  # peer id of each rank
    history: bytes  # the whole history, one payload

    @property
    def ops(self) -> int:
        """Inserts and applied deletes."""
        return len(self.events["insert"])


class Doc(NamedTuple):
    """One document of a run: a base of the pool with peer ids of its own."""

    base: int  # index into the pool
    peer_ids: List[int]  # new peer id of each rank
    remap: Dict[int, int]  # base peer id -> new peer id


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for `seed` (any whole number) and a stream label."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def trace_patches(path: Path):
    """(pos, is_insert, char) of a recorded editing trace, one row a
    character: a patch's deletes first, then its inserted characters."""
    with gzip.open(path, "rt", encoding="utf-8") as f:
        txns = json.load(f)["txns"]
    pos: List[int] = []
    ins: List[bool] = []
    chars: List[int] = []
    for txn in txns:
        for at, n_del, text in txn["patches"]:
            pos += [at] * n_del
            ins += [False] * n_del
            chars += [0] * n_del
            pos += range(at, at + len(text))
            ins += [True] * len(text)
            chars += [ord(c) for c in text]
    return np.asarray(pos, np.int64), np.asarray(ins, bool), np.asarray(chars, np.int32)


def _author_patches(config: dict, author_seed: int):
    trace = config.get("trace_file")
    if trace:
        return trace_patches(ROOT / trace)
    return textgen.automerge_like_patches(author_seed, int(config["patches_per_doc"]))


def _pool_params(config: dict, mix: dict, b: int) -> dict:
    p = {"version": DATA_VERSION, "author_seed": int(mix["pool_seed"]) + b}
    for k in ("patches_per_doc", "inserts_per_doc", "deletes_per_doc", "peers_per_doc", "sync_every"):
        p[k] = int(config[k])
    trace = config.get("trace_file")
    if trace:
        p["trace_sha256"] = hashlib.sha256((ROOT / trace).read_bytes()).hexdigest()
    return p


def _make_base(config: dict, p: dict) -> Base:
    pos, ins, chars = _author_patches(config, p["author_seed"])
    got = (len(pos), int(ins.sum()), int((~ins).sum()))
    want = (p["patches_per_doc"], p["inserts_per_doc"], p["deletes_per_doc"])
    if got != want:
        raise ValueError(f"the author's stream has (patches, inserts, deletes) {got}; the configuration says {want}")
    h = textgen.concurrent_events((pos, ins, chars), p["peers_per_doc"], p["sync_every"], seed=p["author_seed"] * 1000 + 1)
    return Base(h.events, list(h.peers), textgen.history_payload(h))


def _save(path: Path, p: dict, base: Base) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + ".partial.npz")
    np.savez_compressed(
        tmp, params=np.asarray(json.dumps(p, sort_keys=True)), peers=np.asarray(base.peers, np.uint64),
        history=np.frombuffer(base.history, np.uint8), **{"ev_" + f: a for f, a in base.events.items()},
    )
    os.replace(tmp, path)


def _load(path: Path, p: dict) -> Optional[Base]:
    if not path.exists():
        return None
    with np.load(path) as z:
        if json.loads(str(z["params"])) != p:
            return None
        return Base({f: z["ev_" + f] for f in textgen.EVENT_FIELDS}, [int(x) for x in z["peers"]],
                    z["history"].tobytes())


def load_pool(config: dict, mix: dict, cache_dir: Path, log=lambda msg: None) -> List[Base]:
    """Every base of the mix's pool in the configuration's shape, made
    where the cache lacks it."""
    pool = []
    for b in range(int(mix["pool"])):
        p = _pool_params(config, mix, b)
        key = hashlib.sha256(json.dumps(p, sort_keys=True).encode()).hexdigest()[:16]
        path = cache_dir / f"text_{key}.npz"
        base = _load(path, p)
        if base is None:
            log(f"generating base {b} of the pool ({p['patches_per_doc']} patches) into {path.name}")
            base = _make_base(config, p)
            _save(path, p, base)
        pool.append(base)
    return pool


def make_docs(mix: dict, pool: List[Base], seed: int, n_docs: int) -> List[Doc]:
    """`n_docs` documents for `seed`: document i is base i mod len(pool),
    its peers' ids in order (i // len(pool)) mod orders_per_base of that
    base (the same orders for every seed), the ids themselves fresh from
    the seed."""
    rng = seed_rng(seed, 1)
    n_peers = len(pool[0].peers)
    fixed = seed_rng(int(mix["pool_seed"]), 3)  # the same orders for every seed
    n_orders = int(mix["orders_per_base"])
    orders = [[fixed.permutation(n_peers) for _ in range(n_orders)] for _ in pool]
    docs, seen = [], set()
    for i in range(n_docs):
        b = i % len(pool)
        while True:
            ids = np.sort(rng.integers(1, 1 << 64, size=n_peers, dtype=np.uint64, endpoint=False)).tolist()
            if len(set(ids)) == n_peers and not seen.intersection(ids):
                break
        seen.update(ids)
        order = orders[b][(i // len(pool)) % n_orders]
        new = [int(ids[order[r]]) for r in range(n_peers)]
        docs.append(Doc(b, new, dict(zip(pool[b].peers, new))))
    return docs


def history_payload(pool: List[Base], doc: Doc) -> bytes:
    return textgen.remap_peers(pool[doc.base].history, doc.remap)
