"""The port's entry points: the element-level merge of a small example
batch, the counterpart of ``__graft_entry__.entry()``, and the
multi-device dry run over a ("docs", "ops") mesh, the counterpart of
``__graft_entry__.dryrun_multichip()``.

    fn, (cols,) = entry()
    codes, counts = fn(cols)                # on the card
    codes, counts = fn(cols, device="cpu")  # the plain torch versions
    dryrun_multichip(8)                     # a 4 x 2 mesh of the visible cards, cycled
    dryrun_multichip(8, device="cpu")       # a 4 x 2 mesh of the host
"""
from __future__ import annotations

import numpy as np

from .device import DeviceLike
from .ops.fugue_batch import SeqColumns, materialize_content_batch, seq_columns_to_torch
from .parallel.mesh import Mesh, make_mesh


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


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> Mesh:
    """One step of each of the fleet's parallel paths over a mesh of
    ``n_devices`` entries, each checked against its host oracle (an
    AssertionError names the one that disagrees, under -O too); returns
    the mesh.  The entries are the visible cards, cycled
    (``device="cuda"``: eight entries on one card are that card eight
    times), or ``device`` itself repeated; op_parallel is 2 when
    n_devices is even, else 1.  The docs
    axis is document batching, the ops axis the op rows of one doc batch;
    there is no weight matrix to split, no layer pipeline and no experts.

    1. the element merge, doc-sharded (shard_doc_batch, then
       materialize_content_batch a row), two docs a row;
    2. Fleet(mesh=).merge_map_docs_sharded against LoroDoc map values;
    3. make_ring_rank_sharded ("wyllie" and "blocked") against _wyllie_dist;
    4. a ResidentServer on the mesh's lead device: ingest, auto-grow past
       capacity 32, compaction at acked floors, checkpoint and restore,
       texts against the LoroDocs;
    5. a ShardedResidentServer over the mesh's rows: ingest, texts, one
       migration that changes no text."""
    import torch

    from .device import resolve_device
    from .doc import LoroDoc, strip_envelope
    from .errors import ConfigError
    from .ops.columnar import extract_map_ops
    from .ops.fugue_batch import _wyllie_dist, make_ring_rank_sharded
    from .parallel.fleet import Fleet
    from .parallel.mesh import DOC_AXIS, shard_doc_batch
    from .parallel.server import ResidentServer
    from .parallel.sharded import ShardedResidentServer

    if not isinstance(n_devices, int) or isinstance(n_devices, bool) or n_devices < 1:
        raise ConfigError("n_devices", n_devices, "positive integer")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    op_par = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh([cards[i % len(cards)] for i in range(n_devices)], op_parallel=op_par)
    rows = mesh.shape[DOC_AXIS]
    d = rows * 2  # two docs a doc-axis row
    lead = mesh.lead

    # 1. the element merge, doc-sharded
    n = 64
    parts = [materialize_content_batch(c, device=c.parent.device) for c in shard_doc_batch(mesh, example_cols(d, n))]
    codes = torch.cat([p[0].to(lead) for p in parts]).cpu().numpy()
    counts = torch.cat([p[1].to(lead) for p in parts]).cpu().numpy()
    ctr = np.arange(n)
    want = (ctr[ctr % 7 != 6] % 26 + 97).tolist()
    for i in range(d):
        _check(int(counts[i]) == len(want) and codes[i, : len(want)].tolist() == want,
               f"doc-sharded merge doc {i} != its text")

    # 2. the op-axis-sharded LWW merge against the LoroDocs
    fleet = Fleet(mesh=mesh)
    maps = []
    for i in range(d):
        a, b = LoroDoc(peer=2 * i + 1), LoroDoc(peer=2 * i + 2)
        for x in (a, b):
            for k in "abcd":
                x.get_map("m").set(k, f"{x.peer}:{k}")
            x.commit()
        a.import_(b.export_updates(a.oplog_vv()))
        b.import_(a.export_updates(b.oplog_vv()))
        maps.append(a)
    got = fleet.merge_map_docs_sharded([extract_map_ops(x.oplog.changes_in_causal_order()) for x in maps])
    for i, x in enumerate(maps):
        _check(got[i] == x.get_map("m").get_value(), f"sharded LWW merge doc {i} != the LoroDoc's map")

    # 3. the op-axis-sharded ring rank against pointer doubling
    m = 128
    rng = np.random.default_rng(5)
    succ = np.zeros((d, m), np.int32)
    for i in range(d):
        p = rng.permutation(m).astype(np.int32)
        succ[i] = np.arange(m, dtype=np.int32)
        succ[i][p[:-1]] = p[1:]
    want_d = _wyllie_dist(torch.from_numpy(succ))
    for algo in ("wyllie", "blocked"):
        dist = make_ring_rank_sharded(mesh, m, algo)(succ)
        _check(torch.equal(dist.cpu(), want_d), f"op-sharded ranking ({algo}) != _wyllie_dist")

    # 4. the resident lifecycle on the mesh's lead device
    srv = ResidentServer("text", n_docs=d, device=lead, capacity=32)
    text_docs = []
    for i in range(d):
        x = LoroDoc(peer=100 + i)
        x.get_text("t").insert(0, f"doc {i} resident base ")
        x.commit()
        text_docs.append(x)
        srv.register_replica(i, "r0")
    cid_t = text_docs[0].get_text("t").id
    e = srv.ingest([strip_envelope(x.export_updates({})) for x in text_docs], cid_t)
    updates = []
    for i, x in enumerate(text_docs):
        srv.ack(i, "r0", e)
        vv = x.oplog_vv()
        x.get_text("t").insert(0, "grown past the bucket ")  # crosses capacity 32
        x.get_text("t").delete(0, 6)
        x.commit()
        updates.append(strip_envelope(x.export_updates(vv)))
    e2 = srv.ingest(updates, cid_t)
    _check(srv.batch.cap > 32, "auto-grow did not repack")
    for i in range(d):
        srv.ack(i, "r0", e2)
    _check(srv.compact() > 0, "acked floors reclaimed nothing")
    blob = srv.checkpoint()
    srv.close()
    srv = ResidentServer.restore(blob, device=lead)
    texts = [x.get_text("t").to_string() for x in text_docs]
    _check(srv.batch.texts() == texts, "resident texts after restore != the LoroDocs'")
    srv.close()

    # 5. the sharded resident fleet over the mesh's rows, one migration
    n_shards = next((k for k in range(max(1, rows // 2), 0, -1) if rows % k == 0), 1)
    sharded = ShardedResidentServer("text", d, shards=n_shards, devices=mesh, capacity=128)
    try:
        e = sharded.ingest([strip_envelope(x.export_updates({})) for x in text_docs], cid_t)
        _check(e == 1 and sharded.epoch == 1, f"sharded fleet epoch {e}, {sharded.epoch} != 1")
        _check(sharded.texts() == texts, "sharded fleet texts != the LoroDocs'")
        if n_shards > 1:
            src = sharded.placement.place(0)[0]
            sharded.migrate(0, (src + 1) % n_shards)
            _check(sharded.texts() == texts, "migration changed served state")
    finally:
        sharded.close()
    return mesh


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")
