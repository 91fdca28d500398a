"""The port stands alone: loro_tpu_torch and chip_smoke.py import neither
jax nor the JAX package, and the port's entry points never drop to the
CPU on their own."""
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "loro_tpu_torch"

_BLOCKED_IMPORT = textwrap.dedent(
    """
    import importlib, pathlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "loro_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import loro_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(loro_tpu_torch.__path__, "loro_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke

    # the slice runs end to end on the CPU without jax
    from loro_tpu_torch import tracegen
    from loro_tpu_torch.ops import columnar, fugue_batch

    docs = tracegen.fleet_docs(1, n_patches=400, seed=1, use_cache=False)
    cols = columnar.stack_docs([columnar.chain_columns(d.extract, pad_n=512, pad_c=256) for d in docs])
    t = fugue_batch.chain_columns_to_torch(cols, device="cpu")
    codes, counts = fugue_batch.chain_merge_docs_v(t, device="cpu")
    for i, d in enumerate(docs):
        assert "".join(map(chr, codes[i][: int(counts[i])].tolist())) == d.text
    seq = fugue_batch.seq_columns_to_torch(
        columnar.stack_docs([d.extract.to_seq_columns(pad_to=1024) for d in docs]), device="cpu"
    )
    for spec in ("torch:ruling", "torch:wyllie", "torch:blocked"):
        codes, counts = fugue_batch.merge_docs(seq, rank_impl=spec, device="cpu")
        for i, d in enumerate(docs):
            assert "".join(map(chr, codes[i][: int(counts[i])].tolist())) == d.text, spec

    # payload ingest: the port's encoder and native codec, the packed
    # transport and the coalesced rank
    import numpy as np
    from torch import equal as torch_equal
    from loro_tpu_torch.ops import rank_model

    payloads = [tracegen.trace_payload(d, use_cache=False) for d in docs]
    exs = [columnar.extract_seq_from_payload(p, tracegen.TEXT_CID) for p in payloads]
    packed = np.empty((len(exs), fugue_batch.packed_row_bytes(257, 515)), np.uint8)
    for ex, row in zip(exs, packed):
        fugue_batch.pack_chain_doc_into(columnar.chain_columns(ex, pad_n=515, pad_c=257), row)
    budget = rank_model.coalesce_budget(600)
    codes, counts = fugue_batch.chain_merge_docs_packed(packed, 257, 515, "torch:coalesced", budget, device="cpu")
    for i, d in enumerate(docs):
        assert "".join(map(chr, codes[i][: int(counts[i])].tolist())) == d.text

    # the one-shot fleet merge, the decoder and the new core modules,
    # and the resident path's device ops
    from loro_tpu_torch.codec.binary import decode_changes
    from loro_tpu_torch.core import change, ids, version
    from loro_tpu_torch.parallel.fleet import FLEET_FALLBACKS, Fleet

    fleet = Fleet(device="cpu")
    assert fleet.merge_text_payloads(payloads, tracegen.TEXT_CID).texts == [d.text for d in docs]
    changes = [decode_changes(p) for p in payloads]
    assert all(isinstance(ch, change.Change) and isinstance(ch.deps, version.Frontiers) for chs in changes for ch in chs)
    assert fleet.merge_text_changes(changes, tracegen.TEXT_CID).texts == [d.text for d in docs]
    assert FLEET_FALLBACKS["payload_extract"] == 0 and ids.ID.parse("3@7") == ids.ID(7, 3)
    u = [tracegen.seq_columns_u(d, pad_to=1024) for d in docs]
    u = fugue_batch.seq_columns_to_torch(
        fugue_batch.SeqColumnsU(*[np.stack([getattr(c, f) for c in u]) for f in fugue_batch.SeqColumnsU._fields]),
        device="cpu")
    codes_u, counts_u, _ = fugue_batch.chain_merge_docs_u(u, 1024, device="cpu")
    rank = fugue_batch.fugue_order_u(u, device="cpu").long()
    by_key = fugue_batch.materialize_by_key(u, rank >> 10, rank & 0x3FF, device="cpu")
    assert torch_equal(codes_u, by_key[0]) and torch_equal(counts_u, by_key[1])

    # the resident text batch: epoch payloads in, texts and a checkpoint
    # out, on the native engines and on the Python ones
    import os
    from loro_tpu_torch.parallel.fleet import DeviceDocBatch
    from loro_tpu_torch.parallel.order_maintenance import ShadowOrder
    from loro_tpu_torch.storage import MemKvStore

    eps = [tracegen.epoch_payloads(d, use_cache=False) for d in docs]
    blobs = []
    for py in ("0", "1"):
        os.environ["LORO_PY_ORDER"] = os.environ["LORO_PY_IDMAP"] = py
        batch = DeviceDocBatch(len(docs), 256, device="cpu", auto_grow=True)
        assert isinstance(batch.order[0], ShadowOrder) == (py == "1")
        for e in range(len(eps[0])):
            batch.append_payloads([ep[e] for ep in eps], tracegen.TEXT_CID)
        assert batch.texts() == batch.texts(use_solver=True) == [d.text for d in docs]
        blobs.append(batch.export_state())
    assert blobs[0] == blobs[1] and FLEET_FALLBACKS["payload_decode"] == 0
    assert DeviceDocBatch.import_state(blobs[0], device="cpu").export_state() == blobs[0]
    kv = MemKvStore()
    kv.import_all(blobs[0])
    assert kv.get(b"meta") is not None

    # the LWW-map and counter merges: one-shot and resident, from
    # tracegen payloads and change lists
    from loro_tpu_torch.ops.columnar import extract_map_ops
    from loro_tpu_torch.parallel.fleet import DeviceCounterBatch, DeviceMapBatch

    mdocs = [tracegen.map_doc(s, n_ops=600, n_keys=50, sync_every=200) for s in range(2)]
    meps = [tracegen.map_epoch_payloads(d) for d in mdocs]
    mb = DeviceMapBatch(2, 16, device="cpu", auto_grow=True)
    for e in range(mdocs[0].n_epochs):
        mb.append_payloads([ep[e] for ep in meps])
    want = [tracegen.oracle_map(d) for d in mdocs]
    assert mb.root_value_maps("m") == want and mb.s == 64
    assert DeviceMapBatch.import_state(mb.export_state(), device="cpu").root_value_maps("m") == want
    assert fleet.merge_map_docs([extract_map_ops(decode_changes(tracegen.map_payload(d))) for d in mdocs]) == want
    cdocs = [tracegen.counter_doc(s, n_incr=512, n_counters=20, epoch_incr=128) for s in range(2)]
    cb = DeviceCounterBatch(2, 8, device="cpu", auto_grow=True)
    for e in range(cdocs[0].n_epochs):
        cb.append_changes([d.epoch_changes()[e] for d in cdocs])
    want = [tracegen.oracle_counter(d) for d in cdocs]
    assert cb.value_maps() == want and cb.s == 32
    assert DeviceCounterBatch.import_state(cb.export_state(), device="cpu").value_maps() == want
    assert fleet.merge_counter_changes([d.changes for d in cdocs]) == want

    # the movable-tree merge: one-shot from payloads and change lists,
    # and resident from epoch payloads, against the trace oracle
    from loro_tpu_torch.parallel.fleet import DeviceTreeBatch

    tdocs = [tracegen.tree_doc(s, n_moves=300, n_nodes=80, sync_every=100) for s in range(2)]
    want = [tracegen.oracle_tree(d) for d in tdocs]
    assert fleet.merge_tree_payloads([tracegen.tree_payload(d) for d in tdocs], tracegen.TREE_CID) == [w[0] for w in want]
    assert fleet.merge_tree_children([d.changes for d in tdocs], tracegen.TREE_CID) == [w[1] for w in want]
    teps = [tracegen.tree_epoch_payloads(d) for d in tdocs]
    tbatch = DeviceTreeBatch(2, 64, 16, device="cpu", auto_grow=True)
    for e in range(tdocs[0].n_epochs):
        tbatch.append_payloads([ep[e] for ep in teps], tracegen.TREE_CID)
    assert tbatch.parent_maps() == [w[0] for w in want] and tbatch.children_maps() == [w[1] for w in want]
    assert DeviceTreeBatch.import_state(tbatch.export_state(), device="cpu").parent_maps() == [w[0] for w in want]

    # rich text: one-shot from change lists, resident from epoch payloads,
    # and the one-shot MovableList merge from payloads and change lists,
    # against the trace oracles
    tracegen.CACHE_DIR = pathlib.Path(sys.argv[1])  # the test's own directory, not the shared cache
    rdocs = [tracegen.richtext_doc(s, n_chars=600, n_marks=40, sync_every=100) for s in range(2)]
    want = [tracegen.oracle_richtext(d) for d in rdocs]
    assert fleet.merge_richtext_changes([d.changes for d in rdocs], tracegen.TEXT_CID, pad_docs=4) == want
    reps = [tracegen.richtext_epoch_payloads(d) for d in rdocs]
    rbatch = DeviceDocBatch(2, 64, device="cpu", auto_grow=True)
    for e in range(max(map(len, reps))):
        rbatch.append_payloads([ep[e] if e < len(ep) else None for ep in reps], tracegen.TEXT_CID)
    assert rbatch.richtexts() == want and any("attributes" in seg for segs in want for seg in segs)
    vdocs = [tracegen.movable_doc(s, n_elems=200, n_moves=100, n_sets=50, n_deletes=30, sync_every=80)
             for s in range(2)]
    want = [tracegen.oracle_movable(d) for d in vdocs]
    assert fleet.merge_movable_payloads([tracegen.movable_payload(d) for d in vdocs], tracegen.MOVABLE_CID) == want
    assert fleet.merge_movable_changes([d.changes for d in vdocs], tracegen.MOVABLE_CID) == want
    assert FLEET_FALLBACKS["payload_extract"] == 0

    # the resident MovableList batch from epoch payloads, and the read
    # plane's selection over the text traces' epochs
    from loro_tpu_torch.core.version import VersionVector
    from loro_tpu_torch.ops.export_batch import ExportIndex
    from loro_tpu_torch.parallel.fleet import DeviceMovableBatch

    veps = [tracegen.movable_epoch_payloads(d) for d in vdocs]
    vbatch = DeviceMovableBatch(2, 16, 8, device="cpu", auto_grow=True)
    for e in range(max(map(len, veps))):
        vbatch.append_payloads([ep[e] if e < len(ep) else None for ep in veps], tracegen.MOVABLE_CID)
    assert vbatch.value_lists() == want and FLEET_FALLBACKS["payload_decode"] == 0
    assert DeviceMovableBatch.import_state(vbatch.export_state(), device="cpu").value_lists() == want
    index = ExportIndex(len(docs), capacity=8, device="cpu")
    groups = [[decode_changes(p) for p in ep] for ep in eps]
    for di, gs in enumerate(groups):
        for g in gs:
            index.note_changes(di, g)
    mid = [{ch.peer: ch.ctr_end for g in gs[: len(gs) // 2] for ch in g} for gs in groups]
    reqs = [(di, VersionVector(m)) for di, m in enumerate(mid)] + [(0, VersionVector())]
    got = vbatch.export_select(index, reqs)
    for (di, vv), g in zip(reqs, got):
        assert g.tolist() == tracegen.oracle_export(groups[di], vv)

    # the host engine: a LoroDoc edit, export and import round trip, and
    # the host mirror on a LoroDoc-made fleet
    from loro_tpu_torch import LoroDoc
    from loro_tpu_torch.resilience.hostpath import host_merge_changes

    a, b = LoroDoc(peer=1), LoroDoc(peer=2)
    a.get_text("t").insert(0, "hello")
    a.get_map("m").set("k", [1, "x"])
    b.import_(a.export_updates(b.oplog_vv()))
    b.get_text("t").insert(5, "!")
    a.import_(b.export_updates(a.oplog_vv()))
    assert a.get_deep_value() == b.get_deep_value() == {"m": {"k": [1, "x"]}, "t": "hello!"}
    assert LoroDoc.from_snapshot(a.export_snapshot()).get_deep_value() == a.get_deep_value()
    lf = tracegen.loro_fleet(1, 2, n_rounds=2)
    assert host_merge_changes("text", [d.changes() for d in lf], tracegen.TEXT_CID) == \
        fleet.merge_text_changes([d.changes() for d in lf], tracegen.TEXT_CID).texts

    # supervision: an armed fatal launch fault degrades the merge to the
    # host engine, counted
    from loro_tpu_torch.resilience import DeviceSupervisor, faultinject, set_supervisor

    sup = DeviceSupervisor(sleep=lambda s: None)
    set_supervisor(sup)
    faultinject.inject("launch", exc=RuntimeError("INTERNAL: injected"), times=1)
    try:
        assert fleet.merge_tree_changes([d.changes() for d in lf], tracegen.TREE_CID) == \
            host_merge_changes("tree", [d.changes() for d in lf], tracegen.TREE_CID)
    finally:
        faultinject.clear()
        set_supervisor(None)
    assert sup.report()["degradations"] == 1

    # the port's entry point
    from loro_tpu_torch.entry import entry

    fn, (ex,) = entry()
    codes, counts = fn(ex, device="cpu")
    assert codes.shape == (8, 256) and int(counts[0]) == 256 - 256 // 7
    # the device mesh: one op-sharded map merge and one op-sharded rank on the host
    from loro_tpu_torch.ops.columnar import extract_map_ops
    from loro_tpu_torch.ops.fugue_batch import _wyllie_dist, make_ring_rank_sharded
    from loro_tpu_torch.parallel.fleet import Fleet as MeshFleet
    from loro_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(["cpu"] * 4, op_parallel=2)
    md = LoroDoc(peer=7)
    md.get_map("m").set("k", 1)
    md.get_map("m").set("j", "x")
    md.commit()
    got = MeshFleet(mesh=mesh).merge_map_docs_sharded([extract_map_ops(md.oplog.changes_in_causal_order())])
    assert got == [md.get_map("m").get_value()], got
    ring = np.stack([np.minimum(np.arange(1, 65, dtype=np.int32), 63)] * 2)
    import torch
    assert torch.equal(make_ring_rank_sharded(mesh, 64, "blocked")(ring), _wyllie_dist(torch.from_numpy(ring)))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "loro_tpu"))
    assert not leaked, leaked
    print("OK", len(names))
    """
)


def test_imports_with_jax_and_loro_tpu_blocked(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(tmp_path)], cwd=REPO, capture_output=True, text=True, timeout=240
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().startswith("OK")


_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|loro_tpu)(?:[.\s]|$)", re.M)


_INCLUDE_RE = re.compile(r'^\s*#\s*include\s*[<"]([^>"]*)[>"]', re.M)


def test_source_scan_finds_no_jax_or_loro_tpu_import():
    """Every Python file of the port (its subpackages included) and
    chip_smoke.py import neither jax nor loro_tpu, and no C++ or CUDA
    source of the port includes anything of loro_tpu/."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 5
    for name in ("parallel/fleet.py", "core/change.py", "core/version.py", "core/ids.py", "storage/kv.py",
                 "parallel/order_maintenance.py", "parallel/idmap.py", "native/__init__.py", "ops/lww.py",
                 "ops/tree_batch.py", "ops/richtext_batch.py", "ops/movable_batch.py", "ops/export_batch.py",
                 "oplog/oplog.py", "oplog/dag.py", "oplog/change_store.py", "doc.py", "state.py", "txn.py",
                 "event.py", "models/handlers.py", "codec/snapshot.py", "codec/json_schema.py", "cursor.py",
                 "jsonpath.py", "history_cache.py", "resilience/hostpath.py", "obs/metrics.py", "utils/treap.py",
                 "resilience/supervisor.py", "resilience/faultinject.py", "resilience/probe.py", "obs/flight.py",
                 "analysis/lockorder.py", "analysis/lockwitness.py", "analysis/core.py", "analysis/rules.py",
                 "analysis/lint.py", "chaos/plan.py", "chaos/stack.py", "chaos/invariants.py", "chaos/runner.py",
                 "chaos/replay.py", "chaos/shrink.py", "chaos/run.py"):
        assert PKG / name in files, name
    for sub in ("analysis", "chaos", "codec", "core", "models", "native", "obs", "oplog", "ops", "parallel",
                "resilience", "storage", "utils"):
        assert any(f.parent == PKG / sub for f in files), sub
    offenders = [
        f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files for m in _IMPORT_RE.finditer(f.read_text())
    ]
    assert not offenders, offenders
    assert _IMPORT_RE.search("import jax.numpy as jnp") and _IMPORT_RE.search("from loro_tpu.ops import x")
    assert not _IMPORT_RE.search("from loro_tpu_torch.ops import x")
    native = sorted(PKG.rglob("*.cpp")) + sorted(PKG.rglob("*.cu")) + sorted(PKG.rglob("*.cuh"))
    assert {f.name for f in native} >= {"seq_codec.cpp", "order_idmap.cpp", "list_rank.cu", "tree_replay.cu"}
    includes = [(f, inc) for f in native for inc in _INCLUDE_RE.findall(f.read_text())]
    assert includes
    bad = [
        f"{f.relative_to(REPO)}: {inc}" for f, inc in includes
        if re.search(r"(^|/)loro_tpu/", inc)
        or ((f.parent / inc).exists() and not (f.parent / inc).resolve().is_relative_to(PKG))
    ]
    assert not bad, bad
    assert re.search(r"(^|/)loro_tpu/", "../../loro_tpu/native/x.h") and not re.search(r"(^|/)loro_tpu/", "loro_tpu_torch/x.h")


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from loro_tpu_torch import resolve_device
    from loro_tpu_torch.errors import DeviceUnavailable
    from loro_tpu_torch.ops import fugue_batch, list_rank

    z = np.zeros(4, np.int32)
    np_cols = fugue_batch.ChainColumns(
        c_parent=np.full((1, 2), -1, np.int32), c_side=np.ones((1, 2), np.int32),
        c_valid=np.ones((1, 2), bool), head_row=np.array([[0, 1]], np.int32),
        chain_id=np.array([[0, 1, 1, 1]], np.int32), deleted=np.zeros((1, 4), bool),
        content=np.array([[97, 98, 99, 100]], np.int32), valid=np.ones((1, 4), bool),
    )
    cpu_cols = fugue_batch.chain_columns_to_torch(np_cols, device="cpu")
    from loro_tpu_torch.entry import dryrun_multichip, entry, example_cols
    from loro_tpu_torch.ops import lww
    from loro_tpu_torch.ops.export_batch import ExportIndex
    from loro_tpu_torch.parallel.fleet import (DeviceCounterBatch, DeviceDocBatch, DeviceMapBatch, DeviceMovableBatch,
                                              DeviceTreeBatch, Fleet)
    from loro_tpu_torch.parallel.mesh import make_mesh
    from loro_tpu_torch.parallel.residency import TieredResidentServer
    from loro_tpu_torch.parallel.server import ResidentServer
    from loro_tpu_torch.parallel.sharded import ShardedResidentServer
    from loro_tpu_torch.persist import open_server, recover_server
    from loro_tpu_torch.chaos import ChaosConfig, ChaosRunner, ChaosStack, replay_artifact, shrink_artifact
    from loro_tpu_torch.replication import Follower, ShardedFollower, enable

    durable = str(tmp_path / "durable")  # a durable directory made on the CPU, recovered by default on the card
    ResidentServer("counter", 1, device="cpu", durable_dir=durable).close()
    leader_dir, sharded_dir = str(tmp_path / "leader"), str(tmp_path / "sharded")  # followed by default on the card
    for lead in (ResidentServer("counter", 1, device="cpu", durable_dir=leader_dir),
                 ShardedResidentServer("counter", 2, devices=["cpu", "cpu"], durable_dir=sharded_dir)):
        enable(lead)
        lead.close()

    chaos_cfg = ChaosConfig(seed=1, steps=4, families=("map",), docs=1, shards=2, follower=False)
    chaos_art = str(tmp_path / "chaos_art.json")  # a violation artifact: replay and shrink would run it
    with open(chaos_art, "w") as f:
        f.write(json.dumps({"version": 1, "config": chaos_cfg.to_json(), "trace": [{"i": 0, "kind": "check"}],
                            "violations": [{"invariant": "convergence", "family": "map", "detail": "", "step": 0}]}))

    np_seq = example_cols(d=1, n=8)
    seq = fugue_batch.seq_columns_to_torch(np_seq, device="cpu")
    u32 = np.zeros((1, 8), np.uint32)
    np_u = fugue_batch.SeqColumnsU(
        np_seq.parent, np_seq.side, u32, u32, np_seq.counter, np_seq.deleted, np_seq.content, np_seq.valid
    )
    seq_u = fugue_batch.seq_columns_to_torch(np_u, device="cpu")
    fn, _ = entry()
    i32 = torch.zeros((1, 4), dtype=torch.int32)
    map_cols = lww.MapOpCols(i32, i32, i32, i32, torch.ones((1, 4), dtype=torch.bool))
    from loro_tpu_torch.ops import movable_batch, richtext_batch

    p_i32, p_ok = np.zeros((1, 2), np.int32), np.ones((1, 2), bool)
    pair_cols = (p_i32, p_i32 + 1, p_i32, p_i32, p_i32, p_i32, p_ok)
    rt_cols = richtext_batch.RichtextCols(np_seq, *pair_cols)
    rt_chain = richtext_batch.RichtextChainCols(np_cols, *pair_cols)
    rt_pairs = richtext_batch.RichtextPairs(*pair_cols)
    mv_cols = movable_batch.MovableCols(np_seq._replace(content=np_seq.content % 4), np_seq.counter, *pair_cols[:4],
                                        p_ok)
    calls = [
        lambda: resolve_device(),
        lambda: list_rank.wyllie_rank(np.arange(4, dtype=np.int32)),
        lambda: list_rank.wyllie_rank(torch.from_numpy(z)),
        lambda: fugue_batch.chain_columns_to_torch(np_cols),
        lambda: fugue_batch.chain_merge_docs(cpu_cols),
        lambda: fugue_batch.chain_merge_docs_checksum(cpu_cols),
        lambda: fugue_batch.chain_merge_docs_v(cpu_cols),
        lambda: fugue_batch.chain_merge_docs_checksum_v(cpu_cols),
        lambda: fugue_batch.chain_rank_checksum_v(cpu_cols),
        lambda: fugue_batch.seq_columns_to_torch(np_seq),
        lambda: fugue_batch.fugue_order(seq),
        lambda: fugue_batch.visible_order(seq),
        lambda: fugue_batch.materialize_content(seq),
        lambda: fugue_batch.materialize_content_batch(seq),
        lambda: fugue_batch.merge_docs(seq),
        lambda: fugue_batch.merge_docs_checksum(seq),
        lambda: fn(np_seq),
        lambda: fugue_batch.seq_columns_to_torch(np_u),
        lambda: fugue_batch.fugue_order_u(seq_u),
        lambda: fugue_batch.materialize_content_u(seq_u),
        lambda: fugue_batch.merge_docs_u(seq_u),
        lambda: fugue_batch.chain_merge_docs_u(seq_u, 8),
        lambda: fugue_batch.materialize_by_key(seq_u, u32, u32),
        lambda: Fleet(),
        lambda: DeviceDocBatch(1, 16),
        lambda: DeviceDocBatch.import_state(DeviceDocBatch(1, 16, device="cpu").export_state()),
        lambda: lww.lww_merge_batch(map_cols, 2),
        lambda: lww.counter_merge_batch(map_cols.slot, map_cols.slot.float(), map_cols.valid, 2),
        lambda: DeviceMapBatch(1, 4),
        lambda: DeviceMapBatch.import_state(DeviceMapBatch(1, 4, device="cpu").export_state()),
        lambda: DeviceCounterBatch(1, 4),
        lambda: DeviceCounterBatch.import_state(DeviceCounterBatch(1, 4, device="cpu").export_state()),
        lambda: DeviceTreeBatch(1, 16, 4),
        lambda: DeviceTreeBatch.import_state(DeviceTreeBatch(1, 16, 4, device="cpu").export_state()),
        lambda: richtext_batch.richtext_merge_batch(rt_cols, 4),
        lambda: richtext_batch.richtext_chain_merge_batch(rt_chain, 4),
        lambda: richtext_batch.richtext_by_key_batch(seq_u, u32, u32, rt_pairs, 4),
        lambda: movable_batch.movable_merge_batch(mv_cols, 4),
        lambda: movable_batch.movable_by_key_batch(np_seq.valid, np_seq.deleted, u32, u32, i32, i32, i32),
        lambda: DeviceMovableBatch(1, 16, 4),
        lambda: DeviceMovableBatch.import_state(DeviceMovableBatch(1, 16, 4, device="cpu").export_state()),
        lambda: ExportIndex(1),
        lambda: ResidentServer("text", 1),
        lambda: ResidentServer.restore(ResidentServer("counter", 1, device="cpu").checkpoint()),
        lambda: TieredResidentServer("text", 2, hot_slots=1),
        lambda: ShardedResidentServer("text", 2),
        lambda: ShardedResidentServer("text", 2, devices=["cuda", "cuda"]),
        lambda: make_mesh(),
        lambda: make_mesh(op_parallel=2),
        lambda: Fleet(mesh=make_mesh()),
        lambda: dryrun_multichip(8),
        lambda: recover_server(durable),
        lambda: open_server(durable),
        lambda: open_server(str(tmp_path / "fresh"), "text", 1),
        lambda: Follower(leader_dir, str(tmp_path / "follower")),
        lambda: ShardedFollower(sharded_dir, str(tmp_path / "sharded_follower")),
        lambda: ChaosStack(chaos_cfg, str(tmp_path / "chaos_stack")),
        lambda: ChaosRunner(chaos_cfg, str(tmp_path / "chaos_run")),
        lambda: replay_artifact(chaos_art),
        lambda: shrink_artifact(chaos_art),
    ]
    for call in calls:
        with pytest.raises(DeviceUnavailable):
            call()
    # the same calls run when the CPU is asked for
    codes, counts = fugue_batch.chain_merge_docs_v(cpu_cols, device="cpu")
    assert int(counts[0]) == 4 and codes[0].tolist() == [97, 98, 99, 100]
    codes, counts = fn(np_seq, device="cpu")
    assert int(counts[0]) == 7 and codes[0].tolist() == [97, 98, 99, 100, 101, 102, 104, -1]
    assert torch.equal(fugue_batch.merge_docs_u(seq_u, device="cpu")[0], codes)
    assert lww.lww_merge_batch(map_cols, 2, device="cpu")[0].tolist() == [[0, -2]]
    # the tree replay dispatches on its tensors' device: CPU tensors take the plain version
    from loro_tpu_torch.ops import tree_batch

    parents, eff = tree_batch.tree_merge_batch(tree_batch.TreeOpCols(i32, i32, map_cols.valid), 1)
    assert parents.tolist() == [[tree_batch.ABSENT]] and not eff.any()  # node 0 under itself: rejected
    parents, eff = tree_batch.tree_merge_batch(tree_batch.TreeOpCols(i32, i32 + tree_batch.ROOT, map_cols.valid), 1)
    assert parents.tolist() == [[tree_batch.ROOT]] and eff.all()
    # the richtext and movable merges run when the CPU is asked for
    codes, counts, bounds, win = richtext_batch.richtext_chain_merge_batch(rt_chain, 4, device="cpu")
    assert int(counts[0]) == 4 and win.shape == (1, 5, 4)
    assert int(movable_batch.movable_merge_batch(mv_cols, 4, device="cpu")[1][0]) > 0
    # the resident movable batch and the export index run when the CPU is asked for
    from loro_tpu_torch.core.version import VersionVector

    assert DeviceMovableBatch(1, 16, 4, device="cpu").value_lists() == [[]]
    assert [g.tolist() for g in ExportIndex(1, device="cpu").select([(0, VersionVector())])] == [[]]
    # the server layer runs when the CPU is asked for
    assert recover_server(durable, device="cpu").value_maps() == [{}]
    assert ShardedResidentServer("text", 2, devices=["cpu", "cpu"]).texts() == ["", ""]
    assert TieredResidentServer("text", 2, hot_slots=1, device="cpu").texts() == ["", ""]
    # the followers run when the CPU is asked for
    with Follower(leader_dir, str(tmp_path / "follower"), device="cpu") as fol:
        assert fol.catch_up()["applied_epoch"] == 0 and fol.resident.value_maps() == [{}]
    with ShardedFollower(sharded_dir, str(tmp_path / "sharded_follower"), devices=["cpu", "cpu"]) as sfol:
        assert sfol.catch_up()["applied_epoch"] == 0 and sfol.value_maps() == [{}, {}]
