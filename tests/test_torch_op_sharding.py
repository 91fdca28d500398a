"""The port's device mesh and op-axis sharding on the CPU, against the JAX
package on its 8 virtual CPU devices (tests/conftest.py).

The port runs on meshes of the host (``["cpu"] * 8``, or eight distinct
``cpu:i`` devices where a carve is compared index for index).  Covered:
make_mesh's shape and shard_meshes' carve for op_parallel 1, 2, 4, 8;
the op-sharded ring rank ("wyllie" against JAX's own cases, "blocked"
against JAX's _wyllie_dist, since JAX's blocked variant does not run on
jax 0.9.0); make_lww_sharded against JAX's on columns with ties across
op shards, deletes, untouched slots and pad rows; merge_map_docs_sharded
on a 4 x 2 mesh against JAX's and the LoroDoc values; the eleven one-shot
Fleet merges doc-sharded over 8 rows against JAX's Fleet(make_mesh())
(results, fleet.* counters and padded shapes; an armed fault degrading
as JAX's does); dryrun_multichip.  Every comparison is exact (tolerance:
none); inputs are made from seeds.
"""
import random

import jax
import numpy as np
import pytest
import torch

from loro_tpu import LoroDoc as JLoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.ids import ContainerID as JCid
from loro_tpu.errors import ConfigError as JConfigError
from loro_tpu.obs import metrics as jobs
from loro_tpu.ops import columnar as jcol
from loro_tpu.ops import fugue_batch as jfb
from loro_tpu.ops import lww as jlww
from loro_tpu.parallel import mesh as jmesh
from loro_tpu.parallel.fleet import Fleet as JFleet
from loro_tpu.resilience import faultinject as jfi
from loro_tpu_torch import LoroDoc as PLoroDoc
from loro_tpu_torch import tracegen as tg
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.entry import dryrun_multichip
from loro_tpu_torch.errors import ConfigError
from loro_tpu_torch.obs import metrics as pobs
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.ops import fugue_batch as pfb
from loro_tpu_torch.ops import lww as plww
from loro_tpu_torch.parallel import mesh as pmesh
from loro_tpu_torch.parallel.fleet import Fleet as PFleet
from loro_tpu_torch.resilience import faultinject as pfi
from loro_tpu_torch.resilience import supervisor as psup
from test_torch_doc import plain

CPU8 = ["cpu"] * 8
DISTINCT8 = [torch.device("cpu", i) for i in range(8)]


@pytest.fixture(autouse=True)
def _quiet():
    """A sleepless process supervisor for the port; armed faults cleared
    in both packages afterwards."""
    psup.set_supervisor(psup.DeviceSupervisor(sleep=lambda _s: None))
    yield
    pfi.clear()
    jfi.clear()
    psup.set_supervisor(None)


# ---- the mesh ---------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_make_mesh_and_shard_meshes_carve_as_jax(k):
    jm = jmesh.make_mesh(op_parallel=k)
    pm = pmesh.make_mesh(DISTINCT8, op_parallel=k)
    assert dict(jm.shape) == pm.shape and tuple(jm.axis_names) == pm.axis_names
    assert [[d.id for d in r] for r in np.asarray(jm.devices)] == [[d.index for d in r] for r in pm.devices]
    rows = pm.shape["docs"]
    for n in [n for n in range(1, rows + 1) if rows % n == 0]:
        jsub, psub = jmesh.shard_meshes(jm, n), pmesh.shard_meshes(pm, n)
        assert [[[d.id for d in r] for r in np.asarray(s.devices)] for s in jsub] == \
            [[[d.index for d in r] for r in s.devices] for s in psub]
        assert all(dict(j.shape) == p.shape for j, p in zip(jsub, psub))
    for bad in [n for n in range(1, 9) if rows % n]:
        with pytest.raises(ConfigError):
            pmesh.shard_meshes(pm, bad)


@pytest.mark.parametrize("k", [3, 5, 0])
def test_make_mesh_refuses_an_op_parallel_that_does_not_divide(k):
    with pytest.raises(ConfigError):
        pmesh.make_mesh(CPU8, op_parallel=k)
    if k:
        with pytest.raises(AssertionError):  # JAX asserts where the port raises ConfigError
            jmesh.make_mesh(op_parallel=k)


def test_mesh_layout_helpers():
    """A flat list is one column; doc_sharding gives each row's lead and
    contiguous docs; replicated the distinct devices; shard_doc_batch
    cuts a nested column tuple a row."""
    flat = pmesh.make_mesh(DISTINCT8[:4])
    assert flat.shape == {"docs": 4, "ops": 1} and list(flat) == DISTINCT8[:4] and flat.lead == DISTINCT8[0]
    assert pmesh.make_mesh(flat) is flat
    m = pmesh.make_mesh(DISTINCT8, op_parallel=2)
    assert pmesh.doc_sharding(m, 8) == [(DISTINCT8[2 * i], slice(2 * i, 2 * i + 2)) for i in range(4)]
    with pytest.raises(ConfigError):
        pmesh.doc_sharding(m, 6)
    assert pmesh.replicated(m) == tuple(DISTINCT8)
    assert pmesh.replicated(pmesh.make_mesh(CPU8)) == (torch.device("cpu"),)
    cols = pfb.SeqColumns(*[np.arange(16, dtype=np.int32).reshape(8, 2) + i for i in range(7)])
    parts = pmesh.shard_doc_batch(m, cols)
    assert len(parts) == 4 and all(isinstance(p, pfb.SeqColumns) and p.parent.shape == (2, 2) for p in parts)
    assert torch.equal(torch.cat([p.counter for p in parts]), torch.from_numpy(cols.counter))
    with pytest.raises(ConfigError):
        pmesh.make_mesh(m, op_parallel=4)


# ---- the op-sharded ring rank ----------------------------------------------


def _ring(rng, m):
    """tests/test_sharded_rank.py's ring: a random subset of tokens linked
    in a random order, the rest self-loops."""
    live = rng.choice(m, size=rng.integers(2, m + 1), replace=False)
    p = rng.permutation(live).astype(np.int32)
    succ = np.arange(m, dtype=np.int32)
    succ[p[:-1]] = p[1:]
    return succ


def _jax_wyllie(succ):
    return np.stack([np.asarray(jax.jit(jfb._wyllie_dist)(s)) for s in succ])


@pytest.mark.parametrize("m,seed", [(512, 3), (4096, 11)])
@pytest.mark.parametrize("op_parallel", [2, 4, 8])
def test_sharded_wyllie_rank_matches_jax(op_parallel, m, seed):
    jm = jmesh.make_mesh(op_parallel=op_parallel)
    pm = pmesh.make_mesh(CPU8, op_parallel=op_parallel)
    d = pm.shape["docs"] * 2
    rng = np.random.default_rng(seed)
    succ = np.stack([_ring(rng, m) for _ in range(d)])
    want = np.asarray(jfb.make_ring_rank_sharded(jm, m)(jax.device_put(succ)))
    fn = pfb.make_ring_rank_sharded(pm, m)
    got = fn(succ)
    assert got.dtype == torch.int32 and got.shape == (d, m)
    assert np.array_equal(got.numpy(), want) and np.array_equal(want, _jax_wyllie(succ))
    assert fn.rounds == [pfb.list_rank.ceil_log2(m)] * pm.shape["docs"]


@pytest.mark.parametrize("op_parallel", [2, 4])
def test_sharded_blocked_rank_matches_wyllie(op_parallel):
    """tests/test_sharded_rank.py's blocked case (seed 7, one doc a pure
    index run that phase A collapses), held against JAX's _wyllie_dist:
    the JAX blocked variant passes check_rep, which jax 0.9.0's shard_map
    does not take."""
    pm = pmesh.make_mesh(CPU8, op_parallel=op_parallel)
    d, m = pm.shape["docs"] * 2, 512
    rng = np.random.default_rng(7)
    succ = np.stack([_ring(rng, m) for _ in range(d)])
    succ[0] = np.arange(1, m + 1, dtype=np.int32)
    succ[0, -1] = m - 1
    fn = pfb.make_ring_rank_sharded(pm, m, algo="blocked")
    got = fn(torch.from_numpy(succ))
    assert np.array_equal(got.numpy(), _jax_wyllie(succ))
    assert all(1 <= r <= pfb.list_rank.ceil_log2(m) for r in fn.rounds)
    assert torch.equal(pfb.make_ring_rank_sharded(pm, m, algo="wyllie")(succ), got)


def test_sharded_rank_validation():
    pm = pmesh.make_mesh(CPU8, op_parallel=2)
    with pytest.raises(ConfigError):
        pfb.make_ring_rank_sharded(pm, 512, algo="bogus")
    with pytest.raises(JConfigError):
        jfb.make_ring_rank_sharded(jmesh.make_mesh(op_parallel=2), 512, algo="bogus")
    with pytest.raises(ConfigError):
        pfb.make_ring_rank_sharded(pm, 511)
    fn = pfb.make_ring_rank_sharded(pm, 8)
    with pytest.raises(ConfigError):
        fn(np.zeros((3, 8), np.int32))  # 3 docs over 4 rows
    with pytest.raises(ValueError):
        fn(np.full((4, 8), 8, np.int32))


# ---- the op-sharded LWW merge -----------------------------------------------


def _lww_cols(seed, d, m, s):
    """[d, m] map op columns: per doc, ops with unique (slot, lamport,
    peer) over few lamports and peers (ties on lamport everywhere), values
    in [-1, 20) (-1 a delete), the last slot never written, then pad rows
    (invalid, with junk fields); doc 0 pins a lamport tie whose higher
    peer sits in the last op shard."""
    rng = np.random.default_rng(seed)
    cols = {f: np.zeros((d, m), np.int32) for f in ("slot", "lamport", "peer", "value_idx")}
    valid = np.zeros((d, m), bool)
    for i in range(d):
        trip = {(int(rng.integers(0, s - 1)), int(rng.integers(0, 4)), int(rng.integers(0, 4)))
                for _ in range(m)}
        trip = list(trip)[: int(rng.integers(m // 2, m - 2))]
        rows = rng.permutation(m)[: len(trip)]
        for r, (sl, la, pe) in zip(rows, trip):
            cols["slot"][i, r], cols["lamport"][i, r], cols["peer"][i, r] = sl, la, pe
            cols["value_idx"][i, r] = int(rng.integers(-1, 20))
            valid[i, r] = True
        junk = ~valid[i]
        cols["slot"][i, junk] = rng.integers(0, s, junk.sum())
        cols["lamport"][i, junk] = 99
    cols["slot"][0, :] = np.where(valid[0], cols["slot"][0], 0)
    cols["slot"][0, 0], cols["lamport"][0, 0], cols["peer"][0, 0], cols["value_idx"][0, 0] = s - 2, 50, 1, 7
    cols["slot"][0, m - 1], cols["lamport"][0, m - 1], cols["peer"][0, m - 1], cols["value_idx"][0, m - 1] = \
        s - 2, 50, 3, 9
    valid[0, 0] = valid[0, m - 1] = True
    # doc 1's slot 0: a delete at a lamport above every other op's
    cols["slot"][1, 1], cols["lamport"][1, 1], cols["peer"][1, 1], cols["value_idx"][1, 1] = 0, 60, 0, -1
    valid[1, 1] = True
    return cols["slot"], cols["lamport"], cols["peer"], cols["value_idx"], valid


@pytest.mark.parametrize("op_parallel,seed", [(2, 1), (4, 2), (8, 3)])
def test_lww_sharded_matches_jax(op_parallel, seed):
    jm = jmesh.make_mesh(op_parallel=op_parallel)
    pm = pmesh.make_mesh(CPU8, op_parallel=op_parallel)
    d, m, s = pm.shape["docs"] * 2, 64, 6
    arrays = _lww_cols(seed, d, m, s)
    want = jlww.make_lww_sharded(jm, s)(jlww.MapOpCols(*[jax.device_put(a) for a in arrays]))
    got = plww.make_lww_sharded(pm, s)(plww.MapOpCols(*arrays))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
    vi, lam, peer = (t.numpy() for t in got)
    assert (vi[:, s - 1] == -2).all() and (lam[:, s - 1] == plww.NEG).all()  # untouched
    assert (vi[0, s - 2], lam[0, s - 2], peer[0, s - 2]) == (9, 50, 3)  # the tie across op shards
    assert vi[1, 0] == -1  # the delete
    one = plww.lww_merge_batch(plww.MapOpCols(*[torch.from_numpy(a) for a in arrays]), s, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, one))
    with pytest.raises(ConfigError):
        plww.make_lww_sharded(pm, s)(plww.MapOpCols(*[a[:, :-1] for a in arrays]))


# ---- Fleet over a mesh ---------------------------------------------------------


def _fleet_counters(metrics):
    out = {}
    for m in metrics.registry().metrics():
        if m.name.startswith("fleet.") and m.kind == "counter":
            for row in m.snapshot()["values"]:
                out[(m.name, tuple(sorted(row["labels"].items())))] = row["value"]
    return out


def _observed(metrics, call):
    """(call's result, the fleet.* counter deltas it left in `metrics`,
    the padded shapes it recorded: the distinct-shape set is swapped for
    an empty one during the call, then merged back)."""
    c0 = _fleet_counters(metrics)
    shapes = metrics.unique("fleet.padded_shapes_distinct")
    saved, shapes._values = shapes._values, {}
    try:
        out = call()
    finally:
        seen, shapes._values = shapes._values, saved
        for k, v in seen.items():
            saved.setdefault(k, set()).update(v)
    c1 = _fleet_counters(metrics)
    return out, {k: v - c0.get(k, 0) for k, v in c1.items() if v != c0.get(k, 0)}, set(seen.get((), ()))


def _map_docs(doc_cls):
    """tests/test_fleet_surface.py's op-sharded map docs (seed 77)."""
    rng = random.Random(77)
    docs = []
    for i in range(5):
        a, b = doc_cls(peer=500 + 2 * i), doc_cls(peer=501 + 2 * i)
        for d in (a, b):
            m = d.get_map("m")
            for _ in range(rng.randint(3, 30)):
                if rng.random() < 0.2:
                    m.delete(rng.choice("abcdef"))
                else:
                    m.set(rng.choice("abcdef"), rng.randint(0, 999))
            d.commit()
        a.import_(b.export_updates(a.oplog_vv()))
        b.import_(a.export_updates(b.oplog_vv()))
        docs.append(a)
    return docs


def test_merge_map_docs_sharded_matches_jax_and_the_loro_docs():
    jdocs, pdocs = _map_docs(JLoroDoc), _map_docs(PLoroDoc)
    jex = [jcol.extract_map_ops(d.oplog.changes_in_causal_order()) for d in jdocs]
    pex = [pcol.extract_map_ops(d.oplog.changes_in_causal_order()) for d in pdocs]
    jfl = JFleet(jmesh.make_mesh(op_parallel=2))
    pfl = PFleet(mesh=pmesh.make_mesh(CPU8, op_parallel=2))
    want, jc, js = _observed(jobs, lambda: jfl.merge_map_docs_sharded(jex))
    got, pc, ps = _observed(pobs, lambda: pfl.merge_map_docs_sharded(pex))
    assert plain(got) == plain(want) and (pc, ps) == (jc, js)
    assert ps == {("map_sharded", 64, 6, 8, 2)}
    assert got == pfl.merge_map_docs(pex)
    for i, d in enumerate(pdocs):
        assert got[i] == d.get_map("m").get_value()


def test_merge_map_docs_sharded_falls_back_on_one_column():
    pdocs = _map_docs(PLoroDoc)
    pex = [pcol.extract_map_ops(d.oplog.changes_in_causal_order()) for d in pdocs]
    pfl = PFleet(mesh=pmesh.make_mesh(CPU8))
    got, pc, ps = _observed(pobs, lambda: pfl.merge_map_docs_sharded(pex))
    assert got == [d.get_map("m").get_value() for d in pdocs]
    assert {k[0] for k in pc} >= {"fleet.merge_calls_total"} and ps == {("map", 64, 6, 8)}


def test_fleet_device_and_mesh():
    assert PFleet(device="cpu").mesh.shape == {"docs": 1, "ops": 1}
    m = pmesh.make_mesh(CPU8, op_parallel=2)
    fl = PFleet(mesh=m)
    assert fl.mesh is m and fl.device == torch.device("cpu")
    with pytest.raises(ConfigError):
        PFleet(device="cpu", mesh=m)
    assert PFleet(mesh=["cpu", "cpu"]).mesh.shape == {"docs": 2, "ops": 1}


# the eleven one-shot entry points: (family, cid, call(fleet, inputs, cid));
# inputs hold each package's change lists, payloads and decode
ENTRY = {
    "text_docs": ("text", tg.TEXT_CID,
                  lambda f, X, c: f.merge_text_docs([X.col.extract_seq_container(ch, c) for ch in X.changes]).texts),
    "text_changes": ("text", tg.TEXT_CID, lambda f, X, c: f.merge_text_changes(X.changes, c).texts),
    "text_payloads": ("text", tg.TEXT_CID, lambda f, X, c: f.merge_text_payloads(X.payloads, c).texts),
    "richtext": ("richtext", tg.RICH_CID, lambda f, X, c: f.merge_richtext_changes(X.changes, c)),
    "movable_changes": ("movable", tg.MOVABLE_CID, lambda f, X, c: f.merge_movable_changes(X.changes, c)),
    "movable_payloads": ("movable", tg.MOVABLE_CID, lambda f, X, c: f.merge_movable_payloads(X.payloads, c)),
    "tree_changes": ("tree", tg.TREE_CID, lambda f, X, c: f.merge_tree_changes(X.changes, c)),
    "tree_payloads": ("tree", tg.TREE_CID, lambda f, X, c: f.merge_tree_payloads(X.payloads, c)),
    "tree_children": ("tree_children", tg.TREE_CID, lambda f, X, c: f.merge_tree_children(X.changes, c)),
    "counter": ("counter", None, lambda f, X, c: f.merge_counter_changes(X.changes)),
    "map_docs": ("map", None, lambda f, X, c: f.merge_map_docs([X.col.extract_map_ops(ch) for ch in X.changes])),
}
DEGRADING = [n for n in ENTRY if n not in ("text_docs", "map_docs")]


class _Inputs:
    def __init__(self, changes, payloads, col):
        self.changes, self.payloads, self.col = changes, payloads, col


_FLEETS = {}


def _inputs(n_docs):
    if n_docs not in _FLEETS:
        docs = tg.loro_fleet(23, n_docs, n_rounds=3, max_edits=6)
        payloads = [d.payload() for d in docs]
        _FLEETS[n_docs] = (_Inputs([pdecode(p) for p in payloads], payloads, pcol),
                           _Inputs([jdecode(p) for p in payloads], payloads, jcol))
    return _FLEETS[n_docs]


def _both(name, n_docs, arm=None):
    """The entry point through the JAX Fleet on its 8-device mesh and the
    port's on 8 rows of the host, each observed; `arm(faultinject)` arms
    a fault in each package before its call."""
    _family, cid, call = ENTRY[name]
    P, J = _inputs(n_docs)
    jcid = None if cid is None else JCid.parse(str(cid))
    out = []
    for fl, X, c, fi, metrics in ((JFleet(jmesh.make_mesh()), J, jcid, jfi, jobs),
                                  (PFleet(mesh=pmesh.make_mesh(CPU8)), P, cid, pfi, pobs)):
        if arm:
            arm(fi)
        try:
            out.append(_observed(metrics, lambda: call(fl, X, c)))
        finally:
            fi.clear()
    return out


@pytest.mark.parametrize("n_docs", [5, 11])
@pytest.mark.parametrize("name", list(ENTRY))
def test_doc_sharded_one_shot_merge_matches_jax(name, n_docs):
    """Eight doc rows: the doc axis padded to 8 (5 docs) or 16 (11), each
    row's docs merged on its lead device, the rows gathered in doc order:
    the JAX Fleet's results, fleet.* counters and padded shapes."""
    (want, jc, js), (got, pc, ps) = _both(name, n_docs)
    assert plain(got) == plain(want)
    assert pc == jc and ps == js
    d_pad = 8 if n_docs == 5 else 16
    assert len(ps) == 1 and next(iter(ps))[-1] == d_pad


def test_text_docs_honour_pad_docs():
    P, J = _inputs(5)
    jfl, pfl = JFleet(jmesh.make_mesh()), PFleet(mesh=pmesh.make_mesh(CPU8))
    jex = [jcol.extract_seq_container(ch, JCid.parse(str(tg.TEXT_CID))) for ch in J.changes]
    pex = [pcol.extract_seq_container(ch, tg.TEXT_CID) for ch in P.changes]
    want, jc, js = _observed(jobs, lambda: jfl.merge_text_docs(jex, pad_docs=16).texts)
    got, pc, ps = _observed(pobs, lambda: pfl.merge_text_docs(pex, pad_docs=16).texts)
    assert got == want and pc == jc and ps == js and next(iter(ps))[-1] == 16
    with pytest.raises(ConfigError):
        pfl.merge_text_docs(pex, pad_docs=12)  # 12 docs over 8 rows


@pytest.mark.parametrize("name", DEGRADING)
def test_doc_sharded_merge_degrades_as_jax(name):
    """A fatal launch fault armed in each package: both re-run on the
    host engine, with equal results and counters."""

    def arm(fi):
        fi.inject("launch", exc=RuntimeError("INTERNAL: injected device death"), times=1)

    (want, jc, js), (got, pc, ps) = _both(name, 5, arm)
    assert plain(got) == plain(want) and pc == jc and ps == js
    family = ENTRY[name][0]
    assert pc[("fleet.degraded_merges_total", (("family", family),))] == 1


# ---- the dry run ---------------------------------------------------------------


@pytest.mark.parametrize("n,shape", [(8, {"docs": 4, "ops": 2}), (1, {"docs": 1, "ops": 1}),
                                     (3, {"docs": 3, "ops": 1})])
def test_dryrun_multichip_on_the_host(n, shape):
    assert dryrun_multichip(n, device="cpu").shape == shape
