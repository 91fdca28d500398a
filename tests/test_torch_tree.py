"""The port's movable-tree merge (loro_tpu_torch.ops.tree_batch, the
one-shot Fleet.merge_tree_* and the resident DeviceTreeBatch) and what
it stands on (the native tree explode, tracegen's tree traces), against
the JAX package on the CPU.

Inputs: seeded numpy columns in the JAX bench's shape (targets uniform
in [0, n), parents in [-2, n)), hand-made move logs for each edge of the
cycle walk, unsorted resident logs with duplicate lamports, a peer id
with bit 63 set and padding, multi-peer LoroDoc histories (concurrent
creates, moves that form cycles across peers, deletes, fractional
positions), random LoroDoc rounds of 2 replicas a doc, and small
tracegen traces.  The JAX batches run on a one-device mesh.  Every
comparison is exact (tolerance: none): parent and effected arrays,
node dictionaries, maps, checkpoint bytes.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loro_tpu import LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.ids import TreeID as JTreeID
from loro_tpu.doc import frame_columnar_updates, strip_envelope
from loro_tpu.native import explode_tree_payload as jexplode_tree
from loro_tpu.ops import tree_batch as jtb
from loro_tpu.parallel.fleet import DeviceTreeBatch as JTreeBatch
from loro_tpu.parallel.fleet import Fleet as JFleet
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu_torch import native as pnative
from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.codec.binary import read_tables
from loro_tpu_torch.core.ids import ContainerID, ContainerType, TreeID
from loro_tpu_torch.errors import CodecDecodeError, DecodeError
from loro_tpu_torch.native import explode_tree_payload as pexplode_tree
from loro_tpu_torch.ops import tree_batch as ptb
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.parallel.fleet import DeviceTreeBatch, Fleet
from loro_tpu_torch.storage import MemKvStore

# peers past 2^63, with a low half past 2^31, and small ones
PEERS = ((1 << 63) + (1 << 31) + 9, 5, (1 << 32) + 3, (1 << 31) + 7)


def _mesh():
    return make_mesh(jax.devices()[:1])


def _jax_merge(target, parent, valid, n, d_max=None):
    p, e = jtb.tree_merge_batch(jtb.TreeOpCols(jnp.asarray(target), jnp.asarray(parent), jnp.asarray(valid)), n, d_max)
    return np.asarray(p), np.asarray(e)


def _port_merge(target, parent, valid, n, d_max=None):
    p, e = ptb.tree_merge_batch(ptb.TreeOpCols(*(torch.from_numpy(a) for a in (target, parent, valid))), n, d_max)
    assert p.dtype == torch.int32 and e.dtype == torch.bool
    return p.numpy(), e.numpy()


def _bench_cols(rng, d: int, m: int, n: int):
    """The JAX bench's columns (bench.py:407-412): targets uniform in
    [0, n), parents uniform in [-2, n), with pads at each doc's tail."""
    target = rng.integers(0, n, (d, m)).astype(np.int32)
    parent = rng.integers(-2, n, (d, m)).astype(np.int32)
    valid = np.arange(m)[None, :] < rng.integers(m // 2, m + 1, (d, 1))
    return target, parent, valid


# ---- the replay on raw columns ---------------------------------------------------


@pytest.mark.parametrize("d_max", [None, 3])
def test_tree_merge_batch_matches_jax_on_bench_columns(d_max):
    """The plain version against JAX on the bench's random columns (some
    cycle checks cut short at d_max = 3), and on ordinals past n (the
    clip JAX applies); some moves are rejected."""
    rng = np.random.default_rng(7)
    target, parent, valid = _bench_cols(rng, 5, 128, 40)
    target[:, ::11] = 43  # past n: clipped to n - 1 in the table
    parent[:, ::13] = 41
    got = _port_merge(target, parent, valid, 40, d_max)
    want = _jax_merge(target, parent, valid, 40, d_max)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert (~got[1] & valid).any() and (got[0] == ptb.ABSENT).any()


@pytest.mark.parametrize("d_max", [None, 1, 2, 3])
def test_cycle_walk_edges_match_jax(d_max):
    """One doc a case, each against JAX at several d_max: a move onto
    itself (rejected), parents ROOT and TRASH (no walk), a parent never
    created (the walk stops at once), a chain walked to its end, a d_max
    that cuts the walk where cur == t after the loop still catches the
    hit, and padding rows (target 0, parent ROOT, invalid) that never
    write."""
    cases = [
        [(0, 0), (1, 1)],  # onto itself
        [(0, -1), (1, -2), (0, 1)],  # ROOT, TRASH, then under a trashed node
        [(0, 5), (1, 0)],  # parent 5 never created
        [(0, -1), (1, 0), (2, 1), (3, 2), (0, 3)],  # chain 3 -> 2 -> 1 -> 0: the cycle at depth 4
        [(0, -1), (1, 0), (2, 1), (0, 2)],  # depth 3: caught at d_max 2 by the check after the loop
        [(0, -1), (1, 0), (1, 1), (0, 1)],
    ]
    m, n = 8, 6
    target = np.zeros((len(cases), m), np.int32)
    parent = np.full((len(cases), m), ptb.ROOT, np.int32)
    valid = np.zeros((len(cases), m), bool)
    for i, moves in enumerate(cases):
        for k, (t, p) in enumerate(moves):
            target[i, k], parent[i, k], valid[i, k] = t, p, True
    got = _port_merge(target, parent, valid, n, d_max)
    want = _jax_merge(target, parent, valid, n, d_max)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert not got[1][~valid].any()
    if d_max is None:
        assert not got[1][0, 1] and not got[1][3, 4] and got[1][2, 1]


def _log_cols(rng, d: int, m: int, n: int):
    """Unsorted resident logs: lamports crowded on few values (duplicate
    keys), peers among PEERS (bit 63 set, low halves past 2^31), pads
    scattered through the rows, plus the bench's targets and parents."""
    lam = rng.integers(0, 6, (d, m)).astype(np.int32)
    pu = np.asarray(PEERS, np.uint64)[rng.integers(0, len(PEERS), (d, m))]
    ctr = rng.integers(0, 4, (d, m)).astype(np.int32)
    target = rng.integers(0, n, (d, m)).astype(np.int32)
    parent = rng.integers(-2, n, (d, m)).astype(np.int32)
    valid = rng.random((d, m)) < 0.85
    return lam, (pu >> np.uint64(32)).astype(np.uint32), (pu & np.uint64(0xFFFFFFFF)).astype(np.uint32), ctr, \
        target, parent, valid


def test_tree_replay_log_batch_matches_jax():
    """Sorting on the device by (lamport, peer u64, counter), pads last,
    ties in row order, then the replay: parents and effected in row
    order equal JAX's, with the peer halves as int64 holding uint32."""
    rng = np.random.default_rng(3)
    lam, hi, lo, ctr, target, parent, valid = _log_cols(rng, 4, 96, 24)
    jp, je = jtb.tree_replay_log_batch(jtb.TreeLogCols(*(jnp.asarray(a) for a in
                                                         (lam, hi, lo, ctr, target, parent, valid))), 24)
    cols = ptb.TreeLogCols(*(pfleet._to_device(a, torch.device("cpu")) for a in
                             (lam, hi, lo, ctr, target, parent, valid)))
    assert cols.peer_hi.dtype == torch.int64 and int(cols.peer_hi.max()) >= 2**31
    pp, pe = ptb.tree_replay_log_batch(cols, 24)
    assert np.array_equal(pp.numpy(), np.asarray(jp)) and np.array_equal(pe.numpy(), np.asarray(je))
    assert not pe.numpy()[~valid].any() and (pe.numpy() != valid).any()


def test_plain_order_form_equals_the_sorted_form():
    """replay_plain with a permutation (the kernel's resident form) equals
    the replay of the gathered columns, effected scattered back."""
    rng = np.random.default_rng(11)
    target, parent, valid = (torch.from_numpy(a) for a in _bench_cols(rng, 3, 64, 20))
    order = torch.stack([torch.randperm(64, generator=torch.Generator().manual_seed(i)) for i in range(3)])
    p1, e1, l1 = ptb.replay_plain(target, parent, valid, 20, order=order.to(torch.int32))
    p2, e2, l2 = ptb.replay_plain(*(c.gather(1, order) for c in (target, parent, valid)), 20)
    assert torch.equal(p1, p2) and torch.equal(l1, l2)
    assert torch.equal(e1.gather(1, order), e2)
    assert bool((l1 >= 64).all()) and bool((l1 > 64).any())


# ---- the kernel's layout (plan_replay) and its timed split, on the host -----------

# docs a warp plan_replay picks on an H100's 132 SMs: 1 where the warps
# fit the card in one wave, more past that; n = 2,048 fits 16 docs' tables
# a CTA, n = 60,000 none (the global variant)
PLAN_CHOICE = {
    (1, 512): ("smem", 1), (8, 512): ("smem", 1), (1024, 512): ("smem", 1), (10240, 512): ("smem", 16),
    (1, 2048): ("smem", 1), (8, 2048): ("smem", 1), (1024, 2048): ("smem", 1), (10240, 2048): ("smem", 4),
    (1, 60000): ("global", 1), (8, 60000): ("global", 1), (1024, 60000): ("global", 1),
    (10240, 60000): ("global", 16),
}


@pytest.mark.parametrize("d,n", sorted(PLAN_CHOICE))
def test_plan_replay_choice(d, n):
    """The layout rule at D in {1, 8, 1,024, 10,240} x n in {512, 2,048,
    60,000}: the docs a warp, the variant, a CTA's shared memory within
    the limit, and the fewest waves of warps among the layouts."""
    plan = ptb.plan_replay(d, n, 132)
    assert (plan.variant, plan.docs_per_warp) == PLAN_CHOICE[d, n]
    assert plan.smem_bytes <= ptb.SMEM_LIMIT and plan.n_nodes == n
    assert plan.warps(d) == -(-d // plan.docs_per_warp)
    assert ptb.plan_replay(d, n, 132, plan.variant) == plan
    if n < 60000:
        assert ptb.plan_replay(d, n, 132, "global").variant == "global"


def test_plan_replay_layout_sizes_and_errors():
    """Tiles of 32 moves a doc (16 at 32 docs a warp), the odd stride, a
    CTA's bytes, plan_variant's largest power of two of tables, and the
    errors of both plan functions."""
    assert [ptb.tile_moves(g) for g in ptb.DOCS_PER_WARP] == [32, 32, 32, 32, 32, 16]
    plan = ptb.ReplayPlan("smem", 32, 512)
    assert plan.stride == 513 and plan.tile == 16 and plan.smem_bytes == (32 * 513 + 1) * 4 + 13 * 32 * 16
    assert ptb.ReplayPlan("smem", 1, 513).stride == 515 and ptb.table_stride(2048) == 2049
    assert ptb.ReplayPlan("global", 4, 512).smem_bytes == 13 * 4 * 32 and ptb.ReplayPlan("global", 4, 512).stride == 512
    assert ptb.plan_variant(512) == ("smem", 32) and ptb.plan_variant(2048) == ("smem", 16)
    assert ptb.plan_variant(4000) == ("smem", 8) and ptb.plan_variant(60000) == ("global", 32)
    assert ptb.plan_variant(512, "global") == ("global", 32)
    last = max(n for n in range(57_900, 58_100) if ptb.plan_variant(n)[0] == "smem")
    assert ptb.ReplayPlan("smem", 1, last).smem_bytes <= ptb.SMEM_LIMIT < ptb.ReplayPlan("smem", 1, last + 2).smem_bytes
    with pytest.raises(ValueError):
        ptb.plan_variant(512, "texture")
    with pytest.raises(ValueError):
        ptb.plan_variant(60000, "smem")
    with pytest.raises(ValueError):
        ptb.plan_variant(0)
    with pytest.raises(ValueError):
        ptb.plan_replay(-1, 512, 132)
    with pytest.raises(ValueError):
        ptb.plan_replay(8, 512, 0)
    assert ptb.plan_replay(0, 512, 132).docs_per_warp == 1
    # fewer SMs: more docs a warp for the same docs
    assert ptb.plan_replay(1024, 512, 8).docs_per_warp > ptb.plan_replay(1024, 512, 132).docs_per_warp


def test_replay_split_reads_the_stamps():
    """replay_split on two warps' stamps: shares of the summed cycles,
    cycles a walk step, active lanes over 32 and over the docs, and the
    mean and warp walks a move."""
    st = torch.tensor([[1000, 600, 100, 200, 10, 40, 50, 30],
                       [800, 500, 100, 100, 10, 20, 30, 20]], dtype=torch.int64)
    sp = ptb.replay_split(st, n_docs=8, m=5, docs_per_warp=4)
    assert sp["warps"] == 2 and sp["longest_warp_cycles"] == 1000 and sp["mean_warp_cycles"] == 900
    assert sp["walk_share"] == 1100 / 1800 and sp["wait_share"] == 200 / 1800 and sp["book_share"] == 300 / 1800
    assert sp["walk_cycles_per_step"] == 1100 / 20 and sp["book_cycles_per_move"] == 300 / 10
    assert sp["active_lanes_of_32"] == 60 / 640 and sp["active_lanes_of_docs"] == 60 / 80
    assert sp["mean_walk_per_move"] == 80 / 40 and sp["warp_walk_per_move"] == 50 / 10


def test_launch_wrappers_reject_cpu_tensors():
    """The kernel's wrappers take CUDA tensors only: a CPU column raises
    before any launch (tree_merge_batch routes CPU tensors to the plain
    version instead)."""
    t = torch.zeros((2, 4), dtype=torch.int32)
    v = torch.ones((2, 4), dtype=torch.bool)
    before = dict(ptb.LAUNCHES)
    for call in (lambda: ptb.launch_kernel(t, t, v, 4), lambda: ptb.launch_timed(t, t, v, 4),
                 lambda: ptb.launch_plan(t, t, v, 4, ptb.plan_replay(2, 4, 132))):
        with pytest.raises(ValueError):
            call()
    assert ptb.LAUNCHES == before


def test_is_deleted_batch_matches_jax():
    """Trash reachability by pointer doubling on replayed parents (deep
    chains under trashed nodes)."""
    rng = np.random.default_rng(5)
    target, parent, valid = _bench_cols(rng, 4, 200, 33)
    parents, _ = _port_merge(target, parent, valid, 33)
    chain = np.arange(-1, 32, dtype=np.int32)[None]  # node i under node i - 1
    chain[0, 5] = ptb.TRASH
    parents = np.concatenate([parents, chain])
    got = ptb.is_deleted_batch(torch.from_numpy(parents)).numpy()
    want = np.asarray(jtb.is_deleted_batch(jnp.asarray(parents)))
    assert np.array_equal(got, want) and got[-1, 5:].all() and not got[-1, :5].any()


# ---- host extracts and the native explode ---------------------------------------


def _tree_docs(seed: int, n_peers: int = 3, steps: int = 80, fractional: bool = True):
    """The random multi-peer tree editing of the JAX package's kernel
    tests (tests/test_tree_kernel.py), fractional positions on, peers
    among PEERS: creates, moves (some rejected locally), deletes and
    partial syncs, then a full sync.  Returns the docs (all equal)."""
    rng = random.Random(seed)
    docs = [LoroDoc(peer=PEERS[i] + seed) for i in range(n_peers)]
    if fractional:
        for d in docs:
            d.get_tree("tr").enable_fractional_index(0)
    for _ in range(steps):
        d = rng.choice(docs)
        tr = d.get_tree("tr")
        nodes = tr.nodes()
        r = rng.random()
        if not nodes or r < 0.35:
            tr.create(rng.choice(nodes) if nodes and rng.random() < 0.5 else None)
        elif r < 0.7 and len(nodes) >= 2:
            x, y = rng.sample(nodes, 2)
            try:
                tr.move(x, y)
            except ValueError:
                pass
        elif r < 0.85:
            tr.delete(rng.choice(nodes))
        if rng.random() < 0.3:
            src, dst = rng.sample(docs, 2)
            dst.import_(src.export_updates(dst.oplog_vv()))
    for _ in range(2):
        for s in docs:
            for t in docs:
                if s is not t:
                    t.import_(s.export_updates(t.oplog_vv()))
    assert docs[0].get_deep_value() == docs[-1].get_deep_value()
    return docs


@pytest.fixture(scope="module")
def tree_payloads():
    return [strip_envelope(_tree_docs(seed)[0].export_updates()) for seed in range(4)]


def _pcid(name: str = "tr") -> ContainerID:
    return ContainerID.root(name, ContainerType.Tree)


def _jcid(name: str = "tr"):
    return LoroDoc(peer=1).get_tree(name).id


def _same_extract(got, want):
    (pc, pn, ppos), (jc, jn, jpos) = got, want
    for a, b in zip(pc, jc):
        assert np.array_equal(np.asarray(a), np.asarray(b)) and np.asarray(a).dtype == np.asarray(b).dtype
    assert [tuple(t) for t in pn] == [tuple(t) for t in jn]
    assert list(ppos) == list(jpos)


def test_extracts_and_native_explode_match_jax(tree_payloads):
    """explode_tree_payload column for column, extract_tree_from_payload
    (packed wire-id node order) and extract_tree_ops (first-seen order)
    against JAX on every payload, and a container the payload lacks."""
    rows = 0
    for p in tree_payloads:
        _peers, _keys, cids, _ = read_tables(p)
        i = cids.index(_pcid())
        got, want = pexplode_tree(p, i), jexplode_tree(p, i)
        assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
        rows += len(got["lamport"])
        _same_extract(ptb.extract_tree_from_payload(p, _pcid()), jtb.extract_tree_from_payload(p, _jcid()))
        _same_extract(ptb.extract_tree_ops(pdecode(p), _pcid()), jtb.extract_tree_ops(jdecode(p), _jcid()))
        _same_extract(ptb.extract_tree_from_payload(p, _pcid("none")), jtb.extract_tree_from_payload(p, _jcid("none")))
    assert rows > 100


def test_positions_of_matches_jax(tree_payloads):
    p = tree_payloads[0]
    cols, nodes, pos = ptb.extract_tree_from_payload(p, _pcid())
    _, eff = _port_merge(*(a[None] for a in cols), len(nodes))
    jcols, _, jpos = jtb.extract_tree_from_payload(p, _jcid())
    got = ptb.positions_of(cols, pos, eff[0])
    assert got == jtb.positions_of(jcols, jpos, eff[0]) and any(v for v in got.values())


# ---- one-shot fleet merges --------------------------------------------------------


def _as_j(x):
    """A port TreeID / map / list in the JAX package's types."""
    if isinstance(x, TreeID):
        return JTreeID(x.peer, x.counter)
    if isinstance(x, dict):
        return {_as_j(k): _as_j(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_as_j(v) for v in x]
    return x


def _loro_parents(doc):
    st = doc.state.get_or_create(doc.get_tree("tr").id)
    return {t: st.parent_of(t) for t in st.nodes if st.contains(t)}


def _loro_children(doc):
    st = doc.state.get_or_create(doc.get_tree("tr").id)
    out = {}
    for t in st.nodes:
        if st.contains(t):
            out.setdefault(st.parent_of(t), None)
    return {p: st.children_of(p) for p in out}


def test_fleet_tree_merges_match_jax_and_loro_doc(monkeypatch):
    """merge_tree_payloads, merge_tree_changes and merge_tree_children on
    four docs (one with no tree ops) against JAX's Fleet and each doc's
    LoroDoc tree state; payloads the native explode rejects take the
    counted Python decode, to the same maps."""
    docs = [_tree_docs(seed)[0] for seed in range(3)]
    plain = LoroDoc(peer=77)
    plain.get_map("m").set("k", 1)
    plain.commit()
    docs.append(plain)
    payloads = [strip_envelope(d.export_updates()) for d in docs]
    fl, jfl = Fleet(device="cpu"), JFleet(mesh=_mesh())
    got = fl.merge_tree_payloads(payloads, _pcid())
    assert _as_j(got) == jfl.merge_tree_payloads(payloads, _jcid())
    assert _as_j(got) == [_loro_parents(d) for d in docs[:3]] + [{}]
    assert _as_j(fl.merge_tree_changes([pdecode(p) for p in payloads], _pcid())) == _as_j(got)
    kids = fl.merge_tree_children([pdecode(p) for p in payloads], _pcid())
    assert _as_j(kids) == jfl.merge_tree_children([jdecode(p) for p in payloads], _jcid())
    assert _as_j(kids[:3]) == [_loro_children(d) for d in docs[:3]]
    before = pfleet.FLEET_FALLBACKS["payload_extract"]

    def rejects(payload, cid):
        raise CodecDecodeError("rejected")

    monkeypatch.setattr(pfleet, "extract_tree_from_payload", rejects)
    assert fl.merge_tree_payloads(payloads, _pcid()) == got
    assert pfleet.FLEET_FALLBACKS["payload_extract"] == before + len(payloads)


# ---- the resident batch -------------------------------------------------------------


def _tree_rounds(seed: int, n_docs: int, n_rounds: int):
    """(docs, rounds): each round, for every doc, the payload its first
    replica exports since the last round after two replicas edited the
    tree "tr" and synced (concurrent moves across replicas), or None for
    a doc left alone; one round in which every doc is left alone."""
    rng = random.Random(seed)
    docs = []
    for i in range(n_docs):
        a, b = rng.sample(PEERS, 2)
        pair = (LoroDoc(peer=a), LoroDoc(peer=b + i))
        for d in pair:
            d.get_tree("tr").enable_fractional_index(0)
        docs.append(pair)
    marks = [a.oplog_vv() for a, _ in docs]
    idle = rng.randrange(1, n_rounds)
    rounds = []
    for r in range(n_rounds):
        payloads = []
        for di, (a, b) in enumerate(docs):
            if r == idle or rng.random() < 0.2:
                payloads.append(None)
                continue
            for d in (a, b):
                tr = d.get_tree("tr")
                for _ in range(rng.randint(1, 6)):
                    nodes = tr.nodes()
                    u = rng.random()
                    if not nodes or u < 0.4:
                        tr.create(rng.choice(nodes) if nodes and rng.random() < 0.6 else None)
                    elif u < 0.85 and len(nodes) >= 2:
                        x, y = rng.sample(nodes, 2)
                        try:
                            tr.move(x, y)
                        except ValueError:
                            pass
                    else:
                        tr.delete(rng.choice(nodes))
                d.commit()
            b.import_(a.export_updates(b.oplog_vv()))
            a.import_(b.export_updates(a.oplog_vv()))
            payloads.append(strip_envelope(a.export_updates(marks[di])))
            marks[di] = a.oplog_vv()
        rounds.append(payloads)
    return docs, rounds


def _tree_pair(n_docs: int, cap: int, node_cap: int, auto_grow: bool = True):
    return (JTreeBatch(n_docs, cap, node_cap, mesh=_mesh(), auto_grow=auto_grow),
            DeviceTreeBatch(n_docs, cap, node_cap, device="cpu", auto_grow=auto_grow))


def _same_tree(jb, pb) -> bytes:
    blob = pb.export_state()
    assert blob == jb.export_state()
    assert (pb.cap, pb.node_cap, pb.epoch) == (jb.cap, jb.node_cap, jb.epoch)
    return blob


@pytest.mark.parametrize("path", ["payloads", "changes", "rejected"])
def test_device_tree_batch_matches_jax_every_round(path, monkeypatch):
    """Random rounds through append_payloads, append_changes, or
    append_payloads with every payload rejected by the native explode
    (the counted Python walk), from 16 rows and 4 nodes with auto_grow
    (both grow): equal checkpoint bytes after every round (an all-idle
    round too), equal parent and children maps, and the final maps equal
    each doc's LoroDoc tree state."""
    docs, rounds = _tree_rounds(1, 3, 6)
    jb, pb = _tree_pair(3, 16, 4)
    before = pfleet.FLEET_FALLBACKS["payload_decode"]
    if path == "rejected":
        def rejects(payload, i):
            raise CodecDecodeError("rejected")

        monkeypatch.setattr(pnative, "explode_tree_payload", rejects)
    for payloads in rounds:
        if path != "changes":
            jb.append_payloads(payloads, _jcid())
            pb.append_payloads(payloads, _pcid())
        else:
            jb.append_changes([jdecode(p) if p else None for p in payloads], _jcid())
            pb.append_changes([pdecode(p) if p else None for p in payloads], _pcid())
        _same_tree(jb, pb)
        got = pb.parent_maps()
        assert _as_j(got) == jb.parent_maps()
    assert pb.cap > 16 and pb.node_cap > 4 and pb.epoch == len(rounds)
    fell_back = pfleet.FLEET_FALLBACKS["payload_decode"] - before
    assert fell_back == (sum(p is not None for r in rounds for p in r) if path == "rejected" else 0)
    assert _as_j(got) == [_loro_parents(a) for a, _ in docs]
    kids = pb.children_maps()
    assert _as_j(kids) == jb.children_maps() == [_loro_children(a) for a, _ in docs]


def test_tree_import_state_both_directions():
    """Each package imports the other's checkpoint, and the two then
    ingest the same rounds to equal bytes and maps."""
    _docs, rounds = _tree_rounds(4, 2, 6)
    jb, pb = _tree_pair(2, 32, 8)
    for payloads in rounds[:3]:
        jb.append_payloads(payloads, _jcid())
        pb.append_payloads(payloads, _pcid())
    blob = _same_tree(jb, pb)
    p2 = DeviceTreeBatch.import_state(jb.export_state(), device="cpu")
    j2 = JTreeBatch.import_state(blob, mesh=_mesh())
    assert p2.export_state() == blob and j2.export_state() == blob
    for payloads in rounds[3:]:
        j2.append_payloads(payloads, _jcid())
        p2.append_payloads(payloads, _pcid())
        pb.append_payloads(payloads, _pcid())
        assert _same_tree(j2, p2) == pb.export_state()
    assert _as_j(p2.children_maps()) == j2.children_maps()


def test_tree_capacity_error_leaves_the_batch_untouched_and_grow_works():
    """Past the move or node capacity without auto_grow: RuntimeError from
    both packages, and the batch exports the bytes it had (epoch
    included); grow then takes the same append, and an append of no tree
    ops still ticks the epoch."""
    a = LoroDoc(peer=PEERS[0])
    tr = a.get_tree("tr")
    x = tr.create()
    for _ in range(20):
        x = tr.create(x)
    a.commit()
    p = strip_envelope(a.export_updates())
    for move_cap, node_cap, what in ((16, 64, "move capacity"), (64, 8, "node capacity")):
        for b, cid in ((JTreeBatch(1, move_cap, node_cap, mesh=_mesh()), _jcid()),
                       (DeviceTreeBatch(1, move_cap, node_cap, device="cpu"), _pcid())):
            before = b.export_state()
            with pytest.raises(RuntimeError, match=what):
                b.append_payloads([p], cid)
            assert b.export_state() == before and b.epoch == 0 and b.nodes[0] == []
            b.grow(move_capacity=64, node_capacity=64)
            b.append_payloads([p], cid)
            assert b.cap == 64 and b.node_cap == 64 and len(b.nodes[0]) == 21
    pb = DeviceTreeBatch(1, 16, 4, device="cpu", auto_grow=True)
    pb.append_payloads([p], _pcid())
    assert (pb.cap, pb.node_cap) == (32, 32) and len(pb.parent_maps()[0]) == 21
    m = LoroDoc(peer=3)
    m.get_map("m").set("k", 1)
    m.commit()
    pb.append_payloads([strip_envelope(m.export_updates())], _pcid())
    pb.append_changes([None], _pcid())
    assert pb.epoch == 3 and int(pb.counts[0]) == 21


def test_tree_corrupt_state_raises_decode_error():
    """A flipped byte, a truncated store, a node ordinal past the node
    dictionary, a count past capacity and an implausible capacity raise
    DecodeError."""
    _docs, rounds = _tree_rounds(2, 1, 3)
    pb = DeviceTreeBatch(1, 64, 16, device="cpu", auto_grow=True)
    for payloads in rounds:
        pb.append_payloads(payloads, _pcid())
    good = pb.export_state()
    assert DeviceTreeBatch.import_state(good, device="cpu").export_state() == good
    blob = bytearray(good)
    blob[25] ^= 0xFF
    with pytest.raises(DecodeError):
        DeviceTreeBatch.import_state(bytes(blob), device="cpu")
    with pytest.raises(DecodeError):
        DeviceTreeBatch.import_state(good[:-7], device="cpu")
    kv = MemKvStore()
    kv.import_all(good)
    kv.set(b"doc/00000000/nodes", b"\x00")  # no nodes, rows that name some
    with pytest.raises(DecodeError, match="ordinal"):
        DeviceTreeBatch.import_state(kv.export_all(), device="cpu")
    kv.import_all(good)
    # version 2, 1 doc of width 1, move capacity 2^32 - 1
    kv.set(b"meta", bytes([2, 1, 1]) + b"\xff\xff\xff\xff\x0f" + bytes([16, 0, 0, 1]))
    with pytest.raises(DecodeError, match="implausible move_capacity"):
        DeviceTreeBatch.import_state(kv.export_all(), device="cpu")
    kv.import_all(good)
    kv.set(b"meta", bytes([2, 1, 1, 4, 16, 5, 1, 1]))  # 5 rows in a log of capacity 4
    with pytest.raises(DecodeError, match="count exceeds capacity"):
        DeviceTreeBatch.import_state(kv.export_all(), device="cpu")


# ---- tracegen ------------------------------------------------------------------------


def test_tracegen_tree_oracle_agrees_with_loro_doc():
    """A small tree trace imported epoch by epoch into a LoroDoc: after
    each epoch its live parents and ordered children equal oracle_tree of
    that prefix; the trace has creates, moves, deletes, rejected moves
    and a bit-63 peer."""
    doc = tracegen.tree_doc(3, n_moves=600, n_nodes=150, sync_every=150)
    assert doc.n_epochs == 4 and any(p >> 63 for p in doc.peers)
    ld = LoroDoc(peer=1)
    for e, p in enumerate(tracegen.tree_epoch_payloads(doc)):
        ld.import_(frame_columnar_updates(jdecode(p)))
        parents, children, rejected = tracegen.oracle_tree(doc, e + 1)
        st = ld.state.get_or_create(ld.get_tree("tree").id)
        assert _as_j(parents) == {t: st.parent_of(t) for t in st.nodes if st.contains(t)}
        assert _as_j(children) == {p: st.children_of(p) for p in _as_j(children)}
    kinds = [op.content for ch in doc.changes for op in ch.ops]
    assert sum(c.is_create for c in kinds) == 150 and any(c.is_delete for c in kinds) and rejected > 0


def test_tracegen_tree_traces_through_every_port_path():
    """Two small traces through merge_tree_payloads, merge_tree_children
    and a DeviceTreeBatch fed one epoch a round (it grows): the oracle's
    maps at every prefix, and the JAX batch's bytes."""
    docs = [tracegen.tree_doc(s, n_moves=400, n_nodes=100, sync_every=100) for s in range(2)]
    cid = tracegen.TREE_CID
    fl = Fleet(device="cpu")
    want = [tracegen.oracle_tree(d) for d in docs]
    assert fl.merge_tree_payloads([tracegen.tree_payload(d) for d in docs], cid) == [w[0] for w in want]
    assert fl.merge_tree_children([d.changes for d in docs], cid) == [w[1] for w in want]
    eps = [tracegen.tree_epoch_payloads(d) for d in docs]
    jb, pb = _tree_pair(2, 64, 16)
    for e in range(docs[0].n_epochs):
        jb.append_payloads([ep[e] for ep in eps], _jcid("tree"))
        pb.append_payloads([ep[e] for ep in eps], cid)
        _same_tree(jb, pb)
        pre = [tracegen.oracle_tree(d, e + 1) for d in docs]
        assert pb.parent_maps() == [w[0] for w in pre] and pb.children_maps() == [w[1] for w in pre]
    assert pb.cap == 512 and pb.node_cap == 128
