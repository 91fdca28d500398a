"""The port's host engine (loro_tpu_torch.doc.LoroDoc and its layers)
against the JAX package's LoroDoc on the CPU.

Both packages get the same seeded inputs: one random.Random(seed)
decides every step from the JAX doc's state (the port's is equal, or a
check has already failed), peers are pinned, and where a path draws a
peer from the global `random` (fork, detached editing) it is seeded
identically before each package's call.  Results are compared through
`plain`, a package-neutral form (class names, field values, ids and
container ids as tuples or strings), never by == across packages.
Every comparison is exact (tolerance: none): deep values, versions,
events, and the bytes of every export mode.

The wire format is the carrier of state between the packages: bytes
that either package exports import into the other (no conversion
function exists or is needed).
"""
import dataclasses
import enum
import json
import random

import pytest

import loro_tpu as J
import loro_tpu_torch as P
from loro_tpu.models import seq_crdt as j_seq
from loro_tpu.utils import treap as j_treap
from loro_tpu_torch.models import seq_crdt as p_seq
from loro_tpu_torch.utils import treap as p_treap

PKGS = (J, P)
VALUES = [None, True, False, 0, -7, 2**40, -(2**62), 2.5, -0.0, "", "v☃", b"", b"\x00\xff", [1, "a", None],
          {"n": 2.5, "l": [True, {"x": b"\x01"}]}]
KINDS = ("Text", "Map", "List", "MovableList", "Tree", "Counter")


def plain(x):
    """A package-neutral form: scalars tagged by type (so True != 1 and
    1 != 1.0), enums by class and name, containers recursively, ids and
    versions as tuples, container ids as their string form."""
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return (type(x).__name__, x)
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return ("dict", [(plain(k), plain(v)) for k, v in x.items()])
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(plain(v)) for v in x))
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # ID, IdSpan, TreeID, ...
        return (type(x).__name__,) + tuple(plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [plain(v) for v in x])
    name = type(x).__name__
    if name == "ContainerID":
        return ("cid", str(x))
    if name == "Frontiers":
        return ("Frontiers", [plain(i) for i in x.as_ids()])
    if name == "VersionVector":
        return ("VV", sorted(x.items()))
    if name == "VersionRange":
        return ("VR", sorted(x.items()))
    if name == "_RunCont":
        return ("run-cont",)
    if name == "Delta":
        return ("Delta", [plain(i) for i in x.items])
    if dataclasses.is_dataclass(x):
        return (name,) + tuple(plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (J.Handler, P.Handler)):
        return ("handler", name, str(x.id))
    if isinstance(x, (J.LoroDoc, P.LoroDoc)):  # a fork: its peer (drawn from the seeded global random)
        return ("LoroDoc", x.peer)
    raise TypeError(f"no plain form for {name}")


def conv(pkg, x):
    """Rebuild a plain-ish argument (TreeID / Frontiers / VersionVector
    given as tuples) in package `pkg`."""
    kind, v = x
    if kind == "tree":
        return None if v is None else pkg.TreeID(*v)
    if kind == "frontiers":
        return pkg.Frontiers([pkg.ID(p, c) for p, c in v])
    if kind == "vv":
        return pkg.VersionVector(dict(v))
    if kind == "ctype":
        return pkg.ContainerType[v]
    raise ValueError(kind)


def both(fn, *, seed=None):
    """Run fn(pkg_index) for each package; the two results (or raised
    exception class names) must be equal in plain form.  Returns the
    two raw results (None where an exception was raised)."""
    outs, raw = [], []
    for k in range(2):
        if seed is not None:
            random.seed(seed)
        try:
            r = fn(k)
        except (J.LoroError, P.LoroError, ValueError, KeyError, IndexError, TypeError, AssertionError) as e:
            outs.append(("raise", type(e).__name__))
            raw.append(None)
            continue
        outs.append(("ok", plain(r)))
        raw.append(r)
    assert outs[0] == outs[1], outs
    return raw


def fr_of(doc):
    return ("frontiers", [(i.peer, i.counter) for i in doc.oplog_frontiers().as_ids()])


def vv_of(doc):
    return ("vv", sorted(doc.oplog_vv().items()))


class Twins:
    """n peers, each one LoroDoc per package, with root subscribers."""

    def __init__(self, peers, merge_interval=None):
        self.docs = [[pkg.LoroDoc(peer=p) for pkg in PKGS] for p in peers]
        self.events = [[[], []] for _ in peers]
        self.frontiers = [[("frontiers", [])] for _ in peers]
        self.children = [[] for _ in peers]  # (kind, cid string) of nested containers
        for i in range(len(peers)):
            self._subscribe(i)
            if merge_interval is not None:
                for d in self.docs[i]:
                    d.set_change_merge_interval(merge_interval)

    def _subscribe(self, i):
        """A root subscriber and one on each of the text "t" and the map
        "m" (container events), all into one log a doc."""
        for k, d in enumerate(self.docs[i]):
            log = lambda ev, i=i, k=k, tag="root": self.events[i][k].append((tag, plain(ev)))  # noqa: E731
            d.subscribe_root(log)
            for name, ctype in (("t", "Text"), ("m", "Map")):
                cid = PKGS[k].ContainerID.root(name, PKGS[k].ContainerType[ctype])
                d.subscribe(cid, lambda ev, i=i, k=k, tag=name: self.events[i][k].append((tag, plain(ev))))

    def on(self, i, fn, seed=None):
        return both(lambda k: fn(PKGS[k], self.docs[i][k]), seed=seed)

    def replace(self, i, pair):
        self.docs[i] = pair
        self.events[i] = [[], []]
        self._subscribe(i)

    def check(self, i, exports=True):
        """Every read of peer i equal across the packages, and the events
        since the last check."""
        ev = self.events[i]
        assert ev[0] == ev[1]
        ev[0].clear(), ev[1].clear()
        self.on(i, lambda pkg, d: (d.get_deep_value(), d.get_deep_value_with_id(), d.oplog_vv(),
                                   d.oplog_frontiers(), d.state_vv(), d.state_frontiers(), d.is_detached()))
        if not exports:
            return
        i2 = (i + 1) % len(self.docs)
        vv = vv_of(self.docs[i2][0])
        fr = random.Random(len(self.frontiers[i])).choice(self.frontiers[i])
        self.on(i, lambda pkg, d: (
            d.export_updates(conv(pkg, vv)),
            d.export_snapshot(),
            d.export(pkg.ExportMode.ShallowSnapshot(conv(pkg, fr))),
            d.export(pkg.ExportMode.StateOnly),
            json.dumps(d.export_json_updates(conv(pkg, vv)), sort_keys=True),
        ))


def _edit(tw, rng, i):
    """One random edit of peer i on one of the six container kinds or a
    nested container."""
    jd = tw.docs[i][0]
    r = rng.random()
    if r < 0.22:
        t = jd.get_text("t")
        n = len(t)
        r2 = rng.random()
        if n > 2 and r2 < 0.15:
            a = rng.randint(0, n - 2)
            b = rng.randint(a + 1, n)
            key, val = rng.choice([("bold", True), ("color", "red"), ("link", None), ("size", 3)])
            tw.on(i, lambda pkg, d: d.get_text("t").mark(a, b, key, val))
        elif n > 2 and r2 < 0.22:
            a = rng.randint(0, n - 2)
            b = rng.randint(a + 1, n)
            tw.on(i, lambda pkg, d: d.get_text("t").unmark(a, b, "bold"))
        elif n and r2 < 0.5:
            pos = rng.randint(0, n - 1)
            ln = min(rng.randint(1, 4), n - pos)
            tw.on(i, lambda pkg, d: d.get_text("t").delete(pos, ln))
        else:
            pos = rng.randint(0, n)
            s = rng.choice(["ab", "ç", "1234", "☃x", "x", "hello world", "😀"])
            tw.on(i, lambda pkg, d: d.get_text("t").insert(pos, s))
    elif r < 0.36:
        r2 = rng.random()
        key = rng.choice("kqzw")
        if r2 < 0.6:
            val = rng.choice(VALUES)
            tw.on(i, lambda pkg, d: d.get_map("m").set(key, val))
        elif r2 < 0.75:
            tw.on(i, lambda pkg, d: d.get_map("m").delete(key))
        else:
            kind = rng.choice(KINDS)
            h = tw.on(i, lambda pkg, d: d.get_map("m").set_container("c" + key, pkg.ContainerType[kind]))[0]
            if h is not None:
                tw.children[i].append((kind, str(h.id)))
    elif r < 0.48:
        ll = jd.get_list("l")
        n = len(ll)
        r2 = rng.random()
        if n and r2 < 0.3:
            pos = rng.randint(0, n - 1)
            ln = min(rng.randint(1, 2), n - pos)
            tw.on(i, lambda pkg, d: d.get_list("l").delete(pos, ln))
        elif r2 < 0.4:
            pos, kind = rng.randint(0, n), rng.choice(KINDS)
            h = tw.on(i, lambda pkg, d: d.get_list("l").insert_container(pos, pkg.ContainerType[kind]))[0]
            if h is not None:
                tw.children[i].append((kind, str(h.id)))
        else:
            pos = rng.randint(0, n)
            vals = [rng.choice(VALUES) for _ in range(rng.randint(1, 3))]
            tw.on(i, lambda pkg, d: d.get_list("l").insert(pos, *vals))
    elif r < 0.62:
        n = len(jd.get_movable_list("ml"))
        r2 = rng.random()
        if n < 2 or r2 < 0.35:
            pos, val = rng.randint(0, n), rng.choice(VALUES)
            tw.on(i, lambda pkg, d: d.get_movable_list("ml").insert(pos, val))
        elif r2 < 0.65:
            a, b = rng.randint(0, n - 1), rng.randint(0, n - 1)
            tw.on(i, lambda pkg, d: d.get_movable_list("ml").move(a, b))
        elif r2 < 0.85:
            a, val = rng.randint(0, n - 1), rng.choice(VALUES)
            tw.on(i, lambda pkg, d: d.get_movable_list("ml").set(a, val))
        else:
            a = rng.randint(0, n - 1)
            tw.on(i, lambda pkg, d: d.get_movable_list("ml").delete(a, 1))
    elif r < 0.78:
        ns = [tuple(x) for x in jd.get_tree("tr").nodes()]
        r2 = rng.random()
        if not ns or r2 < 0.35:
            par = rng.choice(ns) if ns and rng.random() < 0.6 else None
            tw.on(i, lambda pkg, d: d.get_tree("tr").create(conv(pkg, ("tree", par))))
        elif r2 < 0.8:
            # a move under a random node: under its own subtree it forms
            # a cycle, which both packages must refuse alike
            a, par = rng.choice(ns), rng.choice(ns + [None])
            tw.on(i, lambda pkg, d: d.get_tree("tr").move(conv(pkg, ("tree", a)), conv(pkg, ("tree", par))))
        elif r2 < 0.9:
            a = rng.choice(ns)
            key, val = rng.choice("ab"), rng.choice(VALUES)
            tw.on(i, lambda pkg, d: d.get_tree("tr").get_meta(conv(pkg, ("tree", a))).set(key, val))
        else:
            a = rng.choice(ns)
            tw.on(i, lambda pkg, d: d.get_tree("tr").delete(conv(pkg, ("tree", a))))
    elif r < 0.86:
        delta = rng.choice([1, -2, 2.5, 0.25, 7])
        tw.on(i, lambda pkg, d: d.get_counter("c").increment(delta))
    elif tw.children[i]:
        kind, cid = rng.choice(tw.children[i])
        _edit_child(tw, rng, i, kind, cid)


def _edit_child(tw, rng, i, kind, cid):
    """An edit of a nested container, by its container id string (its
    length read in both packages alike: a read materialises the state)."""
    n = 0
    if kind in ("Text", "List", "MovableList"):
        n = tw.on(i, lambda pkg, d: len(d.get_container(cid).get_value()))[0] or 0
    if kind == "Text":
        pos, s = rng.randint(0, n), rng.choice(["n", "est", "é"])
        tw.on(i, lambda pkg, d: d.get_container(cid).insert(pos, s))
    elif kind == "Map":
        key, val = rng.choice("xy"), rng.choice(VALUES)
        tw.on(i, lambda pkg, d: d.get_container(cid).set(key, val))
    elif kind in ("List", "MovableList"):
        pos, val = rng.randint(0, n), rng.choice(VALUES)
        tw.on(i, lambda pkg, d: d.get_container(cid).insert(pos, val))
    elif kind == "Tree":
        tw.on(i, lambda pkg, d: d.get_container(cid).create(None))
    elif kind == "Counter":
        tw.on(i, lambda pkg, d: d.get_container(cid).increment(3))


def _step(tw, rng, step):
    """One fuzz step; returns the peer whose reads changed."""
    n = len(tw.docs)
    i = rng.randrange(n)
    r = rng.random()
    if r < 0.55:
        if tw.docs[i][0].is_detached() and rng.random() < 0.8:
            tw.on(i, lambda pkg, d: d.checkout_to_latest())  # else the edit raises (detached)
        _edit(tw, rng, i)
    elif r < 0.65:
        msg = rng.choice([None, "m", "msg ☃"])
        tw.on(i, lambda pkg, d: d.commit(message=msg))
        tw.frontiers[i].append(fr_of(tw.docs[i][0]))
    elif r < 0.84:
        j = rng.choice([x for x in range(n) if x != i])
        src = tw.docs[j]
        tw.on(i, lambda pkg, d: d.import_(src[PKGS.index(pkg)].export_updates(d.oplog_vv())))
        tw.frontiers[i].append(fr_of(tw.docs[i][0]))
    elif r < 0.9:
        fr = rng.choice(tw.frontiers[i])
        tw.on(i, lambda pkg, d: d.checkout(conv(pkg, fr)))
    elif r < 0.96:
        tw.on(i, lambda pkg, d: d.checkout_to_latest())
    else:
        seed = rng.getrandbits(32)
        pair = tw.on(i, lambda pkg, d: d.fork(), seed=seed)
        if pair[0] is not None:
            tw.replace(i, pair)
    return i


def _sync_all(tw):
    n = len(tw.docs)
    for i in range(n):
        tw.on(i, lambda pkg, d: d.checkout_to_latest())
    for _ in range(2):
        for i in range(n):
            for j in range(n):
                if i != j:
                    src = tw.docs[j]
                    tw.on(i, lambda pkg, d: d.import_(src[PKGS.index(pkg)].export_updates(d.oplog_vv())))


@pytest.mark.parametrize("seed", range(8))
def test_differential_fuzz(seed):
    """8 seeds x 160 steps of edits on 3 peers (six container kinds,
    nested containers, every value tag, marks, tree moves that would
    form cycles, movable moves and sets), commits, one-way syncs,
    checkouts, checkout_to_latest and forks: after every step the acted
    peer's deep values, versions, the events of its root and container
    subscribers and the bytes of five exports are equal; at the end all
    peers converge in both packages."""
    rng = random.Random(seed)
    tw = Twins([rng.getrandbits(40) + 1 for _ in range(3)], merge_interval=rng.choice([None, 0, 1000]))
    if seed % 2:
        for d in tw.docs[0]:
            d.get_tree("tr").enable_fractional_index(0)
    for step in range(160):
        i = _step(tw, rng, step)
        tw.check(i)
    _sync_all(tw)
    # every replica reads every nested container first: the deep value
    # of a child container nobody has read is None, of one read there []
    # (a quirk of the JAX engine, which the port keeps)
    cids = sorted({cid for ch in tw.children for _, cid in ch})
    for i in range(3):
        for cid in cids:
            tw.on(i, lambda pkg, d: d.get_container(cid).get_value())
        tw.check(i)
    for k in range(2):
        vals = [pair[k].get_deep_value() for pair in tw.docs]
        assert vals[0] == vals[1] == vals[2]


def _history(seed, steps=120):
    """A synced 3-peer history (all kinds, nested containers, marks),
    every peer at head; returns the Twins."""
    rng = random.Random(1000 + seed)
    tw = Twins([11, 22, 33])
    for step in range(steps):
        i = rng.randrange(3)
        if rng.random() < 0.8:
            _edit(tw, rng, i)
        else:
            j = (i + 1) % 3
            src = tw.docs[j]
            tw.on(i, lambda pkg, d: d.import_(src[PKGS.index(pkg)].export_updates(d.oplog_vv())))
        if step % 10 == 9:
            tw.on(i, lambda pkg, d: d.commit())
            tw.frontiers[i].append(fr_of(tw.docs[i][0]))
    _sync_all(tw)
    return tw


def _blob(pkg, d, mode, fr):
    if mode == "updates":
        return d.export_updates()
    if mode == "snapshot":
        return d.export_snapshot()
    if mode == "shallow":
        return d.export(pkg.ExportMode.ShallowSnapshot(conv(pkg, fr)))
    if mode == "state_only":
        return d.export(pkg.ExportMode.StateOnly)
    if mode == "snapshot_at":
        return d.export(pkg.ExportMode.SnapshotAt(conv(pkg, fr)))
    raise ValueError(mode)


@pytest.mark.parametrize("mode", ["updates", "snapshot", "shallow", "state_only", "snapshot_at"])
@pytest.mark.parametrize("src", [0, 1], ids=["jax_to_port", "port_to_jax"])
def test_state_carried_across(src, mode):
    """Bytes one package exports import into a fresh doc of the other
    and into one of its own: the two receivers agree on values and
    versions, and their re-exports are byte-identical; from updates and
    snapshots the receiver's value is the sender's."""
    tw = _history(src)
    pair = tw.docs[0]
    fr = tw.frontiers[0][len(tw.frontiers[0]) // 2]
    blobs = both(lambda k: _blob(PKGS[k], pair[k], mode, fr))
    blob = blobs[src]
    fresh = [pkg.LoroDoc.from_snapshot(blob) if mode != "updates" else _fresh_import(pkg, blob) for pkg in PKGS]
    both(lambda k: (fresh[k].get_deep_value(), fresh[k].get_deep_value_with_id(), fresh[k].oplog_vv(),
                    fresh[k].oplog_frontiers(), fresh[k].export_snapshot(), fresh[k].export_updates(),
                    fresh[k].export(PKGS[k].ExportMode.StateOnly)))
    if mode in ("updates", "snapshot"):
        assert fresh[1 - src].get_deep_value() == pair[src].get_deep_value()  # builtins only; dict order aside
        assert fresh[1 - src].oplog_vv() == fresh[1 - src].oplog_vv() and len(fresh[1 - src].oplog_vv()) == 3


def _fresh_import(pkg, blob):
    d = pkg.LoroDoc(peer=99)
    d.import_(blob)
    return d


@pytest.mark.parametrize("seed", range(3))
def test_container_states_on_the_same_ops(seed):
    """Each ContainerState class of the two packages, fed the same op
    list (a fuzzed history decoded by each package's own decoder) op by
    op: equal diffs returned, values and to_diff()."""
    from loro_tpu.codec.binary import decode_changes as jdec
    from loro_tpu.doc import strip_envelope as jstrip
    from loro_tpu.state import DocState as JDocState
    from loro_tpu_torch.codec.binary import decode_changes as pdec
    from loro_tpu_torch.state import DocState as PDocState

    tw = _history(seed, steps=90)
    blob = tw.docs[0][0].export_updates()
    chs = [jdec(jstrip(blob)), pdec(P.doc.strip_envelope(blob))]
    states = [{}, {}]
    kinds = set()
    for k, (pkg, DocState) in enumerate(((J, JDocState), (P, PDocState))):
        table = DocState()
        for ch in chs[k]:
            for op in ch.ops:
                st = states[k].get(str(op.container))
                if st is None:
                    st = states[k][str(op.container)] = table._new_state(op.container) \
                        if hasattr(table, "_new_state") else table.get_or_create(op.container)
                lam = ch.lamport + (op.counter - ch.ctr_start)
                d = st.apply_op(op, ch.peer, lam)
                states[k].setdefault("_diffs", []).append(plain(d))
                kinds.add(type(st).__name__)
    assert states[0].pop("_diffs") == states[1].pop("_diffs")
    assert list(states[0]) == list(states[1])
    for cid in states[0]:
        a, b = states[0][cid], states[1][cid]
        assert type(a).__name__ == type(b).__name__
        assert plain(a.get_value()) == plain(b.get_value())
        assert plain(a.to_diff()) == plain(b.to_diff())
    assert {"TextState", "MapState", "ListState", "MovableListState", "TreeState", "CounterState"} <= kinds


def test_fugue_seq_and_treap():
    """FugueSeq (integrate_insert / integrate_delete, concurrent runs
    under one parent on both sides, deletes of ids never inserted) and
    the Treap under it, driven directly with one op list."""
    rng = random.Random(5)
    seqs = [j_seq.FugueSeq(), p_seq.FugueSeq()]
    ids = []
    for step in range(400):
        if ids and rng.random() < 0.25:
            peer, ctr = rng.choice(ids + [(77, 5)])
            spans = [(peer, ctr, ctr + rng.randint(1, 3))]
            outs = [s.integrate_delete([pkg.IdSpan(*sp) for sp in spans], deleter=pkg.ID(9, step))
                    for s, pkg in zip(seqs, PKGS)]
        else:
            peer = rng.choice([1, 2, 3])
            run = [chr(97 + rng.randrange(26)) for _ in range(rng.randint(1, 4))]
            parent = rng.choice(ids) if ids and rng.random() < 0.8 else None
            side = rng.choice(["Left", "Right"]) if parent is not None else "Right"  # root children sit right
            ctr = 10 * step
            outs = []
            for s, pkg in zip(seqs, PKGS):
                pos, elems = s.integrate_insert(peer, ctr, None if parent is None else pkg.ID(*parent),
                                                pkg.Side[side], run, lamport=step)
                outs.append((pos, [(e.peer, e.counter) for e in elems]))
            ids.extend((peer, ctr + j) for j in range(len(run)))
        assert plain(outs[0]) == plain(outs[1])
        if step % 25 == 0:
            for s in seqs:
                s.check_invariants()
            got = [([(e.peer, e.counter, e.content) for e in s.visible_elems()],
                    [(e.peer, e.counter) for e in s.all_elems()], s.visible_len, s.total_len,
                    [s.placement_for_visible_pos(k) for k in range(0, s.visible_len + 1, 7)])
                   for s in seqs]
            assert plain(got[0]) == plain(got[1])
    # the treap alone: insertions at random ranks, visibility flips, rank/select
    treaps = [j_treap.Treap(), p_treap.Treap()]
    nodes = [[], []]
    for step in range(300):
        at = rng.randrange(len(nodes[0]) + 1)
        w = rng.choice([0, 1, 2])
        flip = rng.randrange(len(nodes[0])) if nodes[0] and rng.random() < 0.3 else None
        for t, ns, mod in zip(treaps, nodes, (j_treap, p_treap)):
            n = mod.TreapNode()
            n.init_treap(w)
            t.insert_after(ns[at - 1] if at else None, n)
            ns.insert(at, n)
            if flip is not None:
                t.set_visible(ns[flip], 1 - min(ns[flip].vis_w, 1))
        got = [(t.visible_len, t.total_len, [t.visible_rank(n) for n in ns[::9]],
                [t.total_rank(n) for n in ns[::11]], [ns.index(t.find_visible(k)) for k in range(0, t.visible_len, 5)])
               for t, ns in zip(treaps, nodes)]
        assert got[0] == got[1]


def test_jsonpath_cursors_and_the_diff_api():
    """jsonpath, get_cursor / get_cursor_pos across edits (text, list and
    movable list, anchors deleted), diff / apply_diff / revert_to."""
    tw = _history(7, steps=80)
    i = 0
    paths = ["$.m.k", "$..*", "$.l[0]", "$.l[-1:]", "$.ml[*]", "$['m','t']", "$.tr[0].id", "$.m[?(@ != null)]",
             "$..children", "$.l[0:4:2]"]
    for p in paths:
        tw.on(i, lambda pkg, d: d.jsonpath(p))
    fired = [[], []]
    for k, d in enumerate(tw.docs[i]):
        d.subscribe_jsonpath("$.m.k", lambda r, k=k: fired[k].append(plain(r)))
    cursors = both(lambda k: [tw.docs[i][k].get_cursor(h(tw.docs[i][k]), pos, side)
                              for h, pos in ((lambda d: d.get_text("t"), 0), (lambda d: d.get_text("t"), 3),
                                             (lambda d: d.get_list("l"), 1),
                                             (lambda d: d.get_movable_list("ml"), 1))
                              for side in (PKGS[k].CursorSide.Left, PKGS[k].CursorSide.Right)])
    rng = random.Random(3)
    f0 = fr_of(tw.docs[i][0])
    for step in range(40):
        _edit(tw, rng, i)
        if step % 4 == 0:
            tw.on(i, lambda pkg, d: d.get_map("m").set("k", step))
        tw.on(i, lambda pkg, d: [d.get_cursor_pos(c) for c in cursors[PKGS.index(pkg)]])
    tw.on(i, lambda pkg, d: d.commit())
    assert fired[0] == fired[1] and fired[0]
    f1 = fr_of(tw.docs[i][0])
    tw.on(i, lambda pkg, d: d.diff(conv(pkg, f0), conv(pkg, f1)))
    tw.on(i, lambda pkg, d: d.diff(conv(pkg, f1), conv(pkg, f0)))
    batch = both(lambda k: tw.docs[i][k].diff(conv(PKGS[k], f1), conv(PKGS[k], f0)))
    other = [pkg.LoroDoc(peer=5) for pkg in PKGS]
    snap = tw.docs[i][0].export_snapshot()
    both(lambda k: other[k].import_(snap))
    both(lambda k: (other[k].apply_diff(batch[k]), other[k].get_deep_value(), other[k].export_updates()))
    tw.check(i)
    tw.on(i, lambda pkg, d: d.revert_to(conv(pkg, f0)))
    tw.check(i)


def test_import_batch_out_of_order_and_pending():
    """Update slices imported newest first (pending, then unlocked),
    and the same slices through import_batch in a shuffled order: equal
    ImportStatus (success and pending ranges), values and exports."""
    tw = _history(9, steps=100)
    src = tw.docs[1][0]
    vv_end = src.oplog_vv()
    cuts = [J.VersionVector({p: c * q // 4 for p, c in vv_end.items()}) for q in range(5)]
    slices = [src.export(J.ExportMode.UpdatesInRange(a, b)) for a, b in zip(cuts, cuts[1:])]
    both(lambda k: [tw.docs[1][k].export(PKGS[k].ExportMode.UpdatesInRange(conv(PKGS[k], ("vv", sorted(a.items()))),
                                                                           conv(PKGS[k], ("vv", sorted(b.items())))))
                    for a, b in zip(cuts, cuts[1:])])
    one = [pkg.LoroDoc(peer=7) for pkg in PKGS]
    for blob in reversed(slices):
        both(lambda k: (one[k].import_(blob), one[k].get_deep_value(), one[k].oplog_vv()))
    rng = random.Random(2)
    order = list(range(len(slices)))
    rng.shuffle(order)
    many = [pkg.LoroDoc(peer=8) for pkg in PKGS]
    both(lambda k: (many[k].import_batch([slices[o] for o in order[:2]]), many[k].get_deep_value()))
    both(lambda k: (many[k].import_batch([slices[o] for o in order[2:]]), many[k].get_deep_value(),
                    many[k].export_snapshot(), one[k].export_snapshot()))
    assert many[1].get_deep_value() == src.get_deep_value()


def test_metrics_and_spans_count_alike():
    """The copied metrics registry and tracer: the same history and
    exports move the same counters by the same deltas (deltas, never
    absolute values: the registry is process-wide), and the same span
    names reach a span observer in the same order."""
    from loro_tpu.obs import metrics as jm
    from loro_tpu.utils import tracing as jt
    from loro_tpu_torch.obs import metrics as pm
    from loro_tpu_torch.utils import tracing as pt

    names = ["doc.export_calls_total", "doc.export_bytes_total", "doc.import_calls_total",
             "doc.import_bytes_total", "oplog.changes_applied_total", "oplog.ops_applied_total"]
    deltas, spans = [], []
    for pkg, m, tr in ((J, jm, jt), (P, pm, pt)):
        before = {n: m.counter(n).total() for n in names}
        seen = []
        obs = lambda name, dur, seen=seen: seen.append(name)  # noqa: E731
        tr.add_span_observer(obs)
        try:
            tw = _history(5, steps=40)
        finally:
            tr.remove_span_observer(obs)
        d = tw.docs[0][PKGS.index(pkg)]
        d.export(pkg.ExportMode.StateOnly)
        deltas.append({n: m.counter(n).total() - before[n] for n in names})
        spans.append(seen)
    assert deltas[0] == deltas[1] and all(deltas[0].values())
    assert spans[0] == spans[1] and spans[0]
    assert pm.counter("doc.export_calls_total").get(mode="StateOnly") >= 1


def test_one_run_continuation_class():
    """The port keeps one _RunCont (in core/change.py, where the decoder
    needs it): oplog re-exports it, and a sliced run decoded from bytes,
    from JSON and imported into a LoroDoc resolves through it as in JAX."""
    from loro_tpu_torch.codec import binary as pbin
    from loro_tpu_torch.core import change as pch
    from loro_tpu_torch.oplog import oplog as pop

    assert pop._RunCont is pch._RunCont and pop._RUN_CONT is pch._RUN_CONT
    outs = []
    for pkg in PKGS:
        a = pkg.LoroDoc(peer=3)
        a.get_text("t").insert(0, "abcdef")
        a.commit()
        vv = pkg.VersionVector({3: 2})  # inside the run: the export slices it
        blob = a.export_updates(vv)
        js = a.export_json_updates(vv)
        b = pkg.LoroDoc(peer=4)
        b.import_(a.export(pkg.ExportMode.UpdatesInRange(pkg.VersionVector(), vv)))
        b.import_(blob)
        c = pkg.LoroDoc(peer=5)
        c.import_(a.export(pkg.ExportMode.UpdatesInRange(pkg.VersionVector(), vv)))
        c.import_json_updates(js)
        outs.append((blob, json.dumps(js, sort_keys=True), b.get_deep_value(), c.get_deep_value()))
    assert outs[0] == outs[1] and outs[1][2] == outs[1][3] == {"t": "abcdef"}
    parents = [op.content.parent for ch in pbin.decode_changes(P.doc.strip_envelope(outs[1][0])) for op in ch.ops]
    assert parents and all(isinstance(x, pch._RunCont) for x in parents)
