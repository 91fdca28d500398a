"""The port's UndoManager, Awareness and EphemeralStore
(loro_tpu_torch.undo, loro_tpu_torch.awareness) against the JAX
package's, on the CPU.

Both packages' LoroDocs get the same seeded edits (decided from the JAX
doc's state; the port's is equal, or a check has already failed), an
UndoManager on the local peer's doc, and the same remote imports.
time.monotonic (the undo merge interval's clock) is replaced by one fake
clock that both packages read.  Results are compared through
test_torch_doc's package-neutral `plain`; presence blobs byte for byte.
Tolerance: exact.
"""
import random
import time

import pytest

import loro_tpu as J
import loro_tpu_torch as P
from test_torch_doc import PKGS, VALUES, both, conv, plain


class FakeClock:
    """A settable clock: time.monotonic for the undo merge interval, the
    injected clock of Awareness and EphemeralStore."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


def test_exports():
    assert P.UndoManager.__module__ == "loro_tpu_torch.undo"
    assert P.Awareness.__module__ == P.EphemeralStore.__module__ == "loro_tpu_torch.awareness"
    assert {"UndoManager", "Awareness", "EphemeralStore"} <= set(P.__all__)


# ---- UndoManager -------------------------------------------------------------------------


class UndoTwins:
    """A local doc with an UndoManager and a remote doc, one of each per
    package; the push / pop callbacks log into one list a package."""

    def __init__(self, merge_interval_ms=0, exclude=("sys",)):
        self.local = [pkg.LoroDoc(peer=1) for pkg in PKGS]
        self.remote = [pkg.LoroDoc(peer=2) for pkg in PKGS]
        self.ums = [pkg.UndoManager(d, merge_interval_ms=merge_interval_ms, exclude_origin_prefixes=list(exclude))
                    for pkg, d in zip(PKGS, self.local)]
        self.logs = [[], []]
        self.n_push = [0, 0]
        for k, um in enumerate(self.ums):
            um.set_on_push(lambda is_undo, span, k=k: self._push(k, is_undo, span))
            um.set_on_pop(lambda is_undo, span, meta, k=k: self.logs[k].append(("pop", is_undo, plain(span), meta)))

    def _push(self, k, is_undo, span):
        self.n_push[k] += 1
        self.logs[k].append(("push", is_undo, plain(span)))
        return {"value": self.n_push[k]}

    def on(self, fn, remote=False):
        docs = self.remote if remote else self.local
        return both(lambda k: fn(PKGS[k], docs[k]))

    def um(self, fn):
        return both(lambda k: fn(self.ums[k]))

    def sync_in(self):
        """The remote's new work imported into the local doc (concurrent
        with the local stacks), and back."""
        both(lambda k: self.local[k].import_(self.remote[k].export_updates(self.local[k].oplog_vv())))
        both(lambda k: self.remote[k].import_(self.local[k].export_updates(self.remote[k].oplog_vv())))

    def check(self):
        assert self.logs[0] == self.logs[1]
        self.on(lambda pkg, d: d.get_deep_value())
        self.on(lambda pkg, d: d.get_deep_value(), remote=True)
        self.um(lambda um: (um.undo_count(), um.redo_count(), um.can_undo(), um.can_redo(), um.top_undo_meta(),
                            um.top_redo_meta(), um.top_undo_value(), um.top_redo_value()))


def _edit(tw, rng, remote=False):
    """One random edit of a root container of one of the six kinds."""
    d0 = (tw.remote if remote else tw.local)[0]
    kind = rng.choice(["text", "map", "list", "movable", "tree", "counter"])
    on = lambda fn: tw.on(fn, remote=remote)  # noqa: E731
    if kind == "text":
        n = len(d0.get_text("t"))
        if n > 2 and rng.random() < 0.3:
            pos = rng.randrange(n - 1)
            on(lambda pkg, d: d.get_text("t").delete(pos, min(2, n - pos)))
        elif n > 2 and rng.random() < 0.2:
            a = rng.randrange(n - 1)
            on(lambda pkg, d: d.get_text("t").mark(a, a + 1, "bold", True))
        else:
            pos, s = rng.randint(0, n), rng.choice(["ab", "☃", "xyz"])
            on(lambda pkg, d: d.get_text("t").insert(pos, s))
    elif kind == "map":
        key, val = rng.choice("kqz"), rng.choice(VALUES)
        if rng.random() < 0.25:
            on(lambda pkg, d: d.get_map("m").delete(key))
        else:
            on(lambda pkg, d: d.get_map("m").set(key, val))
    elif kind == "list":
        n = len(d0.get_list("l"))
        if n and rng.random() < 0.3:
            pos = rng.randrange(n)
            on(lambda pkg, d: d.get_list("l").delete(pos, 1))
        else:
            pos, val = rng.randint(0, n), rng.choice(VALUES)
            on(lambda pkg, d: d.get_list("l").insert(pos, val))
    elif kind == "movable":
        n = len(d0.get_movable_list("ml"))
        u = rng.random()
        if n < 2 or u < 0.4:
            pos, val = rng.randint(0, n), rng.choice(VALUES)
            on(lambda pkg, d: d.get_movable_list("ml").insert(pos, val))
        elif u < 0.65:
            a, b = rng.randrange(n), rng.randrange(n)
            on(lambda pkg, d: d.get_movable_list("ml").move(a, b))
        elif u < 0.85:
            a, val = rng.randrange(n), rng.choice(VALUES)
            on(lambda pkg, d: d.get_movable_list("ml").set(a, val))
        else:
            a = rng.randrange(n)
            on(lambda pkg, d: d.get_movable_list("ml").delete(a, 1))
    elif kind == "tree":
        ns = [tuple(x) for x in d0.get_tree("tr").nodes()]
        u = rng.random()
        if not ns or u < 0.45:
            par = rng.choice(ns) if ns and rng.random() < 0.5 else None
            on(lambda pkg, d: d.get_tree("tr").create(conv(pkg, ("tree", par))))
        elif u < 0.85:
            a, par = rng.choice(ns), rng.choice(ns + [None])
            on(lambda pkg, d: d.get_tree("tr").move(conv(pkg, ("tree", a)), conv(pkg, ("tree", par))))
        else:
            a = rng.choice(ns)
            on(lambda pkg, d: d.get_tree("tr").delete(conv(pkg, ("tree", a))))
    else:
        delta = rng.choice([1, -2, 2.5, 7])
        on(lambda pkg, d: d.get_counter("c").increment(delta))


def _undo_fuzz(seed, clock, merge_interval_ms):
    rng = random.Random(seed)
    tw = UndoTwins(merge_interval_ms=merge_interval_ms)
    grouping = False
    n_undo = n_redo = 0
    for _step in range(90):
        u = rng.random()
        if u < 0.4:
            for _ in range(rng.randint(1, 3)):
                _edit(tw, rng)
            origin = rng.choice(["", "", "", "sys:auto", "user"])
            tw.on(lambda pkg, d: d.commit(origin=origin))
        elif u < 0.52:
            _edit(tw, rng, remote=True)
            tw.on(lambda pkg, d: d.commit(), remote=True)
            tw.sync_in()
        elif u < 0.68:
            n_undo += bool(tw.um(lambda um: um.undo())[0])
        elif u < 0.78:
            n_redo += bool(tw.um(lambda um: um.redo())[0])
        elif u < 0.84:
            if grouping:
                tw.um(lambda um: um.group_end())
            else:
                tw.um(lambda um: um.group_start())
            grouping = not grouping
        elif u < 0.9:
            clock.advance(rng.choice([0.01, 0.5, 30.0]))
        elif u < 0.94:
            tw.um(lambda um: um.record_new_checkpoint())
        else:
            tw.sync_in()
        tw.check()
    tw.sync_in()
    tw.check()
    both(lambda k: tw.local[k].export_snapshot())
    return n_undo, n_redo


@pytest.mark.parametrize("merge_interval_ms", [0, 1000])
@pytest.mark.parametrize("seed", range(6))
def test_undo_fuzz_matches_jax(seed, merge_interval_ms, clock):
    """Random local edits over the six container kinds (origins excluded
    by prefix among them), concurrent remote imports, undo, redo, groups,
    clock steps across the merge interval and checkpoints: deep values,
    stack counts, pushed metas and the push / pop logs equal after every
    step; both undo and redo did something."""
    n_undo, n_redo = _undo_fuzz(seed, clock, merge_interval_ms)
    assert n_undo and n_redo


def _scripted(steps, clock=None, **kw):
    """Run a fixed step list through both packages; returns the twins."""
    tw = UndoTwins(**kw)
    for st in steps:
        op = st[0]
        if op == "do":
            tw.on(st[1])
            tw.on(lambda pkg, d: d.commit(origin=st[2] if len(st) > 2 else ""))
        elif op == "remote":
            tw.on(st[1], remote=True)
            tw.on(lambda pkg, d: d.commit(), remote=True)
            tw.sync_in()
        elif op == "undo":
            assert tw.um(lambda um: um.undo())[0] == st[1]
        elif op == "redo":
            assert tw.um(lambda um: um.redo())[0] == st[1]
        elif op == "um":
            tw.um(st[1])
        elif op == "tick":
            clock.advance(st[1])
        tw.check()
    return tw


def _text(pkg, d):
    return d.get_text("t")


SCRIPTS = {
    "text_undo_redo": [("do", lambda p, d: _text(p, d).insert(0, "hello")),
                       ("do", lambda p, d: _text(p, d).insert(5, " world")),
                       ("undo", True), ("undo", True), ("undo", False), ("redo", True), ("redo", True)],
    "new_edit_clears_redo": [("do", lambda p, d: _text(p, d).insert(0, "a")), ("undo", True),
                             ("do", lambda p, d: _text(p, d).insert(0, "b")), ("redo", False)],
    "map": [("do", lambda p, d: d.get_map("m").set("k", 1)), ("do", lambda p, d: d.get_map("m").set("k", 2)),
            ("undo", True), ("undo", True), ("redo", True)],
    "only_own_ops": [("do", lambda p, d: _text(p, d).insert(0, "aaa")),
                     ("remote", lambda p, d: _text(p, d).insert(0, "bbb")), ("undo", True)],
    "transformed_through_remote": [("do", lambda p, d: _text(p, d).insert(0, "base")),
                                   ("remote", lambda p, d: None),
                                   ("do", lambda p, d: _text(p, d).insert(4, "XYZ")),
                                   ("remote", lambda p, d: _text(p, d).insert(0, "pre-")),
                                   ("undo", True), ("undo", True), ("redo", True)],
    "counter": [("do", lambda p, d: d.get_counter("c").increment(5)), ("undo", True), ("redo", True)],
    "tree": [("do", lambda p, d: d.get_tree("tr").create()),
             ("do", lambda p, d: d.get_tree("tr").create(d.get_tree("tr").nodes()[0])),
             ("undo", True), ("undo", True), ("redo", True)],
    "list_and_movable": [("do", lambda p, d: d.get_list("l").insert(0, 1, "two")),
                         ("do", lambda p, d: d.get_movable_list("ml").insert(0, "a", "b", "c")),
                         ("do", lambda p, d: d.get_movable_list("ml").move(0, 2)),
                         ("do", lambda p, d: d.get_movable_list("ml").set(1, 9)),
                         ("undo", True), ("undo", True), ("undo", True), ("redo", True), ("undo", True),
                         ("undo", True)],
    "mark": [("do", lambda p, d: _text(p, d).insert(0, "hello")),
             ("do", lambda p, d: _text(p, d).mark(0, 5, "bold", True)), ("undo", True), ("redo", True)],
    "group": [("do", lambda p, d: _text(p, d).insert(0, "one ")), ("um", lambda um: um.group_start()),
              ("do", lambda p, d: _text(p, d).insert(4, "two ")),
              ("do", lambda p, d: _text(p, d).insert(8, "three")), ("um", lambda um: um.group_end()),
              ("undo", True), ("undo", True), ("redo", True), ("redo", True)],
    "excluded_origin_splits_a_group": [
        ("um", lambda um: um.group_start()), ("do", lambda p, d: _text(p, d).insert(0, "a")),
        ("do", lambda p, d: _text(p, d).insert(1, "S"), "sys:fmt"), ("do", lambda p, d: _text(p, d).insert(2, "b")),
        ("um", lambda um: um.group_end()), ("undo", True), ("undo", True), ("undo", False)],
    "max_steps_and_clear": [("do", lambda p, d: _text(p, d).insert(0, "a")),
                            ("do", lambda p, d: _text(p, d).insert(0, "b")),
                            ("do", lambda p, d: _text(p, d).insert(0, "c")),
                            ("um", lambda um: um.set_max_undo_steps(2)), ("undo", True), ("undo", True),
                            ("undo", False), ("um", lambda um: um.clear()), ("redo", False)],
    "add_exclude_prefix": [("um", lambda um: um.add_exclude_origin_prefix("bot")),
                           ("do", lambda p, d: d.get_map("m").set("x", 1), "bot:1"),
                           ("do", lambda p, d: d.get_map("m").set("y", 2)), ("undo", True), ("undo", False)],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_undo_scripts_match_jax(name, clock):
    """test_features.py's undo cases (text, map, own ops only, through a
    remote insert, counter, tree, marks, groups) and list, movable-list,
    exclusion, max-steps and clear cases: every step's result, the deep
    values, the stacks and the callback logs equal."""
    _scripted(SCRIPTS[name], clock)


@pytest.mark.parametrize("gap_s,want_steps", [(0.5, 1), (5.0, 2)])
def test_merge_interval_reads_the_patched_monotonic_clock(gap_s, want_steps, clock):
    """Two commits gap_s apart under a 1 s merge interval: one undo step
    when closer, two when farther, in both packages; a new checkpoint
    splits the merge."""
    tw = _scripted([("do", lambda p, d: _text(p, d).insert(0, "a")), ("tick", gap_s),
                    ("do", lambda p, d: _text(p, d).insert(1, "b"))], clock, merge_interval_ms=1000)
    assert tw.ums[1].undo_count() == want_steps
    tw = _scripted([("do", lambda p, d: _text(p, d).insert(0, "a")), ("um", lambda um: um.record_new_checkpoint()),
                    ("do", lambda p, d: _text(p, d).insert(1, "b"))], clock, merge_interval_ms=60_000)
    assert tw.ums[1].undo_count() == 2


# ---- Awareness and EphemeralStore ---------------------------------------------------------

STATES = [None, 1, "cursor", {"pos": [1, 2], "name": "ü"}, [True, 2.5]]


def test_awareness_bytes_cross_decode_and_expiry():
    """Awareness in both packages under one injected clock: encoded bytes
    equal, each package applies the other's bytes with the same
    (updated, added), older counters are ignored, expiry removes the same
    peers, and a malformed blob raises ValueError in both."""
    clk = FakeClock()
    aw = {pkg: pkg.Awareness(peer, timeout_s=10.0, clock=clk) for pkg in PKGS for peer in [1]}
    other = {pkg: pkg.Awareness(7, timeout_s=10.0, clock=clk) for pkg in PKGS}
    for i, st in enumerate(STATES):
        for pkg in PKGS:
            aw[pkg].set_local_state(st)
            other[pkg].set_local_state({"i": i})
        blobs = [aw[pkg].encode_all() for pkg in PKGS]
        assert blobs[0] == blobs[1]
        assert aw[J].get_local_state() == aw[P].get_local_state() == st
        # each package applies the other package's blob of peer 7
        res = [aw[pkg].apply(other[src].encode([7])) for pkg, src in ((J, P), (P, J))]
        assert res[0] == res[1]
        clk.advance(3.0)
    assert aw[J].get_all_states() == aw[P].get_all_states()
    stale = J.Awareness(7, clock=clk).encode()  # counter 0: older than what both hold
    assert aw[J].apply(stale) == aw[P].apply(stale) == ([], [])
    assert aw[J].encode([7]) == aw[P].encode([7])
    clk.advance(5.0)  # peers 1 and 7 were last set or applied 8 s ago: within the 10 s
    assert aw[J].remove_outdated() == aw[P].remove_outdated() == []
    clk.advance(20.0)
    assert aw[J].remove_outdated() == aw[P].remove_outdated() == [1, 7]
    assert aw[J].encode_all() == aw[P].encode_all()
    for pkg in PKGS:
        with pytest.raises(ValueError):
            aw[pkg].apply(b"LTAW\x05\x01")
        with pytest.raises(ValueError):
            aw[pkg].apply(b"nope")


def test_ephemeral_store_bytes_events_cross_decode_and_expiry():
    """EphemeralStore in both packages under one injected clock: local
    update payloads, encoded bytes and events equal; each package
    applies the other's bytes (newer timestamps win, deletes remove);
    keys and states equal; expiry removes the same keys with the same
    timeout events; malformed blobs raise ValueError."""
    clk = FakeClock()
    stores = {pkg: pkg.EphemeralStore(timeout_ms=5_000, clock=clk) for pkg in PKGS}
    peers = {pkg: pkg.EphemeralStore(timeout_ms=5_000, clock=clk) for pkg in PKGS}
    local = {pkg: [] for pkg in PKGS}
    events = {pkg: [] for pkg in PKGS}
    for pkg in PKGS:
        stores[pkg].subscribe_local_update(local[pkg].append)
        stores[pkg].subscribe(events[pkg].append)
    rng = random.Random(5)
    for step in range(40):
        u = rng.random()
        key, val = rng.choice("abcd"), rng.choice(STATES)
        for pkg in PKGS:
            if u < 0.4:
                stores[pkg].set(key, val)
            elif u < 0.55:
                stores[pkg].delete(key)
            elif u < 0.8:
                peers[pkg].set(key, val)
            else:
                peers[pkg].delete(key)
        clk.advance(rng.choice([0.0, 0.5, 2.0]))
        if step % 5 == 4:  # each package applies the other package's peer blob
            stores[J].apply(peers[P].encode_all())
            stores[P].apply(peers[J].encode_all())
        assert local[J] == local[P]
        assert events[J] == events[P]
        assert stores[J].encode_all() == stores[P].encode_all()
        assert stores[J].keys() == stores[P].keys()
        assert stores[J].get_all_states() == stores[P].get_all_states()
        assert [stores[J].get(k) for k in "abcd"] == [stores[P].get(k) for k in "abcd"]
        assert stores[J].encode("a") == stores[P].encode("a")
    assert any(e["by"] == "import" for e in events[P]) and local[P]
    clk.advance(10.0)
    assert stores[J].remove_outdated() == stores[P].remove_outdated()
    assert events[J] == events[P] and events[P][-1]["by"] == "timeout"
    assert stores[J].encode_all() == stores[P].encode_all() == b"LTEP\x00"
    for pkg in PKGS:
        with pytest.raises(ValueError):
            stores[pkg].apply(b"LTEP\x02\x01")
        with pytest.raises(ValueError):
            stores[pkg].apply(b"LTAW")
