"""Sharded resident fleet: one logical ResidentServer over a device
mesh or list (parallel/mesh.py carves the mesh's doc axis, a list being
one column, into one contiguous slice of rows a shard, and each shard's
server is bound to the lead device of its slice).  A
list may name one device twice: ``devices=["cpu", "cpu"]`` runs two
shards on the host, ``[dev, dev]`` two shards on one card, each with
its own batch tensors, its own ``fleet.dev`` lock and, under a
pipeline, its own commit thread launching concurrently.

Everything below L5 treats a batch's device placement as an assumption
— one ResidentServer pins one device (or one NamedSharding) for its
whole life.  This module makes placement a *parameter*: a
``ShardedResidentServer`` partitions its doc set across a device
list (``parallel/mesh.py``), one **per-shard ResidentServer** per
contiguous slice, so N cards buy N× resident capacity and N
concurrent ingest launches (ROADMAP "millions of users"; the scale-out
argument of "Operational Concurrency Control in the Face of Arbitrary
Scale and Latency", PAPERS.md).

Design points (docs/SHARDING.md has the full story):

- **deterministic placement** — doc→shard via rendezvous hashing on a
  per-doc key (highest-random-weight over a keyed blake2b digest):
  the same key always lands on the same shard across runs and
  processes, and growing the shard count moves only the docs the NEW
  shards win — never a doc between surviving shards.
- **lockstep epoch clocks** — every ingest round fans out to every
  shard (untouched shards get an all-None round: an epoch bump and a
  small journal record, no device launch), so per-shard visible epochs
  advance in lockstep with the fleet-global epoch.  The rare skew
  (per-doc poison isolation journals extra shard rounds) is absorbed
  by a per-shard breakpoint translation map, so client acks on the
  global clock always reach each shard's compaction floors at or
  below the true shard epoch — floors may lag, never lead.
- **per-shard everything** — each shard has its own DeviceSupervisor
  (retry budgets and deadlines never couple shards), its own WAL +
  checkpoint ladder under ``<durable_dir>/shard-NN/`` (reopened
  independently by ``recover_sharded_server``; the fleet
  ``durable_epoch`` is the min over shards), and its own
  PipelinedIngest executor (``pipeline()`` returns a ShardedPipeline
  whose per-shard stage/commit threads launch coalesced groups
  concurrently across chips).  A DeviceFailure degrades ONE shard's
  batch onto its host mirror; the other shards never notice.
- **live migration** — ``migrate(di, to_shard)`` drains the pipeline,
  re-exports the doc's full history from the source shard's mirror
  (per-shard servers run history-complete "deep" mirror anchors for
  exactly this), and lands it in a spare slot on the target through
  one ordinary fleet round — epoch stream contiguous, a round fed
  mid-migration simply waits on the routing lock and lands exactly
  once under the new placement.

The sync front-end (``loro_tpu/sync``) rides on top unchanged: the
wrapper exposes the same serving surface as ResidentServer
(``ingest``/``ingest_coalesced``/``pipeline``/``subscribe_epochs``/
``seed_mirror_engine``/acks/reads/``durable_epoch``), so
``SyncServer.over(sharded)`` just works.
"""
from __future__ import annotations

import json
import os
import threading
import time as _time
from collections import deque
from typing import List, Optional, Sequence

from ..analysis.lockwitness import named_lock, named_rlock
from ..device import DeviceLike
from ..errors import ConfigError, LoroError, PersistError, ShardingError
from ..obs import heat as heat_acct
from ..obs import metrics as obs
from .mesh import DOC_AXIS, make_mesh, shard_meshes
from .pipeline import PendingRound
from .placement import ShardPlacement, _EpochMap, rendezvous_shard
from .server import ResidentServer

MANIFEST_NAME = "sharding.json"
MANIFEST_VERSION = 1


# ---------------------------------------------------------------------------
# placement (rendezvous_shard / ShardPlacement / _EpochMap live in the
# device-free parallel/placement.py, re-exported here; persist.inspect
# imports them directly for the watermark translation)
# ---------------------------------------------------------------------------


def _resolve_shards(shards, devices) -> int:
    """Shard-count knob resolution with typed first-use validation:
    explicit ``shards=`` wins, else ``LORO_SHARDS``, else one shard per
    doc-axis row of the mesh (a device of a list).  Divisibility against
    the mesh is validated by ``shard_meshes`` (also typed ConfigError)."""
    if shards is None:
        env = os.environ.get("LORO_SHARDS")
        if env is not None:
            try:
                shards = int(env)
            except ValueError:
                raise ConfigError(
                    "LORO_SHARDS", env, "positive integer"
                ) from None
            if shards < 1:
                raise ConfigError("LORO_SHARDS", env, "positive integer")
        else:
            shards = devices.shape[DOC_AXIS]
    return shards


# ---------------------------------------------------------------------------
# per-shard pipelined ingest
# ---------------------------------------------------------------------------


class ShardedPipeline:
    """Per-shard ``PipelinedIngest`` executors behind one ``submit``.

    A submitted round splits by placement and every slice rides its
    own shard's pipeline — per-shard stage/commit threads run
    concurrently, so coalesced device groups launch in parallel across
    chips.  A collector thread resolves each round's fleet-global
    epoch once EVERY shard has committed it (FIFO, so global epochs
    resolve in submit order), fires the wrapper's epoch subscribers,
    and with ``durable_fsync="group"`` shards a resolved epoch is
    covered by every shard's fsync window exactly as in the
    single-server pipeline."""

    def __init__(self, server: "ShardedResidentServer", cid=None,
                 coalesce: int = 4, depth: int = 2):
        self._server = server
        self._pipes = [
            srv.pipeline(cid=cid, coalesce=coalesce, depth=depth)
            for srv in server.shards
        ]
        self._lock = named_lock("sharded.collect")
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()  # (aggregate PendingRound, [shard prs])
        self._collecting = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._rounds = 0

    def submit(self, per_doc_updates: Sequence, cid=None,
               trace: Optional[str] = None) -> PendingRound:
        agg = PendingRound()
        agg.trace_id = trace
        with self._server._route_lock:
            with self._cv:
                self._check_open()
            if cid is not None:
                # keep the wrapper's served-cid current (migrate()
                # and the empty-round contract need it), exactly as
                # the direct ingest paths do
                self._server._cid = cid
            parts = self._server._split(list(per_doc_updates))
            self._server._tick_shard_rounds(parts)
            try:
                prs = [
                    pipe.submit(part, cid, trace=trace)
                    for pipe, part in zip(self._pipes, parts)
                ]
            except BaseException as e:  # noqa: BLE001 — fail-stop
                # a mid-fan-out failure (freeze/encode error, closed
                # shard pipe) may have enqueued earlier shards' slices
                # already — the round can no longer land exactly-once,
                # so the whole pipeline fails terminally rather than
                # accepting further rounds over a half-applied one
                with self._cv:
                    self._error = e
                    agg._fail(e)
                    while self._q:
                        a2, _ = self._q.popleft()
                        a2._fail(e)
                    self._cv.notify_all()
                raise
            with self._cv:
                self._q.append((agg, prs))
                self._rounds += 1
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="loro-sharded-collect",
                        daemon=True,
                    )
                    self._thread.start()
                self._cv.notify_all()
        return agg

    def _check_open(self) -> None:
        if self._stop:
            raise RuntimeError("sharded pipeline is closed")
        if self._error is not None:
            raise RuntimeError(
                "sharded pipeline failed; no further rounds accepted"
            ) from self._error

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop and self._error is None:
                    self._cv.notify_all()  # wake flushers: collector idle
                    self._cv.wait()
                if self._error is not None or (self._stop and not self._q):
                    self._cv.notify_all()
                    return
                agg, prs = self._q.popleft()
                self._collecting = True
            try:
                eps = [pr.epoch() for pr in prs]
            except BaseException as e:  # noqa: BLE001 — fail every waiter
                agg._fail(e)
                with self._cv:
                    self._error = e
                    self._collecting = False
                    while self._q:
                        a2, _ = self._q.popleft()
                        a2._fail(e)
                    self._cv.notify_all()
                return
            g = self._server._commit_global(eps)
            # attribution: one commit boundary for the aggregate round
            # (per-shard stage/commit detail lives in the shard pipes)
            agg.marks.append(("commit", _time.perf_counter()))
            agg._resolve(g)
            with self._cv:
                self._collecting = False
                self._cv.notify_all()

    def flush(self) -> None:
        """Block until every submitted round is committed on every
        shard and its global epoch resolved."""
        for p in self._pipes:
            p.flush()
        with self._cv:
            while (self._q or self._collecting) and self._error is None:
                self._cv.wait()
            if self._error is not None:
                raise RuntimeError(
                    "sharded pipeline failed"
                ) from self._error

    def close(self) -> None:
        err = None
        try:
            self.flush()
        except RuntimeError as e:
            err = e
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout=30.0)
        close_err = None
        for p in self._pipes:
            try:
                p.close()
            except RuntimeError as e:
                close_err = close_err or e
        if err or close_err:
            raise err or close_err

    @property
    def closed(self) -> bool:
        return self._stop

    def report(self) -> dict:
        """Aggregate of the per-shard pipeline reports (the bench
        ``shard`` sidecar core)."""
        per = [p.report() for p in self._pipes]
        return {
            "shards": len(per),
            "rounds": self._rounds,
            "groups": sum(p["groups"] for p in per),
            "coalesced_rounds": sum(p["coalesced_rounds"] for p in per),
            "max_group": max((p["max_group"] for p in per), default=0),
            "backpressure_waits": sum(
                p["backpressure_waits"] for p in per
            ),
            "stage_s": round(sum(p["stage_s"] for p in per), 3),
            "commit_s": round(sum(p["commit_s"] for p in per), 3),
            "overlap_s": round(sum(p["overlap_s"] for p in per), 3),
        }


# ---------------------------------------------------------------------------
# the sharded server
# ---------------------------------------------------------------------------


class ShardedResidentServer:
    """One logical resident server over N doc-axis shards.

    ``ShardedResidentServer(family, n_docs, shards=|devices=, **caps)``:
    ``shards`` defaults to ``LORO_SHARDS`` (typed ConfigError on a bad
    value) and then to one shard per doc-axis row of ``devices`` (a
    mesh, or a list as one column; every visible card when omitted,
    DeviceUnavailable without one); the shard count must divide the
    rows.  Capacity kwargs apply per shard.
    ``doc_keys`` are the rendezvous placement keys (default: the doc
    index as a string; pass stable names — e.g. stringified container
    ids — when the fleet will be resized, so placement survives the
    resize).  ``spare_slots`` is the per-shard migration headroom.

    The serving surface matches ResidentServer — ``ingest`` /
    ``ingest_coalesced`` / ``pipeline`` / reads / acks / ``compact`` /
    ``checkpoint``/``restore`` / ``subscribe_epochs`` /
    ``seed_mirror_engine`` — with epochs on the fleet-global clock, so
    ``sync.SyncServer.over(...)`` fronts it unchanged.  With
    ``durable_dir`` each shard journals under ``shard-NN/`` and a
    ``sharding.json`` manifest records placement;
    ``persist.recover_sharded_server`` reopens every shard
    independently after a crash."""

    def __init__(self, family: str, n_docs: int, shards: Optional[int] = None,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 doc_keys: Optional[Sequence[str]] = None,
                 spare_slots: int = 1, supervisors=None,
                 auto_grow: bool = True, host_fallback: bool = True,
                 auto_checkpoint: bool = True,
                 durable_dir: Optional[str] = None, durable_fsync=True,
                 fsync_window: int = 8, hot_slots: Optional[int] = None,
                 **caps):
        from ..resilience import DeviceSupervisor

        devices = make_mesh(devices)
        n_shards = _resolve_shards(shards, devices)
        self.family = family
        self.n_docs = n_docs
        self.devices = devices
        self.shard_devices = shard_meshes(devices, n_shards)  # typed ConfigError
        self.n_shards = n_shards
        self.placement = ShardPlacement(
            n_docs, n_shards, keys=doc_keys, spare_slots=spare_slots
        )
        if supervisors is not None and len(supervisors) != n_shards:
            raise ValueError(
                f"supervisors has {len(supervisors)} entries for "
                f"{n_shards} shards"
            )
        self.supervisors = (
            list(supervisors) if supervisors is not None
            else [DeviceSupervisor() for _ in range(n_shards)]
        )
        self._durable_dir = durable_dir
        self._host_fallback_flag = host_fallback
        self.hot_slots = hot_slots
        self.shards: List[ResidentServer] = []
        try:
            for s in range(n_shards):
                kw = dict(caps)
                if durable_dir is not None:
                    kw["durable_dir"] = os.path.join(
                        durable_dir, f"shard-{s:02d}"
                    )
                    kw["durable_fsync"] = durable_fsync
                    kw["fsync_window"] = fsync_window
                if hot_slots is not None:
                    # tiered residency per shard (docs/RESIDENCY.md):
                    # each shard manages its own hot set over its slice
                    # of the doc space — eviction never crosses shards.
                    # The budget is per shard, clamped to the shard's
                    # width (spares included, so migration landings can
                    # always go hot).
                    kw["hot_slots"] = min(
                        int(hot_slots), self.placement.widths[s]
                    )
                self.shards.append(ResidentServer(
                    family, self.placement.widths[s], device=self.shard_devices[s].lead,
                    auto_grow=auto_grow, supervisor=self.supervisors[s],
                    host_fallback=host_fallback,
                    auto_checkpoint=auto_checkpoint,
                    # deep anchors keep per-doc history exportable for
                    # live migration (docs/SHARDING.md)
                    mirror_anchor="deep" if host_fallback else True,
                    **kw,
                ))
        except BaseException:
            for srv in self.shards:
                try:
                    srv.close()
                except Exception:  # tpulint: disable=LT-EXC(best-effort shard close while the constructor error propagates)
                    pass
            raise
        self._init_runtime(cid=None, global_epoch=0,
                           emaps=[_EpochMap() for _ in range(n_shards)])
        if durable_dir is not None:
            self._write_manifest()

    def _init_runtime(self, cid, global_epoch: int, emaps) -> None:
        self._route_lock = named_rlock("sharded.route")
        self._epoch_lock = named_lock("sharded.epoch")
        self._emaps = emaps
        self._global_epoch = global_epoch
        self._epoch_subs: List = []
        self._pipeline = None
        self._cid = cid
        self.last_poison_docs: List[int] = []
        obs.gauge("shard.count", "shards in the resident fleet").set(
            self.n_shards, family=self.family
        )
        for s in range(self.n_shards):
            obs.gauge("shard.docs", "docs placed on the shard").set(
                len(self.placement.docs_of(s)),
                family=self.family, shard=str(s),
            )

    # -- routing -------------------------------------------------------
    def _split(self, per_doc_updates: Sequence) -> List[list]:
        """One global round → per-shard local rounds (every shard gets
        a round, possibly all-None: the lockstep epoch contract)."""
        if len(per_doc_updates) > self.n_docs:
            raise ValueError(
                f"round has {len(per_doc_updates)} entries for "
                f"{self.n_docs} docs"
            )
        parts = [[None] * w for w in self.placement.widths]
        for g, u in enumerate(per_doc_updates):
            if u is None:
                continue
            s, l = self.placement.place(g)
            parts[s][l] = u
        return parts

    def _tick_shard_rounds(self, parts: List[list],
                           launches: bool = False) -> None:
        for s, part in enumerate(parts):
            if any(u is not None for u in part):
                obs.counter(
                    "shard.rounds_total",
                    "ingest rounds carrying payloads for the shard",
                ).inc(family=self.family, shard=str(s))
                heat_acct.tick_shard(s, "ingest", of=self.n_shards)
                if launches:
                    heat_acct.tick_shard(s, "launch", of=self.n_shards)

    def _globals_of(self, shard: int, locals_: Sequence[int]) -> List[int]:
        back = {
            self.placement.slot_of[g]: g
            for g in self.placement.docs_of(shard)
        }
        return [back[l] for l in locals_ if l in back]

    # -- ingest --------------------------------------------------------
    def ingest(self, per_doc_updates: Sequence, cid=None) -> int:
        """Feed one fleet round: slices route to their shards by
        placement, every shard's epoch clock ticks, and the returned
        fleet-global epoch is what clients ack."""
        with self._route_lock:
            self._drain_pipeline()
            if cid is not None:
                self._cid = cid
            parts = self._split(list(per_doc_updates))
            self._tick_shard_rounds(parts, launches=True)
            eps = []
            poison: List[int] = []
            for s, srv in enumerate(self.shards):
                eps.append(srv.ingest(parts[s], cid))
                if srv.last_poison_docs:
                    poison.extend(
                        self._globals_of(s, srv.last_poison_docs)
                    )
            self.last_poison_docs = poison
            return self._commit_global(eps)

    def ingest_coalesced(self, rounds: Sequence[Sequence], cid=None) -> List[int]:
        """Apply several rounds as one coalesced group per shard (one
        device launch per shard per group).  Returns one fleet-global
        epoch per round, in order."""
        rounds = [list(r) for r in rounds]
        if not rounds:
            return []
        with self._route_lock:
            self._drain_pipeline()
            if cid is not None:
                self._cid = cid
            split_rounds = []
            for r in rounds:
                parts = self._split(r)
                self._tick_shard_rounds(parts)
                split_rounds.append(parts)
            # one device launch per shard per coalesced GROUP
            for s in range(self.n_shards):
                if any(
                    any(u is not None for u in split_rounds[j][s])
                    for j in range(len(rounds))
                ):
                    heat_acct.tick_shard(s, "launch", of=self.n_shards)
            self.last_poison_docs = []
            per_shard = []
            for s, srv in enumerate(self.shards):
                per_shard.append(srv.ingest_coalesced(
                    [split_rounds[j][s] for j in range(len(rounds))], cid
                ))
                if srv.last_poison_docs:
                    self.last_poison_docs.extend(
                        self._globals_of(s, srv.last_poison_docs)
                    )
            out = []
            for j in range(len(rounds)):
                out.append(self._commit_global(
                    [per_shard[s][j] for s in range(self.n_shards)]
                ))
            return out

    def _commit_global(self, eps: List[int]) -> int:
        with self._epoch_lock:
            self._global_epoch += 1
            g = self._global_epoch
            for s, e in enumerate(eps):
                self._emaps[s].note(g, e)
        self._notify_epoch(g)
        degraded = self.degraded_shards()
        obs.gauge(
            "shard.degraded_shards", "shards degraded to their host mirror"
        ).set(len(degraded), family=self.family)
        for s in degraded:
            heat_acct.tick_shard(s, "degradation", of=self.n_shards)
        return g

    # -- epoch-commit subscription (sync fan-out) ----------------------
    def subscribe_epochs(self, cb):
        """Register ``cb(global_epoch)``: fires once per fleet round,
        after EVERY shard has committed it (same visibility contract as
        ``ResidentServer.subscribe_epochs``)."""
        self._epoch_subs.append(cb)
        return lambda: self._epoch_subs.remove(cb)

    def _notify_epoch(self, epoch: int) -> None:
        for cb in list(self._epoch_subs):
            try:
                cb(epoch)
            except Exception:  # tpulint: disable=LT-EXC(subscriber isolation: a broken epoch subscriber must never poison ingest; counted below)
                obs.counter(
                    "server.epoch_sub_errors_total",
                    "epoch-commit subscriber callbacks that raised",
                ).inc(family=self.family)

    # -- pipeline ------------------------------------------------------
    def pipeline(self, cid=None, coalesce: int = 4, depth: int = 2):
        """Attach per-shard PipelinedIngest executors behind one
        submit() (see ShardedPipeline)."""
        if self._pipeline is not None and not self._pipeline.closed:
            raise RuntimeError(
                "server already has a live pipeline — close() it first"
            )
        if cid is not None:
            self._cid = cid
        self._pipeline = ShardedPipeline(
            self, cid=cid, coalesce=coalesce, depth=depth
        )
        return self._pipeline

    def _drain_pipeline(self) -> None:
        if self._pipeline is not None and not self._pipeline.closed:
            self._pipeline.flush()

    # -- reads (placement-merged across shards) ------------------------
    def _read(self, name: str, *args):
        outs = [getattr(srv, name)(*args) for srv in self.shards]
        merged = [None] * self.n_docs
        for g in range(self.n_docs):
            s, l = self.placement.place(g)
            merged[g] = outs[s][l]
        return merged

    def texts(self) -> List[str]:
        return self._read("texts")

    def richtexts(self) -> List[list]:
        return self._read("richtexts")

    def values(self) -> List[list]:
        return self._read("values")

    def value_maps(self):
        return self._read("value_maps")

    def root_value_maps(self, name: str):
        return self._read("root_value_maps", name)

    def parent_maps(self) -> List[dict]:
        return self._read("parent_maps")

    def children_maps(self) -> List[dict]:
        return self._read("children_maps")

    def value_lists(self) -> List[list]:
        return self._read("value_lists")

    @property
    def epoch(self) -> int:
        return self._global_epoch

    # -- degradation (per shard) ---------------------------------------
    @property
    def degraded(self) -> bool:
        return any(srv.degraded for srv in self.shards)

    def degraded_shards(self) -> List[int]:
        return [s for s, srv in enumerate(self.shards) if srv.degraded]

    def recover(self, shard: Optional[int] = None) -> bool:
        """Recover the given shard (or every degraded one) back onto
        its device batch; True when nothing is left degraded."""
        targets = [shard] if shard is not None else self.degraded_shards()
        ok = True
        for s in targets:
            if self.shards[s].degraded:
                ok = self.shards[s].recover(device=self.shard_devices[s].lead) and ok
        obs.gauge(
            "shard.degraded_shards", "shards degraded to their host mirror"
        ).set(len(self.degraded_shards()), family=self.family)
        return ok

    # -- acks / compaction (global clock in, shard clocks inside) ------
    def register_replica(self, di: int, replica: str) -> None:
        s, l = self.placement.place(di)
        self.shards[s].register_replica(l, replica)

    def ack(self, di: int, replica: str, epoch: int) -> None:
        s, l = self.placement.place(di)
        self.shards[s].ack(l, replica, self._emaps[s].to_shard(epoch))

    def drop_replica(self, di: int, replica: str) -> None:
        s, l = self.placement.place(di)
        self.shards[s].drop_replica(l, replica)

    def stable_epoch(self, di: int) -> int:
        s, l = self.placement.place(di)
        return self._emaps[s].to_global(self.shards[s].stable_epoch(l))

    def compact(self) -> int:
        self._drain_pipeline()
        return sum(srv.compact() for srv in self.shards)

    # -- durability ----------------------------------------------------
    @property
    def _durable(self):
        logs = [srv._durable for srv in self.shards]
        return logs if any(lg is not None for lg in logs) else None

    @property
    def durable_epoch(self) -> int:
        """Fleet durable watermark: the min over shards of each
        shard's acked-epoch watermark translated to the global clock —
        a crash loses no round at or below it on ANY shard."""
        if self._durable is None:
            return 0
        return min(
            self._emaps[s].to_global(srv.durable_epoch)
            for s, srv in enumerate(self.shards)
        )

    def flush_durable(self) -> int:
        return sum(srv.flush_durable() for srv in self.shards)

    def _manifest(self) -> dict:
        with self._epoch_lock:
            return {
                "version": MANIFEST_VERSION,
                "family": self.family,
                "n_docs": self.n_docs,
                "shards": self.n_shards,
                "spare_slots": self.placement.spare_slots,
                "keys": self.placement.keys,
                "shard_of": list(self.placement.shard_of),
                "slot_of": list(self.placement.slot_of),
                "widths": list(self.placement.widths),
                "free": [list(f) for f in self.placement.free],
                "global_epoch": self._global_epoch,
                "emaps": [m.encode() for m in self._emaps],
                # informational (recovery reads per-shard WAL meta caps;
                # inspect and operators read this)
                "hot_slots": self.hot_slots,
            }

    def _write_manifest(self) -> None:
        path = os.path.join(self._durable_dir, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        try:
            dfd = os.open(self._durable_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass

    # -- checkpoint / restore ------------------------------------------
    def checkpoint(self) -> bytes:
        """Per-shard checkpoints (each lands on its own ladder when
        durable) + the placement manifest, as one LTKV blob.  Holds
        the routing lock: a round landing between two shards'
        checkpoints would tear the fleet blob (shard A pre-round,
        shard B post-round — a state that never existed)."""
        from ..storage import MemKvStore

        with self._route_lock:
            self._drain_pipeline()
            kv = MemKvStore()
            kv.set(b"manifest",
                   json.dumps(self._manifest()).encode("utf-8"))
            for s, srv in enumerate(self.shards):
                kv.set(f"shard-{s:02d}".encode(), srv.checkpoint())
            if self._durable_dir is not None:
                self._write_manifest()
            return kv.export_all()

    @classmethod
    def restore(cls, data: bytes, devices: Optional[Sequence[DeviceLike]] = None) -> "ShardedResidentServer":
        from ..errors import DecodeError
        from ..storage import MemKvStore

        kv = MemKvStore()
        kv.import_all(data)
        mb = kv.get(b"manifest")
        if mb is None:
            raise DecodeError("ShardedResidentServer state: missing manifest")
        manifest = json.loads(mb.decode("utf-8"))
        if manifest.get("version", 0) > MANIFEST_VERSION:
            raise DecodeError(
                f"shard manifest v{manifest.get('version')} too new"
            )
        n_shards = int(manifest["shards"])
        devices = make_mesh(devices)
        shard_devices = shard_meshes(devices, n_shards)
        shard_srvs = []
        for s in range(n_shards):
            blob = kv.get(f"shard-{s:02d}".encode())
            if blob is None:
                raise DecodeError(
                    f"ShardedResidentServer state: missing shard {s}"
                )
            shard_srvs.append(ResidentServer.restore(blob, device=shard_devices[s].lead))
        return cls._assemble(manifest, shard_srvs, devices, shard_devices,
                             durable_dir=None)

    @classmethod
    def _assemble(cls, manifest: dict, shard_srvs: List[ResidentServer],
                  devices, shard_devices, durable_dir: Optional[str]
                  ) -> "ShardedResidentServer":
        """Shared tail of restore() and recover_sharded_server():
        wire recovered per-shard servers back into one fleet.  Shards
        may come back at different epochs (independent WAL tails): the
        global clock resumes at the furthest shard and each epoch map
        gets a breakpoint, so translations stay conservative."""
        from ..resilience import DeviceSupervisor

        self = cls.__new__(cls)
        self.family = manifest["family"]
        self.n_docs = int(manifest["n_docs"])
        self.n_shards = int(manifest["shards"])
        self.devices = devices
        self.shard_devices = shard_devices
        self.placement = ShardPlacement.from_manifest(manifest)
        self.shards = shard_srvs
        self._durable_dir = durable_dir
        self.hot_slots = manifest.get("hot_slots")
        self._host_fallback_flag = all(
            srv._host_fallback for srv in shard_srvs
        )
        self.supervisors = []
        for srv in shard_srvs:
            if srv._supervisor is None:
                srv._supervisor = DeviceSupervisor()
            self.supervisors.append(srv._supervisor)
        # stale-manifest guard: a crash between a migration round's
        # WAL fsync and the manifest write leaves the target's spare
        # slot populated while the recovered manifest still lists it
        # free.  Retire any "free" slot the recovered journal tail or
        # anchor shows content in, so a later migrate() can never land
        # a second doc on top of it (the half-migrated doc itself keeps
        # serving from its source slot — the pre-move placement).
        for s, srv in enumerate(shard_srvs):
            if not self.placement.free[s]:
                continue
            occupied = set()
            for _e, ups, _c in (getattr(srv, "_history", None) or ()):
                for l, u in enumerate(ups):
                    if u is not None:
                        occupied.add(l)
            anchor = getattr(srv, "_anchor", None)
            if anchor is not None:
                for l, blob in enumerate(anchor.doc_blobs):
                    if blob:
                        occupied.add(l)
            self.placement.free[s] = [
                l for l in self.placement.free[s] if l not in occupied
            ]
        g_m = int(manifest.get("global_epoch", 0))
        emaps = [_EpochMap.decode(b) for b in manifest.get(
            "emaps", [[[0, 0]]] * self.n_shards
        )]
        # global rounds since the manifest = journal-tail ROUNDS past
        # the manifest-time shard epoch, NOT the epoch delta: a round
        # with deletes ticks a batch clock twice (scatter + tombstone
        # launch), so epochs overcount rounds.  Shards may disagree
        # (independent fsync tails) — the furthest shard defines how
        # many global rounds were issued.
        deltas = []
        for s, srv in enumerate(shard_srvs):
            floor = emaps[s].to_shard(g_m)
            hist = getattr(srv, "_history", None)
            if srv._host_fallback and hist is not None:
                delta = sum(1 for rec in hist if rec[0] > floor)
            else:
                delta = max(0, srv.epoch - floor)
            rung = getattr(srv, "last_recovery", None)
            if rung is not None and rung.checkpoint_epoch > floor:
                # the manifest predates the restored rung (a crash
                # inside checkpoint(), between the per-shard rungs and
                # the manifest write): the journal tail counts only
                # rounds AFTER the rung, so take the epoch delta — an
                # OVERestimate of rounds (clocks tick >= 1 per round).
                # An inflated global clock is never reused; an
                # undercounted one would re-issue epochs clients
                # already acked and let translated floors lead.
                delta = max(delta, srv.epoch - floor)
            deltas.append(delta)
        g = g_m + max([0] + deltas)
        for s, srv in enumerate(shard_srvs):
            emaps[s].note(g, srv.epoch)
        cid = next(
            (srv._cid for srv in shard_srvs if srv._cid is not None), None
        )
        self._init_runtime(cid=cid, global_epoch=g, emaps=emaps)
        return self

    # -- host mirror (sync oracle / degradation seed) -------------------
    @property
    def _host_fallback(self) -> bool:
        return self._host_fallback_flag

    @property
    def _history_complete(self) -> bool:
        return all(srv._history_complete for srv in self.shards)

    @property
    def _anchor(self):
        # the sync front-end only tests truthiness (can this server
        # seed a mirror without history since birth?)
        return self.shards[0]._anchor

    def seed_mirror_engine(self):
        """A fleet-wide ``hostpath.HostEngine`` at the current applied
        state: per-shard mirror engines grafted back into global doc
        order (the sync front-end's delta-export oracle)."""
        from ..resilience.hostpath import HostEngine

        subs = [srv.seed_mirror_engine() for srv in self.shards]
        eng = HostEngine(self.family, self.n_docs)
        eng._cid = self._cid if self._cid is not None else subs[0]._cid
        eng.epoch = self._global_epoch
        for g in range(self.n_docs):
            s, l = self.placement.place(g)
            eng.docs[g] = subs[s].docs[l]
            eng._seen_cids[g] = subs[s]._seen_cids[l]
        return eng

    # -- live migration -------------------------------------------------
    def migrate(self, di: int, to_shard: int) -> int:
        """Move doc ``di`` onto ``to_shard`` live: drain the pipeline,
        re-export the doc's full history from the source shard's
        (deep-anchored) mirror, flip the placement, and land the
        history in the target's spare slot through ONE ordinary fleet
        round — every other shard sees an empty round, so the global
        epoch stream stays contiguous and a round fed mid-migration
        waits on the routing lock and lands exactly once under the new
        placement.  Replicas carry over with their floors reset (the
        migrated rows are all dated at the migration epoch, so nothing
        compacts until clients ack past the move).  Returns the
        migration round's global epoch."""
        from ..doc import strip_envelope

        with self._route_lock:
            if not (0 <= di < self.n_docs):
                raise ValueError(
                    f"doc index {di} out of range [0, {self.n_docs})"
                )
            if not (0 <= to_shard < self.n_shards):
                raise ValueError(
                    f"target shard {to_shard} out of range "
                    f"[0, {self.n_shards})"
                )
            src, src_slot = self.placement.place(di)
            if src == to_shard:
                return self._global_epoch
            if not self._host_fallback_flag:
                raise ShardingError(
                    "migration needs host_fallback=True shards (the "
                    "doc's history is re-exported from the source "
                    "shard's mirror)"
                )
            if self.shards[src].degraded or self.shards[to_shard].degraded:
                raise ShardingError(
                    f"cannot migrate doc {di}: shard "
                    f"{src if self.shards[src].degraded else to_shard} "
                    "is degraded — recover() it first"
                )
            if self.family not in ("map", "counter") and self._cid is None:
                raise ShardingError(
                    "migration needs the served container id — ingest "
                    "at least one round (with cid) first"
                )
            self._drain_pipeline()
            # full-history export from the source mirror (deep anchors
            # keep it exportable across checkpoints)
            eng = self.shards[src].seed_mirror_engine()
            doc = eng.docs[src_slot]
            payload = None
            if len(doc.oplog_vv()):
                try:
                    payload = strip_envelope(doc.export_updates())
                except LoroError as e:
                    raise ShardingError(
                        f"doc {di}: source mirror cannot export full "
                        f"history ({e}) — the shard was restored from a "
                        "non-deep anchor; rebuild it from a fleet "
                        "checkpoint to migrate"
                    ) from e
            replicas = list(self.shards[src].acks[src_slot])
            new_slot = self.placement.move(di, to_shard)
            # the migration round: ONE ordinary fleet round whose only
            # payload is the doc's history at its new slot
            ups: List = [None] * self.n_docs
            ups[di] = payload
            parts = self._split(ups)
            self._tick_shard_rounds(parts)
            eps: List[int] = []
            try:
                for s, srv in enumerate(self.shards):
                    eps.append(srv.ingest(parts[s], self._cid))
            except BaseException:
                # roll the placement back: the doc must keep serving
                # from its (untouched) source slot, never point at a
                # slot the round may not have populated.  The spare
                # slot is re-freed only if the target shard never
                # applied its slice — a populated orphan slot is
                # retired, the same rule the recovery guard enforces
                # (a free-but-populated slot could absorb a second
                # doc).  Shard clocks that already ticked re-sync
                # through the epoch maps at the next commit.
                target_done = (
                    len(eps) > to_shard
                    and new_slot not in
                    self.shards[to_shard].last_poison_docs
                )
                self.placement.shard_of[di] = src
                self.placement.slot_of[di] = src_slot
                if not target_done:
                    self.placement.free[to_shard].insert(0, new_slot)
                raise
            g = self._commit_global(eps)
            if new_slot in self.shards[to_shard].last_poison_docs:
                # the history payload was poison-skipped: NOTHING
                # landed in the spare slot, so reclaim it, point the
                # doc back at its (untouched) source slot and surface
                # typed — never serve a silently-empty doc
                self.placement.shard_of[di] = src
                self.placement.slot_of[di] = src_slot
                self.placement.free[to_shard].insert(0, new_slot)
                raise ShardingError(
                    f"doc {di}: migration round was poison-skipped on "
                    f"shard {to_shard} — placement rolled back, the "
                    "doc still serves from its source shard"
                )
            # replica set carries over; floors restart at 0 (every
            # migrated row/tombstone is dated at the migration epoch,
            # so nothing reclaims until clients ack past the move)
            s_new, l_new = self.placement.place(di)
            for rep in replicas:
                self.shards[s_new].register_replica(l_new, rep)
            self.shards[src].acks[src_slot] = {}
            obs.counter(
                "shard.migrations_total", "live doc migrations"
            ).inc(family=self.family)
            for s in (src, to_shard):
                obs.gauge("shard.docs", "docs placed on the shard").set(
                    len(self.placement.docs_of(s)),
                    family=self.family, shard=str(s),
                )
            if self._durable_dir is not None:
                # fsync BEFORE publishing the new placement: in group
                # fsync mode the migration round is only appended so
                # far — a manifest that durably pointed the doc at a
                # never-fsynced slot would serve it empty after a
                # crash.  (The opposite ordering — round durable,
                # manifest lost — is the recovery guard's case: the
                # doc keeps serving from its source slot.)
                self.flush_durable()
                self._write_manifest()
            return g

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        err = None
        if self._pipeline is not None and not self._pipeline.closed:
            try:
                self._pipeline.close()
            except RuntimeError as e:
                err = e
        for srv in self.shards:
            try:
                srv.close()
            except PersistError as e:
                err = err or e
        if err is not None:
            raise err


# ---------------------------------------------------------------------------
# durable recovery
# ---------------------------------------------------------------------------


def load_manifest(durable_dir: str) -> Optional[dict]:
    """The ``sharding.json`` manifest of a sharded durable dir, or
    None when the directory is not sharded."""
    path = os.path.join(durable_dir, MANIFEST_NAME)
    if not os.path.isfile(path):
        return None
    with open(path, "r") as f:
        m = json.load(f)
    if m.get("version", 0) > MANIFEST_VERSION:
        raise PersistError(
            f"{durable_dir}: shard manifest v{m.get('version')} newer "
            "than supported"
        )
    return m


def recover_sharded_server(durable_dir: str, devices: Optional[Sequence[DeviceLike]] = None,
                           fsync: bool = True) -> ShardedResidentServer:
    """Reopen a sharded durable directory after a crash: every shard
    recovers independently (``persist.recover_server`` per
    ``shard-NN/`` — newest valid rung + bounded WAL replay), then the
    fleet reassembles from the ``sharding.json`` manifest.  Shards may
    recover at different epochs (independent fsync tails); the global
    clock resumes at the furthest shard and the fleet
    ``durable_epoch`` stays the min over shards.  ``devices`` defaults
    to every visible card (DeviceUnavailable without one), resolved
    before the directory is read."""
    from ..persist import recover_server

    devices = make_mesh(devices)

    manifest = load_manifest(durable_dir)
    if manifest is None:
        raise PersistError(
            f"{durable_dir}: no {MANIFEST_NAME} — not a sharded durable "
            "dir (use persist.recover_server for single-server dirs)"
        )
    n_shards = int(manifest["shards"])
    shard_devices = shard_meshes(devices, n_shards)
    shard_srvs: List[ResidentServer] = []
    try:
        for s in range(n_shards):
            sub = os.path.join(durable_dir, f"shard-{s:02d}")
            if not os.path.isdir(sub):
                raise PersistError(
                    f"{durable_dir}: manifest names {n_shards} shards "
                    f"but shard-{s:02d}/ is missing"
                )
            shard_srvs.append(
                recover_server(sub, device=shard_devices[s].lead, fsync=fsync)
            )
    except BaseException:
        for srv in shard_srvs:
            try:
                srv.close()
            except Exception:  # tpulint: disable=LT-EXC(best-effort shard close while the recovery error propagates)
                pass
        raise
    srv = ShardedResidentServer._assemble(
        manifest, shard_srvs, devices, shard_devices, durable_dir=durable_dir
    )
    obs.counter("shard.recoveries_total", "sharded fleet reopens").inc(
        family=srv.family
    )
    return srv
