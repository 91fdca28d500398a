"""The composed serving stack the chaos plane drives.

One ``ChaosStack`` is the fully composed regime the ROADMAP's
"millions of users" north star implies, per container family:

    ShardedResidentServer (durable group-commit WAL + checkpoint
    ladder, tiered hot/warm/cold residency, per-shard PipelinedIngest)
      <- SyncServer (fan-in, sessions, presence, device read plane)
      <- replication.enable + a live ShardedFollower (WAL shipping)

plus N writer **clients** (each a real ``LoroDoc`` pushing deltas to
every family server and reconstructing itself from pulls — the
soak_sync pattern) and a runner-owned **reference oracle**: one host
``LoroDoc`` per doc index importing every ACKED push payload.  The
reference oracle is the independent ground truth the invariant checker
compares every plane against; it deliberately never touches any server
code path.

Client operations retry on *typed* injected failures (an armed
``sync_push`` fault fails the push; the retry runs with the fault
exhausted), so a convergent end state is reachable under any SAFE-arm
schedule; anything atypical (a raw ``DeviceFailure`` escaping to a
session, retries not sufficing) is recorded and surfaces as an
``obs_sanity`` violation at the next barrier — sessions observing raw
device errors is exactly what the degradation contract forbids.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..errors import (
    ChaosError,
    DeviceFailure,
    LoroError,
    ReplicationError,
    ShardingError,
    SyncError,
)
from ..obs import metrics as obs
from ..resilience import faultinject
from .plan import ChaosConfig

#: per-family construction caps (small: chaos runs are breadth tests)
CAPS = {
    "text": dict(capacity=1 << 12),
    "map": dict(slot_capacity=128),
    "tree": dict(move_capacity=1 << 11, node_capacity=256),
    "counter": dict(slot_capacity=32),
    "movable": dict(capacity=1 << 11, elem_capacity=256),
}

#: typed failures a client operation may legitimately see under an
#: armed fault — anything else escaping a session call is an
#: obs-sanity violation (DeviceFailure must NEVER reach a session)
_TYPED_CLIENT_ERRORS = (SyncError, ReplicationError,
                       faultinject.InjectedFault, TimeoutError)

_PUSH_RETRIES = 4


def chaos_devices(cfg: ChaosConfig, devices=None) -> list:
    """The stack's device list, resolved once and handed to every
    leader, recovery and follower it builds.  ``None`` is every visible
    card (DeviceUnavailable without one); a list whose length
    ``cfg.shards`` does not divide is repeated ``cfg.shards`` times, so
    ``[cuda:0]`` at two shards runs both on the one card (a list may
    name one device twice).  A mesh gives its rows' lead devices, where
    the shards' batches live.  The list is not part of the config: plans
    and artifacts stay a function of ``(config, seed)``."""
    from ..parallel.mesh import make_mesh

    devs = [row[0] for row in make_mesh(devices).devices]
    if len(devs) % cfg.shards:
        devs = devs * cfg.shards
    return devs


def family_cids() -> Dict[str, object]:
    """Served container ids per family.  Root container ids are
    name-derived (no peer component), so a scratch doc's ids are THE
    ids every client doc produces for the same root names."""
    from .. import LoroDoc

    d = LoroDoc(peer=1)
    d.get_text("t")
    d.get_tree("tr")
    d.get_movable_list("ml")
    return {
        "text": d.get_text("t").id,
        "tree": d.get_tree("tr").id,
        "movable": d.get_movable_list("ml").id,
        "map": None,
        "counter": None,
    }


class FamilyPlane:
    """One family's slice of the stack (leader fleet + sync front +
    follower) plus its per-family bookkeeping."""

    def __init__(self, family: str):
        self.family = family
        self.resident = None
        self.sync = None
        self.follower = None
        self.dir: Optional[str] = None
        self.fol_gen = 0
        self.max_acked = 0

    def fol_dir(self, root: str) -> str:
        return os.path.join(root, f"{self.family}-fol-g{self.fol_gen}")


class ChaosClient:
    """One writer replica: a client ``LoroDoc`` + one session per
    family server.  Every edit touches all five container families so
    every family server sees ops regardless of the configured family
    subset (extra containers ride along in the payload and are simply
    not served by that family's device plane)."""

    def __init__(self, stack: "ChaosStack", n: int, di: int, peer: int):
        from .. import LoroDoc

        self.stack = stack
        self.n = n
        self.di = di
        self.peer = peer
        self.stalled = False
        self.doc = LoroDoc(peer=peer)
        self.sess = {
            fam: stack.planes[fam].sync.connect(sid=f"c{n}-{fam}")
            for fam in stack.cfg.families
        }
        fam0 = stack.cfg.families[0]
        data = self.sess[fam0].pull(di)
        if data:
            self.doc.import_(bytes(data))
        self.mark = self.doc.oplog_vv()

    def edit(self, rng) -> None:
        """Deterministic multi-container edit burst (the soak_sync op
        mix) against the client's own doc; commit, no push."""
        d = self.doc
        for _ in range(rng.randint(2, 5)):
            kind = rng.randint(0, 4)
            if kind == 0:
                t = d.get_text("t")
                L = len(t)
                if L > 4 and rng.random() < 0.3:
                    t.delete(rng.randrange(L - 2), 2)
                else:
                    t.insert(rng.randint(0, L),
                             rng.choice(["xy", "q ", "lo"]))
            elif kind == 1:
                d.get_map("m").set(rng.choice(["k1", "k2"]),
                                   rng.randrange(99))
            elif kind == 2:
                tr = d.get_tree("tr")
                nodes = tr.nodes()
                if not nodes or rng.random() < 0.5:
                    tr.create(rng.choice(nodes) if nodes else None)
                else:
                    tr.delete(rng.choice(nodes))
            elif kind == 3:
                d.get_counter("c").increment(rng.randint(-9, 9))
            else:
                ml = d.get_movable_list("ml")
                L = len(ml)
                if L >= 2 and rng.random() < 0.4:
                    ml.move(rng.randrange(L), rng.randrange(L))
                else:
                    ml.insert(rng.randint(0, L), f"s{self.n}")
        d.commit()

    def export_delta(self) -> bytes:
        payload = bytes(self.doc.export_updates(self.mark))
        self.mark = self.doc.oplog_vv()
        return payload

    def close(self) -> None:
        for s in self.sess.values():
            try:
                s.close()
            except SyncError:
                pass  # server already closed underneath us


class ChaosStack:
    """Build (or recover) the composed stack and drive it.

    All mutation runs on the caller's single thread; the only
    background threads are the stack's OWN planes (fan-in workers,
    pipeline executors, read-plane windows) — which is the point: the
    chaos plan is deterministic, the stack under it is the real
    concurrent machine.  ``devices=`` is the device list every plane
    is built on (``chaos_devices``): the card by default, ``["cpu"]``
    for the plain versions.
    """

    def __init__(self, cfg: ChaosConfig, root: str, recover: bool = False,
                 peer_base: int = 1000, devices=None):
        self.cfg = cfg
        self.root = root
        self.devices = chaos_devices(cfg, devices)
        self.cids = family_cids()
        self.planes: Dict[str, FamilyPlane] = {}
        self.clients: List[ChaosClient] = []
        self._next_peer = peer_base
        self._next_client = peer_base
        # raw (non-typed) errors a session call surfaced — the
        # obs-sanity invariant reads and drains this
        self.raw_errors: List[str] = []
        self.unresolved: List[str] = []  # ops retries could not land
        # resolved push-ticket breakdowns (bounded window) — the
        # attribution invariant checks each one's stages telescope to
        # its end-to-end total (docs/OBSERVABILITY.md)
        self.breakdowns: List[dict] = []
        os.makedirs(root, exist_ok=True)
        for fam in cfg.families:
            p = FamilyPlane(fam)
            p.dir = os.path.join(root, fam)
            self.planes[fam] = p
            if recover:
                self._recover_plane(p)
            else:
                self._build_plane(p)
        # health plane riding the stack (docs/OBSERVABILITY.md "Health &
        # heat"): ticked at settle + checked by the `health` invariant.
        # Ticks read the stack, never steer it — the plan stays a pure
        # function of (config, seed).
        from ..obs import health as health_mod

        self.health = health_mod.HealthPlane(window_s=300.0)
        self._refresh_health()
        for i in range(cfg.sessions):
            self.new_client(i % cfg.docs)

    # -- plane lifecycle ------------------------------------------------
    def _leader_kwargs(self) -> dict:
        cfg = self.cfg
        kw = dict(durable_fsync="group", fsync_window=cfg.fsync_window)
        if cfg.hot_slots is not None:
            kw["hot_slots"] = cfg.hot_slots
        return kw

    def _build_plane(self, p: FamilyPlane) -> None:
        from ..parallel.sharded import ShardedResidentServer

        cfg = self.cfg
        p.resident = ShardedResidentServer(
            p.family, cfg.docs, shards=cfg.shards, devices=self.devices,
            durable_dir=p.dir,
            **self._leader_kwargs(), **CAPS[p.family],
        )
        self._front(p)

    def _recover_plane(self, p: FamilyPlane) -> None:
        from ..persist import recover_sharded_server

        p.resident = recover_sharded_server(p.dir, devices=self.devices)
        self._front(p)

    def _front(self, p: FamilyPlane) -> None:
        """Attach replication + sync front + follower to ``p.resident``
        (shared by build, recover, reopen and promote)."""
        from ..replication import ShardedFollower, enable
        from ..sync import SyncServer

        cfg = self.cfg
        if cfg.follower:
            # re-claiming the same leader id after a reopen is
            # idempotent (manifest.claim_leader) — the fence, the
            # .visible marker and the retention pin re-install
            enable(p.resident, f"chaos-{p.family}")
        p.sync = SyncServer.over(p.resident, cid=self.cids[p.family],
                                 coalesce=cfg.coalesce)
        if cfg.follower:
            p.follower = ShardedFollower(
                p.dir, p.fol_dir(self.root),
                follower_id=f"chaos-fol-{p.family}", leader=p.resident,
                devices=self.devices,
            )

    def _refresh_health(self) -> None:
        """Point the health plane at the CURRENT topology (the first
        family's serving pair + every live follower) — called after
        build/recover/reopen/promote."""
        p0 = self.planes[self.cfg.families[0]]
        self.health.attach_resident(p0.resident)
        self.health.attach_sync(p0.sync)
        self.health.set_followers(
            [p.follower for p in self.planes.values()
             if p.follower is not None])

    def _teardown_plane(self, p: FamilyPlane) -> None:
        if p.follower is not None:
            p.follower.close()
            p.follower = None
        if p.sync is not None:
            p.sync.flush()
            p.sync.close()
            p.sync = None
        if p.resident is not None:
            p.resident.close()
            p.resident = None

    def _quiesce_faults(self) -> None:
        """Topology nemeses (reopen/promote/kill) run against a clean
        fault table: recovery replay on a device with an armed fatal
        fault fails typed BY CONTRACT (the operator retries) — inside
        a deterministic schedule the retry is this clear (counted)."""
        left = faultinject.active()
        if left:
            obs.counter("chaos.faults_cleared_total",
                        "armed-but-unfired faults cleared at barriers "
                        "and topology nemeses").inc(sum(left.values()))
        faultinject.clear()

    def reopen(self, family: str) -> None:
        """Graceful close + durable recovery + re-front + follower
        resume; clients reconnect from first-sync pulls (the recovered
        oracle is shallow, so a fresh client's first pull takes the
        snapshot path — load-bearing, same as docs/SYNC.md)."""
        self._quiesce_faults()
        p = self.planes[family]
        self._teardown_plane(p)
        self._recover_plane(p)
        self._refresh_health()
        obs.counter("chaos.reopens_total",
                    "in-process close+recover nemesis executions").inc(
            family=family)
        self.reset_clients()

    def promote(self, family: str) -> None:
        """Failover: drain + retire the leader, promote its follower
        to a writable fleet, re-front it, and start a fresh follower
        generation over the promoted directory."""
        p = self.planes[family]
        if p.follower is None:
            return
        self._quiesce_faults()
        p.sync.flush()
        p.resident.flush_durable()
        self.catch_up(p)
        promoted_dir = p.fol_dir(self.root)
        p.sync.close()
        p.resident.close()
        try:
            promoted = p.follower.promote(f"chaos-{family}")
        except (ReplicationError, faultinject.InjectedFault):
            # an armed repl_promote fault: a retried promote starts
            # clean (docs/REPLICATION.md)
            promoted = p.follower.promote(f"chaos-{family}")
        # discard the wrapper WITHOUT close(): a promoted follower's
        # per-shard residents ARE the promoted fleet
        p.follower = None
        p.resident = promoted
        p.dir = promoted_dir
        # pre-promote acked epochs are on the RETIRED leader's global
        # scale; the promoted fleet numbers its own.  The promote gate
        # (flush + catch_up to lag 0 before the flip) discharged them —
        # the durability watermark restarts on the promoted scale.
        p.max_acked = 0
        p.fol_gen += 1
        self._front(p)
        self._refresh_health()
        obs.counter("chaos.promotions_total",
                    "follower promotions executed").inc(family=family)
        self.reset_clients()

    # -- clients --------------------------------------------------------
    def new_client(self, di: int) -> ChaosClient:
        self._next_client += 1
        self._next_peer += 1
        c = ChaosClient(self, self._next_client, di, self._next_peer)
        self.clients.append(c)
        return c

    def drop_client(self, sel: int) -> Optional[ChaosClient]:
        if len(self.clients) <= 1:
            return None
        c = self.clients.pop(sel % len(self.clients))
        c.close()
        return c

    def pick_client(self, sel: int) -> ChaosClient:
        return self.clients[sel % len(self.clients)]

    def reset_clients(self) -> None:
        """Replace every client with a fresh replica reconstructed
        purely from pulls (fresh peer ids — abandoned local ops must
        never be resumed under a reused peer)."""
        old = list(self.clients)
        self.clients = []
        for c in old:
            c.close()
        for c in old:
            self.new_client(c.di)
        obs.counter("chaos.client_resets_total",
                    "client cohorts rebuilt from pulls").inc(len(old))

    # -- client operations (retry-on-typed protocol) --------------------
    def push_payload(self, c: ChaosClient, payload: bytes,
                     oracle_docs: List) -> Dict[str, int]:
        """Push one enveloped payload from client ``c`` to every family
        server — through ``c``'s OWN sessions: the commit hook advances
        the pushing session's pull frontier past the pushed ops
        ("the pusher holds its own ops"), so pushing through any other
        client's session silently desyncs that client's frontier from
        its doc.  Retries typed failures with the fault exhausted;
        applies the payload to the reference oracle once every family
        acked.  Returns per-family acked epochs ({} when the payload
        could not land — recorded, surfaces at the barrier)."""
        di = c.di
        acked: Dict[str, int] = {}
        for fam in self.cfg.families:
            p = self.planes[fam]
            err = None
            for _ in range(_PUSH_RETRIES):
                try:
                    tk = self._session_of(c, fam).push(di, payload)
                    acked[fam] = tk.epoch(120)
                    p.max_acked = max(p.max_acked, acked[fam])
                    bd = tk.breakdown()
                    bd["family"] = fam
                    self.breakdowns.append(bd)
                    if len(self.breakdowns) > 128:
                        del self.breakdowns[:64]
                    err = None
                    break
                except _TYPED_CLIENT_ERRORS as e:
                    err = e
                except Exception as e:  # tpulint: disable=LT-EXC(the chaos checker's business: a raw error reaching a session IS the obs_sanity violation being recorded)
                    err = e
                    self.raw_errors.append(
                        f"push {fam}/doc{di}: {type(e).__name__}: {e}")
                    break
            if err is not None and fam not in acked:
                self.unresolved.append(
                    f"push {fam}/doc{di}: {type(err).__name__}: {err}")
        if len(acked) == len(self.cfg.families):
            oracle_docs[di].import_(bytes(payload))
        return acked

    def _session_of(self, c: ChaosClient, fam: str):
        """``c``'s session on ``fam``, reconnected if the server closed
        it underneath (reopen churn).  A fresh session starts with an
        empty frontier — pulls re-serve ops the client already holds,
        which a CRDT import absorbs idempotently; the safe direction."""
        s = c.sess.get(fam)
        if s is None or s.closed:
            s = self.planes[fam].sync.connect(sid=f"c{c.n}-{fam}-r")
            c.sess[fam] = s
        return s

    def pull_client(self, c: ChaosClient) -> List[str]:
        """Pull every family for ``c``'s doc with the byte-identity
        gate: the served bytes must equal the serving oracle's own
        export from the session's frontier (ExportMode.Updates, or the
        first-sync snapshot on a shallow oracle).  Returns violation
        detail strings (empty = clean)."""
        from ..doc import ExportMode

        bad: List[str] = []
        fam0 = self.cfg.families[0]
        for fam in self.cfg.families:
            p = self.planes[fam]
            sess = c.sess[fam]
            if sess.closed:
                continue
            p.sync.flush()
            got = want = None
            for _ in range(3):
                try:
                    fvv = sess.frontier(c.di)
                    od = p.sync.oracle_doc(c.di)
                    if od.is_shallow() and not (od.shallow_since_vv() <= fvv) \
                            and len(fvv) == 0:
                        want = bytes(od.export(ExportMode.Snapshot))
                    else:
                        want = bytes(od.export(ExportMode.Updates(fvv)))
                    got = bytes(sess.pull(c.di))
                    break
                except _TYPED_CLIENT_ERRORS:
                    continue
                except Exception as e:  # tpulint: disable=LT-EXC(recorded as the obs_sanity violation, not swallowed)
                    self.raw_errors.append(
                        f"pull {fam}/doc{c.di}: {type(e).__name__}: {e}")
                    break
            if got is None:
                bad.append(f"pull {fam}/doc{c.di}: never served")
                continue
            if got != want:
                bad.append(
                    f"pull {fam}/doc{c.di}: served {len(got)}B != oracle "
                    f"export {len(want)}B")
            if fam == fam0 and got:
                c.doc.import_(got)
        c.mark = c.doc.oplog_vv()
        return bad

    # -- nemesis helpers ------------------------------------------------
    def net_nemesis(self, family: str, seed: int) -> List[str]:
        """Socket-edge nemesis (docs/NET.md): front ``family``'s LIVE
        SyncServer with a ``net.NetServer`` on an ephemeral port, pull
        one doc over a real TCP socket with the byte-identity gate
        (served bytes == the oracle's own export from the client's
        frontier), inject one seeded connection fault, kill the
        connection abruptly (the in-process SIGKILL stand-in) and
        reconnect-with-frontier — the resumed pull is gated the same
        way.  Pull-only by construction: pushes stay on the in-process
        sessions, so the reference oracle's acked-payload bookkeeping
        is untouched.  Returns violation detail strings."""
        import random as _random

        from ..doc import ExportMode
        from ..errors import DecodeError, NetError
        from ..net import NetClient, NetServer

        rng = _random.Random(seed)
        bad: List[str] = []
        p = self.planes[family]
        p.sync.flush()
        di = rng.randrange(self.cfg.docs)
        srv = cli = None
        try:
            srv = NetServer(p.sync)
            cli = NetClient("127.0.0.1", srv.port, family,
                            client_id=f"chaos-net-{seed}")
            cli.connect()

            def gate(tag: str) -> None:
                from ..core.version import VersionVector

                od = p.sync.oracle_doc(di)
                fvv = cli.frontiers.get(di) or VersionVector()
                if od.is_shallow() and not (od.shallow_since_vv() <= fvv) \
                        and len(fvv) == 0:
                    want = bytes(od.export(ExportMode.Snapshot))
                else:
                    want = bytes(od.export(ExportMode.Updates(fvv)))
                got = bytes(cli.pull(di))
                if got != want:
                    bad.append(
                        f"net {family}/doc{di} {tag}: socket pull "
                        f"{len(got)}B != oracle export {len(want)}B")

            gate("pre")
            arm = rng.randrange(3)
            if arm == 0:
                # writer stall: the pull's DELTA is delayed, never lost
                faultinject.inject("conn_stall", action="delay",
                                   delay_s=0.005, times=1)
                gate("stalled")
            elif arm == 1:
                # a bit-flipped inbound frame fails ONLY this
                # connection, typed; the reconnect below is the resume
                faultinject.inject("net_frame", action="bitflip", times=1)
                try:
                    cli.pull(di)
                    bad.append(
                        f"net {family}/doc{di}: bit-flipped frame was "
                        "served instead of failing typed")
                except (NetError, DecodeError):
                    pass
            else:
                # accept refusal: the FIRST reconnect attempt is
                # refused typed; the retry (fault exhausted) serves
                faultinject.inject("net_accept", action="raise", times=1)
                cli.kill()  # tpulint: disable=LT-TUNNEL(NetClient.kill = abrupt socket close, not a process signal)
                try:
                    cli.reconnect()
                    bad.append(
                        f"net {family}/doc{di}: accept fault did not "
                        "refuse the connection")
                except (NetError, DecodeError):
                    pass
            # abrupt kill + reconnect-with-frontier resume (retry once:
            # the armed fault above may have already torn the socket)
            cli.kill()  # tpulint: disable=LT-TUNNEL(NetClient.kill = abrupt socket close, not a process signal)
            for attempt in range(2):
                try:
                    cli.reconnect()
                    break
                except (NetError, DecodeError):
                    if attempt:
                        raise
            gate("resumed")
            obs.counter("chaos.net_nemeses_total",
                        "socket-edge nemesis executions").inc(
                family=family)
        finally:
            for site in ("conn_stall", "net_frame", "net_accept"):
                faultinject.clear(site)
            if cli is not None:
                cli.kill()  # tpulint: disable=LT-TUNNEL(NetClient.kill = abrupt socket close, not a process signal)
            if srv is not None:
                srv.close()
        return bad

    def checkpoint(self, family: str) -> bool:
        p = self.planes[family]
        try:
            p.sync.flush()
            p.resident.checkpoint()
            return True
        except DeviceFailure:
            # an armed fatal launch fault mid-checkpoint: typed refusal
            # (the ladder keeps its previous rung; retried next time)
            obs.counter("chaos.nemesis_refused_total",
                        "housekeeping steps refused typed under armed "
                        "faults").inc(kind="checkpoint", family=family)
            return False

    def compact(self, family: str) -> bool:
        try:
            self.planes[family].sync.compact()
            return True
        except DeviceFailure:
            obs.counter("chaos.nemesis_refused_total",
                        "housekeeping steps refused typed under armed "
                        "faults").inc(kind="compact", family=family)
            return False

    def demote(self, family: str, pick: int) -> bool:
        """Demote one warm doc of one shard to the cold tier (durable
        rung + WAL tail).  Typed ResidencyError (e.g. an armed
        evict_flush) leaves the doc hot — counted, not a violation."""
        from ..errors import ResidencyError

        p = self.planes[family]
        p.sync.flush()
        shards = p.resident.shards
        for off in range(len(shards)):
            srv = shards[(pick + off) % len(shards)]
            res = getattr(srv, "residency", None)
            if res is None:
                continue
            warm = res.tiers().get("warm", [])
            if not warm:
                continue
            try:
                srv.batch.demote(warm[pick % len(warm)])
                obs.counter("chaos.demotions_total",
                            "explicit warm->cold demotions").inc(
                    family=family)
                return True
            except (ResidencyError, faultinject.InjectedFault):
                obs.counter(
                    "chaos.demote_failures_total",
                    "typed demote failures (armed evict faults)",
                ).inc(family=family)
                return False
        return False

    def migrate(self, family: str, di: int) -> bool:
        p = self.planes[family]
        if p.resident.n_shards < 2:
            return False
        di = di % self.cfg.docs
        cur, _ = p.resident.placement.place(di)
        target = (cur + 1) % p.resident.n_shards
        try:
            p.resident.migrate(di, target)
            obs.counter("chaos.migrations_total",
                        "live doc migrations executed").inc(family=family)
            return True
        except (ShardingError, LoroError):
            # typed lifecycle refusal (no spare slot, degraded shard):
            # a legitimate outcome under chaos, never a violation
            obs.counter("chaos.migrate_refused_total",
                        "typed migrate refusals").inc(family=family)
            return False

    def arm_fault(self, params: dict) -> None:
        kw = {k: v for k, v in params.items() if k in (
            "action", "delay_s", "keep_bytes", "flip_at", "times")}
        if params.get("msg"):
            kw["exc"] = faultinject.InjectedFault(params["msg"])
        faultinject.inject(params["site"], **kw)
        obs.counter("chaos.faults_armed_total",
                    "fault arms scheduled by chaos plans").inc(
            site=params["site"])

    # -- quiesce (the barrier's settle phase) ---------------------------
    def catch_up(self, p: FamilyPlane, passes: int = 10) -> int:
        """Drive the follower's lag to 0 (armed repl faults make single
        passes fail/fall short; the loop retries with them exhausted).
        Returns the final lag."""
        if p.follower is None:
            return 0
        lag = -1
        for _ in range(passes):
            p.resident.flush_durable()
            try:
                p.follower.catch_up()
            except (ReplicationError, faultinject.InjectedFault, OSError):
                continue
            lag = p.follower.lag_epochs
            if lag == 0:
                return 0
        return lag

    def settle(self) -> None:
        """Quiesce before invariant checks: drain every plane, clear
        leftover armed faults (counted), heal degraded shards, bring
        followers to lag 0.  Mutates only toward the steady state the
        degradation contracts promise."""
        # sample BEFORE quiescing: an armed health_tick fault must hit
        # a real tick (the skip path), not be cleared unfired below
        self.health.tick()
        self._quiesce_faults()
        for p in self.planes.values():
            p.sync.flush()
            if p.resident.degraded:
                ok = p.resident.recover()
                obs.counter("chaos.shard_recoveries_total",
                            "degraded-shard recoveries at barriers").inc(
                    family=p.family)
                if not ok:
                    self.raw_errors.append(
                        f"{p.family}: degraded shard did not recover")
            p.resident.flush_durable()
            if p.follower is not None:
                for f in p.follower.shards:
                    if f.resident.degraded:
                        f.resident.recover()
        # unstall everyone: stalled clients catch up right after checks
        for c in self.clients:
            c.stalled = False

    # -- lifecycle ------------------------------------------------------
    def hold_marker(self) -> str:
        return os.path.join(self.root, "CHAOS_READY")

    def close(self) -> None:
        for c in self.clients:
            c.close()
        self.clients = []
        err: Optional[BaseException] = None
        for p in self.planes.values():
            try:
                self._teardown_plane(p)
            except LoroError as e:
                err = e
        if err is not None:
            raise ChaosError(f"stack teardown failed: {err}") from err
