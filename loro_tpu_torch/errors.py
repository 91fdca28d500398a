"""Exception types of the PyTorch port (its own copies: the port imports
nothing of the JAX package)."""


class LoroError(Exception):
    pass


class DecodeError(LoroError):
    pass


class CodecDecodeError(DecodeError, ValueError):
    """Truncated, bit-flipped or otherwise malformed wire bytes.

    Subclasses ValueError so ``except ValueError`` guards keep working;
    callers that want the typed contract catch CodecDecodeError (or
    DecodeError)."""


class ConfigError(LoroError, ValueError):
    """Invalid tuning value (rank spec, ruler spacing k, placement,
    device name, ...), raised at first use with the accepted values
    spelled out — never a silent fall-back to the default.

    Subclasses ValueError so ``except ValueError`` guards keep working.
    """

    def __init__(self, knob: str, got: object, accepted: str):
        self.knob = knob
        self.got = got
        self.accepted = accepted
        super().__init__(f"{knob}={got!r} invalid: accepted {accepted}")


class DeviceUnavailable(LoroError, RuntimeError):
    """An entry point was asked for a CUDA device on a machine without
    one.  The port never falls back to the CPU on its own: callers that
    want the CPU pass ``device="cpu"``."""


class PersistError(LoroError):
    """Durability-layer failure (loro_tpu/persist/): a WAL append or
    checkpoint write did not reach disk, or a durable directory is in a
    state the requested operation cannot honor (e.g. opening an
    existing log as a fresh server).  Corrupt *reads* raise DecodeError
    subclasses instead — this type is for the write/lifecycle side."""


class SyncError(LoroError):
    """Base for the sync front end (sync/)."""


class PushRejected(SyncError):
    """A pushed update payload did not decode (poison): the push's
    ticket fails typed with this, other sessions' pushes in the same
    fan-in batch land normally.  The client should re-export and retry;
    the server state never half-applied the payload."""


class StaleFrontier(SyncError):
    """The client's frontier is below the server oracle's shallow root
    (history there was trimmed by the checkpoint ladder) AND the client
    is not empty, so neither a delta nor a snapshot can be served — the
    client must resync from scratch (fresh doc, then ``pull()`` takes
    the first-sync snapshot path)."""


class SessionClosed(SyncError):
    """Operation on a session that was closed or TTL-expired."""


class NetError(LoroError):
    """Base for the network edge (net/): frame-layer violations
    (oversized frames, send-queue overflow, a closed or refused
    connection) and client-side transport failures.  A NetError fails
    exactly ONE connection — the accept loop and every other live
    session keep serving.  Truncated / bit-flipped frame *bytes* raise
    ``CodecDecodeError`` (the codec-harden contract); sync-layer
    outcomes crossing the wire re-raise their own types
    (``PushRejected``, ``StaleFrontier``, ``NotLeader``, ...)."""


class NetProtocolError(NetError):
    """The peer spoke the wrong protocol: bad HELLO magic, an
    unsupported protocol version, an unknown message type, or a frame
    whose declared length exceeds the negotiated maximum.  The
    connection closes typed; reconnect-with-frontier resume applies."""


class ShardingError(LoroError):
    """Sharded-fleet lifecycle misuse (loro_tpu/parallel/sharded.py,
    docs/SHARDING.md): migrating to a shard with no free slot, moving a
    doc on/off a degraded shard, a shard manifest that does not match
    the durable directories under it.  Invalid shard-count *knob*
    values (LORO_SHARDS, divisibility) raise ConfigError instead."""


class ResidencyError(LoroError):
    """Tiered-residency lifecycle failure (loro_tpu/parallel/residency.py,
    docs/RESIDENCY.md): a round touched more docs than the hot-slot
    budget can hold, no evictable victim exists (every hot doc is still
    un-journaled), or an injected/real failure interrupted an evict or
    revive.  The contract: a failed EVICT leaves the doc hot (no torn
    tier state); a failed REVIVE fails only the triggering round/ticket
    and leaves the doc warm/cold — the server itself stays healthy
    either way.  Passes through DeviceSupervisor untouched (LoroError),
    so it can never be misread as a device failure and trigger
    degradation."""


class ReplicationError(LoroError):
    """Base for WAL-shipping replication (replication/): leader-side
    shipping, follower apply loops, fencing and promotion."""


class NotLeader(ReplicationError):
    """A write (push/ingest) reached a read-only follower.  Carries the
    current leader's identity so clients can redirect instead of
    guessing."""

    def __init__(self, msg: str, leader=None):
        self.leader = leader
        super().__init__(msg + (f" (leader: {leader})" if leader else ""))


class FencedLeader(ReplicationError):
    """A fenced (deposed) leader attempted a WAL append: a follower was
    promoted with a newer leader token, so this process must fail-stop
    — continuing to journal would fork the replicated history.  Raised
    BEFORE any bytes reach the segment (no partial record)."""


class StaleFollower(ReplicationError):
    """The follower's shipped position fell below the leader's WAL
    prune floor (its retention pin was dropped by the staleness
    cutoff, then the history it still needed was deleted).  The
    follower must re-bootstrap from a fresh directory — resuming would
    silently fabricate a truncated history."""


class ReplicaLag(ReplicationError):
    """A ``pull(min_epoch=...)`` read-your-writes gate timed out: the
    replica has not applied the requested epoch yet.  Retry, or pull
    from the leader."""


class ObsError(LoroError):
    """Observability-tooling failure (obs/): an unreadable or malformed
    trace/flight artifact handed to ``python -m
    loro_tpu_torch.obs.trace``, or a merge over artifacts with no common
    epoch stamps.  Always raised typed so the CLI exits with a legible
    message instead of a stack trace."""


class AnalysisError(LoroError):
    """Base for the runtime lock-order witness (analysis/)."""


class LockOrderViolation(AnalysisError):
    """The runtime lock witness observed an acquisition the declared
    partial order in analysis/lockorder.py forbids, or a cycle in the
    witnessed lock graph (a latent deadlock).  Raised only in strict
    witness mode (tests)."""


class ResilienceError(LoroError):
    """Base for the resilience subsystem (resilience/)."""


class DeviceFailure(ResilienceError):
    """Supervisor-declared device failure: a launch or fetch raised a
    device error (a CUDA error, an out-of-memory, a failed kernel launch
    or an armed fault), or exhausted its retry budget on transient
    errors.  ``injected`` is True when the error that ended the launch
    was an armed fault's (resilience.faultinject), False for a real one.
    A one-shot Fleet merge degrades to the host engine on an injected
    failure only; a real one reaches the caller as this typed error."""

    def __init__(self, label: str, attempts: int = 1, cause: str = "", injected: bool = False):
        self.label = label
        self.attempts = attempts
        self.injected = injected
        super().__init__(
            f"device failure at {label!r} after {attempts} attempt(s)"
            + (f": {cause}" if cause else "")
        )


class BackendUnavailable(DeviceFailure):
    """The backend never came up within the probe deadline
    (resilience.probe.wait_for_backend(raise_on_timeout=True))."""


class DeadlineExceeded(ResilienceError):
    """A cooperative deadline expired BETWEEN launches.  Raised only at
    launch boundaries, never by signaling a process mid-launch."""


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's launch returned a nonzero cudaError.  A
    device error, so the supervisor classifies it into DeviceFailure; not
    a LoroError, which the supervisor would pass through untouched."""


class KernelBuildError(LoroError, RuntimeError):
    """A native source of the port could not be built or its library not
    loaded (no compiler, a compiler that fails or cannot start, a library
    that does not load).  A LoroError, so the supervisor passes it
    through: a kernel that does not build never degrades to the host
    engine in silence."""
