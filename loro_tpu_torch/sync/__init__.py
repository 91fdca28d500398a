"""Session-oriented sync front end (the port of loro_tpu/sync/).

``SyncServer`` fronts a ``ResidentServer`` with many concurrent client
sessions: per-session version vectors, delta export since the client
frontier (``Session.pull``), batched fan-in of pushes into pipelined
ingest rounds with backpressure (``fanin.FanIn``), fan-out of committed
epochs as delta notifications, and an ephemeral presence plane
(``presence.PresencePlane`` over ``loro_tpu_torch.awareness``).

Reads ride the batched device read plane by default
(``readbatch.ReadBatcher``: concurrent ``Session.pull``s coalesce into
one export-selection launch on the server's device, byte-identical to
the oracle export; ``read_batch=False`` keeps every pull on the per-doc
oracle).  Only an armed fault degrades a read window to the oracle; a
real device failure reaches the window's pullers as a typed
``DeviceFailure``.

Typed errors live in ``loro_tpu_torch.errors``: ``SyncError``,
``PushRejected``, ``StaleFrontier``, ``SessionClosed``.
"""
from ..errors import PushRejected, SessionClosed, StaleFrontier, SyncError
from .fanin import FanIn, PushTicket
from .presence import PresencePlane
from .readbatch import PullTicket, ReadBatcher
from .server import SyncServer
from .session import Session

__all__ = [
    "SyncServer",
    "Session",
    "FanIn",
    "PushTicket",
    "PullTicket",
    "ReadBatcher",
    "PresencePlane",
    "SyncError",
    "PushRejected",
    "StaleFrontier",
    "SessionClosed",
]
