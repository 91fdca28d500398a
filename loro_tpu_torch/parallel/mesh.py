"""The device mesh of the fleet: the port of loro_tpu/parallel/mesh.py.

The distributed axis of a CRDT fleet is document-batch parallelism: docs
are independent, so the mesh shards the doc axis ("docs").  A second
axis ("ops") shards the op rows of one doc batch for very large imports
(ops/lww.make_lww_sharded, ops/fugue_batch.make_ring_rank_sharded); by
default it has size 1.

A mesh is a grid of torch.devices of the port's own (not
torch.distributed's DeviceMesh): rows are the "docs" axis, columns the
"ops" axis.  One process drives the whole grid, as JAX's single
controller does, and a collective is an explicit copy onto the device
that combines: a max over the op axis stacks the shards' partials on the
row's lead device (its first entry), a gather concatenates the shards'
tables onto each shard's device.  On a host with several cards those
copies are peer copies.  torch.distributed is not used: it would make
every entry point SPMD code that each rank calls, and NCCL refuses two
ranks on one card.

A grid may name one device many times: ``make_mesh(["cpu"] * 8,
op_parallel=2)`` is a 4 x 2 mesh on the host, ``[cuda:0] * 4`` four rows
on one card, each row with its own tensors.  A flat device list is
accepted wherever a mesh is, as a one-column mesh.  The port's code
reads a mesh through its rows (``devices``, ``shape``, ``lead``): a port
batch lives on one device, so doc-sharded work runs each row's docs on
the row's lead device, and a shard carved by ``shard_meshes`` binds its
batches to its sub-mesh's lead.  A mesh also reads as the list of its
entries in row-major order (``len``, indexing, iteration), the form
``shard_meshes`` and the sharded server's device lists had before the
op axis; for a one-column mesh, every list, the two agree.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..errors import ConfigError, DeviceUnavailable

DOC_AXIS = "docs"
OP_AXIS = "ops"


class Mesh(Sequence[torch.device]):
    """A rectangular grid of torch.devices with axes ("docs", "ops").
    ``devices`` holds the rows, ``shape`` the axis sizes ({"docs": rows,
    "ops": columns}); as a sequence it is the grid's entries in row-major
    order (so ``len`` counts entries, ``shape["docs"]`` rows)."""

    axis_names = (DOC_AXIS, OP_AXIS)

    def __init__(self, devices: Iterable[Iterable[torch.device]]):
        rows = tuple(tuple(r) for r in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ConfigError("mesh", [list(r) for r in rows], "a non-empty rectangular grid of devices")
        self.devices = rows
        self.shape = {DOC_AXIS: len(rows), OP_AXIS: len(rows[0])}
        self._flat = tuple(d for r in rows for d in r)

    def __len__(self) -> int:
        return len(self._flat)

    def __getitem__(self, i):
        return self._flat[i]

    def __repr__(self) -> str:
        return f"Mesh({[[str(d) for d in r] for r in self.devices]})"

    @property
    def lead(self) -> torch.device:
        """The first device: where gathered results land."""
        return self.devices[0][0]


MeshLike = Union[Mesh, Sequence[DeviceLike]]


def _positive_int(knob: str, value) -> int:
    if not isinstance(value, int) or isinstance(value, bool) or value < 1:
        raise ConfigError(knob, value, "positive integer")
    return value


def make_mesh(devices: Optional[MeshLike] = None, op_parallel: int = 1) -> Mesh:
    """A ("docs", "ops") mesh of ``devices`` resolved (each must be
    usable: DeviceUnavailable for a card that is not there), or of every
    visible card when None (DeviceUnavailable without one), reshaped to
    (n // op_parallel, op_parallel).  ConfigError when op_parallel does
    not divide n (JAX asserts).  A Mesh comes back as it is (op_parallel
    must then be 1 or its own op axis)."""
    op_parallel = _positive_int("op_parallel", op_parallel)
    if isinstance(devices, Mesh):
        if op_parallel not in (1, devices.shape[OP_AXIS]):
            raise ConfigError("op_parallel", op_parallel, f"1 or the mesh's op axis ({devices.shape[OP_AXIS]})")
        return devices
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise DeviceUnavailable(
                "no CUDA device visible for the fleet's default mesh; "
                "pass devices=['cpu', ...] to run the plain versions"
            )
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ConfigError("devices", list(devices), "a non-empty device list")
    if len(devs) % op_parallel:
        raise ConfigError("op_parallel", op_parallel, f"a divisor of the device count ({len(devs)})")
    return Mesh(devs[i:i + op_parallel] for i in range(0, len(devs), op_parallel))


def doc_sharding(mesh: MeshLike, n_docs: int) -> List[Tuple[torch.device, slice]]:
    """Each row's lead device and its contiguous slice of ``n_docs``
    docs (the layout of JAX's P("docs")); ConfigError when the rows do
    not divide n_docs."""
    mesh = make_mesh(mesh)
    rows = mesh.shape[DOC_AXIS]
    if n_docs % rows:
        raise ConfigError("docs", n_docs, f"a multiple of the mesh's doc axis ({rows} row(s))")
    k = n_docs // rows
    return [(r[0], slice(i * k, (i + 1) * k)) for i, r in enumerate(mesh.devices)]


def replicated(mesh: MeshLike) -> Tuple[torch.device, ...]:
    """The devices a replicated table is copied to: each distinct device
    of the mesh once, in row-major order.  JAX's surface, kept for
    parity: nothing in the port calls it (JAX replicates resident
    batches; the port binds each to one device)."""
    return tuple(dict.fromkeys(make_mesh(mesh)))


def shard_doc_batch(mesh: MeshLike, tree) -> list:
    """A NamedTuple of [D, ...] arrays (numpy or tensors; nested column
    tuples carried whole) split into one NamedTuple a mesh row, each
    row's contiguous docs on that row's lead device (numpy becomes
    tensors there, uint32 as int64 holding the same values)."""
    from ..ops.fugue_batch import _on

    return [_on(docs_of(tree, sl), dev) for dev, sl in doc_sharding(mesh, doc_count(tree))]


def doc_count(tree) -> int:
    """The leading (doc) dimension of a column tuple's first array."""
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree.shape[0]


def docs_of(tree, sl: slice):
    """The docs `sl` of a column tuple of [D, ...] arrays (nested column
    tuples cut alike)."""
    return type(tree)(*(docs_of(c, sl) for c in tree)) if isinstance(tree, tuple) else tree[sl]


def shard_meshes(mesh: MeshLike, n_shards: int) -> List[Mesh]:
    """Carve a mesh (or a device list, as one column) into ``n_shards``
    contiguous doc-axis slices, one sub-mesh a shard (the op axis kept);
    raises typed ConfigError when the doc axis does not divide evenly (a
    ragged carve would skew per-shard capacity).  Each shard's batches
    live on its sub-mesh's lead device."""
    mesh = make_mesh(mesh)
    n_shards = _positive_int("shards", n_shards)
    rows = mesh.shape[DOC_AXIS]
    if rows % n_shards:
        raise ConfigError("shards", n_shards, f"a divisor of the mesh doc axis ({rows} device row(s))")
    k = rows // n_shards
    return [Mesh(mesh.devices[s * k:(s + 1) * k]) for s in range(n_shards)]


def make_global_mesh(op_parallel: int = 1) -> Mesh:
    """Every card of this process (the port has no multi-host fleet: one
    process drives the cards it sees).  JAX's surface, kept for parity:
    nothing in the port calls it."""
    return make_mesh(op_parallel=op_parallel)
