"""Device lists for the sharded resident fleet (the doc-axis part of the
JAX package's parallel/mesh.py: make_mesh, shard_meshes and
make_global_mesh).

The distributed axis of a CRDT fleet is document-batch parallelism: docs
are independent, so the fleet carves its doc set across devices.  Where
the JAX package builds a ("docs",) Mesh, the port keeps a plain list of
torch.devices: ``make_mesh()`` is every visible card, and
``shard_meshes(devices, n)`` carves the list into ``n`` contiguous
slices, one a shard.  Each shard's resident batches are bound to the
first device of its slice (a port batch lives on one device).

A list may name one device twice: ``["cpu", "cpu"]`` runs two shards on
the host, and ``[dev, dev]`` two shards on one card, each with its own
tensors and its own ``fleet.dev`` lock.

The op-axis sharding of the JAX module (doc_sharding, replicated,
shard_doc_batch) is not ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device
from ..errors import ConfigError, DeviceUnavailable


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None) -> List[torch.device]:
    """The fleet's device list: ``devices`` resolved (each must be usable:
    DeviceUnavailable for a card that is not there), or every visible
    card when None, DeviceUnavailable without one."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise DeviceUnavailable(
                "no CUDA device visible for the fleet's default device list; "
                "pass devices=['cpu', ...] to run the plain versions"
            )
        return [torch.device("cuda", i) for i in range(n)]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ConfigError("devices", list(devices), "a non-empty device list")
    return out


def shard_meshes(devices: Sequence[torch.device], n_shards: int) -> List[List[torch.device]]:
    """Carve a device list into ``n_shards`` contiguous slices, one a
    shard; raises typed ConfigError when the list does not divide evenly
    (a ragged carve would skew per-shard capacity)."""
    devs = list(devices)
    if not isinstance(n_shards, int) or isinstance(n_shards, bool) or n_shards < 1:
        raise ConfigError("shards", n_shards, "positive integer")
    if len(devs) % n_shards:
        raise ConfigError("shards", n_shards, f"a divisor of the device list's length ({len(devs)} device(s))")
    k = len(devs) // n_shards
    return [devs[s * k:(s + 1) * k] for s in range(n_shards)]


def make_global_mesh() -> List[torch.device]:
    """Every card of this process (the port has no multi-host fleet: one
    process drives the cards it sees)."""
    return make_mesh()
