"""loro_tpu_torch — the PyTorch/CUDA port of the loro_tpu fleet merge.

The JAX package ``loro_tpu`` stays the reference; this package imports
nothing of it (and never imports jax).  It covers the fleet text merge,
element-level and chain-contracted, from payload bytes, the LWW-map,
counter and movable-tree merges, and their resident batches:

    core              ids, the op/change model, Frontiers
    codec.binary      the payload decoder (decode_changes) and encoder
    native            the native payload explodes (seq_codec.cpp: seq,
                      delta, map and tree), order engine and id map
                      (order_idmap.cpp)
    ops.columnar      host numpy element tables -> SeqColumns / ChainColumns
    ops.fugue_batch   Euler-tour ring, list-rank dispatch, placement,
                      batch entry points (explicit leading doc axis), the
                      resident path's device ops on SeqColumnsU
    parallel.fleet    Fleet: one-shot batched text, map, counter and
                      tree merges of docs, change lists or payloads; the
                      resident batches DeviceDocBatch (text),
                      DeviceMapBatch, DeviceCounterBatch and
                      DeviceTreeBatch (appends, reads, checkpoints)
    parallel.order_maintenance, parallel.idmap
                      the resident batch's host order engine and id maps
    storage           the LTKV key-value store of its checkpoints
    ops.list_rank     hand-written Hopper list-ranking kernels
                      (csrc/list_rank.cu) + their plain torch versions
    ops.lww           the LWW-map and counter merges (torch scatters)
    ops.tree_batch    the movable-tree merge: the hand-written replay
                      kernel (csrc/tree_replay.cu) + its plain version
    entry             entry(): the element merge of an example batch
    tracegen          seeded traces (automerge-perf-shaped text, map,
                      counter and tree histories) + host oracles

Public entry points take ``device=`` (default ``"cuda"``) and raise
DeviceUnavailable without a card unless given ``device="cpu"``.
"""
from .device import resolve_device
from .errors import ConfigError, DeviceUnavailable, LoroError

__all__ = ["resolve_device", "ConfigError", "DeviceUnavailable", "LoroError"]
