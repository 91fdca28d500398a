"""loro_tpu_torch — the PyTorch/CUDA port of the loro_tpu fleet merge.

The JAX package ``loro_tpu`` stays the reference; this package imports
nothing of it (and never imports jax).  It covers the fleet text merge,
element-level and chain-contracted, from payload bytes, and the resident
text batch:

    core              ids, the op/change model, Frontiers
    codec.binary      the payload decoder (decode_changes) and a text encoder
    native            the native payload explode and delta explode
                      (seq_codec.cpp), order engine and id map
                      (order_idmap.cpp)
    ops.columnar      host numpy element tables -> SeqColumns / ChainColumns
    ops.fugue_batch   Euler-tour ring, list-rank dispatch, placement,
                      batch entry points (explicit leading doc axis), the
                      resident path's device ops on SeqColumnsU
    parallel.fleet    Fleet: one-shot batched text merges of docs, change
                      lists or payloads; DeviceDocBatch: the resident
                      text batch (appends, reads, checkpoints)
    parallel.order_maintenance, parallel.idmap
                      the resident batch's host order engine and id maps
    storage           the LTKV key-value store of its checkpoints
    ops.list_rank     hand-written Hopper list-ranking kernels
                      (csrc/list_rank.cu) + their plain torch versions
    entry             entry(): the element merge of an example batch
    tracegen          seeded automerge-perf-shaped traces + host oracle

Public entry points take ``device=`` (default ``"cuda"``) and raise
DeviceUnavailable without a card unless given ``device="cpu"``.
"""
from .device import resolve_device
from .errors import ConfigError, DeviceUnavailable, LoroError

__all__ = ["resolve_device", "ConfigError", "DeviceUnavailable", "LoroError"]
