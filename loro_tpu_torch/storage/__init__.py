"""The ordered key-value store and its LTKV SSTable format (the port's
copy of loro_tpu/storage)."""
from .kv import CompressionType, MemKvStore

__all__ = ["MemKvStore", "CompressionType"]
