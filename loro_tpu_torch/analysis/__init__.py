"""The runtime lock-order witness: named locks (``lockwitness``) and the
declared partial order they are checked against (``lockorder``).  Pure
stdlib."""
from . import lockorder, lockwitness
from .lockwitness import LockWitness, named_lock, named_rlock, witness

__all__ = ["LockWitness", "lockorder", "lockwitness", "named_lock", "named_rlock", "witness"]
