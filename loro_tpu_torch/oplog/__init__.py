"""The port's op history (loro_tpu/oplog): for now only the known-prefix
trim that the read plane (ops/export_batch.py) shares with import and
ranged export."""
