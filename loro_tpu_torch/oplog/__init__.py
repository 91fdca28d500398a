"""The port's op history (loro_tpu/oplog): the OpLog with its DAG
(dag.py), pending queue and known-prefix trim (oplog.py), and the
block-chunked cold change store (change_store.py)."""
