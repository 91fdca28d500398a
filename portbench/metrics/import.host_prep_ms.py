"""import.host_prep_ms: host ms a merge call in the fleet's preparation
around the device call: stacking and padding the extracts, the upload,
the two fetches and the texts' decode (``parallel/fleet``:
``stack_seq_columns``, ``seq_columns_to_torch``, ``_sup_fetch``,
``texts_of``).  The device call (``materialize_content_batch``) is
wrapped to wait for the card at its end, so the fetches time the copies
alone."""

FLEET = "loro_tpu_torch.parallel.fleet:"
TARGETS = [FLEET + n for n in ("stack_seq_columns", "seq_columns_to_torch", "_sup_fetch", "texts_of")]
WRAPS = [{"target": t} for t in TARGETS] + [{"target": FLEET + "materialize_content_batch", "sync": True}]


def read(probe):
    return probe.ms_per_step(*TARGETS)
