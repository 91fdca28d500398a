"""import.device_busy_ms: the card's busy ms a merge call: the union of
kernel and copy intervals in the traced window (``torch.profiler``), over
the window's merge calls.  The device merge is
``ops/fugue_batch.materialize_content`` (``parallel/fleet``'s
``materialize_content_batch``), annotated so that the trace names it."""

DEVICE = True
WRAPS = [{"target": "loro_tpu_torch.parallel.fleet:materialize_content_batch"}]


def read(probe):
    if probe.trace is None or not probe.step_ms:
        return None
    return probe.trace["busy_s"] * 1e3 / len(probe.step_ms)
