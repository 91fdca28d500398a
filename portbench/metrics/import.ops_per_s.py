"""import.ops_per_s: the operations the traced window completed (the
benchmark's own count, from its generator) over the window's wall time,
first timed step's start to the last one's end: the whole import
entry's rate on the host's clock."""

WRAPS = []


def read(probe):
    return probe.ops / probe.window_s if probe.window_s > 0 else None
