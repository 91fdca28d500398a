"""kernel_ms_per_Mop: the card's kernel milliseconds a million
operations merged: the union of every kernel interval on the card in the
window (``torch.profiler``, device activity only, so nothing on the host
is wrapped or annotated; copies are left out, since a pageable copy's
span on the card follows the host's staging), over the operations the
window completed (the benchmark's own count)."""

DEVICE = True
PROFILE = True  # asks the untraced run for the card's profile
WRAPS = []


def read(probe):
    if probe.trace is None or "kernel_busy_s" not in probe.trace or probe.ops <= 0:
        return None
    return probe.trace["kernel_busy_s"] * 1e3 / (probe.ops / 1e6)
