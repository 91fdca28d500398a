"""device_idle_pct: the share of the traced window with no kernel and no
copy on the card (``torch.profiler``)."""

DEVICE = True
WRAPS = []


def read(probe):
    if probe.trace is None or probe.trace["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - probe.trace["busy_s"] / probe.trace["trace_window_s"])
