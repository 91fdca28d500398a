"""import.span.merge_device_ms: the card's ms a merge call from the first
to the last of the device merge's work, read from the program's own
device span ``fleet.text.merge_device`` (a CUDA event pair around the
merge's launches, on the card's clock)."""

from portbench import spanlog

DEVICE = True
WRAPS = []


def read(probe):
    return spanlog.ms_per_call(probe, "fleet.text.merge_device")
