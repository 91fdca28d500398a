"""import.span.wait_ms: host ms a merge call launching the device merge
and waiting for it, read from the program's own spans
``fleet.text.launch`` and ``fleet.text.fetch``: the host waiting for the
card, the copies back included, wherever the sync falls (a reader that
makes the launch wait moves time from the fetch to the launch, and the
sum stays)."""

from portbench import spanlog

WRAPS = []


def read(probe):
    return spanlog.ms_per_call(probe, "fleet.text.launch", "fleet.text.fetch")
