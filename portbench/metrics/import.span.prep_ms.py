"""import.span.prep_ms: host ms a merge call in the fleet's preparation
on either side of the card, read from the program's own spans
``fleet.text.stack`` (stacking and padding the extracts) and
``fleet.text.decode`` (the texts' decode)."""

from portbench import spanlog

WRAPS = []


def read(probe):
    return spanlog.ms_per_call(probe, "fleet.text.stack", "fleet.text.decode")
