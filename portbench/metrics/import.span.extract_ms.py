"""import.span.extract_ms: host ms a merge call in the payload codec, read
from the program's own span ``fleet.text.extract`` (the explode loop of
``Fleet.merge_text_payloads``, fallbacks included)."""

from portbench import spanlog

WRAPS = []


def read(probe):
    return spanlog.ms_per_call(probe, "fleet.text.extract")
