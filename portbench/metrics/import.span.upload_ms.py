"""import.span.upload_ms: host ms a merge call staging the upload, read
from the program's own span ``fleet.text.upload`` (the first supervised
launch of the merge: the pageable copies of the stacked columns)."""

from portbench import spanlog

WRAPS = []


def read(probe):
    return spanlog.ms_per_call(probe, "fleet.text.upload")
