"""setup_s: process start to the first timed step: imports, CUDA start,
the data, the program's build and cache checks, the warm calls."""

WRAPS = []


def read(probe):
    return probe.setup_s
