"""rank_roofline: list ranking's share of its roofline.  The least
time for the rings a call ranks is their bytes by the port's kernel-table
rule (12 bytes a ring token, counted from the ring shape [D, m] the call
receives, whatever route ranks it) over the card's 3.35 TB/s; the time is
CUDA events around ``ops/fugue_batch._rank_dist``, wrapped where
``_order_core`` looks it up.  Summed over the window's calls."""

from portbench.timing import PEAKS, RANK_BYTES_PER_TOKEN

DEVICE = True
TARGET = "loro_tpu_torch.ops.fugue_batch:_rank_dist"
WRAPS = [{"target": TARGET, "events": True}]


def read(probe):
    calls = probe.event_ms(TARGET)
    if not calls:
        return None
    least_s = sum(RANK_BYTES_PER_TOKEN * shape[0] * shape[1] for _, shape in calls) / PEAKS["hbm_bytes_per_s"]
    took_s = sum(ms for ms, _ in calls) / 1e3
    return 100.0 * least_s / took_s if took_s > 0 else None
