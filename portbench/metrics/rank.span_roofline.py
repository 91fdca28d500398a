"""rank.span_roofline: list ranking's share of its roofline, read from
the program's own device spans ``fugue.rank`` (a CUDA event pair around
``ops/fugue_batch._rank_dist`` in ``_order_core``).  The least time is
the rings' bytes by the port's kernel-table rule, 12 bytes a ring token,
over the card's 3.35 TB/s; the ring tokens (D x m of every ranking) are
the program's ``rank.ring_tokens`` counter's rise over the window's
calls.  Summed over the window's calls."""

from portbench import spanlog
from portbench.timing import PEAKS, RANK_BYTES_PER_TOKEN

DEVICE = True
WRAPS = []


def read(probe):
    took = spanlog.seconds(probe, "fugue.rank")
    tokens = spanlog.window_ring_tokens(probe)
    if took is None or not tokens or sum(took) <= 0:
        return None
    return 100.0 * RANK_BYTES_PER_TOKEN * tokens / PEAKS["hbm_bytes_per_s"] / sum(took)
