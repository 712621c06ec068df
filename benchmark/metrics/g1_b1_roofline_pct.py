"""B1's share of its roofline in the G1 stream: the least time of the
cascade over the G1 window's 8 RDMs of 1536 x 868 (three segments, the /20
re-notch fused) over the device time of B1's kernels, in the traced window
(``rooflines.py``)."""

from benchmark.metrics.b1_roofline_pct import PREFIXES
from benchmark.rooflines import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b1", PREFIXES)
