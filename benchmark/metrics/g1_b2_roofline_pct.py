"""B2's share of its roofline in the G1 stream: the least time of the G1
window's Doppler transform (K = 1536 over 4 slices of 868 columns, two
beams) over the device time of B2's kernels, in the traced window
(``rooflines.py``)."""

from benchmark.metrics.b2_roofline_pct import PREFIXES
from benchmark.rooflines import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b2", PREFIXES)
