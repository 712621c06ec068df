"""B3's share of its roofline: the least time its calls need over the
device time of its kernels, in the traced window (``rooflines.py``)."""

from benchmark.rooflines import roofline_pct

PREFIXES = ("pc_kernel", "rdm_kernel", "split_m_kernel")


def read(ctx):
    return roofline_pct(ctx, "b3", PREFIXES)
