"""B2's share of its roofline: the least time its calls need over the
device time of its kernels, in the traced window (``rooflines.py``)."""

from benchmark.rooflines import roofline_pct

PREFIXES = ("doppler_rdm_kernel", "split_w_kernel")


def read(ctx):
    return roofline_pct(ctx, "b2", PREFIXES)
