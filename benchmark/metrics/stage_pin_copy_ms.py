"""The median time of the stream producer's copy of a frame into pinned
host memory: the program's ``stream.pin`` spans that start inside the
traced part."""

import statistics

from benchmark.metrics.host_launch_ms import traced


def read(ctx):
    spans = traced(ctx, "pin", "stream.pin")
    if not spans:
        return None
    return 1e3 * statistics.median(s[3] - s[2] for s in spans)
