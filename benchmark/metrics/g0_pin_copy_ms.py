"""The host's time to copy one G0 frame's beams into pinned host memory:
per frame whose harness ``next`` span lies inside the traced part, the sum
of the program's ``g0.pin`` spans that start in it; the median of those
sums over the frames that staged their beams so."""

import bisect
import statistics

from benchmark.metrics.host_launch_ms import traced


def read(ctx):
    pins = sorted(traced(ctx, "pin", "g0.pin"), key=lambda s: s[2])
    if not pins:
        return None
    starts = [s[2] for s in pins]
    a, b = ctx.trace.t0, ctx.trace.t0 + ctx.trace.window_s
    sums = []
    for _, t0, t1, _ in ctx.spans.between(a, b, "next"):
        frame = pins[bisect.bisect_left(starts, t0):bisect.bisect_right(starts, t1)]
        if frame:
            sums.append(sum(s[3] - s[2] for s in frame))
    return 1e3 * statistics.median(sums) if sums else None
