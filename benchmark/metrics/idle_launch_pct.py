"""The share of the traced part in which the device sat idle while the
host was inside one of the program's ``launch`` spans: each idle gap of the
device (the gaps ``Trace.breakdown`` walks) counts whole where its middle,
on the host's clock, falls inside such a span."""

import bisect

from benchmark.metrics.host_launch_ms import traced


def read(ctx):
    merged: list = []
    for a, b in sorted((s[2], s[3]) for s in traced(ctx, "launch")):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if not merged:
        return None
    starts = [a for a, _ in merged]
    window = ctx.trace.window_s
    idle, edge = 0.0, 0.0
    for a, b in ctx.trace.busy() + [[window, window]]:
        if a > edge:
            mid = ctx.trace.t0 + (edge + a) / 2
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid <= merged[i][1]:
                idle += a - edge
        edge = max(edge, b)
    return 100.0 * idle / window
