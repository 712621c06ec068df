"""The median time of the harness's spans around ``read_frame`` in the
window: the reader's parse of a frame from its file."""

import statistics


def read(ctx):
    spans = ctx.spans.between(ctx.t0, ctx.t_end, "read_frame")
    if not spans:
        return None
    return statistics.median(s[2] - s[1] for s in spans) * 1e3
