"""The share of the traced part of the window that ``StreamingPipeline``'s
producer spent waiting: the change of its ``producer_wait_s`` counter between
the two ends of the traced part, over its length.  The counters are read
before the profiler stops, so its stop and parse, which stall the loop,
count in neither."""


def read(ctx):
    before, after = ctx.trace.counters
    if not ctx.trace.window_s or "producer_wait_s" not in after:
        return None
    waited = after["producer_wait_s"] - before.get("producer_wait_s", 0.0)
    return 100.0 * waited / ctx.trace.window_s
