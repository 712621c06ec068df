"""The host's time to enqueue one step's work: the program's ``launch``
spans (``utils.profiling.span``) that start inside the traced part, summed
and divided by the steps whose results reached the host in it."""


def traced(ctx, kind=None, name=None) -> list:
    """The program's spans ``(name, kind, t0, t1, thread, nbytes)`` that
    start inside the traced part, of ``kind`` and ``name`` where given;
    none where the program keeps no spans."""
    from radar_signal_process_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None or not ctx.trace.window_s:
        return []
    a, b = ctx.trace.t0, ctx.trace.t0 + ctx.trace.window_s
    return [s for s in read() if a <= s[2] <= b and kind in (None, s[1]) and name in (None, s[0])]


def read(ctx):
    spans = traced(ctx, "launch")
    if not spans or not ctx.trace.steps:
        return None
    return 1e3 * sum(s[3] - s[2] for s in spans) / ctx.trace.steps
