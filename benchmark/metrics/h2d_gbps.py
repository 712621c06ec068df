"""The rate of the copies onto the device: the bytes of the program's
``copy`` spans that start inside the traced part, over the device time of
the trace's host-to-device copies (``Memcpy HtoD``), in GB/s."""

from benchmark.metrics.host_launch_ms import traced


def read(ctx):
    spans = traced(ctx, "copy")
    seconds = sum(b - a for name, a, b in ctx.trace.kernels
                  if name.replace(" ", "_") == "Memcpy_HtoD")
    if not spans or seconds <= 0:
        return None
    return sum(s[5] for s in spans) / seconds / 1e9
