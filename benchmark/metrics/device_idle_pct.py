"""The share of the traced window in which nothing ran on the device: 100
less the union of the device's intervals over the window's wall time."""


def read(ctx):
    window = ctx.trace.window_s
    if not window:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in ctx.trace.busy()) / window)
