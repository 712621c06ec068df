"""Kernel families' rooflines from a trace: the least time the function
needs for the steps traced (the system module's ``step_bound_s``, from
``cost/work.py``), over the device time of the family's kernels, which each
metric's reader names by prefix."""

from __future__ import annotations


def device_seconds(trace, prefixes: tuple) -> float:
    return sum(b - a for name, a, b in trace.kernels if name.startswith(prefixes))


def roofline_pct(ctx, family: str, prefixes: tuple) -> float | None:
    bound = ctx.system.step_bound_s(ctx.config, family)
    if bound is None or not ctx.trace.window_s or ctx.trace.steps == 0:
        return None
    busy = device_seconds(ctx.trace, prefixes)
    if busy <= 0:
        return None
    return 100.0 * ctx.trace.steps * bound / busy
