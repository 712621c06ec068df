"""The host's time to enqueue one G1 window's work: ``host_launch_ms``'s
reading (the program's ``launch`` spans that start inside the traced part,
``mtd.concat``, the range re-concatenation, among them, summed and divided
by the steps whose results reached the host in it), in the G1 cell."""

from benchmark.metrics.host_launch_ms import read  # noqa: F401
