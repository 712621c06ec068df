"""One reader a per-layer metric, ``metrics/<name>.py`` with ``read(ctx)``;
a reader that finds nothing to read returns None."""
