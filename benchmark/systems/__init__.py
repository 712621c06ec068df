"""One module a system (``config["system"]``): set-up, the closed loop, the
check against the reference."""
