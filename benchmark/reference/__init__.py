"""The plain reference that decides ``correct``: NumPy and plain PyTorch,
built from the configuration files alone.  It imports nothing of the
program and nothing of JAX."""
