"""G2 ``.bin`` ingest, shared with the JAX package.

``radar_signal_process_tpu.ingest`` (cross-file splicing, PRT packet parsing
and its native C++ reader) imports neither jax nor torch, so the port
re-exports its readers rather than copying them, as ``config`` does for the
profiles.
"""

from radar_signal_process_tpu.ingest import (  # noqa: F401
    FrameResult,
    G2FrameReader,
    NativeG2FrameReader,
    native_available,
)


def g2_reader_class(native: bool = True) -> type:
    """The native C++ reader when ``native`` is set and it builds, else the
    pure-Python one; both yield the same frames."""
    return NativeG2FrameReader if native and native_available() else G2FrameReader
