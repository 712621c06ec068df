"""G2 and G1 ``.bin`` ingest, shared with the JAX package.

``radar_signal_process_tpu.ingest`` (cross-file splicing, PRT packet parsing
and its native C++ reader) imports neither jax nor torch, so the port
re-exports its readers rather than copying them, as ``config`` does for the
profiles.
"""

from radar_signal_process_tpu.ingest import (  # noqa: F401
    FrameResult,
    G1FrameReader,
    G2FrameReader,
    NativeG2FrameReader,
    native_available,
)
from radar_signal_process_tpu.ingest.native_loader import NativeG1FrameReader  # noqa: F401


def g2_reader_class(native: bool = True) -> type:
    """The native C++ reader when ``native`` is set and it builds, else the
    pure-Python one; both yield the same frames."""
    return NativeG2FrameReader if native and native_available() else G2FrameReader


def g1_reader_class(native: bool = True) -> type:
    """The G1 (dual-beam, 24-bit) reader: native C++ when ``native`` is set
    and it builds, else the pure-Python one; both yield the same frames."""
    return NativeG1FrameReader if native and native_available() else G1FrameReader
