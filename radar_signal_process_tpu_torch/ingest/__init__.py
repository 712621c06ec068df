"""Ingest: cross-file byte-stream splicing, PRT packet parsing, DBF feed.

The port's own copy of the JAX package's ``ingest`` (framework-free numpy
and C++).  Reference layer L0/L1 (SURVEY.md §1): the one component the
reference itself models on C++ (``read_continuous_file_stream.m:2``).  The
native C++ library (``native/ingest.cpp``) is the fast path;
``stream.py``/``packets.py`` are the pure-Python implementations and
fallback.
"""

from radar_signal_process_tpu_torch.ingest.paths import g1_file_name, g2_file_name  # noqa: F401
from radar_signal_process_tpu_torch.ingest.stream import FileStream  # noqa: F401
from radar_signal_process_tpu_torch.ingest.packets import (  # noqa: F401
    G2FrameReader,
    G1FrameReader,
    FrameResult,
)
from radar_signal_process_tpu_torch.ingest.native_loader import (  # noqa: F401
    native_available,
    NativeG1FrameReader,
    NativeG2FrameReader,
)


def g2_reader_class(native: bool = True) -> type:
    """The native C++ reader when ``native`` is set and it builds, else the
    pure-Python one; both yield the same frames."""
    return NativeG2FrameReader if native and native_available() else G2FrameReader


def g1_reader_class(native: bool = True) -> type:
    """The G1 (dual-beam, 24-bit) reader: native C++ when ``native`` is set
    and it builds, else the pure-Python one; both yield the same frames."""
    return NativeG1FrameReader if native and native_available() else G1FrameReader
