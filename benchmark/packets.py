"""The G2 packet writer, vectorised: a frame's PRT packets in one buffer.

A frozen copy of the wire format of the port's ``sim/packets_synth.py``
(``g2_prt_packet``, DDC data type 1) and of the reference's
``FrameDataRead_xzr.m``: per PRT a 64-byte head (frame number, pulse number
and frequency number, channel count, servo angle, samples, data type, PRTs
a frame and radar type, segment lengths), the 128-byte real-time block,
the samples as interleaved little-endian int16 I/Q per (sample, channel)
padded to 64 bytes, and a 64-byte tail.
"""

from __future__ import annotations

import os

import numpy as np

FREQ_NO, RADAR_TYPE, DATA_TYPE = 3, 2, 1


def packet_bytes(profile: dict) -> int:
    payload = profile["point_prt"] * profile["n_channels"] * 4
    payload += -payload % 64
    return profile["bytes_head"] + profile["bytes_realtime"] + payload + profile["bytes_tail"]


def g2_frame_packets(iq: np.ndarray, profile: dict, frame_no: int) -> np.ndarray:
    """(n_prt, n_samples, n_channels) int16-valued complex -> uint8 buffer of
    the frame's n_prt packets."""
    n_prt, n, ch = iq.shape
    head_b, rt_b = profile["bytes_head"], profile["bytes_realtime"]
    size = packet_bytes(profile)
    buf = np.zeros((n_prt, size), np.uint8)
    head = np.zeros((n_prt, 16), "<u4")
    pulse = np.arange(n_prt, dtype=np.uint32)
    seg = profile["segment_points"]
    head[:, 0] = frame_no
    head[:, 2] = (pulse & 0xFFFF) | (FREQ_NO << 16)
    head[:, 3] = ch & 0xFF
    head[:, 4] = (100 + pulse) & 0xFFFF
    head[:, 6] = n
    head[:, 7] = DATA_TYPE | ((profile["prt_per_frame"] & 0xFFFF) << 8) | (RADAR_TYPE << 24)
    head[:, 10] = seg[0] | (seg[1] << 16)
    head[:, 11] = seg[2]
    buf[:, :64] = head.view(np.uint8)
    inter = np.empty((n_prt, n, ch, 2), "<i2")
    inter[..., 0] = iq.real
    inter[..., 1] = iq.imag
    start = head_b + rt_b
    buf[:, start:start + n * ch * 4] = inter.reshape(n_prt, -1).view(np.uint8)
    return buf


def write_g2_frame(root: str, iq: np.ndarray, profile: dict, frame_no: int) -> str:
    """Write one frame as ``root/1.000001.bin``, the first file of a G2
    capture; returns the file's path."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "1.000001.bin")
    with open(path, "wb") as fh:
        fh.write(g2_frame_packets(iq, profile, frame_no).tobytes())
    return path
