"""Synthetic binary capture generation: byte-level fixtures for ingest tests.

The port's own copy of the JAX package's ``sim/packets_synth.py``.  Writes
G2/G1 packet streams with the exact wire formats parsed by
``ingest.packets`` (and by the reference's ``FrameDataRead_xzr.m`` /
``frameDataRead_A_xzr.m``), split across numbered ``.bin`` files at arbitrary
byte boundaries so the cross-file splicing paths are exercised.
"""

from __future__ import annotations

import os
import struct
from typing import Sequence

import numpy as np

from radar_signal_process_tpu_torch.config import G2_PROFILE, RadarProfile
from radar_signal_process_tpu_torch.ingest.paths import g1_file_name, g2_file_name


def g2_prt_packet(
    iq: np.ndarray,
    profile: RadarProfile = G2_PROFILE,
    frame_no: int = 0,
    pulse_no: int = 0,
    freq_no: int = 3,
    servo_angle: int = 123,
    data_type: int = 1,
    radar_type: int = 2,
    timer: int = 0,
) -> bytes:
    """One G2 PRT packet: 64 B head + 128 B realtime + payload + 64 B tail.

    ``iq``: (point_prt, n_channels) complex (DDC) or real int (ADC).
    """
    n, ch = iq.shape
    head = np.zeros(16, dtype="<u4")
    head[0] = frame_no
    head[2] = (pulse_no & 0xFFFF) | (freq_no << 16)
    head[3] = ch & 0xFF
    head[4] = servo_angle & 0xFFFF
    head[6] = n
    head[7] = (data_type & 0xFF) | ((profile.prt_per_frame & 0xFFFF) << 8) | (
        (radar_type & 0xFF) << 24
    )
    head[8] = timer & 0xFFFFFFFF
    head[9] = (timer >> 32) & 0xFFFFFFFF
    head[10] = 228 | (723 << 16)
    head[11] = 2453

    if data_type == 0:
        payload = np.real(iq).astype("<i2").tobytes()
    elif data_type == 1:
        inter = np.empty((n, ch * 2), dtype="<i2")
        inter[:, 0::2] = np.real(iq).astype("<i2")
        inter[:, 1::2] = np.imag(iq).astype("<i2")
        payload = inter.tobytes()
    else:  # DBF 24-bit packed
        pad1 = 8 - (6 * ch) % 8
        vals = np.empty((n, ch * 2), dtype=np.int64)
        vals[:, 0::2] = np.real(iq).astype(np.int64)
        vals[:, 1::2] = np.imag(iq).astype(np.int64)
        vals = np.where(vals < 0, vals + 2**24, vals)
        rows = np.zeros((n, ch * 2 * 3 + pad1), dtype=np.uint8)
        rows[:, 0 : ch * 2 * 3 : 3] = vals & 0xFF
        rows[:, 1 : ch * 2 * 3 : 3] = (vals >> 8) & 0xFF
        rows[:, 2 : ch * 2 * 3 : 3] = (vals >> 16) & 0xFF
        payload = rows.tobytes()

    if len(payload) % 64:
        payload += b"\x00" * (64 - len(payload) % 64)
    return (
        head.tobytes()
        + b"\x00" * profile.bytes_realtime
        + payload
        + b"\x00" * profile.bytes_tail
    )


def write_g2_capture(
    root: str,
    frames_iq: np.ndarray,
    profile: RadarProfile = G2_PROFILE,
    data_type: int = 1,
    file_sizes: Sequence[int] | None = None,
    servo_angles: np.ndarray | None = None,
) -> None:
    """Write a G2 capture: ``frames_iq`` (n_frames, n_prt, points, channels).

    ``file_sizes`` gives the byte length of each numbered file (the last file
    takes the remainder) — place boundaries anywhere to fuzz the splicer.
    """
    blob = bytearray()
    n_frames, n_prt = frames_iq.shape[:2]
    for f in range(n_frames):
        for p in range(n_prt):
            angle = int(servo_angles[f, p]) if servo_angles is not None else 100 + p
            blob += g2_prt_packet(
                frames_iq[f, p],
                profile,
                frame_no=f,
                pulse_no=p,
                servo_angle=angle,
                data_type=data_type,
            )
    _write_split(root, bytes(blob), file_sizes, g2_file_name)


def g1_prt_packet(
    left: np.ndarray,
    right: np.ndarray,
    frame_no: int = 0,
    mod_flag: int = 1,
    beam_pos: int = 0,
    beam_nums: int = 2,
    freq_index: int = 1,
    prt_no: int = 0,
    angle_deg: float = 0.0,
) -> bytes:
    """One G1 PRT packet: 28 B head + 12 B/sample payload + 8 B tail."""
    pts = left.shape[0]
    code = int(round(angle_deg * 16384.0 / 360.0))
    a1, a2 = code & 0x7F, (code >> 7) & 0xFF
    head = struct.pack(
        "<HHHHHBBHH",
        0xA5A5, 0xA5A5,
        (frame_no >> 16) & 0xFFFF, frame_no & 0xFFFF,
        mod_flag, beam_pos, beam_nums, freq_index, prt_no,
    )
    head += b"\x00" * 10 + bytes([a1, a2])
    assert len(head) == 28

    def enc24(x):
        v = np.asarray(np.where(x < 0, x + 2**24, x), dtype=np.int64)
        return v

    il, ql = enc24(np.real(left)), enc24(np.imag(left))
    ir, qr = enc24(np.real(right)), enc24(np.imag(right))
    rows = np.zeros((pts, 12), dtype=np.uint8)
    # byte positions (0-based) per frameDataRead_A_xzr.m:86-104
    rows[:, 1], rows[:, 5], rows[:, 9] = (il >> 16) & 0xFF, (il >> 8) & 0xFF, il & 0xFF
    rows[:, 0], rows[:, 4], rows[:, 8] = (ql >> 16) & 0xFF, (ql >> 8) & 0xFF, ql & 0xFF
    rows[:, 3], rows[:, 7], rows[:, 11] = (ir >> 16) & 0xFF, (ir >> 8) & 0xFF, ir & 0xFF
    rows[:, 2], rows[:, 6], rows[:, 10] = (qr >> 16) & 0xFF, (qr >> 8) & 0xFF, qr & 0xFF
    return head + rows.tobytes() + b"\x00" * 8


def write_g1_capture(
    root: str,
    left: np.ndarray,
    right: np.ndarray,
    frames_per_file: int = 10,
    angle_deg: float = 45.0,
    freq_index=1,
    beam_pos=0,
) -> None:
    """Write a G1 capture: ``left``/``right`` (n_frames, n_prt, points).

    ``freq_index``/``beam_pos`` may be scalars or per-frame sequences — a
    sequence produces a frequency-hopping / beam-scanning capture (the real
    radar hops over the 11-point frequency table; ``freValueGen.m:3-29``).
    """
    os.makedirs(root, exist_ok=True)
    n_frames, n_prt = left.shape[:2]
    fi = np.broadcast_to(np.asarray(freq_index, dtype=np.int64), (n_frames,))
    bp = np.broadcast_to(np.asarray(beam_pos, dtype=np.int64), (n_frames,))
    file_idx, fh = 1, None
    for f in range(n_frames):
        if f % frames_per_file == 0:
            if fh:
                fh.close()
            fh = open(os.path.join(root, g1_file_name(file_idx)), "wb")
            file_idx += 1
        for p in range(n_prt):
            fh.write(
                g1_prt_packet(
                    left[f, p], right[f, p],
                    frame_no=f, prt_no=p, angle_deg=angle_deg,
                    freq_index=int(fi[f]), beam_pos=int(bp[f]),
                )
            )
    if fh:
        fh.close()


def _write_split(root, blob, file_sizes, name_fn):
    os.makedirs(root, exist_ok=True)
    if file_sizes is None:
        file_sizes = [len(blob)]
    pos, idx = 0, 1
    for size in file_sizes:
        if pos >= len(blob):
            break
        with open(os.path.join(root, name_fn(idx)), "wb") as fh:
            fh.write(blob[pos : pos + size])
        pos += size
        idx += 1
    if pos < len(blob):
        with open(os.path.join(root, name_fn(idx)), "wb") as fh:
            fh.write(blob[pos:])
