"""PRT packet parsers (reference I4/I5), NumPy reference implementation.

Byte-level formats replicated:

* **G2** (``FrameDataRead_xzr.m``): per PRT a 64 B header parsed as
  ``uint32[16]`` (frame no, PRT no, freq no, channel count, servo azimuth in
  0.1 deg, samples/PRT, data type, PRTs/frame, radar model, 64-bit timestamp,
  short/mid/long sample counts, :70-87), a 128 B realtime block, the payload
  (int16 for ADC/DDC; 24-bit little-endian two's-complement for DBF with
  per-sample and 64 B-block FPGA padding, :105-139) and a 64 B tail.
* **G1** (``frameDataRead_A_xzr.m``): 28 B header (A5A5 sync x2, frame no,
  mode, beam position/count, freq index, PRT no, 10 skip bytes, 2-byte angle
  code scaled by 360/16384, :56-78), then 12 B per sample of 24-bit packed
  dual-beam I/Q (:83-133), 8 B tail.

Error paths (EOS at any read boundary, invalid header, mid-frame resume via
the PRT cursor) mirror the reference's and are exercised by the truncation /
boundary-fuzz tests.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np

from radar_signal_process_tpu_torch.config import G2_PROFILE, RadarProfile
from radar_signal_process_tpu_torch.ingest.paths import g1_file_path, g2_file_path
from radar_signal_process_tpu_torch.ingest.stream import FileStream


class FrameResult(NamedTuple):
    iq: np.ndarray             # (n_prt, samples, channels) complex64
    servo_angle: np.ndarray    # (n_prt,) float64 — 0.1 deg units (raw codes)
    frame_completed: bool
    eos: bool
    meta: dict


@dataclasses.dataclass
class G2Header:
    frame_no: int
    pulse_no: int
    freq_no: int
    channel_num: int
    servo_angle: int
    pulse_data_num: int
    data_type: int
    pulse_num: int
    radar_type: int
    timer: int
    s_dots: int
    m_dots: int
    l_dots: int

    @property
    def ddc_decimation(self) -> int:
        """DDC decimation factor by radar model (``FrameDataRead_xzr.m:191-196``):
        2 for KuP4K (model 4), 4 for the X3D/C3D models."""
        return 2 if self.radar_type == 4 else 4

    @classmethod
    def parse(cls, raw: bytes) -> "G2Header":
        h = np.frombuffer(raw, dtype="<u4")
        return cls(
            frame_no=int(h[0]),
            pulse_no=int(h[2] & 0xFFFF),
            freq_no=int(h[2] >> 16),
            channel_num=int(h[3] & 0xFF),
            servo_angle=int(h[4] & 0xFFFF),
            pulse_data_num=int(h[6]),
            data_type=int(h[7] & 0xFF),
            pulse_num=int((h[7] >> 8) & 0xFFFF),
            radar_type=int((h[7] >> 24) & 0xFF),
            timer=int(h[8]) + (int(h[9]) << 32),
            s_dots=int(h[10] & 0xFFFF),
            m_dots=int(h[10] >> 16),
            l_dots=int(h[11] & 0xFFFF),
        )

    def payload_size(self) -> int:
        """Signal bytes incl. FPGA padding (``FrameDataRead_xzr.m:105-119``)."""
        n, ch = self.pulse_data_num, self.channel_num
        if self.data_type == 0:      # ADC: int16 real
            size = n * ch * 2
        elif self.data_type == 1:    # DDC: int16 I/Q
            size = n * ch * 2 * 2
        else:                        # DBF: 24-bit I/Q + per-sample pad
            pad1 = 8 - (6 * ch) % 8
            size = n * ch * 2 * 3 + n * pad1
        if size % 64:
            size += 64 - size % 64
        return size


def _sign24(x: np.ndarray) -> np.ndarray:
    """24-bit two's-complement sign fix (``FrameDataRead_xzr.m:135-136``)."""
    x = x.astype(np.int64)
    return np.where(x > 2**23, x - 2**24, x)


def parse_g2_payload(raw: bytes, head: G2Header) -> np.ndarray:
    """Payload bytes -> (samples, channels) complex64 (ADC: real int16)."""
    n, ch = head.pulse_data_num, head.channel_num
    if head.data_type == 0:
        data = np.frombuffer(raw, dtype="<i2", count=n * ch)
        return data.reshape(n, ch).astype(np.complex64)
    if head.data_type == 1:
        data = np.frombuffer(raw, dtype="<i2", count=n * ch * 2).astype(np.float32)
        data = data.reshape(n, ch * 2)
        return (data[:, 0::2] + 1j * data[:, 1::2]).astype(np.complex64)
    # DBF 24-bit
    pad1 = 8 - (6 * ch) % 8
    row = ch * 2 * 3 + pad1
    buf = np.frombuffer(raw, dtype=np.uint8, count=n * row).reshape(n, row)
    trip = buf[:, : ch * 2 * 3].reshape(n, ch * 2, 3).astype(np.int64)
    vals = _sign24(trip[:, :, 0] + (trip[:, :, 1] << 8) + (trip[:, :, 2] << 16))
    return (vals[:, 0::2] + 1j * vals[:, 1::2]).astype(np.complex64)


class G2FrameReader:
    """Streaming G2 frame reader with mid-frame resume (reference I4 + I1).

    Holds the cross-file stream and a PRT cursor; on EOS mid-frame the caller
    may retry the same logical frame and parsing resumes at the cursor
    (``FrameDataRead_xzr.m:49-52``).
    """

    def __init__(self, root: str, profile: RadarProfile = G2_PROFILE):
        self.profile = profile
        self.stream = FileStream(root, g2_file_path)
        self._current_prt = 0
        self._last_frame_idx: Optional[int] = None
        self._buffers: Optional[np.ndarray] = None
        self._angles: Optional[np.ndarray] = None

    def read_frame(self, frame_idx: int) -> FrameResult:
        prof = self.profile
        n_prt = prof.prt_per_frame
        if self._last_frame_idx != frame_idx or self._buffers is None:
            self._current_prt = 0
            self._last_frame_idx = frame_idx
            self._buffers = np.zeros(
                (n_prt, prof.point_prt, prof.n_channels), dtype=np.complex64
            )
            self._angles = np.zeros(n_prt, dtype=np.float64)
        meta: dict = {}

        def partial(eos: bool) -> FrameResult:
            return FrameResult(self._buffers, self._angles, False, eos, meta)

        while self._current_prt < n_prt:
            head_raw, eos = self.stream.read(prof.bytes_head)
            if eos or len(head_raw) < prof.bytes_head:
                return partial(True)
            head = G2Header.parse(head_raw)
            if head.pulse_data_num <= 0:
                # corrupted header (``FrameDataRead_xzr.m:89-94``)
                return partial(True)
            meta = dataclasses.asdict(head)
            meta["ddc_decimation"] = head.ddc_decimation

            _, eos = self.stream.read(prof.bytes_realtime)
            if eos:
                return partial(True)

            payload_size = head.payload_size()
            payload, eos = self.stream.read(payload_size)
            if eos or len(payload) < payload_size:
                return partial(True)
            sig = parse_g2_payload(payload, head)
            if sig.shape != (prof.point_prt, prof.n_channels):
                # dimension mismatch (``FrameDataRead_xzr.m:171-176``)
                return partial(True)

            self._buffers[self._current_prt] = sig
            self._angles[self._current_prt] = head.servo_angle
            self._current_prt += 1

            _, eos = self.stream.read(prof.bytes_tail)
            if eos:
                return partial(True)

        out = FrameResult(self._buffers, self._angles, True, False, meta)
        self._buffers = None  # force fresh buffers for the next frame
        return out


# ------------------------------------------------------------------------- G1
G1_BYTES_HEAD = 28            # 24 B declared header + 4 B angle-code region
G1_BYTES_TAIL = 8
G1_BYTES_PER_SAMPLE = 12


class G1FrameReader:
    """G1 24-bit packed dual-beam reader (reference I5).

    Computes the file index from the frame index (10 frames/file,
    ``frameDataRead_A_xzr.m:34-41``) and seeks to the frame offset.  Note:
    the reference *computes* the skip but leaves the ``fseek`` commented out
    (:49), so it always re-reads the first frame of each file; the seek here
    is the evidently-intended behavior.
    """

    def __init__(
        self,
        root: str,
        prt_num: int = 1536,
        point_prt: int = 1031,
        frames_per_file: int = 10,
    ):
        self.root = root
        self.prt_num = prt_num
        self.point_prt = point_prt
        self.frames_per_file = frames_per_file
        self.bytes_per_prt = (
            G1_BYTES_HEAD + G1_BYTES_PER_SAMPLE * point_prt + G1_BYTES_TAIL
        )

    def read_frame(self, frame_idx: int):
        """1-based ``frame_idx`` -> (left, right, angle_codes, meta)."""
        file_ind = (frame_idx - 1) // self.frames_per_file + 1
        frame_skip = (frame_idx - 1) % self.frames_per_file
        path = g1_file_path(self.root, file_ind)
        n, pts = self.prt_num, self.point_prt
        left = np.zeros((n, pts), dtype=np.complex128)
        right = np.zeros((n, pts), dtype=np.complex128)
        angles = np.zeros(n, dtype=np.float64)
        meta: dict = {}
        with open(path, "rb") as fh:
            fh.seek(self.bytes_per_prt * n * frame_skip, os.SEEK_SET)
            for i in range(n):
                head = fh.read(G1_BYTES_HEAD)
                if len(head) < G1_BYTES_HEAD:
                    raise EOFError(f"truncated G1 header at PRT {i}")
                h16 = np.frombuffer(head[:16], dtype="<u2")
                if h16[0] != 0xA5A5 or h16[1] != 0xA5A5:
                    raise ValueError(f"G1 sync A5A5 not found at PRT {i}")
                meta = dict(
                    frame_no=int(h16[2]) * 2**16 + int(h16[3]),
                    mod_flag=int(h16[4]),
                    beam_pos=head[10],
                    beam_nums=head[11],
                    freq_index=int(h16[6]),
                    prt_no=int(h16[7]),
                )
                # bytes 16..25 skipped; 26-27 are the angle code
                a1, a2 = head[26], head[27]
                angles[i] = (a1 + a2 * 2**7) * 360.0 / 16384.0

                payload = fh.read(G1_BYTES_PER_SAMPLE * pts)
                if len(payload) < G1_BYTES_PER_SAMPLE * pts:
                    raise EOFError(f"truncated G1 payload at PRT {i}")
                b = np.frombuffer(payload, dtype=np.uint8).reshape(pts, 12)
                b = b.astype(np.int64)
                # 1-based byte positions within each 12-byte group
                # (frameDataRead_A_xzr.m:86-104): value = b[pos1]*2^16 +
                # b[pos2]*2^8 + b[pos3] with (I_left: 2,6,10) (Q_left: 1,5,9)
                # (I_right: 4,8,12) (Q_right: 3,7,11).
                i_l = _sign24((b[:, 1] << 16) + (b[:, 5] << 8) + b[:, 9])
                q_l = _sign24((b[:, 0] << 16) + (b[:, 4] << 8) + b[:, 8])
                i_r = _sign24((b[:, 3] << 16) + (b[:, 7] << 8) + b[:, 11])
                q_r = _sign24((b[:, 2] << 16) + (b[:, 6] << 8) + b[:, 10])
                left[i] = i_l + 1j * q_l
                right[i] = i_r + 1j * q_r
                fh.seek(G1_BYTES_TAIL, os.SEEK_CUR)
        return left, right, angles, meta
