"""The frozen G2 packet writer: the port's wire format, parsed back equal."""

import numpy as np
import torch

from benchmark.frames import g2_frames
from benchmark.packets import g2_frame_packets, write_g2_frame
from benchmark.systems.g2_stream import port_profile
from benchmark.tests.tiny import tiny_configs


def _frame():
    cfg = tiny_configs()["g2"]
    frames, _, _ = g2_frames(cfg, 3, 100.0, 9, torch.device("cpu"))
    return cfg, frames[1]


def test_bytes_equal_the_ports_writer():
    from radar_signal_process_tpu_torch.sim.packets_synth import g2_prt_packet

    cfg, iq = _frame()
    prof = port_profile(cfg)
    buf = g2_frame_packets(iq, cfg["profile"], 4)
    words = buf[:, 40:48].copy().view("<u4")
    seg = cfg["profile"]["segment_points"]
    assert (words[:, 0] == seg[0] | seg[1] << 16).all() and (words[:, 1] == seg[2]).all()
    # the port's writer states G2's own segment lengths whatever the profile
    buf[:, 40:48] = np.array([[228 | 723 << 16, 2453]], "<u4").view(np.uint8)
    for p in (0, 1, iq.shape[0] - 1):
        want = g2_prt_packet(iq[p], prof, frame_no=4, pulse_no=p, servo_angle=100 + p, data_type=1)
        assert buf[p].tobytes() == want


def test_parsed_back_equal(tmp_path):
    from radar_signal_process_tpu_torch.ingest import G2FrameReader, g2_reader_class

    cfg, iq = _frame()
    d = tmp_path / "frame"
    write_g2_frame(str(d), iq, cfg["profile"], 0)
    prof = port_profile(cfg)
    for cls in {G2FrameReader, g2_reader_class()}:
        res = cls(str(d), prof).read_frame(0)
        assert res.frame_completed
        np.testing.assert_array_equal(res.iq, iq)
