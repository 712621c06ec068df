"""Command-line entry point of the port: the ``stream`` and ``dmx`` subcommands.

``python -m radar_signal_process_tpu_torch.cli stream --input DIR ...`` runs
:class:`models.streaming.StreamingPipeline` over a G2 capture on
``--device`` (default ``cuda``) and prints the same JSON line as
``radar_signal_process_tpu.cli stream``: one entry per window with its
latency, CFAR hits and detections per beam, then the pipeline counters.

``python -m radar_signal_process_tpu_torch.cli dmx --input DIR ...`` runs
:class:`models.g0_chain.G0Chain` over a G1-format dual-beam capture and
prints the same per-frame JSON as ``radar_signal_process_tpu.cli dmx``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import PROFILES

log = logging.getLogger("radar_signal_process_tpu_torch.cli")


def cmd_stream(args, on_result: Optional[Callable] = None) -> int:
    """Streaming chain: overlapped host ingest + device compute, all-beam
    detection.  ``on_result`` (if given) sees every ``StreamResult``."""
    from radar_signal_process_tpu_torch.ingest import g2_reader_class
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
    from radar_signal_process_tpu_torch.ops.dbf import load_dbf_coeffs

    profile = PROFILES[args.profile]
    if profile.bytes_head != 64:
        raise SystemExit(
            f"stream supports G2-format captures only (profile {profile.name})"
        )
    reader_cls = g2_reader_class(args.native)
    coeffs = None
    if args.dbf_coeffs:
        coeffs = load_dbf_coeffs(args.dbf_coeffs, profile.n_channels)
    pipe = StreamingPipeline(
        reader_cls(args.input, profile),
        profile,
        win_size=args.win_size,
        max_frames=args.frames,
        clutter_v=args.clutter_v,
        max_detections=args.max_detections,
        dbf_coeffs=coeffs,
        emit=args.emit,
        device=args.device,
    )
    frames_out = []
    t_prev = time.perf_counter()
    for res in pipe:
        now = time.perf_counter()
        frames_out.append({
            "frame": res.frame_idx,
            "window_latency_ms": round((now - t_prev) * 1e3, 1),
            "cfar_hits": res.cfar_hits,
            "detections_per_beam": res.detections.valid.any(dim=-1).sum(dim=-1).tolist(),
        })
        if on_result is not None:
            on_result(res)
        t_prev = time.perf_counter()
    print(json.dumps({"frames": frames_out, "counters": pipe.counters.snapshot()}))
    return 0


def _measurement_json(meas) -> dict:
    valid = meas.valid.cpu().numpy()
    out = {
        "range_m": meas.range_m.cpu().numpy()[valid].tolist(),
        "velocity_ms": meas.velocity_ms.cpu().numpy()[valid].tolist(),
        "elevation_deg": meas.elevation_deg.cpu().numpy()[valid].tolist(),
    }
    if meas.spectral_width is not None:
        out["spectral_width_bins"] = meas.spectral_width.cpu().numpy()[valid].tolist()
    return out


def cmd_dmx(args, on_result: Optional[Callable] = None) -> int:
    """G0 end-to-end chain over a G1-format capture (``DMX_SignalProcessing_main_xzr.m``).

    Per frame: read the dual-beam 24-bit frame, run B3 -> sum/diff -> notch
    -> B1 -> detections -> measurements, and emit the estimates.  Agile
    mode: unless ``--freq-index``/``--beam-pos`` pin them, both come from
    each frame's own header (:310-315,506-516).  ``on_result`` (if given)
    sees ``(frame_idx, G0FrameResult)`` for every frame.
    """
    from radar_signal_process_tpu_torch.config import G0_PROFILE, G0ChainConfig
    from radar_signal_process_tpu_torch.ingest import g1_reader_class
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

    profile = G0_PROFILE
    chain = G0Chain(
        profile, G0ChainConfig(),
        5 if args.freq_index is None else args.freq_index,
        0 if args.beam_pos is None else args.beam_pos,
        spectral_width_db=args.spectral_width_db,
        spectral_width_interp=args.spectral_width_interp,
        device=args.device,
    )
    reader = g1_reader_class(args.native)(
        args.input, prt_num=profile.prt_per_frame, point_prt=profile.point_prt,
        frames_per_file=args.frames_per_file,
    )
    fence = torch.cuda.synchronize if chain.device.type == "cuda" else (lambda: None)
    wall = {"read": 0.0, "process": 0.0}
    frames_out = []
    for frame_idx in range(args.frame_start, args.frame_start + args.frames):
        t0 = time.perf_counter()
        left, right, angles, meta = reader.read_frame(frame_idx)
        t1 = time.perf_counter()
        fi = args.freq_index if args.freq_index is not None else int(
            meta.get("freq_index", chain.freq_index))
        bp = args.beam_pos if args.beam_pos is not None else int(
            meta.get("beam_pos", chain.beam_pos))
        res = chain.process_frame(left, right, freq_index=fi, beam_pos=bp)
        fence()
        wall["read"] += t1 - t0
        wall["process"] += time.perf_counter() - t1
        frames_out.append({
            "frame": frame_idx,
            "azimuth_deg": float(chain.compensate_angle(np.asarray(angles[:1]))[0]),
            "freq_index": fi,
            "beam_pos": bp,
            "short": _measurement_json(res.measurements_short),
            "long": _measurement_json(res.measurements_long),
        })
        if on_result is not None:
            on_result(frame_idx, res)
    print(json.dumps({"frames": frames_out}))
    n = max(len(frames_out), 1)
    log.info("dmx timing (%s, %d frames): read %.1f ms/frame, process %.1f ms/frame",
             chain.device, len(frames_out), wall["read"] * 1e3 / n, wall["process"] * 1e3 / n)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radar_signal_process_tpu_torch",
        description="PyTorch/CUDA port of the radar signal-processing chain",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("stream", help="streaming chain: overlapped ingest + "
                                       "compute with all-beam detection")
    st.add_argument("--input", required=True)
    st.add_argument("--profile", default="G2", choices=PROFILES)
    st.add_argument("--frames", type=int, default=10)
    st.add_argument("--win-size", type=int, default=4)
    st.add_argument("--clutter-v", type=float, default=3.0)
    st.add_argument("--max-detections", type=int, default=16)
    st.add_argument("--dbf-coeffs", default=None)
    st.add_argument("--emit", default="full",
                    choices=("detections", "flags", "full"),
                    help="per-window emission: 'detections' drops the RDM "
                         "and flag stacks; detections and hit counters are "
                         "identical across modes")
    st.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    st.add_argument("--device", default="cuda",
                    help="torch device of the chain (cuda or cpu)")
    st.set_defaults(fn=cmd_stream)

    dmx = sub.add_parser("dmx", help="G0 end-to-end chain over a G1-format capture")
    dmx.add_argument("--input", required=True)
    dmx.add_argument("--frames", type=int, default=1)
    dmx.add_argument("--frame-start", type=int, default=1)
    dmx.add_argument("--frames-per-file", type=int, default=10)
    dmx.add_argument("--freq-index", type=int, default=None,
                     help="pin the frequency index (default: each frame's header)")
    dmx.add_argument("--beam-pos", type=int, default=None,
                     help="pin the beam position (default: each frame's header)")
    dmx.add_argument("--spectral-width-db", type=float, default=None,
                     help="also report each detection's Doppler spectral width "
                          "at this dB constraint (ampConstrWidthEst.m)")
    dmx.add_argument("--spectral-width-interp", type=int, default=1,
                     help="spline upsampling factor of the spectral-width rule")
    dmx.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    dmx.add_argument("--device", default="cuda",
                     help="torch device of the chain (cuda or cpu)")
    dmx.set_defaults(fn=cmd_dmx)
    return p


def main(argv=None, on_result: Optional[Callable] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args, on_result=on_result)


if __name__ == "__main__":
    sys.exit(main())
