"""Command-line entry point of the port.

Each subcommand prints what the same subcommand of
``radar_signal_process_tpu.cli`` prints; the chains run on ``--device``
(default ``cuda``):

* ``simulate`` writes a synthetic G2 capture: a moving target in seeded
  clutter at a given SCR (reference S1-S3 as a tool);
* ``e2e`` runs the in-memory chain over a G2 capture: frame pairs through
  :class:`models.mtd_pipeline.FrameProcessor` (B2) and the detector (B1),
  detections of every (beam, slice) as JSON;
* ``stream`` runs :class:`models.streaming.StreamingPipeline` over a G2
  capture: per window its latency, CFAR hits and detections per beam, then
  the pipeline counters;
* ``dmx`` runs :class:`models.g0_chain.G0Chain` over a G1-format dual-beam
  capture, per-frame measurements;
* ``sweep`` runs the threshold x SCR sweep (``evalx.sweep``) and prints its
  table and the metrics as JSON.
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


def cmd_simulate(args, on_result: Optional[Callable] = None) -> int:
    """Synthetic G2 capture: the target echo at ``--scr`` in seeded clutter,
    quantised to int16-scale DDC samples, the same echo in every channel
    with a per-channel phase ramp.  The bytes equal the JAX package's."""
    from radar_signal_process_tpu_torch.sim import (
        add_clutter,
        apply_scr,
        synthesize_target_echo,
        synthetic_clutter,
        write_g2_capture,
    )

    profile = PROFILES[args.profile]
    n = profile.prt_per_frame
    frames = np.zeros(
        (args.frames, n, profile.point_prt, profile.n_channels), dtype=np.complex128
    )
    target = synthesize_target_echo(
        profile, args.velocity, args.range, n_pulses=args.frames * n
    )
    clutter = synthetic_clutter(profile, n_pulses=args.frames * n, seed=args.seed)
    echo = add_clutter(apply_scr(target, clutter, args.scr, profile), clutter)
    scale = 3000.0 / (np.abs(echo).max() + 1e-30)
    phases = np.exp(1j * 2 * np.pi * np.arange(profile.n_channels) / 64.0)
    for f in range(args.frames):
        block = echo[f * n : (f + 1) * n] * scale
        frames[f] = np.round(block[..., None].real * phases.real
                             - block[..., None].imag * phases.imag) + 1j * np.round(
            block[..., None].real * phases.imag + block[..., None].imag * phases.real
        )
    write_g2_capture(args.output, frames, profile, data_type=1,
                     file_sizes=[args.file_bytes] * 1000 if args.file_bytes else None)
    log.info("wrote %d synthetic frames to %s", args.frames, args.output)
    return 0


def _det_rows(dets) -> list:
    """Batched (beam, slice) DetectionList -> ``[beam, win, v, r, amp]`` rows."""
    valid = dets.valid.cpu().numpy()
    v_idx, r_idx = dets.v_idx.cpu().numpy(), dets.r_idx.cpu().numpy()
    amp = dets.amplitude.cpu().numpy()
    return [
        [int(b), int(w), int(v), int(r), float(a)]
        for b, w in np.ndindex(*valid.shape[:2])
        for v, r, a in zip(v_idx[b, w][valid[b, w]], r_idx[b, w][valid[b, w]],
                           amp[b, w][valid[b, w]])
    ]


def cmd_e2e(args, on_result: Optional[Callable] = None) -> int:
    """Fused in-memory chain: ``.bin`` capture -> detections of every
    (beam, slice) of every frame pair, as the reference's stage 3 does
    (``main_cfar.m:85-96``), no file bus.  ``on_result`` (if given) sees
    ``(frame, rdms, flags, dets, seconds)`` for every window, ``seconds``
    being the window's "mtd+cfar" stage time (``utils.StageTimers``: on the
    card it ends in a synchronize)."""
    from radar_signal_process_tpu_torch.device import resolve_device
    from radar_signal_process_tpu_torch.ingest import g2_reader_class
    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.models.mtd_pipeline import make_frame_processor
    from radar_signal_process_tpu_torch.utils import StageTimers

    profile = PROFILES[args.profile]
    device = resolve_device(args.device)
    reader = g2_reader_class(args.native)(args.input, profile)
    process = make_frame_processor(profile, win_size=args.win_size, device=device)
    detector = make_detector(profile, clutter_v=args.clutter_v,
                             max_detections=args.max_detections, device=device)
    timers = StageTimers(device)
    prev = None
    results = []
    with torch.inference_mode():
        for frame_idx in range(args.frames + 1):
            with timers.stage("read"):
                res = reader.read_frame(frame_idx)
            if not res.frame_completed:
                break
            # (prt, samples, channels) -> (channels, prt, samples) on the device
            cur = torch.from_numpy(np.asarray(res.iq, dtype=np.complex64)).to(device)
            cur = cur.permute(2, 0, 1).contiguous()
            if prev is not None:
                with timers.stage("mtd+cfar"):
                    rdms = process(prev, cur)
                    flags, _, dets = detector(rdms)
                results.append({"frame": frame_idx - 1, "detections": _det_rows(dets)})
                if on_result is not None:
                    on_result(frame_idx - 1, rdms, flags, dets,
                              timers.records["mtd+cfar"][-1])
            prev = cur
    print(json.dumps({"frames": results}))
    log.info("e2e timing (%s)\n%s", device, timers.report())
    return 0


def cmd_sweep(args, on_result: Optional[Callable] = None) -> int:
    """Threshold x SCR sweep with the S4 detection metrics (``main_cfar``'s
    ``for T=[5]`` loop generalised)."""
    from radar_signal_process_tpu_torch.evalx.sweep import format_sweep, sweep_thresholds

    results = sweep_thresholds(
        PROFILES[args.profile],
        thresholds=args.thresholds,
        scr_db=args.scr,
        velocity_ms=args.velocity,
        range_m=args.range,
        n_frames=args.frames,
        clutter_v=args.clutter_v,
        device=args.device,
    )
    print(format_sweep(results))

    def clean(m):
        return {k: (None if v != v else v) for k, v in m.items()}

    print(json.dumps({f"{scr}/{t}": clean(m) for (scr, t), m in results.items()}))
    if on_result is not None:
        on_result(results)
    return 0


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
    sim = sub.add_parser("simulate", help="write a synthetic G2 .bin capture")
    sim.add_argument("--output", required=True)
    sim.add_argument("--profile", default="G2", choices=PROFILES)
    sim.add_argument("--frames", type=int, default=3)
    sim.add_argument("--velocity", type=float, default=-5.7)
    sim.add_argument("--range", type=float, default=320.0)
    sim.add_argument("--scr", type=float, default=10.0)
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--file-bytes", type=int, default=0,
                     help="split the capture into files of this size")
    sim.set_defaults(fn=cmd_simulate)

    e2e = sub.add_parser("e2e", help=".bin capture -> detection JSON, in memory")
    e2e.add_argument("--input", required=True)
    e2e.add_argument("--profile", default="G2", choices=PROFILES)
    e2e.add_argument("--frames", type=int, default=3)
    e2e.add_argument("--win-size", type=int, default=4)
    e2e.add_argument("--clutter-v", type=float, default=3.0)
    e2e.add_argument("--max-detections", type=int, default=16)
    e2e.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    e2e.add_argument("--device", default="cuda",
                     help="torch device of the chain (cuda or cpu)")
    e2e.set_defaults(fn=cmd_e2e)

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

    sw = sub.add_parser("sweep", help="threshold x SCR detection-metric sweep")
    sw.add_argument("--profile", default="G2", choices=PROFILES)
    sw.add_argument("--thresholds", type=float, nargs="+", default=[3.0, 5.0, 7.0])
    sw.add_argument("--scr", type=float, nargs="+", default=[0.0, 10.0, 20.0])
    sw.add_argument("--velocity", type=float, default=-5.7)
    sw.add_argument("--range", type=float, default=320.0)
    sw.add_argument("--frames", type=int, default=4)
    sw.add_argument("--clutter-v", type=float, default=3.0)
    sw.add_argument("--device", default="cuda",
                    help="torch device of the chain (cuda or cpu)")
    sw.set_defaults(fn=cmd_sweep)
    return p


def main(argv=None, on_result: Optional[Callable] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args, on_result=on_result)


if __name__ == "__main__":
    sys.exit(main())
