"""Command-line entry point of the port: the ``stream`` subcommand.

``python -m radar_signal_process_tpu_torch.cli stream --input DIR ...`` runs
:class:`models.streaming.StreamingPipeline` over a G2 capture on
``--device`` (default ``cuda``) and prints the same JSON line as
``radar_signal_process_tpu.cli stream``: one entry per window with its
latency, CFAR hits and detections per beam, then the pipeline counters.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

from radar_signal_process_tpu_torch.config import PROFILES


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
    return p


def main(argv=None, on_result: Optional[Callable] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args, on_result=on_result)


if __name__ == "__main__":
    sys.exit(main())
