#!/usr/bin/env python3
"""Where a G2 window's device time goes on the block path and the windowed path.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_block_window.py

On seven seeded full-G2 beam frames (13 beams x 332 x 3404, complex64, on
the card) it times, in turns with CUDA events (median of 5), one block of
six windows through ``models.host_parallel.make_stream_pipeline`` (each
frame compressed once, one B2 and one B1 launch, one top-k) and the same six
windows through ``FrameProcessor`` + ``Detector`` one at a time, then traces
one of each with ``torch.profiler`` and prints each side's device time per
window by kernel (the twelve largest) and the device's busy share of the
traced wall time (the union of its device intervals,
``bench.device_busy_share``).  Prints one JSON line last.  Imports only the port.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from radar_signal_process_tpu_torch.bench import device_busy_share  # noqa: E402
from radar_signal_process_tpu_torch.config import G2_PROFILE as PROF  # noqa: E402
from radar_signal_process_tpu_torch.models.detect import (  # noqa: E402
    clutter_cells,
    make_detector,
)
from radar_signal_process_tpu_torch.models.host_parallel import make_stream_pipeline  # noqa: E402
from radar_signal_process_tpu_torch.models.mtd_pipeline import make_frame_processor  # noqa: E402

K, REPS = 6, 5


def by_kernel(prof) -> dict:
    """Device ms per window of each kernel name in the trace."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and str(getattr(e, "device_type", "")).endswith("CUDA"):
            out[e.key] = t / 1e3 / K
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20250817)
    frames = [torch.randn((PROF.n_beams, PROF.prt_per_frame, PROF.point_prt),
                          dtype=torch.complex64, device=dev, generator=gen) for _ in range(K + 1)]
    n_clutter = clutter_cells(PROF, PROF.prt_per_frame)
    run = make_stream_pipeline(PROF, 4, n_clutter, max_detections=16, device=dev)
    processor = make_frame_processor(PROF, 4, device=dev)
    detector = make_detector(PROF, n_clutter=n_clutter, max_detections=16, device=dev)

    def block():
        run(frames, lambda *r: None)

    def windowed():
        for w in range(K):
            flags, _, _ = detector(processor(frames[w], frames[w + 1]))
            int(flags.sum())

    fns = {"block": block, "windowed": windowed}
    with torch.inference_mode():
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        times = {k: [] for k in fns}
        for _ in range(REPS):
            for k, fn in fns.items():
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                times[k].append(e0.elapsed_time(e1) / K)
        kernels, busy = {}, {}
        for k, fn in fns.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            kernels[k] = by_kernel(prof)
            busy[k] = device_busy_share(prof, wall_s)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    print(f"{smi} | G2 windows, device ms per window (CUDA events, median of {REPS}, in turns, "
          f"{K} windows a turn): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    for k, table in kernels.items():
        print(f"{k}: device ms per window by kernel (torch.profiler, {K} windows), sum "
              f"{sum(table.values()):.3f}; device busy {100 * busy[k]:.1f}% of the traced "
              "wall time")
        for name, t in list(table.items())[:12]:
            print(f"  {t:8.3f}  {name[:110]}")
    print(json.dumps({"card": smi, "ms": ms, "busy_share": busy, "kernel_ms": {
        k: {n: round(t, 4) for n, t in list(v.items())[:12]} for k, v in kernels.items()},
        "kernel_sum_ms": {k: sum(v.values()) for k, v in kernels.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
