#!/usr/bin/env python3
"""Where one G2 window's device time goes, sharded (world 1) and unsharded.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_mesh_window.py

On two seeded full-G2 frames (13 beams x 332 x 3404, complex64, on the
card) it times, in turns with CUDA events (median of 10), the world-1
sharded stream step of ``parallel.make_sharded_stream`` (one frame
compressed, the other carried; B2; B1 on the rank's block, which at sp = 1
needs no halo; top-k) and the unsharded frame processor + detector, then traces five of
each with ``torch.profiler`` and prints each side's device time by kernel
(the ten largest), summed over the five calls and divided by five.  Prints
one JSON line last.  Imports only the port.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from radar_signal_process_tpu_torch.config import G2_PROFILE as PROF  # noqa: E402
from radar_signal_process_tpu_torch.models.detect import (  # noqa: E402
    clutter_cells,
    make_detector,
)
from radar_signal_process_tpu_torch.models.mtd_pipeline import make_frame_processor  # noqa: E402
from radar_signal_process_tpu_torch.ops.measure import extract_detections  # noqa: E402
from radar_signal_process_tpu_torch.parallel import make_mesh  # noqa: E402
from radar_signal_process_tpu_torch.parallel.multihost import initialize_distributed  # noqa: E402
from radar_signal_process_tpu_torch.parallel.sharding import make_sharded_stream  # noqa: E402

REPS, TRACED = 10, 5


def by_kernel(prof) -> dict:
    """Device ms per call of each kernel name in the trace."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and str(getattr(e, "device_type", "")).endswith("CUDA"):
            out[e.key] = t / 1e3 / TRACED
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    initialize_distributed("cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(20250817)
    shape = (PROF.n_beams, PROF.prt_per_frame, PROF.point_prt)
    frames = []
    for _ in range(2):
        x = np.empty(shape, np.complex64)
        x.real = rng.standard_normal(shape, dtype=np.float32)
        x.imag = rng.standard_normal(shape, dtype=np.float32)
        frames.append(torch.from_numpy(x).to(dev))
    a, b = frames
    n_clutter = clutter_cells(PROF, PROF.prt_per_frame)
    try:
        mesh = make_mesh(("dp", "sp"), (1, 1), "cuda")
        compress, step = make_sharded_stream(PROF, mesh, n_clutter=n_clutter, win_size=4,
                                             renotch_divisor=20)
        processor = make_frame_processor(PROF, 4, device=dev)
        detector = make_detector(PROF, n_clutter=n_clutter, max_detections=16, device=dev)
        pc = compress(a)

        def sharded():
            _, rdm, flags, _ = step(pc, b)
            return extract_detections(flags, rdm, 16)

        fns = {"sharded": sharded, "unsharded": lambda: detector(processor(a, b))}
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
                    times[k].append(e0.elapsed_time(e1))
            kernels = {}
            for k, fn in fns.items():
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(TRACED):
                        fn()
                    torch.cuda.synchronize()
                kernels[k] = by_kernel(prof)
    finally:
        dist.destroy_process_group()
    ms = {k: float(np.median(v)) for k, v in times.items()}
    print(f"{smi} | one G2 window, device ms (CUDA events, median of {REPS}, in turns): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    for k, table in kernels.items():
        print(f"{k}: device ms per window by kernel (torch.profiler, {TRACED} windows), sum "
              f"{sum(table.values()):.3f}")
        for name, t in list(table.items())[:10]:
            print(f"  {t:8.3f}  {name[:110]}")
    print(json.dumps({"card": smi, "ms": ms, "kernel_ms": {
        k: {n: round(t, 4) for n, t in list(v.items())[:10]} for k, v in kernels.items()},
        "kernel_sum_ms": {k: sum(v.values()) for k, v in kernels.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
