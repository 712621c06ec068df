#!/usr/bin/env python3
"""Host time per G2 RDM of the port's CPU CFAR detectors, in one process.

Run from the repository root on any host (no GPU needed):

    python3 tools/bench_cpu_cfar.py [--batch 13] [--rounds 3]

On ``--batch`` seeded G2 RDMs (332 x 3404 float32, Rayleigh clutter with a
few strong cells) it times, in turns over ``--rounds`` rounds (median), the
re-notch plus cascaded CFAR of every CPU form the port has:

* ``roll``: ``models.detect.detect_rdm`` on a CPU tensor, i.e. B1's plain
  version ``ops.cfar.segmented_cfar`` (the windowed path's CPU CFAR);
* ``split``: ``make_split_detector`` in the standard layout;
* ``split_t``: ``make_split_detector(transposed=True)`` on the stack's
  transposed view, as the block runner hands it over;
* ``native_t``: the C++ cascade (``kernels.native_cfar``) one RDM at a
  time on one thread;
* ``native_t_pool``: ``make_cascade_detector(transposed=True)``, the CPU
  block path's CFAR: the same cascade mapped over the RDMs on a pool of
  ``os.cpu_count()`` threads (ctypes releases the GIL).

Every form's flags are checked equal to ``roll``'s before anything is
timed.  Prints one line per form, the host's ``os.cpu_count()`` and
``torch.get_num_threads()``, and one JSON line last.  Imports only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from radar_signal_process_tpu_torch.config import G2_PROFILE as PROF  # noqa: E402
from radar_signal_process_tpu_torch.kernels import native_cfar  # noqa: E402
from radar_signal_process_tpu_torch.models.detect import (  # noqa: E402
    RENOTCH_DIVISOR,
    clutter_cells,
    detect_rdm,
    make_cascade_detector,
    make_split_detector,
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=13)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    n_v, n_r = PROF.prt_per_frame, PROF.point_prt
    n_clutter = clutter_cells(PROF, n_v)
    g = torch.Generator().manual_seed(args.seed)
    rdms = torch.randn((args.batch, n_v, n_r), dtype=torch.complex64, generator=g).abs()
    hot = torch.randint(0, rdms.numel(), (args.batch * 64,), generator=g)
    rdms.view(-1)[hot] *= 40.0

    cpu = torch.device("cpu")
    split = make_split_detector(PROF, n_clutter, device=cpu)
    split_t = make_split_detector(PROF, n_clutter, transposed=True, device=cpu)
    if not native_cfar.native_cfar_available():
        print(f"native cascade unavailable: {native_cfar.build_error()}")
        return 1
    pooled = make_cascade_detector(PROF, n_clutter, transposed=True, prefer_native=True,
                                   device=cpu)
    mask = native_cfar.notch_mask_shifted(n_v, RENOTCH_DIVISOR)
    one = native_cfar.make_native_cascade(n_clutter, PROF.cfar, segments=PROF.cfar_segments,
                                          notch_mask=mask)

    forms = {
        "roll": lambda: detect_rdm(rdms, PROF, n_clutter)[0],
        "split": lambda: split(rdms)[0],
        "split_t": lambda: split_t(rdms.mT)[0].mT,
        "native_t": lambda: torch.stack([one(r)[0] for r in rdms.mT]).mT,
        "native_t_pool": lambda: pooled(rdms.mT)[0].mT,
    }
    want = forms["roll"]()
    for name, fn in forms.items():
        n_diff = int((fn() != want).sum())
        if n_diff:
            print(f"{name}: {n_diff} flags differ from roll's")
            return 1
    times: dict = {k: [] for k in forms}
    for _ in range(args.rounds):
        for name, fn in forms.items():
            t0 = time.perf_counter()
            fn()
            times[name].append(time.perf_counter() - t0)
    ms = {k: 1e3 * sorted(v)[len(v) // 2] / args.batch for k, v in times.items()}
    for k, v in ms.items():
        print(f"{k}: {v:.3f} ms per G2 RDM (median of {args.rounds}, batch {args.batch}, "
              f"flags equal to roll's)")
    print(f"os.cpu_count() {os.cpu_count()}, torch.get_num_threads() {torch.get_num_threads()}")
    print(json.dumps({"ms_per_rdm": ms, "batch": args.batch, "rounds": args.rounds,
                      "cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
