"""Threshold x SCR sweep with the S4 detection metrics.

Port of ``radar_signal_process_tpu/evalx/sweep.py``: the reference's
``for T=[5]`` threshold loop (``main_cfar.m:40``) generalised.  A simulated
target at known kinematics is injected into seeded clutter at each SCR, the
MTD + CFAR chain runs per (SCR, threshold) cell, and the detection metrics
are tabulated.

The ``n_frames`` echoes of one SCR go through the chain as one batch:
``mtd_produce`` (one B2 launch) and the re-notch once, then one B1 launch
per threshold over the whole batch (B1 takes the threshold at run time, so
every threshold shares one launch plan).  The flags are those of the JAX
package's ref-level form, which keeps the roll form's sum order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import RadarProfile
from radar_signal_process_tpu_torch.device import REAL, resolve_device
from radar_signal_process_tpu_torch.evalx.metrics import TruthGate, evaluate_frames
from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d
from radar_signal_process_tpu_torch.models.detect import (
    RENOTCH_DIVISOR,
    clutter_cells,
    renotch_mask,
)
from radar_signal_process_tpu_torch.models.mtd_pipeline import mtd_produce
from radar_signal_process_tpu_torch.sim import (
    add_clutter,
    apply_scr,
    synthesize_target_echo,
    synthetic_clutter,
)


def sweep_thresholds(
    profile: RadarProfile,
    thresholds: Sequence[float],
    scr_db: Sequence[float],
    velocity_ms: float,
    range_m: float,
    n_frames: int = 4,
    clutter_v: float = 3.0,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
    seed: int = 0,
    gate: TruthGate = TruthGate(),
    device: str | torch.device = "cuda",
) -> dict:
    """Returns ``{(scr, T): metrics_dict}`` over the sweep grid; the chain
    runs on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    n = profile.prt_per_frame
    n_clutter = clutter_cells(profile, n, clutter_v)
    r_axis = profile.range_axis(profile.point_prt)
    v_axis = profile.velocity_axis(n)
    # truth in global RDM coordinates: the mid-segment column
    r_cell = profile.segment_starts[1] + int(round(range_m / profile.delta_r))
    r_true = [r_axis[r_cell]] * n_frames
    v_true = [velocity_ms] * n_frames
    segments = profile.cfar_segments or ((0, profile.point_prt),)

    target = synthesize_target_echo(profile, velocity_ms, range_m, n_pulses=n)
    clutters = [synthetic_clutter(profile, n_pulses=n, seed=seed + 97 * f)
                for f in range(n_frames)]
    results = {}
    for scr in scr_db:
        echo = np.stack([add_clutter(apply_scr(target, c, scr, profile), c) for c in clutters])
        rdm = mtd_produce(torch.from_numpy(echo.astype(np.complex64)).to(device), profile)
        keep = renotch_mask(profile, rdm.shape[-2], n_clutter, renotch_divisor)
        rdmn = rdm if keep is None else rdm * torch.as_tensor(keep, dtype=REAL, device=device)[:, None]
        rdm_host = list(rdm.cpu().numpy())
        for t in thresholds:
            cfg = dataclasses.replace(profile.cfar, threshold=float(t))
            flags, _ = cascaded_cfar2d(rdmn, cfg, n_clutter, segments)
            results[(float(scr), float(t))] = evaluate_frames(
                list(flags.cpu().numpy()), rdm_host, r_true, v_true, r_axis, v_axis, gate=gate,
            )
    return results


def format_sweep(results: dict) -> str:
    lines = [
        f"{'SCR dB':>7} {'T':>5} {'Pd':>6} {'FA rate':>10} {'acc':>6} {'PCF':>6}"
    ]
    for (scr, t), m in sorted(results.items()):
        lines.append(
            f"{scr:7.1f} {t:5.1f} {m['detection_rate']:6.2f} "
            f"{m['false_alarm_rate']:10.2e} {m['accuracy']:6.2f} "
            f"{m['localization_pcf']:6.2f}"
        )
    return "\n".join(lines)
