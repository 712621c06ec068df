"""The general frame generator: frames from a seed, by the configuration's
geometry and scene and the traffic file's noise and number of frames.

Noise is drawn on the card (a ``torch.Generator`` seeded from ``--seed``,
one large call a frame); the targets' parameters on the host from the same
seed.  Every frame is int16-valued complex64, as the radars' 16-bit DDC
words parse, in the layout the port's readers return.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import C_LIGHT, reference_pulses, segment_starts

SEED_MOD = 2 ** 63


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % SEED_MOD, *stream])


def card_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % SEED_MOD)
    return g


def _noise(shape, std: float, gen, device) -> torch.Tensor:
    x = torch.randn(tuple(shape) + (2,), generator=gen, device=device, dtype=torch.float32)
    return torch.view_as_complex(x * std)


def _to_int16(x: torch.Tensor) -> np.ndarray:
    x = torch.complex(x.real.round().clamp(-32768, 32767), x.imag.round().clamp(-32768, 32767))
    return x.cpu().numpy()


def g2_dbf_coeffs(config: dict, seed: int) -> np.ndarray:
    """(n_beams, n_channels) DFT-steered beams with seeded phase errors."""
    prof, dbf = config["profile"], config["dbf"]
    u = (np.arange(prof["n_beams"]) - prof["n_beams"] // 2) * dbf["beam_spacing"]
    ch = np.arange(prof["n_channels"])
    err = np.deg2rad(host_rng(seed, 1).uniform(-dbf["phase_error_deg"], dbf["phase_error_deg"],
                                                (prof["n_beams"], prof["n_channels"])))
    return np.exp(-1j * np.pi * u[:, None] * ch[None, :] + 1j * err)


def g2_frames(config: dict, n: int, noise_std: float, seed: int, device):
    """(frames (N, n_prt, n_samples, n_channels) complex64, DBF coefficients,
    targets): N distinct frames, each noise plus point targets steered into
    seeded beams, chirped echoes at seeded ranges and velocities."""
    prof = config["profile"]
    spec = config["scene"]["targets"]
    n_prt, n_pts, n_ch = prof["prt_per_frame"], prof["point_prt"], prof["n_channels"]
    rng = host_rng(seed, 2)
    pulses, starts = reference_pulses(prof), segment_starts(prof)
    u = (np.arange(prof["n_beams"]) - prof["n_beams"] // 2) * config["dbf"]["beam_spacing"]
    chirped = [i for i, s in enumerate(prof["chirp_signs"]) if s != 0]
    targets = []
    for _ in range(spec["count"]):
        seg = int(rng.choice(chirped))
        room = prof["segment_points"][seg] - len(pulses[seg])
        targets.append({"beam": int(rng.integers(prof["n_beams"])), "segment": seg,
                        "col": starts[seg] + int(rng.integers(max(room, 1))),
                        "amplitude": float(rng.uniform(*spec["amplitude"])),
                        "velocity": float(rng.uniform(*spec["velocity_ms"]))})
    wavelength = C_LIGHT / prof["fc"]
    gen = card_generator(seed, device)
    frames = np.empty((n, n_prt, n_pts, n_ch), np.complex64)
    ch = torch.arange(n_ch, device=device, dtype=torch.float64)
    for f in range(n):
        x = _noise((n_prt, n_pts, n_ch), noise_std, gen, device)
        m = torch.arange(f * n_prt, (f + 1) * n_prt, device=device, dtype=torch.float64)
        for t in targets:
            p = torch.as_tensor(pulses[t["segment"]], device=device)
            p = p[: n_pts - t["col"]]
            fd = 2.0 * t["velocity"] / wavelength
            ramp = torch.exp(2j * np.pi * fd * prof["prt"] * m)
            steer = torch.exp(1j * np.pi * u[t["beam"]] * ch)
            echo = t["amplitude"] * ramp[:, None, None] * p[None, :, None] * steer[None, None, :]
            x[:, t["col"]:t["col"] + len(p)] += echo.to(torch.complex64)
        frames[f] = _to_int16(x)
    return frames, g2_dbf_coeffs(config, seed), targets


def g0_frames(config: dict, n: int, noise_std: float, seed: int, device):
    """(left, right (N, n_prt, point_prt) complex64, freq_index (N,), beam_pos
    (N,), targets): both pulses of each target echo in both beams, the right
    a seeded share of the left, each frame on its own seeded frequency
    index and beam position."""
    prof = config["profile"]
    spec = config["scene"]["targets"]
    n_prt, n_pts = prof["prt_per_frame"], prof["point_prt"]
    rng = host_rng(seed, 3)
    pulses, starts = reference_pulses(prof), segment_starts(prof)
    n_freq, n_pos = len(config["k_value_table"]), len(config["k_value_table"][0])
    freq_index = rng.integers(n_freq, size=n)
    beam_pos = rng.integers(n_pos, size=n)
    targets = []
    for _ in range(spec["count"]):
        targets.append({
            "cells": [starts[s] + int(rng.integers(max(prof["segment_points"][s]
                                                           - len(pulses[s]), 1)))
                      for s in range(len(pulses))],
            "amplitude": float(rng.uniform(*spec["amplitude"])),
            "velocity": float(rng.uniform(*spec["velocity_ms"])),
            "ratio": float(rng.uniform(*spec["right_over_left"]))})
    gen = card_generator(seed, device)
    left = np.empty((n, n_prt, n_pts), np.complex64)
    right = np.empty_like(left)
    m = torch.arange(n_prt, device=device, dtype=torch.float64)
    for f in range(n):
        wavelength = C_LIGHT / (config["freq_table_mhz"][int(freq_index[f])] * 1e6)
        xl = _noise((n_prt, n_pts), noise_std, gen, device)
        xr = _noise((n_prt, n_pts), noise_std, gen, device)
        for t in targets:
            ramp = torch.exp(2j * np.pi * (2.0 * t["velocity"] / wavelength) * prof["prt"] * m)
            for s, col in enumerate(t["cells"]):
                p = torch.as_tensor(pulses[s], device=device)
                echo = (t["amplitude"] * ramp[:, None] * p[None, :]).to(torch.complex64)
                xl[:, col:col + len(p)] += echo
                xr[:, col:col + len(p)] += t["ratio"] * echo
        left[f], right[f] = _to_int16(xl), _to_int16(xr)
    return left, right, freq_index, beam_pos, targets
