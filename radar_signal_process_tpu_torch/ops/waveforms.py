"""Reference transmit-waveform synthesis and measured matched-filter
waveforms (host numpy constants).

The port's own copy of the JAX package's ``ops/waveforms.py``: the ideal LFM
pulses of the reference (``MTD/fun_MTD_produce.m:61-69`` for G2,
``MatlabProcess_xuzerui/main.m:68-80`` for G1) — for each pulse ``i`` with
width ``tau_i`` and chirp slope ``K_i``,

* time axis ``t = -tau/2 : ts : tau/2 - ts``,
* narrow (unmodulated) pulse: ``sin(2*pi*t + pi/2)``,
* chirped pulses: ``exp(j*2*pi*(0.5*K*t^2))`` (f0 = 0);

measured waveforms loaded from ``.mat``/``.npz``/``.npy`` and substituted per
segment (the ``fun_MTD_produce.m:72-78`` hook); and the composite transmit
pulse.  ``tests/test_torch_import.py`` holds the code equal to the original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from radar_signal_process_tpu_torch.config import RadarProfile


def reference_pulses(profile: RadarProfile) -> Tuple[np.ndarray, ...]:
    """Return the per-pulse reference waveforms for matched filtering."""
    ts = profile.ts
    pulses = []
    for tau, k_slope, sign in zip(
        profile.pulse_widths, profile.chirp_slopes, profile.chirp_signs
    ):
        n = int(round(tau / ts))
        t = (np.arange(n) * ts) - tau / 2.0
        if sign == 0:
            # narrow simple pulse: sin(2*pi*t + pi/2) == cos(2*pi*t)
            pulses.append(np.sin(2.0 * np.pi * t + np.pi / 2.0).astype(np.complex128))
        else:
            pulses.append(np.exp(1j * 2.0 * np.pi * (0.5 * k_slope * t**2)))
    return tuple(pulses)


def load_measured_pulse(path: str, var: str | None = None) -> np.ndarray:
    """Load one measured matched-filter waveform from ``.mat``/``.npz``/``.npy``.

    The reference keeps measured pulse tables as an alternative to the
    synthesized LFM references (hard-coded at ``temp.m:50-56``, the
    commented hook at ``MTD/fun_MTD_produce.m:72-78``, and the G0 fixtures
    ``refDDCDataMF1.mat``/``refDBFDataMF1.mat`` loaded at
    ``DMX_SignalProcessing_main_xzr.m:156-159``).  ``var`` selects the
    variable/array name; default: the single non-metadata entry.
    """
    def _as_waveform(arr) -> np.ndarray:
        # a measured waveform is one complex vector; flattening a 2-D table
        # (e.g. a stack of pulses, or a (n, 2) real/imag pair saved as a
        # matrix) would silently matched-filter against interleaved garbage
        wf = np.squeeze(np.asarray(arr))
        if wf.ndim != 1:
            raise ValueError(
                f"measured waveform in {path} has shape {np.shape(arr)}; "
                "expected one 1-D complex vector (select a row/variable)"
            )
        return wf.astype(np.complex128)

    lower = path.lower()
    if lower.endswith(".mat"):
        import scipy.io as sio

        data = {k: v for k, v in sio.loadmat(path).items()
                if not k.startswith("__")}
    elif lower.endswith(".npz"):
        data = dict(np.load(path))
    else:
        if var is not None:
            raise ValueError(
                f"var={var!r} has no meaning for {path}: .npy files hold a "
                "single array (did you mean an .npz/.mat?)"
            )
        return _as_waveform(np.load(path))
    if var is None:
        if len(data) != 1:
            raise ValueError(
                f"{path} holds {sorted(data)}; pass var= to select one"
            )
        (var,) = data
    if var not in data:
        raise KeyError(f"{var!r} not in {path} (has {sorted(data)})")
    return _as_waveform(data[var])


def pulses_with_overrides(
    profile: RadarProfile, overrides: dict[int, np.ndarray]
) -> Tuple[np.ndarray, ...]:
    """Reference pulses with measured waveforms substituted per segment.

    ``overrides`` maps 0-based segment index -> measured complex waveform.
    Only chirped (matched-filter) segments can be overridden — the narrow
    segment uses the FIR path, which has no reference pulse
    (``fun_lss_pulse_compression.m:31-51``).
    """
    pulses = list(reference_pulses(profile))
    for seg, wf in overrides.items():
        if not (0 <= seg < len(pulses)):
            raise ValueError(
                f"segment {seg} out of range (profile has {len(pulses)})"
            )
        if profile.chirp_signs[seg] == 0:
            raise ValueError(
                f"segment {seg} is the FIR narrow-pulse path; only chirped "
                "segments take a matched-filter waveform"
            )
        wf = np.squeeze(np.asarray(wf))
        if wf.ndim > 1:
            # same guard as load_measured_pulse, applied where ALL waveform
            # inputs converge: raveling a 2-D table would matched-filter
            # against interleaved garbage
            raise ValueError(
                f"measured waveform for segment {seg} has shape "
                f"{wf.shape}; expected one 1-D complex vector"
            )
        wf = np.atleast_1d(wf).astype(np.complex128)
        if len(wf) == 0:
            raise ValueError(f"measured waveform for segment {seg} is empty")
        if len(wf) > profile.segment_points[seg]:
            raise ValueError(
                f"measured waveform ({len(wf)} samples) longer than "
                f"segment {seg} ({profile.segment_points[seg]} points)"
            )
        pulses[seg] = wf
    return tuple(pulses)


def composite_transmit_pulse(profile: RadarProfile) -> np.ndarray:
    """Composite transmit waveform: pulses placed at their segment starts.

    Reference: ``main.m:76-80`` places pulse_i at the start of segment i of the
    PRT sample grid.
    """
    out = np.zeros(profile.point_prt, dtype=np.complex128)
    for start, pulse in zip(profile.segment_starts, reference_pulses(profile)):
        out[start : start + len(pulse)] = pulse
    return out
