"""Digital beamforming: channel -> beam projection.

The reference forms 13 beams from 16 channels with a per-PRT complex matmul
``(3404 x 16) * DBF_coeffs.'`` (``FrameDataRead_xzr.m:150-159``); here the
whole frame is one matmul.  ``.'`` is the non-conjugating transpose.
"""

from __future__ import annotations

import numpy as np
import torch


def apply_dbf(iq: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Beamform ``iq`` (..., n_samples, n_channels) with ``coeffs``
    (n_beams, n_channels), non-conjugating.  Returns (..., n_samples, n_beams)."""
    return torch.matmul(iq, coeffs.transpose(0, 1))


def load_dbf_coeffs(path: str, n_channels: int | None = None) -> np.ndarray:
    """Load DBF coefficients from the interleaved-I/Q text format.

    One row per beam; columns alternate I, Q per channel
    (``bin_to_mat_xzr.m:22-29``).  Returns complex128 (n_beams, n_channels).
    """
    raw = np.loadtxt(path, delimiter=None, dtype=np.float64, ndmin=2)
    if raw.shape[1] % 2 != 0:
        raise ValueError(f"expected an even number of columns, got {raw.shape[1]}")
    coeffs = raw[:, 0::2] + 1j * raw[:, 1::2]
    if n_channels is not None and coeffs.shape[1] != n_channels:
        raise ValueError(
            f"coefficient file has {coeffs.shape[1]} channels, expected {n_channels}"
        )
    return coeffs
