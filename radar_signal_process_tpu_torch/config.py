"""Radar profiles and processing configs, shared with the JAX package.

``radar_signal_process_tpu.config`` imports neither jax nor numpy, so the
port re-exports it: one definition of every profile constant serves both
packages, and the parity tests hand the same profile object to each.
"""

from radar_signal_process_tpu.config import (  # noqa: F401
    G0_PROFILE,
    G1_PROFILE,
    G2_PROFILE,
    NARROW_PULSE_FIR_TAPS,
    PROFILES,
    CFARConfig,
    G0ChainConfig,
    MTDConfig,
    RadarProfile,
    matlab_round,
)
