"""G1 simulation/validation chain (``MatlabProcess_xuzerui/main.m:206-239``).

Port of ``radar_signal_process_tpu/models/g1_chain.py``: segmented pulse
compression -> range re-concatenation (1031 -> 868 columns,
``config.G1_RANGE_CONCAT``) -> Kaiser-windowed, shifted Doppler transform
-> zero-velocity notch (÷150 from the profile).  The Doppler transform and
the notch are the B2 kernel on the card; the JAX chain takes the XLA FFT
there, and the two agree to f32 rounding.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from radar_signal_process_tpu_torch.config import G1_PROFILE, G1_RANGE_CONCAT, RadarProfile
from radar_signal_process_tpu_torch.device import COMPLEX, resolve_device
from radar_signal_process_tpu_torch.models.mtd_pipeline import _form_rdm
from radar_signal_process_tpu_torch.ops.pulse_compression import (
    range_concatenate,
    segment_filters,
    segmented_pulse_compression,
)
from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses
from radar_signal_process_tpu_torch.params import cpi_params


class G1ValidationChain(nn.Module):
    """Echo (..., n_pulses, 1031) complex64 -> notched magnitude RDM
    (..., n_pulses, 868) float32.

    The pulse-compression spectra are buffers; the window and the DFT
    planes span the echo's pulse count (``params.cpi_params``).
    """

    def __init__(self, profile: RadarProfile, pulses, device: torch.device):
        super().__init__()
        self.profile = profile
        spectra, self.pc_filter_lens = segment_filters(profile, pulses)
        for i, s in enumerate(spectra):
            self.register_buffer(f"pc_spectrum_{i}", torch.as_tensor(s, dtype=COMPLEX,
                                                                     device=device))

    @property
    def pc_spectra(self):
        return tuple(getattr(self, f"pc_spectrum_{i}") for i in range(len(self.pc_filter_lens)))

    def forward(self, echo: torch.Tensor) -> torch.Tensor:
        pc = segmented_pulse_compression(echo, self.profile, self.pc_spectra,
                                         self.pc_filter_lens)
        pc = range_concatenate(pc, G1_RANGE_CONCAT)
        return _form_rdm(pc, self.profile, cpi_params(self.profile, pc.shape[-2], pc.device))


def make_g1_validation_chain(
    profile: RadarProfile = G1_PROFILE, pulses=None, device: str | torch.device = "cuda"
) -> G1ValidationChain:
    """:class:`G1ValidationChain` on ``device`` (the card unless the caller
    asks for the CPU); ``pulses`` overrides the synthesized reference
    waveforms per segment (the measured-pulse hook,
    ``fun_MTD_produce.m:72-78``)."""
    return G1ValidationChain(
        profile, reference_pulses(profile) if pulses is None else pulses,
        resolve_device(device),
    )


@functools.lru_cache(maxsize=None)
def _default_chain(profile: RadarProfile, device: torch.device) -> G1ValidationChain:
    return make_g1_validation_chain(profile, device=device)


def g1_validation_chain(echo: torch.Tensor, profile: RadarProfile = G1_PROFILE) -> torch.Tensor:
    """The synthesized-pulse chain on the echo's device, built once per
    (profile, device)."""
    return _default_chain(profile, echo.device)(echo)
