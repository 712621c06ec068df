"""Detection stage: RDM -> re-notch -> cascaded CFAR per segment -> detections.

Port of ``radar_signal_process_tpu/models/detect.py`` (``detect_rdm`` and
``make_detector``), after ``CFAR_WangCai/main_cfar.m:85-96``: the RDM is
re-notched with the wide divisor-20 clutter notch, the cascaded CFAR (B1)
runs per pulse segment, and the strongest hits of the *un-renotched* RDM
form the detection list.  ``n_clutter`` follows ``MTD_0v_num =
floor(MTD_V / deltaV)`` (``main_cfar.m:56-58``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from radar_signal_process_tpu_torch.config import RadarProfile
from radar_signal_process_tpu_torch.device import resolve_device
from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d
from radar_signal_process_tpu_torch.ops.measure import DetectionList, extract_detections
from radar_signal_process_tpu_torch.params import ChainParams, chain_params


def clutter_cells(profile: RadarProfile, n_fft: int, clutter_v: float = 3.0) -> int:
    """``MTD_0_num = floor(MTD_V / deltaV)`` (``main_cfar.m:56-58``)."""
    return int(math.floor(clutter_v / profile.delta_v(n_fft)))


def detect_rdm(
    rdm: torch.Tensor,
    profile: RadarProfile,
    n_clutter: int,
    renotch_mask: torch.Tensor | None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RDM (..., n_v, n_r) -> bool (cascade flags, velocity-only flags).

    ``renotch_mask`` is the (n_v,) keep-mask of the CFAR-stage notch
    (``ChainParams.renotch_mask``), or None for no re-notch.
    """
    if not profile.mtd.fftshift:
        raise NotImplementedError(
            "the detector re-notches shifted (G1/G2-class) spectra only; G0 runs "
            "through models.g0_chain.G0Chain (cli dmx), and the G1 chain is not "
            "ported yet"
        )
    if renotch_mask is not None:
        rdm = rdm * renotch_mask[:, None]
    segments = profile.cfar_segments or ((0, rdm.shape[-1]),)
    return cascaded_cfar2d(rdm, profile.cfar, n_clutter, segments)


class Detector(nn.Module):
    """RDM stack -> ``(flags, vflags, DetectionList)``; the re-notch mask is
    a buffer."""

    def __init__(
        self,
        profile: RadarProfile,
        params: ChainParams,
        n_clutter: int,
        max_detections: int = 64,
    ):
        super().__init__()
        self.profile = profile
        self.n_clutter = n_clutter
        self.max_detections = max_detections
        self.register_buffer("renotch_mask", params.renotch_mask)

    def forward(self, rdm: torch.Tensor):
        flags, vflags = detect_rdm(rdm, self.profile, self.n_clutter, self.renotch_mask)
        dets: DetectionList = extract_detections(flags, rdm, self.max_detections)
        return flags, vflags, dets


def make_detector(
    profile: RadarProfile,
    n_clutter: int | None = None,
    clutter_v: float = 3.0,
    max_detections: int = 64,
    device: str | torch.device = "cuda",
) -> Detector:
    """:class:`Detector` for ``profile`` with its buffer on ``device`` (the
    card unless the caller asks for the CPU; a CUDA device that is absent
    raises); ``n_clutter`` defaults to :func:`clutter_cells` of the Doppler
    extent."""
    device = resolve_device(device)
    n_fft = profile.mtd.fft_length or profile.prt_per_frame
    if n_clutter is None:
        n_clutter = clutter_cells(profile, n_fft, clutter_v)
    return Detector(profile, chain_params(profile, device=device), n_clutter, max_detections)
