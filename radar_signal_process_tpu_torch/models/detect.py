"""Detection stage: RDM -> re-notch -> cascaded CFAR per segment -> detections.

Port of ``radar_signal_process_tpu/models/detect.py`` (``detect_rdm`` and
``make_detector``), after ``CFAR_WangCai/main_cfar.m:85-96``: the RDM is
re-notched with the wide divisor-20 clutter notch (on an unshifted spectrum,
the clutter rows at both ends), the cascaded CFAR (B1) runs per pulse
segment, and the strongest hits of the *un-renotched* RDM form the detection
list.  ``n_clutter`` follows ``MTD_0v_num = floor(MTD_V / deltaV)``
(``main_cfar.m:56-58``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from radar_signal_process_tpu_torch.config import CFARConfig, RadarProfile
from radar_signal_process_tpu_torch.device import REAL, resolve_device
from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d
from radar_signal_process_tpu_torch.ops.measure import DetectionList, extract_detections
from radar_signal_process_tpu_torch.ops.mtd import notch_mask, notch_mask_unshifted

# the detector's CFAR-stage re-notch, N/20 rows (CFAR_WangCai/fun_0v_pressing.m)
RENOTCH_DIVISOR = 20


def clutter_cells(profile: RadarProfile, n_fft: int, clutter_v: float = 3.0) -> int:
    """``MTD_0_num = floor(MTD_V / deltaV)`` (``main_cfar.m:56-58``)."""
    return int(math.floor(clutter_v / profile.delta_v(n_fft)))


def renotch_mask(
    profile: RadarProfile, n_v: int, n_clutter: int, renotch_divisor: int | None
) -> Optional[np.ndarray]:
    """(n_v,) float32 keep-mask of the CFAR-stage re-notch, or None for none.

    A shifted spectrum loses the ``round(n_v / divisor)`` rows around zero
    velocity; an unshifted one (G0 class) keeps its clutter at both ends, so
    it loses rows ``0..n_clutter`` and ``n_v-n_clutter..`` instead.
    """
    if not renotch_divisor:
        return None
    if profile.mtd.fftshift:
        return notch_mask(n_v, renotch_divisor)
    return notch_mask_unshifted(n_v, n_clutter)


def _cascade(
    rdm: torch.Tensor, keep: Optional[torch.Tensor], profile: RadarProfile,
    n_clutter: int, cfg: CFARConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if keep is not None:
        rdm = rdm * keep[:, None]
    segments = profile.cfar_segments or ((0, rdm.shape[-1]),)
    return cascaded_cfar2d(rdm, cfg, n_clutter, segments)


def detect_rdm(
    rdm: torch.Tensor,
    profile: RadarProfile,
    n_clutter: int,
    cfg: CFARConfig | None = None,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RDM (..., n_v, n_r) -> bool (cascade flags, velocity-only flags):
    the re-notch, then B1 over the profile's CFAR segments with ``cfg``
    (default ``profile.cfar``)."""
    keep = renotch_mask(profile, rdm.shape[-2], n_clutter, renotch_divisor)
    if keep is not None:
        keep = torch.as_tensor(keep, dtype=REAL, device=rdm.device)
    return _cascade(rdm, keep, profile, n_clutter, cfg or profile.cfar)


class Detector(nn.Module):
    """RDM stack -> ``(flags, vflags, DetectionList)``; the re-notch mask of
    the profile's Doppler extent is a buffer."""

    def __init__(
        self,
        profile: RadarProfile,
        n_clutter: int,
        max_detections: int = 64,
        cfg: CFARConfig | None = None,
        renotch_divisor: int | None = RENOTCH_DIVISOR,
        device: str | torch.device = "cpu",
    ):
        super().__init__()
        self.profile = profile
        self.n_clutter = n_clutter
        self.max_detections = max_detections
        self.cfg = cfg or profile.cfar
        n_v = profile.mtd.fft_length or profile.prt_per_frame
        keep = renotch_mask(profile, n_v, n_clutter, renotch_divisor)
        self.register_buffer(
            "renotch_mask",
            None if keep is None else torch.as_tensor(keep, dtype=REAL, device=device),
        )

    def forward(self, rdm: torch.Tensor):
        flags, vflags = _cascade(rdm, self.renotch_mask, self.profile, self.n_clutter,
                                 self.cfg)
        dets: DetectionList = extract_detections(flags, rdm, self.max_detections)
        return flags, vflags, dets


def make_detector(
    profile: RadarProfile,
    n_clutter: int | None = None,
    clutter_v: float = 3.0,
    max_detections: int = 64,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
    cfg: CFARConfig | None = None,
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
    return Detector(profile, n_clutter, max_detections, cfg, renotch_divisor, device)
