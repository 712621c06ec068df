"""Detection stage: RDM -> re-notch -> cascaded CFAR per segment -> detections.

Port of ``radar_signal_process_tpu/models/detect.py``, after
``CFAR_WangCai/main_cfar.m:85-96``: the RDM is re-notched with the wide
divisor-20 clutter notch (on an unshifted spectrum, the clutter rows at both
ends), the cascaded CFAR (B1) runs per pulse segment, and the strongest hits
of the *un-renotched* RDM form the detection list.  ``n_clutter`` follows
``MTD_0v_num = floor(MTD_V / deltaV)`` (``main_cfar.m:56-58``).

The re-notch is no separate pass: :func:`renotch_rows` turns the mask into
the one run of rows the CFAR reads, and B1 reads those as 0.0
(``cascaded_cfar2d(..., zero_rows=)``), on the card without fetching them.

:func:`make_split_detector` and :func:`make_cascade_detector` are the flag
stage alone, in either layout: B1 on a CUDA tensor, and on a CPU tensor the
split form of ``ops.cfar`` (the JAX package's CPU detector) or, in the
transposed layout, the native C++ cascade (``kernels.native_cfar``).
"""

from __future__ import annotations

import functools
import logging
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from radar_signal_process_tpu_torch.config import CFARConfig, RadarProfile
from radar_signal_process_tpu_torch.device import REAL, resolve_device
from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d
from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar_flags, segmented_cfar_select
from radar_signal_process_tpu_torch.ops.measure import DetectionList, extract_detections
from radar_signal_process_tpu_torch.ops.mtd import notch_mask, notch_mask_unshifted
from radar_signal_process_tpu_torch.utils.profiling import span

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


@functools.lru_cache(maxsize=64)
def renotch_rows(
    profile: RadarProfile, n_v: int, n_clutter: int, renotch_divisor: int | None
) -> Optional[Tuple[int, int]]:
    """The rows of :func:`renotch_mask` that the CFAR reads, as one half-open
    run ``(a, b)`` inside the crop ``[n_clutter + 1, n_v - n_clutter)``, or
    None when the re-notch zeroes none of them.

    A shifted spectrum's notch is one run around zero velocity (G2/G1: rows
    148-182 of 332); an unshifted one's two runs lie outside the crop, so
    the re-notch leaves B1's flags as they are.  Raises when the zeroed rows
    in the crop are not one run.
    """
    mask = renotch_mask(profile, n_v, n_clutter, renotch_divisor)
    if mask is None:
        return None
    lo, hi = n_clutter + 1, n_v - n_clutter
    zero = np.flatnonzero(mask[lo:hi] == 0) + lo
    if zero.size == 0:
        return None
    if zero[-1] - zero[0] + 1 != zero.size:
        raise ValueError(f"the re-notch zeroes rows {zero.tolist()} of the crop [{lo}, {hi}): "
                         "not one run")
    return int(zero[0]), int(zero[-1]) + 1


def _segments(profile: RadarProfile, n_range: int) -> Tuple[Tuple[int, int], ...]:
    """The profile's CFAR segments clipped to an RDM ``n_range`` wide, as
    slicing clips them, empty ones dropped (one segment by default)."""
    return tuple((a, min(b, n_range)) for a, b in profile.cfar_segments or ((0, n_range),)
                 if a < min(b, n_range))


def _cascade(
    rdm: torch.Tensor, zero_rows: Optional[Tuple[int, int]], profile: RadarProfile,
    n_clutter: int, cfg: CFARConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return cascaded_cfar2d(rdm, cfg, n_clutter, _segments(profile, rdm.shape[-1]),
                           zero_rows=zero_rows)


def make_split_detector(
    profile: RadarProfile,
    n_clutter: int,
    cfg: CFARConfig | None = None,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
    transposed: bool = False,
    device: str | torch.device = "cuda",
):
    """``detect(rdm) -> (flags, vflags)``: the re-notch and the cascaded CFAR
    over the profile's segments, the JAX ``make_split_detector``'s contract.

    ``transposed=True`` takes (..., n_range, n_velocity) RDMs and returns
    flags in that layout.  On a CUDA tensor the detector is
    :func:`detect_rdm`'s one B1 launch with the re-notch fused, transposing
    in and out when ``transposed`` (free when the RDM is a transposed view
    of a standard-layout tensor); on a CPU tensor it runs the re-notch and
    the split form, ``segmented_cfar_flags`` then ``segmented_cfar_select``.
    Neither copies anything from the host per call.
    """
    resolve_device(device)
    cfg = cfg or profile.cfar
    v_dim, r_dim = (-1, -2) if transposed else (-2, -1)
    masks: dict = {}

    def keep(n_v: int) -> Optional[torch.Tensor]:  # the CPU route's mask
        if n_v not in masks:
            m = renotch_mask(profile, n_v, n_clutter, renotch_divisor)
            masks[n_v] = None if m is None else torch.as_tensor(m, dtype=REAL)
        return masks[n_v]

    def detect(rdm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if rdm.device.type == "cuda":
            x = rdm.mT if transposed else rdm
            zero = renotch_rows(profile, rdm.shape[v_dim], n_clutter, renotch_divisor)
            flags, vflags = _cascade(x.contiguous(), zero, profile, n_clutter, cfg)
            return (flags.mT, vflags.mT) if transposed else (flags, vflags)
        segments = _segments(profile, rdm.shape[r_dim])
        k = keep(rdm.shape[v_dim])
        if k is not None:
            rdm = rdm * (k if transposed else k[:, None])
        vflag, rflag = segmented_cfar_flags(rdm, segments, cfg, n_clutter, transposed=transposed)
        return segmented_cfar_select(rdm, vflag, rflag, segments, cfg, n_clutter,
                                     transposed=transposed)

    return detect


def make_cascade_detector(
    profile: RadarProfile,
    n_clutter: int,
    cfg: CFARConfig | None = None,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
    transposed: bool = False,
    prefer_native: bool | None = None,
    device: str | torch.device = "cuda",
):
    """:func:`make_split_detector`, or on the host the native C++ cascade.

    The native cascade (``kernels/native/cfar.cpp``) gives the split form's
    flags bit for bit, and on an 8-CPU host it takes 2.75 ms per G2 RDM
    against the split form's 40.9 (``tools/bench_cpu_cfar.py``, ``PERF.md``
    §6).  So on a CPU ``device`` in the transposed layout it is the default:
    ``prefer_native`` None or True takes it, False the split form.  It runs
    the RDMs of the leading axes on a pool of ``os.cpu_count()`` threads
    (ctypes releases the GIL).  Where it cannot be built, the build error is
    logged at WARNING and the split form runs.  ``prefer_native=True`` on a
    CUDA ``device`` raises: the card runs B1.
    """
    device = resolve_device(device)
    if prefer_native and device.type != "cpu":
        raise ValueError(f"prefer_native=True: the native cascade runs on the host, not {device}")
    cfg = cfg or profile.cfar
    if prefer_native is not False and transposed and device.type == "cpu":
        from radar_signal_process_tpu_torch.kernels import native_cfar

        if native_cfar.native_cfar_available():
            mask = None
            if renotch_divisor:
                # Doppler extent: the padded FFT length when the profile
                # zero-pads (G0 class), else the CPI length
                n_v = profile.mtd.fft_length or profile.prt_per_frame
                mask = (native_cfar.notch_mask_shifted(n_v, renotch_divisor)
                        if profile.mtd.fftshift
                        else native_cfar.notch_mask_unshifted(n_v, n_clutter))

            def detect(rdm_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
                one = native_cfar.make_native_cascade(
                    n_clutter, cfg, segments=_segments(profile, rdm_t.shape[-2]),
                    notch_mask=mask)
                with ThreadPoolExecutor(os.cpu_count()) as pool:
                    outs = list(pool.map(one, rdm_t.reshape((-1,) + rdm_t.shape[-2:])))
                return (torch.stack([f for f, _ in outs]).reshape(rdm_t.shape),
                        torch.stack([v for _, v in outs]).reshape(rdm_t.shape))

            return detect
        logging.getLogger("radar_tpu_torch.detect").warning(
            "native CFAR unavailable (%s); using the split form", native_cfar.build_error())
    return make_split_detector(profile, n_clutter, cfg=cfg, renotch_divisor=renotch_divisor,
                               transposed=transposed, device=device)


def detect_rdm(
    rdm: torch.Tensor,
    profile: RadarProfile,
    n_clutter: int,
    cfg: CFARConfig | None = None,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RDM (..., n_v, n_r) -> bool (cascade flags, velocity-only flags):
    B1 over the profile's CFAR segments with ``cfg`` (default
    ``profile.cfar``), the re-notch rows read as 0.0.  It copies nothing
    from the host, so it enqueues without synchronising the stream."""
    zero = renotch_rows(profile, rdm.shape[-2], n_clutter, renotch_divisor)
    return _cascade(rdm, zero, profile, n_clutter, cfg or profile.cfar)


class Detector(nn.Module):
    """RDM stack -> ``(flags, vflags, DetectionList)``; the re-notch rows of
    the profile's Doppler extent (``renotch_rows``) are fused into B1."""

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
        self.renotch_divisor = renotch_divisor
        self.device = resolve_device(device)  # no tensor lives on it: the re-notch is fused

    def forward(self, rdm: torch.Tensor):
        with span("detect.cfar", "launch"):
            zero = renotch_rows(self.profile, rdm.shape[-2], self.n_clutter,
                                self.renotch_divisor)
            flags, vflags = _cascade(rdm, zero, self.profile, self.n_clutter, self.cfg)
        with span("detect.extract", "launch"):
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
    """:class:`Detector` for ``profile`` on ``device`` (the
    card unless the caller asks for the CPU; a CUDA device that is absent
    raises); ``n_clutter`` defaults to :func:`clutter_cells` of the Doppler
    extent."""
    device = resolve_device(device)
    n_fft = profile.mtd.fft_length or profile.prt_per_frame
    if n_clutter is None:
        n_clutter = clutter_cells(profile, n_fft, clutter_v)
    return Detector(profile, n_clutter, max_detections, cfg, renotch_divisor, device)
