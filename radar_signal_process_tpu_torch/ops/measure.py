"""Detection lists and sub-bin motion-parameter measurement.

Port of ``radar_signal_process_tpu/ops/measure.py``.

* ``extract_detections``: CFAR hits are densified into the
  ``max_detections`` strongest entries per RDM, ordered by amplitude.
  ``torch.topk`` and ``lax.top_k`` may order equal amplitudes differently;
  notched all-zero rows self-flag and are dropped by ``valid = amplitude > 0``.
* ``motion_parameters`` (``CFAR_WangCai/motionParaMeasure.m:22-82``): for
  every detection a ``2*extra_dots+1``-cell neighbourhood is upsampled with
  MATLAB's not-a-knot spline (x8 in range, x4 in velocity), the interpolated
  peak gives the sub-bin position, and the monopulse sum/difference ratio
  gives the elevation.  The spline on uniform knots is linear in the samples,
  so it is one host-built ``(Q, K)`` matrix (:func:`spline_eval_matrix`).
  The JAX version ``vmap``s a ``dynamic_slice`` per detection; here the
  clamped row and column windows of all K detections are gathered at once
  with index tensors, then one matmul and a first-maximum ``argmax``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch


class DetectionList(NamedTuple):
    """Padded detection list, batched over the RDM's leading axes."""

    v_idx: torch.Tensor      # (..., K) int32 velocity-cell index into the RDM
    r_idx: torch.Tensor      # (..., K) int32 range-cell index
    amplitude: torch.Tensor  # (..., K) RDM amplitude at the hit
    valid: torch.Tensor      # (..., K) bool


def extract_detections(
    flags: torch.Tensor, rdm: torch.Tensor, max_detections: int = 64
) -> DetectionList:
    """Keep the ``max_detections`` strongest flagged cells of each RDM.

    ``flags``/``rdm``: (..., n_velocity, n_range).
    """
    nv, nr = flags.shape[-2], flags.shape[-1]
    scores = torch.where(flags, rdm, -1.0).reshape(*flags.shape[:-2], nv * nr)
    top_vals, top_idx = torch.topk(scores, min(max_detections, nv * nr), dim=-1)
    return DetectionList(
        v_idx=(top_idx // nr).to(torch.int32),
        r_idx=(top_idx % nr).to(torch.int32),
        amplitude=top_vals,
        valid=top_vals > 0,
    )


# --------------------------------------------------------------------- spline
@functools.lru_cache(maxsize=None)
def _spline_matrices(n_knots: int) -> tuple:
    """``C`` with second derivatives ``M = C @ y`` of the not-a-knot cubic
    spline through ``n_knots`` uniform knots with values ``y``."""
    k = n_knots
    a = np.zeros((k, k))
    rhs_t = np.zeros((k, k))
    # not-a-knot end conditions: third-derivative continuity at the 2nd and
    # second-to-last knots -> M0 - 2 M1 + M2 = 0 (and mirrored)
    a[0, 0:3] = (1.0, -2.0, 1.0)
    a[-1, -3:] = (1.0, -2.0, 1.0)
    for i in range(1, k - 1):
        a[i, i - 1 : i + 2] = (1.0, 4.0, 1.0)
        rhs_t[i, i - 1 : i + 2] = (6.0, -12.0, 6.0)
    c = np.linalg.solve(a, rhs_t)
    return (c,)


@functools.lru_cache(maxsize=None)
def spline_eval_matrix(n_knots: int, upsample: int) -> np.ndarray:
    """(Q, K) float64 matrix evaluating the not-a-knot spline of K uniform
    knots at Q = (K-1)*upsample + 1 uniformly spaced points:
    ``values @ P.T`` == ``interp1(0:K-1, values, 0:1/upsample:K-1, 'spline')``.
    """
    (c,) = _spline_matrices(n_knots)
    k = n_knots
    q = (k - 1) * upsample + 1
    p = np.zeros((q, k))
    for qi in range(q):
        t = qi / upsample
        j = min(int(np.floor(t)), k - 2)  # segment index
        s = t - j
        # S = M_j (1-s)^3/6 + M_{j+1} s^3/6 + (y_j - M_j/6)(1-s) + (y_{j+1} - M_{j+1}/6) s
        w_y = np.zeros(k)
        w_m = np.zeros(k)
        w_y[j] += 1.0 - s
        w_y[j + 1] += s
        w_m[j] += (1.0 - s) ** 3 / 6.0 - (1.0 - s) / 6.0
        w_m[j + 1] += s**3 / 6.0 - s / 6.0
        p[qi, :] = w_y + w_m @ c
    return p


def spline_interp_notaknot(y: torch.Tensor, upsample: int) -> torch.Tensor:
    """Not-a-knot cubic-spline upsampling along the last axis (matmul form)."""
    p = torch.as_tensor(spline_eval_matrix(y.shape[-1], upsample), dtype=y.dtype, device=y.device)
    return y @ p.T


# ---------------------------------------------------------------- measurement
class Measurements(NamedTuple):
    range_m: torch.Tensor        # (K,)
    velocity_ms: torch.Tensor    # (K,)
    elevation_deg: torch.Tensor  # (K,)
    valid: torch.Tensor          # (K,) bool
    # optional K12 output: Doppler spectral width per detection, in velocity
    # bins (ampConstrWidthEst.m); None unless requested
    spectral_width: Optional[torch.Tensor] = None


def motion_parameters(
    rdm_sum: torch.Tensor,
    rdm_diff: torch.Tensor,
    detections: DetectionList,
    r_scale: torch.Tensor,
    delta_r: float,
    v_scale: torch.Tensor,
    delta_v: float | torch.Tensor,
    k_value: float | torch.Tensor,
    beam_pos: int | None,
    beam_angle_step: float,
    n_clutter: int,
    extra_dots: int = 2,
    r_interp: int = 8,
    v_interp: int = 4,
    ele_angle_comp: float = 0.0,
    ele_angle_sys_err: float = 0.0,
    spectral_width_db: float | None = None,
    spectral_width_shifted: bool = True,
    spectral_width_interp: int = 1,
    beam_elevation: float | torch.Tensor | None = None,
    splines: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Measurements:
    """Per-detection sub-bin range/velocity/elevation estimates.

    ``rdm_sum``/``rdm_diff``: (n_velocity, n_range) magnitude sum and
    difference RDMs; ``k_value`` is the monopulse slope for (frequency
    index, beam position).  The support windows are clamped to contiguous
    in-bounds blocks, as the reference's index rebuild does: in range to
    ``[0, nr-w]``, in velocity to the rows outside the clutter notch.
    ``spectral_width_db`` adds each detection's Doppler spectral width
    (:func:`radar_signal_process_tpu_torch.ops.spectrum.detection_spectral_widths`);
    ``spectral_width_shifted=False`` marks unshifted (G0) spectra.

    ``delta_v``, ``k_value`` and ``beam_elevation`` (the beam's axis,
    ``beam_pos * beam_angle_step + 2.5``, computed here when None; where it
    is given, ``beam_pos`` and ``beam_angle_step`` are not read) may be
    0-dim float32 tensors on the RDM's device holding the value a Python
    float becomes in a float32 operation: the results are the same bits, and
    a captured CUDA graph reads each frame's values from them.  ``splines``
    is ``(P_r, P_v)``, :func:`spline_eval_matrix` of the range and velocity
    windows made once on the RDM's device and dtype; made here when None.
    """
    nv, nr = rdm_sum.shape
    w = 2 * extra_dots + 1
    dt, dev = rdm_sum.dtype, rdm_sum.device
    if splines is None:
        splines = (torch.as_tensor(spline_eval_matrix(w, r_interp), dtype=dt, device=dev),
                   torch.as_tensor(spline_eval_matrix(w, v_interp), dtype=dt, device=dev))
    p_r, p_v = splines
    r_scale = torch.as_tensor(r_scale, dtype=dt, device=dev)
    v_scale = torch.as_tensor(v_scale, dtype=dt, device=dev)
    v = detections.v_idx.long()
    r = detections.r_idx.long()
    offs = torch.arange(w, device=dev)

    # range estimate (motionParaMeasure.m:22-46)
    r_start = (r - extra_dots).clamp(0, nr - w)
    rows = rdm_sum[v[:, None], r_start[:, None] + offs]          # (K, w)
    i1 = torch.argmax(rows @ p_r.T, dim=-1)                      # first maximum
    r_cell_max = r_start.to(dt) + i1.to(dt) / r_interp
    r_est = r_scale[r] + (r_cell_max - r.to(dt)) * delta_r

    # velocity estimate (motionParaMeasure.m:49-73), outside the clutter rows
    v_lo = n_clutter + 1
    v_hi = nv - n_clutter - 1 - (w - 1)
    v_start = (v - extra_dots).clamp(v_lo, v_hi).clamp(0, nv - w)
    cols = rdm_sum[v_start[:, None] + offs, r[:, None]]          # (K, w)
    i2 = torch.argmax(cols @ p_v.T, dim=-1)
    v_cell_max = v_start.to(dt) + i2.to(dt) / v_interp
    v_int = torch.floor(v_cell_max).long()
    v_frac = v_cell_max - v_int.to(dt)
    v_est = v_scale[v_int] - v_frac * delta_v

    # monopulse elevation (motionParaMeasure.m:75-82)
    amp_ratio = rdm_diff[v, r] / rdm_sum[v, r]
    if beam_elevation is None:
        beam_elevation = beam_pos * beam_angle_step + 2.5
    ele = beam_elevation - amp_ratio * k_value + ele_angle_comp + ele_angle_sys_err
    width = None
    if spectral_width_db is not None:
        from radar_signal_process_tpu_torch.ops.spectrum import detection_spectral_widths

        width = detection_spectral_widths(
            rdm_sum, detections.r_idx, spectral_width_db,
            shifted_input=spectral_width_shifted,
            interp=spectral_width_interp > 1,
            interp_times=max(spectral_width_interp, 1),
        )
    return Measurements(
        range_m=r_est, velocity_ms=v_est, elevation_deg=ele,
        valid=detections.valid, spectral_width=width,
    )
