"""Fixed-capacity detection lists.

Port of ``radar_signal_process_tpu/ops/measure.py::extract_detections``:
CFAR hits are densified into the ``max_detections`` strongest entries per
RDM, ordered by amplitude.  ``torch.topk`` and ``lax.top_k`` may order
equal amplitudes differently; notched all-zero rows self-flag and are
dropped by ``valid = amplitude > 0``.
"""

from __future__ import annotations

from typing import NamedTuple

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
