"""Frame-keyed persistence with embedded configuration.

The reference's stage bus is a directory of per-frame ``.mat`` files whose
outputs do *not* carry the radar parameters needed to interpret them — a
known flaw it documents itself (``analyze_and_plot_mtd_results.m:19-22``).
Here every frame artifact is an ``.npz`` with the full profile serialized
alongside the arrays, and stage re-runs are idempotent (frame-keyed skip),
preserving the reference's restart-anywhere property (SURVEY.md §5.4).

The port's own copy of the JAX package's ``utils/manifest.py``;
``tests/test_torch_import.py`` holds its code equal to the original.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from radar_signal_process_tpu_torch.config import CFARConfig, MTDConfig, RadarProfile


def _profile_to_json(profile: RadarProfile) -> str:
    def enc(obj):
        if dataclasses.is_dataclass(obj):
            return {
                "__type__": type(obj).__name__,
                **{f.name: enc(getattr(obj, f.name)) for f in dataclasses.fields(obj)},
            }
        if isinstance(obj, tuple):
            return list(obj)
        return obj

    return json.dumps(enc(profile))


def _profile_from_json(blob: str) -> RadarProfile:
    def dec(obj):
        if isinstance(obj, dict) and "__type__" in obj:
            cls = {
                "RadarProfile": RadarProfile,
                "MTDConfig": MTDConfig,
                "CFARConfig": CFARConfig,
            }[obj.pop("__type__")]
            kwargs = {k: dec(v) for k, v in obj.items()}
            for k, v in kwargs.items():
                if isinstance(v, list):
                    kwargs[k] = tuple(
                        tuple(e) if isinstance(e, list) else e for e in v
                    )
            return cls(**kwargs)
        return obj

    return dec(json.loads(blob))


def frame_path(directory: str, frame_idx: int) -> str:
    return os.path.join(directory, f"frame_{frame_idx}.npz")


def frame_exists(directory: str, frame_idx: int) -> bool:
    return os.path.exists(frame_path(directory, frame_idx))


def save_frame(
    directory: str,
    frame_idx: int,
    arrays: Dict[str, np.ndarray],
    profile: RadarProfile,
    meta: Dict[str, Any] | None = None,
) -> str:
    """Atomically persist one frame's arrays + profile + metadata."""
    os.makedirs(directory, exist_ok=True)
    path = frame_path(directory, frame_idx)
    tmp = path + ".tmp"
    payload = dict(arrays)
    payload["__profile__"] = np.frombuffer(
        _profile_to_json(profile).encode(), dtype=np.uint8
    )
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **payload)
    os.replace(tmp, path)
    return path


def load_frame(
    directory: str, frame_idx: int
) -> Tuple[Dict[str, np.ndarray], RadarProfile, Dict[str, Any]]:
    with np.load(frame_path(directory, frame_idx)) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("__")}
        profile = _profile_from_json(bytes(z["__profile__"]).decode())
        meta = json.loads(bytes(z["__meta__"]).decode())
    return arrays, profile, meta
