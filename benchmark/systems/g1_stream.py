"""The G1 stream: ``StreamingPipeline``'s windowed path on the card over a
G1 radar's two beams, as ``cli stream --profile G1`` builds it, fed by the
benchmark's source in the G1 reader's form.

Frame ``k`` (counting on from 0) is distinct frame ``k % N``; its result is
the detection list of the window it completes, ``(k - 1, k)``, pulled to
the host.  The check takes, of each kept window, its re-concatenated RDM
stack and flags, and every window's detection list.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.cost.work import bound_s, cascaded_cfar, rdm_former
from benchmark.frames import _noise, _to_int16, card_generator, host_rng
from benchmark.reference import cfar as ref_cfar
from benchmark.reference import g1 as ref_g1
from benchmark.reference.common import C_LIGHT, reference_pulses, segment_starts
from benchmark.reference.g2 import slice_starts
from benchmark.systems import g2_stream
from benchmark.systems.g2_stream import frame_bytes  # noqa: F401


def g1_frames(config: dict, n: int, noise_std: float, seed: int, device):
    """(frames (N, 2, n_prt, n_samples) complex64, targets): N distinct
    frames of both beams, each noise plus chirped point-target echoes at
    seeded ranges and velocities, the right beam a seeded share of the left."""
    prof = config["profile"]
    spec = config["scene"]["targets"]
    n_prt, n_pts = prof["prt_per_frame"], prof["point_prt"]
    rng = host_rng(seed, 5)
    pulses, starts = reference_pulses(prof), segment_starts(prof)
    chirped = [i for i, s in enumerate(prof["chirp_signs"]) if s != 0]
    targets = []
    for _ in range(spec["count"]):
        seg = int(rng.choice(chirped))
        room = prof["segment_points"][seg] - len(pulses[seg])
        targets.append({"segment": seg, "col": starts[seg] + int(rng.integers(max(room, 1))),
                        "amplitude": float(rng.uniform(*spec["amplitude"])),
                        "velocity": float(rng.uniform(*spec["velocity_ms"])),
                        "ratio": float(rng.uniform(*spec["right_over_left"]))})
    wavelength = C_LIGHT / prof["fc"]
    gen = card_generator(seed, device)
    frames = np.empty((n, 2, n_prt, n_pts), np.complex64)
    for f in range(n):
        x = _noise((2, n_prt, n_pts), noise_std, gen, device)
        m = torch.arange(f * n_prt, (f + 1) * n_prt, device=device, dtype=torch.float64)
        for t in targets:
            p = torch.as_tensor(pulses[t["segment"]], device=device)[: n_pts - t["col"]]
            ramp = torch.exp(2j * np.pi * (2.0 * t["velocity"] / wavelength) * prof["prt"] * m)
            echo = (t["amplitude"] * ramp[:, None] * p[None, :]).to(torch.complex64)
            x[0, :, t["col"]:t["col"] + len(p)] += echo
            x[1, :, t["col"]:t["col"] + len(p)] += t["ratio"] * echo
        frames[f] = _to_int16(x)
    return frames, targets


def step_bound_s(config: dict, family: str) -> float | None:
    """The least time of one window's calls of ``family``, or None where the
    stream makes none."""
    prof, st = config["profile"], config["stream"]
    n_prt, n_r = prof["prt_per_frame"], config["range_concat"][-1][1]   # re-concatenated
    if family == "b2":
        return bound_s(*rdm_former(prof["n_beams"], n_prt, n_r,
                                   slice_starts(n_prt, st["win_size"])))
    if family == "b1":
        zero = ref_g1.renotch_rows(config)
        notched = 0 if zero is None else zero[1] - zero[0]
        return bound_s(*cascaded_cfar(prof["n_beams"] * st["win_size"], n_prt, n_r,
                                      ref_g1.n_clutter(config), notched))
    return None


class _Reader:
    """The G1 reader's form over the benchmark's source: frames counted
    from 1, ``(left, right, angles, meta)``; after the source stops, the
    end of the capture (a short read), which ends the producer."""

    def __init__(self, source):
        self.source = source

    def read_frame(self, frame_idx: int):
        res = self.source.read(frame_idx - 1)
        if res is None:
            raise EOFError("the source has stopped")
        return res


class Cell(g2_stream.Cell):
    def make_frames(self, noise_std: float) -> None:
        self.frames, self.targets = g1_frames(self.config, self.n, noise_std, self.seed,
                                              self.device)
        self.angles = np.zeros(self.config["profile"]["prt_per_frame"])

    def frame(self, idx: int):
        """Frame ``idx`` as the G1 readers return it, from memory."""
        beams = self.frames[idx % self.n]
        return beams[0], beams[1], self.angles, {}

    def start(self, source) -> None:
        from radar_signal_process_tpu_torch.models.streaming import (
            StreamingPipeline,
            TwoBeamReader,
        )

        st = self.config["stream"]
        self.pipe = StreamingPipeline(
            TwoBeamReader(_Reader(source)), self.profile, win_size=st["win_size"],
            max_frames=2 ** 31 - 1, clutter_v=st["clutter_v"],
            max_detections=st["max_detections"], emit=st["emit"], device=self.device,
            use_host_parallel=False)

    # --------------------------------------------------------------- check
    def _reference(self, frame: int, precision: str = "float64") -> torch.Tensor:
        prev, cur = self.frames[(frame - 1) % self.n], self.frames[frame % self.n]
        return ref_g1.window_rdms(prev, cur, self.config, self.device, precision)

    def control(self, kept: dict, pulled: dict) -> dict:
        """The numbers of :meth:`check` with the TF32 control in the
        program's place: the reference chain with TF32 operands, its flags
        and detection lists by the reference's cascade and sort."""
        ctl_kept, ctl_dets = {}, {}
        for key, (frame, _, _) in sorted(kept.items()):
            c = self._reference(frame, "tf32")
            cf, _ = ref_g1.cascade(c, self.config)
            amp, cells = ref_g1.detection_list(cf, c, self.config)
            ctl_kept[key] = (frame, c, cf)
            ctl_dets[frame] = (cells[..., 0], cells[..., 1], amp, amp > 0)
        return self.compare(ctl_kept, ctl_dets)

    def compare(self, kept: dict, dets: dict) -> dict:
        rdm_err, flag_bad, det_bad = 0.0, 0, 0
        for key, (frame, rdms, flags) in sorted(kept.items()):
            rdms, flags = rdms.to(self.device), flags.to(self.device)
            ref = self._reference(frame)
            if rdms.shape != ref.shape:
                rdm_err = float("inf")
                continue
            rdm_err = max(rdm_err, float((rdms.double() - ref).abs().max() / ref.max()))
            del ref
            ref_flags, _ = ref_g1.cascade(rdms, self.config)
            flag_bad += int((ref_flags != flags).sum())
            amp, cells = ref_g1.detection_list(flags, rdms, self.config)
            for f, (v, r, a, _) in dets.items():
                if f % self.n == key:
                    det_bad += ref_cfar.detection_mismatches(a, v, r, amp, cells)
        if not kept:
            rdm_err = float("inf")
        return {"rdm_err": (rdm_err, self.config["correct_limits"]["rdm_err"]),
                "flags_differ": (flag_bad, 0), "detections_differ": (det_bad, 0)}
