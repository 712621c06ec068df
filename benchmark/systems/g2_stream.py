"""The G2 stream: ``StreamingPipeline``'s windowed path on the card, fed by
the benchmark's source.

Frame ``k`` (counting on from 0) is distinct frame ``k % N``; its result is
the detection list of the window it completes, ``(k - 1, k)``, pulled to
the host.  The check takes, of each kept window, its RDM stack and flags,
and every window's detection list.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.cost.work import bound_s, cascaded_cfar, rdm_former
from benchmark.drive import to_host
from benchmark.frames import g2_frames
from benchmark.reference import cfar as ref_cfar
from benchmark.reference.common import C_LIGHT, clutter_cells
from benchmark.reference.g2 import slice_starts, window_rdms


def port_profile(config: dict):
    from radar_signal_process_tpu_torch.config import CFARConfig, MTDConfig, RadarProfile

    p = dict(config["profile"])
    p["mtd"] = MTDConfig(**p["mtd"])
    p["cfar"] = CFARConfig(**p["cfar"])
    p["cfar_segments"] = tuple(tuple(s) for s in p["cfar_segments"])
    for k in ("pulse_widths", "chirp_signs", "segment_points"):
        p[k] = tuple(p[k])
    return RadarProfile(name=config["name"].upper(), **p)


def frame_bytes(config: dict) -> int:
    p = config["profile"]
    return p["prt_per_frame"] * p["point_prt"] * p["n_channels"] * 8


def n_clutter(config: dict) -> int:
    prof = config["profile"]
    return clutter_cells(config["stream"]["clutter_v"], C_LIGHT / prof["fc"], 1.0 / prof["prt"],
                         prof["prt_per_frame"])


def renotch_rows(config: dict):
    prof = config["profile"]
    return ref_cfar.renotch_zero_rows(prof["prt_per_frame"], config["stream"]["renotch_divisor"],
                                      n_clutter(config), prof["mtd"]["fftshift"])


def step_bound_s(config: dict, family: str) -> float | None:
    """The least time of one window's calls of ``family``, or None where the
    stream makes none."""
    prof, st = config["profile"], config["stream"]
    n_prt, n_r = prof["prt_per_frame"], prof["point_prt"]
    if family == "b2":
        return bound_s(*rdm_former(prof["n_beams"], n_prt, n_r,
                                   slice_starts(n_prt, st["win_size"])))
    if family == "b1":
        zero = renotch_rows(config)
        notched = 0 if zero is None else zero[1] - zero[0]
        return bound_s(*cascaded_cfar(prof["n_beams"] * st["win_size"], n_prt, n_r,
                                      n_clutter(config), notched))
    return None


class _Reader:
    """The port's reader interface over the benchmark's source: after the
    source stops, an incomplete frame, which ends the producer."""

    def __init__(self, source):
        self.source = source

    def read_frame(self, idx: int):
        from radar_signal_process_tpu_torch.ingest import FrameResult

        res = self.source.read(idx)
        return FrameResult(None, None, False, True, {}) if res is None else res


class Cell:
    def __init__(self, config: dict, n: int, seed: int, device, spans):
        self.config, self.n, self.seed = config, n, seed
        self.device, self.spans = device, spans
        self.profile = port_profile(config)

    def make_frames(self, noise_std: float) -> None:
        self.frames, self.coeffs, self.targets = g2_frames(self.config, self.n, noise_std,
                                                           self.seed, self.device)
        self.angles = np.zeros(self.config["profile"]["prt_per_frame"])

    def frame(self, idx: int):
        """Frame ``idx`` as the port's readers return it, from memory."""
        from radar_signal_process_tpu_torch.ingest import FrameResult

        return FrameResult(self.frames[idx % self.n], self.angles, True, False, {})

    def start(self, source) -> None:
        from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline

        st = self.config["stream"]
        self.pipe = StreamingPipeline(
            _Reader(source), self.profile, win_size=st["win_size"], max_frames=2 ** 31 - 1,
            clutter_v=st["clutter_v"], max_detections=st["max_detections"],
            dbf_coeffs=self.coeffs, emit=st["emit"], device=self.device,
            use_host_parallel=False)

    def results(self):
        """``(frame, done, result, pulled)`` for each window, as its
        detection list reaches the host."""
        it = iter(self.pipe)
        while True:
            with self.spans("next"):
                res = next(it, None)
            if res is None:
                return
            with self.spans("pull"):
                d = res.detections
                dets = tuple(t.to("cpu", non_blocking=True)
                             for t in (d.v_idx, d.r_idx, d.amplitude, d.valid))
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                dets = tuple(t.numpy() for t in dets)
            yield res.frame_idx + 1, time.perf_counter(), res, dets

    def snapshot(self, res):
        """What the check needs of a kept window, on the host."""
        return to_host(res.rdms), to_host(res.flags)

    def counters(self) -> dict:
        return self.pipe.counters.snapshot()

    def release(self) -> None:
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def check(self, kept: dict, pulled: dict) -> dict:
        """Numbers compared, each ``(value, limit)``: the widest gap of the
        kept windows' RDMs from the float64 reference as a share of its peak;
        the flags that differ from the reference cascade on the program's
        RDMs; the detection entries that differ from the reference's lists
        on the program's flags and RDMs, over every window of the run."""
        return self.compare({k: (f, *snap) for k, (f, snap, _) in kept.items()}, pulled)

    def control(self, kept: dict, pulled: dict) -> dict:
        """The numbers of :meth:`check` with the TF32 control in the
        program's place: the reference chain with TF32 operands, its flags
        and detection lists by the reference's cascade and sort."""
        cfg, prof, st = self.config, self.config["profile"], self.config["stream"]
        segments = [tuple(s) for s in prof["cfar_segments"]]
        ctl_kept, ctl_dets = {}, {}
        for key, (frame, _, _) in sorted(kept.items()):
            prev, cur = self.frames[(frame - 1) % self.n], self.frames[frame % self.n]
            c = window_rdms(prev, cur, self.coeffs, cfg, self.device, "tf32")
            cf, _ = ref_cfar.cascade(c, prof["cfar"], n_clutter(cfg), segments, renotch_rows(cfg))
            amp, cells = ref_cfar.detection_list(cf, c, st["max_detections"])
            ctl_kept[key] = (frame, c, cf)
            ctl_dets[frame] = (cells[..., 0], cells[..., 1], amp, amp > 0)
        return self.compare(ctl_kept, ctl_dets)

    def compare(self, kept: dict, dets: dict) -> dict:
        cfg, prof = self.config, self.config["profile"]
        st, lim = cfg["stream"], cfg["correct_limits"]
        zero, n_c = renotch_rows(cfg), n_clutter(cfg)
        segments = [tuple(s) for s in prof["cfar_segments"]]
        rdm_err, flag_bad, det_bad = 0.0, 0, 0
        for key, (frame, rdms, flags) in sorted(kept.items()):
            rdms, flags = rdms.to(self.device), flags.to(self.device)
            prev, cur = self.frames[(frame - 1) % self.n], self.frames[frame % self.n]
            ref = window_rdms(prev, cur, self.coeffs, cfg, self.device)
            rdm_err = max(rdm_err, float((rdms.double() - ref).abs().max() / ref.max()))
            del ref
            ref_flags, _ = ref_cfar.cascade(rdms, prof["cfar"], n_c, segments, zero)
            flag_bad += int((ref_flags != flags).sum())
            amp, cells = ref_cfar.detection_list(flags, rdms, st["max_detections"])
            for f, (v, r, a, _) in dets.items():
                if f % self.n == key:
                    det_bad += ref_cfar.detection_mismatches(a, v, r, amp, cells)
        if not kept:
            rdm_err = float("inf")
        return {"rdm_err": (rdm_err, lim["rdm_err"]),
                "flags_differ": (flag_bad, 0), "detections_differ": (det_bad, 0)}
