"""G0 ``dmx``: ``G0Chain.process_frame`` on the card, as ``cli dmx``
drives it: each frame with its own frequency index and beam position, its
measurements pulled to the host as ``cli dmx`` pulls them.

Frame ``k`` is distinct frame ``k % N``, in the form
``NativeG1FrameReader.read_frame`` returns.  The check takes, of each kept
frame, its RDMs, flags and detection lists, and every frame's pulled
measurements.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.cost.work import bound_s, cascaded_cfar, fused_pc_rdm
from benchmark.drive import to_host
from benchmark.frames import g0_frames
from benchmark.reference import cfar as ref_cfar
from benchmark.reference import g0 as ref_g0
from benchmark.systems.g2_stream import port_profile

KEPT = ("rdm_sum_short", "rdm_sum_long", "rdm_diff_short", "rdm_diff_long", "flags_short",
        "flags_long", "vflags_short", "vflags_long")
DETECTIONS = ("amplitude", "v_idx", "r_idx", "valid")


def frame_bytes(config: dict) -> int:
    p = config["profile"]
    return 2 * p["prt_per_frame"] * p["point_prt"] * 8


def step_bound_s(config: dict, family: str) -> float | None:
    """The least time of one frame's calls of ``family``, or None where the
    chain makes none."""
    prof, chain = config["profile"], config["chain"]
    n_fft, ps = chain["mtd_fft_length"], prof["segment_points"][0]
    widths = (ps, chain["pc_fft_length"])
    if family == "b1":
        # the least over the frequency plan: no frame's bound is counted high
        n_cs = {ref_g0.frame_scalars(config, f, 0)["n_clutter"]
                for f in range(len(config["freq_table_mhz"]))}
        return min(sum(bound_s(*cascaded_cfar(1, n_fft, w, n_c)) for w in widths)
                   for n_c in n_cs)
    if family == "b3":
        n_prt = prof["prt_per_frame"]
        taps = len(config["narrow_pulse_fir_taps"])
        return (bound_s(*fused_pc_rdm(2, n_prt, ps, ps, n_fft, fir_taps=taps))
                + bound_s(*fused_pc_rdm(2, n_prt, prof["point_prt"] - ps, widths[1], n_fft,
                                        pc_fft=widths[1])))
    return None


class Cell:
    def __init__(self, config: dict, n: int, seed: int, device, spans):
        self.config, self.n, self.seed = config, n, seed
        self.device, self.spans = device, spans

    def make_frames(self, noise_std: float) -> None:
        self.left, self.right, self.fi, self.bp, self.targets = g0_frames(
            self.config, self.n, noise_std, self.seed, self.device)
        self.angles = np.zeros(self.left.shape[1])

    def frame(self, idx: int):
        """Frame ``idx`` as ``NativeG1FrameReader.read_frame`` returns it, from memory."""
        j = idx % self.n
        return self.left[j], self.right[j], self.angles, {
            "freq_index": int(self.fi[j]), "beam_pos": int(self.bp[j])}

    def start(self, source) -> None:
        from radar_signal_process_tpu_torch.config import G0ChainConfig
        from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

        cfg = self.config
        self.source = source
        self.chain = G0Chain(port_profile(cfg), G0ChainConfig(**cfg["chain"]),
                             max_detections=cfg["dmx"]["max_detections"],
                             power_norm=cfg["dmx"]["power_norm"], device=self.device)

    def results(self):
        """``(frame, done, result, pulled)`` for each frame, as its
        measurements reach the host."""
        k = 0
        while True:
            frame = self.source.read(k)
            if frame is None:
                return
            left, right, _, meta = frame
            with self.spans("next"):
                res = self.chain.process_frame(left, right, freq_index=meta["freq_index"],
                                               beam_pos=meta["beam_pos"])
            with self.spans("pull"):
                meas = tuple(tuple(t.cpu().numpy() for t in (m.valid, m.range_m, m.velocity_ms,
                                                              m.elevation_deg))
                             for m in (res.measurements_short, res.measurements_long))
            yield k, time.perf_counter(), res, meas
            k += 1

    def snapshot(self, res):
        """What the check needs of a kept frame, on the host."""
        out = {name: to_host(getattr(res, name)) for name in KEPT}
        for part in ("short", "long"):
            det = getattr(res, f"detections_{part}")
            out[f"detections_{part}"] = SimpleNamespace(
                **{name: to_host(getattr(det, name)) for name in DETECTIONS})
        return SimpleNamespace(**out)

    def _on_card(self, res):
        out = {name: getattr(res, name).to(self.device) for name in KEPT}
        for part in ("short", "long"):
            det = getattr(res, f"detections_{part}")
            out[f"detections_{part}"] = SimpleNamespace(
                **{name: getattr(det, name).to(self.device) for name in DETECTIONS})
        return SimpleNamespace(**out)

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.chain = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, kept: dict, pulled: dict) -> dict:
        """Numbers compared, each ``(value, limit)``: the widest gap of the
        sum and difference RDMs from the float64 reference as a share of the
        sum's peak; the flags and velocity flags that differ from the
        reference cascade on the program's sum RDMs; the detection entries
        that differ from the reference's lists; and the measurements of
        every frame of the run that differ from the reference's on the
        program's RDMs and detections."""
        return self.compare({k: self._on_card(snap) for k, (_, snap, _) in kept.items()}, pulled)

    def control(self, kept: dict, pulled: dict) -> dict:
        """The numbers of :meth:`check` with the TF32 control in the
        program's place: the reference's products with TF32 operands, its
        flags, detection lists and measurements by the reference."""
        cfg = self.config
        cfar, k_max = cfg["profile"]["cfar"], cfg["dmx"]["max_detections"]
        scales = ref_g0.range_scales(cfg)
        ctl_kept, ctl_meas = {}, {}
        dev = self.device
        for key in sorted(kept):
            fi, bp = int(self.fi[key]), int(self.bp[key])
            scal = ref_g0.frame_scalars(cfg, fi, bp)
            beams = torch.stack([torch.as_tensor(self.left[key]), torch.as_tensor(self.right[key])])
            parts, m = {}, []
            for name, (s, d), r_scale in zip(("short", "long"), ref_g0.sum_diff(
                    *ref_g0.beam_rdms(beams.to(dev), cfg, "tf32"), scal["n_clutter"]), scales):
                fl, vfl = ref_cfar.cascade(s, cfar, scal["n_clutter"], None)
                amp, cells = ref_cfar.detection_list(fl, s, k_max)
                det = SimpleNamespace(amplitude=torch.as_tensor(amp),
                                      v_idx=torch.as_tensor(cells[..., 0], device=dev),
                                      r_idx=torch.as_tensor(cells[..., 1], device=dev),
                                      valid=torch.as_tensor(amp > 0))
                r, v, e = ref_g0.measurements(s, d, det.v_idx, det.r_idx, r_scale, scal, bp, cfg)
                m.append((det.valid.numpy(),) + tuple(x.cpu().numpy() for x in (r, v, e)))
                parts.update({f"rdm_sum_{name}": s, f"rdm_diff_{name}": d, f"flags_{name}": fl,
                              f"vflags_{name}": vfl, f"detections_{name}": det})
            ctl_kept[key] = SimpleNamespace(**parts)
            ctl_meas[key] = tuple(m)
        return self.compare(ctl_kept, ctl_meas)

    def compare(self, kept: dict, meas: dict) -> dict:
        cfg = self.config
        cfar, k_max = cfg["profile"]["cfar"], cfg["dmx"]["max_detections"]
        scales = ref_g0.range_scales(cfg)
        rdm_err, flag_bad, det_bad, meas_bad = 0.0, 0, 0, 0
        for key, res in sorted(kept.items()):
            fi, bp = int(self.fi[key]), int(self.bp[key])
            scal = ref_g0.frame_scalars(cfg, fi, bp)
            beams = torch.stack([torch.as_tensor(self.left[key]), torch.as_tensor(self.right[key])])
            ref = ref_g0.sum_diff(*ref_g0.beam_rdms(beams.to(self.device), cfg),
                                  scal["n_clutter"])
            progs = ((res.rdm_sum_short, res.rdm_diff_short, res.flags_short, res.vflags_short,
                      res.detections_short, scales[0]),
                     (res.rdm_sum_long, res.rdm_diff_long, res.flags_long, res.vflags_long,
                      res.detections_long, scales[1]))
            expected = []
            for (s, d, fl, vfl, det, r_scale), (rs, rd) in zip(progs, ref):
                peak = rs.max()
                rdm_err = max(rdm_err, float((s.double() - rs).abs().max() / peak),
                              float((d.double() - rd).abs().max() / peak))
                rf, rvf = ref_cfar.cascade(s, cfar, scal["n_clutter"], None)
                flag_bad += int((rf != fl).sum() + (rvf != vfl).sum())
                amp, cells = ref_cfar.detection_list(fl, s, k_max)
                det_bad += ref_cfar.detection_mismatches(
                    det.amplitude.cpu().numpy(), det.v_idx.cpu().numpy(),
                    det.r_idx.cpu().numpy(), amp, cells)
                r, v, e = ref_g0.measurements(s, d, det.v_idx, det.r_idx, r_scale, scal, bp, cfg)
                expected.append((det.valid.cpu().numpy(),) + tuple(x.cpu().numpy()
                                                                   for x in (r, v, e)))
            for k, m in meas.items():
                if k % self.n == key:
                    for got, want in zip(m, expected):
                        valid = want[0]
                        meas_bad += int((got[0] != valid).sum())
                        meas_bad += sum(int((g[valid] != w[valid]).sum())
                                        for g, w in zip(got[1:], want[1:]))
        if not kept:
            rdm_err = float("inf")
        lim = cfg["correct_limits"]
        return {"rdm_err": (rdm_err, lim["rdm_err"]), "flags_differ": (flag_bad, 0),
                "detections_differ": (det_bad, 0), "measurements_differ": (meas_bad, 0)}
