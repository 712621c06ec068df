"""Command-line entry point of the port.

Each subcommand reads and writes the files, and prints what the same
subcommand of ``radar_signal_process_tpu.cli`` prints; the chains run on
``--device`` (default ``cuda``):

* ``simulate`` writes a synthetic G2 capture: a moving target in seeded
  clutter at a given SCR (reference S1-S3 as a tool);
* ``ingest``, ``mtd``, ``detect`` and ``analyze`` are the reference's
  stage-by-stage file bus (``bin_to_mat_xzr.m`` ->
  ``main_produce_dataset_win_xzr_v2.m`` -> ``main_cfar.m``): per-frame
  ``.npz`` manifests with the profile embedded (``utils.manifest``) or the
  reference's MATLAB ``.mat`` variables (``utils.matbus``); every stage is
  frame-keyed and skips frames already written unless ``--force``.
  ``ingest`` parses a capture (and beamforms it with ``--dbf-coeffs``),
  ``mtd`` forms the windowed RDMs of each frame pair
  (``models.host_parallel.make_stream_processor``, B2), ``detect`` runs
  the re-notch and B1 once per frame, or once per threshold per frame with
  ``--thresholds``, ``analyze`` renders an RDM dashboard and animations;
* ``e2e`` runs the in-memory chain over a G2 capture: frame pairs through
  the frame processor (B2) and the detector (B1), detections of every
  (beam, slice) as JSON;
* ``stream`` runs :class:`models.streaming.StreamingPipeline` over a G2
  capture: per window its latency, CFAR hits and detections per beam, then
  the pipeline counters;
* ``dmx`` runs :class:`models.g0_chain.G0Chain` over a G1-format dual-beam
  capture, per-frame measurements, optionally against a GPS track, with
  estimate plots and a ``resultData_<clock>.mat``;
* ``sweep`` runs the threshold x SCR sweep (``evalx.sweep``) and prints its
  table and the metrics as JSON.

``e2e --mesh DPxSP`` and ``stream --mesh DPxSP`` run over a ``(dp, sp)``
mesh of ranks (``parallel``): start one process per rank with ``python -m
torch.distributed.run --nproc_per_node N -m radar_signal_process_tpu_torch.cli
...`` (NCCL on the card, one GPU per rank; gloo with ``--device cpu``), or
run ``--mesh 1x1`` in a plain process.  ``dp * sp`` must be the number of
ranks; only rank 0 prints, and every rank leaves on exit the process group
the command formed (a group its caller formed stays up).
``e2e --beam`` is accepted and, as on the JAX package's device path,
unused; ``e2e --win-slice`` selects the slice that ``--mesh`` runs.

``mtd`` and ``detect`` take the JAX CLI's CPU routes on both devices
(``models.host_parallel``): ``mtd`` compresses each frame once and reuses it
for both windows it feeds (``make_stream_processor``), ``detect`` runs
``make_flags`` and then the extraction.  ``stream --device cpu`` runs blocks
of ``--block-windows`` windows; on ``--device cuda`` it keeps the windowed
path, as the JAX package does off the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import PROFILES
from radar_signal_process_tpu_torch.utils import (
    StageTimers,
    frame_exists,
    get_logger,
    load_frame,
    save_frame,
)

log = get_logger("radar_signal_process_tpu_torch.cli")


def _stage_exists(directory: str, frame_idx: int, fmt: str) -> bool:
    """Frame-keyed idempotence check for either artifact format."""
    from radar_signal_process_tpu_torch.utils import matbus

    if fmt == "mat":
        return matbus.mat_frame_exists(directory, frame_idx)
    return frame_exists(directory, frame_idx)


def _load_stage1(directory: str, frame_idx: int, profile):
    """Load a stage-1 frame from either the ``.npz`` manifest or the
    reference's MATLAB ``frame_N.mat`` bus (``bin_to_mat_xzr.m:66``)."""
    from radar_signal_process_tpu_torch.utils import matbus
    from radar_signal_process_tpu_torch.utils.manifest import frame_path

    if os.path.exists(frame_path(directory, frame_idx)):
        return load_frame(directory, frame_idx)
    if matbus.mat_frame_exists(directory, frame_idx):
        iq, servo = matbus.load_frame_mat(matbus.mat_frame_path(directory, frame_idx))
        return {"iq": iq, "servo_angle": servo}, profile, {"format": "mat"}
    raise FileNotFoundError(frame_path(directory, frame_idx))


def _load_rdms(directory: str, frame_idx: int, profile):
    """Load stage-2 RDMs (beam, win, v, r) from ``.npz`` or MATLAB form."""
    from radar_signal_process_tpu_torch.utils import matbus
    from radar_signal_process_tpu_torch.utils.manifest import frame_path

    if os.path.exists(frame_path(directory, frame_idx)):
        arrays, prof, meta = load_frame(directory, frame_idx)
        return arrays["rdm"], prof, meta
    if matbus.mat_frame_exists(directory, frame_idx):
        rdm = matbus.load_mtd_mat(matbus.mat_frame_path(directory, frame_idx))
        return rdm, profile, {"format": "mat"}
    raise FileNotFoundError(frame_path(directory, frame_idx))


def _parse_match_waveforms(args, profile):
    """``--match-waveform SEG=PATH[:VAR]`` specs -> pulses tuple (or None).

    The measured matched-filter hook (``fun_MTD_produce.m:72-78`` /
    ``temp.m:50-56``), shared by the mtd and stream commands.
    """
    if not getattr(args, "match_waveform", None):
        return None
    from radar_signal_process_tpu_torch.ops.waveforms import (
        load_measured_pulse,
        pulses_with_overrides,
    )

    overrides = {}
    for spec in args.match_waveform:
        seg_s, _, rest = spec.partition("=")
        if not rest:
            raise SystemExit(
                f"--match-waveform needs SEG=PATH[:VAR], got {spec!r}"
            )
        path, _, var = rest.partition(":")
        overrides[int(seg_s)] = load_measured_pulse(path, var or None)
    return pulses_with_overrides(profile, overrides)


def _istc_profile(args, profile):
    """``--istc CURVE_TXT``: the loaded dB curve and the profile with the
    iSTC hook switched on (``fun_iSTC.m:6-15``), or ``(None, profile)``."""
    if not getattr(args, "istc", None):
        return None, profile
    from radar_signal_process_tpu_torch.utils.dataset import load_stc_curve

    curve = load_stc_curve(args.istc)
    return curve, dataclasses.replace(
        profile, mtd=dataclasses.replace(profile.mtd, istc=True))


def _frame_to_device(iq: np.ndarray, device: torch.device) -> torch.Tensor:
    """(prt, samples, channels-or-beams) host frame -> (beams, prt, samples)
    complex64 on ``device``."""
    cur = torch.from_numpy(np.asarray(iq, dtype=np.complex64)).to(device)
    return cur.permute(2, 0, 1).contiguous()


def _last(timers: StageTimers) -> dict:
    """Seconds of the latest record of every stage."""
    return {k: v[-1] for k, v in timers.records.items()}


def cmd_simulate(args, on_result: Optional[Callable] = None) -> int:
    """Synthetic G2 capture: the target echo at ``--scr`` in seeded clutter,
    quantised to int16-scale DDC samples, the same echo in every channel
    with a per-channel phase ramp.  The bytes equal the JAX package's."""
    from radar_signal_process_tpu_torch.sim import (
        add_clutter,
        apply_scr,
        synthesize_target_echo,
        synthetic_clutter,
        write_g2_capture,
    )

    profile = PROFILES[args.profile]
    n = profile.prt_per_frame
    frames = np.zeros(
        (args.frames, n, profile.point_prt, profile.n_channels), dtype=np.complex128
    )
    target = synthesize_target_echo(
        profile, args.velocity, args.range, n_pulses=args.frames * n
    )
    clutter = synthetic_clutter(profile, n_pulses=args.frames * n, seed=args.seed)
    echo = add_clutter(apply_scr(target, clutter, args.scr, profile), clutter)
    scale = 3000.0 / (np.abs(echo).max() + 1e-30)
    phases = np.exp(1j * 2 * np.pi * np.arange(profile.n_channels) / 64.0)
    for f in range(args.frames):
        block = echo[f * n : (f + 1) * n] * scale
        frames[f] = np.round(block[..., None].real * phases.real
                             - block[..., None].imag * phases.imag) + 1j * np.round(
            block[..., None].real * phases.imag + block[..., None].imag * phases.real
        )
    write_g2_capture(args.output, frames, profile, data_type=1,
                     file_sizes=[args.file_bytes] * 1000 if args.file_bytes else None)
    log.info("wrote %d synthetic frames to %s", args.frames, args.output)
    return 0


# ------------------------------------------------------------------ stage 1
def _ingest_g1(args, profile, on_result: Optional[Callable] = None) -> int:
    """G1/G0 stage 1: 24-bit packed dual-beam capture -> per-frame artifacts.

    The reference's G1 stage-1 script (``MatlabProcess_xuzerui/
    bin_to_mat_xzr.m:14-22``) loops frames through ``frameDataRead_A`` and
    saves ``echoData_Frame_0/1`` + ``angleCodeSeries`` per frame; there is
    no mid-frame retry (EOF simply ends the run).
    """
    from radar_signal_process_tpu_torch.ingest import g1_reader_class
    from radar_signal_process_tpu_torch.utils import Counters, matbus

    reader_cls = g1_reader_class(args.native)
    reader = reader_cls(
        args.input, prt_num=profile.prt_per_frame, point_prt=profile.point_prt,
        frames_per_file=args.frames_per_file,
    )
    log.info("ingest using %s", reader_cls.__name__)
    counters = Counters()
    timers = StageTimers()
    for out_idx in range(args.frames):
        if _stage_exists(args.output, out_idx, args.format) and not args.force:
            continue
        try:
            # artifact index is 0-based; the packet reader is 1-based
            with timers.stage("read"):
                left, right, angles, meta = reader.read_frame(out_idx + 1)
        except (OSError, EOFError) as e:
            # a missing next file or a truncated frame ends the capture: the
            # Python reader raises FileNotFoundError/EOFError, the native
            # one IOError with the C return code (-1 open, -2 short read)
            log.info("end of stream at frame %d (%s)", out_idx, e)
            break
        with timers.stage("write"):
            if args.format == "mat":
                matbus.save_g1_frame_mat(
                    matbus.mat_frame_path(args.output, out_idx), left, right, angles
                )
            else:
                iq = np.stack([left, right], axis=-1)  # (prt, sample, beam)
                save_frame(
                    args.output, out_idx,
                    {"iq": iq, "servo_angle": angles},
                    profile, meta={"dbf": False, **{k: int(v) for k, v in meta.items()}},
                )
        if args.debug_plots:
            # Show_Read-style I/Q view (Show_Read.m:127-136), one static
            # panel per ingested frame
            from radar_signal_process_tpu_torch.viz import plot_iq_debug

            os.makedirs(args.debug_plots, exist_ok=True)
            plot_iq_debug(
                left, right, prt_index=0, frame_index=out_idx,
                save_path=os.path.join(args.debug_plots, f"iq_frame_{out_idx}.png"),
            )
        counters.add("frames")
        counters.add("prts", profile.prt_per_frame)
        if on_result is not None:
            on_result(out_idx, {"left": left, "right": right}, _last(timers))
    log.info("ingest done: %s\n%s", counters, timers.report())
    return 0


def cmd_ingest(args, on_result: Optional[Callable] = None) -> int:
    """Stage 1 (``bin_to_mat_xzr.m``): ``.bin`` capture -> per-frame
    artifacts, beamformed on ``--device`` with ``--dbf-coeffs``.
    ``on_result`` (if given) sees ``(frame_idx, {"iq": array}, seconds)``
    for every frame written, ``seconds`` the wall time of its read, DBF and
    write stages."""
    from radar_signal_process_tpu_torch.device import resolve_device
    from radar_signal_process_tpu_torch.ingest import g2_reader_class
    from radar_signal_process_tpu_torch.ops.dbf import apply_dbf, load_dbf_coeffs
    from radar_signal_process_tpu_torch.utils import Counters, matbus

    profile = PROFILES[args.profile]
    if profile.bytes_head != 64:
        # G1/G0 captures are the 24-bit packed dual-beam format; the G2
        # packet parser would misread them
        return _ingest_g1(args, profile, on_result)
    reader_cls = g2_reader_class(args.native)
    reader = reader_cls(args.input, profile)
    log.info("ingest using %s", reader_cls.__name__)

    coeffs = None
    if args.dbf_coeffs:
        device = resolve_device(args.device)
        coeffs = torch.as_tensor(
            load_dbf_coeffs(args.dbf_coeffs, profile.n_channels).astype(np.complex64),
            device=device)
    timers = StageTimers(coeffs.device if coeffs is not None else "cpu")
    counters = Counters()
    frame_idx, retries = 0, 0
    while frame_idx < args.frames:
        if _stage_exists(args.output, frame_idx, args.format) and not args.force:
            frame_idx += 1
            continue
        with timers.stage("read"):
            res = reader.read_frame(frame_idx)
        if res.frame_completed:
            iq = res.iq
            if coeffs is not None:
                with timers.stage("dbf"), torch.inference_mode():
                    x = torch.from_numpy(np.asarray(iq, dtype=np.complex64)).to(coeffs.device)
                    iq = apply_dbf(x, coeffs).cpu().numpy()
            with timers.stage("write"):
                if args.format == "mat":
                    matbus.save_frame_mat(
                        matbus.mat_frame_path(args.output, frame_idx), iq, res.servo_angle,
                    )
                else:
                    save_frame(
                        args.output, frame_idx,
                        {"iq": iq, "servo_angle": res.servo_angle},
                        profile, meta={"dbf": coeffs is not None},
                    )
            counters.add("frames")
            counters.add("prts", profile.prt_per_frame)
            if on_result is not None:
                on_result(frame_idx, {"iq": iq}, _last(timers))
            frame_idx += 1
            retries = 0
        else:
            if res.eos:
                log.info("end of stream at frame %d", frame_idx)
                break
            retries += 1
            counters.add("retries")
            if retries > args.max_retries:  # bin_to_mat_xzr.m:81-84
                log.error("frame %d failed %d retries; aborting", frame_idx, retries)
                return 1
    log.info("ingest done: %s\n%s", counters, timers.report())
    return 0


# ------------------------------------------------------------------ stage 2
def cmd_mtd(args, on_result: Optional[Callable] = None) -> int:
    """Stage 2 (``main_produce_dataset_win_xzr_v2.m``): each frame pair of a
    stage-1 directory (npz or mat) -> the windowed RDM stack, one B2 launch
    on ``--device`` (``make_stream_processor``: each frame compressed once
    and reused for both pairs it feeds, as the JAX CLI's CPU route).
    ``on_result`` (if
    given) sees ``(frame_idx, {"rdm": tensor}, seconds)`` for every frame
    written, ``seconds`` the wall time of its load, device (upload, mtd,
    download) and save stages."""
    from radar_signal_process_tpu_torch.device import resolve_device
    from radar_signal_process_tpu_torch.models.host_parallel import make_stream_processor
    from radar_signal_process_tpu_torch.utils import matbus

    device = resolve_device(args.device)
    stc_curve, profile = _istc_profile(args, PROFILES[args.profile])
    # each frame compressed once over consecutive frame pairs
    process = make_stream_processor(
        profile, win_size=args.win_size, stc_curve_db=stc_curve,
        pulses=_parse_match_waveforms(args, profile), device=device,
    )
    timers = StageTimers(device)
    done = 0
    with torch.inference_mode():
        for frame_idx in range(args.frames):
            if _stage_exists(args.output, frame_idx, args.format) and not args.force:
                done += 1
                continue
            try:
                with timers.stage("load"):
                    now, _, _ = _load_stage1(args.input, frame_idx, profile)
                    nxt, _, _ = _load_stage1(args.input, frame_idx + 1, profile)
            except FileNotFoundError:
                log.warning("frames %d/%d unavailable; stopping", frame_idx, frame_idx + 1)
                break
            with timers.stage("mtd"):
                rdms = process(_frame_to_device(now["iq"], device),
                               _frame_to_device(nxt["iq"], device), frame_idx=frame_idx)
                host = rdms.cpu().numpy()
            with timers.stage("save"):
                if args.format == "mat":
                    matbus.save_mtd_mat(
                        matbus.mat_frame_path(args.output, frame_idx), host,
                        # the G1 two-beam stage saves MTD_0/MTD_1 variables
                        two_beam_vars=profile.bytes_head != 64 and host.shape[0] == 2,
                    )
                else:
                    save_frame(
                        args.output, frame_idx,
                        {"rdm": host, "servo_angle": now["servo_angle"]},
                        profile,
                        meta={"win_size": args.win_size, "istc": stc_curve is not None},
                    )
            done += 1
            if on_result is not None:
                on_result(frame_idx, {"rdm": rdms}, _last(timers))
    log.info("mtd done (%d frames, %s)\n%s", done, device, timers.report())
    return 0


# ------------------------------------------------------------------ stage 3
def _detection_arrays(flags, vflags, dets, det_width=None) -> dict:
    """A frame's stage-3 outputs on the host, under the manifest's names."""
    arrays = {
        "flags": flags.cpu().numpy(),
        "vflags": vflags.cpu().numpy(),
        "det_v": dets.v_idx.cpu().numpy(),
        "det_r": dets.r_idx.cpu().numpy(),
        "det_amp": dets.amplitude.cpu().numpy(),
        "det_valid": dets.valid.cpu().numpy(),
    }
    if det_width is not None:
        arrays["det_width"] = det_width.cpu().numpy()
    return arrays


def _save_detections(directory, frame_idx, fmt, profile, arrays, meta) -> None:
    """The npz manifest, or the reference's ``cfarFlag_win_*`` variables."""
    from radar_signal_process_tpu_torch.utils import matbus

    if fmt == "mat":
        matbus.save_cfar_mat(matbus.mat_frame_path(directory, frame_idx), arrays["flags"])
    else:
        save_frame(directory, frame_idx, arrays, profile, meta=meta)


def _rdms_to_device(rdm_arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rdm_arr, dtype=np.float32)).to(device)


def _detect_sweep(args, profile, device, on_result: Optional[Callable] = None) -> int:
    """Stage-3 threshold sweep over the file bus (``main_cfar.m:40``).

    The reference loops ``for T=[...]`` over the loaded stage-2 frames and
    writes one ``cfarFlag{win}_T{T}`` directory per threshold.  Each frame
    is re-notched once, then B1 runs once per threshold on it (B1 takes the
    threshold at run time, so every threshold shares one launch plan).
    """
    from radar_signal_process_tpu_torch.device import REAL
    from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d
    from radar_signal_process_tpu_torch.models.detect import (
        RENOTCH_DIVISOR,
        clutter_cells,
        renotch_mask,
    )
    from radar_signal_process_tpu_torch.ops.measure import extract_detections
    from radar_signal_process_tpu_torch.utils import matbus

    thresholds = [float(t) for t in args.thresholds]

    def t_name(t: float) -> str:
        return str(int(t)) if float(t).is_integer() else str(t)

    def out_dir(t: float, win_size: int) -> str:
        if args.format == "mat":
            # the reference's exact cfarFlag{win}_T{T} directory contract
            return matbus.cfar_dir(args.output, win_size, t)
        return f"{args.output}_T{t_name(t)}"

    timers = StageTimers(device)
    n_clutter = keep = segments = None
    done = 0
    with torch.inference_mode():
        for frame_idx in range(args.frames):
            try:
                with timers.stage("load"):
                    rdm_arr, _, _ = _load_rdms(args.input, frame_idx, profile)
            except FileNotFoundError:
                break
            win_size = rdm_arr.shape[-3] if rdm_arr.ndim >= 3 else 1
            if all(_stage_exists(out_dir(t, win_size), frame_idx, args.format)
                   for t in thresholds) and not args.force:
                done += 1
                continue
            if n_clutter is None:
                n_v, n_r = rdm_arr.shape[-2:]
                n_clutter = clutter_cells(profile, n_v, args.clutter_v)
                segments = profile.cfar_segments or ((0, n_r),)
                mask = renotch_mask(profile, n_v, n_clutter, RENOTCH_DIVISOR)
                keep = torch.as_tensor(mask, dtype=REAL, device=device)[:, None]
            out = {}
            with timers.stage("cfar_sweep"):
                rdms = _rdms_to_device(rdm_arr, device)
                rn = rdms * keep
                for t in thresholds:
                    cfg = dataclasses.replace(profile.cfar, threshold=t)
                    flags, vflags = cascaded_cfar2d(rn, cfg, n_clutter, segments)
                    out[t] = _detection_arrays(
                        flags, vflags, extract_detections(flags, rdms, args.max_detections))
            with timers.stage("save"):
                for t, arrays in out.items():
                    _save_detections(out_dir(t, win_size), frame_idx, args.format, profile,
                                     arrays, meta={"threshold": t})
            done += 1
            if on_result is not None:
                on_result(frame_idx, out, _last(timers))
    log.info("detect sweep done (%d frames x %d thresholds, %s)\n%s",
             done, len(thresholds), device, timers.report())
    return 0


def cmd_detect(args, on_result: Optional[Callable] = None) -> int:
    """Stage 3 (``main_cfar.m``): each frame's RDM stack (npz or mat) ->
    the re-notch, B1 and the detection list on ``--device``: ``make_flags``
    (one B1 launch per frame, or one per threshold with ``--thresholds``)
    and then the extraction, as the JAX CLI's CPU route.
    ``on_result`` (if given) sees ``(frame_idx, arrays, seconds)`` for
    every frame written: ``arrays`` the frame's host arrays under the
    manifest's names (sweep: ``{threshold: arrays}``), ``seconds`` the wall
    time of its load, device (upload, CFAR, download) and save stages."""
    from radar_signal_process_tpu_torch.device import resolve_device
    from radar_signal_process_tpu_torch.models.detect import clutter_cells
    from radar_signal_process_tpu_torch.models.host_parallel import make_flags
    from radar_signal_process_tpu_torch.ops.measure import extract_detections
    from radar_signal_process_tpu_torch.ops.spectrum import detection_spectral_widths

    profile = PROFILES[args.profile]
    device = resolve_device(args.device)
    if args.thresholds:
        return _detect_sweep(args, profile, device, on_result)
    if args.spectral_width_db is not None and args.format == "mat":
        log.warning(
            "--format mat writes only the reference's cfarFlag variables; "
            "per-detection spectral widths are not computed or persisted "
            "(use the npz format)"
        )
    flags_fn = None
    timers = StageTimers(device)
    done = 0
    with torch.inference_mode():
        for frame_idx in range(args.frames):
            if _stage_exists(args.output, frame_idx, args.format) and not args.force:
                done += 1
                continue
            try:
                with timers.stage("load"):
                    rdm_arr, _, _ = _load_rdms(args.input, frame_idx, profile)
            except FileNotFoundError:
                break
            if flags_fn is None:
                flags_fn = make_flags(
                    profile, clutter_cells(profile, rdm_arr.shape[-2], args.clutter_v),
                    cfg=dataclasses.replace(profile.cfar, threshold=args.threshold),
                    device=device,
                )
            with timers.stage("cfar"):
                rdms = _rdms_to_device(rdm_arr, device)
                flags, vflags = flags_fn(rdms)
                dets = extract_detections(flags, rdms, args.max_detections)
                det_width = None
                if args.spectral_width_db is not None and args.format != "mat":
                    det_width = detection_spectral_widths(
                        rdms, dets.r_idx, args.spectral_width_db,
                        shifted_input=profile.mtd.fftshift,
                        interp=args.spectral_width_interp > 1,
                        interp_times=max(args.spectral_width_interp, 1),
                    )
                arrays = _detection_arrays(flags, vflags, dets, det_width)
            with timers.stage("save"):
                _save_detections(args.output, frame_idx, args.format, profile, arrays,
                                 meta={"threshold": args.threshold})
            done += 1
            if on_result is not None:
                on_result(frame_idx, arrays, _last(timers))
    log.info("detect done (%d frames, %s)\n%s", done, device, timers.report())
    return 0


def cmd_analyze(args, on_result: Optional[Callable] = None) -> int:
    """Reload a stage-2 RDM artifact and render its dashboard (reference V3),
    with ``--animate`` the reference's V1 animations.

    Unlike ``analyze_and_plot_mtd_results.m`` — which must re-declare the
    radar parameters because the reference never stored them — the profile
    is recovered from the artifact itself.  ``--animate pc`` recomputes the
    pulse compression of the stage-1 frame on ``--device``.
    """
    from radar_signal_process_tpu_torch.viz import plot_mtd_dashboard

    os.makedirs(args.output, exist_ok=True)
    rdm, profile, meta = _load_rdms(args.input, args.frame, PROFILES[args.profile])
    rdm = np.asarray(rdm)
    if rdm.ndim == 4:
        rdm = rdm[args.beam, args.win_slice]
    outputs = [plot_mtd_dashboard(
        rdm, profile,
        save_path=os.path.join(
            args.output, f"frame_{args.frame}_b{args.beam}_s{args.win_slice}.png"
        ),
    )]
    if args.animate in ("doppler", "all"):
        # reference V1 mode 2: per-range-bin Doppler spectrum animation
        # (MTD/fun_plot_visualizations.m:51-63)
        from radar_signal_process_tpu_torch.viz import plot_doppler_animation

        outputs.append(plot_doppler_animation(
            rdm, profile.velocity_axis(rdm.shape[-2]),
            save_path=os.path.join(args.output, "doppler_anim.gif"),
            step=args.animate_step, max_frames=args.animate_frames,
        ))
    if args.animate in ("pc", "all"):
        # reference V1 mode 1: per-PRT compressed-pulse animation
        # (MTD/fun_plot_visualizations.m:33-49), recomputed from the
        # stage-1 artifact the RDM was produced from
        if not args.stage1_input:
            raise SystemExit("--animate pc needs --stage1-input DIR")
        from radar_signal_process_tpu_torch.device import resolve_device
        from radar_signal_process_tpu_torch.ops.pulse_compression import (
            segmented_pulse_compression,
        )
        from radar_signal_process_tpu_torch.params import cpi_params
        from radar_signal_process_tpu_torch.viz import plot_pc_animation

        device = resolve_device(args.device)
        arrays, _, _ = _load_stage1(args.stage1_input, args.frame, profile)
        echo = np.moveaxis(arrays["iq"], -1, 0)[args.beam]
        params = cpi_params(profile, profile.prt_per_frame, device)
        with torch.inference_mode():
            pc = segmented_pulse_compression(
                torch.from_numpy(np.ascontiguousarray(echo, dtype=np.complex64)).to(device),
                profile, params.pc_spectra, params.pc_filter_lens,
            ).cpu().numpy()
        outputs.append(plot_pc_animation(
            pc, save_path=os.path.join(args.output, "pc_anim.gif"),
            step=args.animate_step, max_frames=args.animate_frames,
        ))
    log.info("wrote %s (profile %s, meta %s)", outputs, profile.name, meta)
    for o in outputs:
        print(o)
    return 0


# ----------------------------------------------------------- in-memory chains
def _det_rows(dets, win_slice: int | None = None) -> list:
    """Batched (beam, slice) DetectionList -> ``[beam, win, v, r, amp]`` rows;
    with ``win_slice`` the list is batched over beams only, all of that slice."""
    valid, v_idx, r_idx, amp = (
        x.cpu().numpy() if win_slice is None else x.cpu().numpy()[:, None]
        for x in (dets.valid, dets.v_idx, dets.r_idx, dets.amplitude))
    return [
        [int(b), int(w if win_slice is None else win_slice), int(v), int(r), float(a)]
        for b, w in np.ndindex(*valid.shape[:2])
        for v, r, a in zip(v_idx[b, w][valid[b, w]], r_idx[b, w][valid[b, w]],
                           amp[b, w][valid[b, w]])
    ]


@contextlib.contextmanager
def _mesh_of(args, device: torch.device):
    """``--mesh DPxSP``: the (dp, sp) mesh over this command's ranks, or
    ``None`` without it.  A process group formed here is left on exit; one
    the caller formed stays up."""
    if not getattr(args, "mesh", None):
        yield None
        return
    import torch.distributed as dist

    from radar_signal_process_tpu_torch.parallel import make_mesh
    from radar_signal_process_tpu_torch.parallel.multihost import initialize_distributed

    dp, sp = (int(x) for x in args.mesh.lower().split("x"))
    formed = not dist.is_initialized()
    initialize_distributed(device.type)
    try:
        yield make_mesh(("dp", "sp"), (dp, sp), device.type)
    finally:
        if formed:
            dist.destroy_process_group()


def _is_root() -> bool:
    """Rank 0 of the process group, or a process without one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def cmd_e2e(args, on_result: Optional[Callable] = None) -> int:
    """Fused in-memory chain: ``.bin`` capture -> detections of every
    (beam, slice) of every frame pair, as the reference's stage 3 does
    (``main_cfar.m:85-96``), no file bus.  ``on_result`` (if given) sees
    ``(frame, rdms, flags, dets, seconds)`` for every window, ``seconds``
    being the window's "mtd+cfar" stage time (``utils.StageTimers``: on the
    card it ends in a synchronize)."""
    from radar_signal_process_tpu_torch.device import resolve_device
    from radar_signal_process_tpu_torch.ingest import g2_reader_class
    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.models.mtd_pipeline import make_frame_processor

    profile = PROFILES[args.profile]
    device = resolve_device(args.device)
    if args.mesh:
        with _mesh_of(args, device) as mesh:
            return _e2e_mesh(args, profile, device, mesh, on_result)
    reader = g2_reader_class(args.native)(args.input, profile)
    process = make_frame_processor(profile, win_size=args.win_size, device=device)
    detector = make_detector(profile, clutter_v=args.clutter_v,
                             max_detections=args.max_detections, device=device)
    timers = StageTimers(device)
    prev = None
    results = []
    with torch.inference_mode():
        for frame_idx in range(args.frames + 1):
            with timers.stage("read"):
                res = reader.read_frame(frame_idx)
            if not res.frame_completed:
                break
            cur = _frame_to_device(res.iq, device)
            if prev is not None:
                with timers.stage("mtd+cfar"):
                    rdms = process(prev, cur)
                    flags, _, dets = detector(rdms)
                results.append({"frame": frame_idx - 1, "detections": _det_rows(dets)})
                if on_result is not None:
                    on_result(frame_idx - 1, rdms, flags, dets,
                              timers.records["mtd+cfar"][-1])
            prev = cur
    print(json.dumps({"frames": results}))
    log.info("e2e timing (%s)\n%s", device, timers.report())
    return 0


def _e2e_mesh(args, profile, device, mesh, on_result: Optional[Callable] = None) -> int:
    """``e2e --mesh``: slice ``--win-slice`` of every window over the mesh
    (``parallel.make_sharded_pipeline``): the capture's channel rows padded
    by ``(-profile.n_beams) % dp`` zero rows, split over dp,
    PRT-sharded then range-sharded over sp, the halo CFAR after the
    divisor-20 re-notch; rank 0 gathers the RDMs and flags and prints rows
    ``[:profile.n_beams]``, as the JAX ``e2e --mesh`` does (ROADMAP C11:
    it counts the profile's beams on a capture of channels).  Rows that
    the padding leaves unsplit over dp raise, where the JAX shard fails.
    ``on_result`` (rank 0) sees ``(frame, rdm, flags, dets, seconds)``, the
    stacks (rows, n_prt, n_points)."""
    from radar_signal_process_tpu_torch.ingest import g2_reader_class
    from radar_signal_process_tpu_torch.models.detect import RENOTCH_DIVISOR, clutter_cells
    from radar_signal_process_tpu_torch.models.mtd_pipeline import window_slice_starts
    from radar_signal_process_tpu_torch.ops.measure import extract_detections
    from radar_signal_process_tpu_torch.parallel.mesh import axis_index, axis_size
    from radar_signal_process_tpu_torch.parallel.sharding import (
        gather_blocks,
        local_block,
        make_sharded_pipeline,
    )

    reader = g2_reader_class(args.native)(args.input, profile)
    n_prt = profile.prt_per_frame
    run = make_sharded_pipeline(
        profile, mesh, n_clutter=clutter_cells(profile, n_prt, args.clutter_v),
        renotch_divisor=RENOTCH_DIVISOR)
    start = window_slice_starts(n_prt, args.win_size)[args.win_slice]
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    if n_prt % sp:
        raise ValueError(f"{n_prt} PRTs do not split over sp={sp}")
    pad = (-profile.n_beams) % dp
    if (profile.n_channels + pad) % dp:
        raise ValueError(
            f"{profile.n_channels} channel rows + {pad} padding rows (to the profile's "
            f"{profile.n_beams} beams) do not split over dp={dp}")
    # this rank's rows [r0, r1) of the doubled CPI (prev ++ cur)
    r0 = start + axis_index(mesh, "sp") * (n_prt // sp)
    r1 = r0 + n_prt // sp
    timers = StageTimers(device)
    prev = None
    results = []
    with torch.inference_mode():
        for frame_idx in range(args.frames + 1):
            with timers.stage("read"):
                res = reader.read_frame(frame_idx)
            if not res.frame_completed:
                break
            cur = torch.from_numpy(np.asarray(res.iq, dtype=np.complex64)).permute(2, 0, 1)
            if prev is not None:
                with timers.stage("h2d"):
                    # the block is cut on the host, so each rank copies its
                    # own rows and beams only
                    echo = torch.cat([prev[:, min(r0, n_prt) : min(r1, n_prt)],
                                      cur[:, max(r0, n_prt) - n_prt : max(r1, n_prt) - n_prt]],
                                     dim=1)
                    if pad:
                        echo = torch.cat([echo, echo.new_zeros((pad,) + tuple(echo.shape[1:]))])
                    x = local_block(echo, mesh, ("dp", None, None)).contiguous().to(device)
                with timers.stage("mtd+cfar"):
                    rdm, flags, _ = run(x)
                    spec = ("dp", None, "sp")
                    rdm, flags = gather_blocks(rdm, mesh, spec), gather_blocks(flags, mesh, spec)
                    if rdm is not None:
                        rdm, flags = rdm[: profile.n_beams], flags[: profile.n_beams]
                        dets = extract_detections(flags, rdm, args.max_detections)
                if rdm is not None:
                    results.append({"frame": frame_idx - 1,
                                    "detections": _det_rows(dets, args.win_slice)})
                    if on_result is not None:
                        on_result(frame_idx - 1, rdm, flags, dets,
                                  timers.records["mtd+cfar"][-1])
            prev = cur
    if _is_root():
        print(json.dumps({"frames": results}))
    log.info("e2e --mesh %s timing (%s)\n%s", args.mesh, device, timers.report())
    return 0


def cmd_sweep(args, on_result: Optional[Callable] = None) -> int:
    """Threshold x SCR sweep with the S4 detection metrics (``main_cfar``'s
    ``for T=[5]`` loop generalised)."""
    from radar_signal_process_tpu_torch.evalx.sweep import format_sweep, sweep_thresholds

    results = sweep_thresholds(
        PROFILES[args.profile],
        thresholds=args.thresholds,
        scr_db=args.scr,
        velocity_ms=args.velocity,
        range_m=args.range,
        n_frames=args.frames,
        clutter_v=args.clutter_v,
        device=args.device,
    )
    print(format_sweep(results))

    def clean(m):
        return {k: (None if v != v else v) for k, v in m.items()}

    print(json.dumps({f"{scr}/{t}": clean(m) for (scr, t), m in results.items()}))
    if on_result is not None:
        on_result(results)
    return 0


def cmd_stream(args, on_result: Optional[Callable] = None) -> int:
    """Streaming chain: overlapped host ingest + device compute, all-beam
    detection.  ``on_result`` (if given) sees every ``StreamResult``."""
    from radar_signal_process_tpu_torch.device import resolve_device
    from radar_signal_process_tpu_torch.ingest import g2_reader_class
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
    from radar_signal_process_tpu_torch.ops.dbf import load_dbf_coeffs

    profile = PROFILES[args.profile]
    if profile.bytes_head != 64:
        raise SystemExit(
            f"stream supports G2-format captures only (profile {profile.name})"
        )
    reader_cls = g2_reader_class(args.native)
    coeffs = None
    if args.dbf_coeffs:
        coeffs = load_dbf_coeffs(args.dbf_coeffs, profile.n_channels)
    stc_curve, profile = _istc_profile(args, profile)
    device = resolve_device(args.device)
    with _mesh_of(args, device) as mesh:
        pipe = StreamingPipeline(
            reader_cls(args.input, profile),
            profile,
            win_size=args.win_size,
            max_frames=args.frames,
            clutter_v=args.clutter_v,
            max_detections=args.max_detections,
            dbf_coeffs=coeffs,
            emit=args.emit,
            device=device,
            stc_curve_db=stc_curve,
            pulses=_parse_match_waveforms(args, profile),
            mesh=mesh,
            block_windows=args.block_windows,
        )
        root = _is_root()
        frames_out = []
        t_prev = time.perf_counter()
        for res in pipe:
            if not root:                 # rank 0 holds the gathered windows
                continue
            now = time.perf_counter()
            frames_out.append({
                "frame": res.frame_idx,
                "window_latency_ms": round((now - t_prev) * 1e3, 1),
                "cfar_hits": res.cfar_hits,
                "detections_per_beam": res.detections.valid.any(dim=-1).sum(dim=-1).tolist(),
            })
            if on_result is not None:
                on_result(res)
            t_prev = time.perf_counter()
    if root:
        print(json.dumps({"frames": frames_out, "counters": pipe.counters.snapshot()}))
    return 0


# ------------------------------------------------------------------------ G0
def _measurement_json(meas) -> dict:
    valid = meas.valid.cpu().numpy()
    out = {
        "range_m": meas.range_m.cpu().numpy()[valid].tolist(),
        "velocity_ms": meas.velocity_ms.cpu().numpy()[valid].tolist(),
        "elevation_deg": meas.elevation_deg.cpu().numpy()[valid].tolist(),
    }
    if meas.spectral_width is not None:
        out["spectral_width_bins"] = meas.spectral_width.cpu().numpy()[valid].tolist()
    return out


def _dmx_series(frames_out: list, name: str, key: str) -> np.ndarray:
    """One estimate of every ``name``-pulse detection, in frame order."""
    return np.asarray([x for f in frames_out for x in f[name][key]], dtype=np.float64)


def _dmx_frames(frames_out: list, name: str) -> np.ndarray:
    """The frame index of every ``name``-pulse detection."""
    return np.asarray([f["frame"] for f in frames_out for _ in f[name]["range_m"]],
                      dtype=np.float64)


def _dmx_outputs(args, chain, frames_out: list, out: dict) -> None:
    """``--gps`` residuals, ``--plots`` estimate series and ``--save-results``
    result struct of ``cmd_dmx``, added to ``out``."""
    profile = chain.profile
    gps_overlay = None
    if args.gps:
        # differential-GPS comparison (DMX_SignalProcessing_main_xzr.m:567-601)
        from radar_signal_process_tpu_torch.evalx.gps import (
            compare_estimates,
            drop_invalid,
            gps_frame_indices,
            read_gps_track,
        )

        track = read_gps_track(args.gps, start_line=args.gps_start_line)
        gi = gps_frame_indices(track, profile.prt, profile.prt_per_frame, args.frames_shift)
        track, gi = drop_invalid(track, gi)
        fr = _dmx_frames(frames_out, "long")
        out["gps_range_residuals"] = compare_estimates(
            fr, _dmx_series(frames_out, "long", "range_m"), gi, track.range_m)
        # the reference overlays velocity too (:592-599)
        out["gps_velocity_residuals"] = compare_estimates(
            fr, _dmx_series(frames_out, "long", "velocity_ms"), gi, track.velocity_ms)
        gps_overlay = (gi, track.range_m, track.velocity_ms)

    if args.plots:
        # estimate-series scatter with GPS overlay, the reference's live
        # result plots (DMX_SignalProcessing_main_xzr.m:534-559,592-599)
        from radar_signal_process_tpu_torch.viz import plot_estimate_series

        os.makedirs(args.plots, exist_ok=True)
        out["plots"] = {}
        for name in ("short", "long"):
            out["plots"][name] = plot_estimate_series(
                _dmx_frames(frames_out, name),
                _dmx_series(frames_out, name, "range_m"),
                _dmx_series(frames_out, name, "velocity_ms"),
                _dmx_series(frames_out, name, "elevation_deg"),
                gps_frames=gps_overlay[0] if gps_overlay else None,
                gps_range_m=gps_overlay[1] if gps_overlay else None,
                gps_velocity_ms=gps_overlay[2] if gps_overlay else None,
                save_path=os.path.join(args.plots, f"estimates_{name}.png"),
                title=f"G0 estimate series ({name} pulse)",
            )

    if args.save_results:
        # result-struct persistence with full config echo, the reference's
        # resultData_<clock>.mat save (DMX_SignalProcessing_main_xzr.m:603-612)
        import scipy.io as sio

        payload = {
            "orgDataFilePath": args.input,
            "frameS": float(args.frame_start),
            "frameE": float(args.frame_start + args.frames - 1),
            "framesProcessTotal": float(args.frames),
            "freqInd": float(frames_out[0]["freq_index"]) if frames_out else -1.0,
            "beamPosNum": float(frames_out[0]["beam_pos"]) if frames_out else -1.0,
            "freqIndSeries": np.asarray([f["freq_index"] for f in frames_out], np.float64),
            "beamPosSeries": np.asarray([f["beam_pos"] for f in frames_out], np.float64),
            "angleCodeSeries": np.asarray([f["azimuth_deg"] for f in frames_out], np.float64),
            "resultEst_Struct": {
                name: {
                    "frame": _dmx_frames(frames_out, name),
                    "rEst": _dmx_series(frames_out, name, "range_m"),
                    "vEst": _dmx_series(frames_out, name, "velocity_ms"),
                    "eleEst": _dmx_series(frames_out, name, "elevation_deg"),
                }
                for name in ("short", "long")
            },
        }
        # config echo: every chain parameter, as the reference saves its
        # winType/MTD_V/refCells/interp/sys-err knobs beside the results
        payload.update({k: (v if isinstance(v, str) else float(v))
                        for k, v in dataclasses.asdict(chain.chain).items()})
        os.makedirs(args.save_results, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(args.save_results, f"resultData_{stamp}.mat")
        sio.savemat(path, payload, do_compression=True)
        out["result_mat"] = path
        log.info("saved result struct to %s", path)


def cmd_dmx(args, on_result: Optional[Callable] = None) -> int:
    """G0 end-to-end chain over a G1-format capture (``DMX_SignalProcessing_main_xzr.m``).

    Per frame: read the dual-beam 24-bit frame, run B3 -> sum/diff -> notch
    -> B1 -> detections -> measurements, and emit the estimates.  Agile
    mode: unless ``--freq-index``/``--beam-pos`` pin them, both come from
    each frame's own header (:310-315,506-516).  ``on_result`` (if given)
    sees ``(frame_idx, G0FrameResult)`` for every frame.
    """
    from radar_signal_process_tpu_torch.config import G0_PROFILE, G0ChainConfig
    from radar_signal_process_tpu_torch.ingest import g1_reader_class
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

    profile = G0_PROFILE
    chain = G0Chain(
        profile, G0ChainConfig(),
        5 if args.freq_index is None else args.freq_index,
        0 if args.beam_pos is None else args.beam_pos,
        spectral_width_db=args.spectral_width_db,
        spectral_width_interp=args.spectral_width_interp,
        device=args.device,
    )
    reader = g1_reader_class(args.native)(
        args.input, prt_num=profile.prt_per_frame, point_prt=profile.point_prt,
        frames_per_file=args.frames_per_file,
    )
    fence = torch.cuda.synchronize if chain.device.type == "cuda" else (lambda: None)
    wall = {"read": 0.0, "process": 0.0}
    frames_out = []
    for frame_idx in range(args.frame_start, args.frame_start + args.frames):
        t0 = time.perf_counter()
        left, right, angles, meta = reader.read_frame(frame_idx)
        t1 = time.perf_counter()
        fi = args.freq_index if args.freq_index is not None else int(
            meta.get("freq_index", chain.freq_index))
        bp = args.beam_pos if args.beam_pos is not None else int(
            meta.get("beam_pos", chain.beam_pos))
        res = chain.process_frame(left, right, freq_index=fi, beam_pos=bp)
        fence()
        wall["read"] += t1 - t0
        wall["process"] += time.perf_counter() - t1
        frames_out.append({
            "frame": frame_idx,
            "azimuth_deg": float(chain.compensate_angle(np.asarray(angles[:1]))[0]),
            "freq_index": fi,
            "beam_pos": bp,
            "short": _measurement_json(res.measurements_short),
            "long": _measurement_json(res.measurements_long),
        })
        if on_result is not None:
            on_result(frame_idx, res)
    out = {"frames": frames_out}
    _dmx_outputs(args, chain, frames_out, out)
    print(json.dumps(out))
    n = max(len(frames_out), 1)
    log.info("dmx timing (%s, %d frames): read %.1f ms/frame, process %.1f ms/frame",
             chain.device, len(frames_out), wall["read"] * 1e3 / n, wall["process"] * 1e3 / n)
    return 0


# -------------------------------------------------------------------- parser
def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of the chain (cuda or cpu)")


def _stage_args(p) -> None:
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--profile", default="G2", choices=PROFILES)
    p.add_argument("--frames", type=int, default=10)


def _match_waveform_arg(p) -> None:
    p.add_argument("--match-waveform", action="append", default=None,
                   metavar="SEG=PATH[:VAR]",
                   help="measured matched-filter waveform for chirped segment SEG "
                        "(0-based) from a .mat/.npz/.npy file (fun_MTD_produce.m:72-78 "
                        "hook); repeatable")


def _istc_arg(p) -> None:
    p.add_argument("--istc", default=None, metavar="CURVE_TXT",
                   help="apply iSTC gain compensation from a textread-style dB curve "
                        "file (fun_iSTC.m:6-15)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radar_signal_process_tpu_torch",
        description="PyTorch/CUDA port of the radar signal-processing chain",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    sim = sub.add_parser("simulate", help="write a synthetic G2 .bin capture")
    sim.add_argument("--output", required=True)
    sim.add_argument("--profile", default="G2", choices=PROFILES)
    sim.add_argument("--frames", type=int, default=3)
    sim.add_argument("--velocity", type=float, default=-5.7)
    sim.add_argument("--range", type=float, default=320.0)
    sim.add_argument("--scr", type=float, default=10.0)
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--file-bytes", type=int, default=0,
                     help="split the capture into files of this size")
    sim.set_defaults(fn=cmd_simulate)

    ing = sub.add_parser("ingest", help=".bin capture -> per-frame npz")
    _stage_args(ing)
    ing.add_argument("--dbf-coeffs", default=None)
    ing.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    ing.add_argument("--max-retries", type=int, default=1000)
    ing.add_argument("--frames-per-file", type=int, default=10,
                     help="G1/G0 captures: frames per .bin file "
                          "(frameDataRead_A_xzr.m:34-41)")
    ing.add_argument("--debug-plots", default=None, metavar="DIR",
                     help="G1/G0: write Show_Read-style I/Q debug panels per frame "
                          "(Show_Read.m:127-136)")
    ing.add_argument("--format", default="npz", choices=("npz", "mat"),
                     help="artifact format; 'mat' writes the reference's frame_N.mat "
                          "bus (sig_data_DBF_allprts)")
    ing.add_argument("--force", action="store_true")
    _device_arg(ing)
    ing.set_defaults(fn=cmd_ingest)

    mtd = sub.add_parser("mtd", help="frame npz -> windowed RDM npz")
    _stage_args(mtd)
    mtd.add_argument("--win-size", type=int, default=4)
    _match_waveform_arg(mtd)
    _istc_arg(mtd)
    mtd.add_argument("--format", default="npz", choices=("npz", "mat"),
                     help="'mat' writes MTD_win_all_beams cell arrays; inputs "
                          "auto-detect npz or mat")
    mtd.add_argument("--force", action="store_true")
    _device_arg(mtd)
    mtd.set_defaults(fn=cmd_mtd)

    det = sub.add_parser("detect", help="RDM npz -> CFAR flags + detections")
    _stage_args(det)
    det.add_argument("--threshold", type=float, default=5.0)
    det.add_argument("--thresholds", type=float, nargs="+", default=None,
                     help="sweep mode (main_cfar.m:40): one output dir per threshold "
                          "(npz: OUTPUT_T{t}; mat: the reference's cfarFlag{win}_T{t} "
                          "under OUTPUT), one B1 launch per threshold per frame")
    det.add_argument("--clutter-v", type=float, default=3.0)
    det.add_argument("--max-detections", type=int, default=64)
    det.add_argument("--spectral-width-db", type=float, default=None,
                     help="also record each detection's Doppler spectral width at "
                          "this dB constraint (ampConstrWidthEst.m)")
    det.add_argument("--spectral-width-interp", type=int, default=1,
                     help="spline-upsample factor for sub-bin widths (1 = off)")
    det.add_argument("--format", default="npz", choices=("npz", "mat"),
                     help="'mat' writes cfarFlag_win_{beam} variables; inputs "
                          "auto-detect npz or mat")
    det.add_argument("--force", action="store_true")
    _device_arg(det)
    det.set_defaults(fn=cmd_detect)

    e2e = sub.add_parser("e2e", help=".bin capture -> detection JSON, in memory")
    e2e.add_argument("--input", required=True)
    e2e.add_argument("--profile", default="G2", choices=PROFILES)
    e2e.add_argument("--frames", type=int, default=3)
    e2e.add_argument("--win-size", type=int, default=4)
    e2e.add_argument("--beam", type=int, default=0,
                     help="unused (every beam is reported)")
    e2e.add_argument("--win-slice", type=int, default=0,
                     help="the window slice --mesh runs (without it every slice is reported)")
    e2e.add_argument("--mesh", default=None, metavar="DPxSP",
                     help="run slice --win-slice over a (dp, sp) mesh of ranks, e.g. 1x4: "
                          "beams data-parallel, range sharded with halo-exchange CFAR")
    e2e.add_argument("--clutter-v", type=float, default=3.0)
    e2e.add_argument("--max-detections", type=int, default=16)
    e2e.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    _device_arg(e2e)
    e2e.set_defaults(fn=cmd_e2e)

    st = sub.add_parser("stream", help="streaming chain: overlapped ingest + "
                                       "compute with all-beam detection")
    st.add_argument("--input", required=True)
    st.add_argument("--profile", default="G2", choices=PROFILES)
    st.add_argument("--frames", type=int, default=10)
    st.add_argument("--win-size", type=int, default=4)
    st.add_argument("--clutter-v", type=float, default=3.0)
    st.add_argument("--max-detections", type=int, default=16)
    st.add_argument("--dbf-coeffs", default=None)
    _istc_arg(st)
    st.add_argument("--block-windows", type=int, default=6,
                    help="windows per block of the CPU block path (models.host_parallel)")
    st.add_argument("--emit", default="full",
                    choices=("detections", "flags", "full"),
                    help="per-window emission: 'detections' drops the RDM "
                         "and flag stacks; detections and hit counters are "
                         "identical across modes")
    _match_waveform_arg(st)
    st.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    st.add_argument("--mesh", default=None, metavar="DPxSP",
                    help="stream over a (dp, sp) mesh of ranks with the compressed previous "
                         "frame carried between windows (parallel.make_sharded_stream), e.g. 2x4")
    _device_arg(st)
    st.set_defaults(fn=cmd_stream)

    dmx = sub.add_parser("dmx", help="G0 end-to-end chain over a G1-format capture")
    dmx.add_argument("--input", required=True)
    dmx.add_argument("--frames", type=int, default=1)
    dmx.add_argument("--frame-start", type=int, default=1)
    dmx.add_argument("--frames-per-file", type=int, default=10)
    dmx.add_argument("--freq-index", type=int, default=None,
                     help="pin the frequency index (default: each frame's header)")
    dmx.add_argument("--beam-pos", type=int, default=None,
                     help="pin the beam position (default: each frame's header)")
    dmx.add_argument("--spectral-width-db", type=float, default=None,
                     help="also report each detection's Doppler spectral width "
                          "at this dB constraint (ampConstrWidthEst.m)")
    dmx.add_argument("--spectral-width-interp", type=int, default=1,
                     help="spline upsampling factor of the spectral-width rule")
    dmx.add_argument("--gps", default=None,
                     help="differential-GPS track file (time, range, velocity, "
                          "azimuth, height per line)")
    dmx.add_argument("--gps-start-line", type=int, default=1)
    dmx.add_argument("--frames-shift", type=int, default=0)
    dmx.add_argument("--native", action=argparse.BooleanOptionalAction, default=True)
    dmx.add_argument("--plots", default=None, metavar="DIR",
                     help="write estimate-series plots (R/V/elevation vs frame, GPS "
                          "overlay when --gps is given)")
    dmx.add_argument("--save-results", default=None, metavar="DIR",
                     help="write resultData_<clock>.mat with the full config echo "
                          "(DMX_SignalProcessing_main_xzr.m:603-612)")
    _device_arg(dmx)
    dmx.set_defaults(fn=cmd_dmx)

    ana = sub.add_parser("analyze", help="render RDM dashboards from manifests")
    ana.add_argument("--input", required=True)
    ana.add_argument("--output", required=True)
    ana.add_argument("--profile", default="G2", choices=PROFILES)
    ana.add_argument("--frame", type=int, default=0)
    ana.add_argument("--beam", type=int, default=0)
    ana.add_argument("--win-slice", type=int, default=0)
    ana.add_argument("--animate", default=None, choices=("pc", "doppler", "all"),
                     help="also write the reference's V1 animation modes "
                          "(fun_plot_visualizations.m:33-63) as .gif")
    ana.add_argument("--animate-step", type=int, default=8,
                     help="PRT/range-bin stride between animation frames")
    ana.add_argument("--animate-frames", type=int, default=24,
                     help="max animation frames")
    ana.add_argument("--stage1-input", default=None, metavar="DIR",
                     help="stage-1 frame dir for --animate pc")
    _device_arg(ana)
    ana.set_defaults(fn=cmd_analyze)

    sw = sub.add_parser("sweep", help="threshold x SCR detection-metric sweep")
    sw.add_argument("--profile", default="G2", choices=PROFILES)
    sw.add_argument("--thresholds", type=float, nargs="+", default=[3.0, 5.0, 7.0])
    sw.add_argument("--scr", type=float, nargs="+", default=[0.0, 10.0, 20.0])
    sw.add_argument("--velocity", type=float, default=-5.7)
    sw.add_argument("--range", type=float, default=320.0)
    sw.add_argument("--frames", type=int, default=4)
    sw.add_argument("--clutter-v", type=float, default=3.0)
    _device_arg(sw)
    sw.set_defaults(fn=cmd_sweep)
    return p


def main(argv=None, on_result: Optional[Callable] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args, on_result=on_result)


if __name__ == "__main__":
    sys.exit(main())
