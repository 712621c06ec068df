"""G0 end-to-end chain: one dual-beam frame -> detections and measurements.

Port of ``radar_signal_process_tpu/models/g0_chain.py`` (after
``CFAR_WangCai/DMX_SignalProcessing_main_xzr.m``).  Per frame:

* split each beam into the short / long pulse segments (:330-335);
* B3 per segment: raw-tap FIR (short, :343-344) or the 512-point
  frequency-domain matched filter (long, :346-353), then the
  Hamming-windowed, unshifted 2048-point slow-time DFT and the magnitude
  (:413-418), fused into one kernel (``kernels.pc_rdm``);
* monopulse sum |L|+|R| and difference |R|-|L| (:420-426);
* zero the low-velocity clutter rows of the unshifted spectrum (:462-465);
* B1, the cascaded 2-D CFAR, over each segment's sum RDM (:468-472);
* the 32 strongest hits, and their sub-bin range / velocity and monopulse
  elevation (:489-516).

On a CUDA device the front runs B3 and the CFAR runs B1, and nothing else;
on the CPU both run their plain versions.  The JAX class's ``use_split`` /
``_front`` / ``_finish`` split works around XLA on the CPU and has no
counterpart here.

On a CUDA device everything after the beams' copy is replayed as one CUDA
graph per clutter-row count ``n_clutter`` (which sets B1's rows, the notch
and the measurement's clamps; shapes are fixed by the profile).  The
frame's other values (velocity scale, Doppler cell, monopulse slope, beam
elevation) are one row of a table made once on the card, copied into the
block the graph reads; the notch masks and spline matrices are made once
too, so a frame copies nothing from the host but its beams.

On a CUDA device the beams come through a ring of two pinned host slots
that the chain keeps, in blocks of rows: the host copies one block into the
slot while the card's DMA moves the block before it, on the current stream.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from radar_signal_process_tpu_torch.config import (
    G0_PROFILE,
    G0ChainConfig,
    NARROW_PULSE_FIR_TAPS,
    RadarProfile,
)
from radar_signal_process_tpu_torch.device import COMPLEX, REAL, resolve_device
from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d
from radar_signal_process_tpu_torch.kernels.pc_rdm import fused_pc_rdm, prepared_operator_image
from radar_signal_process_tpu_torch.ops.measure import (
    DetectionList,
    Measurements,
    extract_detections,
    motion_parameters,
    spline_eval_matrix,
)
from radar_signal_process_tpu_torch.ops.mtd import (
    doppler_process,
    notch_mask_unshifted,
    zero_velocity_notch_unshifted,
)
from radar_signal_process_tpu_torch.ops.pulse_compression import (
    fir_compress,
    fir_spectrum,
    fixed_length_matched_filter,
)
from radar_signal_process_tpu_torch.ops.tables import angle_k_values, freq_value
from radar_signal_process_tpu_torch.params import g0_chain_params
from radar_signal_process_tpu_torch.utils.profiling import span

C_LIGHT = 299792458.0
# a beam goes through a pinned slot in equal blocks of rows of at most about
# this many bytes (G0: two of 3.48 MB): the DMA of each block runs while the
# host copies the next; smaller blocks leave the host's copy fewer threads
# (torch splits a copy into chunks of 32768 elements) and cost more calls
STAGE_BLOCK_BYTES = 1 << 22


class G0FrameParams(NamedTuple):
    """Frequency/beam-dependent quantities of one frame (:310-327,506-516)."""

    v_scale: torch.Tensor  # (mtd_fft,) f32 velocity scale, sign-inverted
    delta_v: float         # m/s per Doppler bin
    k_value: float         # monopulse slope K(freq, beam)
    beam_pos: int


class G0FrameResult(NamedTuple):
    rdm_sum_short: torch.Tensor    # (mtd_fft, point_short)
    rdm_sum_long: torch.Tensor     # (mtd_fft, pc_fft)
    rdm_diff_short: torch.Tensor
    rdm_diff_long: torch.Tensor
    flags_short: torch.Tensor
    flags_long: torch.Tensor
    vflags_short: torch.Tensor
    vflags_long: torch.Tensor
    detections_short: DetectionList
    detections_long: DetectionList
    measurements_short: Measurements
    measurements_long: Measurements


def _host_tensor(x) -> torch.Tensor:
    """Host beam ``x`` as a CPU tensor, sharing an array's memory where torch
    can (else a complex64 copy of it)."""
    if not isinstance(x, np.ndarray):
        return x
    try:
        return torch.from_numpy(x)
    except (TypeError, ValueError):     # a dtype, byte order or strides torch cannot share
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.complex64))


def _leaves(x) -> list:
    """The leaves of a nest of named tuples, depth first (``None`` kept)."""
    if isinstance(x, tuple):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def _rebuild(skeleton, leaves):
    """``skeleton``'s nest of named tuples with its leaves taken in turn from
    the iterator ``leaves``."""
    if isinstance(skeleton, tuple):
        return type(skeleton)._make(_rebuild(item, leaves) for item in skeleton)
    return next(leaves)


def pack_result(result: G0FrameResult) -> tuple[torch.Tensor, tuple, G0FrameResult]:
    """Every tensor of ``result`` in one flat byte block (4-byte values
    first, so each lies on a multiple of its size), each leaf's ``(dtype,
    offset in its elements, shape, strides)`` there (None for a leaf that is
    None), and the result's nest with leaf numbers in place of its tensors."""
    leaves = _leaves(result)
    order = sorted((i for i, t in enumerate(leaves) if t is not None),
                   key=lambda i: -leaves[i].element_size())
    block = torch.cat([leaves[i].reshape(-1).view(torch.uint8) for i in order])
    layout, offset = [None] * len(leaves), 0
    for i in order:
        t = leaves[i]
        shape = tuple(t.shape)
        layout[i] = (t.dtype, offset // t.element_size(), shape,
                     torch.empty(shape, device="meta").stride())
        offset += t.numel() * t.element_size()
    return block, tuple(layout), _rebuild(result, iter(range(len(leaves))))


def unpack_result(block: torch.Tensor, layout: tuple, skeleton: G0FrameResult) -> G0FrameResult:
    """The result :func:`pack_result` packed into ``block``, as views of it
    (one view of the block a dtype, then one strided view a tensor)."""
    typed = {}
    for spec in layout:
        if spec is not None and spec[0] not in typed:
            size = spec[0].itemsize
            typed[spec[0]] = block[: block.numel() // size * size].view(spec[0])
    return _rebuild(skeleton, iter(
        None if spec is None else typed[spec[0]].as_strided(spec[2], spec[3], spec[1])
        for spec in layout))


class _Replay(NamedTuple):
    """One captured frame: the graph writes every output into ``out``
    (:func:`pack_result`'s block); ``images`` are the B3 operator images it
    reads, held so that their memory lives as long as the graph."""

    graph: torch.cuda.CUDAGraph
    out: torch.Tensor
    layout: tuple
    skeleton: G0FrameResult
    images: tuple

    def result(self) -> G0FrameResult:
        """The last replay's result, in a copy of ``out`` (one launch) that no
        later replay writes."""
        return unpack_result(self.out.clone(), self.layout, self.skeleton)


class G0Chain(nn.Module):
    """G0 per-frame processor with its constants as buffers on ``device``
    (the card unless the caller asks for the CPU; a CUDA device that is
    absent raises).

    ``freq_index``/``beam_pos`` are the defaults; :meth:`process_frame`
    takes per-frame values (parsed from each frame's header), so a
    frequency-hopping capture gets per-frame velocity scales and monopulse
    slopes.  Those values, for every (frequency, beam) of the calibration
    tables, are the rows of ``frame_values``: the velocity scale
    (``mtd_fft``), then ``delta_v``, ``k_value`` and the beam elevation
    ``beam_pos * beam_angle_step + 2.5``, each computed on the host in
    float64 and stored as the float32 a Python float becomes in a float32
    operation.  ``notch_keep`` (one keep-mask per ``n_clutter`` of the
    frequency plan) and ``splines`` (the range and velocity spline matrices)
    are made once beside them.

    On a CUDA device :meth:`process_frame` replays its device work as a CUDA
    graph (see there); ``captures``, ``replays`` and ``eager_frames`` count
    the graphs captured and the frames replayed or run eagerly.  Host beams
    go to the card through pinned slots (:meth:`beams`): ``pinned_frames``
    counts the frames staged so, ``slot_waits`` the times a slot was still
    being read by the card when the host came to write it.
    """

    def __init__(
        self,
        profile: RadarProfile = G0_PROFILE,
        chain: G0ChainConfig = G0ChainConfig(),
        freq_index: int = 5,
        beam_pos: int = 0,
        match_waveform: np.ndarray | None = None,
        power_norm: bool = True,
        max_detections: int = 32,
        spectral_width_db: float | None = None,
        spectral_width_interp: int = 1,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.profile = profile
        self.chain = chain
        self.freq_index = freq_index
        self.beam_pos = beam_pos
        self.max_detections = max_detections
        self.spectral_width_db = spectral_width_db
        self.spectral_width_interp = spectral_width_interp
        self.device = resolve_device(device)
        params = g0_chain_params(profile, chain, match_waveform, power_norm, device=self.device)
        for name, value in vars(params).items():
            self.register_buffer(name, value)

        self.wavelength = C_LIGHT / freq_value(freq_index)  # lamda = c/fc (:315)
        self._delta_doppler = profile.prf / chain.mtd_fft_length
        self._f_scale = np.fft.fftshift(
            np.arange(-chain.mtd_fft_length // 2, chain.mtd_fft_length // 2)
            * self._delta_doppler
        )
        self._k_table = angle_k_values(chain.sys_num)
        n_freq, self._n_beams = self._k_table.shape
        n_fft = chain.mtd_fft_length
        values = np.empty((n_freq, self._n_beams, n_fft + 3), np.float32)
        clutter = set()
        for f in range(n_freq):
            delta_v, n_clutter, v_scale = self._frequency_terms(f)
            values[f, :, :n_fft] = v_scale
            values[f, :, n_fft] = delta_v
            clutter.add(n_clutter)
        values[..., n_fft + 1] = self._k_table
        values[..., n_fft + 2] = np.arange(self._n_beams) * chain.beam_angle_step + 2.5
        self.frame_values = torch.from_numpy(values.reshape(n_freq * self._n_beams, -1)).to(
            self.device)
        self.notch_keep = {
            n_c: torch.as_tensor(notch_mask_unshifted(n_fft, n_c), dtype=REAL, device=self.device)
            for n_c in sorted(clutter)
        }
        w = 2 * chain.extra_dots + 1
        self.splines = tuple(
            torch.as_tensor(spline_eval_matrix(w, u), dtype=REAL, device=self.device)
            for u in (chain.r_interp_times, chain.v_interp_times)
        )
        self._params_cache: dict = {}
        fp, self.n_clutter = self.frame_params(freq_index, beam_pos)
        self.delta_v = fp.delta_v
        self.k_value = fp.k_value

        # the graph path: static input, the block of frame values the graphs
        # read, one graph per n_clutter, all in one memory pool; spectral
        # widths upsampled by a spline copy their matrix from the host, so
        # those frames run eagerly
        self.captures = self.replays = self.eager_frames = 0
        self.pinned_frames = self.slot_waits = 0
        self._ring = None
        self._graphed = self.device.type == "cuda" and (
            spectral_width_db is None or spectral_width_interp <= 1)
        self._graphs: dict = {}
        self._graph_pool = None
        self._streams = None
        if self._graphed:
            self._input = torch.empty((2, profile.prt_per_frame, profile.point_prt),
                                      dtype=COMPLEX, device=self.device)
            self._frame_block = torch.empty(n_fft + 3, dtype=REAL, device=self.device)

    def _frequency_terms(self, freq_index: int) -> tuple[float, int, np.ndarray]:
        """``(delta_v, n_clutter, v_scale)`` of one frequency, in float64 as
        the reference computes them in its frame loop (:315-327)."""
        wavelength = C_LIGHT / freq_value(freq_index)
        delta_v = wavelength * self._delta_doppler / 2.0
        n_clutter = int(math.floor(self.chain.mtd_clutter_v / delta_v))
        return delta_v, n_clutter, -wavelength * self._f_scale / 2.0  # (:326-327)

    def frame_params(self, freq_index: int, beam_pos: int) -> tuple[G0FrameParams, int]:
        """Frequency/beam-dependent scalars of one frame and its clutter-row
        count, computed on the host in float64 as the reference does in its
        frame loop (:310-327,506-516); ``v_scale`` is the frame's row of
        ``frame_values``."""
        key = (int(freq_index), int(beam_pos))
        hit = self._params_cache.get(key)
        if hit is not None:
            return hit
        n_freq, n_beam = self._k_table.shape
        if not (0 <= key[0] < n_freq and 0 <= key[1] < n_beam):
            # agile mode feeds header fields here: a corrupt header must fail
            # loud, not wrap into the wrong table row
            raise ValueError(
                f"freq_index/beam_pos ({key[0]}, {key[1]}) outside the "
                f"calibration tables ({n_freq} x {n_beam}); corrupt frame "
                "header? pin --freq-index/--beam-pos to override"
            )
        delta_v, n_clutter, _ = self._frequency_terms(key[0])
        params = G0FrameParams(
            v_scale=self.frame_values[key[0] * n_beam + key[1], : self.chain.mtd_fft_length],
            delta_v=float(delta_v),
            k_value=float(self._k_table[key[0], key[1]]),
            beam_pos=key[1],
        )
        self._params_cache[key] = (params, n_clutter)
        return params, n_clutter

    def compensate_angle(self, angle_code: np.ndarray) -> np.ndarray:
        """North-angle compensation: rem(angle + northAngle + angleE1, 360) (:310)."""
        return np.remainder(angle_code + self.chain.north_angle + self.chain.angle_e1, 360.0)

    # ------------------------------------------------------------------ core
    def beams(self, left, right, out: torch.Tensor | None = None) -> torch.Tensor:
        """(2, prt, point_prt) complex64 stack of the two beams on the device;
        into ``out`` when given.

        On a CUDA device, beams on the host (arrays or CPU tensors of any
        dtype the copy converts) go through the next slot of the chain's ring
        of two pinned host slots, in blocks of rows: each block is copied
        into the slot on the host's intra-op threads, converted to complex64
        on the way, then onto the card without blocking the host, on the
        current stream, so the card's copy of a block runs while the host
        copies the next.  The caller's arrays are free once this returns.
        Elsewhere each beam is one copy."""
        shape = (self.profile.prt_per_frame, self.profile.point_prt)
        for x in (left, right):
            if tuple(x.shape) != shape:
                raise ValueError(f"a beam of {tuple(x.shape)} samples, not {shape}")
        if out is None:
            out = torch.empty((2,) + shape, dtype=COMPLEX, device=self.device)
        if self.device.type == "cuda" and not any(
                isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in (left, right)):
            return self._stage((left, right), out)
        for dst, x in zip(out, (left, right)):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.asarray(x, dtype=np.complex64))
            with span("g0.h2d", "copy", x.numel() * x.element_size()):
                dst.copy_(x)
        return out

    def _pinned_ring(self, shape: tuple) -> list:
        """Two pinned host slots of a frame's beams, each with the event that
        the last copy out of it records."""
        return [(torch.empty(shape, dtype=COMPLEX, pin_memory=True), torch.cuda.Event())
                for _ in range(2)]

    def _stage(self, beams: tuple, out: torch.Tensor) -> torch.Tensor:
        """The host ``beams`` into ``out`` on the card through the ring's next
        slot (see :meth:`beams`); the slot is written only once the card has
        read what the frame before last left in it."""
        if self._ring is None:
            self._ring = self._pinned_ring(tuple(out.shape))
        slot, read = self._ring[self.pinned_frames % len(self._ring)]
        if not read.query():
            self.slot_waits += 1
            read.synchronize()
        rows = out.shape[1]
        n_blocks = math.ceil(slot[0].numel() * slot.element_size() / STAGE_BLOCK_BYTES)
        step = math.ceil(rows / n_blocks)
        for x, pinned, dst in zip(beams, slot, out):
            src = _host_tensor(x)
            for r in range(0, rows, step):
                block = pinned[r:r + step]
                nbytes = block.numel() * block.element_size()
                with span("g0.pin", "pin", nbytes):
                    block.copy_(src[r:r + step])
                with span("g0.h2d", "copy", nbytes):
                    dst[r:r + step].copy_(block, non_blocking=True)
        read.record(torch.cuda.current_stream(self.device))
        self.pinned_frames += 1
        return out

    def front(self, beams: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """B3 on each segment: per-beam |RDM| (2, mtd_fft, n) of the short and
        long pulse.  The segments are read in place from ``beams``."""
        ps = self.profile.segment_points[0]
        abs_short = fused_pc_rdm(beams[..., :ps], self.pc_short_re, self.pc_short_im,
                                 self.dft_re, self.dft_im)
        abs_long = fused_pc_rdm(beams[..., ps:], self.pc_long_re, self.pc_long_im,
                                self.dft_re, self.dft_im)
        return abs_short, abs_long

    def pc(self, beams: torch.Tensor, segments=("short", "long")) -> tuple[torch.Tensor, ...]:
        """The FFT form of the pulse compression (the JAX ``_pc``): raw-tap FIR
        on the short segment, 512-point matched filter on the long one; the
        compressed ``segments``, in that order."""
        ps = self.profile.segment_points[0]
        out = []
        for segment in segments:
            if segment == "short":
                spec = torch.as_tensor(fir_spectrum(ps, normalize=False), dtype=COMPLEX,
                                       device=beams.device)
                out.append(fir_compress(beams[..., :ps], spec, len(NARROW_PULSE_FIR_TAPS),
                                        post_scale=1.0, roll_group_delay=False))
            else:
                out.append(fixed_length_matched_filter(beams[..., ps:], self.match_spec))
        return tuple(out)

    def front_fft(self, beams: torch.Tensor, segments=("short", "long")) -> tuple[torch.Tensor, ...]:
        """B3's cuFFT form: :meth:`pc`, then the windowed, unshifted,
        zero-padded slow-time FFT and the magnitude (``ops.mtd``)."""
        window = self.mtd_window.double().cpu().numpy()
        n_fft = self.chain.mtd_fft_length
        return tuple(doppler_process(mf, window, n_fft, shift=False)
                     for mf in self.pc(beams, segments))

    def process_frame(
        self, left, right, freq_index: int | None = None, beam_pos: int | None = None
    ) -> G0FrameResult:
        """One frame: ``left``/``right`` (prt_per_frame, point_prt) complex.

        ``freq_index``/``beam_pos`` default to the chain's; pass the frame's
        own parsed ``freInd``/``beamPosNum`` for per-frame agility.

        On the CPU, or where spectral widths are upsampled, the frame runs
        eagerly.  Otherwise the beams are copied into a static input and the
        rest is a CUDA graph keyed by the frame's ``n_clutter``: its first
        frame runs eagerly on the capture stream, which builds what the
        capture must find made (B3's operator images, B1's launch plans,
        the tensor-map entry point); its second captures the graph; from
        then on a frame copies its row of ``frame_values`` into the block
        the graph reads, replays it and copies the outputs out.  Kernel
        wrappers count their launches when called, so once per capture on
        this path.  The result is the frame's own: no later frame writes it.
        """
        with span("g0.params", "launch"):
            fi = self.freq_index if freq_index is None else freq_index
            bp = self.beam_pos if beam_pos is None else beam_pos
            _, n_clutter = self.frame_params(fi, bp)
            values = self.frame_values[int(fi) * self._n_beams + int(bp)]
        if not self._graphed:
            self.eager_frames += 1
            return self._frame_work(self.beams(left, right), n_clutter, values)
        beams = self.beams(left, right, out=self._input)
        if n_clutter not in self._graphs:
            self._graphs[n_clutter] = None     # warmed up, not yet captured
            self.eager_frames += 1
            return self._warm_up(beams, n_clutter, values)
        replay = self._graphs[n_clutter]
        if replay is None:
            with span("g0.capture", "launch"):
                replay = self._graphs[n_clutter] = self._capture(n_clutter)
            self.captures += 1
        with span("g0.replay", "launch"):
            self._frame_block.copy_(values)
            replay.graph.replay()
            self.replays += 1
            return replay.result()

    def _side_streams(self) -> tuple[torch.cuda.Stream, torch.cuda.Stream]:
        """The capture stream, and the stream the short segment's branch
        forks onto from it."""
        if self._streams is None:
            self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
        return self._streams

    def _warm_up(self, beams: torch.Tensor, n_clutter: int, values: torch.Tensor) -> G0FrameResult:
        """The frame's device work, eagerly on the capture stream."""
        main, (side, fork) = torch.cuda.current_stream(self.device), self._side_streams()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = self._frame_work(beams, n_clutter, values, fork)
        main.wait_stream(side)
        for t in _leaves(result):
            if t is not None:
                t.record_stream(main)   # the caller reads and frees it on ``main``
        return result

    def _capture(self, n_clutter: int) -> _Replay:
        """The graph of the device work of a frame of ``n_clutter``, reading
        the static input and frame block, writing one flat output block."""
        images = tuple(prepared_operator_image(re, im) for re, im in (
            (self.pc_short_re, self.pc_short_im), (self.pc_long_re, self.pc_long_im)))
        side, fork = self._side_streams()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=side,
                              capture_error_mode="thread_local"):
            out, layout, skeleton = pack_result(
                self._frame_work(self._input, n_clutter, self._frame_block, fork))
        self._graph_pool = graph.pool()
        return _Replay(graph, out, layout, skeleton, images)

    def _frame_work(self, beams: torch.Tensor, n_clutter: int, values: torch.Tensor,
                    fork: torch.cuda.Stream | None = None) -> G0FrameResult:
        """Everything after the beams' copy: B3, sums and notch, B1, then per
        segment top-k and the measurement, with the frame's ``values`` (a row
        of ``frame_values``, or the block a graph reads) as device tensors.
        With ``fork``, the short segment's top-k and measurement run on that
        stream beside the long segment's, forked from the current stream and
        joined back into it: the two chains of small kernels overlap, while
        B3 and B1 keep the card to themselves."""
        with span("g0.front", "launch"):
            rdms = self.front(beams)
        with span("g0.combine", "launch"):
            keep = self.notch_keep[n_clutter]
            sums = [zero_velocity_notch_unshifted(a[0] + a[1], n_clutter, keep) for a in rdms]
            diffs = [a[1] - a[0] for a in rdms]
        with span("g0.cfar", "launch"):
            flags = [cascaded_cfar2d(s, self.profile.cfar, n_clutter) for s in sums]
        if fork is None:
            dets_s, meas_s = self._measure(sums[0], diffs[0], flags[0][0], 0, n_clutter, values)
        else:
            main = torch.cuda.current_stream(self.device)
            fork.wait_stream(main)
            with torch.cuda.stream(fork):
                dets_s, meas_s = self._measure(sums[0], diffs[0], flags[0][0], 0, n_clutter,
                                               values)
        dets_l, meas_l = self._measure(sums[1], diffs[1], flags[1][0], 1, n_clutter, values)
        if fork is not None:
            main.wait_stream(fork)
        return G0FrameResult(
            rdm_sum_short=sums[0], rdm_sum_long=sums[1],
            rdm_diff_short=diffs[0], rdm_diff_long=diffs[1],
            flags_short=flags[0][0], flags_long=flags[1][0],
            vflags_short=flags[0][1], vflags_long=flags[1][1],
            detections_short=dets_s, detections_long=dets_l,
            measurements_short=meas_s, measurements_long=meas_l,
        )

    def _measure(self, rdm_sum: torch.Tensor, rdm_diff: torch.Tensor, flags: torch.Tensor,
                 segment: int, n_clutter: int,
                 values: torch.Tensor) -> tuple[DetectionList, Measurements]:
        """One segment's detection list and measurements."""
        n_fft, chain = self.chain.mtd_fft_length, self.chain
        with span("g0.extract", "launch"):
            dets = extract_detections(flags, rdm_sum, self.max_detections)
        with span("g0.measure", "launch"):
            meas = motion_parameters(
                rdm_sum, rdm_diff, dets,
                r_scale=self.r_scale_long if segment else self.r_scale_short,
                delta_r=self.profile.delta_r,
                v_scale=values[:n_fft],
                delta_v=values[n_fft],
                k_value=values[n_fft + 1],
                beam_pos=None,
                beam_angle_step=chain.beam_angle_step,
                beam_elevation=values[n_fft + 2],
                n_clutter=n_clutter,
                extra_dots=chain.extra_dots,
                r_interp=chain.r_interp_times,
                v_interp=chain.v_interp_times,
                ele_angle_comp=chain.ele_angle_comp,
                ele_angle_sys_err=chain.ele_angle_sys_err,
                spectral_width_db=self.spectral_width_db,
                spectral_width_shifted=False,
                spectral_width_interp=self.spectral_width_interp,
                splines=self.splines,
            )
        return dets, meas
