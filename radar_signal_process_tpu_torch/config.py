"""Typed configuration for the three radar hardware generations.

The port's own copy of ``radar_signal_process_tpu/config.py``: the same
profiles and config classes, field for field (``tests/test_torch_import.py``
holds the two copies equal).

The MATLAB reference hard-codes its parameters in each top-level script (e.g.
``MTD/main_produce_dataset_win_xzr_v2.m:22-44`` for G2,
``MatlabProcess_xuzerui/main.m:42-62`` for G1,
``CFAR_WangCai/DMX_SignalProcessing_main_xzr.m:94-127`` for G0) and its v2
changelog explicitly records the move toward centralized parameters.  This
module is the framework-wide replacement: frozen dataclasses with derived
quantities computed once, hashable so they can serve as cache keys.

All parameters cite the reference file:line they replicate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Tuple

C_LIGHT = 2.99792458e8  # speed of light [m/s] (reference: main.m:33)

# 35-tap low-pass FIR used for narrow-pulse compression in every generation
# (reference: MTD/fun_lss_pulse_compression.m:31-33, DMX_SignalProcessing_main_xzr.m:146).
# Stored un-normalized; ops normalize by max at use time, as the reference does.
NARROW_PULSE_FIR_TAPS: Tuple[float, ...] = (
    -9, -7, -2, 10, 27, 40, 42, 24, -13, -57, -89, -86, -30, 77, 220, 364,
    471, 511, 471, 364, 220, 77, -30, -86, -89, -57, -13, 24, 42, 40, 27,
    10, -2, -7, -9,
)


def matlab_round(x: float) -> int:
    """MATLAB ``round``: half away from zero (Python ``round`` is banker's)."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


@dataclasses.dataclass(frozen=True)
class CFARConfig:
    """Cell-averaging CFAR parameters.

    Defaults follow ``CFAR_WangCai/DMX_SignalProcessing_main_xzr.m:233-247``
    (and the G1 sweep in ``main_cfar.m:40-54`` which uses T=5).
    """

    ref_cells: int = 5        # reference cells per side (refCells_V / refCells_R)
    guard_cells: int = 7      # guard cells per side (saveCells_V / saveCells_R)
    threshold: float = 7.0    # T_CFAR normalization factor
    method: Literal[0, 1] = 0  # 0 = greatest-of (GO), 1 = smallest-of (SO)
    range_detect: bool = True  # run the cascaded range-dim confirmation pass
    range_extend_cells: int = 1  # +-cells checked around each velocity hit
    # (executeCFAR.m rangeCellNums = 1)


@dataclasses.dataclass(frozen=True)
class MTDConfig:
    """Doppler-processing (slow-time FFT) parameters.

    Defaults follow ``MTD/fun_Process_MTD.m:17-18`` (Kaiser beta=8) and
    ``MTD/fun_0v_pressing.m:18-22`` (notch half-width = round(N/150)).
    """

    window: Literal["kaiser", "hamming", "hanning", "blackman", "rect"] = "kaiser"
    window_beta: float = 8.0       # Kaiser beta (G0 chain uses 4.5 for PC window)
    notch_divisor: int = 150       # zero-velocity notch half-width = round(N/divisor)
    fft_length: int | None = None  # zero-padded slow-time FFT length (G0: 2048); None = CPI length
    fftshift: bool = True          # G1/G2 shift DC to center; G0 keeps FFT order
    # dormant-in-reference capabilities, wired as options here:
    mti_lag: int | None = None     # two-pulse canceller lag before the FFT
    # (fun_Process_MTI.m: 30; None = off, as the current reference scripts)
    istc: bool = False             # iSTC gain compensation before PC
    # (fun_iSTC.m; callers keep it commented out)


@dataclasses.dataclass(frozen=True)
class RadarProfile:
    """Full radar system profile for one hardware generation."""

    name: str
    # --- timing / RF ---
    fs: float                      # processing sample rate [Hz]
    fc: float                      # carrier frequency [Hz]
    prt: float                     # pulse repetition time [s]
    bandwidth: float               # chirp bandwidth [Hz]
    prt_per_frame: int             # pulses per frame (CPI building block)
    # --- waveform: pulse widths [s]; () entries absent for that generation ---
    pulse_widths: Tuple[float, ...]
    # chirp slope signs per pulse (+1 up, -1 down, 0 unmodulated narrow pulse)
    chirp_signs: Tuple[int, ...]
    # --- fast-time geometry ---
    point_prt: int                 # total samples per PRT
    segment_points: Tuple[int, ...]  # samples per pulse segment (sums to <= point_prt)
    # --- array geometry ---
    n_beams: int = 1
    n_channels: int = 1
    # --- framing (packet format) ---
    bytes_head: int = 0
    bytes_realtime: int = 0
    bytes_tail: int = 0
    # --- processing defaults ---
    mtd: MTDConfig = MTDConfig()
    cfar: CFARConfig = CFARConfig()
    # CFAR column segmentation of the (possibly concatenated) RDM
    # (reference: main_cfar.m:143-145 [1:82|83:318|319:868] for G1).
    cfar_segments: Tuple[Tuple[int, int], ...] = ()

    # ------------------------------------------------------------------ derived
    @property
    def prf(self) -> float:
        return 1.0 / self.prt

    @property
    def wavelength(self) -> float:
        return C_LIGHT / self.fc

    @property
    def ts(self) -> float:
        return 1.0 / self.fs

    @property
    def delta_r(self) -> float:
        """Range resolution set by the sample rate (main_produce_dataset_win_xzr_v2.m:44)."""
        return C_LIGHT / (2.0 * self.fs)

    def delta_doppler(self, n_fft: int | None = None) -> float:
        n = n_fft or self.prt_per_frame
        return self.prf / n

    def delta_v(self, n_fft: int | None = None) -> float:
        return self.wavelength * self.delta_doppler(n_fft) / 2.0

    @property
    def pulse_samples(self) -> Tuple[int, ...]:
        """Reference-pulse sample counts: tau * fs per pulse.

        G2: (4, 200, 700) (fun_MTD_produce.m comments); G1: (7, 75, 160)
        (main.m:73-75).
        """
        return tuple(int(round(tau * self.fs)) for tau in self.pulse_widths)

    @property
    def chirp_slopes(self) -> Tuple[float, ...]:
        """Chirp rate K_i = sign_i * B / tau_i (fun_MTD_produce.m K1..K3)."""
        return tuple(
            s * self.bandwidth / tau for s, tau in zip(self.chirp_signs, self.pulse_widths)
        )

    @property
    def segment_starts(self) -> Tuple[int, ...]:
        starts = []
        acc = 0
        for n in self.segment_points:
            starts.append(acc)
            acc += n
        return tuple(starts)

    def notch_half_width(self, n_pulses: int) -> int:
        return matlab_round(n_pulses / self.mtd.notch_divisor)

    def velocity_axis(self, n_pulses: int):
        """Physical velocity axis for a shifted RDM (fun_MTD_produce.m:127-129)."""
        import numpy as np

        fd = np.linspace(-self.prf / 2, self.prf / 2, n_pulses)
        return fd * self.wavelength / 2.0

    def range_axis(self, n_points: int):
        import numpy as np

        return np.arange(n_points) * self.delta_r


# --------------------------------------------------------------------------- G2
# 2025 "X3D8K DMX" capture: 16-channel DDC -> 13-beam DBF.
# Parameters: MTD/main_produce_dataset_win_xzr_v2.m:31-37, bin_to_mat_xzr.m:35-43.
G2_PROFILE = RadarProfile(
    name="G2",
    fs=25e6,
    fc=9450e6,
    prt=232.76e-6,
    bandwidth=20e6,
    prt_per_frame=332,
    pulse_widths=(0.16e-6, 8e-6, 28e-6),
    chirp_signs=(0, -1, +1),          # narrow simple pulse, down-chirp mid, up-chirp long
    point_prt=3404,
    segment_points=(228, 723, 2453),
    n_beams=13,
    n_channels=16,
    bytes_head=64,
    bytes_realtime=128,
    bytes_tail=64,
    mtd=MTDConfig(window="kaiser", window_beta=8.0, notch_divisor=150, fftshift=True),
    cfar=CFARConfig(threshold=5.0),
    cfar_segments=((0, 228), (228, 951), (951, 3404)),
)

# --------------------------------------------------------------------------- G1
# 2022 weather-bureau rooftop UAV captures, 2 beams, 24-bit packed I/Q.
# Parameters: MatlabProcess_xuzerui/main.m:42-62, main_cfar.m:21-35.
G1_PROFILE = RadarProfile(
    name="G1",
    fs=25e6,
    fc=9400e6,
    prt=64.88e-6,
    bandwidth=20e6,
    prt_per_frame=1536,
    pulse_widths=(0.28e-6, 3e-6, 6.4e-6),
    chirp_signs=(0, +1, -1),          # main.m:55-56: K2 = +B/tao2, K3 = -B/tao3
    point_prt=1031,
    segment_points=(82, 242, 707),
    n_beams=2,
    n_channels=2,
    bytes_head=24,
    bytes_realtime=4,                 # angle-code bytes beyond the 24 B header
    bytes_tail=8,
    # MTD-stage notch is the narrow /150 variant (MatlabProcess_xuzerui/
    # fun_0v_pressing.m); the wide /20 variant (CFAR_WangCai/fun_0v_pressing.m)
    # is the CFAR-stage re-notch (models.detect renotch_divisor).
    mtd=MTDConfig(window="kaiser", window_beta=8.0, notch_divisor=150, fftshift=True),
    cfar=CFARConfig(threshold=5.0),
    # segmentation of the 868-column range-concatenated RDM (main_cfar.m:143-145)
    cfar_segments=((0, 82), (82, 318), (318, 868)),
)

# Post-pulse-compression range re-concatenation for G1: 1031 -> 868 columns
# (fun_lss_range_concate.m:4-8).  Each entry is (dst_start, dst_stop, src_start)
# in 0-based half-open coordinates.
G1_RANGE_CONCAT: Tuple[Tuple[int, int, int], ...] = (
    (0, 82, 0),          # narrow segment: columns 1:82 -> 1:82
    (82, 318, 89),       # mid: dst 83:318 <- src 90:325   (83+(82-75) = 90 1-based)
    (318, 868, 481),     # long: dst 319:868 <- src 482:1031 (325+(82+235-160) = 482 1-based)
)

# The stream's range re-concatenation after pulse compression, by profile
# name: G1's windows drop the overlapping samples as its CPI does
# (main.m:210-211).  A profile without an entry keeps every column.  The
# tables stand apart from RadarProfile, whose fields are the JAX package's
# (stage files carry them).
RANGE_CONCAT = {"G1": G1_RANGE_CONCAT}


def range_concat(profile: RadarProfile) -> Tuple[Tuple[int, int, int], ...]:
    """``profile``'s entry of :data:`RANGE_CONCAT`, () for none.  Raises
    where the table's destination has a gap or its source reads past the
    profile's samples."""
    spec = tuple(RANGE_CONCAT.get(profile.name, ()))
    stop = 0
    for dst_start, dst_stop, src in spec:
        if dst_start != stop or dst_stop <= dst_start or src < 0 \
                or src + dst_stop - dst_start > profile.point_prt:
            raise ValueError(f"range re-concatenation {spec} does not fit profile "
                             f"{profile.name} ({profile.point_prt} samples)")
        stop = dst_stop
    return spec

# --------------------------------------------------------------------------- G0
# 2018 "DMX 6 km mode", dual beam sum/diff monopulse.
# Parameters: CFAR_WangCai/DMX_SignalProcessing_main_xzr.m:94-127.
G0_PROFILE = RadarProfile(
    name="G0",
    fs=12.5e6,
    fc=9405e6,                        # actual fc per frame comes from the frequency table
    prt=52.08e-6,
    bandwidth=10e6,
    prt_per_frame=1536,
    pulse_widths=(0.56e-6, 5.04e-6),
    chirp_signs=(0, +1),
    point_prt=566,
    segment_points=(62, 504),         # point_short / point_long (:115-116)
    n_beams=2,
    n_channels=2,
    mtd=MTDConfig(window="hamming", notch_divisor=0, fft_length=2048, fftshift=False),
    cfar=CFARConfig(threshold=7.0),
)


@dataclasses.dataclass(frozen=True)
class G0ChainConfig:
    """Extra parameters specific to the G0 end-to-end chain.

    Reference: DMX_SignalProcessing_main_xzr.m:118-266.
    """

    pc_fft_length: int = 512           # FFT_num (:119)
    mtd_fft_length: int = 2048         # mtd_FFT_num (:120)
    mtd_clutter_v: float = 1.0         # MTD_V, clutter-region speed bound [m/s] (:231)
    pc_window: str = "kaiser"          # winType=3 (:179)
    pc_window_beta: float = 4.5        # betaMF (:186)
    mtd_window: str = "hamming"        # MTD_win_TYPE=1 (:208)
    mtd_window_beta: float = 4.5       # betaMTD, used when mtd_window="kaiser" (:215-216)
    r_sys_err_short: float = 0.0       # rSysErr_short [m] (:250)
    r_sys_err_long: float = 62.0 * 12  # rSysErr_long [m] (:251)
    r_measure_err_short: float = 297.0  # (:252)
    r_measure_err_long: float = 92.0    # (:253)
    extra_dots: int = 2                # interpolation support half-width (:256)
    r_interp_times: int = 8            # range interpolation factor (:257)
    v_interp_times: int = 4            # velocity interpolation factor (:258)
    ele_angle_comp: float = 0.0        # (:261)
    ele_angle_sys_err: float = 0.0     # (:262)
    beam_angle_step: float = 5.0       # degrees between beam positions (:263)
    north_angle: float = 29.01         # (:270)
    angle_e1: float = 5.9              # (:271)
    sys_num: int = 2                   # K-value table selector (:265)


PROFILES = {"G0": G0_PROFILE, "G1": G1_PROFILE, "G2": G2_PROFILE}
