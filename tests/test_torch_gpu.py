"""CUDA kernels of the port against their plain versions, on the card.

Imports no jax, so it runs where the JAX package cannot:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` configures jax).  Without a
GPU every test here skips.  The input classes and the on-threshold RDM are
shared with ``test_torch_kernels.py``, which holds the plain versions
against the JAX package on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE, CFARConfig
from radar_signal_process_tpu_torch.kernels import cfar as kcfar
from radar_signal_process_tpu_torch.kernels import pc_rdm as kpcr
from radar_signal_process_tpu_torch.kernels import rdm as krdm
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from radar_signal_process_tpu_torch.ops.windows import make_window

RTOL, ATOL = 2e-4, 2e-3
B3_PEAK_ATOL = 2e-5   # B3: |kernel - plain| <= 2e-5 * peak + RTOL * |plain|
C128_PEAK = 1e-5      # |kernel - complex128 product| <= 1e-5 * peak


@pytest.fixture
def rng():
    return np.random.default_rng(20250817)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# --------------------------------------------------------------- input classes
def _rdm(rng, nv=96, nr=160, hits=8):
    rdm = np.abs(rng.standard_normal((nv, nr))).astype(np.float32) + 0.5
    for _ in range(hits):
        rdm[rng.integers(8, nv - 8), rng.integers(0, nr)] += 40.0
    return rdm


def _notched_edges(rng):
    rdm = _rdm(rng)
    rdm[44:53, :] = 0.0                         # wide clutter re-notch band
    rdm[int(rng.integers(8, 40)), 0] += 40.0    # edge-column hits
    rdm[int(rng.integers(56, 88)), 159] += 40.0
    return rdm


def _ties(rng):
    rdm = _rdm(rng)
    for v, r in ((20, 30), (40, 80), (60, 0), (70, 158)):
        rdm[v, r : r + 2] = 50.0                # exact neighbour ties
    rdm[30, 100:103] = 60.0                     # a three-way tie
    return rdm


# name -> (RDM maker, n_clutter, CFAR config)
INPUTS = {
    "random-nc6": (lambda rng: _rdm(rng), 6, CFARConfig(threshold=5.0)),
    "random-nc11": (lambda rng: _rdm(rng), 11, CFARConfig(threshold=5.0)),
    "batched": (lambda rng: np.stack([_rdm(rng) for _ in range(6)]).reshape(2, 3, 96, 160),
                6, CFARConfig(threshold=5.0)),
    "no-range-pass": (lambda rng: _rdm(rng), 6, CFARConfig(threshold=5.0, range_detect=False)),
    "wide": (lambda rng: np.stack([_rdm(rng, nv=64, nr=700, hits=10) for _ in range(3)]),
             6, CFARConfig(threshold=5.0)),
    "notched-edges": (_notched_edges, 6, CFARConfig(threshold=5.0)),
    "ties": (_ties, 6, CFARConfig(threshold=5.0)),
    "E2": (_ties, 6, CFARConfig(threshold=5.0, range_extend_cells=2)),
    "SO": (lambda rng: _rdm(rng), 6, CFARConfig(threshold=3.0, method=1)),
    # 23 cropped rows x 20 columns: below the 2*(ref+guard)+1 parity floor
    # on both axes, so both windows wrap (the roll form's semantics)
    "below-floor": (lambda rng: _rdm(rng, nv=30, nr=20, hits=3), 3, CFARConfig(threshold=2.0)),
    "r1-g0": (lambda rng: _rdm(rng), 6, CFARConfig(ref_cells=1, guard_cells=0, threshold=3.0)),
    "r8-g2-E3": (_ties, 6, CFARConfig(ref_cells=8, guard_cells=2, threshold=4.0,
                                      range_extend_cells=3)),
}


def _on_threshold(rng):
    """A cell exactly on its threshold ``fl(fl(s/5) * 5)``, where the mean
    of the five equal reference cells rounds one ulp higher as ``s * (1/5)``
    than as ``s / 5``: a reciprocal multiply would miss the flag."""
    five, inv = np.float32(5.0), np.float32(1.0) / np.float32(5.0)
    for v in rng.uniform(0.5, 2.0, 10000).astype(np.float32):
        s = v
        for _ in range(4):
            s = np.float32(s + v)
        if np.float32(s / five) < np.float32(s * inv):
            break
    rdm = np.full((64, 64), v, np.float32)
    rdm[30, 30] = np.float32(np.float32(s / five) * five)
    return rdm


def _pc(rng, shape, device):
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(x).to(device)


def _planes(window, device, n_fft=None, shift=True):
    return tuple(torch.from_numpy(p).to(device) for p in krdm.dft_planes(window, n_fft, shift))


# ------------------------------------------------------------------------ B2
@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,n_fft,shift,notch",
    [((3, 332, 700), None, True, (163, 167)), ((2, 100, 65), None, True, None),
     ((1, 48, 130), 64, False, None), ((5, 17, 3), None, True, (7, 9)),
     ((52, 332, 3404), None, True, (163, 167))],
    ids=["g2-rows", "ragged", "zero-padded", "tiny", "g2-full"],
)
def test_doppler_rdm_kernel_matches_plain(rng, cuda_device, shape, n_fft, shift, notch):
    pc = _pc(rng, shape, cuda_device)
    w_re, w_im = _planes(make_window("kaiser", shape[-2]), cuda_device, n_fft, shift)
    notch = notch or (0, -1)
    before = krdm.doppler_rdm.launches
    got = krdm.doppler_rdm(pc, w_re, w_im, notch)
    want = krdm.doppler_rdm_plain(pc, w_re, w_im, notch)
    torch.cuda.synchronize()
    assert krdm.doppler_rdm.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _c128_error(got, want128):
    """max |got - want| over the peak of the complex128 product's magnitude."""
    return float((got.double() - want128).abs().max() / want128.abs().max())


@pytest.mark.gpu
def test_doppler_rdm_kernel_large_dynamic_range(rng, cuda_device):
    """One target 1e5 above unit noise: the 3xTF32 split keeps the weak
    cells.  Held to the peak-scaled form of the RDM tolerance (the absolute
    2e-3 is a unit-scale rule; the slice does the same at int16 scale) and
    to 1e-5 of the peak against the complex128 product."""
    shape = (3, 332, 700)
    pc = _pc(rng, shape, cuda_device)
    pulses = torch.arange(332, device=cuda_device)
    pc[1, :, 321] += 1e5 * torch.exp(2j * torch.pi * 0.137 * pulses).to(torch.complex64)
    w_re, w_im = _planes(make_window("kaiser", 332), cuda_device)
    got = krdm.doppler_rdm(pc, w_re, w_im, (163, 167))
    want = krdm.doppler_rdm_plain(pc, w_re, w_im, (163, 167))
    exact = torch.matmul(torch.complex(w_re, w_im).to(torch.complex128),
                         pc.to(torch.complex128)).abs()
    exact[:, 163:168] = 0.0
    peak = float(want.abs().max())
    assert peak > 1e6
    torch.testing.assert_close(got, want, rtol=RTOL, atol=B3_PEAK_ATOL * peak)
    assert _c128_error(got, exact) <= C128_PEAK


@pytest.mark.gpu
def test_doppler_rdm_kernel_rejects_bad_inputs(rng, cuda_device):
    pc = _pc(rng, (2, 16, 20), cuda_device)
    w_re, w_im = _planes(make_window("kaiser", 16), cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        krdm.doppler_rdm(pc.transpose(-1, -2).contiguous().transpose(-1, -2), w_re, w_im, (0, -1))
    with pytest.raises(ValueError, match="complex64"):
        krdm.doppler_rdm(pc.to(torch.complex128), w_re, w_im, (0, -1))


# ------------------------------------------------------------------------ B1
@pytest.mark.gpu
@pytest.mark.parametrize("case", list(INPUTS))
def test_cascaded_cfar2d_kernel_bit_equal(rng, cuda_device, case):
    make, n_clutter, cfg = INPUTS[case]
    rdm = torch.from_numpy(np.ascontiguousarray(make(rng))).to(cuda_device)
    before = kcfar.cascaded_cfar2d.launches
    got_f, got_v = kcfar.cascaded_cfar2d(rdm, cfg, n_clutter)
    want_f, want_v = tcfar.cascaded_cfar2d(rdm, cfg, n_clutter)
    assert kcfar.cascaded_cfar2d.launches == before + 1
    assert torch.equal(got_f, want_f) and torch.equal(got_v, want_v)


@pytest.mark.gpu
def test_cascaded_cfar2d_kernel_segments(rng, cuda_device):
    segs = G2_PROFILE.cfar_segments
    rdm = np.stack([_rdm(rng, nv=48, nr=3404, hits=60) for _ in range(2)])
    rdm[:, :, [0, 227, 228, 950, 951, 3403]] += 40.0
    x = torch.from_numpy(rdm).to(cuda_device)
    before = kcfar.cascaded_cfar2d.launches
    got = kcfar.cascaded_cfar2d(x, G2_PROFILE.cfar, 2, segs)
    want = tcfar.segmented_cfar(x, segs, G2_PROFILE.cfar, 2)
    assert kcfar.cascaded_cfar2d.launches == before + 1   # one launch for all segments
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _g2_crafted(rng, batch, nr=3404, segments=G2_PROFILE.cfar_segments, n_clutter=13):
    """G2-geometry RDMs (332 rows): the divisor-20 re-notch band of zero
    rows, exact ties, hits on every segment's edge columns, and a block of
    equal cells around one cell exactly on its threshold."""
    rdm = np.abs(rng.standard_normal((batch, 332, nr), dtype=np.float32)) + 0.5
    rdm[:, 148:183] = 0.0
    lo, hi = n_clutter + 1, 332 - n_clutter
    for b in range(batch):
        v, r = rng.integers(lo, hi, 400), rng.integers(0, nr - 1, 400)
        rdm[b, v, r] += 40.0
        rdm[b, v[::2], r[::2] + 1] = rdm[b, v[::2], r[::2]]      # exact ties
        for a, e in segments:
            rdm[b, rng.integers(lo, hi, 4), [a, a + 1, e - 2, e - 1]] += 40.0
    rdm[0, 60:124, nr - 80 : nr - 16] = _on_threshold(rng)   # its cell: (90, nr - 50)
    return rdm


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 52])
@pytest.mark.parametrize("cfg", [G2_PROFILE.cfar, CFARConfig(threshold=5.0, range_extend_cells=2),
                                 CFARConfig(threshold=5.0, range_detect=False)],
                         ids=["g2-cfar", "E2", "no-range-pass"])
def test_cascaded_cfar2d_kernel_g2_geometry(rng, cuda_device, batch, cfg):
    """Full G2 geometry (332 x 3404, three segments, the third starting at
    the misaligned column 951), batch 1 and the 52 of one window."""
    x = torch.from_numpy(_g2_crafted(rng, batch)).to(cuda_device)
    before = kcfar.cascaded_cfar2d.launches
    got = kcfar.cascaded_cfar2d(x, cfg, 13, G2_PROFILE.cfar_segments)
    want = tcfar.segmented_cfar(x, G2_PROFILE.cfar_segments, cfg, 13)
    assert kcfar.cascaded_cfar2d.launches == before + 1
    assert int(want[0].sum()) > 0 and bool(want[1][0, 90, 3354])   # the on-threshold cell
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# segments narrower than the 14-column range halo, misaligned starts, a row
# width that is not a multiple of 4, and every strip width of the build
SEGMENT_CASES = {
    "narrow-and-misaligned": (704, ((0, 5), (5, 13), (13, 700), (700, 704))),
    "one-column": (400, ((0, 1), (1, 137), (137, 138), (138, 400))),
    "odd-width": (411, ((0, 3), (3, 229), (229, 411))),
    "strips-of-128": (200, ((0, 100), (100, 200))),   # the 128-column build
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_cascaded_cfar2d_kernel_narrow_misaligned_segments(rng, cuda_device, case):
    nr, segments = SEGMENT_CASES[case]
    x = torch.from_numpy(_g2_crafted(rng, 3, nr, segments)).to(cuda_device)
    for cfg in (G2_PROFILE.cfar, CFARConfig(ref_cells=8, guard_cells=2, threshold=4.0,
                                            range_extend_cells=3)):
        before = kcfar.cascaded_cfar2d.launches
        got = kcfar.cascaded_cfar2d(x, cfg, 13, segments)
        want = tcfar.segmented_cfar(x, segments, cfg, 13)
        assert kcfar.cascaded_cfar2d.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cascaded_cfar2d_smem_matches_plan(cuda_device):
    """The shared memory the kernel lays out is what cfar_plan sized."""
    from radar_signal_process_tpu_torch.kernels import _build

    lib = _build.library()
    for tx in kcfar.STRIPS:
        for r, g, e in ((5, 7, 1), (1, 0, 0), (8, 2, 3), (5, 7, 127)):
            assert lib.rsp_cascaded_cfar_smem_bytes(tx, r, g, e) == kcfar.smem_bytes(tx, r, g, e)


@pytest.mark.gpu
def test_cascaded_cfar2d_kernel_on_threshold(rng, cuda_device):
    rdm = torch.from_numpy(_on_threshold(rng)).to(cuda_device)
    cfg = CFARConfig(threshold=5.0)
    f, v = kcfar.cascaded_cfar2d(rdm, cfg, 3)
    pf, pv = tcfar.cascaded_cfar2d(rdm, cfg, 3)
    assert bool(f[30, 30]) and torch.equal(f, pf) and torch.equal(v, pv)


@pytest.mark.gpu
def test_cascaded_cfar2d_kernel_rejects_bad_inputs(cuda_device):
    rdm = torch.zeros(2, 40, 50, device=cuda_device)
    with pytest.raises(ValueError, match="do not tile"):
        kcfar.cascaded_cfar2d(rdm, CFARConfig(), 3, ((0, 20), (25, 50)))
    with pytest.raises(ValueError, match="range_extend_cells"):
        kcfar.cascaded_cfar2d(rdm, dataclasses.replace(CFARConfig(), range_extend_cells=128), 3)
    with pytest.raises(ValueError, match="contiguous float32"):
        kcfar.cascaded_cfar2d(rdm.double(), CFARConfig(), 3)


# --------------------------------------------------------------------- slice
@pytest.mark.gpu
def test_stream_on_card_matches_cpu(tmp_path, rng, cuda_device):
    """The stream on the card goes through both kernels and agrees with the
    same stream on the CPU (plain versions)."""
    from radar_signal_process_tpu_torch.ingest import G2FrameReader
    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
    from radar_signal_process_tpu_torch.sim import write_g2_capture

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=64, point_prt=344, segment_points=(40, 80, 224),
        cfar_segments=((0, 40), (40, 120), (120, 344)), n_channels=2, n_beams=2,
    )
    shape = (3, 64, 344, 2)
    iq = (rng.integers(-300, 300, shape) + 1j * rng.integers(-300, 300, shape)).astype(np.complex64)
    iq[:, :, 200, 1] += 20000.0 * np.exp(1j * 2 * np.pi * 0.25 * np.arange(3 * 64)).reshape(3, 64)
    write_g2_capture(str(tmp_path), iq, prof, data_type=1)

    def run(device):
        pipe = StreamingPipeline(G2FrameReader(str(tmp_path), prof), prof, win_size=2,
                                 max_frames=3, device=device)
        return [(r.rdms.cpu(), r.flags.cpu(), r.cfar_hits) for r in pipe]

    launches = (krdm.doppler_rdm.launches, kcfar.cascaded_cfar2d.launches)
    got = run(cuda_device)
    assert krdm.doppler_rdm.launches == launches[0] + 2
    assert kcfar.cascaded_cfar2d.launches == launches[1] + 2   # one per window
    want = run("cpu")
    detector = make_detector(prof, device="cpu")   # plain CFAR
    for (g_rdm, g_flags, g_hits), (w_rdm, _, _) in zip(got, want):
        scale = float(w_rdm.abs().max())
        torch.testing.assert_close(g_rdm / scale, w_rdm / scale, rtol=RTOL, atol=2e-5)
        f, _, _ = detector(g_rdm)
        assert torch.equal(f, g_flags) and g_hits == int(f.sum())


# ------------------------------------------------------------------------ B3
# name -> (batch shape, n_prt, n_in, n_out, n_fft, DFT shift, columns around
# the segment in the row it is read from)
B3_CASES = {
    "g0-short": ((2,), 1536, 62, 62, 2048, False, (0, 504)),
    "g0-long": ((2,), 1536, 504, 512, 2048, False, (62, 0)),
    "n_in-100": ((1,), 200, 100, 100, 256, True, (0, 0)),
    "ragged-out": ((2,), 64, 100, 37, 128, False, (5, 3)),
    "batched-4d": ((2, 3), 48, 62, 70, 96, True, (0, 0)),
    "odd-prt": ((1,), 37, 30, 17, 64, True, (1, 0)),
    # wide shape (32-column tiles) on ragged edges
    "wide-ragged": ((3, 2), 200, 70, 300, 256, True, (2, 4)),
    # beyond the 1536-class P tile of one block: only a cluster holds it
    "n_prt-2048": ((2,), 2048, 504, 512, 2048, False, (62, 0)),
    "n_prt-4096-narrow": ((2,), 4096, 62, 62, 4096, False, (0, 504)),
    # odd column offset: the echo is not 16-byte aligned, 8-byte copies
    "x-8-byte": ((2,), 1536, 504, 512, 2048, False, (61, 1)),
}


def _b3_inputs(rng, device, batch, n_prt, n_in, n_out, n_fft, shift, around):
    lo, hi = around
    rows = _pc(rng, batch + (n_prt, lo + n_in + hi), device)
    echo = rows[..., lo : lo + n_in]                      # read in place
    m = rng.standard_normal((n_in, n_out)) + 1j * rng.standard_normal((n_in, n_out))
    m_re, m_im = (torch.from_numpy(p.astype(np.float32)).to(device) for p in (m.real, m.imag))
    w_re, w_im = _planes(make_window("hamming", n_prt), device, n_fft, shift)
    return echo, m_re, m_im, w_re, w_im


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(B3_CASES))
def test_fused_pc_rdm_kernel_matches_plain(rng, cuda_device, case):
    args = _b3_inputs(rng, cuda_device, *B3_CASES[case])
    before = kpcr.fused_pc_rdm.launches
    got = kpcr.fused_pc_rdm(*args)
    want = kpcr.fused_pc_rdm_plain(*args)
    torch.cuda.synchronize()
    assert kpcr.fused_pc_rdm.launches == before + 1
    assert got.shape == want.shape
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=B3_PEAK_ATOL * peak)


@pytest.mark.gpu
def test_fused_pc_rdm_kernel_rejects_bad_inputs(rng, cuda_device):
    echo, m_re, m_im, w_re, w_im = _b3_inputs(rng, cuda_device, (2, 3), 16, 10, 7, 32, False,
                                              (0, 0))
    with pytest.raises(ValueError, match="complex64"):
        kpcr.fused_pc_rdm(echo.to(torch.complex128), m_re, m_im, w_re, w_im)
    with pytest.raises(ValueError, match="unit fast-time stride"):
        t = echo.transpose(-1, -2).contiguous().transpose(-1, -2)
        kpcr.fused_pc_rdm(t, m_re, m_im, w_re, w_im)
    with pytest.raises(ValueError, match="contiguous float32"):
        kpcr.fused_pc_rdm(echo, m_re.double(), m_im, w_re, w_im)
    with pytest.raises(ValueError, match="contiguous float32"):
        kpcr.fused_pc_rdm(echo, m_re, m_im, w_re.cpu(), w_im)
    with pytest.raises(ValueError, match="merge"):
        kpcr.fused_pc_rdm(echo.transpose(0, 1), m_re, m_im, w_re, w_im)
    with pytest.raises(ValueError, match="batch 0"):
        kpcr.fused_pc_rdm(echo[:0], m_re, m_im, w_re, w_im)
    with pytest.raises(ValueError, match="DFT planes"):
        kpcr.fused_pc_rdm(echo[..., :15, :], m_re, m_im, w_re, w_im)
    long_echo, *planes = _b3_inputs(rng, cuda_device, (1,), 41000, 4, 3, 16, False, (0, 0))
    with pytest.raises(ValueError, match="shared memory"):
        kpcr.fused_pc_rdm(long_echo, *planes)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["g0-short", "g0-long"])
def test_fused_pc_rdm_kernel_large_dynamic_range(rng, cuda_device, case):
    """One target 1e5 above unit noise, held at the B3 tolerance against the
    plain version and at 1e-5 of the peak against the complex128 product."""
    echo, m_re, m_im, w_re, w_im = _b3_inputs(rng, cuda_device, *B3_CASES[case])
    n_prt = echo.shape[-2]
    pulses = torch.arange(n_prt, device=cuda_device)
    echo[1, :, 20] += 1e5 * torch.exp(2j * torch.pi * 0.211 * pulses).to(torch.complex64)
    got = kpcr.fused_pc_rdm(echo, m_re, m_im, w_re, w_im)
    want = kpcr.fused_pc_rdm_plain(echo, m_re, m_im, w_re, w_im)
    c128 = torch.complex128
    p = torch.matmul(echo.to(c128), torch.complex(m_re, m_im).to(c128))
    exact = torch.matmul(torch.complex(w_re, w_im).to(c128), p).abs()
    peak = float(want.abs().max())
    assert peak > 1e4 * float(want[0].mean())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=B3_PEAK_ATOL * peak)
    assert _c128_error(got, exact) <= C128_PEAK


# ----------------------------------------------------------------- B1 at G0
def _g0_rdm(rng, nr, n_clutter=6):
    """2048-row unshifted RDM: clutter rows zero at both ends, ties, hits in
    the edge columns, and one cell exactly on its threshold."""
    rdm = _rdm(rng, nv=2048, nr=nr, hits=80)
    rdm[: n_clutter + 1] = 0.0
    rdm[2048 - n_clutter :] = 0.0
    for r in (0, 1, nr - 2, nr - 1):
        rdm[int(rng.integers(20, 2000)), r] += 40.0
    rdm[500, 10:12] = 50.0
    block = _on_threshold(rng)[:40, :40]
    rdm[900:940, nr - 40 :] = block
    return rdm


@pytest.mark.gpu
@pytest.mark.parametrize("nr", [62, 512])
@pytest.mark.parametrize("cfg", [G0_PROFILE.cfar, CFARConfig(threshold=5.0, range_extend_cells=2)],
                         ids=["g0-cfar", "E2"])
def test_cascaded_cfar2d_kernel_bit_equal_at_g0(rng, cuda_device, nr, cfg):
    rdm = torch.from_numpy(_g0_rdm(rng, nr)).to(cuda_device)
    before = kcfar.cascaded_cfar2d.launches
    got_f, got_v = kcfar.cascaded_cfar2d(rdm, cfg, 6)
    want_f, want_v = tcfar.cascaded_cfar2d(rdm, cfg, 6)
    assert kcfar.cascaded_cfar2d.launches == before + 1
    assert int(want_f.sum()) > 0
    assert torch.equal(got_f, want_f) and torch.equal(got_v, want_v)


# ------------------------------------------------------------------- G0 chain
@pytest.mark.gpu
def test_g0_chain_on_card_matches_cpu(tmp_path, rng, cuda_device):
    """A G1 capture through the G0 chain on the card (B3 + B1) and on the CPU
    (plain versions): RDMs agree, the card's flags equal the plain CFAR on
    the card's RDM, and both measure the target."""
    from radar_signal_process_tpu_torch.config import G0ChainConfig
    from radar_signal_process_tpu_torch.ingest import G1FrameReader
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain
    from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses
    from radar_signal_process_tpu_torch.sim import write_g1_capture

    prof, cfg = G0_PROFILE, G0ChainConfig()
    n = prof.prt_per_frame
    fd = -60 * prof.prf / cfg.mtd_fft_length
    _, p_long = reference_pulses(prof)
    ramp = np.exp(1j * 2 * np.pi * fd * np.arange(n) * prof.prt)
    base = np.zeros((n, prof.point_prt), complex)
    s1 = prof.segment_starts[1]
    base[:, s1 + 100 : s1 + 100 + len(p_long)] += ramp[:, None] * p_long[None, :]
    noise = rng.standard_normal((2, n, prof.point_prt)) * 2.0
    left = np.round(5000 * base.real + noise[0]) + 1j * np.round(5000 * base.imag)
    right = np.round(4000 * base.real + noise[1]) + 1j * np.round(4000 * base.imag)
    write_g1_capture(str(tmp_path), left[None], right[None], freq_index=5, beam_pos=2)
    fl, fr, _, _ = G1FrameReader(str(tmp_path), n, prof.point_prt).read_frame(1)

    launches = (kpcr.fused_pc_rdm.launches, kcfar.cascaded_cfar2d.launches)
    got = G0Chain(prof, cfg, 5, 2, device=cuda_device).process_frame(fl, fr)
    torch.cuda.synchronize()
    assert kpcr.fused_pc_rdm.launches == launches[0] + 2
    assert kcfar.cascaded_cfar2d.launches == launches[1] + 2
    cpu = G0Chain(prof, cfg, 5, 2, device="cpu")
    want = cpu.process_frame(fl, fr)
    for seg in ("short", "long"):
        g, w = getattr(got, f"rdm_sum_{seg}").cpu(), getattr(want, f"rdm_sum_{seg}")
        peak = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=RTOL, atol=B3_PEAK_ATOL * peak)
        f, v = tcfar.cascaded_cfar2d(g, prof.cfar, cpu.n_clutter)
        assert torch.equal(f, getattr(got, f"flags_{seg}").cpu())
        assert torch.equal(v, getattr(got, f"vflags_{seg}").cpu())
    v_true = -cpu.wavelength * fd / 2.0
    r_true = 100 * prof.delta_r + cfg.r_sys_err_long - cfg.r_measure_err_long
    for res in (got, want):
        m = res.measurements_long
        assert bool(m.valid[0])
        assert abs(float(m.velocity_ms[0]) - v_true) < 0.3
        assert abs(float(m.range_m[0]) - r_true) < 2 * prof.delta_r


# ---------------------------------------------- the detection-quality path
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1536, 868), (1, 332, 3404), (4, 332, 3404)],
                         ids=["g1", "g2-single-cpi", "g2-sweep-batch"])
def test_doppler_rdm_kernel_new_shapes(rng, cuda_device, shape):
    """B2 at the shapes of the G1 chain (1536 x 1536 x 868, two beams) and
    of a single-CPI ``mtd_produce`` at G2 (batch 1, and the sweep's 4),
    against its plain version and the complex128 product."""
    n = shape[-2]
    pc = _pc(rng, shape, cuda_device)
    pc[0, :, shape[-1] // 3] += 300.0 * torch.exp(
        2j * torch.pi * 0.19 * torch.arange(n, device=cuda_device)).to(torch.complex64)
    w_re, w_im = _planes(make_window("kaiser", n), cuda_device)
    notch = (n // 2 - 1 - round(n / 150), n // 2 - 1 + round(n / 150))
    before = krdm.doppler_rdm.launches
    got = krdm.doppler_rdm(pc, w_re, w_im, notch)
    want = krdm.doppler_rdm_plain(pc, w_re, w_im, notch)
    assert krdm.doppler_rdm.launches == before + 1
    exact = torch.matmul(torch.complex(w_re, w_im).to(torch.complex128),
                         pc.to(torch.complex128)).abs()
    exact[:, notch[0] : notch[1] + 1] = 0.0
    peak = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=B3_PEAK_ATOL * peak)
    assert _c128_error(got, exact) <= C128_PEAK


@pytest.mark.gpu
def test_cascaded_cfar2d_kernel_threshold_sweep(rng, cuda_device):
    """Five thresholds over one batch in one process: bit-identical to the
    plain version at each, and one launch plan for all of them."""
    x = torch.from_numpy(_g2_crafted(rng, 4)).to(cuda_device)
    segs = G2_PROFILE.cfar_segments
    kcfar.cascaded_cfar2d(x, G2_PROFILE.cfar, 13, segs)
    plans = kcfar._launch_table.cache_info().currsize
    for t in (3.0, 4.3, 5.0, 6.1, 7.0):
        cfg = dataclasses.replace(G2_PROFILE.cfar, threshold=t)
        before = kcfar.cascaded_cfar2d.launches
        got = kcfar.cascaded_cfar2d(x, cfg, 13, segs)
        want = tcfar.segmented_cfar(x, segs, cfg, 13)
        assert kcfar.cascaded_cfar2d.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kcfar._launch_table.cache_info().currsize == plans


@pytest.mark.gpu
def test_sweep_on_card_matches_cpu(cuda_device):
    """``sweep_thresholds`` on the card (B2 once per SCR, B1 once per
    threshold per SCR) gives the table of the same sweep on the CPU: Pd,
    accuracy and PCF equal, the FA rate within 2 cells per frame."""
    from radar_signal_process_tpu_torch.evalx.sweep import sweep_thresholds

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=128, point_prt=512, segment_points=(32, 160, 320),
        cfar_segments=((0, 32), (32, 192), (192, 512)),
    )
    kw = dict(thresholds=[3.0, 4.3, 7.0], scr_db=[-10.0, 20.0], velocity_ms=-8.0,
              range_m=300.0, n_frames=3)
    launches = (krdm.doppler_rdm.launches, kcfar.cascaded_cfar2d.launches)
    got = sweep_thresholds(prof, device=cuda_device, **kw)
    assert krdm.doppler_rdm.launches == launches[0] + 2
    assert kcfar.cascaded_cfar2d.launches == launches[1] + 6
    want = sweep_thresholds(prof, device="cpu", **kw)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        for m in ("detection_rate", "accuracy", "localization_pcf"):
            assert g[m] == w[m] or (np.isnan(g[m]) and np.isnan(w[m])), (key, m)
        assert abs(g["false_alarm_rate"] - w["false_alarm_rate"]) <= 2 / (128 * 512), key
    assert got[(20.0, 3.0)]["detection_rate"] == 1.0


@pytest.mark.gpu
def test_g1_chain_on_card_matches_cpu(cuda_device):
    """The G1 chain at full width on the card against the same chain on the
    CPU (B2's plain version)."""
    from radar_signal_process_tpu_torch.config import G1_PROFILE
    from radar_signal_process_tpu_torch.models.g1_chain import g1_validation_chain
    from radar_signal_process_tpu_torch.sim import (
        apply_scr,
        synthesize_target_echo,
        synthetic_clutter,
    )

    target = synthesize_target_echo(G1_PROFILE, -5.7, 320.0)
    clutter = synthetic_clutter(G1_PROFILE, seed=7)
    echo = torch.from_numpy((apply_scr(target, clutter, 15.0, G1_PROFILE) + clutter)
                            .astype(np.complex64))
    before = krdm.doppler_rdm.launches
    got = g1_validation_chain(echo.to(cuda_device), G1_PROFILE)
    assert krdm.doppler_rdm.launches == before + 1
    want = g1_validation_chain(echo, G1_PROFILE)
    peak = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=B3_PEAK_ATOL * peak)
    assert int(got[:, 82:318].amax(dim=0).argmax()) + 82 == 128   # mid-segment peak
