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

from radar_signal_process_tpu_torch.config import G2_PROFILE, CFARConfig
from radar_signal_process_tpu_torch.kernels import cfar as kcfar
from radar_signal_process_tpu_torch.kernels import rdm as krdm
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from radar_signal_process_tpu_torch.ops.windows import make_window

RTOL, ATOL = 2e-4, 2e-3


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
     ((1, 48, 130), 64, False, None), ((5, 17, 3), None, True, (7, 9))],
    ids=["g2-rows", "ragged", "zero-padded", "tiny"],
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
    assert kcfar.cascaded_cfar2d.launches == before + 3
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
    assert kcfar.cascaded_cfar2d.launches == launches[1] + 6
    want = run("cpu")
    detector = make_detector(prof, device="cpu")   # plain CFAR
    for (g_rdm, g_flags, g_hits), (w_rdm, _, _) in zip(got, want):
        scale = float(w_rdm.abs().max())
        torch.testing.assert_close(g_rdm / scale, w_rdm / scale, rtol=RTOL, atol=2e-5)
        f, _, _ = detector(g_rdm)
        assert torch.equal(f, g_flags) and g_hits == int(f.sum())
