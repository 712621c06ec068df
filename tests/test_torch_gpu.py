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


def _renotch(rng, rdm, zero_rows):
    """``(rdm, zero_rows)`` for a B1 case: with ``zero_rows`` (a half-open
    Doppler row range, or a function of the row count giving one) those rows
    of a copy of ``rdm`` hold negative values, which the kernel must read as
    0.0 and the plain version multiplies by 0 (to -0)."""
    if zero_rows is None:
        return rdm, None
    a, b = zero_rows(rdm.shape[-2]) if callable(zero_rows) else zero_rows
    rdm = rdm.copy()
    rdm[..., a:b, :] = -(np.abs(rng.standard_normal(rdm[..., a:b, :].shape)) + 0.5)
    return rdm, (a, b)


def _plain_renotched(x, segments, cfg, n_clutter, zero_rows):
    """B1's plain version on ``x * keep[:, None]``, ``keep`` zero on
    ``zero_rows``: the CFAR stage's re-notch, then ``segmented_cfar``."""
    if zero_rows is not None:
        keep = torch.ones(x.shape[-2], dtype=x.dtype, device=x.device)
        keep[zero_rows[0] : zero_rows[1]] = 0.0
        x = x * keep[:, None]
    return tcfar.segmented_cfar(x, segments or ((0, x.shape[-1]),), cfg, n_clutter)


# the fused re-notch: no rows, or a band around the middle of the crop
NOTCH = {"whole": None, "renotched": lambda nv: (nv // 2 - nv // 10, nv // 2 + nv // 10 + 1)}


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
     ((52, 332, 3404), None, True, (163, 167)), ((3, 100, 301), 128, False, (60, 62)),
     ((65535, 17, 3), None, True, (7, 9))],
    ids=["g2-rows", "ragged", "zero-padded", "tiny", "g2-full", "ragged-k-padded", "batch-max"],
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
def test_doppler_rdm_kernel_long_chain_target(rng, cuda_device):
    """G1's K = 1536 with one target 1e5 above unit noise: the long chain the
    16-pulse partials exist for, within 1e-5 of the peak of the complex128
    product and the peak-scaled RDM tolerance of the plain version."""
    shape = (2, 1536, 868)
    pc = _pc(rng, shape, cuda_device)
    pulses = torch.arange(1536, device=cuda_device)
    pc[0, :, 433] += 1e5 * torch.exp(2j * torch.pi * 0.2503 * pulses).to(torch.complex64)
    w_re, w_im = _planes(make_window("kaiser", 1536), cuda_device)
    notch = (757, 777)
    got = krdm.doppler_rdm(pc, w_re, w_im, notch)
    want = krdm.doppler_rdm_plain(pc, w_re, w_im, notch)
    exact = torch.matmul(torch.complex(w_re, w_im).to(torch.complex128),
                         pc.to(torch.complex128)).abs()
    exact[:, notch[0] : notch[1] + 1] = 0.0
    peak = float(want.abs().max())
    assert peak > 1e7
    torch.testing.assert_close(got, want, rtol=RTOL, atol=B3_PEAK_ATOL * peak)
    assert _c128_error(got, exact) <= C128_PEAK


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft,n", [(332, 332), (100, 100), (64, 48), (17, 17), (1536, 1536)],
                         ids=["g2", "ragged", "zero-padded", "tiny", "g1"])
def test_wgmma_b_planes_kernel_bit_equal(rng, cuda_device, n_fft, n):
    """B2's W split on the card: the planes its main kernel reads, bit for bit
    those of the plain version (padding included)."""
    w_re = torch.from_numpy(rng.standard_normal((n_fft, n)).astype(np.float32)).to(cuda_device)
    w_im = torch.from_numpy(rng.standard_normal((n_fft, n)).astype(np.float32)).to(cuda_device)
    got = krdm.wgmma_b_planes(w_re, w_im)
    want = krdm.wgmma_b_planes_plain(w_re, w_im)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _sass_functions(lib_path) -> dict:
    """``cuobjdump -sass`` of the kernel library: mangled name -> SASS text."""
    import shutil
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or (CUDA_HOME and f"{CUDA_HOME}/bin/cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


@pytest.mark.gpu
def test_doppler_rdm_kernel_sass_is_wgmma_and_tma(cuda_device):
    """The built B2 main kernel runs its products as wgmma (HGMMA, no mma.sync
    HMMA) and takes W by a TMA-engine copy (UBLKCP, or UTMALDG for a tensor
    map)."""
    from radar_signal_process_tpu_torch.kernels import _build

    _build.library()
    funcs = _sass_functions(_build.library_path())
    b2 = [body for name, body in funcs.items() if "doppler_rdm_kernel" in name]
    assert len(b2) == 1, sorted(funcs)
    assert "HGMMA" in b2[0] and "HMMA" not in b2[0]
    assert "UBLKCP" in b2[0] or "UTMALDG" in b2[0]


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
@pytest.mark.parametrize("notch", list(NOTCH))
@pytest.mark.parametrize("case", list(INPUTS))
def test_cascaded_cfar2d_kernel_bit_equal(rng, cuda_device, case, notch):
    make, n_clutter, cfg = INPUTS[case]
    rdm, zero = _renotch(rng, np.ascontiguousarray(make(rng)), NOTCH[notch])
    rdm = torch.from_numpy(rdm).to(cuda_device)
    before = kcfar.cascaded_cfar2d.launches
    got_f, got_v = kcfar.cascaded_cfar2d(rdm, cfg, n_clutter, zero_rows=zero)
    want_f, want_v = _plain_renotched(rdm, None, cfg, n_clutter, zero)
    assert kcfar.cascaded_cfar2d.launches == before + 1
    assert torch.equal(got_f, want_f) and torch.equal(got_v, want_v)


@pytest.mark.gpu
@pytest.mark.parametrize("notch", list(NOTCH))
def test_cascaded_cfar2d_kernel_segments(rng, cuda_device, notch):
    segs = G2_PROFILE.cfar_segments
    rdm = np.stack([_rdm(rng, nv=48, nr=3404, hits=60) for _ in range(2)])
    rdm[:, :, [0, 227, 228, 950, 951, 3403]] += 40.0
    rdm, zero = _renotch(rng, rdm, NOTCH[notch])
    x = torch.from_numpy(rdm).to(cuda_device)
    before = kcfar.cascaded_cfar2d.launches
    got = kcfar.cascaded_cfar2d(x, G2_PROFILE.cfar, 2, segs, zero_rows=zero)
    want = _plain_renotched(x, segs, G2_PROFILE.cfar, 2, zero)
    assert kcfar.cascaded_cfar2d.launches == before + 1   # one launch for all segments
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cascaded_cfar2d_kernel_notched_rows_negative(rng, cuda_device):
    """The G2 re-notch band (rows 148-182) holds negative values and a +-inf
    free mix of magnitudes: read as 0.0, the flags are the plain version's
    on the product with the keep-mask (-0 where the row was negative)."""
    x = _g2_crafted(rng, 3)
    x[:, 148:183] = rng.standard_normal(x[:, 148:183].shape).astype(np.float32) * 1e3
    x[:, 150, :40] = -3.0e38
    x = torch.from_numpy(x).to(cuda_device)
    for cfg in (G2_PROFILE.cfar, dataclasses.replace(G2_PROFILE.cfar, method=1),
                CFARConfig(ref_cells=8, guard_cells=2, threshold=4.0, range_extend_cells=3)):
        got = kcfar.cascaded_cfar2d(x, cfg, 13, G2_PROFILE.cfar_segments, zero_rows=(148, 183))
        want = _plain_renotched(x, G2_PROFILE.cfar_segments, cfg, 13, (148, 183))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(want[1][:, 160:171].all())   # C8: the self-flagged band


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
    if nr >= 80:
        rdm[0, 60:124, nr - 80 : nr - 16] = _on_threshold(rng)   # its cell: (90, nr - 50)
    return rdm


@pytest.mark.gpu
@pytest.mark.parametrize("notch", list(NOTCH))
@pytest.mark.parametrize("batch", [1, 52])
@pytest.mark.parametrize("cfg", [G2_PROFILE.cfar, CFARConfig(threshold=5.0, range_extend_cells=2),
                                 CFARConfig(threshold=5.0, range_detect=False)],
                         ids=["g2-cfar", "E2", "no-range-pass"])
def test_cascaded_cfar2d_kernel_g2_geometry(rng, cuda_device, batch, cfg, notch):
    """Full G2 geometry (332 x 3404, three segments, the third starting at
    the misaligned column 951), batch 1 and the 52 of one window; renotched:
    the G2 re-notch band (148, 183) fused, its rows negative in memory."""
    x, zero = _renotch(rng, _g2_crafted(rng, batch), NOTCH[notch] and (148, 183))
    x = torch.from_numpy(x).to(cuda_device)
    before = kcfar.cascaded_cfar2d.launches
    got = kcfar.cascaded_cfar2d(x, cfg, 13, G2_PROFILE.cfar_segments, zero_rows=zero)
    want = _plain_renotched(x, G2_PROFILE.cfar_segments, cfg, 13, zero)
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
    "narrow-rdm": (60, ((0, 3), (3, 40), (40, 60))),  # the narrow body
}


@pytest.mark.gpu
@pytest.mark.parametrize("notch", list(NOTCH))
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_cascaded_cfar2d_kernel_narrow_misaligned_segments(rng, cuda_device, case, notch):
    nr, segments = SEGMENT_CASES[case]
    x, zero = _renotch(rng, _g2_crafted(rng, 3, nr, segments), NOTCH[notch])
    x = torch.from_numpy(x).to(cuda_device)
    for cfg in (G2_PROFILE.cfar, CFARConfig(ref_cells=8, guard_cells=2, threshold=4.0,
                                            range_extend_cells=3)):
        before = kcfar.cascaded_cfar2d.launches
        got = kcfar.cascaded_cfar2d(x, cfg, 13, segments, zero_rows=zero)
        want = _plain_renotched(x, segments, cfg, 13, zero)
        assert kcfar.cascaded_cfar2d.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("notch", list(NOTCH))
@pytest.mark.parametrize("body", ["tile", "narrow"])
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_cascaded_cfar2d_kernel_either_body(rng, cuda_device, monkeypatch, case, body, notch):
    """Each kernel body on every segment case, whichever ``cfar_plan``
    would pick for its width: the tile body on a narrow RDM, the narrow
    body (several strips a segment) on a wide one, bit for bit against the
    plain version, with the shipped windows and r = 8, g = 2, E = 3."""
    nr, segments = SEGMENT_CASES[case]
    x, zero = _renotch(rng, _g2_crafted(rng, 2, nr, segments), NOTCH[notch])
    x = torch.from_numpy(x).to(cuda_device)
    real = kcfar._launch_table

    def forced(*key):
        plan, table = real(*key)
        cfg = CFARConfig(ref_cells=key[3], guard_cells=key[4], range_extend_cells=key[5],
                         method=key[6])
        return kcfar.plan_for(key[0], key[1], cfg, 128 if body == "tile" else 0, 16,
                              body == "tile" and key[8] and nr % 4 == 0), table

    monkeypatch.setattr(kcfar, "_launch_table", forced)
    for cfg in (G2_PROFILE.cfar, CFARConfig(ref_cells=8, guard_cells=2, threshold=4.0,
                                            range_extend_cells=3)):
        got = kcfar.cascaded_cfar2d(x, cfg, 13, segments, zero_rows=zero)
        want = _plain_renotched(x, segments, cfg, 13, zero)
        assert int(want[0].sum()) > 0
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cascaded_cfar2d_smem_matches_plan(cuda_device):
    """The shared memory the kernel lays out is what cfar_plan sized, for
    every tile and the narrow body."""
    from radar_signal_process_tpu_torch.kernels import _build

    lib = _build.library()
    for r, g, e in ((5, 7, 1), (1, 0, 0), (8, 2, 3), (300, 7, 1)):
        for sw in kcfar.STRIPS:
            assert lib.rsp_cascaded_cfar_smem_bytes(sw, r, g, e) == kcfar.smem_bytes(sw, r, g)
        assert lib.rsp_cascaded_cfar_smem_bytes(0, r, g, e) == kcfar.narrow_smem_bytes(r, g, e)


@pytest.mark.gpu
@pytest.mark.parametrize("notch", list(NOTCH))
def test_cascaded_cfar2d_kernel_on_threshold(rng, cuda_device, notch):
    rdm, zero = _renotch(rng, _on_threshold(rng), NOTCH[notch] and (8, 20))
    rdm = torch.from_numpy(rdm).to(cuda_device)
    cfg = CFARConfig(threshold=5.0)
    f, v = kcfar.cascaded_cfar2d(rdm, cfg, 3, zero_rows=zero)
    pf, pv = _plain_renotched(rdm, None, cfg, 3, zero)
    assert bool(f[30, 30]) and torch.equal(f, pf) and torch.equal(v, pv)


@pytest.mark.gpu
def test_b1_division_by_five_is_ieee_on_every_float(cuda_device):
    """B1's division by the shipped r = 5 is an FMA sequence, not a
    division: on all 2^32 float32 bit patterns it gives __fdiv_rn(x, 5.0f)
    bit for bit."""
    assert kcfar.division_mismatches(cuda_device) == 0


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


@pytest.mark.gpu
def test_stream_graph_replays_match_cpu(tmp_path, rng, cuda_device):
    """Five windows on the card: the first runs eagerly, the second captures
    the window's graph, the rest replay it (B2 and B1 launched from Python
    twice in all).  Every window, held until the stream ends, agrees with
    the CPU's stream, its flags and detection list are those of the eager
    detector on the card over its RDMs, and a stream that emits only
    detections yields the same lists and flag counts."""
    from radar_signal_process_tpu_torch.ingest import G2FrameReader
    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
    from radar_signal_process_tpu_torch.sim import write_g2_capture

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=64, point_prt=344, segment_points=(40, 80, 224),
        cfar_segments=((0, 40), (40, 120), (120, 344)), n_channels=2, n_beams=2,
    )
    shape = (6, 64, 344, 2)
    iq = (rng.integers(-300, 300, shape) + 1j * rng.integers(-300, 300, shape)).astype(np.complex64)
    iq[:, :, 200, 1] += 20000.0 * np.exp(1j * 2 * np.pi * 0.25 * np.arange(6 * 64)).reshape(6, 64)
    write_g2_capture(str(tmp_path), iq, prof, data_type=1)

    def run(device, emit="full"):
        return list(StreamingPipeline(G2FrameReader(str(tmp_path), prof), prof, win_size=2,
                                      max_frames=6, emit=emit, device=device,
                                      use_host_parallel=False))

    launches = (krdm.doppler_rdm.launches, kcfar.cascaded_cfar2d.launches)
    got = run(cuda_device)
    assert krdm.doppler_rdm.launches == launches[0] + 2
    assert kcfar.cascaded_cfar2d.launches == launches[1] + 2
    want = run("cpu")
    assert [r.frame_idx for r in got] == [r.frame_idx for r in want] == [0, 1, 2, 3, 4]
    assert len({r.rdms.data_ptr() for r in got}) == len(got)
    plain = make_detector(prof, device="cpu")
    eager = make_detector(prof, max_detections=64, device=cuda_device)
    for g, w in zip(got, want):
        scale = float(w.rdms.abs().max())
        torch.testing.assert_close(g.rdms.cpu() / scale, w.rdms / scale, rtol=RTOL, atol=2e-5)
        f, _, _ = plain(g.rdms.cpu())
        assert torch.equal(f, g.flags.cpu()) and g.cfar_hits == int(f.sum()) > 0
        with torch.inference_mode():
            f, _, dets = eager(g.rdms)
        assert torch.equal(f, g.flags)
        for a, b in zip(g.detections, dets):
            assert torch.equal(a, b)
    lean = run(cuda_device, emit="detections")
    for g, d in zip(got, lean):
        assert d.rdms is None and d.flags is None and d.cfar_hits == g.cfar_hits
        for a, b in zip(g.detections, d.detections):
            assert torch.equal(a, b)


class _G1Frames:
    """A G1-format reader over frames in memory: frames from 1, ``(left,
    right, angles, meta)``; past the last one a short read."""

    def __init__(self, frames):
        self.frames = frames

    def read_frame(self, idx):
        if idx > len(self.frames):
            raise EOFError("end of the capture")
        f = self.frames[idx - 1]
        return f[0], f[1], np.zeros(f.shape[1]), {}


def _g1_frames(rng, n):
    """(n, 2, 1536, 1031) integer-valued frames, a target in both beams'
    long segment at 40 Doppler bins off zero velocity."""
    shape = (n, 2, 1536, 1031)
    x = (rng.integers(-300, 300, shape) + 1j * rng.integers(-300, 300, shape))
    ramp = np.exp(2j * np.pi * 40 / 1536 * np.arange(n * 1536)).reshape(n, 1, 1536)
    x[:, :, :, 600] += 2000.0 * ramp
    return x.astype(np.complex64)


@pytest.mark.gpu
def test_g1_window_on_card_matches_plain(rng, cuda_device):
    """One G1 window at its published widths (2 beams, 1536 x 1031, re-
    concatenated to 868 columns): the windowed stream on the card launches
    B2 and B1 once and agrees with the same stream on the CPU (plain
    versions); the beams are staged as one block, contiguous on the card."""
    from radar_signal_process_tpu_torch.config import G1_PROFILE
    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline, TwoBeamReader

    frames = _g1_frames(rng, 2)

    def run(device):
        pipe = StreamingPipeline(TwoBeamReader(_G1Frames(frames)), G1_PROFILE, win_size=4,
                                 max_detections=16, device=device, use_host_parallel=False)
        return pipe, [(r.rdms.cpu(), r.flags.cpu(), r.cfar_hits) for r in pipe]

    launches = (krdm.doppler_rdm.launches, kcfar.cascaded_cfar2d.launches)
    pipe, got = run(cuda_device)
    assert krdm.doppler_rdm.launches == launches[0] + 1
    assert kcfar.cascaded_cfar2d.launches == launches[1] + 1
    staged = pipe._stage(pipe._pin(TwoBeamReader(_G1Frames(frames)).read_frame(1)))
    assert staged.is_contiguous() and torch.equal(staged.cpu(), torch.from_numpy(frames[1]))
    _, want = run("cpu")
    assert len(got) == len(want) == 1
    (g_rdm, g_flags, g_hits), (w_rdm, _, _) = got[0], want[0]
    assert tuple(g_rdm.shape) == (2, 4, 1536, 868)
    scale = float(w_rdm.abs().max())
    torch.testing.assert_close(g_rdm / scale, w_rdm / scale, rtol=RTOL, atol=2e-5)
    f, _, _ = make_detector(G1_PROFILE, device="cpu")(g_rdm)
    assert torch.equal(f, g_flags) and g_hits == int(f.sum()) > 0


@pytest.mark.gpu
def test_cli_stream_g1_capture_on_card(tmp_path, rng, cuda_device, capsys):
    """``cli stream --profile G1`` over a written three-frame G1 capture on
    the card: two windows, bit for bit those of the windowed stream on the
    reader's frames, and a clean end at the capture's end."""
    import json

    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import G1_PROFILE
    from radar_signal_process_tpu_torch.ingest import g1_reader_class
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline, TwoBeamReader
    from radar_signal_process_tpu_torch.sim import write_g1_capture

    frames = _g1_frames(rng, 3)
    write_g1_capture(str(tmp_path), frames[:, 0], frames[:, 1])
    got = []
    args = cli.build_parser().parse_args(
        ["stream", "--input", str(tmp_path), "--profile", "G1", "--frames", "8"])
    assert cli.cmd_stream(args, on_result=got.append) == 0
    assert [f["frame"] for f in json.loads(capsys.readouterr().out.strip())["frames"]] == [0, 1]
    reader = TwoBeamReader(g1_reader_class()(str(tmp_path)))
    want = list(StreamingPipeline(reader, G1_PROFILE, max_detections=16, device=cuda_device))
    assert [r.frame_idx for r in got] == [r.frame_idx for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert torch.equal(g.rdms, w.rdms) and torch.equal(g.flags, w.flags)
        for a, b in zip(g.detections, w.detections):
            assert torch.equal(a, b)
        assert g.cfar_hits == w.cfar_hits > 0


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
    # three beams side by side along phase 2's columns (32 tiles of 48)
    "beams-3": ((3,), 1536, 504, 512, 2048, False, (62, 0)),
    # n_prt no multiple of the 16-pulse stage (W by TMA, its last stage
    # half past n_prt), beams whose columns share a tile
    "n_prt-1000": ((2,), 1000, 62, 62, 1024, False, (0, 504)),
    # one beam, the short segment's width: phase 2 in blocks of one warpgroup
    "beams-1-narrow": ((1,), 1536, 62, 62, 2048, False, (0, 504)),
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
@pytest.mark.parametrize("n_in,n_out", [(62, 62), (504, 512), (30, 17), (100, 300)],
                         ids=["g0-short", "g0-long", "ragged", "wide"])
def test_pc_operator_image_kernel_bit_equal(rng, cuda_device, n_in, n_out):
    """B3's M image on the card: the image phase 1 reads, bit for bit that of
    the plain version (padding included)."""
    m_re = torch.from_numpy(rng.standard_normal((n_in, n_out)).astype(np.float32)).to(cuda_device)
    m_im = torch.from_numpy(rng.standard_normal((n_in, n_out)).astype(np.float32)).to(cuda_device)
    got = kpcr.pc_operator_image(m_re, m_im)
    want = kpcr.pc_operator_image_plain(m_re, m_im)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_fused_pc_rdm_kernel_follows_operator_edits(rng, cuda_device):
    """The kept M image is made again after an in-place edit of either PC
    plane: the kernel then agrees with the plain version on the new M."""
    echo, m_re, m_im, w_re, w_im = _b3_inputs(rng, cuda_device, *B3_CASES["ragged-out"])
    for edit in (None, m_re, m_im):
        if edit is not None:
            edit.mul_(-0.5).add_(0.25)
        got = kpcr.fused_pc_rdm(echo, m_re, m_im, w_re, w_im)
        want = kpcr.fused_pc_rdm_plain(echo, m_re, m_im, w_re, w_im)
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=B3_PEAK_ATOL * float(want.abs().max()))


@pytest.mark.gpu
def test_fused_pc_rdm_kernel_sass_is_wgmma_and_tma(cuda_device):
    """B3's kernels run their products as wgmma (HGMMA, no mma.sync HMMA) and
    stage by the TMA engine: a bulk copy of B's image (UBLKCP) and a tensor
    box of A (UTMALDG)."""
    from radar_signal_process_tpu_torch.kernels import _build

    _build.library()
    funcs = _sass_functions(_build.library_path())
    b3 = {name: body for name, body in funcs.items()
          if "pc_kernel" in name or "rdm_kernel" in name and "doppler" not in name}
    assert len(b3) == 3, sorted(funcs)   # pc_kernel, rdm_kernel<1>, rdm_kernel<2>
    for name, body in b3.items():
        assert "HGMMA" in body and "HMMA" not in body, name
        assert "UBLKCP" in body and "UTMALDG" in body, name


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
    # a 41000-pulse echo, which the earlier cluster design refused (its P
    # slice outgrew shared memory), is taken: P goes through L2
    long_echo, *planes = _b3_inputs(rng, cuda_device, (1,), 41000, 4, 3, 16, False, (0, 0))
    before = kpcr.fused_pc_rdm.launches
    got = kpcr.fused_pc_rdm(long_echo, *planes)
    want = kpcr.fused_pc_rdm_plain(long_echo, *planes)
    assert kpcr.fused_pc_rdm.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=B3_PEAK_ATOL * float(want.abs().max()))


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
@pytest.mark.parametrize("notch", list(NOTCH))
@pytest.mark.parametrize("nr", [62, 512])
@pytest.mark.parametrize("cfg", [G0_PROFILE.cfar, CFARConfig(threshold=5.0, range_extend_cells=2)],
                         ids=["g0-cfar", "E2"])
def test_cascaded_cfar2d_kernel_bit_equal_at_g0(rng, cuda_device, nr, cfg, notch):
    """G0's two segments: 62 columns (no wider than a narrow strip, so the
    narrow body) and 512 (the tile body, staged by TMA)."""
    rdm, zero = _renotch(rng, _g0_rdm(rng, nr), NOTCH[notch])
    rdm = torch.from_numpy(rdm).to(cuda_device)
    plan = kcfar.cfar_plan(((0, nr),), 2035, 1, cfg)
    assert plan.narrow == (nr == 62) and plan.tma == (nr == 512)
    before = kcfar.cascaded_cfar2d.launches
    got_f, got_v = kcfar.cascaded_cfar2d(rdm, cfg, 6, zero_rows=zero)
    want_f, want_v = _plain_renotched(rdm, None, cfg, 6, zero)
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


def _g0_on_card(cuda_device, cfg=None, **kwargs):
    """A G0 chain whose beams come from host arrays (the pinned ring) and
    one fed the same beams as tensors already on the card."""
    from radar_signal_process_tpu_torch.config import G0ChainConfig
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

    cfg = cfg or G0ChainConfig(mtd_clutter_v=0.9)     # two n_clutter over the plan
    return (G0Chain(G0_PROFILE, cfg, device=cuda_device, **kwargs),
            G0Chain(G0_PROFILE, cfg, device=cuda_device, **kwargs))


# frequencies whose n_clutter alternate between the two keys of ``_g0_on_card``
G0_TWO_KEYS = [0, 10, 1, 9, 0, 10, 2, 8]


@pytest.mark.gpu
@pytest.mark.parametrize("width", [None, -10.0], ids=["graph", "eager-spectral-width"])
def test_g0_chain_pinned_beams_equal_card_beams(rng, cuda_device, width):
    """Frames alternating two ``n_clutter`` (each key's eager frame, capture
    and replays; or every frame eager where spectral widths are upsampled):
    beams staged from host arrays through the pinned ring give, bit for bit,
    what the chain gives on beams already on the card.  With a sync each
    frame no slot is ever waited on."""
    pinned, card = _g0_on_card(cuda_device, spectral_width_db=width,
                               spectral_width_interp=1 if width is None else 2)
    keys = {pinned.frame_params(fi, 0)[1] for fi in G0_TWO_KEYS}
    assert len(keys) == 2
    for k, (fi, (left, right)) in enumerate(zip(G0_TWO_KEYS, _g0_frames(rng, len(G0_TWO_KEYS)))):
        got = pinned.process_frame(left, right, freq_index=fi, beam_pos=k % 12)
        want = card.process_frame(torch.from_numpy(left).to(cuda_device),
                                  torch.from_numpy(right).to(cuda_device),
                                  freq_index=fi, beam_pos=k % 12)
        for a, b in zip(_g0_tensors(got), _g0_tensors(want), strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (k, fi)
        torch.cuda.synchronize()
    n = len(G0_TWO_KEYS)
    assert (pinned.pinned_frames, pinned.slot_waits) == (n, 0)
    assert card.pinned_frames == 0 and card._ring is None
    if width is None:
        assert pinned.captures == 2 and pinned.replays == n - 2
    else:
        assert pinned.eager_frames == n


@pytest.mark.gpu
def test_g0_chain_caller_may_overwrite_its_beams_at_once(rng, cuda_device):
    """Frames handed over with no sync between them, each caller's array
    overwritten as soon as ``process_frame`` returns: every result is that
    of its own beams, and every frame went through the ring."""
    pinned, card = _g0_on_card(cuda_device)
    frames = list(_g0_frames(rng, len(G0_TWO_KEYS)))
    left, right = (np.empty_like(frames[0][0]) for _ in range(2))
    got = []
    for fi, (a, b) in zip(G0_TWO_KEYS, frames):
        left[...], right[...] = a, b
        got.append(pinned.process_frame(left, right, freq_index=fi, beam_pos=3))
        left[...] = right[...] = 0
    for fi, res, (a, b) in zip(G0_TWO_KEYS, got, frames):
        want = card.process_frame(torch.from_numpy(a).to(cuda_device),
                                  torch.from_numpy(b).to(cuda_device), freq_index=fi, beam_pos=3)
        assert all(torch.equal(x, y) for x, y in zip(_g0_tensors(res), _g0_tensors(want),
                                                      strict=True)), fi
    assert pinned.pinned_frames == len(frames)


@pytest.mark.gpu
def test_g0_chain_converts_a_complex128_beam(rng, cuda_device):
    """A complex128 beam, converted on its way into the pinned slot, gives
    the result of its complex64 cast, bit for bit."""
    wide, narrow = _g0_on_card(cuda_device)
    for k, (left, right) in enumerate(_g0_frames(rng, 3)):
        got = wide.process_frame(left.astype(np.complex128), right.astype(np.complex128),
                                 freq_index=4, beam_pos=k)
        want = narrow.process_frame(left, right, freq_index=4, beam_pos=k)
        assert all(torch.equal(x, y) for x, y in zip(_g0_tensors(got), _g0_tensors(want),
                                                      strict=True)), k
    assert wide.pinned_frames == narrow.pinned_frames == 3


def _g0_frames(rng, n):
    """``n`` G0 frames (left, right): a target at long cell 100 and short
    cell 20, 30 Doppler bins off zero, in fresh noise each."""
    from radar_signal_process_tpu_torch.config import G0ChainConfig
    from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses

    prof = G0_PROFILE
    rows = prof.prt_per_frame
    p_short, p_long = reference_pulses(prof)
    ramp = np.exp(1j * 2 * np.pi * (-30 / G0ChainConfig().mtd_fft_length) * np.arange(rows))
    base = np.zeros((rows, prof.point_prt), complex)
    s0, s1 = prof.segment_starts
    base[:, s0 + 20 : s0 + 20 + len(p_short)] += ramp[:, None] * p_short[None, :]
    base[:, s1 + 100 : s1 + 100 + len(p_long)] += ramp[:, None] * p_long[None, :]
    for _ in range(n):
        noise = rng.standard_normal((2, 2, rows, prof.point_prt)) * 20.0
        yield tuple((gain * 500 * base + noise[i, 0] + 1j * noise[i, 1]).astype(np.complex64)
                    for i, gain in enumerate((1.0, 0.8)))


def _g0_tensors(res):
    from radar_signal_process_tpu_torch.models.g0_chain import _leaves

    return [t for t in _leaves(res) if t is not None]


def _g0_chains(cuda_device, cfg=None):
    """A chain on the graph path and one held to eager frames on the card."""
    from radar_signal_process_tpu_torch.config import G0ChainConfig
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

    cfg = cfg or G0ChainConfig()
    graphed = G0Chain(G0_PROFILE, cfg, device=cuda_device)
    eager = G0Chain(G0_PROFILE, cfg, device=cuda_device)
    eager._graphed = False
    return graphed, eager


@pytest.mark.gpu
def test_g0_chain_graph_equals_eager_on_card(rng, cuda_device):
    """Every frequency of the 11-point plan at two beam positions: each
    frame of the graph path (eager first frame, capture, replays) gives the
    eager path's RDMs, flags, detection lists and measurements bit for bit."""
    graphed, eager = _g0_chains(cuda_device)
    plan = [(fi, bp) for fi in range(11) for bp in (2, 9)]
    for (fi, bp), (left, right) in zip(plan, _g0_frames(rng, len(plan))):
        got = graphed.process_frame(left, right, freq_index=fi, beam_pos=bp)
        want = eager.process_frame(left, right, freq_index=fi, beam_pos=bp)
        assert got.measurements_long.spectral_width is None
        for a, b in zip(_g0_tensors(got), _g0_tensors(want), strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (fi, bp)
        assert bool(got.measurements_long.valid.any())
    assert graphed.replays == len(plan) - 1 and graphed.eager_frames == 1


@pytest.mark.gpu
def test_g0_chain_graph_results_outlive_later_frames(rng, cuda_device):
    """A result held from frame n is unchanged after frames n+1 to n+3."""
    graphed, _ = _g0_chains(cuda_device)
    frames = list(_g0_frames(rng, 6))
    held = []
    for k, (left, right) in enumerate(frames):
        res = graphed.process_frame(left, right, freq_index=k % 11, beam_pos=k % 12)
        held.append((res, [t.clone() for t in _g0_tensors(res)]))
    torch.cuda.synchronize()
    for res, copy in held:
        assert all(torch.equal(a, b) for a, b in zip(_g0_tensors(res), copy, strict=True))
    assert graphed.replays == 5


@pytest.mark.gpu
def test_g0_chain_graph_counts_one_capture_per_key(rng, cuda_device):
    """A clutter velocity at which the plan's frequencies give two
    ``n_clutter``: one eager frame and one capture each, then only replays."""
    from radar_signal_process_tpu_torch.config import G0ChainConfig

    graphed, eager = _g0_chains(cuda_device, G0ChainConfig(mtd_clutter_v=0.9))
    plan = [0, 10, 1, 9, 2, 8, 5, 10, 0]
    keys = [graphed.frame_params(fi, 0)[1] for fi in plan]
    assert len(set(keys)) == 2
    for k, (fi, (left, right)) in enumerate(zip(plan, _g0_frames(rng, len(plan)))):
        got = graphed.process_frame(left, right, freq_index=fi, beam_pos=4)
        want = eager.process_frame(left, right, freq_index=fi, beam_pos=4)
        for a, b in zip(_g0_tensors(got), _g0_tensors(want), strict=True):
            assert torch.equal(a, b), (k, fi)
    assert graphed.captures == graphed.eager_frames == 2
    assert graphed.replays == len(plan) - 2


@pytest.mark.gpu
def test_g0_chain_replay_makes_no_hidden_sync(rng, cuda_device):
    """Everything after the beams' copy of a replayed frame runs with
    ``torch.cuda.set_sync_debug_mode("error")``: no hidden sync."""
    graphed, eager = _g0_chains(cuda_device)
    frames = list(_g0_frames(rng, 3))
    for left, right in frames[:2]:
        graphed.process_frame(left, right, freq_index=4, beam_pos=1)
    copy_beams = graphed.beams

    def beams(*args, **kwargs):
        out = copy_beams(*args, **kwargs)
        torch.cuda.set_sync_debug_mode("error")
        return out

    graphed.beams = beams
    try:
        got = graphed.process_frame(*frames[2], freq_index=7, beam_pos=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graphed.replays == 2 and graphed.captures == 1
    want = eager.process_frame(*frames[2], freq_index=7, beam_pos=3)
    assert all(torch.equal(a, b) for a, b in zip(_g0_tensors(got), _g0_tensors(want)))


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
@pytest.mark.parametrize("notch", list(NOTCH))
def test_cascaded_cfar2d_kernel_threshold_sweep(rng, cuda_device, notch):
    """Five thresholds over one batch in one process: bit-identical to the
    plain version at each, and one launch plan for all of them."""
    x, zero = _renotch(rng, _g2_crafted(rng, 4), NOTCH[notch] and (148, 183))
    x = torch.from_numpy(x).to(cuda_device)
    segs = G2_PROFILE.cfar_segments
    kcfar.cascaded_cfar2d(x, G2_PROFILE.cfar, 13, segs, zero_rows=zero)
    plans = kcfar._launch_table.cache_info().currsize
    for t in (3.0, 4.3, 5.0, 6.1, 7.0):
        cfg = dataclasses.replace(G2_PROFILE.cfar, threshold=t)
        before = kcfar.cascaded_cfar2d.launches
        got = kcfar.cascaded_cfar2d(x, cfg, 13, segs, zero_rows=zero)
        want = _plain_renotched(x, segs, cfg, 13, zero)
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


# ------------------------------------------------------------ the stage bus
_STAGE_PROFILE = dataclasses.replace(
    G2_PROFILE, prt_per_frame=64, point_prt=344, segment_points=(40, 80, 224),
    cfar_segments=((0, 40), (40, 120), (120, 344)), n_channels=2, n_beams=2,
)


@pytest.fixture
def stage_frames(tmp_path, monkeypatch):
    """``cli simulate`` (a target at -5.7 m/s, 60 m: segment-local cell 10)
    then ``cli ingest``, 3 frames under the profile name STAGE."""
    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import PROFILES

    monkeypatch.setitem(PROFILES, "STAGE", _STAGE_PROFILE)
    cap = str(tmp_path / "cap")
    assert cli.main(["simulate", "--output", cap, "--profile", "STAGE", "--frames", "3",
                     "--velocity", "-5.7", "--range", "60", "--scr", "25"]) == 0
    assert cli.main(["ingest", "--input", cap, "--output", str(tmp_path / "frames"),
                     "--profile", "STAGE", "--frames", "3"]) == 0
    return tmp_path


@pytest.mark.gpu
def test_stage_bus_on_card_matches_plain(cuda_device, stage_frames):
    """``cli mtd`` then ``cli detect`` on the card: B2 once per frame pair,
    B1 once per frame; the RDMs within tolerance of the CPU run (plain
    versions), the flags bit for bit those of the plain CFAR on the RDMs the
    card wrote."""
    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.utils import load_frame

    root = stage_frames
    common = ["--profile", "STAGE", "--frames", "2", "--win-size", "2"]
    launches = (krdm.doppler_rdm.launches, kcfar.cascaded_cfar2d.launches)
    for dev in ("cuda", "cpu"):
        assert cli.main(["mtd", "--input", str(root / "frames"), "--output",
                         str(root / f"rdm_{dev}"), "--device", dev] + common) == 0
    assert krdm.doppler_rdm.launches == launches[0] + 2
    assert cli.main(["detect", "--input", str(root / "rdm_cuda"), "--output", str(root / "det"),
                     "--profile", "STAGE", "--frames", "2", "--device", "cuda"]) == 0
    assert kcfar.cascaded_cfar2d.launches == launches[1] + 2
    detector = make_detector(_STAGE_PROFILE, max_detections=64, device="cpu")
    for f in range(2):
        got = load_frame(str(root / "rdm_cuda"), f)[0]["rdm"]
        want = load_frame(str(root / "rdm_cpu"), f)[0]["rdm"]
        peak = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-5 * peak)
        flags, vflags, dets = detector(torch.from_numpy(got))
        arrays = load_frame(str(root / "det"), f)[0]
        np.testing.assert_array_equal(arrays["flags"], flags.numpy())
        np.testing.assert_array_equal(arrays["vflags"], vflags.numpy())
        cols = set(arrays["det_r"][arrays["det_valid"]].tolist())
        assert {50, 130} & cols, cols       # the target's mid and long segment cells


@pytest.mark.gpu
def test_detect_thresholds_on_card_equal_single_runs(cuda_device, stage_frames):
    """``cli detect --thresholds`` on the card: one B1 launch per threshold
    per frame, each threshold's files equal to ``--threshold T``'s."""
    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.utils import load_frame

    root = stage_frames
    assert cli.main(["mtd", "--input", str(root / "frames"), "--output", str(root / "rdm"),
                     "--profile", "STAGE", "--frames", "2", "--win-size", "2",
                     "--device", "cuda"]) == 0
    common = ["--input", str(root / "rdm"), "--profile", "STAGE", "--frames", "2",
              "--device", "cuda"]
    before = kcfar.cascaded_cfar2d.launches
    assert cli.main(["detect", "--output", str(root / "sweep"), "--thresholds", "3", "5",
                     "7"] + common) == 0
    assert kcfar.cascaded_cfar2d.launches == before + 3 * 2
    for t in ("3", "5", "7"):
        assert cli.main(["detect", "--output", str(root / f"single{t}"), "--threshold", t]
                        + common) == 0
        for f in range(2):
            got = load_frame(str(root / f"sweep_T{t}"), f)[0]
            want = load_frame(str(root / f"single{t}"), f)[0]
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"T{t} {key}")


# --------------------------------------------------------- multi-device layer
def _wrapped_blocks(rdm, sp, h):
    """Each range shard's halo-extended block, as ``sharded_cascaded_cfar2d``
    has ``halo_exchange`` deliver it (the ring wraps at the global edges;
    the right halo is wider by the columns that make a row whole 16 bytes)."""
    local = rdm.shape[-1] // sp
    w = local + 2 * h + -(local + 2 * h) % 4
    ext = torch.cat([rdm[..., -h:], rdm, rdm[..., : w - local - h]], dim=-1)
    return [(s * local, ext[..., s * local : s * local + w].contiguous()) for s in range(sp)]


@pytest.mark.gpu
@pytest.mark.parametrize("notch", list(NOTCH))
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("shape,segments", [
    ((4, 332, 3404), G2_PROFILE.cfar_segments),
    ((3, 96, 344), ((0, 24), (24, 104), (104, 344))),
], ids=["g2", "cut"])
def test_b1_extended_blocks_match_whole(rng, cuda_device, sp, shape, segments, notch):
    """B1 once per halo-extended block (the sharded CFAR's route on the card),
    centres stitched, equals B1 over the whole RDM and its plain version,
    bit for bit, at shards that cut the segments; the re-notch band's
    self-flagging rows included (fused into the load when renotched).  The
    G2 blocks (1730 and 879 columns, widened to 1732 and 880) take the TMA
    staging path."""
    from radar_signal_process_tpu_torch.parallel.sharding import extended_block_cfar

    b, nv, nr = shape
    rdm = (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32)
    rdm[:, nv // 2 - 4 : nv // 2 + 3] = 0.0
    for _ in range(40 * b):
        rdm[rng.integers(0, b), rng.integers(12, nv - 12), rng.integers(0, nr)] += 40.0
    rdm, zero = _renotch(rng, rdm, NOTCH[notch] and (nv // 2 - 4, nv // 2 + 3))
    x = torch.from_numpy(rdm).to(cuda_device)
    cfg, n_clutter = G2_PROFILE.cfar, 6
    h = cfg.ref_cells + cfg.guard_cells + 2 * cfg.range_extend_cells
    whole_f, whole_v = kcfar.cascaded_cfar2d(x, cfg, n_clutter, segments, zero_rows=zero)
    before = kcfar.cascaded_cfar2d.launches
    parts = [extended_block_cfar(blk, cfg, n_clutter, nr, segments, c0, nr // sp, h,
                                 zero_rows=zero)
             for c0, blk in _wrapped_blocks(x, sp, h)]
    assert kcfar.cascaded_cfar2d.launches == before + sp
    got_f = torch.cat([f for f, _ in parts], -1)
    got_v = torch.cat([v for _, v in parts], -1)
    assert torch.equal(got_f, whole_f) and torch.equal(got_v, whole_v)
    plain_f, _ = _plain_renotched(torch.from_numpy(rdm), segments, cfg, n_clutter, zero)
    np.testing.assert_array_equal(got_f.cpu().numpy(), plain_f.numpy())
    assert bool(whole_f.any())


@pytest.mark.gpu
def test_world1_nccl_sharded_pipeline_matches_unsharded(rng, cuda_device):
    """A world-1 NCCL group (``initialize_distributed`` without torchrun's
    environment) and a (1, 1) mesh on the card: the sharded pipeline runs B2
    and B1 (at sp = 1 on the rank's block as it is) and gives the unsharded
    chain's RDM and the flags of B1 rerun on it."""
    import torch.distributed as dist

    from radar_signal_process_tpu_torch.models.detect import detect_rdm
    from radar_signal_process_tpu_torch.models.mtd_pipeline import mtd_produce
    from radar_signal_process_tpu_torch.parallel import make_mesh, make_sharded_pipeline
    from radar_signal_process_tpu_torch.parallel.multihost import initialize_distributed

    prof = dataclasses.replace(G2_PROFILE, prt_per_frame=64)
    shape = (2, 64, prof.point_prt)
    echo = _pc(rng, shape, cuda_device)
    echo[..., 1004] += 40.0 * torch.exp(2j * np.pi * 0.2 * torch.arange(64, device=cuda_device))
    assert initialize_distributed("cuda") == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(("dp", "sp"), (1, 1), "cuda")
        before = (krdm.doppler_rdm.launches, kcfar.cascaded_cfar2d.launches)
        rdm, flags, _ = make_sharded_pipeline(prof, mesh, n_clutter=6, renotch_divisor=20)(echo)
        torch.cuda.synchronize()
        assert (krdm.doppler_rdm.launches, kcfar.cascaded_cfar2d.launches) == (
            before[0] + 1, before[1] + 1)
    finally:
        dist.destroy_process_group()
    want = mtd_produce(echo, prof)
    peak = float(want.abs().max())
    assert bool(((rdm - want).abs() <= 2e-5 * peak + RTOL * want.abs()).all())
    rerun, _ = detect_rdm(rdm, prof, 6)
    assert torch.equal(flags, rerun) and bool(flags.any())


# ----------------------------------------------------------------- block path
BLOCK_PROFILE = dataclasses.replace(
    G2_PROFILE, prt_per_frame=64, point_prt=344, segment_points=(40, 80, 224),
    cfar_segments=((0, 40), (40, 120), (120, 344)), n_channels=2, n_beams=3,
)


@pytest.mark.gpu
def test_block_path_on_card_matches_windowed(tmp_path, rng, cuda_device, monkeypatch):
    """``StreamingPipeline(use_host_parallel=True)`` on the card: 4 frames in
    blocks of 2 windows launch B2 and B1 once per block and compress each
    frame once; RDMs agree with the windowed path's, flags equal the plain
    CFAR on the block's own RDMs."""
    from radar_signal_process_tpu_torch.ingest import G2FrameReader
    from radar_signal_process_tpu_torch.models import host_parallel as hp
    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
    from radar_signal_process_tpu_torch.sim import write_g2_capture

    prof = BLOCK_PROFILE
    shape = (4, 64, 344, 2)
    iq = (rng.integers(-300, 300, shape) + 1j * rng.integers(-300, 300, shape)).astype(np.complex64)
    iq[:, :, 200, 1] += 20000.0 * np.exp(1j * 2 * np.pi * 0.25 * np.arange(4 * 64)).reshape(4, 64)
    write_g2_capture(str(tmp_path), iq, prof, data_type=1)
    calls = []
    real = hp.segmented_pulse_compression
    monkeypatch.setattr(hp, "segmented_pulse_compression",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def run(**kw):
        pipe = StreamingPipeline(G2FrameReader(str(tmp_path), prof), prof, win_size=2,
                                 max_frames=4, device=cuda_device, **kw)
        return [(r.frame_idx, r.rdms.cpu(), r.flags.cpu(), r.cfar_hits) for r in pipe]

    before = (krdm.doppler_rdm.launches, kcfar.cascaded_cfar2d.launches)
    got = run(use_host_parallel=True, block_windows=2)
    assert (krdm.doppler_rdm.launches - before[0], kcfar.cascaded_cfar2d.launches - before[1]) \
        == (2, 2)
    assert len(calls) == 4
    want = run()
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 1, 2]
    detector = make_detector(prof, device="cpu")
    for (_, g_rdm, g_flags, g_hits), (_, w_rdm, _, _) in zip(got, want):
        scale = float(w_rdm.abs().max())
        torch.testing.assert_close(g_rdm / scale, w_rdm / scale, rtol=RTOL, atol=2e-5)
        f, _, _ = detector(g_rdm)
        assert torch.equal(f, g_flags) and g_hits == int(f.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
def test_cascade_detector_and_flags_on_card(rng, cuda_device, transposed):
    """``make_cascade_detector`` and ``make_flags`` on the card run B1 once a
    call and equal their plain versions on the CPU."""
    from radar_signal_process_tpu_torch.models import detect as tdetect
    from radar_signal_process_tpu_torch.models import host_parallel as hp

    prof = BLOCK_PROFILE
    rdm = (rng.standard_normal((2, 3, 64, 344)).astype(np.float32)) ** 2
    rdm[..., 8:56, 100] += 30.0
    x = np.ascontiguousarray(np.swapaxes(rdm, -1, -2)) if transposed else rdm
    det = tdetect.make_cascade_detector(prof, 4, transposed=transposed, device=cuda_device)
    before = kcfar.cascaded_cfar2d.launches
    got = det(torch.from_numpy(x).to(cuda_device))
    assert kcfar.cascaded_cfar2d.launches == before + 1
    want = tdetect.make_cascade_detector(prof, 4, transposed=transposed, device="cpu")(
        torch.from_numpy(x))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    before = kcfar.cascaded_cfar2d.launches
    flags = hp.make_flags(prof, 4, device=cuda_device)(rdm)
    assert kcfar.cascaded_cfar2d.launches == before + 1
    for g, w in zip(flags, hp.make_flags(prof, 4, device="cpu")(rdm)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_prefer_native_on_card_raises(cuda_device):
    from radar_signal_process_tpu_torch.models.detect import make_cascade_detector

    with pytest.raises(ValueError, match="native"):
        make_cascade_detector(BLOCK_PROFILE, 4, transposed=True, prefer_native=True,
                              device=cuda_device)
