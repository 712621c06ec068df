"""B1/B2 wrappers of the port against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held against the JAX op and the Pallas kernel in interpret mode (B2 within
the repo's f32 tolerance, B1 flags bit for bit).  The CUDA kernels
themselves run only on a GPU, in ``test_torch_gpu.py`` (same input classes)
and in ``chip_smoke.py`` at G2 geometry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu.kernels import cascaded_cfar2d_pallas, doppler_rdm_pallas
from radar_signal_process_tpu.ops import cfar as jcfar
from radar_signal_process_tpu.ops import mtd as jmtd
from radar_signal_process_tpu_torch.config import G2_PROFILE, CFARConfig
from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.kernels import cfar as kcfar
from radar_signal_process_tpu_torch.kernels import pc_rdm as kpcr
from radar_signal_process_tpu_torch.kernels import rdm as krdm
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from radar_signal_process_tpu_torch.ops import mtd as tmtd
from radar_signal_process_tpu_torch.ops.windows import make_window
from tests.test_torch_gpu import INPUTS, _on_threshold, _rdm, _ties
from tests.test_torch_import import as_config

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-3


def _pc(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _planes(window, n_fft=None, shift=True):
    return tuple(torch.from_numpy(p) for p in krdm.dft_planes(window, n_fft, shift))


# ------------------------------------------------------------------------ B2
@pytest.mark.parametrize(
    "n,nr,divisor,kind",
    [(332, 40, 150, "kaiser"), (96, 300, 20, "kaiser"), (48, 64, None, "hamming"),
     (96, 64, 10, "kaiser")],
    ids=["g2-rows", "div20", "no-notch", "wide-notch"],
)
def test_doppler_rdm_plain_matches_pallas(rng, n, nr, divisor, kind):
    pc = _pc(rng, (2, n, nr))
    w = make_window(kind, n, 8.0)
    want = np.asarray(doppler_rdm_pallas(
        jnp.asarray(pc), w, notch_divisor=divisor, interpret=True
    ))
    w_re, w_im = _planes(w)
    got = krdm.doppler_rdm(
        torch.from_numpy(pc), w_re, w_im, tmtd.notch_rows(n, divisor)
    ).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_doppler_rdm_plain_matches_fft_form(rng):
    """The DFT-plane contraction equals the windowed FFT + notch
    (``doppler_process`` + ``zero_velocity_notch``) of both packages."""
    pc = _pc(rng, (3, 332, 50))
    w = make_window("kaiser", 332, 8.0)
    w_re, w_im = _planes(w)
    got = krdm.doppler_rdm(torch.from_numpy(pc), w_re, w_im, tmtd.notch_rows(332, 150))
    fft = tmtd.zero_velocity_notch(tmtd.doppler_process(torch.from_numpy(pc), w), divisor=150)
    jfft = np.asarray(jmtd.zero_velocity_notch(
        jmtd.doppler_process(jnp.asarray(pc), w, use_matmul=False), divisor=150
    ))
    np.testing.assert_allclose(got.numpy(), fft.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), jfft, rtol=RTOL, atol=ATOL)
    assert (got[:, 163:168] == 0).all()


def test_doppler_rdm_zero_padded_plane(rng):
    """Rectangular plane (n_fft > n), unshifted: the JAX FFT form's result."""
    pc = _pc(rng, (2, 48, 30))
    w = make_window("hamming", 48)
    w_re, w_im = _planes(w, n_fft=64, shift=False)
    got = krdm.doppler_rdm(torch.from_numpy(pc), w_re, w_im, (0, -1)).numpy()
    want = np.asarray(jmtd.doppler_process(jnp.asarray(pc), w, n_fft=64, shift=False))
    assert got.shape == (2, 64, 30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_doppler_rdm_cpu_dispatch_and_validation(rng):
    pc = torch.from_numpy(_pc(rng, (2, 16, 20)))
    w_re, w_im = _planes(make_window("kaiser", 16))
    before = krdm.doppler_rdm.launches
    got = krdm.doppler_rdm(pc, w_re, w_im, (6, 8))
    torch.testing.assert_close(
        got, krdm.doppler_rdm_plain(pc, w_re, w_im, (6, 8)), rtol=0, atol=0
    )
    assert krdm.doppler_rdm.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="do not match"):
        krdm.doppler_rdm(pc[:, :15], w_re, w_im, (6, 8))


# ------------------------------------------------------------------------ B1
@pytest.mark.parametrize("case", list(INPUTS))
def test_cascaded_cfar2d_plain_bit_equal(rng, case):
    make, n_clutter, cfg = INPUTS[case]
    rdm = make(rng)
    jcfg = as_config(cfg, jconfig)
    want_f, want_v = jcfar.cascaded_cfar2d(jnp.asarray(rdm), jcfg, n_clutter)
    pal_f, pal_v = cascaded_cfar2d_pallas(jnp.asarray(rdm), jcfg, n_clutter, interpret=True)
    got_f, got_v = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), cfg, n_clutter)
    for got, want in ((got_v, want_v), (got_f, want_f), (got_v, pal_v), (got_f, pal_f)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_f.any()


def test_cascaded_cfar2d_on_threshold_follows_ops_cfar(rng):
    """On the threshold the port follows ``ops.cfar`` (division by float(r)):
    the cell is flagged.  The Pallas kernel's ``* (1/r)`` mean rounds one ulp
    higher and drops it — a fault of that reference kernel (ROADMAP C1); it
    agrees with the port on every other cell."""
    rdm = _on_threshold(rng)
    cfg, jcfg = CFARConfig(threshold=5.0), jconfig.CFARConfig(threshold=5.0)
    want_f, want_v = jcfar.cascaded_cfar2d(jnp.asarray(rdm), jcfg, 3)
    got_f, got_v = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), cfg, 3)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_f[30, 30] and got_v[30, 30]
    pal_f, pal_v = (np.asarray(x).copy() for x in cascaded_cfar2d_pallas(
        jnp.asarray(rdm), jcfg, 3, interpret=True))
    for got, pal in ((got_f, pal_f), (got_v, pal_v)):
        diff = np.argwhere(got.numpy() != pal)
        assert diff.tolist() in ([], [[30, 30]])


def test_cascaded_cfar2d_segments_cpu_dispatch(rng):
    """With the G2 segment table the wrapper is ``segmented_cfar`` on the CPU."""
    segs = G2_PROFILE.cfar_segments
    rdm = np.stack([_rdm(rng, nv=48, nr=3404, hits=40) for _ in range(2)])
    before = kcfar.cascaded_cfar2d.launches
    got_f, got_v = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), G2_PROFILE.cfar, 2, segs)
    want_f, want_v = jcfar.segmented_cfar(jnp.asarray(rdm), segs, jconfig.G2_PROFILE.cfar, 2)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert kcfar.cascaded_cfar2d.launches == before


# name -> (segments, cropped rows nvu, batch, CFAR config, expected staged
# tile width (0: the narrow body), expected staging: TMA (row stride a
# multiple of 16 bytes) or cp.async)
PLANS = {
    "g2": (G2_PROFILE.cfar_segments, 303, 52, G2_PROFILE.cfar, 256, True),
    "g2-batch1": (G2_PROFILE.cfar_segments, 303, 1, G2_PROFILE.cfar, 256, True),
    "sweep": (G2_PROFILE.cfar_segments, 303, 4, G2_PROFILE.cfar, 256, True),
    # G0's short segment, no wider than a narrow strip: the narrow body
    "g0-short": (((0, 62),), 2035, 1, CFARConfig(), 0, False),
    "g0-long": (((0, 512),), 2035, 1, CFARConfig(), 128, True),
    # segments narrower than the 14-column range halo, misaligned starts
    "tiny": (((0, 3), (3, 20), (20, 21), (21, 150)), 23, 2, CFARConfig(threshold=2.0), 128,
             False),
    "mid": (((0, 100), (100, 127)), 40, 2, CFARConfig(), 128, False),
    "narrow-only": (((0, 5), (5, 13)), 7, 3, CFARConfig(ref_cells=1, guard_cells=0), 0, False),
    "narrow-segments": (((0, 3), (3, 40), (40, 64)), 60, 2, CFARConfig(), 0, False),
    "one-past-narrow": (((0, 3), (3, 40), (40, 65)), 60, 2, CFARConfig(), 128, False),
    "E127": (((0, 700),), 50, 3, CFARConfig(range_extend_cells=127), 1024, True),
    # the halo-extended blocks of a G2 window on sp = 2 and 4 range shards,
    # their rows widened to whole 16 bytes (the last segment takes the columns)
    "halo-sp2": (kcfar.extended_segments(3404, G2_PROFILE.cfar_segments, 0, 1702, 14)[:-1]
                 + ((965, 1732),), 303, 52, G2_PROFILE.cfar, 256, True),
    "halo-sp4": (kcfar.extended_segments(3404, G2_PROFILE.cfar_segments, 851, 851, 14)[:-1]
                 + ((114, 880),), 303, 52, G2_PROFILE.cfar, 256, True),
    # the edge ranks' blocks: a dummy segment of wrapped columns first or last
    "halo-sp2-last": (kcfar.extended_segments(3404, G2_PROFILE.cfar_segments, 1702, 1702, 14)[:-1]
                      + ((1716, 1732),), 303, 52, G2_PROFILE.cfar, 256, True),
    "halo-sp4-first": (kcfar.extended_segments(3404, G2_PROFILE.cfar_segments, 0, 851, 14)[:-1]
                       + ((242, 880),), 303, 52, G2_PROFILE.cfar, 256, True),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_cfar_plan_covers_every_cell_once(case):
    """The block map of the one B1 launch: every output cell of the RDM
    belongs to exactly one block, every clutter-row column to exactly one
    first-band block, a block fits the card (threads, shared memory), its
    columns start on 16-byte boundaries (the tile body) or lie in one
    segment (the narrow body), and the shape takes the body and the staging
    path it should, from the shape alone."""
    segments, nvu, batch, cfg, sw, tma = PLANS[case]
    plan = kcfar.cfar_plan(segments, nvu, batch, cfg)
    r, g, e = cfg.ref_cells, cfg.guard_cells, cfg.range_extend_cells
    nr = segments[-1][1]
    assert (0 if plan.narrow else plan.sw, plan.tma) == (sw, tma)
    assert plan.narrow == (nr <= kcfar.NARROW_TX)
    if plan.narrow:
        assert plan.halo == 2 * e + r + g and plan.tx == kcfar.NARROW_TX
        assert plan.sw == plan.tx + 2 * plan.halo and plan.threads == kcfar.narrow_threads(r, g, e)
        assert plan.threads % 32 == 0 and plan.sw <= plan.threads <= 1024
        assert plan.smem == kcfar.narrow_smem_bytes(r, g, e) <= kcfar.SMEM_LIMIT
        assert plan.n_strips == sum(-(-(b - a) // plan.tx) for a, b in segments)
    else:
        assert plan.halo >= 2 * e + r + g and plan.halo % 4 == 0
        assert plan.tx == sw - 2 * plan.halo and plan.tx % 4 == 0
        assert plan.threads == sw // kcfar.COLS <= 1024
        assert plan.smem == kcfar.smem_bytes(sw, r, g) <= kcfar.SMEM_LIMIT
        assert plan.n_strips == -(-nr // plan.tx)
    assert plan.table == tuple((a, b - a) for a, b in segments)
    assert plan.n_bands == -(-nvu // plan.band_rows)
    cells = np.zeros((nvu, nr), np.int32)
    crop = np.zeros(nr, np.int32)
    for block in range(plan.n_blocks):
        x0, x1, y_begin, y_end = kcfar.plan_tile(plan, block)
        assert 0 <= x0 < x1 <= nr and 0 <= y_begin < nvu
        if plan.narrow:
            assert any(a <= x0 and x1 <= b for a, b in segments)
        else:
            assert (x0 - plan.halo) % 4 == 0 and x1 == min(x0 + plan.tx, nr)
        cells[y_begin:y_end, x0:x1] += 1
        if y_begin == 0:
            crop[x0:x1] += 1
    assert (cells == 1).all() and (crop == 1).all()
    assert not kcfar.cfar_plan(segments, nvu, batch, cfg, aligned=False).tma


def test_cfar_plan_bands():
    """G2 keeps long bands (the velocity pipeline fills once per 101 rows)
    in strips of 224 columns, five blocks of 64 threads an SM; the mesh's
    halo-extended blocks take G2's bands too, whole waves of the card (one
    at sp = 4, two at sp = 2), and the sweep's batch one wave of bands of
    31 rows; the single G0 segments cut their 2035 rows into short
    bands, so the one RDM of a call still spreads over the card, the short
    segment into bands of one 4-row step."""
    g2 = kcfar.cfar_plan(G2_PROFILE.cfar_segments, 303, 52, G2_PROFILE.cfar)
    assert (g2.sw, g2.tx, g2.threads, g2.band_rows, g2.n_bands) == (256, 224, 64, 101, 3)
    assert g2.n_blocks * 52 == 2496 and g2.smem == 43048   # five blocks per SM
    assert 233472 // (g2.smem + 1024) == 5
    slots = 5 * kcfar.H100_SMS
    for case, waves in (("halo-sp2", 2), ("halo-sp4", 1), ("halo-sp2-last", 2),
                        ("halo-sp4-first", 1)):
        segments, nvu, batch, cfg = PLANS[case][:4]
        plan = kcfar.cfar_plan(segments, nvu, batch, cfg)
        assert (plan.sw, plan.band_rows) == (256, 101)
        assert -(-plan.n_blocks * batch // slots) == waves
    sweep = kcfar.cfar_plan(G2_PROFILE.cfar_segments, 303, 4, G2_PROFILE.cfar)
    assert (sweep.sw, sweep.band_rows) == (256, 31)
    assert sweep.n_blocks * 4 <= slots   # one wave, 14 steps a block
    short = kcfar.cfar_plan(((0, 62),), 2035, 1, CFARConfig())
    long = kcfar.cfar_plan(((0, 512),), 2035, 1, CFARConfig())
    assert (short.narrow, short.band_rows, long.sw, long.band_rows) == (True, 4, 128, 12)
    for plan in (short, long):
        assert plan.n_blocks >= 2 * kcfar.H100_SMS and plan.band_rows <= 16
    with pytest.raises(ValueError, match="segments"):
        kcfar.cfar_plan(tuple((i, i + 1) for i in range(kcfar.MAX_SEGMENTS + 1)), 10, 1,
                        CFARConfig())
    with pytest.raises(ValueError, match="threads"):
        kcfar.cfar_plan(((0, 100),), 50, 1, CFARConfig(ref_cells=300))


@pytest.mark.parametrize("band_rows,steps", [(1, 7), (4, 7), (5, 8), (8, 8), (12, 9), (101, 32)])
def test_cfar_plan_cost_counts_whole_steps_and_waves(band_rows, steps):
    """The band model prices a band by its whole 4-row steps (the 2(g+r) =
    24 rows of pipeline fill at FILL_SHARE) and a launch by its whole waves
    of resident blocks: one block past a full wave costs a second wave."""
    cfg = G2_PROFILE.cfar
    fill = 2 * (cfg.guard_cells + cfg.ref_cells) // kcfar.ROWS
    per_step = steps - (1 - kcfar.FILL_SHARE) * fill
    slots = 5 * kcfar.H100_SMS   # five blocks of the 256-column tile an SM
    for n_blocks, waves in ((slots, 1), (slots + 1, 2)):
        plan = kcfar.plan_for(((0, 224),), n_blocks * band_rows, cfg, 256, band_rows)
        assert plan.n_blocks == n_blocks
        assert kcfar.plan_cost(plan, 1, cfg) == pytest.approx(waves * per_step)


# ------------------------------------------------------- B1 with the re-notch
def _renotch_case(rng, shape, negative: bool):
    """RDMs with hits, segment-edge hits and, where ``negative``, negative
    values in the divisor-20 notch rows (NaN-free), so the re-notch's
    product gives -0 there."""
    rdm = (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32)
    b, nv, nr = shape
    for _ in range(20 * b):
        rdm[rng.integers(0, b), rng.integers(4, nv - 4), rng.integers(0, nr)] += 40.0
    rdm[..., [0, 23, 24, 103, 104, nr - 1]] += 40.0
    lo, hi = tmtd.notch_rows(nv, 20)
    if negative:
        rdm[:, lo : hi + 1] = -(np.abs(rng.standard_normal((b, hi + 1 - lo, nr))) * 30.0
                                ).astype(np.float32)
    return rdm, (lo, hi + 1)


@pytest.mark.parametrize("negative", [False, True], ids=["positive", "notched-negative"])
@pytest.mark.parametrize("cfg", [CFARConfig(threshold=5.0), CFARConfig(threshold=3.0, method=1),
                                 CFARConfig(threshold=4.0, range_extend_cells=2)],
                         ids=["go", "so", "E2"])
def test_cascaded_cfar2d_zero_rows_matches_jax(rng, cfg, negative):
    """``zero_rows`` is the re-notch fused into B1: the wrapper's flags equal
    the JAX ``segmented_cfar`` on ``zero_velocity_notch(rdm, divisor=20)``,
    and, per segment, ``cascaded_cfar2d_pallas`` in interpret mode on it."""
    segments = ((0, 24), (24, 104), (104, 160))
    rdm, zero = _renotch_case(rng, (2, 64, 160), negative)
    notched = jmtd.zero_velocity_notch(jnp.asarray(rdm), divisor=20)
    jcfg = as_config(cfg, jconfig)
    want_f, want_v = jcfar.segmented_cfar(notched, segments, jcfg, 4)
    got_f, got_v = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), cfg, 4, segments, zero_rows=zero)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    pal = [cascaded_cfar2d_pallas(notched[..., a:b], jcfg, 4, interpret=True) for a, b in segments]
    np.testing.assert_array_equal(got_v.numpy(), np.concatenate([np.asarray(v) for _, v in pal], -1))
    np.testing.assert_array_equal(got_f.numpy(), np.concatenate([np.asarray(f) for f, _ in pal], -1))
    assert got_f.any()


def test_cascaded_cfar2d_zero_rows_is_the_product(rng):
    """The plain route is ``rdm * keep[:, None]`` then ``segmented_cfar``:
    equal to the wrapper without ``zero_rows`` on the product; an empty or
    clipped range means no notch or the rows inside the RDM."""
    rdm, zero = _renotch_case(rng, (3, 48, 120), True)
    x = torch.from_numpy(rdm)
    keep = torch.ones(48)
    keep[zero[0] : zero[1]] = 0.0
    cfg = CFARConfig(threshold=5.0)
    want = kcfar.cascaded_cfar2d(x * keep[:, None], cfg, 3)
    for z in (zero, (zero[0], zero[1])):
        got = kcfar.cascaded_cfar2d(x, cfg, 3, zero_rows=z)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = kcfar.cascaded_cfar2d_plain(x, cfg, 3, None, zero)
    assert torch.equal(plain[0], want[0]) and torch.equal(plain[1], want[1])
    none = kcfar.cascaded_cfar2d(x, cfg, 3)
    for z in (None, (10, 10), (30, 5), (60, 90)):
        got = kcfar.cascaded_cfar2d(x, cfg, 3, zero_rows=z)
        assert torch.equal(got[0], none[0]) and torch.equal(got[1], none[1])
    keep_all = torch.ones(48)
    keep_all[40:] = 0.0
    tail = kcfar.cascaded_cfar2d(x * keep_all[:, None], cfg, 3)
    got = kcfar.cascaded_cfar2d(x, cfg, 3, zero_rows=(40, 99))
    assert torch.equal(got[0], tail[0]) and torch.equal(got[1], tail[1])


def test_ops_cfar_general_form_matches_ext1_form(rng):
    """The port's two cascade forms (branch-free E=1 and the general
    running-max loop the kernel follows) agree on ties and edges."""
    rdm = torch.from_numpy(_ties(rng))
    cfg = CFARConfig(threshold=5.0)
    f1, _ = tcfar.cascaded_cfar2d(rdm, cfg, 6)
    used = rdm[7:-6]
    rflag = tcfar.cfar1d(used, 5, 7, 5.0, 0, dim=-1)
    vflag = tcfar.cfar1d(used, 5, 7, 5.0, 0, dim=-2)
    # general form with E=1, written out
    best_v = torch.full_like(used, -torch.inf)
    best_o = torch.zeros(used.shape, dtype=torch.int32)
    for d in (-1, 0, 1):
        val = torch.where(tcfar._shift_range(rflag, d, False),
                          tcfar._shift_range(used, d, 0.0), torch.tensor(-torch.inf))
        take = val > best_v
        best_v = torch.where(take, val, best_v)
        best_o = torch.where(take, torch.full_like(best_o, d), best_o)
    win = vflag & (best_v > -torch.inf)
    mark = torch.zeros_like(win)
    for d in (-1, 0, 1):
        mark |= tcfar._shift_range(win & (best_o == d), -d, False)
    assert torch.equal(f1[7:-6], mark)


# --------------------------------------------------------------------- build
def test_build_without_nvcc_raises(monkeypatch):
    """No toolkit: the build fails loudly and leaves no library behind."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    path = _build.library_path()
    if path.exists():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not path.exists()


def test_library_path_is_content_addressed():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("librsp_kernels-") and path.suffix == ".so"
    assert path == _build.library_path()
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == ["cfar.cu", "pc_rdm.cu", "rdm.cu"]
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == ["cgemm_3xtf32.cuh",
                                                                 "sm90_async.cuh"]
    assert _build.CSRC / "cgemm_3xtf32.cuh" in _build._sources()
    assert _build.CSRC / "sm90_async.cuh" in _build._sources()


def test_library_path_follows_header_edits(tmp_path, monkeypatch):
    """A header is part of the hash: editing it names a new library, so the
    sources that include it are rebuilt."""
    for src in _build._sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "cgemm_3xtf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before


# ------------------------------------------------- the 3xTF32 error model
# B2 (csrc/rdm.cu) and B3 (csrc/pc_rdm.cu) run their complex products on
# the tensor cores through wgmma: each operand split as hi = rna_tf32(a),
# lo = rna_tf32(a - hi), three TF32 products per real product (lo.lo
# dropped), partial sums restarted every 16 (B2) or 32 (B3) deep K and
# rounded into an FP32 accumulator.  B2's form is emulated by _wgmma_3xtf32_rdm, B3's two
# products by _wgmma_3xtf32_cgemm: each product's 8-term sum is added into
# the partial with truncation toward zero, the pessimistic reading of the
# tensor core's rounding.
def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """rna_tf32, the rounding of cvt.rna.tf32.f32: to nearest, ties away from
    zero, to 10 explicit mantissa bits (the low 13 bits of the float32 pattern
    cleared).  The kernels compute it with the same integer add and mask."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)  # the float32 subtraction is exact


def _to_f32_toward_zero(x: np.ndarray) -> np.ndarray:
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)                      # TF32 spacing at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp * 0.49, 1 + ulp * 0.51,
                  1 + ulp * 1.5, 3.1415927], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), one, 1 + ulp, 1 + 2 * ulp, 3.140625], np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), want)
    hi, lo = _split_tf32(x)
    assert (hi.view(np.uint32) & 0x1FFF == 0).all() and (lo.view(np.uint32) & 0x1FFF == 0).all()
    assert (np.abs(x - hi - lo) <= np.abs(x) * 2.0**-22).all()


def _c64(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _with_target(x, col, freq):
    """One target 1e5 above unit noise in fast-time column `col`."""
    x = x.copy()
    x[:, col] += (1e5 * np.exp(2j * np.pi * freq * np.arange(x.shape[0]))).astype(np.complex64)
    return x


# 3xTF32 error against float64 over the float32 matmul's, at most this
_3XTF32_OVER_F32 = 6.0


def _wgmma_3xtf32_rdm(w: np.ndarray, x: np.ndarray, period: int = krdm.STAGE_PULSES) -> np.ndarray:
    """|W X| as csrc/rdm.cu forms it: D^T = Xr^T B_r + Xi^T B_i with
    B_r = [Wr; Wi]^T, B_i = [-Wi; Wr]^T, each operand split into TF32 hi/lo,
    six TF32 products per 8-pulse step (the kernel's order, lo.lo dropped),
    each product's 8-term sum added into the partial with the tensor core's
    truncation (the pessimistic reading: every wgmma truncates), the partial
    restarted every `period` pulses and added into FP32 totals rounded to
    nearest."""
    n_fft, k = w.shape
    (brh, brl), (bih, bil) = (_split_tf32(np.concatenate(p).astype(np.float32)) for p in (
        (w.real, w.imag), (-w.imag, w.real)))
    (xrh, xrl), (xih, xil) = _split_tf32(x.real), _split_tf32(x.imag)
    terms = ((xrl, brh), (xrh, brl), (xil, bih), (xih, bil), (xrh, brh), (xih, bih))
    acc = np.zeros((x.shape[1], 2 * n_fft), np.float32)
    for k0 in range(0, k, period):
        part = np.zeros_like(acc, dtype=np.float64)
        for s in range(k0, min(k0 + period, k), 8):
            ks = slice(s, s + 8)
            for xa, b in terms:
                prod = xa[ks].T.astype(np.float64) @ b[:, ks].T.astype(np.float64)
                part = _to_f32_toward_zero(part + prod).astype(np.float64)
        acc += part.astype(np.float32)
    return np.abs(acc[:, :n_fft] + 1j * acc[:, n_fft:].astype(np.float64)).T


@pytest.mark.parametrize("target", [False, True], ids=["noise", "target-1e5"])
def test_3xtf32_error_model_b2(rng, target):
    """B2 at a G2-like 332 x 64 slice (the transposed real wgmma form, 16-pulse
    partials, as rdm.cu flushes): inside the card tolerances against float64
    and near float32's error."""
    x = _c64(rng, (332, 64))
    if target:
        x = _with_target(x, 21, 0.137)
    w_re, w_im = (p.numpy() for p in _planes(make_window("kaiser", 332, 8.0)))
    w = (w_re + 1j * w_im).astype(np.complex64)
    exact = np.abs(w.astype(np.complex128) @ x.astype(np.complex128))
    got = _wgmma_3xtf32_rdm(w, x)
    f32 = np.abs(w @ x)
    peak = exact.max()
    err, f32_err = np.abs(got - exact).max(), np.abs(f32 - exact).max()
    assert err <= 1e-5 * peak                                    # the complex128 bound
    # the B2 card tolerance; with the target, its peak-scaled form (test_torch_gpu.py)
    np.testing.assert_allclose(got, f32, rtol=RTOL, atol=2e-5 * peak if target else ATOL)
    assert err <= _3XTF32_OVER_F32 * f32_err


@pytest.mark.parametrize("target", [False, True], ids=["noise", "target-1e5"])
@pytest.mark.parametrize("k,rows,freq", [(332, 1, 0.137), (1536, 8, 0.2503)], ids=["k332", "k1536"])
def test_3xtf32_error_model_b2_wgmma_chain(rng, k, rows, freq, target):
    """The flush period against the long chain: at K = 332 (G2) and 1536 (G1,
    every 8th Doppler row; the target peaks in a kept row), with noise and
    with a target 1e5 above it, B2's 16-pulse partials stay within 1e-5 of
    the peak of the complex128 product."""
    x = _c64(rng, (k, 48))
    if target:
        x = _with_target(x, 17, freq)
    w_re, w_im = (p.numpy() for p in _planes(make_window("kaiser", k, 8.0)))
    w = (w_re + 1j * w_im).astype(np.complex64)[::rows]
    exact = np.abs(w.astype(np.complex128) @ x.astype(np.complex128))
    got = _wgmma_3xtf32_rdm(w, x)
    peak = exact.max()
    assert np.argmax(exact) // x.shape[1] == np.argmax(got) // x.shape[1]
    assert np.abs(got - exact).max() <= 1e-5 * peak
    if k == 1536:  # what the flush is for: one truncating chain over G1's K is not
        assert np.abs(_wgmma_3xtf32_rdm(w, x, period=k) - exact).max() > 1e-5 * peak


# the W split of the wgmma form: shapes (n_fft, n) of the card's B2 cases
SPLIT_SHAPES = {"g2": (332, 332), "ragged": (100, 100), "zero-padded": (64, 48),
                "tiny": (17, 17), "g1-rows": (200, 1536)}


def _detile(planes: torch.Tensor) -> np.ndarray:
    """wgmma_b_planes' image -> (4, tiles * 2 TILE_ROWS, stages * STAGE_PULSES)."""
    t, s = planes.shape[:2]
    p = planes.permute(2, 0, 3, 5, 1, 4, 6).reshape(4, t * 2 * krdm.TILE_ROWS,
                                                    s * krdm.STAGE_PULSES)
    return p.numpy()


@pytest.mark.parametrize("case", list(SPLIT_SHAPES))
def test_wgmma_b_planes_recompose_w(rng, case):
    """The W split, de-tiled: each plane is bit for bit the rna split of
    +-Wr / +-Wi in the transposed real form's rows, zero in the padding of
    rows and pulses, and hi + lo recomposes W to within 2^-22 of each value."""
    n_fft, n = SPLIT_SHAPES[case]
    w_re = rng.standard_normal((n_fft, n)).astype(np.float32)
    w_im = rng.standard_normal((n_fft, n)).astype(np.float32)
    planes = krdm.wgmma_b_planes(torch.from_numpy(w_re), torch.from_numpy(w_im))
    tiles, stages = -(-n_fft // krdm.TILE_ROWS), -(-n // krdm.STAGE_PULSES)
    assert tuple(planes.shape) == (tiles, stages, 4, 2 * krdm.TILE_ROWS // 8,
                                   krdm.STAGE_PULSES // 4, 8, 4)
    got = _detile(planes).reshape(4, tiles, 2, krdm.TILE_ROWS, stages * krdm.STAGE_PULSES)

    def padded(w):
        out = np.zeros((tiles * krdm.TILE_ROWS, stages * krdm.STAGE_PULSES), np.float32)
        out[:n_fft, :n] = w
        return out.reshape(tiles, krdm.TILE_ROWS, -1)

    b_r = np.stack([padded(w_re), padded(w_im)], axis=1)   # (tiles, re/im half, rows, p)
    b_i = np.stack([padded(-w_im), padded(w_re)], axis=1)
    for hi, lo, b in ((got[0], got[1], b_r), (got[2], got[3], b_i)):
        want_hi, want_lo = _split_tf32(b)
        np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
        np.testing.assert_array_equal(lo.view(np.uint32), want_lo.view(np.uint32))
        assert (np.abs(b - hi - lo) <= np.abs(b) * 2.0**-22).all()


@pytest.mark.parametrize("shape,n_fft,shift,notch",
                         [((2, 100, 65), None, True, (48, 51)), ((5, 17, 3), None, True, (7, 9)),
                          ((1, 48, 130), 64, False, (0, -1))],
                         ids=["ragged", "tiny", "zero-padded"])
def test_wgmma_b_planes_product_matches_plain(rng, shape, n_fft, shift, notch):
    """A float64 product of X^T with the split planes (hi + lo), in the
    transposed real form, reproduces doppler_rdm_plain."""
    pc = _pc(rng, shape)
    w_re, w_im = _planes(make_window("kaiser", shape[-2]), n_fft, shift)
    planes = _detile(krdm.wgmma_b_planes(w_re, w_im)).astype(np.float64)
    b_r, b_i = planes[0] + planes[1], planes[2] + planes[3]
    nf, n = w_re.shape
    x = np.zeros(shape[:-2] + (planes.shape[-1], shape[-1]), np.complex64)
    x[..., :n, :] = pc
    dt = (np.swapaxes(x.real, -1, -2).astype(np.float64) @ b_r.T
          + np.swapaxes(x.imag, -1, -2).astype(np.float64) @ b_i.T)   # (..., nr, rows)
    dt = dt.reshape(dt.shape[:-1] + (-1, 2, krdm.TILE_ROWS))
    mag = np.abs(dt[..., 0, :] + 1j * dt[..., 1, :]).reshape(dt.shape[:-3] + (-1,))
    got = np.swapaxes(mag, -1, -2)[..., :nf, :]
    if notch[1] >= notch[0]:
        got[..., notch[0] : notch[1] + 1, :] = 0.0
    want = krdm.doppler_rdm_plain(torch.from_numpy(pc), w_re, w_im, notch).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _wgmma_3xtf32_cgemm(a: np.ndarray, b: np.ndarray, period: int = kpcr.PARTIAL_K) -> np.ndarray:
    """complex64 (m, k) @ (k, n) as csrc/pc_rdm.cu forms each of its two
    products: D = Ar [Br | Bi] + Ai [-Bi | Br] (re then im along N), A and B
    split into TF32 hi/lo, six TF32 products per 8-deep step in the kernel's
    order (lo.lo dropped), each product's 8-term sum added into the partial
    with the tensor core's truncation (the pessimistic reading: every wgmma
    truncates), the partial restarted every `period` and added into FP32
    totals rounded to nearest.  Returns the totals as complex64."""
    n = b.shape[1]
    (arh, arl), (aih, ail) = _split_tf32(a.real), _split_tf32(a.imag)
    (bh, bl), (bnh, bnl) = (_split_tf32(np.concatenate(p, axis=1).astype(np.float32))
                            for p in ((b.real, b.imag), (-b.imag, b.real)))
    terms = ((arl, bh), (arh, bl), (ail, bnh), (aih, bnl), (arh, bh), (aih, bnh))
    acc = np.zeros((a.shape[0], 2 * n), np.float32)
    for k0 in range(0, a.shape[1], period):
        part = np.zeros_like(acc, dtype=np.float64)
        for s in range(k0, min(k0 + period, a.shape[1]), 8):
            ks = slice(s, s + 8)
            for xa, y in terms:
                prod = xa[:, ks].astype(np.float64) @ y[ks].astype(np.float64)
                part = _to_f32_toward_zero(part + prod).astype(np.float64)
        acc += part.astype(np.float32)
    return (acc[:, :n] + 1j * acc[:, n:]).astype(np.complex64)


@pytest.mark.parametrize("target", [False, True], ids=["noise", "target-1e5"])
def test_3xtf32_error_model_b3(rng, target):
    """B3 at a G0-like 1536-pulse, 16-column tile: P = X M then W P, both in
    pc_rdm.cu's wgmma form with 32-deep partials (two ring stages, the
    longest a partial runs), P rounded to float32 between them as phase 1
    writes it."""
    x = _c64(rng, (1536, 62))
    if target:
        x = _with_target(x, 20, 0.2503)                      # peaks in a kept row, 1152
    m = _c64(rng, (62, 16))
    w_re, w_im = (p.numpy() for p in _planes(make_window("hamming", 1536)))
    w = (w_re + 1j * w_im).astype(np.complex64)[::8]             # 192 of the 1536 Doppler rows
    c128 = np.complex128
    exact = np.abs(w.astype(c128) @ (x.astype(c128) @ m.astype(c128)))
    got = np.abs(_wgmma_3xtf32_cgemm(w, _wgmma_3xtf32_cgemm(x, m)).astype(c128))
    f32 = np.abs(w @ (x @ m))
    peak = exact.max()
    err, f32_err = np.abs(got - exact).max(), np.abs(f32 - exact).max()
    assert err <= 1e-5 * peak                                    # the complex128 bound
    assert (np.abs(got - f32) <= 2e-5 * peak + RTOL * f32).all()  # the B3 card tolerance
    assert err <= _3XTF32_OVER_F32 * f32_err


# B3's operator image: (n_in, n_out) of the card's B3 cases
IMAGE_SHAPES = {"g0-short": (62, 62), "g0-long": (504, 512), "ragged": (30, 17),
                "wide": (70, 300), "tiny": (4, 3)}


def _image_planes(img: torch.Tensor, n_rows: int, n_k: int) -> np.ndarray:
    """An image, de-tiled: (part, sub, rows, K) cropped to (n_rows, n_k)."""
    t, s = img.shape[:2]
    p = img.permute(2, 3, 0, 4, 6, 1, 5, 7).reshape(2, 3, t * kpcr.TILE_COLS, s * kpcr.STAGE_K)
    return p[:, :, :n_rows, :n_k].numpy()


@pytest.mark.parametrize("case", list(IMAGE_SHAPES))
def test_pc_operator_image_recomposes_m(rng, case):
    """M's image, de-tiled: each sub-plane is bit for bit the rna split of
    -Mi, Mr, Mi over M^T's rows, zero in the padding of rows and samples, and
    hi + lo recomposes M to within 2^-22 of each value."""
    n_in, n_out = IMAGE_SHAPES[case]
    m_re = rng.standard_normal((n_in, n_out)).astype(np.float32)
    m_im = rng.standard_normal((n_in, n_out)).astype(np.float32)
    img = kpcr.pc_operator_image(torch.from_numpy(m_re), torch.from_numpy(m_im))
    tiles, stages = -(-n_out // kpcr.TILE_COLS), -(-n_in // kpcr.STAGE_K)
    assert tuple(img.shape) == (tiles, stages, 2, 3, kpcr.TILE_COLS // 8, kpcr.STAGE_K // 4, 8, 4)
    assert img.numel() == tiles * stages * kpcr.IMAGE_STAGE_FLOATS
    full = _image_planes(img, tiles * kpcr.TILE_COLS, stages * kpcr.STAGE_K)
    assert not full[:, :, n_out:].any() and not full[:, :, :, n_in:].any()
    got = full[:, :, :n_out, :n_in]
    for sub, b in enumerate((-m_im.T, m_re.T, m_im.T)):
        hi, lo = got[0, sub], got[1, sub]
        want_hi, want_lo = _split_tf32(np.ascontiguousarray(b))
        np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
        np.testing.assert_array_equal(lo.view(np.uint32), want_lo.view(np.uint32))
        assert (np.abs(b - hi - lo) <= np.abs(b) * 2.0**-22).all()


@pytest.mark.parametrize("batch,n_prt,n_in,n_out,n_fft", [(2, 64, 30, 62, 96), (3, 37, 20, 17, 64)],
                         ids=["beams-2", "beams-3-ragged"])
def test_b3_images_product_matches_plain(rng, batch, n_prt, n_in, n_out, n_fft):
    """The data flow of csrc/pc_rdm.cu in float64 through its images: phase 1
    contracts X with M's image (B = [Mr; Mi], B' = [-Mi; Mr] as the overlap
    of its sub-planes), P's columns of all beams side by side become P's
    image, phase 2 contracts W with it; |D| reproduces fused_pc_rdm_plain."""
    x = _c64(rng, (batch, n_prt, n_in))
    m_re, m_im = (rng.standard_normal((n_in, n_out)).astype(np.float32) for _ in range(2))
    w_re, w_im = _planes(make_window("hamming", n_prt), n_fft, False)

    def product(a: np.ndarray, img: torch.Tensor, n_rows: int, n_k: int) -> np.ndarray:
        sub = _image_planes(img, n_rows, n_k).astype(np.float64).sum(axis=0)  # hi + lo
        b, bn = np.concatenate([sub[1], sub[2]]), np.concatenate([sub[0], sub[1]])
        d = a.real.astype(np.float64) @ b.T + a.imag.astype(np.float64) @ bn.T
        return d[:, :n_rows] + 1j * d[:, n_rows:]

    m_img = kpcr.pc_operator_image(torch.from_numpy(m_re), torch.from_numpy(m_im))
    p = product(x.reshape(-1, n_in), m_img, n_out, n_in).astype(np.complex64)
    cols = p.reshape(batch, n_prt, n_out).transpose(0, 2, 1).reshape(batch * n_out, n_prt)
    p_img = kpcr.wgmma_b_image_plain(torch.from_numpy(cols.real.copy()),
                                     torch.from_numpy(cols.imag.copy()))
    w = (w_re.numpy() + 1j * w_im.numpy()).astype(np.complex64)
    d = np.abs(product(w, p_img, batch * n_out, n_prt))
    got = d.reshape(n_fft, batch, n_out).transpose(1, 0, 2)
    want = kpcr.fused_pc_rdm_plain(torch.from_numpy(x), torch.from_numpy(m_re),
                                   torch.from_numpy(m_im), w_re, w_im).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5 * want.max())


def test_prepared_operator_image_follows_in_place_edits(monkeypatch):
    """fused_pc_rdm's kept M image: made once for a pair of planes, made
    again after an in-place edit of either plane, and made for other planes
    (the split stubbed by a counter)."""
    calls = []
    monkeypatch.setattr(kpcr, "pc_operator_image",
                        lambda m_re, m_im: calls.append(1) or torch.full((1,), float(len(calls))))
    monkeypatch.setattr(kpcr, "_images", type(kpcr._images)())
    m_re, m_im = torch.ones(6, 5), torch.zeros(6, 5)
    first = kpcr.prepared_operator_image(m_re, m_im)
    assert kpcr.prepared_operator_image(m_re, m_im) is first and len(calls) == 1
    m_re.add_(1.0)
    assert float(kpcr.prepared_operator_image(m_re, m_im)) == 2.0 and len(calls) == 2
    m_im[2, 3] = 4.0
    assert float(kpcr.prepared_operator_image(m_re, m_im)) == 3.0 and len(calls) == 3
    assert kpcr.prepared_operator_image(m_re, m_im) is not first and len(calls) == 3
    other = m_re.clone()
    kpcr.prepared_operator_image(other, m_im)
    assert len(calls) == 4
    for i in range(kpcr._IMAGE_CACHE):   # the oldest entries make way
        kpcr.prepared_operator_image(torch.ones(2, 2), torch.ones(2, 2))
    assert len(kpcr._images) == kpcr._IMAGE_CACHE


def test_wrappers_reject_unsupported_devices(rng):
    pc = torch.from_numpy(_pc(rng, (1, 8, 8))).to("meta")
    w_re, w_im = _planes(make_window("kaiser", 8))
    with pytest.raises(ValueError, match="unsupported device"):
        krdm.doppler_rdm(pc, w_re.to("meta"), w_im.to("meta"), (0, -1))
    with pytest.raises(ValueError, match="unsupported device"):
        kcfar.cascaded_cfar2d(torch.zeros(1, 40, 40, device="meta"), CFARConfig(), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.zeros(8, 5, device="meta")
        kpcr.fused_pc_rdm(pc, m, m, w_re.to("meta"), w_im.to("meta"))
