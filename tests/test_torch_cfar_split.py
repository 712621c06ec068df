"""The split and ref-level CFAR forms of the port against the JAX package.

``segmented_cfar_flags`` / ``_select`` and the threshold sweep's
``segmented_cfar_ref_levels`` / ``_from_ref_levels`` (with their helpers
``_ref_level_padded`` and the zero-filled shift) get the same float32 RDMs
as the JAX functions, in both layouts, for E = 1 and E = 2 and at
thresholds 3, 4.3 (not exact in f32) and 7.  Flags and reference levels are
bit-equal, and the cascade flags also equal B1's plain version (the roll
form) on the same RDM.  The RDMs stay above the parity floor of the padded
forms (ROADMAP C3): 57 cropped rows, segments of 40 to 90 columns.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu.ops import cfar as jcfar
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.config import CFARConfig
from radar_signal_process_tpu_torch.kernels import cfar as kcfar
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from tests.test_torch_import import as_config

torch.set_num_threads(2)

SEGMENTS = ((0, 40), (40, 110), (110, 200))
N_CLUTTER = 3
THRESHOLDS = (3.0, 4.3, 7.0)
CONFIGS = {
    "E1": CFARConfig(threshold=5.0),
    "E2": CFARConfig(threshold=5.0, range_extend_cells=2),
    "E2-SO": CFARConfig(threshold=5.0, range_extend_cells=2, method=1),
    "no-range-pass": CFARConfig(threshold=5.0, range_detect=False),
}


def _rdm(seed):
    """(2, 64, 200) float32: notched zero rows, hits, exact neighbour ties
    and hits on every segment's edge columns."""
    rng = np.random.default_rng(seed)
    rdm = (np.abs(rng.standard_normal((2, 64, 200))) + 0.5).astype(np.float32)
    rdm[:, 30:35] = 0.0
    for b in range(2):
        v, r = rng.integers(N_CLUTTER + 1, 64 - N_CLUTTER, 60), rng.integers(0, 199, 60)
        rdm[b, v, r] += 12.0 * rng.random(60).astype(np.float32) + 3.0
        rdm[b, v[::3], r[::3] + 1] = rdm[b, v[::3], r[::3]]
        for a, e in SEGMENTS:
            rdm[b, rng.integers(4, 60, 4), [a, a + 1, e - 2, e - 1]] += 20.0
    return rdm


def _layout(rdm, transposed):
    return np.ascontiguousarray(np.swapaxes(rdm, -1, -2)) if transposed else rdm


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("transposed", [False, True], ids=["v-major", "r-major"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_flags_and_select_bit_equal(cfg, transposed):
    cfg = CONFIGS[cfg]
    jcfg = as_config(cfg, jconfig)
    x = _layout(_rdm(1), transposed)
    want_v, want_r = jcfar.segmented_cfar_flags(jnp.asarray(x), SEGMENTS, jcfg, N_CLUTTER,
                                                transposed=transposed)
    got_v, got_r = tcfar.segmented_cfar_flags(torch.from_numpy(x), SEGMENTS, cfg, N_CLUTTER,
                                              transposed=transposed)
    _eq(got_v, want_v)
    _eq(got_r, want_r)
    # stage B on the JAX stage-A planes
    want_f, want_vf = jcfar.segmented_cfar_select(jnp.asarray(x), want_v, want_r, SEGMENTS,
                                                  jcfg, N_CLUTTER, transposed=transposed)
    got_f, got_vf = tcfar.segmented_cfar_select(
        torch.from_numpy(x), torch.from_numpy(np.array(want_v)),
        torch.from_numpy(np.array(want_r)), SEGMENTS, cfg, N_CLUTTER, transposed=transposed)
    _eq(got_f, want_f)
    _eq(got_vf, want_vf)
    # and B1's plain version (the roll form) on the same RDM
    plain_f, plain_v = kcfar.cascaded_cfar2d(torch.from_numpy(_rdm(1)), cfg, N_CLUTTER, SEGMENTS)
    if transposed:
        plain_f, plain_v = plain_f.mT, plain_v.mT
    assert torch.equal(got_f, plain_f) and torch.equal(got_vf, plain_v)
    assert int(plain_f.sum()) > 0


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("transposed", [False, True], ids=["v-major", "r-major"])
@pytest.mark.parametrize("cfg", ["E1", "E2"])
def test_ref_levels_and_sweep_flags_bit_equal(cfg, transposed, threshold):
    cfg = CONFIGS[cfg]
    jcfg = as_config(cfg, jconfig)
    x = _layout(_rdm(2), transposed)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want_vref, want_rref = jcfar.segmented_cfar_ref_levels(jx, SEGMENTS, jcfg, N_CLUTTER,
                                                           transposed=transposed)
    got_vref, got_rref = tcfar.segmented_cfar_ref_levels(tx, SEGMENTS, cfg, N_CLUTTER,
                                                         transposed=transposed)
    assert got_vref.dtype == torch.float32 and np.asarray(want_vref).dtype == np.float32
    _eq(got_vref, want_vref)
    _eq(got_rref, want_rref)
    want_f, want_v = jcfar.segmented_cfar_from_ref_levels(
        jx, want_vref, want_rref, threshold, SEGMENTS, jcfg, N_CLUTTER, transposed=transposed)
    got_f, got_v = tcfar.segmented_cfar_from_ref_levels(
        tx, got_vref, got_rref, threshold, SEGMENTS, cfg, N_CLUTTER, transposed=transposed)
    _eq(got_f, want_f)
    _eq(got_v, want_v)
    # the sweep's flags are B1's plain version at that threshold
    at_t = dataclasses.replace(cfg, threshold=threshold)
    plain_f, plain_v = kcfar.cascaded_cfar2d(torch.from_numpy(_rdm(2)), at_t, N_CLUTTER, SEGMENTS)
    if transposed:
        plain_f, plain_v = plain_f.mT, plain_v.mT
    assert torch.equal(got_f, plain_f) and torch.equal(got_v, plain_v)


def _split_product_cell(rng):
    """A level v and a cell x where the velocity window's mean m of five v
    gives ``x = fl32(m * fl32(4.3)) < m * 4.3`` (float64): the float32
    product flags x, a float64 product would not."""
    t = np.float32(4.3)
    for v in rng.uniform(0.5, 2.0, 10000).astype(np.float32):
        s = v
        for _ in range(4):
            s = np.float32(s + v)
        m = np.float32(s / np.float32(5.0))
        x = np.float32(m * t)
        if float(x) < float(m) * 4.3:
            return v, x
    raise AssertionError("no split product found")


def test_threshold_product_is_float32(rng):
    """Both packages flag by the float32 product ``level * fl32(T)``."""
    v, x = _split_product_cell(rng)
    rdm = np.full((1, 64, 64), v, np.float32)
    rdm[0, 32, 32] = x
    cfg = CFARConfig(threshold=4.3, range_detect=False)
    want, _ = jcfar.segmented_cfar(jnp.asarray(rdm), ((0, 64),), as_config(cfg, jconfig), 3)
    vref, rref = tcfar.segmented_cfar_ref_levels(torch.from_numpy(rdm), ((0, 64),), cfg, 3)
    got, _ = tcfar.segmented_cfar_from_ref_levels(torch.from_numpy(rdm), vref, rref, 4.3,
                                                  ((0, 64),), cfg, 3)
    plain, _ = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), cfg, 3)
    _eq(got, want)
    assert torch.equal(got, plain)
    assert bool(got[0, 32, 32]) and int(got.sum()) == 1


@pytest.mark.parametrize("shape", [(3, 9, 11), (2, 2, 1)], ids=["wide", "narrower-than-E"])
@pytest.mark.parametrize("dim", [-1, -2])
@pytest.mark.parametrize("d", [-3, -1, 1, 3])
def test_shift_equals_pad_shift(rng, shape, dim, d):
    """The zero-filled shift of both cascade forms is the JAX split form's
    ``_pad_shift``, on amplitudes and on flags, also past the axis (a
    segment narrower than the cascade's +-E)."""
    x = rng.standard_normal(shape).astype(np.float32)
    want = jcfar._pad_shift(jnp.asarray(x), 3, dim)(d)
    _eq(tcfar._shift_range(torch.from_numpy(x), d, 0.0, dim), want)
    f = x > 0
    _eq(tcfar._shift_range(torch.from_numpy(f), d, False, dim),
        jcfar._pad_shift(jnp.asarray(f), 3, dim)(d))


def test_one_column_segments_with_e3():
    """Segments of one column under a +-3 cascade: the roll form, the split
    form and the JAX package agree."""
    segs = ((0, 1), (1, 137), (137, 138), (138, 200))
    cfg = CFARConfig(ref_cells=8, guard_cells=2, threshold=4.0, range_extend_cells=3)
    rdm = _rdm(4)
    want_f, want_v = jcfar.segmented_cfar(jnp.asarray(rdm), segs, as_config(cfg, jconfig),
                                          N_CLUTTER)
    got_f, got_v = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), cfg, N_CLUTTER, segs)
    _eq(got_f, want_f)
    _eq(got_v, want_v)


@pytest.mark.parametrize("dim", [-1, -2])
@pytest.mark.parametrize("method", [0, 1])
def test_ref_level_padded_bit_equal(rng, dim, method):
    x = (np.abs(rng.standard_normal((2, 40, 50))) + 0.1).astype(np.float32)
    want = jcfar._ref_level_padded(jnp.asarray(x), 5, 7, method, dim)
    _eq(tcfar._ref_level_padded(torch.from_numpy(x), 5, 7, method, dim), want)


def test_b1_plan_key_leaves_out_the_threshold():
    """A sweep's thresholds share one B1 launch plan: the key and the plan
    are those of the shape inputs alone."""
    segs, nvu, batch = tconfig.G2_PROFILE.cfar_segments, 303, 4
    a = tconfig.G2_PROFILE.cfar
    b = dataclasses.replace(a, threshold=4.3)
    assert kcfar.plan_key(segs, nvu, batch, a, 132) == kcfar.plan_key(segs, nvu, batch, b, 132)
    assert kcfar.cfar_plan(segs, nvu, batch, a) == kcfar.cfar_plan(segs, nvu, batch, b)
    for other in (dataclasses.replace(a, range_extend_cells=2), dataclasses.replace(a, method=1)):
        assert kcfar.plan_key(segs, nvu, batch, other, 132) != kcfar.plan_key(
            segs, nvu, batch, a, 132)
