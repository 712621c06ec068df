"""The port stands alone: it runs where jax and the JAX package cannot be
imported, its copies of the JAX package's host code (profiles, ``.bin``
readers) equal the originals, its entry points default to the card, and
chip_smoke.py refuses to run without a GPU."""

import argparse
import ast
import dataclasses
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "radar_signal_process_tpu_torch"


def as_config(obj, module):
    """``obj`` rebuilt field by field from the same-named classes of
    ``module`` (either package's ``config``), nested dataclasses included;
    any other value is returned as it is.  The parity tests hand each
    package its own profile and config objects through this."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(module, type(obj).__name__)
        return cls(**{f.name: as_config(getattr(obj, f.name), module)
                      for f in dataclasses.fields(obj)})
    return obj


def _port_sources():
    built = PACKAGE / "kernels" / "_build"   # build outputs, not sources
    sources = sorted(p for p in PACKAGE.rglob("*.py") if built not in p.parents)
    return sources + [REPO / "chip_smoke.py"]


_JAX_FREE = r"""
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)
import radar_signal_process_tpu_torch.cli  # noqa: F401
from radar_signal_process_tpu_torch.config import G2_PROFILE
from radar_signal_process_tpu_torch.device import resolve_device
from radar_signal_process_tpu_torch.models.detect import make_detector
from radar_signal_process_tpu_torch.models.mtd_pipeline import make_frame_processor
from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline  # noqa: F401

SMALL = dataclasses.replace(
    G2_PROFILE, prt_per_frame=16, point_prt=128, segment_points=(24, 40, 64),
    n_channels=2, n_beams=2,
)
dev = resolve_device("cpu")
rng = np.random.default_rng(0)
shape = (2, 16, 128)
a, b = (torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                         .astype(np.complex64)) for _ in range(2))
rdms = make_frame_processor(SMALL, 2, device=dev)(a, b)
flags, vflags, dets = make_detector(SMALL, n_clutter=0, max_detections=4, device=dev)(rdms)
assert rdms.shape == (2, 2, 16, 128) and bool(torch.isfinite(rdms).all())
assert flags.shape == rdms.shape and dets.valid.shape == (2, 2, 4)
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.")]
print("jax-free ok")
"""


def test_port_runs_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FREE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("jax-free ok")


_CAPTURE_JAX_FREE = r"""
import sys
sys.modules["jax"] = None
import dataclasses
import tempfile

import numpy as np

from radar_signal_process_tpu_torch.config import G2_PROFILE
from radar_signal_process_tpu_torch.ingest import g2_reader_class
from radar_signal_process_tpu_torch.sim import write_g2_capture

prof = dataclasses.replace(
    G2_PROFILE, prt_per_frame=8, point_prt=64, segment_points=(8, 16, 40),
    n_channels=2, n_beams=2,
)
rng = np.random.default_rng(1)
shape = (2, 8, 64, 2)
iq = (rng.integers(-900, 900, shape) + 1j * rng.integers(-900, 900, shape)).astype(np.complex64)
with tempfile.TemporaryDirectory() as root:
    write_g2_capture(root, iq, prof, data_type=1)
    reader = g2_reader_class(native=False)(root, prof)
    for f in range(2):
        np.testing.assert_array_equal(reader.read_frame(f).iq, iq[f])
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.")]
print("capture ok")
"""


def test_capture_roundtrip_with_jax_unimportable():
    """The port's capture writer and reader (``sim``/``ingest``) work without
    jax, and a written capture reads back exactly."""
    proc = subprocess.run(
        [sys.executable, "-c", _CAPTURE_JAX_FREE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("capture ok")


_G0_JAX_FREE = r"""
import sys
sys.modules["jax"] = None
import contextlib
import importlib
import io
import json
import pkgutil
import tempfile

import numpy as np
import torch

torch.set_num_threads(2)
import chip_smoke  # noqa: F401
import radar_signal_process_tpu_torch as port

for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
from radar_signal_process_tpu_torch import cli
from radar_signal_process_tpu_torch.config import G0_PROFILE as prof
from radar_signal_process_tpu_torch.config import G0ChainConfig
from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses
from radar_signal_process_tpu_torch.sim import write_g1_capture

n = prof.prt_per_frame
fd = -60 * prof.prf / G0ChainConfig().mtd_fft_length
_, p_long = reference_pulses(prof)
ramp = np.exp(1j * 2 * np.pi * fd * np.arange(n) * prof.prt)
base = np.zeros((n, prof.point_prt), complex)
s1 = prof.segment_starts[1]
base[:, s1 + 100 : s1 + 100 + len(p_long)] += ramp[:, None] * p_long[None, :]
left = np.round(5000 * base.real) + 1j * np.round(5000 * base.imag)
with tempfile.TemporaryDirectory() as root:
    write_g1_capture(root, left[None], 0.8 * left[None], freq_index=5, beam_pos=2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["dmx", "--input", root, "--device", "cpu", "--no-native"]) == 0
frame = json.loads(out.getvalue())["frames"][0]
assert (frame["freq_index"], frame["beam_pos"]) == (5, 2)
assert any(abs(r - 1851.17) < 24 for r in frame["long"]["range_m"]), frame["long"]
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith("jax.")]
print("g0 jax-free ok")
"""


def test_g0_slice_runs_with_jax_unimportable():
    """Every module of the port and chip_smoke.py import without jax, and
    ``cli dmx`` runs a G1 capture written by the port's own writer."""
    proc = subprocess.run(
        [sys.executable, "-c", _G0_JAX_FREE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("g0 jax-free ok")


_PACKAGE_FREE = r"""
import sys
sys.modules["jax"] = None
sys.modules["radar_signal_process_tpu"] = None   # the JAX package, blocked
import ast
import dataclasses
import importlib
import pathlib
import pkgutil
import tempfile

import numpy as np
import torch

torch.set_num_threads(2)
import chip_smoke  # noqa: F401
import radar_signal_process_tpu_torch as port

for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
smoke_imports = set()
for node in ast.walk(ast.parse(pathlib.Path(chip_smoke.__file__).read_text())):
    if isinstance(node, ast.Import):
        smoke_imports.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom):
        smoke_imports.add(node.module)
for name in sorted(smoke_imports):
    importlib.import_module(name)
from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE, G0ChainConfig
from radar_signal_process_tpu_torch.ingest import g2_reader_class
from radar_signal_process_tpu_torch.models.g0_chain import G0Chain
from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses
from radar_signal_process_tpu_torch.sim import write_g2_capture

# the small G2 slice: capture -> reader -> stream -> detections
prof = dataclasses.replace(
    G2_PROFILE, prt_per_frame=16, point_prt=128, segment_points=(24, 40, 64),
    cfar_segments=((0, 24), (24, 64), (64, 128)), n_channels=2, n_beams=2,
)
rng = np.random.default_rng(2)
shape = (3, 16, 128, 2)
iq = (rng.integers(-300, 300, shape) + 1j * rng.integers(-300, 300, shape)).astype(np.complex64)
iq[:, :, 90, 1] += 20000.0 * np.exp(1j * 2 * np.pi * 0.25 * np.arange(48)).reshape(3, 16)
with tempfile.TemporaryDirectory() as root:
    write_g2_capture(root, iq, prof, data_type=1)
    pipe = StreamingPipeline(g2_reader_class()(root, prof), prof, win_size=2, max_frames=3,
                             clutter_v=1e-6, max_detections=4, device="cpu")
    results = list(pipe)
assert [r.frame_idx for r in results] == [0, 1]
assert all(r.rdms.shape == (2, 2, 16, 128) and bool(torch.isfinite(r.rdms).all())
           for r in results)
assert all(r.cfar_hits > 0 and bool(r.detections.valid.any()) for r in results)

# the reduced G0 chain: 128 PRT, 62 + 120 samples, 256-point MTD
g0 = dataclasses.replace(G0_PROFILE, prt_per_frame=128, point_prt=182, segment_points=(62, 120))
cfg = dataclasses.replace(G0ChainConfig(), pc_fft_length=128, mtd_fft_length=256)
_, p_long = reference_pulses(g0)
base = np.zeros((128, 182), complex)
base[:, 82 : 82 + len(p_long)] += np.exp(1j * 2 * np.pi * 0.1 * np.arange(128))[:, None] * p_long
noise = rng.standard_normal((2, 128, 182)) * 30.0
res = G0Chain(g0, cfg, 3, 1, device="cpu").process_frame(4000 * base + noise[0],
                                                          3000 * base + noise[1])
assert res.rdm_sum_long.shape == (256, 128) and bool(res.measurements_long.valid[0])

# the threshold x SCR sweep and the G1 chain on a small profile
from radar_signal_process_tpu_torch.config import G1_PROFILE
from radar_signal_process_tpu_torch.evalx import TruthGate
from radar_signal_process_tpu_torch.evalx.sweep import sweep_thresholds
from radar_signal_process_tpu_torch.models.g1_chain import g1_validation_chain

small = dataclasses.replace(
    G2_PROFILE, prt_per_frame=64, point_prt=256, segment_points=(32, 80, 144),
    cfar_segments=((0, 32), (32, 112), (112, 256)),
)
table = sweep_thresholds(small, [5.0], [25.0], velocity_ms=-8.0, range_m=60.0, n_frames=2,
                         clutter_v=1.0, gate=TruthGate(r_min=100.0), device="cpu")
assert table[(25.0, 5.0)]["detection_rate"] == 1.0
echo = torch.from_numpy((rng.standard_normal((32, 1031)) + 0j).astype(np.complex64))
assert g1_validation_chain(echo, G1_PROFILE).shape == (32, 868)
assert sys.modules["radar_signal_process_tpu"] is None and sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith(("radar_signal_process_tpu.", "jax."))]
print("package-free ok")
"""


def test_port_runs_with_the_jax_package_unimportable():
    """With ``radar_signal_process_tpu`` (and jax) blocked, every module of
    the port and every module chip_smoke.py imports load, and the small G2
    slice and the reduced G0 chain run on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-c", _PACKAGE_FREE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("package-free ok")


_BENCH_PACKAGE_FREE = r"""
import sys
sys.modules["jax"] = None
sys.modules["radar_signal_process_tpu"] = None   # the JAX package, blocked
sys.modules["bench"] = None                      # and the JAX system's bench.py
import contextlib
import dataclasses
import io
import json

import torch

torch.set_num_threads(2)
from radar_signal_process_tpu_torch import bench
from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE, G0ChainConfig

tiny = dataclasses.replace(
    G2_PROFILE, prt_per_frame=64, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)), n_beams=3,
)
g0 = (dataclasses.replace(G0_PROFILE, prt_per_frame=128, point_prt=182, segment_points=(62, 120)),
      dataclasses.replace(G0ChainConfig(), pc_fft_length=128, mtd_fft_length=256))
out = io.StringIO()
with contextlib.redirect_stdout(out):
    result = bench.run("cpu", tiny, g0, repeat=2, stream_frames=3)
line = json.loads(out.getvalue().strip().splitlines()[-1])
assert line["ok"] and line["device"] == "cpu" and line["oracle_frame_s"] > 0
assert sys.modules["radar_signal_process_tpu"] is None and sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith(("radar_signal_process_tpu.", "jax."))]
print("bench package-free ok")
"""


def test_bench_runs_with_the_jax_package_unimportable():
    """With jax, the JAX package and the JAX system's ``bench.py`` blocked,
    the port's bench runs every workload at cut geometry on the CPU, the
    numpy loop oracle of ``tests/oracle`` included, and its checks pass."""
    proc = subprocess.run(
        [sys.executable, "-c", _BENCH_PACKAGE_FREE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("bench package-free ok")


def test_no_jax_package_import_or_path_load_in_port_sources():
    """No port source and not chip_smoke.py imports ``radar_signal_process_tpu``
    (without the ``_torch`` suffix) or loads a file by path."""
    imports = re.compile(
        r"^\s*(from|import)\s+radar_signal_process_tpu(?!_torch)\b"
        r"|import_module\(\s*['\"]radar_signal_process_tpu(?!_torch)\b",
        re.MULTILINE,
    )
    offenders = [str(p.relative_to(REPO)) for p in _port_sources()
                 if imports.search(p.read_text()) or "spec_from_file_location" in p.read_text()]
    assert offenders == []
    assert not (PACKAGE / "_reference.py").exists()


_CONFIG_NAMES = ("G0_PROFILE", "G1_PROFILE", "G2_PROFILE", "CFARConfig", "MTDConfig",
                 "G0ChainConfig", "RadarProfile")


@pytest.mark.parametrize("name", _CONFIG_NAMES)
def test_port_config_equals_the_jax_package(name):
    """Each profile and config class of the port equals the JAX package's
    field by field (defaults of the classes, every field of the profiles,
    nested configs included), and ``as_config`` maps one onto the other."""
    from radar_signal_process_tpu import config as jconfig
    from radar_signal_process_tpu_torch import config as tconfig

    got, want = getattr(tconfig, name), getattr(jconfig, name)
    assert got is not want
    if isinstance(want, type):
        assert [(f.name, f.type, f.default) for f in dataclasses.fields(got)] == [
            (f.name, f.type, f.default if not dataclasses.is_dataclass(f.default)
             else as_config(f.default, tconfig)) for f in dataclasses.fields(want)]
        assert [n for n in vars(got) if not n.startswith("__")] == [
            n for n in vars(want) if not n.startswith("__")]
        return
    assert type(got) is tconfig.RadarProfile
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert as_config(want, tconfig) == got and as_config(got, jconfig) == want
    for prop in ("prf", "wavelength", "delta_r", "pulse_samples", "chirp_slopes",
                 "segment_starts"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.delta_v(2048) == want.delta_v(2048)
    assert tconfig.PROFILES[got.name] is got and jconfig.PROFILES[want.name] is want


_COPIED_MODULES = ("sim.targets", "sim.clutter", "sim.scr", "sim.packets_synth",
                   "evalx.metrics", "evalx.gps", "utils.logging", "utils.manifest",
                   "utils.matbus", "utils.dataset", "ops.waveforms", "viz.plots")


@pytest.mark.parametrize("name", _COPIED_MODULES)
def test_port_copies_equal_the_jax_package(name):
    """The port's copies of the JAX package's numpy modules define the same
    functions and classes with the same code (only imports and the module
    docstring differ)."""
    import importlib
    import inspect

    got = importlib.import_module(f"radar_signal_process_tpu_torch.{name}")
    want = importlib.import_module(f"radar_signal_process_tpu.{name}")

    def defs(module):
        return {k: inspect.getsource(v) for k, v in vars(module).items()
                if (inspect.isfunction(v) or inspect.isclass(v))
                and v.__module__ == module.__name__}

    want_defs = defs(want)
    assert want_defs and defs(got) == want_defs


def test_port_config_constants_equal_the_jax_package():
    from radar_signal_process_tpu import config as jconfig
    from radar_signal_process_tpu_torch import config as tconfig

    for name in ("C_LIGHT", "NARROW_PULSE_FIR_TAPS", "G1_RANGE_CONCAT"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert set(tconfig.PROFILES) == set(jconfig.PROFILES)
    for x in (-2.5, -0.5, 0.0, 0.49999, 0.5, 1.5, 2.5, 1e9 + 0.5):
        assert tconfig.matlab_round(x) == jconfig.matlab_round(x)


def _g2_capture(root, profile, rng):
    shape = (3, profile.prt_per_frame, profile.point_prt, profile.n_channels)
    iq = rng.integers(-900, 900, shape) + 1j * rng.integers(-900, 900, shape)
    from radar_signal_process_tpu_torch.sim import write_g2_capture

    # boundaries inside packets exercise the cross-file splicing
    write_g2_capture(root, iq, profile, data_type=1, file_sizes=[5000, 7777, 12000])


def _g1_capture(root, rng):
    from radar_signal_process_tpu_torch.sim import write_g1_capture

    shape = (3, 12, 40)
    left = rng.integers(-90000, 90000, shape) + 1j * rng.integers(-90000, 90000, shape)
    right = rng.integers(-90000, 90000, shape) + 1j * rng.integers(-90000, 90000, shape)
    write_g1_capture(root, left, right, frames_per_file=2, freq_index=[3, 7, 1],
                     beam_pos=[0, 5, 2])


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_port_g2_readers_equal_the_jax_package(tmp_path, rng, native):
    """On a seeded capture written by the port's writer, the port's G2
    reader (native C++ or Python) yields the same frames as the JAX
    package's Python reader, the reference form of both."""
    from radar_signal_process_tpu import config as jconfig
    from radar_signal_process_tpu import ingest as jingest
    from radar_signal_process_tpu_torch import config as tconfig
    from radar_signal_process_tpu_torch import ingest as tingest

    prof = dataclasses.replace(tconfig.G2_PROFILE, prt_per_frame=6, point_prt=50,
                               segment_points=(10, 15, 25), n_channels=3)
    _g2_capture(str(tmp_path), prof, rng)
    assert tingest.native_available()
    t_cls = tingest.g2_reader_class(native)
    assert t_cls is (tingest.NativeG2FrameReader if native else tingest.G2FrameReader)
    got = t_cls(str(tmp_path), prof)
    want = jingest.G2FrameReader(str(tmp_path), as_config(prof, jconfig))
    for idx in range(4):
        g, w = got.read_frame(idx), want.read_frame(idx)
        assert (g.frame_completed, g.eos) == (w.frame_completed, w.eos) == (idx < 3, idx == 3)
        if idx < 3:
            np.testing.assert_array_equal(g.iq, w.iq)
            np.testing.assert_array_equal(g.servo_angle, w.servo_angle)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_port_g1_readers_equal_the_jax_package(tmp_path, rng, native):
    from radar_signal_process_tpu import ingest as jingest
    from radar_signal_process_tpu_torch import ingest as tingest

    _g1_capture(str(tmp_path), rng)
    assert tingest.native_available()
    t_cls = tingest.g1_reader_class(native)
    assert t_cls is (tingest.NativeG1FrameReader if native else tingest.G1FrameReader)
    got = t_cls(str(tmp_path), 12, 40, 2)
    want = jingest.G1FrameReader(str(tmp_path), 12, 40, 2)
    for idx in (1, 2, 3):
        g, w = got.read_frame(idx), want.read_frame(idx)
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3] and g[3]["freq_index"] == (3, 7, 1)[idx - 1]


@pytest.mark.parametrize("entry", ["make_detector", "make_frame_processor", "G0Chain", "entry"])
def test_entry_points_default_to_the_card(entry):
    """Without a card the entry points' default device raises (nothing moves
    to the CPU silently); asked for the CPU, they build there (``entry``:
    its example window)."""
    from radar_signal_process_tpu_torch import entry as tentry
    from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE
    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain
    from radar_signal_process_tpu_torch.models.mtd_pipeline import make_frame_processor

    small = dataclasses.replace(G2_PROFILE, prt_per_frame=16, point_prt=128,
                                segment_points=(24, 40, 64), n_channels=2, n_beams=2)
    build = {"make_detector": lambda **kw: make_detector(small, **kw),
             "make_frame_processor": lambda **kw: make_frame_processor(small, 2, **kw),
             "G0Chain": lambda **kw: G0Chain(G0_PROFILE, **kw),
             "entry": lambda **kw: tentry.entry(**kw)[1][0]}[entry]
    built = build(device="cpu")
    if not isinstance(built, torch.Tensor):
        # a module's buffers, or where it works when it keeps none (the
        # Detector: its re-notch is fused into B1)
        built = next(iter(built.buffers()), built)
    assert built.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default would build there")
    with pytest.raises(RuntimeError, match="is_available"):
        build()


_STAGE_COMMANDS = {
    "ingest --dbf-coeffs": ["ingest", "--dbf-coeffs", "{coeffs}"],
    "mtd": ["mtd"],
    "detect": ["detect"],
    "detect --thresholds": ["detect", "--thresholds", "3", "5"],
    "analyze --animate pc": ["analyze", "--animate", "pc", "--stage1-input", "{frames}"],
}


@pytest.mark.parametrize("name", list(_STAGE_COMMANDS))
def test_stage_commands_default_to_the_card(tmp_path, monkeypatch, name):
    """The stage commands' device work runs on ``--device``, ``cuda`` unless
    the caller asks for the CPU: without a card the default raises, asked
    for the CPU the command runs."""
    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import PROFILES, G2_PROFILE
    from radar_signal_process_tpu_torch.utils import save_frame

    small = dataclasses.replace(G2_PROFILE, prt_per_frame=16, point_prt=128,
                                segment_points=(24, 40, 64), n_channels=2, n_beams=2)
    rng = np.random.default_rng(4)
    frames, rdms = tmp_path / "frames", tmp_path / "rdm"
    shape = (16, 128, 2)
    for f in range(2):
        iq = (rng.integers(-99, 99, shape) + 1j * rng.integers(-99, 99, shape)).astype(np.complex64)
        save_frame(str(frames), f, {"iq": iq, "servo_angle": np.zeros(16)}, small)
    rdm = np.abs(rng.standard_normal((2, 2, 16, 128))).astype(np.float32)
    save_frame(str(rdms), 0, {"rdm": rdm, "servo_angle": np.zeros(16)}, small)
    coeffs = tmp_path / "dbf.txt"
    np.savetxt(coeffs, rng.standard_normal((2, 4)))
    cap = tmp_path / "cap"
    from radar_signal_process_tpu_torch.sim import write_g2_capture

    write_g2_capture(str(cap), np.zeros((1, 16, 128, 2), np.complex64), small, data_type=1)
    argv = [a.format(coeffs=coeffs, frames=frames) for a in _STAGE_COMMANDS[name]]
    src = {"ingest": cap, "mtd": frames, "detect": rdms, "analyze": rdms}[argv[0]]
    argv += ["--input", str(src), "--output", str(tmp_path / "out"), "--profile", "SMALL",
             "--frames", "1"] if argv[0] != "analyze" else [
        "--input", str(src), "--output", str(tmp_path / "out"), "--profile", "SMALL"]
    monkeypatch.setitem(PROFILES, "SMALL", small)
    assert cli.build_parser().parse_args(argv).device == "cuda"
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert list(tmp_path.glob("out*"))           # out, or out_T3 and out_T5
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default would run there")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(argv + (["--force"] if argv[0] != "analyze" else []))


def _subcommand_options(parser) -> dict:
    """``{subcommand: {option string: default}}`` of a CLI parser."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {opt: action.default for action in p._actions
                   for opt in action.option_strings if opt not in ("-h", "--help")}
            for name, p in sub.choices.items()}


# options of the JAX CLI the port does not take yet, each with the item that
# brings it (none since the multi-device layer came)
_NOT_PORTED = {}


@pytest.mark.parametrize("command", ["simulate", "ingest", "mtd", "detect", "e2e", "stream",
                                     "dmx", "analyze", "sweep"])
def test_port_parser_accepts_the_jax_options(command):
    """Every subcommand of the JAX CLI exists in the port's and takes each of
    its options with the same default, ``--mesh`` included; the port's only
    extra option is ``--device``, default ``cuda``, on
    every subcommand that runs a chain (all but ``simulate``)."""
    from radar_signal_process_tpu import cli as jcli
    from radar_signal_process_tpu_torch import cli as tcli

    want = _subcommand_options(jcli.build_parser())
    got = _subcommand_options(tcli.build_parser())
    assert set(got) == set(want)
    missing = {o for o in want[command] if o not in got[command]}
    assert missing == {o for c, o in _NOT_PORTED if c == command}
    assert set(got[command]) - set(want[command]) == (
        set() if command == "simulate" else {"--device"})
    assert got[command].get("--device", "cuda") == "cuda"
    for opt, default in want[command].items():
        if opt not in missing:
            assert got[command][opt] == default, opt


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the JAX package's host code only through the
    port's own modules, and loads no file of it by path."""
    src = (REPO / "chip_smoke.py").read_text()
    modules = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            modules.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            modules.add(node.module)
    ours = {m for m in modules if m.startswith("radar_signal_process_tpu")}
    assert ours and all(m.split(".")[0] == "radar_signal_process_tpu_torch" for m in ours)
    assert not {m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "importlib")}
    assert "spec_from_file_location" not in src and "exec_module" not in src


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.MULTILINE)
    sources = _port_sources()
    assert len(sources) > 10
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert offenders == []


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120,
    )


def test_chip_smoke_fails_fast_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
    assert "is_available() is False" in proc.stderr
    # and alone, without the package beside it
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout


def test_native_cfar_source_equals_the_jax_copy():
    """``kernels/native/cfar.cpp`` is the JAX package's, byte for byte."""
    got = PACKAGE / "kernels" / "native" / "cfar.cpp"
    want = REPO / "radar_signal_process_tpu" / "kernels" / "native" / "cfar.cpp"
    assert got.read_bytes() == want.read_bytes()


_BLOCK_PACKAGE_FREE = r"""
import sys
sys.modules["jax"] = None
sys.modules["radar_signal_process_tpu"] = None   # the JAX package, blocked
import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)
from radar_signal_process_tpu_torch.config import G2_PROFILE
from radar_signal_process_tpu_torch.kernels import cost_model, native_cfar
from radar_signal_process_tpu_torch.models import host_parallel as hp
from radar_signal_process_tpu_torch.models.detect import make_cascade_detector
from radar_signal_process_tpu_torch.models.mtd_pipeline import process_frame_pair
from radar_signal_process_tpu_torch.parallel.sharding import shard_batch  # noqa: F401

prof = dataclasses.replace(
    G2_PROFILE, prt_per_frame=32, point_prt=128, segment_points=(24, 40, 64),
    cfar_segments=((0, 40), (40, 128)), n_channels=2, n_beams=2,
)
rng = np.random.default_rng(1)
shape = (2, 32, 128)
frames = [torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                           .astype(np.complex64)) for _ in range(3)]
got = []
hp.make_stream_pipeline(prof, 2, 2, max_detections=4, device="cpu")(
    frames, lambda w, r, f, d, h: got.append((w, r.shape, h)))
assert [g[0] for g in got] == [0, 1] and got[0][1] == (2, 2, 32, 128)
rdms = hp.make_stream_processor(prof, 2, device="cpu")(frames[0], frames[1], frame_idx=0)
assert torch.allclose(rdms, process_frame_pair(torch.stack(frames[:2]), prof, 2))
flags, _ = hp.make_flags(prof, 2, device="cpu")(rdms)
if native_cfar.native_cfar_available():
    native, _ = make_cascade_detector(prof, 2, transposed=True, prefer_native=True,
                                      device="cpu")(rdms.mT)
    assert torch.equal(native.mT, flags)
assert cost_model.g2_frame_fused_cfar_projection()["bound_by"] == "bytes"
assert sys.modules["radar_signal_process_tpu"] is None and sys.modules["jax"] is None
assert not [m for m in sys.modules if m.startswith(("radar_signal_process_tpu.", "jax."))]
print("block package-free ok")
"""


def test_block_modules_run_with_the_jax_package_unimportable():
    """With ``radar_signal_process_tpu`` and jax blocked, the block runner,
    the stream processor, ``make_flags``, the native cascade, the cost model
    and ``process_frame_pair`` load and run on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK_PACKAGE_FREE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("block package-free ok")
