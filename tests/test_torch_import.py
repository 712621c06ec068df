"""The port runs where jax cannot be imported; chip_smoke.py refuses to run
without a GPU."""

import ast
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "radar_signal_process_tpu_torch"

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
    built = PACKAGE / "kernels" / "_build"   # build outputs, not sources
    sources = sorted(p for p in PACKAGE.rglob("*.py") if built not in p.parents)
    sources.append(REPO / "chip_smoke.py")
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
