"""Neither the harness nor the reference loads JAX or the JAX package, and the
reference loads nothing of the program (top-level module names, compared
whole, in a fresh process)."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "radar_signal_process_tpu"}

PROBE = """
import json, sys, pathlib, tempfile, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_neither_jax_nor_the_program():
    names = _top_level("import benchmark.reference.g2, benchmark.reference.g0, "
                       "benchmark.reference.cfar, benchmark.cost.work")
    assert not names & FORBIDDEN
    assert "radar_signal_process_tpu_torch" not in names


def test_a_run_imports_no_jax():
    body = """
from benchmark.tests.tiny import run_cell
for w in ("g2_stream_disk", "g0_dmx_ram"):
    with tempfile.TemporaryDirectory() as d:
        assert run_cell(pathlib.Path(d), w, seconds=0.5)[0] == 0
import benchmark.control, benchmark.metrics.b1_roofline_pct, benchmark.metrics.b2_roofline_pct
import benchmark.metrics.b3_roofline_pct, benchmark.metrics.device_idle_pct
import benchmark.metrics.ingest_parse_ms, benchmark.metrics.stream_consumer_wait_pct
import benchmark.metrics.stream_producer_wait_pct
"""
    names = _top_level(body)
    assert "radar_signal_process_tpu_torch" in names
    assert not names & FORBIDDEN
