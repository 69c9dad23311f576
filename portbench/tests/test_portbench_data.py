"""Cells, traffic mixes and metrics are data: a new cell, traffic file
and per-layer reader are new files and entries, found by name; and the
kernels' byte counts follow live rows, not capacity."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_cells import checkout  # noqa: E402
from portbench import harness, roofline, scene  # noqa: E402


def test_a_cell_added_as_data(tmp_path):
    root = checkout(tmp_path)
    b = root / "portbench"
    (b / "traffic" / "tiny_k4.json").write_text(json.dumps(dict(
        name="tiny_k4", cd_update_freq=4, frame_steps=12,
        adaptive_update_freq=False, adaptive_bin_size=False, why="test")))
    (b / "metrics" / "frames_seen.py").write_text(
        "def read(rec):\n    return float(rec['window']['frames'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny.k4", config="tiny_bed",
                                   traffic="tiny_k4", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="frames_seen", unit="frames", better="higher",
        source="host_clock", layer="API (api.DEMSolver.DoDynamics)",
        moves="clump_steps_per_s", workloads=["tiny.k4"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    t0 = time.perf_counter()
    result, extra = harness.run(harness.load_bench(root), root, "tiny.k4",
                                5, 0.3, True, "cpu", t0, time.perf_counter)
    assert result["correct"], result["checks"]
    assert result["metrics"]["frames_seen"]["value"] == \
        extra["window"]["frames"]
    assert extra["window"]["steps"] == 12 * extra["window"]["frames"]


@pytest.mark.parametrize("grow", [2, 3])
def test_byte_counts_follow_live_rows(grow):
    cfg = json.loads((Path(__file__).parent / "tiny_bed.json").read_text())
    traffic = dict(cd_update_freq=10, adaptive_update_freq=False,
                   adaptive_bin_size=False)
    s = scene.build_solver(cfg, traffic, 3, "cpu")
    s.DoDynamics(10 * cfg["time_step"])
    st = s.state
    base = harness.kernel_bytes(st, s.engine.cfg)
    big = st.replace(ss=st.ss.grown(st.ss.cap * grow),
                     sa=st.sa.grown(st.sa.cap * grow))
    assert harness.kernel_bytes(big, s.engine.cfg) == base
    assert base["B"][0] > 0 and base["A"][0][0] > 0


def test_least_time_takes_the_larger_bound():
    kind = roofline.DEFAULT
    p = roofline.peaks(kind)
    assert roofline.least_s(p["hbm"], 0, kind) == pytest.approx(1.0)
    assert roofline.least_s(0, p["f32"], kind) == pytest.approx(1.0)
    b, f = roofline.bytes_B(1000, 10)
    assert b == 1000 * 148 + 640 and f == 1000 * roofline.B_FLOPS_PER_ROW
