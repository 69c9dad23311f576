"""A test-only copy of the benchmark: the real files of portbench/ and
BENCHMARK.json in a temporary checkout, with tiny cells added as data
(512 clumps, frames of 20 steps) so that the CPU runs the harness in
seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent

#: each tiny configuration and the one it is cut from
CUT_FROM = {"tiny_bed": "mono_bed_1m", "tiny_cohesive": "cohesive_bed_1m"}

TINY_TRAFFIC = {"name": "tiny_k10", "cd_update_freq": 10, "frame_steps": 20,
                "adaptive_update_freq": False, "adaptive_bin_size": False,
                "why": "a test's traffic: K 10, frames of 20 steps"}


def checkout(tmp: Path) -> Path:
    """A checkout in `tmp` holding BENCHMARK.json and portbench/, plus the
    tiny cells tiny.k10 (mono) and tinycoh.k10 (cohesive)."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("tiny_bed", "tiny_cohesive"):
        cfg = json.loads((HERE / f"{name}.json").read_text())
        if "script" in cfg["force_model"]:
            cfg["force_model"]["script"] = "cohesive_bed_1m.py"
        (root / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        (root / "portbench" / "limits" / f"{name}.json").write_text(
            (REPO / "portbench" / "limits" / f"{CUT_FROM[name]}.json")
            .read_text())
        bench["configs"].append(dict(
            name=name, source="test", file=f"portbench/configs/{name}.json",
            reduced=["n_clumps"], why="test"))
    (root / "portbench" / "traffic" / "tiny_k10.json").write_text(
        json.dumps(TINY_TRAFFIC))
    bench["workloads"] += [
        dict(name="tiny.k10", config="tiny_bed", traffic="tiny_k10",
             chips=1, why="test"),
        dict(name="tinycoh.k10", config="tiny_cohesive", traffic="tiny_k10",
             chips=1, why="test")]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny.k10", "tinycoh.k10"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
