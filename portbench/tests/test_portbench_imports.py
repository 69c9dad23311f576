"""What the benchmark loads: no JAX, no JAX package, and a reference
that loads nothing of the program. Top-level names are compared whole:
the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "dem_engine_tpu"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(REPO)!r}); {code}; "
         "print(sorted({m.split('.', 1)[0] for m in sys.modules}))"],
        capture_output=True, text=True, check=True, cwd=REPO)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_comparison():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    saved = dict(sys.modules)
    try:
        sys.modules.pop("dem_engine_tpu", None)
        sys.modules["dem_engine_tpu_torch_probe"] = sys
        assert "dem_engine_tpu" not in run.loaded_forbidden()
        sys.modules["dem_engine_tpu.ops"] = sys
        sys.modules["jaxlib.xla"] = sys
        assert {"dem_engine_tpu", "jaxlib"} <= run.loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_harness_loads_no_jax():
    loaded = _loaded_after(
        "import portbench.harness, portbench.control, dem_engine_tpu_torch")
    assert "dem_engine_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import portbench.reference.compare, portbench.reference.follow")
    assert not loaded & (FORBIDDEN | {"dem_engine_tpu_torch"})
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"dem_engine_tpu_torch"}), \
            path
    for path in (BENCH / "lattice.py",):
        assert _imports(path) <= {"__future__", "numpy"}, path


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mono_1m.k20",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
