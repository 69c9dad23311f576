"""The harness end to end on the CPU at a test-only size (512 clumps),
with faults planted under the timed path; the card-only run skips here."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_cells import checkout  # noqa: E402
from portbench import capture, control, harness, scene  # noqa: E402

SEED = 2**31 + 977  # above 32 signed bits: seeds may be that large


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, also=()):
    bench = harness.load_bench(root)
    t0 = time.perf_counter()
    return harness.run(bench, root, cell, SEED, 0.5, trace, "cpu", t0,
                       time.perf_counter, also=also)


@pytest.mark.parametrize("cell", ["tiny.k10", "tinycoh.k10"])
def test_cell_is_correct(root, cell):
    result, extra = _run(root, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"clump_steps_per_s", "peak_mem_gib",
                                      "setup_s"}
    pairs = extra["detail"]["pairs"]["ss"]
    # the lattice starts at touch: pairs within the band may differ
    assert pairs["program"] > 0 and pairs["reference"] > 0
    assert pairs["extra_off"] == pairs["missing_off"] == pairs["twice"] == 0


def test_same_seed_same_scene(root):
    from portbench import lattice

    cfg = json.loads((root / "portbench/configs/tiny_bed.json").read_text())
    a = lattice.initial_velocities(cfg, SEED)
    assert (a == lattice.initial_velocities(cfg, SEED)).all()
    assert not (a == lattice.initial_velocities(cfg, SEED + 1)).all()


def test_traced_run_reads_spans(root):
    result, _ = _run(root, "tiny.k10", trace=True)
    assert result["correct"]
    # the CPU has no device trace: only the span and counter readers
    assert {"frame_gap_share", "refresh_ms", "step_ms", "state_gib"} <= \
        set(result["metrics"])
    assert not {"idle_share", "A_roofline"} & set(result["metrics"])


@pytest.mark.parametrize("cell", ["tiny.k10", "tinycoh.k10"])
def test_control_fails(root, cell):
    cfg = harness.resolve(harness.load_bench(root), cell, root)["config"]
    also = control.controls(cfg)
    result, extra = _run(root, cell, also=also)
    assert result["correct"]
    assert len(also) == 3
    for label, *_ in also:
        ctrl = extra["detail"]["controls"][label]
        over = [k for k, c in result["checks"].items()
                if ctrl[k] > c["limit"]]
        assert over, (label, ctrl)


@pytest.mark.parametrize("cell,term,number", [
    ("tiny.k10", "Crr", "roll_err"),
    ("tinycoh.k10", "Cohesion", "coh_err")])
def test_fault_small_term_left_out(root, monkeypatch, cell, term, number):
    """The program run without the rolling resistance, or without the
    cohesion, while the reference keeps it: the term's own number fails,
    though it is small beside the Hertz force."""
    build = scene.build_solver

    def without(cfg, *a, **k):
        return build(harness.with_material(cfg, {term: 0.0}), *a, **k)

    monkeypatch.setattr(scene, "build_solver", without)
    result, _ = _run(root, cell)
    assert not result["correct"]
    c = result["checks"][number]
    assert c["value"] > c["limit"], result["checks"]


def _broken(monkeypatch, target, name, make):
    monkeypatch.setattr(target, name, make(getattr(target, name)))


def test_fault_state_unchanged(root, monkeypatch):
    from dem_engine_tpu_torch.ops import integrator

    _broken(monkeypatch, integrator, "integrate_owners",
            lambda f: lambda owners, *a, **k: owners)
    result, _ = _run(root, "tiny.k10")
    assert not result["correct"]
    assert result["checks"]["integ_err"]["value"] > \
        result["checks"]["integ_err"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.k10", "tinycoh.k10"])
def test_fault_half_the_contacts(root, monkeypatch, cell):
    from dem_engine_tpu_torch.ops import forces, fused_force

    def half(rows):
        rows = rows.clone()
        rows[rows.shape[0] // 2:] = 0
        return rows

    def hertz(f):
        def g(*a, **k):
            out = f(*a, **k)
            return (half(out[0]), half(out[1]), *out[2:])
        return g

    def cpass(f):
        def g(*a, **k):
            out = dict(f(*a, **k))
            out["rec_a"], out["rec_b"] = half(out["rec_a"]), half(
                out["rec_b"])
            return out
        return g

    _broken(monkeypatch, fused_force, "hertz_rows", hertz)
    _broken(monkeypatch, forces, "contact_pass", cpass)
    result, _ = _run(root, cell)
    assert not result["correct"]
    assert result["checks"]["wrench_err"]["value"] > \
        result["checks"]["wrench_err"]["limit"]


def test_fault_pair_dropped(root, monkeypatch):
    from dem_engine_tpu_torch import solver

    def drop(f):
        def g(state, *a, **k):
            out = f(state, *a, **k)
            ss = out.ss
            idA = ss.idA.clone()
            idA[0] = -1
            return out.replace(ss=ss.replace(idA=idA))
        return g

    _broken(monkeypatch, solver, "refresh_contacts", drop)
    result, _ = _run(root, "tiny.k10")
    assert not result["correct"]
    assert result["checks"]["pairs_off"]["value"] >= 1


@pytest.mark.parametrize("method", ["_refresh", "_step", "_hertz_plain",
                                    "_contact_pass", "_integrate"])
def test_a_silent_wrapper_stops_the_run(root, monkeypatch, method):
    """Where the program stops calling a wrapped function as the check
    expects, the run stops with the function's name: it never judges
    outputs it did not capture."""
    name = dict(_refresh="refresh_contacts", _step="dynamics_step",
                _hertz_plain="hertz_rows", _contact_pass="contact_pass",
                _integrate="integrate_owners")[method]

    def passthrough(self, *a, **k):
        return self._orig[name](*a, **k)

    monkeypatch.setattr(capture.Capture, method, passthrough)
    with pytest.raises(RuntimeError, match="captured nothing from"):
        _run(root, "tiny.k10")


def test_the_wrapped_signatures():
    """The leading parameters the wrappers read, by name."""
    import inspect

    from dem_engine_tpu_torch import solver
    from dem_engine_tpu_torch.ops import forces, fused_force, integrator

    lead = {(solver, "refresh_contacts"): ["state"],
            (solver, "dynamics_step"): ["state"],
            (fused_force, "hertz_rows_cuda"): ["table"],
            (forces, "contact_pass"): ["kind", "table"],
            (integrator, "integrate_owners"): ["owners", "f_acc", "t_acc"]}
    for (mod, name), params in lead.items():
        got = list(inspect.signature(getattr(mod, name)).parameters)
        assert got[:len(params)] == params, (name, got)
    assert hasattr(fused_force.hertz_rows_cuda, "launches")


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels run only there")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mono_1m.k20",
         "--seed", str(SEED), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
