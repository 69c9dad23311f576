"""The repository's examples and the flagship workflow through the port,
on the CPU (``dem_engine_tpu_torch.examples``,
``dem_engine_tpu_torch.tools.flagship_wheeldp``).

* All 29 examples load through ``load_example(name, device="cpu")`` and
  take one CD chunk at the size their JAX test builds
  (``tests/torch_scenes.py``): finite owner positions, no contact lost, the
  example's own invariant; no module of jax or the JAX package among
  their globals. A fresh process loads all 29 and imports
  ``tests/torch_scenes.py`` (which ``chip_smoke.py`` runs) and finds
  neither in ``sys.modules``, nor an example under its bare name.
* The 8 torch twins differ from their examples only in lines that name
  jnp, jax or dem_engine_tpu (difflib); their prescription and rule
  callables and their force models' ``fn`` equal the JAX originals' on
  the same seeded inputs (float32: within 1e-5 of the largest value of
  each output; the rule conditions exactly). A force model is evaluated
  on one ``ContactContext`` made from the same numpy arrays in each
  package.
* ``repose`` (60 clumps) and the twin ``solar_system`` end to end
  against the JAX package for 20 steps (one CD chunk of repose, the
  first 20 steps of solar_system's K = 50): positions within 1e-3 of a
  voxel, velocities within 2e-4 of the largest (the port's parity
  limits, tests/test_torch_api.py).
* The flagship at 1,024 clumps (h = 2e-5, a 200-step settle, one
  100-step drive chunk): the packing equals the JAX tool's, position for
  position; the contact gate passes; the clump CSV restores per template
  with the same counts and positions, and the JAX package's reader reads
  it as the port's does; the wheel advances by vx t.
* The repairs: ``PDSampler`` point for point against the JAX package's,
  every public top-level name of ``dem_engine_tpu`` in the port, and
  ``GetDEMEDataFile``'s search order.
"""

import difflib
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dem_engine_tpu as jdem
import dem_engine_tpu_torch as tdem
from dem_engine_tpu.models.force_model import ContactContext as JContext
from dem_engine_tpu_torch.examples import (EXAMPLES_DIR, NAMES, TWINS,
                                           load_example, source_path)
from dem_engine_tpu_torch.tools import flagship_wheeldp as tflag
from test_torch_slice import (finished, jax_steps_without_donation,  # noqa
                              started_python)
from torch_scenes import (CALLABLES, FORCE_MODELS, TIMES, contact_arrays,
                          life_board, make_context, recorded_build,
                          run_chunks, scene, twin_outputs)

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


def _jax_module(path, name):
    """A JAX-side file loaded under a private name (never an example's
    bare name, which the JAX tests import from examples/)."""
    spec = importlib.util.spec_from_file_location(f"_jax_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_example(name):
    return _jax_module(os.path.join(EXAMPLES_DIR, f"{name}.py"), name)


def _foreign(value):
    name = (value.__name__ if isinstance(value, types.ModuleType)
            else getattr(value, "__module__", None) or "")
    return name.split(".")[0] in ("jax", "jaxlib", "dem_engine_tpu")


# --- (a) every example, one CD chunk -------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_example_takes_a_chunk(name, tmp_path):
    sc = scene(name, "cpu", str(tmp_path))
    s = sc.solver
    assert s.device.type == "cpu"
    run_chunks(sc, 1)
    assert s.GetSimTime() > 0
    assert np.isfinite(sc.positions()).all()
    assert np.isfinite(np.asarray(s.GetOwnerVelocity())[:sc.n]).all()
    assert int(s.state.lost_contacts) == 0
    sc.check()
    mod = load_example(name, "cpu")
    assert mod.__name__ == f"dem_engine_tpu_torch.examples.{name}"
    bad = [k for k, v in vars(mod).items() if _foreign(v)]
    assert not bad, bad


@pytest.fixture(scope="module", autouse=True)
def loading_probe():
    """The interpreter of ``test_loading_imports_no_jax``, started with
    the module so that it loads while the other tests run."""
    proc = started_python(
        "import sys\n"
        "from dem_engine_tpu_torch.examples import NAMES, load_example\n"
        "mods = [load_example(n, 'cpu') for n in NAMES]\n"
        "assert len(mods) == 29\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_scenes\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'dem_engine_tpu.')) "
        "or m == 'dem_engine_tpu' or m in NAMES)\n"
        "assert not bad, bad\n")
    yield proc
    proc.kill()
    proc.communicate()


def test_loading_imports_no_jax(loading_probe):
    code, err = finished(loading_probe)
    assert code == 0, err


def test_loader_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_example("repose")
    assert load_example("repose", "cpu").dem.DEMSolver().device.type == "cpu"


def test_loader_refuses_leftover_jax():
    from dem_engine_tpu_torch.examples import rewrite_source

    src = open(os.path.join(EXAMPLES_DIR, "shake.py")).read()
    with pytest.raises(ImportError, match="jax"):
        rewrite_source(src, "examples/shake.py")
    # the rest of the examples rewrite line for line
    for name in sorted(set(NAMES) - TWINS):
        path = os.path.join(EXAMPLES_DIR, f"{name}.py")
        src = open(path).read()
        assert len(rewrite_source(src, path).splitlines()) == len(
            src.splitlines())


# --- (b), (c) the torch twins --------------------------------------------

_MARKS = ("jnp", "jax", "dem_engine_tpu")


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_differs_only_in_jnp_lines(name):
    old = open(os.path.join(EXAMPLES_DIR, f"{name}.py")).read().splitlines()
    new = open(source_path(name)).read().splitlines()
    ops = difflib.SequenceMatcher(None, old, new, autojunk=False)
    changed = 0
    for tag, i1, i2, j1, j2 in ops.get_opcodes():
        if tag == "equal":
            continue
        assert tag == "replace", (tag, old[i1:i2], new[j1:j2])
        assert all(any(m in ln for m in _MARKS) for ln in old[i1:i2]), \
            old[i1:i2]
        assert all(any(m in ln for m in ("torch", "dem_engine_tpu_torch"))
                   or ln.lstrip().startswith(("torch.", "device="))
                   for ln in new[j1:j2]), new[j1:j2]
        changed += i2 - i1
    assert changed > 0
    assert not any(m in ln.replace("dem_engine_tpu_torch", "")
                   for ln in new for m in _MARKS)


def _jax_outputs(name):
    """What the JAX example computes with jnp on the inputs that
    ``torch_scenes.twin_outputs`` gives the twin."""
    m = _jax_example(name)
    if name in FORCE_MODELS:
        model = getattr(m, FORCE_MODELS[name])()
        f, t, wc = model.fn(make_context(JContext, jnp.asarray, contact_arrays(
            model.contact_wildcards, model.geo_wildcards)))
        out = {"force": f, "torque": t}
        out.update((f"wildcard {k}", v) for k, v in wc.items())
    elif name in ("shake", "sieve"):
        (args,) = recorded_build(m, CALLABLES[name])
        out = {f"component {i}": jnp.stack([fn(jnp.float32(t))
                                            for t in TIMES])
               for i, fn in enumerate(args[1:4]) if callable(fn)}
    else:
        rules = recorded_build(m, CALLABLES[name], n=12)
        out = {}
        for trial in range(4):
            pos, fam = life_board(trial)
            view = types.SimpleNamespace(pos=jnp.asarray(pos),
                                         family=jnp.asarray(fam))
            for i, (_, _, cond) in enumerate(rules):
                out[f"board {trial} rule {i}"] = cond(view, jnp.float32(0))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_computes_as_jax(name):
    if name in FORCE_MODELS:
        jm = getattr(_jax_example(name), FORCE_MODELS[name])()
        tm = getattr(load_example(name, "cpu"), FORCE_MODELS[name])()
        for attr in ("name", "contact_wildcards", "owner_wildcards",
                     "geo_wildcards", "per_material_props", "pairwise_props",
                     "no_contact_force"):
            assert getattr(jm, attr) == getattr(tm, attr), attr
    ref, got = _jax_outputs(name), twin_outputs(name, "cpu")
    assert sorted(ref) == sorted(got) and ref
    for k in ref:
        assert ref[k].shape == got[k].shape, k
        if ref[k].dtype == bool:
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
        else:
            assert np.abs(ref[k]).max() > 0 or k == "torque", k
            assert _rel(ref[k], got[k]) < 1e-5, k
    if name == "game_of_life":  # the boards see births and deaths
        assert all(v.any() for v in ref.values())


# --- (d) two examples end to end against the JAX package -----------------

def _owners_close(js, ts, n):
    vs = ts._voxel_size
    assert ts.GetSimTime() == pytest.approx(js.GetSimTime(), rel=1e-12)
    err = np.abs(js.GetOwnerPosition()[:n] - ts.GetOwnerPosition()[:n])
    assert err.max() < 1e-3 * vs, err.max() / vs
    assert _rel(js.GetOwnerVelocity()[:n], ts.GetOwnerVelocity()[:n]) < 2e-4
    assert _rel(js.GetOwnerAngVel()[:n], ts.GetOwnerAngVel()[:n]) < 2e-4


def test_repose_matches_jax():
    js, n = _jax_example("repose").build(n=60)
    ts, tn = load_example("repose", "cpu").build(n=60)
    assert n == tn > 30
    for s in (js, ts):
        s.Initialize()
        s.DoDynamics(20 * s.GetTimeStepSize())  # K = 20: one CD chunk
    assert ts.GetNumContacts() == js.GetNumContacts()
    _owners_close(js, ts, n)


def test_solar_system_matches_jax():
    js, r_orbit, v_circ = _jax_example("solar_system").build()
    ts, tr, tv = load_example("solar_system", "cpu").build()
    assert (r_orbit, v_circ) == (tr, tv)
    for s in (js, ts):
        s.DoDynamics(20 * s.GetTimeStepSize())
    assert ts.GetNumContacts() == js.GetNumContacts() == 1
    _owners_close(js, ts, 2)
    assert np.abs(ts.GetOwnerVelocity()[1]).max() > 0.5 * v_circ


# --- (e) the flagship at 1,024 clumps ------------------------------------

FLAG_N, FLAG_H = 1024, 2e-5


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("flagship"))
    rep, s2, tracker = tflag.run(
        n=FLAG_N, settle=200 * FLAG_H, drive=100 * FLAG_H, h=FLAG_H,
        out=out, device="cpu", verbosity="QUIET", log=lambda m: None,
        keep=True)
    return rep, s2, tracker, out


def test_flagship_packing_equals_jax():
    jtool = _jax_module(os.path.join(REPO, "tools", "flagship_wheeldp.py"),
                        "flagship_wheeldp")
    js, jlx, jlz = jtool.build_prep(FLAG_N, verbosity="QUIET", h=FLAG_H)
    ts, tlx, tlz = tflag.build_prep(FLAG_N, verbosity="QUIET", h=FLAG_H,
                                    device="cpu")
    assert (jlx, jlz) == (tlx, tlz)
    np.testing.assert_array_equal(js.GetOwnerPosition(),
                                  ts.GetOwnerPosition())
    # the same template per clump: the same masses
    np.testing.assert_array_equal(js.GetOwnerMass(), ts.GetOwnerMass())
    assert ts.engine.cfg.cd_two_class and js.engine.cfg.cd_two_class


def test_flagship_chain(flagship):
    rep, s2, tracker, out = flagship
    assert rep["two_class_cd"]
    assert rep["contacts_after_settle"] > tflag.GATE * FLAG_N
    for name, (in_file, restored) in rep["restore_counts"].items():
        assert in_file == restored > 0, name
    assert sum(v[0] for v in rep["restore_counts"].values()) == FLAG_N
    assert rep["restore_max_pos_err"] < 1e-6
    assert len(rep["drawbar_N"]) == 1 and np.isfinite(rep["drawbar_N"]).all()
    dx = rep["wheel_x"][-1] - rep["wheel_x0"]
    want = rep["vx"] * rep["sim_time"][-1]
    assert abs(dx - want) < 1e-3 * want, (dx, want)
    assert np.isfinite(rep["wheel_z"]).all()
    assert rep["floor_z"] < rep["wheel_z"][-1]
    p = s2.GetOwnerPosition()[:s2.GetNumClumps()]
    assert np.isfinite(p).all() and p[:, 2].min() > rep["floor_z"]


def test_flagship_csv_reads_in_jax(flagship):
    path = os.path.join(flagship[3], "terrain.csv")
    for reader in ("ReadClumpXyzFromCsv", "ReadClumpQuatFromCsv"):
        ref = getattr(jdem.DEMSolver, reader)(path)
        got = getattr(tdem.DEMSolver, reader)(path)
        assert sorted(ref) == sorted(got) == ["grc_0.75", "grc_1.0",
                                              "grc_1.4"]
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ref[k]),
                                          np.asarray(got[k]))


# --- (f) the repairs -----------------------------------------------------

def test_pd_sampler_matches_jax():
    from dem_engine_tpu_torch import core

    ref = jdem.PDSampler(0.01).SampleBox([0, 0, 0], [0.05, 0.05, 0.05])
    got = tdem.PDSampler(0.01).SampleBox([0, 0, 0], [0.05, 0.05, 0.05])
    assert len(ref) > 50
    np.testing.assert_array_equal(ref, got)
    assert core.__file__.startswith(os.path.dirname(tdem.__file__))


def test_top_level_names_match_jax():
    names = [n for n in dir(jdem) if not n.startswith("_")
             and not isinstance(getattr(jdem, n), types.ModuleType)]
    assert len(names) > 20
    assert [n for n in names if not hasattr(tdem, n)] == []


def test_data_file_search_order(tmp_path, monkeypatch):
    env, cwd = tmp_path / "env", tmp_path / "cwd"
    for d in (env, cwd / "data"):
        d.mkdir(parents=True)
        (d / "a.csv").write_text("x")
    (cwd / "data" / "b.csv").write_text("x")
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("DEME_DATA_DIR", str(env))
    assert tdem.GetDEMEDataFile("a.csv") == str(env / "a.csv")
    assert tdem.GetDEMEDataFile("b.csv") == os.path.join(
        os.getcwd(), "data", "b.csv")
    with pytest.raises(FileNotFoundError):
        tdem.GetDEMEDataFile("none.csv")
