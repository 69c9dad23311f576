"""The port's DEMSolver against the JAX package's, on the CPU.

One seeded scene through both packages' public calls: 256 3-sphere
clumps on a floor plane (AddBCPlane) inside a top-open box
(InstructBoxDomainBoundingBC), K = 5, 20 steps, rolling resistance off
(Crr = 0: with it on, any two implementations part on a bed, see
tests/test_torch_slice.py). Both solvers run once, in a module-scoped
fixture; the tests read them.

* The state after Initialize equals JAX's field by field (through
  convert.py).
* Owner vel/omg within 2e-4 of the largest value, positions within 1e-3
  of a voxel: the tolerances of tests/test_pallas_force.py:102-118.
* GetNumContacts equal; GetContactDetailedInfo matched per (kind, idA,
  idB): force, torque_only and point within 2e-4 of the largest. The
  JAX API on its CPU runs the XLA contact_pass, which leaves the SS
  fields of the LAST step in the state; the port, like the JAX package
  on its accelerator, evaluates them on the current state (a query pass
  with the extras outputs). The SS reference is therefore JAX's
  contact_pass run on the JAX solver's final state; the SA fields are
  the last step's in both packages.
* WriteSphereFile columns equal within 1e-6, but the speed column absv,
  held to the velocity tolerance (2e-4 of the largest); one tracker's
  GetContactForces equal to JAX's on the same (current-state) SS fields,
  points and forces within 2e-4 of the largest.
* Without a card the entry points raise instead of running on the CPU.
"""

import csv

import jax
import numpy as np
import pytest
import torch

import dem_engine_tpu as jdem
import dem_engine_tpu_torch as tdem
from dem_engine_tpu.ops import forces as jforces
from dem_engine_tpu_torch import convert

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

R = 0.005
H = 1e-5
STEPS = 20


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


def _scene(dem, **device):
    """A jittered lattice of 8 x 8 x 4 clumps, just above the floor."""
    s = dem.DEMSolver(**device)
    s.SetVerbosity("QUIET")
    nx, ny, nz = 8, 8, 4
    dims = np.asarray([nx * 1.99 * R + 20 * R, ny * 1.99 * R + 20 * R,
                       nz * 3.99 * R + 40 * R])
    s.InstructBoxDomainDimension(*dims)
    s.InstructBoxDomainBoundingBC("top_open")
    mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                          "Crr": 0.0})
    m_s = 2600 * 4 / 3 * np.pi * R**3
    i_s = 0.4 * m_s * R * R
    tmpl = s.LoadClumpType(
        3 * m_s, [3 * i_s + 2 * m_s * R * R] * 2 + [3 * i_s], [R, R, R],
        [[0, 0, -R], [0, 0, 0], [0, 0, R]], mat)
    idx = np.arange(nx * ny * nz)
    ii, jj, kk = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    lbf = -dims / 2
    pos = np.stack([ii * 1.99 * R + 10 * R, jj * 1.99 * R + 10 * R,
                    kk * 3.99 * R + 4 * R], axis=-1) + lbf
    pos += np.random.default_rng(0).uniform(-0.1 * R, 0.1 * R, pos.shape)
    batch = s.AddClumps(tmpl, pos)
    s.AddBCPlane([0, 0, lbf[2] + 2 * R], [0, 0, 1], mat)
    s.SetInitTimeStep(H)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(5)
    tracker = s.Track(batch)
    s.Initialize()
    return s, tracker


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    js, jtr = _scene(jdem)
    ts, ttr = _scene(tdem, device="cpu")
    init = (jax.tree_util.tree_map(np.asarray, js.state), ts.state)
    js.DoDynamics(STEPS * H)
    ts.DoDynamics(STEPS * H)
    files = {}
    for name, s in (("jax", js), ("port", ts)):
        files[name] = tmp_path_factory.mktemp(name) / "spheres.csv"
        s.WriteSphereFile(str(files[name]))
    # the JAX SS fields on the final state (see the module docstring)
    st, cfg = js.state, js.engine.cfg
    ss_now = jforces.contact_pass(
        "ss", st.ss, st.owners, st.spheres, st.tris, st.anals, js.params,
        st.time, cfg.voxel_size, cfg.force_model,
        krec=jforces.pack_kinematics(st.owners))["table"]
    return dict(js=js, ts=ts, jtr=jtr, ttr=ttr, init=init, files=files,
                ss_now=ss_now)


def test_initial_state_matches(run):
    ref = convert.state_from_numpy(run["init"][0], device="cpu")
    got = run["init"][1]
    for group, names in (
            ("owners", ("vox", "loc", "quat", "vel", "omg", "family",
                        "mass", "moi")),
            ("spheres", ("owner", "relpos", "radius", "mat")),
            ("anals", ("owner", "objtype", "relpos", "direction", "size",
                       "normal_sign", "mat"))):
        for name in names:
            r = getattr(getattr(ref, group), name)
            g = getattr(getattr(got, group), name)
            assert r.dtype == g.dtype and torch.equal(r, g), (group, name)
    for name in ("ss", "sa", "st"):
        r, g = getattr(ref, name), getattr(got, name)
        assert r.cap == g.cap, name
        for f in ("idA", "idB", "count", "own_a", "own_b"):
            assert torch.equal(getattr(r, f), getattr(g, f)), (name, f)
    assert run["ts"].GetNumOwners() == run["js"].GetNumOwners() == 258
    assert run["ts"].GetNumClumps() == run["js"].GetNumClumps() == 256


def test_dynamics_match(run):
    js, ts = run["js"], run["ts"]
    assert ts.GetTime() == js.GetTime()
    assert _rel(js.GetOwnerVelocity(), ts.GetOwnerVelocity()) < 2e-4
    assert _rel(js.GetOwnerAngVel(), ts.GetOwnerAngVel()) < 2e-4
    vs = ts._voxel_size
    err = np.abs(js.GetOwnerPosition() - ts.GetOwnerPosition()).max()
    assert err < 1e-3 * vs
    np.testing.assert_array_equal(js.GetOwnerOriQ().shape,
                                  ts.GetOwnerOriQ().shape)
    assert _rel(js.GetOwnerOriQ(), ts.GetOwnerOriQ()) < 2e-4
    np.testing.assert_array_equal(js.GetOwnerFamily(), ts.GetOwnerFamily())
    np.testing.assert_array_equal(js.GetOwnerMass(), ts.GetOwnerMass())
    assert ts.GetNumContacts() == js.GetNumContacts() > 500
    assert (sorted(map(tuple, ts.GetClumpContacts()))
            == sorted(map(tuple, js.GetClumpContacts())))
    # both engines shrank the initial capacities the same way
    jc, tc = js.engine.cfg, ts.engine.cfg
    assert (tc.cap_ss, tc.cap_sa) == (jc.cap_ss, jc.cap_sa)


def _by_pair(block, name):
    return {(a, b): block[name][i]
            for i, (a, b) in enumerate(zip(block["idA"], block["idB"]))}


def test_contact_detailed_info(run):
    js, ts = run["js"], run["ts"]
    ref = {b["kind"]: b for b in js.GetContactDetailedInfo()}
    got = {b["kind"]: b for b in ts.GetContactDetailedInfo()}
    assert ref.keys() == got.keys() == {"SS", "SA"}
    # SS reference on the current state (see the module docstring)
    now = run["ss_now"]
    n = int(now.count)
    own = np.asarray(js.state.spheres.owner)
    ss = dict(ref["SS"])
    ss["force"] = np.asarray(now.force)[:n]
    ss["torque_only"] = np.asarray(now.torque)[:n]
    ss["point"] = (np.asarray(now.cpoint)[:n]
                   + js.GetOwnerPosition()[own[ss["idA"]]])
    ref["SS"] = ss
    for kind in ("SS", "SA"):
        for name in ("force", "torque_only", "point"):
            r, g = _by_pair(ref[kind], name), _by_pair(got[kind], name)
            assert r.keys() == g.keys(), kind
            keys = sorted(r)
            rv = np.stack([r[q] for q in keys])
            gv = np.stack([g[q] for q in keys])
            if name == "torque_only":  # Crr = 0: no rolling torque
                assert not gv.any() and not rv.any()
            else:
                assert _rel(rv, gv) < 2e-4, (kind, name, _rel(rv, gv))
        # the history both steps left behind, per pair
        for k in ref[kind]["wildcards"]:
            r = _by_pair(dict(ref[kind], v=ref[kind]["wildcards"][k]), "v")
            g = _by_pair(dict(got[kind], v=got[kind]["wildcards"][k]), "v")
            keys = sorted(r)
            assert _rel([r[q] for q in keys], [g[q] for q in keys]) < 1e-3


def test_sphere_file(run):
    cols = {}
    for name, path in run["files"].items():
        with open(path) as f:
            rows = list(csv.reader(f))
        cols[name] = (rows[0], np.asarray(rows[1:], np.float64))
    assert cols["jax"][0] == cols["port"][0]
    assert cols["jax"][0] == ["x", "y", "z", "r", "owner", "absv", "family"]
    ref, got = cols["jax"][1], cols["port"][1]
    assert ref.shape == got.shape == (768, 7)
    absv = 5
    np.testing.assert_allclose(np.delete(got, absv, 1),
                               np.delete(ref, absv, 1), rtol=0, atol=1e-6)
    assert _rel(ref[:, absv], got[:, absv]) < 2e-4


def test_tracker_contact_forces(run):
    """Rows of equal (own_a, own_b) may come in another order: each port
    row is matched to the JAX row with the nearest contact point."""
    js, jtr, ttr = run["js"], run["jtr"], run["ttr"]
    kept = js.state
    js.state = kept.replace(ss=run["ss_now"])
    try:
        ref = {o: jtr.GetContactForces(o) for o in (3, 200)}
    finally:
        js.state = kept
    for offset, (jp, jf) in ref.items():
        assert ttr.GetOwnerID(offset) == jtr.GetOwnerID(offset)
        tp, tf = ttr.GetContactForces(offset)
        assert jp.shape == tp.shape and len(jp) > 3
        near = np.linalg.norm(tp[:, None] - jp[None], axis=-1).argmin(1)
        assert sorted(near) == list(range(len(jp)))
        assert _rel(jp[near], tp) < 2e-4 and _rel(jf[near], tf) < 2e-4
        assert np.abs(ttr.Pos(offset) - jtr.Pos(offset)).max() < (
            1e-3 * ttr._s._voxel_size)
        assert _rel(jtr.Vel(offset), ttr.Vel(offset)) < 2e-4


def test_entry_points_need_a_card_unless_asked():
    """build_case and DEMSolver default to the card. Without one they
    raise; they never carry on on the CPU."""
    if torch.cuda.is_available():
        assert tdem.DEMSolver().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdem.build_case(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdem.DEMSolver()
    assert tdem.DEMSolver(device="cpu").device.type == "cpu"
