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
* The read side on the same two solvers (no new JAX step): inspectors
  (every quantity, no region / BoxRegion / SphereRegion) against JAX's
  and against the port's own host-callable path; clump and contact
  files in CSV and binary (header, keys, rows, values, force_thres);
  the readers on JAX-written files equal to JAX's readers; getters and
  tracker reads; ProfileStageTimings' stages with the state left bit for
  bit; ShowTimingStats' counts; a ChangeFamilyWhen rule added after
  Initialize runs in neither package.
"""

import csv
import dataclasses
import re

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


# ---------------------------------------------------------------------------
# the read side: inspectors, files, readers, getters, timing
# ---------------------------------------------------------------------------

QUANTITIES = tuple(f"clump_{m}_{a}" for m in ("max", "min") for a in "xyz") + (
    "clump_max_absv", "clump_absv", "clump_kinetic_energy", "clump_mass",
    "clump_volume", "clump_count")


def _regions(dem, lbf):
    """None, a box over a quarter of the columns and the lower two
    layers, a ball around the bed's middle; boundaries fall between
    lattice sites."""
    box = dem.BoxRegion(lbf + [0.0, 0.0, 0.0],
                        lbf + [10 * R + 3.5 * 1.99 * R,
                               10 * R + 3.5 * 1.99 * R, 10 * R])
    ball = dem.SphereRegion(lbf + [10 * R + 3.5 * 1.99 * R,
                                   10 * R + 3.5 * 1.99 * R, 8 * R],
                            4.2 * R)
    return {"none": None, "box": box, "sphere": ball}


@pytest.mark.parametrize("kind", ["none", "box", "sphere"])
def test_inspectors_match_jax(run, kind):
    js, ts = run["js"], run["ts"]
    jreg = _regions(jdem, js._lbf)[kind]
    treg = _regions(tdem, ts._lbf)[kind]
    vmax = np.abs(js.GetOwnerVelocity()).max()
    # extents: the position tolerance and 1e-3 of a voxel, plus one f32
    # ulp of the largest LBF-relative coordinate (both packages reduce
    # f32 sphere positions; the two states round apart by up to an ulp)
    pos_tol = 2e-3 * ts._voxel_size + float(
        np.spacing(np.float32(np.max(-2 * ts._lbf))))
    for q in QUANTITIES:
        ref = js.CreateInspector(q, jreg).GetValue()
        got = ts.CreateInspector(q, treg).GetValue()
        # the port's host path: the region as a plain callable
        host = ts.CreateInspector(
            q, (lambda p: np.ones(len(p), bool)) if treg is None
            else (lambda p: treg(p))).GetValue()
        assert abs(host - got) <= 1e-5 * abs(host), (q, kind, host, got)
        if q.startswith(("clump_max_x", "clump_max_y", "clump_max_z",
                         "clump_min_")):
            assert abs(ref - got) <= pos_tol, (q, kind, ref, got)
        elif q == "clump_count":
            assert ref == got > 0, (q, kind)
        elif q in ("clump_mass", "clump_volume"):
            assert got == pytest.approx(ref, rel=1e-6), (q, kind)
        elif q in ("clump_absv", "clump_max_absv"):
            assert abs(ref - got) <= 2e-4 * vmax, (q, kind, ref, got)
        else:
            assert got == pytest.approx(ref, rel=4e-4), (q, kind)


@pytest.fixture(scope="module")
def written(run, tmp_path_factory):
    """Clump and contact files of both solvers, CSV and binary, and a
    contact file kept to |f| > thres; JAX writes its contact files with
    the SS fields of the current state (the module docstring)."""
    js, ts = run["js"], run["ts"]
    d = tmp_path_factory.mktemp("files")
    # a threshold halfway across the widest gap of the port's |f| near
    # the median, so that both packages keep the same rows
    f = np.concatenate([np.linalg.norm(b["force"], axis=1)
                        for b in ts.GetContactDetailedInfo()])
    fs = np.sort(f)
    mid = len(fs) // 2
    gaps = np.diff(fs[mid - 50:mid + 50])
    g = int(np.argmax(gaps)) + mid - 50
    thres = 0.5 * (fs[g] + fs[g + 1])
    kept = js.state
    now = run["ss_now"]
    # the current state's forces; the history the steps left behind
    js.state = kept.replace(ss=kept.ss.replace(
        force=now.force, torque=now.torque, cpoint=now.cpoint))
    try:
        for name, s in (("jax", js), ("port", ts)):
            for fmt in ("csv", "binary"):
                s.SetOutputFormat(fmt)
                s.SetContactOutputFormat(fmt)
                s.WriteClumpFile(str(d / f"{name}_clumps.{fmt}"))
                s.WriteContactFile(str(d / f"{name}_contacts.{fmt}"))
            s.WriteContactFile(str(d / f"{name}_thres.binary"),
                               force_thres=thres)
            s.SetOutputFormat("csv")
            s.SetContactOutputFormat("csv")
    finally:
        js.state = kept
    return d, thres, f


def _table(path, fmt):
    """(header, {column: array}) of a written file."""
    if fmt == "binary":
        z = np.load(path)
        return list(z.keys()), {k: z[k] for k in z.keys()}
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    cols = list(zip(*rows[1:]))
    return rows[0], {k: np.asarray(c) for k, c in zip(rows[0], cols)}


@pytest.mark.parametrize("fmt", ["csv", "binary"])
def test_clump_file_matches_jax(run, written, fmt):
    d = written[0]
    jh, jc = _table(d / f"jax_clumps.{fmt}", fmt)
    th, tc = _table(d / f"port_clumps.{fmt}", fmt)
    assert jh == th == ["x", "y", "z", "clump_type", "Qw", "Qx", "Qy", "Qz",
                        "v_x", "v_y", "v_z", "w_x", "w_y", "w_z", "family"]
    # an unnamed template writes as type_<owner id>, one type per clump
    np.testing.assert_array_equal(jc["clump_type"], tc["clump_type"])
    assert tc["clump_type"][7] == "type_7" and len(tc["x"]) == 256
    np.testing.assert_array_equal(jc["family"].astype(np.int64),
                                  tc["family"].astype(np.int64))

    def f64(c, keys):
        return np.stack([c[k].astype(np.float64) for k in keys], axis=1)

    xyz = ("x", "y", "z")
    assert np.abs(f64(jc, xyz) - f64(tc, xyz)).max() < 1e-3 * (
        run["ts"]._voxel_size)
    for keys in (("Qw", "Qx", "Qy", "Qz"), ("v_x", "v_y", "v_z"),
                 ("w_x", "w_y", "w_z")):
        assert _rel(f64(jc, keys), f64(tc, keys)) < 2e-4, keys


def _contacts(path, fmt):
    h, c = _table(path, fmt)
    key = [tuple(r) for r in np.stack(
        [c[k].astype(np.float64).astype(np.int64)
         for k in ("A", "B", "contact_type")], axis=1)]
    vals = {k: c[k].astype(np.float64) for k in h[3:]}
    return h, key, vals


@pytest.mark.parametrize("fmt", ["csv", "binary"])
def test_contact_file_matches_jax(run, written, fmt):
    d, thres, f = written
    jh, jk, jv = _contacts(d / f"jax_contacts.{fmt}", fmt)
    th, tk, tv = _contacts(d / f"port_contacts.{fmt}", fmt)
    assert jh == th and jh[:3] == ["A", "B", "contact_type"]
    assert jh[3:12] == ["x", "y", "z", "f_x", "f_y", "f_z", "tof_x",
                        "tof_y", "tof_z"]
    assert sorted(jk) == sorted(tk) and len(tk) == run["ts"].GetNumContacts()
    # SS rows (type 1) come first, then SA (11), in both
    types = [k[2] for k in tk]
    assert types == sorted(types) and set(types) == {1, 11}
    order = {k: i for i, k in enumerate(jk)}
    perm = np.asarray([order[k] for k in tk])
    for cols, tol in ((("x", "y", "z"), 2e-4), (("f_x", "f_y", "f_z"), 2e-4),
                      (tuple(jh[12:]), 1e-3)):
        r = np.stack([jv[k][perm] for k in cols], axis=1)
        g = np.stack([tv[k] for k in cols], axis=1)
        assert _rel(r, g) < tol, cols
    assert not any(tv[k].any() for k in ("tof_x", "tof_y", "tof_z"))
    # force_thres: the same rows in both, exactly those with |f| > thres
    _, jt, _ = _contacts(d / "jax_thres.binary", "binary")
    _, tt, tvt = _contacts(d / "port_thres.binary", "binary")
    assert sorted(jt) == sorted(tt)
    assert len(tt) == int((f > thres).sum()) > 0
    assert (np.linalg.norm(np.stack([tvt[k] for k in ("f_x", "f_y", "f_z")],
                                    1), axis=1) > thres).all()


def test_readers_match_jax(written, tmp_path):
    from dem_engine_tpu.utils import io as jio
    from dem_engine_tpu_torch.utils import io as tio

    d = written[0]
    clumps, contacts = d / "jax_clumps.csv", d / "jax_contacts.csv"

    def same(a, b):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, tuple):
            for x, y in zip(a, b, strict=True):
                same(x, y)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    for name in ("ReadClumpXyzFromCsv", "ReadClumpQuatFromCsv",
                 "ReadClumpVelFromCsv", "ReadClumpAngVelFromCsv"):
        same(getattr(jdem.DEMSolver, name)(str(clumps)),
             getattr(tdem.DEMSolver, name)(str(clumps)))
    same(jdem.DEMSolver.ReadClumpFloat3FromCsv(str(clumps), "w_x", "v_y",
                                               "Qz"),
         tdem.DEMSolver.ReadClumpFloat3FromCsv(str(clumps), "w_x", "v_y",
                                               "Qz"))
    same(jdem.DEMSolver.ReadContactPairsFromCsv(str(contacts)),
         tdem.DEMSolver.ReadContactPairsFromCsv(str(contacts)))
    names = ["delta_time", "delta_tan_x"]
    same(jdem.DEMSolver.ReadContactWildcardsFromCsv(str(contacts), names),
         tdem.DEMSolver.ReadContactWildcardsFromCsv(str(contacts), names))
    # a clump-template file and LoadClumpType's file overload
    tmpl = tmp_path / "tmpl.csv"
    tmpl.write_text("# a 2-sphere clump\nx,y,z,r\n0,0,-0.5,0.25\n"
                    "0,0,0.5,0.3\n")
    same(jio.read_clump_template_csv(str(tmpl)),
         tio.read_clump_template_csv(str(tmpl)))
    s = tdem.DEMSolver(device="cpu")
    t = s.LoadClumpType(1.0, [1, 1, 1], str(tmpl), s.LoadMaterial({"E": 1}))
    np.testing.assert_array_equal(t.radii, [0.25, 0.3])
    assert len(t.materials) == 2
    # meshes as OBJ, byte for byte
    v = np.random.default_rng(1).normal(size=(5, 3))
    fc = np.asarray([[0, 1, 2], [2, 3, 4]])
    for nrm in (None, np.eye(3)[:2]):
        jio.write_mesh_obj(str(tmp_path / "j.obj"), v, fc, normals=nrm)
        tio.write_mesh_obj(str(tmp_path / "t.obj"), v, fc, normals=nrm)
        assert ((tmp_path / "j.obj").read_bytes()
                == (tmp_path / "t.obj").read_bytes())


def test_getters_and_tracker_reads_match_jax(run):
    """The trackers cover owners 3, 100, 200: JAX's plural reads loop
    over the owners one by one."""
    js, ts = run["js"], run["ts"]
    jtr = jdem.api.DEMTracker(js, [3, 100, 200])
    ttr = tdem.DEMTracker(ts, [3, 100, 200])
    vmax = np.abs(js.GetOwnerVelocity()).max()
    for name in ("GetTimeStepSize", "GetSimTime", "GetInitStatus",
                 "GetUpdateFreq", "GetBinNum", "GetAvgSphContacts"):
        assert getattr(ts, name)() == getattr(js, name)(), name
    assert ts.GetBinSize() == pytest.approx(js.GetBinSize(), rel=1e-6)
    assert abs(ts.GetMaxVelocity() - js.GetMaxVelocity()) <= 2e-4 * vmax
    assert type(ts.GetContactForceModel()).__name__ == type(
        js.GetContactForceModel()).__name__
    for fams in (None, [0], [5]):
        assert (sorted(map(tuple, ts.GetContacts(fams)))
                == sorted(map(tuple, js.GetContacts(fams))))
    for o in (3, 100, 200, 255):
        np.testing.assert_array_equal(ts.GetOwnerContactClumps(o),
                                      js.GetOwnerContactClumps(o))
    np.testing.assert_array_equal(ts.GetOwnerMOI(), js.GetOwnerMOI())
    # tracker reads over the whole batch and one owner
    np.testing.assert_array_equal(ttr.Masses(), jtr.Masses())
    np.testing.assert_array_equal(ttr.MOIs(), jtr.MOIs())
    assert ttr.Mass(2) == ttr.GetMass(2) == jtr.Mass(2)
    np.testing.assert_array_equal(ttr.GetMOI(2), jtr.MOI(2))
    np.testing.assert_array_equal(ttr.GetOwnerIDs(), jtr.GetOwnerIDs())
    np.testing.assert_array_equal(ttr.GetContactClumps(1),
                                  jtr.GetContactClumps(1))
    assert np.abs(ttr.Positions() - jtr.Positions()).max() < (
        1e-3 * ts._voxel_size)
    for name in ("Velocities", "AngularVelocitiesLocal",
                 "AngularVelocitiesGlobal", "OrientationQuaternions",
                 "ContactAccelerations", "ContactAngularAccelerationsLocal",
                 "ContactAngularAccelerationsGlobal"):
        assert _rel(getattr(jtr, name)(), getattr(ttr, name)()) < 2e-4, name
    for one, plural in (("GetAngVelGlobal", "AngularVelocitiesGlobal"),
                        ("GetContactAcc", "ContactAccelerations"),
                        ("GetContactAngAccLocal",
                         "ContactAngularAccelerationsLocal"),
                        ("GetContactAngAccGlobal",
                         "ContactAngularAccelerationsGlobal")):
        np.testing.assert_array_equal(getattr(ttr, one)(2),
                                      getattr(ttr, plural)()[2])
    for one in ("GetPos", "GetVel", "GetAngVelLocal", "GetOriQ"):
        np.testing.assert_array_equal(getattr(ttr, one)(2),
                                      getattr(ttr, one[3:])(2))


def test_tracker_contact_torques_match_jax(run):
    """Two owners' contact forces and torques, the JAX side on the SS
    fields of the current state (module docstring); contact rows are
    matched by the nearest point."""
    js, ts = run["js"], run["ts"]
    jt = jdem.api.DEMTracker(js, [3, 200])
    tt = tdem.DEMTracker(ts, [3, 200])
    kept = js.state
    js.state = kept.replace(ss=run["ss_now"])
    try:
        ref = {name: getattr(jt, name)() for name in (
            "GetContactForcesForAll", "GetContactForcesAndGlobalTorqueForAll",
            "GetContactForcesAndLocalTorqueForAll")}
        ref_one = jt.GetContactForcesAndLocalTorque(1)
    finally:
        js.state = kept
    for name, r in ref.items():
        g = getattr(tt, name)()
        near = np.linalg.norm(g[0][:, None] - r[0][None], axis=-1).argmin(1)
        assert sorted(near) == list(range(len(r[0]))) and len(near) > 6
        assert _rel(r[1][near], g[1]) < 2e-4, name
        if len(r) == 3:
            assert g[2].shape == (2, 3)
            assert _rel(r[2], g[2]) < 2e-4, name
    g_one = tt.GetContactForcesAndLocalTorque(1)
    assert _rel(ref_one[2], g_one[2]) < 2e-4


def _tensors(x, path=""):
    """Every tensor of a (nested) state dataclass, by path."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _tensors(v, f"{path}[{k}]")


def test_stage_profile_leaves_state_bit_for_bit(run):
    ts = run["ts"]
    before = {p: t.clone() for p, t in _tensors(ts.state)}
    stages = ts.ProfileStageTimings(reps=1)
    after = dict(_tensors(ts.state))
    assert after.keys() == before.keys() and len(before) > 40
    for p, t in before.items():
        assert torch.equal(t, after[p]), p
    assert list(stages) == [
        "Discretize domain", "Find contact pairs", "Build history map",
        "Finalize tables", "kT total (refresh)",
        "Other kT (ST/SA, margins, error-outs)", "Clear force array",
        "Calculate contact forces (+reduction, fused kernel)",
        "Optional force reduction", "Integration", "dT total (one step)"]
    assert all(np.isfinite(v) and v >= 0 for v in stages.values())
    assert stages["kT total (refresh)"] >= stages["Find contact pairs"] > 0


def test_timing_stats_count_the_run(run, capsys):
    js, ts = run["js"], run["ts"]
    ts.ShowTimingStats()
    out = capsys.readouterr().out
    assert (f"over {js._n_steps_done} steps, {js._n_refreshes} CD "
            f"refreshes") in out
    assert js._n_steps_done == STEPS and js._n_refreshes == STEPS // 5
    assert re.search(rf"\({STEPS // 5} refreshes, [0-9.]+ ms each", out)
    assert re.search(rf"\({STEPS} steps, [0-9.]+ ms/step", out)
    assert "grows=0 shrinks=1 retries=0" in out


def test_rule_added_after_initialize_never_runs(run):
    """The JAX package keeps a ChangeFamilyWhen rule added after
    Initialize out of its engine's config, so it never runs; the port
    does the same. Checked on a small port scene stepped once, and on
    the JAX solver's config only."""
    js = run["js"]
    js.ChangeFamilyWhen(0, 7, lambda v, t: v.vel[:, 2] < 1e9)
    try:
        assert js.engine.cfg.family_changes == ()
    finally:
        js._family_changes.pop()
    s = tdem.DEMSolver(device="cpu")
    s.SetVerbosity("QUIET")
    s.InstructBoxDomainDimension(0.1, 0.1, 0.1)
    mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                          "Crr": 0.0})
    s.AddClumps(s.LoadSphereType(1e-3, R, mat),
                np.asarray([[0.0, 0.0, 0.0], [0.02, 0.0, 0.0]]))
    s.SetInitTimeStep(H)
    s.Initialize()
    s.ChangeFamilyWhen(0, 7, lambda v, t: v.vel[:, 2] < 1e9)
    s.DoDynamics(H)
    assert s.engine.cfg.family_changes == ()
    assert len(s._family_changes) == 1
    np.testing.assert_array_equal(s.GetOwnerFamily(), [0, 0])
