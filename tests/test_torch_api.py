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
* The rest of the API. The tuners' _propose_k/_propose_bin return
  exactly what the JAX engine's return; Engine.advance's blocks under a
  scripted cost take exactly the K and bin factor a replay through the
  JAX methods picks. The bin switches: the bin factor and GetBinSize
  within 1e-6 of JAX's, GetBinNum equal; the pair set equal at factors
  1.0, 1.7, 3.0 and to JAX's find_pairs_ss. Checkpoints: every tensor
  bit for bit after a load, and a replay bit for bit on the CPU, also
  after a growth between save and load. UpdateClumps, PurgeFamily and
  ChangeClumpSizes on a second _scene pair: ids, counts and pair sets
  exactly, radii and offsets scaled exactly, owner state at the
  tolerances above (vel/omg 2e-4 of the largest, positions 1e-3
  voxel). The engine's log events, and every public JAX method present.
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
from dem_engine_tpu_torch.state import state_tensors
from test_torch_slice import jax_steps_without_donation  # noqa: F401

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

R = 0.005
H = 1e-5
STEPS = 20


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


def _scene(dem, dry_run=False, **device):
    """A jittered lattice of 8 x 8 x 4 clumps, just above the floor;
    `dry_run` refreshes the tables at Initialize."""
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
    s.Initialize(dry_run=dry_run)
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
    ss_now = jax.jit(lambda st, p: jforces.contact_pass(
        "ss", st.ss, st.owners, st.spheres, st.tris, st.anals, p,
        st.time, cfg.voxel_size, cfg.force_model,
        krec=jforces.pack_kinematics(st.owners))["table"])(st, js.params)
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


def test_stage_profile_leaves_state_bit_for_bit(run):
    ts = run["ts"]
    before = {p: t.clone() for p, t in state_tensors(ts.state)}
    stages = ts.ProfileStageTimings(reps=1)
    after = dict(state_tensors(ts.state))
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


# ---------------------------------------------------------------------------
# the rest of the API: tuners, bin switches, checkpoints, insertion, purge,
# resize, log events, the whole surface
# ---------------------------------------------------------------------------

def _jax_tuner(**attrs):
    """A JAX Engine for its pure host methods (_propose_k, _propose_bin):
    no config, no scene."""
    from dem_engine_tpu.solver import Engine as JaxEngine

    je = object.__new__(JaxEngine)
    je.fuse, je.max_freq, je._k_perf = 8, None, {}
    je.bin_factor, je._bin_perf = 1.0, {}
    for k, v in attrs.items():
        setattr(je, k, v)
    return je


# (k, remaining, fuse, max_freq, k_perf) for _propose_k, and (bin_factor,
# bin_perf) for _propose_bin: the cases of tests/test_auto_freq.py and
# tests/test_adaptive_bin.py::test_propose_bin_walks_toward_best
_K_CASES = {
    "explore": (8, 10**6, 8, None, {8: 1.0}),
    "walk_up": (8, 10**6, 8, None, {5: 3.0, 8: 2.0, 12: 1.5, 25: 1.0}),
    "stay": (18, 10**6, 8, None, {12: 2.0, 18: 1.0, 25: 1.5}),
    "walk_down": (8, 10**6, 8, None, {5: 0.5, 8: 1.0, 12: 2.0}),
    "max_freq": (12, 10**6, 8, 12, {5: 3.0, 8: 2.0, 12: 1.5, 25: 1.0}),
    "remaining": (5, 80, 8, None, {5: 2.0, 8: 1.0}),
    "settled": (25, 10**6, 8, None, {25: 1.0}),
}
_BIN_CASES = {
    "bin_explore": (1.3, {1.3: 1.0}),
    "bin_walk": (1.3, {1.0: 0.5, 1.3: 1.0, 1.7: 2.0}),
    "bin_stay": (1.0, {1.0: 0.5, 1.3: 1.0, 1.7: 2.0}),
}


@pytest.mark.parametrize("case", [*_K_CASES, *_BIN_CASES, "random"])
def test_tuner_proposals_match_jax(case):
    """Engine._propose_k and _propose_bin return what the JAX engine's
    return on the same readings; "random": 50 seeded reading sets, each
    walked several moves (and a bin factor off the ladder, as
    SetBinSize leaves one)."""
    if case in _K_CASES:
        k, rem, fuse, mx, perf = _K_CASES[case]
        runs = [(k, rem, fuse, mx, perf, 1.0, {})]
    elif case in _BIN_CASES:
        bf, bperf = _BIN_CASES[case]
        runs = [(25, 10**6, 8, None, {}, bf, bperf)]
    else:
        rng = np.random.default_rng(11)
        ladder_k = tdem.Engine.K_LADDER
        ladder_b = tdem.Engine.BIN_LADDER + (2.6,)
        runs = []
        for _ in range(50):
            perf = {int(x): float(rng.uniform(0.5, 2.0)) for x in rng.choice(
                ladder_k, size=rng.integers(1, 8), replace=False)}
            bperf = {float(x): float(rng.uniform(0.5, 2.0))
                     for x in rng.choice(ladder_b, size=rng.integers(1, 6),
                                         replace=False)}
            bf = float(rng.choice(list(bperf)))
            runs.append((int(rng.choice(ladder_k)),
                         int(rng.integers(0, 4000)),
                         int(rng.choice([1, 2, 8])),
                         [None, 12, 52][rng.integers(3)], perf, bf, bperf))
    for k, rem, fuse, mx, perf, bf, bperf in runs:
        je = _jax_tuner(fuse=fuse, max_freq=mx, _k_perf=dict(perf),
                        bin_factor=bf, _bin_perf=dict(bperf))
        eng = tdem.Engine(None, fuse=fuse)
        eng.max_freq, eng._k_perf = mx, dict(perf)
        eng.bin_factor, eng._bin_perf = bf, dict(bperf)
        for _ in range(4):
            if perf:
                k_j, k_t = je._propose_k(k, rem), eng._propose_k(k, rem)
                assert k_t == k_j, (case, k, rem, perf)
                assert mx is None or k_t <= max(mx, k)
                k = k_t
            if bperf:
                b_j, b_t = je._propose_bin(), eng._propose_bin()
                assert b_t == b_j, (case, bf, bperf)
                je.bin_factor = eng.bin_factor = b_t
    assert tdem.Engine.K_LADDER == _jax_tuner().K_LADDER
    assert tdem.Engine.BIN_LADDER == _jax_tuner().BIN_LADDER


def test_tuner_in_advance_replays_jax(monkeypatch):
    """Both tuners on, in Engine.advance on a 64-clump bed (fuse 2, K 5,
    max_freq 18, 400 steps; the refreshes run, the steps only count),
    with a scripted cost: every chunk span reads 1 ms, then 0.3 ms from
    the 40th span on, so a settled K gets >20 % cheaper. The
    blocks' K and bin factor must be what the JAX engine's update rule
    and _propose_k/_propose_bin pick from the same readings, each block
    running at the pick made one block before it, and K within max_freq
    and the ladder."""
    from dem_engine_tpu_torch import solver as tsolver

    calls = []

    def scripted(a, b):
        calls.append(1)
        return 1e-3 if len(calls) < 40 else 3e-4

    monkeypatch.setattr(tsolver, "mark_seconds", scripted)
    # the tuner reads only the scripted spans: the steps need not move
    monkeypatch.setattr(tsolver, "run_steps", lambda st, p, c, n, h=None:
                        st.replace(step=st.step + n))
    cfg, state, params = tdem.build_case(64, update_freq=5, device="cpu")
    eng = tdem.Engine(cfg, fuse=2)
    eng.auto_freq, eng.auto_bin, eng.max_freq = True, True, 18
    state = eng.advance(state, params, 400, update_freq=5)
    eng.read_timers()
    assert int(state.step) == 400
    blocks = eng.blocks
    assert len(blocks) >= 8 and all(b["counted"] for b in blocks)
    assert any(b["retuned"] for b in blocks)
    assert len({b["k"] for b in blocks}) > 1
    assert len({b["bin_factor"] for b in blocks}) > 1
    je = _jax_tuner(fuse=2, max_freq=18)
    for i, b in enumerate(blocks):
        k, per = b["k"], b["per"]
        assert k in tdem.Engine.K_LADDER and k <= 18
        assert b["bin_factor"] in tdem.Engine.BIN_LADDER
        # JAX's update of a measured block (dem_engine_tpu/solver.py,
        # Engine.advance), then its move
        old = je._k_perf.get(k)
        if old is not None and per < 0.8 * old:
            je._k_perf = {k: per}
            je._bin_perf.clear()
            assert b["retuned"]
        else:
            je._k_perf[k] = per if old is None else 0.5 * old + 0.5 * per
            assert not b["retuned"]
        # keyed by the block's own factor; the move starts from the
        # factor the tuner holds now (je.bin_factor, the last move's)
        old_b = je._bin_perf.get(b["bin_factor"])
        je._bin_perf[b["bin_factor"]] = per if old_b is None else (
            0.5 * old_b + 0.5 * per)
        if b["index"] % 2 == 0:
            assert b["k_next"] == je._propose_k(k, b["remaining"])
        else:
            je.bin_factor = je._propose_bin()
        assert b["bin_next"] == je.bin_factor
        if i + 2 < len(blocks) and blocks[i + 2]["index"] == b["index"] + 2:
            assert blocks[i + 2]["k"] == (b["k_next"] or 5)
            assert blocks[i + 2]["bin_factor"] == b["bin_next"]


def _host(x):
    """A torch tensor or a JAX array as numpy."""
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _pair_set(idA, idB, count):
    """The live pairs of a pair list, each as (lower id, higher id)."""
    n = int(count)
    a, b = _host(idA)[:n], _host(idB)[:n]
    return set(zip(np.minimum(a, b).tolist(), np.maximum(a, b).tolist()))


def _all_tensors(s):
    return {p: t.clone() for p, t in state_tensors(s.state)}


def _assert_same(a, b):
    assert a.keys() == b.keys() and len(a) > 40
    for p in a:
        assert a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]), p


@pytest.mark.parametrize("grow", [False, True], ids=["plain", "grown"])
def test_checkpoint_round_trip_bit_for_bit(tmp_path, grow, capsys):
    """SaveCheckpoint, 10 steps, LoadCheckpoint: every tensor is the saved
    one, and the same 10 steps replay bit for bit (the CPU's plain
    versions sum in a fixed order). "grown": cap_ss is cut to the live
    count before the save, so the run after it grows the SS table (and
    logs the growth at STEP_METRIC); the load restores the capacity and
    the replay grows it again. The file then loads into a fresh solver,
    bit for bit, which runs a chunk."""
    s, _ = _scene(tdem, device="cpu")
    s.DoDynamics(5 * H)
    if grow:
        n = int(s.state.ss.count)
        s.engine.cfg = dataclasses.replace(s.engine.cfg, cap_ss=n)
        s.state = s.state.replace(ss=s.state.ss.shrunk(n))
        s.SetVerbosity("STEP_METRIC")
    path = str(tmp_path / "ck.npz")
    s.SaveCheckpoint(path)
    saved = _all_tensors(s)
    cap0 = s.engine.cfg.cap_ss
    s.DoDynamics(10 * H)
    first = _all_tensors(s)
    assert (s.engine.timers["grows"] > 0) == grow
    if grow:
        out = capsys.readouterr().out
        assert "[STEP_METRIC] capacity/strategy growth after overflow 0x1" \
            in out and s.engine.cfg.cap_ss > cap0
    s.LoadCheckpoint(path)
    assert s.engine.cfg.cap_ss == cap0
    _assert_same(saved, _all_tensors(s))
    s.DoDynamics(10 * H)
    _assert_same(first, _all_tensors(s))
    fresh, _ = _scene(tdem, device="cpu")
    fresh.LoadCheckpoint(path)
    _assert_same(saved, _all_tensors(fresh))
    assert fresh.GetTime() == pytest.approx(5 * H)
    fresh.DoDynamics(5 * H)
    assert np.isfinite(fresh.GetOwnerVelocity()).all()
    # a file that does not fit raises
    other = tdem.DEMSolver(device="cpu")
    other.SetVerbosity("QUIET")
    mat = other.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4})
    other.AddClumps(other.LoadSphereType(1e-3, R, mat), np.zeros((2, 3)))
    other.Initialize()
    with pytest.raises(ValueError, match="does not fit|owners.vox is"):
        other.LoadCheckpoint(path)



def _snapshot(s, tracker):
    st = s.state
    return dict(
        counts=(s.GetNumOwners(), s.GetNumSpheres(), s.GetNumClumps()),
        pos=s.GetOwnerPosition(), vel=s.GetOwnerVelocity(),
        omg=s.GetOwnerAngVel(), fam=s.GetOwnerFamily(),
        s_owner=_host(st.spheres.owner), radius=_host(st.spheres.radius),
        relpos=_host(st.spheres.relpos), a_owner=_host(st.anals.owner),
        tracked=np.asarray(tracker.owner_ids),
        pairs=_pair_set(st.ss.idA, st.ss.idB, st.ss.count))


@pytest.fixture(scope="module")
def changed():
    """A second _scene pair through the same calls, from a dry run (its
    refresh fills the tables): clumps 40 and 200 put in family 2,
    AddClumps of a 4 x 4 layer of family 2 just above the bed, falling at
    1 m/s, and UpdateClumps; one chunk (K = 5); PurgeFamily(2) (which
    leaves the scene's owner and sphere counts, so the last chunk runs
    the first pair's compiled shapes); ChangeClumpSizes of every tenth
    clump by 0.95; one chunk. Snapshots of both packages after each call
    and each chunk (10 steps in all: the two packages' positions part by
    f32 rounding that grows with the steps).
    Returns them, the resized owners, the voxel size and the two
    solvers."""
    js, jtr = _scene(jdem, dry_run=True)
    ts, ttr = _scene(tdem, dry_run=True, device="cpu")
    lbf = ts._lbf
    ii, jj = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    pos = np.stack([ii.ravel() * 1.99 * R + 12 * R,
                    jj.ravel() * 1.99 * R + 12 * R,
                    np.full(16, 4 * 3.99 * R + 6 * R)], axis=-1) + lbf
    ids = np.arange(0, 256, 10)

    def insert(s):
        s.SetOwnerFamily([40, 200], 2)  # two of the bed's clumps too
        b = s.AddClumps(s._templates[0], pos)
        b.SetFamilies(2)
        b.SetVel([0.0, 0.0, -1.0])
        s.UpdateClumps()

    calls = (("init", lambda s: None),
             ("inserted", insert),
             ("insert_chunk", lambda s: s.DoDynamics(5 * H)),
             ("purged", lambda s: s.PurgeFamily(2)),
             ("resized", lambda s: s.ChangeClumpSizes(ids, 0.95)),
             ("chunk", lambda s: s.DoDynamics(5 * H)))
    snaps = {}
    for stage, call in calls:
        call(js)
        call(ts)
        snaps[stage] = {"jax": _snapshot(js, jtr), "port": _snapshot(ts, ttr)}
    return snaps, ids, ts._voxel_size, (js, ts)


def _same_stage(snap, voxel):
    """The owners and spheres of both packages: ids, counts, pair sets
    exactly; positions within 1e-3 of a voxel, vel and omg within 2e-4 of
    the largest."""
    ref, got = snap["jax"], snap["port"]
    assert ref["counts"] == got["counts"]
    for key in ("s_owner", "fam", "a_owner", "tracked"):
        np.testing.assert_array_equal(ref[key], got[key], err_msg=key)
    assert ref["pairs"] == got["pairs"]
    assert np.abs(ref["pos"] - got["pos"]).max() < 1e-3 * voxel
    assert _rel(ref["vel"], got["vel"]) < 2e-4
    assert _rel(ref["omg"], got["omg"]) < 2e-4


def test_update_clumps_matches_jax(changed):
    """16 clumps (48 spheres) take owner ids after the two plane owners
    (258-273) and sphere ids after the bed's, in both packages; the
    contact tables keep their rows, and the chunk after finds the new
    pairs."""
    snaps, _, voxel, _ = changed
    for stage in ("init", "inserted", "insert_chunk"):
        _same_stage(snaps[stage], voxel)
    before, after = snaps["init"]["port"], snaps["inserted"]["port"]
    assert after["counts"] == (before["counts"][0] + 16,
                               before["counts"][1] + 48,
                               before["counts"][2] + 16)
    np.testing.assert_array_equal(after["s_owner"][-48:],
                                  np.repeat(np.arange(258, 274), 3))
    assert (after["fam"][258:] == 2).all()
    assert (after["vel"][258:, 2] == -1).all()
    assert (after["fam"][[40, 200]] == 2).all()
    assert after["pairs"] == before["pairs"]
    chunk = snaps["insert_chunk"]["port"]
    new = {p for p in chunk["pairs"] if p[1] >= 768}
    assert new and all(p[0] >= 768 for p in new)  # the layer's own pairs


def test_purge_family_matches_jax(changed):
    """PurgeFamily(2) removes the family-2 owners below GetNumClumps()
    (272 after the insertion): clumps 40 and 200 and the inserted 258-271,
    so the last two inserted (272, 273; one for each plane owner) stay,
    in both packages. Owner ids are renumbered in the spheres and the
    planes; no sphere names a purged owner, the kept owners keep their
    state, the tables start empty, and the chunk after the purge and the
    resize agrees."""
    snaps, _, voxel, _ = changed
    for stage in ("purged", "chunk"):
        _same_stage(snaps[stage], voxel)
    ins, pur = snaps["insert_chunk"]["port"], snaps["purged"]["port"]
    rule_keep = ~((ins["fam"] == 2) & (np.arange(len(ins["fam"])) < 272))
    assert pur["counts"] == (int(rule_keep.sum()), 3 * 256, 256)
    assert int(rule_keep.sum()) == 258 and rule_keep[272:].all()
    assert not rule_keep[[40, 200]].any()
    np.testing.assert_array_equal(pur["pos"], ins["pos"][rule_keep])
    np.testing.assert_array_equal(pur["vel"], ins["vel"][rule_keep])
    # the bed's 254 clumps, then the floor (AddBCPlane) and the bounding
    # box's five planes, now owners 254 and 255, then the two kept
    np.testing.assert_array_equal(np.unique(pur["s_owner"]),
                                  np.r_[0:254, 256, 257])
    np.testing.assert_array_equal(pur["a_owner"], [254] + [255] * 5)
    assert not pur["pairs"] and snaps["chunk"]["port"]["pairs"]


def test_change_clump_sizes_matches_jax(changed):
    """Every tenth clump's spheres scaled by 0.95 (f32, exactly, in both
    packages) after the purge; the chunk after them reads the new radii
    in its refresh."""
    snaps, ids, voxel, _ = changed
    for stage in ("resized", "chunk"):
        _same_stage(snaps[stage], voxel)
    a, b = snaps["purged"]["port"], snaps["resized"]["port"]
    scaled = np.isin(a["s_owner"], ids)
    f = np.where(scaled, np.float32(0.95), np.float32(1.0)).astype(np.float32)
    np.testing.assert_array_equal(b["radius"], a["radius"] * f)
    np.testing.assert_array_equal(b["relpos"], a["relpos"] * f[:, None])
    np.testing.assert_array_equal(snaps["resized"]["jax"]["radius"],
                                  b["radius"])
    assert scaled.sum() == 3 * len(ids)


def test_bin_switches_match_jax(changed):
    """On the pair the changed fixture left: SetInitBinSize, SetBinSize
    (with the warning below the floor) and SetInitBinNumTarget after
    Initialize, and SetInitBinSize before it: the engine's bin factor,
    GetBinSize and GetBinNum equal JAX's. The pair set of the port's
    search (binning.sweep_table on the CPU) is the same at factors 1.0,
    1.7 and 3.0 and equal to JAX's binning.find_pairs_ss at 1.0."""
    from dem_engine_tpu.ops import binning as jbinning
    from dem_engine_tpu_torch.ops import sweep
    from dem_engine_tpu_torch.solver import ss_search_inputs

    js, ts = changed[3]
    floor = ts._bin_floor()
    assert floor == pytest.approx(js._bin_floor(), rel=1e-6)
    for call, arg in (("SetInitBinSize", 2.6 * floor),
                      ("SetInitBinNumTarget", 40),
                      ("SetBinSize", 0.3 * floor),
                      ("SetBinSize", 1.7 * floor)):
        if arg < floor:
            for s in (js, ts):
                with pytest.warns(UserWarning, match="below the one-bin"):
                    getattr(s, call)(arg)
        else:
            getattr(js, call)(arg)
            getattr(ts, call)(arg)
        assert ts.engine.bin_factor == pytest.approx(js.engine.bin_factor,
                                                     rel=1e-6), call
        assert ts.GetBinSize() == pytest.approx(js.GetBinSize(), rel=1e-6)
        assert ts.GetBinNum() == js.GetBinNum(), call
        assert ts.engine.auto_bin == js.engine.auto_bin
    # a size given before Initialize is applied there
    s = tdem.DEMSolver(device="cpu")
    s.SetVerbosity("QUIET")
    s.SetInitBinSize(2 * floor)
    mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4})
    s.AddClumps(s.LoadSphereType(1e-3, R, mat), np.zeros((1, 3)))
    s.Initialize()
    assert s.engine.bin_factor == pytest.approx(2 * floor / s._bin_floor())
    # the pair set at three factors
    st = ts.state
    sets = {}
    for f in (1.0, 1.7, 3.0):
        p = ts.params.replace(bin_factor=torch.tensor(f))
        q = ss_search_inputs(st, p, ts._voxel_size)
        a, b, n, _ = sweep.find_pairs_ss(
            q["pos_cd"], q["reach"], st.spheres.owner, q["family"],
            p.family_mask, q["bin_size"], q["nb_cd"], 8192)
        sets[f] = _pair_set(a, b, n)
        if f == 1.0:
            ja, jb, jn, _, _ = jax.jit(jbinning.find_pairs_ss,
                                       static_argnums=(7, 8))(
                *(jax.numpy.asarray(_host(x)) for x in (
                    q["pos_cd"], q["reach"], st.spheres.owner,
                    q["family"], p.family_mask, q["bin_size"],
                    q["nb_cd"])), 8192, 64)
            ref = _pair_set(ja, jb, jn)
    assert len(sets[1.0]) > 500
    assert sets[1.0] == sets[1.7] == sets[3.0] == ref



def _log_scene(verbosity, xyz=((0, 0, 0.0), (0, 0, 0.05))):
    """tests/test_engine_log_events.py's scene on the port: two spheres
    over a floor plane."""
    s = tdem.DEMSolver(device="cpu")
    s.SetVerbosity(verbosity)
    s.InstructBoxDomainDimension(1.0, 1.0, 1.0)
    mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.3,
                          "Crr": 0.0})
    s.AddClumps(s.LoadSphereType(0.1, 0.02, mat), np.asarray(xyz))
    s.AddBCPlane([0, 0, -0.05], [0, 0, 1], mat)
    s.SetInitTimeStep(5e-6)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.Initialize()
    return s


@pytest.mark.parametrize("case", ["wired", "step_metric", "quiet", "growth"])
def test_engine_log_events(case, capsys):
    """The three cases of tests/test_engine_log_events.py on the port
    (WARNING shows at INFO, STEP_METRIC only at STEP_METRIC, QUIET
    silences both), and a real growth: three overlapping spheres against
    cap_ss 1 log the SS growth at STEP_METRIC. A bare Engine with no sink
    sends WARNING to stderr."""
    if case == "wired":
        s = _log_scene("INFO")
        assert s.engine.log is not None
        s.engine._emit("WARNING", "synthetic warning event")
        out = capsys.readouterr().out
        assert "synthetic warning event" in out and "[WARNING]" in out
        s.engine._emit("STEP_METRIC", "synthetic metric event")
        assert "synthetic metric event" not in capsys.readouterr().out
        bare = tdem.Engine(s.engine.cfg)
        bare._emit("WARNING", "to stderr")
        bare._emit("STEP_METRIC", "nowhere")
        got = capsys.readouterr()
        assert "to stderr" in got.err and "nowhere" not in got.err + got.out
    elif case == "step_metric":
        s = _log_scene("STEP_METRIC")
        s.engine._emit("STEP_METRIC", "growth 0x1: caps")
        assert "growth 0x1" in capsys.readouterr().out
    elif case == "quiet":
        s = _log_scene("QUIET")
        s.engine._emit("WARNING", "should not appear")
        assert "should not appear" not in capsys.readouterr().out
    else:
        s = _log_scene("STEP_METRIC", ((0, 0, 0.0), (0, 0, 0.039),
                                       (0, 0.039, 0.0)))
        s.engine.cfg = dataclasses.replace(s.engine.cfg, cap_ss=1)
        s.state = s.state.replace(ss=s.state.ss.shrunk(1))
        s.DoDynamics(5e-6)
        out = capsys.readouterr().out
        assert s.engine.timers["grows"] == 1 and int(s.state.ss.count) == 2
        assert ("[dem_engine_tpu_torch][STEP_METRIC] capacity/strategy "
                "growth after overflow 0x1: {'cap_ss': 65}") in out


def test_api_surface_matches_jax():
    """Every public method of the JAX DEMSolver and DEMTracker exists on
    the port's. Left out, with a reason each: none."""
    left_out = {}
    for jcls, tcls in ((jdem.DEMSolver, tdem.DEMSolver),
                       (jdem.api.DEMTracker, tdem.DEMTracker)):
        names = [n for n in dir(jcls) if not n.startswith("_")]
        missing = [n for n in names
                   if not hasattr(tcls, n) and n not in left_out]
        assert not missing, (tcls.__name__, missing)
        assert len(names) > 30
    eng = tdem.Engine(None)
    for name in ("K_LADDER", "BIN_LADDER", "_propose_k", "_propose_bin",
                 "log", "_emit", "auto_freq", "active_freq", "max_freq",
                 "_k_perf", "bin_factor", "auto_bin", "_bin_perf", "fuse"):
        assert hasattr(eng, name), name
