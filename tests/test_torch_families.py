"""Family prescriptions, fixed families, family-change rules and the
owner-state setters of the port against the JAX package, on the CPU.

* ``PrescriptionTables`` + ``integrate_owners`` on 64 seeded owners
  spread over families that set every channel (partial masks, a merged
  channel), an unregistered family and the reserved family 255, under
  each of the three integrators: vel and omg within 1e-6 of the largest
  value, quat within 1e-6, vox equal and loc within one f32 unit (ulp)
  of the voxel size.
* ``merge`` on the per-axis setter sequences of
  tests/test_api_extras.py (``test_per_axis_prescriptions_accumulate``
  and ``test_prescription_merge_keeps_earlier_axes``), through both
  packages' DEMSolver setters: tables equal at a time.
* Two rules A->B and B->C in one step: no cascade, families equal.
* One DEMSolver scene through both packages (module fixture): 8 x 8 x 3
  clumps, a 2*2^2-triangle plate pressed down by a prescribed velocity
  of time, a fixed bottom layer with its (1, 1) contacts disabled, a
  rule re-familying the top layer under the plate into a family with an
  added acceleration, a CorrectFamilyLinVel family, a tracker SetVel and
  an AddOwnerNextStepAcc; 20 steps; then ChangeFamily,
  SetFamilyClumpMaterial, EnableContactBetweenFamilies and
  SetFamilyExtraMargin; 20 more steps. State and pair sets are held to
  tests/test_torch_api.py's tolerances (2e-4 of the largest for vel and
  omg, 1e-3 of a voxel for position); pair sets, not rows, compared.
* ``convert.config_from_reference`` with and without the port's
  prescriptions.
* The three one-step free-fall cases of tests/test_integrators.py
  through the port against the JAX package, and SetMaxTriangleInBin
  stored only, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dem_engine_tpu as jdem
import dem_engine_tpu_torch as tdem
from dem_engine_tpu import initializer as jinit
from dem_engine_tpu.models import prescriptions as jpresc
from dem_engine_tpu.ops import integrator as jinteg
from dem_engine_tpu_torch import convert
from dem_engine_tpu_torch import initializer as tinit
from dem_engine_tpu_torch import solver as tsolver
from dem_engine_tpu_torch.cases import plate_mesh
from dem_engine_tpu_torch.defines import F, TimeIntegrator
from dem_engine_tpu_torch.models import prescriptions as tpresc
from dem_engine_tpu_torch.ops import integrator as tinteg
from dem_engine_tpu_torch.state import SolverConfig as TSolverConfig
from test_torch_slice import jax_steps_without_donation  # noqa: F401

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

INTEGRATORS = ("forward_euler", "centered_difference", "extended_taylor")
VS = 1.0 / 2**16
T0 = 0.37
F_J = jnp.float32


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


# ---------------------------------------------------------------------------
# tables + integrator
# ---------------------------------------------------------------------------


def _vec(lib, *fs):
    return lambda t: lib.stack([f(t) for f in fs])


def _prescriptions(mod, lib):
    """Every channel, in each package's own terms (`lib` is jnp or
    torch)."""
    P = mod.FamilyPrescription
    s = lib.sin
    return [
        mod.fixed(1),
        P(2, lin_vel=_vec(lib, lambda t: 0.3 * s(5 * t), lambda t: 0 * t,
                          lambda t: 0 * t - 0.2),
          lin_vel_mask=(True, False, True),
          rot_vel=_vec(lib, lambda t: 0 * t, lambda t: 2 * t,
                       lambda t: s(t)),
          rot_vel_mask=(False, True, True),
          acc=_vec(lib, lambda t: 0 * t + 1.5, lambda t: -t,
                   lambda t: 0 * t),
          ang_acc=_vec(lib, lambda t: 0 * t, lambda t: 0 * t + 40.0,
                       lambda t: 3 * t)),
        P(3, lin_pos=_vec(lib, lambda t: 0.5 + 0.01 * s(t),
                          lambda t: 0 * t + 0.25, lambda t: 0 * t + 0.6),
          lin_pos_mask=(True, True, False),
          quat=_vec(lib, lambda t: lib.cos(t), lambda t: s(t),
                    lambda t: 0 * t, lambda t: 0 * t)),
        P(4, lin_vel_soft=_vec(lib, lambda t: 0 * t + 0.05, lambda t: t,
                               lambda t: 0 * t),
          lin_vel_soft_mask=(False, True, True),
          rot_vel_soft=_vec(lib, lambda t: 0 * t + 1.0, lambda t: 0 * t,
                            lambda t: -t),
          lin_pos_soft=_vec(lib, lambda t: 0.4 + 0 * t, lambda t: 0.3 + t,
                            lambda t: 0.7 + 0 * t),
          lin_pos_soft_mask=(False, False, True),
          quat_soft=_vec(lib, lambda t: 0 * t + 0.5, lambda t: 0 * t + 0.5,
                         lambda t: 0 * t + 0.5, lambda t: t)),
        mod.merge(P(5, lin_vel=_vec(lib, lambda t: 0 * t + 0.7,
                                    lambda t: 0 * t, lambda t: 0 * t),
                    lin_vel_mask=(True, False, False)),
                  P(5, lin_vel=_vec(lib, lambda t: 0 * t, lambda t: 0 * t,
                                    lambda t: -t),
                    lin_vel_mask=(False, False, True))),
    ]


@pytest.fixture(scope="module")
def owners64():
    """JAX owners and params (64 owners, seeded), the port's copies, and
    the per-owner contact accelerations."""
    rng = np.random.default_rng(7)
    n = 64
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    fams = np.asarray([0, 1, 2, 3, 4, 5, 7, 255])[np.arange(n) % 8]
    jo = jinit.make_owners(
        pos=rng.uniform(0.2, 0.8, (n, 3)), voxel_size=VS,
        quat=q.astype(np.float32), vel=rng.normal(0, 0.3, (n, 3)),
        omg=rng.normal(0, 3.0, (n, 3)), family=fams,
        mass=rng.uniform(0.5, 2.0, n), moi=rng.uniform(0.01, 0.1, (n, 3)))
    jo = jo.replace(ext_acc=jnp.asarray(rng.normal(0, 1, (n, 3)), F_J),
                    ext_ang_acc=jnp.asarray(rng.normal(0, 5, (n, 3)), F_J))
    jp = jinit.make_params(
        h=1e-3, gravity=[0.0, 0.0, -9.81], domain=[1.0, 1.0, 1.0],
        materials={"E": np.asarray([1e7], np.float32),
                   "nu": np.asarray([0.3], np.float32)},
        pair_materials={"CoR": np.asarray([[0.5]], np.float32),
                        "mu": np.asarray([[0.3]], np.float32),
                        "Crr": np.asarray([[0.0]], np.float32)})
    f_acc = rng.normal(0, 2, (n, 3)).astype(np.float32)
    t_acc = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    to = convert.owners_from_numpy(jax.tree_util.tree_map(np.asarray, jo),
                                   "cpu")
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return dict(jo=jo, jp=jp, to=to, tp=tp, f=f_acc, t=t_acc)


def _hold_owners(ref, got, rel=1e-6):
    """JAX owners `ref` against the port's `got`."""
    for name in ("vel", "omg"):
        assert _rel(ref.vel if name == "vel" else ref.omg,
                    _np(getattr(got, name))) <= rel, name
    assert np.abs(np.asarray(ref.quat) - _np(got.quat)).max() <= 1e-6
    np.testing.assert_array_equal(np.asarray(ref.vox), _np(got.vox))
    ulp = np.spacing(np.float32(VS))
    assert np.abs(np.asarray(ref.loc) - _np(got.loc)).max() <= ulp
    np.testing.assert_array_equal(np.asarray(ref.family), _np(got.family))


@pytest.mark.parametrize("integ", INTEGRATORS)
def test_tables_and_integrator_match_jax(owners64, integ):
    o = owners64
    jt = jpresc.PrescriptionTables(_prescriptions(jpresc, jnp),
                                   jnp.float32(T0))
    static = tpresc.static_tables(_prescriptions(tpresc, torch), "cpu")
    tt = static.at(torch.tensor(T0, dtype=F))
    assert tt is not static  # callables evaluated into a copy
    for ch, _, _ in tpresc.CHANNELS:
        np.testing.assert_allclose(_np(getattr(tt, ch)),
                                   np.asarray(getattr(jt, ch)), rtol=1e-6,
                                   atol=1e-7, err_msg=ch)
        np.testing.assert_array_equal(_np(getattr(tt, ch + "_mask")),
                                      np.asarray(getattr(jt, ch + "_mask")))
    ref = jinteg.integrate_owners(
        o["jo"], jnp.asarray(o["f"]), jnp.asarray(o["t"]), o["jp"], jt, VS,
        jdem.TimeIntegrator(integ), jnp.float32(T0))
    got = tinteg.integrate_owners(
        o["to"], torch.from_numpy(o["f"]), torch.from_numpy(o["t"]),
        o["tp"], tt, VS, TimeIntegrator(integ), torch.tensor(T0))
    _hold_owners(ref, got)
    fam = _np(o["to"].family)
    fixed = np.isin(fam, (1, 255))
    # fixed owners (SetFamilyFixed and 255): no motion
    assert not _np(got.vel)[fixed].any() and not _np(got.omg)[fixed].any()
    np.testing.assert_array_equal(_np(got.vox)[fixed],
                                  _np(o["to"].vox)[fixed])
    np.testing.assert_array_equal(_np(got.loc)[fixed],
                                  _np(o["to"].loc)[fixed])


def _axis_cases(dem, **device):
    """The setter sequences of the two per-axis merge cases of
    tests/test_api_extras.py, on one solver (families 3 and 0)."""
    s = dem.DEMSolver(**device)
    s.InstructBoxDomainDimension(2, 2, 2)
    s.SetFamilyPrescribedLinVelX(3, 0.5)
    s.SetFamilyPrescribedLinVelZ(3, lambda t: 0 * t + 0.25)
    s.SetFamilyPrescribedPositionY(3, 0.125)
    s.SetFamilyPrescribedLinVel(0, vx=0.2)
    s.SetFamilyPrescribedLinVelZ(0, 0.05)
    return list(s._prescriptions.values())


def test_merge_per_axis_cases_match_jax():
    jt = jpresc.PrescriptionTables(_axis_cases(jdem), jnp.float32(T0))
    tt = tpresc.PrescriptionTables(
        _axis_cases(tdem, device="cpu"), "cpu").at(torch.tensor(T0))
    np.testing.assert_array_equal(_np(tt.fam_ids), np.asarray(jt.fam_ids))
    for ch, _, _ in tpresc.CHANNELS:
        np.testing.assert_array_equal(_np(getattr(tt, ch)),
                                      np.asarray(getattr(jt, ch)), ch)
        np.testing.assert_array_equal(_np(getattr(tt, ch + "_mask")),
                                      np.asarray(getattr(jt, ch + "_mask")))
    # the earlier axes stay prescribed
    assert _np(tt.lin_vel_mask).tolist() == [[True, False, True]] * 2
    assert _np(tt.lin_pos_mask)[1].tolist() == [False, True, False]


def test_rules_do_not_cascade(owners64):
    o = owners64

    def rules(mod):
        return [mod.FamilyChange(0, 7, lambda v, t: v.pos[:, 0] > 0.4),
                mod.FamilyChange(7, 9, lambda v, t: v.pos[:, 1] < 0.6)]

    ref = jinteg.apply_family_changes(o["jo"], rules(jpresc), VS,
                                      jnp.float32(T0))
    got = tinteg.apply_family_changes(o["to"], rules(tpresc), VS,
                                      torch.tensor(T0))
    fam0, fam = _np(o["to"].family), _np(got.family)
    np.testing.assert_array_equal(fam, np.asarray(ref.family))
    moved = (fam0 == 0) & (fam != 0)
    assert moved.any() and (fam[moved] == 7).all()  # 0 -> 7, never -> 9
    assert ((fam0 == 7) & (fam == 9)).any()


# ---------------------------------------------------------------------------
# the DEMSolver scene
# ---------------------------------------------------------------------------

R = 0.005
H = 1e-5
NX, NY, NZ = 8, 8, 3


def _scene(dem, lib, **device):
    """8 x 8 x 3 clumps on a floor: bottom layer family 1 (fixed, its
    (1, 1) contacts off), a 2*2^2-triangle plate in family 2 on the top
    layer, pressed down at f(t) with no spin, a rule sending the top
    layer's clumps under the plate from 0 to 3, whose clumps feel an
    added 9.81 m/s^2 downwards; every 11th clump of the middle layer in
    family 4 with a velocity correction; one tracker velocity and a
    next-step acceleration. SetMaxTriangleInBin is called (stored
    only)."""
    from dem_engine_tpu_torch.structs import DEMMeshConnected as TMesh

    from dem_engine_tpu.structs import DEMMeshConnected as JMesh

    s = dem.DEMSolver(**device)
    s.SetVerbosity("QUIET")
    dims = np.asarray([NX * 1.99 * R + 20 * R, NY * 1.99 * R + 20 * R,
                       NZ * 3.99 * R + 40 * R])
    s.InstructBoxDomainDimension(*dims)
    props = {"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4, "Crr": 0.0}
    mat = s.LoadMaterial(props)
    mat2 = s.LoadMaterial(dict(props, E=3e7, mu=0.2))
    m_s = 2600 * 4 / 3 * np.pi * R**3
    i_s = 0.4 * m_s * R * R
    tmpl = s.LoadClumpType(
        3 * m_s, [3 * i_s + 2 * m_s * R * R] * 2 + [3 * i_s], [R, R, R],
        [[0, 0, -R], [0, 0, 0], [0, 0, R]], mat)
    idx = np.arange(NX * NY * NZ)
    ii, jj, kk = idx % NX, (idx // NX) % NY, idx // (NX * NY)
    lbf = -dims / 2
    pos = np.stack([ii * 1.99 * R + 10 * R, jj * 1.99 * R + 10 * R,
                    kk * 3.99 * R + 4 * R], axis=-1) + lbf
    pos += np.random.default_rng(0).uniform(-0.02 * R, 0.02 * R, pos.shape)
    batch = s.AddClumps(tmpl, pos)
    fam = np.where(kk == 0, 1, 0)
    fam[(kk == 1) & (idx % 11 == 0)] = 4
    batch.SetFamilies(fam)
    s.AddBCPlane([0, 0, lbf[2] + 2 * R], [0, 0, 1], mat)
    verts, faces = plate_mesh(2)
    plate = (JMesh if dem is jdem else TMesh)(vertices=verts, faces=faces)
    plate.SetFamily(2)
    center = pos[kk == NZ - 1].mean(0)
    # pressed 0.05 R into the mean top of the top layer's clumps
    plate.SetInitPos([center[0], center[1], center[2] + 1.95 * R])
    s.AddWavefrontMeshObject(plate, mat)
    s.SetFamilyFixed(1)
    s.DisableContactBetweenFamilies(1, 1)
    s.SetFamilyPrescribedLinVel(2, 0, 0, lambda t: -0.05 * lib.cos(4e3 * t))
    s.SetFamilyPrescribedAngVel(2, 0, 0, 0)
    # LBF-relative: the top layer's clumps under the plate's footprint
    c = center - lbf
    z_top = float(pos[kk == NZ - 1, 2].min() - lbf[2] - R)
    s.ChangeFamilyWhen(0, 3, lambda v, t: (
        (v.pos[:, 2] > z_top) & ((v.pos[:, 0] - c[0]).abs() < 6 * R)
        & ((v.pos[:, 1] - c[1]).abs() < 6 * R))
        if lib is torch else (
        (v.pos[:, 2] > z_top) & (jnp.abs(v.pos[:, 0] - c[0]) < 6 * R)
        & (jnp.abs(v.pos[:, 1] - c[1]) < 6 * R)))
    s.AddFamilyPrescribedAcc(3, 0, 0, -9.81)
    s.CorrectFamilyLinVel(4, 0.01, 0.0, lambda t: 0 * t - 0.02)
    s.SetInitTimeStep(H)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    # K = 19: the first call's next-step acceleration splits it into 1 +
    # 19 steps, the second call into 19 + 1, so the JAX package compiles
    # two step programs
    s.SetCDUpdateFreq(19)
    s.SetMaxTriangleInBin(64)
    tracker = s.Track(batch)
    s.Initialize()
    tracker.SetVel([0.0, 0.02, -0.05], offset=100)
    s.AddOwnerNextStepAcc([70, 71], [0.0, 0.0, 50.0])
    return s, tracker, mat2


def _pairs(state):
    out = []
    for name in ("ss", "st", "sa"):
        t = getattr(state, name)
        a, b = _np(t.idA), _np(t.idB)
        out.append(set(zip(a[a >= 0].tolist(), b[a >= 0].tolist())))
    return out


def _snap(s):
    o = s.state.owners
    return dict(pos=s.GetOwnerPosition(), vel=s.GetOwnerVelocity(),
                omg=s.GetOwnerAngVel(), quat=s.GetOwnerOriQ(),
                fam=s.GetOwnerFamily(), vox=_np(o.vox).copy(),
                loc=_np(o.loc).copy(), pairs=_pairs(s.state),
                time=s.GetTime())


@pytest.fixture(scope="module")
def scene():
    out = {}
    for name, dem, lib, dev in (("jax", jdem, jnp, {}),
                                ("port", tdem, torch, {"device": "cpu"})):
        s, tr, mat2 = _scene(dem, lib, **dev)
        span0 = s.engine.cfg.max_tri_span
        snaps = [_snap(s)]
        s.DoDynamics(20 * H)
        snaps.append(_snap(s))
        s.ChangeFamily(4, 0)
        s.SetFamilyClumpMaterial(3, mat2)
        s.EnableContactBetweenFamilies(1, 1)
        s.SetFamilyExtraMargin(2, 0.1 * R)
        s.DoDynamics(20 * H)
        snaps.append(_snap(s))
        out[name] = dict(s=s, tr=tr, snaps=snaps, span0=span0)
    return out


def test_scene_matches_jax(scene):
    js, ts = scene["jax"], scene["port"]
    vs = ts["s"]._voxel_size
    for k, (ref, got) in enumerate(zip(js["snaps"], ts["snaps"])):
        assert ref["time"] == got["time"]
        assert np.abs(ref["pos"] - got["pos"]).max() < 1e-3 * vs, k
        for name in ("vel", "omg", "quat"):
            assert _rel(ref[name], got[name]) < 2e-4, (k, name)
        np.testing.assert_array_equal(ref["fam"], got["fam"])
        for kind, a, b in zip(("SS", "ST", "SA"), ref["pairs"],
                              got["pairs"]):
            assert a == b, (k, kind)
    fam1, fam2 = ts["snaps"][1]["fam"], ts["snaps"][2]["fam"]
    assert (fam1 == 3).sum() > 0 and not (fam2 == 4).any()
    # contacts of every kind; no (1, 1) pair until it was enabled
    own = _np(ts["s"].state.spheres.owner)
    for k in (1, 2):
        ss = np.asarray(sorted(ts["snaps"][k]["pairs"][0]))
        fa = ts["snaps"][k]["fam"][own[ss[:, 0]]]
        fb = ts["snaps"][k]["fam"][own[ss[:, 1]]]
        assert ((fa == 1) & (fb == 1)).any() == (k == 2)
        assert all(len(p) for p in ts["snaps"][k]["pairs"])


def test_scene_fixed_plate_and_tracker(scene):
    s, tr = scene["port"]["s"], scene["port"]["tr"]
    snaps = scene["port"]["snaps"]
    fixed = snaps[0]["fam"] == 1
    for k in (1, 2):
        np.testing.assert_array_equal(snaps[k]["vox"][fixed],
                                      snaps[0]["vox"][fixed])
        np.testing.assert_array_equal(snaps[k]["loc"][fixed],
                                      snaps[0]["loc"][fixed])
        np.testing.assert_array_equal(snaps[k]["quat"][fixed],
                                      snaps[0]["quat"][fixed])
        assert not snaps[k]["vel"][fixed].any()
        assert not snaps[k]["omg"][fixed].any()
    # the plate: z by the integral of f over the steps' f32 times
    p = s._meshes[0].owner_id
    t = np.float32(0.0)
    dz = 0.0
    for _ in range(40):
        dz += np.float32(-0.05 * np.cos(np.float32(4e3) * t)) * H
        t = np.float32(t + np.float32(H))
    got = snaps[2]["pos"][p] - snaps[0]["pos"][p]
    assert abs(got[2] - dz) < s._voxel_size and not got[:2].any()
    np.testing.assert_array_equal(snaps[2]["quat"][p], snaps[0]["quat"][p])
    # the next-step acceleration is gone, the tracker reads
    assert not _np(s.state.owners.ext_acc).any()
    assert tr.GetFamily(0) == 1 and list(tr.GetFamilies()) == list(
        snaps[2]["fam"][:NX * NY * NZ])


def test_max_triangle_in_bin_is_stored_only(scene):
    """The call leaves the ST span at its default (4) at Initialize in
    both packages; the span ladder then grows it alike, and the ST pair
    sets agree (test_scene_matches_jax)."""
    for name in ("jax", "port"):
        assert scene[name]["s"]._init_max_tri_span == 8
        assert scene[name]["span0"] == 4
    assert (scene["jax"]["s"].engine.cfg.max_tri_span
            == scene["port"]["s"].engine.cfg.max_tri_span)


def test_config_from_reference_with_and_without_prescriptions(scene):
    """The JAX config's prescriptions and rules hold JAX callables: the
    caller passes the port's own, checked family by family, channel by
    channel and mask by mask; without them it raises naming the
    argument."""
    import dataclasses

    jcfg = scene["jax"]["s"].engine.cfg
    tcfg = scene["port"]["s"].engine.cfg
    with pytest.raises(ValueError, match="prescriptions="):
        convert.config_from_reference(jcfg)
    with pytest.raises(ValueError, match="family_changes="):
        convert.config_from_reference(jcfg, prescriptions=tcfg.prescriptions)
    cfg = convert.config_from_reference(
        jcfg, prescriptions=tcfg.prescriptions,
        family_changes=tcfg.family_changes)
    assert cfg.prescriptions == tcfg.prescriptions
    assert cfg.family_changes == tcfg.family_changes
    assert len(cfg.prescriptions) == 4 and len(cfg.family_changes) == 1
    # another mask, a missing family, another rule: refused
    other = [p if p.family != 2 else dataclasses.replace(
        p, lin_vel_mask=(True, False, True)) for p in tcfg.prescriptions]
    for presc, rules in ((other, tcfg.family_changes),
                         (tcfg.prescriptions[1:], tcfg.family_changes),
                         (tcfg.prescriptions,
                          [tpresc.FamilyChange(0, 5, lambda v, t: True)])):
        with pytest.raises(ValueError, match="differ"):
            convert.config_from_reference(jcfg, prescriptions=presc,
                                          family_changes=rules)
    plain = dataclasses.replace(jcfg, prescriptions=(), family_changes=())
    cfg = convert.config_from_reference(plain)
    assert cfg.prescriptions == () and cfg.family_changes == ()


# ---------------------------------------------------------------------------
# the integrators (tests/test_integrators.py's one-step free fall)
# ---------------------------------------------------------------------------

V0 = 0.3


def _free_fall(integ):
    """One step of a lone sphere thrown up at V0 under g = -9.81, h =
    1e-3, through the port's refresh and step: (z displacement, new vz),
    and the same step of the JAX package's integrator (no contact: zero
    force sums)."""
    vs = 1.0 / 2**16
    owners = tinit.make_owners(pos=np.asarray([[0.5, 0.5, 0.5]]),
                               voxel_size=vs,
                               vel=np.asarray([[0.0, 0.0, V0]]),
                               mass=np.asarray([1.0]), moi=np.ones((1, 3)),
                               device="cpu")
    spheres = tinit.make_spheres(owner=[0], relpos=np.zeros((1, 3)),
                                 radius=np.asarray([0.01]), device="cpu")
    cfg = TSolverConfig(voxel_size=vs, integrator=TimeIntegrator(integ),
                        force_model=tdem.HertzianForceModel(), cap_ss=8,
                        cap_st=8, cap_sa=8)
    params = tinit.make_params(
        h=1e-3, gravity=[0.0, 0.0, -9.81], domain=[1.0, 1.0, 1.0],
        materials={"E": np.asarray([1e7], np.float32),
                   "nu": np.asarray([0.3], np.float32)},
        pair_materials={"CoR": np.asarray([[0.5]], np.float32),
                        "mu": np.asarray([[0.3]], np.float32),
                        "Crr": np.asarray([[0.0]], np.float32)},
        update_freq=5, device="cpu")
    state = tsolver.refresh_contacts(
        tinit.make_state(owners, spheres, cfg), params, cfg)
    new = tsolver.dynamics_step(state, params, cfg)
    jo = jax.tree_util.tree_map(jnp.asarray, convert_owners(state.owners))
    zero = jnp.zeros((1, 3), F_J)
    # jitted: one compile per integrator, not one per operation
    jt = jpresc.PrescriptionTables((), jnp.float32(0.0))
    ref = jax.jit(lambda jo, zero, jp: jinteg.integrate_owners(
        jo, zero, zero, jp, jt, vs, jdem.TimeIntegrator(integ),
        jnp.float32(0.0)))(
        jo, zero, jinit.make_params(
            h=1e-3, gravity=[0.0, 0.0, -9.81], domain=[1.0, 1.0, 1.0],
            materials={}, pair_materials={}))

    def z(o):
        return float(np.float64(_np(o.vox)[0, 2]) * vs + _np(o.loc)[0, 2])

    return ((z(new.owners) - z(state.owners),
             float(_np(new.owners.vel)[0, 2])),
            (z(ref) - z(state.owners), float(np.asarray(ref.vel)[0, 2])))


def convert_owners(o):
    """The port's owners as the JAX package's (numpy leaves)."""
    from dem_engine_tpu.state import Owners as JOwners

    return JOwners(**{f: _np(getattr(o, f)) for f in (
        "vox", "loc", "quat", "vel", "omg", "lin_acc", "ang_acc", "ext_acc",
        "ext_ang_acc", "family", "mass", "moi")}, wildcards={})


@pytest.mark.parametrize("integ, v_pass", [
    ("forward_euler", V0),                          # the old velocity
    ("centered_difference", V0 - 9.81e-3),          # the new velocity
    ("extended_taylor", V0 - 0.5 * 9.81e-3)])       # the midpoint
def test_integrators_one_step_match_jax(integ, v_pass):
    got, ref = _free_fall(integ)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got[0], v_pass * 1e-3, rtol=1e-4)
    np.testing.assert_allclose(got[1], V0 - 9.81e-3, rtol=1e-5)
    s = tdem.DEMSolver(device="cpu")
    s.SetIntegrator(integ)
    assert s._integrator == TimeIntegrator(integ)
