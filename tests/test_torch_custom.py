"""Custom force models, wildcards, persistency and restart contacts: the
port's DEMSolver against the JAX package's, on the CPU.

Each model is written twice, with jnp for the JAX package and with torch
for the port (``dem_engine_tpu_torch.cases``); a model's callable runs in
its own framework. Each JAX scene runs once, in a module-scoped fixture.

* Cohesive scene: the 256-clump scene of tests/test_torch_api.py (K = 5,
  20 steps, Crr = 0) with Hertz-Mindlin plus cohesion (Cohesion 20),
  scaled by the
  owner wildcard `coh_scale` (0 on a tagged family of 32 clumps, set by
  SetFamilyOwnerWildcardValue) and the geometry wildcard `stick`. Owner
  vel/omg within 2e-4 of the largest value, positions within 1e-3 of a
  voxel, the same contact pairs, and per (kind, idA, idB) the four
  friction-history wildcards and the query's force within 2e-4 of the
  largest (both packages read the last step's contact_pass fields).
* Bonded 4^3 block on a floor: the bond model of examples/fracture_box.py,
  MarkFamilyPersistentContact(0), a dry run, SetContactWildcardValueAll;
  then the top two layers moved up by 4 R with SetOwnerPosition, so the
  16 bonds across the cut are no longer detected and come back by
  re-injection, and 10 steps. Pair sets (re-injected rows included),
  persist and `unbroken` equal exactly: no stretch lies near the break
  limit (bonds start at 2 % overlap against a 3 % limit, and the cut
  bonds sit at ~2 R of stretch). Then a restart on a dry run: the
  block's final table by SetExistingContacts and its wildcards, same
  table as JAX's.
* Electrostatic pair: geometry wildcard `Q`, no_contact_force, an extra
  margin; velocities within 2e-4 of the largest.
* The built-in Hertz model through contact_pass (SetPerContactWildcards
  drops its fused variant) against the port's fused CPU path on one
  table: per-contact force and torque within 1e-5 of the largest (the
  two differ by rounding only), per-owner wrench within 2e-4.
* carry_history with persistency against the JAX package's, rows past
  the capacity dropped; config_from_reference refuses a port model whose
  declared resources differ from the JAX model's.

On this scene the limits on positions (1e-3 of a voxel, 2.7e-10 m) and
on the friction history (2e-4 of the largest) are as tight as the f32
rounding of the reference itself. At Cohesion 0, 40 and 50
(examples/cohesion_pile.py uses 50) the port and JAX part by more than
one of them: friction history 6.1e-4 at 0, position 1.08e-3 voxel and
friction history 1.28e-3 at 40, friction history 2.03e-4 at 50. Each
package's f32 run lies as far from a float64 run of the port's own code
from the same start: 0.46-1.17e-3 voxel, friction history 1.1e-4 to
1.25e-3. The scene runs at 20, where every limit holds. Run from the
repo root as ``python -m tests.test_torch_custom``, the file prints those
differences at Cohesion 0, 20, 40 and 50.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dem_engine_tpu as jdem
import dem_engine_tpu_torch as tdem
from dem_engine_tpu.models.force_model import ForceModel as JForceModel
from dem_engine_tpu.models.hertz import _full_fn as j_full_fn
from dem_engine_tpu.ops import history as jhistory
from dem_engine_tpu_torch import cases, convert
from dem_engine_tpu_torch.models import HertzianForceModel
from dem_engine_tpu_torch.ops import forces, history
from dem_engine_tpu_torch.ops.fused_force import fused_wrench_ss, hertz_rows
from dem_engine_tpu_torch.state import ContactTable
from test_torch_slice import jax_steps_without_donation  # noqa: F401

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

R = 0.005
H = 1e-5
COHESION = 20.0  # see the module docstring for 40 and 50


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


# --- the models in jnp, as cases.cohesion_model / cases.bond_model -------

def j_cohesion_model():
    def fn(ctx):
        force, torque, wc = j_full_fn(ctx)
        m_eff = ctx.a_mass * ctx.b_mass / jnp.maximum(
            ctx.a_mass + ctx.b_mass, 1e-30)
        scale = ctx.a_owner_wc["coh_scale"] * ctx.b_owner_wc["coh_scale"]
        scale = scale * ctx.a_geo_wc["stick"]
        if "stick" in ctx.b_geo_wc:
            scale = scale * ctx.b_geo_wc["stick"]
        f_coh = jnp.where(ctx.overlap > 0.0,
                          ctx.pair("Cohesion") * m_eff * scale, 0.0)
        return force - f_coh[:, None] * ctx.b2a, torque, wc

    return JForceModel(
        name="hertz_cohesion", fn=fn,
        contact_wildcards=cases.FRICTION_HISTORY,
        owner_wildcards=("coh_scale",), geo_wildcards=("stick",),
        per_material_props=("E", "nu"),
        pairwise_props=("CoR", "mu", "Crr", "Cohesion"))


def j_bond_model(k_bond=1e5, break_strain=0.015, kn_contact=1e5,
                 damp=0.25):
    def fn(ctx):
        stretch = -ctx.overlap
        unbroken = ctx.wildcards["unbroken"]
        lim = break_strain * (ctx.a_radius + ctx.b_radius)
        breaks = (stretch > lim) | (ctx.overlap > lim)
        unbroken = jnp.where(breaks, 0.0, unbroken)
        f_bond = jnp.where(unbroken > 0.5, k_bond * ctx.overlap, 0.0)
        f_contact = jnp.where((unbroken <= 0.5) & (ctx.overlap > 0),
                              kn_contact * ctx.overlap, 0.0)
        m_eff = ctx.a_mass * ctx.b_mass / (ctx.a_mass + ctx.b_mass)
        vn = jnp.sum((ctx.a_lin_vel - ctx.b_lin_vel) * ctx.b2a, axis=-1)
        active = (unbroken > 0.5) | (ctx.overlap > 0)
        c = 2.0 * damp * jnp.sqrt(k_bond * m_eff)
        f_damp = jnp.where(active, -c * vn, 0.0)
        force = (f_bond + f_contact + f_damp)[:, None] * ctx.b2a
        return force, jnp.zeros_like(force), {"unbroken": unbroken}

    return JForceModel(
        name="bond", fn=fn, contact_wildcards=("unbroken",),
        per_material_props=(), pairwise_props=(), no_contact_force=True)


def j_coulomb_model():
    from dem_engine_tpu.models.force_model import hertz_material_mix

    def fn(ctx):
        E, nu = ctx.mat("E"), ctx.mat("nu")
        E_eff, _ = hertz_material_mix(E[0], nu[0], E[1], nu[1])
        ovl = jnp.maximum(ctx.overlap, 0.0)
        r_eff = ctx.a_radius * ctx.b_radius / (ctx.a_radius + ctx.b_radius)
        kn = (4.0 / 3.0) * E_eff * jnp.sqrt(ovl * r_eff)
        dist = ctx.a_radius + ctx.b_radius - ctx.overlap
        f_c = 9e-3 * ctx.a_geo_wc["Q"] * ctx.b_geo_wc["Q"] / jnp.maximum(
            dist * dist, 1e-12)
        force = (kn * ovl + f_c)[:, None] * ctx.b2a
        return force, jnp.zeros_like(force), {}

    return JForceModel(name="hertz_coulomb", fn=fn, geo_wildcards=("Q",),
                       pairwise_props=(), no_contact_force=True)


def t_coulomb_model():
    from dem_engine_tpu_torch.models.force_model import (ForceModel,
                                                         hertz_material_mix)

    def fn(ctx):
        E, nu = ctx.mat("E"), ctx.mat("nu")
        E_eff, _ = hertz_material_mix(E[0], nu[0], E[1], nu[1])
        ovl = torch.clamp(ctx.overlap, min=0.0)
        r_eff = ctx.a_radius * ctx.b_radius / (ctx.a_radius + ctx.b_radius)
        kn = (4.0 / 3.0) * E_eff * torch.sqrt(ovl * r_eff)
        dist = ctx.a_radius + ctx.b_radius - ctx.overlap
        f_c = 9e-3 * ctx.a_geo_wc["Q"] * ctx.b_geo_wc["Q"] / torch.clamp(
            dist * dist, min=1e-12)
        force = (kn * ovl + f_c)[:, None] * ctx.b2a
        return force, torch.zeros_like(force), {}

    return ForceModel(name="hertz_coulomb", fn=fn, geo_wildcards=("Q",),
                      pairwise_props=(), no_contact_force=True)


# --- scenes ----------------------------------------------------------------

def _cohesive(dem, model, cohesion=COHESION, steps=20, **device):
    """tests/test_torch_api.py's scene with the cohesion model: the last
    32 clumps in family 1, whose `coh_scale` goes to 0."""
    s = dem.DEMSolver(**device)
    s.SetVerbosity("QUIET")
    nx, ny, nz = 8, 8, 4
    dims = np.asarray([nx * 1.99 * R + 20 * R, ny * 1.99 * R + 20 * R,
                       nz * 3.99 * R + 40 * R])
    s.InstructBoxDomainDimension(*dims)
    s.InstructBoxDomainBoundingBC("top_open")
    mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                          "Crr": 0.0, "Cohesion": cohesion})
    s.DefineContactForceModel(model)
    m_s = 2600 * 4 / 3 * np.pi * R**3
    i_s = 0.4 * m_s * R * R
    tmpl = s.LoadClumpType(
        3 * m_s, [3 * i_s + 2 * m_s * R * R] * 2 + [3 * i_s], [R, R, R],
        [[0, 0, -R], [0, 0, 0], [0, 0, R]], mat)
    n = nx * ny * nz
    idx = np.arange(n)
    ii, jj, kk = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    lbf = -dims / 2
    pos = np.stack([ii * 1.99 * R + 10 * R, jj * 1.99 * R + 10 * R,
                    kk * 3.99 * R + 4 * R], axis=-1) + lbf
    pos += np.random.default_rng(0).uniform(-0.1 * R, 0.1 * R, pos.shape)
    batch = s.AddClumps(tmpl, pos)
    batch.SetFamilies(np.where(idx >= n - 32, 1, 0))
    batch.AddOwnerWildcard("coh_scale", 1.0)
    batch.AddGeometryWildcard("stick", np.ones(n))
    s.AddBCPlane([0, 0, lbf[2] + 2 * R], [0, 0, 1], mat)
    s.SetInitTimeStep(H)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(5)
    s.Initialize()
    s.SetFamilyOwnerWildcardValue(1, "coh_scale", 0.0)
    if steps:
        s.DoDynamics(steps * H)
    return s


SIDE = 4
RB = 0.01  # the block's sphere radius


def _block(dem, model, **device):
    """A 4^3 block of single spheres at pitch 1.98 RB on a floor, bonded
    at a dry run."""
    s = dem.DEMSolver(**device)
    s.SetVerbosity("QUIET")
    s.InstructBoxDomainDimension(0.4, 0.4, 0.4)
    floor = -0.18
    mat = s.LoadMaterial({"E": 1e8, "nu": 0.3, "CoR": 0.3, "mu": 0.4,
                          "Crr": 0.0})
    s.DefineContactForceModel(model)
    tmpl = s.LoadSphereType(2600 * 4 / 3 * np.pi * RB**3, RB, mat)
    g = np.mgrid[0:SIDE, 0:SIDE, 0:SIDE].reshape(3, -1).T[:, ::-1]
    pts = (g - (SIDE - 1) / 2) * 1.98 * RB
    pts[:, 2] += floor + RB + 1.5 * 1.98 * RB
    s.AddClumps(tmpl, pts)
    s.AddBCPlane([0, 0, floor], [0, 0, 1], mat)
    s.MarkFamilyPersistentContact(0)
    s.SetInitTimeStep(H)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(5)
    return s, pts


def _bonded(dem, model, **device):
    """The block bonded, cut between layers 1 and 2 (SetOwnerPosition),
    10 steps; returns the solver and the SS pair count before the
    cut."""
    s, pts = _block(dem, model, **device)
    s.Initialize(dry_run=True)
    s.SetContactWildcardValueAll("unbroken", 1.0)
    n0 = int(s.state.ss.count)
    top = np.nonzero(pts[:, 2] > pts[:, 2].mean())[0]
    s.SetOwnerPosition(top, pts[top] + [0.0, 0.0, 4 * RB])
    s.DoDynamics(10 * H)
    return s, n0


def _restart(dem, model, pairs, wc, **device):
    s, _ = _block(dem, model, **device)
    b = s._batches[0]
    b.SetExistingContacts({"idA": pairs[0], "idB": pairs[1]})
    b.SetExistingContactWildcards(wc)
    s.Initialize(dry_run=True)
    return s


def _electro(dem, model, **device):
    s = dem.DEMSolver(**device)
    s.SetVerbosity("QUIET")
    s.InstructBoxDomainDimension(1, 1, 1)
    mat = s.LoadMaterial({"E": 1e8, "nu": 0.3})
    s.DefineContactForceModel(model)
    r = 0.01
    tmpl = s.LoadSphereType(0.001, r, mat)
    b = s.AddClumps(tmpl, np.asarray([[-0.02, 0, 0], [0.02, 0, 0]]))
    b.AddGeometryWildcard("Q", np.asarray([0.3, 0.3]))
    s.SetFamilyExtraMargin(0, 0.05)
    s.SetInitTimeStep(H)
    s.SetGravitationalAcceleration([0, 0, 0])
    s.Initialize()
    s.DoDynamics(100 * H)
    return s


@pytest.fixture(scope="module")
def runs():
    out = {}
    out["coh"] = (_cohesive(jdem, j_cohesion_model()),
                  _cohesive(tdem, cases.cohesion_model(), device="cpu"))
    out["bond"] = (_bonded(jdem, j_bond_model()),
                   _bonded(tdem, cases.bond_model(), device="cpu"))
    t = out["bond"][1][0].state.ss
    n = int(t.count)
    pairs = (t.idA[:n].numpy(), t.idB[:n].numpy())
    wc = {"unbroken": t.wildcards["unbroken"][:n].numpy()}
    out["restart"] = (_restart(jdem, j_bond_model(), pairs, wc),
                      _restart(tdem, cases.bond_model(), pairs, wc,
                               device="cpu"))
    out["electro"] = (_electro(jdem, j_coulomb_model()),
                      _electro(tdem, t_coulomb_model(), device="cpu"))
    return out


def _rows(table, names=()):
    """{(idA, idB): (persist, wildcard values)} of a table's live rows."""
    idA, idB = np.asarray(table.idA), np.asarray(table.idB)
    per = np.asarray(table.persist)
    wc = [np.asarray(table.wildcards[k]) for k in names]
    return {(int(a), int(b)): (int(per[i]), tuple(float(w[i]) for w in wc))
            for i, (a, b) in enumerate(zip(idA, idB)) if a >= 0}


def _owner_state_close(js, ts):
    for get in (js.GetOwnerVelocity, js.GetOwnerAngVel):
        name = get.__name__
        assert _rel(get(), getattr(ts, name)()) <= 2e-4, name
    vs = ts._voxel_size
    assert (np.abs(js.GetOwnerPosition() - ts.GetOwnerPosition()).max()
            <= 1e-3 * vs)


def test_cohesive_scene_matches(runs):
    js, ts = runs["coh"]
    _owner_state_close(js, ts)
    assert ts.engine.cfg.force_model.fused_variant is None
    names = cases.FRICTION_HISTORY
    for kind in ("ss", "sa"):
        jr = _rows(getattr(js.state, kind), names)
        tr = _rows(getattr(ts.state, kind), names)
        assert set(jr) == set(tr) and jr, kind
        keys = sorted(jr)
        jw = np.asarray([jr[k][1] for k in keys])
        tw = np.asarray([tr[k][1] for k in keys])
        assert np.abs(jw).max() > 0, kind  # history is live
        assert _rel(jw, tw) <= 2e-4, kind
    # the tagged family's owners carry coh_scale 0, the others 1
    assert not ts.GetFamilyOwnerWildcardValue(1, "coh_scale").any()
    np.testing.assert_array_equal(ts.GetOwnerWildcardValue("coh_scale"),
                                  js.GetOwnerWildcardValue("coh_scale"))
    # the query reads the last step's contact_pass fields in both
    jinfo = {b["kind"]: b for b in js.GetContactDetailedInfo()}
    tinfo = {b["kind"]: b for b in ts.GetContactDetailedInfo()}
    assert set(jinfo) == set(tinfo) == {"SS", "SA"}
    for kind, jb in jinfo.items():
        tb = tinfo[kind]
        jk = {(a, b): i for i, (a, b) in enumerate(zip(jb["idA"],
                                                       jb["idB"]))}
        order = [jk[(a, b)] for a, b in zip(tb["idA"], tb["idB"])]
        assert _rel(jb["force"][order], tb["force"]) <= 2e-4, kind


def test_cohesive_scene_files(runs, tmp_path):
    """Owner wildcard columns in the clump file, geometry wildcard
    columns in the sphere file, contact wildcards in the contact file and
    its reader."""
    _, ts = runs["coh"]
    ts.EnableOwnerWildcardOutput()
    ts.EnableGeometryWildcardOutput()
    ts.WriteClumpFile(str(tmp_path / "c.csv"))
    ts.WriteSphereFile(str(tmp_path / "s.csv"))
    ts.WriteContactFile(str(tmp_path / "k.csv"))
    import csv

    with open(tmp_path / "c.csv") as f:
        rows = list(csv.DictReader(f))
    np.testing.assert_array_equal(
        [float(r["coh_scale"]) for r in rows],
        ts.GetOwnerWildcardValue("coh_scale")[:ts.GetNumClumps()])
    with open(tmp_path / "s.csv") as f:
        assert all(float(r["stick"]) == 1.0 for r in csv.DictReader(f))
    wc = ts.ReadContactWildcardsFromCsv(str(tmp_path / "k.csv"),
                                        ["delta_time"])
    np.testing.assert_allclose(
        wc["delta_time"], ts.GetAllContactWildcardValue("delta_time"),
        rtol=1e-6)


def test_bonded_block_matches(runs):
    (js, jn0), (ts, tn0) = runs["bond"]
    assert jn0 == tn0 == 3 * SIDE * SIDE * (SIDE - 1)
    assert ts.engine.cfg.use_persistency
    for kind in ("ss", "sa"):
        jr = _rows(getattr(js.state, kind), ("unbroken",))
        tr = _rows(getattr(ts.state, kind), ("unbroken",))
        assert jr == tr and jr, kind
    ss = _rows(ts.state.ss, ("unbroken",))
    # every bond is still in the table, the 16 across the cut broken
    assert len(ss) == tn0
    assert sum(v[1][0] == 0.0 for v in ss.values()) == SIDE * SIDE
    assert all(v[0] == 1 for v in ss.values())
    _owner_state_close(js, ts)


def test_restart_contacts_match(runs):
    js, ts = runs["restart"]
    jr = _rows(js.state.ss, ("unbroken",))
    tr = _rows(ts.state.ss, ("unbroken",))
    assert jr == tr
    # the block is back on its lattice: every bond is detected again and
    # carries its `unbroken`, the cut ones 0
    _, (tb, _) = runs["bond"]
    assert set(tr) == set(_rows(tb.state.ss))
    assert sum(v[1][0] == 0.0 for v in tr.values()) == SIDE * SIDE


def test_electrostatic_pair_matches(runs):
    js, ts = runs["electro"]
    v = ts.GetOwnerVelocity()
    assert v[0, 0] < 0 < v[1, 0]
    assert _rel(js.GetOwnerVelocity(), v) <= 2e-4
    assert ts.engine.cfg.force_model.no_contact_force


def test_hertz_contact_pass_matches_fused(runs):
    """The cohesive scene's final table under the built-in Hertz model:
    the fused pass against contact_pass, per contact (rounding apart) and
    in the segment sums."""
    _, ts = runs["coh"]
    st, cfg = ts.state, ts.engine.cfg
    fused = HertzianForceModel()
    plain = HertzianForceModel()
    plain.SetPerContactWildcards(fused.contact_wildcards)
    assert plain.fused_variant is None and forces.fused_ss(fused)
    args = (st.owners, st.spheres, st.tris, st.anals, ts.params)
    t_f = forces.finalize_table("ss", st.ss, *args, fused)
    t_p = forces.finalize_table("ss", st.ss, *args, plain)
    acc, _ = fused_wrench_ss(t_f, st.owners, float(ts.params.h),
                             cfg.voxel_size, fused,
                             forces.pack_kinematics(st.owners, True))
    p = forces.contact_pass("ss", t_p, *args[:4], ts.params, st.time,
                            cfg.voxel_size, plain)
    acc_p = forces.reduce_wrench_segment(st.owners.n, [p])
    live = t_f.idA >= 0
    oa, ob = (torch.where(live, o, 0).long() for o in (t_f.own_a,
                                                       t_f.own_b))
    wc = torch.stack([t_f.wildcards[k] for k in cases.FRICTION_HISTORY])
    krec = forces.pack_kinematics(st.owners, True)
    rows = hertz_rows(t_f.fstat_a, wc, krec[oa], krec[ob],
                      float(ts.params.h), cfg.voxel_size, True)
    for got, ref in zip((p["rec_a"], p["rec_b"]), rows[:2]):
        for part in (slice(0, 3), slice(3, 6)):
            assert _rel(ref[live, part], got[live, part]) <= 1e-5
    assert _rel(acc[:, :3], acc_p[:, :3]) <= 2e-4
    assert _rel(acc[:, 3:], acc_p[:, 3:]) <= 2e-4


def test_carry_history_persistency_matches():
    """Re-injection against the JAX package's carry_history: persistent
    old rows not found again land after the new ones, rows past the
    capacity drop and the count says so."""
    rng = np.random.default_rng(3)
    cap, n_old, n_new = 40, 40, 30
    pairs = np.unique(rng.integers(0, 60, (200, 2)), axis=0)
    pairs = pairs[pairs[:, 0] < pairs[:, 1]]
    shuffled = pairs[rng.permutation(len(pairs))]
    old = shuffled[:n_old]
    new = np.concatenate([old[:10], shuffled[n_old:n_old + n_new - 10]])
    persist = (rng.random(cap) < 0.5).astype(np.int32)
    wc = rng.random(cap).astype(np.float32)

    def table(empty, to):
        ids = np.full((2, cap), -1, np.int32)
        ids[:, :n_old] = old.T
        t = empty(cap, ("w",))
        return t.replace(idA=to(ids[0]), idB=to(ids[1]),
                         persist=to(np.where(ids[0] >= 0, persist, 0)),
                         wildcards={"w": to(wc)},
                         count=to(np.int32(n_old)))

    from dem_engine_tpu import state as jstate

    new_ids = np.full((2, cap), -1, np.int32)
    new_ids[:, :n_new] = new.T
    jt, jlost = jax.jit(jhistory.carry_history, static_argnums=(4, 5))(
        table(jstate.ContactTable.empty, jnp.asarray),
        jnp.asarray(new_ids[0]),
        jnp.asarray(new_ids[1]), jnp.asarray(np.int32(n_new)), ("w",),
        True)
    tt, tlost = history.carry_history(
        table(ContactTable.empty, torch.as_tensor),
        torch.as_tensor(new_ids[0]), torch.as_tensor(new_ids[1]),
        torch.tensor(n_new, dtype=torch.int32), ("w",), True)
    n_keep = int(((persist[:n_old] > 0)
                  & ~np.isin(old[:, 0] * 100 + old[:, 1],
                             new[:, 0] * 100 + new[:, 1])).sum())
    assert int(tt.count) == int(jt.count) == n_new + n_keep > cap
    assert int(tlost) == int(jlost)
    for f in ("idA", "idB", "persist"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), f)
    np.testing.assert_array_equal(tt.wildcards["w"].numpy(),
                                  np.asarray(jt.wildcards["w"]))


def test_config_from_reference_checks_the_model(runs):
    js, ts = runs["coh"]
    jcfg = js.engine.cfg
    cfg = convert.config_from_reference(
        jcfg, force_model=ts.engine.cfg.force_model)
    assert cfg.force_model is ts.engine.cfg.force_model
    with pytest.raises(ValueError, match="force_model="):
        convert.config_from_reference(jcfg)
    other = cases.cohesion_model()
    other.SetMustPairwiseMatProp(("CoR", "mu", "Crr"))
    with pytest.raises(ValueError, match="pairwise_props"):
        convert.config_from_reference(jcfg, force_model=other)
    bcfg = convert.config_from_reference(
        runs["bond"][0][0].engine.cfg,
        force_model=runs["bond"][1][0].engine.cfg.force_model)
    assert bcfg.use_persistency
    # the state carries owner, geometry and contact wildcards and persist
    ref = convert.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js.state), "cpu",
        fused_ss=False)
    np.testing.assert_array_equal(ref.owners.wildcards["coh_scale"],
                                  ts.state.owners.wildcards["coh_scale"])
    np.testing.assert_array_equal(ref.spheres.wildcards["stick"],
                                  ts.state.spheres.wildcards["stick"])
    assert set(ref.ss.wildcards) == set(cases.FRICTION_HISTORY)


def test_pair_lists_are_front_compacted():
    """Re-injection appends after the count, so the SS pair lists must
    hold their live rows first: the single-grid search and the two-class
    list (small-small, then large-large and small-large) on the CPU; the
    card's kernel C is held to it in chip_smoke.py's bonded phase."""
    from dem_engine_tpu_torch.ops import sweep
    from dem_engine_tpu_torch.solver import ss_search_inputs, two_class_pairs

    cfg, state, params = tdem.build_case(256, poly_frac=0.2, device="cpu")
    assert cfg.cd_two_class
    params = params.replace(max_drift=torch.tensor(20, dtype=torch.int32))
    q = ss_search_inputs(state, params, cfg.voxel_size)
    small = state.spheres.radius <= params.cls_thr
    lists = [two_class_pairs(q, small, params, cfg, state.spheres.n)[:3],
             sweep.find_pairs_ss(q["pos_cd"], q["reach"], q["owner"],
                                 q["family"], q["family_mask"],
                                 q["bin_size"], q["nb_cd"], cfg.cap_ss)[:3]]
    for idA, idB, n in lists:
        n = int(n)
        assert 0 < n < idA.shape[0]
        assert bool((idA[:n] >= 0).all() and (idB[:n] >= 0).all())
        assert bool((idA[n:] == -1).all())


def _compare(a, b, vs):
    """(position difference in voxels; velocity, angular velocity and the
    SS friction history per pair, each relative to the largest) of two
    solvers of the cohesive scene."""
    n = b.GetNumClumps()
    ra = _rows(a.state.ss, cases.FRICTION_HISTORY)
    rb = _rows(b.state.ss, cases.FRICTION_HISTORY)
    assert set(ra) == set(rb)
    keys = sorted(ra)
    return (np.abs(a.GetOwnerPosition()[:n]
                   - b.GetOwnerPosition()[:n]).max() / vs,
            _rel(a.GetOwnerVelocity(), b.GetOwnerVelocity()),
            _rel(a.GetOwnerAngVel(), b.GetOwnerAngVel()),
            _rel([ra[k][1] for k in keys], [rb[k][1] for k in keys]))


def _float64_run(coh):
    """The port's cohesive scene stepped in float64: Initialize in f32 as
    usual, then every f32 tensor of the state, the parameters and the
    solver widened, and the package's float dtype F set to float64 for
    the 20 steps."""
    import dataclasses
    import sys

    def wide(x):
        if isinstance(x, torch.Tensor):
            return x.double() if x.dtype == torch.float32 else x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: wide(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if isinstance(x, dict):
            return {k: wide(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(wide(v) for v in x)
        return x

    s = _cohesive(tdem, cases.cohesion_model(), coh, steps=0, device="cpu")
    s.state, s.params = wide(s.state), wide(s.params)
    for k, v in list(vars(s).items()):
        setattr(s, k, wide(v) if isinstance(v, torch.Tensor) else v)
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("dem_engine_tpu_torch")
            and getattr(m, "F", None) is torch.float32]
    try:
        for m in mods:
            m.F = torch.float64
        s.DoDynamics(20 * H)
    finally:
        for m in mods:
            m.F = torch.float32
    assert s.state.owners.vel.dtype == torch.float64
    return s


def cohesion_study(values=(0.0, 20.0, 40.0, 50.0)):
    """The cohesive scene at each Cohesion: port against JAX, and each
    against the port's float64 run; the test's limits are 1e-3 voxel,
    2e-4, 2e-4 and 2e-4."""
    for coh in values:
        js = _cohesive(jdem, j_cohesion_model(), coh)
        ts = _cohesive(tdem, cases.cohesion_model(), coh, device="cpu")
        f64 = _float64_run(coh)
        vs = ts._voxel_size
        n = ts.GetNumClumps()
        start = _cohesive(tdem, cases.cohesion_model(), coh, steps=0,
                          device="cpu").GetOwnerPosition()[:n]
        print(f"Cohesion {coh:g}: largest displacement "
              f"{np.abs(ts.GetOwnerPosition()[:n] - start).max() / vs:.4g} "
              f"voxels", flush=True)
        for name, (d, v, w, h) in (("port - JAX", _compare(js, ts, vs)),
                                   ("port - float64", _compare(f64, ts, vs)),
                                   ("JAX - float64", _compare(f64, js, vs))):
            print(f"  {name}: position {d:.3e} voxel, velocity {v:.2e}, "
                  f"angular velocity {w:.2e}, friction history {h:.2e}",
                  flush=True)


if __name__ == "__main__":
    cohesion_study()
