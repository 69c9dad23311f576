"""The port's triangle meshes (ST) against the JAX package, on the CPU.

* ``narrowphase.closest_point_triangle`` and ``sphere_triangle`` within
  1e-6 of JAX's on random points around random triangles (every Voronoi
  region, and centres on the face).
* ``binning.find_pairs_st`` gives JAX's pair set, count and span flag on
  the ratio-3 cloud of tests/test_twoclass_cd.py with a family mask, for
  small facets and for a facet wider than the span.
* The slice: ``cases.build_case(512, poly_frac=0.2, with_mesh=True,
  plate_z=2R)`` (two-class CD, a 2-triangle plate under the bed, Crr = 0)
  equals JAX's build field by field; one refresh gives JAX's SS, ST and
  SA pair sets; after 2 chunks of K = 5, owner vel/omg within 2e-4
  relative and positions within 1e-3 of a voxel, and the last step's
  ``contact_pass("st")`` forces, torque-only forces and contact points
  within 2e-4 of the largest, pair by pair. The JAX reference runs
  its jitted refresh and steps once, in a module-scoped fixture.
* ``DEMSolver``: the exact candidate filter of
  tests/test_sentry_and_st.py (a domain-wide slanted facet near no
  sphere gives no ST pair; a sphere on a facet gives one; both through
  the span ladder to the exact S x T matrix); a clump bed on an OBJ plate
  gets ST forces in GetContactDetailedInfo and its tracker, and
  ``UpdateMesh`` moves ``GetMeshNodesGlobal`` and the next refresh's
  contacts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_twoclass_cd import _cloud

from __graft_entry__ import _build_case
from dem_engine_tpu.ops import binning as jb
from dem_engine_tpu.ops import narrowphase as jnarrow
from dem_engine_tpu.solver import refresh_contacts as jax_refresh
from dem_engine_tpu.solver import run_steps as jax_steps
from dem_engine_tpu_torch import DEMSolver, Engine, build_case, convert
from dem_engine_tpu_torch.cases import R
from dem_engine_tpu_torch.ops import binning as tb
from dem_engine_tpu_torch.ops import narrowphase
from dem_engine_tpu_torch.ops.voxel import decode_host
from dem_engine_tpu_torch.solver import refresh_contacts
from dem_engine_tpu_torch.structs import DEMMeshConnected

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


def _pairs(t_or_a, b=None):
    a, b = ((t_or_a.idA, t_or_a.idB) if b is None else (t_or_a, b))
    a, b = _np(a), _np(b)
    return set(zip(a[a >= 0].tolist(), b[a >= 0].tolist()))


def test_sphere_triangle_matches_jax():
    rng = np.random.default_rng(0)
    n = 4000
    tri = rng.uniform(-1, 1, (n, 3, 3)).astype(np.float32)
    p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    # a tenth of the centres on the face: the face-normal branch
    w = rng.dirichlet(np.ones(3), n // 10).astype(np.float32)
    p[:n // 10] = np.einsum("nk,nkd->nd", w, tri[:n // 10])
    rad = rng.uniform(0.1, 1.0, n).astype(np.float32)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    jout = (jnarrow.closest_point_triangle(p, a, b, c),
            *jnarrow.sphere_triangle(p, rad, a, b, c))
    tt = [torch.from_numpy(x) for x in (p, rad, a, b, c)]
    tout = (narrowphase.closest_point_triangle(tt[0], *tt[2:]),
            *narrowphase.sphere_triangle(*tt))
    for j, t in zip(jout, tout):
        assert np.abs(np.asarray(j) - t.numpy()).max() <= 1e-6


@pytest.mark.parametrize("facets", ["small", "wide"])
def test_find_pairs_st_matches_jax(facets):
    pos, reach, _, owner, _ = (np.asarray(x) for x in _cloud(seed=7))
    family = np.where(np.arange(len(pos)) % 3 == 0, 1, 0).astype(np.int32)
    mask = np.ones((256, 256), bool)
    mask[1, 255] = False
    rng = np.random.default_rng(1)
    size = 0.02 if facets == "small" else 0.6
    ctr = rng.uniform(0.1, 0.9, (40, 1, 3)) * [1, 1, 0.3]
    nodes = (ctr + rng.uniform(-size, size, (40, 3, 3)) * [1, 1, 0.3]
             ).astype(np.float32)
    t_owner = np.full(40, len(pos), np.int32)
    t_fam = np.where(np.arange(40) % 2 == 0, 255, 0).astype(np.int32)
    margin = np.full(40, 0.002, np.float32)
    amin = nodes.min(1) - margin[:, None]
    amax = nodes.max(1) + margin[:, None]
    domain = np.asarray([1.0, 1.0, 0.3], np.float32)
    args = [pos, reach, owner, family]

    jbs, jnb = jb.build_grid(jnp.asarray(domain), jnp.asarray(reach.max()))
    jtab = jb.build_sphere_table(*(jnp.asarray(x) for x in args), jbs, jnb,
                                 len(pos))
    ja, jbb, jn, jovf = jax.jit(jb.find_pairs_st, static_argnums=(8, 9, 10))(
        *(jnp.asarray(x) for x in (amin, amax, t_owner, t_fam)), jtab,
        jnp.asarray(mask), jbs, jnb, 65536, 4, 64,
        *(jnp.asarray(x) for x in (amin - reach.max(), amax + reach.max(),
                                   nodes, margin)))
    tbs, tnb = tb.build_grid(torch.from_numpy(domain),
                             torch.tensor(reach.max()))
    ttab = tb.build_sphere_table(*(torch.from_numpy(x) for x in args), tbs,
                                 tnb, len(pos))
    ta, tbb, tn, tovf = tb.find_pairs_st(
        *(torch.from_numpy(x) for x in (amin, amax, t_owner, t_fam)), ttab,
        torch.from_numpy(mask), tbs, tnb, 65536, 4, 64,
        *(torch.from_numpy(x) for x in (amin - reach.max(),
                                        amax + reach.max(), nodes, margin)))
    assert int(ttab.max_occ) <= 64
    got = _pairs(ta, tbb)
    assert got == _pairs(ja, jbb)
    assert int(tn) == int(jn) == len(got) > 10
    assert bool(tovf) == bool(jovf) == (facets == "wide")
    assert not any(t_fam[t] == 255 and family[s] == 1 for s, t in got)


@pytest.fixture(scope="module")
def slice_runs():
    """The JAX slice (jitted refresh and 5 steps, run twice) and the
    port's (Engine.advance), from the same state, with Crr = 0."""
    jcfg, js, jp = _build_case(512, update_freq=5, poly_frac=0.2,
                               with_mesh=True, plate_z=2 * R)
    # the JAX engine would grow max_per_bin from 16 to 60 on the plate's
    # coarse bins, compiling each size: start both packages at 64
    jcfg = dataclasses.replace(jcfg, max_per_bin=64)
    jp = jp.replace(pair_props={**jp.pair_props,
                                "Crr": jnp.zeros((1, 1), jnp.float32)})
    cfg = convert.config_from_reference(jcfg)
    ts = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                  device="cpu")
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
    refresh = jax.jit(functools.partial(jax_refresh, cfg=jcfg))
    steps = jax.jit(functools.partial(jax_steps, cfg=jcfg, n_steps=5))
    j1 = refresh(js, jp)
    jend = steps(refresh(steps(j1, jp), jp), jp)
    assert int(j1.overflow) == int(jend.overflow) == 0
    return dict(jcfg=jcfg, js=js, jp=jp, j1=j1, jend=jend, cfg=cfg, ts=ts,
                tp=tp, t1=refresh_contacts(ts, tp, cfg),
                tend=Engine(cfg).advance(ts, tp, 10, 5))


def test_build_case_matches_reference(slice_runs):
    r = slice_runs
    cfg, ts, tp = build_case(512, update_freq=5, poly_frac=0.2,
                             with_mesh=True, plate_z=2 * R, device="cpu")
    jcfg, js = r["jcfg"], r["js"]
    assert (cfg.voxel_size, cfg.cap_ss, cfg.cap_st, cfg.cap_sa,
            cfg.cd_two_class) == (jcfg.voxel_size, jcfg.cap_ss, jcfg.cap_st,
                                  jcfg.cap_sa, jcfg.cd_two_class)
    for group, names in (
            ("owners", ("vox", "loc", "quat", "family", "mass", "moi")),
            ("spheres", ("owner", "relpos", "radius", "mat")),
            ("tris", ("owner", "nodes", "mat")),
            ("anals", ("owner", "objtype", "relpos", "direction"))):
        for name in names:
            ref = _np(getattr(getattr(js, group), name))
            got = _np(getattr(getattr(ts, group), name))
            assert ref.dtype == got.dtype, name
            np.testing.assert_array_equal(ref, got, err_msg=name)
    assert float(tp.cls_thr) == float(r["jp"].cls_thr) > 0
    assert ts.tris.n == 2


def test_refresh_pairs_match_jax(slice_runs):
    r = slice_runs
    for kind in ("ss", "st", "sa"):
        assert _pairs(getattr(r["t1"], kind)) == _pairs(
            getattr(r["j1"], kind)), kind
    assert int(r["t1"].st.count) > 20


def test_st_contact_pass_matches_jax(slice_runs):
    """The per-contact ST force, torque-only force and contact point that
    contact_pass("st") left in the table at the last step, by pair: the
    JAX package's XLA step keeps them too."""
    jst, tst = slice_runs["jend"].st, slice_runs["tend"].st
    for name in ("force", "torque", "cpoint"):
        ref = {p: v for p, v in zip(zip(_np(jst.idA), _np(jst.idB)),
                                    _np(getattr(jst, name))) if p[0] >= 0}
        got = {p: v for p, v in zip(zip(_np(tst.idA), _np(tst.idB)),
                                    _np(getattr(tst, name))) if p[0] >= 0}
        keys = sorted(ref)
        assert sorted(got) == keys
        assert _rel([ref[k] for k in keys], [got[k] for k in keys]) <= 2e-4
    # the plate pushes the bottom spheres up
    assert float(tst.force[:, 2].sum()) > 0


def test_slice_advance_matches_jax(slice_runs):
    r = slice_runs
    jo, to = r["jend"].owners, r["tend"].owners
    assert _rel(jo.vel, to.vel) <= 2e-4
    assert _rel(jo.omg, to.omg) <= 2e-4
    vs = r["cfg"].voxel_size
    pj = decode_host(_np(jo.vox), _np(jo.loc), vs)
    pt = decode_host(_np(to.vox), _np(to.loc), vs)
    assert np.abs(pj - pt).max() / vs <= 1e-3
    assert _pairs(r["tend"].st) == _pairs(r["jend"].st)
    assert int(r["tend"].st.count) > 20


def _solver():
    s = DEMSolver(device="cpu")
    s.SetVerbosity("QUIET")
    s.InstructBoxDomainDimension(2, 2, 2)
    mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.3,
                          "Crr": 0.0})
    return s, mat, s.LoadSphereType(0.001, 0.01, mat)


@pytest.mark.parametrize("case", ["far_facet", "sphere_on_facet"])
def test_exact_st_candidate_filter(case):
    """tests/test_sentry_and_st.py's cases: a sphere row inside a big
    slanted facet's box but ~0.35 from its plane gives no ST pair; a
    sphere resting on a facet gives one."""
    s, mat, tmpl = _solver()
    if case == "far_facet":
        n = 12
        s.AddClumps(tmpl, np.stack([np.linspace(-0.4, 0.4, n),
                                    np.full(n, 0.25), np.full(n, 0.25)], 1))
        verts = [[-0.9, -0.9, 0.9], [0.9, -0.9, 0.9], [0.0, 0.9, -0.9]]
    else:
        s.AddClumps(tmpl, np.asarray([[0.0, 0.0, 0.0095]]))
        verts = [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.5, 0.0]]
    s.AddWavefrontMeshObject(DEMMeshConnected(
        vertices=np.asarray(verts), faces=np.asarray([[0, 1, 2]])), mat)
    s.SetInitTimeStep(1e-5)
    s.SetGravitationalAcceleration([0, 0, 0])
    s.Initialize(dry_run=True)
    assert int(s.state.st.count) == (0 if case == "far_facet" else 1)
    # both facets span more than 32 bins: the span ladder ends at the
    # exact S x T matrix
    assert s.engine.cfg.st_bruteforce


def test_mesh_scene_through_the_api(tmp_path):
    """Spheres on a 2 x 2-quad OBJ plate: ST contacts with upward forces
    in the query and the mesh's tracker; UpdateMesh lowers the plate and
    the next refresh loses them."""
    obj = tmp_path / "plate.obj"
    xs = np.linspace(-0.1, 0.1, 3)
    v = np.asarray([[x, y, 0.0] for y in xs for x in xs])
    f = [[i + 3 * j, i + 1 + 3 * j, i + 4 + 3 * j, i + 3 + 3 * j]
         for j in range(2) for i in range(2)]
    obj.write_text("".join(f"v {a} {b} {c}\n" for a, b, c in v)
                   + "".join("f " + " ".join(str(k + 1) for k in q) + "\n"
                             for q in f))
    s, mat, tmpl = _solver()
    g = np.linspace(-0.06, 0.06, 4)
    s.AddClumps(tmpl, np.asarray([[x, y, 0.0099] for x in g for y in g]))
    mesh = s.AddWavefrontMeshObject(str(obj), mat)
    assert mesh.n_tri == 8
    tr = s.Track(mesh)
    s.SetInitTimeStep(1e-5)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(5)
    s.Initialize()
    s.SetFamilyMeshMaterial(mesh.family, mat)
    s.DoDynamics(1e-4)
    info = {b["kind"]: b for b in s.GetContactDetailedInfo()}
    assert len(info["ST"]["idA"]) == int(s.state.st.count) >= 16
    assert np.isfinite(info["ST"]["force"]).all()
    assert (info["ST"]["force"][:, 2] > 0).all()
    pts, fs = tr.GetContactForces()
    assert len(fs) == len(info["ST"]["idA"]) and (fs[:, 2] < 0).all()
    s.WriteMeshFile(str(tmp_path / "plate.vtk"))
    assert "POLYGONS 8 32" in (tmp_path / "plate.vtk").read_text()

    before = tr.GetMeshNodesGlobal()
    tr.UpdateMeshByIncrement(np.tile([0.0, 0.0, -0.05], (9, 1)))
    np.testing.assert_allclose(tr.GetMeshNodesGlobal() - before,
                               np.tile([0.0, 0.0, -0.05], (9, 1)),
                               atol=1e-6)
    s.DoDynamics(1e-4)
    assert int(s.state.st.count) == 0
