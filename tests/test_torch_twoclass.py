"""The port's two-class polydisperse CD against the JAX package, on the
CPU, on the ratio-3 cloud of tests/test_twoclass_cd.py with a family mask
(a third of the spheres in family 1, family pair (1, 1) off).

* ``compact_member`` equal to JAX's, order included, with and without a
  large class past its capacity.
* ``build_cross_entries`` equal entry for entry; ``find_pairs_cross_fine``
  the same pair list and count.
* The whole two-class search (``solver.two_class_pairs``: kernel C's
  plain version on both member tables, the cross search between) gives
  the pair set of JAX's two-class composition and of the port's own
  single-grid search, with and without small spheres whose reach exceeds
  the large class's.
* ``DEMSolver`` switches the two-class CD on by its radius rule, and a
  small ratio-3 pile gives the same contacts and positions with it on and
  forced off.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_twoclass_cd import _cloud

from dem_engine_tpu.ops import binning as jb
from dem_engine_tpu_torch import DEMSolver
from dem_engine_tpu_torch.ops import binning as tb
from dem_engine_tpu_torch.ops import sweep
from dem_engine_tpu_torch.solver import two_class_pairs
from dem_engine_tpu_torch.state import SolverConfig

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

DOMAIN = np.asarray([1.0, 1.0, 0.3], np.float32)
THR = float(np.sqrt(0.01 * 0.03))
CAP = 65536


def _pairs(idA, idB):
    a, b = np.asarray(idA), np.asarray(idB)
    live = a >= 0
    return set(zip(a[live].tolist(), b[live].tolist()))


@pytest.fixture(scope="module")
def cloud():
    """The cloud as numpy (pos, reach, radius, owner, family, mask)."""
    pos, reach, radius, owner, _ = (np.asarray(x) for x in _cloud(seed=5))
    family = np.where(np.arange(len(pos)) % 3 == 0, 1, 0).astype(np.int32)
    mask = np.ones((256, 256), bool)
    mask[1, 1] = False
    return pos, reach, radius, owner, family, mask


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@functools.partial(jax.jit, static_argnums=(6,))
def _jax_two_class(pos, reach, radius, owner, family, mask, lcap):
    """JAX's two-class composition on its XLA path, as
    tests/test_twoclass_cd.py builds it, with its intermediate results:
    the compacted large class, its entries, the small-large pairs alone
    and the whole pair list."""
    small = radius <= THR
    large = ~small
    reach_s = jnp.max(jnp.where(small, reach, 0.0))
    reach_l = jnp.max(jnp.where(large, reach, 0.0))
    domain = jnp.asarray(DOMAIN)
    bs_l, nb_l = jb.build_grid(domain,
                               jnp.maximum(reach_l, 0.5 * (reach_s + reach_l)))
    comp = jb.compact_member(large, lcap, pos, reach, owner, family)
    (pos_c, reach_c, own_c, fam_c), orig_l, live_l = comp[0], comp[1], comp[2]
    reach_c = jnp.where(live_l, reach_c, -1e30)
    own_c = jnp.where(live_l, own_c, -1)
    fam_c = jnp.where(live_l, fam_c, 0)
    idA, idB, n_ll, _, _ = jb.find_pairs_ss(
        pos_c, reach_c, own_c, fam_c, mask, bs_l, nb_l, CAP, 64,
        member=live_l)
    idA = jnp.where(idA >= 0, orig_l[jnp.maximum(idA, 0)], -1)
    idB = jnp.where(idB >= 0, orig_l[jnp.maximum(idB, 0)], -1)
    rec_l = jnp.concatenate(
        [pos_c, reach_c[:, None], own_c.astype(jnp.float32)[:, None],
         fam_c.astype(jnp.float32)[:, None],
         jnp.minimum(orig_l, pos.shape[0]).astype(jnp.float32)[:, None]],
        axis=1)
    ent = jb.build_cross_entries(pos_c, jnp.maximum(reach_c + reach_s, 0.0),
                                 live_l, bs_l, nb_l)
    args = (pos, reach, owner, family, small, rec_l, ent[0], ent[1], mask,
            bs_l, nb_l, CAP, 64)
    cross = jb.find_pairs_cross_fine(*args)
    idA, idB, n_xl = jb.find_pairs_cross_fine(
        *args, base=jnp.minimum(n_ll, CAP), outs=(idA, idB))
    bs_s, nb_s = jb.build_grid(domain, reach_s)
    pairs = jb.find_pairs_ss(pos, reach, owner, family, mask, bs_s, nb_s,
                             CAP, 64, member=small,
                             base=jnp.minimum(n_xl, CAP), outs=(idA, idB))
    return dict(comp=comp, entries=ent, cross=cross, pairs=pairs[:3])


@pytest.fixture(scope="module")
def jax_runs(cloud):
    """_jax_two_class on the cloud, and on the cloud with small spheres
    whose reach exceeds the large class's; lcap 256 (fits)."""
    pos, reach, radius, owner, family, mask = cloud
    big = np.where(radius <= 0.02, radius + 0.05, reach).astype(np.float32)
    return {case: _jax_two_class(pos, r, radius, owner, family, mask, 256)
            for case, r in (("cloud", reach),
                            ("small_reach_above_large", big))}


def _port_head(cloud, lcap):
    """The port's compacted large class of the cloud and its grid."""
    pos, reach, radius, owner, family, _ = cloud
    large = radius > THR
    reach_s = float(reach[~large].max())
    cell = np.float32(max(reach[large].max(),
                          0.5 * (reach_s + reach[large].max())))
    comp = tb.compact_member(*_t(large), lcap,
                             *_t(pos, reach, owner, family))
    grid = tb.build_grid(torch.from_numpy(DOMAIN), torch.tensor(cell))
    return comp, grid, reach_s


@pytest.mark.parametrize("lcap", [256, 64], ids=["fits", "past_lcap"])
def test_compact_member_matches_jax(cloud, jax_runs, lcap):
    pos, reach, radius, owner, family, _ = cloud
    if lcap == 256:
        jcomp = jax_runs["cloud"]["comp"]
    else:
        jcomp = jb.compact_member(jnp.asarray(radius > THR), lcap,
                                  *(jnp.asarray(x)
                                    for x in (pos, reach, owner, family)))
    (jouts, jorig, jlive, jn, jovf) = jcomp
    (touts, torig, tlive, tn, tovf) = _port_head(cloud, lcap)[0]
    for j, t in zip(jouts, touts):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(np.asarray(jorig), torig.numpy())
    np.testing.assert_array_equal(np.asarray(jlive), tlive.numpy())
    assert int(jn) == int(tn) and bool(jovf) == bool(tovf) == (lcap == 64)


def test_cross_search_matches_jax(cloud, jax_runs):
    """The large class's entries, then the small-large pairs alone."""
    pos, reach, radius, owner, family, mask = cloud
    (tp, tr, to, tf), torig, tlive = _port_head(cloud, 256)[0][:3]
    (tbs, tnb), reach_s = _port_head(cloud, 256)[1:]
    tr = torch.where(tlive, tr, -1e30)
    te = tb.build_cross_entries(tp, torch.clamp(tr + reach_s, min=0.0),
                                tlive, tbs, tnb)
    jr = jax_runs["cloud"]
    for j, t in zip(jr["entries"], te):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert 1 < int(te[2]) <= 64
    S = len(pos)
    trec = torch.cat(
        [tp, tr[:, None], torch.where(tlive, to, -1).float()[:, None],
         tf.float()[:, None], torch.clamp(torig, max=S).float()[:, None]],
        dim=1)
    ta, tbb, tn = tb.find_pairs_cross_fine(
        *_t(pos, reach, owner, family, radius <= THR), trec, te[0], te[1],
        torch.from_numpy(mask), tbs, tnb, CAP, 64)
    ja, jbb, jn = jr["cross"]
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jbb), tbb.numpy())
    assert int(jn) == int(tn) > 50


@pytest.mark.parametrize("reach_case", ["cloud", "small_reach_above_large"])
def test_two_class_search_matches(cloud, jax_runs, reach_case):
    """Pair sets of the port's two-class search, JAX's two-class
    composition and the port's single-grid search."""
    pos, reach, radius, owner, family, mask = cloud
    if reach_case != "cloud":
        reach = np.where(radius <= 0.02, radius + 0.05, reach).astype(
            np.float32)
    ja, jbb, jn = jax_runs[reach_case]["pairs"]

    tpos, treach, towner, tfam = _t(pos, reach, owner, family)
    tmask = torch.from_numpy(mask)
    q = dict(pos_cd=tpos, reach=treach, owner=towner, family=tfam,
             family_mask=tmask, dom_cd=torch.from_numpy(DOMAIN))
    cfg = SolverConfig(voxel_size=1e-6, integrator=None, force_model=None,
                       cap_ss=CAP, cd_two_class=True, cross_mpb=64)
    params = type("P", (), {"bin_factor": torch.tensor(1.0)})
    ta, tbb, tn, _, ovf = two_class_pairs(
        q, torch.from_numpy(radius <= THR), params, cfg, len(pos))
    bs, nb = tb.build_grid(q["dom_cd"], treach.max())
    sa, sb, sn, _ = sweep.find_pairs_ss(tpos, treach, towner, tfam, tmask,
                                        bs, nb, CAP)
    got = _pairs(ta, tbb)
    assert int(ovf) == 0
    assert got == _pairs(ja, jbb) == _pairs(sa, sb)
    assert int(tn) == int(jn) == int(sn) == len(got) > 100
    fam = family.tolist()
    assert not any(fam[a] == fam[b] == 1 for a, b in got)


def _pile(two_class):
    """A ratio-3 pile through the port's DEMSolver: a layer of 8 x 8
    small spheres on a floor, 3 x 3 large ones resting on it; the
    two-class CD left to the radius rule or forced off."""
    r, rl = 0.008, 0.024
    s = DEMSolver(device="cpu")
    s.SetVerbosity("QUIET")
    s.InstructBoxDomainDimension(0.4, 0.4, 0.3)
    mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.4, "mu": 0.4,
                          "Crr": 0.0})
    if not two_class:
        s.SetCDTwoClassGrids(False)
    small = s.LoadSphereType(r**3 * 2.6e3, r, mat)
    large = s.LoadSphereType(rl**3 * 2.6e3, rl, mat)
    floor = -0.1
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2)
    jit = np.random.default_rng(0).uniform(-0.01, 0.01, (64, 2)) * r
    s.AddClumps(small, np.c_[(g - 3.5 + jit) * 1.999 * r,
                             np.full(64, floor + r)])
    gl = np.stack(np.meshgrid(np.arange(3), np.arange(3)), -1).reshape(-1, 2)
    s.AddClumps(large, np.c_[(gl - 1) * 2.05 * rl,
                             np.full(9, floor + 2 * r + rl)])
    s.AddBCPlane([0, 0, floor], [0, 0, 1], mat)
    s.SetInitTimeStep(5e-6)
    s.SetGravitationalAcceleration([0, 0, -9.81])
    s.SetCDUpdateFreq(10)
    s.Initialize()
    s.DoDynamics(1e-3)
    return s


def test_solver_radius_rule_and_single_grid_agree():
    a, b = _pile(True), _pile(False)
    assert a.engine.cfg.cd_two_class and not b.engine.cfg.cd_two_class
    assert float(a.params.cls_thr) == pytest.approx(np.sqrt(0.008 * 0.024))
    assert a.GetNumContacts() == b.GetNumContacts() > 150
    assert _pairs(a.state.ss.idA, a.state.ss.idB) == _pairs(
        b.state.ss.idA, b.state.ss.idB)
    np.testing.assert_allclose(a.GetOwnerPosition(), b.GetOwnerPosition(),
                               rtol=0, atol=1e-6)
