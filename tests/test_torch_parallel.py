"""The port's multi-device layer (``dem_engine_tpu_torch.parallel``) on the
CPU over gloo, against the JAX package's ``tests/test_spatial_refresh.py``
and ``tests/test_multichip.py``.

One module fixture starts four rank processes (``torch_mesh_worker.py``)
that run every case once and write their results; each test computes its
JAX reference (the 8-device CPU mesh of ``conftest.py``) while the ranks
run, then reads theirs. Pair sets, rows keyed by their pair and
per-owner results are compared, never row order; where the JAX tests
read XLA's compiled shapes, each rank's sizes are read instead (its
carry's lists and the collectives ``Mesh.record`` saw). World size 1
runs in this process over a ``HashStore``.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dem_engine_tpu.ops import binning as jbinning
from dem_engine_tpu.ops import voxel as jvoxel
from dem_engine_tpu.parallel.mesh import make_mesh as jax_mesh
from dem_engine_tpu.parallel.spatial import find_pairs_ss_spatial as jspatial
from dem_engine_tpu.solver import refresh_contacts as jax_refresh
from dem_engine_tpu.solver import run_steps as jax_steps
from dem_engine_tpu_torch import convert
from dem_engine_tpu_torch.parallel import gather_state, make_mesh, shard_state
from dem_engine_tpu_torch.solver import Engine
from __graft_entry__ import _build_case
from test_multichip import _setup as jax_setup32
from torch_mesh_worker import CASES, PLATE_Z, SEARCHES, move_owners, setup32

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
WAIT_S = 240  # the four ranks take ~20 s alone


class Ranks:
    """The rank processes and their results."""

    def __init__(self, out):
        self.out = str(out)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.dirname(HERE))
        self.logs = [open(os.path.join(self.out, f"log_{r}.txt"), "w")
                     for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
             str(r), str(WORLD), os.path.join(self.out, "store"), self.out],
            env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        self.deadline = time.monotonic() + WAIT_S

    def _path(self, case, r):
        return os.path.join(self.out, f"{case}_{r}.npz")

    def _fail(self, why):
        self.stop()
        text = [open(os.path.join(self.out, f)).read()
                for f in sorted(os.listdir(self.out))
                if f.endswith((".err", ".txt"))]
        pytest.fail(why + "\n" + "\n".join(text)[-6000:])

    def result(self, case):
        """Each rank's npz of `case` once all have written it, as dicts of
        arrays."""
        assert case in CASES
        while not all(os.path.exists(self._path(case, r))
                      for r in range(WORLD)):
            codes = [p.poll() for p in self.procs]
            if any(codes):
                self._fail(f"rank exit codes {codes}")
            if all(c == 0 for c in codes):
                self._fail(f"the ranks ended without {case}")
            if time.monotonic() > self.deadline:
                self._fail(f"the ranks ran past {WAIT_S} s")
            time.sleep(0.05)
        return [dict(np.load(self._path(case, r))) for r in range(WORLD)]

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started with the module, so the ranks run while this process
    computes the JAX references."""
    r = Ranks(tmp_path_factory.mktemp("mesh"))
    yield r
    r.stop()


@functools.lru_cache(maxsize=None)
def _no_mesh32():
    """The Engine without a mesh on the 32-sphere case, 40 steps
    (spatial_refresh is read only by a refresh on a mesh)."""
    cfg, state, params = setup32()
    return Engine(cfg).advance(state, params, 40, update_freq=20)


@pytest.mark.parametrize("spatial", [False, True])
def test_world_size_one_in_process(spatial):
    """make_mesh(1) makes its own one-rank group; the mesh Engine then
    gives the Engine without a mesh on the 32-sphere case."""
    ref = _no_mesh32()
    mesh = make_mesh(1, device="cpu")
    try:
        cfg, state, params = setup32()
        cfg = dataclasses.replace(cfg, spatial_refresh=spatial)
        local = Engine(cfg, mesh=mesh).advance(shard_state(state, mesh),
                                               params, 40, update_freq=20)
        got = gather_state(local, mesh)
    finally:
        mesh.close()
    for a, b in ((ref.owners.vox, got.owners.vox),
                 (ref.owners.loc, got.owners.loc),
                 (ref.owners.vel, got.owners.vel),
                 (ref.owners.omg, got.owners.omg)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert int(got.sa.count) == int(ref.sa.count) > 0


def _set(a, b):
    a, b = np.asarray(a), np.asarray(b)
    live = a >= 0
    return set(zip(a[live].tolist(), b[live].tolist()))


def _jax_sets(name):
    """JAX's global search and its 8-device spatial search of one case,
    at the JAX test's own capacities."""
    make, mask_of, capx = SEARCHES[name]
    pos, reach, owner, family, domain = (jnp.asarray(x) for x in make())
    n = pos.shape[0]
    mask = jnp.asarray(mask_of() if mask_of else np.ones((256, 256), bool))
    mpb = 64 if name == "escaped" else 32
    bs, nb = jbinning.build_grid(domain, reach.max())
    glob, spatial = _jax_searches(mpb, capx or max(128, 2 * n // 64 + 128))
    a1, b1, n1, occ1, _ = glob(pos, reach, owner, family, mask, bs, nb)
    a2, b2, n2, occ2, bovf = spatial(pos, reach, owner, family, mask, bs,
                                     nb, domain)
    assert not bool(bovf)
    return _set(a1, b1), int(occ1), _set(a2, b2)


@functools.lru_cache(maxsize=None)
def _jax_searches(mpb, capx):
    """The two JAX searches, jitted once per (max_per_bin, capx): the
    512-sphere cases share their programs."""
    return (jax.jit(partial(jbinning.find_pairs_ss, cap=16384,
                            max_per_bin=mpb)),
            jax.jit(partial(jspatial, cap=16384, max_per_bin=mpb,
                            mesh=jax_mesh(8), capx=capx)))


def _rank_sets(ranks, name):
    res = ranks.result(name)
    got = set()
    for x in res:
        live = x["idA"] >= 0
        # each rank's pairs sit at the front of its cap / D rows
        assert x["idA"].shape == (int(x["cap"]) // WORLD,)
        assert live[:live.sum()].all()
        got |= _set(x["idA"], x["idB"])
    return got, res


@pytest.mark.parametrize("name", ["global_512_0", "global_1024_3"])
def test_spatial_matches_global(ranks, name):
    ref, occ, ref8 = _jax_sets(name)
    got, res = _rank_sets(ranks, name)
    assert got == ref == ref8, (len(got), len(ref), len(got ^ ref))
    assert all(int(x["count"]) == len(got) for x in res)
    assert all(int(x["max_occ"]) == occ for x in res)
    assert not any(bool(x["bucket_ovf"]) for x in res)


def test_spatial_family_mask(ranks):
    ref, _, ref8 = _jax_sets("mask")
    got, _ = _rank_sets(ranks, "mask")
    assert got == ref == ref8
    fam = SEARCHES["mask"][0]()[3]
    assert not any({fam[a], fam[b]} == {1, 2} for a, b in got)


def test_spatial_keeps_escaped_spheres(ranks):
    ref, _, ref8 = _jax_sets("escaped")
    got, _ = _rank_sets(ranks, "escaped")
    assert (0, 1) in got and (2, 3) in got
    assert got == ref == ref8


def test_spatial_thin_slabs(ranks):
    """Slabs 2 bins wide: a middle rank receives its slab and 4 bins of
    halo, so kernel C finds more than twice as many pairs among its rows
    as it keeps. At the capacity whose cap / D rows the fullest rank's
    pairs just fill, no rank reports an overflow of either kind, and the
    pair set is JAX's."""
    ref, occ, ref8 = _jax_sets("thin")
    got, res = _rank_sets(ranks, "thin")
    assert got == ref == ref8
    for x in res:
        assert 1.9 < float(x["slab_bins"]) < 2.1
        assert int(x["count"]) == len(got) <= int(x["cap"])
        assert int(x["max_occ"]) == occ
        assert not bool(x["bucket_ovf"])


def test_bucket_overflow_grows_capx(ranks):
    """Buckets of 16 rows: the flag on every rank, the JAX growth of
    spatial_capx, and the whole pair set after the retry."""
    res = ranks.result("bucket_overflow")
    from dem_engine_tpu_torch.state import OVF_SPATIAL_BUCKET

    for x in res:
        assert int(x["first_overflow"]) & OVF_SPATIAL_BUCKET
        assert int(x["capx"]) == int(16 * 1.6) + 128
        assert int(x["grows"]) == 1
        assert int(x["count"]) == int(x["ref_count"]) > 200
        assert set(map(tuple, x["pairs"])) == set(map(tuple, x["ref"]))


@functools.lru_cache(maxsize=None)
def _jax_programs(**kw):
    """The JAX package's ``_build_case(64, update_freq=4,
    spatial_refresh=True, **kw)`` at Crr = 0, and its refresh and 4 steps
    jitted, once per configuration."""
    jcfg, js, jp = _build_case(64, update_freq=4, spatial_refresh=True,
                               **kw)
    jp = jp.replace(pair_props={**jp.pair_props,
                                "Crr": jnp.zeros((1, 1), jnp.float32)})
    return (jcfg, js, jp, jax.jit(partial(jax_refresh, cfg=jcfg)),
            jax.jit(partial(jax_steps, cfg=jcfg, n_steps=4)))


def _jax_engine_run(n_chunks, persist_all=False, **kw):
    """The JAX package's single-device run of ``_jax_programs(**kw)``:
    `n_chunks` times its refresh and 4 steps, as its Engine runs them
    when nothing overflows. The pair sets, persistent marks and owners a
    worker case is held to."""
    jcfg, js, jp, refresh, steps = _jax_programs(**kw)
    if persist_all:
        jp = jp.replace(family_persist=jnp.ones_like(jp.family_persist))
    j = js
    for _ in range(n_chunks):
        j = refresh(j, jp)
        assert int(j.overflow) == 0
        j = steps(j, jp)
    return dict(
        ss=_set(j.ss.idA, j.ss.idB), st=_set(j.st.idA, j.st.idB),
        sa=_set(j.sa.idA, j.sa.idB),
        persist=int(np.asarray(j.ss.persist).sum()),
        pos=jvoxel.decode_host(np.asarray(j.owners.vox),
                               np.asarray(j.owners.loc), jcfg.voxel_size),
        vel=np.asarray(j.owners.vel), vs=jcfg.voxel_size)


def _hold_to_jax(x, ref, pos="pos"):
    """A rank's owners and pair sets against the JAX run `ref`, at the
    slice's parity tolerances (test_torch_slice.py): positions within
    1e-3 of a voxel, velocities within 2e-4 of the largest."""
    np.testing.assert_allclose(x[pos], ref["pos"], rtol=0,
                               atol=1e-3 * ref["vs"])
    np.testing.assert_allclose(x["vel"], ref["vel"], rtol=0,
                               atol=2e-4 * np.abs(ref["vel"]).max())


@functools.lru_cache(maxsize=None)
def _jax_persistency():
    return _jax_engine_run(2, persist_all=True, use_persistency=True)


@functools.lru_cache(maxsize=None)
def _jax_production():
    # the plate's facets need a bin span of 8, where the JAX engine's
    # OVF_TRI_BINS growth lands from its default 4: one compile
    return _jax_engine_run(1, with_mesh=True, plate_grid=2, max_tri_span=8)


def test_spatial_refresh_with_persistency(ranks):
    """Every contact persistent: the mesh keeps the pairs and marks of
    one process, and of the JAX package's single-device run."""
    ref = _jax_persistency()
    for x in ranks.result("persistency"):
        pairs = set(map(tuple, x["pairs"]))
        assert pairs == set(map(tuple, x["ref"])) == ref["ss"]
        assert (int(x["persist"]) == int(x["ref_persist"]) == ref["persist"]
                == len(x["ref"]))
        np.testing.assert_allclose(x["pos"], x["ref_pos"], rtol=0,
                                   atol=1e-6)
        _hold_to_jax(x, ref)


def test_sharded_step_matches_jax(ranks):
    """``test_eight_device_mesh_matches_single`` on 4 ranks: 400 steps at
    K = 20 against the JAX package's single-device run of the same
    schedule (its refresh and 20 steps, jitted, 20 times; the capacities
    need no growth)."""
    cfg, s1, params, _ = jax_setup32()
    refresh = jax.jit(partial(jax_refresh, cfg=cfg))
    steps = jax.jit(partial(jax_steps, cfg=cfg, n_steps=20))
    for _ in range(20):
        s1 = refresh(s1, params)
        assert int(s1.overflow) == 0
        s1 = steps(s1, params)
    p1 = jvoxel.decode_host(np.asarray(s1.owners.vox),
                            np.asarray(s1.owners.loc), cfg.voxel_size)
    for x in ranks.result("step32"):
        np.testing.assert_allclose(x["pos"], p1, atol=5e-5)
        np.testing.assert_allclose(x["vel"], np.asarray(s1.owners.vel),
                                   atol=5e-3)
        assert int(x["step"]) == 400
        # the SS table is split: cap_ss / 4 rows on each rank
        assert int(x["ss_rows"]) * WORLD == int(x["cap_ss"]) == 512


@pytest.mark.parametrize("case", ["production", "production_replicated"])
def test_production_shape(ranks, case):
    """The ``dryrun_multichip`` shape with the spatial refresh: triangles
    and the ST table split, owners split unless the mesh keeps them
    whole; positions as in one process at the two-class parity
    tolerance; pair sets and owners as in the JAX package's
    single-device run."""
    ref = _jax_production()
    for x in ranks.result(case):
        assert int(x["step"]) == 4
        assert int(x["n_tris"]) == 8 and int(x["tri_rows"]) * WORLD == 8
        assert str(x["tris_place"]) == "split:0"
        assert int(x["st_rows"]) * WORLD == int(x["cap_st"])
        assert str(x["st_place"]) == "split:0"
        assert str(x["statics_place"]) == "split:1"
        assert str(x["count_place"]) == "per-shard"
        assert str(x["anals_place"]) == "replicated"
        split = case == "production"
        assert int(x["owner_rows"]) * (WORLD if split else 1) == int(
            x["n_owners"])
        assert str(x["owners_place"]) == (
            "split:0" if split else "replicated")
        assert int(x["st_count"]) == int(x["ref_st_count"])
        assert set(map(tuple, x["ss_pairs"])) == set(
            map(tuple, x["ref_ss_pairs"])) == ref["ss"]
        assert set(map(tuple, x["st_pairs"])) == ref["st"]
        np.testing.assert_allclose(x["pos"], x["ref"], rtol=0, atol=1e-6)
        _hold_to_jax(x, ref)


def test_tuners_take_rank_zeros_moves(ranks):
    """Each rank times its own blocks; the K and bin-size moves are rank
    0's on every rank, so the ranks stay in step."""
    res = ranks.result("tuners")
    assert len(res[0]["k"]) >= 5
    for x in res:
        np.testing.assert_array_equal(x["k"], res[0]["k"])
        np.testing.assert_array_equal(x["bin"], res[0]["bin"])
        np.testing.assert_array_equal(x["pos"], res[0]["pos"])
        assert int(x["step"]) == 100
        assert np.isfinite(x["pos"]).all()


def test_config_carries_the_spatial_fields():
    jcfg = dataclasses.replace(jax_setup32()[0], spatial_refresh=True,
                               spatial_capx=640)
    cfg = convert.config_from_reference(jcfg)
    assert (cfg.spatial_refresh, cfg.spatial_capx) == (True, 640)


def test_no_group_raises():
    with pytest.raises(RuntimeError, match="no torch.distributed process"):
        make_mesh(4, device="cpu")


def test_production_sa_pairs(ranks):
    """The production shape's SA pairs on four ranks, each rank's found
    by its own brute force over its home spheres: the JAX package's
    single-device set."""
    ref = _jax_production()
    for x in ranks.result("production"):
        assert set(map(tuple, x["sa_pairs"])) == ref["sa"] != set()


def _keyed(rows):
    """Rows (idA, idB, persist, wildcards...) keyed by their pair."""
    return {(int(r[0]), int(r[1])): r[2:] for r in rows}


def _jax_rows(t):
    """A JAX table's live rows: (idA, idB, persist, then each wildcard by
    name), as float64 columns (the worker's ``table_rows``)."""
    a = np.asarray(t.idA)
    live = a >= 0
    cols = [a, np.asarray(t.idB), np.asarray(t.persist)] + [
        np.asarray(t.wildcards[k]) for k in sorted(t.wildcards)]
    return np.stack([c[live].astype(np.float64) for c in cols], 1)


def _hold_rows(got, want):
    """Rows keyed by pair: the same pairs, persistency marks equal, the
    wildcards within 2e-4 of the largest of the reference's."""
    got, want = _keyed(got), _keyed(want)
    assert set(got) == set(want) != set()
    g = np.stack([got[k] for k in sorted(want)])
    w = np.stack([want[k] for k in sorted(want)])
    np.testing.assert_array_equal(g[:, 0], w[:, 0])
    np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=0,
                               atol=2e-4 * np.abs(w[:, 1:]).max())
    return w


@functools.lru_cache(maxsize=None)
def _jax_crossing():
    """The crossing case through the JAX package on one device: its
    refresh, 4 steps, ``move_owners``, its refresh again."""
    jcfg, js, jp, refresh, steps = _jax_programs(use_persistency=True)
    fp = np.zeros(jp.family_persist.shape, bool)
    fp[0, 255] = fp[255, 0] = True
    jp = jp.replace(family_persist=jnp.asarray(fp))
    j = refresh(js, jp)
    assert int(j.overflow) == 0
    j = steps(j, jp)
    j = j.replace(owners=j.owners.replace(vox=jnp.asarray(
        move_owners(np.asarray(j.owners.vox), jcfg.voxel_size))))
    j = refresh(j, jp)
    assert int(j.overflow) == 0
    return dict(ss=_jax_rows(j.ss), sa=_jax_rows(j.sa),
                lost=int(j.lost_contacts), wc=sorted(j.ss.wildcards))


@pytest.mark.parametrize("kind", ["ss", "sa"])
def test_crossing_matches_jax(ranks, kind):
    """Every sphere crosses a slab boundary between two refreshes on four
    ranks, the top layer lifts off the layer below and the bed off its
    persistent floor contacts. The pairs, each row's carried wildcards
    (within 2e-4 of the largest of each) and persistency mark, the
    re-injected floor rows and the lost count are the JAX package's
    single-device run's."""
    ref = _jax_crossing()
    for x in ranks.result("crossing"):
        assert list(x["overflow"]) == [0, 0]
        assert int(x["crossed"]) == int(x["n_spheres"])
        assert list(x["wc"]) == ref["wc"]
        w = _hold_rows(x[kind], ref[kind])
        if kind == "sa":
            # the floor rows, persistent, were re-injected: not detected
            assert (w[:, 0] == 1).all()
        else:
            assert int(x["lost"]) == ref["lost"] > 0
            assert not w[:, 0].any()


def test_uneven_slabs_shrink_without_regrowth(ranks):
    """The bed in two of four slabs, its home shards even: the first
    slab's rank keeps more pairs than cap / D before it sends each home,
    while each rank's home rows fit. Neither the refresh nor, after
    ``Engine.maybe_shrink`` cuts cap_ss, the next one takes a growth; the
    pair set is one process's."""
    res = ranks.result("uneven")
    homes = [int(x["home"]) for x in res]
    for x in res:
        cap, new = (int(c) for c in x["caps"])
        assert int(x["slabs"][0]) >= 3 * sum(map(int, x["slabs"])) // 4
        assert int(x["slab0_pairs"]) > new // WORLD >= max(homes)
        assert list(x["grows"]) == [0, 0] and int(x["shrinks"]) == 1
        assert new < cap and int(x["overflow"]) == 0
        assert _set(*x["pairs"].T) == _set(*x["ref"].T) != set()


@functools.lru_cache(maxsize=None)
def _jax_plate():
    """The plate case through the JAX package on one device (the
    production shape's programs, the plate lowered): its refresh, 4 steps
    and refresh again."""
    _, _, jp, refresh, steps = _jax_programs(with_mesh=True, plate_grid=2,
                                             max_tri_span=8)
    _, js, _ = _build_case(64, update_freq=4, spatial_refresh=True,
                           with_mesh=True, plate_grid=2, max_tri_span=8,
                           plate_z=PLATE_Z)
    j = refresh(js, jp)
    assert int(j.overflow) == 0
    j = refresh(steps(j, jp), jp)
    assert int(j.overflow) == 0
    return {k: _jax_rows(getattr(j, k)) for k in ("ss", "st", "sa")}


@pytest.mark.parametrize("kind", ["st", "ss", "sa"])
def test_plate_rows_match_jax(ranks, kind):
    """The plate on the bed's top layer on four ranks: each rank sweeps
    its two triangles and sends the pairs home (all to the last rank,
    which holds the top layer's spheres), fetching the triangles it
    finalizes from their holders. Each table's rows with their carried
    wildcards are the JAX package's single-device run's."""
    ref = _jax_plate()
    res = ranks.result("plate")
    for x in res:
        assert list(x["overflow"]) == [0, 0]
        _hold_rows(x[kind], ref[kind])
    if kind == "st":
        assert [int(x["st_rows"]) for x in res] == [0, 0, 0, len(ref["st"])]


@pytest.mark.parametrize("case", ["reshard", "reshard_odd"])
def test_sharded_tables_carry_as_one_process(ranks, case):
    """A whole state with live tables sharded, its SS table split by home
    rank and its SA table whole on every rank (its capacity does not
    divide), its spheres split or (63 clumps) whole: the mesh's next
    refresh gives the rows, carried wildcards and lost count of the same
    refresh in one process."""
    for x in ranks.result(case):
        assert bool(x["spheres_split"]) == (case == "reshard")
        assert list(x["split"]) == ["ss", "st"]
        assert list(x["after"]) == ["ss", "st", "sa"]
        assert int(x["overflow"]) == 0
        for kind in ("ss", "sa"):
            got, want = _keyed(x[kind]), _keyed(x["ref_" + kind])
            assert set(got) == set(want) != set()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        assert int(x["lost"]) == int(x["ref_lost"])


@pytest.mark.parametrize("tag", ["tri", "bed"])
def test_refresh_sizes_are_per_rank(ranks, tag):
    """``test_spatial_refresh_hlo_partitions_sweep``,
    ``test_sharded_step_partitions_big_arrays`` and the partition half of
    ``test_st_sweep_shards_over_mesh`` as the port can hold them: one
    refresh's sizes on each of four ranks. The history carry's old and
    new lists are cap / D rows (SS, ST, SA), the SA overlap matrix S / D
    x A, the triangle world nodes T / D; no collective returns cap_ss
    rows, and without triangles none returns a row for every sphere (the
    gathers are of the owner records alone)."""
    for x in ranks.result("sizes"):
        cap_ss, cap_st, cap_sa = (int(c) for c in x[tag + "_caps"])
        n_sph, n_tri, n_anal, n_own = (int(c) for c in x[tag + "_n"])
        assert int(x[tag + "_overflow"]) == 0
        caps = [cap_ss] + ([cap_st] if n_tri else []) + [cap_sa]
        assert [tuple(c) for c in x[tag + "_carry"]] == [
            (c // WORLD, c // WORLD) for c in caps]
        assert [tuple(c) for c in x[tag + "_sa"]] == [
            (n_sph // WORLD, n_anal)]
        assert [tuple(c) for c in x[tag + "_nodes"]] == (
            [(n_tri // WORLD, 3, 3)] if n_tri else [])
        rows = [int(r) for r in x[tag + "_rows"]]
        kinds = list(x[tag + "_kinds"])
        assert max(rows) < cap_ss
        gathered = {r for k, r in zip(kinds, rows) if k == "all_gather"}
        assert gathered == ({n_own, n_sph} if n_tri else {n_own})
        assert "all_to_all_v" in kinds


@pytest.mark.parametrize("tag", ["tri", "bed"])
def test_step_sizes_are_per_rank(ranks, tag):
    """``test_sharded_step_partitions_big_arrays`` as the port can hold
    it: after a mesh refresh each of four ranks holds n_owners / D owners
    and cap / D rows of each table, and a step's only collectives are the
    owner records' all-gather and the wrench's reduce-scatter onto the
    rank's owners: no collective returns a table's rows."""
    for x in ranks.result("sizes"):
        caps = [int(c) for c in x[tag + "_caps"]]
        n_own = int(x[tag + "_n"][3])
        assert [int(c) for c in x[tag + "_local"]] == [
            n_own // WORLD] + [c // WORLD for c in caps]
        assert list(zip(x[tag + "_step_kinds"],
                        (int(r) for r in x[tag + "_step_rows"]))) == [
            ("all_gather", n_own), ("reduce_scatter", n_own // WORLD)]


def test_local_shrink_matches_gather_shrink_split(ranks):
    """``Engine.maybe_shrink`` on a mesh cuts each rank's block where it
    lies; the whole table gathered, cut and split again gives the same
    tensors on every rank."""
    for x in ranks.result("shrink"):
        cap_ss, cap_sa, new_ss, new_sa = (int(c) for c in x["caps"])
        assert new_ss < cap_ss
        for k in x:
            if k.endswith(":local"):
                np.testing.assert_array_equal(
                    x[k], x[k[:-len(":local")] + ":split"], err_msg=k)
