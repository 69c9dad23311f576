"""One rank of the port's multi-device CPU checks (not a test module; it
imports no JAX). ``tests/test_torch_parallel.py`` starts WORLD of these
at once:

    python tests/torch_mesh_worker.py RANK WORLD STORE OUT

Each joins a gloo group of WORLD ranks over the ``FileStore`` STORE, runs
every case of ``CASES`` in order (each a few collectives; every rank runs
the same ones) and writes ``OUT/<case>_<rank>.npz``, then
``OUT/done_<rank>``. A case that raises writes its traceback to
``OUT/<case>_<rank>.err`` and ends the rank: the others then fail at
their next collective's timeout.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from dem_engine_tpu_torch import cases  # noqa: E402
from dem_engine_tpu_torch.defines import ANAL_PLANE, TimeIntegrator  # noqa
from dem_engine_tpu_torch.initializer import (  # noqa: E402
    concat_owners, make_analyticals, make_owners, make_params, make_spheres,
    make_state)
from dem_engine_tpu_torch.models import HertzianForceModel  # noqa: E402
from dem_engine_tpu_torch.ops import binning, voxel  # noqa: E402
from dem_engine_tpu_torch import solver  # noqa: E402
from dem_engine_tpu_torch.ops import history, narrowphase  # noqa: E402
from dem_engine_tpu_torch.parallel import (  # noqa: E402
    find_pairs_ss_spatial, gather_state, make_mesh, shard_state,
    state_shardings)
from dem_engine_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from dem_engine_tpu_torch.solver import (Engine, refresh_contacts,  # noqa
                                         run_steps, spatial_capx_auto)
from dem_engine_tpu_torch.state import (SolverConfig,  # noqa: E402
                                        state_tensors)

CAP = 16384
R = 0.01
RHO = 2500.0


def random_spheres(n, seed=0, box=(0.8, 0.3, 0.3), r=0.012):
    """``tests/test_spatial_refresh.py``'s ``_random_spheres`` in numpy:
    (pos, reach, owner, family, domain)."""
    rng = np.random.default_rng(seed)
    lo = 0.03
    pos = np.stack([rng.uniform(lo, box[i] - lo, n) for i in range(3)],
                   axis=1).astype(np.float32)
    reach = (np.full(n, r) * rng.uniform(0.8, 1.2, n)).astype(np.float32)
    owner = np.arange(n, dtype=np.int32)
    family = rng.integers(0, 3, n).astype(np.int32)
    return pos, reach, owner, family, np.asarray(box, np.float32)


def escaped_spheres():
    """``test_spatial_keeps_escaped_spheres``'s input: 256 spheres, two
    pairs parked beyond the x faces of the domain."""
    pos, reach, owner, family, domain = random_spheres(256, seed=7)
    pos = pos.copy()
    pos[0] = [-0.3, 0.1, 0.1]
    pos[1] = [-0.3, 0.1, 0.1 + 0.018]
    pos[2] = [float(domain[0]) + 0.25, 0.2, 0.2]
    pos[3] = [float(domain[0]) + 0.25, 0.2, 0.2 + 0.018]
    return pos, reach, owner, family, domain


def masked_family():
    mask = np.ones((256, 256), bool)
    mask[1, 2] = mask[2, 1] = False
    return mask


#: the spatial-search cases: (inputs, family mask, capx or None for auto)
SEARCHES = {
    "global_512_0": (lambda: random_spheres(512, 0), None, None),
    "global_1024_3": (lambda: random_spheres(1024, 3), None, None),
    "mask": (lambda: random_spheres(512, 5), masked_family, None),
    "escaped": (escaped_spheres, None, 512),
    # slabs 2.0 bins wide: a middle rank receives its slab and 4 bins of
    # halo, 85% of the spheres and of the pairs
    "thin": (lambda: random_spheres(1024, 11, box=(0.233, 0.3, 0.3)), None,
             None),
}


def setup32(cap_ss=512, cap_sa=512, device="cpu"):
    """``tests/test_multichip.py``'s ``_setup`` through the port: 32
    spheres in a 4 x 4 x 2 block over a floor plane."""
    cfg = SolverConfig(
        voxel_size=1.0 / 2**16,
        integrator=TimeIntegrator.CENTERED_DIFFERENCE,
        force_model=HertzianForceModel(),
        cap_ss=cap_ss, cap_st=8, cap_sa=cap_sa)
    mass = RHO * 4 / 3 * np.pi * R**3
    moi = 2 / 5 * mass * R**2
    xs = 0.5 + (np.arange(4) - 1.5) * 2.1 * R
    zs = 0.2 + R + np.arange(2) * 2.1 * R
    g = np.stack(np.meshgrid(xs, xs, zs, indexing="ij"), -1).reshape(-1, 3)
    n = g.shape[0]
    owners = concat_owners(
        make_owners(pos=g, voxel_size=cfg.voxel_size, mass=np.full(n, mass),
                    moi=np.full((n, 3), moi), device=device),
        make_owners(pos=np.asarray([[0.5, 0.5, 0.2]]),
                    voxel_size=cfg.voxel_size, family=[255], mass=[1e30],
                    moi=np.full((1, 3), 1e30), device=device))
    spheres = make_spheres(owner=np.arange(n), relpos=np.zeros((n, 3)),
                           radius=np.full(n, R), device=device)
    anals = make_analyticals(
        owner=[n], objtype=[ANAL_PLANE], relpos=np.zeros((1, 3)),
        direction=[[0, 0, 1.0]], size=np.zeros((1, 3)), normal_sign=[1.0],
        device=device)
    state = make_state(owners, spheres, cfg, anals=anals)
    params = make_params(
        h=5e-6, gravity=[0, 0, -9.81], domain=[1, 1, 1],
        materials={"E": np.asarray([1e8], np.float32),
                   "nu": np.asarray([0.3], np.float32)},
        pair_materials={"CoR": np.asarray([[0.4]], np.float32),
                        "mu": np.asarray([[0.4]], np.float32),
                        "Crr": np.asarray([[0.0]], np.float32)},
        update_freq=20, device=device)
    return cfg, state, params


def no_rolling(params):
    """`params` with Crr = 0: the bed's cases are also held to the JAX
    package, and rolling resistance makes such a comparison
    ill-conditioned (``test_torch_slice.py``)."""
    return params.replace(pair_props={**params.pair_props,
                                      "Crr": torch.zeros((1, 1))})


def positions(state, cfg):
    return voxel.decode_host(state.owners.vox.numpy(),
                             state.owners.loc.numpy(), cfg.voxel_size)


def pairs(table):
    a, b = table.idA.numpy(), table.idB.numpy()
    return np.stack([a[a >= 0], b[a >= 0]], 1)


def search(mesh, name, tight=False):
    """One spatial search of SEARCHES[name] at capacity CAP; with `tight`
    a second one at the capacity whose cap / D rows the fullest rank's
    pairs just fill (the first search's largest count on a rank)."""
    make, mask_of, capx = SEARCHES[name]
    pos, reach, owner, family, domain = make()
    mask = torch.from_numpy(mask_of() if mask_of else
                            np.ones((256, 256), bool))
    n = len(pos)
    t = [torch.from_numpy(x) for x in (pos, reach, owner, family, domain)]
    bs, nb = binning.build_grid(t[4], t[1].max())
    s = n // mesh.size
    rows = slice(mesh.rank * s, (mesh.rank + 1) * s)

    def run(cap):
        return find_pairs_ss_spatial(
            t[0][rows], t[1][rows], t[2][rows], t[3][rows], mask, bs, nb,
            t[4], cap, mesh, capx or spatial_capx_auto(n, mesh.size))

    cap = CAP
    a, b, count, occ, bovf = run(cap)
    if tight:
        cap = mesh.size * int(mesh.all_max((a >= 0).sum()))
        a, b, count, occ, bovf = run(cap)
    return dict(idA=a.numpy(), idB=b.numpy(), count=int(count),
                max_occ=int(occ), bucket_ovf=bool(bovf), cap=cap,
                slab_bins=float(t[4][0] / mesh.size / bs))


def bucket_overflow(mesh):
    """The production bed with buckets of 16 rows: the first refresh
    flags OVF_SPATIAL_BUCKET on every rank and the engine grows capx."""
    cfg, state, params = cases.build_case(64, update_freq=4, device="cpu")
    cfg = dataclasses.replace(cfg, spatial_refresh=True, spatial_capx=16)
    whole_ref = refresh_contacts(state, params, cfg)
    direct = refresh_contacts(shard_state(state, mesh), params, cfg,
                              mesh=mesh)
    eng = Engine(cfg, mesh=mesh)
    out = gather_state(eng.refresh(shard_state(state, mesh), params), mesh)
    return dict(first_overflow=int(direct.overflow),
                capx=eng.cfg.spatial_capx, grows=eng.timers["grows"],
                pairs=pairs(out.ss), ref=pairs(whole_ref.ss),
                count=int(out.ss.count), ref_count=int(whole_ref.ss.count))


def persistency(mesh):
    """The production bed with every contact persistent and the spatial
    refresh on, Crr = 0: two chunks of 4 on the mesh and in one process
    (the spatial lists are compacted to the front before the carry)."""
    def case():
        cfg, state, params = cases.build_case(64, update_freq=4,
                                              device="cpu")
        cfg = dataclasses.replace(cfg, spatial_refresh=True,
                                  use_persistency=True)
        return cfg, state, no_rolling(params.replace(
            family_persist=torch.ones_like(params.family_persist)))

    cfg, state, params = case()
    out = gather_state(Engine(cfg, mesh=mesh).advance(
        shard_state(state, mesh), params, 8, update_freq=4), mesh)
    cfg1, state1, params1 = case()
    one = Engine(cfg1).advance(state1, params1, 8, update_freq=4)
    return dict(pairs=pairs(out.ss), ref=pairs(one.ss),
                persist=int(out.ss.persist.sum()),
                ref_persist=int(one.ss.persist.sum()),
                pos=positions(out, cfg), ref_pos=positions(one, cfg1),
                vel=out.owners.vel.numpy())


def step32(mesh):
    cfg, state, params = setup32()
    eng = Engine(cfg, mesh=mesh)
    local = eng.advance(shard_state(state, mesh), params, 400,
                        update_freq=20)
    out = gather_state(local, mesh)
    return dict(pos=positions(out, cfg), vel=out.owners.vel.numpy(),
                ss_rows=local.ss.cap, owner_rows=local.owners.n,
                cap_ss=eng.cfg.cap_ss, step=int(out.step))


def production(mesh):
    """``__graft_entry__.dryrun_multichip``'s shape: 16 D clumps with the
    2 x 2 plate, the spatial refresh on, Crr = 0, one chunk of 4 steps;
    and the same case in one process. Its 72 owners split over the ranks (with
    the mesh's `shard_owners`)."""
    def case():
        cfg, state, params = cases.build_case(
            16 * mesh.size, update_freq=4, with_mesh=True, plate_grid=2,
            device="cpu")
        return (dataclasses.replace(cfg, spatial_refresh=True), state,
                no_rolling(params))

    cfg, state, params = case()
    local = shard_state(state, mesh)
    places = state_shardings(local, mesh)
    eng = Engine(cfg, mesh=mesh)
    local = eng.advance(local, params, 4, update_freq=4)
    out = gather_state(local, mesh)
    cfg1, state1, params1 = case()
    one = Engine(cfg1).advance(state1, params1, 4, update_freq=4)
    return dict(pos=positions(out, cfg), ref=positions(one, cfg1),
                vel=out.owners.vel.numpy(), ref_vel=one.owners.vel.numpy(),
                n_tris=state.tris.n, tri_rows=local.tris.n,
                n_owners=state.owners.n, owner_rows=local.owners.n,
                st_rows=local.st.cap, cap_st=eng.cfg.cap_st,
                st_count=int(out.st.count), ref_st_count=int(one.st.count),
                ss_pairs=pairs(out.ss), ref_ss_pairs=pairs(one.ss),
                st_pairs=pairs(out.st), sa_pairs=pairs(out.sa),
                tris_place=places["tris.nodes"],
                owners_place=places["owners.vel"],
                st_place=places["st.idA"], statics_place=places["st.statics"],
                count_place=places["st.count"],
                anals_place=places["anals.size"], step=int(out.step))


def table_rows(table):
    """A table's live rows: (idA, idB, persist, then each wildcard by
    name), as float64 columns."""
    live = table.idA >= 0
    cols = [table.idA, table.idB, table.persist] + [
        table.wildcards[k] for k in sorted(table.wildcards)]
    return np.stack([c[live].double().numpy() for c in cols], 1)


def move_owners(vox, voxel_size, n_clumps=64):
    """The crossing case's move between its refreshes, in voxels: every
    owner 8 R toward x = 0 (on four ranks each sphere crosses a slab
    boundary), every clump 3 R up (off the floor) and the top layer of
    clumps 4 R more (off the layer below)."""
    r = cases.R
    vox = vox.copy()
    z = cases.bed_geometry(n_clumps)["pos"][:, 2]
    vox[:, 0] -= int(round(8 * r / voxel_size))
    vox[:n_clumps, 2] += int(round(3 * r / voxel_size))
    vox[:n_clumps][z == z.max(), 2] += int(round(4 * r / voxel_size))
    return vox


def persist_floor(params):
    """`params` with the contacts between the clumps (family 0) and the
    floor (255) persistent, and no others."""
    fp = torch.zeros_like(params.family_persist)
    fp[0, 255] = fp[255, 0] = 1
    return params.replace(family_persist=fp)


def crossing(mesh):
    """The bed (spatial refresh, the clump-floor contacts persistent, Crr
    = 0): a refresh and 4 steps, ``move_owners``, a second refresh. Every
    sphere changes slab, so each re-detected pair is found on one rank
    and sent to its home on another; the top layer's contacts below are
    lost and the floor's are re-injected. The tables after the second
    refresh, with their wildcards, and the lost count."""
    cfg, state, params = cases.build_case(64, update_freq=4, device="cpu")
    cfg = dataclasses.replace(cfg, spatial_refresh=True,
                              use_persistency=True)
    params = persist_floor(no_rolling(params))
    local = refresh_contacts(shard_state(state, mesh), params, cfg,
                             mesh=mesh)
    first = int(local.overflow)
    local = run_steps(local, params, cfg, 4, mesh=mesh)
    before = gather_state(local, mesh)
    moved = move_owners(before.owners.vox.numpy(), cfg.voxel_size)
    lo, hi = pmesh.home_range(before.owners.n, mesh.size, mesh.rank)
    local = local.replace(owners=local.owners.replace(vox=torch.from_numpy(
        moved[lo:hi] if local.layout.owners else moved)))
    out = refresh_contacts(local, params, cfg, mesh=mesh)
    got = gather_state(out, mesh)
    slab = float(params.domain[0]) / mesh.size
    x0 = solver.sphere_world_pos(before.owners, before.spheres,
                                 cfg.voxel_size)[:, 0]
    x1 = solver.sphere_world_pos(got.owners, got.spheres,
                                 cfg.voxel_size)[:, 0]
    return dict(overflow=[first, int(out.overflow)], ss=table_rows(got.ss),
                sa=table_rows(got.sa), lost=int(out.lost_contacts),
                crossed=int(((x0 // slab) != (x1 // slab)).sum()),
                n_spheres=state.spheres.n, wc=sorted(got.ss.wildcards))


def uneven(mesh):
    """The bed moved as in ``crossing`` (its spheres in two of the four
    slabs, its home shards as even as before) through Engine(cfg, mesh):
    a refresh, ``Engine.maybe_shrink`` and a refresh at the shrunk
    capacity, whose first slab keeps more than cap / D pairs. The spheres
    a slab, the pairs within the first slab (which its rank keeps), the
    rank's home rows, the capacities and growths, and the last refresh's
    pairs against one process's refresh of the same state."""
    cfg, state, params = cases.build_case(64, update_freq=4, device="cpu")
    cfg = dataclasses.replace(cfg, spatial_refresh=True)
    params = no_rolling(params)
    state = state.replace(owners=state.owners.replace(vox=torch.from_numpy(
        move_owners(state.owners.vox.numpy(), cfg.voxel_size))))
    eng = Engine(cfg, mesh=mesh)
    local = eng.refresh(shard_state(state, mesh), params)
    grows = eng.timers["grows"]
    cap = eng.cfg.cap_ss
    out = eng.refresh(eng.maybe_shrink(local), params)
    ref = refresh_contacts(state, params, eng.cfg)
    x = solver.sphere_world_pos(state.owners, state.spheres,
                                cfg.voxel_size)[:, 0]
    slab = (x // (float(params.domain[0]) / mesh.size)).long()
    live = ref.ss.idA >= 0
    first = slab[ref.ss.idA[live].long()] + slab[ref.ss.idB[live].long()]
    return dict(slabs=torch.bincount(slab.clamp(0, mesh.size - 1),
                                     minlength=mesh.size).numpy(),
                slab0_pairs=int((first == 0).sum()), home=int(out.ss.count), caps=[cap, eng.cfg.cap_ss],
                grows=[grows, eng.timers["grows"]],
                shrinks=eng.timers["shrinks"],
                overflow=int(out.overflow), pairs=pairs(gather_state(
                    out, mesh).ss), ref=pairs(ref.ss))


#: the plate of the production shape lowered onto the bed: the top
#: layer's top spheres 0.02 R into it (as in test_st_sweep_shards_over_mesh)
PLATE_Z = cases.R * (3 * 3.99 + 2 + 1.995 + 1.98)


def plate(mesh):
    """The production shape (8 triangles, 2 a rank) with its plate on the
    top layer, spatial refresh on, Crr = 0: a refresh, 4 steps and a
    refresh. Each rank sweeps its own triangles and sends the pairs to
    the home of their spheres, all on the last rank. The tables' rows
    with their wildcards, and the ST rows each rank holds."""
    cfg, state, params = cases.build_case(
        64, update_freq=4, with_mesh=True, plate_grid=2, plate_z=PLATE_Z,
        device="cpu")
    cfg = dataclasses.replace(cfg, spatial_refresh=True, max_tri_span=8)
    params = no_rolling(params)
    local = refresh_contacts(shard_state(state, mesh), params, cfg,
                             mesh=mesh)
    first = int(local.overflow)
    local = run_steps(local, params, cfg, 4, mesh=mesh)
    out = refresh_contacts(local, params, cfg, mesh=mesh)
    got = gather_state(out, mesh)
    return dict(overflow=[first, int(out.overflow)], ss=table_rows(got.ss),
                st=table_rows(got.st), sa=table_rows(got.sa),
                st_rows=int(out.st.count), lost=int(out.lost_contacts))


def reshard(mesh, n_clumps=64):
    """The bed refreshed and stepped 4 times in one process, then sharded:
    its SS table splits by home rank, its SA table (258 rows, which do
    not divide by four) stays whole on every rank. The mesh's next
    refresh (SA at 260 rows) against the process's own next refresh: the
    tables' rows with their wildcards and the lost count. With 63 clumps
    the 189 spheres do not divide either: every rank holds them all and
    runs the search over every sphere, keeping its home pairs."""
    cfg, state, params = cases.build_case(n_clumps, update_freq=4,
                                          device="cpu")
    cfg = dataclasses.replace(cfg, spatial_refresh=True, cap_sa=258)
    params = no_rolling(params)
    one = run_steps(refresh_contacts(state, params, cfg), params, cfg, 4)
    ref = refresh_contacts(one, params, cfg)
    local = shard_state(one, mesh)
    split = local.layout.tables
    out = refresh_contacts(local, params,
                           dataclasses.replace(cfg, cap_sa=260), mesh=mesh)
    got = gather_state(out, mesh)
    return dict(split=list(split), after=list(out.layout.tables),
                spheres_split=local.layout.spheres,
                overflow=int(out.overflow), ss=table_rows(got.ss),
                ref_ss=table_rows(ref.ss), sa=table_rows(got.sa),
                ref_sa=table_rows(ref.sa), lost=int(out.lost_contacts),
                ref_lost=int(ref.lost_contacts))


def sizes(mesh):
    """One refresh of the production shape (its 8 triangles) and of the
    bed without triangles, spatial refresh on, with each rank's sizes
    recorded: the history carry's old and new lengths (SS, ST, SA in
    turn), the SA overlap matrix, the triangle world nodes, and what
    each collective returned (``Mesh.record``); then one step's
    collectives and the rank's owner and table rows."""
    out = {}
    for tag, kw in (("tri", dict(with_mesh=True, plate_grid=2)),
                    ("bed", {})):
        cfg, state, params = cases.build_case(16 * mesh.size, update_freq=4,
                                              device="cpu", **kw)
        cfg = dataclasses.replace(cfg, spatial_refresh=True, max_tri_span=8)
        local = shard_state(state, mesh)
        seen = {"carry": [], "sa": [], "nodes": []}
        saved = (history.carry_history, narrowphase.sphere_analytical,
                 solver.tri_world_nodes)

        def carry(old, a, *args, **kw):
            seen["carry"].append((old.idA.shape[0], a.shape[0]))
            return saved[0](old, a, *args, **kw)

        def sa(*args, **kw):
            res = saved[1](*args, **kw)
            seen["sa"].append(tuple(res[0].shape))
            return res

        def nodes(*args, **kw):
            res = saved[2](*args, **kw)
            seen["nodes"].append(tuple(res.shape))
            return res

        history.carry_history, narrowphase.sphere_analytical = carry, sa
        solver.tri_world_nodes = nodes
        mesh.record = []
        try:
            res = refresh_contacts(local, params, cfg, mesh=mesh)
        finally:
            (history.carry_history, narrowphase.sphere_analytical,
             solver.tri_world_nodes) = saved
            calls, mesh.record = mesh.record, None
        # and one step from there
        mesh.record = []
        run_steps(res, params, cfg, 1, mesh=mesh)
        steps, mesh.record = mesh.record, None
        out.update({f"{tag}_{k}": np.asarray(v) for k, v in seen.items()})
        out.update({
            f"{tag}_step_kinds": [c[0] for c in steps],
            f"{tag}_step_rows": [c[1] for c in steps],
            f"{tag}_local": [res.owners.n, res.ss.cap, res.st.cap,
                             res.sa.cap]})
        out.update({
            f"{tag}_kinds": [c[0] for c in calls],
            f"{tag}_rows": [c[1] for c in calls],
            f"{tag}_caps": [cfg.cap_ss, cfg.cap_st, cfg.cap_sa],
            f"{tag}_n": [state.spheres.n, state.tris.n, state.anals.n,
                         state.owners.n],
            f"{tag}_counts": [int(res.ss.count), int(res.st.count),
                              int(res.sa.count)],
            f"{tag}_overflow": int(res.overflow)})
    return out


def shrink(mesh):
    """The bed after a mesh refresh, ``Engine.maybe_shrink`` (each rank
    cuts its block where it lies) against the whole table gathered, cut
    and split again; every tensor of both, and the capacities."""
    cfg, state, params = cases.build_case(64, update_freq=4, device="cpu")
    eng = Engine(dataclasses.replace(cfg, spatial_refresh=True), mesh=mesh)
    local = eng.refresh(shard_state(state, mesh), params)
    cut = eng.maybe_shrink(local)
    lay = local.layout
    out = dict(caps=[cfg.cap_ss, cfg.cap_sa, eng.cfg.cap_ss, eng.cfg.cap_sa])
    for kind, cap in (("ss", eng.cfg.cap_ss), ("sa", eng.cfg.cap_sa)):
        ref = pmesh.shard_table(
            pmesh.gather_table(getattr(local, kind), mesh,
                               lay.n_owners).shrunk(cap),
            mesh, lay.n_owners, lay.n_spheres)
        for (p, x), (_, y) in zip(state_tensors(getattr(cut, kind), kind),
                                  state_tensors(ref, kind)):
            out[p + ":local"], out[p + ":split"] = x.numpy(), y.numpy()
    return out


def tuners(mesh):
    """Both tuners on (blocks of one chunk, K 5, max_freq 18) for 100
    steps: each rank times its own blocks, and every rank must run rank
    0's moves."""
    cfg, state, params = cases.build_case(64, update_freq=5, device="cpu")
    eng = Engine(cfg, mesh=mesh, fuse=1)
    eng.auto_freq, eng.auto_bin, eng.max_freq = True, True, 18
    out = gather_state(eng.advance(shard_state(state, mesh), params, 100,
                                   update_freq=5), mesh)
    return dict(k=[b["k"] for b in eng.blocks],
                bin=[b["bin_factor"] for b in eng.blocks],
                step=int(out.step), pos=positions(out, cfg))


CASES = {**{k: (lambda m, k=k: search(m, k, tight=k == "thin"))
            for k in SEARCHES},
         "bucket_overflow": bucket_overflow,
         "persistency": persistency,
         "step32": step32,
         "production": production,
         "production_replicated": lambda m: production(
             make_mesh(m.size, device="cpu", shard_owners=False)),
         "tuners": tuners,
         "crossing": crossing,
         "uneven": uneven,
         "plate": plate,
         "reshard": reshard,
         "reshard_odd": lambda m: reshard(m, 63),
         "sizes": sizes,
         "shrink": shrink}


def main(rank, world, store, out):
    torch.set_num_threads(1)
    os.makedirs(out, exist_ok=True)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(world, device="cpu")
    for name, fn in CASES.items():
        t0 = time.perf_counter()
        try:
            res = fn(mesh)
        except Exception:
            with open(os.path.join(out, f"{name}_{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
            raise
        # written whole, then renamed: a reader never sees half a file
        tmp = os.path.join(out, f"{name}_{rank}.part.npz")
        np.savez(tmp, **res)
        os.replace(tmp, os.path.join(out, f"{name}_{rank}.npz"))
        print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)
    open(os.path.join(out, f"done_{rank}"), "w").close()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
