"""The solver engine: contact-table refresh + dynamics stepping.

``refresh_contacts`` rebuilds the contact tables every K steps: sphere
pairs through kernel C (once on one grid, or, in two-class mode, twice
on member tables with the cross search between), sphere-triangle pairs
by the two-stage ST sweep over the same sorted spheres, sphere-floor
pairs by brute force; history carried, tables sorted and denormalized.
``dynamics_step`` then runs K times against the frozen tables (the fused
SS pass of a built-in Hertz model, kernel B, with its wrench sums, kernel
A; the ST and SA tables, and the SS table of any other force model,
through ``contact_pass`` and kernel A; integration under the family
prescriptions, evaluated at the step's start time, then the
family-change rules). Contact margins sized by K·h·velocity keep the
stale table exact.

Host protocol: ``Engine.refresh`` reads one overflow word per refresh.
On a capacity overflow it grows the table (or the unique-fetch lists)
and re-runs the refresh from the retained pre-refresh state; nothing on
this path updates a state tensor in place, so the retry is lossless.
``Engine.advance`` runs blocks of `fuse` chunks and shrinks oversized
tables after the refresh that opens its first, 64th and every 512th
block (``maybe_shrink``); with the tuners on it picks K and the bin
factor per block from the blocks' measured times (``Engine``). Growths
and tuner moves go to ``Engine.log`` at STEP_METRIC.

Multi-device: ``Engine(cfg, mesh)`` runs on one rank's shard of the
state (``parallel.mesh``). A refresh gathers the owner records, searches
the rank's share (by x-slab with cfg.spatial_refresh,
``parallel.spatial``), sends each new row to its home rank, carries
history against the rank's own old rows and finalizes them, then
reduces the overflow word over the ranks (``_refresh_on_mesh``); a step
runs the kernels on the rank's rows and reduce-scatters the wrench.
Every host decision reads values that are equal on every rank (the
reduced overflow word, counts reduced over the ranks, rank 0's tuner
moves), so the ranks call the same collectives.

Timers: ``Engine.advance`` marks each chunk's refresh and its K steps
with CUDA events on the card (the host clock on the CPU) and folds them
into ``Engine.timers`` once they are complete: after the next chunk's
refresh, which reads its overflow word anyway, or when the caller has
synchronised (``read_timers``). The K-step window reads nothing back.
``refresh_contacts`` and ``dynamics_step`` take an optional `mark`
callable that they call with a name at their stage boundaries
(``profiling.profile_stages``).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from .defines import F, I
from .models.prescriptions import PrescriptionTables, static_tables
from .ops import binning, forces, history, integrator, narrowphase, quat
from .ops import sweep, voxel
from .initializer import uniq_fields
from .ops.fused_force import fused_wrench_ss
from .parallel import mesh as pmesh
from .parallel.spatial import find_pairs_ss_spatial, received_cap
from .state import (
    OVF_AVG_CONTACTS,
    OVF_LCAP,
    OVF_SA_CAP,
    OVF_SPATIAL_BUCKET,
    OVF_SS_CAP,
    OVF_ST_CAP,
    OVF_ST_OCC,
    OVF_TRI_BINS,
    OVF_UNIQ,
    OVF_VEL,
    OVF_XOCC,
    ContactTable,
    RuntimeParams,
    SimState,
    SolverConfig,
)

_GROWTH = 1.6
_CAP_OVF = (OVF_SS_CAP | OVF_ST_CAP | OVF_SA_CAP | OVF_TRI_BINS
            | OVF_ST_OCC | OVF_UNIQ | OVF_XOCC | OVF_LCAP
            | OVF_SPATIAL_BUCKET)
_CAPS = {"ss": "cap_ss", "st": "cap_st", "sa": "cap_sa"}


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _no_mark(name):
    pass


def time_mark(device):
    """A timer mark: a recorded CUDA event on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def mark_seconds(a, b) -> float:
    """Seconds between two complete marks of ``time_mark``."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) * 1e-3


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def sphere_world_pos(owners, spheres, voxel_size):
    """f32 LBF-relative sphere centers."""
    own = spheres.owner.long()
    base = voxel.decode_f32(owners.vox[own], owners.loc[own], voxel_size)
    return base + quat.rotate(owners.quat[own], spheres.relpos)


def sphere_pos_margins(owners, spheres, params, voxel_size):
    """f32 LBF-relative sphere centers and per-sphere CD margins for
    max_drift steps of drift. Returns (pos, margin, absv, raw_absv)."""
    own = spheres.owner.long()
    pos = sphere_world_pos(owners, spheres, voxel_size)
    ex = params.family_extra_margin[owners.family.long()]
    lin = _norm(owners.vel)[own]
    arm = _norm(spheres.relpos) + spheres.radius
    raw = lin + _norm(owners.omg)[own] * arm
    absv = torch.minimum(raw, params.approx_max_vel)
    t_drift = params.h * params.max_drift.to(F)
    g_mag = _norm(params.gravity)
    margin = (
        (absv * params.expand_safety_multi + params.expand_safety_adder)
        * t_drift
        + 0.5 * g_mag * t_drift * t_drift
    ) + ex[own]
    return pos, margin, absv, raw


def owner_margin(owners, idx, arm, params):
    """Margin of a non-sphere owner (mesh/analytical), arm = lever."""
    idx = idx.long()
    lin = _norm(owners.vel[idx])
    rot = _norm(owners.omg[idx]) * arm
    absv = torch.minimum(lin + rot, params.approx_max_vel)
    t_drift = params.h * params.max_drift.to(F)
    m = ((absv * params.expand_safety_multi + params.expand_safety_adder)
         * t_drift)
    return m + params.family_extra_margin[owners.family[idx].long()]


# ---------------------------------------------------------------------------
# refresh
# ---------------------------------------------------------------------------


def tri_world_nodes(owners, tris, voxel_size):
    """f32 LBF-relative triangle nodes, (T, 3, 3)."""
    own = tris.owner.long()
    base = voxel.decode_f32(owners.vox[own], owners.loc[own], voxel_size)
    return base[:, None, :] + quat.rotate(owners.quat[own][:, None, :],
                                          tris.nodes)


def ss_search_inputs(state: SimState, params: RuntimeParams,
                     voxel_size: float, relabel: bool = True,
                     mesh=None) -> dict:
    """Sphere positions, reaches and grid of the SS pair search, plus
    the margins, radii and velocity measures the rest of the refresh
    uses (`max_vel`: the largest uncapped |v|, inf where one is not
    finite). `relabel` False keeps the world axes (the spatial search
    slabs x). With `mesh`, `state` holds a rank's share of the spheres
    and the grid and `max_vel` are those of every rank's."""
    owners, spheres = state.owners, state.spheres
    pos, margin, absv, raw_absv = sphere_pos_margins(owners, spheres,
                                                     params, voxel_size)
    reach = spheres.radius + margin
    max_vel = torch.where(torch.all(torch.isfinite(raw_absv)),
                          _max0(raw_absv), torch.inf).to(F)
    if mesh is None:
        top = reach.max()
    else:
        top, max_vel = mesh.all_max(torch.stack([_max0(reach),
                                                 max_vel])).unbind()
    bin_size, nb = binning.build_grid(params.domain, top, params.bin_factor)
    # CD axis relabel: the axis with the most bins becomes the slowest
    # (flat-bin major) axis. Distances do not depend on the axis order;
    # only the bin order of the sorted table does.
    perm = (torch.argsort(nb, stable=True) if relabel
            else torch.arange(3, device=nb.device))
    return dict(pos=pos, margin=margin, raw_absv=raw_absv, max_vel=max_vel,
                pos_cd=pos[:, perm], reach=reach, owner=spheres.owner,
                radius=spheres.radius,
                family=owners.family[spheres.owner.long()],
                family_mask=params.family_mask, bin_size=bin_size,
                nb_cd=nb[perm], dom_cd=params.domain[perm], perm=perm)


def _max0(x):
    """The largest of the non-negative `x`, 0 where it is empty."""
    return torch.cat([x.reshape(-1), x.new_zeros(1)]).max()


def _cross_lcap(cfg, n_spheres: int) -> int:
    """Rows of the two-class compacted large class (cfg.cross_lcap, or
    by default a third of the spheres, 128-aligned; OVF_LCAP grows it),
    never more than the spheres."""
    cap = cfg.cross_lcap or max(256, -(-(n_spheres // 3 + 1) // 128) * 128)
    return min(cap, max(n_spheres, 1))


def two_class_inputs(q, small, params, cfg, n_spheres):
    """The two classes of the two-class CD (``cfg.cd_two_class``), each
    ready for a member-table search.

    The large class is compacted to `_cross_lcap` rows (dead rows keep
    real positions, so their member flag sends them to the table's
    sentinel tail) and gets a coarse grid whose cell covers both the
    large-large distance and the largest cross distance (reach_s +
    reach_l: margins can lift a small sphere's reach above the large
    class's); the small class gets its own fine grid. Returns a dict:
    `large` and `small`, each the argument tuple (pos, reach, owner,
    family, bin_size, nb, member) of its search; `orig_l` (compacted row
    -> sphere id, S on dead rows), `reach_s`, `lcap_ovf`."""
    reach, owner, fam = q["reach"], q["owner"], q["family"]
    large = ~small
    reach_s = torch.where(small, reach, 0.0).max()
    reach_l = torch.where(large, reach, 0.0).max()
    bs_l, nb_l = binning.build_grid(
        q["dom_cd"], torch.maximum(reach_l, 0.5 * (reach_s + reach_l)),
        params.bin_factor)
    ((pos_c, reach_c, own_c, fam_c), orig_l, live_l, _,
     lcap_ovf) = binning.compact_member(large, _cross_lcap(cfg, n_spheres),
                                        q["pos_cd"], reach, owner, fam)
    bs_s, nb_s = binning.build_grid(q["dom_cd"], reach_s,
                                    params.bin_factor)
    return dict(
        large=(pos_c, torch.where(live_l, reach_c, -1e30),
               torch.where(live_l, own_c, -1), torch.where(live_l, fam_c, 0),
               bs_l, nb_l, live_l),
        small=(q["pos_cd"], reach, owner, fam, bs_s, nb_s, small),
        orig_l=orig_l, reach_s=reach_s, lcap_ovf=lcap_ovf)


def cross_pairs(q, tc, small, cfg, n_spheres, base=None, outs=None):
    """The small-large pairs of the two-class CD: the large spheres'
    multi-bin entries on the coarse grid, each small sphere scanning its
    own bin. Appends into (`outs`, `base`); returns (idA, idB, count,
    occupancy overflow: OVF_XOCC)."""
    pos_c, reach_c, own_c, fam_c, bs_l, nb_l, live_l = tc["large"]
    rec_l = torch.cat(
        [pos_c, reach_c[:, None], own_c.to(F)[:, None],
         fam_c.to(F)[:, None],
         torch.clamp(tc["orig_l"], max=n_spheres).to(F)[:, None]], dim=1)
    eb, el, occ_x = binning.build_cross_entries(
        pos_c, torch.clamp(reach_c + tc["reach_s"], min=0.0), live_l, bs_l,
        nb_l)
    idA, idB, n = binning.find_pairs_cross_fine(
        q["pos_cd"], q["reach"], q["owner"], q["family"], small, rec_l, eb,
        el, q["family_mask"], bs_l, nb_l, cfg.cap_ss, cfg.cross_mpb,
        base=base, outs=outs)
    return idA, idB, n, torch.where(occ_x > cfg.cross_mpb, OVF_XOCC, 0)


def two_class_pairs(q, small, params, cfg, n_spheres):
    """The SS pairs of the two-class CD: kernel C twice, on the member
    tables of ``two_class_inputs``, and ``cross_pairs`` between. The list
    is the small-small pairs, then the large-large and small-large ones.
    Returns (idA, idB, count, small table, overflow bits: OVF_XOCC,
    OVF_LCAP)."""
    cap = cfg.cap_ss
    mask = q["family_mask"]
    tc = two_class_inputs(q, small, params, cfg, n_spheres)
    pos_c, reach_c, own_c, fam_c, bs_l, nb_l, live_l = tc["large"]
    idA, idB, n_ll, _ = sweep.find_pairs_ss(
        pos_c, reach_c, own_c, fam_c, mask, bs_l, nb_l, cap, member=live_l)
    # compacted -> sphere ids (the compaction is stable: idA < idB holds)
    orig_l = tc["orig_l"]
    idA = torch.where(idA >= 0, orig_l[torch.clamp(idA, min=0).long()], -1)
    idB = torch.where(idB >= 0, orig_l[torch.clamp(idB, min=0).long()], -1)
    idA, idB, n_xl, ovf = cross_pairs(
        q, tc, small, cfg, n_spheres, base=torch.clamp(n_ll, max=cap).to(I),
        outs=(idA, idB))
    pos_s, reach_s, own_s, fam_s, bs_s, nb_s, _ = tc["small"]
    idA_s, idB_s, n_sss, tab = sweep.find_pairs_ss(
        pos_s, reach_s, own_s, fam_s, mask, bs_s, nb_s, cap, member=small)
    # the (L-L + S-L) list goes after the S-S list; rows past cap drop
    k = torch.arange(cap, dtype=I, device=idA.device)
    dest = torch.where(idA >= 0, k + torch.clamp(n_sss, max=cap), cap)
    dest = torch.clamp(dest, max=cap).long()
    outA = torch.cat([idA_s, idA_s.new_zeros(1)])
    outB = torch.cat([idB_s, idB_s.new_zeros(1)])
    outA[dest] = idA
    outB[dest] = idB
    ovf = (ovf | torch.where(tc["lcap_ovf"], OVF_LCAP, 0)).to(I)
    return outA[:cap], outB[:cap], n_sss + n_xl, tab, ovf


def st_pairs(state, params, cfg, q, tab):
    """The sphere-triangle pairs of a refresh and their overflow bits
    (OVF_ST_OCC, OVF_TRI_BINS): the two-stage sweep over the SS search's
    sorted table `tab` (in two-class mode a single-grid table of all
    spheres, built here, takes its place), or, once cfg.st_bruteforce is
    set, the exact S x T matrix."""
    owners, tris = state.owners, state.tris
    dev = state.device
    nodes = tri_world_nodes(owners, tris, cfg.voxel_size)
    arm = _norm(tris.nodes).max(dim=-1).values
    m_t = owner_margin(owners, tris.owner, arm, params)
    tri_fam = owners.family[tris.owner.long()]
    if cfg.st_bruteforce:
        # facets too large for bin enumeration: O(S*T) candidates in
        # world axes, compacted like the sphere-analytical pairs
        ovl, _, _ = narrowphase.sphere_triangle(
            q["pos"][:, None, :], q["radius"][:, None],
            nodes[None, :, 0], nodes[None, :, 1], nodes[None, :, 2])
        ovl_m = ovl + q["margin"][:, None] + m_t[None, :]
        tA, tB, n_st = binning.find_pairs_sa(
            ovl_m, q["owner"], q["family"], tris.owner, tri_fam,
            params.family_mask, cfg.cap_st)
        return tA, tB, n_st, torch.zeros((), dtype=I, device=dev)
    if cfg.cd_two_class:
        tab = binning.build_sphere_table(
            q["pos_cd"], q["reach"], q["owner"], q["family"],
            q["bin_size"], q["nb_cd"], max(q["reach"].shape[0], 1))
    # the table's axes are the relabelled ones; so are the nodes here
    nodes_cd = nodes[:, :, q["perm"]]
    amin = nodes_cd.min(dim=1).values - m_t[:, None]
    amax = nodes_cd.max(dim=1).values + m_t[:, None]
    tA, tB, n_st, span_ovf = binning.find_pairs_st(
        amin, amax, tris.owner, tri_fam, tab, params.family_mask,
        q["bin_size"], q["nb_cd"], cfg.cap_st, cfg.max_tri_span,
        cfg.max_per_bin, amin - q["reach"].max(), amax + q["reach"].max(),
        nodes_cd, m_t)
    # the sweep scans max_per_bin slots of a bin; no SS search bounds
    # the table's occupancy, so a denser bin grows the scan
    ovf = (torch.where(tab.max_occ > cfg.max_per_bin, OVF_ST_OCC, 0)
           | torch.where(span_ovf, OVF_TRI_BINS, 0)).to(I)
    return tA, tB, n_st, ovf


def _mark_persistent(table, fam_a_src, fam_b_src, params):
    """Mark the table's live contacts persistent where the family pair of
    their two sides is (params.family_persist, MarkFamilyPersistentContact
    and its kin)."""
    live = table.idA >= 0
    fa = fam_a_src[torch.where(live, table.idA, 0).long()].long()
    fb = fam_b_src[torch.where(live, table.idB, 0).long()].long()
    mark = params.family_persist[fa, fb] & live
    return table.replace(persist=torch.where(mark, 1, table.persist))


def _capped(table, cap, bit):
    """The finalized table with its count clamped to `cap`, and `bit`
    where it held more: re-injected persistent rows can push a count
    past the capacity (without persistency the count never passes it)."""
    ovf = torch.where(table.count > cap, bit, 0).to(I)
    return table.replace(count=torch.clamp(table.count, max=cap)), ovf


def _ss_pairs(q, params, cfg, mark):
    """The SS search over the spheres of `q`: kernel C on one grid, or
    the two-class search. Returns (idA, idB, count, sorted table,
    overflow bits)."""
    if cfg.cd_two_class:
        return two_class_pairs(q, q["radius"] <= params.cls_thr, params,
                               cfg, q["reach"].shape[0])
    idA, idB, n_ss, tab = sweep.find_pairs_ss(
        q["pos_cd"], q["reach"], q["owner"], q["family"],
        params.family_mask, q["bin_size"], q["nb_cd"], cfg.cap_ss,
        mark=mark)
    return idA, idB, n_ss, tab, torch.zeros((), dtype=I, device=idA.device)


def sa_pairs(owners, anals, q, params, cfg, cap):
    """The sphere-analytical pairs of the spheres of `q`, brute force over
    their (S, A) margined-overlap matrix: (row of `q`, analytical id,
    count), `cap` rows."""
    own_b = anals.owner.long()
    base_b = voxel.decode_f32(owners.vox[own_b], owners.loc[own_b],
                              cfg.voxel_size)
    obj_pos = base_b + quat.rotate(owners.quat[own_b], anals.relpos)
    obj_dir = quat.rotate(owners.quat[own_b], anals.direction)
    m_a = owner_margin(owners, anals.owner,
                       torch.zeros_like(anals.normal_sign), params)
    ovl, _, _ = narrowphase.sphere_analytical(
        q["pos"][:, None, :], q["radius"][:, None],
        anals.objtype[None, :], obj_pos[None], obj_dir[None],
        anals.size[None], anals.normal_sign[None, :],
    )
    ovl_m = ovl + q["margin"][:, None] + m_a[None, :]
    return binning.find_pairs_sa(
        ovl_m, q["owner"], q["family"], anals.owner, owners.family[own_b],
        params.family_mask, cap)


def _guards(overflow, max_vel, n_live, n_spheres, params):
    """The overflow word with the divergence guards: a velocity past
    error_out_vel (or not finite), too many contacts a sphere."""
    overflow = overflow | torch.where(~(max_vel <= params.error_out_vel),
                                      OVF_VEL, 0).to(I)
    avg_cnt = 2.0 * n_live.to(F) / max(n_spheres, 1)
    return overflow | torch.where(avg_cnt > params.error_out_avg_contacts,
                                  OVF_AVG_CONTACTS, 0).to(I)


def _refreshed(kind, old, a, b, n, cap, bit, recs, params, cfg, mark,
               uniq_cap=0, ids=None):
    """Carry, mark, cap and finalize one table of `cap` rows: the history
    of `old` carried onto the front-compacted pairs (a, b) (`n` counts
    every pair found, those past `cap` too), the live rows whose family
    pair persists marked so, and the table finalized on `recs` (owners,
    spheres, triangles, analyticals). `ids`, on a mesh, takes the carried
    table and the sphere and triangle records to the ids the finalize
    reads, and gives the map of the finalized table back to global ids.
    Returns (table, live count, overflow bits, contacts lost)."""
    owners, sph, tris, anals = recs
    model = cfg.force_model
    persistency = cfg.use_persistency
    t, lost = history.carry_history(old, a, b, torch.clamp(n, max=cap).to(I),
                                    model.contact_wildcards, persistency)
    if kind == "ss":
        mark("history")
    overflow = torch.where(n > cap, bit, 0).to(I)
    if old.cap != cap:
        # a grown capacity, or a whole table's home rows: the carried rows
        # on a table of the new size (finalize fills the rest)
        t = ContactTable.empty(
            cap, fused=kind == "ss" and forces.fused_ss(model),
            device=t.idA.device).replace(idA=t.idA, idB=t.idB,
                                         persist=t.persist,
                                         wildcards=t.wildcards, count=t.count)
    back = None
    if ids is not None:
        t, sph, tris, back = ids(kind, t, sph, tris)
    if persistency:
        src_b = {"ss": sph, "st": tris, "sa": anals}[kind]
        t = _mark_persistent(t, owners.family[sph.owner.long()],
                             owners.family[src_b.owner.long()], params)
        t, ovf = _capped(t, cap, bit)
        overflow |= ovf
    count = t.count
    t = forces.finalize_table(kind, t, owners, sph, tris, anals, params,
                              model, uniq_cap=uniq_cap)
    return (t if back is None else back(t)), count, overflow, lost


def _refresh(state, params, cfg, mark):
    """The tables of a refresh of a whole state: each list searched over
    every sphere and carried once."""
    owners, spheres, tris, anals = (state.owners, state.spheres,
                                    state.tris, state.anals)
    recs = (owners, spheres, tris, anals)
    q = ss_search_inputs(state, params, cfg.voxel_size)
    idA, idB, n_ss, tab, overflow = _ss_pairs(q, params, cfg, mark)
    mark("pairs")
    lost = state.lost_contacts

    def refreshed(kind, a, b, n, bit, uniq_cap=0):
        """One table (``_refreshed``) at its capacity; its live count."""
        nonlocal overflow, lost
        t, count, ovf, n_lost = _refreshed(
            kind, getattr(state, kind), a, b, n, getattr(cfg, _CAPS[kind]),
            bit, recs, params, cfg, mark, uniq_cap)
        overflow, lost = overflow | ovf, lost + n_lost
        return t, count

    ss, n_live = refreshed("ss", idA, idB, n_ss, OVF_SS_CAP, cfg.uniq_cap)
    if cfg.uniq_cap:
        overflow |= torch.where(ss.uniq_max > cfg.uniq_cap, OVF_UNIQ,
                                0).to(I)
    mark("finalize")

    st = state.st
    if tris.n > 0:
        tA, tB, n_st, ovf_st = st_pairs(state, params, cfg, q, tab)
        overflow |= ovf_st
        st, _ = refreshed("st", tA, tB, n_st, OVF_ST_CAP)

    sa = state.sa
    if anals.n > 0:
        aA, aB, n_sa = sa_pairs(owners, anals, q, params, cfg, cfg.cap_sa)
        sa, _ = refreshed("sa", aA, aB, n_sa, OVF_SA_CAP)

    overflow = _guards(overflow, q["max_vel"], n_live, spheres.n, params)
    return state.replace(ss=ss, st=st, sa=sa, overflow=overflow,
                         max_vel=q["max_vel"], lost_contacts=lost)


def refresh_contacts(state: SimState, params: RuntimeParams,
                     cfg: SolverConfig, mark=None, mesh=None) -> SimState:
    """One refresh of the contact tables. `mark`, if given, is called
    with "table", "pairs", "history" and "finalize" at the single-grid SS
    search's stage boundaries (after the sorted table, kernel C, the
    history carry and the SS table's finalize). With `mesh`, `state` is
    this rank's shard (``parallel.mesh.shard_state``): see
    ``_refresh_on_mesh``."""
    mark = mark or _no_mark
    if mesh is not None:
        return _refresh_on_mesh(state, params, cfg, mark, mesh)
    return _refresh(state, params, cfg, mark)


def spatial_capx_auto(n_spheres: int, n_dev: int) -> int:
    """Rows of a spatial exchange bucket when cfg.spatial_capx is 0."""
    return max(128, 2 * n_spheres // (n_dev * n_dev) + 128)


# the per-sphere fields of ss_search_inputs that a search over every
# sphere reads (pos_cd follows from pos)
_Q_ROWS = ("pos", "margin", "reach", "owner", "family", "radius")


def _q_rows(q, lo, hi):
    """`q` of the spheres lo..hi."""
    return {**q, **{k: q[k][lo:hi] for k in _Q_ROWS}}


def _whole_q(q, mesh):
    """`q` of a rank's spheres with its per-sphere fields gathered from
    every rank (one collective): what a search over every sphere reads."""
    out = dict(q)
    out.update(zip(_Q_ROWS, mesh.gather_fields([q[k] for k in _Q_ROWS])))
    out["pos_cd"] = out["pos"][:, q["perm"]]
    return out


def _home_pairs(a, b, n, n_spheres, cap, mesh, send):
    """The rank's home pairs (``parallel.mesh.home_of`` their A side) of a
    front-compacted pair list (live where a >= 0; `n` counts every pair
    found, those past the list too), front-compacted into `cap` rows,
    and their count (rows past `cap` are dropped and counted). With
    `send` the list is this rank's share of the pairs and each is sent
    home (one ``Mesh.exchange``); else every rank holds the whole list
    and keeps its own. On one rank every pair is home: the list is cut or
    padded to `cap` rows as it is."""
    d = mesh.size
    if d == 1:
        return _fit(a, cap), _fit(b, cap), n
    home = pmesh.home_of(a, n_spheres, d)
    dev = a.device
    outs = (torch.full((cap,), -1, dtype=I, device=dev),
            torch.full((cap,), -1, dtype=I, device=dev))
    zero = torch.zeros((), dtype=I, device=dev)
    if not send:
        (a, b), k = binning._compact((a >= 0) & (home == mesh.rank), (a, b),
                                     cap, zero, outs)
        return a, b, k.to(I)
    rows, _ = mesh.exchange(torch.stack([a, b], 1),
                            torch.where(a >= 0, home, d))
    live = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
    (a, b), k = binning._compact(live, (rows[:, 0], rows[:, 1]), cap, zero,
                                 outs)
    return a, b, k.to(I)


def _fit(x, rows):
    """A front-compacted id list cut or padded (-1) to `rows` rows."""
    if x.shape[0] >= rows:
        return x[:rows]
    return torch.cat([x, x.new_full((rows - x.shape[0],), -1)])


def _home_rows(table, split, n_spheres, mesh):
    """The rows of an old table a rank carries history against: its block
    where the table is split (every row there is home), else the whole
    table's home rows, the others marked dead."""
    if split:
        return table
    mine = (table.idA >= 0) & (
        pmesh.home_of(table.idA, n_spheres, mesh.size) == mesh.rank)
    return table.replace(idA=torch.where(mine, table.idA, -1),
                         idB=torch.where(mine, table.idB, -1))


def _cat_spheres(a, b):
    return a.replace(wildcards={}, **{
        k: torch.cat([getattr(a, k), getattr(b, k)])
        for k in ("owner", "relpos", "radius", "mat")})


def _refresh_on_mesh(state, params, cfg, mark, mesh):
    """The refresh of a rank's shard: each rank searches its own share,
    sends each new row to its home rank (``parallel.mesh.home_of``: the
    index shard of its A-side sphere, the same at every refresh), carries
    history against its own old rows and finalizes them, as the JAX
    package's refresh partitions over its mesh. Each table holds cap / D
    rows a rank.

    Gathered: the owner records; with triangles, every sphere's search
    record (the ST sweep reads the sorted table of every sphere); without
    the spatial search, every sphere's search record for the search over
    every sphere, which each rank runs alike. SS pairs come from the
    spatial search (cfg.spatial_refresh, the spheres split over the
    ranks: this rank's index shard searched by slab, each kept pair sent
    home) or from that whole search (each rank keeps its home pairs). ST
    pairs come from the sweep over this rank's triangle shard (over every
    triangle where they do not divide), sent home; SA pairs from the
    brute force over the rank's home spheres, home already. Where the
    spheres or triangles are split, a finalize asks the B-side records of
    its rows of their holders (``parallel.mesh.fetch_record``). A rank
    whose home rows pass cap / D raises the table's overflow bit. The
    overflow word, the live SS count and the lost contacts are reduced
    over the ranks, so every rank takes the same growth and retry."""
    lay = state.layout
    if lay is None:
        raise ValueError("a refresh on a mesh takes a rank's shard "
                         "(parallel.mesh.shard_state)")
    d, r = mesh.size, mesh.rank
    for name in _CAPS.values():
        if getattr(cfg, name) % d:
            raise ValueError(f"{name} {getattr(cfg, name)} does not divide "
                             f"by {d} ranks (Engine(cfg, mesh) rounds it)")
    n_sph, n_tri = lay.n_spheres, lay.n_tris
    lo, hi = pmesh.home_range(n_sph, d, r)
    owners = (pmesh.gather_record(state.owners, mesh) if lay.owners
              else state.owners)
    g = state.replace(owners=owners)
    spatial = cfg.spatial_refresh and lay.spheres
    # q: the search record of the rank's home spheres; qa: of every
    # sphere, where a search over every sphere reads it
    if lay.spheres:
        q = ss_search_inputs(g, params, cfg.voxel_size, relabel=not spatial,
                             mesh=mesh)
        qa = _whole_q(q, mesh) if n_tri or not spatial else None
    else:
        # the spheres are whole on every rank: so is their record
        qa = ss_search_inputs(g, params, cfg.voxel_size)
        q = _q_rows(qa, lo, hi)
    dev = state.device
    lost = torch.zeros((), dtype=I, device=dev)

    tab = None
    if spatial:
        capx = cfg.spatial_capx or spatial_capx_auto(n_sph, d)
        # the pairs a rank keeps by slab, before each goes home, in as
        # many rows as kernel C's table over its received rows: each kept
        # pair is one of C's, so however the slabs split the pairs against
        # the home shards, the list overflows only where C's table did
        a, b, n_found, _, bucket_ovf = find_pairs_ss_spatial(
            q["pos"], q["reach"], q["owner"], q["family"],
            params.family_mask, q["bin_size"], q["nb_cd"], params.domain,
            cfg.cap_ss, mesh, capx,
            keep_cap=received_cap(cfg.cap_ss, n_sph, d * capx))
        overflow = torch.where(bucket_ovf, OVF_SPATIAL_BUCKET, 0).to(I)
        if n_tri:
            tab = binning.build_sphere_table(
                qa["pos_cd"], qa["reach"], qa["owner"], qa["family"],
                qa["bin_size"], qa["nb_cd"], max(n_sph, 1))
    else:
        a, b, n_found, tab, overflow = _ss_pairs(qa, params, cfg, mark)
    # more pairs than the table's rows (a rank's home rows past cap / D
    # raise the bit in its carry too)
    overflow |= torch.where(n_found > cfg.cap_ss, OVF_SS_CAP, 0).to(I)
    a, b, n_ss = _home_pairs(a, b, n_found, n_sph, cfg.cap_ss // d, mesh,
                             send=spatial)
    mark("pairs")

    # where the spheres (triangles) are split over several ranks, a
    # finalize reads the rank's own spheres and, for each row, the B-side
    # sphere (triangle) fetched from its holder, by ids into those
    # records; where a record is whole here, by global id
    fetch_sph = lay.spheres and d > 1
    fetch_tri = lay.tris and d > 1

    recs = (owners, state.spheres, state.tris, state.anals)

    def to_local(kind, t, sph, tris):
        """The rank's rows in ids into the records its finalize reads: A
        into the rank's own spheres, B into the records fetched from their
        holders; and the map of the finalized rows back to global ids."""
        glob_b = None
        live = t.idA >= 0
        if fetch_sph:
            t = t.replace(idA=torch.where(live, t.idA - lo, -1))
        if kind == "ss" and fetch_sph or kind == "st" and fetch_tri:
            glob_b = t.idB
            rec_b = pmesh.fetch_record(sph if kind == "ss" else tris,
                                       glob_b, mesh)
            row = torch.arange(t.cap, dtype=I, device=dev)
            if kind == "ss":
                sph, row = _cat_spheres(sph, rec_b), row + sph.n
            else:
                tris = rec_b
            t = t.replace(idB=torch.where(live, row, -1))

        def back(t):
            live = t.idA >= 0
            if glob_b is not None:
                j = t.idB - (state.spheres.n if kind == "ss" else 0)
                t = t.replace(idB=torch.where(
                    live, glob_b[torch.clamp(j, min=0).long()], -1))
            if fetch_sph:
                t = t.replace(idA=torch.where(live, t.idA + lo, -1))
            return t

        return t, sph, tris, back

    def refreshed(kind, a, b, n, bit, uniq_cap=0):
        """The rank's rows of one table (``_refreshed``, cap / D rows),
        carried against its own old rows; its live count."""
        nonlocal overflow, lost
        old = _home_rows(getattr(state, kind), kind in lay.tables, n_sph,
                         mesh)
        t, count, ovf, n_lost = _refreshed(
            kind, old, a, b, n, getattr(cfg, _CAPS[kind]) // d, bit, recs,
            params, cfg, mark, uniq_cap, ids=to_local)
        overflow, lost = overflow | ovf, lost + n_lost
        return t, count

    ss, n_live = refreshed("ss", a, b, n_ss, OVF_SS_CAP, cfg.uniq_cap)
    if cfg.uniq_cap:
        overflow |= torch.where(ss.uniq_max > cfg.uniq_cap, OVF_UNIQ,
                                0).to(I)
    mark("finalize")

    st = state.st
    if n_tri:
        # this rank's triangles against the sorted table of every sphere
        tA, tB, n_found, ovf_st = st_pairs(g, params, cfg, qa, tab)
        t_lo = pmesh.home_range(n_tri, d, r)[0] if lay.tris else 0
        tB = torch.where(tA >= 0, tB + t_lo, -1)
        overflow |= ovf_st | torch.where(n_found > cfg.cap_st, OVF_ST_CAP,
                                         0).to(I)
        st, _ = refreshed("st", *_home_pairs(
            tA, tB, n_found, n_sph, cfg.cap_st // d, mesh, send=lay.tris),
            OVF_ST_CAP)

    sa = state.sa
    if state.anals.n:
        aA, aB, n_sa = sa_pairs(owners, state.anals, q, params, cfg,
                                cfg.cap_sa // d)
        sa, _ = refreshed("sa", torch.where(aA >= 0, aA + lo, -1), aB,
                          n_sa, OVF_SA_CAP)

    bit = torch.arange(31, dtype=I, device=dev)
    sums = mesh.all_sum(torch.cat([(overflow >> bit) & 1,
                                   torch.stack([n_live, lost]).to(I)]))
    overflow = ((sums[:31] > 0).to(I) << bit).sum().to(I)
    fresh = {"ss"} | ({"st"} if n_tri else set()) | (
        {"sa"} if state.anals.n else set())
    return state.replace(
        ss=ss, st=st, sa=sa,
        overflow=_guards(overflow, q["max_vel"], sums[31], n_sph, params),
        max_vel=q["max_vel"], lost_contacts=state.lost_contacts + sums[32],
        layout=lay._replace(tables=tuple(
            k for k in _CAPS if k in fresh or k in lay.tables)))


# ---------------------------------------------------------------------------
# dynamics step
# ---------------------------------------------------------------------------


def _mesh_inputs(state, mesh):
    """On a mesh: every owner (one all-gather of the owner records where
    they are split), and the spheres and triangles whose geometry
    wildcards a contact pass reads by global id. Raises where a table the
    step would run is replicated: its sums would count once per rank."""
    lay = state.layout
    if lay is None:
        raise ValueError("a step on a mesh takes a rank's shard "
                         "(parallel.mesh.shard_state)")
    for kind, n_geo in (("ss", state.spheres.n), ("st", state.tris.n),
                        ("sa", state.anals.n)):
        if n_geo and getattr(state, kind).cap and kind not in lay.tables:
            raise ValueError(f"the {kind} table is replicated on the mesh "
                             "(its capacity does not divide by the ranks): "
                             "refresh it first")

    def whole(rec, split):
        return (pmesh.gather_record(rec, mesh) if split and rec.wildcards
                else rec)

    owners = (pmesh.gather_record(state.owners, mesh) if lay.owners
              else state.owners)
    return (owners, whole(state.spheres, lay.spheres),
            whole(state.tris, lay.tris))


def dynamics_step(state: SimState, params: RuntimeParams,
                  cfg: SolverConfig, h: float | None = None,
                  tables: PrescriptionTables | None = None,
                  mark=None, mesh=None) -> SimState:
    """One step. `h` is params.h as a host float and `tables` the static
    prescription tables (``static_tables``); run_steps passes both once
    per chunk so a step reads nothing back from the device. The tables
    are evaluated at the step's start time, the family-change rules
    applied to the owners that come out of the integrator. `mark`, if
    given, is called with "forces" after the contact passes and with
    "reduced" after the ST and SA sums.

    With `mesh`, `state` is this rank's shard: the passes run on its
    table rows against every owner's record (``_mesh_inputs``), and the
    partial (N, 6) wrench is reduce-scattered onto the rank's owners, or
    all-reduced where the owners are replicated, before they are
    integrated."""
    mark = mark or _no_mark
    if h is None:
        h = float(params.h)
    if tables is None:
        tables = static_tables(cfg.prescriptions, state.device)
    if mesh is None:
        owners, spheres, tris = state.owners, state.spheres, state.tris
    else:
        owners, spheres, tris = _mesh_inputs(state, mesh)
    model = cfg.force_model
    n = owners.n

    # one (n, 6) wrench accumulator per step: the first table's sums
    # create it and the others add onto it in place. The SS table of a
    # built-in Hertz model runs the fused pass (kernel B with its own
    # sums); any other model's runs contact_pass like ST and SA
    ss = state.ss
    fused = (state.spheres.n > 0 and ss.cap > 0
             and forces.fused_ss(model))
    acc = None
    if fused:
        krec_w = forces.pack_kinematics(owners, world_omg=True)
        acc, ss = fused_wrench_ss(ss, owners, h, cfg.voxel_size, model,
                                  krec_w)
    wide = {"ss": ss, "st": state.st, "sa": state.sa}
    passes = []
    krec = None  # body-frame omg, packed once for every table
    for kind, n_geo in (("ss", 0 if fused else state.spheres.n),
                        ("st", state.tris.n), ("sa", state.anals.n)):
        if n_geo == 0 or wide[kind].cap == 0 or state.spheres.n == 0:
            continue
        if krec is None:
            krec = forces.pack_kinematics(owners)
        p = forces.contact_pass(
            kind, wide[kind], owners, spheres, tris, state.anals, params,
            state.time, cfg.voxel_size, model, krec=krec)
        wide[kind] = p["table"]
        passes.append(p)
    mark("forces")
    if passes:
        acc = forces.reduce_wrench_segment(n, passes, out=acc)
    elif acc is None:
        acc = torch.zeros((n, 6), dtype=F, device=state.device)
    if mesh is not None:
        acc = (mesh.reduce_rows(acc) if state.layout.owners
               else mesh.all_sum(acc))
    f_acc, t_acc = acc[:, :3], acc[:, 3:]
    mark("reduced")

    owners = integrator.integrate_owners(
        state.owners, f_acc, t_acc, params, tables.at(state.time),
        cfg.voxel_size, cfg.integrator, state.time)
    owners = integrator.apply_family_changes(
        owners, cfg.family_changes, cfg.voxel_size, state.time)
    return state.replace(owners=owners, ss=wide["ss"], st=wide["st"],
                         sa=wide["sa"], time=state.time + params.h,
                         step=state.step + 1)


def run_steps(state: SimState, params: RuntimeParams, cfg: SolverConfig,
              n_steps: int, h: float | None = None, mesh=None) -> SimState:
    """`n_steps` steps. `h` is float(params.h), read here unless given:
    with it given, the steps read nothing back from the device."""
    if h is None:
        h = float(params.h)
    tables = static_tables(cfg.prescriptions, state.device)
    for _ in range(n_steps):
        state = dynamics_step(state, params, cfg, h, tables, mesh=mesh)
    return state


# ---------------------------------------------------------------------------
# host-side engine
# ---------------------------------------------------------------------------


class Engine:
    """The refresh/step/grow/shrink protocol, with the adaptive CD cadence
    and bin size of the JAX package's engine.

    ``advance`` runs its steps in blocks of `fuse` chunks of K steps (the
    JAX engine's fused superchunks; the port launches each chunk on its
    own), then the remainder that fills no block in chunks of K. Each
    block is measured: the sum of its chunks' CUDA-event spans, from
    each refresh's start to the end of its steps, over its steps. The
    marks are complete once the next refresh has read its overflow word,
    so a block is folded in one block late (``read_timers``) and the
    tuner adds no host sync. A block whose refreshes grew a table is not
    counted: its time holds the retry.

    What the events see: on the built-in step the card is idle most of a
    step (about 83 % on the 262,144-clump bed), so the span between two
    events is mostly the host's launch time. The K tuner therefore walks
    toward the K that makes the fewest launches per step, which is the
    cost a user pays; the bin tuner toward the cheapest refresh.
    """

    #: the CD cadences the adaptive tuner visits
    K_LADDER = (5, 8, 12, 18, 25, 36, 52, 75, 108, 156)

    #: bin-size factors the adaptive bin tuner visits (1.0 is the
    #: one-bin-per-sphere floor, 2 x the largest reach)
    BIN_LADDER = (1.0, 1.3, 1.7, 2.2, 3.0)

    def __init__(self, cfg: SolverConfig, mesh=None, fuse: int = 8):
        #: the ``parallel.mesh.Mesh`` a multi-device run shards over, or
        #: None; on a mesh every method takes and returns this rank's
        #: shard, and the capacities stay multiples of the world size
        self.mesh = mesh
        if mesh is not None:
            cfg = dataclasses.replace(cfg, **{
                name: self._divisible(getattr(cfg, name))
                for name in _CAPS.values()})
        self.cfg = cfg
        #: chunks per measured block
        self.fuse = fuse
        #: optional callable(level_name, msg) that the API sets: routes the
        #: engine's growth and tuner events to the user's verbosity sink
        self.log = None
        # adaptive CD cadence: seconds/step per K, walked toward the
        # cheapest rung of K_LADDER (below max_freq, SetCDMaxUpdateFreq)
        self.auto_freq = False
        self.active_freq: int | None = None
        self.max_freq: int | None = None
        self._k_perf: dict = {}
        # adaptive bin size: a factor over the 2*max(reach) cell floor,
        # put into params at every chunk; SetBinSize/SetInitBinSize seed
        # it, and with auto_bin it walks BIN_LADDER like K
        self.bin_factor = 1.0
        self.auto_bin = False
        self._bin_perf: dict = {}
        #: one record per measured block, oldest first: its index in its
        #: advance call, K, bin factor, seconds per step, growths, ss.count
        #: and cap_ss at its first refresh, whether it was counted and
        #: whether it re-tuned, the steps not yet enqueued when it was
        #: measured, and the K (active_freq) and bin factor set after it
        self.blocks: list = []
        #: refreshes run, retries after a capacity growth included (one
        #: pair-search launch each)
        self.refresh_attempts = 0
        self.shrinks = 0
        #: clearable statistics: seconds and counts of the chunks' timed
        #: refreshes and steps, growths, shrinks and refresh retries
        self.timers = self.zero_timers()
        self._pending = []  # marks of chunks not yet folded in
        self._remaining = 0  # steps the running advance has not enqueued

    @staticmethod
    def zero_timers():
        return {"refresh_s": 0.0, "refresh_n": 0, "steps_s": 0.0,
                "steps_n": 0, "grows": 0, "shrinks": 0, "retries": 0}

    def _emit(self, level, msg):
        if self.log is not None:
            self.log(level, msg)
        elif level in ("WARNING", "ERROR"):
            # no sink (bare Engine use): a strategy change still surfaces
            print(f"[dem_engine_tpu_torch][{level}] {msg}", file=sys.stderr,
                  flush=True)

    def _divisible(self, cap: int) -> int:
        """`cap` rounded up to a multiple of the world size."""
        d = self.mesh.size if self.mesh is not None else 1
        return -(-cap // d) * d

    def _count(self, state, kind) -> int:
        """A table's live count over every rank."""
        t = getattr(state, kind)
        if self.mesh is not None and kind in state.layout.tables:
            return int(self.mesh.all_sum(t.count))
        return int(t.count)

    def _config_changed(self):
        """What the JAX engine's rebuild after a change of capacities or
        config does here: there is no compiled program to drop, only the
        K tuner's measurements, since capacities shift the per-step
        cost."""
        self._k_perf.clear()

    def read_timers(self) -> dict:
        """Fold every pending chunk's marks into ``timers``, and each
        block whose chunks are all folded into the tuners. On the card
        this waits for the last chunk's end mark: no wait where the caller
        has synchronised already, as DoDynamics and a refresh have."""
        if self._pending and not isinstance(self._pending[-1][2], float):
            self._pending[-1][2].synchronize()
        pending, self._pending = self._pending, []
        for r0, s0, s1, kk, blk in pending:
            rs, ss = mark_seconds(r0, s0), mark_seconds(s0, s1)
            self.timers["refresh_s"] += rs
            self.timers["steps_s"] += ss
            self.timers["refresh_n"] += 1
            self.timers["steps_n"] += kk
            if blk is not None:
                blk["s"] += rs + ss
                blk["folded"] += 1
                if blk["folded"] == blk["chunks"]:
                    self._measure(blk)
        return self.timers

    def clear_timers(self):
        self._pending = []
        self.timers = self.zero_timers()

    def _measure(self, blk):
        """A block's seconds per step into the tuners, then, with them on,
        a move: K after even blocks, the bin factor after odd ones (the
        two hill climbs never move in one measurement window). A move
        takes effect at the next block that starts."""
        k, bf = blk["k"], blk["bin_factor"]
        per = blk["s"] / blk["steps"]
        rec = dict(index=blk["index"], k=k, bin_factor=bf, per=per,
                   grows=blk["grows"], ss_count=blk["ss_count"],
                   cap_ss=blk["cap_ss"], counted=blk["grows"] == 0,
                   retuned=False, remaining=self._remaining)
        self.blocks.append(rec)
        if rec["counted"]:
            self._tune(rec)
        if self.mesh is not None and (self.auto_freq or self.auto_bin):
            # each rank timed its own blocks: all take rank 0's move
            k, bf = self.mesh.broadcast(torch.tensor(
                [float(self.active_freq or 0), self.bin_factor],
                dtype=torch.float64, device=self.mesh.device)).tolist()
            self.active_freq, self.bin_factor = int(k) or None, bf
        # what the next block to start runs at
        rec["k_next"], rec["bin_next"] = self.active_freq, self.bin_factor

    def _tune(self, rec):
        """The JAX engine's update of a counted block and its move."""
        k, bf, per = rec["k"], rec["bin_factor"], rec["per"]
        old = self._k_perf.get(k)
        if old is not None and per < 0.8 * old:
            # the bed is settling (the same K got >20% cheaper): the
            # other rungs' readings are stale, re-explore from here
            self._k_perf = {k: per}
            self._bin_perf.clear()
            rec["retuned"] = True
        else:
            self._k_perf[k] = per if old is None else 0.5 * old + 0.5 * per
        old_b = self._bin_perf.get(bf)
        self._bin_perf[bf] = per if old_b is None else (
            0.5 * old_b + 0.5 * per)
        if self.auto_freq and rec["index"] % 2 == 0:
            new = self._propose_k(k, self._remaining)
            if new != (self.active_freq or k):
                self._emit("STEP_METRIC", f"adaptive CD cadence: K {k} -> "
                           f"{new} ({per * 1e3:.3f} ms/step at K {k})")
            self.active_freq = new
        elif self.auto_bin and rec["index"] % 2 == 1:
            new = self._propose_bin()
            if new != self.bin_factor:
                self._emit("STEP_METRIC", f"adaptive bin size: factor "
                           f"{self.bin_factor:g} -> {new:g} "
                           f"({per * 1e3:.3f} ms/step at {bf:g})")
            self.bin_factor = new

    def _propose_k(self, k: int, remaining: int) -> int:
        """Walk the K ladder toward the cheapest measured seconds/step;
        explore an unmeasured neighbor when adjacent to the current best."""
        ladder = [x for x in self.K_LADDER
                  if remaining >= 2 * self.fuse * x
                  and (self.max_freq is None or x <= self.max_freq)]
        if k not in ladder:
            return k
        i = ladder.index(k)
        neighbors = [j for j in (i - 1, i + 1) if 0 <= j < len(ladder)]
        for j in neighbors:  # explore unmeasured neighbors first
            if ladder[j] not in self._k_perf:
                return ladder[j]
        best = min(
            (v, kk) for kk, v in self._k_perf.items() if kk in ladder
        )[1]
        if best == k:
            return k
        return ladder[i + (1 if best > k else -1)]

    def _propose_bin(self) -> float:
        """Walk the bin-factor ladder toward the cheapest measured
        seconds/step."""
        ladder = sorted(set(self.BIN_LADDER) | {self.bin_factor})
        f = self.bin_factor
        i = ladder.index(f)
        for j in (i - 1, i + 1):
            if 0 <= j < len(ladder) and ladder[j] not in self._bin_perf:
                return ladder[j]
        best = min(
            (v, kk) for kk, v in self._bin_perf.items() if kk in ladder
        )[1]
        if best == f:
            return f
        return ladder[i + (1 if best > f else -1)]

    def grow_for(self, state: SimState, ovf: int) -> SimState:
        """Grow the capacities named by the overflow bits. A unique-fetch
        overflow doubles the per-block list capacity up to 2048, past
        which kernel B (the direct gather) takes over: uniq_cap 0. A
        triangle box past `max_tri_span` bins doubles the span up to 32,
        past which the ST search takes the exact S x T matrix."""
        cfg = self.cfg
        changes = {}
        for bit, name in ((OVF_SS_CAP, "cap_ss"), (OVF_ST_CAP, "cap_st"),
                          (OVF_SA_CAP, "cap_sa")):
            if ovf & bit:
                changes[name] = self._divisible(
                    int(getattr(cfg, name) * _GROWTH) + 64)
        if ovf & OVF_SPATIAL_BUCKET:
            d, n_sph = ((self.mesh.size, state.layout.n_spheres)
                        if self.mesh is not None else (1, state.spheres.n))
            changes["spatial_capx"] = int(
                (cfg.spatial_capx or spatial_capx_auto(n_sph, d))
                * _GROWTH) + 128
        if ovf & OVF_ST_OCC:
            mpb = int(cfg.max_per_bin * _GROWTH) + 8
            if mpb > 1024:
                raise RuntimeError(
                    "bin occupancy exploded (max_per_bin would exceed "
                    "1024): the simulation has likely diverged: huge "
                    "velocities inflate the CD margins until every sphere "
                    "lands in one bin. Check the time step and stiffness, "
                    "or SetMaxVelocity to cap the margins.")
            changes["max_per_bin"] = mpb
        if ovf & OVF_TRI_BINS:
            if cfg.max_tri_span >= 32:
                changes["st_bruteforce"] = True
            else:
                changes["max_tri_span"] = min(cfg.max_tri_span * 2, 32)
        if ovf & OVF_XOCC:
            mx = int(cfg.cross_mpb * _GROWTH) + 8
            if mx > 2048:
                raise RuntimeError(
                    "cross-class entry-bin occupancy exploded (cross_mpb "
                    "would exceed 2048): the simulation has likely "
                    "diverged, or the class threshold puts nearly "
                    "everything in the large class.")
            changes["cross_mpb"] = mx
        if ovf & OVF_LCAP:
            n_sph = state.spheres.n
            changes["cross_lcap"] = min(
                -(-int(_cross_lcap(cfg, n_sph) * _GROWTH + 128) // 128)
                * 128, max(n_sph, 1))
        if ovf & OVF_UNIQ:
            changes["uniq_cap"] = (cfg.uniq_cap * 2 if cfg.uniq_cap < 2048
                                   else 0)
        if changes:
            lvl = "WARNING" if "st_bruteforce" in changes else "STEP_METRIC"
            self._emit(lvl, f"capacity/strategy growth after overflow "
                            f"0x{ovf:x}: {changes}")
            self._config_changed()
        self.cfg = dataclasses.replace(cfg, **changes)
        if self.mesh is not None:
            # a refresh on a mesh builds its tables anew at the new sizes
            return state
        ss = state.ss.grown(self.cfg.cap_ss)
        if self.cfg.uniq_cap != cfg.uniq_cap:
            ss = ss.replace(**uniq_fields(self.cfg, ss.cap, state.owners.n,
                                          state.device))
        return state.replace(ss=ss, st=state.st.grown(self.cfg.cap_st),
                             sa=state.sa.grown(self.cfg.cap_sa))

    def maybe_shrink(self, state: SimState) -> SimState:
        """Shrink a table whose capacity exceeds 1.4x what its count
        needs (1.25x + 64, rounded up to a coarse quantum so that count
        jitter keeps the chosen capacity; on a mesh the count is D times
        the fullest rank's): every per-row cost of a step scales with
        capacity, not count."""
        cfg = self.cfg
        changes = {}
        for name, cap in (("ss", cfg.cap_ss), ("st", cfg.cap_st),
                          ("sa", cfg.cap_sa)):
            cnt = self._rows_needed(state, name)
            quantum = 512 if name == "ss" else 256
            quantum = max(quantum, 1 << max(0, cnt.bit_length() - 5))
            need = self._divisible(
                max(64, -(-int(cnt * 1.25 + 64) // quantum) * quantum))
            # 1.4: a growth lands at 1.6x the overflowed capacity, which
            # must not shrink again at once
            if cap > 1.4 * need:
                changes["cap_" + name] = need
        if not changes:
            return state
        self.shrinks += 1
        self.timers["shrinks"] += 1
        self.cfg = dataclasses.replace(cfg, **changes)
        self._config_changed()
        return state.replace(**{
            kind: self._shrunk(state, kind, getattr(self.cfg, name))
            for kind, name in _CAPS.items()})

    def _rows_needed(self, state, kind) -> int:
        """The live rows a table's capacity must hold: its count, or on a
        mesh D times the fullest rank's count (each rank holds its home
        rows in cap / D)."""
        t = getattr(state, kind)
        if self.mesh is not None and kind in state.layout.tables:
            return self.mesh.size * int(self.mesh.all_max(t.count))
        return int(t.count)

    def _shrunk(self, state, kind, cap):
        """A table at its new capacity: on a mesh a split table's block is
        cut where it lies, to cap / D rows (its live rows are in front)."""
        t = getattr(state, kind)
        if self.mesh is None or kind not in state.layout.tables:
            return t.shrunk(cap)
        return t.shrunk(cap // self.mesh.size)

    def refresh(self, state: SimState, params: RuntimeParams) -> SimState:
        """Refresh with capacity growth, retried from the retained
        pre-refresh state."""
        for attempt in range(16):
            self.refresh_attempts += 1
            if attempt:
                self.timers["retries"] += 1
            new_state = refresh_contacts(state, params, self.cfg,
                                         mesh=self.mesh)
            ovf = int(new_state.overflow)
            if not ovf & _CAP_OVF:
                self._check_vel(new_state, ovf)
                return new_state
            self.timers["grows"] += 1
            state = self.grow_for(state, ovf)
        raise RuntimeError("contact capacity growth did not converge")

    def advance(self, state: SimState, params: RuntimeParams,
                n_steps: int, update_freq: int) -> SimState:
        """Run n_steps, refreshing the contact tables every K steps: K is
        update_freq, or the tuner's pick with auto_freq on. Whole blocks
        of `fuse` chunks first, each at one K and one bin factor and
        measured (class docstring), then the remainder in chunks of K, the
        last one shorter. Oversized tables shrink after the refresh that
        opens block 1, 64 and every 512th, and in the remainder after
        that of its chunk 1, 64 and every 512th. Each chunk's refresh and
        steps are timed (module docstring)."""
        h = float(params.h)
        done = 0
        blocks = 0
        split = 0
        while done < n_steps:
            k = (self.active_freq if self.auto_freq and self.active_freq
                 else update_freq)
            if n_steps - done >= self.fuse * k:
                blocks += 1
                blk = dict(index=blocks, k=k, bin_factor=self.bin_factor,
                           chunks=self.fuse, steps=self.fuse * k, s=0.0,
                           folded=0, grows0=self.timers["grows"], grows=0)
                for c in range(self.fuse):
                    self._remaining = n_steps - done
                    state = self._chunk(
                        state, params, k, blk["bin_factor"], h, blk,
                        shrink=c == 0 and (blocks in (1, 64)
                                           or blocks % 512 == 0))
                    done += k
            else:
                split += 1
                self._remaining = n_steps - done
                kk = min(k, n_steps - done)
                state = self._chunk(
                    state, params, kk, self.bin_factor, h, None,
                    shrink=split in (1, 64) or split % 512 == 0)
                done += kk
        self._remaining = 0
        return state

    def _chunk(self, state, params, kk, bin_factor, h, blk, shrink):
        """One chunk: the refresh (`max_drift` kk, the bin factor), the
        timers of the chunks before it folded in, a shrink if asked, then
        the K-step window. `blk` is the measured block the chunk belongs
        to, or None."""
        dev = state.device
        params_k = params.replace(
            max_drift=torch.tensor(kk, dtype=I, device=dev),
            bin_factor=torch.tensor(bin_factor, dtype=F, device=dev))
        marks = [time_mark(dev)]
        state = self.refresh(state, params_k)
        # the refresh read its overflow word: earlier chunks' marks are
        # complete
        self.read_timers()
        if blk is not None and "ss_count" not in blk:
            blk["ss_count"] = self._count(state, "ss")
            blk["cap_ss"] = self.cfg.cap_ss
        if shrink:
            state = self.maybe_shrink(state)
        if blk is not None:
            # growths of the block's refreshes so far
            blk["grows"] = self.timers["grows"] - blk["grows0"]
        state = self.timed_steps(state, params_k, kk, h, marks)
        self._pending.append((*marks, kk, blk))
        return state

    def timed_steps(self, state, params, n_steps, h, marks):
        """A chunk's K-step window: `n_steps` steps between two timer
        marks, appended to `marks`. Nothing in it reads back from the
        device."""
        marks.append(time_mark(state.device))
        on_mesh = {} if self.mesh is None else {"mesh": self.mesh}
        state = run_steps(state, params, self.cfg, n_steps, h=h, **on_mesh)
        marks.append(time_mark(state.device))
        return state

    @staticmethod
    def _check_vel(state, ovf: int):
        if ovf & OVF_VEL:
            raise RuntimeError(
                "Simulation diverged: max system velocity "
                f"{float(state.max_vel):.3g} exceeds the error-out "
                "threshold.")
        if ovf & OVF_AVG_CONTACTS:
            raise RuntimeError(
                "Too many contacts per sphere: the simulation likely "
                "diverged or the force model cannot hold the packing.")
