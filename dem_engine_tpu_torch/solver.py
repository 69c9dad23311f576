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
from .state import (
    OVF_AVG_CONTACTS,
    OVF_LCAP,
    OVF_SA_CAP,
    OVF_SS_CAP,
    OVF_ST_CAP,
    OVF_ST_OCC,
    OVF_TRI_BINS,
    OVF_UNIQ,
    OVF_VEL,
    OVF_XOCC,
    RuntimeParams,
    SimState,
    SolverConfig,
)

_GROWTH = 1.6
_CAP_OVF = (OVF_SS_CAP | OVF_ST_CAP | OVF_SA_CAP | OVF_TRI_BINS
            | OVF_ST_OCC | OVF_UNIQ | OVF_XOCC | OVF_LCAP)


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
                     voxel_size: float) -> dict:
    """Sphere positions, reaches and grid of the SS pair search, plus
    the margins and the velocity measure the rest of the refresh uses."""
    owners, spheres = state.owners, state.spheres
    pos, margin, absv, raw_absv = sphere_pos_margins(owners, spheres,
                                                     params, voxel_size)
    reach = spheres.radius + margin
    bin_size, nb = binning.build_grid(params.domain, reach.max(),
                                      params.bin_factor)
    # CD axis relabel: the axis with the most bins becomes the slowest
    # (flat-bin major) axis. Distances do not depend on the axis order;
    # only the bin order of the sorted table does.
    perm = torch.argsort(nb, stable=True)
    return dict(pos=pos, margin=margin, raw_absv=raw_absv,
                pos_cd=pos[:, perm], reach=reach, owner=spheres.owner,
                family=owners.family[spheres.owner.long()],
                family_mask=params.family_mask, bin_size=bin_size,
                nb_cd=nb[perm], dom_cd=params.domain[perm], perm=perm)


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
    owners, spheres, tris = state.owners, state.spheres, state.tris
    dev = state.device
    nodes = tri_world_nodes(owners, tris, cfg.voxel_size)
    arm = _norm(tris.nodes).max(dim=-1).values
    m_t = owner_margin(owners, tris.owner, arm, params)
    tri_fam = owners.family[tris.owner.long()]
    if cfg.st_bruteforce:
        # facets too large for bin enumeration: O(S*T) candidates in
        # world axes, compacted like the sphere-analytical pairs
        ovl, _, _ = narrowphase.sphere_triangle(
            q["pos"][:, None, :], spheres.radius[:, None],
            nodes[None, :, 0], nodes[None, :, 1], nodes[None, :, 2])
        ovl_m = ovl + q["margin"][:, None] + m_t[None, :]
        tA, tB, n_st = binning.find_pairs_sa(
            ovl_m, spheres.owner, q["family"], tris.owner, tri_fam,
            params.family_mask, cfg.cap_st)
        return tA, tB, n_st, torch.zeros((), dtype=I, device=dev)
    if cfg.cd_two_class:
        tab = binning.build_sphere_table(
            q["pos_cd"], q["reach"], q["owner"], q["family"],
            q["bin_size"], q["nb_cd"], max(spheres.n, 1))
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


def refresh_contacts(state: SimState, params: RuntimeParams,
                     cfg: SolverConfig, mark=None) -> SimState:
    """One refresh of the contact tables. `mark`, if given, is called
    with "table", "pairs", "history" and "finalize" at the single-grid SS
    search's stage boundaries (after the sorted table, kernel C, the
    history carry and the SS table's finalize)."""
    mark = mark or _no_mark
    vs = cfg.voxel_size
    owners, spheres, tris, anals = (state.owners, state.spheres,
                                    state.tris, state.anals)
    wc_names = cfg.force_model.contact_wildcards
    dev = state.device

    q = ss_search_inputs(state, params, vs)
    pos, margin, raw_absv = q["pos"], q["margin"], q["raw_absv"]
    sph_family = q["family"]
    # uncapped |v| for the divergence guard; a non-finite value trips it
    max_vel = torch.where(torch.all(torch.isfinite(raw_absv)),
                          raw_absv.max(), torch.inf).to(F)

    if cfg.cd_two_class:
        idA, idB, n_ss, tab, overflow = two_class_pairs(
            q, spheres.radius <= params.cls_thr, params, cfg, spheres.n)
    else:
        idA, idB, n_ss, tab = sweep.find_pairs_ss(
            q["pos_cd"], q["reach"], spheres.owner, sph_family,
            params.family_mask, q["bin_size"], q["nb_cd"], cfg.cap_ss,
            mark=mark)
        overflow = torch.zeros((), dtype=I, device=dev)
    mark("pairs")
    persistency = cfg.use_persistency
    ss, lost_ss = history.carry_history(
        state.ss, idA, idB, torch.clamp(n_ss, max=cfg.cap_ss).to(I),
        wc_names, persistency)
    if persistency:
        ss = _mark_persistent(ss, sph_family, sph_family, params)
    mark("history")
    overflow |= torch.where(n_ss > cfg.cap_ss, OVF_SS_CAP, 0).to(I)
    ss = forces.finalize_table("ss", ss, owners, spheres, tris, anals,
                               params, cfg.force_model,
                               uniq_cap=cfg.uniq_cap)
    if persistency:
        ss, ovf = _capped(ss, cfg.cap_ss, OVF_SS_CAP)
        overflow |= ovf
    if cfg.uniq_cap:
        overflow |= torch.where(ss.uniq_max > cfg.uniq_cap, OVF_UNIQ,
                                0).to(I)
    mark("finalize")

    st, lost_st = state.st, torch.zeros((), dtype=I, device=dev)
    if tris.n > 0:
        tA, tB, n_st, ovf_st = st_pairs(state, params, cfg, q, tab)
        st, lost_st = history.carry_history(
            state.st, tA, tB, torch.clamp(n_st, max=cfg.cap_st).to(I),
            wc_names, persistency)
        if persistency:
            st = _mark_persistent(st, sph_family,
                                  owners.family[tris.owner.long()], params)
        st = forces.finalize_table("st", st, owners, spheres, tris, anals,
                                   params, cfg.force_model)
        if persistency:
            st, ovf = _capped(st, cfg.cap_st, OVF_ST_CAP)
            overflow |= ovf
        overflow |= ovf_st | torch.where(n_st > cfg.cap_st, OVF_ST_CAP,
                                         0).to(I)

    sa, lost_sa = state.sa, torch.zeros((), dtype=I, device=dev)
    if anals.n > 0:
        own_b = anals.owner.long()
        base_b = voxel.decode_f32(owners.vox[own_b], owners.loc[own_b], vs)
        obj_pos = base_b + quat.rotate(owners.quat[own_b], anals.relpos)
        obj_dir = quat.rotate(owners.quat[own_b], anals.direction)
        m_a = owner_margin(owners, anals.owner,
                           torch.zeros_like(anals.normal_sign), params)
        ovl, _, _ = narrowphase.sphere_analytical(
            pos[:, None, :], spheres.radius[:, None],
            anals.objtype[None, :], obj_pos[None], obj_dir[None],
            anals.size[None], anals.normal_sign[None, :],
        )
        ovl_m = ovl + margin[:, None] + m_a[None, :]
        aA, aB, n_sa = binning.find_pairs_sa(
            ovl_m, spheres.owner, sph_family, anals.owner,
            owners.family[own_b], params.family_mask, cfg.cap_sa)
        sa, lost_sa = history.carry_history(
            state.sa, aA, aB, torch.clamp(n_sa, max=cfg.cap_sa).to(I),
            wc_names, persistency)
        if persistency:
            sa = _mark_persistent(sa, sph_family, owners.family[own_b],
                                  params)
        sa = forces.finalize_table("sa", sa, owners, spheres, tris, anals,
                                   params, cfg.force_model)
        if persistency:
            sa, ovf = _capped(sa, cfg.cap_sa, OVF_SA_CAP)
            overflow |= ovf
        overflow |= torch.where(n_sa > cfg.cap_sa, OVF_SA_CAP, 0).to(I)

    overflow |= torch.where(~(max_vel <= params.error_out_vel), OVF_VEL,
                            0).to(I)
    avg_cnt = 2.0 * ss.count.to(F) / max(spheres.n, 1)
    overflow |= torch.where(avg_cnt > params.error_out_avg_contacts,
                            OVF_AVG_CONTACTS, 0).to(I)
    return state.replace(
        ss=ss, st=st, sa=sa, overflow=overflow, max_vel=max_vel,
        lost_contacts=state.lost_contacts + lost_ss + lost_st + lost_sa,
    )


# ---------------------------------------------------------------------------
# dynamics step
# ---------------------------------------------------------------------------


def dynamics_step(state: SimState, params: RuntimeParams,
                  cfg: SolverConfig, h: float | None = None,
                  tables: PrescriptionTables | None = None,
                  mark=None) -> SimState:
    """One step. `h` is params.h as a host float and `tables` the static
    prescription tables (``static_tables``); run_steps passes both once
    per chunk so a step reads nothing back from the device. The tables
    are evaluated at the step's start time, the family-change rules
    applied to the owners that come out of the integrator. `mark`, if
    given, is called with "forces" after the contact passes and with
    "reduced" after the ST and SA sums."""
    mark = mark or _no_mark
    if h is None:
        h = float(params.h)
    if tables is None:
        tables = static_tables(cfg.prescriptions, state.device)
    owners = state.owners
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
            kind, wide[kind], owners, state.spheres, state.tris,
            state.anals, params, state.time, cfg.voxel_size, model,
            krec=krec)
        wide[kind] = p["table"]
        passes.append(p)
    mark("forces")
    if passes:
        acc = forces.reduce_wrench_segment(n, passes, out=acc)
    elif acc is None:
        acc = torch.zeros((n, 6), dtype=F, device=state.device)
    f_acc, t_acc = acc[:, :3], acc[:, 3:]
    mark("reduced")

    owners = integrator.integrate_owners(
        owners, f_acc, t_acc, params, tables.at(state.time),
        cfg.voxel_size, cfg.integrator, state.time)
    owners = integrator.apply_family_changes(
        owners, cfg.family_changes, cfg.voxel_size, state.time)
    return state.replace(owners=owners, ss=wide["ss"], st=wide["st"],
                         sa=wide["sa"], time=state.time + params.h,
                         step=state.step + 1)


def run_steps(state: SimState, params: RuntimeParams, cfg: SolverConfig,
              n_steps: int, h: float | None = None) -> SimState:
    """`n_steps` steps. `h` is float(params.h), read here unless given:
    with it given, the steps read nothing back from the device."""
    if h is None:
        h = float(params.h)
    tables = static_tables(cfg.prescriptions, state.device)
    for _ in range(n_steps):
        state = dynamics_step(state, params, cfg, h, tables)
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

    def __init__(self, cfg: SolverConfig, fuse: int = 8):
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
                changes[name] = int(getattr(cfg, name) * _GROWTH) + 64
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
        ss = state.ss.grown(self.cfg.cap_ss)
        if self.cfg.uniq_cap != cfg.uniq_cap:
            ss = ss.replace(**uniq_fields(self.cfg, ss.cap, state.owners.n,
                                          state.device))
        return state.replace(ss=ss, st=state.st.grown(self.cfg.cap_st),
                             sa=state.sa.grown(self.cfg.cap_sa))

    def maybe_shrink(self, state: SimState) -> SimState:
        """Shrink a table whose capacity exceeds 1.4x what its count
        needs (1.25x + 64, rounded up to a coarse quantum so that count
        jitter keeps the chosen capacity): every per-row cost of a step
        scales with capacity, not count."""
        cfg = self.cfg
        changes = {}
        for name, cap in (("ss", cfg.cap_ss), ("st", cfg.cap_st),
                          ("sa", cfg.cap_sa)):
            cnt = int(getattr(state, name).count)
            quantum = 512 if name == "ss" else 256
            quantum = max(quantum, 1 << max(0, cnt.bit_length() - 5))
            need = max(64, -(-int(cnt * 1.25 + 64) // quantum) * quantum)
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
        return state.replace(ss=state.ss.shrunk(self.cfg.cap_ss),
                             st=state.st.shrunk(self.cfg.cap_st),
                             sa=state.sa.shrunk(self.cfg.cap_sa))

    def refresh(self, state: SimState, params: RuntimeParams) -> SimState:
        """Refresh with capacity growth, retried from the retained
        pre-refresh state."""
        for attempt in range(16):
            self.refresh_attempts += 1
            if attempt:
                self.timers["retries"] += 1
            new_state = refresh_contacts(state, params, self.cfg)
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
            blk["ss_count"], blk["cap_ss"] = int(state.ss.count), state.ss.cap
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
        state = run_steps(state, params, self.cfg, n_steps, h=h)
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
