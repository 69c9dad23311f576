"""Per-contact force evaluation and owner-wrench reduction.

Everything constant between two CD refreshes is denormalized into the
contact table once per refresh by ``finalize_table``: geometry, masses,
and premixed material properties. The per-step random-access working set
is then one 16-float kinematic record per owner, gathered per contact.

Tables are sorted by (own_a, own_b), so the A-side wrench sum is a sum
over contiguous owner segments; the B side goes through the refresh-built
permutation ``perm_b`` into own_b order. Both sums of a table run in one
``segred.seg_sum_pair`` (one CUDA kernel launch on the card).

Conventions: the force is computed ON body A (the sphere) in the global
frame, B gets -F; the torque-only force (rolling resistance) adds torque
at the contact point and no linear force; angular accelerations are
assembled in each owner's body frame.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from ..defines import (
    F,
    HUGE_FLOAT,
    I,
    SPHERE_ANALYTICAL_CONTACT,
    SPHERE_MESH_CONTACT,
    SPHERE_SPHERE_CONTACT,
    TINY_FLOAT,
)
from ..models.force_model import ContactContext
from ..state import FSTAT_W, ContactTable, Owners
from . import narrowphase, quat, segred
from .history import pair_key
from .voxel import rel_pos

# sort key of dead rows: above every owner id, and small enough that
# history.pair_key's (key + 1) << 32 stays a positive int64
_DEAD = 2**31 - 2
_PI = 3.14159265358979323846
_PI_SQ = 9.869604401089358

# kinematic record: the only per-step random-access owner data.
# [0:3] vox (i32 as f32, exact below 2^24)  [3:6] loc  [6:10] quat
# [10:13] vel  [13:16] omg
KREC_W = 16


def pack_kinematics(owners: Owners, world_omg: bool = False):
    """(N, 16) packed per-owner kinematic records.

    Two omg frames: the fused SS pass takes WORLD-frame omg
    (rot(quat, omg)), so a contact-point velocity is one cross product;
    ``contact_pass`` takes BODY-frame omg, as its force models expect.
    Mixing the two is wrong by a large margin."""
    omg = owners.omg
    if world_omg:
        omg = quat.rotate(owners.quat, owners.omg)
    return torch.cat(
        [owners.vox.to(F), owners.loc, owners.quat, owners.vel, omg], dim=1)


def premix_names(model) -> Tuple[str, ...]:
    names = []
    for n in model.per_material_props:
        names += [n + ":a", n + ":b"]
    names += list(model.pairwise_props)
    return tuple(names)


def fused_ss(model) -> bool:
    """Whether the model's SS table belongs to the fused force pass
    (kernel B): the built-in Hertz models only. Any other model runs
    ``contact_pass`` on the SS table too."""
    return model.fused_variant in ("hertz_full", "hertz_frictionless")


# ---------------------------------------------------------------------------
# refresh-time table finalization
# ---------------------------------------------------------------------------


def _owner_sort(own_a, own_b, live):
    """Stable argsort by (own_a, own_b), dead rows last. Rows that tie on
    (own_a, own_b) -- up to 9 sphere pairs of two 3-sphere clumps -- keep
    their input order."""
    ka = torch.where(live, own_a, _DEAD)
    kb = torch.where(live, own_b, _DEAD)
    return torch.sort(pair_key(ka, kb), stable=True).indices


def _uniq_layout(own_ids, other_ids, n_owners, ob, uniq_cap):
    """Per-block unique other-owner list and per-row local rank of one
    owner-sorted layout (see ContactTable.uidx).

    own_ids: i32[cap] reducing-side owner, dead rows >= n_owners (trail).
    other_ids: i32[cap] other-side owner (any value on dead rows).
    Returns (uidx f32[cap], uniq i32[n_blocks*uniq_cap] other-owner ids,
    n_owners in unused slots, umax i32[] largest per-block unique
    count)."""
    cap = own_ids.shape[0]
    dev = own_ids.device
    n_blocks = -(-n_owners // ob)
    live = own_ids < n_owners
    blk0 = torch.where(live, own_ids // ob, n_blocks)
    oth0 = torch.where(live, other_ids, -1)
    # the same other owner recurs under different owners of one block:
    # group the rows by (block, other) to rank them
    order = torch.sort(pair_key(blk0, oth0), stable=True).indices
    blk, oth = blk0[order], oth0[order]
    first_row = torch.ones_like(live)
    first_row[1:] = False
    new_blk = first_row.clone()
    new_blk[1:] = blk[1:] != blk[:-1]
    new_oth = first_row.clone()
    new_oth[1:] = oth[1:] != oth[:-1]
    live_z = blk < n_blocks
    is_first = live_z & (new_blk | new_oth)
    grank = torch.cumsum(is_first.to(I), 0, dtype=I) - 1
    base = torch.cummax(torch.where(new_blk & live_z, grank, -(2**30)),
                        0).values
    u = torch.where(live_z, grank - base, 0)
    umax = (torch.where(live_z, u, -1).max() + 1 if cap
            else torch.zeros((), dtype=I, device=dev))
    uc = torch.clamp(u, max=uniq_cap - 1)
    n_slots = n_blocks * uniq_cap
    slot = torch.where(is_first & (u < uniq_cap), blk * uniq_cap + uc,
                       n_slots)
    uniq = torch.full((n_slots + 1,), n_owners, dtype=I, device=dev)
    uniq[slot.long()] = torch.where(live_z, oth, n_owners).to(I)
    uidx = torch.empty(cap, dtype=F, device=dev)
    uidx[order] = uc.to(F)
    return uidx, uniq[:n_slots], umax.to(I)


def finalize_table(kind, table: ContactTable, owners: Owners, spheres,
                   tris, anals, params, model,
                   uniq_cap: int = 0) -> ContactTable:
    """Sort the table by (own_a, own_b), rebuild the B-side permutation
    and denormalize the refresh-constant data.

    The SS table of a fused model (``fused_ss``) gets the slim
    fused-pass record ``fstat_a`` (state.FSTAT_W) and, with `uniq_cap`,
    the unique-fetch layout of kernel B-ub (``uidx``, ``uniq_a``,
    ``uniq_max``, ``blk_start``); every other table the wide ``statics``
    record and premix that ``contact_pass`` reads."""
    n_owners = owners.n
    src_b = {"ss": spheres, "st": tris, "sa": anals}[kind]

    live0 = table.idA >= 0
    jA = torch.where(live0, table.idA, 0).long()
    jB = torch.where(live0, table.idB, 0).long()
    own_a0 = torch.where(live0, spheres.owner[jA], -1)
    own_b0 = torch.where(live0, src_b.owner[jB], -1)
    perm = _owner_sort(own_a0, own_b0, live0)

    idA = table.idA[perm]
    idB = table.idB[perm]
    persist = table.persist[perm]
    own_a = own_a0[perm]
    own_b = own_b0[perm]
    wildcards = {k: v[perm] for k, v in table.wildcards.items()}
    live = idA >= 0
    iA = torch.where(live, idA, 0).long()
    iB = torch.where(live, idB, 0).long()
    mat_a = spheres.mat[iA].long()
    mat_b = src_b.mat[iB].long()
    oa = torch.where(live, own_a, 0).long()
    ob = torch.where(live, own_b, 0).long()

    # B-side permutation: own_b order, ties by own_a
    perm_b = _owner_sort(own_b, own_a, live).to(I)
    own_b_sorted = torch.where(live, own_b, n_owners)[perm_b.long()]

    out = table.replace(idA=idA, idB=idB, persist=persist, own_a=own_a,
                        own_b=own_b, wildcards=wildcards, perm_b=perm_b,
                        own_b_sorted=own_b_sorted)
    if kind == "ss" and fused_ss(model):
        fstat = _fused_statics(live, own_a, iA, iB, oa, ob, mat_a, mat_b,
                               owners, spheres, params)
        out = out.replace(fstat_a=fstat)
        if uniq_cap:
            out = _with_uniq_layout(out, n_owners, uniq_cap)
        return out

    statics = _build_statics(kind, live, iA, iB, oa, ob, own_a, own_b,
                             mat_a, mat_b, owners, spheres, tris, anals)
    premix = {}
    for name in model.per_material_props:
        t = params.mat_props[name]
        premix[name + ":a"] = t[mat_a]
        premix[name + ":b"] = t[mat_b]
    for name in model.pairwise_props:
        premix[name] = params.pair_props[name][mat_a, mat_b]
    return out.replace(statics=statics, premix=premix)


def block_starts(own_a, n_owners):
    """i32[NB+1]: the first row of each block of OB A owners, then the
    first dead row, of an own_a-sorted table (dead rows, own_a -1, last)."""
    from .fused_force import OB, n_blocks_of

    keys = torch.clamp(torch.arange(n_blocks_of(n_owners) + 1, dtype=I,
                                    device=own_a.device) * OB, max=n_owners)
    return torch.searchsorted(torch.where(own_a >= 0, own_a, _DEAD), keys,
                              out_int32=True)


def uniq_layout_plain(table, n_owners, uniq_cap):
    """The unique-fetch lists as tensor code: (uidx, uniq_a, uniq_max,
    blk_start). Kernel B-ub computes each contact once, from the A layout,
    so only the A layout's lists are kept. ``uniq_max`` still covers the
    B layout (own_b_sorted against own_a[perm_b]), as the JAX package's
    two-pass kernel needs both: OVF_UNIQ then rises on the same scenes,
    and the engine's growth protocol takes the same steps."""
    from .fused_force import OB

    live = table.idA >= 0
    uidx, uniq_a, umax_a = _uniq_layout(
        torch.where(live, table.own_a, n_owners),
        torch.where(live, table.own_b, 0), n_owners, OB, uniq_cap)
    live_b = table.own_b_sorted < n_owners
    own_a_b = torch.where(live_b, table.own_a[table.perm_b.long()], 0)
    _, _, umax_b = _uniq_layout(table.own_b_sorted, own_a_b, n_owners, OB,
                                uniq_cap)
    return (uidx, uniq_a, torch.maximum(umax_a, umax_b),
            block_starts(table.own_a, n_owners))


def uniq_layout_cuda(table, n_owners, uniq_cap):
    """The lists launch (``csrc/uniq_layout.cu``): the same four outputs
    as ``uniq_layout_plain``, element for element, from one launch after
    a 4-byte memset of ``uniq_max``. Needs a finalized table: rows sorted
    by (own_a, own_b) and, through perm_b, by (own_b, own_a), dead rows
    last in both orders."""
    from .fused_force import n_blocks_of

    cap = table.cap
    dev = table.own_a.device
    for name in ("own_a", "own_b", "own_b_sorted", "perm_b"):
        _build.require(getattr(table, name), I, (cap,), name)
    if n_owners <= 0 or uniq_cap <= 0:
        raise ValueError(f"lists of {n_owners} owners, width {uniq_cap}")
    nb = n_blocks_of(n_owners)
    uidx = torch.empty((cap,), dtype=F, device=dev)
    uniq_a = torch.empty((nb * uniq_cap,), dtype=I, device=dev)
    blk_start = torch.empty((nb + 1,), dtype=I, device=dev)
    umax = torch.empty((), dtype=I, device=dev)
    uniq_layout_cuda.launches += 1
    _build.check(_build.lib().dem_uniq_layout(
        table.own_a.data_ptr(), table.own_b.data_ptr(),
        table.own_b_sorted.data_ptr(), table.perm_b.data_ptr(), cap,
        n_owners, uniq_cap, uidx.data_ptr(), uniq_a.data_ptr(),
        blk_start.data_ptr(), umax.data_ptr(),
        _build.stream_of(table.own_a)), "dem_uniq_layout")
    return uidx, uniq_a, umax, blk_start


uniq_layout_cuda.launches = 0


def _with_uniq_layout(table, n_owners, uniq_cap):
    """The table with its unique-fetch lists: the lists launch on a CUDA
    table, ``uniq_layout_plain`` on a CPU one."""
    build = (uniq_layout_cuda if table.own_a.is_cuda
             else uniq_layout_plain)
    uidx, uniq_a, umax, blk_start = build(table, n_owners, uniq_cap)
    return table.replace(uidx=uidx, uniq_a=uniq_a, uniq_max=umax,
                         blk_start=blk_start)


def _fused_statics(live, own_a, iA, iB, oa, ob, mat_a, mat_b, owners,
                   spheres, params):
    """The (FSTAT_W, cap) record of the fused SS pass: geometry, m_eff,
    the Schwartz collision time and the pair-premixed E_eff, G_eff, beta,
    mu, Crr (formulas of models/hertz.py, evaluated once per refresh)."""
    Em = params.mat_props["E"]
    num = params.mat_props["nu"]
    Ea2, Eb2 = Em[:, None], Em[None, :]
    nua2, nub2 = num[:, None], num[None, :]
    inv_E2 = (1.0 - nua2 * nua2) / Ea2 + (1.0 - nub2 * nub2) / Eb2
    E_eff2 = 1.0 / torch.clamp(inv_E2, min=TINY_FLOAT)
    inv_G2 = (2.0 * (2.0 - nua2) * (1.0 + nua2) / Ea2
              + 2.0 * (2.0 - nub2) * (1.0 + nub2) / Eb2)
    G_eff2 = 1.0 / torch.clamp(inv_G2, min=TINY_FLOAT)
    zero2 = torch.zeros_like(E_eff2)
    loge2 = torch.log(torch.clamp(params.pair_props.get("CoR", zero2),
                                  min=TINY_FLOAT))
    beta2 = loge2 / torch.sqrt(loge2 * loge2 + _PI_SQ)
    E_eff_c = E_eff2[mat_a, mat_b]
    G_eff_c = G_eff2[mat_a, mat_b]
    beta_c = beta2[mat_a, mat_b]
    mu_c = params.pair_props.get("mu", zero2)[mat_a, mat_b]
    crr_c = params.pair_props.get("Crr", zero2)[mat_a, mat_b]

    ma_c = owners.mass[oa]
    mb_c = owners.mass[ob]
    m_eff_c = ma_c * mb_c / torch.clamp(ma_c + mb_c, min=TINY_FLOAT)
    ra_r = spheres.radius[iA]
    rb_r = spheres.radius[iB]
    r_eff_c = ra_r * rb_r / torch.clamp(ra_r + rb_r, min=TINY_FLOAT)
    R_eff_c = torch.sqrt(r_eff_c)
    kn_s = (4.0 / 3.0) * E_eff_c * torch.sqrt(R_eff_c)
    gn_s = (-2.0 * torch.sqrt((5.0 / 3.0) * m_eff_c * E_eff_c) * beta_c
            * torch.sqrt(torch.sqrt(R_eff_c)))
    d_c = gn_s / (2.0 * torch.clamp(torch.sqrt(kn_s * m_eff_c),
                                    min=TINY_FLOAT))
    t_col = _PI * torch.sqrt(
        m_eff_c / torch.clamp(
            kn_s * torch.clamp(1.0 - d_c * d_c, min=TINY_FLOAT),
            min=TINY_FLOAT))
    t_col_eff = torch.where(d_c >= 1.0, 0.0, t_col)

    fs = torch.cat(
        [
            own_a.to(F)[:, None],
            ra_r[:, None],
            spheres.relpos[iA],
            spheres.relpos[iB],
            rb_r[:, None],
            m_eff_c[:, None],
            t_col_eff[:, None],
            E_eff_c[:, None], G_eff_c[:, None], beta_c[:, None],
            mu_c[:, None], crr_c[:, None],
        ],
        dim=1,
    )
    fs = torch.where(live[:, None], fs, 0.0)
    fs[:, 0] = torch.where(live, own_a.to(F), -1.0)
    assert fs.shape[1] == FSTAT_W
    return fs.T.contiguous()


def _build_statics(kind, live, iA, iB, oa, ob, own_a, own_b, mat_a, mat_b,
                   owners, spheres, tris, anals):
    """The (STATIC_W, cap) record of a non-fused table (state.STATIC_W):
    columns 8:17 hold sphere B's body-frame offset and radius (SS), the
    triangle's 9 body-frame node floats (ST) or the analytical component
    (SA)."""
    cap = live.shape[0]
    dev = live.device
    if kind == "ss":
        rest = [spheres.relpos[iB], spheres.radius[iB][:, None],
                torch.zeros((cap, 5), dtype=F, device=dev)]
    elif kind == "st":
        rest = [tris.nodes[iB].reshape(cap, 9)]
    else:
        rest = [
            anals.objtype[iB].to(F)[:, None],
            anals.relpos[iB],
            anals.direction[iB],
            anals.size[iB][:, 0:1],
            anals.normal_sign[iB][:, None],
        ]
    cols = [
        own_a.to(F)[:, None],
        own_b.to(F)[:, None],
        spheres.relpos[iA],
        spheres.radius[iA][:, None],
        mat_a.to(F)[:, None],
        mat_b.to(F)[:, None],
        *rest,
        owners.mass[oa][:, None],
        owners.mass[ob][:, None],
        owners.moi[oa],
        owners.moi[ob],
        owners.family[oa].to(F)[:, None],
        owners.family[ob].to(F)[:, None],
        torch.zeros((cap, 5), dtype=F, device=dev),
    ]
    statics = torch.where(live[:, None], torch.cat(cols, dim=1), 0.0)
    statics = statics.T.contiguous()
    # row 0 doubles as the live marker (own_a, -1 on dead rows)
    statics[0] = own_a.to(F)
    return statics


# ---------------------------------------------------------------------------
# per-step contact pass (non-fused tables)
# ---------------------------------------------------------------------------


def _unpack_kin(rec):
    return dict(vox=rec[:, 0:3].to(I), loc=rec[:, 3:6], quat=rec[:, 6:10],
                vel=rec[:, 10:13], omg=rec[:, 13:16])


def contact_pass(kind, table: ContactTable, owners: Owners, spheres,
                 tris, anals, params, time, voxel_size, model, krec=None):
    """Evaluate one non-fused contact class ("ss", "st" or "sa") through
    the model's Python function: the SS table of a model without a fused
    variant, and every ST and SA table. `krec` carries BODY-frame omg
    (pack_kinematics default). Rows past the live ones are masked after
    the model runs, and the wildcards it returns are written back on live
    rows only. Returns dict(table, rec_a, rec_b) with the per-contact
    wrench records [force(3), body-frame torque(3)] of each side; the
    table keeps the step's force, torque-only force and contact point
    for queries."""
    live = table.idA >= 0
    iA = torch.where(live, table.idA, 0).long()
    iB = torch.where(live, table.idB, 0).long()
    if krec is None:
        krec = pack_kinematics(owners)

    s = table.statics
    own_a = torch.where(live, table.own_a, 0)
    own_b = torch.where(live, table.own_b, 0)
    A = _unpack_kin(krec[own_a.long()])
    B = _unpack_kin(krec[own_b.long()])
    A["owner_id"], B["owner_id"] = own_a, own_b
    A["mass"], B["mass"] = s[17], s[18]
    A["moi"], B["moi"] = s[19:22].T, s[22:25].T
    A["family"], B["family"] = s[25].to(I), s[26].to(I)
    A["wc"] = {k: v[own_a.long()] for k, v in owners.wildcards.items()}
    B["wc"] = {k: v[own_b.long()] for k, v in owners.wildcards.items()}

    rel_a = quat.rotate(A["quat"], s[2:5].T)
    rad_a = s[5]
    mat_a = s[6].to(I)
    mat_b = s[7].to(I)
    geo_wc_a = {k: v[iA] for k, v in spheres.wildcards.items()}
    d = rel_pos(B["vox"], B["loc"], A["vox"], A["loc"], voxel_size)

    rad_b = torch.full_like(rad_a, HUGE_FLOAT)
    if kind == "ss":
        pos_b = d + quat.rotate(B["quat"], s[8:11].T)
        rad_b = s[11]
        overlap, b2a, cp = narrowphase.sphere_sphere(rel_a, rad_a, pos_b,
                                                     rad_b)
        geo_wc_b = {k: v[iB] for k, v in spheres.wildcards.items()}
        ctype = SPHERE_SPHERE_CONTACT
    elif kind == "st":
        nodes_l = s[8:17].T.reshape(-1, 3, 3)
        nodes = quat.rotate(B["quat"][:, None, :], nodes_l) + d[:, None, :]
        overlap, b2a, cp = narrowphase.sphere_triangle(
            rel_a, rad_a, nodes[:, 0], nodes[:, 1], nodes[:, 2])
        geo_wc_b = {k: v[iB] for k, v in tris.wildcards.items()}
        ctype = SPHERE_MESH_CONTACT
    elif kind == "sa":
        obj_pos = d + quat.rotate(B["quat"], s[9:12].T)
        obj_dir = quat.rotate(B["quat"], s[12:15].T)
        size = torch.cat([s[15:16].T, torch.zeros(
            (s.shape[1], 2), dtype=F, device=s.device)], dim=1)
        overlap, b2a, cp = narrowphase.sphere_analytical(
            rel_a, rad_a, s[8].to(I), obj_pos, obj_dir, size, s[16])
        geo_wc_b = {k: v[iB] for k, v in anals.wildcards.items()}
        ctype = SPHERE_ANALYTICAL_CONTACT
    else:
        raise ValueError(kind)

    cp_a = cp  # relative to owner A's CoM, global orientation
    cp_b = cp - d
    ctx = ContactContext(
        overlap=overlap, b2a=b2a, cp_a=cp_a, cp_b=cp_b,
        a_radius=rad_a, b_radius=rad_b,
        contact_type=torch.full(overlap.shape, ctype, dtype=I,
                                device=overlap.device),
        a_lin_vel=A["vel"], b_lin_vel=B["vel"],
        a_rot_vel=A["omg"], b_rot_vel=B["omg"],
        a_quat=A["quat"], b_quat=B["quat"],
        a_mass=A["mass"], b_mass=B["mass"],
        a_moi=A["moi"], b_moi=B["moi"],
        a_owner=A["owner_id"], b_owner=B["owner_id"],
        a_geo=iA, b_geo=iB,
        a_family=A["family"], b_family=B["family"],
        a_mat=mat_a, b_mat=mat_b,
        time=time, ts=params.h,
        wildcards=table.wildcards,
        a_geo_wc=geo_wc_a, b_geo_wc=geo_wc_b,
        a_owner_wc=A["wc"], b_owner_wc=B["wc"],
        mat_props=params.mat_props, pair_props=params.pair_props,
        premix=table.premix,
    )
    force, torque_only, new_wc = model.fn(ctx)

    live3 = live[:, None]
    force = torch.where(live3, force, 0.0)
    torque_only = torch.where(live3, torque_only, 0.0)
    wildcards = dict(table.wildcards)
    for k, v in new_wc.items():
        wildcards[k] = torch.where(live, v, 0.0)
    new_table = table.replace(
        force=force, torque=torque_only,
        cpoint=torch.where(live3, cp_a, 0.0), wildcards=wildcards)

    f_tot = force + torque_only
    lcp_a = quat.rotate_inv(A["quat"], cp_a)
    tq_a = quat.cross(lcp_a, quat.rotate_inv(A["quat"], f_tot))
    lcp_b = quat.rotate_inv(B["quat"], cp_b)
    tq_b = quat.cross(lcp_b, quat.rotate_inv(B["quat"], -f_tot))
    return dict(table=new_table,
                rec_a=torch.cat([force, tq_a], dim=1),
                rec_b=torch.cat([-force, tq_b], dim=1))


def reduce_wrench_segment(n_owners: int, passes, out=None):
    """Owner wrench sums over the (own_a, own_b)-sorted tables, one
    ``segred.seg_sum_pair`` per table: the A side over contiguous own_a
    segments, the B side through perm_b over own_b_sorted. The first
    table's sums make a new (N, 6) accumulator unless `out` is given;
    every other table's are added onto it in place. Returns the (N, 6)
    accumulator [force, body-frame torque]."""
    for p in passes:
        t = p["table"]
        out = segred.seg_sum_pair(p["rec_a"], t.own_a, p["rec_b"],
                                  t.own_b_sorted, t.perm_b, n_owners,
                                  out=out)
    return out
