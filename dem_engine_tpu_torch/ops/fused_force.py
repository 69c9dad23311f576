"""Fused sphere–sphere force step (kernel B and its variants).

``fused_step_ss`` evaluates every SS contact of the (own_a, own_b)-sorted
table once: narrow phase, Hertz normal force with damping, tangential
history spring with the Coulomb clamp, and rolling resistance past the
premixed collision time. It returns the per-owner wrench sums and the
table with its new wildcards; with `extras` also the per-contact force,
torque-only force and contact point (query outputs) in the table's
``force``/``torque``/``cpoint``.

On CUDA tensors ``csrc/fused_force.cu`` computes each contact once and
writes the A-side and B-side wrench rows; kernel A
(``segred.seg_sum_pair``) sums the A rows over own_a and the B rows
through perm_b over own_b_sorted in one launch. ``fused_wrench_ss``
returns those sums as one (N, 6) tensor, the step's accumulator, which
``forces.reduce_wrench_segment`` adds the other tables onto.
A table with unique-fetch rows (``uniq_a``, built at refresh when
``SolverConfig.uniq_cap`` > 0, by the lists launch on the card:
``forces.uniq_layout_cuda``) runs kernel B-ub, which reads each block's
distinct B owners once instead of one B record per row, and each
block's rows from ``blk_start`` instead of searching own_a. The
extras ride in the same launch (``hertz_extras_cuda``). On CPU tensors
``fused_step_ss_plain`` runs the same math as tensor code and sums with
``index_add_``.

The kinematic records `krec` carry WORLD-frame omg
(``forces.pack_kinematics(world_omg=True)``): a contact-point velocity
is then one cross product.
"""

from __future__ import annotations

import torch

from .. import _build
from ..defines import F, I, TINY_FLOAT
from ..state import FSTAT_W, WCB_W
from . import quat, segred

_TWO_SQRT_5_6 = 2.0 * (5.0 / 6.0) ** 0.5

#: A owners per block of kernel B-ub (the unique lists are per block)
OB = 128


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def hertz_rows(fstat, wc, Ak, Bk, h, voxel_size, with_friction,
               extras=False):
    """The per-contact math over (cap,) rows.

    fstat (FSTAT_W, cap) slim statics, wc (4, cap) wildcards or None,
    Ak/Bk (cap, 16) kinematic records of the A and B owners. Returns
    (rec_a (cap, 6), rec_b (cap, 6), wc_new (4, cap) or None): the wrench
    [force, body-frame torque] on each side and the new wildcards; with
    `extras` a fourth item (force, torque_only, cpoint), each (cap, 3):
    force and torque-only force on A where in contact, the contact point
    relative to owner A's CoM on every live row."""
    s = fstat
    avox, aloc, aq = Ak[:, 0:3], Ak[:, 3:6], Ak[:, 6:10]
    avel, aomg = Ak[:, 10:13], Ak[:, 13:16]
    bvox, bloc, bq = Bk[:, 0:3], Bk[:, 3:6], Bk[:, 6:10]
    bvel, bomg = Bk[:, 10:13], Bk[:, 13:16]
    radA, relA = s[1][:, None], s[2:5].T
    relB, radB = s[5:8].T, s[8][:, None]
    m_eff, t_col_eff = s[9][:, None], s[10][:, None]
    E_eff, G_eff, beta = s[11][:, None], s[12][:, None], s[13][:, None]
    live = s[0][:, None] >= 0.0

    # B position relative to owner A's CoM (exact voxel-int difference)
    d = (bvox - avox) * voxel_size + (bloc - aloc)
    rel_a = quat.rotate(aq, relA)
    pos_b = d + quat.rotate(bq, relB)

    dd = rel_a - pos_b
    dist = torch.sqrt(_dot(dd, dd))
    safe = torch.clamp(dist, min=TINY_FLOAT)
    b2a = dd * (1.0 / safe)
    overlap = radA + radB - dist
    cp = pos_b + b2a * (radB - overlap * 0.5)
    cp_b = cp - d
    in_contact = overlap > 0.0
    ovl = torch.clamp(overlap, min=0.0)

    va = quat.cross(aomg, cp)
    vb = quat.cross(bomg, cp_b)
    vel_b2a = (avel + va) - (bvel + vb)
    proj = _dot(vel_b2a, b2a)
    vrel_tan = vel_b2a - b2a * proj

    r_eff = radA * radB / torch.clamp(radA + radB, min=TINY_FLOAT)
    sqrt_Rd = torch.sqrt(ovl * r_eff)
    Sn = 2.0 * E_eff * sqrt_Rd
    k_n = (2.0 / 3.0) * Sn
    gamma_n = _TWO_SQRT_5_6 * beta * torch.sqrt(Sn * m_eff)
    f_n = k_n * ovl + gamma_n * proj
    force = b2a * f_n
    torque_only = torch.zeros_like(force)
    wc_new = None

    if with_friction:
        mu, Crr = s[14][:, None], s[15][:, None]
        dtan = wc[0:3].T + vrel_tan * h
        disp_proj = _dot(dtan, b2a)
        dtan = dtan - b2a * disp_proj
        dtime = wc[3][:, None] + h

        past = dtime > t_col_eff
        v_rot = vb - va
        v_rot_mag = torch.sqrt(_dot(v_rot, v_rot))
        f_mag = torch.sqrt(_dot(force, force))
        roll_on = (Crr > 0.0) & past & (v_rot_mag > TINY_FLOAT)
        torque_only = torch.where(
            roll_on,
            v_rot * (Crr * f_mag / torch.clamp(v_rot_mag, min=TINY_FLOAT)),
            0.0)

        kt = 8.0 * G_eff * sqrt_Rd
        gt = -_TWO_SQRT_5_6 * beta * torch.sqrt(m_eff * kt)
        tf = dtan * (-kt) - vrel_tan * gt
        ft = torch.sqrt(_dot(tf, tf))
        ft_max = f_mag * mu
        clamp = (ft > ft_max) & (ft > TINY_FLOAT)
        scl = torch.where(clamp, ft_max / torch.clamp(ft, min=TINY_FLOAT),
                          1.0)
        tf = torch.where(ft > TINY_FLOAT, tf * scl, 0.0)
        dtan = torch.where(
            clamp,
            (tf + vrel_tan * gt) * (-1.0 / torch.where(kt > TINY_FLOAT, kt,
                                                       1.0)),
            dtan)
        force = force + torch.where(mu > 0.0, tf, 0.0)
        keep = in_contact & live
        wc_new = torch.cat([torch.where(keep, dtan, 0.0),
                            torch.where(keep, dtime, 0.0)], dim=1).T

    on = in_contact & live
    force = torch.where(on, force, 0.0)
    torque_only = torch.where(on, torque_only, 0.0)
    f_tot = force + torque_only
    # body-frame torque: rot_inv(cross(cp, f)) == cross(rot_inv(cp),
    # rot_inv(f))
    tq_a = quat.rotate_inv(aq, quat.cross(cp, f_tot))
    tq_b = quat.rotate_inv(bq, quat.cross(cp_b, -f_tot))
    rec_a = torch.cat([force, torch.where(live, tq_a, 0.0)], dim=1)
    rec_b = torch.cat([-force, torch.where(live, tq_b, 0.0)], dim=1)
    if extras:
        return rec_a, rec_b, wc_new, (force, torque_only,
                                      torch.where(live, cp, 0.0))
    return rec_a, rec_b, wc_new


def _wc_names(table, model):
    if model.fused_variant != "hertz_full":
        return ()
    names = tuple(sorted(table.wildcards))
    if len(names) != WCB_W:
        raise ValueError(f"hertz_full expects {WCB_W} contact wildcards, "
                         f"got {names}")
    return names


def _new_table(table, names, wc_new, ext=None):
    if names:
        wildcards = dict(table.wildcards)
        for k, name in enumerate(names):
            wildcards[name] = wc_new[k]
        table = table.replace(wildcards=wildcards)
    if ext is not None:
        table = table.replace(force=ext[0], torque=ext[1], cpoint=ext[2])
    return table


def n_blocks_of(n_owners):
    return -(-n_owners // OB)


def uniq_records(table, krec):
    """The B-side records of the unique-fetch path as its plain version
    builds them: each block's distinct B owners gathered once (the slab),
    then expanded per row through ``uidx``."""
    n = krec.shape[0]
    ub = table.uniq_a.shape[0] // n_blocks_of(n)
    slab = krec[torch.clamp(table.uniq_a, max=n - 1).long()]
    live = table.fstat_a[0] >= 0.0
    blk = torch.where(live, table.own_a, 0).long() // OB
    return slab[blk * ub + table.uidx.long()]


def fused_step_ss_plain(table, owners, h, voxel_size, model, krec,
                        extras=False):
    """Plain version of the fused step: hertz_rows + index_add_. A table
    with unique-fetch rows takes its B records from the per-block slab,
    as kernel B-ub does."""
    names = _wc_names(table, model)
    live = table.fstat_a[0] >= 0.0
    oa = torch.where(live, table.own_a, 0).long()
    ob = torch.where(live, table.own_b, 0).long()
    wc = (torch.stack([table.wildcards[n] for n in names])
          if names else None)
    Bk = uniq_records(table, krec) if table.uniq_a.shape[0] else krec[ob]
    out = hertz_rows(table.fstat_a, wc, krec[oa], Bk, h, voxel_size,
                     bool(names), extras)
    rec_a, rec_b, wc_new = out[:3]
    n = owners.n
    acc = torch.zeros((n, 6), dtype=F, device=krec.device)
    acc.index_add_(0, oa, rec_a)
    acc.index_add_(0, ob, rec_b)
    return (acc[:, :3], acc[:, 3:],
            _new_table(table, names, wc_new, out[3] if extras else None))


def _launch(table, krec, h, voxel_size, model, ub, extras):
    """One launch of kernel B (`ub` False) or B-ub, with or without the
    extras outputs. Returns (rec_a, rec_b, wc_new or None, extras or
    None)."""
    names = _wc_names(table, model)
    cap = table.cap
    n = krec.shape[0]
    dev = krec.device
    _build.require(table.fstat_a, F, (FSTAT_W, cap), "fstat_a")
    _build.require(krec, F, (n, 16), "krec")
    if krec.data_ptr() % 16:
        raise ValueError("krec must be 16-byte aligned")
    wc_in = [table.wildcards[nm] for nm in names]
    for nm, t in zip(names, wc_in):
        _build.require(t, F, (cap,), f"wildcard {nm}")
    rec_a = torch.empty((cap, 6), dtype=F, device=dev)
    rec_b = torch.empty((cap, 6), dtype=F, device=dev)
    wc_out = torch.empty((WCB_W if names else 0, cap), dtype=F, device=dev)
    ext = (tuple(torch.empty((cap, 3), dtype=F, device=dev)
                 for _ in range(3)) if extras else None)
    wc_ptrs = [t.data_ptr() for t in wc_in] or [None] * 4
    out_ptrs = (rec_a.data_ptr(), rec_b.data_ptr(),
                wc_out.data_ptr() if names else None,
                *([t.data_ptr() for t in ext] if extras else [None] * 3))
    lib = _build.lib()
    stream = _build.stream_of(krec)
    if ub:
        n_blocks = n_blocks_of(n)
        width = table.uniq_a.shape[0] // n_blocks
        _build.require(table.blk_start, I, (n_blocks + 1,), "blk_start")
        _build.require(table.uidx, F, (cap,), "uidx")
        _build.require(table.uniq_a, I, (n_blocks * width,), "uniq_a")
        if not 0 < width <= 2048:
            raise ValueError(f"unique list width {width} outside (0, 2048]")
        _build.check(lib.dem_fused_hertz_ub(
            table.fstat_a.data_ptr(), cap, *wc_ptrs, krec.data_ptr(), n,
            table.blk_start.data_ptr(), table.uidx.data_ptr(),
            table.uniq_a.data_ptr(), width, float(h), float(voxel_size),
            int(bool(names)), *out_ptrs, stream), "dem_fused_hertz_ub")
    else:
        _build.require(table.own_b, I, (cap,), "own_b")
        _build.check(lib.dem_fused_hertz(
            table.fstat_a.data_ptr(), cap, *wc_ptrs, krec.data_ptr(),
            table.own_b.data_ptr(), float(h), float(voxel_size),
            int(bool(names)), *out_ptrs, stream), "dem_fused_hertz")
    return rec_a, rec_b, (wc_out if names else None), ext


def hertz_rows_cuda(table, krec, h, voxel_size, model):
    """Kernel B alone: (rec_a, rec_b, wc_new) of every row, as
    ``hertz_rows`` over the gathered records computes them."""
    hertz_rows_cuda.launches += 1
    return _launch(table, krec, h, voxel_size, model, False, False)[:3]


def hertz_rows_ub_cuda(table, krec, h, voxel_size, model):
    """Kernel B-ub alone: the same (rec_a, rec_b, wc_new), the B records
    read from the table's per-block unique lists."""
    hertz_rows_ub_cuda.launches += 1
    return _launch(table, krec, h, voxel_size, model, True, False)[:3]


def hertz_extras_cuda(table, krec, h, voxel_size, model):
    """Kernel B or B-ub (as the table's layout says) with the query
    outputs: (rec_a, rec_b, wc_new, (force, torque_only, cpoint))."""
    hertz_extras_cuda.launches += 1
    return _launch(table, krec, h, voxel_size, model,
                   bool(table.uniq_a.shape[0]), True)


hertz_rows_cuda.launches = 0
hertz_rows_ub_cuda.launches = 0
hertz_extras_cuda.launches = 0


def fused_wrench_ss(table, owners, h, voxel_size, model, krec,
                    extras=False):
    """One fused SS force step. Returns (acc (N, 6) owner wrench sums
    [force, body-frame torque], new_table). `h` is the step size as a
    host float. With `extras` the new table also carries the per-contact
    force/torque/cpoint."""
    if not table.fstat_a.is_cuda:
        f_acc, t_acc, new_table = fused_step_ss_plain(
            table, owners, h, voxel_size, model, krec, extras)
        return torch.cat([f_acc, t_acc], dim=1), new_table
    if extras:
        rec_a, rec_b, wc_new, ext = hertz_extras_cuda(table, krec, h,
                                                      voxel_size, model)
    elif table.uniq_a.shape[0]:
        rec_a, rec_b, wc_new = hertz_rows_ub_cuda(table, krec, h,
                                                  voxel_size, model)
        ext = None
    else:
        rec_a, rec_b, wc_new = hertz_rows_cuda(table, krec, h, voxel_size,
                                               model)
        ext = None
    acc = segred.seg_sum_pair(rec_a, table.own_a, rec_b, table.own_b_sorted,
                              table.perm_b, owners.n)
    return acc, _new_table(table, _wc_names(table, model), wc_new, ext)


def fused_step_ss(table, owners, h, voxel_size, model, krec, extras=False):
    """``fused_wrench_ss`` with the sums split: (f_acc (N,3), t_acc (N,3),
    new_table), two views of one tensor."""
    acc, new_table = fused_wrench_ss(table, owners, h, voxel_size, model,
                                     krec, extras)
    return acc[:, :3], acc[:, 3:], new_table
