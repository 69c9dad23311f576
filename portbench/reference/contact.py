"""Hertz-Mindlin contact forces with friction history and rolling
resistance (DEM-Engine's built-in model), and the optional cohesion term
of the cohesive configuration, row by row.

A row is a sphere against a sphere ("ss") or against the floor ("sa").
Forces act on body A in the world frame, B gets -F; the torques are in
each owner's body frame; the rolling resistance is a torque-only force
at the contact point. The history is the tangential displacement and
the contact's age, zero while the bodies do not overlap.
"""

from __future__ import annotations

import math

import torch

from . import quat

TINY = 1e-12
TWO_SQRT_5_6 = 2.0 * math.sqrt(5.0 / 6.0)


def _dot(a, b):
    return (a * b).sum(1)


def _norm(a):
    return torch.sqrt((a * a).sum(1))


def geometry(scene, kind, owners, a, b):
    """Normal b2a, overlap, contact point from A's and B's centre of
    mass, and the kinematics of both owners at each row."""
    oa = scene.owner_of(a)
    qa = owners["quat"][oa]
    rel_a = quat.rotate(qa, scene.rel_of(a))
    rA = torch.full_like(rel_a[:, 0], scene.radius)
    if kind == "ss":
        ob = scene.owner_of(b)
        d = owners["pos"][ob] - owners["pos"][oa]
        qb = owners["quat"][ob]
        pos_b = d + quat.rotate(qb, scene.rel_of(b))
        dd = rel_a - pos_b
        dist = _norm(dd)
        b2a = dd / torch.clamp(dist, min=TINY)[:, None]
        overlap = 2.0 * scene.radius - dist
        cp = pos_b + b2a * (scene.radius - 0.5 * overlap)[:, None]
        vb, wb = owners["vel"][ob], quat.rotate(qb, owners["omg"][ob])
        mb = torch.full_like(rA, scene.mass)
        rB = rA
    else:
        # the floor: a fixed plane z = floor_z, normal +z, at rest
        ob = torch.full_like(oa, scene.n)
        centre = owners["pos"][oa] + rel_a
        dist = centre[:, 2] - scene.floor_z
        overlap = scene.radius - dist
        b2a = torch.zeros_like(rel_a)
        b2a[:, 2] = 1.0
        cp = rel_a - b2a * (dist + 0.5 * overlap)[:, None]
        # the floor's point under the contact: its owner sits at z =
        # floor_z under the box's centre
        plane = torch.tensor([scene.dims[0] / 2, scene.dims[1] / 2,
                              scene.floor_z], dtype=scene.dt,
                             device=scene.dev)
        d = plane[None, :] - owners["pos"][oa]
        qb = torch.zeros_like(qa)
        qb[:, 0] = 1.0
        vb = torch.zeros_like(rel_a)
        wb = torch.zeros_like(rel_a)
        mb = torch.full_like(rA, scene.plane_mass)
        rB = None
    return dict(oa=oa, ob=ob, qa=qa, qb=qb, b2a=b2a, overlap=overlap, cp=cp,
                cp_b=cp - d, va=owners["vel"][oa],
                wa=quat.rotate(qa, owners["omg"][oa]), vb=vb, wb=wb,
                ma=torch.full_like(rA, scene.mass), mb=mb, rA=rA, rB=rB)


def forces(scene, kind, owners, a, b, wc_old, f_other=None):
    """Per row: force on A (world), body torques on A and B, the new
    history (dtan xyz, age), the overlap, and `roll_ill`: rows whose
    rolling-resistance direction (the relative spin velocity at the
    contact point) is below a thousandth of the spin velocities it is
    the difference of, where any two roundings point it differently.

    Also `f_coh`, the cohesion's pull (0 without it). With `f_other`
    (rows, 3), another side's force on A: `tq_a_other`, `tq_b_other`,
    the body torques that force gives at this contact point; `fn_other`
    and `fn`, its and the reference's components along b2a;
    `roll_a_other`, `roll_b_other`, the rolling torques the reference
    gives where its normal force is that side's (the same direction and
    switch, Crr |fn_other|). So that the other side's rolling torque and
    cohesion can be split off its totals and held apart from the error
    of its normal force."""
    g = geometry(scene, kind, owners, a, b)
    b2a, cp, cp_b, overlap = g["b2a"], g["cp"], g["cp_b"], g["overlap"]
    va_rot = quat.cross(g["wa"], cp)
    vb_rot = quat.cross(g["wb"], cp_b)
    vel_b2a = (g["va"] + va_rot) - (g["vb"] + vb_rot)
    proj = _dot(vel_b2a, b2a)
    vrel_tan = vel_b2a - b2a * proj[:, None]

    m_eff = g["ma"] * g["mb"] / (g["ma"] + g["mb"])
    rA = g["rA"]
    r_eff = rA if g["rB"] is None else rA * g["rB"] / (rA + g["rB"])
    in_contact = overlap > 0
    ovl = torch.clamp(overlap, min=0.0)
    sqrt_rd = torch.sqrt(ovl * r_eff)
    Sn = 2.0 * scene.E_eff * sqrt_rd
    k_n = 2.0 / 3.0 * Sn
    gamma_n = TWO_SQRT_5_6 * scene.beta * torch.sqrt(Sn * m_eff)
    f_n = k_n * ovl + gamma_n * proj
    force = b2a * f_n[:, None]
    f_mag = _norm(force)
    f_coh = torch.zeros_like(f_mag)

    h = scene.h
    dtan = wc_old[:, 0:3] + vrel_tan * h
    dtan = dtan - b2a * _dot(dtan, b2a)[:, None]
    age = wc_old[:, 3] + h
    # Schwartz collision time with R_eff = sqrt(r_eff)
    R_eff = torch.sqrt(r_eff)
    kn_s = 4.0 / 3.0 * scene.E_eff * torch.sqrt(R_eff)
    gn_s = (-2.0 * torch.sqrt(5.0 / 3.0 * m_eff * scene.E_eff) * scene.beta
            * torch.sqrt(torch.sqrt(R_eff)))
    d_c = gn_s / (2.0 * torch.sqrt(kn_s * m_eff))
    t_col = math.pi * torch.sqrt(
        m_eff / (kn_s * torch.clamp(1.0 - d_c * d_c, min=TINY)))
    past = torch.where(d_c < 1.0, age > t_col, torch.ones_like(in_contact))
    v_rot = vb_rot - va_rot
    v_rot_mag = _norm(v_rot)
    roll_on = (scene.crr > 0) & past & (v_rot_mag > TINY)
    roll_dir = torch.where(
        roll_on[:, None], v_rot / torch.clamp(v_rot_mag, min=TINY)[:, None],
        0.0)
    torque_only = roll_dir * (scene.crr * f_mag)[:, None]
    roll_ill = (scene.crr > 0) & in_contact & (
        (v_rot_mag < 1e-3 * (_norm(va_rot) + _norm(vb_rot)))
        | ((age - t_col).abs() < 1e-6 * t_col))

    kt = 8.0 * scene.G_eff * sqrt_rd
    gt = -TWO_SQRT_5_6 * scene.beta * torch.sqrt(m_eff * kt)
    tf = -kt[:, None] * dtan - gt[:, None] * vrel_tan
    ft = _norm(tf)
    ft_max = scene.mu * f_mag
    clamp = (ft > ft_max) & (ft > TINY)
    scl = torch.where(clamp, ft_max / torch.clamp(ft, min=TINY), 1.0)
    tf = torch.where((ft > TINY)[:, None], tf * scl[:, None], 0.0)
    safe_kt = torch.where(kt > TINY, kt, 1.0)
    dtan = torch.where(clamp[:, None],
                       (tf + gt[:, None] * vrel_tan) / (-safe_kt[:, None]),
                       dtan)
    if scene.mu > 0:
        force = force + tf
    if scene.coh_owner is not None:
        scale = scene.coh_owner[g["oa"]] * scene.coh_owner[g["ob"]]
        scale = scale * scene.stick * (scene.stick if kind == "ss" else 1.0)
        f_coh = torch.where(in_contact, scene.cohesion * m_eff * scale, 0.0)
        force = force - b2a * f_coh[:, None]
    on = in_contact[:, None]
    force = torch.where(on, force, 0.0)
    torque_only = torch.where(on, torque_only, 0.0)
    wc_new = torch.where(on, torch.cat([dtan, age[:, None]], 1), 0.0)
    def body_torques(f):
        return (quat.rotate_inv(g["qa"], quat.cross(cp, f)),
                quat.rotate_inv(g["qb"], quat.cross(cp_b, -f)))

    tq_a, tq_b = body_torques(force + torque_only)
    out = dict(force=force, tq_a=tq_a, tq_b=tq_b, wc=wc_new,
               overlap=overlap, roll_ill=roll_ill, oa=g["oa"], ob=g["ob"],
               f_coh=f_coh)
    if f_other is not None:
        f_other = f_other.to(scene.dt)
        out["tq_a_other"], out["tq_b_other"] = body_torques(f_other)
        out["fn_other"] = _dot(f_other, b2a)
        out["fn"] = _dot(force, b2a)
        roll_other = torch.where(
            on, roll_dir * (scene.crr * out["fn_other"].abs())[:, None], 0.0)
        out["roll_a_other"], out["roll_b_other"] = body_torques(roll_other)
    return out


def forces_blocked(scene, kind, owners, a, b, wc_old, f_other=None,
                   block=1 << 21):
    """``forces`` over rows in blocks, so that the float64 temporaries of
    millions of rows fit beside the captured state."""
    n = a.shape[0]
    starts = list(range(0, n, block)) or [0]
    parts = [forces(scene, kind, owners, a[i:i + block],
                    None if b is None else b[i:i + block],
                    wc_old[i:i + block],
                    None if f_other is None else f_other[i:i + block])
             for i in starts]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
