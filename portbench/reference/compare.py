"""The numbers that decide ``correct``: the program's outputs (or the
control's) against the float64 reference, at the timed sizes.

Every number is a worst case over the rows or owners compared, as a
share of the reference's largest value of that quantity, except
``pairs_off``, a count. Three rules on the reference leave rows out where
any two correct implementations part by rounding alone:

- a pair whose distance lies within ``pair_band`` of its reach sum (or a
  sphere whose margined overlap with the floor lies within it) may be
  found or not: ``pair_band`` is 8 float32 roundings of a position at
  the box's largest extent;
- a row whose overlap lies within its touch band of 0 (``overlap_band``
  for a sphere pair; ``pair_band`` for a floor row, whose overlap the
  program takes from positions across the box) may keep or drop its
  history; a floor row there, or a row of a model with a step at touch
  (cohesion), its force too: such a row's force and its owners' sums
  and step are left out;
- a row whose rolling-resistance direction is ill-posed
  (``contact.forces``' ``roll_ill``) may turn its rolling torque
  anywhere, and its owners' torques and spins are left out with it.

Two terms are small beside the Hertz force and are held against their
own scale, row by row: the rolling resistance (``roll_err``, where the
configuration has it) and the cohesion (``coh_err``, where it has it).
Each is split off the program's totals with the program's own force at
the reference's contact point, so that the error of the larger terms
does not hide the smaller one.
"""

from __future__ import annotations

import torch

from . import contact, pairs
from .follow import carried, keys

F32_EPS = 2.0 ** -23


def bands(scene) -> dict:
    return dict(pair_band=8 * F32_EPS * float(max(scene.dims)),
                overlap_band=64 * F32_EPS * 2 * scene.radius)


def _norms(x):
    x = x.double()
    return torch.sqrt((x * x).sum(-1)) if x.dim() > 1 else x.abs()


def _rel(diff, ref, floor):
    """max |diff| (row norms) over the larger of max |ref| and `floor`,
    the quantity's own scale in the scene (a clump's weight for a force),
    so that a table with no contact does not divide by nought."""
    if diff.numel() == 0:
        return 0.0
    den = float(_norms(ref).max()) if ref.numel() else 0.0
    return float(_norms(diff).max()) / max(den, floor)


def floors(scene) -> dict:
    """The scale of each compared quantity: a clump's weight, its torque
    at one radius, gravity's change of velocity (and of spin at one
    radius) in one step, one step's age of a contact; a picometre of
    tangential displacement or of displacement."""
    w = scene.mass * scene.g_mag
    gh = scene.g_mag * scene.h
    return dict(force=w, torque=w * scene.radius, dtan=1e-12,
                age=scene.h, vel=gh, omg=gh / scene.radius, disp=1e-12)


def pairs_off(scene, ref, prog_pairs, band) -> tuple:
    """(count, detail): pairs found on one side only and outside the
    band, plus pairs the program lists twice."""
    f = ref["found"]
    pos, reach, margin = f["pos"], f["reach"], f["margin"]
    detail = {}
    total = 0
    for kind in ("ss", "sa"):
        if kind == "ss":
            a, b = prog_pairs["ss"]
            ra, rb, rgap = f["ss"]
        else:
            a, b = prog_pairs["sa"], None
            ra, rb, rgap = f["sa"][0], None, f["sa"][1]
        pk = keys(scene, kind, a, b)
        rk = keys(scene, kind, ra, rb)
        dup = pk.numel() - torch.unique(pk).numel()
        extra = ~torch.isin(pk, rk)
        missing = ~torch.isin(rk, pk)
        if kind == "ss":
            g_extra = pairs.pair_gap(pos, reach, a[extra], b[extra])
        else:
            g_extra = pairs.plane_gap(scene, pos, margin)[a[extra]]
        off_e = int((g_extra.abs() >= band).sum())
        off_m = int((rgap[missing].abs() >= band).sum())
        detail[kind] = dict(program=int(pk.numel()), reference=int(rk.numel()),
                            extra=int(extra.sum()), missing=int(missing.sum()),
                            extra_off=off_e, missing_off=off_m, twice=dup)
        total += off_e + off_m + dup
    return total, detail


def rows_errors(scene, ref, old, prog_rows, bands_):
    """Each row of the program against the reference evaluated on the
    same pair with the history the reference carries itself: for the
    sphere pairs force_err, torque_err and history_err; for the floor
    rows, whose overlap the program takes from differences of positions
    across the box, floor_err (the worst of the three)."""
    errs = {}
    detail = {}
    for kind in ("ss", "sa"):
        p = prog_rows[kind]
        a, b = p["a"], p.get("b")
        r = contact.forces_blocked(scene, kind, ref["owners"], a, b,
                                   carried(scene, kind, old[kind], a, b),
                                   f_other=p["force"])
        fl = floors(scene)
        ok_f = ~touch_ill(scene, kind, r, bands_)
        f = _rel((p["force"].double() - r["force"])[ok_f], r["force"],
                 fl["force"])
        ok_t = ~r["roll_ill"] & ok_f
        t = max(_rel((p[q].double() - r[q])[ok_t], r[q], fl["torque"])
                for q in (("tq_a", "tq_b") if kind == "ss" else ("tq_a",)))
        ok_h = r["overlap"].abs() >= touch_band(kind, bands_)
        h = max(_rel((p["wc"][:, :3].double() - r["wc"][:, :3])[ok_h],
                     r["wc"][:, :3], fl["dtan"]),
                _rel((p["wc"][:, 3].double() - r["wc"][:, 3])[ok_h],
                     r["wc"][:, 3], fl["age"]))
        if kind == "ss":
            errs.update(force_err=f, torque_err=t, history_err=h)
        else:
            errs["floor_err"] = max(f, t, h)
        detail[kind] = dict(rows=int(a.numel()),
                            roll_ill=int(r["roll_ill"].sum()),
                            touch_ill=int((~ok_f).sum()),
                            near_touch=int((~ok_h).sum()),
                            in_contact=int((r["overlap"] > 0).sum()),
                            force=f, torque=t, history=h)
        if scene.crr > 0:
            ro, n_roll = roll_error(scene, kind, p, r, ok_t)
            errs["roll_err"] = max(errs.get("roll_err", 0.0), ro)
            detail[kind].update(roll=ro, rolling=n_roll)
        if scene.coh_owner is not None:
            co, n_coh = cohesion_error(r, ok_f)
            errs["coh_err"] = max(errs.get("coh_err", 0.0), co)
            detail[kind].update(cohesion=co, cohesive=n_coh)
    return errs, detail


def roll_error(scene, kind, p, r, ok):
    """(error, rows rolling): the program's rolling torque (its body
    torques less those its own force gives at the contact point) against
    the reference's direction and switch at the program's own normal
    force (whose error ``force_err`` holds), over rows in contact where
    the direction is well-posed, each over Crr |F_n| R of its row (at
    least Crr times a clump's weight times R)."""
    ok = ok & (r["overlap"] > 0)
    fl = floors(scene)
    scale = scene.crr * scene.radius * torch.clamp(r["fn_other"].abs(),
                                                   min=fl["force"])
    worst = 0.0
    for q in (("a", "b") if kind == "ss" else ("a",)):
        roll_p = p[f"tq_{q}"].double() - r[f"tq_{q}_other"]
        d = _norms(roll_p - r[f"roll_{q}_other"]) / scale
        if bool(ok.any()):
            worst = max(worst, float(d[ok].max()))
    n_roll = int((_norms(r["roll_a_other"])[ok] > 0).sum())
    return worst, n_roll


def cohesion_error(r, ok):
    """(error, rows cohesive): the program's normal force against the
    reference's, over rows where the reference's cohesion pulls and the
    overlap is clear of its touch band, each over its row's cohesion
    (Cohesion m_eff times the wildcards)."""
    on = ok & (r["f_coh"] > 0)
    if not bool(on.any()):
        return 0.0, 0
    d = (r["fn_other"] - r["fn"]).abs() / r["f_coh"]
    return float(d[on].max()), int(on.sum())


def touch_band(kind, bands_) -> float:
    """How far from 0 rounding moves a row's overlap: a floor row's
    overlap comes from positions across the box (``pair_band``), a
    sphere pair's from a neighbour's (``overlap_band``)."""
    return bands_["pair_band" if kind == "sa" else "overlap_band"]


def touch_ill(scene, kind, r, bands_):
    """Rows whose overlap lies within their touch band of 0 where the
    force is ill-posed there: every floor row (the damping grows as the
    overlap's fourth root, and the floor's overlap carries the rounding
    of the box's extent), and every row of a model with a step at touch
    (the cohesion term)."""
    if kind == "ss" and scene.coh_owner is None:
        return torch.zeros_like(r["roll_ill"])
    return r["overlap"].abs() < touch_band(kind, bands_)


def excluded(scene, ref, rows_ill):
    """Owners touched by a row of the reference for which `rows_ill`
    holds: their sums and their step are not compared."""
    out = torch.zeros(scene.n + 1, dtype=torch.bool, device=scene.dev)
    for kind, r in ref["rows"].items():
        ill = rows_ill(kind, r)
        out[r["oa"][ill]] = True
        out[r["ob"][ill]] = True
    return out[:scene.n]


def owner_errors(scene, ref, prog_F, prog_T, after):
    """wrench_err over the clumps' sums, integ_err over the clumps after
    the step (velocity, spin and displacement, orientation as a unit
    quaternion). A sum is held against the scale of its terms: the
    largest contact force (torque) of the reference, and the change of
    velocity (spin) that force gives a clump in one step, since a clump
    held between its neighbours sums large forces to a small one."""
    n = scene.n
    fl = floors(scene)
    rows = ref["rows"].values()
    f_max = max([float(_norms(r["force"]).max()) for r in rows
                 if r["force"].numel()] + [fl["force"]])
    t_max = max([float(_norms(r[q]).max()) for r in rows
                 for q in ("tq_a", "tq_b") if r[q].numel()]
                + [fl["torque"]])
    b = bands(scene)
    near = excluded(scene, ref, lambda k, r: touch_ill(scene, k, r, b))
    keep = ~(near | excluded(scene, ref, lambda k, r: r["roll_ill"]))
    F, T = ref["F"][:n], ref["T"][:n]
    w = max(_rel((prog_F[:n].double() - F)[~near], F, f_max),
            _rel((prog_T[:n].double() - T)[keep], T[keep], t_max))
    ra, o = ref["after"], ref["owners"]
    dv = ra["vel"] - o["vel"][:n]
    dw = ra["omg"] - o["omg"][:n]
    moi = float(scene.moi.double().min())
    i = max(_rel((after["vel"].double() - ra["vel"])[~near], dv,
                 max(fl["vel"], f_max / scene.mass * scene.h)),
            _rel((after["omg"].double() - ra["omg"])[keep], dw[keep],
                 max(fl["omg"], t_max / moi * scene.h)),
            _rel((after["disp"].double() - ra["disp"])[~near], ra["disp"],
                 fl["disp"]),
            float((after["quat"].double() - ra["quat"])[keep].abs().max())
            if bool(keep.any()) else 0.0)
    return dict(wrench_err=w, integ_err=i), dict(
        spin_excluded=int((~keep).sum()), touch_excluded=int(near.sum()))


def start_error(scene, start: dict, seed_vel, lattice_pos) -> float:
    """The program's initial clumps against the scene the configuration
    and the seed make: positions in radii, velocities as a share of the
    largest drawn, orientations, masses and moments."""
    n = scene.n
    dt = torch.float64
    pos = lattice_pos.to(dt)
    e = [float((start["pos"][:n].double() - pos).abs().max())
         / scene.radius,
         _rel(start["vel"][:n].double() - seed_vel.to(dt), seed_vel, 1e-12),
         float((start["quat"][:n].double()
                - torch.tensor([1.0, 0, 0, 0], dtype=dt,
                               device=pos.device)).abs().max()),
         float((start["mass"][:n].double() - scene.mass).abs().max())
         / scene.mass,
         float((start["moi"][:n].double() - scene.moi.double()).abs().max()
               / scene.moi.double().min())]
    return max(e)


def compare(scene, ref, old, prog) -> tuple:
    """(numbers, detail) of one check."""
    b = bands(scene)
    numbers = {}
    numbers["pairs_off"], d_pairs = pairs_off(scene, ref, prog["pairs"],
                                              b["pair_band"])
    errs, d_rows = rows_errors(scene, ref, old, prog["rows"], b)
    numbers.update(errs)
    errs, d_own = owner_errors(scene, ref, prog["F"], prog["T"],
                               prog["after"])
    numbers.update(errs)
    return numbers, dict(pairs=d_pairs, rows=d_rows, owners=d_own, **b)
