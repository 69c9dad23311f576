"""The reference's refresh and first step, from the program's state.

``follow`` takes the owner state a refresh started from and the contact
history it carried (the program's own state: the reference follows the
program step by step), and computes in its own dtype what the timed path
computes there: the pair sets, each contact's force, torques and new
history, every owner's wrench, and the owners after one step.
"""

from __future__ import annotations

import torch

from . import contact, pairs, quat
from .scene import Scene


def to_dtype(owners_in: dict, scene: Scene) -> dict:
    """Owner positions, poses and velocities in the scene's dtype."""
    dt = scene.dt
    return dict(pos=owners_in["pos"].to(dt), quat=owners_in["quat"].to(dt), vel=owners_in["vel"].to(dt),
                omg=owners_in["omg"].to(dt))


def keys(scene, kind, a, b):
    """int64 pair keys: a * S + b for sphere pairs, the sphere id for the
    floor."""
    return a if kind == "sa" else a * scene.n_spheres + b


def carried(scene, kind, old: dict, a, b):
    """The history each row (a, b) inherits: that of the old table's row
    with the same pair, zero where there is none."""
    wc = torch.zeros((a.shape[0], 4), dtype=scene.dt, device=scene.dev)
    if old["a"].numel() == 0 or a.numel() == 0:
        return wc
    ko = keys(scene, kind, old["a"], old["b"])
    so, idx = torch.sort(ko)
    k = keys(scene, kind, a, b)
    pos = torch.searchsorted(so, k).clamp(max=so.shape[0] - 1)
    hit = so[pos] == k
    src = old["wc"].to(scene.dt)[idx[pos]]
    return torch.where(hit[:, None], src, wc)


def refresh(scene, owners):
    """The pair sets of a refresh from these owners: SS (a, b, gap) and
    SA (a, gap), with the positions and reaches they came from."""
    pos, reach, margin = pairs.sphere_state(scene, owners)
    a, b, gap = pairs.ss_pairs(scene, pos, reach)
    sa, sgap = pairs.sa_pairs(scene, pos, margin)
    return dict(ss=(a, b, gap), sa=(sa, sgap), pos=pos, reach=reach,
                margin=margin)


def wrench(scene, rows: dict):
    """(N + 1, 3) force and (N + 1, 3) body torque sums of every owner
    over the given rows of each table."""
    n = scene.n + 1
    F = torch.zeros((n, 3), dtype=scene.dt, device=scene.dev)
    T = torch.zeros((n, 3), dtype=scene.dt, device=scene.dev)
    for r in rows.values():
        F.index_add_(0, r["oa"], r["force"])
        F.index_add_(0, r["ob"], -r["force"])
        T.index_add_(0, r["oa"], r["tq_a"])
        T.index_add_(0, r["ob"], r["tq_b"])
    return F, T


def integrate(scene, owners, F, T):
    """One centered-difference step of the clumps: velocity from the
    wrench and gravity, position by the new velocity, orientation by the
    new body-frame spin (no gyroscopic term, as DEM-Engine)."""
    n = scene.n
    vel = owners["vel"][:n] + (F[:n] / scene.mass + scene.g) * scene.h
    omg = owners["omg"][:n] + T[:n] / scene.moi * scene.h
    disp = vel * scene.h
    q = quat.integrate(owners["quat"][:n], omg, scene.h)
    return dict(vel=vel, omg=omg, disp=disp, quat=q)


def follow(scene, owners_in: dict, old: dict, pairs=None):
    """Everything the reference computes for one refresh and the step
    after it, from the owners both start from (positions decoded to
    float64 from the solver's voxel codec). `old` holds the old tables'
    live rows: for "ss" and "sa", dict(a, b, wc (C, 4)). With `pairs`
    (``capture.plain``'s: ss (a, b), sa a), the step runs on those pairs
    in place of the reference's own search."""
    owners = to_dtype(owners_in, scene)
    if pairs is None:
        found = refresh(scene, owners)
    else:
        found = dict(ss=(*pairs["ss"], None), sa=(pairs["sa"], None))
    rows = {}
    a, b, _ = found["ss"]
    rows["ss"] = contact.forces_blocked(
        scene, "ss", owners, a, b, carried(scene, "ss", old["ss"], a, b))
    rows["ss"].update(a=a, b=b)
    sa = found["sa"][0]
    rows["sa"] = contact.forces_blocked(
        scene, "sa", owners, sa, None,
        carried(scene, "sa", old["sa"], sa, None))
    rows["sa"].update(a=sa, b=None)
    F, T = wrench(scene, rows)
    return dict(found=found, rows=rows, F=F, T=T, owners=owners,
                after=integrate(scene, owners, F, T))
