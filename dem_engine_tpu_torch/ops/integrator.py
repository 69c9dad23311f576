"""Explicit time integration with family prescriptions.

The three velocity pass-on policies:

  forward euler      : position advances with the OLD velocity
  centered difference: position advances with the NEW velocity
  extended taylor    : position advances with the midpoint velocity

and the prescription semantics: velocity prescriptions dictate
components (skipping true physics for them), position/quaternion
prescriptions pin the pose, added accelerations stack on top of contact
accelerations without polluting the queryable acc arrays. The reserved
family 255 is always fixed. The position and orientation branches run
only where some family sets their channel.
"""

from __future__ import annotations

import torch

from ..defines import RESERVED_FAMILY, TimeIntegrator
from ..models.prescriptions import PrescriptionTables
from ..state import Owners
from . import quat as quat_ops
from . import voxel


class OwnerView:
    """Read-only view handed to family-change conditions: f32 positions
    plus raw state tensors.

    Frame: `pos` is LBF-RELATIVE (the solver's internal frame, origin at
    the domain's lower corner), NOT user coordinates: add the solver's
    `_lbf` offset to user-frame thresholds before comparing. It is
    decoded on first use."""

    def __init__(self, owners: Owners, voxel_size, time):
        self._owners = owners
        self._voxel_size = voxel_size
        self._pos = None
        self.vel = owners.vel
        self.omg = owners.omg
        self.quat = owners.quat
        self.family = owners.family
        self.mass = owners.mass
        self.moi = owners.moi
        self.wildcards = owners.wildcards
        self.time = time

    @property
    def pos(self):
        if self._pos is None:
            self._pos = voxel.decode_f32(self._owners.vox, self._owners.loc,
                                         self._voxel_size)
        return self._pos


def integrate_owners(owners: Owners, f_acc, t_acc, params,
                     tables: PrescriptionTables, voxel_size: float,
                     integrator: TimeIntegrator, time) -> Owners:
    """One step of every owner. `tables` are evaluated at the step's
    start time (``PrescriptionTables.at``)."""
    h = params.h
    lin_acc = f_acc / owners.mass[:, None]
    ang_acc = t_acc / owners.moi

    pidx, pmatch = tables.lookup(owners.family)
    pm = pmatch[:, None]
    # added accelerations (do not appear in the queryable acc arrays)
    extra_acc = torch.where(pm & tables.acc_mask[pidx], tables.acc[pidx],
                            0.0)
    extra_aacc = torch.where(pm & tables.ang_acc_mask[pidx],
                             tables.ang_acc[pidx], 0.0)
    # "soft" prescriptions assign the component, then physics integrates
    # on top
    v_base = torch.where(pm & tables.lin_vel_soft_mask[pidx],
                         tables.lin_vel_soft[pidx], owners.vel)
    o_base = torch.where(pm & tables.rot_vel_soft_mask[pidx],
                         tables.rot_vel_soft[pidx], owners.omg)
    vel_unc = v_base + (lin_acc + params.gravity[None, :] + extra_acc
                        + owners.ext_acc) * h
    omg_unc = o_base + (ang_acc + extra_aacc + owners.ext_ang_acc) * h

    v_presc_mask = pm & tables.lin_vel_mask[pidx]
    o_presc_mask = pm & tables.rot_vel_mask[pidx]
    vel_new = torch.where(v_presc_mask, tables.lin_vel[pidx], vel_unc)
    omg_new = torch.where(o_presc_mask, tables.rot_vel[pidx], omg_unc)

    fixed = (owners.family == RESERVED_FAMILY)[:, None]
    vel_new = torch.where(fixed, 0.0, vel_new)
    omg_new = torch.where(fixed, 0.0, omg_new)
    v_presc_mask = v_presc_mask | fixed
    o_presc_mask = o_presc_mask | fixed

    if integrator == TimeIntegrator.FORWARD_EULER:
        v_pass = torch.where(v_presc_mask, vel_new, owners.vel)
        o_pass = torch.where(o_presc_mask, omg_new, owners.omg)
    elif integrator == TimeIntegrator.CENTERED_DIFFERENCE:
        v_pass, o_pass = vel_new, omg_new
    elif integrator == TimeIntegrator.EXTENDED_TAYLOR:
        v_pass = torch.where(v_presc_mask, vel_new,
                             owners.vel + 0.5 * (vel_new - owners.vel))
        o_pass = torch.where(o_presc_mask, omg_new,
                             owners.omg + 0.5 * (omg_new - owners.omg))
    else:
        raise ValueError(integrator)

    # position update through the voxel codec; soft position
    # prescriptions re-seat the base position first
    vox, loc = owners.vox, owners.loc
    if tables.has_lin_pos_soft:
        sp_mask = pm & tables.lin_pos_soft_mask[pidx]
        svox, sloc = voxel.encode(tables.lin_pos_soft[pidx], voxel_size)
        vox = torch.where(sp_mask, svox, vox)
        loc = torch.where(sp_mask, sloc, loc)
    vox, loc = voxel.advance(vox, loc, v_pass * h, voxel_size)
    # a position prescription pins components to an LBF-relative position
    if tables.has_lin_pos:
        p_mask = pm & tables.lin_pos_mask[pidx]
        tvox, tloc = voxel.encode(tables.lin_pos[pidx], voxel_size)
        vox = torch.where(p_mask, tvox, vox)
        loc = torch.where(p_mask, tloc, loc)

    # orientation; soft quaternion prescriptions re-seat the base first
    q_base = owners.quat
    if tables.has_quat_soft:
        qs_mask = pmatch & tables.quat_soft_mask[pidx, 0]
        q_base = torch.where(qs_mask[:, None],
                             quat_ops.normalize(tables.quat_soft[pidx]),
                             q_base)
    q_new = quat_ops.integrate(q_base, o_pass, h)
    if tables.has_quat:
        q_mask = pmatch & tables.quat_mask[pidx, 0]
        q_new = quat_ops.normalize(
            torch.where(q_mask[:, None], tables.quat[pidx], q_new))
    return owners.replace(vox=vox, loc=loc, quat=q_new, vel=vel_new,
                          omg=omg_new, lin_acc=lin_acc, ang_acc=ang_acc)


def apply_family_changes(owners: Owners, rules, voxel_size, time) -> Owners:
    """ChangeFamilyWhen rules. Every rule tests the family the owner had
    when the rules started, so rules do not cascade within a step."""
    if not rules:
        return owners
    view = OwnerView(owners, voxel_size, time)
    family = owners.family
    for rule in rules:
        cond = rule.condition(view, time)
        family = torch.where(cond & (owners.family == rule.from_family),
                             rule.to_family, family)
    return owners.replace(family=family)
