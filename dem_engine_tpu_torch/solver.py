"""The solver engine: contact-table refresh + dynamics stepping.

``refresh_contacts`` rebuilds the contact tables every K steps (sphere
pairs through kernel C, sphere-floor pairs by brute force, history
carried, tables sorted and denormalized); ``dynamics_step`` then runs K
times against the frozen tables (the fused SS pass, kernel B, with its
wrench sums, kernel A; the SA table through ``contact_pass`` and kernel
A; integration). Contact margins sized by K·h·velocity keep the stale
table exact.

Host protocol: ``Engine.refresh`` reads one overflow word per refresh.
On a capacity overflow it grows the table (or the unique-fetch lists)
and re-runs the refresh from the retained pre-refresh state; nothing on
this path updates a state tensor in place, so the retry is lossless.
``Engine.advance`` shrinks oversized tables after the refresh of its
first, 64th and every 512th chunk (``maybe_shrink``).
"""

from __future__ import annotations

import dataclasses

import torch

from .defines import F, I
from .models.prescriptions import PrescriptionTables
from .ops import binning, forces, history, integrator, narrowphase, quat
from .ops import sweep, voxel
from .initializer import ss_uniq_rows
from .ops.fused_force import fused_wrench_ss
from .state import (
    OVF_AVG_CONTACTS,
    OVF_SA_CAP,
    OVF_SS_CAP,
    OVF_UNIQ,
    OVF_VEL,
    RuntimeParams,
    SimState,
    SolverConfig,
)

_GROWTH = 1.6
_CAP_OVF = OVF_SS_CAP | OVF_SA_CAP | OVF_UNIQ


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


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
                nb_cd=nb[perm])


def refresh_contacts(state: SimState, params: RuntimeParams,
                     cfg: SolverConfig) -> SimState:
    vs = cfg.voxel_size
    owners, spheres, anals = state.owners, state.spheres, state.anals
    wc_names = cfg.force_model.contact_wildcards
    dev = state.device

    q = ss_search_inputs(state, params, vs)
    pos, margin, raw_absv = q["pos"], q["margin"], q["raw_absv"]
    sph_family = q["family"]
    # uncapped |v| for the divergence guard; a non-finite value trips it
    max_vel = torch.where(torch.all(torch.isfinite(raw_absv)),
                          raw_absv.max(), torch.inf).to(F)

    idA, idB, n_ss = sweep.find_pairs_ss(
        q["pos_cd"], q["reach"], spheres.owner, sph_family,
        params.family_mask, q["bin_size"], q["nb_cd"], cfg.cap_ss)
    ss, lost_ss = history.carry_history(
        state.ss, idA, idB, torch.clamp(n_ss, max=cfg.cap_ss).to(I),
        wc_names)
    overflow = torch.where(n_ss > cfg.cap_ss, OVF_SS_CAP, 0).to(I)
    ss = forces.finalize_table("ss", ss, owners, spheres, anals, params,
                               cfg.force_model, uniq_cap=cfg.uniq_cap)
    if cfg.uniq_cap:
        overflow |= torch.where(ss.uniq_max > cfg.uniq_cap, OVF_UNIQ,
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
            wc_names)
        sa = forces.finalize_table("sa", sa, owners, spheres, anals,
                                   params, cfg.force_model)
        overflow |= torch.where(n_sa > cfg.cap_sa, OVF_SA_CAP, 0).to(I)

    overflow |= torch.where(~(max_vel <= params.error_out_vel), OVF_VEL,
                            0).to(I)
    avg_cnt = 2.0 * ss.count.to(F) / max(spheres.n, 1)
    overflow |= torch.where(avg_cnt > params.error_out_avg_contacts,
                            OVF_AVG_CONTACTS, 0).to(I)
    return state.replace(
        ss=ss, sa=sa, overflow=overflow, max_vel=max_vel,
        lost_contacts=state.lost_contacts + lost_ss + lost_sa,
    )


# ---------------------------------------------------------------------------
# dynamics step
# ---------------------------------------------------------------------------


def dynamics_step(state: SimState, params: RuntimeParams,
                  cfg: SolverConfig, h: float | None = None,
                  tables: PrescriptionTables | None = None) -> SimState:
    """One step. `h` is params.h as a host float and `tables` the
    prescription tables; run_steps passes both once per chunk so a step
    reads nothing back from the device."""
    if h is None:
        h = float(params.h)
    if tables is None:
        tables = PrescriptionTables(cfg.prescriptions, state.device)
    owners = state.owners
    model = cfg.force_model
    n = owners.n

    # one (n, 6) wrench accumulator per step: the SS sums create it and
    # the SA sums add onto it in place
    ss = state.ss
    if state.spheres.n > 0 and ss.cap > 0:
        krec_w = forces.pack_kinematics(owners, world_omg=True)
        acc, ss = fused_wrench_ss(ss, owners, h, cfg.voxel_size, model,
                                  krec_w)
    else:
        acc = torch.zeros((n, 6), dtype=F, device=state.device)
    f_acc, t_acc = acc[:, :3], acc[:, 3:]
    sa = state.sa
    if state.anals.n > 0 and sa.cap > 0 and state.spheres.n > 0:
        krec = forces.pack_kinematics(owners)  # body-frame omg
        p = forces.contact_pass(
            "sa", sa, owners, state.spheres, state.anals, params,
            state.time, cfg.voxel_size, model, krec=krec)
        sa = p["table"]
        forces.reduce_wrench_segment(n, [p], out=acc)

    owners = integrator.integrate_owners(
        owners, f_acc, t_acc, params, tables, cfg.voxel_size,
        cfg.integrator, state.time)
    owners = integrator.apply_family_changes(
        owners, cfg.family_changes, cfg.voxel_size, state.time)
    return state.replace(owners=owners, ss=ss, sa=sa,
                         time=state.time + params.h, step=state.step + 1)


def run_steps(state: SimState, params: RuntimeParams, cfg: SolverConfig,
              n_steps: int) -> SimState:
    h = float(params.h)
    tables = PrescriptionTables(cfg.prescriptions, state.device)
    for _ in range(n_steps):
        state = dynamics_step(state, params, cfg, h, tables)
    return state


# ---------------------------------------------------------------------------
# host-side engine
# ---------------------------------------------------------------------------


class Engine:
    """The refresh/step/grow/shrink protocol with a fixed CD cadence."""

    def __init__(self, cfg: SolverConfig):
        self.cfg = cfg
        #: refreshes run, retries after a capacity growth included (one
        #: pair-search launch each)
        self.refresh_attempts = 0
        self.shrinks = 0

    def grow_for(self, state: SimState, ovf: int) -> SimState:
        """Grow the capacities named by the overflow bits. A unique-fetch
        overflow doubles the per-block list capacity up to 2048, past
        which kernel B (the direct gather) takes over: uniq_cap 0."""
        cfg = self.cfg
        changes = {}
        if ovf & OVF_SS_CAP:
            changes["cap_ss"] = int(cfg.cap_ss * _GROWTH) + 64
        if ovf & OVF_SA_CAP:
            changes["cap_sa"] = int(cfg.cap_sa * _GROWTH) + 64
        if ovf & OVF_UNIQ:
            changes["uniq_cap"] = (cfg.uniq_cap * 2 if cfg.uniq_cap < 2048
                                   else 0)
        self.cfg = dataclasses.replace(cfg, **changes)
        ss = state.ss.grown(self.cfg.cap_ss)
        if self.cfg.uniq_cap != cfg.uniq_cap:
            n = state.owners.n
            rows = ss_uniq_rows(self.cfg, n)
            ss = ss.replace(
                uniq_a=torch.full((rows,), n, dtype=I, device=state.device),
                uidx=torch.zeros((ss.cap if rows else 0,), dtype=F,
                                 device=state.device))
        return state.replace(ss=ss, sa=state.sa.grown(self.cfg.cap_sa))

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
        self.cfg = dataclasses.replace(cfg, **changes)
        return state.replace(ss=state.ss.shrunk(self.cfg.cap_ss),
                             st=state.st.shrunk(self.cfg.cap_st),
                             sa=state.sa.shrunk(self.cfg.cap_sa))

    def refresh(self, state: SimState, params: RuntimeParams) -> SimState:
        """Refresh with capacity growth, retried from the retained
        pre-refresh state."""
        for _ in range(16):
            self.refresh_attempts += 1
            new_state = refresh_contacts(state, params, self.cfg)
            ovf = int(new_state.overflow)
            if not ovf & _CAP_OVF:
                self._check_vel(new_state, ovf)
                return new_state
            state = self.grow_for(state, ovf)
        raise RuntimeError("contact capacity growth did not converge")

    def advance(self, state: SimState, params: RuntimeParams,
                n_steps: int, update_freq: int) -> SimState:
        """Run n_steps, refreshing the contact tables every update_freq
        steps (the last chunk may be shorter), and shrinking oversized
        tables after the refresh of chunk 1, 64 and every 512th."""
        done = 0
        chunks = 0
        while done < n_steps:
            kk = min(update_freq, n_steps - done)
            params_k = params.replace(
                max_drift=torch.tensor(kk, dtype=I, device=state.device))
            state = self.refresh(state, params_k)
            chunks += 1
            if chunks in (1, 64) or chunks % 512 == 0:
                state = self.maybe_shrink(state)
            state = run_steps(state, params_k, self.cfg, kk)
            done += kk
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
