"""What the check reads of the program: the inputs and outputs of one
refresh and of the first step after it, as the timed path runs them.

``Capture`` wraps the program's functions for one ``DoDynamics`` frame
after the window, keeping references (the program never updates a state
tensor in place): the refresh that precedes the frame's first step (its
input and output states), that step's input and output states, each
table's per-contact outputs (kernel B's rows, or ``contact_pass``'s),
and the owner wrench the integrator got (kernel A's sums). ``plain``
turns them into tensors the reference can read.

These six functions, their leading parameters and their return layouts
are the benchmark's contract with the program: ``refresh_contacts(state,
...)`` and ``dynamics_step(state, ...)`` return the new state;
``hertz_rows_cuda(table, ...)`` and ``hertz_rows(...)`` return (rec_a,
rec_b, wc_new) with rec_x = [force (3), body torque (3)] per row;
``contact_pass(kind, table, ...)`` returns dict(table, rec_a, rec_b),
the history in the table's wildcards; ``integrate_owners(owners, f_acc,
t_acc, ...)`` gets the owners' sums. The module attribute is what is
wrapped, so the program has to call them through their modules. A frame
in which a wrapper records nothing stops the run (``plain``).
"""

from __future__ import annotations

import torch

HISTORY = ("delta_tan_x", "delta_tan_y", "delta_tan_z", "delta_time")


class Capture:
    def __init__(self):
        from dem_engine_tpu_torch import solver
        from dem_engine_tpu_torch.ops import forces, fused_force, integrator

        self._targets = [
            (solver, "refresh_contacts", self._refresh),
            (solver, "dynamics_step", self._step),
            (fused_force, "hertz_rows_cuda", self._hertz_cuda),
            (fused_force, "hertz_rows", self._hertz_plain),
            (forces, "contact_pass", self._contact_pass),
            (integrator, "integrate_owners", self._integrate),
        ]
        self._orig = {}
        self.refresh_in = self.refresh_out = None
        self.step_in = self.step_out = None
        self.rows = {}
        self.wrench = None
        self.stepping = False
        self.stepped = False

    def __enter__(self):
        self._wrappers = {}
        for mod, name, method in self._targets:
            self._orig[name] = orig = getattr(mod, name)
            wrapper = (lambda m: lambda *a, **k: m(*a, **k))(method)
            if hasattr(orig, "launches"):
                # the kernel wrappers count their launches on themselves
                wrapper.launches = orig.launches
            self._wrappers[name] = wrapper
            setattr(mod, name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self._targets:
            orig, wrapper = self._orig[name], self._wrappers[name]
            if hasattr(orig, "launches"):
                orig.launches = wrapper.launches
            setattr(mod, name, orig)
        return False

    def _refresh(self, state, *args, **kw):
        out = self._orig["refresh_contacts"](state, *args, **kw)
        if not self.stepped:
            # a retry after a growth replaces the one before
            self.refresh_in, self.refresh_out = state, out
        return out

    def _step(self, state, *args, **kw):
        first = not self.stepped
        if first:
            self.step_in, self.stepping = state, True
        out = self._orig["dynamics_step"](state, *args, **kw)
        if first:
            self.step_out, self.stepping, self.stepped = out, False, True
        return out

    def _hertz_cuda(self, table, *args, **kw):
        out = self._orig["hertz_rows_cuda"](table, *args, **kw)
        if self.stepping and "ss" not in self.rows:
            self.rows["ss"] = (table, out[0], out[1], out[2])
        return out

    def _hertz_plain(self, *args, **kw):
        out = self._orig["hertz_rows"](*args, **kw)
        if self.stepping and "ss" not in self.rows:
            self.rows["ss"] = (self.step_in.ss, out[0], out[1], out[2])
        return out

    def _contact_pass(self, kind, table, *args, **kw):
        out = self._orig["contact_pass"](kind, table, *args, **kw)
        if self.stepping and kind not in self.rows:
            wc = out["table"].wildcards
            self.rows[kind] = (table, out["rec_a"], out["rec_b"],
                               torch.stack([wc[k] for k in HISTORY]))
        return out

    def _integrate(self, owners, f_acc, t_acc, *args, **kw):
        if self.stepping and self.wrench is None:
            self.wrench = (f_acc, t_acc)
        return self._orig["integrate_owners"](owners, f_acc, t_acc, *args,
                                              **kw)


def owners_plain(owners, voxel, n=None) -> dict:
    """Positions decoded to float64 from the voxel codec, and the rest of
    an owner record, for the first `n` owners (all by default)."""
    sl = slice(None) if n is None else slice(0, n)
    pos = (owners.vox[sl].double() * voxel + owners.loc[sl].double())
    return dict(pos=pos, quat=owners.quat[sl], vel=owners.vel[sl],
                omg=owners.omg[sl], mass=owners.mass[sl],
                moi=owners.moi[sl])


def _table_rows(t):
    live = t.idA >= 0
    wc = torch.stack([t.wildcards[k] for k in HISTORY], 1)
    return live, dict(a=t.idA[live].long(), b=t.idB[live].long(),
                      wc=wc[live])


def plain(cap: Capture, voxel: float, n_clumps: int) -> tuple:
    """(inputs, outputs) of the captured refresh and step as plain
    tensors: inputs = the owners both start from and the old tables'
    live rows; outputs = the pair sets, the per-contact
    rows, the wrench and the clumps after the step."""
    silent = [name for name, seen in (
        ("refresh_contacts", cap.refresh_in is not None),
        ("dynamics_step", cap.step_in is not None),
        ("hertz_rows_cuda, hertz_rows or contact_pass ('ss')",
         "ss" in cap.rows),
        ("contact_pass ('sa')", "sa" in cap.rows),
        ("integrate_owners", cap.wrench is not None)) if not seen]
    if silent:
        raise RuntimeError("the check frame captured nothing from "
                           + "; ".join(silent) + ": the program no longer "
                           "calls them as the check expects")
    st0 = cap.step_in
    owners = owners_plain(st0.owners, voxel)
    old = {k: _table_rows(getattr(cap.refresh_in, k))[1] for k in ("ss", "sa")}
    pairs = {}
    for k in ("ss", "sa"):
        t = getattr(cap.refresh_out, k)
        live = t.idA >= 0
        pairs[k] = ((t.idA[live].long(), t.idB[live].long()) if k == "ss"
                    else t.idA[live].long())
    rows = {}
    for k, (t, rec_a, rec_b, wc) in cap.rows.items():
        live = t.idA >= 0
        rows[k] = dict(a=t.idA[live].long(), b=t.idB[live].long(),
                       force=rec_a[live, :3], tq_a=rec_a[live, 3:],
                       tq_b=rec_b[live, 3:], wc=wc[:, live].T)
    f_acc, t_acc = cap.wrench
    o1 = cap.step_out.owners
    o0 = st0.owners
    n = n_clumps
    disp = ((o1.vox[:n] - o0.vox[:n]).double() * voxel
            + (o1.loc[:n].double() - o0.loc[:n].double()))
    after = dict(vel=o1.vel[:n], omg=o1.omg[:n], quat=o1.quat[:n],
                 disp=disp)
    if cap.refresh_in.owners is not st0.owners:
        # a refresh leaves the owners as they are: the step starts from
        # the same records the search saw
        raise RuntimeError("the owners changed between refresh and step")
    inputs = dict(owners=owners, old=old)
    outputs = dict(pairs=pairs, rows=rows, F=f_acc, T=t_acc, after=after)
    return inputs, outputs
