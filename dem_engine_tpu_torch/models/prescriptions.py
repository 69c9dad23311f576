"""Family prescriptions and family-change rules.

A prescription is a set of Python callables of simulation time, one per
channel, registered per family. The integrator gathers each owner's
row of dense per-family tables by its family id.

Semantics, as in the JAX package:
  * velocity / angular-velocity prescriptions **dictate** the component
    (true physics is skipped for it) unless the component mask is False;
  * angular velocity is in the owner's body frame;
  * position / quaternion prescriptions pin the pose;
  * "added acceleration" is additive and does not show up in the
    queryable acceleration arrays;
  * the "soft" channels (dictate=False and the CorrectFamily* calls) are
    assigned each step, and the physics integrates on top.

A callable receives `t`, the step's start time, as a 0-d float32 tensor
on the state's device, and must compute with torch operations on it
(``torch.sin``, not ``jnp.sin`` or ``math.sin``), returning a tensor on
that device: a 0-d one for a single component, a (3,) or (4,) one for a
whole channel. Anything else is copied to the device every step, a host
round trip.

Tables are built for the card in two parts. The static part (family
ids, masks and every constant component) goes to the device once per
prescription set (``static_tables`` keeps the last few sets). Each step
``PrescriptionTables.at(t)`` evaluates only the callables and writes
their values into a copy of the static part, with no host sync.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..defines import F

Vec3Fn = Callable[[torch.Tensor], torch.Tensor]  # t -> (3,)
QuatFn = Callable[[torch.Tensor], torch.Tensor]  # t -> (4,) (w,x,y,z)


class Const:
    """A channel value that does not change with time (f32)."""

    def __init__(self, value):
        self.value = np.asarray(value, np.float32).reshape(-1)

    def __call__(self, t):
        return torch.as_tensor(self.value, device=t.device)


class Components:
    """A vec3 channel given per component: each a number, a callable of
    `t` returning one value, or None (0). `offset` is subtracted from
    every component in f32 (the position channels take user-frame
    values and store them relative to the domain's lower corner)."""

    def __init__(self, comps, offset=(0.0, 0.0, 0.0)):
        self.comps = tuple(comps)
        self.offset = np.asarray(offset, np.float32).reshape(3)

    def __call__(self, t):
        vals = [torch.as_tensor(c(t), dtype=F, device=t.device).reshape(())
                if callable(c) else
                torch.tensor(0.0 if c is None else c, dtype=F,
                             device=t.device) for c in self.comps]
        return torch.stack(vals) - torch.as_tensor(self.offset,
                                                   device=t.device)


class Merged:
    """Component-wise merge of a masked vec3 channel: `b`'s components
    where `sel` is set, `a`'s elsewhere."""

    def __init__(self, a, b, sel):
        self.a, self.b = a, b
        self.sel = tuple(bool(x) for x in sel)

    def __call__(self, t):
        sel = torch.tensor(self.sel, device=t.device)
        return torch.where(sel, torch.as_tensor(self.b(t), dtype=F).reshape(3),
                           torch.as_tensor(self.a(t), dtype=F).reshape(3))


@dataclasses.dataclass(frozen=True, eq=False)
class FamilyPrescription:
    family: int
    lin_vel: Optional[Vec3Fn] = None
    lin_vel_mask: Tuple[bool, bool, bool] = (True, True, True)
    rot_vel: Optional[Vec3Fn] = None          # body frame
    rot_vel_mask: Tuple[bool, bool, bool] = (True, True, True)
    lin_pos: Optional[Vec3Fn] = None          # LBF-relative
    lin_pos_mask: Tuple[bool, bool, bool] = (True, True, True)
    quat: Optional[QuatFn] = None
    acc: Optional[Vec3Fn] = None              # added linear acceleration
    ang_acc: Optional[Vec3Fn] = None          # added angular acc, body frame
    # "soft" (non-dictating) prescriptions: assigned each step, then the
    # physics integrates on top
    lin_vel_soft: Optional[Vec3Fn] = None
    lin_vel_soft_mask: Tuple[bool, bool, bool] = (True, True, True)
    rot_vel_soft: Optional[Vec3Fn] = None     # body frame
    rot_vel_soft_mask: Tuple[bool, bool, bool] = (True, True, True)
    lin_pos_soft: Optional[Vec3Fn] = None     # LBF-relative
    lin_pos_soft_mask: Tuple[bool, bool, bool] = (True, True, True)
    quat_soft: Optional[QuatFn] = None

    def __hash__(self):
        return id(self)


def fixed(family: int) -> FamilyPrescription:
    """All-DOF fixed family (the semantics of reserved family 255 and
    SetFamilyFixed)."""
    zero = Const((0.0, 0.0, 0.0))
    return FamilyPrescription(family=family, lin_vel=zero, rot_vel=zero)


def _merge_vec(fa, ma, fb, mb):
    """The later prescription's components override exactly where ITS
    mask is set; earlier components survive elsewhere, so mixing
    SetFamilyPrescribedLinVel with the per-axis setters keeps the earlier
    axes prescribed."""
    if fb is None:
        return fa, ma
    if fa is None:
        return fb, mb
    return Merged(fa, fb, mb), tuple(x or y for x, y in zip(ma, mb))


def merge(a: FamilyPrescription, b: FamilyPrescription) -> FamilyPrescription:
    """OR-merge two prescriptions for the same family."""
    assert a.family == b.family
    merged = {}
    for ch in ("lin_vel", "rot_vel", "lin_pos", "lin_vel_soft",
               "rot_vel_soft", "lin_pos_soft"):
        merged[ch], merged[ch + "_mask"] = _merge_vec(
            getattr(a, ch), getattr(a, ch + "_mask"),
            getattr(b, ch), getattr(b, ch + "_mask"))
    for ch in ("quat", "acc", "ang_acc", "quat_soft"):
        merged[ch] = getattr(b, ch) or getattr(a, ch)
    return FamilyPrescription(family=a.family, **merged)


@dataclasses.dataclass(frozen=True, eq=False)
class FamilyChange:
    """ChangeFamilyWhen rule, applied every step after the integrator.
    `condition` receives an ``ops.integrator.OwnerView`` and the step's
    start time (0-d tensors, as for prescriptions) and returns a bool[N]
    tensor; it must not read values back to the host."""

    from_family: int
    to_family: int
    condition: Callable  # (OwnerView, t) -> bool[N]

    def __hash__(self):
        return id(self)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

#: (channel, width, mask attribute or None for an all-True mask)
CHANNELS = (
    ("lin_vel", 3, "lin_vel_mask"),
    ("rot_vel", 3, "rot_vel_mask"),
    ("lin_pos", 3, "lin_pos_mask"),
    ("quat", 4, None),
    ("acc", 3, None),
    ("ang_acc", 3, None),
    ("lin_vel_soft", 3, "lin_vel_soft_mask"),
    ("rot_vel_soft", 3, "rot_vel_soft_mask"),
    ("lin_pos_soft", 3, "lin_pos_soft_mask"),
    ("quat_soft", 4, None),
)


def _sources(fn, width):
    """Where each component of a channel's value comes from: a number
    (constant), ("scalar", callable, offset) or ("vec", callable, k), the
    k-th component of the callable's value."""
    if isinstance(fn, Const):
        return [float(v) for v in fn.value.reshape(width)]
    if isinstance(fn, Components):
        out = []
        for c, off in zip(fn.comps, fn.offset):
            if callable(c):
                out.append(("scalar", c, off))
            else:
                out.append(float(np.float32(0.0 if c is None else c) - off))
        return out
    if isinstance(fn, Merged):
        a, b = _sources(fn.a, width), _sources(fn.b, width)
        return [y if s else x for x, y, s in zip(a, b, fn.sel)]
    return [("vec", fn, k) for k in range(width)]


class PrescriptionTables:
    """Dense per-registered-family tables: for each channel of
    ``CHANNELS`` a value table (P, width) f32 and a mask table (P, width)
    bool, rows in the order of ``fam_ids`` (sorted). Built as the static
    part; ``at(t)`` returns the tables with the callables evaluated."""

    def __init__(self, prescriptions: Sequence[FamilyPrescription],
                 device=None):
        pres = sorted(prescriptions, key=lambda p: p.family)
        fam_list = [p.family for p in pres] or [-99999]  # never matches
        self.fam_ids = torch.as_tensor(np.asarray(fam_list, np.int32),
                                       device=device)
        P = max(len(pres), 1)
        #: channel -> (flat positions (device), their sources, offsets)
        self._dynamic = {}
        self._values = {}
        for ch, width, mask_name in CHANNELS:
            val = np.zeros((P, width), np.float32)
            mask = np.zeros((P, width), bool)
            dyn_pos, dyn_src = [], []
            for i, p in enumerate(pres):
                fn = getattr(p, ch)
                if fn is None:
                    continue
                mask[i] = (getattr(p, mask_name) if mask_name
                           else (True,) * width)
                for k, src in enumerate(_sources(fn, width)):
                    if isinstance(src, float):
                        val[i, k] = src
                    else:
                        dyn_pos.append(i * width + k)
                        dyn_src.append(src)
            self._values[ch] = torch.as_tensor(val, device=device)
            setattr(self, ch + "_mask", torch.as_tensor(mask, device=device))
            #: whether any row sets the channel (the integrator skips the
            #: position and orientation branches of channels no row sets)
            setattr(self, "has_" + ch, bool(mask.any()))
            if dyn_pos:
                offs = torch.as_tensor(
                    np.asarray([s[2] if s[0] == "scalar" else 0.0
                                for s in dyn_src], np.float32),
                    device=device)
                self._dynamic[ch] = (
                    torch.as_tensor(np.asarray(dyn_pos, np.int64),
                                    device=device), dyn_src, offs)
        self._set_values(self._values)

    def _set_values(self, values):
        for ch, v in values.items():
            setattr(self, ch, v)

    def at(self, t) -> "PrescriptionTables":
        """The tables at time `t` (a 0-d tensor on the tables' device):
        each callable evaluated once, its values written into a copy of
        the static part. Nothing is read back to the host."""
        if not self._dynamic:
            return self
        out = object.__new__(PrescriptionTables)
        out.__dict__.update(self.__dict__)
        cache = {}

        def value(fn):
            v = cache.get(id(fn))
            if v is None:
                v = cache[id(fn)] = torch.as_tensor(
                    fn(t), dtype=F, device=t.device).reshape(-1)
            return v

        vals = dict(self._values)
        for ch, (pos, srcs, offs) in self._dynamic.items():
            got = torch.cat([value(s[1]) if s[0] == "scalar"
                             else value(s[1])[s[2]:s[2] + 1]
                             for s in srcs]) - offs
            static = self._values[ch]
            vals[ch] = static.reshape(-1).index_put(
                (pos,), got).reshape(static.shape)
        out._set_values(vals)
        return out

    def lookup(self, family):
        """Per-owner row index into the tables, and the matched mask."""
        idx = torch.searchsorted(self.fam_ids, family)
        idx = torch.clamp(idx, 0, self.fam_ids.shape[0] - 1)
        matched = self.fam_ids[idx] == family
        return idx, matched


_CACHE: "OrderedDict[tuple, PrescriptionTables]" = OrderedDict()
_CACHE_SIZE = 8


def static_tables(prescriptions: Sequence[FamilyPrescription],
                  device) -> PrescriptionTables:
    """The static tables of a prescription set on `device`, built once
    per set (the last few sets are kept): a step only evaluates them at
    its time."""
    key = (tuple(prescriptions), str(torch.device(device)))
    tab = _CACHE.get(key)
    if tab is None:
        tab = _CACHE[key] = PrescriptionTables(prescriptions, device)
        while len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
    return tab
