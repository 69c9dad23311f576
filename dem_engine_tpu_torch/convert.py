"""Carry a state across from the JAX package.

The functions take a JAX ``SimState`` / ``RuntimeParams`` whose leaves
the caller has already turned into numpy arrays (for example with
``jax.tree_util.tree_map(np.asarray, state)``), or nested mappings with
the same field names, and build the port's objects on `device`. Field
names and dtypes are kept: f32 for reals, i32 for ids and voxels, bool
for the family masks. This module imports nothing of JAX: prescriptions
and family-change rules, which hold callables, are not carried across
but checked against the port's own (``config_from_reference``).

Force models hold callables of one framework too: a custom model's
``fn`` is JAX code, so the caller passes the port's own model, whose
declared resources must equal the JAX model's.

Layouts differ in two places: the port's SS table of a built-in Hertz
model always carries the fused-pass record ``fstat_a`` and no wide
``statics`` (for any other model it carries the wide layout, as the JAX
package's does off the TPU), and of the JAX
package's unique-fetch fields it keeps the A layout's (``uidx``,
``uniq_a``) and ``uniq_max``, since its kernel computes each contact
once, and adds the A layout's block row starts (``blk_start``), which the
JAX package does not keep. A JAX SS table
that was built without the fused layout converts only while it holds no
live contact (then the fused layout is simply the empty one).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .defines import F, I, TimeIntegrator
from .models import HertzianForceModel, HertzianFrictionlessForceModel
from .models.prescriptions import CHANNELS
from .ops.forces import block_starts
from .state import (
    FSTAT_W,
    Analyticals,
    ContactTable,
    Owners,
    RuntimeParams,
    SimState,
    SolverConfig,
    Spheres,
    Triangles,
)


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _t(x, device, dtype):
    a = np.asarray(x)
    want = {F: np.float32, I: np.int32, torch.bool: np.bool_}[dtype]
    if a.dtype != want:
        raise TypeError(f"expected {np.dtype(want)}, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _dict(d, device, dtype=F):
    return {k: _t(v, device, dtype) for k, v in dict(d).items()}


def _fields(obj, device, floats=(), ints=()):
    out = {k: _t(_get(obj, k), device, F) for k in floats}
    out.update({k: _t(_get(obj, k), device, I) for k in ints})
    out["wildcards"] = _dict(_get(obj, "wildcards"), device)
    return out


def owners_from_numpy(o, device) -> Owners:
    return Owners(**_fields(
        o, device,
        floats=("loc", "quat", "vel", "omg", "lin_acc", "ang_acc",
                "ext_acc", "ext_ang_acc", "mass", "moi"),
        ints=("vox", "family")))


def spheres_from_numpy(s, device) -> Spheres:
    return Spheres(**_fields(s, device, floats=("relpos", "radius"),
                             ints=("owner", "mat")))


def analyticals_from_numpy(a, device) -> Analyticals:
    return Analyticals(**_fields(
        a, device, floats=("relpos", "direction", "size", "normal_sign"),
        ints=("owner", "objtype", "mat")))


def triangles_from_numpy(t, device) -> Triangles:
    return Triangles(**_fields(t, device, floats=("nodes",),
                               ints=("owner", "mat")))


def table_from_numpy(t, device, fused=False) -> ContactTable:
    """One contact table. With `fused` (the SS table) the result carries
    the fused layout: the JAX ``fstat_a`` if present, else the empty
    layout of a table with no live contact."""
    idA = _t(_get(t, "idA"), device, I)
    cap = idA.shape[0]
    fields = dict(
        idA=idA,
        idB=_t(_get(t, "idB"), device, I),
        count=_t(_get(t, "count"), device, I),
        persist=_t(_get(t, "persist"), device, I),
        wildcards=_dict(_get(t, "wildcards"), device),
        own_a=_t(_get(t, "own_a"), device, I),
        own_b=_t(_get(t, "own_b"), device, I),
        perm_b=_t(_get(t, "perm_b"), device, I),
        own_b_sorted=_t(_get(t, "own_b_sorted"), device, I),
        uidx=_t(_get(t, "uidx"), device, F),
        uniq_a=_t(_get(t, "uniq_a"), device, I),
        uniq_max=_t(_get(t, "uniq_max"), device, I),
        blk_start=torch.zeros((0,), dtype=I, device=device),
    )
    if not fused:
        return ContactTable(
            **fields,
            force=_t(_get(t, "force"), device, F),
            torque=_t(_get(t, "torque"), device, F),
            cpoint=_t(_get(t, "cpoint"), device, F),
            statics=_t(_get(t, "statics"), device, F),
            premix=_dict(_get(t, "premix"), device),
            fstat_a=torch.zeros((FSTAT_W, 0), dtype=F, device=device),
        )
    fstat = np.asarray(_get(t, "fstat_a"))
    if fstat.shape[1] != cap:
        if bool((np.asarray(_get(t, "idA")) >= 0).any()):
            raise ValueError(
                "the JAX SS table has live contacts but no fused layout "
                "(fstat_a); refresh it with use_fused_force=True, or "
                "refresh the converted state in the port")
        fstat = np.zeros((FSTAT_W, cap), np.float32)
        fstat[0] = -1.0
    z = torch.zeros((0, 3), dtype=F, device=device)
    return ContactTable(
        **fields, force=z, torque=z.clone(), cpoint=z.clone(),
        statics=torch.zeros((0, cap), dtype=F, device=device), premix={},
        fstat_a=_t(fstat, device, F))


def state_from_numpy(s, device, fused_ss: bool = True) -> SimState:
    """The state; `fused_ss` False takes the SS table in the wide layout
    (a model without a fused variant, ``forces.fused_ss``)."""
    owners = owners_from_numpy(_get(s, "owners"), device)
    ss = table_from_numpy(_get(s, "ss"), device, fused=fused_ss)
    if ss.uniq_a.shape[0]:
        # the JAX table has no row starts: its kernel searches own_a
        ss = ss.replace(blk_start=block_starts(ss.own_a, owners.n))
    return SimState(
        owners=owners,
        spheres=spheres_from_numpy(_get(s, "spheres"), device),
        tris=triangles_from_numpy(_get(s, "tris"), device),
        anals=analyticals_from_numpy(_get(s, "anals"), device),
        ss=ss,
        st=table_from_numpy(_get(s, "st"), device),
        sa=table_from_numpy(_get(s, "sa"), device),
        time=_t(_get(s, "time"), device, F),
        step=_t(_get(s, "step"), device, I),
        overflow=_t(_get(s, "overflow"), device, I),
        max_vel=_t(_get(s, "max_vel"), device, F),
        lost_contacts=_t(_get(s, "lost_contacts"), device, I),
    )


def params_from_numpy(p, device) -> RuntimeParams:
    floats = ("h", "gravity", "domain", "expand_safety_multi",
              "expand_safety_adder", "approx_max_vel", "error_out_vel",
              "error_out_avg_contacts", "family_extra_margin", "cls_thr",
              "bin_factor")
    return RuntimeParams(
        **{k: _t(_get(p, k), device, F) for k in floats},
        max_drift=_t(_get(p, "max_drift"), device, I),
        family_mask=_t(_get(p, "family_mask"), device, torch.bool),
        family_persist=_t(_get(p, "family_persist"), device, torch.bool),
        mat_props=_dict(_get(p, "mat_props"), device),
        pair_props=_dict(_get(p, "pair_props"), device),
    )


_MODELS = {
    "hertz_full": HertzianForceModel,
    "hertz_frictionless": HertzianFrictionlessForceModel,
}


_CHANNELS = tuple(ch for ch, _, _ in CHANNELS)
_MASKS = tuple(m for _, _, m in CHANNELS if m)


def _check_prescriptions(ref, port):
    """The port's prescriptions hold the JAX config's families, with
    the same channels set and the same component masks."""
    def layout(presc):
        out = {}
        for p in presc:
            f = int(_get(p, "family"))
            if f in out:
                raise ValueError(f"family {f} is prescribed twice")
            out[f] = (tuple(_get(p, c) is not None for c in _CHANNELS),
                      tuple(tuple(bool(x) for x in _get(p, m))
                            for m in _MASKS))
        return out

    want, got = layout(ref), layout(port)
    if want != got:
        raise ValueError(
            "the prescriptions differ from the JAX config's: families "
            f"{sorted(want)} against {sorted(got)}, or their channels or "
            "masks")


def _check_family_changes(ref, port):
    want = [(int(_get(r, "from_family")), int(_get(r, "to_family")))
            for r in ref]
    got = [(int(r.from_family), int(r.to_family)) for r in port]
    if want != got:
        raise ValueError(f"the family changes {got} differ from the JAX "
                         f"config's {want}")


_MODEL_FIELDS = ("name", "contact_wildcards", "owner_wildcards",
                 "geo_wildcards", "per_material_props", "pairwise_props",
                 "no_contact_force")


def _check_model(ref, port):
    """The port's model declares what the JAX model declares."""
    diff = [f for f in _MODEL_FIELDS
            if _get(ref, f) != getattr(port, f)]
    if diff:
        raise ValueError(
            "the force model differs from the JAX config's in "
            + ", ".join(f"{f} ({getattr(port, f)!r}, JAX "
                        f"{_get(ref, f)!r})" for f in diff))


def config_from_reference(cfg, prescriptions=None, family_changes=None,
                          force_model=None) -> SolverConfig:
    """The port's SolverConfig from a JAX ``SolverConfig``: voxel size,
    integrator, force model, capacities, the ST sweep's scan widths, the
    two-class CD settings and persistency. Options of the JAX package
    that select TPU kernels or layouts have no counterpart (the port
    picks kernels by device).

    Prescriptions, family-change rules and custom force models hold
    callables of one framework and cannot be carried across: where the
    JAX config has them, pass the port's own (``models.prescriptions``,
    ``models.ForceModel``) as `prescriptions`, `family_changes` and
    `force_model`; their families, channels and masks, and the model's
    name, wildcards, material props and ``no_contact_force``, must match
    the JAX config's. A built-in Hertz model needs no `force_model`."""
    ref_model = _get(cfg, "force_model")
    if force_model is None:
        builtin = _MODELS.get(ref_model.fused_variant)
        if builtin is None:
            raise ValueError(
                "the JAX config has a custom force model, whose callable "
                "cannot be carried across: pass the port's own as "
                "`force_model=`")
        force_model = builtin()
    _check_model(ref_model, force_model)
    for name, given, check in (
            ("prescriptions", prescriptions, _check_prescriptions),
            ("family_changes", family_changes, _check_family_changes)):
        ref = tuple(_get(cfg, name))
        if ref and given is None:
            raise ValueError(
                f"the JAX config has {name}, whose callables cannot be "
                f"carried across: pass the port's own as `{name}=`")
        check(ref, tuple(given or ()))
    return SolverConfig(
        voxel_size=float(_get(cfg, "voxel_size")),
        integrator=TimeIntegrator(_get(cfg, "integrator").value),
        force_model=force_model,
        cap_ss=int(_get(cfg, "cap_ss")),
        cap_st=int(_get(cfg, "cap_st")),
        cap_sa=int(_get(cfg, "cap_sa")),
        max_per_bin=int(_get(cfg, "max_per_bin")),
        max_tri_span=int(_get(cfg, "max_tri_span")),
        st_bruteforce=bool(_get(cfg, "st_bruteforce")),
        cd_two_class=bool(_get(cfg, "cd_two_class")),
        cross_lcap=int(_get(cfg, "cross_lcap")),
        cross_mpb=int(_get(cfg, "cross_mpb")),
        # the JAX package builds unique-fetch layouts on fused tables only
        uniq_cap=(int(_get(cfg, "uniq_cap"))
                  if _get(cfg, "use_fused_force") else 0),
        use_persistency=bool(_get(cfg, "use_persistency")),
        spatial_refresh=bool(_get(cfg, "spatial_refresh")),
        spatial_capx=int(_get(cfg, "spatial_capx")),
        prescriptions=tuple(prescriptions or ()),
        family_changes=tuple(family_changes or ()),
    )
