"""Carry a state across from the JAX package.

The functions take a JAX ``SimState`` / ``RuntimeParams`` whose leaves
the caller has already turned into numpy arrays (for example with
``jax.tree_util.tree_map(np.asarray, state)``), or nested mappings with
the same field names, and build the port's objects on `device`. Field
names and dtypes are kept: f32 for reals, i32 for ids and voxels, bool
for the family masks. This module imports nothing of JAX.

Layouts differ in two places: the port's SS table always carries the
fused-pass record ``fstat_a`` and no wide ``statics``, and of the JAX
package's unique-fetch fields it keeps the A layout's (``uidx``,
``uniq_a``) and ``uniq_max``, since its kernel computes each contact
once. A JAX SS table
that was built without the fused layout converts only while it holds no
live contact (then the fused layout is simply the empty one).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .defines import F, I, TimeIntegrator
from .models import HertzianForceModel, HertzianFrictionlessForceModel
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
    tri = Triangles(**_fields(t, device, floats=("nodes",),
                              ints=("owner", "mat")))
    if tri.n:
        raise NotImplementedError(
            "triangle meshes are not ported to the torch package yet")
    return tri


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


def state_from_numpy(s, device) -> SimState:
    return SimState(
        owners=owners_from_numpy(_get(s, "owners"), device),
        spheres=spheres_from_numpy(_get(s, "spheres"), device),
        tris=triangles_from_numpy(_get(s, "tris"), device),
        anals=analyticals_from_numpy(_get(s, "anals"), device),
        ss=table_from_numpy(_get(s, "ss"), device, fused=True),
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


def config_from_reference(cfg) -> SolverConfig:
    """The port's SolverConfig from a JAX ``SolverConfig``: voxel size,
    integrator, built-in force model and capacities. Options of the JAX
    package that select TPU kernels or layouts have no counterpart (the
    port picks kernels by device); settings the port does not run yet
    raise."""
    model = _MODELS.get(_get(cfg, "force_model").fused_variant)
    if model is None:
        raise NotImplementedError(
            "only the built-in Hertz force models are ported")
    if _get(cfg, "use_persistency") or _get(cfg, "cd_two_class"):
        raise NotImplementedError(
            "persistency and two-class CD are not ported yet")
    if _get(cfg, "prescriptions") or _get(cfg, "family_changes"):
        raise NotImplementedError(
            "prescriptions and family changes are not ported yet")
    return SolverConfig(
        voxel_size=float(_get(cfg, "voxel_size")),
        integrator=TimeIntegrator(_get(cfg, "integrator").value),
        force_model=model(),
        cap_ss=int(_get(cfg, "cap_ss")),
        cap_st=int(_get(cfg, "cap_st")),
        cap_sa=int(_get(cfg, "cap_sa")),
        # the JAX package builds unique-fetch layouts on fused tables only
        uniq_cap=(int(_get(cfg, "uniq_cap"))
                  if _get(cfg, "use_fused_force") else 0),
    )
