"""Assembly of SimState / RuntimeParams from flat host arrays, on an
explicit device: every helper takes the device from its caller."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .defines import F, I
from .ops import voxel
from .state import (
    Analyticals,
    ContactTable,
    Owners,
    RuntimeParams,
    SimState,
    SolverConfig,
    Spheres,
    Triangles,
)


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for. A CUDA device on a
    machine without a card raises: nothing carries on on the CPU unless
    the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev


def _f(x, device, shape=None):
    a = torch.as_tensor(np.asarray(x, np.float32), device=device)
    return a if shape is None else a.reshape(shape)


def _i(x, device, shape=None):
    a = torch.as_tensor(np.asarray(x, np.int32), device=device)
    return a if shape is None else a.reshape(shape)


def make_owners(pos, voxel_size, *, quat=None, vel=None, omg=None,
                family=None, mass=None, moi=None, wildcards=None,
                device) -> Owners:
    """pos: (N,3) float64 LBF-relative positions (exact host encode)."""
    pos = np.asarray(pos, np.float64).reshape(-1, 3)
    n = pos.shape[0]
    vox, loc = voxel.encode_host(pos, voxel_size)
    if quat is None:
        quat = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (n, 1))
    z3 = np.zeros((n, 3))
    return Owners(
        vox=_i(vox, device),
        loc=_f(loc, device),
        quat=_f(quat, device, (n, 4)),
        vel=_f(z3 if vel is None else vel, device, (n, 3)),
        omg=_f(z3 if omg is None else omg, device, (n, 3)),
        lin_acc=_f(z3, device),
        ang_acc=_f(z3, device),
        ext_acc=_f(z3, device),
        ext_ang_acc=_f(z3, device),
        family=_i(np.zeros(n) if family is None else family, device, (n,)),
        mass=_f(np.ones(n) if mass is None else mass, device, (n,)),
        moi=_f(np.ones((n, 3)) if moi is None else moi, device, (n, 3)),
        wildcards={k: _f(v, device, (n,))
                   for k, v in (wildcards or {}).items()},
    )


def concat_owners(*parts: Owners) -> Owners:
    """Owners of several groups, in argument order."""
    def cat(name):
        return torch.cat([getattr(p, name) for p in parts], 0)

    names = set(parts[0].wildcards)
    if any(set(p.wildcards) != names for p in parts):
        raise ValueError("owner groups carry different wildcard sets")
    return Owners(
        **{f: cat(f) for f in ("vox", "loc", "quat", "vel", "omg",
                               "lin_acc", "ang_acc", "ext_acc",
                               "ext_ang_acc", "family", "mass", "moi")},
        wildcards={k: torch.cat([p.wildcards[k] for p in parts])
                   for k in sorted(names)},
    )


def make_spheres(owner, relpos, radius, mat=None, wildcards=None, *,
                 device) -> Spheres:
    owner = np.asarray(owner).reshape(-1)
    s = owner.shape[0]
    return Spheres(
        owner=_i(owner, device),
        relpos=_f(relpos, device, (s, 3)),
        radius=_f(radius, device, (s,)),
        mat=_i(np.zeros(s) if mat is None else mat, device, (s,)),
        wildcards={k: _f(v, device, (s,))
                   for k, v in (wildcards or {}).items()},
    )


def empty_triangles(device) -> Triangles:
    return Triangles(
        owner=torch.zeros((0,), dtype=I, device=device),
        nodes=torch.zeros((0, 3, 3), dtype=F, device=device),
        mat=torch.zeros((0,), dtype=I, device=device),
        wildcards={},
    )


def empty_analyticals(device) -> Analyticals:
    return Analyticals(
        owner=torch.zeros((0,), dtype=I, device=device),
        objtype=torch.zeros((0,), dtype=I, device=device),
        relpos=torch.zeros((0, 3), dtype=F, device=device),
        direction=torch.zeros((0, 3), dtype=F, device=device),
        size=torch.zeros((0, 3), dtype=F, device=device),
        normal_sign=torch.zeros((0,), dtype=F, device=device),
        mat=torch.zeros((0,), dtype=I, device=device),
        wildcards={},
    )


def make_analyticals(owner, objtype, relpos, direction, size, normal_sign,
                     mat=None, wildcards=None, *, device) -> Analyticals:
    owner = np.asarray(owner).reshape(-1)
    a = owner.shape[0]
    if a == 0:
        return empty_analyticals(device)
    return Analyticals(
        owner=_i(owner, device),
        objtype=_i(objtype, device, (a,)),
        relpos=_f(relpos, device, (a, 3)),
        direction=_f(direction, device, (a, 3)),
        size=_f(size, device, (a, 3)),
        normal_sign=_f(normal_sign, device, (a,)),
        mat=_i(np.zeros(a) if mat is None else mat, device, (a,)),
        wildcards={k: _f(v, device, (a,))
                   for k, v in (wildcards or {}).items()},
    )


def empty_ss_table(cfg: SolverConfig, cap: int, device, uniq_rows: int = 0):
    """The SS table of a fused (built-in Hertz) model: the slim layout
    that the fused force pass reads, with `uniq_rows` unique-fetch
    slots."""
    from .ops.forces import require_fused

    require_fused(cfg.force_model)
    return ContactTable.empty(cap, cfg.force_model.contact_wildcards,
                              fused=True, uniq_rows=uniq_rows, device=device)


def ss_uniq_rows(cfg: SolverConfig, n_owners: int) -> int:
    """Rows of the per-block unique-other lists (0 when unique fetch is
    off)."""
    from .ops.fused_force import n_blocks_of

    return n_blocks_of(n_owners) * cfg.uniq_cap


def empty_table(cfg: SolverConfig, cap: int, device):
    """An ST/SA table: the wide statics layout that contact_pass reads."""
    from .ops.forces import premix_names

    return ContactTable.empty(cap, cfg.force_model.contact_wildcards,
                              premix_names(cfg.force_model), device=device)


def make_state(owners: Owners, spheres: Spheres, cfg: SolverConfig,
               tris: Optional[Triangles] = None,
               anals: Optional[Analyticals] = None) -> SimState:
    device = owners.vox.device
    if tris is not None and tris.n:
        raise NotImplementedError(
            "triangle meshes are not ported to the torch package yet")

    def scalar(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return SimState(
        owners=owners,
        spheres=spheres,
        tris=empty_triangles(device),
        anals=anals if anals is not None else empty_analyticals(device),
        ss=empty_ss_table(cfg, cfg.cap_ss, device,
                          ss_uniq_rows(cfg, owners.n)),
        st=empty_table(cfg, cfg.cap_st, device),
        sa=empty_table(cfg, cfg.cap_sa, device),
        time=scalar(F),
        step=scalar(I),
        overflow=scalar(I),
        max_vel=scalar(F),
        lost_contacts=scalar(I),
    )


def make_params(
    *,
    h: float,
    gravity,
    domain,
    materials: Dict[str, np.ndarray],
    pair_materials: Dict[str, np.ndarray],
    update_freq: int = 20,
    expand_safety_multi: float = 1.0,
    expand_safety_adder: float = 0.0,
    approx_max_vel: float = 1e30,
    error_out_vel: float = 5e4,
    error_out_avg_contacts: float = 100.0,
    family_mask: Optional[np.ndarray] = None,
    family_persist: Optional[np.ndarray] = None,
    family_extra_margin: Optional[np.ndarray] = None,
    cls_thr: float = 0.0,
    bin_factor: float = 1.0,
    device,
) -> RuntimeParams:
    if family_mask is None:
        family_mask = np.ones((256, 256), bool)
    if family_persist is None:
        family_persist = np.zeros((256, 256), bool)
    if family_extra_margin is None:
        family_extra_margin = np.zeros((256,), np.float32)
    return RuntimeParams(
        h=_f(h, device),
        gravity=_f(gravity, device, (3,)),
        domain=_f(domain, device, (3,)),
        expand_safety_multi=_f(expand_safety_multi, device),
        expand_safety_adder=_f(expand_safety_adder, device),
        approx_max_vel=_f(approx_max_vel, device),
        error_out_vel=_f(error_out_vel, device),
        error_out_avg_contacts=_f(error_out_avg_contacts, device),
        max_drift=_i(update_freq, device),
        family_mask=torch.as_tensor(np.asarray(family_mask, bool),
                                    device=device),
        family_persist=torch.as_tensor(np.asarray(family_persist, bool),
                                       device=device),
        family_extra_margin=_f(family_extra_margin, device, (256,)),
        mat_props={k: _f(v, device) for k, v in materials.items()},
        pair_props={k: _f(v, device) for k, v in pair_materials.items()},
        cls_thr=_f(cls_thr, device),
        bin_factor=_f(bin_factor, device),
    )
