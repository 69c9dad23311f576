"""DEMSolver — the user-facing facade of the port.

The JAX package's ``DEMSolver``/``DEMTracker`` method names and
behaviour, for the subset this package runs: clumps of spheres,
analytical boundaries and triangle meshes (deformable through their
trackers), the two-class CD of polydisperse beds, the built-in Hertz
models, family prescriptions (fixed, prescribed and
corrected families, added accelerations), family-change rules, the
family contact masks and the owner-state setters; the read side:
inspectors (device reductions that send one scalar to the host), clump,
contact, sphere and mesh files with their CSV readers, the read-only
getters and tracker reads, and the timing statistics
(``ShowTimingStats``, ``ProfileStageTimings``); custom force models,
wildcards, persistency and restart contacts; and the calls that change
a run mid-way: checkpoints (``SaveCheckpoint``/``LoadCheckpoint``),
insertion (``UpdateClumps``), ``PurgeFamily``, ``ChangeClumpSizes``,
and the adaptive CD cadence and bin size (``UseAdaptiveUpdateFreq``,
``UseAdaptiveBinSize``, ``SetBinSize``). The memory getters report the
card's own counts (``GetDeviceMemUsageDynamic``).

A prescription or rule given as a callable receives the step's start
time `t` as a 0-d float32 tensor on the solver's device and must
compute with torch operations on it (``torch.sin(t)``, not
``jnp.sin``), returning tensors on that device
(``models.prescriptions``).

Typical use:

    import dem_engine_tpu_torch as dem
    solver = dem.DEMSolver()            # on the card; device="cpu" asks
    solver.InstructBoxDomainDimension(2, 2, 2)
    mat = solver.LoadMaterial({"E": 1e9, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                               "Crr": 0.0})
    tmpl = solver.LoadSphereType(0.01, 0.005, mat)
    solver.AddClumps(tmpl, positions)
    solver.AddBCPlane([0, 0, -0.5], [0, 0, 1], mat)
    solver.SetInitTimeStep(5e-6)
    solver.SetGravitationalAcceleration([0, 0, -9.81])
    solver.Initialize()
    solver.DoDynamics(1.0)

On a CUDA device the step runs kernels B and A (once per table: SS, ST,
SA), each refresh kernel C (twice, on member tables, in two-class mode),
and the contact queries and contact files run kernel B with its extras
outputs, once per call. With a custom force model the SS table runs
``contact_pass`` instead of kernel B, and its queries read the fields
of the last step's pass. Unique
fetch (kernel B-ub and its lists launch at each refresh) is off by
default on the card: it did not beat kernel B on the H100, whose L2
already serves B's gathers.
``SetFusedUniqueFetch`` turns it on. On the CPU the plain versions run
and unique fetch is off, as the JAX package runs on its CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time as _time
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import defines, tracing
from .defines import (
    DEFAULT_FAMILY,
    DEFAULT_UPDATE_FREQ,
    NUM_FAMILIES,
    RESERVED_FAMILY,
    TimeIntegrator,
    Verbosity,
)
from .initializer import (
    concat_owners,
    empty_ss_table,
    make_analyticals,
    make_owners,
    make_params,
    make_spheres,
    make_state,
    make_triangles,
    resolve_device,
    ss_uniq_rows,
    uniq_fields,
)
from .models import HertzianForceModel, HertzianFrictionlessForceModel
from .models.force_model import ForceModel
from .models.prescriptions import (
    Components,
    Const,
    FamilyChange,
    FamilyPrescription,
)
from .models.prescriptions import fixed as _fixed_prescription
from .models.prescriptions import merge as _merge_prescription
from .ops import binning, forces, quat
from .ops.fused_force import fused_step_ss
from .ops.voxel import choose_voxel_size, decode_host, encode_host
from .solver import Engine, sphere_pos_margins, sphere_world_pos
from .state import SolverConfig, Spheres, map_tensors, state_tensors
from .structs import (
    DEMClumpBatch,
    DEMClumpTemplate,
    DEMExternObj,
    DEMMaterial,
    DEMMeshConnected,
)
from .utils import io as io_utils
from .utils.obj_loader import load_obj


def _np(t):
    return t.detach().cpu().numpy()


def GetDEMEDataFile(name: str) -> str:
    """Resolve a data asset path (reference DEMEPaths.h:32). Searches, in
    order: $DEME_DATA_DIR, ./data, and the package's data/ directory.
    Point DEME_DATA_DIR at a DEM-Engine checkout's data/ to run ports of
    reference demos that load clump CSVs or meshes by name."""
    roots = []
    env = os.environ.get("DEME_DATA_DIR")
    if env:
        roots.append(env)
    roots.append(os.path.join(os.getcwd(), "data"))
    roots.append(os.path.join(os.path.dirname(__file__), "data"))
    for r in roots:
        p = os.path.join(r, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"data asset {name!r} not found under {roots}; set DEME_DATA_DIR "
        f"to a data directory containing it"
    )


class DEMTracker:
    """Handle to a tracked object: owner-state reads in the user frame and
    its contact forces."""

    def __init__(self, solver: "DEMSolver", owner_ids: Sequence[int],
                 obj=None):
        self._s = solver
        self.owner_ids = np.asarray(owner_ids, np.int64)
        self.obj = obj

    def _oid(self, offset):
        return int(self.owner_ids[offset])

    def Pos(self, offset: int = 0):
        s = self._s
        o = self._oid(offset)
        owners = s.state.owners
        return decode_host(_np(owners.vox[o]), _np(owners.loc[o]),
                           s._voxel_size) + s._lbf

    def Vel(self, offset: int = 0):
        return _np(self._s.state.owners.vel[self._oid(offset)])

    def AngVelLocal(self, offset: int = 0):
        return _np(self._s.state.owners.omg[self._oid(offset)])

    def OriQ(self, offset: int = 0):
        return _np(self._s.state.owners.quat[self._oid(offset)])

    def GetOwnerID(self, offset: int = 0):
        return self._oid(offset)

    def GetFamily(self, offset: int = 0):
        return int(self._s.state.owners.family[self._oid(offset)])

    def GetFamilies(self):
        return self._s.GetOwnerFamily(self.owner_ids)

    # --- writes: between stepping calls, on copies of the state tensors --
    def _set_owner_field(self, field, offset, value):
        s = self._s
        owners = s.state.owners
        arr = getattr(owners, field).clone()
        arr[self._oid(offset)] = torch.as_tensor(
            np.asarray(value, np.float32), device=arr.device)
        s.state = s.state.replace(owners=owners.replace(**{field: arr}))

    def SetPos(self, pos, offset: int = 0):
        s = self._s
        o = self._oid(offset)
        vox, loc = encode_host(np.asarray(pos, np.float64) - s._lbf,
                               s._voxel_size)
        owners = s.state.owners
        new_vox, new_loc = owners.vox.clone(), owners.loc.clone()
        new_vox[o] = torch.as_tensor(vox, device=new_vox.device)
        new_loc[o] = torch.as_tensor(loc, device=new_loc.device)
        s.state = s.state.replace(owners=owners.replace(vox=new_vox,
                                                        loc=new_loc))

    def SetVel(self, v, offset: int = 0):
        self._set_owner_field("vel", offset, v)

    def SetAngVel(self, w, offset: int = 0):
        """Body frame, like AngVelLocal."""
        self._set_owner_field("omg", offset, w)

    def SetOriQ(self, q, offset: int = 0):
        self._set_owner_field("quat", offset, q)

    def SetFamily(self, fam: int, offset: Optional[int] = None):
        """Every tracked owner's family, or the one at `offset`."""
        ids = self.owner_ids if offset is None else [self._oid(offset)]
        self._s.SetOwnerFamily(ids, fam)

    def AddAcc(self, acc, offset: int = 0):
        """Extra acceleration applied every following step (it replaces
        the owner's earlier one)."""
        self._set_owner_field("ext_acc", offset, acc)

    def AddAngAcc(self, aacc, offset: int = 0):
        """Extra body-frame angular acceleration, as AddAcc."""
        self._set_owner_field("ext_ang_acc", offset, aacc)

    def GetContactForces(self, offset: int = 0):
        """All contact (point, force) pairs involving this owner, in the
        user frame."""
        return self._s._contact_forces_for_owner(self._oid(offset))

    def GetContactForcesAndGlobalTorque(self, offset: int = 0):
        """(points, forces, total torque about the owner CoM, global
        frame). The torque includes the rolling-resistance torque-only
        forces, which act at the contact point like the contact force."""
        pts, fs, ts = self._s._contact_forces_for_owner(
            self._oid(offset), with_torque=True)
        com = self.Pos(offset)
        tq = (np.cross(pts - com, fs + ts).sum(axis=0)
              if len(pts) else np.zeros(3))
        return pts, fs, tq

    def GetContactForcesAndLocalTorque(self, offset: int = 0):
        """As GetContactForcesAndGlobalTorque, the torque in the owner's
        body frame (the frame of MOI and omg)."""
        pts, fs, tq = self.GetContactForcesAndGlobalTorque(offset)
        q = self._s.state.owners.quat[self._oid(offset)].cpu()
        tq_l = quat.rotate_inv(q[None, :], torch.as_tensor(
            tq, dtype=defines.F)[None, :])[0]
        return pts, fs, _np(tq_l).astype(np.float64)

    def _for_all(self, read):
        pts, fs, tqs = [], [], []
        for i in range(len(self.owner_ids)):
            p, f, t = read(i)
            pts.append(p)
            fs.append(f)
            tqs.append(t)
        if not pts:
            return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3))
        return np.concatenate(pts), np.concatenate(fs), np.stack(tqs)

    def GetContactForcesAndGlobalTorqueForAll(self):
        """(points, forces, per-owner global torques (n, 3))."""
        return self._for_all(self.GetContactForcesAndGlobalTorque)

    def GetContactForcesAndLocalTorqueForAll(self):
        return self._for_all(self.GetContactForcesAndLocalTorque)

    def GetContactForcesForAll(self):
        """(points, forces) over every owner this tracker covers."""
        return self._s.GetOwnerContactForces(self.owner_ids)

    def GetContactClumps(self, offset: int = 0):
        """Owner ids of the clumps in contact with this owner."""
        return self._s.GetOwnerContactClumps(self._oid(offset))

    # --- wildcards of the tracked owners ---------------------------------
    def SetOwnerWildcardValues(self, name: str, vals):
        self._s.SetOwnerWildcardValue(name, vals, owner_ids=self.owner_ids)

    def GetOwnerWildcardValues(self, name: str):
        return self._s.GetOwnerWildcardValue(name, ids=self.owner_ids)

    def SetGeometryWildcardValues(self, name: str, vals):
        """Geometry wildcards of the spheres of the tracked owner(s)."""
        self._s.SetGeometryWildcardValue(name, vals, geo_ids=self._geo_ids())

    def GetGeometryWildcardValues(self, name: str):
        return self._s.GetGeometryWildcardValue(name, ids=self._geo_ids())

    def _geo_ids(self):
        own = self._s.state.spheres.owner
        ids = torch.as_tensor(self.owner_ids, device=own.device)
        return _np(torch.nonzero(torch.isin(own.long(), ids))[:, 0])

    # --- reads of mass properties and accelerations ----------------------
    def Mass(self, offset: int = 0):
        return float(self._s.state.owners.mass[self._oid(offset)])

    def MOI(self, offset: int = 0):
        return _np(self._s.state.owners.moi[self._oid(offset)])

    def ContactAcc(self, offset: int = 0):
        """The last step's contact acceleration, global frame."""
        return _np(self._s.state.owners.lin_acc[self._oid(offset)])

    def ContactAngAccLocal(self, offset: int = 0):
        return _np(self._s.state.owners.ang_acc[self._oid(offset)])

    def _rotated(self, field, ids):
        """Owner field `field` of `ids`, rotated to the global frame (f32
        rotation, float64 result)."""
        o = self._s.state.owners
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=o.quat.device)
        return _np(quat.rotate(o.quat[idx], getattr(o, field)[idx])).astype(
            np.float64)

    def AngVelGlobal(self, offset: int = 0):
        """The angular velocity in the global frame (omg is stored in the
        body frame)."""
        return self._rotated("omg", [self._oid(offset)])[0]

    def GetContactAngAccGlobal(self, offset: int = 0):
        return self._rotated("ang_acc", [self._oid(offset)])[0]

    def GetOwnerIDs(self):
        return list(self.owner_ids)

    # plural reads over every tracked owner
    def Positions(self):
        return self._s.GetOwnerPosition(self.owner_ids)

    def Velocities(self):
        return self._s.GetOwnerVelocity(self.owner_ids)

    def AngularVelocitiesLocal(self):
        return self._s.GetOwnerAngVel(self.owner_ids)

    def AngularVelocitiesGlobal(self):
        return self._rotated("omg", self.owner_ids)

    def OrientationQuaternions(self):
        return self._s.GetOwnerOriQ(self.owner_ids)

    def Masses(self):
        return self._s.GetOwnerMass(self.owner_ids)

    def MOIs(self):
        return self._s.GetOwnerMOI(self.owner_ids)

    def ContactAccelerations(self):
        return self._s._owner_field("lin_acc", self.owner_ids)

    def ContactAngularAccelerationsLocal(self):
        return self._s._owner_field("ang_acc", self.owner_ids)

    def ContactAngularAccelerationsGlobal(self):
        return self._rotated("ang_acc", self.owner_ids)

    # Get* aliases of the reads
    def GetPos(self, offset: int = 0):
        return self.Pos(offset)

    def GetVel(self, offset: int = 0):
        return self.Vel(offset)

    def GetAngVelLocal(self, offset: int = 0):
        return self.AngVelLocal(offset)

    def GetOriQ(self, offset: int = 0):
        return self.OriQ(offset)

    def GetMass(self, offset: int = 0):
        return self.Mass(offset)

    def GetMOI(self, offset: int = 0):
        return self.MOI(offset)

    def GetContactAcc(self, offset: int = 0):
        return self.ContactAcc(offset)

    def GetContactAngAccLocal(self, offset: int = 0):
        return self.ContactAngAccLocal(offset)

    GetAngVelGlobal = AngVelGlobal

    # --- deformable meshes -------------------------------------------------
    def UpdateMesh(self, new_vertices, offset: int = 0):
        """Replace the tracked mesh's node positions (body frame): the
        deformable-mesh path (reference SetTriNodeRelPos / UpdateMesh).
        The next refresh and step see the new facets."""
        s = self._s
        mesh = self.obj
        if not isinstance(mesh, DEMMeshConnected):
            raise TypeError("tracker is not on a mesh")
        v = np.asarray(new_vertices, np.float64)
        t0 = mesh.tri_offset
        tris = s.state.tris
        nodes = tris.nodes.clone()
        nodes[t0:t0 + mesh.n_tri] = torch.as_tensor(
            v[np.asarray(mesh.faces)], dtype=defines.F, device=s.device)
        s.state = s.state.replace(tris=tris.replace(nodes=nodes))
        mesh.vertices = v

    def UpdateMeshByIncrement(self, delta_vertices, offset: int = 0):
        self.UpdateMesh(np.asarray(self.obj.vertices, np.float64)
                        + np.asarray(delta_vertices, np.float64))

    def GetMeshNodesGlobal(self, offset: int = 0):
        """The tracked mesh's nodes in the user frame."""
        s = self._s
        q = s.state.owners.quat[self._oid(offset)].cpu()[None, :]
        v = torch.as_tensor(np.asarray(self.obj.vertices, np.float64),
                            dtype=defines.F)
        return self.Pos(offset)[None, :] + _np(quat.rotate(q, v))


class BoxRegion:
    """Axis-aligned box region of an inspector, user frame."""

    def __init__(self, lo, hi):
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)

    def __call__(self, pos):
        return np.all((pos >= self.lo) & (pos <= self.hi), axis=1)


class SphereRegion:
    """Ball region of an inspector, user frame."""

    def __init__(self, center, radius):
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)

    def __call__(self, pos):
        return np.linalg.norm(pos - self.center, axis=1) <= self.radius


_AXIS_IDX = {"x": 0, "y": 1, "z": 2}


def _extent_axis(q):
    """The axis of a clump_max_* / clump_min_* quantity, else None."""
    if q.startswith(("clump_max_", "clump_min_")) and q[-1] in _AXIS_IDX:
        return _AXIS_IDX[q[-1]]
    return None


def _inspect_device(state, q, kind, a, b, vol, n_clump, voxel_size):
    """An inspector's reduction on the state's device: one 0-d f32
    tensor. Spheres in the region (`kind` "box": a <= pos <= b; "sphere":
    |pos - a| <= b[0]; "none": all), LBF-relative; a clump owner is in
    when any of its spheres is, reserved-family and non-clump owners
    never."""
    owners, spheres = state.owners, state.spheres
    pos = sphere_world_pos(owners, spheres, voxel_size)
    if kind == "box":
        m = torch.all((pos >= a) & (pos <= b), dim=1)
    elif kind == "sphere":
        m = torch.linalg.vector_norm(pos - a, dim=1) <= b[0]
    else:
        m = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    ax = _extent_axis(q)
    if ax is not None:
        if q.startswith("clump_max_"):
            return torch.where(m, pos[:, ax] + spheres.radius,
                               -torch.inf).max()
        return torch.where(m, pos[:, ax] - spheres.radius, torch.inf).min()

    n = owners.n
    omask = torch.zeros(n, dtype=torch.int32, device=pos.device)
    omask = omask.scatter_reduce(0, spheres.owner.long(), m.to(torch.int32),
                                 "amax") > 0
    omask &= owners.family != RESERVED_FAMILY
    omask &= torch.arange(n, device=pos.device) < n_clump
    absv = torch.linalg.vector_norm(owners.vel, dim=1)
    if q in ("clump_max_absv", "max_absv"):
        return torch.where(omask, absv, -torch.inf).max()
    if q in ("clump_absv", "absv"):
        return (torch.where(omask, absv, 0.0).sum()
                / torch.clamp(omask.sum(), min=1))
    if q == "clump_kinetic_energy":
        ke = 0.5 * owners.mass * torch.sum(owners.vel ** 2, dim=1)
        re = 0.5 * torch.sum(owners.moi * owners.omg ** 2, dim=1)
        return torch.where(omask, ke + re, 0.0).sum()
    if q == "clump_mass":
        return torch.where(omask, owners.mass, 0.0).sum()
    if q == "clump_volume":
        return torch.where(omask, vol, 0.0).sum()
    if q == "clump_count":
        return omask.sum().to(defines.F)
    raise ValueError(f"unknown inspector quantity {q!r}")


class DEMInspector:
    """A reduction over the live state: clump_max_{x,y,z},
    clump_min_{x,y,z} (sphere surface extents), clump_max_absv,
    clump_absv (mean speed), clump_kinetic_energy, clump_mass,
    clump_volume, clump_count; over the clumps with a sphere in `region`
    (a BoxRegion, a SphereRegion, any callable pos (n, 3) -> bool (n,),
    or None for all)."""

    #: spheres above which a host-callable region warns (it reads every
    #: sphere position back)
    HOST_WARN_SPHERES = 4 * 65536

    def __init__(self, solver: "DEMSolver", quantity: str, region=None):
        self._s = solver
        self.quantity = quantity
        self.region = region
        self._warned = False

    def GetValue(self) -> float:
        """A box, sphere or no region reduces on the state's device and
        sends one scalar to the host; another callable takes the host
        path (every sphere position read back once)."""
        s = self._s
        region = self.region
        dev = s.device
        if region is None:
            kind, a, b = "none", None, None
        elif isinstance(region, BoxRegion):
            kind, a, b = "box", region.lo - s._lbf, region.hi - s._lbf
        elif isinstance(region, SphereRegion):
            kind = "sphere"
            a, b = region.center - s._lbf, [region.radius, 0.0, 0.0]
        else:
            return self._host_value()
        if kind != "none":
            a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
            b = torch.as_tensor(np.asarray(b, np.float32), device=dev)
        val = float(_inspect_device(s.state, self.quantity, kind, a, b,
                                    s._volume_dev, s._n_clump_owners,
                                    s._voxel_size))
        ax = _extent_axis(self.quantity)
        if ax is not None:
            val += float(s._lbf[ax])  # back to the user frame
        return val

    def _host_value(self) -> float:
        """The region as a host callable on the float64 user-frame sphere
        positions, the rest in numpy."""
        s = self._s
        st = s.state
        q = self.quantity
        n_sph = int(st.spheres.n)
        if n_sph > self.HOST_WARN_SPHERES and not self._warned:
            warnings.warn(
                f"Inspector region is a host callable: reading back all "
                f"{n_sph} sphere positions. Use a BoxRegion/SphereRegion "
                f"for a device-side reduction (one scalar to host).",
                stacklevel=3)
            self._warned = True
        sph_pos = _np(sphere_world_pos(st.owners, st.spheres, s._voxel_size)
                      ).astype(np.float64) + s._lbf
        own = _np(st.spheres.owner)
        mask = np.asarray(self.region(sph_pos))
        ax = _extent_axis(q)
        if ax is not None:
            r = _np(st.spheres.radius)
            if q.startswith("clump_max_"):
                return float((sph_pos[mask, ax] + r[mask]).max())
            return float((sph_pos[mask, ax] - r[mask]).min())
        o = st.owners
        vel = _np(o.vel).astype(np.float64)
        omg = _np(o.omg).astype(np.float64)
        m = _np(o.mass).astype(np.float64)
        moi = _np(o.moi).astype(np.float64)
        omask = np.zeros(m.shape[0], bool)
        omask[np.unique(own[mask])] = True
        omask &= _np(o.family) != RESERVED_FAMILY
        omask &= np.arange(m.shape[0]) < s._n_clump_owners
        if q in ("clump_max_absv", "max_absv"):
            return float(np.linalg.norm(vel[omask], axis=1).max())
        if q in ("clump_absv", "absv"):
            return float(np.linalg.norm(vel[omask], axis=1).mean())
        if q == "clump_kinetic_energy":
            ke = 0.5 * m[omask] * (vel[omask] ** 2).sum(1)
            re = 0.5 * (moi[omask] * omg[omask] ** 2).sum(1)
            return float(ke.sum() + re.sum())
        if q == "clump_mass":
            return float(m[omask].sum())
        if q == "clump_volume":
            vol = s._owner_volume
            return float(vol[omask[: len(vol)]].sum())
        if q == "clump_count":
            return float(omask.sum())
        raise ValueError(f"unknown inspector quantity {q!r}")


class DEMSolver:
    """The solver facade, on `device`: the card unless the caller asks
    for the CPU. Without a card the default raises."""

    def __init__(self, nGPUs: int = 1, device="cuda"):
        self.device = resolve_device(device)
        # world
        self._dims = np.asarray([1.0, 1.0, 1.0])
        self._lbf = np.asarray([-0.5, -0.5, -0.5])
        self._gravity = np.asarray([0.0, 0.0, 0.0])
        self._h = 1e-5
        self._integrator = TimeIntegrator.CENTERED_DIFFERENCE
        self._update_freq = DEFAULT_UPDATE_FREQ
        self._expand_multi = defines.DEFAULT_EXPAND_SAFETY_MULTI
        self._expand_adder = defines.DEFAULT_EXPAND_SAFETY_ADDER
        self._approx_max_vel = defines.HUGE_FLOAT
        self._error_out_vel = defines.DEFAULT_ERROR_OUT_VEL
        self._error_out_avg_contacts = defines.DEFAULT_ERROR_OUT_AVG_CONTACTS
        self._verbosity = Verbosity.INFO
        self._uniq_cap = 0  # unique fetch off unless SetFusedUniqueFetch
        # the adaptive CD cadence and bin size, handed to the engine at
        # Initialize (SetCDMaxUpdateFreq, SetInitBinSize, ...)
        self._adaptive_freq = False
        self._max_update_freq = None
        self._use_adaptive_bin = False
        self._init_bin_size = None
        self._init_max_per_bin = None
        # staging
        self._materials: List[DEMMaterial] = []
        self._pair_overrides: Dict[tuple, float] = {}
        self._templates: List[DEMClumpTemplate] = []
        self._batches: List[DEMClumpBatch] = []
        self._extern_objs: List[DEMExternObj] = []
        self._family_mask = np.ones((NUM_FAMILIES, NUM_FAMILIES), bool)
        self._family_persist = np.zeros((NUM_FAMILIES, NUM_FAMILIES), bool)
        self._family_extra_margin = np.zeros(NUM_FAMILIES, np.float32)
        self._no_output_families: set = set()
        self._force_model = HertzianForceModel()
        self._use_persistency = False
        self._bounding_bc = "none"
        self._bounding_bc_mat = None
        self._out_format = defines.OutputFormat.CSV
        self._cnt_out_format = defines.OutputFormat.CSV
        self._mesh_out_format = "vtk"
        OC, CC = defines.OutputContent, defines.ContactOutputContent
        self._out_content = OC.XYZ
        self._cnt_out_content = (CC.FORCE | CC.POINT | CC.TORQUE
                                 | CC.CNT_WILDCARD)
        self._pending_trackers: List[DEMTracker] = []
        self._meshes: List[DEMMeshConnected] = []
        self._cd_two_class = None  # None: the radius rule at Initialize
        self._cls_thr = 0.0
        self._init_max_tri_span = None
        # families
        self._prescriptions: Dict[int, FamilyPrescription] = {}
        self._axis_presc: Dict[tuple, list] = {}
        self._family_changes: List[FamilyChange] = []
        self._next_step_acc: list = []
        # live (post-Initialize)
        self.state = None
        self.params = None
        self.engine: Optional[Engine] = None
        self._ss_query = None
        self._voxel_size = None
        self._initialized = False
        self._n_clump_owners = 0
        self._lost_reported = 0
        # per owner: its template (an index into _owner_templates, -1 for
        # an analytical or mesh owner); per clump, in insertion order: its
        # volume; _volume_dev is the volumes on the device, f32, zero past
        # the clumps
        self._owner_templates: List[DEMClumpTemplate] = []
        self._owner_tmpl_idx = np.zeros(0, np.int64)
        self._owner_volume = np.zeros(0)
        self._volume_dev = None
        # statistics
        self._timers = {"total": 0.0}
        self._n_steps_done = 0
        self._anomalies: List[str] = []
        self._stage_timings = None

    # ------------------------------------------------------------------
    # world / solver configuration
    # ------------------------------------------------------------------
    def SetVerbosity(self, v):
        if isinstance(v, str):
            v = Verbosity[v.upper()]
        self._verbosity = v

    def _engine_log(self, level: str, msg: str):
        if self._verbosity >= Verbosity[level]:
            print(f"[dem_engine_tpu_torch][{level}] {msg}", flush=True)

    def InstructBoxDomainDimension(self, x, y, z, dir_bounds: str = "none"):
        """Domain box sizes; world origin at the center."""
        self._dims = np.asarray([x, y, z], np.float64)
        self._lbf = -self._dims / 2.0
        if dir_bounds != "none":
            self._bounding_bc = dir_bounds

    def InstructBoxDomainBoundingBC(self, kind: str, material=None):
        """Add bounding planes on the domain faces at Initialize: 'all',
        'top_open' or 'none'."""
        self._bounding_bc = kind
        self._bounding_bc_mat = material

    def SetGravitationalAcceleration(self, g):
        self._gravity = np.asarray(g, np.float64).reshape(3)

    def SetInitTimeStep(self, h: float):
        self._h = float(h)

    def SetTimeStepSize(self, h: float):
        self._h = float(h)
        if self._initialized:
            self._rebuild_params()

    UpdateStepSize = SetTimeStepSize

    def SetIntegrator(self, integ):
        """The velocity pass-on policy, a TimeIntegrator or its name. It
        is read at Initialize."""
        if isinstance(integ, str):
            integ = TimeIntegrator(integ.lower())
        self._integrator = integ

    def SetCDUpdateFreq(self, freq: int):
        self._update_freq = int(freq)
        if self._initialized:
            self._rebuild_params()

    def SetCDMaxUpdateFreq(self, freq: int):
        """Upper bound of the adaptive CD cadence: with it on, K never
        exceeds `freq`."""
        self._max_update_freq = int(freq)
        if self.engine is not None:
            self.engine.max_freq = self._max_update_freq

    def UseAdaptiveUpdateFreq(self, flag: bool = True):
        """Tune the CD cadence K from the measured time of each block of
        chunks (``solver.Engine``): K walks ``Engine.K_LADDER`` toward the
        cheapest seconds per step, below SetCDMaxUpdateFreq."""
        self._adaptive_freq = bool(flag)
        if self._initialized:
            self.engine.auto_freq = self._adaptive_freq

    def DisableAdaptiveUpdateFreq(self):
        """Pin the CD cadence to the SetCDUpdateFreq setting."""
        self.UseAdaptiveUpdateFreq(False)

    def SetCDNumStepsMaxDriftAheadOfAvg(self, *a, **k):
        """Kept for source compatibility: the refresh and the steps run in
        order on one stream, so there is no drift ahead to bound."""

    def SetCDNumStepsMaxDriftHistorySize(self, n):
        """Kept for source compatibility: the K tuner keeps per-rung
        averages of seconds per step (``Engine._k_perf``), not a drift
        history."""

    def SetCDNumStepsMaxDriftMultipleOfAvg(self, m):
        pass  # see SetCDNumStepsMaxDriftHistorySize

    def SetFusedUniqueFetch(self, cap: int = 1024):
        """Unique-other-owner fetch of the force pass (kernel B-ub): per
        block of 128 owners the step reads each distinct other owner's
        record once. `cap` bounds each block's list; it doubles on
        overflow and falls back to kernel B past 2048. Call before
        Initialize; 0 (the default) disables. On the CPU it is off."""
        self._uniq_cap = int(cap)

    def SetCDTwoClassGrids(self, flag: bool = True):
        """Force the two-class polydisperse CD on (True) or off (False).
        Never called: Initialize switches it on where the radii spread by
        more than 1.7 with more than 5 % and less than 99.9 % of the
        spheres in the small class."""
        self._cd_two_class = bool(flag)

    def SetMaxTriangleInBin(self, n: int):
        """Stored only, as the JAX package does: the ST sweep's span
        starts at 4 bins per axis and doubles on overflow up to 32."""
        self._init_max_tri_span = max(2, int(n) // 8)

    def SetMaxSphereInBin(self, n: int):
        """Stored only, as the JAX package does: the ST sweep's per-bin
        scan starts at its default and grows on overflow (OVF_ST_OCC), and
        kernel C keeps any number of spheres per bin."""
        self._init_max_per_bin = int(n)

    # Bin sizing: the cell floor is 2 x the largest reach, recomputed at
    # every refresh; the knobs below set a factor over that floor
    # (Engine.bin_factor). A request below the floor is clamped to it
    # with a warning: a smaller cell would miss pairs in this design.
    def _bin_floor(self) -> float:
        """2.02 x the largest sphere reach: the live margins once
        initialized, the largest template radius before."""
        if self._initialized and self.state.spheres.n:
            st = self.state
            _, margin, _, _ = sphere_pos_margins(
                st.owners, st.spheres, self.params, self._voxel_size)
            return 2.02 * float((st.spheres.radius + margin).max())
        r = [float(np.max(t.radii)) for t in self._templates if len(t.radii)]
        return 2.02 * max(r) if r else 0.0

    def _apply_bin_size(self, s: float):
        floor = self._bin_floor()
        if floor <= 0:
            return
        f = float(s) / floor
        if f < 0.999:
            warnings.warn(
                f"SetBinSize/SetInitBinSize: requested bin {s:.3e} is "
                f"below the one-bin-per-sphere floor {floor:.3e} "
                "(2 x max sphere reach); clamping to the floor. Bins "
                "smaller than the largest sphere's reach would miss "
                "contacts in this CD design.")
        if self.engine is not None:
            self.engine.bin_factor = max(1.0, f)
            self.engine._bin_perf.clear()

    def SetInitBinSize(self, s):
        """Seed the (adaptive) bin size with a cell size."""
        self._init_bin_size = float(s)
        if self._initialized:
            self._apply_bin_size(s)

    def SetBinSize(self, s):
        """Fix the bin size; turns the adaptive bin tuner off."""
        self._init_bin_size = float(s)
        self._use_adaptive_bin = False
        if self._initialized:
            self._apply_bin_size(s)
            self.engine.auto_bin = False

    def SetInitBinNumTarget(self, n):
        """Seed the bin size from a target number of bins in the
        domain."""
        n = max(int(n), 1)
        vol = float(np.prod(np.asarray(self._dims, np.float64)))
        self.SetInitBinSize((vol / n) ** (1.0 / 3.0))

    def UseAdaptiveBinSize(self, flag: bool = True):
        """Walk the bin-size factor along ``Engine.BIN_LADDER`` toward the
        cheapest measured seconds per step, as the K tuner walks K."""
        self._use_adaptive_bin = bool(flag)
        if self._initialized:
            self.engine.auto_bin = bool(flag)

    def DisableAdaptiveBinSize(self):
        """Kept for source compatibility and, as in the JAX package, does
        nothing: UseAdaptiveBinSize(False) or SetBinSize turns the bin
        tuner off."""

    def SetAdaptiveBinSizeDelaySteps(self, n):
        pass  # the bin tuner moves per measured block, not after a delay

    def SetAdaptiveBinSizeAcc(self, acc):
        pass  # see DisableAdaptiveBinSize

    def SetAdaptiveBinSizeMaxRate(self, rate):
        pass  # see DisableAdaptiveBinSize

    def SetAdaptiveBinSizeLowerProactivity(self, p):
        pass  # see DisableAdaptiveBinSize

    def SetAdaptiveBinSizeUpperProactivity(self, p):
        pass  # see DisableAdaptiveBinSize

    def SetInitBinSizeAsMultipleOfSmallestSphere(self, m):
        """Kept for source compatibility: the grid follows the largest
        reach, and the two-class CD takes wide size ratios."""

    def SetExpandSafetyMultiplier(self, m: float):
        self._expand_multi = float(m)
        if self._initialized:
            self._rebuild_params()

    def SetExpandSafetyAdder(self, v: float):
        self._expand_adder = float(v)
        if self._initialized:
            self._rebuild_params()

    def SetMaxVelocity(self, v: float):
        self._approx_max_vel = float(v)
        if self._initialized:
            self._rebuild_params()

    SetApproxMaxVelocity = SetMaxVelocity

    def SetErrorOutVelocity(self, v: float):
        self._error_out_vel = float(v)
        if self._initialized:
            self._rebuild_params()

    def SetErrorOutAvgContacts(self, n: float):
        """Error out when the average contacts per sphere exceed n."""
        self._error_out_avg_contacts = float(n)
        if self._initialized:
            self._rebuild_params()

    def SetExpandFactor(self, beta: float, fix: bool = True):
        """A fixed CD margin: with `fix`, margins stop following the
        velocity and take the constant length `beta`."""
        self._expand_adder = float(beta)
        if fix:
            self._expand_multi = 0.0
        if self._initialized:
            self._rebuild_params()

    def GetExpandFactor(self) -> float:
        """The fixed CD margin length."""
        return float(self._expand_adder)

    def SetExpandSafetyType(self, kind: str = "auto"):
        """Kept for source compatibility: margins always follow each
        sphere's measured velocity at the refresh (``sphere_pos_margins``),
        which is what 'auto' asks for."""

    def SetAdaptiveTimeStepType(self, type: str = "none"):
        """Kept for source compatibility: the step size is fixed (the
        reference warns and keeps it fixed too)."""

    # source-compatibility switches with nothing to switch here
    def SetJitifyClumpTemplates(self, flag: bool = True):
        pass  # templates are always flattened arrays

    def SetJitifyMassProperties(self, flag: bool = True):
        pass

    def SetSortContactPairs(self, flag: bool):
        pass  # tables are always sorted by owner pair at the refresh

    def EnsureKernelErrMsgLineNum(self, flag: bool = True):
        pass  # kernels are built ahead of time, not from strings

    def SetNoForceRecord(self, flag: bool = True):
        pass  # forces are recorded in the tables or on request

    def SetForceCalcThreadsPerBlock(self, n):
        pass  # each kernel picks its own launch shape

    def SetCollectAccRightAfterForceCalc(self, flag: bool = True):
        """Kept for source compatibility: the force pass always sums the
        wrenches per owner right after it (kernel A), as this asks."""

    def GetWhetherForceCollectInKernel(self) -> bool:
        """True: the wrenches are summed per owner in a kernel (A) right
        after the force pass, the only mode here."""
        return True

    # ------------------------------------------------------------------
    # output settings
    # ------------------------------------------------------------------
    def SetOutputContent(self, content):
        """Clump-file columns: OutputContent flags, or a list of their
        names (XYZ is always in)."""
        if isinstance(content, (list, tuple)):
            flags = defines.OutputContent.XYZ
            for c in content:
                flags |= defines.OutputContent[c.upper()]
            content = flags
        self._out_content = content

    def SetContactOutputContent(self, content):
        """Contact-file columns: ContactOutputContent flags or names."""
        if isinstance(content, (list, tuple)):
            flags = defines.ContactOutputContent.FORCE
            for c in content:
                flags |= defines.ContactOutputContent[c.upper()]
            content = flags
        self._cnt_out_content = content

    def _fmt(self, f):
        if isinstance(f, str):
            if f.lower() == "chpf":
                self._engine_log(
                    "WARNING",
                    "'chpf' output format maps to this package's binary "
                    "format (compressed npz, same column names; "
                    "np.load-able) — NOT the reference's external ChPF "
                    "container")
            return defines.OutputFormat(f.lower())
        return f

    def SetOutputFormat(self, fmt):
        """Clump and sphere files: CSV or BINARY (npz of the same columns;
        'chpf' is taken as BINARY and warns)."""
        self._out_format = self._fmt(fmt)

    def SetContactOutputFormat(self, fmt):
        self._cnt_out_format = self._fmt(fmt)

    def SetMeshOutputFormat(self, fmt):
        """'vtk' (the default, with facet normals) or 'obj'."""
        self._mesh_out_format = str(getattr(fmt, "value", fmt)).lower()

    def _set_flag(self, attr, flag, on):
        cur = getattr(self, attr)
        setattr(self, attr, (cur | flag) if on else (cur & ~flag))

    def EnableOwnerWildcardOutput(self, flag: bool = True):
        """The force model's owner wildcards as clump-file columns."""
        self._set_flag("_out_content",
                       defines.OutputContent.OWNER_WILDCARD, flag)

    def EnableContactWildcardOutput(self, flag: bool = True):
        self._set_flag("_cnt_out_content",
                       defines.ContactOutputContent.CNT_WILDCARD, flag)

    def EnableGeometryWildcardOutput(self, flag: bool = True):
        """The force model's geometry wildcards as sphere-file
        columns."""
        self._set_flag("_out_content",
                       defines.OutputContent.GEO_WILDCARD, flag)

    # ------------------------------------------------------------------
    # materials and bodies
    # ------------------------------------------------------------------
    def LoadMaterial(self, props: Union[Dict[str, float], DEMMaterial]):
        mat = (props if isinstance(props, DEMMaterial)
               else DEMMaterial(dict(props)))
        mat.id = len(self._materials)
        self._materials.append(mat)
        return mat

    def SetMaterialPropertyPair(self, prop: str, matA: DEMMaterial,
                                matB: DEMMaterial, val: float):
        self._pair_overrides[(prop, matA.id, matB.id)] = float(val)
        self._pair_overrides[(prop, matB.id, matA.id)] = float(val)

    def LoadClumpType(self, mass, moi, radii, relpos,
                      materials=None) -> DEMClumpTemplate:
        """A clump template; `radii` may instead be the path of a clump
        CSV (x,y,z,r columns, the data/clumps format), and then `relpos`
        is the material."""
        if isinstance(radii, (str, os.PathLike)):
            materials = relpos
            radii, relpos = io_utils.read_clump_template_csv(radii)
        radii = np.asarray(radii, np.float64).reshape(-1)
        relpos = np.asarray(relpos, np.float64).reshape(-1, 3)
        if isinstance(materials, DEMMaterial):
            materials = [materials] * len(radii)
        t = DEMClumpTemplate(
            mass=float(mass), moi=tuple(np.asarray(moi, np.float64)),
            radii=radii, relpos=relpos, materials=list(materials or []),
        )
        self._templates.append(t)
        return t

    def LoadSphereType(self, mass, radius, material) -> DEMClumpTemplate:
        i = 2.0 / 5.0 * mass * radius * radius
        return self.LoadClumpType(mass, (i, i, i), [radius], np.zeros((1, 3)),
                                  material)

    def LoadClumpTemplate(self, template: DEMClumpTemplate):
        self._templates.append(template)
        return template

    def AddClumps(self, templates, xyz) -> DEMClumpBatch:
        xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
        if isinstance(templates, DEMClumpTemplate):
            templates = [templates] * xyz.shape[0]
        if len(templates) != xyz.shape[0]:
            raise ValueError(f"{len(templates)} templates for "
                             f"{xyz.shape[0]} positions")
        b = DEMClumpBatch(templates=list(templates), xyz=xyz)
        self._batches.append(b)
        return b

    def AddExternalObject(self) -> DEMExternObj:
        o = DEMExternObj()
        self._extern_objs.append(o)
        return o

    def AddBCPlane(self, pos, normal, material=None) -> DEMExternObj:
        o = self.AddExternalObject()
        o.AddPlane(pos, normal, material)
        o.SetFamily(RESERVED_FAMILY)
        return o

    def AddWavefrontMeshObject(self, path_or_mesh, material=None,
                               load_normals=True,
                               load_uv=False) -> DEMMeshConnected:
        """A triangle mesh from an OBJ file, or a DEMMeshConnected as it
        is. A mesh is an owner of its own; its default mass of 1e30 keeps
        it in place."""
        if isinstance(path_or_mesh, DEMMeshConnected):
            mesh = path_or_mesh
        elif load_normals:
            verts, faces, nrm = load_obj(path_or_mesh, with_normals=True)
            mesh = DEMMeshConnected(vertices=verts, faces=faces,
                                    face_normals=nrm)
        else:
            verts, faces = load_obj(path_or_mesh)
            mesh = DEMMeshConnected(vertices=verts, faces=faces)
        if material is not None:
            mesh.material = material
        self._meshes.append(mesh)
        return mesh

    # ------------------------------------------------------------------
    # families
    # ------------------------------------------------------------------
    # Prescriptions and rules set after Initialize take effect at the
    # next step, contact masks, margins and materials at the next refresh.
    # A component given as a callable takes the step's start time as a
    # 0-d tensor and computes with torch (module docstring).
    def _merge_presc(self, p: FamilyPrescription):
        old = self._prescriptions.get(p.family)
        self._prescriptions[p.family] = (
            _merge_prescription(old, p) if old else p)
        if self._initialized:
            self.engine.cfg = dataclasses.replace(
                self.engine.cfg,
                prescriptions=tuple(self._prescriptions.values()))
            self.engine._config_changed()

    def SetFamilyFixed(self, family: int):
        self._merge_presc(_fixed_prescription(family))

    def _prescribe(self, family, channel, comps, dictate=True):
        """A masked vec3 channel from per-component numbers, callables or
        None (unprescribed); dictate=False takes its soft form. Position
        components are user-frame, stored relative to the domain's lower
        corner."""
        name = channel if dictate else channel + "_soft"
        offset = self._lbf if channel == "lin_pos" else (0.0, 0.0, 0.0)
        self._merge_presc(FamilyPrescription(family=family, **{
            name: Components(comps, offset),
            name + "_mask": tuple(c is not None for c in comps)}))

    def SetFamilyPrescribedLinVel(self, family: int, vx=None, vy=None,
                                  vz=None, dictate: bool = True):
        """Components may be numbers or callables of time; None leaves the
        component unprescribed. dictate=False assigns the components each
        step and lets the physics integrate on top."""
        self._prescribe(family, "lin_vel", (vx, vy, vz), dictate)

    def SetFamilyPrescribedAngVel(self, family: int, wx=None, wy=None,
                                  wz=None, dictate: bool = True):
        """Body frame; as SetFamilyPrescribedLinVel."""
        self._prescribe(family, "rot_vel", (wx, wy, wz), dictate)

    def SetFamilyPrescribedPosition(self, family: int, x=None, y=None,
                                    z=None):
        """User-frame position components."""
        self._prescribe(family, "lin_pos", (x, y, z))

    def SetFamilyPrescribedQuaternion(self, family: int, q_fn):
        q = q_fn if callable(q_fn) else Const(q_fn)
        self._merge_presc(FamilyPrescription(family=family, quat=q))

    # per-axis setters: each axis call accumulates into one 3-component
    # prescription of its channel
    def _axis_prescribe(self, family, channel, axis, expr, dictate=True):
        key = (int(family), channel, bool(dictate))
        comps = self._axis_presc.setdefault(key, [None, None, None])
        comps[axis] = expr
        self._prescribe(family, channel, tuple(comps), dictate)

    def SetFamilyPrescribedLinVelX(self, family, vx, dictate: bool = True):
        self._axis_prescribe(family, "lin_vel", 0, vx, dictate)

    def SetFamilyPrescribedLinVelY(self, family, vy, dictate: bool = True):
        self._axis_prescribe(family, "lin_vel", 1, vy, dictate)

    def SetFamilyPrescribedLinVelZ(self, family, vz, dictate: bool = True):
        self._axis_prescribe(family, "lin_vel", 2, vz, dictate)

    def SetFamilyPrescribedAngVelX(self, family, wx, dictate: bool = True):
        self._axis_prescribe(family, "rot_vel", 0, wx, dictate)

    def SetFamilyPrescribedAngVelY(self, family, wy, dictate: bool = True):
        self._axis_prescribe(family, "rot_vel", 1, wy, dictate)

    def SetFamilyPrescribedAngVelZ(self, family, wz, dictate: bool = True):
        self._axis_prescribe(family, "rot_vel", 2, wz, dictate)

    def SetFamilyPrescribedPositionX(self, family, x):
        self._axis_prescribe(family, "lin_pos", 0, x)

    def SetFamilyPrescribedPositionY(self, family, y):
        self._axis_prescribe(family, "lin_pos", 1, y)

    def SetFamilyPrescribedPositionZ(self, family, z):
        self._axis_prescribe(family, "lin_pos", 2, z)

    def CorrectFamilyLinVel(self, family: int, vx=0.0, vy=0.0, vz=0.0):
        """Velocity correction: assigned each step, with the physics
        still integrating on top."""
        self._merge_presc(FamilyPrescription(
            family=family, lin_vel_soft=Components((vx, vy, vz))))

    def CorrectFamilyAngVel(self, family: int, wx=0.0, wy=0.0, wz=0.0):
        """Angular-velocity correction, body frame."""
        self._merge_presc(FamilyPrescription(
            family=family, rot_vel_soft=Components((wx, wy, wz))))

    def CorrectFamilyPosition(self, family: int, x=0.0, y=0.0, z=0.0):
        """Position correction: the base position is re-seated to the
        given user-frame value before the step's displacement."""
        self._merge_presc(FamilyPrescription(
            family=family,
            lin_pos_soft=Components((x, y, z), offset=self._lbf)))

    def CorrectFamilyQuaternion(self, family: int, q_fn):
        """Orientation correction: the base quaternion is re-seated
        before the step's rotation is integrated."""
        q = q_fn if callable(q_fn) else Const(q_fn)
        self._merge_presc(FamilyPrescription(family=family, quat_soft=q))

    def AddFamilyPrescribedAcc(self, family: int, ax=0.0, ay=0.0, az=0.0):
        self._merge_presc(FamilyPrescription(
            family=family, acc=Components((ax, ay, az))))

    def AddFamilyPrescribedAngAcc(self, family: int, ax=0.0, ay=0.0, az=0.0):
        """Body frame."""
        self._merge_presc(FamilyPrescription(
            family=family, ang_acc=Components((ax, ay, az))))

    def _add_next_step(self, field, owner_ids, val):
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        ids = np.asarray(owner_ids, np.int64).reshape(-1)
        val = np.asarray(val, np.float32)
        owners = self.state.owners
        arr = getattr(owners, field).index_put(
            (torch.as_tensor(ids, device=self.device),),
            torch.as_tensor(np.broadcast_to(val, (len(ids), 3)).copy(),
                            device=self.device),
            accumulate=True)
        self.state = self.state.replace(owners=owners.replace(**{field: arr}))
        return ids, val

    def AddOwnerNextStepAcc(self, owner_ids, acc):
        """Extra linear acceleration of the named owners for the NEXT
        step only: cleared after the next stepping call's first step."""
        ids, val = self._add_next_step("ext_acc", owner_ids, acc)
        self._next_step_acc.append(("ext_acc", ids, val))

    def AddOwnerNextStepAngAcc(self, owner_ids, ang_acc):
        """Extra body-frame angular acceleration for the next step only."""
        ids, val = self._add_next_step("ext_ang_acc", owner_ids, ang_acc)
        self._next_step_acc.append(("ext_ang_acc", ids, val))

    def _clear_next_step_acc(self):
        pending, self._next_step_acc = self._next_step_acc, []
        for field, ids, val in pending:
            self._add_next_step(field, ids, -val)

    def ChangeClumpFamily(self, to_family: int, owner_ids=None, IDs=None):
        """Re-family specific clump owners."""
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        self.SetOwnerFamily(owner_ids if owner_ids is not None else IDs,
                            to_family)

    def SetOwnerFamily(self, ids, family: int):
        owners = self.state.owners
        fam = owners.family.clone()
        fam[torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                            device=self.device)] = int(family)
        self.state = self.state.replace(owners=owners.replace(family=fam))

    def _set_owner_rows(self, ids, **fields):
        """Owner fields at rows `ids`, each one indexed write on the
        device."""
        owners = self.state.owners
        idx = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                              device=self.device)
        new = {}
        for name, val in fields.items():
            arr = getattr(owners, name).clone()
            arr[idx] = torch.as_tensor(val, dtype=arr.dtype,
                                       device=self.device)
            new[name] = arr
        self.state = self.state.replace(owners=owners.replace(**new))

    def SetOwnerPosition(self, ids, pos):
        """User-frame positions of the owners `ids` ((n, 3), or one row
        for all): one encode on the host, one write on the device."""
        n = np.asarray(ids).reshape(-1).shape[0]
        p = np.broadcast_to(np.asarray(pos, np.float64), (n, 3))
        vox, loc = encode_host(p - self._lbf, self._voxel_size)
        self._set_owner_rows(ids, vox=vox, loc=loc)

    def SetOwnerVelocity(self, ids, vel):
        self._set_owner_rows(ids, vel=np.asarray(vel, np.float32))

    def SetOwnerAngVel(self, ids, angvel):
        """Body frame, as the tracker's SetAngVel."""
        self._set_owner_rows(ids, omg=np.asarray(angvel, np.float32))

    def SetOwnerOriQ(self, ids, oriq):
        """(w, x, y, z), normalised."""
        q = np.asarray(oriq, np.float32)
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        self._set_owner_rows(ids, quat=q)

    def ChangeFamily(self, from_family: int, to_family: int):
        if not self._initialized:
            raise RuntimeError("ChangeFamily needs an initialized solver")
        owners = self.state.owners
        fam = torch.where(owners.family == from_family, to_family,
                          owners.family)
        self.state = self.state.replace(owners=owners.replace(family=fam))

    def ChangeFamilyWhen(self, from_family: int, to_family: int, condition):
        """condition: (OwnerView, t) -> bool[N] tensor, evaluated every
        step after the integrator. view.pos is LBF-relative (the internal
        frame): add solver._lbf to user-frame thresholds. Rules do not
        cascade within a step. Initialize takes the rules added before
        it; as in the JAX package, a rule added after it is kept in the
        list but never runs."""
        self._family_changes.append(
            FamilyChange(from_family, to_family, condition))

    def _mask_changed(self):
        # kernel C and the SA/ST searches test the mask at every refresh
        if self._initialized:
            self._rebuild_params()

    def DisableContactBetweenFamilies(self, famA: int, famB: int):
        self._family_mask[famA, famB] = False
        self._family_mask[famB, famA] = False
        self._mask_changed()

    def EnableContactBetweenFamilies(self, famA: int, famB: int):
        self._family_mask[famA, famB] = True
        self._family_mask[famB, famA] = True
        self._mask_changed()

    def DisableFamilyContact(self, fam: int):
        self._family_mask[fam, :] = False
        self._family_mask[:, fam] = False
        self._mask_changed()

    def SetFamilyExtraMargin(self, family: int, margin: float):
        """Extra CD margin of a family's geometry."""
        self._family_extra_margin[family] = margin
        if self._initialized:
            self._rebuild_params()

    def SetFamilyClumpMaterial(self, family: int, material):
        """The material of every sphere whose owner is in `family`; the
        next refresh premixes it into the contact tables."""
        st = self.state
        mid = material.id if hasattr(material, "id") else int(material)
        fam = st.owners.family[st.spheres.owner.long()]
        self.state = st.replace(spheres=st.spheres.replace(
            mat=torch.where(fam == family, mid, st.spheres.mat)))

    # ------------------------------------------------------------------
    # force models, wildcards and persistent contacts
    # ------------------------------------------------------------------
    def UseFrictionlessHertzianModel(self) -> ForceModel:
        self._force_model = HertzianFrictionlessForceModel()
        return self._force_model

    def UseFrictionalHertzianModel(self) -> ForceModel:
        self._force_model = HertzianForceModel()
        return self._force_model

    def DefineContactForceModel(self, model: ForceModel) -> ForceModel:
        """Install a force model whose callable computes with torch
        operations (module docstring). Call before Initialize."""
        self._force_model = model
        return model

    def SetContactWildcards(self, names):
        self._force_model.SetPerContactWildcards(tuple(names))

    def SetOwnerWildcards(self, names):
        self._force_model.SetPerOwnerWildcards(tuple(names))

    def SetGeometryWildcards(self, names):
        self._force_model.SetPerGeometryWildcards(tuple(names))

    # Wildcard values live on the device: a setter is one write there, a
    # getter one copy to the host.
    def _tables(self):
        return (("ss", self.state.ss), ("st", self.state.st),
                ("sa", self.state.sa))

    def _set_table_wildcard(self, name, sel_of, val):
        """`name` := val on the rows sel_of(table) selects (every row where
        sel_of is None) of each table that carries the wildcard."""
        for tname, table in self._tables():
            if name not in table.wildcards:
                continue
            wc = dict(table.wildcards)
            wc[name] = (torch.full_like(wc[name], float(val))
                        if sel_of is None else
                        torch.where(sel_of(table), float(val), wc[name]))
            self.state = self.state.replace(
                **{tname: table.replace(wildcards=wc)})

    def SetContactWildcardValueAll(self, name: str, val: float):
        self._set_table_wildcard(name, None, val)

    def SetContactWildcardValue(self, name: str, val: float):
        """Every contact of every table."""
        self.SetContactWildcardValueAll(name, val)

    def _contact_family_sel(self, table, famA, famB=None):
        """Live rows with either side in famA (famB None), or the pair
        exactly (famA, famB) in either order."""
        fam = self.state.owners.family
        live = table.idA >= 0
        fa = fam[torch.clamp(table.own_a, min=0).long()]
        fb = fam[torch.clamp(table.own_b, min=0).long()]
        if famB is None:
            return live & ((fa == famA) | (fb == famA))
        return live & (((fa == famA) & (fb == famB))
                       | ((fa == famB) & (fb == famA)))

    def SetFamilyContactWildcardValue(self, famA: int, *args):
        """(N1, N2, name, val): contacts between families N1 and N2; or
        (N, name, val): contacts with either side in N."""
        if len(args) == 3:
            famB, name, val = args
        else:
            (name, val), famB = args, None
        self._set_table_wildcard(
            name, lambda t: self._contact_family_sel(t, famA, famB), val)

    def SetFamilyContactWildcardValueEither(self, family: int, name: str,
                                            val: float):
        self.SetFamilyContactWildcardValue(family, name, val)

    def SetFamilyContactWildcardValueBoth(self, family: int, name: str,
                                          val: float):
        self.SetFamilyContactWildcardValue(family, family, name, val)

    def GetAllContactWildcardValue(self, name: str):
        """The wildcard on every live contact: SS rows, then ST, then SA."""
        out = [t.wildcards[name][:t.count] for _, t in self._tables()
               if name in t.wildcards]
        return _np(torch.cat(out)) if out else np.zeros(0, np.float32)

    def _set_wildcard(self, group, name, vals, ids):
        """Wildcard `name` of the state's `group` (owners, spheres, tris,
        anals): every entry set to vals (ids None), else the entries
        ids."""
        ent = getattr(self.state, group)
        wc = dict(ent.wildcards)
        v = torch.as_tensor(np.asarray(vals, np.float32), device=self.device)
        if ids is None:
            wc[name] = torch.broadcast_to(v, (ent.n,)).clone()
        else:
            arr = wc.get(name)
            arr = (torch.zeros(ent.n, dtype=defines.F, device=self.device)
                   if arr is None else arr.clone())
            arr[torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                                device=self.device)] = v
            wc[name] = arr
        self.state = self.state.replace(
            **{group: ent.replace(wildcards=wc)})

    def _get_wildcard(self, group, name, ids=None):
        wc = getattr(self.state, group).wildcards[name]
        if ids is not None:
            wc = wc[torch.as_tensor(np.asarray(ids, np.int64),
                                    device=self.device)]
        return _np(wc)

    def SetOwnerWildcardValue(self, name: str, vals, owner_ids=None):
        self._set_wildcard("owners", name, vals, owner_ids)

    def GetOwnerWildcardValue(self, name: str, ids=None):
        return self._get_wildcard("owners", name, ids)

    def SetFamilyOwnerWildcardValue(self, family: int, name: str,
                                    val: float):
        """The owner wildcard of every owner in `family`."""
        owners = self.state.owners
        wc = dict(owners.wildcards)
        arr = wc.get(name)
        if arr is None:
            arr = torch.zeros(owners.n, dtype=defines.F, device=self.device)
        wc[name] = torch.where(owners.family == family, float(val), arr)
        self.state = self.state.replace(owners=owners.replace(wildcards=wc))

    def GetFamilyOwnerWildcardValue(self, family: int, name: str):
        o = self.state.owners
        return _np(o.wildcards[name][o.family == family])

    def SetGeometryWildcardValue(self, name: str, vals, geo_ids=None):
        """Sphere geometry wildcards."""
        self._set_wildcard("spheres", name, vals, geo_ids)

    def GetGeometryWildcardValue(self, name: str, ids=None):
        return self._get_wildcard("spheres", name, ids)

    def SetSphereWildcardValue(self, geo_id, name: str, vals):
        """Spheres geo_id, geo_id + 1, ... take the values of `vals`."""
        vals = np.atleast_1d(np.asarray(vals, np.float32))
        self.SetGeometryWildcardValue(
            name, vals, geo_ids=np.arange(int(geo_id),
                                          int(geo_id) + len(vals)))

    def GetSphereWildcardValue(self, geo_id, name: str, n: int = 1):
        """n values from sphere geo_id on."""
        return _np(self.state.spheres.wildcards[name][
            int(geo_id):int(geo_id) + int(n)])

    def SetTriWildcardValue(self, name: str, vals, tri_ids=None):
        self._set_wildcard("tris", name, vals, tri_ids)

    def GetTriWildcardValue(self, name: str, ids=None):
        return self._get_wildcard("tris", name, ids)

    def SetAnalWildcardValue(self, name: str, vals, comp_ids=None):
        self._set_wildcard("anals", name, vals, comp_ids)

    def GetAnalWildcardValue(self, name: str, ids=None):
        return self._get_wildcard("anals", name, ids)

    def _persistency_on(self):
        """Persistency on; after Initialize in the engine's config too,
        so the next refresh re-injects."""
        self._use_persistency = True
        if self._initialized and not self.engine.cfg.use_persistency:
            self.engine.cfg = dataclasses.replace(self.engine.cfg,
                                                  use_persistency=True)
            self.engine._config_changed()

    def _set_persist(self, value: int, famA=None, famB=None, both=False):
        """Mark (1) or unmark (0) the contacts that exist now, once: no
        rule for later contacts."""
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        fam = self.state.owners.family
        for tname, table in self._tables():
            live = table.idA >= 0
            if famA is None:
                sel = live
            elif famB is not None:
                sel = self._contact_family_sel(table, famA, famB)
            else:
                fa = fam[torch.clamp(table.own_a, min=0).long()]
                fb = fam[torch.clamp(table.own_b, min=0).long()]
                sel = live & (((fa == famA) & (fb == famA)) if both
                              else ((fa == famA) | (fb == famA)))
            self.state = self.state.replace(**{tname: table.replace(
                persist=torch.where(sel, value, table.persist))})
        if value:
            self._persistency_on()

    def MarkPersistentContact(self):
        """Every contact that exists now stays in its table until removed
        (before Initialize: every family pair, as a rule)."""
        if self._initialized:
            self._set_persist(1)
        else:
            self._use_persistency = True
            self._family_persist[:, :] = True

    def MarkFamilyPersistentContactEither(self, family: int):
        self._set_persist(1, famA=family, both=False)

    def MarkFamilyPersistentContactBoth(self, family: int):
        self._set_persist(1, famA=family, both=True)

    def MarkFamilyPersistentContact(self, family: Optional[int] = None):
        """Contacts involving `family` (every family if None), detected at
        any later refresh, stay in their table with their wildcards when
        no longer detected: the bonded-particle and fracture models."""
        if family is None:
            self._family_persist[:, :] = True
        else:
            self._family_persist[family, :] = True
            self._family_persist[:, family] = True
        self._persistency_on()
        if self._initialized:
            self._rebuild_params()

    def MarkPersistentContactBetweenFamilies(self, famA: int, famB: int):
        self._family_persist[famA, famB] = True
        self._family_persist[famB, famA] = True
        self._persistency_on()
        if self._initialized:
            self._rebuild_params()

    def RemovePersistentContact(self):
        if self._initialized:
            self._set_persist(0)
        self._family_persist[:, :] = False
        if self._initialized:
            self._rebuild_params()

    def RemoveFamilyPersistentContactEither(self, family: int):
        self._set_persist(0, famA=family, both=False)
        self._family_persist[family, :] = False
        self._family_persist[:, family] = False
        self._rebuild_params()

    def RemoveFamilyPersistentContactBoth(self, family: int):
        self._set_persist(0, famA=family, both=True)
        self._family_persist[family, family] = False
        self._rebuild_params()

    def RemoveFamilyPersistentContact(self, famA: int, famB: int):
        self._set_persist(0, famA=famA, famB=famB)
        self._family_persist[famA, famB] = False
        self._family_persist[famB, famA] = False
        self._rebuild_params()

    # ------------------------------------------------------------------
    # trackers
    # ------------------------------------------------------------------
    def Track(self, obj) -> DEMTracker:
        if self._initialized:
            return self._make_tracker(obj)
        t = DEMTracker(self, [], obj)
        self._pending_trackers.append(t)
        return t

    def PythonTrack(self, obj) -> DEMTracker:
        """Track, under the reference's name for python callers."""
        return self.Track(obj)

    def _make_tracker(self, obj):
        if isinstance(obj, DEMClumpBatch):
            ids = np.arange(obj.owner_offset, obj.owner_offset + obj.n)
        elif isinstance(obj, (DEMExternObj, DEMMeshConnected)):
            ids = np.asarray([obj.owner_id])
        else:
            raise TypeError(f"cannot track {type(obj)}")
        return DEMTracker(self, ids, obj)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _flatten_batch(self, b: DEMClumpBatch, oid0: int) -> dict:
        """One batch's owner and sphere arrays, clump by clump in batch
        order, built per distinct template instead of per clump; with the
        batch's distinct templates (`kinds`), each clump's index into
        them and each clump's volume (the template's, else the sum of its
        spheres')."""
        n = b.n
        slot: Dict[int, int] = {}
        kinds: List[DEMClumpTemplate] = []
        t_idx = np.empty(n, np.int64)
        for i, t in enumerate(b.templates):
            k = slot.get(id(t))
            if k is None:
                k = slot[id(t)] = len(kinds)
                kinds.append(t)
            t_idx[i] = k
        vol_t = np.asarray([
            t.volume if t.volume is not None
            else float((4.0 / 3.0 * np.pi * np.asarray(t.radii) ** 3).sum())
            for t in kinds], np.float64)
        n_comp_t = np.asarray([t.n_comp for t in kinds], np.int64)
        n_comp = n_comp_t[t_idx]
        t_off = np.cumsum(n_comp_t) - n_comp_t
        starts = np.cumsum(n_comp) - n_comp
        within = np.arange(int(n_comp.sum())) - np.repeat(starts, n_comp)
        comp = np.repeat(t_off[t_idx], n_comp) + within

        def per_comp(get):
            return np.concatenate([np.asarray(get(t)) for t in kinds])

        mats = per_comp(lambda t: [m.id if m is not None else 0
                                   for m in t.materials] or [0] * t.n_comp)

        def per_clump(arr, default):
            if arr is None:
                return np.tile(np.asarray(default, np.float64), (n, 1))
            return np.asarray(arr, np.float64).reshape(n, -1)

        model = self._force_model
        # owner wildcards per clump; a geometry wildcard is given per
        # clump too and covers every sphere of it (as in the JAX package);
        # names the model declares but the batch lacks are zero
        owner_wc = {k: np.broadcast_to(np.asarray(
            b.owner_wildcards.get(k, 0.0), np.float32).reshape(-1),
            (n,)) for k in model.owner_wildcards}
        geo_wc = {}
        for k in model.geo_wildcards:
            gw = np.asarray(b.geo_wildcards.get(k, ()), np.float32)
            vals = (gw.reshape(-1)[:n] if gw.size >= n
                    else np.zeros(n, np.float32))
            geo_wc[k] = np.repeat(vals, n_comp)
        return dict(
            owner_wc=owner_wc, geo_wc=geo_wc,
            pos=b.xyz - self._lbf,
            quat=per_clump(b.oriq, [1.0, 0.0, 0.0, 0.0]),
            vel=per_clump(b.vel, [0.0, 0.0, 0.0]),
            omg=per_clump(b.ang_vel, [0.0, 0.0, 0.0]),
            family=(np.asarray(b.families, np.int64) if b.families is not None
                    else np.full(n, DEFAULT_FAMILY, np.int64)),
            mass=np.asarray([t.mass for t in kinds], np.float64)[t_idx],
            moi=np.asarray([np.asarray(t.moi, np.float64) for t in kinds])[
                t_idx],
            s_owner=np.repeat(oid0 + np.arange(n), n_comp),
            s_rel=per_comp(lambda t: np.asarray(t.relpos, np.float64)
                           .reshape(-1, 3))[comp],
            s_rad=per_comp(lambda t: np.asarray(t.radii, np.float64))[comp],
            s_mat=mats[comp],
            kinds=kinds, t_idx=t_idx, volume=vol_t[t_idx],
        )

    def Initialize(self, dry_run: bool = False):
        dims = self._dims
        self._voxel_size = choose_voxel_size(dims)
        model = self._force_model

        if self._bounding_bc in ("all", "top_open"):
            self._add_bounding_planes()

        # owners: clumps, then analytical objects, then meshes
        parts = []
        oid = 0
        n_sph = 0
        for b in self._batches:
            b.owner_offset, b.sphere_offset = oid, n_sph
            parts.append(self._flatten_batch(b, oid))
            oid += b.n
            n_sph += len(parts[-1]["s_owner"])
        self._n_clump_owners = oid
        self._owner_templates = [t for p in parts for t in p["kinds"]]
        starts = np.cumsum([0] + [len(p["kinds"]) for p in parts])
        self._owner_tmpl_idx = np.concatenate(
            [p["t_idx"] + k0 for p, k0 in zip(parts, starts)]
            or [np.zeros(0, np.int64)])
        self._owner_volume = np.concatenate(
            [p["volume"] for p in parts] or [np.zeros(0)])

        ext = dict(pos=[], quat=[], family=[], mass=[], moi=[])
        a_owner, a_type, a_rel, a_dir, a_size, a_sign, a_mat = (
            [], [], [], [], [], [], [])
        for obj in self._extern_objs:
            obj.owner_id = oid
            ext["pos"].append(np.asarray(obj.init_pos) - self._lbf)
            ext["quat"].append(obj.init_quat)
            ext["family"].append(obj.family)
            ext["mass"].append(obj.mass)
            ext["moi"].append(obj.moi)
            for c in obj.components:
                a_owner.append(oid)
                a_type.append(c.objtype)
                a_rel.append(np.asarray(c.relpos) - np.asarray(obj.init_pos))
                a_dir.append(c.direction)
                a_size.append(c.size)
                a_sign.append(c.normal_sign)
                a_mat.append(c.material.id if c.material else 0)
            oid += 1
        t_owner, t_nodes, t_mat = [], [], []
        for mesh in self._meshes:
            mesh.owner_id = oid
            mesh.tri_offset = sum(len(x) for x in t_owner)
            ext["pos"].append(np.asarray(mesh.init_pos) - self._lbf)
            ext["quat"].append(mesh.init_quat)
            ext["family"].append(mesh.family)
            ext["mass"].append(mesh.mass)
            ext["moi"].append(mesh.moi)
            t_owner.append(np.full(mesh.n_tri, oid))
            t_nodes.append(np.asarray(mesh.vertices, np.float64)[
                np.asarray(mesh.faces)])
            t_mat.append(
                np.asarray(mesh.face_materials)
                if mesh.face_materials is not None
                else np.full(mesh.n_tri,
                             mesh.material.id if mesh.material else 0))
            oid += 1
        n_ext = len(self._extern_objs) + len(self._meshes)
        n_owners = oid
        if n_owners == 0:
            raise RuntimeError("nothing to simulate: add clumps first")

        def cat(key, ext_rows, width):
            rows = [p[key].reshape(-1, width) for p in parts]
            if n_ext:
                rows.append(np.asarray(ext_rows, np.float64).reshape(-1,
                                                                     width))
            return np.concatenate(rows)

        z3 = np.zeros((n_ext, 3))

        def wc_cat(key, names, n_rest):
            # non-clump owners carry zeros
            return {k: np.concatenate([p[key][k] for p in parts]
                                      + [np.zeros(n_rest, np.float32)])
                    for k in names}

        owners = make_owners(
            pos=cat("pos", ext["pos"], 3), voxel_size=self._voxel_size,
            quat=cat("quat", ext["quat"], 4), vel=cat("vel", z3, 3),
            omg=cat("omg", z3, 3),
            family=cat("family", ext["family"], 1).reshape(-1),
            mass=cat("mass", ext["mass"], 1).reshape(-1),
            moi=cat("moi", ext["moi"], 3),
            wildcards=wc_cat("owner_wc", model.owner_wildcards, n_ext),
            device=self.device,
        )

        def scat(key, width=None):
            if not parts:
                return np.zeros((0, width) if width else (0,))
            return np.concatenate([p[key] for p in parts])

        spheres = make_spheres(owner=scat("s_owner"), relpos=scat("s_rel", 3),
                               radius=scat("s_rad"), mat=scat("s_mat"),
                               wildcards=wc_cat("geo_wc", model.geo_wildcards,
                                                0),
                               device=self.device)
        anals = make_analyticals(
            owner=np.asarray(a_owner), objtype=np.asarray(a_type),
            relpos=np.asarray(a_rel).reshape(-1, 3),
            direction=np.asarray(a_dir).reshape(-1, 3),
            size=np.asarray(a_size).reshape(-1, 3),
            normal_sign=np.asarray(a_sign), mat=np.asarray(a_mat),
            device=self.device,
        )
        tris = make_triangles(
            owner=np.concatenate(t_owner) if t_owner else np.zeros(0),
            nodes=(np.concatenate(t_nodes) if t_nodes
                   else np.zeros((0, 3, 3))),
            mat=np.concatenate(t_mat) if t_mat else np.zeros(0),
            device=self.device)
        n_spheres = spheres.n
        # polydisperse beds (radius ratio above 1.7 with real mass in both
        # classes) take the two-class CD: one grid's bin occupancy grows
        # as the cube of the radius ratio
        radii = scat("s_rad")
        self._cls_thr = 0.0
        two_class = False
        if radii.size and self._cd_two_class is not False:
            rmin, rmax = float(radii.min()), float(radii.max())
            if rmin > 0 and rmax / rmin > 1.7:
                thr = float(np.sqrt(rmin * rmax))
                frac = float(np.mean(radii <= thr))
                if 0.05 < frac < 0.999 or self._cd_two_class:
                    self._cls_thr = thr
                    two_class = True

        cap_ss = -(-max(512, int(5 * n_spheres)) // 512) * 512
        cap_st = max(64, 4 * tris.n) if tris.n else 8
        # a sphere can rest against several analytical components at once
        cap_sa = max(64, min(2, anals.n) * n_spheres) if anals.n else 8
        on_card = self.device.type == "cuda"
        cfg = SolverConfig(
            voxel_size=self._voxel_size,
            integrator=self._integrator,
            force_model=model,
            cap_ss=cap_ss,
            cap_st=cap_st,
            cap_sa=cap_sa,
            prescriptions=tuple(self._prescriptions.values()),
            family_changes=tuple(self._family_changes),
            cd_two_class=two_class,
            # unique fetch belongs to the fused SS pass
            uniq_cap=(self._uniq_cap if on_card and forces.fused_ss(model)
                      else 0),
            use_persistency=self._use_persistency,
        )
        self.state = make_state(owners, spheres, cfg, tris=tris,
                                anals=anals)
        cfg = self._seed_existing_contacts(cfg)
        # per owner: its template, -1 past the clumps
        self._owner_tmpl_idx = np.concatenate(
            [self._owner_tmpl_idx, np.full(n_ext, -1, np.int64)])
        self._set_volume_dev()
        self.engine = Engine(cfg)
        self.engine.auto_freq = self._adaptive_freq
        self.engine.max_freq = self._max_update_freq
        self.engine.auto_bin = self._use_adaptive_bin
        # the engine's growth and tuner events go to the verbosity sink
        self.engine.log = self._engine_log
        self._rebuild_params()
        self._initialized = True
        if self._init_bin_size:
            self._apply_bin_size(self._init_bin_size)
        for t in self._pending_trackers:
            t.owner_ids = self._make_tracker(t.obj).owner_ids
        self._engine_log(
            "INFO", f"initialized on {self.device}: {n_owners} owners, "
            f"{n_spheres} spheres, {tris.n} triangles, {anals.n} "
            f"analytical components; voxel={self._voxel_size:.3e}"
            + ("; two-class CD" if two_class else ""))
        if dry_run:
            self.state = self.engine.refresh(self.state, self.params)
        return self

    def _set_volume_dev(self):
        """The inspectors' per-owner volumes on the device: the clumps'
        volumes in order from owner 0, zero after them. After UpdateClumps
        the inserted clumps' volumes follow the first clumps' in that
        order, as in the JAX package, not at their owner ids."""
        vol = np.zeros(self.state.owners.n, np.float32)
        m = min(len(self._owner_volume), len(vol))
        vol[:m] = self._owner_volume[:m]
        self._volume_dev = torch.as_tensor(vol, device=self.device)

    def _seed_existing_contacts(self, cfg):
        """Restart contacts (``SetExistingContacts``, sphere ids local to
        their batch) and their wildcards into the initial SS table, so
        that the first refresh carries their history to the pairs it
        detects again. Returns the config, with cap_ss raised where the
        seeds exceed it (the engine's tables and config keep one
        capacity)."""
        lo, hi, segs = [], [], []
        pos = 0
        for b in self._batches:
            if not b.existing_contacts:
                continue
            off = b.sphere_offset
            a = np.asarray(b.existing_contacts["idA"], np.int64) + off
            c = np.asarray(b.existing_contacts["idB"], np.int64) + off
            lo.append(np.minimum(a, c))
            hi.append(np.maximum(a, c))
            segs.append((pos, len(a), b.existing_contact_wildcards or {}))
            pos += len(a)
        if not lo:
            return cfg
        n = pos
        if n > cfg.cap_ss:
            cfg = dataclasses.replace(
                cfg, cap_ss=-(-(int(1.25 * n) + 64) // 512) * 512)
        old = self.state.ss
        table = empty_ss_table(cfg, cfg.cap_ss, self.device,
                               old.uniq_a.shape[0])
        idA, idB = table.idA.clone(), table.idB.clone()
        idA[:n] = torch.as_tensor(np.concatenate(lo), device=self.device)
        idB[:n] = torch.as_tensor(np.concatenate(hi), device=self.device)
        # each batch's wildcards land at its own rows: batches may carry
        # different names
        wc = dict(table.wildcards)
        for k in wc:
            vals = np.zeros(n, np.float32)
            found = False
            for start, cnt, d in segs:
                if k in d:
                    vals[start:start + cnt] = np.asarray(d[k], np.float32)
                    found = True
            if found:
                w = wc[k].clone()
                w[:n] = torch.as_tensor(vals, device=self.device)
                wc[k] = w
        self.state = self.state.replace(ss=table.replace(
            idA=idA, idB=idB, wildcards=wc,
            count=torch.tensor(n, dtype=defines.I, device=self.device)))
        return cfg

    def _add_bounding_planes(self):
        mat = self._bounding_bc_mat or (
            self._materials[0] if self._materials else None)
        lo = self._lbf
        hi = self._lbf + self._dims
        obj = self.AddExternalObject()
        obj.SetFamily(RESERVED_FAMILY)
        obj.AddPlane([0, 0, lo[2]], [0, 0, 1], mat)
        if self._bounding_bc == "all":
            obj.AddPlane([0, 0, hi[2]], [0, 0, -1], mat)
        obj.AddPlane([lo[0], 0, 0], [1, 0, 0], mat)
        obj.AddPlane([hi[0], 0, 0], [-1, 0, 0], mat)
        obj.AddPlane([0, lo[1], 0], [0, 1, 0], mat)
        obj.AddPlane([0, hi[1], 0], [0, -1, 0], mat)

    def _rebuild_params(self):
        mat_props, pair_props = self._mat_tables()
        self.params = make_params(
            h=self._h,
            gravity=self._gravity,
            domain=self._dims,
            materials=mat_props,
            pair_materials=pair_props,
            update_freq=self._update_freq,
            expand_safety_multi=self._expand_multi,
            expand_safety_adder=self._expand_adder,
            approx_max_vel=self._approx_max_vel,
            error_out_vel=self._error_out_vel,
            error_out_avg_contacts=self._error_out_avg_contacts,
            family_mask=self._family_mask,
            family_persist=self._family_persist,
            family_extra_margin=self._family_extra_margin,
            cls_thr=self._cls_thr,
            device=self.device,
        )

    def _mat_tables(self):
        """Per-material and pairwise (mean of the two, unless overridden)
        property tables over the loaded materials."""
        model = self._force_model
        M = max(len(self._materials), 1)
        mat_props = {}
        for name in set(model.per_material_props):
            tab = np.zeros(M, np.float32)
            for i, m in enumerate(self._materials):
                tab[i] = m.props.get(name, 0.0)
            mat_props[name] = tab
        pair_props = {}
        for name in set(model.pairwise_props):
            base = np.zeros(M, np.float32)
            for i, m in enumerate(self._materials):
                base[i] = m.props.get(name, 0.0)
            tab = 0.5 * (base[:, None] + base[None, :])
            for (pname, ia, ib), v in self._pair_overrides.items():
                if pname == name:
                    tab[ia, ib] = v
            pair_props[name] = tab
        return mat_props, pair_props

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def DoDynamics(self, duration: float):
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        n_steps = int(round(duration / self._h))
        t0 = _time.perf_counter()
        with tracing.frame():
            if self._next_step_acc and n_steps > 1:
                # one-shot next-step accelerations apply to the first
                # step only
                self.state = self.engine.advance(self.state, self.params,
                                                 1, self._update_freq)
                self._clear_next_step_acc()
                n_steps -= 1
            self.state = self.engine.advance(self.state, self.params,
                                             n_steps, self._update_freq)
            if self._next_step_acc:
                self._clear_next_step_acc()
            with tracing.span("frame.tail"):
                with tracing.waited(self.engine.timers, "frame"):
                    self._sync()
                # the engine's chunk timers are complete after the sync
                self.engine.read_timers()
                self._timers["total"] += _time.perf_counter() - t0
                self._n_steps_done += n_steps
                self._check_lost_contacts()

    @property
    def _n_refreshes(self) -> int:
        """The CD refreshes the engine ran since ClearTimingStats, retries
        included, as far as its timers are folded (all of them after
        DoDynamics)."""
        t = self.engine.timers
        return t["refresh_n"] + t["retries"]

    def _check_lost_contacts(self):
        """Contacts that carried friction history but were not
        re-detected at a refresh lost it silently: report them."""
        with tracing.waited(self.engine.timers, "lost"):
            lost = int(self.state.lost_contacts)
        if lost > self._lost_reported:
            msg = (f"{lost - self._lost_reported} contact(s) with live "
                   f"history were not re-detected at a CD refresh and lost "
                   f"their wildcards (total {lost}); consider "
                   f"MarkPersistentContact or larger margins")
            self._anomalies.append(msg)
            self._engine_log("STEP_METRIC", msg)
            self._lost_reported = lost

    def DoStepDynamics(self):
        self.state = self.engine.advance(self.state, self.params, 1,
                                         self._update_freq)
        if self._next_step_acc:
            self._clear_next_step_acc()
        self._n_steps_done += 1

    def DoDynamicsThenSync(self, duration: float):
        self.DoDynamics(duration)

    def SyncMemoryTransfer(self):
        """Wait until the work queued on the card is done."""
        self._sync()

    def UpdateSimParams(self):
        self._rebuild_params()

    def InstructNumOwners(self, n: int):
        """An owner-count hint: capacities here follow what Initialize
        loads and grow on overflow, so it is not needed."""

    # ------------------------------------------------------------------
    # changes of the clump set mid-run
    # ------------------------------------------------------------------
    def UpdateClumps(self):
        """Insert the batches staged by AddClumps after Initialize into
        the running simulation. The new clumps take owner ids after every
        owner there is (the analytical and mesh owners too) and sphere ids
        after every sphere, so the contact tables keep their rows; the
        next refresh finds the new pairs and grows a table that overflows
        (``Engine.grow_for``). As in the JAX package, the new owners'
        and spheres' wildcards start at zero."""
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        pending = [b for b in self._batches if b.owner_offset is None]
        if not pending:
            return
        model = self._force_model
        st = self.state
        n0, s0 = st.owners.n, st.spheres.n
        parts = []
        oid, n_sph = n0, s0
        for b in pending:
            b.owner_offset, b.sphere_offset = oid, n_sph
            parts.append(self._flatten_batch(b, oid))
            oid += b.n
            n_sph += len(parts[-1]["s_owner"])

        def cat(key, width=None):
            a = np.concatenate([p[key] for p in parts])
            return a if width is None else a.reshape(-1, width)

        new_owners = make_owners(
            pos=cat("pos", 3), voxel_size=self._voxel_size,
            quat=cat("quat", 4), vel=cat("vel", 3), omg=cat("omg", 3),
            family=cat("family"), mass=cat("mass"), moi=cat("moi", 3),
            wildcards={k: np.zeros(oid - n0, np.float32)
                       for k in model.owner_wildcards},
            device=self.device)
        new_spheres = make_spheres(
            owner=cat("s_owner"), relpos=cat("s_rel", 3),
            radius=cat("s_rad"), mat=cat("s_mat"),
            wildcards={k: np.zeros(n_sph - s0, np.float32)
                       for k in model.geo_wildcards},
            device=self.device)
        spheres = Spheres(
            **{f: torch.cat([getattr(st.spheres, f),
                             getattr(new_spheres, f)])
               for f in ("owner", "relpos", "radius", "mat")},
            wildcards={k: torch.cat([v, new_spheres.wildcards[k]])
                       for k, v in st.spheres.wildcards.items()})
        k0 = len(self._owner_templates)
        self._owner_templates += [t for p in parts for t in p["kinds"]]
        starts = k0 + np.cumsum([0] + [len(p["kinds"]) for p in parts])
        self._owner_tmpl_idx = np.concatenate(
            [self._owner_tmpl_idx]
            + [p["t_idx"] + k for p, k in zip(parts, starts)])
        self._owner_volume = np.concatenate(
            [self._owner_volume] + [p["volume"] for p in parts])
        self._n_clump_owners += oid - n0
        self._resized(st.replace(owners=concat_owners(st.owners, new_owners),
                                 spheres=spheres))

    def _resized(self, state):
        """Take `state`, whose owner or sphere count changed, and rebuild
        what is keyed on those counts: the inspectors' volumes, the SS
        table's unique-fetch lists (sized by the owner count; the next
        refresh fills them) and the K tuner's measurements."""
        cfg = self.engine.cfg
        ss = state.ss
        if cfg.uniq_cap:
            ss = ss.replace(**uniq_fields(cfg, ss.cap, state.owners.n,
                                          self.device))
        self.state = state.replace(ss=ss)
        self._set_volume_dev()
        self._ss_query = None
        self.engine._config_changed()

    def PurgeFamily(self, family: int):
        """Remove the clumps of `family`: among the owner ids below
        GetNumClumps(), as the JAX package selects them, so after an
        UpdateClumps the last inserted clumps, one for each analytical or
        mesh owner, are not candidates. Owner ids are renumbered in the
        spheres, triangles, analytical components and the trackers made
        before Initialize; the contact tables start empty, as after
        Initialize, so friction history and persistent rows are lost."""
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        st = self.state
        fam = _np(st.owners.family)
        kill = (fam == family) & (np.arange(len(fam)) < self._n_clump_owners)
        if not kill.any():
            return
        keep = ~kill
        new_id = np.cumsum(keep) - 1
        dev = self.device
        keep_t = torch.as_tensor(keep, device=dev)
        new_id_t = torch.as_tensor(new_id, dtype=defines.I, device=dev)

        def remap(owner):
            return new_id_t[owner.long()]

        owners = map_tensors(st.owners, lambda p, t: t[keep_t])
        s_keep = keep_t[st.spheres.owner.long()]
        spheres = map_tensors(st.spheres, lambda p, t: t[s_keep])
        spheres = spheres.replace(owner=remap(spheres.owner))
        tris, anals = st.tris, st.anals
        if tris.n:
            tris = tris.replace(owner=remap(tris.owner))
        if anals.n:
            anals = anals.replace(owner=remap(anals.owner))
        self.state = make_state(owners, spheres, self.engine.cfg, tris=tris,
                                anals=anals).replace(time=st.time,
                                                     step=st.step)
        self._n_clump_owners -= int(kill.sum())
        self._owner_volume = self._owner_volume[
            keep[:len(self._owner_volume)]]
        self._owner_tmpl_idx = self._owner_tmpl_idx[keep]
        for tr in self._pending_trackers:
            tr.owner_ids = np.asarray(
                [new_id[i] for i in tr.owner_ids if keep[i]], np.int64)
        self._resized(self.state)

    def ChangeClumpSizes(self, owner_ids, factors):
        """Scale the spheres of the clump owners `owner_ids` (radius and
        offset from the owner's centre) by `factors`, on the device; mass
        and MOI stay. The next refresh rebuilds the contact tables' radii
        and premixed statics from the new sizes."""
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        ids = np.asarray(owner_ids, np.int64).reshape(-1)
        f = np.broadcast_to(np.asarray(factors, np.float32), ids.shape)
        sph = self.state.spheres
        fac = torch.ones(self.state.owners.n, dtype=defines.F,
                         device=self.device)
        fac[torch.as_tensor(ids, device=self.device)] = torch.as_tensor(
            f.copy(), device=self.device)
        per = fac[sph.owner.long()]
        self.state = self.state.replace(spheres=sph.replace(
            radius=sph.radius * per, relpos=sph.relpos * per[:, None]))

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------
    def GetTime(self) -> float:
        return float(self.state.time)

    def SetTime(self, t: float):
        self.state = self.state.replace(
            time=torch.tensor(t, dtype=defines.F, device=self.device))

    def GetSimTime(self) -> float:
        return self.GetTime()

    def SetSimTime(self, t: float):
        self.SetTime(t)

    def GetTimeStepSize(self) -> float:
        return float(self._h)

    def GetInitStatus(self) -> bool:
        return bool(self._initialized)

    def GetUpdateFreq(self) -> int:
        """The CD cadence in effect: the adaptive tuner's K when it is on
        and has picked one, else the setting."""
        eng = self.engine
        if eng is not None and eng.auto_freq and eng.active_freq:
            return int(eng.active_freq)
        return int(self._update_freq)

    def GetContactForceModel(self):
        return self._force_model

    def GetAvgSphContacts(self) -> float:
        return 2.0 * int(self.state.ss.count) / max(self.state.spheres.n, 1)

    def GetMaxVelocity(self) -> float:
        return float(self.state.max_vel)

    def _next_grid(self):
        """(bin size, bins per axis) of the next refresh's SS grid, from
        the live margins and the engine's bin factor, as refresh_contacts
        computes them."""
        st = self.state
        _, margin, _, _ = sphere_pos_margins(st.owners, st.spheres,
                                             self.params, self._voxel_size)
        return binning.build_grid(
            self.params.domain, (st.spheres.radius + margin).max(),
            torch.tensor(self.engine.bin_factor, dtype=defines.F,
                         device=self.device))

    def GetBinSize(self) -> float:
        return float(self._next_grid()[0])

    def GetBinNum(self) -> int:
        nb = _np(self._next_grid()[1])
        return int(nb[0]) * int(nb[1]) * int(nb[2])

    def GetNumClumps(self) -> int:
        return self._n_clump_owners

    def GetNumOwners(self) -> int:
        return int(self.state.owners.n)

    def GetNumSpheres(self) -> int:
        return int(self.state.spheres.n)

    def GetNumContacts(self) -> int:
        return (int(self.state.ss.count) + int(self.state.st.count)
                + int(self.state.sa.count))

    def GetOwnerPosition(self, ids=None):
        st = self.state.owners
        p = decode_host(_np(st.vox), _np(st.loc), self._voxel_size) + self._lbf
        return p if ids is None else p[np.asarray(ids)]

    def _owner_field(self, name, ids):
        v = _np(getattr(self.state.owners, name))
        return v if ids is None else v[np.asarray(ids)]

    def GetOwnerVelocity(self, ids=None):
        return self._owner_field("vel", ids)

    def GetOwnerAngVel(self, ids=None):
        return self._owner_field("omg", ids)

    def GetOwnerOriQ(self, ids=None):
        return self._owner_field("quat", ids)

    def GetOwnerFamily(self, ids=None):
        return self._owner_field("family", ids)

    def GetOwnerMass(self, ids=None):
        return self._owner_field("mass", ids)

    def GetOwnerMOI(self, ids=None):
        """Principal MOI, body frame."""
        return self._owner_field("moi", ids)

    # ------------------------------------------------------------------
    # contact queries
    # ------------------------------------------------------------------
    def GetClumpContacts(self):
        """Live clump-clump contact pairs as owner-id tuples."""
        st = self.state
        n = int(st.ss.count)
        own = _np(st.spheres.owner)
        return np.stack([own[_np(st.ss.idA[:n])], own[_np(st.ss.idB[:n])]],
                        axis=1)

    def _fill_contact_fields(self):
        """Per-contact force/torque/cpoint of the SS table for queries.

        The fused step sums wrenches per owner and never keeps
        per-contact forces (its SS table carries none), so a query runs
        the force pass once more with its extras outputs, on the current
        state. The wildcards it computes are thrown away: a query does not
        advance the contact history. The SS table of any other model
        holds the fields its last step's ``contact_pass`` wrote."""
        st = self.state
        cfg = self.engine.cfg
        if (st.ss.cap == 0 or st.spheres.n == 0
                or not forces.fused_ss(cfg.force_model)):
            # a non-fused SS table keeps the fields of its last step's
            # contact_pass, as the ST and SA tables do
            self._ss_query = None
            return
        krec = forces.pack_kinematics(st.owners, world_omg=True)
        _, _, tbl = fused_step_ss(st.ss, st.owners, float(self.params.h),
                                  cfg.voxel_size, cfg.force_model, krec,
                                  extras=True)
        self._ss_query = (tbl.force, tbl.torque, tbl.cpoint)

    def _ss_fields(self):
        """(force, torque, cpoint) of the SS table: the extras pass's
        outputs once filled, else zeros of the table's shape (the SS
        table's own arrays are (0, 3) placeholders)."""
        if self._ss_query is not None:
            return self._ss_query
        t = self.state.ss
        if t.force.shape[0] == t.cap:
            return t.force, t.torque, t.cpoint
        z = torch.zeros((t.cap, 3), dtype=defines.F, device=self.device)
        return z, z, z

    def _contact_blocks(self, force_thres=None):
        """The live rows of each contact table, SS then ST then SA, as
        host arrays: {"kind", "idA", "idB", "force", "torque_only",
        "point", "wildcards"} per table with rows. The caller has filled
        the query fields (``_fill_contact_fields``). Rows are selected and
        points formed on the device (float64: the contact point plus owner
        A's decoded position, in the user frame), so only the kept rows
        cross to the host; with `force_thres` only rows with |force| >
        force_thres are kept."""
        st = self.state
        own = st.spheres.owner.long()
        vox, loc = st.owners.vox, st.owners.loc
        lbf = torch.as_tensor(self._lbf, dtype=torch.float64,
                              device=self.device)
        out = []
        for name, tbl in (("SS", st.ss), ("ST", st.st), ("SA", st.sa)):
            n = int(tbl.count)
            if n == 0:
                continue
            f3, t3, cp3 = (self._ss_fields() if name == "SS"
                           else (tbl.force, tbl.torque, tbl.cpoint))
            if force_thres is None:
                def take(x, n=n):
                    return x[:n]
            else:
                keep = torch.nonzero(torch.linalg.vector_norm(
                    f3[:n], dim=1) > force_thres)[:, 0]

                def take(x, n=n, keep=keep):
                    return x[:n][keep]
            idA = take(tbl.idA)
            oa = own[idA.long()]
            opos = (vox[oa].double() * float(self._voxel_size)
                    + loc[oa].double()) + lbf
            out.append(dict(
                kind=name, idA=_np(idA), idB=_np(take(tbl.idB)),
                force=_np(take(f3)), torque_only=_np(take(t3)),
                point=_np(take(cp3).double() + opos),
                wildcards={k: _np(take(v)) for k, v in tbl.wildcards.items()},
            ))
        return out

    def GetContactDetailedInfo(self):
        """Contact table dump with forces and points: one dict per contact
        kind with live rows, {"kind", "idA", "idB", "force", "torque_only",
        "point", "wildcards"}. Runs the force pass's extras once (kernel
        B-extras on the card)."""
        self._fill_contact_fields()
        return self._contact_blocks()

    def GetContacts(self, families=None):
        """Live clump-clump contact pairs as owner ids, optionally only
        those with an owner whose family is in `families`."""
        pairs = self.GetClumpContacts()
        if families is None:
            return pairs
        fams = self.GetOwnerFamily()
        inc = (np.isin(fams[pairs[:, 0]], list(families))
               | np.isin(fams[pairs[:, 1]], list(families)))
        return pairs[inc]

    def GetOwnerContactClumps(self, owner_id: int):
        """Clump owner ids in contact with `owner_id` (any table), sorted;
        selected on the device."""
        found = []
        for t in (self.state.ss, self.state.st, self.state.sa):
            n = int(t.count)
            if n == 0:
                continue
            oa, ob = t.own_a[:n], t.own_b[:n]
            found += [ob[oa == owner_id], oa[ob == owner_id]]
        if not found:
            return np.zeros(0, np.int64)
        ids = _np(torch.unique(torch.cat(found)))
        return ids[(ids >= 0) & (ids < self._n_clump_owners)]

    def _contact_forces_for_owner(self, owner_id: int,
                                  with_torque: bool = False):
        """(points, forces[, torque-only forces]) of every live contact of
        one owner, user frame, in table order: SS then ST then SA, each
        as the A side then the B side (force sign flipped)."""
        self._fill_contact_fields()
        st = self.state
        pts, fs, ts, owna = [], [], [], []
        for tbl in (st.ss, st.st, st.sa):
            if tbl.cap == 0:
                continue
            f3, t3, p3 = (self._ss_fields() if tbl is st.ss
                          else (tbl.force, tbl.torque, tbl.cpoint))
            live = tbl.idA >= 0
            for own_col, sign in ((tbl.own_a, 1.0), (tbl.own_b, -1.0)):
                rows = torch.nonzero(live & (own_col == owner_id))[:, 0]
                pts.append(p3[rows])
                fs.append(sign * f3[rows])
                ts.append(sign * t3[rows])
                owna.append(tbl.own_a[rows])
        pts = _np(torch.cat(pts)).astype(np.float64)
        fs = _np(torch.cat(fs)).astype(np.float64)
        ts = _np(torch.cat(ts)).astype(np.float64)
        idx = torch.cat(owna).long()
        # the contact point is relative to owner A's CoM
        opos = decode_host(_np(st.owners.vox[idx]), _np(st.owners.loc[idx]),
                           self._voxel_size) + self._lbf
        if with_torque:
            return pts + opos, fs, ts
        return pts + opos, fs

    def GetOwnerContactForces(self, owner_ids):
        """(points, forces) stacked over the listed owners' contacts."""
        pts_all, fs_all = [], []
        for oid in np.atleast_1d(np.asarray(owner_ids, np.int64)):
            pts, fs = self._contact_forces_for_owner(int(oid))
            pts_all.append(pts)
            fs_all.append(fs)
        if not pts_all:
            return np.zeros((0, 3)), np.zeros((0, 3))
        return np.concatenate(pts_all), np.concatenate(fs_all)

    # ------------------------------------------------------------------
    # meshes
    # ------------------------------------------------------------------
    def GetCachedMesh(self, owner_id: int) -> DEMMeshConnected:
        """The mesh attached to an owner (reference API.h:494)."""
        for m in self._meshes:
            if m.owner_id == int(owner_id):
                return m
        raise KeyError(f"owner {owner_id} has no cached mesh")

    def SetTriNodeRelPos(self, owner_id: int, new_nodes):
        """Deformable-mesh node update by owner id (reference API.h:489);
        `new_nodes` are body-frame vertex positions."""
        mesh = self.GetCachedMesh(owner_id)
        DEMTracker(self, [owner_id], obj=mesh).UpdateMesh(new_nodes)

    def SetFamilyMeshMaterial(self, family: int, material):
        """The material of every facet whose mesh is in `family`."""
        st = self.state
        if st.tris.n == 0:
            return
        mid = material.id if hasattr(material, "id") else int(material)
        fam = st.owners.family[st.tris.owner.long()]
        self.state = st.replace(tris=st.tris.replace(
            mat=torch.where(fam == family, mid, st.tris.mat)))

    # ------------------------------------------------------------------
    # output
    # ------------------------------------------------------------------
    def WriteMeshFile(self, path):
        """Every mesh in the user frame, in one legacy-VTK file (or OBJ,
        ``SetMeshOutputFormat("obj")``): facet normals from the source
        file where the mesh uses them, else from the winding."""
        if not self._meshes:
            return
        ids = [m.owner_id for m in self._meshes]
        owners = self.state.owners
        qs = _np(owners.quat[ids]).astype(np.float64)
        pos = decode_host(_np(owners.vox[ids]), _np(owners.loc[ids]),
                          self._voxel_size) + self._lbf

        def rot(q, v):  # quaternion rotation, float64
            t = 2.0 * np.cross(q[1:4], v)
            return v + q[0] * t + np.cross(q[1:4], t)

        verts, faces, nrms = [], [], []
        off = 0
        for q, p, mesh in zip(qs, pos, self._meshes):
            v = np.asarray(mesh.vertices, np.float64)
            vw = p[None] + rot(q, v)
            f = np.asarray(mesh.faces)
            if mesh.use_mesh_normals and mesh.face_normals is not None:
                nrms.append(rot(q, np.asarray(mesh.face_normals,
                                              np.float64)))
            else:
                n = np.cross(vw[f[:, 1]] - vw[f[:, 0]],
                             vw[f[:, 2]] - vw[f[:, 0]])
                nrms.append(n / np.maximum(
                    np.linalg.norm(n, axis=1, keepdims=True), 1e-30))
            verts.append(vw)
            faces.append(f + off)
            off += len(v)
        write = (io_utils.write_mesh_obj if self._mesh_out_format == "obj"
                 else io_utils.write_mesh_vtk)
        write(path, np.concatenate(verts), np.concatenate(faces),
              normals=np.concatenate(nrms))

    def WriteSphereFile(self, path):
        st = self.state
        pos = _np(sphere_world_pos(st.owners, st.spheres, self._voxel_size)
                  ).astype(np.float64) + self._lbf
        own = _np(st.spheres.owner)
        absv = np.linalg.norm(_np(st.owners.vel), axis=1)[own]
        fams = _np(st.owners.family)[own]
        keep = self._output_mask(fams)
        extra = {}
        if self._out_content & defines.OutputContent.GEO_WILDCARD:
            extra = {k: _np(st.spheres.wildcards[k])[keep]
                     for k in self._force_model.geo_wildcards}
        io_utils.write_spheres_csv(
            path, pos[keep], _np(st.spheres.radius)[keep], owner=own[keep],
            absv=absv[keep], family=fams[keep], extra=extra,
            fmt=self._out_format)

    def WriteClumpFile(self, path):
        """One row per clump owner (families of DisableFamilyOutput left
        out): x, y, z, clump_type, Qw..Qz, v_*, w_*, family, then absv
        and a_* as SetOutputContent says. An unnamed template is written
        as "type_<owner id>", as the JAX package writes it. The rows are
        selected on the device and each column is copied once."""
        st = self.state
        oc = self._out_content
        OC = defines.OutputContent
        o = st.owners
        # the clump owners: after UpdateClumps they are no longer a prefix
        rows = torch.as_tensor(np.nonzero(self._owner_tmpl_idx >= 0)[0],
                               device=self.device)
        if self._no_output_families:
            fam = o.family[rows]
            rows = rows[~torch.isin(fam, torch.as_tensor(
                sorted(self._no_output_families), dtype=fam.dtype,
                device=self.device))]
        pos = decode_host(_np(o.vox[rows]), _np(o.loc[rows]),
                          self._voxel_size) + self._lbf
        vel = _np(o.vel[rows])
        ids = _np(rows)
        names = [t.name for t in self._owner_templates]
        clump_type = np.asarray(
            [names[t] or f"type_{i}"
             for t, i in zip(self._owner_tmpl_idx[ids].tolist(),
                             ids.tolist())], dtype=str)
        extra = {}
        if oc & OC.ABSV:
            extra["absv"] = np.linalg.norm(vel, axis=1)
        if oc & OC.ACC:
            acc = _np(o.lin_acc[rows])
            extra.update({"a_x": acc[:, 0], "a_y": acc[:, 1],
                          "a_z": acc[:, 2]})
        if oc & OC.OWNER_WILDCARD:
            extra.update({k: _np(o.wildcards[k][rows])
                          for k in self._force_model.owner_wildcards})
        io_utils.write_clumps_csv(
            path, pos, _np(o.quat[rows]), vel=vel, ang_vel=_np(o.omg[rows]),
            family=_np(o.family[rows]), clump_type=clump_type, extra=extra,
            fmt=self._out_format)

    def WriteContactFile(self, path, force_thres: float = -1.0):
        """Every live contact with |force| > force_thres: A, B,
        contact_type (SS 1, ST 2, SA 11), then the point, force,
        torque-only force and wildcards as SetContactOutputContent says;
        SS rows, then ST, then SA. Runs the force pass's extras once
        (kernel B-extras on the card); the threshold is applied on the
        device, so only kept rows cross to the host."""
        self._fill_contact_fields()
        blocks = self._contact_blocks(force_thres)
        if not blocks:
            io_utils.write_contacts_csv(
                path, np.zeros(0, int), np.zeros(0, int), np.zeros(0, int),
                fmt=self._cnt_out_format)
            return
        CC = defines.ContactOutputContent
        cc = self._cnt_out_content

        def cat(key):
            return np.concatenate([b[key] for b in blocks])

        code = {"SS": 1, "ST": 2, "SA": 11}
        wc = {k: np.concatenate([b["wildcards"][k] for b in blocks])
              for k in blocks[0]["wildcards"]}
        io_utils.write_contacts_csv(
            path, cat("idA"), cat("idB"),
            np.concatenate([np.full(len(b["idA"]), code[b["kind"]])
                            for b in blocks]),
            point=cat("point") if cc & CC.POINT else None,
            force=cat("force") if cc & CC.FORCE else None,
            torque=cat("torque_only") if cc & CC.TORQUE else None,
            wildcards=wc if cc & CC.CNT_WILDCARD else None,
            fmt=self._cnt_out_format)

    def WriteContactFileIncludingPotentialPairs(self, path):
        """The contact file with every live table row, the pairs within
        the CD margin that carry no force yet included."""
        self.WriteContactFile(path, force_thres=-1.0)

    def DisableFamilyOutput(self, family: int):
        """Exclude a family from clump and sphere file output."""
        self._no_output_families.add(int(family))

    def _output_mask(self, fams):
        if not self._no_output_families:
            return np.ones(len(fams), bool)
        return ~np.isin(fams, sorted(self._no_output_families))

    # readers of the files above
    ReadClumpXyzFromCsv = staticmethod(io_utils.read_clump_xyz_from_csv)
    ReadClumpQuatFromCsv = staticmethod(io_utils.read_clump_quat_from_csv)
    ReadClumpVelFromCsv = staticmethod(io_utils.read_clump_vel_from_csv)
    ReadClumpAngVelFromCsv = staticmethod(
        io_utils.read_clump_ang_vel_from_csv)
    ReadClumpFloat3FromCsv = staticmethod(
        io_utils.read_clump_float3_from_csv)
    ReadContactPairsFromCsv = staticmethod(
        io_utils.read_contact_pairs_from_csv)
    ReadContactWildcardsFromCsv = staticmethod(
        io_utils.read_contact_wildcards_from_csv)

    # ------------------------------------------------------------------
    # inspectors and statistics
    # ------------------------------------------------------------------
    def CreateInspector(self, quantity: str, region=None) -> DEMInspector:
        return DEMInspector(self, quantity, region)

    def ShowTimingStats(self):
        """The DoDynamics totals and the engine's chunk timers: refreshes
        and steps timed by CUDA events on the card (the host clock on the
        CPU), the refreshes' stage sums, the host round trips by site,
        growths, shrinks, shrink checks and refresh retries, the bin
        factor, and with a tuner on its measured ms/step per rung; then
        the last ProfileStageTimings table. ``tracing.frames()`` holds
        each frame's host spans."""
        t = self.engine.read_timers()
        step_per = t["steps_s"] / t["steps_n"] * 1e3 if t["steps_n"] else 0.0
        refresh_per = (t["refresh_s"] / t["refresh_n"] * 1e3
                       if t["refresh_n"] else 0.0)
        clock = "CUDA events" if self.device.type == "cuda" else "host clock"
        stages = " ".join(
            f"{s}={t[f'refresh_{s}_s']:.3f}s"
            for s in [s for s, _, _ in tracing.REFRESH_STAGES] + ["sync"])
        trips = " ".join(f"{x}={t[f'sync_{x}_n']}/{t[f'sync_{x}_s']:.3f}s"
                         for x in tracing.SYNC_SITES if t[f"sync_{x}_n"])
        print(
            f"[timing] total wall {self._timers['total']:.3f}s over "
            f"{self._n_steps_done} steps, {self._n_refreshes} CD refreshes\n"
            f"  CD refresh        : {t['refresh_s']:8.3f}s"
            f"  ({t['refresh_n']} refreshes, {refresh_per:.1f} ms each; "
            f"{clock})\n"
            f"  refresh stages    : {stages} ({clock})\n"
            f"  dynamics          : {t['steps_s']:8.3f}s"
            f"  ({t['steps_n']} steps, {step_per:.3f} ms/step; {clock})\n"
            f"  host round trips  : {trips or 'none'} (count/host seconds)\n"
            f"  engine events     : grows={t['grows']} "
            f"shrinks={t['shrinks']} retries={t['retries']} "
            f"shrink_checks={t['shrink_checks']} "
            f"bin_factor={self.engine.bin_factor:.2f}"
            + (f"\n  adaptive CD freq  : K={self.engine.active_freq} "
               f"measured {self._perf_ms(self.engine._k_perf)} ms/step"
               if self.engine.auto_freq else "")
            + (f"\n  adaptive bin      : measured "
               f"{self._perf_ms(self.engine._bin_perf)} ms/step"
               if self.engine.auto_bin else ""))
        if self._stage_timings:
            from .profiling import format_stages

            print(format_stages(self._stage_timings))

    @staticmethod
    def _perf_ms(perf):
        return [(k, round(v * 1e3, 3)) for k, v in sorted(perf.items())]

    def ProfileStageTimings(self, reps: int = 2):
        """Time one refresh and one step of the current state at their
        stage boundaries, `reps` times (``profiling.profile_stages``);
        print the table and return {stage: ms}. The state is left as it
        was."""
        if not self._initialized:
            raise RuntimeError("Initialize() first")
        from .profiling import format_stages, profile_stages

        stages = profile_stages(self.engine, self.state, self.params,
                                self._update_freq, reps=reps)
        self._stage_timings = stages
        print(format_stages(stages))
        return stages

    def ClearTimingStats(self):
        self._timers = {"total": 0.0}
        self._n_steps_done = 0
        self.engine.clear_timers()

    def ShowAnomalies(self):
        """Print and return the anomalies met so far (lost contacts)."""
        for a in self._anomalies:
            print("[anomaly]", a)
        return list(self._anomalies)

    def ClearThreadCollaborationStats(self):
        pass  # one stream runs the refresh and the steps: nothing to count

    def ShowThreadCollaborationStats(self):
        print(f"[collab] dynamics/CD ratio: {self._update_freq} (refresh "
              f"and steps in order on one stream; no inter-worker waits)")

    # ------------------------------------------------------------------
    # memory
    # ------------------------------------------------------------------
    # The JAX package reports a model of the TPU's HBM use here; the port
    # reports the card's own counts instead.
    def GetDeviceMemUsageDynamic(self) -> int:
        """Bytes of the state's tensors (owners, geometry, contact
        tables)."""
        return sum(t.numel() * t.element_size()
                   for _, t in state_tensors(self.state))

    def GetDeviceMemUsageKinematic(self) -> int:
        """Device bytes a refresh takes beyond the state: the peak of
        torch.cuda.max_memory_allocated over one refresh of the current
        state, run here and thrown away (the state stays as it was; the
        call resets the peak counter), less the state's bytes. 0 on the
        CPU."""
        if self.device.type != "cuda":
            return 0
        from .solver import refresh_contacts

        dev = self.device
        self._sync()
        torch.cuda.reset_peak_memory_stats(dev)
        params_k = self.params.replace(
            max_drift=torch.tensor(self.GetUpdateFreq(), dtype=defines.I,
                                   device=dev),
            bin_factor=torch.tensor(self.engine.bin_factor,
                                    dtype=defines.F, device=dev))
        refresh_contacts(self.state, params_k, self.engine.cfg)
        self._sync()
        peak = torch.cuda.max_memory_allocated(dev)
        return max(0, peak - self.GetDeviceMemUsageDynamic())

    def GetHostMemUsageDynamic(self) -> int:
        return 0  # no host copy of the device state persists

    def GetHostMemUsageKinematic(self) -> int:
        return 0

    def PrintKinematicScratchSpaceUsage(self):
        print(f"[mem] CD refresh beyond the state: "
              f"{self.GetDeviceMemUsageKinematic() / 1e6:.1f} MB")

    def ShowMemStats(self):
        """Print the state's bytes, a refresh's bytes beyond them
        (GetDeviceMemUsageKinematic) and the allocator's reserved bytes
        (0 on the CPU); returns the state's bytes."""
        dyn = self.GetDeviceMemUsageDynamic()
        kin = self.GetDeviceMemUsageKinematic()
        res = (torch.cuda.memory_reserved(self.device)
               if self.device.type == "cuda" else 0)
        print(f"[mem] state tensors: {dyn / 1e6:.1f} MB")
        print(f"[mem] CD refresh beyond the state: {kin / 1e6:.1f} MB")
        print(f"[mem] reserved by the allocator: {res / 1e6:.1f} MB")
        return dyn

    def ClearCache(self):
        """Nothing to free: the staged batches are consumed by Initialize
        and UpdateClumps."""

    def ReleaseFlattenedArrays(self):
        pass  # no host staging copies persist after Initialize

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    #: the engine settings a checkpoint restores with the tables: the
    #: capacities that growth and shrinking move
    CHECKPOINT_CAPS = ("cap_ss", "cap_st", "cap_sa", "max_per_bin",
                       "max_tri_span", "st_bruteforce", "cross_lcap",
                       "cross_mpb", "uniq_cap")

    def SaveCheckpoint(self, path: str):
        """The state, bit for bit, in one npz (``np.savez``, not
        compressed): each tensor under its path (``state.state_tensors``),
        and under ``__meta`` a JSON record of the time, the step, and the
        engine's capacities and bin factor that the tables were built at.
        The port's own format: the JAX package's files are not read."""
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        cfg = self.engine.cfg
        meta = dict(time=float(self.state.time), step=int(self.state.step),
                    caps={k: getattr(cfg, k) for k in self.CHECKPOINT_CAPS},
                    bin_factor=self.engine.bin_factor)
        np.savez(path, __meta=np.asarray(json.dumps(meta)),
                 **{p: _np(t) for p, t in state_tensors(self.state)})

    def LoadCheckpoint(self, path: str):
        """Restore a SaveCheckpoint file into this solver, set up as the
        one that saved it. Every path, shape and dtype must fit the live
        state, but the contact tables' capacities, which are restored
        together with the engine's (a table may have grown or shrunk since
        the save); raises otherwise."""
        if not self._initialized:
            raise RuntimeError("call Initialize() first")
        with np.load(path) as data:
            meta = json.loads(str(data["__meta"]))
            cfg = dataclasses.replace(self.engine.cfg, **meta["caps"])
            want = self._checkpoint_shapes(cfg)
            have = set(data.files) - {"__meta"}
            if have != set(want):
                raise ValueError(
                    f"checkpoint {path} does not fit this solver: missing "
                    f"{sorted(set(want) - have)}, not in the state "
                    f"{sorted(have - set(want))}")
            arrays = {p: data[p] for p in want}
        for p, (shape, dt) in want.items():
            if arrays[p].shape != shape or arrays[p].dtype != dt:
                raise ValueError(
                    f"checkpoint {path}: {p} is {arrays[p].dtype}"
                    f"{list(arrays[p].shape)}, the solver's {dt}"
                    f"{list(shape)}")
        self.state = map_tensors(self.state, lambda p, t: torch.as_tensor(
            arrays[p], device=self.device))
        self.engine.cfg = cfg
        self.engine.bin_factor = float(meta["bin_factor"])
        self.engine._config_changed()
        self._ss_query = None

    def _checkpoint_shapes(self, cfg):
        """{path: (shape, numpy dtype)} a checkpoint must hold: the live
        state's, with each contact table at the capacities of `cfg`: its
        rows (or, for the field-major records, its columns) and the SS
        table's unique-fetch lists, which follow cfg.uniq_cap."""
        st = self.state
        rows = ss_uniq_rows(cfg, st.owners.n)
        uniq = {"uniq_a": (rows,),
                "blk_start": (rows // cfg.uniq_cap + 1 if rows else 0,)}
        want = {}
        for p, t in state_tensors(st):
            shape = tuple(t.shape)
            table, _, field = p.partition(".")
            field = field.split("[")[0]
            if table in ("ss", "st", "sa"):
                live = getattr(st, table).cap
                cap = getattr(cfg, "cap_" + table)
                if table == "ss" and field in uniq:
                    shape = uniq[field]
                elif table == "ss" and field == "uidx":
                    shape = (cap if rows else 0,)
                elif field in ("statics", "fstat_a"):  # (width, cap)
                    shape = (shape[0], cap if shape[1] == live else shape[1])
                elif shape and shape[0] == live:
                    shape = (cap,) + shape[1:]
            want[p] = (shape, torch.zeros(0, dtype=t.dtype).numpy().dtype)
        return want

    def GetAllOwnerWildcardValue(self, name: str):
        """The owner wildcard `name` of every owner."""
        return _np(self.state.owners.wildcards[name])
