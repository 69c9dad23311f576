"""DEMSolver — the user-facing facade of the port.

The JAX package's ``DEMSolver``/``DEMTracker`` method names and
behaviour, for the subset this package runs: clumps of spheres and
analytical boundaries, the built-in Hertz models, a fixed CD cadence.
Meshes, two-class CD, prescriptions, family-change rules, persistency,
checkpoints, inspectors and contact-file output are not here yet.

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

On a CUDA device the step runs kernels B or B-ub (unique-fetch, on by
default at 512 rows per owner block), A and C, and the contact queries
run kernel B with its extras outputs; on the CPU the plain versions run
and unique-fetch is off, as the JAX package runs on its CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import defines
from .defines import (
    DEFAULT_FAMILY,
    DEFAULT_UPDATE_FREQ,
    NUM_FAMILIES,
    RESERVED_FAMILY,
    TimeIntegrator,
    Verbosity,
)
from .initializer import (
    make_analyticals,
    make_owners,
    make_params,
    make_spheres,
    make_state,
    resolve_device,
)
from .models import HertzianForceModel
from .ops import forces
from .ops.fused_force import fused_step_ss
from .ops.voxel import choose_voxel_size, decode_host
from .solver import Engine, sphere_world_pos
from .state import SolverConfig
from .structs import DEMClumpBatch, DEMClumpTemplate, DEMExternObj, DEMMaterial
from .utils import io as io_utils


def _np(t):
    return t.detach().cpu().numpy()


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
        self._uniq_cap = 512
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
        self._bounding_bc = "none"
        self._bounding_bc_mat = None
        self._out_format = defines.OutputFormat.CSV
        self._pending_trackers: List[DEMTracker] = []
        # live (post-Initialize)
        self.state = None
        self.params = None
        self.engine: Optional[Engine] = None
        self._ss_query = None
        self._voxel_size = None
        self._initialized = False
        self._n_clump_owners = 0
        self._lost_reported = 0

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

    def SetCDUpdateFreq(self, freq: int):
        self._update_freq = int(freq)
        if self._initialized:
            self._rebuild_params()

    def SetFusedUniqueFetch(self, cap: int = 1024):
        """Unique-other-owner fetch of the force pass (kernel B-ub): per
        block of 128 owners the step reads each distinct other owner's
        record once. `cap` bounds each block's list; it doubles on
        overflow and falls back to kernel B past 2048. Call before
        Initialize; 0 disables. On the CPU it is off."""
        self._uniq_cap = int(cap)

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

    # ------------------------------------------------------------------
    # trackers
    # ------------------------------------------------------------------
    def Track(self, obj) -> DEMTracker:
        if self._initialized:
            return self._make_tracker(obj)
        t = DEMTracker(self, [], obj)
        self._pending_trackers.append(t)
        return t

    def _make_tracker(self, obj):
        if isinstance(obj, DEMClumpBatch):
            ids = np.arange(obj.owner_offset, obj.owner_offset + obj.n)
        elif isinstance(obj, DEMExternObj):
            ids = np.asarray([obj.owner_id])
        else:
            raise TypeError(f"cannot track {type(obj)}")
        return DEMTracker(self, ids, obj)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _flatten_batch(self, b: DEMClumpBatch, oid0: int) -> dict:
        """One batch's owner and sphere arrays, clump by clump in batch
        order, built per distinct template instead of per clump."""
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

        return dict(
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
        )

    def Initialize(self, dry_run: bool = False):
        dims = self._dims
        self._voxel_size = choose_voxel_size(dims)
        model = self._force_model

        if self._bounding_bc in ("all", "top_open"):
            self._add_bounding_planes()

        # owners: clumps, then analytical objects
        parts = []
        oid = 0
        for b in self._batches:
            if (b.existing_contacts is not None or b.owner_wildcards
                    or b.geo_wildcards):
                raise NotImplementedError(
                    "restart contacts and owner/geometry wildcards are not "
                    "ported to the torch package yet")
            b.owner_offset = oid
            parts.append(self._flatten_batch(b, oid))
            oid += b.n
        self._n_clump_owners = oid

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
        n_ext = len(self._extern_objs)
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
        owners = make_owners(
            pos=cat("pos", ext["pos"], 3), voxel_size=self._voxel_size,
            quat=cat("quat", ext["quat"], 4), vel=cat("vel", z3, 3),
            omg=cat("omg", z3, 3),
            family=cat("family", ext["family"], 1).reshape(-1),
            mass=cat("mass", ext["mass"], 1).reshape(-1),
            moi=cat("moi", ext["moi"], 3), device=self.device,
        )

        def scat(key, width=None):
            if not parts:
                return np.zeros((0, width) if width else (0,))
            return np.concatenate([p[key] for p in parts])

        spheres = make_spheres(owner=scat("s_owner"), relpos=scat("s_rel", 3),
                               radius=scat("s_rad"), mat=scat("s_mat"),
                               device=self.device)
        anals = make_analyticals(
            owner=np.asarray(a_owner), objtype=np.asarray(a_type),
            relpos=np.asarray(a_rel).reshape(-1, 3),
            direction=np.asarray(a_dir).reshape(-1, 3),
            size=np.asarray(a_size).reshape(-1, 3),
            normal_sign=np.asarray(a_sign), mat=np.asarray(a_mat),
            device=self.device,
        )
        n_spheres = spheres.n
        radii = scat("s_rad")
        if radii.size and radii.min() > 0 and radii.max() / radii.min() > 1.7:
            frac = float(np.mean(radii <= np.sqrt(radii.min() * radii.max())))
            if 0.05 < frac < 0.999:
                raise NotImplementedError(
                    "this radius spread takes the two-class CD, which is "
                    "not ported to the torch package yet")

        cap_ss = -(-max(512, int(5 * n_spheres)) // 512) * 512
        # a sphere can rest against several analytical components at once
        cap_sa = max(64, min(2, anals.n) * n_spheres) if anals.n else 8
        on_card = self.device.type == "cuda"
        cfg = SolverConfig(
            voxel_size=self._voxel_size,
            integrator=self._integrator,
            force_model=model,
            cap_ss=cap_ss,
            cap_st=8,
            cap_sa=cap_sa,
            uniq_cap=self._uniq_cap if on_card else 0,
        )
        self.state = make_state(owners, spheres, cfg, anals=anals)
        self.engine = Engine(cfg)
        self._rebuild_params()
        self._initialized = True
        for t in self._pending_trackers:
            t.owner_ids = self._make_tracker(t.obj).owner_ids
        self._engine_log(
            "INFO", f"initialized on {self.device}: {n_owners} owners, "
            f"{n_spheres} spheres, {anals.n} analytical components; "
            f"voxel={self._voxel_size:.3e}")
        if dry_run:
            self.state = self.engine.refresh(self.state, self.params)
        return self

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
        self.state = self.engine.advance(self.state, self.params, n_steps,
                                         self._update_freq)
        self._sync()
        self._check_lost_contacts()

    def _check_lost_contacts(self):
        """Contacts that carried friction history but were not
        re-detected at a refresh lost it silently: report them."""
        lost = int(self.state.lost_contacts)
        if lost > self._lost_reported:
            msg = (f"{lost - self._lost_reported} contact(s) with live "
                   f"history were not re-detected at a CD refresh and lost "
                   f"their wildcards (total {lost}); consider larger "
                   f"margins")
            self._engine_log("STEP_METRIC", msg)
            self._lost_reported = lost

    def DoStepDynamics(self):
        self.state = self.engine.advance(self.state, self.params, 1,
                                         self._update_freq)

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------
    def GetTime(self) -> float:
        return float(self.state.time)

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

        The step sums wrenches per owner and never keeps per-contact
        forces (the SS table carries none), so a query runs the force
        pass once more with its extras outputs, on the current state.
        The wildcards it computes are thrown away: a query does not
        advance the contact history."""
        st = self.state
        if st.ss.cap == 0 or st.spheres.n == 0:
            self._ss_query = None
            return
        cfg = self.engine.cfg
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

    def GetContactDetailedInfo(self):
        """Contact table dump with forces and points: one dict per contact
        kind with live rows, {"kind", "idA", "idB", "force", "torque_only",
        "point", "wildcards"}."""
        self._fill_contact_fields()
        out = []
        own = _np(self.state.spheres.owner)
        opos = self.GetOwnerPosition()
        for name, tbl in (("SS", self.state.ss), ("ST", self.state.st),
                           ("SA", self.state.sa)):
            n = int(tbl.count)
            if n == 0:
                continue
            f3, t3, cp3 = (self._ss_fields() if name == "SS"
                           else (tbl.force, tbl.torque, tbl.cpoint))
            idA = _np(tbl.idA[:n])
            out.append(dict(
                kind=name,
                idA=idA,
                idB=_np(tbl.idB[:n]),
                force=_np(f3[:n]),
                torque_only=_np(t3[:n]),
                point=_np(cp3[:n]) + opos[own[idA]],
                wildcards={k: _np(v[:n]) for k, v in tbl.wildcards.items()},
            ))
        return out

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
    # output
    # ------------------------------------------------------------------
    def WriteSphereFile(self, path):
        st = self.state
        pos = _np(sphere_world_pos(st.owners, st.spheres, self._voxel_size)
                  ).astype(np.float64) + self._lbf
        own = _np(st.spheres.owner)
        absv = np.linalg.norm(_np(st.owners.vel), axis=1)[own]
        fams = _np(st.owners.family)[own]
        keep = self._output_mask(fams)
        io_utils.write_spheres_csv(
            path, pos[keep], _np(st.spheres.radius)[keep], owner=own[keep],
            absv=absv[keep], family=fams[keep], fmt=self._out_format)

    def DisableFamilyOutput(self, family: int):
        """Exclude a family from sphere file output."""
        self._no_output_families.add(int(family))

    def _output_mask(self, fams):
        if not self._no_output_families:
            return np.ones(len(fams), bool)
        return ~np.isin(fams, sorted(self._no_output_families))
