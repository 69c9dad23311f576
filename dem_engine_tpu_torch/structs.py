"""Host-side user-facing staging objects.

DEMMaterial, DEMClumpTemplate, DEMClumpBatch and DEMExternObj, as the
JAX package's ``structs`` defines them (meshes come with the triangle
slice). These are plain-Python staging objects; ``DEMSolver.Initialize``
flattens them into device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .defines import (
    ANAL_CYL_INF,
    ANAL_PLANE,
    DEFAULT_FAMILY,
    ENTITY_NORMAL_INWARD,
    ENTITY_NORMAL_OUTWARD,
)


def _normal_sign(normal: str) -> float:
    if normal in ("inward", "in"):
        return ENTITY_NORMAL_INWARD
    if normal in ("outward", "out"):
        return ENTITY_NORMAL_OUTWARD
    raise ValueError(f"normal must be 'inward' or 'outward', got {normal!r}")


@dataclasses.dataclass(eq=False)
class DEMMaterial:
    """A material: named float properties (reference Structs.h:533-548).
    `id` is assigned by DEMSolver.LoadMaterial."""

    props: Dict[str, float]
    id: Optional[int] = None

    def __getitem__(self, k):
        return self.props[k]


@dataclasses.dataclass(eq=False)
class DEMClumpTemplate:
    """A clump type: component sphere radii/positions/materials + mass/MOI
    (reference DEMClumpTemplate, Structs.h:562-698)."""

    mass: float = 0.0
    moi: Sequence[float] = (0.0, 0.0, 0.0)
    radii: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    relpos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3))
    )
    materials: List[DEMMaterial] = dataclasses.field(default_factory=list)
    name: Optional[str] = None
    volume: Optional[float] = None

    @property
    def n_comp(self) -> int:
        return int(np.asarray(self.radii).shape[0])

    def SetVolume(self, v: float):
        self.volume = v

    def SetMass(self, m: float):
        self.mass = m

    def SetMOI(self, moi):
        self.moi = tuple(np.asarray(moi, np.float64))

    def Move(self, vec):
        """Translate all components (reference Structs.h Move)."""
        self.relpos = np.asarray(self.relpos, np.float64) + np.asarray(vec)
        return self

    def Scale(self, s: float):
        """Uniformly scale geometry, mass and MOI (reference Scale)."""
        self.relpos = np.asarray(self.relpos, np.float64) * s
        self.radii = np.asarray(self.radii, np.float64) * s
        self.mass = float(self.mass) * s**3
        self.moi = tuple(np.asarray(self.moi, np.float64) * s**5)
        if self.volume is not None:
            self.volume *= s**3
        return self

    def InformCentroidPrincipal(self, com, quat_or_euler=None):
        """Declare that `com` is the centroid in the current frame; shifts
        components so the CoM is the origin (reference
        InformCentroidPrincipal). Rotation to principal axes: users provide
        already-principal MOI, as in the reference's common use."""
        self.Move(-np.asarray(com, np.float64))
        return self

    def ReadComponentFromFile(self, path, x_col="x", y_col="y", z_col="z",
                              r_col="r"):
        """Load component spheres from CSV (reference Structs.h:600-640)."""
        import csv as _csv

        xs, ys, zs, rs = [], [], [], []
        with open(path, newline="") as f:
            for row in _csv.DictReader(f):
                xs.append(float(row[x_col]))
                ys.append(float(row[y_col]))
                zs.append(float(row[z_col]))
                rs.append(float(row[r_col]))
        self.relpos = np.stack([xs, ys, zs], axis=-1)
        self.radii = np.asarray(rs)
        return len(rs)

    def AssignName(self, name: str):
        self.name = name

    def Duplicate(self) -> "DEMClumpTemplate":
        """Deep copy for derive-and-modify workflows (reference template
        Duplicate, API.h:253-315): scale/move the copy without touching
        the original."""
        import copy

        return copy.deepcopy(self)


@dataclasses.dataclass(eq=False)
class DEMClumpBatch:
    """A batch of clumps to insert (reference DEMClumpBatch,
    Structs.h:711-933)."""

    templates: List[DEMClumpTemplate]
    xyz: np.ndarray                       # (n,3)
    vel: Optional[np.ndarray] = None
    ang_vel: Optional[np.ndarray] = None  # body frame
    oriq: Optional[np.ndarray] = None     # (n,4) (w,x,y,z)
    families: Optional[np.ndarray] = None
    owner_wildcards: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict
    )
    geo_wildcards: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict
    )
    existing_contacts: Optional[dict] = None  # restart support
    existing_contact_wildcards: Optional[Dict[str, np.ndarray]] = None
    # filled at Initialize: owner index of first clump
    owner_offset: Optional[int] = None

    @property
    def n(self) -> int:
        return int(np.asarray(self.xyz).shape[0])

    def SetVel(self, v):
        v = np.asarray(v, np.float64)
        self.vel = np.broadcast_to(v, (self.n, 3)).copy()

    def SetAngVel(self, w):
        w = np.asarray(w, np.float64)
        self.ang_vel = np.broadcast_to(w, (self.n, 3)).copy()

    def SetOriQ(self, q):
        q = np.asarray(q, np.float64)
        self.oriq = np.broadcast_to(q, (self.n, 4)).copy()

    def SetFamilies(self, fam):
        self.families = np.broadcast_to(
            np.asarray(fam, np.int32), (self.n,)
        ).copy()

    SetFamily = SetFamilies

    def AddOwnerWildcard(self, name, vals):
        self.owner_wildcards[name] = np.broadcast_to(
            np.asarray(vals, np.float32), (self.n,)
        ).copy()

    def AddGeometryWildcard(self, name, vals):
        vals = np.asarray(vals, np.float32)
        self.geo_wildcards[name] = vals

    def SetExistingContacts(self, pairs):
        """pairs: dict with 'idA','idB' geometry indices local to this batch
        (restart path, reference Structs.h:857-882)."""
        self.existing_contacts = pairs

    def SetExistingContactWildcards(self, wc: Dict[str, np.ndarray]):
        self.existing_contact_wildcards = dict(wc)


@dataclasses.dataclass(eq=False)
class _AnalComponent:
    objtype: int
    relpos: np.ndarray
    direction: np.ndarray
    size: np.ndarray
    normal_sign: float
    material: Optional[DEMMaterial]


@dataclasses.dataclass(eq=False)
class DEMExternObj:
    """An analytical boundary object: one owner, many primitive components
    (reference DEMExternObj, BdrsAndObjs.h:68-227)."""

    components: List[_AnalComponent] = dataclasses.field(default_factory=list)
    family: int = DEFAULT_FAMILY
    mass: float = 1e30
    moi: Tuple[float, float, float] = (1e30, 1e30, 1e30)
    init_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    init_quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    owner_id: Optional[int] = None  # assigned at Initialize

    def SetFamily(self, f: int):
        self.family = int(f)

    def SetMass(self, m: float):
        self.mass = float(m)

    def SetMOI(self, moi):
        self.moi = tuple(np.asarray(moi, np.float64))

    def SetInitPos(self, pos):
        self.init_pos = tuple(np.asarray(pos, np.float64))

    def SetInitQuat(self, q):
        self.init_quat = tuple(np.asarray(q, np.float64))

    def AddPlane(self, pos, normal, material=None):
        """Infinite plane through `pos` with outward normal `normal`
        (reference AddPlane, BdrsAndObjs.h:123)."""
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self.components.append(
            _AnalComponent(
                ANAL_PLANE, np.asarray(pos, np.float64), n,
                np.zeros(3), ENTITY_NORMAL_OUTWARD, material,
            )
        )
        return self

    def AddZCylinder(self, pos, rad, material=None, normal="inward"):
        """Infinite cylinder along z (reference AddZCylinder)."""
        self.components.append(
            _AnalComponent(
                ANAL_CYL_INF, np.asarray(pos, np.float64),
                np.asarray([0.0, 0.0, 1.0]), np.asarray([rad, 0.0, 0.0]),
                _normal_sign(normal), material,
            )
        )
        return self

    def AddCylinder(self, pos, axis, rad, material=None, normal="inward"):
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        self.components.append(
            _AnalComponent(
                ANAL_CYL_INF, np.asarray(pos, np.float64), a,
                np.asarray([rad, 0.0, 0.0]), _normal_sign(normal), material,
            )
        )
        return self

    def AddPlate(self, pos, normal, xdim=0.0, ydim=0.0, material=None):
        """Source compat (reference BdrsAndObjs.h:163): the reference's
        finite-plate analytical type generates NO contacts — its narrow
        phase returns NOT_A_CONTACT (DEMHelperKernels.cuh:491). Matching
        behavior here: the component is recorded but inert. Use an
        AddWavefrontMeshObject two-triangle plate for a real finite
        plate, or AddPlane for an infinite one."""
        import warnings

        warnings.warn(
            "AddPlate generates no contacts (reference parity: plate's "
            "narrow phase is unimplemented, DEMHelperKernels.cuh:491); "
            "use a mesh plate or AddPlane instead.",
            stacklevel=2,
        )
        return self
