"""Host-side user-facing staging objects.

DEMMaterial, DEMClumpTemplate, DEMClumpBatch, DEMExternObj and
DEMMeshConnected, as the JAX package's ``structs`` defines them. These
are plain-Python staging objects; ``DEMSolver.Initialize`` flattens them
into device tensors.
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
    # filled at Initialize: owner index of the first clump and sphere
    # index of its first sphere (restart contacts are local to it)
    owner_offset: Optional[int] = None
    sphere_offset: Optional[int] = None

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


@dataclasses.dataclass(eq=False)
class DEMMeshConnected:
    """A triangle mesh (reference DEMMeshConnected, BdrsAndObjs.h:230-585).

    Vertices are stored in the owner's body frame; `init_pos`/`init_quat`
    place the owner in the world at Initialize.
    """

    vertices: np.ndarray                 # (V,3)
    faces: np.ndarray                    # (T,3) int
    material: Optional[DEMMaterial] = None
    face_materials: Optional[np.ndarray] = None
    family: int = DEFAULT_FAMILY
    mass: float = 1e30
    moi: Tuple[float, float, float] = (1e30, 1e30, 1e30)
    init_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    init_quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    name: Optional[str] = None
    owner_id: Optional[int] = None
    tri_offset: Optional[int] = None     # first triangle index at Initialize
    face_normals: Optional[np.ndarray] = None  # (T,3) body frame, from vn
    use_mesh_normals: bool = False       # honor source normals in output

    @property
    def n_tri(self) -> int:
        return int(np.asarray(self.faces).shape[0])

    def GetNumTriangles(self):
        return self.n_tri

    def GetNumNodes(self):
        return int(np.asarray(self.vertices).shape[0])

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

    def SetMaterial(self, mat: DEMMaterial):
        self.material = mat

    def Move(self, vec):
        self.vertices = np.asarray(self.vertices, np.float64) + np.asarray(vec)
        return self

    def Scale(self, s):
        self.vertices = np.asarray(self.vertices, np.float64) * s
        return self

    def Mirror(self, plane_point, plane_normal):
        """Mirror across a plane (reference BdrsAndObjs.h Mirror)."""
        p = np.asarray(plane_point, np.float64)
        n = np.asarray(plane_normal, np.float64)
        n = n / np.linalg.norm(n)
        v = np.asarray(self.vertices, np.float64)
        d = (v - p) @ n
        self.vertices = v - 2.0 * d[:, None] * n
        # flip winding to keep outward normals
        self.faces = np.asarray(self.faces)[:, ::-1].copy()
        return self

    def GetCoordsVertices(self):
        return np.asarray(self.vertices)

    def GetTriangles(self):
        return np.asarray(self.vertices)[np.asarray(self.faces)]

    def UseNormals(self, use: bool = True):
        """Honor the source file's vertex normals in mesh output (needs
        the OBJ to declare vn and the mesh to be loaded with
        load_normals); facet normals are recomputed from winding
        otherwise."""
        self.use_mesh_normals = bool(use)

    def Clear(self):
        """Drop the mesh's geometry (reference BdrsAndObjs.h:357)."""
        self.vertices = np.zeros((0, 3))
        self.faces = np.zeros((0, 3), np.int64)
        self.face_materials = None

    def ComputeMassProperties(self, density: float = 1.0):
        """(mass, com (3,), inertia tensor (3, 3) about the com) of the
        closed mesh at `density`, by signed-tetrahedron integrals about
        the origin (reference BdrsAndObjs.h:394)."""
        v = np.asarray(self.vertices, np.float64)
        tri = v[np.asarray(self.faces)]
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        d6 = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 * signed volume
        vol = d6.sum() / 6.0
        if abs(vol) < 1e-30:
            return 0.0, np.zeros(3), np.zeros((3, 3))
        com = (d6[:, None] * (a + b + c)).sum(0) / (24.0 * vol)
        s = a + b + c
        # the integral of x x^T over tet(0, a, b, c) is
        # V/20 (a a^T + b b^T + c c^T + s s^T)
        S = np.einsum("i,ijk->jk", d6 / 120.0,
                      np.einsum("ij,ik->ijk", a, a)
                      + np.einsum("ij,ik->ijk", b, b)
                      + np.einsum("ij,ik->ijk", c, c)
                      + np.einsum("ij,ik->ijk", s, s))
        m = density * vol
        inertia_o = density * (np.trace(S) * np.eye(3) - S)
        # parallel-axis shift to the com
        return m, com, inertia_o - m * ((com @ com) * np.eye(3)
                                        - np.outer(com, com))

    @staticmethod
    def WriteWavefront(filename, meshes):
        """Write meshes into one OBJ file (reference BdrsAndObjs.h:335)."""
        from .utils import io as _io

        verts, faces, off = [], [], 0
        for m in meshes:
            v = np.asarray(m.vertices, np.float64)
            verts.append(v)
            faces.append(np.asarray(m.faces) + off)
            off += v.shape[0]
        _io.write_mesh_obj(filename, np.concatenate(verts),
                           np.concatenate(faces))
