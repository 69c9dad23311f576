"""Simulation state as dataclasses of tensors.

The same records as ``dem_engine_tpu.state`` with the same field names,
dtypes (f32, i32 ids/voxels) and layouts, so a JAX state flattened to
numpy converts field by field (see ``convert.py``).

Functions of the port never update a state tensor in place: a step or a
refresh returns new tensors. ``Engine.refresh`` relies on that to retry
a refresh losslessly from the retained pre-refresh state after it grew
a capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .defines import F, I


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# entity state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Owners(_Replace):
    """Per-owner rigid-body state (clumps, mesh owners, analytical owners)."""

    vox: torch.Tensor        # i32[N,3]  voxel index per axis (LBF-relative)
    loc: torch.Tensor        # f32[N,3]  in-voxel offset, in [0, voxel_size)
    quat: torch.Tensor       # f32[N,4]  (w,x,y,z), body->global
    vel: torch.Tensor        # f32[N,3]  linear velocity, global frame
    omg: torch.Tensor        # f32[N,3]  angular velocity, body frame
    lin_acc: torch.Tensor    # f32[N,3]  last contact acceleration
    ang_acc: torch.Tensor    # f32[N,3]  last contact angular accel, body frame
    ext_acc: torch.Tensor    # f32[N,3]  user-set persistent extra accel
    ext_ang_acc: torch.Tensor  # f32[N,3]
    family: torch.Tensor     # i32[N]
    mass: torch.Tensor       # f32[N]
    moi: torch.Tensor        # f32[N,3]  principal MOI, body frame
    wildcards: Dict[str, torch.Tensor]  # each f32[N]

    @property
    def n(self) -> int:
        return self.vox.shape[0]


@dataclasses.dataclass
class Spheres(_Replace):
    """Per-sphere-component geometry."""

    owner: torch.Tensor    # i32[S]
    relpos: torch.Tensor   # f32[S,3] body-frame offset from the owner CoM
    radius: torch.Tensor   # f32[S]
    mat: torch.Tensor      # i32[S]
    wildcards: Dict[str, torch.Tensor]

    @property
    def n(self) -> int:
        return self.owner.shape[0]


@dataclasses.dataclass
class Triangles(_Replace):
    """Triangle-mesh facets, node positions in the owner's body frame."""

    owner: torch.Tensor   # i32[T]
    nodes: torch.Tensor   # f32[T,3,3] body frame
    mat: torch.Tensor     # i32[T]
    wildcards: Dict[str, torch.Tensor]

    @property
    def n(self) -> int:
        return self.owner.shape[0]


@dataclasses.dataclass
class Analyticals(_Replace):
    """Flattened analytical boundary components."""

    owner: torch.Tensor        # i32[A]
    objtype: torch.Tensor      # i32[A] ANAL_* codes
    relpos: torch.Tensor       # f32[A,3] owner body frame
    direction: torch.Tensor    # f32[A,3] axis/normal, owner body frame
    size: torch.Tensor         # f32[A,3]
    normal_sign: torch.Tensor  # f32[A] +1 inward / -1 outward
    mat: torch.Tensor          # i32[A]
    wildcards: Dict[str, torch.Tensor]

    @property
    def n(self) -> int:
        return self.owner.shape[0]


# ---------------------------------------------------------------------------
# contact tables
# ---------------------------------------------------------------------------

# width of the packed per-contact static record of the non-fused tables
# (forces._build_statics):
#   [0] ownerA  [1] ownerB  [2:5] relposA  [5] radA  [6] matA  [7] matB
#   ss: [8:11] relposB [11] radB
#   st: [8:17] the triangle's body-frame nodes
#   sa: [8] objtype [9:12] relpos [12:15] direction [15] size1 [16] sign
#   [17] massA [18] massB [19:22] moiA [22:25] moiB [25] famA [26] famB
STATIC_W = 32

# width of the fused SS pass's static record, as forces.finalize_table
# builds it (field-major (FSTAT_W, cap)):
#   [0] own_a (-1 dead)  [1] radA  [2:5] relposA  [5:8] relposB  [8] radB
#   [9] m_eff  [10] t_col_eff (Schwartz collision time, 0 = overdamped)
#   [11] E_eff  [12] G_eff  [13] beta (Hertz damping ratio)  [14] mu
#   [15] Crr
FSTAT_W = 16

# wildcard rows of the fused SS pass: the largest built-in Hertz set,
# delta_tan xyz + delta_time. The JAX package also carries a B-sorted
# copy (wcb) for its second pass; the port computes each contact once
# and has no B-sorted copy.
WCB_W = 4


@dataclasses.dataclass
class ContactTable(_Replace):
    """Fixed-capacity padded contact-pair table for one contact class.

    Invariants after a refresh (forces.finalize_table):
      * padding rows have ``idA == -1`` and sit at the END;
      * rows are sorted by (own_a, own_b);
      * ``perm_b`` permutes rows into own_b-sorted order and
        ``own_b_sorted`` = own_b[perm_b], dead rows mapped to n_owners.

    A table the fused SS pass owns ("slim": the SS table of a built-in
    Hertz model) carries ``fstat_a`` and no
    ``statics``/``premix``/``force``/``torque``/``cpoint``; the other
    tables (the SS table of any other model among them) carry the wide
    ``statics`` record and ``premix`` that ``contact_pass`` reads, and the
    ``force``/``torque``/``cpoint`` of its last step.
    """

    idA: torch.Tensor          # i32[C] sphere geometry id
    idB: torch.Tensor          # i32[C] sphere / triangle / analytical id
    count: torch.Tensor        # i32[] live entries
    persist: torch.Tensor      # i32[C]
    force: torch.Tensor        # f32[C,3] last force on A (slim: (0,3))
    torque: torch.Tensor       # f32[C,3] last torque-only force
    cpoint: torch.Tensor       # f32[C,3] last contact point rel owner A
    wildcards: Dict[str, torch.Tensor]  # each f32[C]
    own_a: torch.Tensor        # i32[C] owner of A (-1 dead)
    own_b: torch.Tensor        # i32[C] owner of B (-1 dead)
    perm_b: torch.Tensor       # i32[C] row permutation sorting by own_b
    own_b_sorted: torch.Tensor  # i32[C] own_b[perm_b]; dead -> n_owners
    statics: torch.Tensor      # f32[STATIC_W, C]; (0, C) when slim
    premix: Dict[str, torch.Tensor]  # premixed material props, each f32[C]
    fstat_a: torch.Tensor      # f32[FSTAT_W, C]; (FSTAT_W, 0) when not slim
    # unique-other-owner fetch (SolverConfig.uniq_cap > 0, kernel B-ub):
    # per block of OB owners of the A side, the distinct B owners of its
    # rows, and each row's rank in that list. Rows are sorted by
    # (own_a, own_b), so a block's rows meet each B owner in runs.
    uidx: torch.Tensor         # f32[C] rank of own_b in its block's list
                               # (exact int); (0,) when uniq fetch is off
    uniq_a: torch.Tensor       # i32[NB*UB] per-block B owners (n_owners
                               # in unused slots)
    uniq_max: torch.Tensor     # i32[] largest per-block unique count over
                               # the A and the B layout, at the refresh
    blk_start: torch.Tensor    # i32[NB+1] first row of each block's A
                               # owners, then the first dead row; (0,) when
                               # uniq fetch is off. Rows past the live ones
                               # do not move it, so grown/shrunk keep it

    @property
    def cap(self) -> int:
        return self.idA.shape[0]

    @staticmethod
    def empty(cap: int, wildcard_names: Tuple[str, ...] = (),
              premix_names: Tuple[str, ...] = (), fused: bool = False,
              uniq_rows: int = 0, uniq_blocks: int = 0,
              device=None) -> "ContactTable":
        def z(*shape, dtype=F):
            return torch.zeros(shape, dtype=dtype, device=device)

        statics = z(0, cap) if fused else z(STATIC_W, cap)
        if not fused:
            statics[0] = -1.0
        fstat = z(FSTAT_W, cap if fused else 0)
        if fused:
            fstat[0] = -1.0
        qcap = 0 if fused else cap
        return ContactTable(
            idA=torch.full((cap,), -1, dtype=I, device=device),
            idB=torch.full((cap,), -1, dtype=I, device=device),
            count=z(dtype=I),
            persist=z(cap, dtype=I),
            force=z(qcap, 3),
            torque=z(qcap, 3),
            cpoint=z(qcap, 3),
            wildcards={k: z(cap) for k in wildcard_names},
            own_a=torch.full((cap,), -1, dtype=I, device=device),
            own_b=torch.full((cap,), -1, dtype=I, device=device),
            perm_b=torch.arange(cap, dtype=I, device=device),
            own_b_sorted=torch.full((cap,), 2**30, dtype=I, device=device),
            statics=statics,
            premix={} if fused else {k: z(cap) for k in premix_names},
            fstat_a=fstat,
            uidx=z(cap if (fused and uniq_rows) else 0),
            uniq_a=z(uniq_rows, dtype=I),
            uniq_max=z(dtype=I),
            # no live row: every block starts at row 0
            blk_start=z(uniq_blocks + 1 if uniq_rows else 0, dtype=I),
        )

    def grown(self, new_cap: int) -> "ContactTable":
        """Capacity growth: appended rows are dead (idA -1, identity
        perm_b slots, dead fstat/statics marker)."""
        cap = self.cap
        if new_cap < cap:
            raise ValueError(f"grown({new_cap}) below the capacity {cap}")
        pad = new_cap - cap
        dev = self.idA.device

        def rows(x, fill=0):
            if x.shape[0] == 0:
                return x
            tail = torch.full((pad,) + tuple(x.shape[1:]), fill,
                              dtype=x.dtype, device=dev)
            return torch.cat([x, tail], 0)

        def cols(m, dead_row0=False):
            if m.shape[0] == 0 or m.shape[1] != cap:
                return m if m.shape[0] else m.new_zeros((0, new_cap))
            tail = m.new_zeros((m.shape[0], pad))
            if dead_row0:
                tail[0] = -1.0
            return torch.cat([m, tail], 1)

        return ContactTable(
            idA=rows(self.idA, -1),
            idB=rows(self.idB, -1),
            count=torch.clamp(self.count, max=new_cap),
            persist=rows(self.persist),
            force=rows(self.force),
            torque=rows(self.torque),
            cpoint=rows(self.cpoint),
            wildcards={k: rows(v) for k, v in self.wildcards.items()},
            own_a=rows(self.own_a, -1),
            own_b=rows(self.own_b, -1),
            perm_b=torch.cat([self.perm_b, torch.arange(
                cap, new_cap, dtype=I, device=dev)]),
            own_b_sorted=rows(self.own_b_sorted, 2**30),
            statics=cols(self.statics, dead_row0=True),
            premix={k: rows(v) for k, v in self.premix.items()},
            fstat_a=cols(self.fstat_a, dead_row0=True),
            uidx=rows(self.uidx),
            uniq_a=self.uniq_a,
            uniq_max=self.uniq_max,
            blk_start=self.blk_start,
        )

    def shrunk(self, new_cap: int) -> "ContactTable":
        """Capacity shrink to the head rows. Safe while count <= new_cap:
        live rows come first in the own_a order, and dead rows sort last
        in the perm_b order, so the head of perm_b is a permutation of the
        kept rows (the clamp only guards the dead tail)."""
        if new_cap > self.cap:
            raise ValueError(f"shrunk({new_cap}) above the capacity "
                             f"{self.cap}")

        def head(x):
            return x[:new_cap] if x.shape[0] else x

        def cols(m):
            # a column slice is a strided view; the kernels take dense rows
            return (m[:, :new_cap].contiguous() if m.shape[1] == self.cap
                    else m)

        return ContactTable(
            idA=head(self.idA),
            idB=head(self.idB),
            count=torch.clamp(self.count, max=new_cap),
            persist=head(self.persist),
            force=head(self.force),
            torque=head(self.torque),
            cpoint=head(self.cpoint),
            wildcards={k: head(v) for k, v in self.wildcards.items()},
            own_a=head(self.own_a),
            own_b=head(self.own_b),
            perm_b=torch.clamp(self.perm_b[:new_cap], max=new_cap - 1),
            own_b_sorted=head(self.own_b_sorted),
            statics=cols(self.statics),
            premix={k: head(v) for k, v in self.premix.items()},
            fstat_a=cols(self.fstat_a),
            uidx=head(self.uidx),
            uniq_a=self.uniq_a,
            uniq_max=self.uniq_max,
            blk_start=self.blk_start,
        )


# overflow bit flags, surfaced to the host after each refresh (same
# values as the JAX package). The port's windowless sweep kernel keeps
# any number of hits per bin, so OVF_BIN_OCC and OVF_PALLAS_WIN never
# rise, in two-class mode either.
OVF_SS_CAP = 1
OVF_ST_CAP = 2
OVF_SA_CAP = 4
OVF_BIN_OCC = 8
OVF_ROW_CAP = 16
OVF_TRI_BINS = 32
OVF_VEL = 64
OVF_ST_OCC = 128
OVF_AVG_CONTACTS = 256
OVF_PALLAS_WIN = 512
OVF_SEGRED = 1024
OVF_SPATIAL_BUCKET = 2048
OVF_UNIQ = 4096
OVF_XOCC = 8192
OVF_LCAP = 16384


@dataclasses.dataclass
class SimState(_Replace):
    owners: Owners
    spheres: Spheres
    tris: Triangles
    anals: Analyticals
    ss: ContactTable
    st: ContactTable
    sa: ContactTable
    time: torch.Tensor           # f32[]
    step: torch.Tensor           # i32[]
    overflow: torch.Tensor       # i32[] bit flags
    max_vel: torch.Tensor        # f32[] measured at the last refresh
    lost_contacts: torch.Tensor  # i32[] cumulative dropped-history count
    #: on a mesh, what this rank's shard holds (``parallel.mesh.Layout``:
    #: the global counts and which records are split); None for a whole
    #: state
    layout: Any = None

    @property
    def device(self) -> torch.device:
        return self.owners.vox.device


@dataclasses.dataclass
class RuntimeParams(_Replace):
    """Per-run tunables, as tensors on the state's device."""

    h: torch.Tensor                      # f32[]
    gravity: torch.Tensor                # f32[3]
    domain: torch.Tensor                 # f32[3] extents (LBF-relative)
    expand_safety_multi: torch.Tensor    # f32[]
    expand_safety_adder: torch.Tensor    # f32[]
    approx_max_vel: torch.Tensor         # f32[]
    error_out_vel: torch.Tensor          # f32[]
    error_out_avg_contacts: torch.Tensor  # f32[]
    max_drift: torch.Tensor              # i32[] steps a table stays live
    family_mask: torch.Tensor            # bool[256,256] True => enabled
    family_persist: torch.Tensor         # bool[256,256]
    family_extra_margin: torch.Tensor    # f32[256]
    mat_props: Dict[str, torch.Tensor]   # each f32[M]
    pair_props: Dict[str, torch.Tensor]  # each f32[M,M]
    cls_thr: torch.Tensor                # f32[] two-class CD threshold
    bin_factor: torch.Tensor             # f32[] bin size over 2*max reach


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Shapes and callables of a run.

    Kernels are chosen by the device the tensors live on, not here: on a
    CUDA device the force pass, the wrench sums and the pair search are
    the hand-written kernels, on the CPU their plain versions.
    """

    voxel_size: float
    integrator: Any                      # TimeIntegrator
    force_model: Any                     # models.ForceModel
    cap_ss: int = 64
    cap_st: int = 16
    cap_sa: int = 16
    #: spheres per bin the ST sweep scans (OVF_ST_OCC grows it)
    max_per_bin: int = 16
    #: bins per axis a triangle's box may cover (OVF_TRI_BINS doubles it
    #: up to 32, then switches to the exact S x T candidate matrix)
    max_tri_span: int = 4
    st_bruteforce: bool = False
    #: two-class polydisperse CD: spheres of radius <= params.cls_thr are
    #: the small class, searched on their own grid; the large class is
    #: compacted to `cross_lcap` rows (0 = a third of the spheres) on a
    #: coarse grid, and small-large pairs come from the large spheres'
    #: multi-bin entries, `cross_mpb` scanned per coarse bin (OVF_LCAP and
    #: OVF_XOCC grow them)
    cd_two_class: bool = False
    cross_lcap: int = 0
    cross_mpb: int = 16
    #: per-block capacity of the unique-other-owner lists of kernel B-ub
    #: (0 = off: kernel B gathers each row's B record itself)
    uniq_cap: int = 0
    #: keep contacts marked persistent (params.family_persist, the
    #: Mark*Persistent* calls) in their tables with their wildcards when
    #: a refresh no longer detects them
    use_persistency: bool = False
    prescriptions: Tuple[Any, ...] = ()
    family_changes: Tuple[Any, ...] = ()
    #: spatially decomposed SS search over an Engine's mesh: one x-slab
    #: per rank, `spatial_capx` rows per exchange bucket (0 = auto;
    #: OVF_SPATIAL_BUCKET grows it), ``parallel.spatial``
    spatial_refresh: bool = False
    spatial_capx: int = 0


def _join(path, name):
    return f"{path}.{name}" if path else name


def state_tensors(x, path: str = ""):
    """Every tensor of a (nested) state dataclass with its dotted path
    (a dict entry as ``[key]``), in field order: ``owners.vox``, ...,
    ``ss.wildcards[delta_time]``, ..., ``time``."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from state_tensors(getattr(x, f.name), _join(path, f.name))
    elif isinstance(x, dict):
        for key, v in x.items():
            yield from state_tensors(v, f"{path}[{key}]")


def map_tensors(x, fn, path: str = ""):
    """A copy of the (nested) state dataclass `x` with each tensor `t` at
    path `p` (as ``state_tensors`` names it) replaced by fn(p, t)."""
    if isinstance(x, torch.Tensor):
        return fn(path, x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: map_tensors(getattr(x, f.name), fn, _join(path, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {key: map_tensors(v, fn, f"{path}[{key}]")
                for key, v in x.items()}
    return x
