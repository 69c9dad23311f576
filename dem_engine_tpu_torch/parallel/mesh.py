"""Multi-device sharding of the solver state over ``torch.distributed``.

The JAX package lays its state over a 1-D device mesh and lets XLA's SPMD
partitioner insert the collectives. Here every rank is a process that
holds its own shard, and the collectives are explicit: NCCL on CUDA
tensors, gloo on CPU tensors.

Layout (the JAX rule, ``state_shardings``): spheres, triangles and (with
`shard_owners`) owners are split on their leading axis when it divides
by the world size D; every contact table is split on its contact axis (a
row tensor on axis 0, a field-major record on axis 1); analyticals, the
time, step, overflow word, max velocity and lost-contact count are
replicated, and so is anything that does not divide. A table's count,
its B-side permutation and its unique-fetch lists describe the rows a
rank holds, so each rank rebuilds them from its own rows ("per-shard").

What the solver does on a mesh (``solver.refresh_contacts`` and
``solver.dynamics_step`` with `mesh`): a refresh gathers the geometry
and the old tables' keys, searches (the spatial search of
``parallel.spatial`` or the global one), carries the history once over
the whole pair list and finalizes this rank's rows; a step all-gathers
the owner records, runs kernels B and A on the local rows, and
reduce-scatters (or, with owners replicated, all-reduces) the (N, 6)
wrench before the local owners are integrated.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..defines import F, I
from ..initializer import resolve_device
from ..ops import forces
from ..state import ContactTable, SimState, map_tensors, state_tensors

#: collective timeouts of a group make_mesh makes itself: a hung
#: collective raises instead of waiting for ever
TIMEOUT_CPU = datetime.timedelta(seconds=60)
TIMEOUT_CUDA = datetime.timedelta(seconds=600)

# recent torch names these collectives all_gather_single and
# reduce_scatter_single and warns on the older names, which older
# releases have alone
_gather_rows = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_rows = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

_TABLES = ("ss", "st", "sa")
# a table's per-contact tensors: rows on axis 0, field-major on axis 1
_ROWS = ("idA", "idB", "persist", "force", "torque", "cpoint", "own_a",
         "own_b", "uidx")
_ROW_DICTS = ("wildcards", "premix")
_COLS = ("statics", "fstat_a")

class Layout(NamedTuple):
    """What a rank's shard holds (``SimState.layout``): the global counts
    of owners, spheres and triangles, whether each of those records is
    split, and the names of the split contact tables."""

    n_owners: int
    n_spheres: int
    n_tris: int
    owners: bool
    spheres: bool
    tris: bool
    tables: tuple


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D mesh: a process group, this rank, the world size and the
    rank's device. `shard_owners` False keeps the owners replicated: the
    wrench sums are all-reduced and every rank integrates every owner.
    `axis` is the JAX mesh's axis name, kept for parity and read by
    nothing: the mesh has one axis."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "shard"
    shard_owners: bool = True
    #: whether make_mesh initialised the process group (``close`` ends it)
    owns_group: bool = False

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    # -- collectives: every rank calls each one in the same order --------

    def gather_rows(self, x):
        """(n, ...) on each rank -> (D n, ...), the ranks' rows in rank
        order."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _gather_rows(out, x, group=self.group)
        return out

    def gather_fields(self, tensors):
        """``gather_rows`` of several tensors with one leading length and
        4-byte dtypes, packed into one collective."""
        if not tensors:
            return []
        n = tensors[0].shape[0]
        words = []
        for t in tensors:
            if t.element_size() != 4 or t.shape[0] != n:
                raise ValueError(f"cannot pack a {t.dtype} tensor of shape "
                                 f"{tuple(t.shape)} with {n} rows")
            w = t.contiguous().reshape(n, t[0].numel() if n else 0)
            words.append(w if w.dtype == F else w.view(F))
        g = self.gather_rows(torch.cat(words, dim=1))
        out, c = [], 0
        for t, w in zip(tensors, words):
            part = g[:, c:c + w.shape[1]].contiguous()
            c += w.shape[1]
            if t.dtype != F:
                part = part.view(t.dtype)
            out.append(part.reshape((g.shape[0],) + tuple(t.shape[1:])))
        return out

    def reduce_rows(self, x):
        """(D n, ...) partial sums on each rank -> this rank's (n, ...)
        block of their sum (reduce-scatter)."""
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        _reduce_rows(out, x, group=self.group)
        return out

    def all_sum(self, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def all_max(self, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def all_to_all(self, x):
        """(D, ...) on each rank: block t goes to rank t; returns the
        (D, ...) blocks received, block s from rank s."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def broadcast(self, x, src: int = 0):
        y = x.clone()
        dist.broadcast(y, src=src, group=self.group)
        return y

    def close(self):
        """End the process group if make_mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard",
              device=None, shard_owners: bool = True) -> Mesh:
    """The mesh of the initialised default process group (the caller or a
    launcher runs ``init_process_group``: NCCL for CUDA, gloo for the
    CPU). Each rank's device is ``cuda:<local rank>`` unless `device`
    says otherwise. With no group initialised only `n_devices` = 1 goes
    on: it makes its own one-rank group over a ``HashStore``; any other
    size raises, so nothing drops silently to one process. `axis` is
    accepted for parity with the JAX package's ``make_mesh`` and is
    ignored."""
    dev = resolve_device("cuda" if device is None else device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    owns = False
    if not dist.is_initialized():
        if n_devices != 1:
            raise RuntimeError(
                "no torch.distributed process group is initialised: call "
                "init_process_group on every rank first (or ask for "
                "make_mesh(1) for a one-rank group)")
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1,
            timeout=TIMEOUT_CUDA if dev.type == "cuda" else TIMEOUT_CPU)
        owns = True
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks asked of a process "
                         f"group of {world}")
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(
            f"the process group runs {have}, and {dev.type} tensors need "
            f"{backend}")
    rank = dist.get_rank()
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, rank=rank, size=world, device=dev,
                axis=axis, shard_owners=shard_owners, owns_group=owns)


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------


def _splits(n: int, d: int) -> bool:
    return n > 0 and n % d == 0


def _plan(state: SimState, mesh: Mesh, shard_owners=None) -> Layout:
    """The layout the JAX rule gives a whole state on `mesh`."""
    if state.layout is not None:
        return state.layout
    d = mesh.size
    so = mesh.shard_owners if shard_owners is None else shard_owners
    return Layout(
        n_owners=state.owners.n, n_spheres=state.spheres.n,
        n_tris=state.tris.n,
        owners=so and _splits(state.owners.n, d),
        spheres=_splits(state.spheres.n, d),
        tris=_splits(state.tris.n, d),
        tables=tuple(k for k in _TABLES
                     if _splits(getattr(state, k).cap, d)))


def state_shardings(state: SimState, mesh: Mesh, shard_owners=None) -> dict:
    """Each state tensor's placement, by its ``state.state_tensors`` path:
    "split:0" or "split:1" (the axis), "replicated", or "per-shard" (a
    table's count, B-side permutation and unique-fetch lists, rebuilt by
    each rank from its rows). `shard_owners` defaults to the mesh's."""
    lay = _plan(state, mesh, shard_owners)
    out = {}
    for rec in ("owners", "spheres", "tris"):
        place = "split:0" if getattr(lay, rec) else "replicated"
        for p, _ in state_tensors(getattr(state, rec), rec):
            out[p] = place
    for p, _ in state_tensors(state.anals, "anals"):
        out[p] = "replicated"
    for name in _TABLES:
        t = getattr(state, name)
        axes = _row_axes(t) if name in lay.tables else {}
        for p, _ in state_tensors(t, name):
            field = p[len(name) + 1:].split("[")[0]
            if name not in lay.tables:
                out[p] = "replicated"
            elif field in axes:
                out[p] = f"split:{axes[field]}"
            else:
                out[p] = "per-shard"
    for k in ("time", "step", "overflow", "max_vel", "lost_contacts"):
        out[k] = "replicated"
    return out


def _row_axes(table: ContactTable) -> dict:
    """field name -> axis of the table's per-contact tensors."""
    cap = table.cap
    axes = {}
    for k in _ROWS:
        if getattr(table, k).shape[0] == cap:
            axes[k] = 0
    for k in _ROW_DICTS:
        axes[k] = 0
    for k in _COLS:
        if getattr(table, k).shape[1] == cap:
            axes[k] = 1
    return axes


def _map_rows(table: ContactTable, fn) -> ContactTable:
    """The table with fn(x, axis) applied to every per-contact tensor
    (axis 0 for rows, 1 for field-major records), in a fixed order."""
    cap = table.cap
    ch = {}
    for k in _ROWS:
        x = getattr(table, k)
        ch[k] = fn(x, 0) if x.shape[0] == cap else x
    for k in _ROW_DICTS:
        ch[k] = {n: fn(v, 0) for n, v in getattr(table, k).items()}
    for k in _COLS:
        x = getattr(table, k)
        ch[k] = fn(x, 1) if x.shape[1] == cap else x
    return table.replace(**ch)


def relayout(table: ContactTable, n_owners: int) -> ContactTable:
    """A table whose rows are in (own_a, own_b) order, dead rows last,
    with its count, B-side permutation and unique-fetch lists rebuilt
    from those rows."""
    live = table.idA >= 0
    perm_b, own_b_sorted = forces.b_side(table.own_a, table.own_b, live,
                                         n_owners)
    out = table.replace(perm_b=perm_b, own_b_sorted=own_b_sorted,
                        count=live.sum().to(I))
    if out.uidx.shape[0]:
        from ..ops.fused_force import n_blocks_of

        out = forces.with_uniq_layout(
            out, n_owners, out.uniq_a.shape[0] // n_blocks_of(n_owners))
    return out


def shard_table(table: ContactTable, mesh: Mesh,
                n_owners: int) -> ContactTable:
    """This rank's contiguous block of the rows of a whole table in
    (own_a, own_b) order, as a table of its own."""
    c = table.cap // mesh.size
    lo, hi = mesh.rank * c, (mesh.rank + 1) * c

    def take(x, axis):
        return (x[lo:hi] if axis == 0 else x[:, lo:hi]).contiguous()

    return relayout(_map_rows(table, take), n_owners)


def gather_table(table: ContactTable, mesh: Mesh,
                 n_owners: int) -> ContactTable:
    """The whole table from every rank's block: the rows in (own_a, own_b)
    order with the dead ones last, as a refresh leaves a table."""
    parts = []

    def collect(x, axis):
        parts.append(x if axis == 0 else x.T)
        return x

    _map_rows(table, collect)
    it = iter(mesh.gather_fields(parts))
    whole = _map_rows(table, lambda x, axis: next(it) if axis == 0
                      else next(it).T.contiguous())
    live = whole.idA >= 0
    perm = forces.owner_sort(whole.own_a, whole.own_b, live)
    whole = _map_rows(whole, lambda x, axis: (x[perm] if axis == 0
                                              else x[:, perm].contiguous()))
    return relayout(whole, n_owners)


def _split_record(rec, mesh: Mesh):
    n = next(iter(state_tensors(rec)))[1].shape[0] // mesh.size
    lo = mesh.rank * n
    return map_tensors(rec, lambda p, x: x[lo:lo + n].contiguous())


def gather_record(rec, mesh: Mesh):
    """A whole owners, spheres or triangles record from every rank's
    block, in one collective."""
    it = iter(mesh.gather_fields([x for _, x in state_tensors(rec)]))
    return map_tensors(rec, lambda p, x: next(it))


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """This rank's shard of a whole state (on the mesh's device), laid out
    by ``state_shardings``."""
    if state.layout is not None:
        raise ValueError("the state is a shard already")
    state = map_tensors(state, lambda p, x: x.to(mesh.device))
    lay = _plan(state, mesh)
    ch = {}
    for rec in ("owners", "spheres", "tris"):
        if getattr(lay, rec):
            ch[rec] = _split_record(getattr(state, rec), mesh)
    for name in lay.tables:
        ch[name] = shard_table(getattr(state, name), mesh, lay.n_owners)
    return state.replace(**ch, layout=lay)


def gather_state(state: SimState, mesh: Mesh) -> SimState:
    """The whole state, on every rank, from each rank's shard (read-back
    and tests; a JAX program gets this from ``np.asarray`` of a sharded
    array)."""
    lay = state.layout
    if lay is None:
        return state
    ch = {}
    for rec in ("owners", "spheres", "tris"):
        if getattr(lay, rec):
            ch[rec] = gather_record(getattr(state, rec), mesh)
    for name in lay.tables:
        ch[name] = gather_table(getattr(state, name), mesh, lay.n_owners)
    return state.replace(**ch, layout=None)
