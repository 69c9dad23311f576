"""Multi-device sharding of the solver state over ``torch.distributed``.

The JAX package lays its state over a 1-D device mesh and lets XLA's SPMD
partitioner insert the collectives. Here every rank is a process that
holds its own shard, and the collectives are explicit: NCCL on CUDA
tensors, gloo on CPU tensors.

Layout (the JAX rule, ``state_shardings``): spheres, triangles and (with
`shard_owners`) owners are split on their leading axis when it divides
by the world size D; a contact table is split on its contact axis (a
row tensor on axis 0, a field-major record on axis 1) when its capacity
divides and each rank's home rows fit its cap / D; analyticals, the
time, step, overflow word, max velocity and lost-contact count are
replicated, and so is anything that does not divide. A table's count,
its B-side permutation and its unique-fetch lists describe the rows a
rank holds, so each rank rebuilds them from its own rows ("per-shard").

What the solver does on a mesh (``solver.refresh_contacts`` and
``solver.dynamics_step`` with `mesh`): every contact row has a home rank,
the index shard of its A-side sphere (``home_of``), the same from one
refresh to the next, so a re-detected pair finds its old row on its own
rank. A refresh gathers the owner records (and, with triangles, every
sphere's search record for the ST sweep), searches its own share, sends
each new row home (``Mesh.exchange``), carries history against the
rank's own old rows and finalizes them, fetching the B-side records it
lacks by id (``fetch_record``); a step all-gathers the owner records,
runs kernels B and A on the local rows, and reduce-scatters (or, with
owners replicated, all-reduces) the (N, 6) wrench before the local
owners are integrated. A split table holds its home rows, cap / D rows
a rank (``shard_table``).

``Mesh.record``, when a list, gets one (kind, rows, bytes) entry for
what each collective returned.
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


def home_of(ids, n: int, d: int):
    """The home rank of global ids in [0, n) split over `d` ranks: the
    index shard that holds the id (``home_range``). A contact row's home
    is that of its A-side sphere."""
    return torch.div(ids.long() * d, max(n, 1), rounding_mode="floor")


def home_range(n: int, d: int, r: int):
    """(lo, hi): the ids in [0, n) whose home is rank `r`; r n / D to
    (r + 1) n / D where D divides n."""
    return -(-r * n // d), -(-(r + 1) * n // d)


def _pack(tensors):
    """Tensors of one leading length and 4-byte dtypes as one (n, W) f32
    tensor, and the spec ``_unpack`` takes them apart by."""
    n = tensors[0].shape[0]
    words, spec = [], []
    for t in tensors:
        if t.element_size() != 4 or t.shape[0] != n:
            raise ValueError(f"cannot pack a {t.dtype} tensor of shape "
                             f"{tuple(t.shape)} with {n} rows")
        w = t.contiguous().reshape(n, t[0].numel() if n else 0)
        words.append(w if w.dtype == F else w.view(F))
        spec.append((t.dtype, tuple(t.shape[1:]), w.shape[1]))
    return torch.cat(words, dim=1), spec


def _unpack(words, spec):
    """The tensors ``_pack`` packed, as views of `words` (no copy: the
    solver's torch ops take strided tensors, and no kernel is handed a
    gathered record's pointer)."""
    out, c = [], 0
    for dtype, shape, w in spec:
        part = words[:, c:c + w]
        c += w
        if dtype != F:
            part = part.view(dtype)
        out.append(part.reshape((words.shape[0],) + shape))
    return out


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
    #: a list that gets (kind, rows, bytes) of what each collective
    #: returned (``_note``), or None: nothing recorded
    record: Optional[list] = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def _note(self, kind: str, out):
        """Record what a collective returned: its kind, its rows (the
        product of every axis but the last; a vector's length) and
        bytes."""
        if self.record is not None:
            rows = (out.numel() // max(out.shape[-1], 1) if out.dim() > 1
                    else out.numel())
            self.record.append((kind, rows,
                                out.numel() * out.element_size()))
        return out

    # -- collectives: every rank calls each one in the same order --------

    def gather_rows(self, x):
        """(n, ...) on each rank -> (D n, ...), the ranks' rows in rank
        order."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _gather_rows(out, x, group=self.group)
        return self._note("all_gather", out)

    def gather_fields(self, tensors):
        """``gather_rows`` of several tensors with one leading length and
        4-byte dtypes, packed into one collective."""
        if not tensors:
            return []
        words, spec = _pack(tensors)
        return _unpack(self.gather_rows(words), spec)

    def reduce_rows(self, x):
        """(D n, ...) partial sums on each rank -> this rank's (n, ...)
        block of their sum (reduce-scatter)."""
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        _reduce_rows(out, x, group=self.group)
        return self._note("reduce_scatter", out)

    def all_sum(self, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return self._note("all_reduce", y)

    def all_max(self, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return self._note("all_reduce", y)

    def all_to_all(self, x):
        """(D, ...) on each rank: block t goes to rank t; returns the
        (D, ...) blocks received, block s from rank s."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return self._note("all_to_all", out)

    def exchange(self, x, dest):
        """The rows of `x` (m, ...) sent to the ranks `dest` (m,) names (a
        dest of D or more drops the row), in one all_to_all_single whose
        split sizes go first (a D-int ``all_to_all`` and one read of both
        on the host). Returns (the rows received: block s from rank s,
        each in its order in `x`; the plan ``answer`` replies by)."""
        d = self.size
        key = torch.clamp(dest.long(), max=d)
        order = torch.sort(key, stable=True).indices
        sizes = torch.zeros(d + 1, dtype=torch.int64, device=x.device)
        sizes = sizes.scatter_add_(0, key, torch.ones_like(key))[:d]
        send, recv = torch.stack(
            [sizes, self.all_to_all(sizes[:, None])[:, 0]]).tolist()
        order = order[:sum(send)]
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x[order].contiguous(), recv, send,
                               group=self.group)
        return self._note("all_to_all_v", out), (order, send, recv,
                                                 x.shape[0])

    def answer(self, y, plan):
        """Replies `y`, a row for each row ``exchange`` received (in that
        order), sent back to their senders. Returns (m, ...) rows in the
        order of the exchanged `x`, zero where its row was dropped."""
        order, send, recv, m = plan
        back = y.new_empty((sum(send),) + tuple(y.shape[1:]))
        dist.all_to_all_single(back, y.contiguous(), send, recv,
                               group=self.group)
        self._note("all_to_all_v", back)
        out = y.new_zeros((m,) + tuple(y.shape[1:]))
        out[order] = back
        return out

    def fetch(self, words, ids, n: int):
        """Rows of an (n, W) table split over the ranks by ``home_of`` (this
        rank holds `words`, its ``home_range``) at the global `ids`: each
        id asked of its holder and its row sent back. Zero where an id is
        negative."""
        d = self.size
        dest = torch.where(ids >= 0, home_of(ids, n, d), d)
        asked, plan = self.exchange(ids[:, None], dest)
        lo = home_range(n, d, self.rank)[0]
        return self.answer(words[asked[:, 0].long() - lo], plan)

    def broadcast(self, x, src: int = 0):
        y = x.clone()
        dist.broadcast(y, src=src, group=self.group)
        return self._note("broadcast", y)

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
                     if _splits(getattr(state, k).cap, d)
                     and _homes_fit(getattr(state, k), state.spheres.n, d)))


def _homes_fit(table: ContactTable, n_spheres: int, d: int) -> bool:
    """Whether each rank's home rows of a whole table fit its cap / D."""
    live = table.idA >= 0
    homes = home_of(table.idA[live], n_spheres, d)
    return bool((torch.bincount(homes, minlength=d) <= table.cap // d).all())


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


def shard_table(table: ContactTable, mesh: Mesh, n_owners: int,
                n_spheres: int) -> ContactTable:
    """This rank's rows of a whole table: its home rows (``home_of`` their
    A-side sphere) in the table's order, then dead rows up to cap / D.
    Raises where they do not fit."""
    c = table.cap // mesh.size
    live = table.idA >= 0
    mine = live & (home_of(table.idA, n_spheres, mesh.size) == mesh.rank)
    rows = torch.cat([torch.nonzero(mine)[:, 0], torch.nonzero(~live)[:, 0]])
    if int(mine.sum()) > c:
        raise ValueError(f"{int(mine.sum())} home rows on rank {mesh.rank} "
                         f"do not fit {c}")
    rows = rows[:c]

    def take(x, axis):
        return x[rows] if axis == 0 else x[:, rows].contiguous()

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


def fetch_record(rec, ids, mesh: Mesh):
    """The rows at the global `ids` of a spheres or triangles record split
    over the ranks (this rank holds `rec`, its block), asked of their
    holders (``Mesh.fetch``): every field but the wildcards, which a
    refresh's finalize does not read. A negative id gets zeros."""
    names = [f.name for f in dataclasses.fields(rec) if f.name != "wildcards"]
    words, spec = _pack([getattr(rec, k) for k in names])
    got = _unpack(mesh.fetch(words, ids, words.shape[0] * mesh.size), spec)
    return rec.replace(wildcards={}, **dict(zip(names, got)))


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
        ch[name] = shard_table(getattr(state, name), mesh, lay.n_owners,
                               lay.n_spheres)
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
