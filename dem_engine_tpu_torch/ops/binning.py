"""Broad + mid phase contact detection: a cell list over a uniform grid.

Every sphere belongs to exactly one bin (its center's), with
``bin_size >= 2 * max(radius + margin)``, so a touching pair lies in the
same bin or in one of the 13 forward neighbours of the half shell, and
each unordered bin pair is visited once. Spheres are sorted by flat bin
id; a pair search walks each sphere's half shell over the sorted table.

``sweep_table`` here is the plain slot sweep (the JAX package's XLA
``find_pairs_ss``) and the plain version of the CUDA pair-search kernel;
``ops/sweep.py`` builds the sorted table and chooses between the two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..defines import F, I

# half shell: self bin + 13 forward neighbour offsets (dx, dy, dz)
HALF_SHELL = np.asarray(
    [[0, 0, 0], [1, 0, 0], [-1, 1, 0], [0, 1, 0], [1, 1, 0]]
    + [[dx, dy, 1] for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    np.int32,
)

_MAX_TOTAL_BINS = float(2**30)
REC_W = 8  # floats per sorted-sphere record (SphereBinTable.rec)
SENTINEL_BIN = 2**31 - 1


def build_grid(domain, reach_max, factor=None):
    """Bin size (f32 scalar tensor) and per-axis bin counts (i32[3])."""
    bs = 2.0 * reach_max * 1.01 + 1e-30
    if factor is not None:
        bs = bs * torch.clamp(factor, min=1.0)
    nb = torch.clamp(torch.ceil(domain / bs), min=1.0)
    prod = nb[0] * nb[1] * nb[2]
    scale = torch.clamp(torch.pow(prod / _MAX_TOTAL_BINS, 1.0 / 3.0),
                        min=1.0)
    # per-axis cap at 2^23: integer-exact bin indices in f32 records
    scale = torch.maximum(scale, torch.max(domain) / bs / float(2**23))
    bs = bs * scale
    nb = torch.clamp(torch.ceil(domain / bs), min=1.0).to(I)
    return bs, nb


def bin_index_3d(pos, bin_size, nb):
    idx = torch.floor(pos / bin_size).to(I)
    return torch.minimum(torch.clamp(idx, min=0), nb - 1)


def flat_bin(idx3, nb):
    return (idx3[..., 2] * nb[1] + idx3[..., 1]) * nb[0] + idx3[..., 0]


@dataclasses.dataclass
class SphereBinTable:
    """Spheres sorted by flat bin id, padded to a static size.

    ``rec`` packs the candidate payload [pos3, reach, owner, family, id]
    into one f32 row per sorted sphere (ids are exact in f32 below 2^24),
    padded to REC_W = 8 floats (32 bytes: two aligned float4 loads in
    kernel C; column 7 is 0); padding rows have reach -1e30, owner -1
    and id S.
    """

    sorted_bin: torch.Tensor   # i32[Spad]
    rec: torch.Tensor          # f32[Spad,REC_W]
    order: torch.Tensor        # i32[Spad] original sphere id (S for padding)
    idx3: torch.Tensor         # i32[Spad,3] sorted 3-D bin indices
    max_occ: torch.Tensor      # i32[] most spheres in one bin

    @property
    def n_rows(self) -> int:
        return self.sorted_bin.shape[0]


def build_sphere_table(pos, reach, owner, family, bin_size, nb, pad_to,
                       member=None):
    """Sort spheres by flat bin id; pad to `pad_to` rows with sentinel
    bins. With `member` (bool[S]) the table holds that subset only: the
    excluded spheres take the sentinel bin, so they sort into the tail
    inside the first S rows, with reach -1e30, owner -1, id S and order
    S, exactly like padding."""
    S = pos.shape[0]
    dev = pos.device
    idx3 = bin_index_3d(pos, bin_size, nb)
    binid = flat_bin(idx3, nb)
    if member is not None:
        binid = torch.where(member, binid, SENTINEL_BIN)
    sorted_bin, order = torch.sort(binid, stable=True)
    order = order.to(I)
    pad = pad_to - S
    if pad > 0:
        sorted_bin = torch.cat([sorted_bin, torch.full(
            (pad,), SENTINEL_BIN, dtype=I, device=dev)])
        order = torch.cat([order, torch.full((pad,), S, dtype=I,
                                             device=dev)])
    if S == 0:  # the padding rows gather from one zero row
        pos, reach, owner, family, idx3 = (
            x.new_zeros((1,) + tuple(x.shape[1:]))
            for x in (pos, reach, owner, family, idx3))
        if member is not None:
            member = member.new_zeros((1,))
    ok = order < S
    src = torch.clamp(order, max=max(S - 1, 0)).long()
    if member is not None:
        ok &= member[src]
        order = torch.where(ok, order, S)
    rec = torch.cat(
        [
            pos[src],
            torch.where(ok, reach[src], -1e30)[:, None],
            torch.where(ok, owner[src].to(F), -1.0)[:, None],
            torch.where(ok, family[src].to(F), 0.0)[:, None],
            torch.where(ok, order, S).to(F)[:, None],
            torch.zeros((pad_to, 1), dtype=F, device=dev),
        ],
        dim=1,
    )
    # padding rows get the top-corner bin, consistent with their
    # sentinel sort key
    sidx3 = torch.where(ok[:, None], idx3[src], (nb - 1)[None, :])

    return SphereBinTable(sorted_bin, rec, order, sidx3,
                          max_run(sorted_bin))


def max_run(sorted_keys):
    """i32[]: the most equal keys in a sorted i32 tensor, the sentinel bin
    apart. A row's place in its run is its index less the first index of
    its key, found by a search of the sorted keys (torch.cummax over the
    run starts took 23.1 ms of one 262,144-clump poly refresh's device
    time, its 7.1M cross entries the most, on an NVIDIA H100 80GB HBM3 at
    700 W)."""
    n = sorted_keys.shape[0]
    if n == 0:
        return torch.zeros((), dtype=I, device=sorted_keys.device)
    first = torch.searchsorted(sorted_keys, sorted_keys, out_int32=True)
    k = torch.arange(n, dtype=I, device=sorted_keys.device)
    return torch.where(sorted_keys != SENTINEL_BIN, k - first + 1,
                       0).max().to(I)


def _compact(hit_flat, payloads, cap, base_total, outs):
    """Scatter hits into fixed-capacity outputs at base + rank; hits past
    `cap` are dropped (they still count in the returned total)."""
    csum = torch.cumsum(hit_flat.to(I), 0, dtype=I)
    dest = torch.where(hit_flat, base_total + csum - 1, cap)
    dest = torch.where(dest < cap, dest, cap).long()
    new_outs = []
    for o, p in zip(outs, payloads):
        # one spare slot takes every dropped lane
        ext = torch.cat([o, o.new_zeros(1)])
        ext[dest] = p.to(o.dtype)
        new_outs.append(ext[:cap])
    total = base_total + csum[-1] if hit_flat.numel() else base_total
    return tuple(new_outs), total


def sweep_table(tab: SphereBinTable, n_spheres, family_mask, nb, cap,
                max_per_bin):
    """The plain slot sweep over a sorted table: each sphere scans
    `max_per_bin` slots of each half-shell bin, 65,536 spheres at a time.
    Returns (idA, idB, count) with idA < idB, in sorted-row,
    half-shell-offset, slot order; count may exceed `cap`."""
    S = n_spheres
    spad = tab.n_rows
    dev = tab.rec.device
    chunk = min(max(spad, 1), 65536)
    fam_mask_flat = family_mask.reshape(-1)
    offs = torch.as_tensor(HALF_SHELL, device=dev)
    mpb = max(int(max_per_bin), 1)
    outA = torch.full((cap,), -1, dtype=I, device=dev)
    outB = torch.full((cap,), -1, dtype=I, device=dev)
    total = torch.zeros((), dtype=I, device=dev)
    same_bin = (torch.arange(14, device=dev) == 0)[None, :, None]
    slot_iota = torch.arange(mpb, dtype=I, device=dev)
    for k0 in range(0, spad, chunk):
        k1 = min(k0 + chunk, spad)
        kk = torch.arange(k0, k1, dtype=I, device=dev)
        my_idx3 = tab.idx3[k0:k1]
        my_rec = tab.rec[k0:k1]
        my_pos = my_rec[:, 0:3]
        my_reach = my_rec[:, 3]
        my_own = my_rec[:, 4]
        my_fam = my_rec[:, 5].to(I)
        my_id = my_rec[:, 6].to(I)
        row_ok = my_id < S

        tgt3 = my_idx3[:, None, :] + offs[None, :, :]          # (ch,14,3)
        ok3 = torch.all((tgt3 >= 0) & (tgt3 < nb), dim=-1)
        tgt = torch.where(ok3, flat_bin(tgt3, nb), -2).contiguous()
        starts = torch.searchsorted(tab.sorted_bin, tgt, out_int32=True)
        ends = torch.searchsorted(tab.sorted_bin, tgt, right=True,
                                  out_int32=True)
        slots = starts[..., None] + slot_iota                  # (ch,14,mpb)
        slots_c = torch.clamp(slots, max=spad - 1).long()
        valid = (slots < ends[..., None]) & (slots < spad)
        valid &= torch.where(same_bin, slots > kk[:, None, None], True)
        valid &= row_ok[:, None, None]

        crec = tab.rec[slots_c]
        # squared distance summed x, y, z in that order, each product
        # rounded: the CUDA kernel's test rounds the same way, so the two
        # give the same bit
        d = my_pos[:, None, None, :] - crec[..., 0:3]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        rr = my_reach[:, None, None] + crec[..., 3]
        hit = valid & (d2 < rr * rr)
        hit &= crec[..., 4] != my_own[:, None, None]
        hit &= fam_mask_flat[(my_fam[:, None, None] * 256
                              + crec[..., 5].to(I)).long()]

        a = my_id[:, None, None].expand(hit.shape)
        cid = crec[..., 6].to(I)
        lo = torch.minimum(a, cid).reshape(-1)
        hi = torch.maximum(a, cid).reshape(-1)
        (outA, outB), total = _compact(hit.reshape(-1), (lo, hi), cap,
                                       total, (outA, outB))
    return outA, outB, total


_FULL_SHELL = np.stack(
    np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"), axis=-1
).reshape(-1, 3).astype(np.int32)  # the 27 neighbour offsets


def compact_member(member, lcap, *arrays):
    """Stable-compact the `member` rows of `arrays` into `lcap`-row heads
    (members keep ascending index order, so idA < idB survives the
    compaction). Returns (compacted arrays, orig_id i32[lcap] (S on dead
    rows), live bool[lcap], n_member, overflow: more members than
    lcap)."""
    S = member.shape[0]
    dev = member.device
    order = torch.sort(torch.where(member, 0, 1).to(I), stable=True).indices
    sel = order[:lcap]
    n_mem = member.to(I).sum()
    live = torch.arange(sel.shape[0], dtype=I, device=dev) < n_mem
    outs = tuple(a[sel] for a in arrays)
    orig = torch.where(live, sel.to(I), S)
    return outs, orig, live, n_mem, n_mem > lcap


def build_cross_entries(pos_l, footprint, live_l, bin_size, nb):
    """Multi-bin entries of the (compacted) large class: each sphere
    enters every coarse bin whose cell lies within `footprint` (its reach
    plus the small class's largest) of its centre, so a small-large pair
    is found by scanning the small sphere's own bin only. The caller keeps
    footprint <= bin_size, so the 27-bin full shell covers it. Edge bins
    reach to infinity outward (positions outside the domain clip into
    them).

    Returns (entry_bins i32[L*27] sorted, entry_lidx i32[L*27] compacted
    index per entry (entries of one bin in index order), occ_x i32[] most
    entries in one bin)."""
    dev = pos_l.device
    c3 = bin_index_3d(pos_l, bin_size, nb)
    offs = torch.as_tensor(_FULL_SHELL, device=dev)
    tgt3 = c3[:, None, :] + offs[None, :, :]                  # (L,27,3)
    ok = torch.all((tgt3 >= 0) & (tgt3 < nb), dim=-1) & live_l[:, None]
    tf = tgt3.to(F)
    lo = torch.where(tgt3 == 0, -torch.inf, tf * bin_size)
    hi = torch.where(tgt3 == nb - 1, torch.inf, (tf + 1.0) * bin_size)
    d = pos_l[:, None, :] - torch.clamp(pos_l[:, None, :], lo, hi)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    ok &= d2 + d[..., 2] * d[..., 2] <= (footprint * footprint)[:, None]
    binid = torch.where(ok, flat_bin(tgt3, nb), SENTINEL_BIN).reshape(-1)
    sb, srt = torch.sort(binid, stable=True)
    return sb, (srt // 27).to(I), max_run(sb)


def find_pairs_cross_fine(pos, reach, owner, family, row_member, rec_l,
                          entry_bins, entry_lidx, family_mask, bin_size,
                          nb, cap, mpb_x, base=None, outs=None,
                          chunk=65536):
    """Small-large pairs through the entry table: each `row_member`
    (small) sphere scans the first `mpb_x` entries of its own coarse bin
    (rec_l: the compacted large class, [pos3, reach, owner, family,
    original id]). The classes are disjoint, so every pair is visited
    once. Appends into (`outs`, `base`) in sphere, entry order; returns
    (idA, idB, count)."""
    S = pos.shape[0]
    dev = pos.device
    E = entry_bins.shape[0]
    if outs is None:
        outs = (torch.full((cap,), -1, dtype=I, device=dev),
                torch.full((cap,), -1, dtype=I, device=dev))
    total = (base if base is not None
             else torch.zeros((), dtype=I, device=dev))
    fam_mask_flat = family_mask.reshape(-1)
    myb = flat_bin(bin_index_3d(pos, bin_size, nb), nb)
    myb = torch.where(row_member, myb, -2).contiguous()
    starts = torch.searchsorted(entry_bins, myb, out_int32=True)
    ends = torch.searchsorted(entry_bins, myb, right=True, out_int32=True)
    slot_iota = torch.arange(max(int(mpb_x), 1), dtype=I, device=dev)
    outA, outB = outs
    for k0 in range(0, S, chunk):
        k1 = min(k0 + chunk, S)
        slots = starts[k0:k1, None] + slot_iota               # (ch,mpb)
        valid = (slots < ends[k0:k1, None]) & (slots < E)
        valid &= row_member[k0:k1, None]
        lid = entry_lidx[torch.clamp(slots, max=max(E - 1, 0)).long()]
        crec = rec_l[lid.long()]
        d = pos[k0:k1, None, :] - crec[..., 0:3]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        rr = reach[k0:k1, None] + crec[..., 3]
        hit = valid & (d2 < rr * rr) & (rr > 0.0)
        hit &= crec[..., 4].to(I) != owner[k0:k1, None]
        hit &= fam_mask_flat[(family[k0:k1, None] * 256
                              + crec[..., 5].to(I)).long()]
        a = torch.arange(k0, k1, dtype=I, device=dev)[:, None].expand(
            hit.shape)
        cid = crec[..., 6].to(I)
        lo = torch.minimum(a, cid).reshape(-1)
        hi = torch.maximum(a, cid).reshape(-1)
        (outA, outB), total = _compact(hit.reshape(-1), (lo, hi), cap,
                                       total, (outA, outB))
    return outA, outB, total


def find_pairs_st(aabb_min, aabb_max, tri_owner, tri_family,
                  tab: SphereBinTable, family_mask, bin_size, nb, cap,
                  max_span, max_per_bin, bin_lo, bin_hi, nodes, tri_margin):
    """Sphere-triangle pairs (idA sphere, idB triangle), two stages over
    the SS sphere table.

    Stage 1 enumerates the bins of each triangle's box [bin_lo, bin_hi]
    (its margined AABB grown by the largest sphere reach), up to
    `max_span` per axis, and keeps a bin only where its centre lies
    within half a bin diagonal + half a bin + the triangle's margin of
    the triangle's plane: a large slanted facet crosses O(span^2) of its
    O(span^3) bins. Stage 2 scans `max_per_bin` slots of each kept bin
    and keeps a sphere whose centre is within its reach of the AABB and
    within reach + margin of the triangle itself (the exact
    point-triangle distance). Returns (idA, idB, count, span_overflow):
    a box wider than `max_span` bins, or more (triangle, bin) pairs than
    the stage-1 capacity, sets span_overflow."""
    from . import narrowphase

    T = aabb_min.shape[0]
    dev = aabb_min.device
    fam_mask_flat = family_mask.reshape(-1)
    spad = tab.n_rows
    sp = int(max_span)
    mpb = max(int(max_per_bin), 1)

    lo3 = bin_index_3d(bin_lo, bin_size, nb)
    hi3 = bin_index_3d(bin_hi, bin_size, nb)
    span3 = hi3 - lo3 + 1
    span_overflow = torch.any(span3 > sp)
    span3 = torch.clamp(span3, max=sp)
    g = np.stack(np.meshgrid(np.arange(sp), np.arange(sp), np.arange(sp),
                             indexing="ij"), axis=-1).reshape(-1, 3)[:, ::-1]
    g = torch.as_tensor(np.ascontiguousarray(g), dtype=I, device=dev)

    # stage 1: the bins near each triangle's plane
    tgt3 = lo3[:, None, :] + g[None, :, :]                     # (T,sp3,3)
    okk = torch.all(g[None] < span3[:, None, :], dim=-1) & torch.all(
        tgt3 < nb, dim=-1)
    nrm = torch.linalg.cross(nodes[:, 1] - nodes[:, 0],
                             nodes[:, 2] - nodes[:, 0])
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1,
                                                     keepdim=True),
                            min=1e-30)
    ctr = (tgt3.to(F) + 0.5) * bin_size
    pd = torch.abs(torch.sum(ctr * nrm[:, None, :], dim=-1)
                   - torch.sum(nodes[:, 0] * nrm, dim=-1)[:, None])
    # any sphere's reach is at most half a bin (build_grid); half the
    # diagonal covers its centre's offset inside the bin
    thr = (0.5 * np.sqrt(3.0) + 0.5) * bin_size + tri_margin[:, None]
    okk &= pd <= thr
    tb_cap = int(min(max(T, 1) * sp ** 3, max(4096, 6 * max(T, 1) * sp * sp)))
    tgt_all = torch.where(okk, flat_bin(tgt3, nb), -2).reshape(-1)
    tri_all = torch.arange(T, dtype=I, device=dev)[:, None].expand(
        okk.shape).reshape(-1)
    zero = torch.zeros((), dtype=I, device=dev)
    (tb_bin, tb_tri), tb_total = _compact(
        okk.reshape(-1), (tgt_all, tri_all), tb_cap, zero,
        (torch.full((tb_cap,), -2, dtype=I, device=dev),
         torch.zeros((tb_cap,), dtype=I, device=dev)))
    span_overflow |= tb_total > tb_cap

    # stage 2: the slots of the kept bins
    tb_bin = tb_bin.contiguous()
    starts = torch.searchsorted(tab.sorted_bin, tb_bin, out_int32=True)
    ends = torch.searchsorted(tab.sorted_bin, tb_bin, right=True,
                              out_int32=True)
    slots = starts[:, None] + torch.arange(mpb, dtype=I, device=dev)
    valid = (slots < ends[:, None]) & (slots < spad)
    crec = tab.rec[torch.clamp(slots, max=spad - 1).long()]
    cpos = crec[..., 0:3]
    cre = crec[..., 3]
    cid = crec[..., 6].to(I)
    tt = tb_tri.long()
    clamped = torch.minimum(torch.maximum(cpos, aabb_min[tt][:, None, :]),
                            aabb_max[tt][:, None, :])
    d = cpos - clamped
    hit = valid & (torch.sum(d * d, dim=-1) < cre * cre)
    tn = nodes[tt]
    closest = narrowphase.closest_point_triangle(
        cpos, tn[:, None, 0], tn[:, None, 1], tn[:, None, 2])
    dt = cpos - closest
    rr = cre + tri_margin[tt][:, None]
    hit &= torch.sum(dt * dt, dim=-1) < rr * rr
    hit &= crec[..., 4].to(I) != tri_owner[tt][:, None]
    hit &= fam_mask_flat[(crec[..., 5].to(I) * 256
                          + tri_family[tt][:, None]).long()]

    tri_ids = tb_tri[:, None].expand(hit.shape).reshape(-1)
    outs = (torch.full((cap,), -1, dtype=I, device=dev),
            torch.full((cap,), -1, dtype=I, device=dev))
    (outA, outB), total = _compact(hit.reshape(-1),
                                   (cid.reshape(-1), tri_ids), cap, zero,
                                   outs)
    return outA, outB, total, span_overflow


def find_pairs_sa(overlap_margined, sph_owner, sph_family, anal_owner,
                  anal_family, family_mask, cap):
    """Sphere–analytical pairs from the (S, A) margined-overlap matrix,
    compacted in row-major order."""
    S, A = overlap_margined.shape
    dev = overlap_margined.device
    hit = overlap_margined > 0.0
    hit &= sph_owner[:, None] != anal_owner[None, :]
    hit &= family_mask[sph_family.long()[:, None],
                       anal_family.long()[None, :]]
    sph_ids = torch.arange(S, dtype=I, device=dev)[:, None].expand(S, A)
    anal_ids = torch.arange(A, dtype=I, device=dev)[None, :].expand(S, A)
    outs = (torch.full((cap,), -1, dtype=I, device=dev),
            torch.full((cap,), -1, dtype=I, device=dev))
    (outA, outB), total = _compact(
        hit.reshape(-1), (sph_ids.reshape(-1), anal_ids.reshape(-1)),
        cap, torch.zeros((), dtype=I, device=dev), outs)
    return outA, outB, total
