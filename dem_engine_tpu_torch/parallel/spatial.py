"""Spatially decomposed sphere-sphere pair search over a mesh.

The domain is cut into D x-slabs, one per rank. Each rank:

  1. **buckets** its index shard of the spheres by destination slab, a
     sphere going to every slab whose interval, widened by a halo of 2
     bin widths, holds it (its x clipped into the domain first, so a
     sphere that escaped the domain stays resident on an edge slab, as
     the global search clips it into an edge bin), `capx` rows a bucket,
     and sends bucket t to rank t in one ``all_to_all``;
  2. **searches** what it received, its residents and their halo, with
     kernel C (``ops.sweep.find_pairs_ss``; its plain version on the CPU)
     on the GLOBAL bin grid, so bins and pair semantics are the global
     search's;
  3. **keeps** a pair only where its row sphere is resident: the sphere
     from whose bin the other's bin is a forward half-shell offset, in a
     shared bin the one with the lower global id. In flat-bin order the
     forward half shell is every offset that raises the flat bin id, so
     the row sphere is the smaller of the two by (flat bin, global id).
     A pair's two spheres lie within one bin of each other on every
     axis, so each is in the halo of the other's slab: every rank that
     holds one as resident receives the other, and the pair is kept
     exactly once.

Kernel C returns pairs in the ids of the table it searched, here rows of
the receive buffer: they are mapped to global ids through the buffer's
id column before anything else reads them. The search has no window, so
this path raises no OVF_BIN_OCC (``ops.sweep``).

Kernel C's table holds every pair among the received rows, halo pairs
too, so it is sized from what a rank receives, not from what it keeps:
the SS capacity's pairs per sphere times the D * capx received rows
(``received_cap``). A thin slab receives a halo several times its own
width; its rows and this table then grow together, through the bucket
flag: an overflow of either raises OVF_SPATIAL_BUCKET, never
OVF_SS_CAP, which stays the flag of the pairs a rank keeps.
"""

from __future__ import annotations

import torch

from ..defines import F, I
from ..ops import binning, sweep

_INVALID_REACH = -1e30
ROW_W = 8  # [pos3, reach, owner, family, gid, 0]; ints as their f32 bits


def _words(x):
    return x.to(I).contiguous().view(F)[:, None]


def slab_of(px, slab_w, n_dev: int):
    return torch.clamp(torch.floor(px / slab_w).to(I), 0, n_dev - 1)


def bucket_rows(pos, reach, owner, family, gid, bin_size, domain,
                n_dev: int, capx: int):
    """The (D, capx, 8) send buffer of one rank's spheres, bucket t for
    slab t, unused rows with reach -1e30; and whether a bucket held more
    than `capx` spheres (those past it are dropped)."""
    dev = pos.device
    slab_w = domain[0] / n_dev
    hw = 2.0 * bin_size  # a candidate's bin is within one of its row's
    px = torch.minimum(torch.clamp(pos[:, 0], min=0.0), domain[0])
    rows = torch.cat([pos, reach[:, None], _words(owner), _words(family),
                      _words(gid), torch.zeros_like(reach)[:, None]], dim=1)
    # [0, 0, 0, -1e30, owner -1, family 0, gid -1, 0], filled on the
    # device: a host list would be a copy the host waits for
    invalid = torch.zeros(ROW_W, dtype=F, device=dev)
    invalid[3] = _INVALID_REACH
    invalid.view(I)[4] = -1
    invalid.view(I)[6] = -1
    send = invalid.expand(n_dev, capx + 1, ROW_W).clone()
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for t in range(n_dev):
        m = (px >= t * slab_w - hw) & (px < (t + 1) * slab_w + hw)
        csum = torch.cumsum(m.to(I), 0, dtype=I)
        dst = torch.where(m & (csum <= capx), csum - 1, capx).long()
        send[t][dst] = rows
        if m.numel():
            ovf |= csum[-1] > capx
    return send[:, :capx], ovf


def exchange(pos, reach, owner, family, bin_size, domain, mesh,
             capx: int):
    """Step 1 of the search: this rank's index shard of the spheres
    bucketed by slab and exchanged. Returns (rec, resident, bucket_ovf):
    the (D capx, 8) rows received, block s from rank s; which of them are
    resident in this rank's slab; and whether this rank's buckets
    overflowed."""
    d = mesh.size
    s_loc = pos.shape[0]
    gid = mesh.rank * s_loc + torch.arange(s_loc, dtype=I, device=pos.device)
    send, bucket_ovf = bucket_rows(pos, reach, owner, family, gid, bin_size,
                                   domain, d, capx)
    rec = mesh.all_to_all(send).reshape(d * capx, ROW_W)
    valid = rec[:, 3] > _INVALID_REACH * 0.5
    resident = valid & (slab_of(rec[:, 0], domain[0] / d, d) == mesh.rank)
    return rec, resident, bucket_ovf


def received_cap(cap: int, n_spheres: int, n_rows: int) -> int:
    """Rows of kernel C's table over `n_rows` received rows: the pairs per
    sphere that the SS capacity `cap` allows for `n_spheres` spheres."""
    return max(64, -(-cap * n_rows // max(n_spheres, 1)))


def unpack(rec):
    """(pos, reach, owner, family, gid, valid) of received rows."""
    ints = rec[:, 4:7].contiguous().view(I)
    reach = rec[:, 3].contiguous()
    return (rec[:, 0:3].contiguous(), reach, ints[:, 0], ints[:, 1],
            ints[:, 2], reach > _INVALID_REACH * 0.5)


def search_received(rec, family_mask, bin_size, nb, c_cap: int,
                    mark=None):
    """Kernel C (its plain version on the CPU) over the received rows on
    the global grid, the unused rows left out as non-members; `mark` as
    ``sweep.find_pairs_ss`` takes it. Returns (idA, idB, count, sorted
    table) in receive-buffer rows."""
    pos, reach, owner, family, _, valid = unpack(rec)
    return sweep.find_pairs_ss(
        pos, reach, owner, torch.where(valid, family, 0), family_mask,
        bin_size, nb, c_cap, member=valid, mark=mark)


def keep_resident(rec, resident, a, b, bin_size, nb, cap_loc: int):
    """The pairs (a, b) of receive-buffer rows that this rank keeps, those
    whose row sphere is resident, in global ids (lo < hi) compacted to
    the front of `cap_loc` rows. Returns (idA, idB, kept), `kept`
    counting every kept pair."""
    pos, _, _, _, gid, _ = unpack(rec)
    live = a >= 0
    ia = torch.clamp(a, min=0).long()
    ib = torch.clamp(b, min=0).long()
    fbin = binning.flat_bin(binning.bin_index_3d(pos, bin_size, nb), nb)
    ga, gb = gid[ia], gid[ib]
    fa, fb = fbin[ia], fbin[ib]
    a_row = (fa < fb) | ((fa == fb) & (ga < gb))
    keep = live & resident[torch.where(a_row, ia, ib)]
    dev = rec.device
    (idA, idB), kept = binning._compact(
        keep, (torch.minimum(ga, gb), torch.maximum(ga, gb)), cap_loc,
        torch.zeros((), dtype=I, device=dev),
        (torch.full((cap_loc,), -1, dtype=I, device=dev),
         torch.full((cap_loc,), -1, dtype=I, device=dev)))
    return idA, idB, kept


def find_pairs_ss_spatial(pos, reach, owner, family, family_mask, bin_size,
                          nb, domain, cap: int, mesh, capx: int,
                          keep_cap: int | None = None, mark=None):
    """The SS pairs of the spheres whose index shard each rank passes
    (pos, reach, owner, family: this rank's rows of the global arrays,
    world axes), searched by slab over `mesh`.

    Returns (idA, idB, count, max_occ, bucket_ovf): idA/idB (keep_cap,)
    this rank's pairs in global sphere ids, compacted to the front
    (keep_cap None: cap / D rows); the count summed over the ranks, or
    cap + 1 where a rank kept more than its rows (the caller's OVF_SS_CAP
    growth then takes it); the largest bin occupancy; and whether any
    rank's buckets or kernel C's table over its received rows overflowed
    (the caller grows capx). `mark`, if given, is called with "table"
    after the received rows' sorted table."""
    d = mesh.size
    if cap % d:
        raise ValueError(f"cap {cap} does not divide by {d} ranks")
    cap_loc = cap // d if keep_cap is None else keep_cap
    rec, resident, bucket_ovf = exchange(pos, reach, owner, family,
                                         bin_size, domain, mesh, capx)
    c_cap = received_cap(cap, pos.shape[0] * d, rec.shape[0])
    a, b, n_c, tab = search_received(rec, family_mask, bin_size, nb, c_cap,
                                     mark)
    idA, idB, kept = keep_resident(rec, resident, a, b, bin_size, nb,
                                   cap_loc)
    flags = mesh.all_max(torch.stack([
        (kept > cap_loc).to(I), (bucket_ovf | (n_c > c_cap)).to(I),
        tab.max_occ.to(I)]))
    count = mesh.all_sum(kept.to(I))
    # a rank's dropped pairs surface through the SS capacity growth
    count = torch.where(flags[0] > 0, cap + 1, count).to(I)
    return idA, idB, count, flags[2], flags[1] > 0
