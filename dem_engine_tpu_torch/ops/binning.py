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


def build_sphere_table(pos, reach, owner, family, bin_size, nb, pad_to):
    S = pos.shape[0]
    dev = pos.device
    idx3 = bin_index_3d(pos, bin_size, nb)
    binid = flat_bin(idx3, nb)
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
    ok = order < S
    src = torch.clamp(order, max=max(S - 1, 0)).long()
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

    k = torch.arange(pad_to, dtype=I, device=dev)
    boundary = torch.ones(pad_to, dtype=torch.bool, device=dev)
    boundary[1:] = sorted_bin[1:] != sorted_bin[:-1]
    run_start = torch.cummax(torch.where(boundary, k, 0), 0).values
    occ = torch.where(sorted_bin != SENTINEL_BIN, k - run_start + 1, 0)
    max_occ = occ.max() if pad_to > 0 else torch.zeros((), dtype=I,
                                                        device=dev)
    return SphereBinTable(sorted_bin, rec, order, sidx3, max_occ.to(I))


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
