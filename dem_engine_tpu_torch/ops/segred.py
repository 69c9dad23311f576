"""Owner-segment wrench sums (kernels A and D).

``seg_sum_sorted`` sums (cap, 6) wrench rows into (n_owners, 6) owner
rows. Rows come grouped by owner (equal ids contiguous); ids outside
[0, n_owners) are dead rows and add nothing. With `perm`, row j of the
grouped order reads ``rec6[perm[j]]`` (the B side of a table, through
its ``perm_b``), so the B-side records are never permuted in memory.

On a CUDA tensor this launches ``csrc/segred.cu``; on a CPU tensor it
runs ``seg_sum_plain``, the ``index_add_`` version.

``seg_sum_sorted_v1`` is the JAX package's first form (kernel D,
``csrc/segred_v1.cu``): each TILE-row tile sums into an OWIN-owner
window and raises a spill flag where a tile spans more owners than the
window holds; the sums are then incomplete and the caller must fall
back. No caller in the package uses it.
"""

from __future__ import annotations

import torch

from .. import _build
from ..defines import F, I


def seg_sum_plain(rec6, ids, n_owners, perm=None):
    src = rec6 if perm is None else rec6[perm.long()]
    live = (ids >= 0) & (ids < n_owners)
    dest = torch.where(live, ids, n_owners).long()
    out = torch.zeros((n_owners + 1, 6), dtype=src.dtype, device=src.device)
    return out.index_add_(0, dest, src)[:n_owners]


def seg_sum_sorted(rec6, ids, n_owners, perm=None):
    if not rec6.is_cuda:
        return seg_sum_plain(rec6, ids, n_owners, perm)
    cap = rec6.shape[0]
    _build.require(rec6, F, (cap, 6), "rec6")
    _build.require(ids, I, (cap,), "ids")
    if perm is not None:
        _build.require(perm, I, (cap,), "perm")
    out = torch.empty((n_owners, 6), dtype=F, device=rec6.device)
    seg_sum_sorted.launches += 1
    _build.check(_build.lib().dem_seg_sum(
        rec6.data_ptr(), ids.data_ptr(),
        perm.data_ptr() if perm is not None else None,
        cap, n_owners, out.data_ptr(), _build.stream_of(rec6)),
        "dem_seg_sum")
    return out


seg_sum_sorted.launches = 0

TILE = 512  # rows per tile of seg_sum_sorted_v1
OWIN = 256  # owners per tile window


def seg_sum_v1_plain(rec6, ids, n_owners, tile=TILE, owin=OWIN):
    """index_add_ of the rows inside their tile's window, and the spill
    rule of the window, on tensors."""
    cap = ids.shape[0]
    pad = (-cap) % tile
    idp = torch.cat([ids, ids.new_full((pad,), n_owners)]).view(-1, tile)
    live = (idp >= 0) & (idp < n_owners)
    n_pad = ((n_owners + 1 + owin + 127) // 128) * 128
    b0 = torch.where(live, idp, n_owners).min(1, keepdim=True).values
    b0 = torch.clamp((b0 // 128) * 128, max=n_pad - owin)
    rel = idp - b0
    spill = (live & (rel >= owin)).any()
    ok = (live & (rel >= 0) & (rel < owin)).reshape(-1)[:cap]
    out = torch.zeros((n_owners + 1, 6), dtype=rec6.dtype,
                      device=rec6.device)
    out.index_add_(0, torch.where(ok, ids, n_owners).long(), rec6)
    return out[:n_owners], spill


def seg_sum_sorted_v1(rec6, ids, n_owners, tile=TILE, owin=OWIN):
    """Returns ((n_owners, 6) sums, spill bool[]). ids ascending, dead
    rows outside [0, n_owners)."""
    if not rec6.is_cuda:
        return seg_sum_v1_plain(rec6, ids, n_owners, tile, owin)
    cap = rec6.shape[0]
    _build.require(rec6, F, (cap, 6), "rec6")
    _build.require(ids, I, (cap,), "ids")
    out = torch.empty((n_owners, 6), dtype=F, device=rec6.device)
    spill = torch.empty((), dtype=I, device=rec6.device)
    seg_sum_sorted_v1.launches += 1
    _build.check(_build.lib().dem_seg_sum_v1(
        rec6.data_ptr(), ids.data_ptr(), cap, n_owners, tile, owin,
        out.data_ptr(), spill.data_ptr(), _build.stream_of(rec6)),
        "dem_seg_sum_v1")
    return out, spill != 0


seg_sum_sorted_v1.launches = 0
