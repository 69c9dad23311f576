"""Owner-segment wrench sums (kernels A and D).

``seg_sum_pair`` sums the wrench rows of one contact table into
(n_owners, 6) owner rows, both sides at once: the A rows under ``own_a``
and the B rows, read through ``perm_b``, under ``own_b_sorted``. With
`out` it adds onto that tensor in place and zeroes nothing, so the
tables of one step share one accumulator. ``seg_sum_sorted`` is the
one-side form. Rows come grouped by owner (equal ids contiguous); ids
outside [0, n_owners) are dead rows, add nothing, and trail the live
rows (the kernel stops at them). With `perm`, row j of the grouped
order reads ``rec6[perm[j]]``, so the B-side records are never permuted
in memory.

On CUDA tensors both launch ``csrc/segred.cu`` once; on CPU tensors they
run ``seg_sum_plain``, the ``index_add_`` version.

``seg_sum_sorted_v1`` is the JAX package's first form (kernel D,
``csrc/segred_v1.cu``, one launch): each TILE-row tile sums into an
OWIN-owner window and raises a spill flag where a tile spans more owners
than the window holds; the sums are then incomplete and the caller must
fall back. No caller in the package uses it.
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


def _side(rec6, ids, perm, name):
    """(rec, ids, perm or None, cap) pointers of one validated side."""
    cap = rec6.shape[0]
    _build.require(rec6, F, (cap, 6), f"rec_{name}")
    _build.require(ids, I, (cap,), f"ids_{name}")
    if perm is not None:
        _build.require(perm, I, (cap,), f"perm_{name}")
    if rec6.data_ptr() % 8:
        raise ValueError(f"rec_{name} must be 8-byte aligned")
    return (rec6.data_ptr(), ids.data_ptr(),
            perm.data_ptr() if perm is not None else None, cap)


_NO_SIDE = (None, None, None, 0)


def _launch(side_a, side_b, n_owners, out, like):
    """One launch of kernel A over two sides, into a new zeroed output
    or onto `out`."""
    zero = out is None
    if zero:
        out = torch.empty((n_owners, 6), dtype=F, device=like.device)
    else:
        _build.require(out, F, (n_owners, 6), "out")
    if out.data_ptr() % 8:
        raise ValueError("out must be 8-byte aligned")
    seg_sum_pair.launches += 1
    _build.check(_build.lib().dem_seg_sum_pair(
        *side_a, *side_b, n_owners, out.data_ptr(), int(zero),
        _build.stream_of(like)), "dem_seg_sum_pair")
    return out


def seg_sum_pair(rec_a, own_a, rec_b, own_b_sorted, perm_b, n_owners,
                 out=None):
    """Both sides of one table: (n_owners, 6) sums of rec_a under own_a
    plus rec_b[perm_b] under own_b_sorted. With `out` (n_owners, 6) the
    sums are added onto it in place and it is returned."""
    if not rec_a.is_cuda:
        acc = (seg_sum_plain(rec_a, own_a, n_owners)
               + seg_sum_plain(rec_b, own_b_sorted, n_owners, perm_b))
        return acc if out is None else out.add_(acc)
    return _launch(_side(rec_a, own_a, None, "a"),
                   _side(rec_b, own_b_sorted, perm_b, "b"), n_owners, out,
                   rec_a)


#: launches of kernel A, by either wrapper
seg_sum_pair.launches = 0


def seg_sum_sorted(rec6, ids, n_owners, perm=None):
    if not rec6.is_cuda:
        return seg_sum_plain(rec6, ids, n_owners, perm)
    return _launch(_side(rec6, ids, perm, "a"), _NO_SIDE, n_owners, None,
                   rec6)


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
    if rec6.data_ptr() % 8:
        raise ValueError("rec6 must be 8-byte aligned")
    out = torch.empty((n_owners, 6), dtype=F, device=rec6.device)
    # the kernel writes the flag byte itself, 0 or 1: no launch reads it
    spill = torch.empty((), dtype=torch.bool, device=rec6.device)
    seg_sum_sorted_v1.launches += 1
    _build.check(_build.lib().dem_seg_sum_v1(
        rec6.data_ptr(), ids.data_ptr(), cap, n_owners, tile, owin,
        out.data_ptr(), spill.data_ptr(), _build.stream_of(rec6)),
        "dem_seg_sum_v1")
    return out, spill


seg_sum_sorted_v1.launches = 0
