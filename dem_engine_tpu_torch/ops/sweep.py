"""Sphere–sphere pair search (kernel C).

``find_pairs_ss`` returns the (idA < idB) pairs of spheres closer than
their summed reach, of different owners and of enabled family pairs,
compacted into a `cap`-row table, with the full count (which may exceed
`cap`; the caller raises OVF_SS_CAP), and the sorted table it searched
(the ST search reuses it). With `member` the search runs over that
subset of the spheres only (the two classes of the two-class CD): the
others sort into the table's sentinel tail and are neither rows nor
candidates.

The sorted sphere table (``binning.build_sphere_table``) is tensor code.
On CUDA tensors ``csrc/sweep.cu`` then searches it in one launch after
one memset, with no read-back: tiles of sorted spheres stage their
half-shell windows in shared memory, count, take their offsets by a
single-pass scan across tiles, and write: one design for search,
compaction and the count. On CPU tensors the plain slot sweep
``binning.sweep_table`` runs with a per-bin scan as wide as the fullest
bin, so neither path has a window that can overflow: OVF_BIN_OCC and
OVF_PALLAS_WIN are never raised.
Both emit pairs in the same order (sorted row, half-shell offset, slot).
"""

from __future__ import annotations

import torch

from .. import _build
from ..defines import F, I
from . import binning


def find_pairs_ss(pos, reach, owner, family, family_mask, bin_size, nb,
                  cap, member=None, mark=None):
    """Returns (idA, idB, count, table). `mark`, if given, is called with
    "table" between the sorted table and the search (the stage timers of
    ``profiling.profile_stages``)."""
    S = pos.shape[0]
    tab = binning.build_sphere_table(pos, reach, owner, family, bin_size,
                                     nb, max(S, 1), member=member)
    if mark is not None:
        mark("table")
    if not pos.is_cuda:
        pairs = binning.sweep_table(tab, S, family_mask, nb, cap,
                                    int(tab.max_occ))
    else:
        pairs = sweep_table_cuda(tab, S, family_mask, nb, cap)
    return (*pairs, tab)


def sweep_table_cuda(tab, n_spheres, family_mask, nb, cap):
    """Kernel C over a sorted table: one memset of its output buffer and
    one launch, nothing read back. Rows of the sentinel bin (padding, and
    the spheres a member table leaves out, which sort into its tail) are
    neither rows nor candidates. Returns (idA, idB, count), the count a
    device scalar."""
    spad = tab.n_rows
    dev = tab.rec.device
    _build.require(tab.rec, F, (spad, binning.REC_W), "rec")
    _build.require(tab.sorted_bin, I, (spad,), "sorted_bin")
    _build.require(tab.idx3, I, (spad, 3), "idx3")
    _build.require(family_mask, torch.bool, (256, 256), "family_mask")
    _build.require(nb, I, (3,), "nb")
    if tab.rec.data_ptr() % 16:
        raise ValueError("rec must be 16-byte aligned")
    lib = _build.lib()
    n_tiles = max(1, -(-spad // lib.dem_sweep_tile()))
    # pair columns, tile status words (two i32 each), ticket, count
    buf = torch.empty((2 * cap + 2 * n_tiles + 2,), dtype=I, device=dev)
    sweep_table_cuda.launches += 1
    _build.check(lib.dem_sweep(
        tab.rec.data_ptr(), tab.sorted_bin.data_ptr(), tab.idx3.data_ptr(),
        family_mask.data_ptr(), nb.data_ptr(), spad, n_spheres, cap,
        buf.data_ptr(), _build.stream_of(tab.rec)), "dem_sweep")
    return buf[:cap], buf[cap:2 * cap], buf[-1]


sweep_table_cuda.launches = 0
