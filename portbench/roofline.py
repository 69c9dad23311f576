"""Peaks of the card and the least time of a kernel's work.

The bytes and operations of kernels A (``csrc/segred.cu``) and B
(``csrc/fused_force.cu``) are counted from the live rows and the owners
they need, each input byte read once and each output byte written once,
so a change of capacity alone moves no roofline.
"""

from __future__ import annotations

#: published peaks (NVIDIA's data sheet, SXM part at its 700 W limit):
#: HBM bytes/s and float32 operations/s outside the tensor cores
PEAKS = {"NVIDIA H100 80GB HBM3": dict(hbm=3.35e12, f32=67e12)}
DEFAULT = "NVIDIA H100 80GB HBM3"

#: float32 operations of one contact of kernel B (narrow phase, Hertz
#: normal force and damping, tangential history with the Coulomb clamp,
#: rolling resistance, two body-frame torques): counted from
#: ``reference/contact.py``'s formulas, square roots and divisions as one
B_FLOPS_PER_ROW = 250


def peaks(kind: str) -> dict:
    return PEAKS.get(kind, PEAKS[DEFAULT])


def least_s(bytes_moved: float, flops: float, kind: str) -> float:
    """The least time: the larger of bytes over the memory rate and
    operations over the f32 rate."""
    p = peaks(kind)
    return max(bytes_moved / p["hbm"], flops / p["f32"])


def bytes_B(live_rows: int, owners_touched: int, history: bool = True):
    """(bytes, operations) of one kernel B launch: each live row reads
    its 16-float static record, its 4 history floats and own_b, and
    writes the A and B wrench rows (6 floats each) and the new history;
    each owner it touches reads its 16-float kinematic record once."""
    wc = 16 if history else 0
    per_row = 64 + wc + 4 + 24 + 24 + wc
    return live_rows * per_row + owners_touched * 64, \
        live_rows * B_FLOPS_PER_ROW


def bytes_A(live_rows: int, n_owners: int, accumulate: bool):
    """(bytes, operations) of one kernel A launch (a table's pair of
    segment sums): each live row's A-side and B-side 6-float records with
    own_a, own_b_sorted and perm_b; the (N, 6) sums written, and read
    first where they add onto an accumulator."""
    out = n_owners * 24 * (2 if accumulate else 1)
    return live_rows * (24 + 4 + 24 + 4 + 4) + out, live_rows * 12
