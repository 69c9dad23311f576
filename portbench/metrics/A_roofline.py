"""Kernels: kernel A's least time a step (roofline.bytes_A of each
table's sums, on the traced frame's last tables) over its device time a
step, in the profiled frame after the window."""

from portbench import roofline

NAME = "seg_sum_pair"


def read(rec):
    p = rec.get("frame_profile")
    if not p or "A" not in p["bytes"]:
        return None
    dev_s = sum(e - s for n, s, e in p["events"] if NAME in n) * 1e-6
    if dev_s <= 0:
        return None
    least = sum(roofline.least_s(b, f, rec["kind"])
                for b, f in p["bytes"]["A"])
    return 100.0 * least / (dev_s / p["steps"])
