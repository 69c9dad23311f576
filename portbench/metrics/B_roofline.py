"""Kernels: kernel B's least time (roofline.bytes_B on the live rows and
the owners they touch, on the traced frame's last tables) over its mean
device time a launch, in the profiled frame after the window."""

from portbench import roofline

NAME = "fused_hertz"


def read(rec):
    p = rec.get("frame_profile")
    if not p or "B" not in p["bytes"]:
        return None
    ev = [(s, e) for n, s, e in p["events"] if NAME in n]
    if not ev:
        return None
    dev_s = sum(e - s for s, e in ev) / len(ev) * 1e-6
    return 100.0 * roofline.least_s(*p["bytes"]["B"], rec["kind"]) / dev_s
