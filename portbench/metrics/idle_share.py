"""Device: the share of a frame's wall time in which no operation ran on
the card: one minus the union of the operations' intervals in the
profiled frame after the window, over the mean wall of the window's own
frames (run without the profiler, which lengthens a frame's wall)."""

from portbench import trace


def read(rec):
    p, w = rec.get("frame_profile"), rec["window"]
    if not p or not p["events"] or w["frames"] == 0:
        return None
    frame_s = w["wall_s"] / w["frames"]
    return 100.0 * (1.0 - trace.busy_us(p["events"]) * 1e-6 / frame_s)
