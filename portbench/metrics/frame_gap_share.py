"""API layer: the share of the window's wall time outside the engine's
CUDA-event spans (each chunk's refresh and K-step window): the host time
of DoDynamics between them (the per-frame sync, the overflow reads, the
shrink checks, the lost-contact read)."""


def read(rec):
    w = rec["window"]
    t = w["timers"]
    if w["wall_s"] <= 0 or t["refresh_n"] == 0:
        return None
    return 100.0 * (1.0 - (t["refresh_s"] + t["steps_s"]) / w["wall_s"])
