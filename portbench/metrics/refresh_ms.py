"""Engine loop: milliseconds of one refresh by the engine's CUDA-event
spans (Engine.timers) over the window."""


def read(rec):
    t = rec["window"]["timers"]
    return t["refresh_s"] / t["refresh_n"] * 1e3 if t["refresh_n"] else None
