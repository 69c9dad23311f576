"""Engine loop: milliseconds of one step by the engine's CUDA-event
spans of each chunk's K-step window (Engine.timers) over the window."""


def read(rec):
    t = rec["window"]["timers"]
    return t["steps_s"] / t["steps_n"] * 1e3 if t["steps_n"] else None
