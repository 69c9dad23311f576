"""Engine loop: the host's round trips to the card a step: every
sync_<site>_n of Engine.timers (overflow and count reads, shrink checks,
pageable parameter tensors, the step size, the frame's sync, the fold,
the lost-contact read) summed over the window, over its steps."""


def read(rec):
    t = rec["window"]["timers"]
    n = [v for k, v in t.items() if k.startswith("sync_") and k.endswith("_n")]
    if not n or not t["steps_n"]:
        return None
    return sum(n) / t["steps_n"]
