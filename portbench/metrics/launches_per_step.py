"""Step: kernels and memsets launched a step over the profiled steps."""

from portbench import trace


def read(rec):
    p = rec.get("step_profile")
    if not p or not p["events"]:
        return None
    n = sum(1 for name, _, _ in p["events"] if not trace.is_copy(name))
    return n / p["steps"]
