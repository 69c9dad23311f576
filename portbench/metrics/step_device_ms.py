"""Step: device milliseconds a step (the union of the operations'
intervals) over K profiled steps after the window's final refresh."""

from portbench import trace


def read(rec):
    p = rec.get("step_profile")
    if not p or not p["events"]:
        return None
    return trace.busy_us(p["events"]) * 1e-3 / p["steps"]
