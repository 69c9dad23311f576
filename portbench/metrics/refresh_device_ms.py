"""Refresh: device milliseconds (the union of its operations' intervals)
of one refresh_contacts on the window's final state."""

from portbench import trace


def read(rec):
    p = rec.get("refresh_profile")
    if not p or not p["events"]:
        return None
    return trace.busy_us(p["events"]) * 1e-3
