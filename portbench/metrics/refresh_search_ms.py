"""Refresh: milliseconds of the search stage (kernel C and its compaction,
the cross search) a refresh, by the engine's CUDA-event marks of every
refresh attempt (Engine.timers' refresh_search_s) over the window's
timed refreshes."""

from portbench import spans


def read(rec):
    return spans.per_refresh_ms(rec, "refresh_search_s")
