"""Refresh: milliseconds of the bin stage (margins, grid, the sorted sphere
table or the two-class member tables) a refresh, by the engine's CUDA-
event marks of every refresh attempt (Engine.timers' refresh_bin_s) over
the window's timed refreshes."""

from portbench import spans


def read(rec):
    return spans.per_refresh_ms(rec, "refresh_bin_s")
