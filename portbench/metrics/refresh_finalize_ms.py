"""Refresh: milliseconds of the finalize stage (the SS table's finalize) a
refresh, by the engine's CUDA-event marks of every refresh attempt
(Engine.timers' refresh_finalize_s) over the window's timed refreshes."""

from portbench import spans


def read(rec):
    return spans.per_refresh_ms(rec, "refresh_finalize_s")
