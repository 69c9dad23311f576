"""Refresh: milliseconds of the tables stage (the ST and SA searches,
carries and finalizes, the guards) a refresh, by the engine's CUDA-event
marks of every refresh attempt (Engine.timers' refresh_tables_s) over
the window's timed refreshes."""

from portbench import spans


def read(rec):
    return spans.per_refresh_ms(rec, "refresh_tables_s")
