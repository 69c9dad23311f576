"""Refresh: milliseconds of the carry stage (the SS history carry) a
refresh, by the engine's CUDA-event marks of every refresh attempt
(Engine.timers' refresh_carry_s) over the window's timed refreshes."""

from portbench import spans


def read(rec):
    return spans.per_refresh_ms(rec, "refresh_carry_s")
