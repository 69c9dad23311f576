"""Engine loop: milliseconds a refresh spends after its attempts' ends
(each overflow read, growths, the fold of the chunks before it, the
count reads and the shrink check), up to its steps' start mark, by the
engine's CUDA-event marks (Engine.timers' refresh_sync_s) over the
window's timed refreshes. With the five refresh stages it makes
refresh_ms."""

from portbench import spans


def read(rec):
    return spans.per_refresh_ms(rec, "refresh_sync_s")
