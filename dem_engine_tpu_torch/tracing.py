"""The program's timing: marks on the card, the refresh's stages, the host
round trips by site, and the host span ring.

Marks. ``time_mark`` records a CUDA event on the card (the host clock on
the CPU) and ``mark_seconds`` reads the seconds between two complete
marks. ``Engine`` marks each chunk's refresh and its K steps and folds
the marks into ``Engine.timers`` once they are complete
(``Engine.read_timers``).

Stages. ``Marker`` is the `mark` callable that ``solver.refresh_contacts``
(and ``dynamics_step``) call with a name at each stage boundary. Every
refresh path calls "table", "pairs", "history" and "finalize" at its
matching point, and ``Engine.refresh`` adds "start" before an attempt and
"end" after it, before its overflow read. The intervals between them are
the stages of ``REFRESH_STAGES``: `bin` (margins, grid, sorted sphere
table, or the two-class member tables), `search` (kernel C, its
compaction, the cross search), `carry` (the SS history carry), `finalize`
(the SS finalize) and `tables` (the ST and SA searches, carries,
finalizes and the guards). ``fold_stages`` adds a chunk's stages to
``timers["refresh_<stage>_s"]`` and the rest of its refresh span, from
each attempt's "end" to the next attempt's "start" or to the steps'
start, to ``timers["refresh_sync_s"]``: the overflow read, growths, the
fold, the count reads and the shrink check. The six sum to the chunk's
``refresh_s`` (the same events).

Round trips. ``waited(timers, site, n)`` wraps a place where the host
waits on the card: it adds `n` to ``timers["sync_<site>_n"]`` and the
host seconds it took to ``timers["sync_<site>_s"]``. The sites
(``SYNC_SITES``) are counted where the code would wait on a card, on the
CPU too:

  refresh   ``Engine.refresh``'s overflow read, each attempt
  count     ``Engine._count``, at a measured block's first chunk
  shrink    ``Engine.maybe_shrink``'s three count reads
  fold      ``Engine.read_timers``' wait on the last chunk's end mark
  params    ``Engine._chunk``'s two pageable tensors (max_drift,
            bin_factor): a copy from pageable memory synchronises
  h         ``Engine.advance``'s read of the step size
  tune      on a mesh with a tuner on, the broadcast of rank 0's move
  frame     ``DEMSolver.DoDynamics``' synchronize
  lost      ``DEMSolver.DoDynamics``' lost-contact read

Spans. Every span is also kept, with ``time.time_ns()`` stamps (the
clock torch.profiler's absolute event stamps follow, up to a drift of
up to 1.7 ms a second seen on an H100's host), in one ring of
``RING_SPANS`` spans for the process: it outlives the solver, and the
oldest spans fall out. A span is (name, depth, start_ns, end_ns), depth
0 outermost; a `frame`'s adds `profiled`, whether torch.profiler was on
at its start. The names are a closed set:

  frame             one ``DEMSolver.DoDynamics``
  frame.tail        its synchronize, timer fold and lost-contact read
  chunk.setup       a chunk's params (``sync.params`` inside)
  refresh           ``Engine.refresh``: its attempts, overflow reads and
                    growths
  refresh.<stage>   each stage of an attempt, inside `refresh`
  grow              ``Engine.grow_for`` after an overflow
  chunk.fold        a chunk's fold of the chunks before it
  shrink            ``Engine.maybe_shrink``
  steps             the K-step launch loop (``Engine.timed_steps``)
  sync.<site>       a round trip of ``SYNC_SITES``

``frames()`` returns the ring's frames, each with every span inside it:
one frame's host timeline, chunk by chunk. The ring and its depth are
the state of the process's one host thread, as torch's current stream
is.
"""

from __future__ import annotations

import collections
import time

import torch

#: the refresh's stages: (stage, the mark that opens it, the one that
#: closes it)
REFRESH_STAGES = (("bin", "start", "table"), ("search", "table", "pairs"),
                  ("carry", "pairs", "history"),
                  ("finalize", "history", "finalize"),
                  ("tables", "finalize", "end"))

SYNC_SITES = ("refresh", "count", "shrink", "fold", "params", "h", "tune",
              "frame", "lost")

#: spans the ring keeps: a K 5 frame of 100 steps records about 260
RING_SPANS = 4096

#: the host span of the stage each refresh mark closes
REFRESH_SPANS = {b: "refresh." + s for s, _, b in REFRESH_STAGES}
_STAGE_KEY = {b: f"refresh_{s}_s" for s, _, b in REFRESH_STAGES}

_ring = collections.deque(maxlen=RING_SPANS)
_depth = 0


def time_mark(device):
    """A timer mark: a recorded CUDA event on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def mark_seconds(a, b) -> float:
    """Seconds between two complete marks of ``time_mark``."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) * 1e-3


def zero_timers() -> dict:
    """``Engine.timers`` at zero, every key a scalar: the chunks' timed
    refreshes and steps, their refresh stages, growths, shrinks, shrink
    checks, retries, and each site's round trips and host seconds."""
    t = {"refresh_s": 0.0, "refresh_n": 0, "steps_s": 0.0, "steps_n": 0,
         "grows": 0, "shrinks": 0, "shrink_checks": 0, "retries": 0}
    for s, _, _ in REFRESH_STAGES:
        t[f"refresh_{s}_s"] = 0.0
    t["refresh_sync_s"] = 0.0
    for site in SYNC_SITES:
        t[f"sync_{site}_n"] = 0
        t[f"sync_{site}_s"] = 0.0
    return t


def fold_stages(timers, marks, s0):
    """Add a chunk's refresh to `timers` by stage: `marks` are its
    attempts' (name, mark) in order, from the first "start", and `s0`
    the steps' start mark. Each interval goes to the stage its closing
    mark closes; from an "end" to the next "start" or to `s0`, to
    refresh_sync_s."""
    prev = marks[0][1]
    for name, m in marks[1:]:
        timers[_STAGE_KEY.get(name, "refresh_sync_s")] += mark_seconds(
            prev, m)
        prev = m
    timers["refresh_sync_s"] += mark_seconds(prev, s0)


class Marker:
    """A `mark` callable: each call appends (name, ``time_mark``) to
    `marks` and, where `spans` maps the name, puts the host span it closes
    (from the previous call) in the ring, one level inside the span open
    at construction. Calls "start" when made."""

    __slots__ = ("marks", "device", "spans", "depth", "t")

    def __init__(self, device, marks, spans=None):
        self.marks, self.device, self.spans = marks, device, spans or {}
        self.depth = _depth
        self("start")

    def __call__(self, name):
        t = time.time_ns()
        self.marks.append((name, time_mark(self.device)))
        closes = self.spans.get(name)
        if closes is not None:
            _ring.append((closes, self.depth, self.t, t))
        self.t = t


class span:
    """``with span(name):`` puts (name, depth, start_ns, end_ns) in the
    ring when the block ends."""

    __slots__ = ("name", "depth", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _depth
        self.depth = _depth
        _depth += 1
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _depth
        _depth = self.depth
        _ring.append((self.name, self.depth, self.t0, time.time_ns()))
        return False


class frame(span):
    """The span of one DoDynamics, with `profiled`: whether
    torch.profiler was on at its start."""

    __slots__ = ("profiled",)

    def __init__(self):
        super().__init__("frame")

    def __enter__(self):
        self.profiled = torch._C._autograd._profiler_enabled()
        return super().__enter__()

    def __exit__(self, *exc):
        global _depth
        _depth = self.depth
        _ring.append((self.name, self.depth, self.t0, time.time_ns(),
                      self.profiled))
        return False


class waited(span):
    """``with waited(timers, site, n):`` around `n` host waits on the
    card: the span sync.<site>, and the round trips and their host
    seconds added to `timers`."""

    __slots__ = ("timers", "site", "n")

    def __init__(self, timers, site, n=1):
        super().__init__("sync." + site)
        self.timers, self.site, self.n = timers, site, n

    def __exit__(self, *exc):
        global _depth
        t1 = time.time_ns()
        _depth = self.depth
        _ring.append((self.name, self.depth, self.t0, t1))
        self.timers[f"sync_{self.site}_n"] += self.n
        self.timers[f"sync_{self.site}_s"] += (t1 - self.t0) * 1e-9
        return False


def frames() -> list:
    """The ring's frames, oldest first: dict(start_ns, end_ns, profiled,
    spans), `spans` every span recorded inside the frame as (name, depth,
    start_ns, end_ns), in start order; each chunk's spans are kept, none
    summed. Where the ring is full its oldest frame may have lost spans:
    it is left out."""
    out, inside = [], []
    for s in list(_ring):
        if s[0] != "frame":
            inside.append(s)
            continue
        out.append(dict(start_ns=s[2], end_ns=s[3], profiled=s[4],
                        spans=sorted((x for x in inside if x[2] >= s[2]),
                                     key=lambda x: (x[2], x[1]))))
        inside = []
    if len(_ring) == _ring.maxlen and out:
        out.pop(0)
    return out
