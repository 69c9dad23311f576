"""The program's own timing, read by the per-layer metrics: its timers'
stage sums, and its host spans (``dem_engine_tpu_torch.tracing``) against
the profiled frame's device operations.

The spans carry ``time.time_ns()`` stamps; torch.profiler's absolute
event stamps follow that clock, but not closely enough for one offset:
on an H100's host they drifted against it by up to 1.7 ms a second
within one frame. The profile (``trace.read``) keeps each event's time
from the trace's start. So ``fit_offsets`` pairs the frame's host reads
of device values (``READS``) in order with the profile's device-to-host
copies, and each anchor (``ANCHORS``: a read that ends just after its
copy ends, the host waking 0–120 us later) gives the offset at its copy;
between anchors the offset is interpolated. With them, ``idle_by_span``
puts each idle stretch of the device inside the frame down to the
innermost host span open over it.

On a program without these timers or spans every reader returns None.
"""

from __future__ import annotations

import bisect

#: the spans that read device values, with the device-to-host copies each
#: issues (``Engine.maybe_shrink`` reads three counts)
READS = {"sync.h": 1, "sync.refresh": 1, "sync.count": 1, "sync.shrink": 3,
         "sync.tune": 1, "sync.lost": 1}
#: the reads whose span ends just after its last copy ends (the first read
#: of a frame pins host memory after its copy under the profiler)
ANCHORS = ("sync.refresh", "sync.count", "sync.shrink", "sync.lost")
#: how far the offset may move from one read to the next: the drift
#: between reads plus the host's wake-up after a copy
STEP_NS = 1_000_000
#: where the host was launching or awaiting work of the frame's own: the
#: other spans' idle is the loop's round trips and bookkeeping
WORK = ("steps", "refresh")


def per_refresh_ms(rec, key):
    """The window's timer `key` (seconds) per timed refresh, in ms."""
    t = rec["window"]["timers"]
    if key not in t or not t["refresh_n"]:
        return None
    return t[key] / t["refresh_n"] * 1e3


def program_frames():
    """``tracing.frames()`` of the program in this process, or None where
    it has no span ring."""
    try:
        from dem_engine_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.frames()


def _walk(reads, copies, j):
    """The reads paired in order with the copies from copy `j` on, each
    read with as many copies as it issues, as (host end, last copy end,
    is an anchor). Against the last anchor's offset, a pair whose copy
    ends more than STEP_NS too late is taken for a read whose copy the
    profile lost (the read is skipped), and an anchor's copy that ends
    more than STEP_NS too early for a copy besides the reads' (the copy is
    skipped); another read may wake long after its copy."""
    out, prev, i = [], None, 0
    while i < len(reads) and j + reads[i][1] <= len(copies):
        e, n, anchor = reads[i]
        off = e - copies[j + n - 1]
        if prev is not None and off < prev - STEP_NS:
            i += 1
        elif prev is not None and anchor and off > prev + STEP_NS:
            j += 1
        else:
            out.append((e, copies[j + n - 1], anchor))
            i, j = i + 1, j + n
            if anchor:
                prev = off
    return out


def fit_offsets(frame, events):
    """The offsets that put the profile's events (us from its start) on
    the frame's clock (ns from its start), [(event ns, offset ns)] at each
    anchor's last copy end, in order, or None. An anchor's offset is its
    span's end less its copy's end: the least of any offset there, off by
    the host's wake-up. The first read takes one of the first four copies,
    the one that pairs the most reads. None where fewer than three
    quarters of the anchors pair."""
    lo = frame["start_ns"]
    reads = [(e - lo, READS[n], n in ANCHORS) for n, _, _, e in
             sorted(frame["spans"], key=lambda x: x[2]) if n in READS]
    copies = sorted(e * 1e3 for n, _, e in events
                    if n.startswith("Memcpy DtoH"))
    best = max((_walk(reads, copies, j) for j in range(min(4, len(copies)))),
               key=len, default=[])
    pts = [(c, e - c) for e, c, anchor in best if anchor]
    n_anchors = sum(anchor for _, _, anchor in reads)
    if not n_anchors or 4 * len(pts) < 3 * n_anchors:
        return None
    return pts


def _offset(pts, t):
    """The offset at event time `t` (ns): linear between the anchors'
    points, the nearest one's outside them."""
    i = bisect.bisect_left(pts, (t,))
    if i == 0:
        return pts[0][1]
    if i == len(pts):
        return pts[-1][1]
    (t0, o0), (t1, o1) = pts[i - 1], pts[i]
    return o0 + (o1 - o0) * (t - t0) / (t1 - t0)


def _busy(events, pts, hi):
    """The union of the events' intervals on the frame's clock (each
    shifted by the offset at its start), within [0, hi]."""
    out = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        off = _offset(pts, s * 1e3)
        s, e = max(s * 1e3 + off, 0), min(e * 1e3 + off, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(frame):
    """The frame cut into stretches, each with the innermost span open
    over it: [(start, end, name)] in ns from the frame's start."""
    lo = frame["start_ns"]
    bounds = []
    for name, depth, s, e in [("frame", -1, lo, frame["end_ns"])] + \
            frame["spans"]:
        bounds.append((s - lo, 1, depth, name))
        bounds.append((e - lo, 0, -depth, name))
    bounds.sort()
    out, open_, t = [], [], None
    for at, starts, d, name in bounds:
        if open_ and at > t:
            out.append((t, at, max(open_)[1]))
        if starts:
            open_.append((d, name))
        else:
            open_.remove((-d, name))
        t = at
    return out


def idle_by_span(frame, events, pts):
    """{span name: idle ns} over the frame, its events put on its clock by
    the offsets `pts` (``fit_offsets``): each stretch in which no device
    operation ran, put down to the innermost span open over it (`frame`
    where none is), and the frame's whole idle under None."""
    hi = frame["end_ns"] - frame["start_ns"]
    gaps, t = [], 0
    for s, e in _busy(events, pts, hi):
        if s > t:
            gaps.append((t, s))
        t = e
    if t < hi:
        gaps.append((t, hi))
    out = {None: sum(e - s for s, e in gaps)}
    segs = _innermost(frame)
    i = 0
    for gs, ge in gaps:
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < ge:
            s, e, name = segs[j]
            out[name] = out.get(name, 0) + min(e, ge) - max(s, gs)
            j += 1
    return out


def profiled_frame(rec):
    """The program's first frame run under the profiler, with the offsets
    that put the traced frame's events on its clock: (frame, offsets), or
    None."""
    p = rec.get("frame_profile")
    frames = program_frames()
    if not p or not p["events"] or not frames:
        return None
    frame = next((f for f in frames if f["profiled"]), None)
    if frame is None:
        return None
    pts = fit_offsets(frame, p["events"])
    return None if pts is None else (frame, pts)


def sync_idle_share(rec):
    """The share (%) of the profiled frame's wall in which the device was
    idle while the host was outside the WORK spans and their stages."""
    got = profiled_frame(rec)
    if got is None:
        return None
    frame, pts = got
    idle = idle_by_span(frame, rec["frame_profile"]["events"], pts)
    loop = sum(v for k, v in idle.items()
               if k is not None and k.split(".")[0] not in WORK)
    return 100.0 * loop / (frame["end_ns"] - frame["start_ns"])
