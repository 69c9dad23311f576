"""The readers of the program's own timing (portbench/spans.py and the
metrics that use it) on synthetic records: the timer readers, the clock
offsets fitted on the host reads of device values (a planted offset, a
drift, reads close together, a lost copy, and the cases that give
None), the idle put down to spans; and on the CPU, a traced run of the
tiny cell whose refresh stages add up to refresh_ms."""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_cells import checkout  # noqa: E402
from portbench import harness, spans  # noqa: E402

METRICS = REPO / "portbench" / "metrics"
STAGES = ("bin", "search", "carry", "finalize", "tables", "sync")
#: an absolute host clock in ns, as time.time_ns() reads it
ORIGIN = 1_760_000_000_123_456_789


def _read(name, rec):
    spec = importlib.util.spec_from_file_location(name,
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def _timers(new=True):
    t = {"refresh_s": 0.7, "refresh_n": 20, "steps_s": 0.3, "steps_n": 100}
    if new:
        t.update({f"refresh_{s}_s": 0.1 * (i + 1)
                  for i, s in enumerate(STAGES)})
        t.update(sync_refresh_n=20, sync_shrink_n=6, sync_params_n=40,
                 sync_frame_n=1, sync_frame_s=0.5)
    return t


def test_timer_readers():
    rec = {"window": {"timers": _timers()}}
    for i, s in enumerate(STAGES):
        assert _read(f"refresh_{s}_ms", rec) == pytest.approx(
            0.1 * (i + 1) / 20 * 1e3)
    assert _read("host_syncs_per_step", rec) == pytest.approx(67 / 100)


def test_timer_readers_on_a_program_without_them():
    rec = {"window": {"timers": _timers(new=False)}, "frame_profile": None}
    for name in [f"refresh_{s}_ms" for s in STAGES] + [
            "host_syncs_per_step", "sync_idle_share"]:
        assert _read(name, rec) is None, name


#: each anchor's host wake-up after its copy: 8 to 141 us, as long waits
#: on the card spread
LATENCY_US = (12, 98, 55, 8, 141)
NAMES = ("sync.refresh", "sync.count", "sync.shrink", "sync.refresh",
         "sync.lost")
US = 1_000


def _frame(latency_us=LATENCY_US, drift=0.0):
    """A synthetic profiled frame and its profile's events (us from the
    trace's start, which is ORIGIN on the host clock, whose rate is
    1 + `drift` of the profile's): the frame's first read (its host
    waking 2.9 ms after its copy), then five anchors 10 ms apart, each
    issuing its copies (three for the shrink check) after a kernel and
    ending `latency` after the last; a span over each idle stretch; and a
    copy no read issued, after the frame."""
    host = lambda t: ORIGIN + round(t * US * (1 + drift))  # noqa: E731
    events = [("Memcpy DtoH (Device -> Pinned)", 60, 62)]
    frame_spans = [("sync.h", 2, host(55), host(62 + 2_900))]
    t = 3_100
    for name, lat in zip(NAMES, latency_us):
        events.append(("kernel", t, t + 400))
        for k in range(spans.READS[name]):
            c = t + 400 + 10 * k
            events.append(("Memcpy DtoH (Device -> Pinned)", c, c + 2))
        end = t + 402 + 10 * (spans.READS[name] - 1)
        frame_spans.append((name, 2, host(t + 100), host(end + lat)))
        # the host's bookkeeping after the read, the card idle until the
        # next kernel
        frame_spans.append(("chunk.fold", 1, host(end + lat),
                            host(t + 902)))
        t += 10_000
    events.append(("Memcpy DtoH (Device -> Pageable)", t + 10, t + 12))
    frame = dict(start_ns=host(50), end_ns=host(t), profiled=True,
                 spans=sorted(frame_spans, key=lambda x: x[2]))
    return frame, events


def _ends(events):
    """Each anchor's last copy end, in ns from the trace's start."""
    ends, i = [], 1
    for name in NAMES:
        i += 1 + spans.READS[name]
        ends.append(events[i - 1][2] * US)
    return ends


def test_fit_recovers_a_planted_offset():
    frame, events = _frame()
    pts = spans.fit_offsets(frame, events)
    # each anchor's offset: the trace's start on the frame's clock (50 us
    # before the frame) plus its host's wake-up
    assert pts == [(c, -50 * US + lat * US)
                   for c, lat in zip(_ends(events), LATENCY_US)]


def test_fit_follows_a_drift():
    """The host clock runs 1.7 ms a second faster than the profile's (as
    one frame on an H100's host did): each anchor's offset follows."""
    drift = 1.7e-3
    frame, events = _frame(drift=drift)
    pts = spans.fit_offsets(frame, events)
    want = [(c, c * drift - 50 * US * (1 + drift) + lat * US * (1 + drift))
            for c, lat in zip(_ends(events), LATENCY_US)]
    assert [c for c, _ in pts] == [c for c, _ in want]
    assert all(abs(o - w) <= 1 for (_, o), (_, w) in zip(pts, want))


def test_fit_after_a_long_wait_then_quick_reads():
    """An overflow read woken 118 us after its copy, then a count read
    (woken 4 us after) and a shrink check's three reads issued 10 us
    later: the copies lie closer than the long wake-up. Each read takes
    its own copies, in order."""
    t = 1_000  # the overflow read's copy ends
    events = [("kernel", 0, t - 2),
              ("Memcpy DtoH (Device -> Pinned)", t - 2, t),
              ("Memcpy DtoH (Device -> Pinned)", t + 130, t + 132),
              ("Memcpy DtoH (Device -> Pinned)", t + 148, t + 150),
              ("Memcpy DtoH (Device -> Pinned)", t + 152, t + 154),
              ("Memcpy DtoH (Device -> Pinned)", t + 156, t + 158)]
    at = lambda x: ORIGIN + x * US  # noqa: E731
    frame = dict(start_ns=at(0), end_ns=at(t + 200), profiled=True,
                 spans=[("sync.refresh", 2, at(t - 900), at(t + 118)),
                        ("sync.count", 2, at(t + 125), at(t + 136)),
                        ("sync.shrink", 3, at(t + 146), at(t + 160))])
    assert spans.fit_offsets(frame, events) == [
        (t * US, 118 * US), ((t + 132) * US, 4 * US),
        ((t + 158) * US, 2 * US)]


def test_fit_without_one_copy():
    """A copy the profile lost leaves its read unpaired; the other four
    anchors of five still pair."""
    frame, events = _frame()
    ends = _ends(events)
    del events[[e[2] * US for e in events].index(ends[1])]
    assert spans.fit_offsets(frame, events) == [
        (c, -50 * US + lat * US)
        for i, (c, lat) in enumerate(zip(ends, LATENCY_US)) if i != 1]


@pytest.mark.parametrize("case", ["disagree", "no_copies", "no_anchors",
                                  "two_copies_lost"])
def test_inconsistent_anchors_give_none(case):
    frame, events = _frame()
    if case == "disagree":
        # the second and fourth anchors end 5 ms later than their copies
        # allow: no offset pairs three quarters of the anchors
        late = [x for x in frame["spans"] if x[0] in spans.ANCHORS][1::2]
        frame["spans"] = [(n, d, s, e + 5_000 * US) if (n, d, s, e) in late
                          else (n, d, s, e) for n, d, s, e in frame["spans"]]
    elif case == "no_copies":
        events = [e for e in events if not e[0].startswith("Memcpy")]
    elif case == "no_anchors":
        frame["spans"] = [s for s in frame["spans"]
                          if s[0] not in spans.ANCHORS]
    elif case == "two_copies_lost":
        ends = _ends(events)
        events = [e for e in events if e[2] * US not in (ends[1], ends[3])]
    assert spans.fit_offsets(frame, events) is None


def test_idle_by_span_adds_up():
    lat = 10
    frame, events = _frame(latency_us=(lat,) * 5)
    pts = spans.fit_offsets(frame, events)
    idle = spans.idle_by_span(frame, events, pts)
    wall = frame["end_ns"] - frame["start_ns"]
    assert sum(v for k, v in idle.items() if k is not None) == \
        pytest.approx(idle[None], rel=1e-12)
    # the events land 10 us late (the wake-up): each copy's end on its
    # read's end, so the fold holds the card's idle until its span ends
    # (500 us after the copy, less the wake-up; the shrink check's last
    # copy ends 20 us later), the frame the rest until the next kernel
    assert idle["chunk.fold"] == pytest.approx((5 * (500 - lat) - 20) * US)
    assert idle.get("sync.refresh", 0) == 0
    # between the shrink check's three copies, 8 us each
    assert idle["sync.shrink"] == pytest.approx(16 * US)
    assert set(idle) == {None, "frame", "chunk.fold", "sync.h",
                         "sync.shrink"}
    assert 0 < idle[None] < wall


def test_sync_idle_share_reads_the_first_profiled_frame(monkeypatch):
    frame, events = _frame()
    other = dict(frame, profiled=False, spans=[])
    monkeypatch.setattr(spans, "program_frames", lambda: [other, frame])
    rec = {"frame_profile": {"events": events}}
    idle = spans.idle_by_span(frame, events,
                              spans.fit_offsets(frame, events))
    wall = frame["end_ns"] - frame["start_ns"]
    want = 100 * sum(v for k, v in idle.items() if k is not None) / wall
    # every span of this frame is the loop's bookkeeping or a round trip
    assert _read("sync_idle_share", rec) == pytest.approx(want)
    frame["spans"] = [("steps", 1) + s[2:] if s[0] == "chunk.fold" else s
                      for s in frame["spans"]]
    assert _read("sync_idle_share", rec) == pytest.approx(
        want - 100 * idle["chunk.fold"] / wall)
    monkeypatch.setattr(spans, "program_frames", lambda: [other])
    assert _read("sync_idle_share", rec) is None


def test_traced_run_splits_the_refresh(tmp_path):
    root = checkout(tmp_path)
    t0 = time.perf_counter()
    result, _ = harness.run(harness.load_bench(root), root, "tiny.k10",
                            2**31 + 977, 0.3, True, "cpu", t0,
                            time.perf_counter)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert sum(m[f"refresh_{s}_ms"] for s in STAGES) == pytest.approx(
        m["refresh_ms"], rel=1e-9)
    # a frame of 20 steps at K 10: 2 overflow reads, 4 pageable tensors,
    # 3 shrink-check reads, the step size, the sync, the fold, the lost
    # read
    assert m["host_syncs_per_step"] == pytest.approx(13 / 20)
    assert "sync_idle_share" not in m  # the CPU has no device trace
