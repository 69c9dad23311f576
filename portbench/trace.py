"""The device's activity from torch.profiler, recorded by the benchmark
around calls into the program (CUDA activity only: the host ops'
records would take most of a profile's time)."""

from __future__ import annotations

import re
import time

import torch


def profiled(fn, device) -> dict:
    """fn() under the profiler, synchronised at both ends: the profile,
    to be read by ``read`` once the measured window has closed, and the
    host wall of the call in seconds. None on a device the profiler
    cannot trace."""
    if device.type != "cuda":
        fn()
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return dict(prof=prof, wall_s=wall)


def read(p: dict) -> dict:
    """The profile's device operations as (name, start_us, end_us) in
    start order (the parse takes seconds: never inside the window)."""
    if p is None:
        return None
    from torch.autograd import DeviceType

    if "events" not in p:
        p["events"] = sorted(
            ((e.name, float(e.time_range.start), float(e.time_range.end))
             for e in p.pop("prof").events()
             if e.device_type == DeviceType.CUDA), key=lambda e: e[1])
    return p


_GENERIC = re.compile(r"\w*Functor\w*|\w+_kernel_cuda|direct_copy_kernel\w*"
                      r"|\w+_kernel_impl\w*")


def short(name: str) -> str:
    """A kernel's name without its signature and namespaces; a generic
    elementwise kernel keeps the functor it runs."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    base = re.sub(r"^void ", "", name)
    base = re.sub(r"\(anonymous namespace\)::", "", base)
    head = re.split(r"[<(]", base, 1)[0]
    head = head.split("::")[-1] or base[:60]
    if "elementwise" in head or head.startswith("index"):
        found = _GENERIC.findall(base[len(head):])
        pick = [f for f in found if "Functor" in f or "cuda" in f
                or "copy" in f] or found
        if pick:
            head += f"[{pick[0]}]"
    return head[:120]


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def merged(events) -> list:
    """The busy intervals: the union of the operations' intervals, as
    [start_us, end_us, name of the operation that ends it]."""
    out = []
    for name, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1], out[-1][2] = e, name
        else:
            out.append([s, e, name])
    return out


def busy_us(events) -> float:
    return sum(e - s for s, e, _ in merged(events))


def by_name(events) -> dict:
    """{name: (total us, count)}."""
    out = {}
    for name, s, e in events:
        t, c = out.get(name, (0.0, 0))
        out[name] = (t + e - s, c + 1)
    return out


def breakdown(events, top=10) -> dict:
    """The result line's breakdown: the device operations that took most
    time, and the longest idle gaps, each named after the operation that
    ended the busy stretch before it."""
    named = [(short(n), s, e) for n, s, e in events]
    ops = sorted(((n, t * 1e-6) for n, (t, _) in by_name(named).items()),
                 key=lambda x: -x[1])[:top]
    m = merged(named)
    gaps = sorted(((f"after {a[2]}", (b[0] - a[1]) * 1e-6)
                   for a, b in zip(m, m[1:])), key=lambda x: -x[1])[:top]
    return dict(device_ops=[list(x) for x in ops],
                idle_gaps=[list(x) for x in gaps])
