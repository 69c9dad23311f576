"""Per-stage timers of a refresh and a step, under the stage names of the
JAX package's ``profiling`` module.

The port runs eagerly, so a stage has real boundaries: ``profile_stages``
passes ``tracing``'s marker to ``refresh_contacts`` (and through it to
``sweep.find_pairs_ss``, between the sorted sphere table and kernel C)
and to ``dynamics_step``, which record a CUDA event at each boundary on
the card (the host clock on the CPU). Each of `reps` runs starts from
the same state; the outputs are thrown away, so the solver's state is
left as it was (neither function writes into a tensor of its input).
One synchronisation at the end reads every event. ``Engine`` times the
same refresh stages in every chunk it runs (``tracing``).

Stages, in milliseconds, the mean over the runs:
  * single-grid CD: "Discretize domain" (margins, grid, sorted table),
    "Find contact pairs" (kernel C), "Build history map", "Finalize
    tables" (the SS table), "kT total (refresh)" and "Other kT (ST/SA,
    margins, error-outs)"; in two-class mode only the total;
  * "Clear force array" (0: kernel A's first launch of a step writes the
    accumulator, there is no clearing pass), "Calculate contact forces"
    (with " (+reduction, fused kernel)" where kernel B sums the SS
    wrenches in the same call), "Optional force reduction" (the ST and SA
    sums), "Integration" (the integrator, prescriptions and family
    rules) and "dT total (one step)".
"""

from __future__ import annotations

from typing import Dict

import torch

from .defines import I
from .models.prescriptions import static_tables
from .ops.forces import fused_ss
from .solver import dynamics_step, refresh_contacts
from .tracing import Marker, mark_seconds

#: the JAX package's titles of ``tracing.REFRESH_STAGES``' bin, search,
#: carry and finalize, between the same marks
REFRESH_STAGES = (("Discretize domain", "start", "table"),
                  ("Find contact pairs", "table", "pairs"),
                  ("Build history map", "pairs", "history"),
                  ("Finalize tables", "history", "finalize"))
FUSED_SUFFIX = " (+reduction, fused kernel)"


def _marked(device):
    """A list of (name, mark) and the marker that appends to it."""
    marks = []
    return marks, Marker(device, marks)


def _span(marks, a, b):
    at = dict(marks)
    return mark_seconds(at[a], at[b]) * 1e3


def profile_stages(engine, state, params, update_freq,
                   reps: int = 2) -> Dict[str, float]:
    """Milliseconds per stage (module docstring) of a refresh and a step
    on `state`, the mean of `reps` runs after one untimed run."""
    cfg = engine.cfg
    dev = state.device
    params_k = params.replace(
        max_drift=torch.tensor(update_freq, dtype=I, device=dev))
    h = float(params.h)
    tables = static_tables(cfg.prescriptions, dev)
    runs = []
    for rep in range(reps + 1):
        kt, mark = _marked(dev)
        refresh_contacts(state, params_k, cfg, mark=mark)
        mark("end")
        dt, mark = _marked(dev)
        dynamics_step(state, params_k, cfg, h, tables, mark=mark)
        mark("end")
        if rep:
            runs.append((kt, dt))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    single_grid = (not cfg.cd_two_class and state.spheres.n > 0
                   and cfg.cap_ss > 0)
    fused = (state.spheres.n > 0 and state.ss.cap > 0
             and fused_ss(cfg.force_model))
    force_key = "Calculate contact forces" + (FUSED_SUFFIX if fused else "")
    out: Dict[str, float] = {}

    def mean(fn):
        return sum(fn(kt, dt) for kt, dt in runs) / len(runs)

    if single_grid:
        for name, a, b in REFRESH_STAGES:
            out[name] = mean(lambda kt, dt: _span(kt, a, b))
    out["kT total (refresh)"] = mean(lambda kt, dt: _span(kt, "start",
                                                          "end"))
    if single_grid:
        out["Other kT (ST/SA, margins, error-outs)"] = mean(
            lambda kt, dt: _span(kt, "finalize", "end"))
    out["Clear force array"] = 0.0
    out[force_key] = mean(lambda kt, dt: _span(dt, "start", "forces"))
    out["Optional force reduction"] = mean(
        lambda kt, dt: _span(dt, "forces", "reduced"))
    out["Integration"] = mean(lambda kt, dt: _span(dt, "reduced", "end"))
    out["dT total (one step)"] = mean(lambda kt, dt: _span(dt, "start",
                                                           "end"))
    return out


def format_stages(stages: Dict[str, float]) -> str:
    w = max(len(k) for k in stages)
    lines = ["[stage timers] one refresh and one step, timed at their "
             "stage boundaries (CUDA events on the card, the host clock "
             "on the CPU); Unpack/Send/Wait do not apply: kT and dT run "
             "in one process"]
    for k, v in stages.items():
        lines.append(f"  {k:<{w}} : {v:10.3f} ms")
    return "\n".join(lines)
