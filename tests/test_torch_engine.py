"""The port's Engine protocol: capacity shrink, unique-fetch growth and
the engine loop's timing.

* ``maybe_shrink`` picks the same capacities as the JAX package's
  ``Engine.maybe_shrink`` for the same counts and capacities. Both read
  only each table's ``count`` and call ``shrunk``/``replace``, so they
  are driven with stand-in tables of the given counts, from a few rows
  to the 262,144-clump bed's 1.8M SS contacts.
* The ports of tests/test_uniq_fetch.py's engine cases, on its random
  60-clump pile: a unique-list capacity of 2 per block overflows
  (OVF_UNIQ) and the engine's refresh grows it until it fits; and the
  lists survive a capacity shrink between refresh and steps (the unique
  and the direct step stay equal after it, within 1e-6), with the block
  row starts of kernel B-ub.
* The timing (``tracing``) on a 32-sphere bed through the port's
  ``DEMSolver`` on the CPU, in a frame of 5 steps at K 2 with blocks of 2
  chunks (a measured block, a shrink check in it and one in the
  remainder): the refresh's five stages and its round trip sum to its
  span; the timers are flat scalars, and a copy of them stays put; each
  site's round trips are what the loop's code makes; the host span ring
  nests each frame's spans on ``time.time_ns()``, keeps its bound,
  outlives the solver and marks a frame run under torch.profiler.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch
from test_pallas_force import _build as build_pile

from dem_engine_tpu.models import HertzianForceModel
from dem_engine_tpu.solver import Engine as JaxEngine
from dem_engine_tpu_torch import DEMSolver, convert, tracing
from dem_engine_tpu_torch.initializer import empty_ss_table, ss_uniq_rows
from dem_engine_tpu_torch.solver import Engine, refresh_contacts, run_steps
from dem_engine_tpu_torch.state import OVF_UNIQ

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")


@dataclasses.dataclass
class _Table:
    count: int
    cap: int

    def shrunk(self, cap):
        assert cap <= self.cap
        return _Table(self.count, cap)


@dataclasses.dataclass
class _State:
    ss: _Table
    st: _Table
    sa: _Table

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@pytest.mark.parametrize("counts,caps", [
    ((0, 0, 0), (4096, 8, 256)),
    ((3136, 0, 64), (6144, 8, 2048)),
    ((3136, 0, 64), (4096, 8, 256)),
    ((1806336, 0, 4096), (3932160, 8, 786432)),
    ((1806336, 0, 4096), (2367488, 8, 5376)),
    ((2500000, 10, 300000), (3145728, 800, 400000)),
])
def test_maybe_shrink_matches_jax(counts, caps):
    def state():
        return _State(*(_Table(n, c) for n, c in zip(counts, caps)))

    jcfg = build_pile(4, HertzianForceModel())[2]
    jcfg = dataclasses.replace(jcfg, cap_ss=caps[0], cap_st=caps[1],
                               cap_sa=caps[2])
    cfg = convert.config_from_reference(jcfg)
    jeng, eng = JaxEngine(jcfg), Engine(cfg)
    js, ts = jeng.maybe_shrink(state()), eng.maybe_shrink(state())
    got = (eng.cfg.cap_ss, eng.cfg.cap_st, eng.cfg.cap_sa)
    assert got == (jeng.cfg.cap_ss, jeng.cfg.cap_st, jeng.cfg.cap_sa)
    assert (ts.ss.cap, ts.st.cap, ts.sa.cap) == got
    assert (js.ss.cap, js.st.cap, js.sa.cap) == got
    assert eng.timers["shrinks"] == jeng.timers["shrinks"]


def _pile(seed, uniq_cap):
    """The pile's pre-refresh state in the port, its SS table with the
    unique-fetch rows of `uniq_cap`."""
    state, params, jcfg = build_pile(60, HertzianForceModel(), seed=seed)
    jcfg = dataclasses.replace(jcfg, use_fused_force=True,
                               uniq_cap=uniq_cap)
    cfg = convert.config_from_reference(jcfg)
    ts = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, state),
                                  device="cpu")
    tp = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    ss = empty_ss_table(cfg, cfg.cap_ss, "cpu",
                        ss_uniq_rows(cfg, ts.owners.n))
    return ts.replace(ss=ss), tp, cfg


def test_uniq_overflow_flag_and_engine_growth():
    state, params, cfg = _pile(seed=4, uniq_cap=2)
    s = refresh_contacts(state, params, cfg)
    assert int(s.overflow) & OVF_UNIQ  # 2 unique others/block is too few
    assert int(s.ss.uniq_max) > 2

    eng = Engine(cfg)
    s = eng.refresh(state, params)
    assert eng.cfg.uniq_cap >= int(s.ss.uniq_max) > 2
    assert not int(s.overflow) & OVF_UNIQ
    assert s.ss.uniq_a.shape[0] == -(-s.owners.n // 128) * eng.cfg.uniq_cap
    # the grown state steps fine
    s = run_steps(s, params, eng.cfg, 1)
    assert torch.isfinite(s.owners.vel).all()


def _dead_rows_trail(table, n_owners):
    """Kernel A's contract: in the A order and in the B order, no live
    row follows a dead one."""
    for ids in (table.own_a, table.own_b_sorted):
        live = (ids >= 0) & (ids < n_owners)
        n_live = int(live.sum())
        assert n_live == int(table.count) and bool(live[:n_live].all())


def test_uniq_survives_capacity_shrink():
    """maybe_shrink runs between refresh and steps: the head rows it keeps
    (live rows first) keep their uidx."""
    s_d, params, cfg_d = _pile(seed=1, uniq_cap=0)
    s_u, _, cfg_u = _pile(seed=1, uniq_cap=64)
    s_d = refresh_contacts(s_d, params, cfg_d)
    s_u = refresh_contacts(s_u, params, cfg_u)
    new_cap = 1024  # < the build cap of 2048, > the live count
    assert 10 < int(s_u.ss.count) < new_cap
    assert bool((s_u.ss.idA[:int(s_u.ss.count)] >= 0).all())
    n = s_u.owners.n
    for table in (s_u.ss, s_u.sa, s_u.ss.grown(3000), s_u.ss.shrunk(new_cap),
                  s_u.sa.grown(s_u.sa.cap + 100)):
        _dead_rows_trail(table, n)
    # kernel B-ub's block row starts: block b's A owners hold rows
    # [blk_start[b], blk_start[b+1]), the dead rows follow; grown and
    # shrunk carry them unchanged
    starts = s_u.ss.blk_start
    n_live = int(s_u.ss.count)
    assert starts.shape == (-(-n // 128) + 1,) and int(starts[-1]) == n_live
    assert int(starts[0]) == 0
    row_blk = torch.repeat_interleave(torch.arange(starts.shape[0] - 1),
                                      starts.diff())
    assert torch.equal(row_blk, s_u.ss.own_a[:n_live].long() // 128)
    for table in (s_u.ss.grown(3000), s_u.ss.shrunk(new_cap)):
        assert torch.equal(table.blk_start, starts)
    s_d = s_d.replace(ss=s_d.ss.shrunk(new_cap))
    s_u = s_u.replace(ss=s_u.ss.shrunk(new_cap))
    assert s_u.ss.uidx.shape[0] == new_cap
    # the kernels take dense field-major rows
    assert s_u.ss.fstat_a.is_contiguous() and s_d.ss.fstat_a.shape == (
        16, new_cap)
    s_d = run_steps(s_d, params, dataclasses.replace(cfg_d, cap_ss=new_cap),
                    2)
    s_u = run_steps(s_u, params, dataclasses.replace(cfg_u, cap_ss=new_cap),
                    2)
    scale = float(s_d.owners.vel.abs().max())
    assert float((s_d.owners.vel - s_u.owners.vel).abs().max()) <= (
        1e-6 * scale)
    for k in s_d.ss.wildcards:
        ref, got = s_d.ss.wildcards[k], s_u.ss.wildcards[k]
        assert float((ref - got).abs().max()) <= 1e-6 * float(
            ref.abs().max())


# ---------------------------------------------------------------------------
# the engine loop's timing (tracing)
# ---------------------------------------------------------------------------

R, H = 0.005, 1e-5
#: the frame: K 2, blocks of FUSE chunks, STEPS steps = one block of 2
#: chunks and a remainder chunk of 1 step
K, FUSE, STEPS = 2, 2, 5


@pytest.fixture(scope="module")
def bed():
    """A 4 x 4 x 2 lattice of spheres just above a floor, initialized,
    with the frame's blocks of FUSE chunks."""
    s = DEMSolver(device="cpu")
    s.SetVerbosity("QUIET")
    dims = np.asarray([28 * R, 28 * R, 48 * R])
    s.InstructBoxDomainDimension(*dims)
    mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                          "Crr": 0.0})
    i = np.arange(32)
    pos = np.stack([i % 4 * 2 * R + 10 * R, i // 4 % 4 * 2 * R + 10 * R,
                    i // 16 * 2 * R + 3 * R], -1) - dims / 2
    s.AddClumps(s.LoadSphereType(2600 * 4 / 3 * np.pi * R**3, R, mat), pos)
    s.AddBCPlane([0, 0, -dims[2] / 2 + 2 * R], [0, 0, 1], mat)
    s.SetInitTimeStep(H)
    s.SetCDUpdateFreq(K)
    s.Initialize()
    s.engine.fuse = FUSE
    return s


@pytest.fixture(scope="module")
def framed(bed):
    """One frame on cleared timers: a copy of its timers, the ring's
    frames after it, and the host clock before and after."""
    bed.ClearTimingStats()
    t0 = time.time_ns()
    bed.DoDynamics(STEPS * H)
    t1 = time.time_ns()
    return dict(timers=dict(bed.engine.read_timers()), t0=t0, t1=t1,
                frames=tracing.frames())


def test_refresh_stages_sum_to_the_refresh_span(framed):
    t = framed["timers"]
    parts = [t[f"refresh_{s}_s"] for s, _, _ in tracing.REFRESH_STAGES]
    assert all(p > 0 for p in parts)
    assert sum(parts) + t["refresh_sync_s"] == pytest.approx(
        t["refresh_s"], rel=1e-9)


def test_timers_are_flat_and_a_copy_stays_put(bed, framed):
    t = framed["timers"]
    assert set(t) == set(tracing.zero_timers())
    assert all(type(v) in (int, float) for v in t.values())
    snap = dict(t)
    bed.DoDynamics(H)
    assert t == snap
    assert bed.engine.read_timers()["steps_n"] == STEPS + 1


def test_round_trips_by_site(framed):
    """Per frame: a refresh's overflow read per attempt, one count at the
    block's first chunk, two shrink checks of three reads, two pageable
    tensors a chunk, and one each of the step size, the frame's sync, the
    fold after it and the lost-contact read."""
    t = framed["timers"]
    chunks = FUSE + 1
    assert (t["refresh_n"], t["steps_n"], t["grows"]) == (chunks, STEPS, 0)
    assert t["shrink_checks"] == 2
    want = dict(refresh=chunks + t["retries"], count=1, shrink=6, fold=1,
                params=2 * chunks, h=1, tune=0, frame=1, lost=1)
    assert {x: t[f"sync_{x}_n"] for x in tracing.SYNC_SITES} == want
    assert all(t[f"sync_{x}_s"] >= 0 for x in tracing.SYNC_SITES)


def test_span_ring(bed, framed):
    names = {"frame.tail", "chunk.setup", "refresh", "grow", "chunk.fold",
             "shrink", "steps"} | set(tracing.REFRESH_SPANS.values()) | {
        "sync." + x for x in tracing.SYNC_SITES}
    f = framed["frames"][-1]
    assert framed["t0"] <= f["start_ns"] < f["end_ns"] <= framed["t1"]
    assert not f["profiled"]
    spans = f["spans"]
    assert {x[0] for x in spans} <= names
    assert sum(x[0] == "steps" for x in spans) == FUSE + 1
    for name, depth, a, b in spans:
        assert depth >= 1 and f["start_ns"] <= a <= b <= f["end_ns"]
        # inside a span one level up
        if depth > 1:
            assert any(d == depth - 1 and p <= a and b <= q
                       for _, d, p, q in spans)
    # under torch.profiler a frame knows it; the ring outlives the solver
    with torch.autograd.profiler.profile():
        bed.DoDynamics(H)
    kept = tracing.frames()[-1]
    assert kept["profiled"] and kept["start_ns"] > f["end_ns"]
    held = tracing._ring.copy()
    try:
        for _ in range(tracing.RING_SPANS):
            with tracing.span("steps"):
                pass
        assert len(tracing._ring) == tracing.RING_SPANS
        with tracing.frame():
            pass
        # a full ring may have cut its oldest frame: that one is left out
        assert tracing.frames() == []
    finally:
        tracing._ring.clear()
        tracing._ring.extend(held)
    assert tracing.frames()[-1] == kept
