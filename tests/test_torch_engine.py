"""The port's Engine protocol: capacity shrink and unique-fetch growth.

* ``maybe_shrink`` picks the same capacities as the JAX package's
  ``Engine.maybe_shrink`` for the same counts and capacities. Both read
  only each table's ``count`` and call ``shrunk``/``replace``, so they
  are driven with stand-in tables of the given counts, from a few rows
  to the 262,144-clump bed's 1.8M SS contacts.
* The ports of tests/test_uniq_fetch.py's engine cases, on its random
  60-clump pile: a unique-list capacity of 2 per block overflows
  (OVF_UNIQ) and the engine's refresh grows it until it fits; and the
  lists survive a capacity shrink between refresh and steps (the unique
  and the direct step stay equal after it, within 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_pallas_force import _build as build_pile

from dem_engine_tpu.models import HertzianForceModel
from dem_engine_tpu.solver import Engine as JaxEngine
from dem_engine_tpu_torch import convert
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
    assert eng.shrinks == jeng.timers["shrinks"]


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
