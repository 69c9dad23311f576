"""The port's fused SS force step (the plain versions of kernels B, B-ub
and B-extras) against the JAX package's fused_step_ss in interpret mode.

Inputs: the random piles of tests/test_pallas_force.py, refreshed by JAX
with the fused layout and carried across with convert.py. One step of
both; owner force/torque within 2e-4 relative to the largest value, new
wildcards within 1e-3, per-contact extras within 2e-4, compared per
(idA, idB) pair (the packages may order rows of one owner pair
differently).

* The 60-clump pile: the full and the frictionless model. Its contacts
  are younger than their collision time for the first ~30 steps, so
  rolling resistance stays off on SS rows; a third case ages every live
  contact past it, so the rolling branch runs on each of them.
* The extras pass on the stepped 60-clump pile. (The JAX package checks
  its extras on a 300-clump pile, because its kernel merges the chunks
  that two owner blocks share; the port's plain version has no blocks,
  and that pile's JAX refresh and interpret-mode pass cost ~10 s here.
  Kernel B-ub's blocks are held to kernel B on the card, over the
  2,049 blocks of the 262,144-clump bed, by chip_smoke.py.)
* Unique fetch, the three cases of tests/test_uniq_fetch.py on one
  60-clump pile (its seed 1) with 64 rows per block: the refresh's
  per-block lists against JAX's field by field; the ub step against
  JAX's ub pass; and the port's ub step and ub extras against its direct
  ones (identical: the same math on the same records).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_force import _build as build_pile
from test_uniq_fetch import _refresh_with_uniq

from dem_engine_tpu.models import (
    HertzianForceModel,
    HertzianFrictionlessForceModel,
)
from dem_engine_tpu.ops import forces as jforces
from dem_engine_tpu.ops.pallas_force import OB as JAX_OB
from dem_engine_tpu.ops.pallas_force import fused_step_ss as jax_fused_step
from dem_engine_tpu.solver import refresh_contacts
from dem_engine_tpu_torch import convert
from dem_engine_tpu_torch.initializer import empty_ss_table, ss_uniq_rows
from dem_engine_tpu_torch.ops import forces as tforces
from dem_engine_tpu_torch.ops.fused_force import OB, fused_step_ss
from dem_engine_tpu_torch.solver import refresh_contacts as port_refresh

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


def _by_pair(table_idA, table_idB, values):
    a = np.asarray(table_idA)
    b = np.asarray(table_idB)
    v = np.asarray(values)
    return {(x, y): v[i] for i, (x, y) in enumerate(zip(a, b)) if x >= 0}


def _same_by_pair(ref_tab, ref_vals, got_tab, got_vals, tol):
    ref = _by_pair(ref_tab.idA, ref_tab.idB, ref_vals)
    got = _by_pair(got_tab.idA, got_tab.idB, got_vals)
    assert ref.keys() == got.keys()
    keys = sorted(ref)
    err = _rel([ref[q] for q in keys], [got[q] for q in keys])
    assert err <= tol, err


def _port(s, params, cfg):
    """The JAX state, params and config carried across to the port."""
    ps = convert.state_from_numpy(jax.tree_util.tree_map(np.asarray, s),
                                  device="cpu")
    pp = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return ps, pp, convert.config_from_reference(cfg)


def _port_step(ps, pp, pc, extras=False):
    pk = tforces.pack_kinematics(ps.owners, world_omg=True)
    return fused_step_ss(ps.ss, ps.owners, float(pp.h), pc.voxel_size,
                         pc.force_model, pk, extras=extras)


@functools.lru_cache(maxsize=None)
def _jax_step_fn(voxel_size, model, extras):
    """JAX's fused step in interpret mode, jitted: one compile per model
    and layout, however many cases run it."""
    def step(ss, owners, params):
        krec = jforces.pack_kinematics(owners, world_omg=True)
        return jax_fused_step(ss, owners, params, voxel_size, model, krec,
                              interpret=True, extras=extras)

    return jax.jit(step)


def _jax_step(s, params, cfg, extras=False):
    return _jax_step_fn(cfg.voxel_size, cfg.force_model, extras)(
        s.ss, s.owners, params)


@pytest.fixture(scope="module")
def stepped_pile():
    """Per model: the 60-pile refreshed by JAX with the fused layout and
    one JAX step taken, so the wildcards going in are not all zero."""
    cache = {}

    def get(model_fn):
        if model_fn not in cache:
            state, params, cfg = build_pile(60, model_fn(), seed=1)
            cfg = dataclasses.replace(cfg, use_fused_force=True)
            s = jax.jit(lambda st, p: refresh_contacts(st, p, cfg))(
                state, params)
            _, _, ss = _jax_step(s, params, cfg)
            cache[model_fn] = (s.replace(ss=ss), params, cfg)
        return cache[model_fn]

    return get


def _check_step(pile, age=0.0):
    """One step of both packages on the pile; `age` (seconds) is added to
    every live contact's delta_time first, in both of JAX's layouts."""
    s, params, cfg = pile
    if age:
        ss = s.ss
        live = ss.idA >= 0
        live_b = ss.own_b_sorted < s.owners.n
        s = s.replace(ss=ss.replace(
            wildcards={**ss.wildcards, "delta_time": jnp.where(
                live, ss.wildcards["delta_time"] + age, 0.0)},
            wcb=ss.wcb.at[3].set(jnp.where(live_b, ss.wcb[3] + age, 0.0))))
    assert int(s.ss.count) > 10, "the pile needs real contacts"
    f_ref, t_ref, ss_ref = _jax_step(s, params, cfg)
    ps, pp, pc = _port(s, params, cfg)
    f_got, t_got, ss_got = _port_step(ps, pp, pc)

    assert _rel(f_ref, f_got.numpy()) < 2e-4
    assert _rel(t_ref, t_got.numpy()) < 2e-4
    assert sorted(ss_ref.wildcards) == sorted(ss_got.wildcards)
    for k in ss_ref.wildcards:
        _same_by_pair(ss_ref, ss_ref.wildcards[k], ss_got,
                      ss_got.wildcards[k].numpy(), 1e-3)
    return ps.ss


@pytest.mark.parametrize("model_fn", [HertzianForceModel,
                                      HertzianFrictionlessForceModel])
def test_fused_step_matches_jax(model_fn, stepped_pile):
    _check_step(stepped_pile(model_fn))


def test_fused_step_rolling_matches_jax(stepped_pile):
    """Every live contact 1 ms old: past its collision time (at most
    0.17 ms on the pile), so each one with spin carries a rolling torque."""
    ss = _check_step(stepped_pile(HertzianForceModel), age=1e-3)
    live = ss.fstat_a[0] >= 0
    assert bool((ss.wildcards["delta_time"][live]
                 > ss.fstat_a[10][live]).all())


def _check_extras(s_ref, params, cfg, ps, pp, pc, tol=2e-4):
    _, _, t_ref = _jax_step(s_ref, params, cfg, extras=True)
    _, _, t_got = _port_step(ps, pp, pc, extras=True)
    live = t_got.idA >= 0
    for name in ("force", "torque", "cpoint"):
        got = getattr(t_got, name)
        assert got.shape == (t_got.cap, 3)
        _same_by_pair(t_ref, getattr(t_ref, name), t_got, got.numpy(), tol)
        # dead rows are exactly zero
        assert not got[~live].any()
    return t_got


def test_extras_match_jax(stepped_pile):
    s, params, cfg = stepped_pile(HertzianForceModel)
    t = _check_extras(s, params, cfg, *_port(s, params, cfg))
    live = t.idA >= 0
    assert bool((t.force[live].abs().sum(1) > 0).any())
    assert bool((t.cpoint[live].abs().sum(1) > 0).all())


@pytest.fixture(scope="module")
def uniq_pile():
    """The 60-pile refreshed by JAX with the unique-fetch layout at 64
    rows per block, and its pre-refresh state."""
    state, params, cfg = build_pile(60, HertzianForceModel(), seed=1)
    cfg_u = dataclasses.replace(cfg, use_fused_force=True, uniq_cap=64)
    s_ref = jax.jit(lambda st, p: _refresh_with_uniq(st, p, cfg_u))(
        state, params)
    return s_ref, state, params, cfg_u


def test_uniq_layout_matches_jax(uniq_pile):
    """The port's refresh builds the A layout's lists exactly as JAX's:
    uniq_a slot for slot, uidx per (idA, idB) pair, uniq_max (which also
    covers the B layout)."""
    s_ref, state, params, cfg_u = uniq_pile
    pre, pp, pc = _port(state, params, cfg_u)
    assert pc.uniq_cap == 64 and OB == JAX_OB
    pre = pre.replace(ss=empty_ss_table(pc, pc.cap_ss, "cpu",
                                        ss_uniq_rows(pc, pre.owners.n)))
    got = port_refresh(pre, pp, pc).ss
    ref = s_ref.ss
    assert int(got.count) == int(ref.count) > 10
    assert int(got.uniq_max) == int(ref.uniq_max) <= 64
    np.testing.assert_array_equal(got.uniq_a.numpy(), np.asarray(ref.uniq_a))
    _same_by_pair(ref, ref.uidx, got, got.uidx.numpy(), 0.0)
    # every live row's (block, uidx) slot holds its own_b
    live = got.idA >= 0
    slot = (got.own_a[live] // OB).long() * 64 + got.uidx[live].long()
    assert torch.equal(got.uniq_a[slot], got.own_b[live])


def test_uniq_step_matches_jax(uniq_pile):
    """The plain ub step on JAX's refreshed unique layout, carried across
    by convert.py, against JAX's ub pass; and against the port's direct
    step on the same table without the lists."""
    s_ref, _, params, cfg_u = uniq_pile
    assert int(s_ref.ss.count) > 10 and int(s_ref.ss.uniq_max) <= 64
    ps, pp, pc = _port(s_ref, params, cfg_u)
    assert ps.ss.uniq_a.shape[0] == -(-ps.owners.n // OB) * 64
    f_ref, t_ref, ss_ref = _jax_step(s_ref, params, cfg_u)
    f_ub, t_ub, ss_ub = _port_step(ps, pp, pc)
    assert _rel(f_ref, f_ub.numpy()) < 2e-4
    assert _rel(t_ref, t_ub.numpy()) < 2e-4
    for k in ss_ref.wildcards:
        _same_by_pair(ss_ref, ss_ref.wildcards[k], ss_ub,
                      ss_ub.wildcards[k].numpy(), 1e-3)
    direct = ps.replace(ss=ps.ss.replace(uniq_a=ps.ss.uniq_a[:0],
                                         uidx=ps.ss.uidx[:0]))
    f_d, t_d, ss_d = _port_step(direct, pp, pc)
    assert torch.equal(f_ub, f_d) and torch.equal(t_ub, t_d)
    for k in ss_d.wildcards:
        assert torch.equal(ss_ub.wildcards[k], ss_d.wildcards[k])
    # the extras of the ub path equal the direct path's
    _, _, e_ub = _port_step(ps, pp, pc, extras=True)
    _, _, e_d = _port_step(direct, pp, pc, extras=True)
    for name in ("force", "torque", "cpoint"):
        assert torch.equal(getattr(e_ub, name), getattr(e_d, name))
