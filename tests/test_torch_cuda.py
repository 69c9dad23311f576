"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode) and
skip without one. The file imports no JAX, so on a machine without it
run it without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: kernels A (one-side and pair form) and
D within 1e-5 of the exact (float64) sums, relative to the largest, and
D's spill flag equal to the plain version's; kernel B owner wrench 2e-4
and wildcards 1e-3 (FMA contraction and atomic summation order), its
extras 2e-4; kernel B-ub equal to kernel B (one device function on
bit-equal records); kernel C identical pair tables.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dem_engine_tpu_torch import DEMSolver, Engine, build_case
from dem_engine_tpu_torch.initializer import empty_ss_table, ss_uniq_rows
from dem_engine_tpu_torch.ops import binning, forces, segred, sweep
from dem_engine_tpu_torch.ops.fused_force import (
    fused_step_ss,
    fused_step_ss_plain,
    hertz_rows_cuda,
    hertz_rows_ub_cuda,
)
from dem_engine_tpu_torch.solver import run_steps, ss_search_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def bed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg, state, params = build_case(2048, update_freq=10, device="cuda")
    eng = Engine(cfg)
    state = eng.advance(state, params, 5, 10)
    state = eng.refresh(state, params)
    return eng.cfg, state, params


def _rel(ref, got):
    return float((ref - got).abs().max() / ref.abs().max().clamp(min=1e-30))


@pytest.fixture
def bed_uniq(bed):
    """The bed refreshed with the unique-fetch layout (512 rows per
    block; the 2,056 owners make 17 blocks)."""
    cfg, state, params = bed
    cfg = dataclasses.replace(cfg, uniq_cap=512)
    state = state.replace(ss=empty_ss_table(
        cfg, cfg.cap_ss, "cuda", ss_uniq_rows(cfg, state.owners.n)))
    eng = Engine(cfg)
    return eng.cfg, eng.refresh(state, params), params


def test_segred_kernel_matches_plain(bed):
    cfg, state, params = bed
    p = forces.contact_pass("sa", state.sa, state.owners, state.spheres,
                            state.anals, params, state.time, cfg.voxel_size,
                            cfg.force_model)
    n = state.owners.n
    g = torch.Generator(device="cuda").manual_seed(0)
    heavy = torch.sort(torch.randint(0, 8, (50_000,), device="cuda",
                                     generator=g)).values.to(torch.int32)
    rec = torch.randn((50_000, 6), device="cuda", generator=g)
    for r, ids, perm, m in ((p["rec_a"], p["table"].own_a, None, n),
                            (p["rec_b"], p["table"].own_b_sorted,
                             p["table"].perm_b, n),
                            (rec, heavy, None, 8)):
        exact = segred.seg_sum_plain(r.double(), ids, m, perm)
        got = segred.seg_sum_sorted(r, ids, m, perm).double()
        assert _rel(exact, got) <= 1e-5


def test_segred_pair_kernel_matches_plain(bed):
    """Both sides of a table in one launch, onto a fresh output and onto
    a given one; an all-dead table adds nothing."""
    cfg, state, params = bed
    p = forces.contact_pass("sa", state.sa, state.owners, state.spheres,
                            state.anals, params, state.time, cfg.voxel_size,
                            cfg.force_model)
    n = state.owners.n
    ss, sa = state.ss, p["table"]
    krec = forces.pack_kinematics(state.owners, world_omg=True)
    rec_a, rec_b, _ = hertz_rows_cuda(ss, krec, float(params.h),
                                      cfg.voxel_size, cfg.force_model)
    sides = [(rec_a, ss.own_a, rec_b, ss.own_b_sorted, ss.perm_b),
             (p["rec_a"], sa.own_a, p["rec_b"], sa.own_b_sorted, sa.perm_b)]

    def exact(ra, ia, rb, ib, pb):
        return (segred.seg_sum_plain(ra.double(), ia, n)
                + segred.seg_sum_plain(rb.double(), ib, n, pb))

    assert int(ss.count) < ss.cap  # a dead tail on both sides
    acc = None
    want = torch.zeros((n, 6), dtype=torch.float64, device="cuda")
    for side in sides:
        before = segred.seg_sum_pair.launches
        got = segred.seg_sum_pair(*side, n)
        assert segred.seg_sum_pair.launches == before + 1
        assert _rel(exact(*side), got.double()) <= 1e-5
        want += exact(*side)
        ret = segred.seg_sum_pair(*side, n, out=acc)
        assert acc is None or ret is acc
        acc = ret
    assert _rel(want, acc.double()) <= 1e-5
    dead = torch.full_like(ss.own_a, -1)
    held = acc.clone()
    segred.seg_sum_pair(rec_a, dead, rec_b, torch.full_like(dead, n),
                        ss.perm_b, n, out=acc)
    assert torch.equal(acc, held)
    assert not segred.seg_sum_pair(rec_a, dead, rec_b, dead, ss.perm_b,
                                   n).any()


def test_segred_kernel_skips_dead_steps():
    """Dead rows inside a warp's 256-row span: a whole 32-row step after
    a live one, single rows, and a tail that begins in the middle of a
    step. A warp stops only at a group that begins with an all-dead
    step, so these sum as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    n, cap = 40, 1024
    ids = torch.sort(torch.randint(0, n, (cap,), device="cuda",
                                   generator=g)).values.to(torch.int32)
    ids[32:64] = n    # step 1 of span 0, after a live step 0
    ids[96:128] = -1  # step 1 of the span's second group
    ids[300:303] = n  # rows inside a live step
    ids[700:] = n     # the tail, from the middle of a step
    rec = torch.randn((cap, 6), device="cuda", generator=g)
    perm = torch.randperm(cap, device="cuda", generator=g).to(torch.int32)
    for pm in (None, perm):
        exact = segred.seg_sum_plain(rec.double(), ids, n, pm)
        assert _rel(exact, segred.seg_sum_sorted(rec, ids, n, pm).double()
                    ) <= 1e-5
    both = segred.seg_sum_pair(rec, ids, rec, ids, perm, n).double()
    assert _rel(segred.seg_sum_plain(rec.double(), ids, n)
                + segred.seg_sum_plain(rec.double(), ids, n, perm),
                both) <= 1e-5


def test_fused_kernel_matches_plain(bed):
    cfg, state, params = bed
    krec = forces.pack_kinematics(state.owners, world_omg=True)
    args = (state.ss, state.owners, float(params.h), cfg.voxel_size,
            cfg.force_model, krec)
    fk, tk, ssk = fused_step_ss(*args)
    fp, tp, ssp = fused_step_ss_plain(*args)
    assert _rel(fp, fk) <= 2e-4 and _rel(tp, tk) <= 2e-4
    live = state.ss.idA >= 0
    for k in ssp.wildcards:
        assert _rel(ssp.wildcards[k][live], ssk.wildcards[k][live]) <= 1e-3


def test_extras_kernel_matches_plain(bed):
    cfg, state, params = bed
    krec = forces.pack_kinematics(state.owners, world_omg=True)
    args = (state.ss, state.owners, float(params.h), cfg.voxel_size,
            cfg.force_model, krec)
    _, _, tk = fused_step_ss(*args, extras=True)
    _, _, tp = fused_step_ss_plain(*args, extras=True)
    live = state.ss.idA >= 0
    for name in ("force", "torque", "cpoint"):
        k, p = getattr(tk, name), getattr(tp, name)
        assert k.shape == p.shape == (state.ss.cap, 3)
        assert _rel(p[live], k[live]) <= 2e-4
        assert not k[~live].any()


def test_ub_kernel_matches_direct(bed_uniq):
    cfg, state, params = bed_uniq
    assert int(state.ss.uniq_max) <= cfg.uniq_cap
    krec = forces.pack_kinematics(state.owners, world_omg=True)
    args = (state.ss, krec, float(params.h), cfg.voxel_size,
            cfg.force_model)
    ub, direct = hertz_rows_ub_cuda(*args), hertz_rows_cuda(*args)
    for u, d in zip(ub, direct):
        assert torch.equal(u, d)
    f_u, t_u, _ = fused_step_ss(state.ss, state.owners, float(params.h),
                                cfg.voxel_size, cfg.force_model, krec)
    f_p, t_p, _ = fused_step_ss_plain(state.ss, state.owners,
                                      float(params.h), cfg.voxel_size,
                                      cfg.force_model, krec)
    assert _rel(f_p, f_u) <= 2e-4 and _rel(t_p, t_u) <= 2e-4


def test_segred_v1_kernel_matches_plain(bed):
    cfg, state, params = bed
    n = state.owners.n
    sa = state.sa
    g = torch.Generator(device="cuda").manual_seed(1)
    rec = torch.randn((sa.cap, 6), device="cuda", generator=g)
    sparse = torch.sort(torch.randint(0, 100_000, (1024,), device="cuda",
                                      generator=g)).values.to(torch.int32)
    rec_s = torch.randn((1024, 6), device="cuda", generator=g)
    # the SA table's B side (every live row on the floor owner: no
    # spill), a sparse table that must spill, the bed's SS table (many
    # tiles, owner runs across warps and tiles, a dead tail; spill as the
    # plain version says), and an all-dead table (zeros out, no spill)
    ss = state.ss
    rec_ss = torch.randn((ss.cap, 6), device="cuda", generator=g)
    dead = torch.full_like(sa.own_b_sorted, n)
    for r, ids, m, must_spill in ((rec, sa.own_b_sorted, n, False),
                                  (rec_s, sparse, 100_000, True),
                                  (rec_ss, ss.own_b_sorted, n, None),
                                  (rec, dead, n, False)):
        exact, spill_p = segred.seg_sum_v1_plain(r.double(), ids, m)
        got, spill = segred.seg_sum_sorted_v1(r, ids, m)
        assert spill.dtype == torch.bool and spill.shape == ()
        assert bool(spill) == bool(spill_p)
        assert must_spill is None or bool(spill) == must_spill
        assert got.shape == (m, 6)
        assert _rel(exact, got.double()) <= 1e-5
        if ids is dead:
            assert not got.any()


def test_solver_matches_cpu():
    """The public DEMSolver on the card against the CPU: 64 clumps on a
    floor, 10 steps, rolling resistance off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    out = {}
    for dev in ("cuda", "cpu"):
        s = DEMSolver(device=dev)
        s.SetVerbosity("QUIET")
        s.InstructBoxDomainDimension(0.1, 0.1, 0.1)
        mat = s.LoadMaterial({"E": 1e7, "nu": 0.3, "CoR": 0.5, "mu": 0.4,
                              "Crr": 0.0})
        t = s.LoadSphereType(1e-3, 0.005, mat)
        g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
        s.AddClumps(t, g * 0.0099 - 0.02)
        s.AddBCPlane([0, 0, -0.026], [0, 0, 1], mat)
        s.SetInitTimeStep(1e-5)
        s.SetGravitationalAcceleration([0, 0, -9.81])
        s.SetCDUpdateFreq(5)
        s.Initialize()
        s.DoDynamics(1e-4)
        out[dev] = (s.GetOwnerVelocity(), s.GetNumContacts(),
                    s.GetContactDetailedInfo())
    (vg, ng, dg), (vc, nc, dc) = out["cuda"], out["cpu"]
    assert ng == nc > 0
    assert np.abs(vg - vc).max() <= 2e-4 * np.abs(vc).max()
    assert [b["kind"] for b in dg] == [b["kind"] for b in dc]


def test_sweep_kernel_matches_plain(bed):
    cfg, state, params = bed
    q = ss_search_inputs(state, params, cfg.voxel_size)
    S = state.spheres.n
    tab = binning.build_sphere_table(q["pos_cd"], q["reach"], q["owner"],
                                     q["family"], q["bin_size"], q["nb_cd"],
                                     S)
    for cap in (cfg.cap_ss, 1000):
        ka, kb, kn = sweep.sweep_table_cuda(tab, S, q["family_mask"],
                                            q["nb_cd"], cap)
        pa, pb, pn = binning.sweep_table(tab, S, q["family_mask"],
                                         q["nb_cd"], cap, int(tab.max_occ))
        assert int(kn) == int(pn) > 1000
        assert torch.equal(ka, pa) and torch.equal(kb, pb)


def test_engine_matches_cpu(bed):
    """One refresh and 10 steps on the card against the CPU (rolling
    resistance off, see tests/test_torch_slice.py)."""
    legs = {}
    for dev in ("cuda", "cpu"):
        cfg, st, pr = build_case(1024, update_freq=10, device=dev)
        pr = pr.replace(pair_props={**pr.pair_props,
                                    "Crr": torch.zeros((1, 1), device=dev)})
        eng = Engine(cfg)
        st = run_steps(eng.refresh(st, pr), pr, eng.cfg, 10)
        legs[dev] = st
    g, c = legs["cuda"], legs["cpu"]
    assert _rel(c.owners.vel, g.owners.vel.cpu()) <= 2e-4
    assert _rel(c.owners.omg, g.owners.omg.cpu()) <= 2e-4
    a = {tuple(x) for x in torch.stack([g.ss.idA, g.ss.idB], 1).cpu()
         .numpy().tolist() if x[0] >= 0}
    b = {tuple(x) for x in torch.stack([c.ss.idA, c.ss.idB], 1)
         .numpy().tolist() if x[0] >= 0}
    assert a == b and np.isfinite(g.owners.loc.cpu().numpy()).all()
